"""Hybrid-transport discovery: MQTT control plane + TCP data plane.

Parity: nnstreamer-edge's HYBRID connect type (SURVEY §2.5 — "hybrid
(MQTT control + TCP data)"; used by tensor_query_* / edge elements via
``connect-type=HYBRID``). A serving pipeline announces its TCP endpoint
on an MQTT topic; clients discover the endpoint from the broker, then
move all tensor traffic over a direct TCP connection. The broker can be
any MQTT 3.1.1 broker (mosquitto, EMQX, …) or the in-process
``edge.mqtt.MqttBroker``.

Announcements are periodic (QoS-0 brokers have no retained-message
guarantee here) with payload ``host:port``.

A copy of the JAX package's module: a server of one package is discovered
by a client of the other on either package's broker.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from nnstreamer_tpu_torch.analysis import lockwitness
from nnstreamer_tpu_torch.edge.mqtt import MqttClient
from nnstreamer_tpu_torch.log import get_logger

log = get_logger("edge.discovery")

ANNOUNCE_INTERVAL_SEC = 1.0

#: Directory stale-entry TTL: a peer that misses this many announce
#: intervals is evicted — routed-to-forever dead peers are exactly the
#: failure the fleet client's blacklist can't see (it only learns about
#: endpoints the directory still lists)
DEFAULT_TTL_SEC = 3.0 * ANNOUNCE_INTERVAL_SEC

_WILDCARD_BINDS = {"0.0.0.0", "::", ""}
_LOOPBACK_BINDS = {"localhost", "127.0.0.1", "::1"}


def resolve_announce_host(bind_host: str, broker_host: str) -> str:
    """Pick the data-plane address to announce for ``bind_host``.

    A server bound to a wildcard must not announce that literal address —
    remote clients would discover an unreachable endpoint (nnstreamer-edge
    hybrid mode advertises an externally reachable address).  For a
    wildcard bind the server listens on every interface, so resolve the
    outbound interface address toward the broker (UDP connect sends no
    packets).  A loopback bind is announced as-is: the server only listens
    on loopback, so an external address would be a lie — bind 0.0.0.0 or
    set announce-host for remote clients.  Any other bind host is already
    a concrete reachable name.
    """
    if bind_host not in _WILDCARD_BINDS:
        return bind_host
    if broker_host in _WILDCARD_BINDS or broker_host in _LOOPBACK_BINDS:
        # broker is local: loopback deployment, loopback is reachable
        return "127.0.0.1"
    import socket

    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect((broker_host, 1))
            return s.getsockname()[0]
    except OSError:
        # never announce the wildcard literal; loopback at least names a
        # real listener (the wildcard bind covers it)
        return "127.0.0.1"


def start_hybrid_announcer(element_name: str, properties: dict,
                           bind_host: str, server_port: int):
    """Shared connect-type=HYBRID announce setup for serving elements.

    Validates topic/dest-host/dest-port, resolves the announce address
    (``announce-host`` property overrides), and returns a running
    :class:`HybridAnnouncer`.  Raises ``ElementError`` on bad config or
    broker failure.  Used by tensor_query_serversrc and edgesink.
    """
    from nnstreamer_tpu_torch.log import ElementError

    topic = str(properties.get("topic", ""))
    bhost = str(properties.get("dest_host", "localhost"))
    bport = int(properties.get("dest_port", 0))
    if not topic or not bport:
        raise ElementError(
            element_name,
            "connect-type=HYBRID needs topic= and broker dest-host=/dest-port=",
        )
    ann_host = str(
        properties.get("announce_host", "")
    ) or resolve_announce_host(bind_host, bhost)
    try:
        return HybridAnnouncer(bhost, bport, topic, ann_host, server_port)
    except Exception as e:
        raise ElementError(element_name, f"hybrid announce failed: {e}")


class HybridAnnouncer:
    """Periodically publishes ``host:port`` on ``topic`` until closed."""

    def __init__(self, broker_host: str, broker_port: int, topic: str,
                 host: str, port: int):
        self.topic = topic
        self.payload = f"{host}:{port}".encode()
        self._client = MqttClient(broker_host, broker_port)
        self._client.connect()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name=f"announce:{topic}", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._client.publish(self.topic, self.payload)
            except (ConnectionError, OSError):
                break
            self._stop.wait(ANNOUNCE_INTERVAL_SEC)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)
        self._client.close()


class Directory:
    """Live endpoint directory for one topic: every announcer publishing
    ``host:port`` heartbeats shows up in :meth:`endpoints`; one that
    stops heartbeating is evicted after ``ttl`` seconds (lazily, at
    lookup — no sweeper thread). This is the discovery feed for the
    fleet client's ``endpoints=`` list: N servers announce on one topic,
    the client routes across whoever is *currently* alive."""

    def __init__(self, broker_host: str, broker_port: int, topic: str,
                 ttl: float = DEFAULT_TTL_SEC, timeout: float = 10.0):
        self.topic = topic
        self.ttl = float(ttl)
        self._entries: Dict[Tuple[str, int], float] = {}
        self._lock = lockwitness.make_lock("edge.discovery")
        self._stop = threading.Event()
        self._client = MqttClient(broker_host, broker_port)
        self._client.connect(timeout=timeout)
        self._client.subscribe(topic, timeout=timeout)
        self._thread = threading.Thread(
            target=self._loop, name=f"directory:{topic}", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                got = self._client.recv(timeout=0.2)
            except (ConnectionError, OSError):
                break
            if got is None:
                continue
            _topic, payload = got
            try:
                text = payload.decode()
                host, _, port_s = text.rpartition(":")
                if not host or not port_s.isdigit():
                    raise ValueError(text)
            except (ValueError, UnicodeDecodeError):
                log.warning("directory %s: malformed announcement %r",
                            self.topic, payload[:64])
                continue
            with self._lock:
                self._entries[(host, int(port_s))] = time.monotonic()

    def endpoints(self) -> List[Tuple[str, int]]:
        """Currently-live endpoints (stale ones evicted on the way out)."""
        now = time.monotonic()
        with self._lock:
            dead = [(ep, seen) for ep, seen in self._entries.items()
                    if now - seen > self.ttl]
            for ep, seen in dead:
                del self._entries[ep]
                log.info("directory %s: evicted stale endpoint %s:%d "
                         "(last heartbeat %.1fs ago)", self.topic,
                         ep[0], ep[1], now - seen)
            return sorted(self._entries)

    def wait_for(self, n: int = 1, timeout: float = 10.0
                 ) -> List[Tuple[str, int]]:
        """Block until at least ``n`` live endpoints are known."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            eps = self.endpoints()
            if len(eps) >= n:
                return eps
            if self._stop.wait(0.05):
                break
        raise TimeoutError(
            f"only {len(self.endpoints())} endpoint(s) on {self.topic!r} "
            f"after {timeout}s (wanted {n})")

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)
        self._client.close()


def discover(broker_host: str, broker_port: int, topic: str,
             timeout: float = 10.0) -> Tuple[str, int]:
    """Subscribe to ``topic`` and wait for a ``host:port`` announcement."""
    client = MqttClient(broker_host, broker_port)
    try:
        client.connect(timeout=timeout)
        client.subscribe(topic, timeout=timeout)
        got: Optional[Tuple[str, bytes]] = client.recv(timeout=timeout)
        if got is None:
            raise TimeoutError(
                f"no endpoint announced on {topic!r} within {timeout}s"
            )
        _, payload = got
        text = payload.decode()
        host, _, port_s = text.rpartition(":")
        if not host or not port_s.isdigit():
            raise ValueError(f"malformed announcement {text!r} on {topic!r}")
        return host, int(port_s)
    finally:
        client.close()
