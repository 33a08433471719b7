"""MQTT 3.1.1 transport: codec + client + in-process broker.

The reference's mqttsrc/mqttsink ride paho MQTTAsync against an external
broker (gst/mqtt/, mqttsink.h:91-93). We implement the protocol subset the
elements need — CONNECT/CONNACK, PUBLISH at QoS 0/1 (PUBACK, DUP
retransmit), SUBSCRIBE/SUBACK, PING, DISCONNECT — as a self-contained
codec so:
  * MqttClient interoperates with any standards broker (mosquitto, EMQX…),
  * MqttBroker provides the loopback broker the reference's tests assume
    exists on localhost (tests/check_broker.sh parity, minus the external
    dependency).
Topic filters support the '+' and '#' wildcards.

Resilience (paho-MQTTAsync parity the r1/r2 subset lacked): QoS-1
publishes are tracked until PUBACK and retransmitted with the DUP flag;
``auto_reconnect=True`` survives a broker bounce — exponential-backoff
redial, session re-establishment, re-SUBSCRIBE of every filter, and
retransmission of unacked QoS-1 publishes. Inbound QoS-1 is PUBACK'd with
recent-packet-id dedup.

A copy of the JAX package's module: the two packages' clients and brokers
talk to each other and put the same bytes on the wire. The client also
counts the DUP-flagged publishes it receives and the ones it drops as
already delivered (``dups_received``, ``dups_dropped``), and the broker
the DUP-flagged publishes it takes in (``dups_received``: it fans each
out again under a fresh packet id), so a run can show how often a slow
PUBACK made a whole message travel twice.
"""

from __future__ import annotations

import queue
import socket
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from nnstreamer_tpu_torch.analysis import lockwitness
from nnstreamer_tpu_torch.log import get_logger

log = get_logger("mqtt")


def _hard_close(sock) -> None:
    """shutdown() before close(): a plain close() while another thread is
    blocked in recv() on the same fd does NOT send FIN (the in-flight
    syscall pins the open file description), so peers would never learn
    the connection died. shutdown(SHUT_RDWR) sends FIN immediately and
    wakes any blocked recv with EOF."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass

CONNECT, CONNACK, PUBLISH, PUBACK = 1, 2, 3, 4
SUBSCRIBE, SUBACK, UNSUBSCRIBE, UNSUBACK = 8, 9, 10, 11
PINGREQ, PINGRESP, DISCONNECT = 12, 13, 14


def _encode_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n % 128
        n //= 128
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _read_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n > 0:
        c = sock.recv(n)
        if not c:
            raise ConnectionError("peer closed")
        chunks.append(c)
        n -= len(c)
    return b"".join(chunks)


def _read_varint(sock: socket.socket) -> int:
    mult, val = 1, 0
    for _ in range(4):
        b = _read_exact(sock, 1)[0]
        val += (b & 0x7F) * mult
        if not b & 0x80:
            return val
        mult *= 128
    raise ValueError("malformed remaining-length")


def _utf8(s: str) -> bytes:
    b = s.encode("utf-8")
    return len(b).to_bytes(2, "big") + b


@dataclass
class Packet:
    type: int
    flags: int
    body: bytes


def send_packet(sock: socket.socket, ptype: int, body: bytes, flags: int = 0) -> None:
    sock.sendall(bytes([(ptype << 4) | flags]) + _encode_varint(len(body)) + body)


def recv_packet(sock: socket.socket) -> Packet:
    h = _read_exact(sock, 1)[0]
    length = _read_varint(sock)
    body = _read_exact(sock, length) if length else b""
    return Packet(type=h >> 4, flags=h & 0x0F, body=body)


def topic_matches(pattern: str, topic: str) -> bool:
    """MQTT topic filter matching with '+' (one level) and '#' (tail)."""
    pp, tp = pattern.split("/"), topic.split("/")
    for i, seg in enumerate(pp):
        if seg == "#":
            return True
        if i >= len(tp):
            return False
        if seg != "+" and seg != tp[i]:
            return False
    return len(pp) == len(tp)


class MqttClient:
    """MQTT client with QoS 0/1 and optional broker-bounce survival.

    ``auto_reconnect=True``: a dropped connection triggers a background
    redial with exponential backoff (capped at ``max_backoff``); on
    re-connect every subscription is re-issued and unacked QoS-1
    publishes are retransmitted with the DUP flag. ``closed`` is then
    only set by :meth:`close` (or when reconnection is off)."""

    #: retransmit unacked QoS-1 publishes older than this (seconds)
    RETRY_SEC = 2.0

    def __init__(self, host: str, port: int, client_id: str = "",
                 keepalive: int = 60, auto_reconnect: bool = False,
                 max_backoff: float = 2.0, reconnect_delay: float = 0.0,
                 max_retries: int = 20):
        self.host, self.port = host, port
        self.client_id = client_id or f"nns-tpu-{id(self):x}"
        self.keepalive = keepalive
        self.auto_reconnect = auto_reconnect
        self.max_backoff = max_backoff
        #: redial budget per outage — reconnection is BOUNDED (a client
        #: whose broker never comes back must eventually report dead, not
        #: spin forever); None = unbounded
        self.max_retries: Optional[int] = max_retries
        #: wait this long before the first redial attempt. QoS-1 makes the
        #: publisher→broker leg lossless across a bounce, but a restarted
        #: broker has no session state: a retransmit that lands before
        #: subscribers re-subscribe is acked into the void. Publishers set
        #: a small delay so subscribers (delay 0) win that race.
        self.reconnect_delay = reconnect_delay
        self._sock: Optional[socket.socket] = None
        self._stop = threading.Event()
        self._pkt_id = 0
        self._suback: "queue.Queue[int]" = queue.Queue()
        self.inbox: "queue.Queue[Tuple[str, bytes]]" = queue.Queue()
        self._send_lock = lockwitness.make_lock("mqtt.client.send",
                                                blocking_ok=True)
        #: set when the connection is gone for good (recv loop exited and
        #: no reconnection will be attempted)
        self.closed = threading.Event()
        #: set while a live connection exists
        self.connected = threading.Event()
        self._subs: Dict[str, int] = {}  # topic filter -> granted qos
        # unacked QoS-1 publishes: pid -> (topic, payload, last_tx_time)
        self._pending: Dict[int, Tuple[str, bytes, float]] = {}
        self._pending_lock = lockwitness.make_lock("mqtt.client.pending")
        self._recent_rx: "deque[int]" = deque(maxlen=64)  # inbound pid dedup
        #: inbound QoS-1 publishes flagged DUP, and those of them dropped
        #: because their packet id was delivered already
        self.dups_received = 0
        self.dups_dropped = 0
        self._reconnecting = False

    # -- connection lifecycle ----------------------------------------------
    def connect(self, timeout: float = 10.0) -> None:
        self._do_connect(timeout)
        threading.Thread(target=self._recv_loop, daemon=True,
                         name=f"mqtt-{self.client_id}").start()
        # the timer thread drives QoS-1 retransmission always, and PINGREQ
        # when a keepalive is advertised (brokers drop clients silent for
        # 1.5x keepalive, MQTT 3.1.1 §3.1.2.10)
        threading.Thread(target=self._ping_loop, daemon=True,
                         name=f"mqtt-ping-{self.client_id}").start()

    def _do_connect(self, timeout: float) -> None:
        sock = socket.create_connection((self.host, self.port), timeout)
        body = (
            _utf8("MQTT")
            + bytes([4])               # protocol level 3.1.1
            + bytes([0x02])            # clean session
            + self.keepalive.to_bytes(2, "big")
            + _utf8(self.client_id)
        )
        send_packet(sock, CONNECT, body)
        ack = recv_packet(sock)
        if ack.type != CONNACK or len(ack.body) < 2 or ack.body[1] != 0:
            _hard_close(sock)
            raise ConnectionError(f"CONNACK refused: {ack.body!r}")
        self._sock = sock
        self.connected.set()

    def _ping_loop(self) -> None:
        ping_interval = max(self.keepalive / 2.0, 1.0)
        last_ping = time.monotonic()
        while not self._stop.wait(self.RETRY_SEC):
            if self.closed.is_set():
                return
            if not self.connected.is_set():
                continue
            self._retransmit_pending()
            # PINGREQ only at the keepalive cadence (not every retransmit
            # wake), and not at all for keepalive=0 clients
            if self.keepalive <= 0 or \
                    time.monotonic() - last_ping < ping_interval:
                continue
            last_ping = time.monotonic()
            try:
                with self._send_lock:
                    send_packet(self._sock, PINGREQ, b"")
            except OSError:
                continue  # recv loop handles the reconnect

    def _recv_loop(self) -> None:
        try:
            while not self._stop.is_set():
                try:
                    pkt = recv_packet(self._sock)
                except (ConnectionError, OSError, ValueError):
                    self.connected.clear()
                    if self._stop.is_set() or not self.auto_reconnect:
                        break
                    if not self._redial():
                        break
                    continue
                try:
                    self._dispatch(pkt)
                except Exception as e:  # noqa: BLE001 — malformed packet
                    # (bad UTF-8 topic, short body...) must not kill the
                    # receive thread: drop the packet, keep the session
                    log.warning("mqtt %s: dropping malformed %d packet: %s",
                                self.client_id, pkt.type, e)
        finally:
            # the liveness guarantee sources depend on: closed ALWAYS set
            # when this thread exits, whatever the exit path
            self.connected.clear()
            self.closed.set()

    def _dispatch(self, pkt: Packet) -> None:
        if pkt.type == PUBLISH:
            self._on_publish(pkt)
        elif pkt.type == PUBACK:
            pid = int.from_bytes(pkt.body[:2], "big")
            with self._pending_lock:
                self._pending.pop(pid, None)
        elif pkt.type == SUBACK:
            self._suback.put(int.from_bytes(pkt.body[:2], "big"))
        elif pkt.type == PINGREQ:
            try:
                with self._send_lock:
                    send_packet(self._sock, PINGRESP, b"")
            except OSError:
                pass

    def _on_publish(self, pkt: Packet) -> None:
        tlen = int.from_bytes(pkt.body[:2], "big")
        topic = pkt.body[2 : 2 + tlen].decode("utf-8")
        off = 2 + tlen
        qos = (pkt.flags >> 1) & 0x03
        if qos:
            pid = int.from_bytes(pkt.body[off : off + 2], "big")
            off += 2
            try:
                with self._send_lock:
                    send_packet(self._sock, PUBACK, pid.to_bytes(2, "big"))
            except OSError:
                pass
            if pkt.flags & 0x08:
                self.dups_received += 1
                if pid in self._recent_rx:
                    self.dups_dropped += 1
                    return  # DUP of a message we already delivered
            self._recent_rx.append(pid)
        self.inbox.put((topic, pkt.body[off:]))

    def _redial(self) -> bool:
        """Bounded backoff+jitter redial (at most ``max_retries`` attempts
        per outage); re-subscribe and retransmit unacked QoS-1 publishes.
        Returns False when stopping or out of retries."""
        import random

        backoff = 0.05
        attempts = 0
        if self.reconnect_delay > 0 and self._stop.wait(self.reconnect_delay):
            return False
        while not self._stop.is_set():
            if self.max_retries is not None and attempts >= self.max_retries:
                log.warning("mqtt %s: gave up on %s:%d after %d redial "
                            "attempts", self.client_id, self.host, self.port,
                            attempts)
                return False
            attempts += 1
            try:
                self._do_connect(timeout=5.0)
            except (OSError, ValueError):
                # ValueError: malformed CONNACK from a half-up broker —
                # treat like a failed dial and back off; full jitter
                # (0.5–1.5x) keeps a client herd from re-dialing a
                # recovering broker in lockstep
                if self._stop.wait(backoff * (0.5 + random.random())):
                    return False
                backoff = min(backoff * 2, self.max_backoff)
                continue
            log.info("mqtt %s: reconnected to %s:%d", self.client_id,
                     self.host, self.port)
            try:
                for topic, qos in list(self._subs.items()):
                    self._send_subscribe(topic, qos)
                self._retransmit_pending(force=True)
            except OSError:
                self.connected.clear()
                continue  # connection died again mid-restore: redial
            return True
        return False

    def _retransmit_pending(self, force: bool = False) -> None:
        now = time.monotonic()
        with self._pending_lock:
            items = [(pid, t, p) for pid, (t, p, ts) in self._pending.items()
                     if force or now - ts > self.RETRY_SEC]
            for pid, t, p in items:
                self._pending[pid] = (t, p, now)
        for pid, topic, payload in items:
            body = _utf8(topic) + pid.to_bytes(2, "big") + payload
            try:
                with self._send_lock:
                    # QoS-1 + DUP (MQTT 3.1.1 §3.3.1.1)
                    send_packet(self._sock, PUBLISH, body, flags=0x0A)
            except OSError:
                return

    # -- application surface ------------------------------------------------
    def _send_subscribe(self, topic: str, qos: int) -> int:
        self._pkt_id = self._pkt_id % 0xFFFF + 1
        pid = self._pkt_id
        body = pid.to_bytes(2, "big") + _utf8(topic) + bytes([qos])
        with self._send_lock:
            send_packet(self._sock, SUBSCRIBE, body, flags=2)
        return pid

    def subscribe(self, topic: str, qos: int = 0, timeout: float = 5.0) -> None:
        self._subs[topic] = qos
        pid = self._send_subscribe(topic, qos)
        # match on OUR packet id: redial re-subscriptions also produce
        # SUBACKs (with no consumer at the time), so stale acks may sit in
        # the queue — discard until ours arrives
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"no SUBACK for {topic!r}")
            try:
                if self._suback.get(timeout=remaining) == pid:
                    return
            except queue.Empty:
                raise TimeoutError(f"no SUBACK for {topic!r}")

    def publish(self, topic: str, payload: bytes, qos: int = 0) -> None:
        """QoS 0: fire-and-forget. QoS 1: tracked until PUBACK; with
        auto_reconnect a send failure queues the message for retransmit
        after redial instead of raising."""
        if qos == 0:
            with self._send_lock:
                send_packet(self._sock, PUBLISH, _utf8(topic) + payload)
            return
        self._pkt_id = self._pkt_id % 0xFFFF + 1
        pid = self._pkt_id
        with self._pending_lock:
            self._pending[pid] = (topic, payload, time.monotonic())
        body = _utf8(topic) + pid.to_bytes(2, "big") + payload
        try:
            with self._send_lock:
                send_packet(self._sock, PUBLISH, body, flags=0x02)
        except OSError:
            if not self.auto_reconnect:
                with self._pending_lock:
                    self._pending.pop(pid, None)
                raise
            # stays in _pending; _redial retransmits with DUP

    def pending_count(self) -> int:
        with self._pending_lock:
            return len(self._pending)

    def recv(self, timeout: Optional[float] = None) -> Optional[Tuple[str, bytes]]:
        try:
            return self.inbox.get(timeout=timeout)
        except queue.Empty:
            return None

    def close(self) -> None:
        self._stop.set()
        if self._sock is not None:
            try:
                send_packet(self._sock, DISCONNECT, b"")
            except OSError:
                pass
            _hard_close(self._sock)
            self._sock = None


class MqttBroker:
    """In-process broker (QoS 0/1) for loopback pipelines and tests.

    QoS-1 inbound PUBLISHes are PUBACK'd and fanned out at
    min(publish-qos, subscribe-qos); subscriber PUBACKs are absorbed
    (delivery rides the same in-process TCP connection, so the
    at-least-once contract holds without broker-side retransmit)."""

    def __init__(self, host: str = "localhost", port: int = 0):
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self.port = self._listener.getsockname()[1]
        self._stop = threading.Event()
        self._lock = lockwitness.make_lock("mqtt.broker.registry")
        # conn -> {topic filter: granted qos}
        self._subs: Dict[socket.socket, Dict[str, int]] = {}
        self._next_pid: Dict[socket.socket, int] = {}
        # conn -> send mutex: fanout runs on the *publisher's* handler
        # thread, so two publishers (or a publisher and the subscriber's
        # own handler sending SUBACK/PINGRESP) could interleave sendall()
        # bytes on one socket without this.
        self._send_locks: Dict[socket.socket, threading.Lock] = {}
        #: inbound publishes flagged DUP (a publisher's retransmits)
        self.dups_received = 0

    def start(self) -> None:
        self._listener.listen(16)
        threading.Thread(target=self._accept_loop, daemon=True, name="mqtt-broker").start()

    def _accept_loop(self) -> None:
        self._listener.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(
                target=self._client_loop, args=(conn,), daemon=True,
                name="mqtt-broker-conn",
            ).start()

    def _client_loop(self, conn: socket.socket) -> None:
        try:
            pkt = recv_packet(conn)
            if pkt.type != CONNECT:
                conn.close()
                return
            send_packet(conn, CONNACK, bytes([0, 0]))
            with self._lock:
                self._subs[conn] = {}
                self._next_pid[conn] = 0
                self._send_locks[conn] = lockwitness.make_lock(
                    "mqtt.broker.send", blocking_ok=True)
            while not self._stop.is_set():
                pkt = recv_packet(conn)
                if pkt.type == PUBLISH:
                    tlen = int.from_bytes(pkt.body[:2], "big")
                    topic = pkt.body[2 : 2 + tlen].decode("utf-8")
                    off = 2 + tlen
                    qos = (pkt.flags >> 1) & 0x03
                    if pkt.flags & 0x08:
                        self.dups_received += 1
                    if qos:
                        pid = pkt.body[off : off + 2]
                        off += 2
                        self._send(conn, PUBACK, pid)
                    self._fanout(topic, pkt.body[off:], qos)
                elif pkt.type == PUBACK:
                    pass  # subscriber ack: delivery is same-connection TCP
                elif pkt.type == SUBSCRIBE:
                    pid = pkt.body[:2]
                    topics = self._parse_sub_topics(pkt.body[2:])
                    with self._lock:
                        self._subs[conn].update(
                            {t: min(q, 1) for t, q in topics})
                    self._send(conn, SUBACK,
                               pid + bytes([min(q, 1) for _, q in topics]))
                elif pkt.type == PINGREQ:
                    self._send(conn, PINGRESP, b"")
                elif pkt.type == DISCONNECT:
                    break
        except (ConnectionError, OSError, ValueError):
            pass
        finally:
            with self._lock:
                self._subs.pop(conn, None)
                self._next_pid.pop(conn, None)
                self._send_locks.pop(conn, None)
            _hard_close(conn)

    @staticmethod
    def _parse_sub_topics(body: bytes) -> List[Tuple[str, int]]:
        topics, off = [], 0
        while off + 2 <= len(body):
            ln = int.from_bytes(body[off : off + 2], "big")
            topic = body[off + 2 : off + 2 + ln].decode("utf-8")
            qoff = off + 2 + ln
            qos = body[qoff] if qoff < len(body) else 0
            topics.append((topic, qos))
            off = qoff + 1
        return topics

    def _send(self, conn: socket.socket, ptype: int, body: bytes,
              flags: int = 0) -> None:
        """send_packet under the connection's send mutex."""
        with self._lock:
            lock = self._send_locks.get(conn)
        if lock is None:  # pre-CONNACK or already closed: no contention
            send_packet(conn, ptype, body, flags=flags)
            return
        with lock:
            send_packet(conn, ptype, body, flags=flags)

    def _fanout(self, topic: str, payload: bytes, pub_qos: int) -> None:
        with self._lock:
            targets = []
            for c, filters in self._subs.items():
                qos = -1
                for f, q in filters.items():
                    if topic_matches(f, topic):
                        qos = max(qos, min(q, pub_qos))
                if qos >= 0:
                    if qos:
                        self._next_pid[c] = self._next_pid[c] % 0xFFFF + 1
                    targets.append((c, qos, self._next_pid.get(c, 0)))
        for c, qos, pid in targets:
            body = _utf8(topic)
            if qos:
                body += pid.to_bytes(2, "big")
            try:
                self._send(c, PUBLISH, body + payload,
                           flags=0x02 if qos else 0)
            except OSError:
                pass

    def close(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._subs)
            self._subs.clear()
            self._next_pid.clear()
        for c in conns:
            _hard_close(c)
