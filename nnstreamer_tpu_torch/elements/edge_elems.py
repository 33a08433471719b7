"""edgesrc / edgesink: lightweight pub-sub stream elements.

Parity: gst/edge/edge_sink.c:291-407 / edge_src.c:331-376 — edgesink is
the publisher (it owns the listener; every connected edgesrc receives each
buffer), edgesrc subscribes by connecting to the sink's host:port.
``topic`` filters streams when several publishers share a port fan-in.
Timestamps can be rebased with the NTP epoch carried per message
(mqtt-hybrid sync model, Documentation/synchronization-in-mqtt-elements.md).

A copy of the JAX package's elements: over TCP, or ``connect-type=HYBRID``
with the publisher's TCP endpoint announced and discovered over MQTT
(``edge/discovery.py``); each package's sink feeds the other's source.
"""

from __future__ import annotations

import time
from typing import Optional

from nnstreamer_tpu_torch.analysis.schema import Prop
from nnstreamer_tpu_torch.buffer import Buffer
from nnstreamer_tpu_torch.caps import Caps
from nnstreamer_tpu_torch.edge import protocol as proto
from nnstreamer_tpu_torch.edge.handle import EdgeClient, EdgeServer
from nnstreamer_tpu_torch.edge.ntp import ClockSync
from nnstreamer_tpu_torch.log import ElementError
from nnstreamer_tpu_torch.pipeline.element import (
    Element,
    FlowReturn,
    Pad,
    SourceElement,
    element_register,
)


@element_register
class EdgeSink(Element):
    ELEMENT_NAME = "edgesink"
    SINK_TEMPLATE = "other/tensors"
    PROPERTY_SCHEMA = {
        "host": Prop("str"),
        "port": Prop("int"),
        "connect_type": Prop("enum", enum=("TCP", "HYBRID")),
        "topic": Prop("str"),
        "timeout": Prop("number"),
        "dest_host": Prop("str", doc="HYBRID broker host"),
        "dest_port": Prop("int", doc="HYBRID broker port"),
        "announce_host": Prop("str", doc="HYBRID announce address override"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._server: Optional[EdgeServer] = None
        self._caps_str = ""

    def _setup_pads(self) -> None:
        self.add_sink_pad("sink")

    def start(self) -> None:
        host = str(self.properties.get("host", "localhost"))
        port = int(self.properties.get("port", 0))
        self._server = EdgeServer(host=host, port=port, caps=self._caps_str)
        self._server.start()
        if str(self.properties.get("connect_type", "TCP")).upper() == "HYBRID":
            # hybrid mode: publish our TCP endpoint on the broker named by
            # dest-host/dest-port (nnstreamer-edge HYBRID parity)
            from nnstreamer_tpu_torch.edge.discovery import start_hybrid_announcer

            self._announcer = start_hybrid_announcer(
                self.name, self.properties, host, self._server.port
            )
        self.post_message("server-started", {"port": self._server.port})

    def stop(self) -> None:
        ann = getattr(self, "_announcer", None)
        if ann is not None:
            ann.close()
            self._announcer = None
        if self._server is not None:
            self._server.close()
            self._server = None

    @property
    def port(self) -> int:
        return self._server.port if self._server else 0

    def transform_caps(self, pad: Pad, caps: Caps) -> Optional[Caps]:
        # remember negotiated caps so late subscribers get them in the
        # CAPABILITY handshake (nns_edge caps advertisement)
        self._caps_str = str(caps)
        if self._server is not None:
            self._server.caps = self._caps_str
        return None  # terminal element

    def chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        topic = str(self.properties.get("topic", ""))
        msg = proto.buffer_to_message(
            buf,
            proto.MSG_DATA,
            topic=topic,
            epoch_us=int(time.time() * 1e6),
        )
        self._server.broadcast(msg)
        return FlowReturn.OK


@element_register
class EdgeSrc(SourceElement):
    ELEMENT_NAME = "edgesrc"
    PROPERTY_SCHEMA = {
        "host": Prop("str"),
        "port": Prop("int"),
        "connect_type": Prop("enum", enum=("TCP", "HYBRID")),
        "topic": Prop("str"),
        "timeout": Prop("number"),
        "reconnect": Prop("bool"),
        "reconnect_retries": Prop("int"),
        "sync_epoch": Prop("bool"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._client: Optional[EdgeClient] = None
        self._sync = ClockSync()

    def start(self) -> None:
        host = str(self.properties.get("host", "localhost"))
        port = int(self.properties.get("port", 0))
        if str(self.properties.get("connect_type", "TCP")).upper() == "HYBRID":
            from nnstreamer_tpu_torch.edge.discovery import discover

            topic = str(self.properties.get("topic", ""))
            if not topic or not port:
                raise ElementError(
                    self.name,
                    "connect-type=HYBRID needs topic= and broker host=/port=",
                )
            try:
                host, port = discover(
                    host, port, topic,
                    timeout=float(self.properties.get("timeout", 10.0)),
                )
            except Exception as e:
                raise ElementError(self.name, f"hybrid discovery failed: {e}")
        if not port:
            raise ElementError(self.name, "edgesrc needs port=")
        self._client = EdgeClient(
            host, port, timeout=float(self.properties.get("timeout", 10.0)),
            # reconnect=1: survive a publisher bounce (bounded backoff +
            # jitter); EOS only once the retry budget is exhausted
            reconnect=bool(int(self.properties.get("reconnect", 0) or 0)),
            max_retries=int(self.properties.get("reconnect_retries", 5)),
        )
        try:
            self._client.connect()
        except Exception as e:
            raise ElementError(self.name, f"cannot connect to {host}:{port}: {e}")

    def stop(self) -> None:
        if self._client is not None:
            self._client.close()
            self._client = None

    def negotiate(self) -> Optional[Caps]:
        if self._client and self._client.server_caps:
            return Caps.from_string(self._client.server_caps)
        return Caps.from_string("other/tensors,format=flexible")

    def create(self) -> Optional[Buffer]:
        want_topic = str(self.properties.get("topic", ""))
        while True:
            if self.pipeline is not None and not self.pipeline._running.is_set():
                return None
            msg = self._client.recv(timeout=0.2)
            if msg is None:
                if self._client.closed.is_set() and self._client.recv_queue.empty():
                    return None  # publisher went away → EOS
                continue
            if want_topic and str(msg.meta.get("topic", "")) != want_topic:
                continue
            epoch = msg.meta.get("epoch_us")
            if epoch is not None:
                self._sync.observe(int(epoch))
            buf = proto.message_to_buffer(msg)
            buf.meta.pop("client_id", None)
            if bool(self.properties.get("sync_epoch", False)):
                buf.pts = self._sync.to_local_ns(buf.pts)
            return buf
