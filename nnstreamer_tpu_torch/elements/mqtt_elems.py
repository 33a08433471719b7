"""mqttsrc / mqttsink: MQTT pub-sub stream elements.

Parity: gst/mqtt/ (3449 LoC, paho MQTTAsync) — mqttsink publishes each
buffer to a topic with its caps and an NTP epoch in the message (the
serialized-caps-in-header + synchronization-in-mqtt-elements.md model);
mqttsrc subscribes, renegotiates from the carried caps, and optionally
rebases timestamps onto the local clock (``sync-epoch=1``).

The payload is an NTEQ-encoded message (edge/protocol.py) inside the MQTT
application payload, so tensors stay self-describing. ``broker=embedded``
on mqttsink starts an in-process broker (edge/mqtt.py) — the loopback
deployment the reference's tests assume an external mosquitto for.

Resilience properties (both elements): ``qos=1`` publishes/subscribes at
QoS 1 (PUBACK-tracked, DUP retransmit); ``reconnect=1`` survives a broker
bounce with backoff redial + re-subscribe + retransmission of unacked
frames; mqttsink additionally staggers its redial by
``reconnect-delay`` (default 0.5 s) so subscribers re-subscribe first
(see MqttClient.reconnect_delay).

A copy of the JAX package's elements; each package's sink publishes to
the other's source, payload bytes equal for the same buffer. mqttsink is
a host consumer (``accepts_device`` stays False), so on a planned line
the filter before it fetches once, at its boundary; tensors that still
reach it on the card come to the host once a buffer, in
``protocol.buffer_to_message``.
"""

from __future__ import annotations

import time
from typing import Optional

from nnstreamer_tpu_torch.analysis.schema import Prop
from nnstreamer_tpu_torch.buffer import Buffer
from nnstreamer_tpu_torch.caps import Caps
from nnstreamer_tpu_torch.edge import protocol as proto
from nnstreamer_tpu_torch.edge.mqtt import MqttBroker, MqttClient
from nnstreamer_tpu_torch.edge.ntp import ClockSync, get_epoch
from nnstreamer_tpu_torch.log import ElementError
from nnstreamer_tpu_torch.pipeline.element import (
    Element,
    FlowReturn,
    Pad,
    SourceElement,
    element_register,
)

DEFAULT_TOPIC = "nns/tensors"


@element_register
class MqttSink(Element):
    ELEMENT_NAME = "mqttsink"
    SINK_TEMPLATE = "ANY"
    PROPERTY_SCHEMA = {
        "host": Prop("str"),
        "port": Prop("int"),
        "topic": Prop("str"),
        "qos": Prop("int"),
        "broker": Prop("str", doc="'embedded' starts an in-process broker"),
        "reconnect": Prop("bool"),
        "reconnect_delay": Prop("number"),
        "reconnect_retries": Prop("int"),
        "ntp": Prop("bool"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._client: Optional[MqttClient] = None
        self._broker: Optional[MqttBroker] = None
        self._caps_str = ""

    def _setup_pads(self) -> None:
        self.add_sink_pad("sink")

    def start(self) -> None:
        host = str(self.properties.get("host", "localhost"))
        port = int(self.properties.get("port", 1883))
        if str(self.properties.get("broker", "")) == "embedded":
            self._broker = MqttBroker(host=host, port=int(self.properties.get("port", 0)))
            self._broker.start()
            port = self._broker.port
        self._qos = int(self.properties.get("qos", 0))
        reconnect = bool(int(self.properties.get("reconnect", 0)))
        # publishers redial a beat after subscribers (see
        # MqttClient.reconnect_delay for the subscription-gap race)
        delay = float(self.properties.get("reconnect_delay", 0.5))
        self._client = MqttClient(
            host, port, client_id=f"sink-{self.name}",
            auto_reconnect=reconnect, reconnect_delay=delay,
            max_retries=int(self.properties.get("reconnect_retries", 20)))
        try:
            self._client.connect()
        except Exception as e:
            raise ElementError(self.name, f"cannot reach MQTT broker {host}:{port}: {e}")
        # NTP offset is sampled ONCE here, not per buffer (the reference
        # caches the epoch the same way; per-frame SNTP would stall chains)
        self._epoch_offset_us = 0
        if self.properties.get("ntp"):
            self._epoch_offset_us = get_epoch() - int(time.time() * 1e6)

    def stop(self) -> None:
        if self._client is not None:
            self._client.close()
            self._client = None
        if self._broker is not None:
            self._broker.close()
            self._broker = None

    @property
    def port(self) -> int:
        """Broker port when embedded (port=0 → OS-assigned)."""
        if self._broker is not None:
            return self._broker.port
        return int(self.properties.get("port", 1883))

    def transform_caps(self, pad: Pad, caps: Caps) -> Optional[Caps]:
        self._caps_str = str(caps)
        return None  # terminal element

    def chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        topic = str(self.properties.get("topic", DEFAULT_TOPIC))
        msg = proto.buffer_to_message(
            buf,
            proto.MSG_DATA,
            caps=self._caps_str,
            epoch_us=int(time.time() * 1e6) + self._epoch_offset_us,
        )
        try:
            self._client.publish(topic, proto.encode_message(msg),
                                 qos=self._qos)
        except OSError as e:
            raise ElementError(self.name, f"publish failed: {e}")
        return FlowReturn.OK


@element_register
class MqttSrc(SourceElement):
    ELEMENT_NAME = "mqttsrc"
    PROPERTY_SCHEMA = {
        "host": Prop("str"),
        "port": Prop("int"),
        "topic": Prop("str"),
        "qos": Prop("int"),
        "caps": Prop("caps"),
        "reconnect": Prop("bool"),
        "reconnect_delay": Prop("number"),
        "reconnect_retries": Prop("int"),
        "sync_epoch": Prop("bool"),
        "ntp": Prop("bool"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._client: Optional[MqttClient] = None
        self._sync = ClockSync()
        self._sent_caps: Optional[str] = None

    def start(self) -> None:
        host = str(self.properties.get("host", "localhost"))
        port = int(self.properties.get("port", 1883))
        qos = int(self.properties.get("qos", 0))
        reconnect = bool(int(self.properties.get("reconnect", 0)))
        self._client = MqttClient(
            host, port, client_id=f"src-{self.name}",
            auto_reconnect=reconnect,
            max_retries=int(self.properties.get("reconnect_retries", 20)))
        try:
            self._client.connect()
            self._client.subscribe(
                str(self.properties.get("topic", DEFAULT_TOPIC)), qos=qos)
        except Exception as e:
            raise ElementError(self.name, f"cannot reach MQTT broker {host}:{port}: {e}")

    def stop(self) -> None:
        if self._client is not None:
            self._client.close()
            self._client = None

    def negotiate(self) -> Optional[Caps]:
        fixed = self.properties.get("caps")
        if fixed:
            return Caps.from_string(str(fixed))
        return Caps.from_string("other/tensors,format=flexible")

    def create(self) -> Optional[Buffer]:
        while True:
            if self.pipeline is not None and not self.pipeline._running.is_set():
                return None
            item = self._client.recv(timeout=0.2)
            if item is None:
                if self._client.closed.is_set() and self._client.inbox.empty():
                    return None  # broker/publisher went away → EOS
                continue
            _topic, payload = item
            try:
                msg = proto.decode_message(payload)
            except proto.ProtocolError:
                continue  # not an NNS payload on this topic: skip
            # renegotiate from the caps carried in-band (serialized-caps-in-
            # header model) when the publisher's stream type changes
            carried = msg.meta.get("caps")
            if carried and carried != self._sent_caps and not self.properties.get("caps"):
                from nnstreamer_tpu_torch.buffer import Event

                for sp in self.src_pads:
                    sp.push_event(Event("caps", {"caps": Caps.from_string(str(carried))}))
                self._sent_caps = str(carried)
            epoch = msg.meta.get("epoch_us")
            if epoch is not None:
                self._sync.observe(int(epoch))
            buf = proto.message_to_buffer(msg)
            if bool(self.properties.get("sync_epoch", False)):
                buf.pts = self._sync.to_local_ns(buf.pts)
            return buf
