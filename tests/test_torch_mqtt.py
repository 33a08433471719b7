"""The port's MQTT transport (``edge/mqtt.py``, ``edge/ntp.py``,
``elements/mqtt_elems.py``) against the JAX package's, on the CPU.

- ``tests/test_mqtt.py``'s cases through the port: topic matching (held
  equal to the JAX package's too), pub/sub and wildcards on the in-process
  broker, mqttsink to mqttsrc with caps carried in-band, a missing broker,
  QoS 1 (PUBACK, DUP dedup, with the port's duplicate counters) and a
  broker bounce survived by ``qos=1 reconnect=1``.
- Across packages: each package's client on the other's broker, each
  package's mqttsink into the other's mqttsrc, and the NTEQ payload that
  each package's mqttsink publishes for the same buffer, byte-equal on the
  wire (the epoch stamp pinned).
- mqttsink is a host consumer: the filter before it fetches once a
  buffer, at its boundary, and mqttsink crosses nothing.
- A narrow MobileNet-v2 (64 px, width 0.35, 16 classes) behind mqttsrc in
  each package on the same frames, the port on flax's weights through
  ``from_jax_variables`` (tests/test_torch_pipeline.py's fixture): labels
  equal, logits within tests/test_torch_query_lines.py's bf16 tolerance
  (atol 0.15, rtol 0.05).
- ``get_epoch`` against a local UDP SNTP responder in both packages, and
  its fall-back to the local clock.

Every broker and server binds ``port=0``; a port that must refuse is one
bound and closed first. Every wait has a bound.
"""

import socket
import struct
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_shared import (  # noqa: E402,F401 (fixtures)
    equal_name_counters,
    one_torch_thread,
)
jax = pytest.importorskip("jax")

from nnstreamer_tpu import pipeline as jpipeline  # noqa: E402
from nnstreamer_tpu.buffer import Buffer as JBuffer  # noqa: E402
from nnstreamer_tpu.edge import mqtt as jmqtt  # noqa: E402
from nnstreamer_tpu.edge import ntp as jntp  # noqa: E402
from nnstreamer_tpu.elements import mqtt_elems as jelems  # noqa: E402
from nnstreamer_tpu_torch import pipeline as tpipeline  # noqa: E402
from nnstreamer_tpu_torch import trace as ttrace  # noqa: E402
from nnstreamer_tpu_torch.buffer import Buffer as TBuffer  # noqa: E402
from nnstreamer_tpu_torch.edge import mqtt as tmqtt  # noqa: E402
from nnstreamer_tpu_torch.edge import ntp as tntp  # noqa: E402
from nnstreamer_tpu_torch.elements import mqtt_elems as telems  # noqa: E402
from test_torch_pipeline import CUSTOM, weights  # noqa: E402,F401

CAPS4 = "other/tensors,num-tensors=1,dimensions=4,types=float32,framerate=30/1"
CPU = "accelerator=true:cpu"

PKG = {"jax": dict(pipeline=jpipeline, Buffer=JBuffer, mqtt=jmqtt,
                   ntp=jntp, elems=jelems),
       "port": dict(pipeline=tpipeline, Buffer=TBuffer, mqtt=tmqtt,
                    ntp=tntp, elems=telems)}
PAIRS = [("port", "port"), ("jax", "port"), ("port", "jax")]


def _wait_for(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def _closed_port() -> int:
    """A port nothing listens on: bound, then closed."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _subscribed(broker) -> bool:
    """Some client of ``broker`` holds a subscription."""
    with broker._lock:
        return any(broker._subs.values())


@pytest.fixture
def broker():
    b = tmqtt.MqttBroker()
    b.start()
    yield b
    b.close()


# -- tests/test_mqtt.py through the port -----------------------------------

@pytest.mark.parametrize(
    "pattern,topic,ok",
    [("a/b", "a/b", True), ("a/b", "a/c", False), ("a/+", "a/b", True),
     ("a/+", "a/b/c", False), ("a/#", "a/b/c", True),
     ("#", "anything/at/all", True), ("+/b", "a/b", True),
     ("a/+/c", "a/x/c", True)])
def test_topic_match(pattern, topic, ok):
    assert tmqtt.topic_matches(pattern, topic) is ok
    assert jmqtt.topic_matches(pattern, topic) is ok


def test_pub_sub_roundtrip(broker):
    sub = tmqtt.MqttClient("localhost", broker.port, "sub1")
    pub = tmqtt.MqttClient("localhost", broker.port, "pub1")
    sub.connect()
    pub.connect()
    try:
        sub.subscribe("t/x")
        pub.publish("t/x", b"hello")
        assert sub.recv(timeout=5.0) == ("t/x", b"hello")
        pub.publish("t/other", b"nope")  # not delivered
        assert sub.recv(timeout=0.3) is None
    finally:
        sub.close()
        pub.close()


def test_wildcard_subscription(broker):
    sub = tmqtt.MqttClient("localhost", broker.port)
    pub = tmqtt.MqttClient("localhost", broker.port)
    sub.connect()
    pub.connect()
    try:
        sub.subscribe("nns/#")
        pub.publish("nns/stream/7", b"payload")
        assert sub.recv(timeout=5.0) == ("nns/stream/7", b"payload")
    finally:
        sub.close()
        pub.close()


def test_sink_to_src():
    pub = tpipeline.parse_launch(
        f"appsrc name=src caps={CAPS4} "
        "! mqttsink name=sink broker=embedded port=0 topic=nns/t1")
    pub.play()
    sub = None
    try:
        sub = tpipeline.parse_launch(
            f"mqttsrc name=msrc port={pub['sink'].port} topic=nns/t1 "
            "! tensor_sink name=out")
        sub.play()
        assert _wait_for(lambda: _subscribed(pub["sink"]._broker), 5)
        for i in range(3):
            pub["src"].push_buffer(TBuffer(
                tensors=[np.full(4, float(i), np.float32)], pts=i * 7))
        assert _wait_for(lambda: len(sub["out"].collected) >= 3, 5)
        outs = list(sub["out"].collected)
        caps = str(sub["out"].sink_pad.caps)
    finally:
        if sub is not None:
            sub.stop()
        pub.stop()
    assert len(outs) == 3
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(np.asarray(o[0]).reshape(-1),
                                      np.full(4, float(i), np.float32))
        assert o.pts == i * 7
    # caps travel in-band AND renegotiate the subscriber's stream
    assert "dimensions=4" in outs[0].meta.get("caps", "")
    assert "dimensions=4" in caps


def test_src_without_broker_errors():
    p = tpipeline.parse_launch(
        f"mqttsrc port={_closed_port()} ! tensor_sink name=out")
    try:
        with pytest.raises(Exception, match="broker"):
            p.play()
    finally:
        p.stop()


def test_puback_clears_pending(broker):
    sub = tmqtt.MqttClient("localhost", broker.port, "s")
    pub = tmqtt.MqttClient("localhost", broker.port, "p")
    sub.connect()
    pub.connect()
    try:
        sub.subscribe("q/t", qos=1)
        pub.publish("q/t", b"once", qos=1)
        assert sub.recv(timeout=5.0) == ("q/t", b"once")
        assert _wait_for(lambda: pub.pending_count() == 0, 2), \
            "PUBACK never cleared pending"
        assert broker.dups_received == 0
        assert sub.dups_received == sub.dups_dropped == 0
    finally:
        sub.close()
        pub.close()


def test_inbound_dup_deduplicated(broker):
    """A publisher's QoS-1 retransmit (DUP set, same pid) reaches the
    broker, which counts it and fans it out under a fresh packet id."""
    sub = tmqtt.MqttClient("localhost", broker.port, "s")
    sub.connect()
    s = socket.create_connection(("localhost", broker.port), 5)
    try:
        sub.subscribe("q/d", qos=1)
        tmqtt.send_packet(s, tmqtt.CONNECT, tmqtt._utf8("MQTT") + bytes([4, 2])
                          + (60).to_bytes(2, "big") + tmqtt._utf8("raw"))
        assert tmqtt.recv_packet(s).type == tmqtt.CONNACK
        body = tmqtt._utf8("q/d") + (7).to_bytes(2, "big") + b"payload"
        tmqtt.send_packet(s, tmqtt.PUBLISH, body, flags=0x02)
        tmqtt.send_packet(s, tmqtt.PUBLISH, body, flags=0x0A)  # DUP
        assert sub.recv(timeout=5.0) == ("q/d", b"payload")
        assert _wait_for(lambda: broker.dups_received == 1, 5)
    finally:
        s.close()
        sub.close()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_client_dedups_dup_flag(pkg):
    """Same pid with DUP set: one delivery (the port also counts the DUP
    received and the one dropped)."""
    m = PKG[pkg]["mqtt"]
    c = m.MqttClient("localhost", 1)  # never connected; drive _on_publish
    body = m._utf8("x") + (9).to_bytes(2, "big") + b"v"

    class _NullSock:
        def sendall(self, *_a):
            pass

    c._sock = _NullSock()
    c._on_publish(m.Packet(type=m.PUBLISH, flags=0x02, body=body))
    c._on_publish(m.Packet(type=m.PUBLISH, flags=0x0A, body=body))  # DUP
    c._on_publish(m.Packet(type=m.PUBLISH, flags=0x0A,
                           body=m._utf8("x") + (10).to_bytes(2, "big") + b"w"))
    assert c.inbox.qsize() == 2
    if pkg == "port":
        assert (c.dups_received, c.dups_dropped) == (2, 1)


def test_pipeline_survives_broker_restart():
    """Kill the broker mid-stream and restart it on the same port: with
    qos=1 reconnect=1 every frame comes out the far end."""
    broker = tmqtt.MqttBroker()
    broker.start()
    port = broker.port
    pub = tpipeline.parse_launch(
        f"appsrc name=src caps={CAPS4} "
        f"! mqttsink name=sink port={port} topic=nns/b qos=1 reconnect=1")
    pub.play()
    sub = tpipeline.parse_launch(
        f"mqttsrc name=msrc port={port} topic=nns/b qos=1 reconnect=1 "
        "! tensor_sink name=out")
    sub.play()
    out = sub["out"].collected
    try:
        time.sleep(0.3)
        for i in range(3):
            pub["src"].push_buffer(TBuffer(
                tensors=[np.full(4, float(i), np.float32)]))
        assert _wait_for(lambda: len(out) >= 3, 5)
        broker.close()
        time.sleep(0.2)
        for i in range(3, 6):  # buffered by the sink through the outage
            pub["src"].push_buffer(TBuffer(
                tensors=[np.full(4, float(i), np.float32)]))
        broker = tmqtt.MqttBroker(port=port)
        broker.start()
        assert _wait_for(lambda: len(out) >= 6, 15), \
            f"lost frames across the bounce: {len(out)}/6"
        for i in range(6, 8):
            pub["src"].push_buffer(TBuffer(
                tensors=[np.full(4, float(i), np.float32)]))
        assert _wait_for(lambda: len(out) >= 8, 10)
        vals = {int(np.asarray(b[0]).reshape(-1)[0]) for b in out}
        assert set(range(8)) <= vals  # at least once; no losses
    finally:
        sub.stop()
        pub.stop()
        broker.close()


# -- across packages ---------------------------------------------------------

@pytest.mark.parametrize("client_pkg,broker_pkg", [("port", "jax"),
                                                   ("jax", "port")])
def test_client_on_the_other_packages_broker(client_pkg, broker_pkg):
    """Each package's client publishes and subscribes, QoS 0 and 1, on the
    other's broker; payload bytes arrive unchanged."""
    b = PKG[broker_pkg]["mqtt"].MqttBroker()
    b.start()
    m = PKG[client_pkg]["mqtt"]
    sub, pub = (m.MqttClient("localhost", b.port, n) for n in ("s", "p"))
    try:
        sub.connect()
        pub.connect()
        sub.subscribe("x/#", qos=1)
        payload = bytes(range(256)) * 40
        pub.publish("x/0", payload)
        pub.publish("x/1", payload[::-1], qos=1)
        assert sub.recv(timeout=5.0) == ("x/0", payload)
        assert sub.recv(timeout=5.0) == ("x/1", payload[::-1])
        assert _wait_for(lambda: pub.pending_count() == 0, 2)
    finally:
        sub.close()
        pub.close()
        b.close()


@pytest.mark.parametrize("pub_pkg,sub_pkg", PAIRS)
def test_mqttsink_to_mqttsrc_across_packages(pub_pkg, sub_pkg):
    """Each package's mqttsink (embedded broker) into the other's mqttsrc
    at QoS 1: three frames, values, pts and the carried caps."""
    pk, sk = PKG[pub_pkg], PKG[sub_pkg]
    pub = pk["pipeline"].parse_launch(
        f"appsrc name=src caps={CAPS4} ! mqttsink name=sink "
        "broker=embedded port=0 topic=nns/x qos=1")
    pub.play()
    sub = None
    try:
        sub = sk["pipeline"].parse_launch(
            f"mqttsrc name=msrc port={pub['sink'].port} topic=nns/x qos=1 "
            "! tensor_sink name=out")
        sub.play()
        assert _wait_for(lambda: _subscribed(pub["sink"]._broker), 5)
        for i in range(3):
            pub["src"].push_buffer(pk["Buffer"](
                tensors=[np.full(4, float(i), np.float32)], pts=10 + i))
        assert _wait_for(lambda: len(sub["out"].collected) >= 3, 10)
        outs = list(sub["out"].collected)
    finally:
        if sub is not None:
            sub.stop()
        pub.stop()
    assert [o.pts for o in outs] == [10, 11, 12]
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(np.asarray(o[0]).reshape(-1),
                                      np.full(4, float(i), np.float32))
        assert "dimensions=4" in o.meta.get("caps", "")


class _FixedClock:
    """Stands in for the ``time`` module in the mqtt elements: a fixed
    wall clock, so the epoch each sink stamps is the same."""

    @staticmethod
    def time():
        return 1_700_000_000.25


@pytest.mark.parametrize("frame", ["float32", "uint8_batch", "two_tensors"])
def test_sinks_publish_byte_equal_payloads(monkeypatch, broker, frame):
    """The same buffer through each package's mqttsink onto one broker: a
    raw subscriber receives byte-equal NTEQ payloads (caps, pts, meta and
    flexible-wrapped tensors); a torch tensor in the port encodes to its
    numpy twin's bytes."""
    rng = np.random.default_rng(3)
    tensors, caps = {
        "float32": ([rng.normal(size=4).astype(np.float32)], CAPS4),
        "uint8_batch": ([rng.integers(0, 256, (2, 8, 8, 3)).astype(np.uint8)],
                        "other/tensors,num-tensors=1,dimensions=3:8:8:2,"
                        "types=uint8,framerate=0/1"),
        "two_tensors": ([rng.normal(size=(3, 4)).astype(np.float32),
                         np.arange(5, dtype=np.int32)],
                        "other/tensors,num-tensors=2,dimensions=4:3.5,"
                        "types=float32.int32,framerate=0/1"),
    }[frame]
    for m in (jelems, telems):
        monkeypatch.setattr(m, "time", _FixedClock)
    raw = tmqtt.MqttClient("localhost", broker.port, "raw")
    raw.connect()
    got = {}
    try:
        raw.subscribe("nns/eq/#")
        for pkg in ("jax", "port", "port_torch"):
            k = PKG["port" if pkg == "port_torch" else pkg]
            ts = ([torch.from_numpy(t) for t in tensors]
                  if pkg == "port_torch" else tensors)
            p = k["pipeline"].parse_launch(
                f"appsrc name=src caps={caps} ! mqttsink name=sink "
                f"port={broker.port} topic=nns/eq/{pkg}")
            p.play()
            try:
                p["src"].push_buffer(k["Buffer"](tensors=ts, pts=42,
                                                 duration=7,
                                                 meta={"tenant": "a"}))
                item = raw.recv(timeout=5.0)
            finally:
                p.stop()
            assert item is not None and item[0] == f"nns/eq/{pkg}"
            got[pkg] = item[1]
    finally:
        raw.close()
    assert got["port"] == got["jax"]
    assert got["port_torch"] == got["jax"]
    msg = telems.proto.decode_message(got["port"])
    assert msg.meta["epoch_us"] == 1_700_000_000_250_000
    assert msg.meta["pts"] == 42 and msg.meta["caps"]


def test_mqttsink_is_the_host_boundary():
    """tensor_filter ! mqttsink: the planner makes the filter the boundary
    (one d2h a buffer, there), and mqttsink crosses nothing, as the tee's
    fetch is billed at the filter."""
    caps = "other/tensors,num-tensors=1,dimensions=4,types=float32"
    pub = tpipeline.parse_launch(
        f"appsrc name=src caps={caps} ! tensor_filter name=f framework=jax "
        f"model=add custom=k:1 {CPU} ! mqttsink name=sink broker=embedded "
        "port=0 topic=nns/b")
    tracer = ttrace.attach(pub)
    pub.play()
    sub = None
    try:
        sub = tpipeline.parse_launch(
            f"mqttsrc port={pub['sink'].port} topic=nns/b ! tensor_sink "
            "name=out")
        sub.play()
        time.sleep(0.3)
        for i in range(3):
            pub["src"].push_buffer(TBuffer(
                tensors=[np.full(4, float(i), np.float32)]))
        assert _wait_for(lambda: len(sub["out"].collected) >= 3, 10)
        outs = [np.asarray(b[0]).reshape(-1) for b in sub["out"].collected]
        assert not pub["sink"].accepts_device(pub["sink"].sink_pads[0])
        assert not pub["f"].src_pads[0].device_ok
    finally:
        if sub is not None:
            sub.stop()
        pub.stop()
    per = tracer.crossings()["per_element"]
    assert per["f"]["d2h"] == 3 and per["f"]["d2h_bytes"] == 3 * 16
    assert "sink" not in per or per["sink"].get("d2h", 0) == 0
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(o, np.full(4, i + 1.0, np.float32))


# -- MobileNet-v2 behind mqttsrc ---------------------------------------------

SIZE = 64
N_FRAMES = 8


def _camera(pkg, custom, frames):
    """appsrc ! tensor_converter frames-per-tensor=4 ! mqttsink qos=1 into
    mqttsrc qos=1 ! tensor_filter model=mobilenet_v2 ! tensor_sink, both
    lines of package ``pkg``; returns the filter's outputs per buffer."""
    k = PKG[pkg]
    extra = f" {CPU}" if pkg == "port" else ""
    pub = k["pipeline"].parse_launch(
        f"appsrc name=src caps=video/x-raw,format=RGB,width={SIZE},"
        f"height={SIZE},framerate=30/1 ! tensor_converter "
        "frames-per-tensor=4 ! mqttsink name=sink broker=embedded port=0 "
        "topic=nns/cam qos=1")
    pub.play()
    sub = None
    try:
        sub = k["pipeline"].parse_launch(
            f"mqttsrc name=msrc port={pub['sink'].port} topic=nns/cam qos=1 "
            f"! tensor_filter name=f framework=jax model=mobilenet_v2 "
            f"custom={custom}{extra} ! tensor_sink name=out")
        sub.play()
        time.sleep(0.3)
        for i, f in enumerate(frames):
            pub["src"].push_buffer(k["Buffer"](tensors=[f], pts=i))
        assert _wait_for(lambda: len(sub["out"].collected) >= 2, 120)
        assert sub.bus.error is None, sub.bus.error
        outs = [np.asarray(b.tensors[0]) for b in sub["out"].collected]
        pts = [b.pts for b in sub["out"].collected]
    finally:
        if sub is not None:
            sub.stop()
        pub.stop()
    assert pts == [3, 7]
    return outs


@pytest.mark.parametrize("form", ["logits", "argmax"])
def test_mobilenet_behind_mqttsrc_matches(weights, form):
    """The same frames over MQTT into each package's filter, the port on
    flax's weights carried by from_jax_variables (npz), as
    tests/test_torch_query_lines.py serves them: logits on flax's seed:0
    weights as they are, labels (postproc:argmax) on the perturbed ones
    (the JAX package reads them from msgpack), which give distinct
    labels."""
    msgpack, npz, npz_seed0, _, frames = weights
    if form == "argmax":
        customs = {"jax": f"params:{msgpack},postproc:argmax,{CUSTOM}",
                   "port": f"params:{npz},postproc:argmax,{CUSTOM}"}
    else:
        customs = {"jax": f"seed:0,{CUSTOM}",
                   "port": f"params:{npz_seed0},{CUSTOM}"}
    got = {pkg: _camera(pkg, customs[pkg], frames) for pkg in PKG}
    for g, w in zip(got["port"], got["jax"]):
        assert g.shape == w.shape
        if form == "argmax":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, atol=0.15, rtol=0.05)
            np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))
    if form == "argmax":  # the perturbed weights tell frames apart
        labels = np.concatenate([w.reshape(-1) for w in got["jax"]])
        assert len(set(labels.tolist())) > 1


# -- SNTP --------------------------------------------------------------------

class _SntpResponder:
    """A UDP SNTP server on 127.0.0.1 (port 0): answers every mode-3
    request with a fixed transmit timestamp."""

    def __init__(self, epoch: float):
        secs = int(epoch)
        frac = int(round((epoch - secs) * 2 ** 32))
        self.reply = (bytes([0x24]) + bytes(39)
                      + struct.pack("!II", secs + jntp.NTP_DELTA, frac))
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.settimeout(0.2)
        self.port = self.sock.getsockname()[1]
        self.requests = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop.is_set():
            try:
                data, addr = self.sock.recvfrom(512)
            except socket.timeout:
                continue
            except OSError:
                return
            self.requests.append(data)
            self.sock.sendto(self.reply, addr)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
        self.sock.close()


def test_get_epoch_from_local_sntp_server():
    """Both packages read the same epoch from a local SNTP responder, as a
    mode-3 client request of 48 bytes; the first reachable server wins."""
    srv = _SntpResponder(1_650_000_000.5)
    try:
        servers = [("127.0.0.1", _closed_udp_port()),
                   ("127.0.0.1", srv.port)]
        got = {pkg: PKG[pkg]["ntp"].get_epoch(servers=servers, timeout=0.3)
               for pkg in PKG}
        q = {pkg: PKG[pkg]["ntp"].sntp_query("127.0.0.1", srv.port, 1.0)
             for pkg in PKG}
    finally:
        srv.close()
    assert got["port"] == got["jax"] == 1_650_000_000_500_000
    assert q["port"] == q["jax"] == pytest.approx(1_650_000_000.5, abs=1e-6)
    assert len(srv.requests) == 4
    assert all(len(r) == 48 and r[0] & 0x07 == 3 for r in srv.requests)


def _closed_udp_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("servers", [[], "dead"])
def test_get_epoch_falls_back_to_local_clock(servers):
    """``servers=[]`` skips the network; an unreachable server falls back
    to the wall clock, in both packages alike."""
    if servers == "dead":
        servers = [("127.0.0.1", _closed_udp_port())]
    t0 = time.time() * 1e6
    for pkg in PKG:
        got = PKG[pkg]["ntp"].get_epoch(servers=servers, timeout=0.2)
        assert abs(got - t0) < 5e6
    assert tntp.DEFAULT_SERVERS == jntp.DEFAULT_SERVERS
    assert tntp.NTP_DELTA == jntp.NTP_DELTA
