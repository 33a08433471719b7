"""The port's transport (``nnstreamer_tpu_torch.edge``) against the JAX
package's, on the CPU.

Two builds of the framework must interoperate on the wire: the same
numpy ``Buffer`` encodes to the same bytes in both packages (untraced,
traced, several tensors, flexible, a 0-d reply row, uint8 / float32 /
int32), each package decodes the other's frames, a CPU ``torch.Tensor``
encodes to the bytes of its numpy twin, and the handles and elements of
one package talk to those of the other over loopback TCP (``port=0``).
``connect-type=HYBRID`` (MQTT discovery of the TCP endpoint) runs across
packages too: query offload and edgesink/edgesrc with the server or
publisher of one package and the client of the other on either package's
broker, the discovery timeout, a misconfigured element failing alike in
both, the announce-host choice (its UDP probe faked) and the live
directory. Comparisons are exact: the wire carries bytes, not rounded
numbers.
Every socket wait, ``pull`` and ``join`` below has a bound.
"""

import random
import socket
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

from nnstreamer_tpu import meta as jmeta  # noqa: E402
from nnstreamer_tpu import pipeline as jpipeline  # noqa: E402
from nnstreamer_tpu.buffer import Buffer as JBuffer  # noqa: E402
from nnstreamer_tpu.edge import fleet as jfleet  # noqa: E402
from nnstreamer_tpu.edge import handle as jhandle  # noqa: E402
from nnstreamer_tpu.edge import ntp as jntp  # noqa: E402
from nnstreamer_tpu.edge import protocol as jproto  # noqa: E402
from nnstreamer_tpu.edge import tracex as jtx  # noqa: E402
from nnstreamer_tpu.filters import base as jbase  # noqa: E402
from nnstreamer_tpu.types import TensorsInfo as JInfo  # noqa: E402
from nnstreamer_tpu_torch import meta as tmeta  # noqa: E402
from nnstreamer_tpu_torch import pipeline as tpipeline  # noqa: E402
from nnstreamer_tpu_torch.buffer import Buffer as TBuffer  # noqa: E402
from nnstreamer_tpu_torch.edge import fleet as tfleet  # noqa: E402
from nnstreamer_tpu_torch.edge import handle as thandle  # noqa: E402
from nnstreamer_tpu_torch.edge import ntp as tntp  # noqa: E402
from nnstreamer_tpu_torch.edge import protocol as tproto  # noqa: E402
from nnstreamer_tpu_torch.edge import tracex as ttx  # noqa: E402
from nnstreamer_tpu_torch.filters import base as tbase  # noqa: E402
from nnstreamer_tpu_torch.testing import faults as tfaults  # noqa: E402
from nnstreamer_tpu_torch.types import TensorsInfo as TInfo  # noqa: E402

CAPS4 = ("other/tensors,num-tensors=1,dimensions=4,types=float32,"
         "framerate=0/1")

#: each package's modules under one name, so a case reads the same for both
PKG = {
    "jax": dict(proto=jproto, tx=jtx, fleet=jfleet, handle=jhandle,
                Buffer=JBuffer, meta=jmeta, pipeline=jpipeline,
                base=jbase, Info=JInfo),
    "port": dict(proto=tproto, tx=ttx, fleet=tfleet, handle=thandle,
                 Buffer=TBuffer, meta=tmeta, pipeline=tpipeline,
                 base=tbase, Info=TInfo),
}
OTHER = {"jax": "port", "port": "jax"}


def _ctx(tx):
    return tx.TraceContext(trace_id=0x1234ABCD, span_id=0x99, t_send_ns=111,
                           t_recv_ns=222, t_reply_ns=333,
                           stages=[(tx.STAGE_INGEST, 10, 20),
                                   (tx.STAGE_ADMIT, 20, 30),
                                   (tx.STAGE_REPLY, 30, 45)])


def _rng():
    return np.random.default_rng(9)


def _case_u8(k):
    frame = _rng().integers(0, 256, (8, 8, 3)).astype(np.uint8)
    buf = k["Buffer"](tensors=[frame], pts=5, duration=33,
                      meta={"tenant": "a"})
    return k["proto"].buffer_to_message(buf, k["proto"].MSG_DATA, _seq=1)


def _case_f32(k):
    buf = k["Buffer"](tensors=[np.linspace(-1, 1, 4, dtype=np.float32)],
                      pts=0)
    return k["proto"].buffer_to_message(buf, k["proto"].MSG_RESULT, _seq=2)


def _case_i32(k):
    buf = k["Buffer"](tensors=[np.arange(-3, 3, dtype=np.int32)
                               .reshape(2, 3)], pts=7)
    return k["proto"].buffer_to_message(buf, k["proto"].MSG_DATA)


def _case_multi(k):
    r = _rng()
    buf = k["Buffer"](tensors=[r.integers(0, 256, (2, 2, 3)).astype(np.uint8),
                               r.normal(size=5).astype(np.float32),
                               np.arange(3, dtype=np.int32)],
                      pts=11, duration=1, meta={"client_id": 4, "n": [1, 2]})
    return k["proto"].buffer_to_message(buf, k["proto"].MSG_DATA, _seq=8)


def _case_flexible(k):
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    blob = k["meta"].wrap_flexible(
        a, k["Info"].from_strings("3:2", "float32").tensors[0])
    buf = k["Buffer"](tensors=[blob], pts=3)
    return k["proto"].buffer_to_message(buf, k["proto"].MSG_RESULT)


def _case_zero_d(k):
    # a postproc:argmax reply row: row k of a [B] int32 output
    labels = np.array([3, 1, 4, 1], dtype=np.int32)
    buf = k["Buffer"](tensors=[labels[2], np.float32(0.5)], pts=2)
    return k["proto"].buffer_to_message(buf, k["proto"].MSG_RESULT, _seq=3)


def _case_traced(k):
    msg = _case_f32(k)
    msg.trace = _ctx(k["tx"])
    return msg


def _case_busy(k):
    p = k["proto"]
    return p.Message(p.MSG_BUSY, {"reason": "SERVER_BUSY",
                                  "detail": "queue-full", "_seq": 9})


def _case_object_meta(k):
    # a non-JSON meta value (a trace context riding the buffer) never
    # reaches the wire
    buf = k["Buffer"](tensors=[np.ones(2, np.float32)], pts=1,
                      meta={"_tracex": object(), "client_id": 2})
    return k["proto"].buffer_to_message(buf, k["proto"].MSG_RESULT)


WIRE_CASES = {
    "uint8": _case_u8, "float32": _case_f32, "int32": _case_i32,
    "several": _case_multi, "flexible": _case_flexible,
    "zero_d_row": _case_zero_d, "traced": _case_traced, "busy": _case_busy,
    "object_meta": _case_object_meta,
}


@pytest.mark.parametrize("case", sorted(WIRE_CASES))
def test_wire_bytes_equal(case):
    make = WIRE_CASES[case]
    enc = {n: k["proto"].encode_message(make(k)) for n, k in PKG.items()}
    assert enc["port"] == enc["jax"]


def _decoded(k, data):
    msg = k["proto"].decode_message(data)
    buf = k["proto"].message_to_buffer(msg)
    return msg, buf


@pytest.mark.parametrize("src", ["jax", "port"])
@pytest.mark.parametrize("case", sorted(WIRE_CASES))
def test_frame_decodes_in_the_other_package(case, src):
    """A frame one package encodes, the other decodes to the same
    tensors (values and dtypes), meta, timestamps and trace context as
    the encoder's own decoder."""
    data = PKG[src]["proto"].encode_message(WIRE_CASES[case](PKG[src]))
    msg_a, buf_a = _decoded(PKG[src], data)
    msg_b, buf_b = _decoded(PKG[OTHER[src]], data)
    assert msg_b.type == msg_a.type and msg_b.meta == msg_a.meta
    assert (buf_b.pts, buf_b.duration) == (buf_a.pts, buf_a.duration)
    assert len(buf_b.tensors) == len(buf_a.tensors)
    for a, b in zip(buf_a.tensors, buf_b.tensors):
        if isinstance(a, bytes):
            assert a == b
        else:
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    if msg_a.trace is None:
        assert msg_b.trace is None
    else:
        for f in ("trace_id", "span_id", "sampled", "shed", "t_send_ns",
                  "t_recv_ns", "t_reply_ns", "stages"):
            assert getattr(msg_b.trace, f) == getattr(msg_a.trace, f)


@pytest.mark.parametrize("dtype", ["uint8", "int32", "int64", "float16",
                                   "float32"])
def test_torch_tensor_encodes_as_its_numpy_twin(dtype):
    """The port's encoding of a CPU torch.Tensor is the bytes of its numpy
    twin, which are the bytes the JAX package puts on the wire."""
    a = (np.arange(24).reshape(2, 3, 4) % 7).astype(dtype)
    t = torch.from_numpy(a.copy())
    enc = {}
    for name, tensor in (("torch", t), ("numpy", a)):
        msg = tproto.buffer_to_message(TBuffer(tensors=[tensor], pts=1),
                                       tproto.MSG_RESULT, _seq=4)
        enc[name] = tproto.encode_message(msg)
    jmsg = jproto.buffer_to_message(JBuffer(tensors=[a], pts=1),
                                    jproto.MSG_RESULT, _seq=4)
    assert enc["torch"] == enc["numpy"] == jproto.encode_message(jmsg)


@pytest.mark.parametrize("sender", ["jax", "port"])
def test_stream_framing_across_packages(sender):
    """send_message of one package, recv_message of the other, over a
    socket pair: three frames back to back, traced and untraced."""
    recv = PKG[OTHER[sender]]["proto"]
    k = PKG[sender]
    msgs = [_case_u8(k), _case_traced(k), _case_multi(k)]
    a, b = socket.socketpair()
    a.settimeout(10)
    b.settimeout(10)
    try:
        for m in msgs:
            k["proto"].send_message(a, m)
        got = [recv.recv_message(b) for _ in msgs]
    finally:
        a.close()
        b.close()
    for m, g in zip(msgs, got):
        assert recv.encode_message(g) == k["proto"].encode_message(m)


def test_tracex_header_and_decomposition_match():
    ctxs = {n: _ctx(k["tx"]) for n, k in PKG.items()}
    packed = {n: PKG[n]["tx"].pack(c) for n, c in ctxs.items()}
    assert packed["port"] == packed["jax"]
    # a newer peer's longer header: the unknown tail is skipped by both
    tail = packed["jax"] + b"\x07" * 13
    for k in PKG.values():
        got = k["tx"].parse(tail)
        assert got.trace_id == 0x1234ABCD and len(got.stages) == 3
    for n, k in PKG.items():
        c = ctxs[n]
        c.t_wire_recv_ns = 500
        random.seed(3)  # reply_context draws the reply's span id
        ctxs[n] = (k["tx"].decompose(c), k["tx"].clock_sample(c),
                   k["tx"].pack(k["tx"].reply_context(c, shed=True,
                                                      shed_reason="x")))
    assert ctxs["port"] == ctxs["jax"]


def test_fleet_health_and_routing_helpers_match():
    health = {"depth": 5, "inflight": 2, "shed_permille": 30,
              "serve_batch": 32, "slo_ms": 100}
    assert tfleet.pack_health(health) == jfleet.pack_health(health)
    raw = jfleet.pack_health(health)
    assert tfleet.parse_health(raw) == jfleet.parse_health(raw)
    for h in (None, health, dict(health, depth=0, shed_permille=0),
              dict(health, inflight=40)):
        assert tfleet.headroom_score(h) == jfleet.headroom_score(h)
    spec = "localhost:5000, 127.0.0.1:5001"
    assert tfleet.parse_endpoints(spec) == jfleet.parse_endpoints(spec)
    rids = ["a-1", "a-2", "a-1", None, "b-1", "a-2"]
    filters = {n: k["fleet"].RidFilter() for n, k in PKG.items()}
    seen = {n: [f.seen(r) for r in rids] for n, f in filters.items()}
    assert seen["port"] == seen["jax"] == [False, False, True, False,
                                           False, True]


def test_clock_offset_estimate_matches():
    samples = [(100, 1100, 1150, 260), (400, 1390, 1420, 520),
               (700, 1720, 1730, 790)]
    assert (vars(tntp.estimate_offset(samples))
            == vars(jntp.estimate_offset(samples)))
    syncs = {n: m.ClockSync() for n, m in (("jax", jntp), ("port", tntp))}
    for s in syncs.values():
        s.observe(1_000_000, local_epoch_us=1_000_250)
    assert ({n: (s.offset_us, s.to_local_ns(5000), s.to_local_ns(-1))
             for n, s in syncs.items()}["port"]
            == {n: (s.offset_us, s.to_local_ns(5000), s.to_local_ns(-1))
                for n, s in syncs.items()}["jax"])


@pytest.mark.parametrize("server_pkg", ["jax", "port"])
def test_handles_interoperate(server_pkg):
    """One package's EdgeServer, the other's EdgeClient: the CAPABILITY
    handshake (caps, client id, the trace capability and the health TLV),
    a DATA frame in, a RESULT routed back by client id."""
    srv_k, cli_k = PKG[server_pkg], PKG[OTHER[server_pkg]]
    srv = srv_k["handle"].EdgeServer(port=0, caps=CAPS4)
    health = {"depth": 3, "inflight": 1, "shed_permille": 0,
              "serve_batch": 8, "slo_ms": 0}
    srv.health_provider = lambda: health
    srv.start()
    cli = cli_k["handle"].EdgeClient("localhost", srv.port, timeout=10.0)
    try:
        cli.connect()
        assert cli.server_caps == CAPS4 and cli.server_trace is True
        assert cli.server_health == health
        cli.send(_case_u8(cli_k))
        item = srv.pop(timeout=10.0)
        assert item is not None
        cid, msg = item
        got = srv_k["proto"].message_to_buffer(msg)
        np.testing.assert_array_equal(
            got.tensors[0], _rng().integers(0, 256, (8, 8, 3))
            .astype(np.uint8))
        reply = srv_k["proto"].buffer_to_message(
            srv_k["Buffer"](tensors=[got.tensors[0] // 2], pts=got.pts),
            srv_k["proto"].MSG_RESULT, _seq=msg.meta["_seq"])
        assert srv.send_to(cid, reply, timeout=5.0)
        back = cli.recv(timeout=10.0)
        assert back is not None and back.meta["_seq"] == 1
        out = cli_k["proto"].message_to_buffer(back)
        np.testing.assert_array_equal(out.tensors[0], got.tensors[0] // 2)
    finally:
        cli.close()
        srv.close()


# -- elements across packages --------------------------------------------------

def _double(xs):
    return [np.asarray(xs[0]) * 2]


@pytest.fixture
def doublers():
    for k in PKG.values():
        for model, dims in (("edge_double", "4"), ("edge_double_b4", "4:4")):
            info = k["Info"].from_strings(dims, "float32")
            k["base"].register_custom_easy(model, _double, info, info)
    yield
    for k in PKG.values():
        for model in ("edge_double", "edge_double_b4"):
            k["base"].unregister_custom_easy(model)


def _server_line(sid, serve):
    serving = ("serve=1 serve-batch=4 serve-queue-depth=64 "
               if serve else "")
    model = "edge_double_b4" if serve else "edge_double"
    return (f"tensor_query_serversrc name=ssrc id={sid} port=0 {serving}"
            f"caps={CAPS4} ! tensor_filter framework=custom-easy "
            f"model={model} ! tensor_query_serversink id={sid} "
            "timeout=5")


def _run_clients(k, port, n_clients, n_frames, extra=""):
    """n_clients client pipelines of package ``k`` in threads, each
    pushing its own values; returns {idx: (eos, error, values)}."""
    results = {}

    def client(idx):
        cl = k["pipeline"].parse_launch(
            f"appsrc name=src caps={CAPS4} ! tensor_query_client "
            f"port={port} timeout=10 {extra} ! tensor_sink name=out")
        cl.play()
        try:
            for i in range(n_frames):
                cl["src"].push_buffer(k["Buffer"](
                    tensors=[np.full(4, idx * 100.0 + i, np.float32)],
                    pts=i))
            cl["src"].end_of_stream()
            ok = cl.bus.wait_eos(30)
            results[idx] = (ok, cl.bus.error,
                            [float(np.asarray(b[0]).reshape(-1)[0])
                             for b in cl["out"].collected])
        finally:
            cl.stop()

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive(), "a client pipeline hung"
    return results


@pytest.mark.parametrize("serve", [0, 1], ids=["plain", "serve"])
@pytest.mark.parametrize("server_pkg", ["jax", "port"])
def test_query_loopback_across_packages(doublers, server_pkg, serve):
    """A client pipeline of one package against a server pipeline of the
    other (custom-easy doubler): every client gets its own doubled
    values, in order, and the serving server batched across clients."""
    srv = PKG[server_pkg]["pipeline"].parse_launch(
        _server_line(f"x{server_pkg}{serve}", serve))
    srv.play()
    try:
        port = srv["ssrc"].port
        res = _run_clients(PKG[OTHER[server_pkg]], port, 3, 6)
    finally:
        srv.stop()
    assert sorted(res) == [0, 1, 2]
    for idx, (ok, err, vals) in res.items():
        assert ok and err is None, (idx, err)
        assert vals == [2.0 * (idx * 100.0 + i) for i in range(6)]


def _wait_for(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


@pytest.mark.parametrize("pub_pkg,sub_pkg", [("port", "port"),
                                             ("port", "jax"),
                                             ("jax", "port")])
def test_edgesink_to_edgesrc(pub_pkg, sub_pkg):
    pk, sk = PKG[pub_pkg], PKG[sub_pkg]
    pub = pk["pipeline"].parse_launch(
        f"appsrc name=src caps={CAPS4} ! edgesink name=sink port=0 "
        "topic=cam")
    pub.play()
    sub = None
    try:
        port = pub["sink"].port
        sub = sk["pipeline"].parse_launch(
            f"edgesrc name=esrc port={port} topic=cam timeout=10 "
            "! tensor_sink name=out")
        sub.play()
        assert _wait_for(lambda: bool(pub["sink"]._server._conns))
        for i in range(3):
            pub["src"].push_buffer(pk["Buffer"](
                tensors=[np.full(4, float(i), np.float32)], pts=i))
        assert _wait_for(lambda: len(sub["out"].collected) >= 3)
        outs = [np.asarray(b[0]).reshape(-1) for b in sub["out"].collected]
        pts = [b.pts for b in sub["out"].collected]
    finally:
        if sub is not None:
            sub.stop()
        pub.stop()
    assert pts == [0, 1, 2]
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(o, np.full(4, float(i), np.float32))


def _closed_port() -> int:
    """A port nothing listens on: bound, then closed."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


#: connect-type=HYBRID started without a reachable broker (the clients
#: discover through one) or without one named (the announcers): what each
#: must say
HYBRID_FAULTS = {
    "query_client": ("appsrc caps=%s ! tensor_query_client port={port} "
                     "connect-type=HYBRID topic=t timeout=2 ! tensor_sink"
                     % CAPS4, "hybrid discovery failed"),
    "query_serversrc": ("tensor_query_serversrc id=h{pkg} port=0 "
                        "connect-type=HYBRID topic=t caps=%s ! "
                        "tensor_query_serversink id=h{pkg}" % CAPS4,
                        "needs topic= and broker dest-host=/dest-port="),
    "edgesink": ("appsrc caps=%s ! edgesink port=0 connect-type=HYBRID "
                 "topic=t" % CAPS4,
                 "needs topic= and broker dest-host=/dest-port="),
    "edgesrc": ("edgesrc port={port} connect-type=HYBRID topic=t timeout=2 "
                "! tensor_sink", "hybrid discovery failed"),
}


@pytest.mark.parametrize("case", sorted(HYBRID_FAULTS))
def test_hybrid_misconfigured_fails_alike(case):
    """Starting a HYBRID element with no broker to reach, or none named,
    raises in both packages with the same message; nothing falls back to
    plain TCP."""
    line, msg = HYBRID_FAULTS[case]
    for pkg in PKG:
        p = PKG[pkg]["pipeline"].parse_launch(
            line.format(port=_closed_port(), pkg=pkg))
        try:
            with pytest.raises(Exception, match=msg):
                p.play()
        finally:
            p.stop()


@pytest.fixture
def brokers():
    """One running MqttBroker of each package, by package name."""
    from nnstreamer_tpu.edge.mqtt import MqttBroker as JBroker
    from nnstreamer_tpu_torch.edge.mqtt import MqttBroker as TBroker

    bs = {"jax": JBroker(), "port": TBroker()}
    for b in bs.values():
        b.start()
    yield bs
    for b in bs.values():
        b.close()


#: (server or publisher, client or subscriber, broker) packages
HYBRID_PAIRS = [("port", "port", "port"), ("jax", "port", "port"),
                ("port", "jax", "jax")]


@pytest.mark.parametrize("server_pkg,client_pkg,broker_pkg", HYBRID_PAIRS)
def test_query_hybrid_loopback(doublers, brokers, server_pkg, client_pkg,
                               broker_pkg):
    """tensor_query_serversrc connect-type=HYBRID announces its bound TCP
    port (port=0) on the broker; a HYBRID tensor_query_client of either
    package discovers it there and gets its doubled frames back."""
    bport = brokers[broker_pkg].port
    sid = f"hyb{server_pkg}{client_pkg}"
    srv = PKG[server_pkg]["pipeline"].parse_launch(
        f"tensor_query_serversrc name=ssrc id={sid} port=0 "
        f"connect-type=HYBRID topic=nns/hyb/ep dest-host=localhost "
        f"dest-port={bport} caps={CAPS4} ! tensor_filter "
        f"framework=custom-easy model=edge_double ! tensor_query_serversink "
        f"id={sid}")
    srv.play()
    try:
        assert srv["ssrc"].port > 0
        k = PKG[client_pkg]
        cl = k["pipeline"].parse_launch(
            f"appsrc name=src caps={CAPS4} ! tensor_query_client "
            f"connect-type=HYBRID host=localhost port={bport} "
            "topic=nns/hyb/ep timeout=15 ! tensor_sink name=out")
        cl.play()
        try:
            for i in range(3):
                cl["src"].push_buffer(k["Buffer"](
                    tensors=[np.full(4, float(i + 1), np.float32)], pts=i))
            cl["src"].end_of_stream()
            assert cl.bus.wait_eos(15)
            assert cl.bus.error is None, cl.bus.error
            outs = [np.asarray(b[0]).reshape(-1) for b in cl["out"].collected]
        finally:
            cl.stop()
    finally:
        srv.stop()
    assert len(outs) == 3
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(o, np.full(4, 2.0 * (i + 1),
                                                 np.float32))


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_hybrid_discovery_timeout(brokers, pkg):
    """A HYBRID client whose topic nobody announces on gives up after its
    timeout, in both packages."""
    p = PKG[pkg]["pipeline"].parse_launch(
        f"appsrc name=src caps={CAPS4} ! tensor_query_client "
        f"connect-type=HYBRID host=localhost port={brokers[pkg].port} "
        "topic=nns/nobody/here timeout=1 ! tensor_sink name=out")
    t0 = time.monotonic()
    try:
        with pytest.raises(Exception, match="discovery"):
            p.play()
    finally:
        p.stop()
    assert time.monotonic() - t0 < 10


@pytest.mark.parametrize("pub_pkg,sub_pkg,broker_pkg", HYBRID_PAIRS)
def test_edgesink_edgesrc_hybrid(brokers, pub_pkg, sub_pkg, broker_pkg):
    """edgesink connect-type=HYBRID announces its listener; an edgesrc
    connect-type=HYBRID of either package discovers it and receives every
    frame, in order."""
    bport = brokers[broker_pkg].port
    pk, sk = PKG[pub_pkg], PKG[sub_pkg]
    pub = pk["pipeline"].parse_launch(
        f"appsrc name=src caps={CAPS4} ! edgesink name=es "
        "connect-type=HYBRID topic=nns/hyb/pub dest-host=localhost "
        f"dest-port={bport}")
    pub.play()
    sub = None
    try:
        sub = sk["pipeline"].parse_launch(
            f"edgesrc connect-type=HYBRID host=localhost port={bport} "
            "topic=nns/hyb/pub timeout=15 ! tensor_sink name=out")
        sub.play()
        assert _wait_for(lambda: bool(pub["es"]._server._conns))
        for i in range(3):
            pub["src"].push_buffer(pk["Buffer"](
                tensors=[np.full(4, float(i), np.float32)], pts=i))
        assert _wait_for(lambda: len(sub["out"].collected) >= 3)
        outs = [np.asarray(b[0]).reshape(-1) for b in sub["out"].collected]
        pts = [b.pts for b in sub["out"].collected]
    finally:
        if sub is not None:
            sub.stop()
        pub.stop()
    assert pts == [0, 1, 2]
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(o, np.full(4, float(i), np.float32))


class _FakeUdp:
    """Stands in for ``socket.socket`` in resolve_announce_host: records
    the address a UDP socket is connected to (which sends nothing) and
    names ``local`` as the outbound interface, or refuses with OSError
    when ``local`` is None (an unresolvable broker)."""

    local = None
    seen = []

    def __init__(self, family, kind):
        assert kind == socket.SOCK_DGRAM
        self.addr = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def connect(self, addr):
        _FakeUdp.seen.append(addr)
        if _FakeUdp.local is None:
            raise OSError("unresolvable")

    def getsockname(self):
        return (_FakeUdp.local, 5)


@pytest.mark.parametrize("bind,broker,local,want", [
    ("localhost", "broker.example", None, "localhost"),
    ("127.0.0.1", "10.0.0.9", None, "127.0.0.1"),
    ("10.1.2.3", "b.example", None, "10.1.2.3"),
    ("0.0.0.0", "localhost", None, "127.0.0.1"),
    ("0.0.0.0", "10.0.0.9", "10.9.8.7", "10.9.8.7"),
    ("0.0.0.0", "no-such-host.invalid", None, "127.0.0.1"),
    ("", "10.0.0.9", "10.9.8.7", "10.9.8.7"),
], ids=["loopback", "loopback_ip", "concrete", "wildcard_local_broker",
        "wildcard_outbound", "wildcard_unresolvable", "empty_outbound"])
def test_announce_host_matches(monkeypatch, bind, broker, local, want):
    """HYBRID announce address selection, in both packages alike: a
    loopback or concrete bind is announced as it is; a wildcard bind
    never literally — loopback for a local broker, else the outbound
    interface toward the broker (a UDP connect, faked here so nothing
    leaves the host), else loopback."""
    from nnstreamer_tpu.edge.discovery import resolve_announce_host as jres
    from nnstreamer_tpu_torch.edge.discovery import (
        resolve_announce_host as tres,
    )

    monkeypatch.setattr(socket, "socket", _FakeUdp)
    monkeypatch.setattr(_FakeUdp, "local", local)
    monkeypatch.setattr(_FakeUdp, "seen", [])
    got = {"jax": jres(bind, broker), "port": tres(bind, broker)}
    assert got == {"jax": want, "port": want}
    wildcard_remote = bind in ("0.0.0.0", "") and broker != "localhost"
    assert _FakeUdp.seen == ([(broker, 1)] * 2 if wildcard_remote else [])


def test_directory_tracks_live_announcers(brokers):
    """The port's Directory lists every endpoint announced on its topic
    (here by each package's announcer on the port's broker) and evicts
    one that stops heartbeating after its TTL."""
    from nnstreamer_tpu.edge.discovery import HybridAnnouncer as JAnn
    from nnstreamer_tpu_torch.edge.discovery import Directory, HybridAnnouncer

    bport = brokers["port"].port
    d = Directory("localhost", bport, "nns/dir", ttl=1.5, timeout=5)
    anns = [HybridAnnouncer("localhost", bport, "nns/dir", "127.0.0.1",
                            4001),
            JAnn("localhost", bport, "nns/dir", "127.0.0.1", 4002)]
    try:
        assert d.wait_for(2, timeout=5) == [("127.0.0.1", 4001),
                                            ("127.0.0.1", 4002)]
        anns.pop().close()
        assert _wait_for(lambda: d.endpoints() == [("127.0.0.1", 4001)], 6)
    finally:
        for a in anns:
            a.close()
        d.close()


def test_injected_partial_write_fails_the_send():
    """The port's fault harness drives its own transport: an armed
    partial-write ships half a frame, kills the socket and raises the
    ConnectionError a real link failure would."""
    srv = thandle.EdgeServer(port=0)
    srv.start()
    cli = thandle.EdgeClient("localhost", srv.port, timeout=5.0)
    try:
        cli.connect()
        fault = tfaults.install("partial-write", times=1)
        with pytest.raises(ConnectionError, match="partial-write"):
            cli.send(_case_f32(PKG["port"]))
        assert fault.fired == 1
        assert _wait_for(lambda: srv.pop(timeout=0.05) is None, 2.0)
    finally:
        tfaults.clear()
        cli.close()
        srv.close()
