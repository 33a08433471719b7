"""The port's serving tier (``nnstreamer_tpu_torch.serving``, the query
elements and the tracer's serving records) against the JAX package's, on
the CPU.

- Admission and scheduler scenarios of tests/test_serving.py and the
  hot-knob and predictive-shed scenarios of tests/test_controller.py run
  through both packages' classes against a fake server handle (each
  package's own protocol): the same batches, fills, routes, shed reasons
  and dequeue order, exactly.
- The plant model and the controller's rules: the same deterministic
  tick sequence gives the same decision log in both packages (exact;
  the plant is pure arithmetic).
- The tracer: for the same fake-server run, the serving, ctl and
  trace_x report sections have the JAX report's keys and the same
  counters, and the metrics text is the same.
- The reference's loopback properties on the port's own elements:
  cross-client fill and demux, one input signature at the filter across
  fills, overload shed with SERVER_BUSY, ``retry:<N>`` riding out a rate
  limit, a clean drain on stop, the serversink's reply timeout and
  reply-drop record, slicing by ``serve_batch`` (not by fill), the
  controller on a live line.

Every socket wait, ``pull`` and thread ``join`` is bounded; ports are
``port=0``. Filters run on the CPU (``accelerator=true:cpu``).
"""

import queue
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

from nnstreamer_tpu import serving as jserving  # noqa: E402
from nnstreamer_tpu import trace as jtrace  # noqa: E402
from nnstreamer_tpu.analysis import plant as jplant  # noqa: E402
from nnstreamer_tpu.buffer import Buffer as JBuffer  # noqa: E402
from nnstreamer_tpu.edge import protocol as jproto  # noqa: E402
from nnstreamer_tpu.elements import query as jquery  # noqa: E402
from nnstreamer_tpu.serving import admission as jadm  # noqa: E402
from nnstreamer_tpu.serving import scheduler as jsched  # noqa: E402
from nnstreamer_tpu_torch import serving as tserving  # noqa: E402
from nnstreamer_tpu_torch import trace as ttrace  # noqa: E402
from nnstreamer_tpu_torch.analysis import plant as tplant  # noqa: E402
from nnstreamer_tpu_torch.buffer import Buffer as TBuffer  # noqa: E402
from nnstreamer_tpu_torch.edge import protocol as tproto  # noqa: E402
from nnstreamer_tpu_torch.edge.handle import (  # noqa: E402
    EdgeClient,
    EdgeServer,
)
from nnstreamer_tpu_torch.elements import query as tquery  # noqa: E402
from nnstreamer_tpu_torch.filters.base import (  # noqa: E402
    register_custom_easy,
    unregister_custom_easy,
)
from nnstreamer_tpu_torch.pipeline import parse_launch  # noqa: E402
from nnstreamer_tpu_torch.serving import admission as tadm  # noqa: E402
from nnstreamer_tpu_torch.serving import scheduler as tsched  # noqa: E402
from nnstreamer_tpu_torch.types import TensorsInfo  # noqa: E402

PKG = {
    "jax": dict(serving=jserving, adm=jadm, sched=jsched, plant=jplant,
                proto=jproto, Buffer=JBuffer, trace=jtrace, query=jquery),
    "port": dict(serving=tserving, adm=tadm, sched=tsched, plant=tplant,
                 proto=tproto, Buffer=TBuffer, trace=ttrace, query=tquery),
}

CAPS4 = ("other/tensors,num-tensors=1,dimensions=4,types=float32,"
         "framerate=30/1")
ADD_FILTER = ("tensor_filter framework=jax model=add custom=k:1,aot:0 "
              "accelerator=true:cpu")


def both(fn):
    """fn(package dict) for each package; asserts the results are equal
    and returns the port's."""
    got = {name: fn(k) for name, k in PKG.items()}
    assert got["port"] == got["jax"]
    return got["port"]


class FakeServer:
    """The query-server handle the scheduler reads (tests/test_serving.py's
    FakeServer), encoding with one package's protocol."""

    def __init__(self, k):
        self.k = k
        self.recv_queue = queue.Queue()
        self.sent = []

    def push(self, cid, tensors, tenant=None, seq=None):
        meta = {}
        if tenant is not None:
            meta["tenant"] = tenant
        if seq is not None:
            meta["_seq"] = seq
        p = self.k["proto"]
        self.recv_queue.put((cid, p.buffer_to_message(
            self.k["Buffer"](tensors=tensors, pts=0), p.MSG_DATA, **meta)))

    def pop(self, timeout=0.2):
        try:
            return self.recv_queue.get(timeout=timeout)
        except queue.Empty:
            return None

    def send_to(self, cid, msg, timeout=None):
        self.sent.append((cid, msg))
        return True

    def busy(self):
        return [(cid, m.meta.get("detail"), m.meta.get("_seq"))
                for cid, m in self.sent if m.type == self.k["proto"].MSG_BUSY]


def _frame(v):
    return [np.full(4, float(v), np.float32)]


def _batch_view(buf):
    """What a batch says: pad target, fill, routes, tensor shapes and the
    first value of every row."""
    if buf is None:
        return None
    return {"batch": buf.meta["serve_batch"], "fill": buf.meta["serve_fill"],
            "routes": [(r["client_id"], r["tenant"])
                       for r in buf.meta["serve_routes"]],
            "shapes": [tuple(t.shape) for t in buf.tensors],
            "rows": [float(np.asarray(t).reshape(t.shape[0], -1)[i, 0])
                     for t in buf.tensors[:1] for i in range(t.shape[0])]}


# -- admission ----------------------------------------------------------------

def adm_token_bucket(k):
    b = k["adm"].TokenBucket(rate=10.0, burst=2.0, now=0.0)
    out = [b.take(now=0.0), b.take(now=0.0), b.take(now=0.0),
           b.take(now=0.1), b.take(now=0.1)]
    assert out == [True, True, False, True, False]
    return out


def adm_unlimited(k):
    b = k["adm"].TokenBucket(rate=0.0, burst=1.0, now=0.0)
    out = [b.take(now=0.0) for _ in range(100)]
    assert all(out)
    return out


def adm_parse_weights(k):
    pw = k["adm"].parse_weights
    out = [pw("a:2, b:1"), pw("")]
    errors = []
    for bad in ("a", "a:0", "a:x"):
        with pytest.raises(ValueError) as e:
            pw(bad)
        errors.append(str(e.value))
    assert out == [{"a": 2.0, "b": 1.0}, {}]
    return out, errors


def adm_queue_bound_then_rate(k):
    a = k["adm"].AdmissionController(queue_depth=2, rate=1.0, burst=1.0)
    out = [a.admit("t", waiting=2, now=0.0), a.admit("t", waiting=0, now=0.0),
           a.admit("t", waiting=0, now=0.0)]
    assert out == [k["adm"].SHED_QUEUE_FULL, None, k["adm"].SHED_RATE_LIMITED]
    return out


def adm_stride_fairness(k):
    a = k["adm"].AdmissionController(weights={"heavy": 3.0, "light": 1.0})
    picks = []
    for _ in range(40):
        t = a.pick(["heavy", "light"])
        a.advance(t)
        picks.append(t)
    assert picks.count("heavy") == 30 and picks.count("light") == 10
    return picks


def adm_late_joiner(k):
    a = k["adm"].AdmissionController()
    for _ in range(50):
        a.advance("old")
    picks = []
    for _ in range(10):
        t = a.pick(["old", "new"])
        a.advance(t)
        picks.append(t)
    assert 4 <= picks.count("new") <= 6
    return picks


def adm_set_rate(k):
    b = k["adm"].TokenBucket(rate=10.0, burst=5.0, now=0.0)
    out = [b.take(now=0.0) for _ in range(6)]
    b.set_rate(rate=1.0, burst=5.0, now=0.2)
    out += [b.take(now=0.2), b.take(now=0.2), b.take(now=0.2),
            b.take(now=0.5), b.take(now=1.2)]
    b2 = k["adm"].TokenBucket(rate=1.0, burst=10.0, now=0.0)
    b2.set_rate(burst=2.0, now=0.0)
    out += [b2.take(now=0.0), b2.take(now=0.0), b2.take(now=0.0)]
    assert out == [True] * 5 + [False, True, True, False, False, True,
                                True, True, False]
    return out


ADMISSION = {f.__name__[4:]: f for f in (
    adm_token_bucket, adm_unlimited, adm_parse_weights,
    adm_queue_bound_then_rate, adm_stride_fairness, adm_late_joiner,
    adm_set_rate)}


@pytest.mark.parametrize("scenario", sorted(ADMISSION))
def test_admission_matches_jax(scenario):
    both(ADMISSION[scenario])


# -- scheduler ----------------------------------------------------------------

def sch_never_blocks_on_own_batch(k):
    srv = FakeServer(k)
    sched = k["sched"].ServingScheduler(srv, batch=8)
    srv.push(1, _frame(7))
    buf = sched.next_batch(timeout=5.0)
    assert buf.meta["serve_fill"] == 1 and buf.tensors[0].shape == (8, 4)
    assert len(buf.meta["serve_routes"]) == 1
    return _batch_view(buf)


def sch_across_clients(k):
    srv = FakeServer(k)
    sched = k["sched"].ServingScheduler(srv, batch=4)
    for cid in range(3):
        srv.push(cid + 1, _frame(cid))
    buf = sched.next_batch(timeout=1.0)
    assert [r["client_id"] for r in buf.meta["serve_routes"]] == [1, 2, 3]
    return _batch_view(buf)


def sch_weighted_fair(k):
    srv = FakeServer(k)
    sched = k["sched"].ServingScheduler(srv, batch=4, queue_depth=0,
                                        weights={"heavy": 3.0, "light": 1.0})
    for i in range(20):
        srv.push(1, _frame(i), tenant="heavy")
    for i in range(5):
        srv.push(2, _frame(100 + i), tenant="light")
    views = []
    for _ in range(4):
        buf = sched.next_batch(timeout=1.0)
        tenants = [r["tenant"] for r in buf.meta["serve_routes"]]
        assert tenants.count("heavy") == 3 and tenants.count("light") == 1
        views.append(_batch_view(buf))
    return views


def sch_queue_full(k):
    srv = FakeServer(k)
    sched = k["sched"].ServingScheduler(srv, batch=4, queue_depth=2)
    for i in range(5):
        srv.push(9, _frame(i), seq=i)
    buf = sched.next_batch(timeout=1.0)
    assert buf.meta["serve_fill"] == 2 and len(srv.busy()) == 3
    assert srv.busy()[0] == (9, "queue-full", 2)
    return _batch_view(buf), srv.busy(), dict(sched.stats)


def sch_signatures_never_mix(k):
    srv = FakeServer(k)
    sched = k["sched"].ServingScheduler(srv, batch=4)
    srv.push(1, _frame(0))
    srv.push(2, [np.zeros((2, 2), np.float32)])
    b1, b2 = sched.next_batch(timeout=1.0), sched.next_batch(timeout=1.0)
    assert b1.tensors[0].shape == (4, 4) and b2.tensors[0].shape == (4, 2, 2)
    return _batch_view(b1), _batch_view(b2)


def sch_unbatchable_shed(k):
    srv = FakeServer(k)
    sched = k["sched"].ServingScheduler(srv, batch=4)
    srv.push(3, [b"raw bytes"], seq=1)
    srv.push(4, _frame(1), seq=2)
    buf = sched.next_batch(timeout=1.0)
    assert srv.busy() == [(3, "unbatchable", 1)]
    return _batch_view(buf), srv.busy()


def sch_shutdown_drains(k):
    srv = FakeServer(k)
    sched = k["sched"].ServingScheduler(srv, batch=4, queue_depth=16)
    for i in range(3):
        srv.push(1, _frame(i))
    sched._ingest_nonblocking()
    srv.push(2, _frame(9))
    n = sched.shutdown()
    assert n == 4 and sched.next_batch(timeout=0.05) is None
    assert all(d == "draining" for _, d, _ in srv.busy())
    return n, srv.busy()


def sch_set_knobs_immediate(k):
    sched = k["sched"].ServingScheduler(FakeServer(k), batch=8)
    out = sched.set_knobs(batch=4, linger_ms=3.0, queue_depth=16)
    assert out == {"linger_ms": 3.0, "queue_depth": 16, "serve_batch": 4}
    return out, sched.knobs()


def sch_batch_change_pends(k):
    srv = FakeServer(k)
    sched = k["sched"].ServingScheduler(srv, batch=4)
    sched.note_reply_batch()
    srv.push(1, _frame(1))
    views = [_batch_view(sched.next_batch(timeout=1.0))]
    out = sched.set_knobs(batch=2)
    srv.push(1, _frame(2))
    views.append(_batch_view(sched.next_batch(timeout=1.0)))
    sched.note_reply_batch()
    sched.note_reply_batch()
    srv.push(1, _frame(3))
    views.append(_batch_view(sched.next_batch(timeout=1.0)))
    assert out["serve_batch"] == {"pending": 2}
    assert [v["batch"] for v in views] == [4, 4, 2]
    return out, views


def sch_lost_inflight_expires(k):
    srv = FakeServer(k)
    sched = k["sched"].ServingScheduler(srv, batch=4)
    sched.note_reply_batch()
    srv.push(1, _frame(1))
    first = _batch_view(sched.next_batch(timeout=1.0))
    out = sched.set_knobs(batch=2)
    sched.inflight_expire_s = 0.0
    srv.push(1, _frame(2))
    second = _batch_view(sched.next_batch(timeout=1.0))
    sched.set_ctl_gate(100.0, 40.0)
    with sched._lock:
        verdict = sched._ctl_gate_verdict_locked()
    assert second["batch"] == 2 and verdict is None
    return first, out, second, verdict


def sch_rate_override(k):
    sched = k["sched"].ServingScheduler(FakeServer(k), batch=4, rate=0.0)
    got = sched.set_tenant_rate("t1", rate=2.0, burst=2.0)
    out = [sched.admission.admit("t1", 0, now=0.0) for _ in range(3)]
    assert out == [None, None, "rate-limited"]
    return got, out


def sch_tenant_arrivals_count_sheds(k):
    srv = FakeServer(k)
    sched = k["sched"].ServingScheduler(srv, batch=4, rate=0.0)
    sched.set_tenant_rate("cut", rate=0.001, burst=1.0)
    for i in range(5):
        srv.push(1, _frame(i), tenant="cut", seq=i)
    sched._ingest_nonblocking()
    win = sched.ctl_window()
    assert win["tenant_arrivals"].get("cut", 0) == 5
    return (srv.busy(), dict(sched.shed_reasons), win["tenant_arrivals"],
            win["tenant_rates"], win["deltas"], win["waiting"])


def sch_predictive_gate(k):
    srv = FakeServer(k)
    sched = k["sched"].ServingScheduler(srv, batch=2, queue_depth=1000)
    sched.set_ctl_gate(100.0, 40.0)
    for i in range(8):
        srv.push(1, _frame(i), seq=i)
    sched._ingest_nonblocking()
    assert sched.shed_reasons.get(k["sched"].SHED_CTL_PREDICTED, 0) > 0
    return srv.busy(), dict(sched.stats)


def sch_gate_off(k):
    srv = FakeServer(k)
    sched = k["sched"].ServingScheduler(srv, batch=2, queue_depth=1000)
    for i in range(8):
        srv.push(1, _frame(i), seq=i)
    sched._ingest_nonblocking()
    sched.set_ctl_gate(100.0, 40.0)
    sched.set_ctl_gate(None, None)
    srv.push(1, _frame(9), seq=9)
    sched._ingest_nonblocking()
    assert sched.stats["shed"] == 0
    return dict(sched.stats)


def sch_ctl_window_drains(k):
    """The controller's measurement window: counter deltas, shed reasons,
    per-tenant arrivals and knob values since the last drain; a second
    drain sees only what came after the first."""
    srv = FakeServer(k)
    sched = k["sched"].ServingScheduler(srv, batch=2, queue_depth=2)
    for i in range(5):
        srv.push(1 + i % 2, _frame(i), tenant="ab"[i % 2], seq=i)
    sched._ingest_nonblocking()
    sched.next_batch(timeout=1.0)
    sched.note_reply_batch({"t0_ns": 1_000_000, "t1_ns": 3_500_000})
    keep = ("deltas", "shed_reasons", "tenant_arrivals", "waiting",
            "inflight_batches", "serve_batch", "serve_batch_pending",
            "queue_depth", "device_ms")
    views = []
    for _ in range(2):
        win = sched.ctl_window()
        views.append(({key: win[key] for key in keep}, sorted(win),
                      len(win["waits_ms"]), len(win["assemble_t"])))
    return views


def sch_health_snapshot(k):
    srv = FakeServer(k)
    sched = k["sched"].ServingScheduler(srv, batch=4, queue_depth=2)
    for i in range(4):
        srv.push(1, _frame(i), seq=i)
    sched._ingest_nonblocking()
    return sched.health_snapshot()


SCHEDULER = {f.__name__[4:]: f for f in (
    sch_never_blocks_on_own_batch, sch_across_clients, sch_weighted_fair,
    sch_queue_full, sch_signatures_never_mix, sch_unbatchable_shed,
    sch_shutdown_drains, sch_set_knobs_immediate, sch_batch_change_pends,
    sch_lost_inflight_expires, sch_rate_override,
    sch_tenant_arrivals_count_sheds, sch_predictive_gate, sch_gate_off,
    sch_ctl_window_drains, sch_health_snapshot)}


@pytest.mark.parametrize("scenario", sorted(SCHEDULER))
def test_scheduler_matches_jax(scenario):
    both(SCHEDULER[scenario])


class _FloodQueue(queue.Queue):
    """A receive queue into which one more request arrives each time one
    is taken, up to ``extra`` arrivals: requests that come faster than
    the scheduler ingests them."""

    def __init__(self, make, extra):
        super().__init__()
        self.make, self.extra = make, extra

    def get_nowait(self):
        item = super().get_nowait()
        if self.extra > 0:
            self.extra -= 1
            self.put(self.make())
        return item


def test_next_batch_leaves_while_requests_keep_arriving():
    """Under overload a batch still leaves: next_batch ingests the
    requests queued when it was called, and those that arrive meanwhile
    wait for the next call (the port's one change to the JAX scheduler,
    which drains until the queue is empty)."""
    k = PKG["port"]
    srv = FakeServer(k)
    for i in range(10_004):
        srv.push(1, _frame(i))
    backlog = srv.recv_queue
    flood = _FloodQueue(backlog.get_nowait, 10_000)
    for _ in range(4):
        flood.put(backlog.get_nowait())
    srv.recv_queue = flood
    sched = k["sched"].ServingScheduler(srv, batch=8, queue_depth=2)
    buf = sched.next_batch(timeout=1.0)
    assert buf is not None and buf.meta["serve_fill"] == 2
    assert sched.stats["enqueued"] + sched.stats["shed"] == 4
    assert flood.qsize() == 4
    buf = sched.next_batch(timeout=1.0)
    assert buf is not None and buf.meta["serve_fill"] == 2
    assert sched.stats["enqueued"] + sched.stats["shed"] == 8


def test_scheduler_keeps_one_shape_under_concurrent_hot_set():
    """A racing set_knobs never splits one buffer between two pad
    targets (tests/test_controller.py's case, on the port)."""
    k = PKG["port"]
    srv = FakeServer(k)
    sched = k["sched"].ServingScheduler(srv, batch=8)
    stop = threading.Event()

    def flip():
        b = 2
        while not stop.is_set():
            sched.set_knobs(batch=b)
            b = 8 if b == 2 else 2

    t = threading.Thread(target=flip, daemon=True)
    t.start()
    try:
        for i in range(50):
            srv.push(1, _frame(i), seq=i)
            buf = sched.next_batch(timeout=1.0)
            assert buf is not None
            n = buf.meta["serve_batch"]
            assert buf.tensors[0].shape[0] == n
            assert len(buf.meta["serve_routes"]) <= n
    finally:
        stop.set()
        t.join(timeout=2.0)
    assert not t.is_alive()


# -- plant and controller -----------------------------------------------------

@pytest.mark.parametrize("batch", [1, 8, 32])
def test_plant_predictions_match(batch):
    def run(k):
        out = []
        for depth in (0, 16, 256):
            for rps in (0.0, 60.0, 145.0, 300.0, 5000.0):
                for linger in (0.0, 2.0):
                    out.append(k["plant"].predict_latency(
                        {"serve_batch": batch, "queue_depth": depth,
                         "linger_ms": linger, "replicas": 1 + (batch > 8)},
                        {"arrival_rps": rps, "device_ms_per_launch": 40.0,
                         "batch_cycle_ms": 50.0 if rps > 100 else 0.0}))
        out.append([k["plant"].slo_optimal_batch({"row_device_ms": r}, slo)
                    for r in (0.1, 1.0) for slo in (1.0, 30.0, 500.0)])
        return out

    both(run)


def test_ctl_bounds_grammar_matches():
    def run(k):
        p = k["serving"].parse_ctl_bounds
        out = [p("batch:2:32,linger:0:5"), p(""), p("rate:1:100")]
        errors = []
        for bad in ("batch:2", "bogus:1:2", "batch:8:2"):
            with pytest.raises(ValueError) as e:
                p(bad)
            errors.append(str(e.value))
        return out, errors

    both(run)


def _snap(**kw):
    base = {
        "serve_batch": 8, "batch_fill": 0.0, "queue_p99_ms": 0.0,
        "device_p99_ms": 40.0, "admitted_p99_ms": 0.0,
        "arrival_rps": 0.0, "batch_cycle_ms": 48.0, "linger_ms": 0.0,
        "queue_depth": 32, "shed_reasons": {}, "tenants": {},
    }
    base.update(kw)
    return base


def _healthy(rate):
    return _snap(serve_batch=32, batch_fill=10.0, queue_p99_ms=20.0,
                 device_p99_ms=45.0, admitted_p99_ms=70.0, arrival_rps=300.0,
                 tenants={"bench": {"arrival_rps": 300.0, "rate": rate,
                                    "burst": 1.0}})


_CALM = _snap(batch_fill=4.0, queue_p99_ms=20.0, device_p99_ms=40.0,
              admitted_p99_ms=60.0, arrival_rps=40.0,
              tenants={"bench": {"arrival_rps": 40.0, "rate": 50.0,
                                 "burst": 10.0}})
_GROW = _snap(batch_fill=7.8, queue_p99_ms=10.0, device_p99_ms=45.0,
              admitted_p99_ms=60.0, arrival_rps=150.0)
_WORSE = _snap(serve_batch=16, batch_fill=15.0, queue_p99_ms=80.0,
               device_p99_ms=95.0, admitted_p99_ms=175.0, arrival_rps=150.0,
               batch_cycle_ms=100.0)

#: (scheduler kwargs, snapshots, slo) — the scripted feeds of
#: tests/test_controller.py's TestControllerRules and its determinism run
CONTROLLER = {
    "queue_shrink": (dict(batch=16, linger_ms=8.0), [_snap(
        serve_batch=16, batch_fill=2.0, queue_p99_ms=90.0,
        device_p99_ms=30.0, admitted_p99_ms=120.0, arrival_rps=20.0,
        linger_ms=8.0)], 200.0),
    "device_grow": (dict(batch=8), [_GROW], 200.0),
    "queue_saturated_grow": (dict(batch=8), [_snap(
        batch_fill=7.5, queue_p99_ms=105.0, device_p99_ms=41.0,
        admitted_p99_ms=150.0, arrival_rps=163.0)], 200.0),
    "rate_cut": (dict(batch=32), [_snap(
        serve_batch=32, batch_fill=30.0, queue_p99_ms=260.0,
        device_p99_ms=45.0, admitted_p99_ms=305.0, arrival_rps=400.0,
        tenants={"bench": {"arrival_rps": 400.0, "rate": 300.0,
                           "burst": 30.0}})], 200.0),
    "burst_spend": (dict(batch=8, rate=50.0, burst=10.0),
                    [_CALM] * 5 + [dict(_CALM,
                                        shed_reasons={"rate-limited": 7})],
                    200.0),
    "revert": (dict(batch=8), [_GROW, _WORSE, _GROW], 200.0),
    "revert_deferred": (dict(batch=8), [
        _GROW, dict(_WORSE, serve_batch=8, serve_batch_pending=16,
                    batch_fill=7.8), _WORSE], 200.0),
    "rate_restore": (dict(batch=32), [_snap(
        serve_batch=32, batch_fill=30.0, queue_p99_ms=260.0,
        device_p99_ms=45.0, admitted_p99_ms=305.0, arrival_rps=400.0,
        tenants={"bench": {"arrival_rps": 400.0, "rate": 0.0,
                           "burst": 1.0}})]
        + [_healthy(300.0)] * 5 + [_healthy(375.0)] + [_healthy(0.0)] * 3,
        200.0),
    "shed_gate": (dict(batch=8), [_snap(batch_fill=2.0, arrival_rps=10.0)],
                  200.0),
    "script": (dict(batch=8), [
        _snap(batch_fill=7.5, queue_p99_ms=105.0, device_p99_ms=41.0,
              admitted_p99_ms=150.0, arrival_rps=163.0),
        _snap(serve_batch=16, batch_fill=9.0, queue_p99_ms=60.0,
              device_p99_ms=42.0, admitted_p99_ms=105.0, arrival_rps=163.0,
              batch_cycle_ms=55.0),
        _snap(serve_batch=16, batch_fill=15.5, queue_p99_ms=140.0,
              device_p99_ms=42.0, admitted_p99_ms=185.0, arrival_rps=330.0,
              batch_cycle_ms=55.0),
        _snap(serve_batch=32, batch_fill=18.0, queue_p99_ms=70.0,
              device_p99_ms=44.0, admitted_p99_ms=115.0, arrival_rps=330.0,
              batch_cycle_ms=60.0),
        _snap(serve_batch=32, batch_fill=4.0, queue_p99_ms=20.0,
              device_p99_ms=44.0, admitted_p99_ms=65.0, arrival_rps=80.0,
              batch_cycle_ms=60.0)], 200.0),
}


def _drive_controller(k, scenario):
    kwargs, snaps, slo = CONTROLLER[scenario]
    s = k["serving"]
    sched = s.ServingScheduler(FakeServer(k), **kwargs)
    tracer = k["trace"].Tracer()
    clock = s.SimClock()
    c = s.ServingController(
        sched, slo_ms=slo, bounds=s.parse_ctl_bounds(
            "batch:2:32,linger:0:10"),
        clock=clock, feed=s.ReplayFeed(snaps), stats_key="srv",
        tracer_fn=lambda: tracer)
    for _ in snaps:
        clock.advance(0.05)
        c.tick()
    return (c.decision_log_text(), sched.knobs(),
            sched.admission.tenant_rate("bench"), sched._ctl_gate,
            tracer.ctl_report())


@pytest.mark.parametrize("scenario", sorted(CONTROLLER))
def test_controller_decisions_match(scenario):
    """The same scripted tick sequence gives the same decision log, the
    same knob values and the same ctl report in both packages."""
    log, *_ = both(lambda k: _drive_controller(k, scenario))
    assert log.strip(), "the script made no decision"


# -- the tracer ---------------------------------------------------------------

class _Element:
    """The scheduler's view of its serversrc: a name, a pipeline with a
    tracer, a message sink."""

    def __init__(self, tracer):
        self.name = "ssrc"
        self.pipeline = self
        self.tracer = tracer
        self.bus = self
        self.messages = []
        self.faults = []

    def post_message(self, mtype, data):
        self.messages.append((mtype, data))

    def record_fault(self, name, **kw):
        self.faults.append((name, kw))


def _keys(d):
    """The nested key structure of a report section (values dropped)."""
    if isinstance(d, dict):
        return {k: _keys(v) for k, v in d.items()}
    if isinstance(d, list) and d and isinstance(d[0], dict):
        return [_keys(d[0])]
    return None


def _fixed_lines(text):
    """The metrics text without the real pool waits of server "srv" (wall
    clock); the fixed waits of server "fix" and every counter stay."""
    return [line for line in text.splitlines()
            if not (line.startswith("nnstpu_serving_wait_us")
                    and 'server="srv"' in line)]


def _fake_run(k):
    """A fake-server run through the scheduler with a tracer attached:
    two tenants, a queue-full shed, three batches, replies, a reply drop,
    fixed pool waits, a controller decision and two sampled request
    traces."""
    tracer = k["trace"].Tracer()
    el = _Element(tracer)
    srv = FakeServer(k)
    sched = k["sched"].ServingScheduler(srv, batch=4, queue_depth=2,
                                        stats_key="srv", element=el)
    for i in range(6):
        srv.push(1 + i % 2, _frame(i), tenant="a" if i % 2 else "b", seq=i)
    bufs = [sched.next_batch(timeout=1.0)]
    srv.push(3, _frame(10), tenant="a", seq=10)
    srv.push(3, _frame(11), tenant="a", seq=11)
    bufs.append(sched.next_batch(timeout=1.0))
    srv.push(1, _frame(12), tenant="b", seq=12)
    bufs.append(sched.next_batch(timeout=1.0))
    for buf in bufs:
        for r in buf.meta["serve_routes"]:
            tracer.record_serving_reply("srv", r["tenant"])
    tracer.record_serving_reply_drop("srv")
    for i, secs in enumerate((0.0004, 0.002, 0.03)):
        tracer.record_serving_wait("fix", secs, "t", trace_id=f"{i:016x}")
    tracer.record_ctl_decision("srv", {
        "tick": 1, "t_ms": 50.0, "rule": "grow", "knob": "serve-batch",
        "before": 8, "after": 16, "reason": "r", "observed": {}})
    for i, rtt in enumerate((1.5, 7.25)):
        tracer.record_request_trace(
            "localhost:1", {"trace_id": f"{i:016x}", "rtt_ms": rtt,
                            "queue_ms": 0.5, "device_ms": rtt / 2},
            sample=(1, 2, 3, 4 + i))
    tracer.record_request_trace("localhost:1", {
        "trace_id": "ff", "rtt_ms": 2.0, "shed": "queue-full"})
    rep = tracer.report()
    serving = rep["serving"]["srv"]
    counters = {key: serving[key] for key in (
        "enqueued", "shed", "shed_reasons", "batches", "rows",
        "padded_rows", "batch_fill", "replies", "reply_drops")}
    counters["tenants"] = {t: {kk: v for kk, v in e.items()
                               if kk != "goodput_rps"}
                           for t, e in serving["per_tenant"].items()}
    counters["queue_depth"] = serving["queue_depth"]
    return {"keys": _keys({s: rep[s] for s in ("serving", "ctl",
                                                "trace_x", "metrics")}),
            "counters": counters,
            "fix_wait": rep["serving"]["fix"]["time_in_queue"]["count"],
            "ctl": rep["ctl"], "trace_x": rep["trace_x"],
            "clock_samples": tracer.clock_samples(),
            "metrics_text": _fixed_lines(tracer.metrics_text()),
            "openmetrics": _fixed_lines(tracer.metrics_text(
                openmetrics=True)),
            "sched_stats": dict(sched.stats),
            "messages": el.messages, "faults": el.faults}


def test_tracer_serving_report_matches_jax():
    got = both(_fake_run)
    assert got["counters"]["shed_reasons"] == {"queue-full": 2}
    assert got["counters"]["rows"] == 7 and got["counters"]["batches"] == 3
    assert got["counters"]["replies"] == 7
    text = "\n".join(got["metrics_text"])
    assert 'nnstpu_serving_wait_us_count{server="fix",tenant="t"} 3' in text
    assert 'nnstpu_request_rtt_us_count{peer="localhost:1"} 3' in text


def test_tracer_serving_spans_and_snapshot():
    """Span mode: the scheduler's serve-wait spans on the server's track,
    and the periodic snapshot's serving and ctl entries, named as the JAX
    tracer names them."""
    def run(k):
        tracer = k["trace"].Tracer(spans=True)
        srv = FakeServer(k)
        sched = k["sched"].ServingScheduler(srv, batch=2, stats_key="srv",
                                            element=_Element(tracer))
        for i in range(3):
            srv.push(1, _frame(i))
        sched.next_batch(timeout=1.0)
        tracer.record_ctl_decision("srv", {"knob": "linger-ms", "after": 1})
        snap = tracer._metrics_snapshot()
        names = sorted({(r[1], r[2]) for r in tracer.spans.records()})
        return names, sorted(snap), sorted(snap["serving"]["srv"]), \
            snap["ctl"], sorted(tracer.serving()["srv"])

    names, *_ = both(run)
    assert ("serve-wait", "serving") in names


# -- loopback properties through the port's elements --------------------------

def _server(extra="", filt=None, sid="sv", caps=CAPS4):
    p = parse_launch(
        f"tensor_query_serversrc name=ssrc id={sid} port=0 serve=1 "
        f"serve-batch=8 serve-queue-depth=64 caps={caps} {extra} "
        f"! {filt or 'tensor_filter framework=custom-easy model=sv_double'} "
        f"name=f ! tensor_query_serversink name=sink id={sid} timeout=5")
    tracer = ttrace.attach(p)
    p.play()
    return p, tracer


def _client(port, extra=""):
    cl = parse_launch(f"appsrc name=src caps={CAPS4} ! tensor_query_client "
                      f"name=qc port={port} timeout=10 {extra} "
                      "! tensor_sink name=out")
    cl.play()
    return cl


def _values(cl):
    return [float(np.asarray(b[0]).reshape(-1)[0])
            for b in cl["out"].collected]


def _wait_for(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


@pytest.fixture
def easy_models():
    """custom-easy probes in the port's registry: a doubler, a slow
    doubler and a stalling doubler, at serve-batch 8 and 2."""
    made = []

    def reg(name, fn, dims):
        info = TensorsInfo.from_strings(dims, "float32")
        register_custom_easy(name, fn, info, info)
        made.append(name)

    def double(xs):
        return [np.asarray(xs[0]) * 2]

    reg("sv_double", double, "4:8")
    reg("sv_slow", lambda xs: (time.sleep(0.05), double(xs))[1], "4:8")
    reg("sv_stall", lambda xs: (time.sleep(0.4), double(xs))[1], "4:2")
    reg("sv_ctl", lambda xs: (time.sleep(0.01), double(xs))[1], "4:4")
    yield
    for name in made:
        unregister_custom_easy(name)


def test_cross_client_fill_and_demux(easy_models):
    server, tracer = _server(sid="fill")
    results = {}
    try:
        port = server["ssrc"].port

        def client(idx):
            cl = _client(port)
            try:
                for i in range(5):
                    cl["src"].push_buffer(TBuffer(
                        tensors=[np.full(4, idx * 100.0 + i, np.float32)],
                        pts=i))
                cl["src"].end_of_stream()
                results[idx] = (cl.bus.wait_eos(20), cl.bus.error,
                                _values(cl))
            finally:
                cl.stop()

        threads = [threading.Thread(target=client, args=(k,), daemon=True)
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        s = tracer.serving()["fill"]
    finally:
        server.stop()
    for idx, (ok, err, vals) in results.items():
        assert ok and err is None, (idx, err)
        assert vals == [2.0 * (idx * 100.0 + i) for i in range(5)]
    assert s["rows"] == 20 and s["shed"] == 0 and s["replies"] == 20
    assert s["batches"] < 20 and s["batch_fill"] > 1.0
    assert s["time_in_queue"]["count"] == 20
    assert s["queue_depth"]["count"] == 20


def test_one_input_shape_at_the_filter_across_fills():
    """Whatever the fill (1 row or 6), padding keeps ONE input signature
    at the filter: the port's counterpart of jit_traces == 1."""
    server, tracer = _server(filt=ADD_FILTER, sid="sig")
    try:
        cl = _client(server["ssrc"].port)
        cl["src"].push_buffer(TBuffer(tensors=_frame(1.0), pts=0))
        assert _wait_for(lambda: len(cl["out"].collected) == 1)
        for i in range(6):
            cl["src"].push_buffer(TBuffer(tensors=_frame(2.0 + i),
                                          pts=1 + i))
        cl["src"].end_of_stream()
        assert cl.bus.wait_eos(20) and cl.bus.error is None
        vals = _values(cl)
        cl.stop()
        assert tracer.serving()["sig"]["batches"] >= 2
        assert server["f"].fw.compile_stats()["jit_traces"] == 1
    finally:
        server.stop()
    assert vals == [2.0] + [3.0 + i for i in range(6)]


def test_overload_sheds_server_busy_and_the_client_drops(easy_models):
    server, tracer = _server(
        extra="serve-queue-depth=2", sid="ovl",
        filt="tensor_filter framework=custom-easy model=sv_slow")
    try:
        cl = _client(server["ssrc"].port, "on-error=drop max-in-flight=64")
        for i in range(30):
            cl["src"].push_buffer(TBuffer(tensors=_frame(i), pts=i))
        cl["src"].end_of_stream()
        assert cl.bus.wait_eos(30), "client wedged on shed replies"
        assert cl.bus.error is None
        delivered = len(cl["out"].collected)
        dropped = cl["qc"].error_stats["dropped"]
        busy = [f for f in cl.bus.fault_record
                if f.get("action") == "busy-drop"]
        cl.stop()
        s = tracer.serving()["ovl"]
    finally:
        server.stop()
    assert s["shed"] > 0 and dropped == s["shed"]
    assert delivered == s["replies"] and delivered + dropped == 30
    assert s["shed_reasons"].get("queue-full", 0) > 0
    assert len(busy) == dropped
    assert all(f["element"] == "qc" for f in busy)


def test_retry_rides_out_a_rate_limit(easy_models):
    server, tracer = _server(extra="serve-rate=50 serve-burst=1", sid="rl")
    try:
        cl = _client(server["ssrc"].port,
                     "on-error=retry:8 retry-backoff-ms=30")
        for i in range(4):
            cl["src"].push_buffer(TBuffer(tensors=_frame(i), pts=i))
        cl["src"].end_of_stream()
        assert cl.bus.wait_eos(30) and cl.bus.error is None
        outs = sorted(_values(cl))
        retries = cl["qc"].error_stats["retries"]
        cl.stop()
        shed = tracer.serving()["rl"]["shed"]
    finally:
        server.stop()
    assert outs == [0.0, 2.0, 4.0, 6.0]
    assert retries > 0 and shed > 0


def test_clean_drain_on_stop(easy_models):
    server, tracer = _server(
        extra="serve-batch=2", sid="drain",
        filt="tensor_filter framework=custom-easy model=sv_stall")
    try:
        cl = _client(server["ssrc"].port, "on-error=drop max-in-flight=16")
        for i in range(8):
            cl["src"].push_buffer(TBuffer(tensors=_frame(i), pts=i))
        _wait_for(lambda: tracer.serving().get("drain", {})
                  .get("enqueued", 0) >= 4, 5.0)
        t0 = time.monotonic()
        server.stop()
        assert time.monotonic() - t0 < 10
        s = tracer.serving()["drain"]
        assert s["shed_reasons"].get("draining", 0) > 0, s
        cl["src"].end_of_stream()
        assert cl.bus.wait_eos(20) and cl.bus.error is None
        assert len(cl["out"].collected) + cl["qc"].error_stats["dropped"] == 8
        cl.stop()
    finally:
        server.stop()


def test_reply_drop_is_recorded():
    """A reply whose client is gone is dropped, recorded in the fault
    record and on the tracer, and the stream goes on. The filter holds
    the request until the server has seen the client leave, so the reply
    cannot win the race."""
    gone = threading.Event()
    info = TensorsInfo.from_strings("4", "float32")
    register_custom_easy(
        "sv_hold", lambda xs: (gone.wait(10), [np.asarray(xs[0]) * 2])[1],
        info, info)
    server = parse_launch(
        "tensor_query_serversrc name=ssrc id=rdrop port=0 "
        f"caps={CAPS4} ! tensor_filter framework=custom-easy model=sv_hold "
        "! tensor_query_serversink name=sink id=rdrop")
    tracer = ttrace.attach(server)
    server.play()
    try:
        cli = EdgeClient("localhost", server["ssrc"].port, timeout=5.0)
        cli.connect()
        cli.send(tproto.buffer_to_message(
            TBuffer(tensors=_frame(3.0), pts=0), tproto.MSG_DATA))
        cli.close()
        srv = tquery.get_server("rdrop")
        assert _wait_for(lambda: not srv._conns)
        gone.set()
        assert _wait_for(lambda: any(
            f.get("action") == "reply-drop" for f in server.bus.fault_record))
        recs = [f for f in server.bus.fault_record
                if f.get("action") == "reply-drop"]
        assert recs[0]["element"] == "sink"
        assert tracer.faults()["sink"]["reply-drop"] >= 1
        assert server.bus.error is None
    finally:
        gone.set()
        server.stop()
        unregister_custom_easy("sv_hold")


def test_send_to_timeout_bounds_a_wedged_client():
    srv = EdgeServer()
    srv.start()
    try:
        import socket as _socket

        s = _socket.create_connection(("localhost", srv.port), 5.0)
        tproto.recv_message(s)
        big = tproto.Message(tproto.MSG_RESULT, {}, [b"x" * (64 << 20)])
        t0 = time.monotonic()
        ok = srv.send_to(1, big, timeout=0.3)
        assert ok is False and time.monotonic() - t0 < 5.0
        tproto.hard_close(s)
    finally:
        srv.close()


def test_serversink_passes_its_timeout(monkeypatch):
    seen = {}
    orig = EdgeServer.send_to

    def spy(self, cid, msg, timeout=None):
        seen["timeout"] = timeout
        return orig(self, cid, msg, timeout=timeout)

    monkeypatch.setattr(EdgeServer, "send_to", spy)
    server = parse_launch(
        "tensor_query_serversrc name=ssrc id=tmo port=0 "
        f"caps={CAPS4} ! {ADD_FILTER} "
        "! tensor_query_serversink id=tmo timeout=2.5")
    server.play()
    try:
        cl = _client(server["ssrc"].port)
        cl["src"].push_buffer(TBuffer(tensors=_frame(1.0), pts=0))
        cl["src"].end_of_stream()
        assert cl.bus.wait_eos(15) and cl.bus.error is None
        cl.stop()
        assert seen.get("timeout") == 2.5
    finally:
        server.stop()


def _demux(k, tensors, fill, batch, monkeypatch):
    """One batched buffer through a package's serversink with a recording
    server: the wire bytes of each reply, in send order."""
    sent = []

    class _Srv:
        def send_to(self, cid, msg, timeout=None):
            sent.append((cid, k["proto"].encode_message(msg)))
            return True

    monkeypatch.setattr(k["query"], "get_server", lambda key: _Srv())
    sink = k["query"].TensorQueryServerSink(id="demux")
    sink.start()
    buf = k["Buffer"](tensors=tensors, meta={
        "serve_routes": [{"client_id": c, "tenant": "_default", "pts": c,
                          "duration": -1, "meta": {"_seq": c}}
                         for c in range(1, fill + 1)],
        "serve_fill": fill, "serve_batch": batch})
    assert sink.chain(sink.sink_pad, buf).name == "OK"
    return sent


@pytest.mark.parametrize("device", ["numpy", "torch"])
def test_demux_slices_by_serve_batch_not_fill(monkeypatch, device):
    """A non-batched output (leading dim != serve-batch) goes whole to
    every client whatever the fill; true per-row outputs slice. The
    port's replies are byte-equal to the JAX serversink's, whether the
    filter's outputs are numpy or torch tensors."""
    batched = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
    summary = np.arange(16, dtype=np.float32)
    conv = (lambda a: torch.from_numpy(a.copy())) if device == "torch" \
        else (lambda a: a)
    want = _demux(PKG["jax"], [batched, summary], 3, 8, monkeypatch)
    got = _demux(PKG["port"], [conv(batched), conv(summary)], 3, 8,
                 monkeypatch)
    assert got == want and len(got) == 3
    for k, (cid, data) in enumerate(got):
        row, whole = tproto.message_to_buffer(
            tproto.decode_message(data)).tensors
        np.testing.assert_array_equal(row, batched[k])
        np.testing.assert_array_equal(whole, summary)


def test_demux_of_an_argmax_output_gives_0d_rows(monkeypatch):
    """postproc:argmax gives a [B] output: each reply row is a 0-d value,
    encoded as the JAX package encodes it."""
    labels = np.array([5, 1, 4, 1, 5, 9, 2, 6], dtype=np.int32)
    want = _demux(PKG["jax"], [labels], 5, 8, monkeypatch)
    got = _demux(PKG["port"], [torch.from_numpy(labels.copy())], 5, 8,
                 monkeypatch)
    assert got == want and len(got) == 5
    vals = [int(tproto.message_to_buffer(tproto.decode_message(d))
                .tensors[0].reshape(-1)[0]) for _, d in got]
    assert vals == [5, 1, 4, 1, 5]


def test_the_d2h_is_billed_once_per_batch():
    """A batch's outputs come to the host once: one d2h crossing per
    served batch, with the batch's bytes, at the filter — the residency
    boundary before the serversink, a host consumer — and none at the
    serversink."""
    server, tracer = _server(filt=ADD_FILTER, sid="d2h")
    try:
        cl = _client(server["ssrc"].port)
        for i in range(3):
            cl["src"].push_buffer(TBuffer(tensors=_frame(i), pts=i))
            assert _wait_for(lambda: len(cl["out"].collected) == i + 1)
        cl["src"].end_of_stream()
        assert cl.bus.wait_eos(20)
        cl.stop()
        batches = tracer.serving()["d2h"]["batches"]
        per = tracer.crossings()["per_element"]
    finally:
        server.stop()
    assert batches == 3
    assert "sink" not in per
    cr = per["f"]
    assert (cr["d2h"], cr["d2h_bytes"]) == (3, 3 * 8 * 4 * 4)


def test_serving_properties():
    from nnstreamer_tpu_torch.log import ElementError

    e = tquery.TensorQueryServerSrc(serve=1, serve_batch=8, caps=CAPS4)
    assert e._batched_caps(CAPS4).to_config().info.tensors[0].np_shape() \
        == (8, 4)
    p = parse_launch("tensor_query_serversrc name=ssrc id=nc port=0 serve=1 "
                     "serve-batch=4 ! tensor_query_serversink id=nc")
    try:
        with pytest.raises(ElementError, match="fixed caps"):
            p.play()
    finally:
        p.stop()
    p = parse_launch(f"tensor_query_serversrc id=bad port=0 ctl=1 slo-ms=100 "
                     f"caps={CAPS4} ! tensor_sink")
    try:
        with pytest.raises(Exception, match="ctl=1 needs serve=1"):
            p.play()
    finally:
        p.stop()


@pytest.mark.parametrize("replicas", ["2", "4", "auto"])
def test_replicas_refuses_and_names_the_missing_pool(replicas):
    """replicas=N|auto with no served filter: there is nothing to copy,
    so the planner refuses the pool (NNST961) and the refusal names the
    missing filter; the server runs single-replica, never a pool in
    silence."""
    p = parse_launch(f"tensor_query_serversrc name=ssrc id=rp port=0 "
                     f"serve=1 serve-batch=8 replicas={replicas} "
                     f"caps={CAPS4} ! tensor_query_serversink id=rp")
    try:
        p.play()
        code, why = p["ssrc"]._pool_refused
        assert code == "NNST961"
        assert "no downstream tensor_filter" in why
        assert p["ssrc"]._pool_state is None
    finally:
        p.stop()


@pytest.mark.parametrize("replicas", ["off", "1"])
def test_replicas_off_serves(easy_models, replicas):
    """replicas=off (the default) and replicas=1 serve as a server with
    no replicas property does: every reply doubled, in order."""
    server, _ = _server(f"replicas={replicas}", sid=f"r{replicas}")
    try:
        cl = _client(server["ssrc"].port)
        try:
            for v in range(3):
                cl["src"].push_buffer(TBuffer(tensors=_frame(v), pts=v))
            cl["src"].end_of_stream()
            assert cl.bus.wait_eos(10)
            assert _values(cl) == [0.0, 2.0, 4.0]
        finally:
            cl.stop()
    finally:
        server.stop()


def test_controller_on_a_live_line(easy_models):
    server, tracer = _server(
        extra="serve-batch=4 serve-queue-depth=32 ctl=1 slo-ms=500 "
              "ctl-interval-ms=20 ctl-bounds=batch:2:16", sid="live",
        filt="tensor_filter framework=custom-easy model=sv_ctl")
    try:
        assert server["ssrc"]._ctl is not None
        cl = _client(server["ssrc"].port, "max-in-flight=64")
        for i in range(40):
            cl["src"].push_buffer(TBuffer(tensors=_frame(i)))
            time.sleep(0.005)
        assert _wait_for(lambda: len(cl["out"].collected) == 40, 15.0)
        assert _wait_for(lambda: "live" in tracer.report().get("ctl", {}))
        entry = tracer.report()["ctl"]["live"]
        assert any(d["rule"] == "shed-gate" for d in entry["decisions"])
        assert server["ssrc"]._sched._ctl_gate is not None
        cl.stop()
    finally:
        server.stop()
    assert server["ssrc"]._ctl is None


def test_hot_set_keeps_signatures_bounded():
    """A mid-stream serve-batch change never mixes two shapes in one
    invoke: every reply is right and the filter sees at most one input
    signature per distinct serve-batch value."""
    server = parse_launch(
        "tensor_query_serversrc name=ssrc id=hot port=0 serve=1 "
        f"serve-batch=4 serve-queue-depth=64 caps={CAPS4} "
        f"! {ADD_FILTER} name=f ! tensor_query_serversink id=hot timeout=5")
    server.play()
    try:
        cl = _client(server["ssrc"].port)

        def send_and_wait(vals):
            n0 = len(cl["out"].collected)
            for v in vals:
                cl["src"].push_buffer(TBuffer(tensors=_frame(v)))
            assert _wait_for(
                lambda: len(cl["out"].collected) >= n0 + len(vals))

        send_and_wait([1.0, 2.0, 3.0])
        out = server["ssrc"]._sched.set_knobs(batch=2)
        assert out["serve_batch"] in (2, {"pending": 2})
        send_and_wait([4.0, 5.0, 6.0])
        got = sorted(_values(cl))
        traces = server["f"].fw.compile_stats()["jit_traces"]
        cl.stop()
    finally:
        server.stop()
    assert got == [2.0, 3.0, 4.0, 5.0, 6.0, 7.0]
    assert traces <= 2


def test_traced_request_decomposes_at_the_client():
    """trace-sample=1 against the port's serving server: every reply
    carries the server's stages, and the client's tracer banks one
    request record and clock sample per request under the JAX keys."""
    server, _ = _server(filt=ADD_FILTER, sid="tx")
    try:
        cl = parse_launch(f"appsrc name=src caps={CAPS4} "
                          f"! tensor_query_client port="
                          f"{server['ssrc'].port} trace-sample=1 "
                          "! tensor_sink name=out")
        tracer = ttrace.attach(cl)
        cl.play()
        for i in range(3):
            cl["src"].push_buffer(TBuffer(tensors=_frame(i), pts=i))
        cl["src"].end_of_stream()
        assert cl.bus.wait_eos(20) and cl.bus.error is None
        rep = tracer.tracex_report()
        samples = tracer.clock_samples()
        cl.stop()
    finally:
        server.stop()
    assert rep["sampled"] == 3 and len(samples) == 3
    assert {"queue_ms", "reply_ms"} <= set(rep["components_ms"])
    assert set(rep) == {"sampled", "shed_sampled", "components_ms",
                        "slow_exemplars", "shed_exemplars", "recent"}
