"""The runtime sanitizer, the lock witness and the schedule fuzzer through
both packages, on the CPU.

The reference's sanitizer cases of tests/test_analysis.py (NNST600 tee
aliasing, NNST601 busy gate, NNST602 un-billed materialization) and its
lock-witness cases of tests/test_threads.py (NNST610 lock order, NNST611
blocking under a lock, NNST612 handoff mutation, NNST613 a lock across an
invoke, the lock contracts and the tracer's ``locks`` section) run through
``nnstreamer_tpu`` and ``nnstreamer_tpu_torch``, each with its own
sanitizer switched on and the other package's switched off in the
fixture, ``doctor --locks`` through each package's own
``tools/doctor.py``. Left out: the replica-pool and rollout cases (the
rollout canary's own cases are tests/test_torch_rollout.py's) and the
timing gate ``test_witness_overhead_under_10pct``.

Then the port alone: NNST600 on torch tensors through the version
counters (a tee of CPU tensors into a ``tensor_transform
acceleration=device:cpu`` that writes in place), NNST612 on a torch
tensor without reading its bytes, the seeded soak printing the same
bytes twice, the sleep probe stacking with the JAX package's, and each
package's switch leaving the other's alone.
"""

import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import nnstreamer_tpu.analysis.lockwitness  # noqa: E402
import nnstreamer_tpu.analysis.sanitizer  # noqa: E402
import nnstreamer_tpu.buffer  # noqa: E402
import nnstreamer_tpu.edge.protocol  # noqa: E402
import nnstreamer_tpu.elements.decoder  # noqa: E402
import nnstreamer_tpu.elements.transform  # noqa: E402
import nnstreamer_tpu.meta  # noqa: E402
import nnstreamer_tpu.pipeline  # noqa: E402
import nnstreamer_tpu.serving.scheduler  # noqa: E402
import nnstreamer_tpu.testing.schedfuzz  # noqa: E402
import nnstreamer_tpu.trace  # noqa: E402
import nnstreamer_tpu.types  # noqa: E402
import nnstreamer_tpu_torch.analysis.lockwitness  # noqa: E402
import nnstreamer_tpu_torch.analysis.sanitizer  # noqa: E402
import nnstreamer_tpu_torch.buffer  # noqa: E402
import nnstreamer_tpu_torch.edge.protocol  # noqa: E402
import nnstreamer_tpu_torch.elements.decoder  # noqa: E402
import nnstreamer_tpu_torch.elements.transform  # noqa: E402
import nnstreamer_tpu_torch.meta  # noqa: E402
import nnstreamer_tpu_torch.pipeline  # noqa: E402
import nnstreamer_tpu_torch.serving.scheduler  # noqa: E402
import nnstreamer_tpu_torch.testing.schedfuzz  # noqa: E402
import nnstreamer_tpu_torch.trace  # noqa: E402
import nnstreamer_tpu_torch.types  # noqa: E402

CAPS_F32 = ("other/tensors,num-tensors=1,dimensions=4:2,types=float32,"
            "framerate=0/1")
CAPS4 = "other/tensors,num-tensors=1,dimensions=4,types=float32,framerate=0/1"


class Pkg:
    """One package's sanitizer, witness and pipeline under one set of
    names."""

    def __init__(self, name):
        mod = sys.modules
        self.name = name
        self.port = name == "nnstreamer_tpu_torch"
        self.sanitizer = mod[f"{name}.analysis.sanitizer"]
        self.lockwitness = mod[f"{name}.analysis.lockwitness"]
        self.schedfuzz = mod[f"{name}.testing.schedfuzz"]
        self.parse_launch = mod[f"{name}.pipeline"].parse_launch
        self.Buffer = mod[f"{name}.buffer"].Buffer
        self.trace = mod[f"{name}.trace"]
        self.proto = mod[f"{name}.edge.protocol"]
        self.wrap_flexible = mod[f"{name}.meta"].wrap_flexible
        self.ServingScheduler = mod[f"{name}.serving.scheduler"] \
            .ServingScheduler
        self.TensorInfo = mod[f"{name}.types"].TensorInfo
        self.TensorsInfo = mod[f"{name}.types"].TensorsInfo
        self.TensorTransform = mod[f"{name}.elements.transform"] \
            .TensorTransform
        self.decoder = mod[f"{name}.elements.decoder"]
        # the port's filters run on the CPU only when asked to
        self.cpu = "accelerator=true:cpu" if self.port else ""
        self.filter = ("tensor_filter framework=jax model=add "
                       f"custom=k:1,aot:0 {self.cpu}")


JAX = Pkg("nnstreamer_tpu")
PORT = Pkg("nnstreamer_tpu_torch")


def _quiet(pkg):
    """Both packages' sanitizers off and cleared, whatever NNSTPU_SANITIZE
    says (each package reads its own switch)."""
    for p in (JAX, PORT):
        p.sanitizer.enable(False)
        p.sanitizer.clear()
        p.lockwitness.reset()


@pytest.fixture(params=[JAX, PORT], ids=["jax", "port"])
def pkg(request):
    _quiet(request.param)
    yield request.param
    _quiet(request.param)
    for p in (JAX, PORT):
        p.sanitizer.reset()


@pytest.fixture
def san(pkg):
    """``pkg``'s sanitizer forced on (the other package's stays off) with a
    clean witness."""
    pkg.sanitizer.enable(True)
    return pkg


def _codes(pkg):
    return [v.code for v in pkg.sanitizer.violations()]


# --- NNST600: tee aliasing -------------------------------------------------

class TestSanitizerTeeAliasing:
    def test_nnst600_reintroduced_arith_cow_bug(self, san, monkeypatch):
        """An arith that mutates its (tee-shared) input in place: the
        violation names the MUTATING transform, not a sibling branch."""
        def buggy_arith(self, a, opt):
            a += 1.0  # in-place on the tee-shared array
            return a

        monkeypatch.setattr(san.TensorTransform, "_arith", buggy_arith)
        p = san.parse_launch(
            f"appsrc name=src caps={CAPS_F32} ! tee name=t  "
            "t. ! tensor_transform name=tr mode=arithmetic option=add:1 "
            "! tensor_sink name=a  t. ! tensor_sink name=b")
        p.play()
        p["src"].push_buffer(san.Buffer(
            tensors=[np.ones((4, 2), np.float32)]))
        assert p.bus.wait_eos(10)
        err = p.bus.error
        p.stop()
        assert err is not None
        v = [x for x in san.sanitizer.violations() if x.code == "NNST600"]
        assert v and v[0].element == "tr"

    def test_clean_cow_transform_passes_sanitized(self, san):
        p = san.parse_launch(
            f"appsrc name=src caps={CAPS_F32} ! tee name=t  "
            "t. ! tensor_transform mode=arithmetic option=add:1 "
            "! tensor_sink name=a  t. ! tensor_sink name=b")
        p.play()
        p["src"].push_buffer(san.Buffer(
            tensors=[np.ones((4, 2), np.float32)]))
        p["src"].end_of_stream()
        assert p.bus.wait_eos(10)
        assert p.bus.error is None
        got = np.asarray(p["a"].collected[0][0])
        untouched = np.asarray(p["b"].collected[0][0])
        p.stop()
        assert np.allclose(got, 2.0)
        assert np.allclose(untouched, 1.0)
        assert not san.sanitizer.violations()


def _torch_tee_line():
    """Torch tensors into a tee: branch ``tr`` is a device-path transform
    (on the CPU), branch ``b`` a sink."""
    return (f"appsrc name=src caps={CAPS_F32} ! tee name=t  "
            "t. ! tensor_transform name=tr mode=arithmetic "
            "option=typecast:float32,add:1 acceleration=device:cpu "
            "! tensor_sink name=a  t. ! queue name=q ! tensor_sink name=b")


@pytest.mark.parametrize("mutate", [True, False], ids=["inplace", "clean"])
def test_nnst600_torch_tensors_by_version_counter(mutate, monkeypatch):
    """The port on torch tensors, which have no WRITEABLE flag: the tee
    records each tensor's version counter and the first chain to exit
    after an in-place write (the transform's device path) is named. The
    clean transform leaves the counter alone and nothing is reported."""
    _quiet(PORT)
    PORT.sanitizer.enable(True)
    orig = PORT.TensorTransform._device_chain_inputs

    def inplace(self, buf):
        xs = orig(self, buf)
        for x in xs:
            x.add_(1.0)  # through the tee-shared tensor itself
        return xs

    if mutate:
        monkeypatch.setattr(PORT.TensorTransform, "_device_chain_inputs",
                            inplace)
    try:
        p = PORT.parse_launch(_torch_tee_line())
        p.play()
        x = torch.ones((4, 2), dtype=torch.float32)
        p["src"].push_buffer(PORT.Buffer(tensors=[x]))
        p["src"].end_of_stream()
        assert p.bus.wait_eos(10)
        err = p.bus.error
        p.stop()
        v = [x for x in PORT.sanitizer.violations() if x.code == "NNST600"]
        if mutate:
            assert err is not None
            assert len(v) == 1 and v[0].element == "tr", v
            assert "version counter" in v[0].message
        else:
            assert err is None and not v
            assert x._version == 0
    finally:
        _quiet(PORT)
        PORT.sanitizer.reset()


# --- NNST601: busy gate ----------------------------------------------------

class TestSanitizerBusyGate:
    def test_nnst601_concurrent_double_invoke(self, san, monkeypatch):
        p = san.parse_launch(
            f"appsrc name=src caps={CAPS_F32} ! "
            f"{san.filter.replace('tensor_filter', 'tensor_filter name=f')} "
            "! tensor_sink")
        p.play()
        f = p["f"]
        orig_invoke = f.fw.invoke
        monkeypatch.setattr(
            f.fw, "invoke",
            lambda inputs: (time.sleep(0.25), orig_invoke(inputs))[1])
        x = [np.ones((4, 2), np.float32)]
        errs = []

        def call():
            try:
                f._call_backend(f.fw, x)
            except san.sanitizer.SanitizerError as e:
                errs.append(e)

        threads = [threading.Thread(target=call) for _ in range(2)]
        for t in threads:
            t.start()
            time.sleep(0.05)
        for t in threads:
            t.join()
        p.stop()
        assert len(errs) == 1
        v = [x for x in san.sanitizer.violations() if x.code == "NNST601"]
        assert v and v[0].element == "f"

    def test_serial_invokes_pass_the_gate(self, san):
        p = san.parse_launch(
            f"appsrc name=src caps={CAPS_F32} ! {san.filter} "
            "! tensor_sink name=out")
        p.play()
        for _ in range(3):
            p["src"].push_buffer(san.Buffer(
                tensors=[np.ones((4, 2), np.float32)]))
        p["src"].end_of_stream()
        assert p.bus.wait_eos(20)
        assert p.bus.error is None
        p.stop()
        assert not san.sanitizer.violations()


# --- NNST602: un-billed materialization -----------------------------------

class TestSanitizerUnbilledMaterialization:
    def test_nnst602_decoder_that_forgot_to_bill(self, san):
        """A 'device-capable' decoder that secretly np.asarray's its
        device inputs and pushes host data without recording the
        crossing."""
        mod = sys.modules[f"{san.name}.caps"]
        types = sys.modules[f"{san.name}.types"]

        class LeakyDecoder:
            DEVICE_CAPABLE = True  # the planner hands it device tensors

            def init(self, opts):
                pass

            def exit(self):
                pass

            def get_out_caps(self, config):
                return mod.Caps.from_config(types.TensorsConfig(
                    types.TensorsInfo(format=types.TensorFormat.FLEXIBLE),
                    config.rate_n, config.rate_d))

            def decode(self, buf, config):
                # the bug: per-tensor host materialization, no billing
                return buf.with_tensors(
                    [np.asarray([float(np.asarray(t).sum())], np.float32)
                     for t in buf.tensors])

        san.decoder.register_custom_decoder("tleaky_sum", LeakyDecoder)
        try:
            p = san.parse_launch(
                f"appsrc name=src caps={CAPS_F32} ! {san.filter} "
                "! tensor_decoder name=dec mode=tleaky_sum "
                "! tensor_sink name=out")
            p.play()
            p["src"].push_buffer(san.Buffer(
                tensors=[np.ones((4, 2), np.float32)]))
            assert p.bus.wait_eos(10)
            err = p.bus.error
            p.stop()
        finally:
            san.decoder.unregister_custom_decoder("tleaky_sum")
        assert err is not None
        v = [x for x in san.sanitizer.violations() if x.code == "NNST602"]
        assert v and v[0].element == "dec"

    def test_billed_boundary_passes(self, san):
        p = san.parse_launch(
            f"appsrc name=src caps={CAPS_F32} ! {san.filter} "
            "! tensor_sink name=out")
        p.play()
        p["src"].push_buffer(san.Buffer(
            tensors=[np.ones((4, 2), np.float32)]))
        p["src"].end_of_stream()
        assert p.bus.wait_eos(10)
        assert p.bus.error is None
        p.stop()
        assert not [x for x in san.sanitizer.violations()
                    if x.code == "NNST602"]


# --- NNST610: lock-order inversion -----------------------------------------

class TestLockOrderInversion:
    def test_sequential_inversion_reported_without_deadlock(self, san):
        lw = san.lockwitness
        la = lw.make_lock("test.A")
        lb = lw.make_lock("test.B")

        def ab():
            with la:
                with lb:
                    pass

        def ba():
            with lb:
                with la:
                    pass

        t1 = threading.Thread(target=ab, name="t-ab")
        t1.start()
        t1.join(timeout=10)
        assert not t1.is_alive()
        assert "NNST610" not in _codes(san)  # one order alone is no cycle
        t2 = threading.Thread(target=ba, name="t-ba")
        t2.start()
        t2.join(timeout=10)
        assert not t2.is_alive(), "inversion report must never deadlock"
        v = [v for v in san.sanitizer.violations() if v.code == "NNST610"]
        assert len(v) == 1, _codes(san)
        msg = v[0].message
        assert "'t-ab'" in msg and "'t-ba'" in msg, msg
        assert "'test.A'" in msg and "'test.B'" in msg, msg
        assert msg.count("acquired at") >= 2, msg
        assert "test_torch_sanitizer.py" in msg, msg
        assert "deadlock" in msg, msg

    def test_inversion_deduplicated(self, san):
        lw = san.lockwitness
        la = lw.make_lock("test.A")
        lb = lw.make_lock("test.B")

        def order(first, second):
            with first:
                with second:
                    pass

        for _ in range(3):
            t = threading.Thread(target=order, args=(la, lb), name="d-ab")
            t.start()
            t.join(10)
            t = threading.Thread(target=order, args=(lb, la), name="d-ba")
            t.start()
            t.join(10)
        assert _codes(san).count("NNST610") == 1

    def test_three_lock_cycle_names_full_cycle(self, san):
        lw = san.lockwitness
        la, lb, lc = (lw.make_lock(f"test.{n}") for n in "ABC")

        def order(first, second):
            with first:
                with second:
                    pass

        for first, second in ((la, lb), (lb, lc), (lc, la)):
            t = threading.Thread(target=order, args=(first, second))
            t.start()
            t.join(10)
        v = [v for v in san.sanitizer.violations() if v.code == "NNST610"]
        assert len(v) == 1 and "full cycle:" in v[0].message, v

    def test_same_name_class_never_self_edges(self, san):
        lw = san.lockwitness
        l1 = lw.make_lock("test.conn.send")
        l2 = lw.make_lock("test.conn.send")
        with l1:
            with l2:
                pass
        assert "test.conn.send" not in lw.order_edges()
        assert "NNST610" not in _codes(san)


# --- NNST611: blocking under a framework lock ------------------------------

class TestBlockingUnderLock:
    def test_sleep_under_lock_reported(self, san):
        lk = san.lockwitness.make_lock("test.hot")
        with lk:
            time.sleep(0.002)  # the installed probe catches this
        v = [v for v in san.sanitizer.violations() if v.code == "NNST611"]
        assert len(v) == 1, _codes(san)
        msg = v[0].message
        assert "'test.hot'" in msg and "sleep" in msg, msg
        assert "held for" in msg and "ms" in msg, msg
        assert "test_torch_sanitizer.py" in msg, msg

    def test_blocking_ok_lock_exempt(self, san):
        lk = san.lockwitness.make_lock("test.send", blocking_ok=True)
        with lk:
            time.sleep(0.002)
        assert "NNST611" not in _codes(san)

    def test_zero_sleep_is_a_hint_not_a_block(self, san):
        lk = san.lockwitness.make_lock("test.hot")
        with lk:
            time.sleep(0)
        assert "NNST611" not in _codes(san)

    def test_explicit_chokepoint(self, san):
        lk = san.lockwitness.make_lock("test.reg")
        with lk:
            san.lockwitness.blocking_call("socket.send", "peer:1234")
        v = [v for v in san.sanitizer.violations() if v.code == "NNST611"]
        assert len(v) == 1 and "socket.send" in v[0].message, _codes(san)
        assert "peer:1234" in v[0].message

    def test_probe_uninstalled_when_off(self, san):
        lw = san.lockwitness
        san.sanitizer.enable(False)
        lw._sync_probes()
        assert time.sleep is lw._real_sleep
        san.sanitizer.enable(True)
        assert time.sleep is not lw._real_sleep


# --- NNST612: cross-thread handoff mutation --------------------------------

class TestHandoffMutation:
    def test_pre_freeze_alias_mutation_detected(self, san):
        lw = san.lockwitness
        base = np.zeros(8, np.float32)
        view = base[:]
        token = object()
        lw.handoff_send("test.chan", token, [view])
        assert not view.flags.writeable  # the freeze landed
        base[0] = 99.0  # pre-freeze alias: the freeze can't stop this

        def recv():
            lw.handoff_recv("test.chan", token, [view])

        t = threading.Thread(target=recv, name="t-recv")
        t.start()
        t.join(10)
        v = [v for v in san.sanitizer.violations() if v.code == "NNST612"]
        assert len(v) == 1, _codes(san)
        assert "'test.chan'" in v[0].message
        assert "t-recv" in v[0].message
        assert "MainThread" in v[0].message

    def test_clean_handoff_silent(self, san):
        arr = np.arange(8, dtype=np.float32)
        token = object()
        san.lockwitness.handoff_send("test.chan", token, [arr])
        san.lockwitness.handoff_recv("test.chan", token, [arr])
        assert "NNST612" not in _codes(san)

    def test_serving_route_handoff_witnessed(self, san):
        """The scheduler's ingest→assemble handoff (channel
        'serving.pool') runs the send/recv pair: a clean pass stays silent
        and leaves no entry behind."""
        srv = _FakeServer()
        sched = san.ServingScheduler(srv, batch=2, stats_key="t")
        for i in range(2):
            srv.recv_queue.put((i, _message(san, i)))
        buf = sched.next_batch(timeout=2.0)
        assert buf is not None
        assert "NNST612" not in _codes(san)
        assert san.lockwitness._handoffs == {}
        sched.shutdown()


@pytest.mark.parametrize("write", [True, False], ids=["written", "clean"])
def test_nnst612_torch_tensor_by_version_counter(write):
    """The port fingerprints a torch tensor by its version counter: a
    write through a view between send and recv is caught, and the
    tensor's bytes are never read (a meta tensor has none)."""
    _quiet(PORT)
    PORT.sanitizer.enable(True)
    try:
        for x in (torch.zeros(8), torch.empty(8, device="meta")):
            token = object()
            view = x[2:]
            PORT.lockwitness.handoff_send("test.dev", token, [x])
            if write:
                view.add_(1.0)
            PORT.lockwitness.handoff_recv("test.dev", token, [x])
        v = [v for v in PORT.sanitizer.violations() if v.code == "NNST612"]
        assert len(v) == (2 if write else 0), v
    finally:
        _quiet(PORT)
        PORT.sanitizer.reset()


# --- NNST613: lock held across a backend invoke ----------------------------

class _FW:
    name = "fw0"


class TestLockAcrossInvoke:
    def test_held_lock_reported(self, san):
        lk = san.lockwitness.make_lock("test.table")
        with lk:
            with san.sanitizer.invoke_gate(_FW(), "myfilter"):
                pass
        v = [v for v in san.sanitizer.violations() if v.code == "NNST613"]
        assert len(v) == 1, _codes(san)
        assert "'test.table'" in v[0].message
        assert "'myfilter'" in v[0].message

    def test_invoke_ok_lock_exempt(self, san):
        lk = san.lockwitness.make_lock("test.interp", invoke_ok=True)
        with lk:
            with san.sanitizer.invoke_gate(_FW(), "myfilter"):
                pass
        assert "NNST613" not in _codes(san)


# --- the lock contracts ----------------------------------------------------

class _FakeServer:
    def __init__(self):
        import queue

        self.recv_queue = queue.Queue()
        self._empty = queue.Empty

    def pop(self, timeout=0.2):
        try:
            return self.recv_queue.get(timeout=timeout)
        except self._empty:
            return None

    def send_to(self, cid, msg, timeout=None):
        return True


def _message(pkg, i):
    arr = np.full((1, 4), float(i), np.float32)
    return pkg.proto.Message(
        pkg.proto.MSG_DATA, {"seq": i},
        payloads=[pkg.wrap_flexible(
            arr, pkg.TensorInfo.from_np_shape(arr.shape, arr.dtype))])


class TestLockContracts:
    def test_scheduler_single_lock_never_nests(self, san):
        srv = _FakeServer()
        sched = san.ServingScheduler(srv, batch=4, stats_key="pin",
                                     queue_depth=128)

        def produce(k):
            for i in range(40):
                srv.recv_queue.put((k, _message(san, i)))

        threads = [threading.Thread(target=produce, args=(k,),
                                    name=f"pin-prod-{k}") for k in range(2)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 20
        while sched.stats["rows"] < 80 and time.monotonic() < deadline:
            buf = sched.next_batch(timeout=0.1)
            if buf is not None:
                sched.note_reply_batch()
        assert sched.stats["rows"] == 80
        for t in threads:
            t.join(10)
        sched.shutdown()
        edges = san.lockwitness.order_edges()
        assert "serving.scheduler" not in edges, edges
        for dsts in edges.values():
            assert "serving.scheduler" not in dsts, edges
        assert "NNST610" not in _codes(san)

    def test_chain_path_no_inversion(self, san):
        line = (f"appsrc name=src caps={CAPS_F32} "
                "! tensor_filter name=f1 framework=jax model=add "
                f"custom=k:1,aot:0 {san.cpu} ! queue "
                "! tensor_filter name=f2 framework=jax model=add "
                f"custom=k:10,aot:0 {san.cpu} ! tensor_sink name=out")
        p = san.parse_launch(line)
        p.play()
        for i in range(6):
            p["src"].push_buffer(san.Buffer(
                tensors=[np.full((4, 2), float(i), np.float32)]))
        p["src"].end_of_stream()
        assert p.bus.wait_eos(60), p.bus.error
        assert p.bus.error is None
        p.stop()
        assert "NNST610" not in _codes(san)
        assert "NNST612" not in _codes(san)

    def test_trace_rings_take_witnessed_locks(self, san):
        t = san.trace.Tracer()
        ring = t.enable_spans()

        def emit(k):
            for _ in range(20):
                t0 = time.perf_counter()
                ring.emit(f"s{k}", "test", t0, t0 + 1e-6)
                t.record_chain(f"e{k}", t0, t0 + 1e-6)

        threads = [threading.Thread(target=emit, args=(k,))
                   for k in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(10)
        rep = san.lockwitness.locks_report()
        assert "trace.spanring" in rep, sorted(rep)
        assert "trace.tracer" in rep, sorted(rep)
        assert rep["trace.spanring"]["acquisitions"] >= 60


# --- lock observability (the tracer's `locks` section) ---------------------

class TestLockObservability:
    def test_report_carries_locks_section_with_hist_contract(self, san):
        lk = san.lockwitness.make_lock("test.obs")
        for _ in range(5):
            with lk:
                pass
        rep = san.trace.Tracer().report()
        assert "locks" in rep
        s = rep["locks"]["test.obs"]
        assert s["acquisitions"] == 5
        assert len(s["held_us"]["counts"]) == len(san.trace.HIST_LE_US) + 1
        assert s["held_us"]["count"] == 5
        assert {"held_p50_us", "held_p95_us", "wait_p95_us"} <= set(s)

    def test_sanitizer_off_report_has_no_locks_section(self, pkg):
        lk = pkg.lockwitness.make_lock("test.off")
        with lk:
            pass
        assert "locks" not in pkg.trace.Tracer().report()

    def test_doctor_locks_renders(self, san, tmp_path, capsys):
        import importlib
        import json

        doctor = importlib.import_module(f"{san.name}.tools.doctor")
        lk = san.lockwitness.make_lock("test.render")
        with lk:
            pass
        path = tmp_path / "r.json"
        path.write_text(json.dumps(san.trace.Tracer().report(), default=str))
        assert doctor.main(["--locks", str(path)]) == 0
        out = capsys.readouterr().out
        assert "test.render" in out and "p95" in out


class TestOverhead:
    def test_sanitizer_off_factories_return_plain_primitives(self, pkg):
        lw = pkg.lockwitness
        assert type(lw.make_lock("x")) is type(threading.Lock())
        assert type(lw.make_rlock("x")) is type(threading.RLock())
        cond = lw.make_condition(lw.make_lock("x"))
        assert type(cond) is threading.Condition


# --- the schedule fuzzer ---------------------------------------------------

class TestSchedFuzz:
    def test_jitter_deterministic_per_seed(self, pkg, monkeypatch):
        sf = pkg.schedfuzz

        def trace_decisions(seed):
            stalls = []
            monkeypatch.setattr(sf, "_sleep", stalls.append)
            sf.configure(seed)
            try:
                sf._tls.n = 0
                for _ in range(64):
                    sf.jitter("p", "t")
                return stalls
            finally:
                sf.configure(None)
                monkeypatch.undo()

        a = trace_decisions(7)
        b = trace_decisions(7)
        c = trace_decisions(8)
        assert a == b
        assert a, "seeded fuzzer never stalled"
        assert c != a, "different seeds explore the same schedule"

    def test_same_decisions_in_both_packages(self, monkeypatch):
        """The port's jitter is the JAX package's pure function."""
        got = {}
        for p in (JAX, PORT):
            stalls = []
            monkeypatch.setattr(p.schedfuzz, "_sleep", stalls.append)
            p.schedfuzz.configure(11)
            try:
                p.schedfuzz._tls.n = 0
                for i in range(64):
                    p.schedfuzz.jitter("p", str(i % 3))
            finally:
                p.schedfuzz.configure(None)
            got[p.name] = stalls
        assert got["nnstreamer_tpu"] == got["nnstreamer_tpu_torch"]


def test_soak_is_byte_identical_across_seeded_runs():
    """Two soaks with one seed print the same bytes: violation counts,
    lock-order edges and the number of witnessed locks."""
    _quiet(PORT)
    try:
        outs = []
        for _ in range(2):
            PORT.lockwitness.reset()
            outs.append(PORT.schedfuzz._soak(3))
        assert outs[0] == outs[1], outs
        lines = outs[0].splitlines()
        assert lines[:4] == ["NNST610=0", "NNST611=0", "NNST612=0",
                             "NNST613=0"], lines
        assert lines[4].startswith("order-edges: ")
        assert int(lines[5].split("=")[1]) > 0
        assert not PORT.sanitizer.active()  # the soak restores the switch
    finally:
        _quiet(PORT)
        PORT.sanitizer.reset()


# --- the two packages side by side -----------------------------------------

def test_switches_are_per_package():
    """Enabling one package's sanitizer arms neither the other's checks
    nor its lock factories."""
    _quiet(PORT)
    try:
        PORT.sanitizer.enable(True)
        assert not JAX.sanitizer.active()
        assert type(JAX.lockwitness.make_lock("x")) is type(threading.Lock())
        assert isinstance(PORT.lockwitness.make_lock("x"),
                          PORT.lockwitness.WitnessLock)
        PORT.sanitizer.enable(False)
        JAX.sanitizer.enable(True)
        assert not PORT.sanitizer.active()
        assert type(PORT.lockwitness.make_lock("x")) is type(
            threading.Lock())
    finally:
        _quiet(PORT)
        for p in (JAX, PORT):
            p.sanitizer.reset()


def test_sleep_probes_stack_and_restore_exactly():
    """The two packages' sleep probes in one process: the port's probe
    wraps whatever time.sleep is when it goes in (here the JAX witness's)
    and puts exactly that back when it comes out; both report a sleep
    under their own lock."""
    _quiet(PORT)
    real = time.sleep
    try:
        JAX.sanitizer.enable(True)
        jax_probe = time.sleep
        assert jax_probe is not real
        PORT.sanitizer.enable(True)
        assert time.sleep is PORT.lockwitness._witness_sleep
        lk = PORT.lockwitness.make_lock("test.port.hot")
        with lk:
            time.sleep(0.001)
        jk = JAX.lockwitness.make_lock("test.jax.hot")
        with jk:
            time.sleep(0.001)
        assert "NNST611" in _codes(PORT) and "NNST611" in _codes(JAX)
        assert [v.element for v in PORT.sanitizer.violations()] == [
            "test.port.hot"]
        PORT.sanitizer.enable(False)
        assert time.sleep is jax_probe
        JAX.sanitizer.enable(False)
        assert time.sleep is real
    finally:
        for p in (JAX, PORT):
            p.sanitizer.enable(False)
        _quiet(PORT)
        for p in (JAX, PORT):
            p.sanitizer.reset()
        assert time.sleep is real
