"""The filter's invoke watchdog and fallback through both packages, on the
CPU.

The watchdog cases of the reference's tests/test_faults.py (a trip that
drops the frame without killing the streaming thread, no concurrent
invokes after a trip, the switch to ``fallback-framework`` after
``fallback-after`` trips, retry under a hang, the consecutive count
resetting on a success, and ``on-error=restart`` waiting for an invoke in
flight) run on the same launch lines and frames through
``nnstreamer_tpu`` and ``nnstreamer_tpu_torch``, each package with its
own custom-easy models, registered backends and fault harness, and must
give the same frames, trip counts and bus records.

Then the port alone on a small flagship line with the preamble fused into
the filter (MobileNet-v2 at 64 px, ``accelerator=true:cpu``): the switch
to a fresh ``jax`` backend instance after two hung invokes carries the
fused stage, and every frame delivered after it is bit-equal to an
unfaulted run, with ``custom=donate:1`` and at feed-depth 2 too;
``loop-window`` is refused beside ``invoke-timeout-ms``.
"""

import sys
import threading
import time

import numpy as np
import pytest
from test_torch_shared import (  # noqa: E402,F401 (fixtures)
    equal_name_counters,
    one_torch_thread,
)

pytest.importorskip("torch")
pytest.importorskip("jax")

import nnstreamer_tpu.buffer  # noqa: E402
import nnstreamer_tpu.filters.base  # noqa: E402
import nnstreamer_tpu.pipeline  # noqa: E402
import nnstreamer_tpu.registry  # noqa: E402
import nnstreamer_tpu.testing.faults  # noqa: E402
import nnstreamer_tpu.types  # noqa: E402
import nnstreamer_tpu_torch.buffer  # noqa: E402
import nnstreamer_tpu_torch.filters.base  # noqa: E402
import nnstreamer_tpu_torch.pipeline  # noqa: E402
import nnstreamer_tpu_torch.registry  # noqa: E402
import nnstreamer_tpu_torch.testing.faults  # noqa: E402
import nnstreamer_tpu_torch.types  # noqa: E402

CAPS4 = "other/tensors,num-tensors=1,dimensions=4,types=float32,framerate=0/1"


class Pkg:
    """One package's pipeline, backends and fault harness under one set
    of names."""

    def __init__(self, name):
        mod = sys.modules
        self.name = name
        self.port = name == "nnstreamer_tpu_torch"
        self.parse_launch = mod[f"{name}.pipeline"].parse_launch
        self.Buffer = mod[f"{name}.buffer"].Buffer
        base = mod[f"{name}.filters.base"]
        self.FilterFramework = base.FilterFramework
        self.register_custom_easy = base.register_custom_easy
        self.unregister_custom_easy = base.unregister_custom_easy
        self.registry = mod[f"{name}.registry"]
        self.faults = mod[f"{name}.testing.faults"]
        self.info4 = mod[f"{name}.types"].TensorsInfo.from_strings(
            "4", "float32")

    def frame(self, value=1.0):
        return self.Buffer(tensors=[np.full(4, value, np.float32)])


JAX = Pkg("nnstreamer_tpu")
PORT = Pkg("nnstreamer_tpu_torch")


@pytest.fixture(params=[JAX, PORT], ids=["jax", "port"])
def pkg(request):
    request.param.faults.clear()
    yield request.param
    request.param.faults.clear()


@pytest.fixture
def double_filter(pkg):
    pkg.register_custom_easy(
        "tflt_double", lambda xs: [np.asarray(xs[0]) * 2], pkg.info4,
        pkg.info4)
    yield pkg
    pkg.unregister_custom_easy("tflt_double")


def _backends(pkg):
    """The reference's two test backends, on ``pkg``'s base class: one
    whose invoke hangs 0.4 s, one that triples its input."""

    class SlowInvokeFW(pkg.FilterFramework):
        NAME = "twd_hang"
        SLEEP = 0.4

        def get_model_info(self):
            return pkg.info4, pkg.info4

        def invoke(self, inputs):
            time.sleep(self.SLEEP)
            return [np.asarray(inputs[0]) * 0.0]

    class OkFW(pkg.FilterFramework):
        NAME = "twd_ok"

        def get_model_info(self):
            return pkg.info4, pkg.info4

        def invoke(self, inputs):
            return [np.asarray(inputs[0]) * 3.0]

    return SlowInvokeFW, OkFW


@pytest.fixture
def watchdog_frameworks(pkg):
    slow, ok = _backends(pkg)
    pkg.registry.register(pkg.registry.FILTER, "twd_hang")(slow)
    pkg.registry.register(pkg.registry.FILTER, "twd_ok")(ok)
    yield pkg
    pkg.registry.unregister(pkg.registry.FILTER, "twd_hang")
    pkg.registry.unregister(pkg.registry.FILTER, "twd_ok")


def _run_frames(pkg, desc, n_frames, wait=5.0):
    p = pkg.parse_launch(desc)
    p.play()
    for i in range(n_frames):
        p["src"].push_buffer(pkg.Buffer(
            tensors=[np.full(4, float(i), np.float32)], pts=i))
    p["src"].end_of_stream()
    assert p.bus.wait_eos(wait), "no EOS/error on the bus"
    return p


class TestWatchdog:
    def test_trip_drops_without_killing_streaming_thread(self,
                                                         double_filter):
        pkg = double_filter
        pkg.faults.install("invoke-hang", times=1, delay_s=0.5)
        p = pkg.parse_launch(
            f"appsrc name=src caps={CAPS4} "
            "! tensor_filter name=flt framework=custom-easy "
            "model=tflt_double invoke-timeout-ms=50 on-error=drop "
            "! tensor_sink name=out")
        p.play()
        p["src"].push_buffer(pkg.frame())
        time.sleep(0.7)  # the abandoned hung worker finishes meanwhile
        for _ in range(2):
            p["src"].push_buffer(pkg.frame())
        p["src"].end_of_stream()
        assert p.bus.wait_eos(8)
        try:
            assert p.bus.error is None
            outs = p["out"].collected
            assert len(outs) == 2
            for o in outs:
                np.testing.assert_array_equal(
                    np.asarray(o[0]).reshape(-1), np.full(4, 2.0))
            assert p["flt"].get_property("watchdog-trips") == 1
            assert p["flt"].get_property("error-stats")[
                "watchdog_trips"] == 1
            trips = [r for r in p.bus.fault_record
                     if r["action"] == "watchdog-trip"]
            assert trips and trips[0]["element"] == "flt"
            assert [r["action"] for r in p.bus.fault_record] == [
                "watchdog-trip", "drop"]
        finally:
            p.stop()

    def test_no_concurrent_invokes_after_trip(self, pkg):
        """A tripped invoke still running inside the backend is not
        overlapped by the next frame's invoke on the same framework
        instance: re-entry waits the deadline out and counts further
        trips instead."""
        state = {"active": 0, "max_active": 0, "calls": 0}
        lock = threading.Lock()

        def slow_first(xs):
            with lock:
                state["calls"] += 1
                state["active"] += 1
                state["max_active"] = max(state["max_active"],
                                          state["active"])
                first = state["calls"] == 1
            if first:
                time.sleep(0.3)
            with lock:
                state["active"] -= 1
            return [np.asarray(xs[0]) * 2]

        pkg.register_custom_easy("tflt_slow1", slow_first, pkg.info4,
                                 pkg.info4)
        try:
            p = pkg.parse_launch(
                f"appsrc name=src caps={CAPS4} "
                "! tensor_filter name=flt framework=custom-easy "
                "model=tflt_slow1 invoke-timeout-ms=60 on-error=drop "
                "! tensor_sink name=out")
            p.play()
            for _ in range(3):  # back-to-back while the worker is stuck
                p["src"].push_buffer(pkg.frame())
            time.sleep(0.5)  # stuck worker drains
            p["src"].push_buffer(pkg.frame())
            p["src"].end_of_stream()
            assert p.bus.wait_eos(8)
            assert p.bus.error is None
            assert state["max_active"] == 1, "concurrent invokes on one fw"
            # the stuck frame is always dropped; how many of the
            # back-to-back frames trip vs. slip past depends on scheduling
            assert 1 <= len(p["out"].collected) <= 3
            assert p["flt"].get_property("watchdog-trips") >= 1
            p.stop()
        finally:
            pkg.unregister_custom_easy("tflt_slow1")

    def test_fallback_switchover_after_k_trips(self, watchdog_frameworks):
        """A genuinely hung backend trips the watchdog K times, then the
        filter re-opens the model on the fallback backend — visible in the
        degraded-to property, the bus record and the delivered frames."""
        pkg = watchdog_frameworks
        p = _run_frames(
            pkg,
            f"appsrc name=src caps={CAPS4} "
            "! tensor_filter name=flt framework=twd_hang model=m "
            "invoke-timeout-ms=60 fallback-framework=twd_ok "
            "fallback-after=2 on-error=drop ! tensor_sink name=out", 4,
            wait=15)
        try:
            assert p.bus.error is None
            assert p["flt"].get_property("degraded-to") == "twd_ok"
            # frame 1 tripped and dropped; frame 2 tripped, hit K=2,
            # switched and was served by the fallback: 3 frames, x3
            outs = p["out"].collected
            assert len(outs) == 3
            for i, o in zip((1, 2, 3), outs):
                np.testing.assert_array_equal(
                    np.asarray(o[0]).reshape(-1),
                    np.full(4, 3.0 * i, np.float32))
            actions = [r["action"] for r in p.bus.fault_record]
            assert actions == ["watchdog-trip", "drop", "watchdog-trip",
                               "fallback"]
            fb = next(r for r in p.bus.fault_record
                      if r["action"] == "fallback")
            assert fb["from_framework"] == "twd_hang"
            assert fb["to_framework"] == "twd_ok"
            assert p["flt"].get_property("error-stats")["fallbacks"] == 1
            assert p["flt"].get_property("watchdog-trips") == 2
        finally:
            p.stop()

    def test_hang_with_retry_keeps_delivering(self, double_filter):
        """invoke-hang under on-error=retry: the tripped frame is
        re-chained (the busy gate waits the stuck worker out) and every
        frame still arrives, with the trips attributed on the bus."""
        pkg = double_filter
        pkg.faults.install("invoke-hang", times=1, delay_s=0.12)
        p = _run_frames(
            pkg,
            f"appsrc name=src caps={CAPS4} "
            "! tensor_filter name=flt framework=custom-easy "
            "model=tflt_double invoke-timeout-ms=50 on-error=retry:4 "
            "retry-backoff-ms=1 ! tensor_sink name=out", 3, wait=8)
        try:
            assert p.bus.error is None
            outs = p["out"].collected
            assert len(outs) == 3
            for i, o in enumerate(outs):
                np.testing.assert_array_equal(
                    np.asarray(o[0]).reshape(-1),
                    np.full(4, 2.0 * i, np.float32))
            actions = [r["action"] for r in p.bus.fault_record]
            assert "watchdog-trip" in actions and "retry" in actions
            assert all(r["element"] == "flt" for r in p.bus.fault_record)
        finally:
            p.stop()

    def test_fallback_consecutive_resets_on_success(self, double_filter):
        # a trip followed by a success must not accumulate toward K
        pkg = double_filter
        pkg.faults.install("invoke-hang", times=1, delay_s=0.3)
        p = pkg.parse_launch(
            f"appsrc name=src caps={CAPS4} "
            "! tensor_filter name=flt framework=custom-easy "
            "model=tflt_double invoke-timeout-ms=50 fallback-framework=twd_ok "
            "fallback-after=2 on-error=drop ! tensor_sink name=out")
        p.play()
        p["src"].push_buffer(pkg.frame())
        time.sleep(0.5)  # hung worker drains before the healthy frames
        for _ in range(2):
            p["src"].push_buffer(pkg.frame())
        p["src"].end_of_stream()
        assert p.bus.wait_eos(8)
        try:
            assert p["flt"].get_property("degraded-to") is None
            assert p["flt"]._watchdog_consec == 0
            assert len(p["out"].collected) == 2
        finally:
            p.stop()

    def test_unset_watchdog_spawns_no_thread(self, double_filter):
        """Without invoke-timeout-ms the invoke runs inline: no worker."""
        pkg = double_filter
        p = _run_frames(
            pkg,
            f"appsrc name=src caps={CAPS4} "
            "! tensor_filter name=flt framework=custom-easy "
            "model=tflt_double ! tensor_sink name=out", 2)
        try:
            assert p["flt"]._wd_worker is None
            assert p["flt"].get_property("watchdog-trips") == 0
            assert p["flt"].get_property("degraded-to") is None
        finally:
            p.stop()


class TestRestartSerialization:
    def test_restart_waits_for_in_flight_invoke(self, pkg):
        """on-error=restart serializes against the hot loop: a restart
        issued mid-invoke blocks on the window lock until the invoke
        completes, then leaves a working framework behind."""
        slow_done = {}

        def slow(xs):
            time.sleep(0.4)
            slow_done["t"] = time.perf_counter()
            return [np.asarray(xs[0]) * 2]

        pkg.register_custom_easy("tflt_slow", slow, pkg.info4, pkg.info4)
        try:
            p = pkg.parse_launch(
                f"appsrc name=src caps={CAPS4} "
                "! tensor_filter name=flt framework=custom-easy "
                "model=tflt_slow ! tensor_sink name=out")
            p.play()
            p["src"].push_buffer(pkg.frame())
            time.sleep(0.1)  # invoke is now in flight on the src thread
            t0 = time.perf_counter()
            p["flt"]._restart_for_error()
            t_restart = time.perf_counter()
            assert "t" in slow_done, "restart overtook the in-flight invoke"
            assert t_restart >= slow_done["t"]
            assert t_restart - t0 > 0.15, "restart did not serialize"
            p["src"].push_buffer(pkg.frame())
            p["src"].end_of_stream()
            assert p.bus.wait_eos(5)
            assert len(p["out"].collected) == 2
            p.stop()
        finally:
            pkg.unregister_custom_easy("tflt_slow")


# -- the port alone: the small flagship with the preamble fused -------------

PREAMBLE = "typecast:float32,add:-127.5,div:127.5"
MBV2 = "seed:0,size:64,width:0.35,classes:16,fused:pallas"
N_FRAMES = 6


def _flagship_line(extra="", custom=MBV2, fpt=2):
    return ("appsrc name=src caps=video/x-raw,format=RGB,width=64,height=64,"
            f"framerate=30/1 ! tensor_converter name=conv "
            f"frames-per-tensor={fpt} "
            f"! tensor_transform name=tr mode=arithmetic option={PREAMBLE} "
            "! tensor_filter name=f framework=torch_cuda model=mobilenet_v2 "
            f"custom={custom} accelerator=true:cpu {extra} "
            "! tensor_sink name=out")


def _frames():
    rng = np.random.default_rng(3)
    return [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
            for _ in range(N_FRAMES * 2)]


def _flagship_run(extra="", custom=MBV2, hang=0, delay=0.6, pace=0.0):
    """Play the line, arm ``hang`` invoke-hang faults, push the frames
    (pacing each of the first ``hang`` batches by ``pace`` seconds, so an
    abandoned invoke finishes before the next batch) and return the
    pipeline, the logits per delivered batch and the seconds of each
    backend call the filter made (``_call_backend``, what the watchdog
    times; a hung call's seconds include its injected stall)."""
    faults = PORT.faults
    faults.clear()
    p = PORT.parse_launch(_flagship_line(extra, custom))
    p.play()
    calls = []
    f = p["f"]
    call_backend = f._call_backend

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return call_backend(*args, **kwargs)
        finally:
            calls.append(time.perf_counter() - t0)

    f._call_backend = timed
    if hang:
        faults.install("invoke-hang", times=hang, delay_s=delay)
    try:
        for i, fr in enumerate(_frames()):
            p["src"].push_buffer(PORT.Buffer(tensors=[fr], pts=i))
            if i % 2 == 1 and i // 2 < hang:
                time.sleep(pace)
        p["src"].end_of_stream()
        assert p.bus.wait_eos(120)
    finally:
        faults.clear()
    assert p.bus.error is None, p.bus.error
    outs = [(b.pts, np.asarray(b.tensors[0])) for b in p["out"].collected]
    return p, outs, calls


#: the watchdog's deadline against the unfaulted run's slowest backend
#: call, between a floor and a cap: an honest invoke of this small model
#: (10-25 ms alone, the first included: the model is built at play) on a
#: loaded CPU must never trip it, and a stalled unfaulted run must not
#: stretch the faulted one (each trip costs 2.5 deadlines)
DEADLINE_FACTOR, DEADLINE_FLOOR_S, DEADLINE_CAP_S = 10.0, 1.0, 3.0


def _watchdog_timing(calls):
    """(deadline ms, injected hang s, pace s) from an unfaulted run's
    backend call seconds: the hang twice the deadline (it trips), the
    pace the hang plus half a deadline (the abandoned call, stall and
    invoke, ends before the next batch)."""
    deadline = min(DEADLINE_CAP_S,
                   max(DEADLINE_FLOOR_S, DEADLINE_FACTOR * max(calls)))
    return deadline * 1e3, 2.0 * deadline, 2.5 * deadline


@pytest.mark.parametrize("extra", [
    "", "feed-depth=2", "custom-donate", "feed-depth=2 custom-donate"])
def test_flagship_switch_after_two_trips_is_bit_equal(extra):
    """Two hung invokes (twice the deadline, each paced out before the
    next batch) trip the watchdog twice: the first batch is dropped, the
    second switches to a fresh ``jax`` instance that carries the fused
    preamble and serves it, and every delivered batch is bit-equal to an
    unfaulted run's. The deadline is ten times the unfaulted run's
    slowest backend call, within [1 s, 3 s] (:func:`_watchdog_timing`)."""
    custom = MBV2 + (",donate:1" if "custom-donate" in extra else "")
    extra = extra.replace("custom-donate", "")
    _, want, calls = _flagship_run(extra, custom)
    t_ms, hang_s, pace_s = _watchdog_timing(calls)
    wd = (f"invoke-timeout-ms={t_ms:.0f} fallback-framework=jax "
          f"fallback-after=2 on-error=drop {extra}")
    p, got, _ = _flagship_run(wd, custom, hang=2, delay=hang_s, pace=pace_s)
    try:
        f = p["f"]
        assert f.get_property("watchdog-trips") == 2
        assert f.get_property("degraded-to") == "jax"
        assert f.get_property("error-stats")["dropped"] == 1
        assert f.fw._pre_specs, "the fallback lost the fused preamble"
        assert f.fw._donate == ("donate:1" in custom)
        # the dropped batch is the first one; the rest are bit-equal
        assert [pts for pts, _ in got] == [pts for pts, _ in want[1:]]
        for (_, g), (_, w) in zip(got, want[1:]):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        assert [r["action"] for r in p.bus.fault_record] == [
            "watchdog-trip", "drop", "watchdog-trip", "fallback"]
    finally:
        p.stop()


def test_failed_switch_is_loud():
    """A fallback backend that cannot be opened posts fallback-failed,
    and the trip reaches the on-error policy (deadline, hang and pace as
    :func:`_watchdog_timing` derives them from an unfaulted run)."""
    _, _, calls = _flagship_run()
    t_ms, hang_s, pace_s = _watchdog_timing(calls)
    p, got, _ = _flagship_run(
        f"invoke-timeout-ms={t_ms:.0f} fallback-framework=no_such_backend "
        "fallback-after=1 on-error=drop", hang=1, delay=hang_s, pace=pace_s)
    try:
        f = p["f"]
        assert f.get_property("degraded-to") is None
        assert f.get_property("watchdog-trips") == 1
        assert len(got) == N_FRAMES - 1
        assert "fallback" not in [r["action"] for r in p.bus.fault_record]
        posted = []
        while (m := p.bus.pop(timeout=0)) is not None:
            posted.append(m)
        failed = [m.data for m in posted if m.type == "fallback-failed"]
        assert len(failed) == 1 and failed[0]["framework"] == \
            "no_such_backend", failed
    finally:
        p.stop()


def test_loop_window_refused_with_watchdog():
    """loop-window beside invoke-timeout-ms runs per-buffer launches,
    loudly, with the loop analyzer's reason on the filter (NNST461, as in
    the JAX package): the window would bypass the watchdog, and a capture
    must not run beside an abandoned invoke's launches."""
    p = PORT.parse_launch(_flagship_line(
        "invoke-timeout-ms=500 loop-window=2", fpt=1))
    p.play()
    try:
        f = p["f"]
        assert f._loop_state is None
        code, reason = f._loop_refused
        assert code == "NNST461" and "invoke-timeout-ms" in reason
    finally:
        p.stop()
