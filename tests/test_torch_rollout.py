"""Safe rollout (``rollout-model``, ``rollout-canary-frames``,
``rollout-rollback``; NNST981) through the port, on the CPU, against the
JAX package.

The seven cases of the reference's tests/test_fleet.py::TestRolloutCanary
run through both packages on the same custom-easy models (``fleet_a``
doubles, ``fleet_b`` triples, ``fleet_bad`` raises; each package's own
registration), and each case checks that both give the same decisions, the
same outputs and the same ``rollout_report`` keys. Then the rollout over
the compile cache: a narrow MobileNet-v2 checkpoint A (``models.save_state``
of seed 0) flips to B (seed 1) and back, the flip a prefetched load and the
rollback a warm hit; a B faulted through ``testing/faults.py`` rolls back
to A. NNST981 (auto rollback with a zero canary window) against the JAX
analyzer. Both packages' element-name counters are emptied at the module's
end.
"""

import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import nnstreamer_tpu.analysis as jax_analysis  # noqa: E402
import nnstreamer_tpu.buffer as jax_buffer  # noqa: E402
import nnstreamer_tpu.filters.base as jax_base  # noqa: E402
import nnstreamer_tpu.log as jax_log  # noqa: E402
import nnstreamer_tpu.pipeline as jax_pipeline  # noqa: E402
import nnstreamer_tpu.testing.faults as jax_faults  # noqa: E402
import nnstreamer_tpu.trace as jax_trace  # noqa: E402
import nnstreamer_tpu.types as jax_types  # noqa: E402
import nnstreamer_tpu_torch.analysis as port_analysis  # noqa: E402
import nnstreamer_tpu_torch.buffer as port_buffer  # noqa: E402
import nnstreamer_tpu_torch.filters.base as port_base  # noqa: E402
import nnstreamer_tpu_torch.log as port_log  # noqa: E402
import nnstreamer_tpu_torch.pipeline as port_pipeline  # noqa: E402
import nnstreamer_tpu_torch.testing.faults as port_faults  # noqa: E402
import nnstreamer_tpu_torch.trace as port_trace  # noqa: E402
import nnstreamer_tpu_torch.types as port_types  # noqa: E402

CAPS4 = "other/tensors,num-tensors=1,dimensions=4,types=float32,framerate=0/1"

PKGS = {
    "jax": SimpleNamespace(
        name="jax", parse=jax_pipeline.parse_launch, Event=jax_buffer.Event,
        base=jax_base, trace=jax_trace, faults=jax_faults,
        ElementError=jax_log.ElementError, types=jax_types,
        analysis=jax_analysis),
    "port": SimpleNamespace(
        name="port", parse=port_pipeline.parse_launch,
        Event=port_buffer.Event, base=port_base, trace=port_trace,
        faults=port_faults, ElementError=port_log.ElementError,
        types=port_types, analysis=port_analysis),
}


def _wait(cond, timeout=8.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.fixture(scope="module", autouse=True)
def _equal_name_counters():
    """Both packages name unnamed elements from their own counters; this
    module builds unnamed elements in both, so it empties both at its end."""
    yield
    for name in ("nnstreamer_tpu", "nnstreamer_tpu_torch"):
        sys.modules[f"{name}.pipeline.element"].Element._name_counters.clear()


@pytest.fixture
def fleet_models():
    """The reference's models, registered in BOTH packages."""
    for pkg in PKGS.values():
        info = pkg.types.TensorsInfo.from_strings("4", "float32")

        def make(name, factor, base=pkg.base, info=info):
            base.register_custom_easy(
                name, lambda xs, f=factor: [np.asarray(xs[0]) * f], info,
                info)

        make("fleet_a", 2.0)
        make("fleet_b", 3.0)

        def bad(xs):
            raise RuntimeError("bad model B")

        pkg.base.register_custom_easy("fleet_bad", bad, info, info)
    yield
    for pkg in PKGS.values():
        for name in ("fleet_a", "fleet_b", "fleet_bad"):
            pkg.base.unregister_custom_easy(name)
        pkg.faults.clear()


def _first_vals(p):
    return [float(np.asarray(b.tensors[0]).reshape(-1)[0])
            for b in p["out"].collected]


def _play(pkg, extra="rollout-canary-frames=3"):
    p = pkg.parse(
        f"appsrc name=src caps={CAPS4} "
        f"! tensor_filter framework=custom-easy model=fleet_a name=f "
        f"{extra} ! tensor_sink name=out")
    tracer = pkg.trace.attach(p)
    p.play()
    # land one frame on model A first: push_buffer is async, so a flip
    # sent immediately would beat the queued frame to the filter
    p["src"].push_buffer(np.ones(4, np.float32))
    _wait(lambda: len(p["out"].collected) >= 1, what="first frame")
    return p, tracer


def _shape(rep):
    """A rollout report with its timings dropped: what both packages must
    give alike."""
    out = {}
    for el, s in rep.items():
        out[el] = {k: v for k, v in s.items() if k != "events"}
        out[el]["events"] = [
            {k: v for k, v in e.items()
             if k not in ("flip_ms", "rollback_ms", "reason")}
            for e in s["events"]]
        out[el]["reasons"] = [e.get("reason") for e in s["events"]]
    return out


def _both(fn):
    """Run ``fn(pkg)`` through both packages; the results must agree."""
    got = {name: fn(pkg) for name, pkg in PKGS.items()}
    assert got["port"] == got["jax"], got
    return got["port"]


class TestRolloutCanary:
    def test_clean_canary_promotes(self, fleet_models):
        def run(pkg):
            p, tracer = _play(pkg)
            p["f"].sink_pad.receive_event(
                pkg.Event("rollout-model", {"model": "fleet_b"}))
            for _ in range(4):
                p["src"].push_buffer(np.ones(4, np.float32))
            p["src"].end_of_stream()
            assert p.bus.wait_eos(15)
            assert p.bus.error is None, p.bus.error
            p.stop()
            rep = tracer.rollout_report()
            assert "rollout" in tracer.report()
            return _shape(rep), _first_vals(p)

        rep, vals = _both(run)
        f = rep["f"]
        assert f["started"] == 1 and f["promoted"] == 1
        assert f["rolled_back"] == 0
        promoted = [e for e in f["events"] if e["decision"] == "promoted"][0]
        assert promoted["frames_used"] == 3
        assert vals[0] == 2.0 and vals[-1] == 3.0  # A before, B after

    def test_invoke_raise_rolls_back_to_a(self, fleet_models):
        def run(pkg):
            p, tracer = _play(pkg, "rollout-canary-frames=5")
            p["f"].sink_pad.receive_event(
                pkg.Event("rollout-model", {"model": "fleet_bad"}))
            for _ in range(3):
                p["src"].push_buffer(np.ones(4, np.float32))
            p["src"].end_of_stream()
            assert p.bus.wait_eos(15)
            assert p.bus.error is None, p.bus.error  # absorbed, not fatal
            p.stop()
            rep = tracer.rollout_report()["f"]
            rb = [e for e in rep["events"]
                  if e["decision"] == "rolled-back"][0]
            assert "invoke raised" in rb["reason"]
            return (_shape({"f": rep})["f"]["events"], _first_vals(p),
                    p.bus.fault_counts().get("f:rollout-rollback"),
                    p.bus.fault_total() >= 1)

        events, vals, faults, any_fault = _both(run)
        rb = [e for e in events if e["decision"] == "rolled-back"][0]
        assert rb["old_model"] == "fleet_a" and rb["frames_used"] <= 5
        assert vals[-1] == 2.0 and faults == 1 and any_fault

    def test_fault_ledger_advance_rolls_back(self, fleet_models):
        def run(pkg):
            p, tracer = _play(pkg, "rollout-canary-frames=8")
            p["f"].sink_pad.receive_event(
                pkg.Event("rollout-model", {"model": "fleet_b"}))
            p.bus.record_fault("downstream", action="decode-error")
            p["src"].push_buffer(np.ones(4, np.float32))
            p["src"].push_buffer(np.ones(4, np.float32))
            p["src"].end_of_stream()
            assert p.bus.wait_eos(15)
            p.stop()
            return _shape(tracer.rollout_report()), _first_vals(p)

        rep, vals = _both(run)
        assert rep["f"]["rolled_back"] == 1
        assert "fault ledger advanced" in rep["f"]["reasons"][-1]
        assert vals[-1] == 2.0  # back on A

    def test_rollback_off_records_regression_keeps_b(self, fleet_models):
        def run(pkg):
            p, tracer = _play(
                pkg, "rollout-canary-frames=8 rollout-rollback=off")
            p["f"].sink_pad.receive_event(
                pkg.Event("rollout-model", {"model": "fleet_b"}))
            p.bus.record_fault("downstream", action="decode-error")
            p["src"].push_buffer(np.ones(4, np.float32))
            p["src"].end_of_stream()
            assert p.bus.wait_eos(15)
            p.stop()
            return _shape(tracer.rollout_report()), _first_vals(p)

        rep, vals = _both(run)
        assert rep["f"]["rolled_back"] == 0
        assert [e["decision"] for e in rep["f"]["events"]] == [
            "started", "regressed"]
        assert vals[-1] == 3.0  # B kept serving

    def test_zero_canary_promotes_immediately(self, fleet_models):
        def run(pkg):
            p, tracer = _play(pkg, "rollout-canary-frames=0")
            p["f"].sink_pad.receive_event(
                pkg.Event("rollout-model", {"model": "fleet_b"}))
            p["src"].push_buffer(np.ones(4, np.float32))
            p["src"].end_of_stream()
            assert p.bus.wait_eos(15)
            p.stop()
            return _shape(tracer.rollout_report())

        rep = _both(run)
        done = [e for e in rep["f"]["events"]
                if e["decision"] == "promoted"][0]
        assert done["frames_used"] == 0
        assert rep["f"]["reasons"][-1] == "no canary window"

    def test_event_without_candidate_errors(self, fleet_models):
        def run(pkg):
            p, _ = _play(pkg)
            with pytest.raises(pkg.ElementError, match="rollout-model"):
                p["f"].sink_pad.receive_event(pkg.Event("rollout-model", {}))
            p["src"].end_of_stream()
            assert p.bus.wait_eos(15)
            p.stop()
            return True

        assert _both(run)

    def test_off_by_default_no_report_section(self, fleet_models):
        def run(pkg):
            p = pkg.parse(
                f"appsrc name=src caps={CAPS4} "
                f"! tensor_filter framework=custom-easy model=fleet_a name=f "
                f"! tensor_sink name=out")
            tracer = pkg.trace.attach(p)
            p.play()
            p["src"].push_buffer(np.ones(4, np.float32))
            p["src"].end_of_stream()
            assert p.bus.wait_eos(15)
            p.stop()
            return p["f"]._rollout, "rollout" in tracer.report()

        assert _both(run) == (None, False)


# --- NNST981 --------------------------------------------------------------

@pytest.mark.parametrize("props,code", [
    ("rollout-model=fleet_b rollout-canary-frames=0", "NNST981"),
    ("rollout-model=fleet_b rollout-canary-frames=0 rollout-rollback=off",
     None),
    ("rollout-model=fleet_b", None),
    ("rollout-model=fleet_b rollout-canary-frames=4 rollout-rollback=auto",
     None),
])
def test_nnst981_matches_reference(props, code):
    line = (f"appsrc caps={CAPS4} ! tensor_filter framework=jax model=add "
            f"custom=k:1,aot:0 {props} ! tensor_sink")
    got = sorted(d.code for d in port_analysis.analyze_launch(line))
    want = sorted(d.code for d in jax_analysis.analyze_launch(line))
    assert got == want
    assert ("NNST981" in got) == (code is not None)


# --- rollout over the compile cache ---------------------------------------

CUSTOM = "fused:pallas,size:32,width:0.35,classes:10,postproc:argmax"
CAPS_IMG = ("other/tensors,num-tensors=1,dimensions=3:32:32:2,types=uint8,"
            "framerate=0/1")


@pytest.fixture
def checkpoints(tmp_path, monkeypatch):
    """Checkpoints A (seed 0) and B (seed 1) of a narrow MobileNet-v2, and
    a private compile cache."""
    import torch

    from nnstreamer_tpu_torch.models import build_bundle, save_state
    from nnstreamer_tpu_torch.filters.aot import custom_dict

    monkeypatch.setenv("NNSTPU_AOT_CACHE", str(tmp_path / "aot"))
    paths = {}
    for tag, seed in (("a", 0), ("b", 1)):
        b = build_bundle("mobilenet_v2", custom_dict(f"seed:{seed},{CUSTOM}"),
                         torch.device("cpu"))
        paths[tag] = str(tmp_path / f"{tag}.npz")
        save_state(b.module.state_dict(), paths[tag])
    return paths


def _frames(n):
    return [np.random.default_rng(i).integers(0, 256, (2, 32, 32, 3),
                                              dtype=np.uint8)
            for i in range(n)]


def _img_line(model, extra=""):
    return (f"appsrc name=src caps={CAPS_IMG} ! tensor_filter name=f "
            f"framework=jax model={model} "
            f"custom=arch:mobilenet_v2,{CUSTOM},aot:1 accelerator=true:cpu "
            f"{extra} ! tensor_sink name=out")


def _labels(model, frames):
    p = port_pipeline.parse_launch(_img_line(model))
    p.play()
    for x in frames:
        p["src"].push_buffer(port_buffer.Buffer(tensors=[x]))
    p["src"].end_of_stream()
    assert p.bus.wait_eos(60)
    out = [np.asarray(b[0]) for b in p["out"].collected]
    p.stop()
    return out


def _rollout(paths, frames_after, canary):
    p = port_pipeline.parse_launch(_img_line(
        paths["a"], f"rollout-canary-frames={canary}"))
    tracer = port_trace.attach(p)
    p.play()
    p["src"].push_buffer(port_buffer.Buffer(tensors=[frames_after[0]]))
    _wait(lambda: len(p["out"].collected) >= 1, timeout=60,
          what="first frame")
    p["f"].sink_pad.receive_event(
        port_buffer.Event("rollout-model", {"model": paths["b"]}))
    for x in frames_after:
        p["src"].push_buffer(port_buffer.Buffer(tensors=[x]))
    p["src"].end_of_stream()
    assert p.bus.wait_eos(60)
    assert p.bus.error is None, p.bus.error
    out = [np.asarray(b[0]) for b in p["out"].collected]
    rep = tracer.report()
    p.stop()
    return out, rep


def test_checkpoint_rollout_promotes_b_through_the_cache(checkpoints):
    frames = _frames(3)
    out, rep = _rollout(checkpoints, frames, canary=2)
    ro = rep["rollout"]["f"]
    assert (ro["started"], ro["promoted"], ro["rolled_back"]) == (1, 1, 0)
    # after promotion the labels are B's, as a line opened on B gives them
    want_b = _labels(checkpoints["b"], frames)
    for got, want in zip(out[1:], want_b):
        np.testing.assert_array_equal(got, want)
    outcomes = [e["outcome"] for e in rep["aot"]["f"]["events"]]
    # A built on its first frame, B prefetched before the flip, B's first
    # invoke a load
    assert outcomes == ["miss-compiled", "prefetch-compiled", "hit"]


def test_faulted_b_rolls_back_to_a_with_a_warm_hit(checkpoints):
    frames = _frames(3)
    port_faults.install("invoke-raise", times=1, after=1, match="f")
    try:
        out, rep = _rollout(checkpoints, frames, canary=8)
    finally:
        port_faults.clear()
    ro = rep["rollout"]["f"]
    assert ro["rolled_back"] == 1 and ro["promoted"] == 0
    rb = [e for e in ro["events"] if e["decision"] == "rolled-back"][0]
    assert "invoke raised" in rb["reason"] and rb["rollback_ms"] >= 0
    # the rollback reopened A from the cache
    assert rep["aot"]["f"]["events"][-1]["outcome"] == "hit"
    want_a = _labels(checkpoints["a"], frames)
    np.testing.assert_array_equal(out[-1], want_a[-1])
