"""The steady loop (``tensor_filter loop-window=N launch-depth=K``) through
both packages, on the CPU.

Every case of the reference's tests/test_steady_loop.py that passes there
runs through ``nnstreamer_tpu`` and ``nnstreamer_tpu_torch`` (the port's
filter with ``accelerator=true:cpu``, where the window program is the
composition in a Python loop over the window): the same launch line and
frames go in, each package must meet the reference's own asserts, and
the two must agree on outputs, verdict codes, crossings, invokes and
builds. The cases the reference fails only through its cost model (the
memory plan's ring billing, the NNST462 verdict, ``auto`` resolution,
joint resolution) are held on the port alone to what those tests assert.

Left out: the tuner cases (tests/test_torch_tuner.py holds them), the
chain-fused head (its module is not ported) and the span-sampling cases (the sampling is
the per-buffer path's, held by tests/test_torch_trace.py). A CUDA-graph
window cannot be captured here: ``chip_smoke.py``'s ``loop`` phase holds
it on the card.
"""

import os
import sys
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

import nnstreamer_tpu.analysis.loop  # noqa: E402
import nnstreamer_tpu.analysis.residency  # noqa: E402
import nnstreamer_tpu.buffer  # noqa: E402
import nnstreamer_tpu.pipeline  # noqa: E402
import nnstreamer_tpu.pipeline.element  # noqa: E402
import nnstreamer_tpu.trace  # noqa: E402
import nnstreamer_tpu_torch.analysis.loop  # noqa: E402
import nnstreamer_tpu_torch.analysis.residency  # noqa: E402
import nnstreamer_tpu_torch.buffer  # noqa: E402
import nnstreamer_tpu_torch.pipeline  # noqa: E402
import nnstreamer_tpu_torch.pipeline.element  # noqa: E402
import nnstreamer_tpu_torch.trace  # noqa: E402
from nnstreamer_tpu_torch.analysis.costmodel import predict_compiles  # noqa: E402
from nnstreamer_tpu_torch.analysis.loop import (  # noqa: E402
    AUTO_LOOP_CANDIDATES,
    analyze_loop,
    resolve_loops,
)
from nnstreamer_tpu_torch.analysis.memplan import fix_hint, plan_memory  # noqa: E402
from nnstreamer_tpu_torch.ops.steady_loop import (  # noqa: E402
    build_window_fn,
    stack_window,
    validate_window,
)
from test_torch_pipeline import weights  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CAPS_F32 = ("other/tensors,num-tensors=1,dimensions=4:2,types=float32,"
            "framerate=0/1")
X = np.arange(8, dtype=np.float32).reshape(2, 4)
PKGS = ("nnstreamer_tpu", "nnstreamer_tpu_torch")


class Pkg:
    """One package's modules under one set of names."""

    def __init__(self, name):
        mod = sys.modules
        self.port = name == "nnstreamer_tpu_torch"
        self.parse_launch = mod[f"{name}.pipeline"].parse_launch
        self.trace = mod[f"{name}.trace"]
        self.Buffer = mod[f"{name}.buffer"].Buffer
        self.Event = mod[f"{name}.pipeline.element"].Event
        self.loop = mod[f"{name}.analysis.loop"]
        self.residency = mod[f"{name}.analysis.residency"]
        #: the filter property that runs the package's backend on the CPU
        self.cpu = "accelerator=true:cpu " if self.port else ""

    def line(self, extra="loop-window=4 ", k=1, name="f"):
        return (f"appsrc name=src caps={CAPS_F32} "
                f"! tensor_filter name={name} framework=jax model=add "
                f"custom=k:{k},aot:0 {self.cpu}{extra}"
                "! tensor_sink name=out")

    def codes(self, line):
        """The NNST46x verdict codes of a launch line."""
        return [v.code for v in self.loop.analyze_loops(
            self.parse_launch(line))]

    def play(self, line, n=8, x=X, spans=False):
        p = self.parse_launch(line)
        tracer = self.trace.attach(p, spans=spans)
        p.play()
        for i in range(n):
            p["src"].push_buffer(self.Buffer(tensors=[x + i]))
        p["src"].end_of_stream()
        assert p.bus.wait_eos(60)
        assert p.bus.error is None, p.bus.error.data
        outs = [np.asarray(t[0]) for t in p["out"].collected]
        return p, tracer, outs


@pytest.fixture(params=PKGS)
def pkg(request):
    return Pkg(request.param)


@pytest.fixture
def port():
    return Pkg("nnstreamer_tpu_torch")


def _wait(cond, t=30.0):
    deadline = time.time() + t
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


def _summary(p, tracer, outs):
    """What both packages must agree on after a run."""
    f = p["f"]
    return {"outs": [o.tolist() for o in outs],
            "crossings": tracer.crossings(),
            "invokes": f.fw.stats.total_invoke_num,
            "builds": f.fw.compile_stats()["jit_traces"],
            "loop": f._loop_state}


def _both(line_of, n=8, spans=False):
    """Run one line through both packages; returns the two summaries and
    stops both pipelines."""
    got = []
    for name in PKGS:
        k = Pkg(name)
        p, tracer, outs = k.play(line_of(k), n=n, spans=spans)
        got.append(_summary(p, tracer, outs))
        p.stop()
    return got


class TestFlagship:
    def test_one_dispatch_one_h2d_one_d2h_per_window(self, pkg):
        """8 frames at loop-window=4 are TWO windows: two invokes (one
        dispatch each), two h2d (the staged rings), two d2h (the stacked
        drains), ONE build."""
        p, tracer, outs = pkg.play(pkg.line(), n=8)
        assert len(outs) == 8
        for i, o in enumerate(outs):
            np.testing.assert_array_equal(o, X + i + 1)
        cr = tracer.crossings()
        assert cr["h2d"] == 2 and cr["d2h"] == 2, cr
        assert p["f"].fw.stats.total_invoke_num == 2
        assert p["f"].fw.compile_stats()["jit_traces"] == 1
        assert p["f"]._loop_state == {"window": 4, "depth": 1}
        p.stop()

    def test_packages_agree(self):
        ref, got = _both(lambda k: k.line(), n=8)
        assert got == ref

    def test_windowed_matches_per_buffer(self, pkg):
        _, _, windowed = pkg.play(pkg.line(), n=8)
        _, _, seq = pkg.play(pkg.line(extra=""), n=8)
        assert len(windowed) == len(seq) == 8
        for a, b in zip(windowed, seq):
            np.testing.assert_array_equal(a, b)

    def test_eos_partial_window_pad_and_mask(self, pkg):
        """6 frames at window 4 = one full window + a padded partial:
        exactly 6 rows emitted, values exact, still ONE build; the padded
        rows cross (2 windows x 4 frames x 32 B each way)."""
        p, tracer, outs = pkg.play(pkg.line(), n=6)
        assert len(outs) == 6
        for i, o in enumerate(outs):
            np.testing.assert_array_equal(o, X + i + 1)
        assert p["f"].fw.stats.total_invoke_num == 2
        assert p["f"].fw.compile_stats()["jit_traces"] == 1
        cr = tracer.crossings()
        assert cr["per_element"]["f"]["h2d_bytes"] == 2 * 4 * 32
        assert cr["per_element"]["f"]["d2h_bytes"] == 2 * 4 * 32
        p.stop()

    def test_partial_window_packages_agree(self):
        ref, got = _both(lambda k: k.line(), n=6)
        assert got == ref

    def test_builds_one_across_window_fills(self, pkg):
        p, _, outs = pkg.play(pkg.line(), n=13)
        assert len(outs) == 13
        assert p["f"].fw.stats.total_invoke_num == 4
        assert p["f"].fw.compile_stats()["jit_traces"] == 1
        p.stop()

    def test_span_dispatch_count_is_windows(self, pkg):
        """One `dispatch` span per WINDOW; the per-invoke `device-sync`
        never fires on the loop path (the drain park is `drain-sync`)."""
        p, tracer, _ = pkg.play(pkg.line(), n=8, spans=True)
        cats, names = {}, {}
        for _track, name, cat, *_ in tracer.spans.records():
            cats[cat] = cats.get(cat, 0) + 1
            names[name] = names.get(name, 0) + 1
        assert cats.get("dispatch") == 2, cats
        assert names.get("device-sync") is None, names
        assert names.get("drain-sync") == 2, names
        assert names.get("h2d") == 2 and names.get("batch-assemble") == 2
        rep = tracer.host_stack_report()
        assert rep["batches"] == 2
        assert rep["device_sync_ms_per_batch"] == 0.0
        assert rep["drain_sync_ms_per_batch"] >= 0.0
        p.stop()


class TestLaunchDepth:
    EXTRA = "loop-window=2 launch-depth=2 "

    def test_banks_one_window_then_drains_oldest(self, pkg):
        p = pkg.parse_launch(pkg.line(self.EXTRA))
        p.play()
        for i in range(2):
            p["src"].push_buffer(pkg.Buffer(tensors=[X + i]))
        assert _wait(lambda: p["f"].fw.stats.total_invoke_num == 1)
        time.sleep(0.1)
        # window 1 dispatched but BANKED un-synced: nothing emitted yet
        assert len(p["out"].collected) == 0
        assert len(p["f"]._loop_inflight) == 1
        for i in range(2, 4):
            p["src"].push_buffer(pkg.Buffer(tensors=[X + i]))
        # window 2's dispatch drains window 1
        assert _wait(lambda: len(p["out"].collected) == 2)
        assert len(p["f"]._loop_inflight) == 1
        p.stop()

    def test_drain_on_stop(self, pkg):
        p = pkg.parse_launch(pkg.line(self.EXTRA))
        p.play()
        for i in range(4):
            p["src"].push_buffer(pkg.Buffer(tensors=[X + i]))
        assert _wait(lambda: len(p["out"].collected) == 2)
        p.stop()
        assert len(p["out"].collected) == 4
        for i, t in enumerate(p["out"].collected):
            np.testing.assert_array_equal(np.asarray(t[0]), X + i + 1)
        assert not p["f"]._loop_inflight

    def test_eos_drains_banked_windows_in_order(self, pkg):
        p, _, outs = pkg.play(pkg.line(self.EXTRA), n=6)
        assert len(outs) == 6
        for i, o in enumerate(outs):
            np.testing.assert_array_equal(o, X + i + 1)
        p.stop()

    def test_packages_agree(self):
        ref, got = _both(lambda k: k.line(self.EXTRA), n=7)
        assert got == ref


#: (extra properties on the filter, the reference's verdict) of
#: tests/test_steady_loop.py's fallback cases the port can construct
FALLBACKS = {
    "sync": ("loop-window=4 sync=true ", "NNST461"),
    "invoke_dynamic": ("loop-window=4 invoke-dynamic=true ", "NNST461"),
    "shared_key": ("loop-window=4 shared-tensor-filter-key=lk1 ",
                   "NNST461"),
    "watchdog": ("loop-window=4 invoke-timeout-ms=5000 ", "NNST461"),
}


class TestVerdictsMatchRuntime:
    """Each NNST46x verdict's runtime behavior: loud per-buffer fallback —
    one invoke per frame, correct outputs, the refusal recorded on the
    element."""

    @pytest.mark.parametrize("case", sorted(FALLBACKS))
    def test_fallback(self, pkg, case):
        extra, code = FALLBACKS[case]
        line = pkg.line(extra)
        assert pkg.codes(line) == [code]
        p, _, outs = pkg.play(line, n=3)
        assert len(outs) == 3
        assert p["f"].fw.stats.total_invoke_num == 3  # per-buffer
        assert p["f"]._loop_state is None
        assert p["f"]._loop_refused is not None
        assert p["f"]._loop_refused[0] == code
        if case != "invoke_dynamic":
            for i, o in enumerate(outs):
                np.testing.assert_array_equal(o, X + i + 1)
        p.stop()

    def test_batch_size_ineligible(self, pkg):
        line = pkg.line("loop-window=4 batch-size=2 ")
        assert pkg.codes(line) == ["NNST461"]
        p, _, outs = pkg.play(line, n=4)
        assert len(outs) == 4
        for i, o in enumerate(outs):
            np.testing.assert_array_equal(np.squeeze(o, 0), X + i + 1)
        assert p["f"].fw.stats.total_invoke_num == 2
        assert p["f"]._loop_state is None
        p.stop()

    def test_refused_under_tee_fanout(self, pkg):
        """The staged window ring is refused when a tee upstream can hold
        the frames it stages: the verdict names the tee, the runtime runs
        per-buffer, the side branch still sees every frame."""
        line = (f"appsrc name=src caps={CAPS_F32} ! tee name=t "
                f" t. ! queue ! tensor_filter name=f framework=jax "
                f"model=add custom=k:1,aot:0 {pkg.cpu}loop-window=4 "
                f"! tensor_sink name=out "
                f" t. ! queue ! tensor_sink name=side")
        verdicts = pkg.loop.analyze_loops(pkg.parse_launch(line))
        assert [v.code for v in verdicts] == ["NNST461"]
        assert "'t'" in verdicts[0].message
        p, _, outs = pkg.play(line, n=4)
        assert len(outs) == 4
        assert p["f"].fw.stats.total_invoke_num == 4
        assert p["f"]._loop_state is None
        assert len(p["side"].collected) == 4
        p.stop()

    def test_over_budget_ring_nnst462(self, port, monkeypatch):
        """A ring the memory plan refuses: NNST462, runtime per-buffer (a
        tiny budget via NNSTPU_HBM_BYTES keeps the test CPU-sized). The
        reference asserts this and fails it only through its cost model;
        the port is held to it alone."""
        monkeypatch.setenv("NNSTPU_HBM_BYTES", "256")
        assert port.codes(port.line()) == ["NNST462"]
        p, _, outs = port.play(port.line(), n=4)
        assert len(outs) == 4
        for i, o in enumerate(outs):
            np.testing.assert_array_equal(o, X + i + 1)
        assert p["f"].fw.stats.total_invoke_num == 4
        assert p["f"]._loop_state is None
        assert p["f"]._loop_refused[0] == "NNST462"
        p.stop()

    def test_eligible_line_verdict_is_460(self, pkg):
        assert pkg.codes(pkg.line()) == ["NNST460"]

    def test_no_loop_window_no_verdict(self, pkg):
        assert pkg.codes(pkg.line(extra="")) == []


def _fixture_lines():
    """(lineno, line, expected code) of examples/launch_lines_loop.txt."""
    out, expect = [], None
    with open(os.path.join(ROOT, "examples", "launch_lines_loop.txt")) as f:
        for n, raw in enumerate(f, 1):
            s = raw.strip()
            if s.startswith("# EXPECT:"):
                expect = s.split(":", 1)[1].strip()
            elif s and not s.startswith("#"):
                out.append((n, s, expect))
                expect = None
    return out


@pytest.mark.parametrize("entry", _fixture_lines(), ids=lambda e: str(e[0]))
def test_launch_lines_loop_verdicts(entry):
    """Every line of the loop fixture gets its annotated code from the
    port; the NNST460/461 lines get the same code from the JAX package
    (its NNST462 line needs the cost model it cannot run)."""
    _, line, expect = entry
    port = Pkg("nnstreamer_tpu_torch")
    assert port.codes(line) == [expect]
    if expect != "NNST462":
        assert Pkg("nnstreamer_tpu").codes(line) == [expect]


class TestConfigResolution:
    def test_env_default_window(self, pkg, monkeypatch):
        monkeypatch.setenv("NNSTPU_LOOP_WINDOW", "4")
        p, _, _ = pkg.play(pkg.line(extra=""), n=8)
        assert p["f"]._loop_state == {"window": 4, "depth": 1}
        assert p["f"].fw.stats.total_invoke_num == 2
        p.stop()

    def test_auto_resolves_largest_feasible(self, port):
        p = port.parse_launch(port.line("loop-window=auto "))
        v = analyze_loop(p, p["f"])
        assert v.code == "NNST460"
        assert v.window == AUTO_LOOP_CANDIDATES[0]

    def test_auto_shrinks_under_tight_budget(self, port, monkeypatch):
        """auto = the largest feasible candidate: with a budget that only
        fits the w=4 ring (4 x (32 + 32) B, the w=8 ring is 512 B) auto
        picks 4 instead of failing."""
        monkeypatch.setenv("NNSTPU_HBM_BYTES", "420")
        p = port.parse_launch(port.line("loop-window=auto "))
        v = analyze_loop(p, p["f"])
        assert v.code == "NNST460"
        assert v.window == 4, v

    def test_auto_engages_at_runtime(self, port):
        p, _, outs = port.play(port.line("loop-window=auto "), n=20)
        assert p["f"]._loop_state == {"window": 16, "depth": 1}
        assert p["f"].fw.stats.total_invoke_num == 2
        for i, o in enumerate(outs):
            np.testing.assert_array_equal(o, X + i + 1)
        p.stop()

    def test_auto_on_unmodelable_program_is_461_not_462(self, pkg):
        """auto on a program the memory plan cannot model must NOT claim
        the budget was exceeded: NNST461 naming the real reason."""
        line = (f"appsrc caps={CAPS_F32} ! tensor_filter name=f "
                f"framework=jax model=no_such_model_xyz custom=aot:0 "
                f"loop-window=auto ! tensor_sink")
        verdicts = pkg.loop.analyze_loops(pkg.parse_launch(line))
        assert [v.code for v in verdicts] == ["NNST461"]
        assert "statically modeled" in verdicts[0].message
        assert "HBM" not in verdicts[0].message

    def test_loop_window_one_is_off(self, pkg):
        line = pkg.line("loop-window=1 ")
        assert pkg.codes(line) == []
        p, _, _ = pkg.play(line, n=2)
        assert p["f"]._loop_state is None
        assert p["f"].fw.stats.total_invoke_num == 2
        p.stop()


class TestStaticHonesty:
    @pytest.mark.parametrize("n", [8, 6])
    def test_predict_crossings_parity_with_tracer(self, pkg, n):
        """N frames cross as one windowed h2d/d2h record per window
        (counts AND bytes, padding included)."""
        p, tracer, _ = pkg.play(pkg.line(), n=n)
        pred = pkg.residency.predict_crossings(p, n_buffers=n)
        assert pkg.residency.parity_mismatches(pred, tracer.crossings()) \
            == []
        p.stop()

    def test_predict_crossings_lint_time_models_loop(self, pkg):
        pred = pkg.residency.predict_crossings(
            pkg.parse_launch(pkg.line()), n_buffers=8)
        assert pred["per_element"]["f"] == {"h2d": 2, "d2h": 2}

    def test_predict_crossings_ineligible_stays_per_buffer(self, pkg):
        pred = pkg.residency.predict_crossings(
            pkg.parse_launch(pkg.line("loop-window=4 sync=true ")),
            n_buffers=4)
        assert pred["per_element"]["f"]["d2h"] == 4

    def test_predict_compiles_pins_one(self, port):
        assert predict_compiles(port.parse_launch(port.line())) == {"f": 1}

    def test_memplan_bills_loop_ring(self, port):
        plan = plan_memory(port.parse_launch(port.line()))
        row = next(r for r in plan["rows"] if r["element"] == "f")
        assert row["loop_window"] == 4 and row["launch_depth"] == 1
        # one in-flight window: 4 frames x 32 B staged ring + 4 x 32 B
        # stacked outputs; the loop owns both amortizers
        assert row["loop_bytes"] == 4 * (32 + 32)
        assert row["window_bytes"] == 0

    def test_memplan_launch_depth_scales_inflight_windows(self, port):
        plan = plan_memory(port.parse_launch(
            port.line("loop-window=4 launch-depth=2 ")))
        row = next(r for r in plan["rows"] if r["element"] == "f")
        assert row["loop_bytes"] == 2 * 4 * (32 + 32)

    def test_fix_hint_names_loop_window(self, port):
        p = port.parse_launch(port.line("loop-window=16 "))
        plan = plan_memory(p, loop_override={"f": (1 << 22, 2)})
        assert "loop-window" in fix_hint(plan)

    def test_joint_resolution_two_loops_share_one_budget(self, port,
                                                         monkeypatch):
        """Two individually feasible rings that jointly bust the budget
        resolve first-in-graph-order: f1 engages, f2 is NNST462."""
        line = (f"appsrc name=s1 caps={CAPS_F32} ! tensor_filter name=f1 "
                f"framework=jax model=add custom=k:1,aot:0 {port.cpu}"
                f"loop-window=4 ! tensor_sink name=o1 "
                f"appsrc name=s2 caps={CAPS_F32} ! tensor_filter name=f2 "
                f"framework=jax model=add custom=k:2,aot:0 {port.cpu}"
                f"loop-window=4 ! tensor_sink name=o2")
        p = port.parse_launch(line)
        base = plan_memory(p, loop_override={"f1": (1, 1),
                                             "f2": (1, 1)})["total_bytes"]
        monkeypatch.setenv("NNSTPU_HBM_BYTES", str(base + 384))
        resolved = resolve_loops(p)
        assert resolved["f1"] == (4, 1)
        assert resolved["f2"] == (1, 1)
        assert analyze_loop(p, p["f1"]).code == "NNST460"
        assert analyze_loop(p, p["f2"]).code == "NNST462"
        plan = plan_memory(p)
        rows = {r["element"]: r for r in plan["rows"]}
        assert rows["f1"]["loop_bytes"] == 256
        assert rows["f2"]["loop_bytes"] == 0
        assert plan["total_bytes"] <= plan["budget_bytes"]

    def test_memplan_bills_the_graph_pool_on_the_card(self, port):
        """A filter that runs on the card (no ``accelerator=true:cpu``)
        runs its window as a CUDA graph, whose private pool is billed at
        what one capture keeps alive, in the allocator's 512-byte blocks:
        the capture's state (two 8-byte tensors), one composition's
        activation peak (the pool reuses a row's blocks for the next)
        beside the earlier rows' outputs; on the CPU the window is a loop
        over the composition and bills no pool."""
        card = port.line().replace(port.cpu, "")
        rows = [next(r for r in plan_memory(port.parse_launch(line))["rows"]
                     if r["element"] == "f") for line in (card, port.line())]
        on_card, on_cpu = rows
        assert on_card["loop_bytes"] == on_cpu["loop_bytes"] == 4 * (32 + 32)
        # the add's 32-byte output and its 0-d k, a 512-byte block each
        assert on_card["activation_bytes"] == 2 * 512
        assert on_cpu["activation_bytes"] == 32 + 4
        # the window's end: four rows' outputs beside their 128-byte stack
        assert on_card["graph_bytes"] == 2 * 512 + 4 * 512 + 512
        assert on_card["graph_bytes"] > 0 and on_cpu["graph_bytes"] == 0
        assert on_card["cublas_bytes"] == 0  # no product
        assert on_card["total_bytes"] == (
            on_cpu["total_bytes"] - on_cpu["activation_bytes"]
            + on_card["activation_bytes"] + on_card["graph_bytes"])

    def test_graph_pool_bill_is_one_peak_plus_the_outputs(self, port):
        """The graph pool's bill on a small window: one composition's
        activation peak, not one per row — a window four times as long
        adds only its rows' outputs (or, where the outputs outweigh the
        peak, the window's end: every row's output beside their stack)."""
        from nnstreamer_tpu_torch.analysis.memplan import graph_pool_bytes

        assert graph_pool_bytes(100_000, [8], 4) == 1024 + 100_000 + 3 * 512
        assert graph_pool_bytes(100_000, [8], 16) == 1024 + 100_000 + 15 * 512
        assert graph_pool_bytes(1000, [8], 16) == 1024 + 16 * 512 + 512
        assert graph_pool_bytes(1000, [8, 600], 4) == 1024 + max(
            1000 + 3 * (512 + 1024), 4 * (512 + 1024) + 512 + 2560)
        card = port.line().replace(port.cpu, "")
        rows = {w: next(r for r in plan_memory(port.parse_launch(
            card.replace("loop-window=4", f"loop-window={w}")))["rows"]
            if r["element"] == "f") for w in (4, 16)}
        a = rows[4]["activation_bytes"]
        assert a > 0 and rows[16]["activation_bytes"] == a
        assert rows[4]["graph_bytes"] == 1024 + 4 * 512 + 512
        assert rows[16]["graph_bytes"] == 1024 + 16 * 512 + 512

    def test_memplan_bills_folded_weights_once(self, port):
        """MobileNet-v2's folded forward keeps BN-folded, cast copies of
        its weights beside the module's state: billed once per backend,
        as params are."""
        line = ("appsrc caps=video/x-raw,format=RGB,width=64,height=64,"
                "framerate=30/1 ! tensor_converter ! tee name=t "
                "t. ! queue ! tensor_filter name=fa framework=jax "
                f"model=mobilenet_v2 custom=seed:0,{MBV2} {port.cpu}"
                "shared-tensor-filter-key=K ! tensor_sink "
                "t. ! queue ! tensor_filter name=fb framework=jax "
                f"model=mobilenet_v2 custom=seed:0,{MBV2} {port.cpu}"
                "shared-tensor-filter-key=K ! tensor_sink")
        plan = plan_memory(port.parse_launch(line))
        derived = plan["rows"][0]["derived_bytes"]
        # the folded blocks in bf16 and the classifier's float32 copy:
        # about half the float32 state of this narrow model
        assert 0.3 * plan["param_bytes_total"] < derived \
            < plan["param_bytes_total"]
        assert plan["derived_bytes_total"] == derived
        assert plan["total_bytes"] >= (plan["param_bytes_total"] + derived
                                       + plan["rows"][0]["total_bytes"])

    def test_ineligible_filter_bills_no_ring(self, port):
        plan = plan_memory(port.parse_launch(
            port.line("loop-window=4 sync=true ")))
        row = next(r for r in plan["rows"] if r["element"] == "f")
        assert row["loop_bytes"] == 0 and row["loop_window"] == 1

    def test_analyze_loops_verdicts_agree(self):
        """Both packages give the same verdicts (codes, windows, depths)
        on the eligible and every cheap-gate line."""
        for extra in ("loop-window=8 launch-depth=2 ",) + tuple(
                e for e, _ in FALLBACKS.values()):
            ref, got = (
                [(v.code, v.window, v.depth) for v in Pkg(n).loop
                 .analyze_loops(Pkg(n).parse_launch(Pkg(n).line(extra)))]
                for n in PKGS)
            assert got == ref, extra


class TestLifecycle:
    def test_reload_model_mid_stream_keeps_loop(self, pkg):
        """A reload-model event flushes the collected window against the
        OLD program, then the loop rebuilds on the reloaded backend."""
        p = pkg.parse_launch(pkg.line())
        p.play()
        for i in range(5):  # 1 full window + 1 collected row
            p["src"].push_buffer(pkg.Buffer(tensors=[X + i]))
        assert _wait(lambda: len(p["out"].collected) == 4)
        assert _wait(lambda: len(p["f"]._loop_rows) == 1)
        p["f"].sink_pads[0].receive_event(
            pkg.Event("reload-model", {"model": "add"}))
        assert _wait(lambda: len(p["out"].collected) == 5)
        assert p["f"]._loop_state == {"window": 4, "depth": 1}
        for i in range(5, 9):
            p["src"].push_buffer(pkg.Buffer(tensors=[X + i]))
        p["src"].end_of_stream()
        assert p.bus.wait_eos(60) and p.bus.error is None
        outs = [np.asarray(t[0]) for t in p["out"].collected]
        assert len(outs) == 9
        for i, o in enumerate(outs):
            np.testing.assert_array_equal(o, X + i + 1)
        p.stop()

    def test_cold_restart_replans_loop(self, pkg):
        p, _, _ = pkg.play(pkg.line(), n=4)
        p.stop()
        p.play()
        for i in range(4):
            p["src"].push_buffer(pkg.Buffer(tensors=[X + i]))
        p["src"].end_of_stream()
        assert p.bus.wait_eos(60) and p.bus.error is None
        assert p["f"]._loop_state == {"window": 4, "depth": 1}
        assert len(p["out"].collected) == 8
        p.stop()

    def test_fetch_timeout_flushes_partial_window(self, pkg):
        p = pkg.parse_launch(pkg.line("loop-window=4 fetch-timeout-ms=120 "))
        p.play()
        for i in range(2):
            p["src"].push_buffer(pkg.Buffer(tensors=[X + i]))
        assert _wait(lambda: len(p["out"].collected) == 2, t=10.0)
        for i, t in enumerate(p["out"].collected):
            np.testing.assert_array_equal(np.asarray(t[0]), X + i + 1)
        p.stop()


class TestErrorPolicy:
    def test_staging_failure_drop_loses_only_the_trigger(self, pkg):
        """A loop_stage failure under on-error=drop restores window-1 rows
        (the trigger frame is the drop)."""
        p = pkg.parse_launch(pkg.line("loop-window=4 on-error=drop "))
        p.play()
        orig = p["f"].fw.loop_stage
        fails = {"n": 0}

        def flaky(stacked):
            if fails["n"] == 0:
                fails["n"] += 1
                raise RuntimeError("transient staging failure")
            return orig(stacked)

        p["f"].fw.loop_stage = flaky
        for i in range(5):
            p["src"].push_buffer(pkg.Buffer(tensors=[X + i]))
        p["src"].end_of_stream()
        assert p.bus.wait_eos(60)
        outs = [np.asarray(t[0]) for t in p["out"].collected]
        assert len(outs) == 4, len(outs)
        for o, w in zip(outs, [X + 1, X + 2, X + 3, X + 5]):
            np.testing.assert_array_equal(o, w)
        assert p["f"].fw.compile_stats()["jit_traces"] == 1
        p.stop()

    def test_invoke_failure_retry_replays_the_window(self, pkg):
        p = pkg.parse_launch(pkg.line("loop-window=4 on-error=retry:2 "))
        p.play()
        orig = p["f"].fw.loop_invoke
        fails = {"n": 0}

        def flaky(staged):
            if fails["n"] == 0:
                fails["n"] += 1
                raise RuntimeError("transient invoke failure")
            return orig(staged)

        p["f"].fw.loop_invoke = flaky
        for i in range(4):
            p["src"].push_buffer(pkg.Buffer(tensors=[X + i]))
        p["src"].end_of_stream()
        assert p.bus.wait_eos(60)
        outs = [np.asarray(t[0]) for t in p["out"].collected]
        assert len(outs) == 4
        for i, o in enumerate(outs):
            np.testing.assert_array_equal(o, X + i + 1)
        p.stop()


    def test_refused_capture_falls_back_per_buffer(self, port):
        """A window the backend cannot build at its first use (on the
        card: a refused CUDA-graph capture) is the reference's decline:
        a loud per-buffer fallback, ``_loop_refused`` set, every frame
        emitted in order."""
        from nnstreamer_tpu_torch.ops.steady_loop import LoopDeclined

        p = port.parse_launch(port.line())
        p.play()

        def refuse(row, window):
            raise LoopDeclined("window capture failed: refused")

        p["f"].fw.loop_slot = refuse
        for i in range(7):
            p["src"].push_buffer(port.Buffer(tensors=[X + i]))
        p["src"].end_of_stream()
        assert p.bus.wait_eos(60) and p.bus.error is None
        outs = [np.asarray(t[0]) for t in p["out"].collected]
        assert len(outs) == 7
        for i, o in enumerate(outs):
            np.testing.assert_array_equal(o, X + i + 1)
        assert p["f"].fw.stats.total_invoke_num == 7
        assert p["f"]._loop_state is None
        assert p["f"]._loop_refused[0] == "NNST460"
        assert "capture" in p["f"]._loop_refused[1]
        p.stop()


class TestWindowProgram:
    def test_stack_window_pads_with_last_row(self):
        rows = [[X + i] for i in range(3)]
        stacked, n_valid = stack_window(rows, 4)
        assert n_valid == 3 and stacked[0].shape == (4, 2, 4)
        np.testing.assert_array_equal(stacked[0][3], X + 2)
        with pytest.raises(ValueError, match="scalar"):
            stack_window([[np.float32(1.0)]], 2)

    def test_window_fn_runs_the_composition_per_row(self):
        calls = []

        def solo(xs):
            calls.append(tuple(xs[0].shape))
            return [xs[0] * 2, xs[0].sum().reshape(1)]

        xs = [torch.arange(12, dtype=torch.float32).reshape(3, 2, 2)]
        a, b = build_window_fn(solo)(xs)
        assert calls == [(2, 2)] * 3
        torch.testing.assert_close(a, xs[0] * 2)
        assert b.shape == (3, 1)

    def test_recording_counts_only_its_own_thread(self):
        """A capture records its own thread's launches into the graph's
        count; a launch another thread makes meanwhile stays in the
        global count, and nothing recorded reaches it."""
        from nnstreamer_tpu_torch.ops import _cuda

        saved = dict(_cuda.LAUNCHES)
        _cuda.reset_launches()
        recording, counted = threading.Event(), threading.Event()

        def other():
            recording.wait(10)
            _cuda.count_launch("normalize_u8")
            counted.set()

        t = threading.Thread(target=other)
        t.start()
        try:
            with _cuda.recording_launches() as rec:
                _cuda.count_launch("fused_inverted_residual")
                recording.set()
                assert counted.wait(10)
                _cuda.count_launch("fused_inverted_residual")
            _cuda.count_launch("arith_chain")
            t.join(10)
            assert rec == dict.fromkeys(_cuda.LAUNCHES, 0) | {
                "fused_inverted_residual": 2}
            assert _cuda.LAUNCHES == dict.fromkeys(_cuda.LAUNCHES, 0) | {
                "normalize_u8": 1, "arith_chain": 1}
        finally:
            _cuda.LAUNCHES.update(saved)

    def test_validate_window_reports_a_composition_that_fails(self):
        from nnstreamer_tpu_torch.types import TensorsInfo

        info = TensorsInfo.from_strings("4:2", "float32")
        assert validate_window(lambda xs: [xs[0] + 1], 4, info) is None
        bad = validate_window(lambda xs: [xs[0] @ xs[0]], 4, info)
        assert bad is not None
        assert validate_window(None, 4, info) is None


MBV2 = "size:64,width:0.35,classes:16,fused:pallas"


def _mbv2_line(custom, cpu, extra):
    return ("appsrc name=src caps=video/x-raw,format=RGB,width=64,height=64,"
            "framerate=30/1 ! tensor_converter frames-per-tensor=1 "
            f"! tensor_filter name=f framework=jax model=mobilenet_v2 "
            f"custom={custom} {cpu}{extra}! tensor_sink name=out")


def _mbv2_run(pkg, custom, frames, extra):
    p = pkg.parse_launch(_mbv2_line(custom, pkg.cpu, extra))
    p.play()
    for f in frames:
        p["src"].push_buffer(pkg.Buffer(tensors=[f]))
    p["src"].end_of_stream()
    assert p.bus.wait_eos(300)
    assert p.bus.error is None, p.bus.error
    out = [np.asarray(b.tensors[0]) for b in p["out"].collected]
    state = (p["f"]._loop_state, p["f"].fw.stats.total_invoke_num)
    p.stop()
    return out, state


def test_mobilenet_v2_window_through_both_packages(weights):
    """MobileNet-v2 (64 px, width 0.35, 16 classes) on 6 frames at
    loop-window=4, on the perturbed weights of tests/test_torch_pipeline.py
    (msgpack for the JAX package, npz for the port), whose logits have
    scale and whose labels have margins: the port's windowed logits equal
    its per-buffer logits exactly (the same per-frame composition, the
    padded tail masked), every frame's label equals the JAX package's
    window, and the logits lie within a tenth of their own scale of the
    JAX window's (the bf16 fused blocks of the two packages differ by up
    to 5.9 on logits up to 106, as test_torch_residency's preamble line
    finds)."""
    msgpack, npz, _, _, frames = weights
    frames = frames[:6]
    port, ref = Pkg("nnstreamer_tpu_torch"), Pkg("nnstreamer_tpu")
    win, state = _mbv2_run(port, f"params:{npz},{MBV2}", frames,
                           "loop-window=4 ")
    seq, _ = _mbv2_run(port, f"params:{npz},{MBV2}", frames, "")
    want, ref_state = _mbv2_run(ref, f"params:{msgpack},{MBV2},aot:0",
                                frames, "loop-window=4 ")
    assert state == ({"window": 4, "depth": 1}, 2)
    assert ref_state == state
    assert len(win) == len(seq) == len(want) == 6
    for w, s, j in zip(win, seq, want):
        assert w.shape == s.shape == j.shape == (1, 16)
        np.testing.assert_array_equal(w, s)
    win, want = np.concatenate(win), np.concatenate(want)
    labels = want.argmax(-1)
    np.testing.assert_array_equal(win.argmax(-1), labels)
    assert len(set(labels.tolist())) > 1  # the labels have teeth
    scale = float(np.abs(want).max())
    assert scale > 10.0
    np.testing.assert_allclose(win, want, rtol=0, atol=0.1 * scale)
