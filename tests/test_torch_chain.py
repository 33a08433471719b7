"""Whole-chain filter→filter fusion through both packages, on the CPU.

Every case of the reference's tests/test_chain.py runs through the port
(``nnstreamer_tpu_torch``, its filters with ``accelerator=true:cpu``):

- the 15 cases the reference passes run through BOTH packages — the
  NNST451/453 verdicts with the blocker's name, the fallbacks,
  ``chain-fusion=off``, the ``NNSTPU_CHAIN_FUSION`` override and the
  ``fusion=off`` gate — with the reference's own asserts on each, and the
  two packages' outputs equal;
- the 14 cases the reference fails under this jax (its composition check
  raises, so it never fuses: every chain is NNST451 "cannot be
  abstract-evaluated") hold the port to the case's own asserts, and the
  port's fused output equal to the JAX package's per-filter output;
- the tracer on the chain fixture: with ``chain-fusion=off`` on both
  packages the same fusions and crossings per element; fused, on the port
  alone, the shells bill nothing and read ``fused-into:<head>``.

The two ``TestChainFusedCrossingParity`` cases of the reference's
tests/test_residency.py (which fail there for the same reason) hold the
port's crossing predictor to its tracer on fused lines.

Then a small form of the flagship cascade (MobileNet-v2 width 0.35 at
96 px, batch 4, the kernels' plain versions): the NNST450 verdict, the
composed run against ``chain-fusion=off`` (labels, logits and crossings),
a MobileNet-v2 → ``scaler`` chain against the JAX package's two filters
on weights carried across by ``models/convert.py`` (the zoo's ``matmul``
draws its W differently in the two packages), the ``add``/``scaler``
chains bit for bit against the reference, and the looped chain head.

Tolerances: the ``add``/``scaler`` chains are exact (float32 adds and
multiplies in the same order); the MobileNet-v2 logits are held at the
JAX package's bf16 tolerance (atol 0.15, rtol 0.05,
tests/test_torch_pipeline.py), fused against off bit for bit (the same
operations in the same order on the CPU).
"""

import os
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_shared import jit_init  # noqa: E402
from test_torch_shared import (  # noqa: E402,F401 (fixtures)
    equal_name_counters,
    one_torch_thread,
)
jax = pytest.importorskip("jax")

import nnstreamer_tpu.analysis  # noqa: E402
import nnstreamer_tpu.analysis.costmodel  # noqa: E402
import nnstreamer_tpu.buffer  # noqa: E402
import nnstreamer_tpu.filters.jax_filter  # noqa: E402
import nnstreamer_tpu.pipeline  # noqa: E402
import nnstreamer_tpu.pipeline.element  # noqa: E402
import nnstreamer_tpu.trace  # noqa: E402
import nnstreamer_tpu_torch.analysis  # noqa: E402
import nnstreamer_tpu_torch.analysis.costmodel  # noqa: E402
import nnstreamer_tpu_torch.buffer  # noqa: E402
import nnstreamer_tpu_torch.filters.cuda_filter  # noqa: E402
import nnstreamer_tpu_torch.pipeline  # noqa: E402
import nnstreamer_tpu_torch.pipeline.element  # noqa: E402
import nnstreamer_tpu_torch.trace  # noqa: E402

CAPS_F32 = ("other/tensors,num-tensors=1,dimensions=4:2,types=float32,"
            "framerate=0/1")


class Pkg:
    """One package's modules under one set of names."""

    def __init__(self, name):
        mod = sys.modules
        self.name = name
        self.port = name == "nnstreamer_tpu_torch"
        self.parse_launch = mod[f"{name}.pipeline"].parse_launch
        self.trace = mod[f"{name}.trace"]
        self.Buffer = mod[f"{name}.buffer"].Buffer
        self.Event = mod[f"{name}.pipeline.element"].Event
        self.analyze_launch = mod[f"{name}.analysis"].analyze_launch
        self.costmodel = mod[f"{name}.analysis.costmodel"]
        self.backend = (mod[f"{name}.filters.cuda_filter"].TorchCudaFilter
                        if self.port else
                        mod[f"{name}.filters.jax_filter"].JaxFilter)
        #: the filter properties that run the package's backend on the CPU
        self.cpu = "accelerator=true:cpu" if self.port else ""

    def filt(self, name, k, extra=""):
        return (f"tensor_filter name={name} framework=jax model=add "
                f"custom=k:{k},aot:0 {self.cpu} {extra}").rstrip()

    def chain_line(self, f1_extra="", f2_extra="", link="! queue !"):
        return (f"appsrc name=src caps={CAPS_F32} "
                f"! {self.filt('f1', 1, f1_extra)} {link} "
                f"{self.filt('f2', 10, f2_extra)} ! tensor_sink name=out")


JAX = Pkg("nnstreamer_tpu")
PORT = Pkg("nnstreamer_tpu_torch")
BOTH = pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])


def chain_codes(pkg, line):
    return [d for d in pkg.analyze_launch(line) if d.code.startswith("NNST45")]


def play(pkg, line, n=1, chain_fusion=None, x=None):
    p = pkg.parse_launch(line)
    if chain_fusion is not None:
        p.chain_fusion = chain_fusion
    tracer = pkg.trace.attach(p)
    p.play()
    if x is None:
        x = np.arange(8, dtype=np.float32).reshape(2, 4)
    for i in range(n):
        p["src"].push_buffer(pkg.Buffer(tensors=[x + i]))
    p["src"].end_of_stream()
    assert p.bus.wait_eos(30)
    assert p.bus.error is None, p.bus.error.data
    outs = [np.asarray(t[0]) for t in p["out"].collected]
    return p, tracer, outs, x


def reference_outputs(line_of, n=1, **kw):
    """The JAX package's outputs for the same line, run per-filter."""
    p, _, outs, _ = play(JAX, line_of(JAX), n=n, chain_fusion="off", **kw)
    p.stop()
    return outs


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def no_crossings(per, name):
    return name not in per or per[name] == {
        "h2d": 0, "d2h": 0, "h2d_bytes": 0, "d2h_bytes": 0}


# --- the reference's TestFlagship ------------------------------------------

class TestFlagship:
    def test_one_h2d_one_launch_one_d2h(self):
        """The two-filter chain is one program on the port: one upload at
        the head, one build, no tail invoke, one fetch at the boundary."""
        p, tracer, outs, x = play(PORT, PORT.chain_line())
        np.testing.assert_array_equal(outs[0], x + 11)
        cr = tracer.crossings()
        assert cr["h2d"] == 1 and cr["d2h"] == 1, cr
        assert p["f1"].fw._jit_trace_count == 1
        assert p["f1"].fw.stats.total_invoke_num == 1
        assert p["f2"].fw.stats.total_invoke_num == 0
        assert tracer.fusions().get("f2") == "fused-into:f1"
        assert no_crossings(cr["per_element"], "f2"), cr["per_element"]
        p.stop()
        assert_same(outs, reference_outputs(Pkg.chain_line))

    @BOTH
    def test_composed_matches_sequential(self, pkg):
        _, _, fused, _ = play(pkg, pkg.chain_line(), n=3)
        _, _, seq, _ = play(pkg, pkg.chain_line(), n=3, chain_fusion="off")
        assert len(fused) == len(seq) == 3
        for a, b in zip(fused, seq):
            np.testing.assert_allclose(a, b, rtol=1e-6)
        if pkg.port:
            assert_same(fused, reference_outputs(Pkg.chain_line, n=3))

    @BOTH
    def test_chain_fusion_off_is_per_filter(self, pkg):
        p, tracer, outs, x = play(pkg, pkg.chain_line(), chain_fusion="off")
        np.testing.assert_array_equal(outs[0], x + 11)
        assert p["f1"].fw.stats.total_invoke_num == 1
        assert p["f2"].fw.stats.total_invoke_num == 1
        assert "f2" not in tracer.fusions()
        p.stop()

    @BOTH
    def test_env_override_disables(self, pkg, monkeypatch):
        monkeypatch.setenv("NNSTPU_CHAIN_FUSION", "off")
        p, tracer, _, _ = play(pkg, pkg.chain_line())
        assert "f2" not in tracer.fusions()
        assert p["f2"].fw.stats.total_invoke_num == 1
        p.stop()

    @pytest.mark.parametrize("gap", [False, True], ids=["queue", "gap"])
    def test_tracer_records_match_jax(self, gap):
        """The tracer on the chain fixture: with chain-fusion=off on both
        packages the same fusions and the same crossings per element,
        counts and bytes; fused (the port alone) the shells bill nothing
        and the fusions name the head."""
        def line(pkg):
            return gap_line(pkg) if gap else pkg.chain_line()

        recs = {}
        for pkg in (JAX, PORT):
            p, tracer, outs, _ = play(pkg, line(pkg), n=2,
                                      chain_fusion="off")
            recs[pkg.name] = (tracer.fusions(), tracer.crossings(), outs)
            p.stop()
        (jf, jc, jo), (pf, pc, po) = recs[JAX.name], recs[PORT.name]
        assert pf == jf
        assert pc["per_element"] == jc["per_element"]
        assert_same(po, jo)
        p, tracer, outs, _ = play(PORT, line(PORT), n=2)
        fus = tracer.fusions()
        assert fus.get("f2") == "fused-into:f1"
        assert (fus.get("tr") == "fused-into:f1") if gap else "tr" not in fus
        per = tracer.crossings()["per_element"]
        assert no_crossings(per, "f2") and no_crossings(per, "tr")
        assert per["f1"]["h2d"] == 2 and per["out"]["d2h"] == 2
        p.stop()
        assert_same(outs, jo)

    def test_restart_after_gate_flip_dissolves_chain(self):
        """stop() → chain-fusion=off → play() comes up per-filter with no
        error: a cold start drops the prior epoch's chain."""
        p, tracer, outs, x = play(PORT, PORT.chain_line())
        assert p["f1"]._chain_specs
        p.stop()
        p.chain_fusion = "off"
        tracer2 = PORT.trace.attach(p, replace=True)
        p.play()
        p["src"].push_buffer(PORT.Buffer(tensors=[x]))
        p["src"].end_of_stream()
        assert p.bus.wait_eos(30)
        assert p.bus.error is None, p.bus.error.data
        np.testing.assert_array_equal(
            np.asarray(p["out"].collected[-1][0]), x + 11)
        assert "f2" not in tracer2.fusions()
        assert not p["f1"]._chain_specs
        assert p["f2"].fw.stats.total_invoke_num == 1
        p.stop()

    def test_restart_into_chain_drops_member_stages(self):
        """A per-filter epoch fuses the gap transform into the tail as its
        pre-stage; after stop() → chain-fusion=auto → play() the chain
        claims the gap, and the tail's old stage must not run inside its
        chain callable on top of the gap's (the math applied twice)."""
        line = PORT.chain_line(link="! queue ! tensor_transform name=tr "
                                    "mode=arithmetic "
                                    "option=typecast:float32,mul:0.5 !")
        p, tracer, outs, x = play(PORT, line, chain_fusion="off")
        np.testing.assert_array_equal(outs[0], (x + 1) * 0.5 + 10)
        assert tracer.fusions() == {"tr": "fused-into:f2"}
        p.stop()
        p.chain_fusion = "auto"
        tracer2 = PORT.trace.attach(p, replace=True)
        p.play()
        p["src"].push_buffer(PORT.Buffer(tensors=[x]))
        p["src"].end_of_stream()
        assert p.bus.wait_eos(30)
        assert p.bus.error is None, p.bus.error.data
        np.testing.assert_array_equal(
            np.asarray(p["out"].collected[-1][0]), (x + 1) * 0.5 + 10)
        assert tracer2.fusions() == {"tr": "fused-into:f1",
                                     "f2": "fused-into:f1"}
        assert not p["f2"]._pre_specs
        p.stop()

    @BOTH
    def test_fusion_off_gates_chain_fusion_too(self, pkg):
        p = pkg.parse_launch(pkg.chain_line())
        p.fusion = "off"
        tracer = pkg.trace.attach(p)
        p.play()
        p["src"].push_buffer(
            pkg.Buffer(tensors=[np.ones((2, 4), np.float32)]))
        p["src"].end_of_stream()
        assert p.bus.wait_eos(30) and p.bus.error is None
        assert "f2" not in tracer.fusions()
        p.stop()


# --- the reference's TestGapTransform --------------------------------------

def gap_line(pkg):
    return pkg.chain_line(link="! tensor_transform name=tr mode=arithmetic "
                               "option=typecast:float32,mul:0.5 !")


class TestGapTransform:
    def test_gap_transform_claimed_exactly_once(self):
        p, tracer, outs, x = play(PORT, gap_line(PORT))
        np.testing.assert_array_equal(outs[0], (x + 1) * 0.5 + 10)
        fus = tracer.fusions()
        assert fus.get("tr") == "fused-into:f1", fus
        assert fus.get("f2") == "fused-into:f1", fus
        assert not p["f1"]._post_specs and not p["f1"]._pre_specs
        assert not p["f2"]._pre_specs and not p["f2"]._post_specs
        assert p["f1"].fw._jit_trace_count == 1
        assert p["f2"].fw.stats.total_invoke_num == 0
        p.stop()
        assert_same(outs, reference_outputs(gap_line))

    @BOTH
    def test_replay_does_not_double_claim(self, pkg):
        p, tracer, outs, x = play(pkg, gap_line(pkg))
        p.stop()
        tracer2 = pkg.trace.attach(p, replace=True)
        p.play()
        p["src"].push_buffer(pkg.Buffer(tensors=[x]))
        p["src"].end_of_stream()
        assert p.bus.wait_eos(30) and p.bus.error is None
        out2 = np.asarray(p["out"].collected[-1][0])
        np.testing.assert_array_equal(out2, (x + 1) * 0.5 + 10)
        assert tracer2.fusions().get("tr") == "fused-into:f1"
        p.stop()

    def test_head_pre_chain_still_fuses(self):
        def line(pkg):
            return (f"appsrc name=src caps={CAPS_F32} "
                    "! tensor_transform name=pre mode=arithmetic "
                    f"option=typecast:float32,mul:2 ! {pkg.filt('f1', 1)} "
                    f"! queue ! {pkg.filt('f2', 10)} ! tensor_sink name=out")

        p, tracer, outs, x = play(PORT, line(PORT))
        np.testing.assert_array_equal(outs[0], x * 2 + 11)
        fus = tracer.fusions()
        assert fus.get("pre") == "fused-into:f1", fus
        assert fus.get("f2") == "fused-into:f1", fus
        assert p["f1"].fw._jit_trace_count == 1
        p.stop()
        assert_same(outs, reference_outputs(line))


# --- the reference's TestVerdicts ------------------------------------------

BLOCKERS = [
    (dict(f1_extra="shared-tensor-filter-key=ck"), "shared backend key"),
    (dict(f1_extra="sync=true"), "sync=1"),
    (dict(f2_extra="batch-size=4"), "batch-size=4 on a non-head member"),
]


def fanout_line(pkg, filter_first=True):
    branch_f = f"t. ! queue ! {pkg.filt('f2', 10)} ! tensor_sink name=out"
    branch_s = "t. ! queue ! tensor_sink name=side"
    branches = (branch_f, branch_s) if filter_first else (branch_s, branch_f)
    return (f"appsrc name=src caps={CAPS_F32} ! {pkg.filt('f1', 1)} "
            f"! tee name=t  {branches[0]}  {branches[1]}")


class TestVerdicts:
    def test_nnst450_fusable_and_fuses(self):
        diags = chain_codes(PORT, PORT.chain_line())
        assert [d.code for d in diags] == ["NNST450"], diags
        assert "saves 1 program launch" in diags[0].message
        p, tracer, _, _ = play(PORT, PORT.chain_line())
        assert tracer.fusions().get("f2") == "fused-into:f1"
        p.stop()

    @BOTH
    @pytest.mark.parametrize("props,needle", BLOCKERS,
                             ids=["shared", "sync", "batch"])
    def test_nnst451_blocked_and_stays_per_filter(self, pkg, props, needle):
        line = pkg.chain_line(link="!", **props)
        diags = chain_codes(pkg, line)
        assert [d.code for d in diags] == ["NNST451"], diags
        assert needle in diags[0].message, diags[0].message
        p, tracer, outs, _ = play(pkg, line)
        assert "f2" not in tracer.fusions(), tracer.fusions()
        assert p["f2"].fw.stats.total_invoke_num >= 1
        p.stop()
        if pkg.port:
            assert_same(outs, reference_outputs(
                lambda q: q.chain_line(link="!", **props)))

    @BOTH
    def test_nnst451_invoke_dynamic_blocked(self, pkg):
        line = pkg.chain_line(f1_extra="invoke-dynamic=true")
        diags = chain_codes(pkg, line)
        assert [d.code for d in diags] == ["NNST451"], diags
        assert "invoke-dynamic" in diags[0].message

    @BOTH
    def test_nnst451_fanout_tee_names_the_tee(self, pkg):
        diags = chain_codes(pkg, fanout_line(pkg))
        assert [d.code for d in diags] == ["NNST451"], diags
        assert diags[0].element == "t"
        assert "fan-out" in diags[0].message

    @BOTH
    def test_nnst451_fanout_verdict_branch_order_independent(self, pkg):
        line = fanout_line(pkg, filter_first=False)
        diags = chain_codes(pkg, line)
        assert [d.code for d in diags] == ["NNST451"], diags
        assert diags[0].element == "t"
        assert "fan-out" in diags[0].message
        p, tracer, outs, x = play(pkg, line)
        assert "f2" not in tracer.fusions()
        np.testing.assert_array_equal(
            np.asarray(p["side"].collected[0][0]), x + 1)
        p.stop()

    def test_nnst452_pruned_and_never_compiled(self, monkeypatch):
        monkeypatch.setenv("NNSTPU_HBM_BYTES", "48")
        diags = chain_codes(PORT, PORT.chain_line())
        assert [d.code for d in diags] == ["NNST452"], diags
        p, tracer, outs, x = play(PORT, PORT.chain_line())
        np.testing.assert_array_equal(outs[0], x + 11)
        assert "f2" not in tracer.fusions()
        assert p["f1"].fw._chain_stages is None  # never installed
        assert p["f2"].fw.stats.total_invoke_num == 1
        p.stop()

    @BOTH
    def test_nnst453_link_mismatch_with_hint(self, pkg):
        line = (f"appsrc caps={CAPS_F32} ! {pkg.filt('f1', 1)} "
                "! tensor_filter name=m framework=jax model=mobilenet_v2 "
                f"custom=aot:0 {pkg.cpu} ! tensor_sink")
        diags = chain_codes(pkg, line)
        assert [d.code for d in diags] == ["NNST453"], diags
        assert diags[0].element == "m"
        assert "'f1' -> 'm'" in diags[0].message
        assert diags[0].hint and "tensor_transform" in diags[0].hint

    @BOTH
    def test_chain_off_element_silences_verdicts(self, pkg):
        line = pkg.chain_line(f2_extra="chain-fusion=off")
        assert chain_codes(pkg, line) == []


# --- the reference's TestFallback ------------------------------------------

class TestFallback:
    @BOTH
    def test_declining_backend_falls_back_unfused(self, pkg, monkeypatch):
        monkeypatch.setattr(pkg.backend, "fuse_chain",
                            lambda self, stages, *a: not stages)
        p, tracer, outs, x = play(pkg, pkg.chain_line())
        np.testing.assert_array_equal(outs[0], x + 11)
        assert "f2" not in tracer.fusions()
        assert p["f1"].fw.stats.total_invoke_num == 1
        assert p["f2"].fw.stats.total_invoke_num == 1
        p.stop()

    @BOTH
    def test_incomposable_composition_declines_at_install(self, pkg):
        """fuse_chain runs the composition data-free (jax.eval_shape; the
        port on meta tensors) before committing: a stage list that cannot
        compose declines instead of failing at the first invoke."""
        fops = sys.modules[f"{pkg.name}.ops.fusion_stages"]
        fbase = sys.modules[f"{pkg.name}.filters.base"]
        types = sys.modules[f"{pkg.name}.types"]
        fw = pkg.backend()
        fw.open(fbase.FilterProperties(
            framework="jax", model_files=["add"], custom="k:1,aot:0",
            accelerator="true:cpu",
            input_info=types.TensorsInfo.from_strings("4:2", "float32")))

        class BadTail:
            def chain_callable(self, meta=False):
                if pkg.port:
                    dev = "meta" if meta else "cpu"
                    return lambda xs: [xs[0] @ torch.ones((999, 3),
                                                          device=dev)]
                import jax.numpy as jnp

                return lambda xs: [jnp.dot(xs[0], jnp.ones((999, 3)))]

        assert fw.fuse_chain([("model",
                               fops.ModelStage("bad", BadTail()))]) is False
        assert fw._chain_stages is None
        fw.close()


# --- the reference's TestCapsAndBatching -----------------------------------

class TestCapsAndBatching:
    def test_head_src_caps_carry_end_of_chain(self):
        def line(pkg):
            return pkg.chain_line(link="! tensor_transform name=tr "
                                       "mode=typecast option=uint8 !")

        p, tracer, outs, x = play(PORT, line(PORT))
        assert tracer.fusions().get("f2") == "fused-into:f1"
        cfg = p["f1"].src_pads[0].caps.to_config()
        assert cfg.info.tensors[0].dtype.np_dtype == np.uint8
        np.testing.assert_array_equal(
            outs[0], (x + 1).astype(np.uint8) + 10)
        p.stop()
        assert_same(outs, reference_outputs(line))

    def test_head_microbatch_composes(self):
        def line(pkg):
            return pkg.chain_line(f1_extra="batch-size=2")

        p, tracer, outs, x = play(PORT, line(PORT), n=4)
        assert len(outs) == 4
        for i, o in enumerate(outs):
            np.testing.assert_array_equal(o, (x + i + 11)[None])
        assert p["f1"].fw._jit_trace_count == 1
        assert p["f1"].fw.stats.total_invoke_num == 2  # 4 frames / batch 2
        assert p["f2"].fw.stats.total_invoke_num == 0
        p.stop()
        assert_same(outs, reference_outputs(line, n=4))

    def test_predicted_compiles_pin_shells_to_zero(self):
        p, _, _, _ = play(PORT, PORT.chain_line())
        pred = PORT.costmodel.predict_compiles(p)
        assert pred == {"f1": 1, "f2": 0}, pred
        assert p["f1"].fw.compile_stats()["jit_traces"] == 1
        assert p["f2"].fw.compile_stats()["jit_traces"] == 0
        p.stop()


# --- the reference's TestReload --------------------------------------------

def wait_for(p, n, what):
    deadline = time.time() + 10
    while len(p["out"].collected) < n and time.time() < deadline:
        time.sleep(0.01)
    assert len(p["out"].collected) >= n, what


class TestReload:
    def test_reload_model_reinstalls_chain(self):
        p = PORT.parse_launch(PORT.chain_line())
        PORT.trace.attach(p)
        p.play()
        x = np.ones((2, 4), np.float32)
        p["src"].push_buffer(PORT.Buffer(tensors=[x]))
        p["f1"].sink_pad.receive_event(
            PORT.Event("reload-model", {"model": "add"}))
        p["src"].push_buffer(PORT.Buffer(tensors=[x]))
        p["src"].end_of_stream()
        assert p.bus.wait_eos(30)
        assert p.bus.error is None, p.bus.error.data
        assert len(p["out"].collected) == 2
        for t in p["out"].collected:
            np.testing.assert_array_equal(np.asarray(t[0]), x + 11)
        assert p["f2"].fw.stats.total_invoke_num == 0
        assert p["f1"].fw._chain_stages, "chain dropped across reload"
        p.stop()

    def test_reload_on_shell_recomposes_head(self, tmp_path):
        """Reloading a chain-fused SHELL's model rebuilds the HEAD's
        composition — without it the head keeps serving the old model."""
        model = tmp_path / "mul100.py"
        model.write_text(
            "def make_model(custom):\n"
            "    def apply_fn(params, x):\n"
            "        return x * 100.0\n"
            "    return apply_fn, None\n")
        p = PORT.parse_launch(PORT.chain_line())
        tracer = PORT.trace.attach(p)
        p.play()
        assert tracer.fusions().get("f2") == "fused-into:f1"
        x = np.ones((2, 4), np.float32)
        p["src"].push_buffer(PORT.Buffer(tensors=[x]))
        wait_for(p, 1, "first buffer never arrived")
        p["f2"].sink_pad.receive_event(
            PORT.Event("reload-model", {"model": str(model)}))
        p["src"].push_buffer(PORT.Buffer(tensors=[x]))
        p["src"].end_of_stream()
        assert p.bus.wait_eos(30)
        assert p.bus.error is None, p.bus.error.data
        np.testing.assert_array_equal(
            np.asarray(p["out"].collected[0][0]), x + 11)  # pre-reload
        np.testing.assert_array_equal(
            np.asarray(p["out"].collected[1][0]), (x + 1) * 100.0)
        assert p["f2"].fw.stats.total_invoke_num == 0  # still composed
        p.stop()


# --- the reference's TestThreeFilterChain ----------------------------------

class TestThreeFilterChain:
    def test_blocked_link_preserves_clean_prefix(self):
        def line(pkg):
            return (f"appsrc name=src caps={CAPS_F32} ! {pkg.filt('f1', 1)} "
                    f"! {pkg.filt('f2', 10)} ! tee name=t  t. ! queue "
                    f"! {pkg.filt('f3', 100)} ! tensor_sink name=out  "
                    "t. ! queue ! tensor_sink name=side")

        diags = chain_codes(PORT, line(PORT))
        assert sorted(d.code for d in diags) == ["NNST450", "NNST451"], diags
        assert {d.code: d.element for d in diags}["NNST451"] == "t"
        p, tracer, outs, x = play(PORT, line(PORT))
        fus = tracer.fusions()
        assert fus.get("f2") == "fused-into:f1", fus
        assert "f3" not in fus
        np.testing.assert_array_equal(outs[0], x + 111)
        np.testing.assert_array_equal(
            np.asarray(p["side"].collected[0][0]), x + 11)
        assert p["f2"].fw.stats.total_invoke_num == 0
        assert p["f3"].fw.stats.total_invoke_num == 1
        p.stop()
        assert_same(outs, reference_outputs(line))

    def test_gated_member_preserves_clean_prefix(self):
        def line(pkg):
            return (f"appsrc name=src caps={CAPS_F32} ! {pkg.filt('f1', 1)} "
                    f"! {pkg.filt('f2', 10)} "
                    f"! {pkg.filt('f3', 100, 'sync=true')} "
                    "! tensor_sink name=out")

        diags = chain_codes(PORT, line(PORT))
        assert sorted(d.code for d in diags) == ["NNST450", "NNST451"], diags
        p, tracer, outs, x = play(PORT, line(PORT))
        assert tracer.fusions().get("f2") == "fused-into:f1"
        np.testing.assert_array_equal(outs[0], x + 111)
        assert p["f3"].fw.stats.total_invoke_num == 1
        p.stop()
        assert_same(outs, reference_outputs(line))

    def test_maximal_run_composes_all(self):
        def line(pkg):
            return (f"appsrc name=src caps={CAPS_F32} ! {pkg.filt('f1', 1)} "
                    f"! queue ! {pkg.filt('f2', 10)} "
                    f"! {pkg.filt('f3', 100)} ! tensor_sink name=out")

        diags = chain_codes(PORT, line(PORT))
        assert [d.code for d in diags] == ["NNST450"], diags
        assert "saves 2 program launch" in diags[0].message
        p, tracer, outs, x = play(PORT, line(PORT))
        np.testing.assert_array_equal(outs[0], x + 111)
        fus = tracer.fusions()
        assert fus.get("f2") == "fused-into:f1"
        assert fus.get("f3") == "fused-into:f1"
        cr = tracer.crossings()
        assert cr["h2d"] == 1 and cr["d2h"] == 1, cr
        assert p["f1"].fw._jit_trace_count == 1
        assert p["f2"].fw.stats.total_invoke_num == 0
        assert p["f3"].fw.stats.total_invoke_num == 0
        p.stop()
        assert_same(outs, reference_outputs(line))


# --- the reference's TestChainFusedCrossingParity (tests/test_residency.py) -

class TestChainFusedCrossingParity:
    """predict_crossings models fused chains: interior links bill zero
    bytes (the shells pass through) and the chain's one boundary bills the
    composed output, so the predictor and the tracer agree on a fused
    line, counts and bytes (the port alone: the reference never fuses
    under this jax)."""

    def test_fused_chain_parity_counts_and_bytes(self):
        from nnstreamer_tpu_torch.analysis.residency import (
            parity_mismatches,
            predict_crossings,
        )

        p = PORT.parse_launch(PORT.chain_line())
        tracer = PORT.trace.attach(p)
        p.play()
        assert p["f2"]._fused_into == "f1"  # chain fused by default
        for i in range(3):
            p["src"].push_buffer(PORT.Buffer(
                tensors=[np.full((2, 4), float(i), np.float32)]))
        p["src"].end_of_stream()
        assert p.bus.wait_eos(30)
        assert p.bus.error is None, p.bus.error.data
        pred = predict_crossings(p, n_buffers=3)
        assert "f2" not in pred["per_element"], pred
        assert pred["per_element"]["out"]["d2h"] == 3
        assert pred["per_element_bytes"]["out"]["d2h"] == 3 * 32
        mism = parity_mismatches(pred, tracer.crossings())
        assert not mism, mism
        p.stop()

    def test_fused_gap_transform_chain_parity(self):
        from nnstreamer_tpu_torch.analysis.residency import (
            parity_mismatches,
            predict_crossings,
        )

        p = PORT.parse_launch(gap_line(PORT))
        tracer = PORT.trace.attach(p)
        p.play()
        assert p["tr"]._fused_into == "f1"
        assert p["f2"]._fused_into == "f1"
        pred = predict_crossings(p, n_buffers=2)
        for _ in range(2):
            p["src"].push_buffer(PORT.Buffer(
                tensors=[np.ones((2, 4), np.float32)]))
        p["src"].end_of_stream()
        assert p.bus.wait_eos(30)
        assert p.bus.error is None, p.bus.error.data
        mism = parity_mismatches(pred, tracer.crossings())
        assert not mism, mism
        p.stop()


# --- the flagship cascade at a small size ----------------------------------

SIZE, CLASSES, FPT, N_FRAMES = 96, 16, 4, 8
MBV2 = f"size:{SIZE},width:0.35,classes:{CLASSES},fused:pallas"


@pytest.fixture(scope="module")
def cascade(tmp_path_factory):
    """(npz of the JAX zoo's seed:0 MobileNet-v2 for the port, labels,
    frames): the JAX package's own weights carried across with
    ``models/convert.py``."""
    import nnstreamer_tpu.models as jm
    from nnstreamer_tpu_torch.models.convert import (
        from_jax_variables,
        save_state_dict,
    )

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jm, "_init_on_cpu", jit_init)
        b = jm.get_model("mobilenet_v2", {"seed": "0", "size": str(SIZE),
                                          "width": "0.35",
                                          "classes": str(CLASSES)})
    d = tmp_path_factory.mktemp("cascade")
    npz = str(d / "mbv2.npz")
    save_state_dict(from_jax_variables(jax.device_get(b.params)), npz)
    labels = str(d / "labels.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"label{i}" for i in range(CLASSES)) + "\n")
    rng = np.random.default_rng(0)
    frames = [np.kron(rng.integers(0, 256, (4, 4, 3)),
                      np.ones((SIZE // 4, SIZE // 4, 1))).astype(np.uint8)
              for _ in range(N_FRAMES)]
    return npz, labels, frames


def cascade_line(npz, labels=None, m_extra="", h_custom=None, fpt=FPT):
    """The flagship's head with a second model behind it: MobileNet-v2, a
    typecast/div gap, a bf16 matmul head (argmax), the labels."""
    h_custom = h_custom or f"dim:{CLASSES},seed:1,postproc:argmax"
    tail = (f"! queue ! tensor_decoder mode=image_labeling option1={labels} "
            if labels else "")
    return (f"appsrc name=src caps=video/x-raw,format=RGB,width={SIZE},"
            f"height={SIZE},framerate=30/1 "
            f"! tensor_converter frames-per-tensor={fpt} "
            "! tensor_filter name=m framework=jax model=mobilenet_v2 "
            f"custom=params:{npz},{MBV2} accelerator=true:cpu {m_extra} "
            "! queue ! tensor_transform name=tr mode=arithmetic "
            "option=typecast:float32,div:2.0 "
            "! tensor_filter name=h framework=jax model=matmul "
            f"custom={h_custom} accelerator=true:cpu {tail}"
            "! tensor_sink name=out")


def run_frames(line, frames, chain_fusion=None):
    """(pipeline, tracer, sink buffers) of one run over ``frames``."""
    p = PORT.parse_launch(line)
    if chain_fusion is not None:
        p.chain_fusion = chain_fusion
    tracer = PORT.trace.attach(p)
    p.play()
    for f in frames:
        p["src"].push_buffer(PORT.Buffer(tensors=[f]))
    p["src"].end_of_stream()
    assert p.bus.wait_eos(120)
    assert p.bus.error is None, p.bus.error.data
    return p, tracer, list(p["out"].collected)


def labels_of(bufs):
    return [lab for b in bufs for lab in b.meta["label"]]


def test_cascade_verdict_is_nnst450(cascade):
    npz, labels, _ = cascade
    diags = chain_codes(PORT, cascade_line(npz, labels))
    assert [d.code for d in diags] == ["NNST450"], diags
    assert diags[0].element == "m"
    assert "saves 1 program launch" in diags[0].message


def test_cascade_fused_equals_off(cascade):
    """One program a batch: one upload at m, one fetch past the shells, h
    never invoked, one build; the labels of every frame and the logits
    (the head without its argmax) equal to chain-fusion=off's."""
    npz, labels, frames = cascade
    runs = {}
    for cf in ("auto", "off"):
        p, tracer, bufs = run_frames(cascade_line(npz, labels), frames, cf)
        runs[cf] = {"labels": labels_of(bufs), "fusions": tracer.fusions(),
                    "crossings": tracer.crossings(),
                    "h_invokes": p["h"].fw.stats.total_invoke_num,
                    "m_builds": p["m"].fw.compile_stats()["jit_traces"]}
        p.stop()
    fused, off = runs["auto"], runs["off"]
    assert len(fused["labels"]) == N_FRAMES
    assert fused["labels"] == off["labels"]
    assert fused["fusions"] == {"tr": "fused-into:m", "h": "fused-into:m"}
    assert off["fusions"] == {"tr": "fused-into:h"}  # a pre stage of h
    batches = N_FRAMES // FPT
    assert fused["crossings"]["h2d"] == fused["crossings"]["d2h"] == batches
    assert fused["crossings"]["per_element"]["m"]["h2d"] == batches
    assert no_crossings(fused["crossings"]["per_element"], "h")
    assert fused["h_invokes"] == 0 and off["h_invokes"] == batches
    assert fused["m_builds"] == 1
    logits = {}
    for cf in ("auto", "off"):
        p, _, bufs = run_frames(cascade_line(
            npz, h_custom=f"dim:{CLASSES},seed:1"), frames, cf)
        logits[cf] = np.concatenate([np.asarray(b.tensors[0]) for b in bufs])
        p.stop()
    assert logits["auto"].shape == (N_FRAMES, CLASSES)
    assert np.isfinite(logits["auto"]).all()
    np.testing.assert_array_equal(logits["auto"], logits["off"])


def test_mobilenet_scaler_chain_matches_jax_filters(cascade):
    """MobileNet-v2 → scaler composed in the port against the JAX
    package's two filters run one by one on the same weights, at the JAX
    package's bf16 tolerance."""
    npz, _, frames = cascade

    def line(pkg, custom):
        return (f"appsrc name=src caps=video/x-raw,format=RGB,width={SIZE},"
                f"height={SIZE},framerate=30/1 "
                f"! tensor_converter frames-per-tensor={FPT} "
                "! tensor_filter name=m framework=jax model=mobilenet_v2 "
                f"custom={custom} {pkg.cpu} ! queue "
                "! tensor_filter name=s framework=jax model=scaler "
                f"custom=scale:0.5,aot:0 {pkg.cpu} ! tensor_sink name=out")

    outs = {}
    for pkg, custom in ((JAX, f"seed:0,{MBV2}"),
                        (PORT, f"params:{npz},{MBV2}")):
        p = pkg.parse_launch(line(pkg, custom))
        p.chain_fusion = "off" if not pkg.port else "auto"
        tracer = pkg.trace.attach(p)
        p.play()
        for f in frames:
            p["src"].push_buffer(pkg.Buffer(tensors=[f]))
        p["src"].end_of_stream()
        assert p.bus.wait_eos(120)
        assert p.bus.error is None, p.bus.error.data
        outs[pkg.name] = np.concatenate(
            [np.asarray(b.tensors[0]) for b in p["out"].collected])
        if pkg.port:
            assert tracer.fusions() == {"s": "fused-into:m"}
            assert p["s"].fw.stats.total_invoke_num == 0
        p.stop()
    got, want = outs[PORT.name], outs[JAX.name]
    assert got.shape == want.shape == (N_FRAMES, CLASSES)
    np.testing.assert_allclose(got, want, atol=0.15, rtol=0.05)


@pytest.mark.parametrize("tail", [
    ("add", "k:10,aot:0"), ("scaler", "scale:0.5,aot:0")],
    ids=["add", "scaler"])
def test_add_scaler_chains_bit_equal_to_reference(tail):
    """A three-member add/scaler chain with a gap transform composed in
    the port, bit for bit against the JAX package's filters one by one."""
    model, custom = tail

    def line(pkg):
        return (f"appsrc name=src caps={CAPS_F32} ! {pkg.filt('f1', 1)} "
                "! tensor_transform name=tr mode=arithmetic "
                "option=typecast:float32,mul:3.0,add:-0.25 "
                f"! tensor_filter name=f2 framework=jax model={model} "
                f"custom={custom} {pkg.cpu} ! queue "
                f"! tensor_filter name=f3 framework=jax model=scaler "
                f"custom=scale:1.5,aot:0 {pkg.cpu} ! tensor_sink name=out")

    x = np.random.default_rng(7).normal(0, 4, (2, 4)).astype(np.float32)
    p, tracer, outs, _ = play(PORT, line(PORT), n=3, x=x)
    assert tracer.fusions() == {"tr": "fused-into:f1", "f2": "fused-into:f1",
                                "f3": "fused-into:f1"}
    p.stop()
    assert_same(outs, reference_outputs(line, n=3, x=x))


def test_looped_chain_head(cascade):
    """loop-window=4 launch-depth=2 on the head: NNST460 for m, the window
    program runs the whole composition (h never invoked), every frame's
    label equal to the per-buffer fused run's."""
    npz, labels, frames = cascade
    frames = frames * 2  # one frame a buffer: 4 windows of 4
    looped = cascade_line(npz, labels, fpt=1,
                          m_extra="loop-window=4 launch-depth=2")
    codes = [d.code for d in PORT.analyze_launch(looped)
             if d.code.startswith(("NNST45", "NNST46"))]
    assert sorted(codes) == ["NNST450", "NNST460"], codes
    p, tracer, bufs = run_frames(looped, frames)
    assert p["m"]._loop_state == {"window": 4, "depth": 2}
    assert p["m"]._loop_refused is None
    assert tracer.fusions().get("h") == "fused-into:m"
    assert p["h"].fw.stats.total_invoke_num == 0
    assert p["m"].fw.stats.total_invoke_num == len(frames) // 4
    got = [b.meta["label"] for b in bufs]
    p.stop()
    q, _, want_bufs = run_frames(cascade_line(npz, labels, fpt=1), frames)
    want = [b.meta["label"] for b in want_bufs]
    q.stop()
    assert len(got) == len(frames) and got == want


def test_reload_on_shell_recomposes_looped_head(tmp_path):
    """A reload on a shell behind a LOOPED head: the window program is
    rebuilt over the new composition (on the card its captured graph is
    dropped and recaptured), so the next windows run the reloaded model."""
    model = tmp_path / "mul100.py"
    model.write_text(
        "def make_model(custom):\n"
        "    def apply_fn(params, x):\n"
        "        return x * 100.0\n"
        "    return apply_fn, None\n")
    line = PORT.chain_line(f1_extra="loop-window=2 launch-depth=1")
    p = PORT.parse_launch(line)
    tracer = PORT.trace.attach(p)
    p.play()
    assert tracer.fusions().get("f2") == "fused-into:f1"
    assert p["f1"]._loop_state == {"window": 2, "depth": 1}
    x = np.ones((2, 4), np.float32)
    for _ in range(2):
        p["src"].push_buffer(PORT.Buffer(tensors=[x]))
    wait_for(p, 2, "first window never arrived")
    p["f2"].sink_pad.receive_event(
        PORT.Event("reload-model", {"model": str(model)}))
    assert p["f1"].fw._loop_graphs == {}
    for _ in range(2):
        p["src"].push_buffer(PORT.Buffer(tensors=[x]))
    p["src"].end_of_stream()
    assert p.bus.wait_eos(30)
    assert p.bus.error is None, p.bus.error.data
    outs = [np.asarray(b[0]) for b in p["out"].collected]
    assert len(outs) == 4
    for o in outs[:2]:
        np.testing.assert_array_equal(o, x + 11)
    for o in outs[2:]:
        np.testing.assert_array_equal(o, (x + 1) * 100.0)
    assert p["f2"].fw.stats.total_invoke_num == 0
    p.stop()
