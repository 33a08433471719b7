"""Mesh sharding (``tensor_filter shard=dp|tp|dpxtp mesh=AxB``) through
both packages, on the CPU.

The JAX package runs on the 8 virtual CPU devices of tests/conftest.py;
the port on ``NNSTPU_TORCH_DEVICES=cpu*8`` (set for every test here), its
filters with ``accelerator=true:cpu``. Every case of the reference's
tests/test_shard.py that passes there runs through both packages: the
same line goes to each package's analyzer or pipeline, and each must meet
the reference's asserts. Outputs: a sharded ``model=matmul custom=dim:64``
equals the same package's unsharded run at the reference's tolerance
(rtol=atol=1e-5; the two packages draw W differently), ``x + k`` equals
numpy at rtol=1e-6 in both. The reference's memory-plan cases fail there
(its cost model raises under jax 0.9), so they are held on the port alone
— with distinct device names (``cuda:0,...,cuda:7``, never run), where the
port's rows must equal what the reference's tests assert, and with one
repeated device, where each device's row sums every position on it. The
tuner cases are in tests/test_torch_tuner.py. Last, the small MobileNet-v2 of
tests/test_torch_pipeline.py on the same weights: the port under
``shard=dp mesh=4x1`` and ``shard=tp mesh=1x2`` against the JAX line
under the same ``shard=`` with ``fused:xla``.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_shared import (  # noqa: E402,F401 (fixtures)
    equal_name_counters,
    one_torch_thread,
)
jax = pytest.importorskip("jax")

import nnstreamer_tpu.analysis  # noqa: E402
import nnstreamer_tpu.analysis.residency  # noqa: E402
import nnstreamer_tpu.analysis.shard  # noqa: E402
import nnstreamer_tpu.buffer  # noqa: E402
import nnstreamer_tpu.parallel.mesh  # noqa: E402
import nnstreamer_tpu.pipeline  # noqa: E402
import nnstreamer_tpu.pipeline.element  # noqa: E402
import nnstreamer_tpu.pipeline.pipeline  # noqa: E402
import nnstreamer_tpu.trace  # noqa: E402
import nnstreamer_tpu_torch.analysis  # noqa: E402
import nnstreamer_tpu_torch.analysis.residency  # noqa: E402
import nnstreamer_tpu_torch.analysis.shard  # noqa: E402
import nnstreamer_tpu_torch.buffer  # noqa: E402
import nnstreamer_tpu_torch.parallel.mesh  # noqa: E402
import nnstreamer_tpu_torch.pipeline  # noqa: E402
import nnstreamer_tpu_torch.pipeline.element  # noqa: E402
import nnstreamer_tpu_torch.pipeline.pipeline  # noqa: E402
import nnstreamer_tpu_torch.trace  # noqa: E402
from nnstreamer_tpu_torch.analysis import memplan  # noqa: E402
from nnstreamer_tpu_torch.parallel import mesh as port_mesh  # noqa: E402
from test_torch_pipeline import weights  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("nnstreamer_tpu", "nnstreamer_tpu_torch")
CAPS_8x64 = ("other/tensors,num-tensors=1,dimensions=64:8,types=float32,"
             "framerate=0/1")
#: matmul has a (64, 64) bf16 param leaf — tp-shardable (64 % 8 == 0)
MM = "tensor_filter name=f framework=jax model=matmul custom=dim:64,aot:0"
ADD = "tensor_filter name=f framework=jax model=add custom=k:1,aot:0"


@pytest.fixture(autouse=True)
def eight_devices(monkeypatch):
    """The port's counterpart of the conftest's 8 virtual devices."""
    monkeypatch.setenv("NNSTPU_TORCH_DEVICES", "cpu*8")


class Pkg:
    def __init__(self, name):
        mod = sys.modules
        self.port = name == "nnstreamer_tpu_torch"
        self.analyze = mod[f"{name}.analysis"].analyze
        self.analyze_launch = mod[f"{name}.analysis"].analyze_launch
        self.parse_launch = mod[f"{name}.pipeline"].parse_launch
        self.State = mod[f"{name}.pipeline.pipeline"].State
        self.trace = mod[f"{name}.trace"]
        self.Buffer = mod[f"{name}.buffer"].Buffer
        self.residency = mod[f"{name}.analysis.residency"]
        self.shard = mod[f"{name}.analysis.shard"]
        self.cpu = "accelerator=true:cpu " if self.port else ""

    def filt(self, filt):
        return f"{filt} {self.cpu}".rstrip()

    def line(self, filt, extra="", caps=CAPS_8x64):
        e = f"{extra} " if extra else ""
        return (f"appsrc name=src caps={caps} ! {self.filt(filt)} {e}"
                f"! tensor_sink name=out")

    def two(self, f1_extra="", f2_extra=""):
        return (f"appsrc name=src caps={CAPS_8x64} "
                f"! tensor_filter name=f1 framework=jax model=add "
                f"custom=k:1,aot:0 {self.cpu}{f1_extra}! queue "
                f"! tensor_filter name=f2 framework=jax model=add "
                f"custom=k:2,aot:0 {self.cpu}{f2_extra}! tensor_sink "
                f"name=out")

    def shard_codes(self, desc):
        return [d for d in self.analyze_launch(desc)
                if d.code.startswith("NNST47")]

    def play(self, desc, n=4, shape=(8, 64)):
        p = self.parse_launch(desc)
        tracer = self.trace.attach(p)
        p.play()
        rng = np.random.default_rng(7)
        frames = [rng.standard_normal(shape).astype(np.float32)
                  for _ in range(n)]
        for x in frames:
            p["src"].push_buffer(self.Buffer(tensors=[x]))
        p["src"].end_of_stream()
        assert p.bus.wait_eos(60)
        assert p.bus.error is None, p.bus.error.data
        outs = [np.asarray(t[0]) for t in p["out"].collected]
        return p, tracer, outs, frames


@pytest.fixture(params=PKGS)
def pkg(request):
    return Pkg(request.param)


PORT = Pkg("nnstreamer_tpu_torch")


# --- verdicts ---------------------------------------------------------------

class TestVerdicts:
    def test_nnst470_dp(self, pkg):
        d = pkg.shard_codes(pkg.line(MM, "shard=dp mesh=8x1"))
        assert [x.code for x in d] == ["NNST470"]
        assert "8x1 mesh" in d[0].message
        assert "P('dp')" in d[0].message

    @pytest.mark.parametrize("extra,mesh_s", [("shard=tp mesh=1x8", "1x8"),
                                              ("shard=dpxtp mesh=4x2",
                                               "4x2")])
    def test_nnst470_tp_and_dpxtp(self, pkg, extra, mesh_s):
        d = pkg.shard_codes(pkg.line(MM, extra))
        assert [x.code for x in d] == ["NNST470"], (extra, d)
        assert f"{mesh_s} mesh" in d[0].message

    def test_nnst471_indivisible_batch_names_dim_and_axis(self, pkg):
        caps = CAPS_8x64.replace("64:8", "64:3")
        d = pkg.shard_codes(pkg.line(MM, "shard=dp", caps=caps))
        assert [x.code for x in d] == ["NNST471"]
        assert "leading dim 3" in d[0].message
        assert "dp axis (8" in d[0].message

    @pytest.mark.parametrize("extra,frag", [
        ("shard=dp sync=true", "sync=1"),
        ("shard=dp invoke-dynamic=true", "invoke-dynamic"),
        ("shard=dp shared-tensor-filter-key=shk", "shared backend"),
        ("shard=dp loop-window=8", "loop interaction"),
        ("shard=dp custom=k:1,aot:0,donate:1", "donate"),
        ("shard=dp output-combination=i0", "combination"),
        ("shard=dp mesh=16x1", "16 devices"),
        ("shard=tp custom=k:1,aot:0", "no shardable channel dim"),
    ])
    def test_nnst471_reasons(self, pkg, extra, frag):
        d = pkg.shard_codes(pkg.line(ADD if "custom=" in extra else MM,
                                     extra))
        assert [x.code for x in d] == ["NNST471"], (extra, d)
        assert frag in d[0].message, (frag, d[0].message)

    def test_nnst471_legacy_custom_shard_spelling(self, pkg):
        d = pkg.shard_codes(pkg.line(
            MM.replace("custom=dim:64,aot:0",
                       "custom=dim:64,aot:0,shard:dp"), "shard=dp"))
        assert [x.code for x in d] == ["NNST471"]
        assert "custom=shard:" in d[0].message

    def test_nnst471_chain_interaction_on_claimed_shell(self, pkg):
        p = pkg.parse_launch(pkg.line(MM, "shard=dp mesh=8x1"))
        p["f"]._fused_into = "head"  # a chain claimed this filter
        v = pkg.shard.analyze_shard(p, p["f"])
        assert v.code == "NNST471" and "chain interaction" in v.message

    def test_nnst472_reshard_hazard_names_matching_spec(self, pkg):
        d = [x for x in pkg.analyze_launch(pkg.two("shard=dp mesh=8x1 "))
             if x.code == "NNST472"]
        assert len(d) == 1
        assert "implicit gather" in d[0].message
        assert "shard=dp mesh=8x1" in d[0].hint

    def test_no_hazard_when_specs_match(self, pkg):
        diags = pkg.analyze_launch(pkg.two(
            "output=64:8 outputtype=float32 shard=dp mesh=8x1 ",
            "shard=dp mesh=8x1 "))
        assert not [x for x in diags if x.code == "NNST472"]
        assert len([x for x in diags if x.code == "NNST470"]) == 2

    def test_single_chip_lines_emit_no_shard_codes(self, pkg):
        assert pkg.shard_codes(pkg.line(MM)) == []
        assert pkg.shard_codes(pkg.line(ADD, "batch-size=4 feed-depth=2")) \
            == []

    def test_corpus_lines_carry_their_marked_codes(self, pkg):
        expected = {"# ELIGIBLE": "NNST470", "# INELIGIBLE": "NNST471",
                    "# RESHARD": "NNST472"}
        want, seen = None, 0
        with open(os.path.join(ROOT, "examples",
                               "launch_lines_shard.txt")) as f:
            for raw in f:
                raw = raw.strip()
                for marker, code in expected.items():
                    if raw.startswith(marker):
                        want = code
                if raw.startswith("# OVER-BUDGET"):
                    want = None  # NNST700 needs the opt-in cost pass
                if raw.startswith("appsrc") and want is not None:
                    got = {d.code for d in pkg.analyze_launch(raw)}
                    assert want in got, (raw, want, got)
                    seen += 1
        assert seen == 8


# --- runtime: verdicts match behaviour --------------------------------------

class TestRuntime:
    @pytest.mark.parametrize("extra", ["shard=dp mesh=8x1",
                                       "shard=tp mesh=1x8",
                                       "shard=dpxtp mesh=4x2"])
    def test_dp_tp_dpxtp_parity_vs_unsharded(self, pkg, extra):
        p0, _, base, _ = pkg.play(pkg.line(MM))
        p0.stop()
        p, _, outs, _ = pkg.play(pkg.line(MM, extra))
        st = p["f"]._shard_state
        assert st is not None and st["mode"] == extra.split()[0][6:]
        assert p["f"].fw.compile_stats()["jit_traces"] == 1
        assert len(outs) == len(base)
        for a, b in zip(base, outs):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        p.stop()

    @pytest.mark.parametrize("extra", ["shard=dp sync=true",
                                       "shard=dp shared-tensor-filter-key=shk"])
    def test_nnst471_fallback_is_loud_and_correct(self, pkg, extra):
        p, _, outs, frames = pkg.play(pkg.line(ADD, extra))
        assert p["f"]._shard_state is None
        code, _ = p["f"]._shard_refused
        assert code == "NNST471"
        for x, o in zip(frames, outs):
            np.testing.assert_allclose(o, x + 1.0, rtol=1e-6)
        p.stop()

    def test_indivisible_batch_falls_back(self, pkg):
        p, _, outs, frames = pkg.play(
            pkg.line(ADD, "shard=dp",
                     caps=CAPS_8x64.replace("64:8", "64:3")), shape=(3, 64))
        assert p["f"]._shard_state is None
        assert p["f"]._shard_refused[0] == "NNST471"
        for x, o in zip(frames, outs):
            np.testing.assert_allclose(o, x + 1.0, rtol=1e-6)
        p.stop()

    def test_loop_wins_the_interaction_and_windows_engage(self, pkg):
        p, tracer, outs, frames = pkg.play(
            pkg.line(ADD, "shard=dp loop-window=4"), n=8)
        assert p["f"]._shard_state is None
        assert p["f"]._shard_refused[0] == "NNST471"
        assert p["f"]._loop_state == {"window": 4, "depth": 1}
        assert tracer.crossings()["h2d"] == 2  # two staged windows
        for x, o in zip(frames, outs):
            np.testing.assert_allclose(o, x + 1.0, rtol=1e-6)
        p.stop()

    def test_reshard_hazard_edge_still_flows(self, pkg):
        p, _, outs, frames = pkg.play(pkg.two("shard=dp mesh=8x1 "))
        assert p["f1"]._shard_state is not None
        assert p["f2"]._shard_state is None
        for x, o in zip(frames, outs):
            np.testing.assert_allclose(o, x + 3.0, rtol=1e-6)
        p.stop()

    def test_chain_refuses_a_shard_member_and_the_shard_engages(self, pkg):
        desc = pkg.two("output=64:8 outputtype=float32 ",
                       "shard=dp mesh=8x1 ")
        d = [x for x in pkg.analyze_launch(desc) if x.code == "NNST451"]
        assert d and "shard=" in d[0].message
        p, _, outs, frames = pkg.play(desc)
        assert p["f2"]._fused_into is None
        assert p["f2"]._shard_state == {"mode": "dp", "dp": 8, "tp": 1}
        for x, o in zip(frames, outs):
            np.testing.assert_allclose(o, x + 3.0, rtol=1e-6)
        p.stop()

    def test_replan_loop_off_shard_on_engages_the_mesh(self, pkg):
        p = pkg.parse_launch(pkg.line(ADD, "loop-window=4"))
        p.play()
        assert p["f"]._loop_state == {"window": 4, "depth": 1}
        p.set_state(pkg.State.PAUSED)
        p["f"].properties["loop_window"] = 1
        p["f"].properties["shard"] = "dp"
        p["f"].properties["mesh"] = "8x1"
        p.play()
        assert p["f"]._loop_state is None
        assert p["f"]._shard_state == {"mode": "dp", "dp": 8, "tp": 1}
        p.stop()

    def test_cold_restart_replans_a_flipped_prop(self, pkg):
        p, _, _, _ = pkg.play(pkg.line(MM, "shard=dp mesh=8x1"))
        assert p["f"]._shard_state is not None
        p.stop()
        p["f"].properties["shard"] = "off"
        p.play()
        p["src"].end_of_stream()
        assert p.bus.wait_eos(30)
        assert p["f"]._shard_state is None
        p.stop()


def test_add_outputs_agree_across_packages():
    """The same frames through both packages' dp-sharded ``x + k``: equal
    outputs (the matmul's W differs between the packages, so it is held
    to its own unsharded run above)."""
    pj, pp = Pkg("nnstreamer_tpu"), PORT
    a = pj.play(pj.line(ADD, "shard=dp mesh=8x1"))
    b = pp.play(pp.line(ADD, "shard=dp mesh=8x1"))
    for x, y in zip(a[2], b[2]):
        np.testing.assert_allclose(x, y, rtol=1e-6)
    a[0].stop()
    b[0].stop()


# --- static-vs-tracer per-device byte parity --------------------------------

class TestByteParity:
    def test_per_device_bytes_parity(self, pkg):
        p, tracer, _, _ = pkg.play(pkg.line(MM, "shard=dp mesh=8x1"), n=4)
        pred = pkg.residency.predict_crossings(p, n_buffers=4)
        # 4 frames x (8, 64) f32 = 8192 B each way, /8 per device
        assert pred["per_element_bytes_per_device"] == {
            "f": {"h2d": 1024, "d2h": 1024}}
        assert pkg.residency.parity_mismatches(pred,
                                               tracer.crossings()) == []
        p.stop()

    def test_unsharded_runs_bank_no_per_device_counters(self, pkg):
        p, tracer, _, _ = pkg.play(pkg.line(MM), n=2)
        assert pkg.residency.predict_crossings(
            p, n_buffers=2)["per_element_bytes_per_device"] == {}
        for el in tracer.crossings()["per_element"].values():
            assert not any(k.endswith("_per_device") for k in el)
        p.stop()


# --- the port's per-position memory plan ------------------------------------

BIG = ("appsrc caps=other/tensors,num-tensors=1,dimensions=1024:1024:8,"
       "types=float32,framerate=0/1 ! tensor_filter name=f framework=jax "
       "model=add custom=k:1,aot:0 accelerator=true:cpu feed-depth=8 "
       "{}! tensor_sink")
#: eight distinct devices, named only: the plans below never run them
DISTINCT = ",".join(f"cuda:{i}" for i in range(8))


class TestMemplan:
    """The reference's TestMemplan asserts (its cost model fails there),
    on the port with distinct devices; then the repeated-device row."""

    def test_dp_model_fits_one_chips_slice(self, monkeypatch):
        monkeypatch.setenv("NNSTPU_TORCH_DEVICES", DISTINCT)
        monkeypatch.setenv("NNSTPU_HBM_BYTES", "128M")
        unsharded = memplan.plan_memory(PORT.parse_launch(BIG.format("")))
        assert unsharded["total_bytes"] > unsharded["budget_bytes"]
        sharded = memplan.plan_memory(PORT.parse_launch(
            BIG.format("shard=dp mesh=8x1 ")))
        assert sharded["total_bytes"] <= sharded["budget_bytes"]
        assert sharded["mesh_devices"] == 8
        row = sharded["rows"][0]
        assert row["shard"] == {"mode": "dp", "dp": 8, "tp": 1}
        assert row["feed_bytes"] == unsharded["rows"][0]["feed_bytes"] // 8
        assert sharded["aggregate_bytes"] >= unsharded["total_bytes"] // 2

    def test_params_billed_replicated_or_sharded_per_spec(self, monkeypatch):
        monkeypatch.setenv("NNSTPU_TORCH_DEVICES", DISTINCT)
        full = 64 * 64 * 2  # matmul dim=64, bf16
        dp = memplan.plan_memory(PORT.parse_launch(
            PORT.line(MM, "shard=dp mesh=8x1")))
        assert dp["param_bytes_total"] == full  # replicated per device
        tp = memplan.plan_memory(PORT.parse_launch(
            PORT.line(MM, "shard=tp mesh=1x8")))
        assert tp["param_bytes_total"] == full // 8  # channel-split
        assert tp["aggregate_bytes"] >= full  # ...but the slice holds all

    def test_mesh_aware_nnst700_fires_per_device(self, monkeypatch):
        monkeypatch.setenv("NNSTPU_TORCH_DEVICES", DISTINCT)
        monkeypatch.setenv("NNSTPU_HBM_BYTES", "8M")
        p = PORT.parse_launch(BIG.format("shard=dp mesh=8x1 "))
        assert "NNST700" in {d.code for d in PORT.analyze(p, cost=True)}

    def test_per_device_budget_is_min_over_mesh(self, monkeypatch):
        monkeypatch.setenv("NNSTPU_TORCH_DEVICES", DISTINCT)
        monkeypatch.delenv("NNSTPU_HBM_BYTES", raising=False)
        limits = [16 * 2**30] * 3 + [2 * 2**30] + [16 * 2**30] * 4
        monkeypatch.setattr(
            memplan, "device_memory_budget",
            lambda i=0: (limits[i] if i < 8 else 16 * 2**30, "cuda"))
        b, src = memplan.mesh_memory_budget(8)
        assert b == 2 * 2**30  # NOT device 0's 16 GiB
        assert "min-of-8-devices" in src
        assert memplan.mesh_memory_budget(1)[0] == 16 * 2**30

    def test_repeated_device_sums_every_position(self, monkeypatch):
        """A mesh of virtual devices over one device: its row holds every
        position's share — an 8-way dp split of one device bills what
        the unsharded line does there, and tp holds each leaf once."""
        monkeypatch.setenv("NNSTPU_TORCH_DEVICES", "cuda:0*8")
        monkeypatch.setenv("NNSTPU_HBM_BYTES", "128M")
        unsharded = memplan.plan_memory(PORT.parse_launch(BIG.format("")))
        sharded = memplan.plan_memory(PORT.parse_launch(
            BIG.format("shard=dp mesh=8x1 ")))
        assert sharded["per_device_bytes"] == {
            "cuda:0": sharded["total_bytes"]}
        # equal but for the activation's rounding in the 8-way split
        assert abs(sharded["total_bytes"] - unsharded["total_bytes"]) < 8
        assert sharded["total_bytes"] > sharded["budget_bytes"]
        full = 64 * 64 * 2
        tp = memplan.plan_memory(PORT.parse_launch(
            PORT.line(MM, "shard=tp mesh=1x8")))
        row = tp["rows"][0]
        # 8 slices of the leaf on cuda:0, plus the invoke's gather
        assert tp["per_device_bytes"]["cuda:0"] == (
            8 * (full // 8 + row["total_bytes"]) + row["gather_bytes"])
        assert row["gather_bytes"] >= full


# --- placement ----------------------------------------------------------------

def test_visible_devices_reads_the_env_on_every_call(monkeypatch):
    assert port_mesh.visible_devices() == [torch.device("cpu")] * 8
    monkeypatch.setenv("NNSTPU_TORCH_DEVICES", "cuda:0*2,cuda:1")
    assert [str(d) for d in port_mesh.visible_devices()] == [
        "cuda:0", "cuda:0", "cuda:1"]
    monkeypatch.delenv("NNSTPU_TORCH_DEVICES")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port_mesh.visible_devices() == [torch.device("cpu")]
    with pytest.raises(ValueError):
        port_mesh.parse_devices("cuda:0*0")


def test_tp_rule_splits_the_same_leaves_as_the_reference():
    """The reference's rule on flax's MobileNet-v2 variables and the
    port's on the same variables carried across: the same bytes split
    and replicated at tp 2 and 4 (flax keeps a kernel's output channels
    last, torch first). The port's state also holds each BatchNorm's
    ``num_batches_tracked`` counter, which flax does not have; it is
    replicated."""
    from nnstreamer_tpu.models import get_model
    from nnstreamer_tpu_torch.analysis.shard import _leaf_shards
    from nnstreamer_tpu_torch.models.convert import from_jax_variables
    from nnstreamer_tpu_torch.models.mobilenet_v2 import MobileNetV2

    jshard = sys.modules["nnstreamer_tpu.analysis.shard"]
    b = get_model("mobilenet_v2", {"seed": "0", "size": "32",
                                   "width": "0.35", "classes": "16"})
    params = jax.device_get(b.params)
    module = MobileNetV2(num_classes=16, width_mult=0.35)
    module.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in
                            from_jax_variables(params).items()})
    counters = sum(t.numel() * t.element_size()
                   for k, t in module.state_dict().items()
                   if k.endswith("num_batches_tracked"))
    assert counters > 0
    for tp in (2, 4):
        want = jshard._leaf_shards(params, tp)
        got = _leaf_shards(module, tp)
        assert got[0] == want[0] and got[1] == want[1] + counters, tp
        assert len(got[2]) == len(want[2])


def test_placed_leaves_gather_back_and_match_the_bill():
    """shard_params_for_tp: each position holds its slice or the whole
    leaf, the gather restores every leaf exactly, and the bytes per
    position are the shard analyzer's per-device bill."""
    from nnstreamer_tpu_torch.analysis.shard import _leaf_shards
    from nnstreamer_tpu_torch.models.mobilenet_v2 import MobileNetV2

    module = MobileNetV2(num_classes=16, width_mult=0.35)
    mesh = port_mesh.mesh_from_axes(2, 2)
    placed = port_mesh.shard_params_for_tp(mesh, module)
    sharded, repl, _ = _leaf_shards(module, 2)
    for pos in port_mesh.mesh_positions(mesh):
        assert sum(leaf.nbytes_at(pos) for leaf in placed.values()) == \
            sharded // 2 + repl
    state = module.state_dict()
    for k, leaf in placed.items():
        for row in (0, 1):
            assert torch.equal(leaf.gather(row, torch.device("cpu")),
                               state[k])
    specs = port_mesh.param_shardings(mesh, module)
    assert specs["stem_conv.weight"] == ("tp", None, None, None)
    assert specs["stem_bn.weight"] == ()
    assert port_mesh.shard_batch(mesh, np.zeros((6, 3)))[1].shape == (3, 3)


def test_backend_holds_the_bill_per_position():
    """The backend's placed weights per mesh position are the analyzer's
    per-shard bill, dp rows hold whole copies, and clearing restores the
    solo model; outputs equal the solo forward (to float32 rounding: a
    dp row's smaller batch sums in another order on the CPU)."""
    from nnstreamer_tpu_torch.filters.base import FilterProperties
    from nnstreamer_tpu_torch.filters.cuda_filter import TorchCudaFilter

    fw = TorchCudaFilter()
    fw.open(FilterProperties(
        framework="jax", model_files=["mobilenet_v2"],
        custom="seed:0,size:32,width:0.35,classes:16,fused:pallas",
        accelerator="true:cpu"))
    x = np.random.default_rng(0).integers(0, 256, (4, 32, 32, 3),
                                          dtype=np.uint8)
    base = fw.invoke([x])[0]
    full = sum(t.numel() * t.element_size()
               for t in fw._bundle.module.state_dict().values())
    from nnstreamer_tpu_torch.analysis.shard import _leaf_shards

    sharded, repl, _ = _leaf_shards(fw._bundle.module, 2)
    for cfg, each in (({"mode": "dp", "dp": 4, "tp": 1}, full),
                      ({"mode": "tp", "dp": 1, "tp": 2}, sharded // 2 + repl),
                      ({"mode": "dpxtp", "dp": 2, "tp": 2},
                       sharded // 2 + repl)):
        assert fw.build_shard(cfg)
        held = fw.mesh_param_bytes()
        assert len(held) == cfg["dp"] * (cfg["tp"] if cfg["tp"] > 1 else 1)
        assert set(held.values()) == {each}, cfg
        torch.testing.assert_close(fw.invoke([x])[0], base, rtol=1e-5,
                                   atol=1e-6)
        torch.testing.assert_close(fw.invoke(fw.prefetch([x]))[0], base,
                                   rtol=1e-5, atol=1e-6)
        assert fw.build_shard(None)
    assert torch.equal(fw.invoke([x])[0], base)
    fw.close()


# --- the small MobileNet-v2 against the JAX line ----------------------------

def _mbv2_line(custom, extra):
    return ("appsrc name=src caps=video/x-raw,format=RGB,width=64,height=64,"
            "framerate=30/1 ! tensor_converter frames-per-tensor=4 "
            f"! tensor_filter name=f framework=jax model=mobilenet_v2 "
            f"custom={custom} {extra}! tensor_sink name=out")


def _run_mbv2(pkg, line, frames):
    p = pkg.parse_launch(line)
    p.play()
    for f in frames:
        p["src"].push_buffer(pkg.Buffer(tensors=[f]))
    p["src"].end_of_stream()
    assert p.bus.wait_eos(120)
    assert p.bus.error is None, p.bus.error
    state = p["f"]._shard_state
    out = [np.asarray(b.tensors[0]) for b in p["out"].collected]
    p.stop()
    return out, state


@pytest.mark.parametrize("shard,want", [
    ("shard=dp mesh=4x1", {"mode": "dp", "dp": 4, "tp": 1}),
    ("shard=tp mesh=1x2", {"mode": "tp", "dp": 1, "tp": 2})])
def test_mobilenet_v2_sharded_against_jax(weights, shard, want):  # noqa: F811
    """The port's kernel forward (``fused:pallas``, plain on the CPU)
    under the mesh against the JAX package's ``fused:xla`` line under the
    same shard= on flax's seed:0 weights: logits at
    tests/test_torch_pipeline.py's tolerance (atol 0.15, rtol 0.05), and
    the port's own unsharded run's to float32 rounding (a dp row's
    smaller batch sums in another order on the CPU)."""
    _, _, npz_seed0, _, frames = weights
    jax_pkg = Pkg("nnstreamer_tpu")
    custom = "size:64,width:0.35,classes:16"
    ref, ref_state = _run_mbv2(jax_pkg, _mbv2_line(
        f"seed:0,{custom},fused:xla", shard + " "), frames)
    assert ref_state == want
    port_line = _mbv2_line(f"params:{npz_seed0},{custom},fused:pallas",
                           "accelerator=true:cpu ")
    got, state = _run_mbv2(PORT, port_line.replace(
        "accelerator", shard + " accelerator"), frames)
    solo, _ = _run_mbv2(PORT, port_line, frames)
    assert state == want
    assert len(got) == len(ref) == len(frames) // 4
    for g, r, s in zip(got, ref, solo):
        assert g.shape == r.shape == (4, 16)
        np.testing.assert_allclose(g, r, atol=0.15, rtol=0.05)
        np.testing.assert_allclose(g, s, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("custom,shape", [
    ("shard:dp,shard_devices:4", {"dp": 4, "tp": 1, "sp": 1}),
    ("shard:dpxtp,shard_devices:8,tp_devices:2", {"dp": 4, "tp": 2, "sp": 1}),
    ("shard:tp,shard_devices:2", {"dp": 1, "tp": 2, "sp": 1})])
def test_legacy_custom_shard_builds_the_mesh_at_open(custom, shape):
    """``custom=shard:`` builds the mesh at open over the first
    ``shard_devices`` devices, as the JAX backend's recipe does
    (``mesh_from_spec``); the shard= planner then cannot install another
    (``shard_supported`` is false) and the outputs are the solo ones."""
    from nnstreamer_tpu_torch.filters.base import FilterProperties
    from nnstreamer_tpu_torch.filters.cuda_filter import TorchCudaFilter

    fw = TorchCudaFilter()
    fw.open(FilterProperties(framework="jax", model_files=["matmul"],
                             custom=f"dim:64,{custom}",
                             accelerator="true:cpu"))
    try:
        assert fw._mesh is not None and fw._mesh.shape == shape
        assert not fw._shard_installed and not fw.shard_supported()
        assert not fw.build_shard({"mode": "dp", "dp": 2, "tp": 1})
        x = np.random.default_rng(1).standard_normal((8, 64)).astype(
            np.float32)
        want = (torch.from_numpy(x).to(torch.bfloat16)
                @ fw._mesh_params["w"].gather(0, torch.device("cpu"))
                if fw._mesh_params is not None
                else torch.from_numpy(x).to(torch.bfloat16)
                @ fw._mesh_bundles[0].module.w).float()
        torch.testing.assert_close(fw.invoke([x])[0], want, rtol=1e-5,
                                   atol=1e-5)
    finally:
        fw.close()


def test_legacy_custom_shard_refuses_a_zero_tp_axis():
    from nnstreamer_tpu_torch.filters.base import FilterProperties
    from nnstreamer_tpu_torch.filters.cuda_filter import TorchCudaFilter

    with pytest.raises(ValueError, match="tp_devices >= 1"):
        TorchCudaFilter().open(FilterProperties(
            framework="jax", model_files=["matmul"],
            custom="dim:64,shard:dpxtp,tp_devices:0",
            accelerator="true:cpu"))
