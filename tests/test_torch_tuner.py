"""The autotuner (``analysis/tuner.py``, ``validate --tune``, NNST850–853)
through the port, on the CPU, against the JAX package's tuner.

Every case of the reference's tests/test_tuner.py, restated for the port
on the same lines, plus the tuner cases of its tests/test_shard.py and
tests/test_steady_loop.py. Under this jax the reference's cost model
raises inside ``program_cost`` (ROADMAP queue 3 item 2), so its tuner
cannot predict, rank or prune by the model: 18 of its 38 cases fail. So
the parity is split:

- where the JAX function runs — ``tune_space``, ``enumerate_points``,
  ``config_fragment``, ``baseline_point``, ``apply_point``, the
  nothing-tunable report, the NNST802 prune of a tee line, the CLI's
  refusals — the port gives what the JAX package gives on the same line
  (the same dims and candidates, points, fragments, baselines, applied
  properties; reports byte-equal where nothing is modeled);
- where it cannot — predictions, ranks, NNST850–853, the prune
  accounting, the measured phase with the reference's spy, the CLI's
  reports — the port is held to the expectations the reference's own
  tests state.

The port's device list is ``NNSTPU_TORCH_DEVICES=cpu*8`` (set for every
test), the counterpart of the conftest's 8 virtual JAX devices; lines
that the measured phase plays name ``accelerator=true:cpu``. The NNST850
hint names ``doctor --tune``, as the reference's does, and
``tools/doctor.py --tune`` delegates to the tuner. Both packages'
element-name counters are emptied at the module's end.
"""

import json
import os

import pytest
from test_torch_shared import (  # noqa: E402,F401 (fixtures)
    equal_name_counters,
    one_torch_thread,
    worker_torch_threads,
)

pytest.importorskip("torch")
pytest.importorskip("jax")

import nnstreamer_tpu.analysis.tuner as jax_tuner  # noqa: E402
import nnstreamer_tpu.pipeline as jax_pipeline  # noqa: E402
import nnstreamer_tpu_torch.analysis.tuner as tuner  # noqa: E402
from nnstreamer_tpu_torch.analysis import analyze, analyze_launch  # noqa: E402
from nnstreamer_tpu_torch.analysis.tuner import (  # noqa: E402
    DEFAULT_SPACE,
    baseline_point,
    config_fragment,
    enumerate_points,
    measure_launch,
    render_tune_report,
    tune_main,
    tune_report,
    tune_space,
)
from nnstreamer_tpu_torch.pipeline import parse_launch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CAPS_F32 = ("other/tensors,num-tensors=1,dimensions=4:2,types=float32,"
            "framerate=0/1")
#: 128 KiB frames — big enough that the link leg is the static story
CAPS_BIG = ("other/tensors,num-tensors=1,dimensions=4096:8,types=float32,"
            "framerate=0/1")
CAPS_8x64 = ("other/tensors,num-tensors=1,dimensions=64:8,types=float32,"
             "framerate=0/1")
FILTER = "tensor_filter framework=jax model=add custom=k:1,aot:0"
CPU = "accelerator=true:cpu"
LINE = f"appsrc name=src caps={CAPS_F32} ! {FILTER} ! tensor_sink name=out"
#: LINE as the measured phase plays it on the CPU
LINE_CPU = (f"appsrc name=src caps={CAPS_F32} ! {FILTER} {CPU} "
            "! tensor_sink name=out")

#: the examples/launch_lines_overbudget.txt shape (64 MB frames)
OVERBUDGET = (
    "appsrc caps=other/tensors,num-tensors=1,dimensions=1024:1024:16,"
    "types=float32,framerate=0/1 "
    f"! {FILTER} ! tensor_sink")

SERVING = (
    "tensor_query_serversrc id=tn port=0 serve=1 serve-batch=8 "
    "serve-queue-depth=64 caps=other/tensors,num-tensors=1,dimensions=4,"
    "types=float32,framerate=0/1 "
    f"! {FILTER} ! tensor_query_serversink id=tn")

TEE = (f"appsrc caps={CAPS_F32} ! tee name=t  "
       f"t. ! queue ! {FILTER} ! tensor_sink name=a  "
       f"t. ! queue ! tensor_sink name=b")

CHAIN = (f"appsrc name=src caps={CAPS_F32} "
         "! tensor_filter name=f1 framework=jax model=add "
         "custom=k:1,aot:0 ! queue "
         "! tensor_filter name=f2 framework=jax model=add "
         "custom=k:10,aot:0 ! tensor_sink name=out")

#: matmul has a (64, 64) bf16 param leaf — tp-shardable (64 % 8 == 0)
MM = "tensor_filter name=f framework=jax model=matmul custom=dim:64,aot:0"
MLINE = f"appsrc name=src caps={CAPS_8x64} ! {MM} ! tensor_sink name=out"


@pytest.fixture(autouse=True)
def _eight_devices(monkeypatch):
    monkeypatch.setenv("NNSTPU_TORCH_DEVICES", "cpu*8")


def codes(diags):
    return {d.code for d in diags}


def by_code(diags, code):
    return [d for d in diags if d.code == code]


def spy_measure(calls):
    """Deterministic fake measured phase recording which configs ran."""

    def fn(launch, point, n_frames):
        calls.append(dict(point))
        return {"frames": 8, "wall_s": 0.001, "fps": 8000.0}

    return fn


def both_spaces(line):
    """(port dims, JAX dims) of one line."""
    return (tune_space(parse_launch(line)),
            jax_tuner.tune_space(jax_pipeline.parse_launch(line)))


def accounting_holds(rep):
    c = rep["counts"]
    return (c["pruned"] + c["evaluated"] + c["validated"]
            == c["enumerated"] == len(rep["points"]))


# --- space discovery ------------------------------------------------------

class TestSpace:
    def test_filter_knobs_without_converter_or_serving(self):
        dims, want = both_spaces(LINE)
        assert list(dims) == ["batch_size", "feed_depth", "fetch_window",
                              "loop_window", "launch_depth", "shard",
                              "donate"]
        assert dims["batch_size"] == list(DEFAULT_SPACE["batch_size"])
        assert dims["shard"] == ["off", "dp:8x1"]
        assert dims == want

    def test_converter_adds_microbatch(self):
        line = ("appsrc caps=video/x-raw,format=RGB,width=224,height=224,"
                "framerate=30/1 ! tensor_converter frames-per-tensor=4 "
                "! tensor_filter framework=jax model=mobilenet_v2 "
                "custom=seed:0,aot:0 ! tensor_sink")
        dims, want = both_spaces(line)
        assert "microbatch" in dims
        # the shard probe stacks 8 four-frame tensors: flax's MobileNet-v2
        # takes any leading dims, the port's [B, H, W, C] only, so its
        # meta run fails there and the port proves no mesh arm
        assert "shard" in want and "shard" not in dims
        want.pop("shard")
        assert dims == want

    def test_fusable_transform_adds_fusion(self):
        line = (f"appsrc caps={CAPS_F32.replace('float32', 'uint8')} "
                "! tensor_transform mode=arithmetic "
                "option=typecast:float32,mul:2 "
                f"! {FILTER} ! tensor_sink")
        dims, want = both_spaces(line)
        assert "fusion" in dims
        assert dims == want

    def test_serving_launch_includes_serve_batch(self):
        dims, want = both_spaces(SERVING)
        assert "serve_batch" in dims and dims == want
        rep = tune_report(SERVING, measure=False)
        assert "serve_batch" in rep["space"]
        assert rep["counts"]["evaluated"] > 0

    def test_nothing_tunable(self):
        line = "videotestsrc num-buffers=2 ! tensor_converter ! tensor_sink"
        rep = tune_report(line, measure=False)
        assert rep["counts"]["enumerated"] == 0
        assert "note" in rep and "signature" in rep
        # nothing is modeled: the two packages' reports are byte-equal
        assert json.dumps(rep, sort_keys=True) == json.dumps(
            jax_tuner.tune_report(line, measure=False), sort_keys=True)

    def test_enumeration_order_is_the_product_order(self):
        dims = {"a": [1, 2], "b": ["x", "y"]}
        pts = enumerate_points(dims)
        assert pts == [{"a": 1, "b": "x"}, {"a": 1, "b": "y"},
                       {"a": 2, "b": "x"}, {"a": 2, "b": "y"}]
        assert pts == jax_tuner.enumerate_points(dims)

    @pytest.mark.parametrize("line", [LINE, SERVING, CHAIN, MLINE])
    def test_points_of_each_space_equal_the_references(self, line):
        dims, want = both_spaces(line)
        assert enumerate_points(dims) == jax_tuner.enumerate_points(want)


# --- points onto a pipeline: the JAX functions' results -------------------

def _knobs(p):
    """Every knob apply_point writes: the filters', converters' and query
    servers' properties and the pipeline's fusion switches."""
    out = {"fusion": str(getattr(p, "fusion", "auto")),
           "chain_fusion": str(getattr(p, "chain_fusion", "auto"))}
    for name, e in sorted(p.elements.items()):
        props = e.properties
        out[name] = {k: str(props.get(k)) for k in (
            "batch_size", "feed_depth", "fetch_window", "loop_window",
            "launch_depth", "shard", "mesh", "custom", "frames_per_tensor",
            "serve_batch") if k in props}
    return out


CONV_LINE = ("appsrc name=src caps=video/x-raw,format=RGB,width=224,"
             "height=224,framerate=30/1 ! tensor_converter name=c "
             "frames-per-tensor=4 ! tensor_filter name=f framework=jax "
             "model=mobilenet_v2 custom=seed:0,aot:0 ! tensor_sink name=out")


class TestApplyPoint:
    @pytest.mark.parametrize("point", [
        {"microbatch": 32, "batch_size": 4, "feed_depth": 2,
         "fetch_window": "auto", "fusion": "off", "chain_fusion": "off",
         "loop_window": 8, "launch_depth": 2, "donate": True},
        {"batch_size": 16, "shard": "dp:8x1"},
        {"shard": "off", "serve_batch": 32},
    ])
    def test_apply_point_writes_what_the_reference_writes(self, point):
        p = parse_launch(CONV_LINE)
        jp = jax_pipeline.parse_launch(CONV_LINE)
        tuner.apply_point(p, point)
        jax_tuner.apply_point(jp, point)
        assert _knobs(p) == _knobs(jp)
        if "microbatch" in point:
            assert p["c"]._frames_per_tensor == point["microbatch"]

    @pytest.mark.parametrize("line", [LINE, CONV_LINE, SERVING, CHAIN])
    def test_baseline_equals_the_references(self, line):
        dims = tune_space(parse_launch(line))
        assert baseline_point(parse_launch(line), dims) == \
            jax_tuner.baseline_point(jax_pipeline.parse_launch(line), dims)

    @pytest.mark.parametrize("point", [
        {"microbatch": 32, "batch_size": 4, "feed_depth": 2,
         "fetch_window": "auto", "donate": True},
        {"shard": "dp:8x1", "loop_window": 8, "serve_batch": 8},
        {"shard": "off", "fusion": "auto", "chain_fusion": "off"},
    ])
    def test_fragment_equals_the_references(self, point):
        assert config_fragment(point) == jax_tuner.config_fragment(point)


# --- prune accounting (lint honesty) --------------------------------------

class TestPruneAccounting:
    def test_statuses_partition_the_enumeration(self):
        calls = []
        rep = tune_report(LINE, top_k=2, measure=spy_measure(calls))
        assert accounting_holds(rep)
        assert rep["counts"]["validated"] == len(calls) == 2

    def test_every_pruned_point_carries_its_code(self):
        # donate points under a tee prune with NNST802 (unsafe donate)
        for rep in (tune_report(TEE, measure=False),
                    jax_tuner.tune_report(TEE, measure=False)):
            pruned = [e for e in rep["points"] if e["status"] == "pruned"]
            assert pruned and all(e.get("code") and e.get("reason")
                                  for e in pruned)
            assert all(e["code"] == "NNST802" for e in pruned
                       if e["config"].get("donate"))
            assert sum(rep["pruned_by_code"].values()) \
                == rep["counts"]["pruned"]

    def test_nnst700_points_never_reach_the_measured_phase(self):
        calls = []
        rep = tune_report(
            OVERBUDGET, top_k=100,  # validate EVERY survivor
            space={"batch_size": [1, 16], "feed_depth": [1, 32]},
            measure=spy_measure(calls))
        pruned = [e for e in rep["points"] if e["status"] == "pruned"]
        assert any(e["code"] == "NNST700" for e in pruned)
        pruned_cfgs = [e["config"] for e in pruned]
        assert pruned_cfgs and all(cfg not in pruned_cfgs for cfg in calls)
        # the 16x32 upload window (32 GB) must be among the refused
        assert {"batch_size": 16, "feed_depth": 32} in pruned_cfgs


# --- determinism gate -----------------------------------------------------

class TestDeterminism:
    def test_byte_identical_rerun(self):
        a = tune_report(LINE, measure=False)
        b = tune_report(LINE, measure=False)
        assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)

    def test_static_runs_give_the_same_bytes(self, capsys):
        """Two CLI runs of a line with points, prunes and ranks print the
        same bytes."""
        outs = []
        for _ in range(2):
            assert tune_main(["--no-measure", "--json", TEE]) == 0
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1] and json.loads(outs[0])["counts"][
            "pruned"] > 0

    def test_signature_invariant_under_measurement(self):
        calls = []
        a = tune_report(LINE, measure=False)
        b = tune_report(LINE, top_k=1, measure=spy_measure(calls))
        assert calls  # the measured phase really ran
        assert a["signature"] == b["signature"]

    def test_env_kill_switch(self, monkeypatch):
        monkeypatch.setenv("NNSTPU_TUNE_MEASURE", "0")
        rep = tune_report(LINE)  # measure=None honours the env
        assert rep["measure"]["ran"] is False
        assert rep["counts"]["validated"] == 0


# --- static ranking vs measured ordering ----------------------------------

class TestRankingMatchesMeasured:
    def _ordering(self, rep):
        ranked = sorted((e for e in rep["points"] if "rank" in e),
                        key=lambda e: e["rank"])
        assert all("measured" in e for e in ranked), \
            "every survivor must have been measured for this gate"
        static = [e["config"]["batch_size"] for e in ranked]
        measured = [e["config"]["batch_size"]
                    for e in sorted(ranked,
                                    key=lambda e: -e["measured"]["fps"])]
        return static, measured

    def test_crossing_bound_pipeline(self):
        """128 KiB frames through model=add: the static model calls it
        link-bound and ranks the bigger batch first; the measured
        ordering agrees.

        On the CPU batch 16 saves only the per-invoke host time, about a
        third of a frame's, and a 128-frame window lasts ~20 ms, so one
        scheduler stall decided the order when each point took its best
        of 5 runs in a row (2 of 15 runs alone flipped). The two points
        are measured here in turns, 21 rounds of 256 frames, and each
        point's median run is the one the tuner ranks; on one intra-op
        thread, since with torch's default pool the batch's 2 MiB add
        spreads over every core and stalls when other test workers hold
        them, while batch 1's 128 KiB add stays on one thread."""
        import torch

        line = (f"appsrc name=src caps={CAPS_BIG} ! {FILTER} {CPU} "
                "! tensor_sink name=out")
        space = {"batch_size": [1, 16]}
        static = tune_report(line, top_k=2, space=space, measure=False)
        points = [e["config"] for e in sorted(
            (e for e in static["points"] if "rank" in e),
            key=lambda e: e["rank"])][:2]
        runs = {p["batch_size"]: [] for p in points}
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            for _ in range(21):
                for p in points:
                    runs[p["batch_size"]].append(
                        measure_launch(line, p, 256))
        finally:
            torch.set_num_threads(threads)
        median = {b: sorted(r, key=lambda x: x["fps"])[len(r) // 2]
                  for b, r in runs.items()}
        rep = tune_report(line, top_k=2, n_frames=256, space=space,
                          measure=lambda l, p, n: median[p["batch_size"]])
        top = next(e for e in rep["points"] if e.get("rank") == 1)
        assert top["predicted"]["bound"] == "link"
        static, measured = self._ordering(rep)
        assert static == measured == [16, 1]
        assert rep["chosen"]["static_choice_confirmed"] is True

    @pytest.mark.usefixtures("worker_torch_threads")
    def test_compute_bound_pipeline(self):
        """512-wide matmul with the compute constant derated to a
        CPU-class rate: compute-bound, and the batch ordering it predicts
        is the ordering the wall clock measures."""
        line = ("appsrc name=src caps=other/tensors,num-tensors=1,"
                "dimensions=512:8,types=float32,framerate=0/1 "
                "! tensor_filter framework=jax model=matmul "
                f"custom=dim:512,aot:0 {CPU} ! tensor_sink name=out")
        rep = tune_report(
            line, top_k=2, n_frames=96,
            space={"batch_size": [1, 8]},
            constants={"peak_tflops": 0.001, "mfu": 1.0},
            measure=lambda l, p, n: measure_launch(l, p, n, repeats=3))
        top = next(e for e in rep["points"] if e.get("rank") == 1)
        assert top["predicted"]["bound"] == "compute"
        static, measured = self._ordering(rep)
        assert static == measured == [8, 1]

    def test_latency_objective_prefers_small_windows(self):
        thr = tune_report(LINE, measure=False, objective="throughput")
        lat = tune_report(LINE, measure=False, objective="p99-latency")
        tcfg = thr["chosen"]["config"]
        lcfg = lat["chosen"]["config"]
        assert tcfg["batch_size"] > lcfg["batch_size"]
        assert lcfg["batch_size"] == 1 and lcfg["fetch_window"] == 1
        assert (lat["chosen"]["predicted"]["p99_latency_ms"]
                < thr["chosen"]["predicted"]["p99_latency_ms"])


# --- NNST85x codes (one failing-input test per code) ----------------------

class TestTunerCodes:
    def test_nnst851_summary(self):
        d = by_code(analyze_launch(LINE, passes=["tuner"]), "NNST851")
        assert d and d[0].severity == "info"
        assert "points enumerated" in d[0].message

    def test_nnst850_dominated_config(self):
        diags = analyze_launch(f"{LINE.replace('! tensor_sink name=out', '')}"
                               "batch-size=1 ! tensor_sink name=out",
                               passes=["tuner"])
        d = by_code(diags, "NNST850")
        assert d and d[0].severity == "warning"
        assert "headroom" in d[0].message
        assert "doctor --tune" in d[0].hint

    def test_nnst852_fully_pruned_space(self, monkeypatch):
        monkeypatch.setenv("NNSTPU_HBM_BYTES", "1")
        d = by_code(analyze_launch(LINE, passes=["tuner"]), "NNST852")
        assert d and d[0].severity == "error"
        assert "NNST700" in d[0].message

    def test_nnst853_unmodelable_point(self, tmp_path):
        """A model that only admits rank-2 inputs: batch-size>1 stacks a
        third axis, the meta run fails, and the point prunes as NNST853
        instead of reaching (or crashing) the measured phase."""
        model = tmp_path / "rank2.py"
        model.write_text(
            "from nnstreamer_tpu_torch.types import TensorsInfo\n"
            "def make_model(custom):\n"
            "    def apply_fn(params, x):\n"
            "        if len(x.shape) != 2:\n"
            "            raise ValueError('rank-2 only')\n"
            "        return x * 2\n"
            "    return (apply_fn, {}, TensorsInfo.from_strings("
            "'4:2', 'float32'))\n")
        line = (f"appsrc caps={CAPS_F32} ! tensor_filter framework=jax "
                f"model={model} custom=aot:0 ! tensor_sink")
        rep = tune_report(line, measure=False,
                          space={"batch_size": [1, 4]})
        fates = {e["config"]["batch_size"]: e for e in rep["points"]}
        assert fates[1]["status"] == "evaluated"
        assert fates[4]["status"] == "pruned"
        assert fates[4]["code"] == "NNST853"

    def test_tuner_pass_is_explicit_only(self):
        assert not codes(analyze_launch(LINE)) & {"NNST850", "NNST851"}
        assert not codes(analyze_launch(LINE, cost=True)) \
            & {"NNST850", "NNST851"}


# --- the measured phase ---------------------------------------------------

class TestMeasureLaunch:
    def test_serving_source_is_not_drivable(self):
        assert measure_launch(SERVING, {"batch_size": 1}) is None
        assert jax_tuner.measure_launch(SERVING, {"batch_size": 1}) is None

    def test_tune_report_records_the_skip(self):
        rep = tune_report(SERVING, top_k=1, measure=True)
        assert rep["measure"]["ran"] is False
        assert "drivable" in rep["measure"]["skipped_reason"]
        assert accounting_holds(rep)

    def test_measured_point_plays_the_line(self):
        """A real measured run on the CPU: every frame counted, the
        report's chosen config measured."""
        got = measure_launch(LINE_CPU, {"batch_size": 4}, n_frames=16)
        assert got is not None and got["frames"] >= 16 and got["fps"] > 0


# --- CLI ------------------------------------------------------------------

class TestCli:
    def test_text_and_exit_zero(self, capsys):
        assert tune_main(["--no-measure", LINE]) == 0
        out = capsys.readouterr().out
        assert "nntune:" in out and "chosen:" in out and "sha256" in out

    def test_json_output_parses(self, capsys):
        assert tune_main(["--no-measure", "--json", LINE]) == 0
        rep = json.loads(capsys.readouterr().out)
        assert rep["signature"]["algo"] == "sha256"
        assert rep["counts"]["enumerated"] == len(rep["points"])

    def test_validate_delegates_tune(self, capsys):
        from nnstreamer_tpu_torch.tools import validate

        assert validate.main(["--tune", "--no-measure", LINE]) == 0
        assert "nntune:" in capsys.readouterr().out

    def test_doctor_delegates_tune(self, capsys):
        from nnstreamer_tpu_torch.tools import doctor

        assert doctor.main(["--tune", "--no-measure", LINE]) == 0
        assert "nntune:" in capsys.readouterr().out

    def test_fully_pruned_line_exits_2(self, monkeypatch, capsys):
        monkeypatch.setenv("NNSTPU_HBM_BYTES", "1")
        assert tune_main(["--no-measure", LINE]) == 2
        assert "NO feasible configuration" in capsys.readouterr().out

    @pytest.mark.parametrize("argv", [
        ["--no-measure", "nosuchelement ! tensor_sink"],
        ["--no-measure", "--objective", "speed!!", LINE],
        ["--top-k"], ["--top-k", "x", LINE], [],
    ])
    def test_refusals_exit_2_in_both_packages(self, argv, capsys):
        assert tune_main(list(argv)) == 2
        assert jax_tuner.tune_main(list(argv)) == 2


# --- report surfaces ------------------------------------------------------

class TestReport:
    def test_fragment_spelling(self):
        assert config_fragment(
            {"microbatch": 32, "batch_size": 4, "feed_depth": 2,
             "fetch_window": "auto", "donate": True}) == \
            "frames-per-tensor=32 batch-size=4 feed-depth=2 " \
            "fetch-window=auto donate=1"

    def test_render_lists_prune_codes(self, monkeypatch):
        monkeypatch.setenv("NNSTPU_HBM_BYTES", "1")
        txt = render_tune_report(tune_report(LINE, measure=False))
        assert "NNST700" in txt and "NO feasible configuration" in txt

    def test_advisory_never_mutates_the_callers_pipeline(self):
        p = parse_launch(LINE)
        before = _knobs(p)
        analyze(p, passes=["tuner"])
        assert _knobs(p) == before

    def test_readme_documents_the_ports_tune(self):
        with open(os.path.join(REPO, "README.md")) as f:
            readme = f.read()
        for token in ("nnstreamer_tpu_torch.tools.validate --tune",
                      "NNSTPU_TUNE_MEASURE", "NNST850", "NNST853"):
            assert token in readme, f"README drifted: {token!r} missing"


# --- chain-fusion knob ----------------------------------------------------

class TestChainFusionKnob:
    def test_knob_enumerated_only_with_eligible_chain(self):
        blocked = CHAIN.replace(
            "custom=k:1,aot:0", "custom=k:1,aot:0 "
            "shared-tensor-filter-key=tk")
        for line, has in ((CHAIN, True), (LINE, False), (blocked, False)):
            dims, want = both_spaces(line)
            assert ("chain_fusion" in dims) is has and dims == want

    def test_objective_credits_saved_launch(self):
        rep = tune_report(CHAIN, measure=False,
                          space={"chain_fusion": ["auto", "off"]})
        assert accounting_holds(rep)
        by = {e["config"]["chain_fusion"]:
              e["predicted"]["ms_per_frame"] for e in rep["points"]}
        assert by["auto"] < by["off"], by
        assert rep["chosen"]["config"]["chain_fusion"] == "auto"
        assert "chain-fusion=auto" in rep["chosen"]["launch_fragment"]

    def test_on_arm_pruned_with_nnst452(self, monkeypatch):
        monkeypatch.setenv("NNSTPU_HBM_BYTES", "48")
        rep = tune_report(CHAIN, measure=False,
                          space={"chain_fusion": ["auto", "off"]})
        assert accounting_holds(rep)
        st = {e["config"]["chain_fusion"]: (e["status"], e.get("code"))
              for e in rep["points"]}
        assert st["auto"] == ("pruned", "NNST452"), st
        assert st["off"] == ("pruned", "NNST700"), st

    def test_no_credit_for_chain_that_cannot_fuse(self):
        line = (f"appsrc name=src caps={CAPS_F32} "
                "! tensor_filter name=f1 framework=jax model=add "
                "custom=k:1,aot:0 "
                "! tensor_filter name=m framework=jax model=mobilenet_v2 "
                "custom=aot:0 ! tensor_sink name=out")
        rep = tune_report(line, measure=False,
                          space={"chain_fusion": ["auto", "off"]})
        by = {e["config"]["chain_fusion"]:
              e.get("predicted", {}).get("ms_per_frame")
              for e in rep["points"]}
        assert by["auto"] == by["off"], by

    def test_baseline_reads_pipeline_attribute(self):
        p, jp = parse_launch(CHAIN), jax_pipeline.parse_launch(CHAIN)
        p.chain_fusion = jp.chain_fusion = "off"
        base = baseline_point(p, tune_space(p))
        assert base["chain_fusion"] == "off"
        assert base == jax_tuner.baseline_point(jp, jax_tuner.tune_space(jp))


# --- the mesh knob (tests/test_shard.py's tuner cases) --------------------

class TestShardKnob:
    def test_knob_enumerated_with_proven_modes(self):
        dims, want = both_spaces(MLINE)
        assert dims["shard"] == ["off", "dp:8x1", "tp:1x8"] == want["shard"]
        add_line = (f"appsrc name=src caps={CAPS_8x64} ! "
                    "tensor_filter name=f framework=jax model=add "
                    "custom=k:1,aot:0 ! tensor_sink name=out")
        dims, want = both_spaces(add_line)
        assert dims["shard"] == ["off", "dp:8x1"] == want["shard"]

    def test_knob_absent_on_single_device(self, monkeypatch):
        monkeypatch.setenv("NNSTPU_TORCH_DEVICES", "cpu")
        assert "shard" not in tune_space(parse_launch(MLINE))

    def test_over_budget_off_arm_pruned_dp_arm_survives(self, monkeypatch):
        # eight distinct devices (planned, never run): over one repeated
        # device the plan sums every position on it
        monkeypatch.setenv("NNSTPU_TORCH_DEVICES",
                           ",".join(f"cuda:{i}" for i in range(8)))
        monkeypatch.setenv("NNSTPU_HBM_BYTES", "128M")
        big = ("appsrc name=src caps=other/tensors,num-tensors=1,"
               "dimensions=1024:1024:8,types=float32,framerate=0/1 "
               "! tensor_filter name=f framework=jax model=add "
               "custom=k:1,aot:0 ! tensor_sink name=out")
        rep = tune_report(big, measure=False,
                          space={"feed_depth": [8],
                                 "shard": ["off", "dp:8x1"]})
        by = {e["config"]["shard"]: e for e in rep["points"]}
        assert by["off"]["status"] == "pruned"
        assert by["off"]["code"] == "NNST700"
        assert by["dp:8x1"]["status"] == "evaluated"

    def test_objective_credits_the_mesh(self):
        rep = tune_report(MLINE, measure=False,
                          space={"shard": ["off", "dp:8x1"]})
        by = {e["config"]["shard"]: e for e in rep["points"]}
        assert by["dp:8x1"]["predicted"]["ms_per_frame"] <= \
            by["off"]["predicted"]["ms_per_frame"]

    def test_determinism_over_the_grown_space(self):
        space = {"batch_size": [1, 8], "shard": ["off", "dp:8x1", "tp:1x8"]}
        a = tune_report(MLINE, measure=False, space=space)
        b = tune_report(MLINE, measure=False, space=space)
        assert a["signature"] == b["signature"]
        assert json.dumps(a, sort_keys=True, default=str) == \
            json.dumps(b, sort_keys=True, default=str)

    def test_fragment_names_an_explicit_mesh(self):
        assert config_fragment({"shard": "dp:8x1"}) == "shard=dp mesh=8x1"
        assert config_fragment({"shard": "off"}) == "shard=off"

    def test_baseline_keeps_the_configured_mesh(self):
        line = (f"appsrc name=src caps={CAPS_8x64} ! {MM} "
                "shard=dpxtp mesh=2x4 ! tensor_sink name=out")
        p, jp = parse_launch(line), jax_pipeline.parse_launch(line)
        assert baseline_point(p, tune_space(p))["shard"] == "dpxtp:2x4"
        assert jax_tuner.baseline_point(
            jp, jax_tuner.tune_space(jp))["shard"] == "dpxtp:2x4"


# --- the loop knobs (tests/test_steady_loop.py's tuner cases) -------------

class TestLoopKnobs:
    LINE = ("appsrc caps=" + CAPS_F32 + " ! tensor_filter name=f "
            "framework=jax model=add custom=k:1,aot:0 ! tensor_sink")

    def test_space_grows_loop_dims_when_eligible(self):
        dims, want = both_spaces(self.LINE)
        assert "loop_window" in dims and "launch_depth" in dims
        assert dims == want

    def test_space_omits_loop_dims_when_blocked(self):
        dims, want = both_spaces(self.LINE.replace(
            "custom=k:1,aot:0", "custom=k:1,aot:0 sync=true"))
        assert "loop_window" not in dims and "launch_depth" not in dims
        assert dims == want

    def test_objective_credits_dispatch_amortization(self):
        rep = tune_report(self.LINE, measure=False)

        def fps(loopw):
            for e in rep["points"]:
                c = e["config"]
                if (c.get("loop_window") == loopw
                        and c.get("launch_depth") == 1
                        and c["batch_size"] == 1 and c["feed_depth"] == 1
                        and c["fetch_window"] == 1 and not c.get("donate")
                        and c.get("shard", "off") == "off"):
                    return e["predicted"]["modeled_fps"]
            return None

        assert fps(8) > fps(1) * 4

    def test_over_budget_loop_arm_pruned_before_compile(self, monkeypatch):
        # fits the solo program (on the card: the output and the 0-d k
        # in a 512-byte block each, and the 32 B input) but never a
        # window's ring beside its graph pool (from 2.5 KiB up)
        monkeypatch.setenv("NNSTPU_HBM_BYTES", "2000")
        rep = tune_report(self.LINE, measure=False)
        on = [e for e in rep["points"]
              if e["config"].get("loop_window", 1) != 1
              and e["config"]["batch_size"] == 1]
        off = [e for e in rep["points"]
               if e["config"].get("loop_window", 1) == 1]
        assert on and all(e["status"] == "pruned"
                          and e["code"] in ("NNST462", "NNST700")
                          for e in on), [
            (e["config"], e.get("code")) for e in on if
            e["status"] != "pruned"][:3]
        assert any(e["status"] != "pruned" for e in off)

    def test_baseline_reads_loop_props(self):
        line = self.LINE.replace(
            "custom=k:1,aot:0", "custom=k:1,aot:0 loop-window=8 "
            "launch-depth=2")
        p, jp = parse_launch(line), jax_pipeline.parse_launch(line)
        base = baseline_point(p, tune_space(p))
        assert base["loop_window"] == 8 and base["launch_depth"] == 2
        assert base == jax_tuner.baseline_point(jp, jax_tuner.tune_space(jp))

    def test_report_deterministic(self):
        a = tune_report(self.LINE, measure=False)
        b = tune_report(self.LINE, measure=False)
        assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
