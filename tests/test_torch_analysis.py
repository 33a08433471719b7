"""The static analyzer (nnlint) and its ``validate`` CLI through both
packages, on the CPU.

Every case of the reference's tests/test_analysis.py but the runtime
sanitizer's (tests/test_torch_sanitizer.py), ``doctor --lint`` through
each package's own ``tools/doctor.py``, and the
two ``TestResidencyLint`` cases of its tests/test_residency.py, run
through ``nnstreamer_tpu`` and ``nnstreamer_tpu_torch``: the same pipeline
goes to each package's ``analyze``/``analyze_launch``, and each must give
the case's stable code on the named element; the static-vs-tracer crossing
parity cases play the line in each package (the port's filters with
``accelerator=true:cpu``).

Then every line of ``examples/launch_lines.txt``,
``launch_lines_chains.txt`` and ``launch_lines_loop.txt`` through both
analyzers: equal codes, and every line's ``EXPECT`` code in the port.
Where the reference shows its jax fault (the composition and the loop's
memory plan cannot walk a jaxpr under this jax, so NNST450/452 become
NNST451 and NNST462 becomes NNST460), the port is held to the line's
``EXPECT`` alone. The same for ``launch_lines_ctl.txt`` and
``launch_lines_fleet.txt``, where the reference's fault hides NNST950/951
(its cost model raises, so the controller pass has no plant seed) and the
codes of passes the port does not have yet are left out, each with its
reason. Last, the port's ``validate`` exit codes under ``--strict`` on the
chains file (fails) and on its NNST450 line alone (clean), and on the ctl
file; and the mesh, pool and thread-topology files (``launch_lines_shard``,
``_pool``, ``_threads``) on 8 devices in both packages (the port's
``NNSTPU_TORCH_DEVICES=cpu*8``): every EXPECT code in the port, the
reference's codes where its jax fault does not rewrite them, each file
failing ``--strict`` and its eligible line strict-clean, and the
over-budget shard line's per-device row over distinct and repeated
devices.
"""

import os
import re
import sys

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import nnstreamer_tpu.analysis  # noqa: E402
import nnstreamer_tpu.analysis.plant  # noqa: E402
import nnstreamer_tpu.analysis.residency  # noqa: E402
import nnstreamer_tpu.buffer  # noqa: E402
import nnstreamer_tpu.elements.basic  # noqa: E402
import nnstreamer_tpu.pipeline  # noqa: E402
import nnstreamer_tpu.pipeline.element  # noqa: E402
import nnstreamer_tpu.pipeline.pipeline  # noqa: E402
import nnstreamer_tpu.tools.validate  # noqa: E402
import nnstreamer_tpu.trace  # noqa: E402
import nnstreamer_tpu_torch.analysis  # noqa: E402
import nnstreamer_tpu_torch.analysis.memplan  # noqa: E402
import nnstreamer_tpu_torch.analysis.plant  # noqa: E402
import nnstreamer_tpu_torch.analysis.residency  # noqa: E402
import nnstreamer_tpu_torch.buffer  # noqa: E402
import nnstreamer_tpu_torch.elements.basic  # noqa: E402
import nnstreamer_tpu_torch.pipeline  # noqa: E402
import nnstreamer_tpu_torch.pipeline.element  # noqa: E402
import nnstreamer_tpu_torch.pipeline.pipeline  # noqa: E402
import nnstreamer_tpu_torch.tools.validate  # noqa: E402
import nnstreamer_tpu_torch.trace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPS_F32 = ("other/tensors,num-tensors=1,dimensions=4:2,types=float32,"
            "framerate=0/1")
CAPS_U8 = ("other/tensors,num-tensors=1,dimensions=4:2,types=uint8,"
           "framerate=0/1")


class Pkg:
    """One package's analyzer, pipeline and tracer under one set of
    names."""

    def __init__(self, name):
        mod = sys.modules
        self.name = name
        self.port = name == "nnstreamer_tpu_torch"
        an = mod[f"{name}.analysis"]
        self.analyze, self.analyze_launch = an.analyze, an.analyze_launch
        res = mod[f"{name}.analysis.residency"]
        self.predict_crossings = res.predict_crossings
        self.parity_mismatches = res.parity_mismatches
        self.parse_launch = mod[f"{name}.pipeline"].parse_launch
        self.Pipeline = mod[f"{name}.pipeline.pipeline"].Pipeline
        self.make = mod[f"{name}.pipeline.element"].element_factory_make
        self.Tee = mod[f"{name}.elements.basic"].Tee
        self.Buffer = mod[f"{name}.buffer"].Buffer
        self.trace = mod[f"{name}.trace"]
        self.validate = mod[f"{name}.tools.validate"]
        #: the filter properties that run the package's backend on the CPU
        self.cpu = "accelerator=true:cpu" if self.port else ""

    def filt(self, extra=""):
        return (f"tensor_filter framework=jax model=add custom=k:1,aot:0 "
                f"{self.cpu} {extra}").rstrip()


JAX = Pkg("nnstreamer_tpu")
PORT = Pkg("nnstreamer_tpu_torch")


@pytest.fixture(scope="module", autouse=True)
def _equal_name_counters():
    """Each package names an unnamed element from its own counter
    (``queue7``). This module builds more pipelines in one package than in
    the other, so at its end it empties both counters: the cross-package
    tests of a later file in the same process compare those names."""
    yield
    for name in ("nnstreamer_tpu", "nnstreamer_tpu_torch"):
        sys.modules[f"{name}.pipeline.element"].Element._name_counters.clear()


@pytest.fixture(params=[JAX, PORT], ids=["jax", "port"])
def pkg(request):
    return request.param


def codes(diags):
    return {d.code for d in diags}


def by_code(diags, code):
    return [d for d in diags if d.code == code]


class TestGraphCodes:
    def test_nnst000_empty_pipeline(self, pkg):
        assert "NNST000" in codes(pkg.analyze(pkg.Pipeline("empty")))

    def test_nnst001_dangling_sink_pad(self, pkg):
        p = pkg.parse_launch(f"appsrc caps={CAPS_F32} ! tensor_sink")
        p.add(pkg.make("tensor_transform", "orphan"))
        d = by_code(pkg.analyze(p), "NNST001")
        assert d and d[0].element == "orphan" and d[0].severity == "error"

    def test_nnst002_dangling_src_warning(self, pkg):
        diags = pkg.analyze_launch(
            f"appsrc caps={CAPS_F32} ! tensor_sink  "
            "videotestsrc name=b num-buffers=1")
        d = by_code(diags, "NNST002")
        assert d and d[0].element == "b" and d[0].severity == "warning"

    def test_nnst002_tee_exemption_is_declared_not_hardcoded(self, pkg):
        class MyTee(pkg.Tee):
            ELEMENT_NAME = "my_tee"

        p = pkg.parse_launch(f"appsrc name=s caps={CAPS_F32} ! tensor_sink")
        t = MyTee("t2")
        t.request_pad("src_0")
        p.add(t)
        p.elements["s"].src_pads[0].unlink()
        assert not [d for d in by_code(pkg.analyze(p), "NNST002")
                    if d.element == "t2"]

    def test_nnst003_no_sources(self, pkg):
        p = pkg.Pipeline("nosrc")
        a = pkg.make("tensor_transform", "a")
        b = pkg.make("tensor_sink", "b")
        p.add(a, b)
        p.link(a, b)
        assert "NNST003" in codes(pkg.analyze(p))

    def test_nnst004_unreachable(self, pkg):
        diags = pkg.analyze_launch(
            f"appsrc caps={CAPS_F32} ! tensor_sink  "
            "identity name=island ! tensor_sink name=is2")
        assert any(d.element == "island" for d in by_code(diags, "NNST004"))

    def test_nnst005_cycle(self, pkg):
        p = pkg.Pipeline("loop")
        a = pkg.make("identity", "a")
        b = pkg.make("identity", "b")
        p.add(a, b)
        a.src_pads[0].link(b.sink_pads[0])
        b.src_pads[0].link(a.sink_pads[0])
        assert "NNST005" in codes(pkg.analyze(p))


class TestPropertyCodes:
    def test_nnst100_unknown_property_with_hint_and_span(self, pkg):
        src = (f"appsrc caps={CAPS_F32} ! {pkg.filt()} feed-dept=2 "
               "! tensor_sink")
        d = by_code(pkg.analyze_launch(src), "NNST100")
        assert d and d[0].severity == "warning"
        assert "feed-depth" in (d[0].hint or "")
        a, b = d[0].span
        assert src[a:b] == "feed-dept=2"

    def test_nnst101_mistyped_value(self, pkg):
        assert by_code(pkg.analyze_launch(
            f"appsrc caps={CAPS_F32} ! queue max-size-buffers=lots "
            "! tensor_sink"), "NNST101")

    def test_nnst102_invalid_enum(self, pkg):
        d = by_code(pkg.analyze_launch(
            f"appsrc caps={CAPS_F32} ! queue leaky=sideways ! tensor_sink"),
            "NNST102")
        assert d and "downstream" in d[0].message

    def test_nnst103_bad_on_error_grammar(self, pkg):
        diags = pkg.analyze_launch(
            f"appsrc caps={CAPS_F32} ! identity on-error=retyr:3 "
            "! tensor_sink")
        assert {"NNST103", "NNST106"} <= codes(diags)

    def test_nnst104_missing_required(self, pkg):
        d = by_code(pkg.analyze_launch(
            f"appsrc caps={CAPS_F32} ! tensor_decoder ! tensor_sink"),
            "NNST104")
        assert d and "mode" in d[0].message and d[0].severity == "error"

    def test_nnst105_unknown_decoder_mode(self, pkg):
        assert by_code(pkg.analyze_launch(
            f"appsrc caps={CAPS_F32} ! tensor_decoder mode=bogus_mode "
            "! tensor_sink"), "NNST105")

    def test_nnst106_construction_failure(self, pkg):
        assert "NNST106" in codes(pkg.analyze_launch(
            f"appsrc caps={CAPS_F32} ! tensor_split ! tensor_sink"))

    def test_nnst107_unknown_element_with_hint(self, pkg):
        d = by_code(pkg.analyze_launch("appsrc ! tensor_fliter ! tensor_sink"),
                    "NNST107")
        assert d and "tensor_filter" in (d[0].hint or "")

    def test_strict_parse_raises(self, pkg):
        with pytest.raises(ValueError, match="NNST100"):
            pkg.parse_launch(f"appsrc caps={CAPS_F32} ! {pkg.filt()} "
                             "feed-dept=2 ! tensor_sink", strict=True)

    def test_boolean_looking_enum_literal_is_valid(self, pkg):
        assert not by_code(pkg.analyze_launch(
            f"appsrc caps={CAPS_F32} ! queue leaky=no ! tensor_sink"),
            "NNST102")

    def test_property_diagnostic_not_duplicated(self, pkg):
        diags = pkg.analyze_launch(
            f"appsrc caps={CAPS_F32} ! {pkg.filt()} feed-dept=2 "
            "! tensor_sink")
        assert len(by_code(diags, "NNST100")) == 1


class TestNegotiationCodes:
    def test_nnst200_template_rejects_caps(self, pkg):
        d = by_code(pkg.analyze_launch(
            "appsrc caps=video/x-raw,format=RGB,width=8,height=8,"
            "framerate=30/1 ! tensor_transform mode=typecast option=uint8 "
            "! tensor_sink"), "NNST200")
        assert d and d[0].severity == "error"

    def test_nnst201_bad_option_grammar_fails_negotiation(self, pkg):
        d = by_code(pkg.analyze_launch(
            f"appsrc caps={CAPS_F32} ! tensor_transform name=tp "
            "mode=transpose option=bogus ! tensor_sink"), "NNST201")
        assert d and d[0].element == "tp"

    def test_nnst202_filter_model_unknown_is_info_not_error(self, pkg):
        diags = pkg.analyze_launch(
            f"appsrc caps={CAPS_F32} ! {pkg.filt()} ! tensor_sink")
        d = by_code(diags, "NNST202")
        assert d and d[0].severity == "info"
        assert "NNST201" not in codes(diags)

    def test_nnst203_declared_input_mismatch(self, pkg):
        d = by_code(pkg.analyze_launch(
            f"appsrc caps={CAPS_F32} ! tensor_filter name=f framework=jax "
            "model=add input=3:3 inputtype=uint8 ! tensor_sink"), "NNST203")
        assert d and d[0].element == "f" and d[0].severity == "error"

    def test_nnst204_merge_dtype_disagreement(self, pkg):
        d = by_code(pkg.analyze_launch(
            "tensor_merge name=m ! tensor_sink  "
            f"appsrc name=a caps={CAPS_F32} ! m.sink_0  "
            f"appsrc name=b caps={CAPS_U8} ! m.sink_1"), "NNST204")
        assert d and d[0].element == "m"

    def test_declared_output_lints_downstream(self, pkg):
        diags = pkg.analyze_launch(
            f"appsrc caps={CAPS_F32} ! tensor_filter framework=jax "
            "model=add output=4:2 outputtype=float32 "
            "! tensor_transform name=bad mode=transpose option=zz "
            "! tensor_sink")
        assert any(d.element == "bad" for d in by_code(diags, "NNST201"))


class TestResidencyCodes:
    def test_nnst300_avoidable_host_hop(self, pkg):
        d = by_code(pkg.analyze_launch(
            f"appsrc caps={CAPS_F32} ! tensor_filter name=f1 framework=jax "
            "model=add ! tensor_transform name=hop mode=stand "
            "! tensor_filter name=f2 framework=jax model=add "
            "! tensor_sink"), "NNST300")
        assert d and d[0].element == "hop"

    def test_nnst301_predicted_crossings_reported(self, pkg):
        d = by_code(pkg.analyze_launch(
            f"appsrc caps={CAPS_F32} ! {pkg.filt()} ! tensor_sink"),
            "NNST301")
        assert d and "h2d=1" in d[0].message and "d2h=1" in d[0].message


class TestFusionCodes:
    def test_nnst400_shared_key_refuses_fusion(self, pkg):
        assert by_code(pkg.analyze_launch(
            f"appsrc caps={CAPS_U8} ! tensor_transform mode=arithmetic "
            "option=typecast:float32,mul:2 ! tensor_filter framework=jax "
            "model=add shared-tensor-filter-key=k1 ! tensor_sink"),
            "NNST400")

    def test_nnst401_sync_ahead_of_device_consumer(self, pkg):
        d = by_code(pkg.analyze_launch(
            f"appsrc caps={CAPS_F32} ! tensor_filter name=f1 framework=jax "
            "model=add sync=1 ! tensor_filter name=f2 framework=jax "
            "model=add ! tensor_sink"), "NNST401")
        assert d and d[0].element == "f1"

    def test_nnst402_transform_between_two_filters(self, pkg):
        d = by_code(pkg.analyze_launch(
            f"appsrc caps={CAPS_F32} ! tensor_filter framework=jax "
            "model=add ! tensor_transform name=mid mode=typecast "
            "option=float32 ! tensor_filter framework=jax model=add "
            "! tensor_sink"), "NNST402")
        assert d and d[0].element == "mid"

    def test_nnst403_combination_inhibits_fusion(self, pkg):
        assert by_code(pkg.analyze_launch(
            f"appsrc caps={CAPS_U8} ! tensor_transform mode=arithmetic "
            "option=typecast:float32,mul:2 ! tensor_filter framework=jax "
            "model=add invoke-dynamic=1 ! tensor_sink"), "NNST403")


class TestDeadlockCodes:
    def test_nnst500_unbalanced_drop_diamond(self, pkg):
        d = by_code(pkg.analyze_launch(
            f"appsrc caps={CAPS_F32} ! tee name=t  "
            "t. ! tensor_rate framerate=5/1 ! m.sink_0  "
            "t. ! m.sink_1  tensor_mux name=m ! tensor_sink"), "NNST500")
        assert d and d[0].element == "m"

    def test_nnst501_unequal_finite_sources(self, pkg):
        assert by_code(pkg.analyze_launch(
            "videotestsrc num-buffers=2 ! tensor_converter ! m.sink_0  "
            "videotestsrc num-buffers=5 ! tensor_converter ! m.sink_1  "
            "tensor_mux name=m ! tensor_sink"), "NNST501")

    def test_nnst502_basepad_driver_drops(self, pkg):
        d = by_code(pkg.analyze_launch(
            f"appsrc name=a caps={CAPS_F32} ! tensor_rate framerate=5/1 "
            "! m.sink_0  "
            f"appsrc name=b caps={CAPS_F32} ! m.sink_1  "
            "tensor_mux name=m sync-mode=basepad ! tensor_sink"), "NNST502")
        assert d and d[0].element == "m"

    def test_nnst503_unbounded_queue(self, pkg):
        assert by_code(pkg.analyze_launch(
            f"appsrc caps={CAPS_F32} ! queue max-size-buffers=0 "
            "! tensor_sink"), "NNST503")

    def test_balanced_diamond_is_clean(self, pkg):
        assert not by_code(pkg.analyze_launch(
            f"appsrc caps={CAPS_F32} ! tee name=t  "
            "t. ! queue ! m.sink_0  t. ! queue ! m.sink_1  "
            "tensor_mux name=m ! tensor_sink"), "NNST500")


# --- static prediction vs runtime tracer parity ----------------------------

def run_and_compare(pkg, launch, n, dtype=np.float32, chain_fusion=None):
    p = pkg.parse_launch(launch)
    if chain_fusion is not None:
        p.chain_fusion = chain_fusion
    tracer = pkg.trace.attach(p)
    p.play()
    pred = pkg.predict_crossings(p, n_buffers=n)
    assert not pred["unmodeled"], pred
    for i in range(n):
        p["src"].push_buffer(pkg.Buffer(tensors=[np.full((4, 2), i + 1,
                                                         dtype)]))
    p["src"].end_of_stream()
    assert p.bus.wait_eos(30)
    assert p.bus.error is None, p.bus.error
    seen = tracer.crossings()
    p.stop()
    mism = pkg.parity_mismatches(pred, seen)
    assert not mism, f"{launch}\npredicted={pred}\ntraced={seen}\n{mism}"
    return pred


def named(pkg, name="f"):
    return pkg.filt().replace("tensor_filter", f"tensor_filter name={name}")


class TestStaticVsTracerParity:
    def test_flagship_chain(self, pkg):
        pred = run_and_compare(
            pkg, f"appsrc name=src caps={CAPS_U8} ! tensor_transform "
            "mode=arithmetic option=typecast:float32,mul:2 "
            f"! {named(pkg)} ! queue ! tensor_sink name=out", n=3,
            dtype=np.uint8)
        assert pred["per_element"]["f"] == {"h2d": 3, "d2h": 3}

    def test_batch_and_fetch_window(self, pkg):
        pred = run_and_compare(
            pkg, f"appsrc name=src caps={CAPS_F32} ! {named(pkg)} "
            "batch-size=2 fetch-window=2 ! tensor_sink name=out", n=4)
        assert pred["per_element"]["f"] == {"h2d": 2, "d2h": 1}

    def test_filter_to_filter_device_lane(self, pkg):
        pred = run_and_compare(
            pkg, f"appsrc name=src caps={CAPS_F32} ! {named(pkg, 'f1')} "
            f"! {named(pkg, 'f2')} ! tensor_sink name=out", n=2,
            chain_fusion="off")
        assert pred["per_element"]["f1"] == {"h2d": 2, "d2h": 0}
        assert pred["per_element"]["f2"] == {"h2d": 0, "d2h": 2}

    def test_filter_to_filter_fused_chain(self):
        """The same line fused (the port alone: the reference cannot fuse
        under this jax): the shell bills nothing, the predictor agrees with
        the tracer, and one fetch lands past the shell."""
        pred = run_and_compare(
            PORT, f"appsrc name=src caps={CAPS_F32} ! {named(PORT, 'f1')} "
            f"! {named(PORT, 'f2')} ! tensor_sink name=out", n=2)
        assert pred["per_element"]["f1"] == {"h2d": 2, "d2h": 0}
        assert "f2" not in pred["per_element"] \
            or pred["per_element"]["f2"] == {"h2d": 0, "d2h": 0}
        assert pred["d2h"] == 2

    def test_sync_materializes_at_filter(self, pkg):
        pred = run_and_compare(
            pkg, f"appsrc name=src caps={CAPS_F32} ! {named(pkg)} sync=1 "
            "! tensor_sink name=out", n=2)
        assert pred["per_element"]["f"]["d2h"] == 2

    def test_tee_fanout_single_boundary(self, pkg):
        pred = run_and_compare(
            pkg, f"appsrc name=src caps={CAPS_F32} ! {named(pkg)} "
            "! tee name=t  t. ! queue ! tensor_sink name=a  "
            "t. ! queue ! tensor_sink name=b", n=2)
        assert pred["per_element"]["f"] == {"h2d": 2, "d2h": 2}

    def test_upload_window_feed_depth(self, pkg):
        pred = run_and_compare(
            pkg, f"appsrc name=src caps={CAPS_F32} ! {named(pkg)} "
            "feed-depth=2 ! tensor_sink name=out", n=3)
        assert pred["per_element"]["f"] == {"h2d": 3, "d2h": 3}


class TestCLI:
    def test_exit_codes_clean_warning_error(self, pkg):
        main = pkg.validate.main
        clean = f"appsrc caps={CAPS_F32} ! tensor_sink"
        warn = (f"appsrc caps={CAPS_F32} ! {pkg.filt()} feed-dept=2 "
                "! tensor_sink")
        err = f"appsrc caps={CAPS_F32} ! tensor_decoder ! tensor_sink"
        assert main([clean]) == 0
        assert main([warn]) == 1
        assert main(["--strict", warn]) == 2
        assert main([err]) == 2

    def test_file_mode(self, pkg, tmp_path):
        f = tmp_path / "lines.txt"
        f.write_text("# comment\n"
                     f"appsrc caps={CAPS_F32} ! tensor_sink\n")
        assert pkg.validate.main(["--strict", "--file", str(f)]) == 0

    def test_examples_lint_clean_in_strict_mode(self, pkg):
        path = os.path.join(ROOT, "examples", "launch_lines.txt")
        assert pkg.validate.main(["--strict", "--file", path]) == 0

    def test_json_mode(self, pkg, capsys):
        """``--json``: one document, the same codes and exit codes as the
        text report."""
        import json

        warn = (f"appsrc caps={CAPS_F32} ! {pkg.filt()} feed-dept=2 "
                "! tensor_sink")
        assert pkg.validate.main(["--json", "--strict", warn]) == 2
        doc = json.loads(capsys.readouterr().out)
        assert doc["exit"] == 2 and len(doc["results"]) == 1
        assert "NNST100" in {d["code"] for d in
                             doc["results"][0]["diagnostics"]}

    def test_legacy_validate_api_shape(self, pkg):
        issues = pkg.validate.validate(pkg.parse_launch(
            f"appsrc caps={CAPS_F32} ! tensor_sink"))
        assert issues == [] or all(len(i) == 3 for i in issues)


class TestResidencyLint:
    """The two ``TestResidencyLint`` cases of the reference's
    tests/test_residency.py, through each package's ``validate``."""

    def test_validator_warns_on_avoidable_host_hop(self, pkg):
        issues = pkg.validate.validate(pkg.parse_launch(
            f"appsrc name=src caps={CAPS_F32} "
            "! tensor_filter name=f1 framework=jax model=add "
            "! tensor_transform name=hop mode=stand "
            "! tensor_filter name=f2 framework=jax model=add "
            "! tensor_sink name=out"))
        msgs = [m for sev, el, m in issues if "avoidable host crossing" in m]
        assert msgs, issues
        assert "hop" in msgs[0]

    def test_no_warning_on_clean_device_chain(self, pkg):
        issues = pkg.validate.validate(pkg.parse_launch(
            f"appsrc name=src caps={CAPS_F32} "
            "! tensor_filter name=f1 framework=jax model=add "
            "! queue ! tensor_filter name=f2 framework=jax model=add "
            "! tensor_sink name=out"))
        assert not [m for _, _, m in issues
                    if "avoidable host crossing" in m], issues


# --- the fixture files through both analyzers ------------------------------

def fixture_lines(name):
    """(line number, launch line, EXPECT code or None) of one fixture."""
    out, expect = [], None
    with open(os.path.join(ROOT, "examples", name)) as f:
        for i, raw in enumerate(f, 1):
            line = raw.strip()
            m = re.match(r"#\s*EXPECT:\s*(NNST\d+)", line)
            if m:
                expect = m.group(1)
            elif line and not line.startswith("#"):
                out.append((i, line, expect))
                expect = None
    return out


FIXTURES = [(name, i, line, expect)
            for name in ("launch_lines.txt", "launch_lines_chains.txt",
                         "launch_lines_loop.txt")
            for i, line, expect in fixture_lines(name)]

#: the controller verdicts that need the cost model's plant seed
CTL_MODEL_CODES = ("NNST950", "NNST951")

#: the serving controller's and the fleet client's fixture files
SERVING_FIXTURES = [(name, i, line, expect)
                    for name in ("launch_lines_ctl.txt",
                                 "launch_lines_fleet.txt")
                    for i, line, expect in fixture_lines(name)]


@pytest.mark.parametrize("name,lineno,line,expect",
                         FIXTURES + SERVING_FIXTURES,
                         ids=[f"{n}:{i}" for n, i, _, _ in
                              FIXTURES + SERVING_FIXTURES])
def test_fixture_codes_match_reference(name, lineno, line, expect):
    diags = PORT.analyze_launch(line)
    got = sorted(d.code for d in diags)
    if expect is not None:
        assert expect in got, (expect, got)
    ref = JAX.analyze_launch(line)
    want = sorted(d.code for d in ref)
    if expect is not None and expect not in want:
        # the reference's jax fault rewrote its verdict: the port gives
        # the EXPECT code alone in that family (NNST45x or NNST46x), and
        # every other code agrees
        family = expect[:6]
        assert [c for c in got if c.startswith(family)] == [expect], got
        got = [c for c in got if not c.startswith(family)]
        want = [c for c in want if not c.startswith(family)]
    if (name, lineno, line, expect) in SERVING_FIXTURES:
        # the same fault hides every model-backed controller verdict, also
        # on a line whose EXPECT is another code
        got = [c for c in got if c not in CTL_MODEL_CODES]
    assert got == want, (got, want)


def test_reference_faults_where_expected():
    """The reference's jax fault shows on exactly the chain lines the
    notes name (NNST450 and NNST452) and the loop line NNST462 — the only
    lines the port is held to EXPECT alone."""
    faulted = []
    for name, i, line, expect in FIXTURES:
        if expect is None:
            continue
        ref = [d.code for d in JAX.analyze_launch(line)]
        if expect not in ref:
            faulted.append((name, expect))
    assert sorted(faulted) == [("launch_lines_chains.txt", "NNST450"),
                               ("launch_lines_chains.txt", "NNST452"),
                               ("launch_lines_loop.txt", "NNST462")]


def test_reference_fault_hides_ctl_verdicts():
    """On the ctl and fleet files the reference's jax fault hides exactly
    the model-backed controller verdicts, NNST950 and NNST951: its
    ``static_report`` raises inside ``program_cost``, so its
    ``serving_launch_model`` gives no plant seed, while the port's gives
    one and the line's EXPECT code."""
    jplant = sys.modules["nnstreamer_tpu.analysis.plant"]
    faulted = []
    for name, i, line, expect in SERVING_FIXTURES:
        ref = [d.code for d in JAX.analyze_launch(line)]
        assert not set(ref) & set(CTL_MODEL_CODES), ref
        if expect is None:
            continue
        if expect not in ref:
            faulted.append((name, expect))
            ports = [e for e in PORT.parse_launch(line).elements.values()
                     if e.ELEMENT_NAME == "tensor_query_serversrc"]
            seed = sys.modules["nnstreamer_tpu_torch.analysis.plant"] \
                .serving_launch_model(ports[0].pipeline, ports[0])
            assert seed is not None and seed["row_device_ms"] >= 0, seed
            jp = JAX.parse_launch(line)
            src = [e for e in jp.elements.values()
                   if e.ELEMENT_NAME == "tensor_query_serversrc"][0]
            assert jplant.serving_launch_model(jp, src) is None
    assert sorted(faulted) == [("launch_lines_ctl.txt", "NNST950"),
                               ("launch_lines_ctl.txt", "NNST951")]


def test_doctor_lint(pkg):
    import importlib

    main = importlib.import_module(f"{pkg.name}.tools.doctor").main
    assert main(["--lint", f"appsrc caps={CAPS_F32} ! tensor_sink"]) == 0
    assert main(["--lint", "--strict",
                 f"appsrc caps={CAPS_F32} ! {pkg.filt()} feed-dept=2 "
                 "! tensor_sink"]) == 2


@pytest.mark.parametrize("name", ["launch_lines_ctl.txt",
                                  "launch_lines_fleet.txt"])
def test_validate_strict_on_serving_files(name):
    """Each file fails ``--strict``; its one CLEAN line is strict-clean."""
    path = os.path.join(ROOT, "examples", name)
    assert PORT.validate.main(["--strict", "--file", path]) == 2
    with open(path) as f:
        text = f.read()
    clean = re.search(r"# CLEAN\n([^#\n][^\n]*)", text).group(1)
    assert PORT.validate.main(["--strict", clean]) == 0


def test_validate_strict_on_chains_file():
    path = os.path.join(ROOT, "examples", "launch_lines_chains.txt")
    assert PORT.validate.main(["--strict", "--file", path]) == 2
    fusable = [line for _, line, expect in
               fixture_lines("launch_lines_chains.txt")
               if expect == "NNST450"]
    assert len(fusable) == 1
    assert PORT.validate.main(["--strict", fusable[0]]) == 0


# --- the mesh, pool and thread-topology fixture files ----------------------

#: the files of the mesh (NNST47x), replica-pool (NNST96x) and
#: thread-topology (NNST62x) passes; the first two are linted with the cost
#: passes (their ``# ANALYZE: cost``), on 8 devices in both packages
MESH_FIXTURES = ("launch_lines_shard.txt", "launch_lines_pool.txt",
                 "launch_lines_threads.txt")


def fixture_expects(name):
    """(line number, launch line, every EXPECT code) of one fixture."""
    out, expect = [], []
    with open(os.path.join(ROOT, "examples", name)) as f:
        for i, raw in enumerate(f, 1):
            line = raw.strip()
            m = re.match(r"#\s*EXPECT:\s*(\S+)", line)
            if m:
                expect = m.group(1).split(",")
            elif line and not line.startswith("#"):
                out.append((i, line, expect))
                expect = []
    return out


@pytest.fixture
def eight_devices(monkeypatch):
    """The port's counterpart of the conftest's 8 virtual devices."""
    monkeypatch.setenv("NNSTPU_TORCH_DEVICES", "cpu*8")


@pytest.mark.parametrize(
    "name,lineno,line,expect",
    [(n, i, line, e) for n in MESH_FIXTURES
     for i, line, e in fixture_expects(n)],
    ids=[f"{n}:{i}" for n in MESH_FIXTURES for i, _, _ in
         fixture_expects(n)])
def test_mesh_and_pool_fixture_codes_match_reference(
        eight_devices, name, lineno, line, expect):
    """Every EXPECT code of the line in the port, and the reference's code
    list where the reference passes. Its jax fault (the cost model raises
    in ``program_cost``) leaves it no NNST70x verdict, and its pool probe,
    with no plan, licenses (NNST960) the pool the line's budget refuses
    (NNST962): those two families are the line's EXPECT alone in the
    port."""
    cost = name != "launch_lines_threads.txt"
    got = sorted(d.code for d in PORT.analyze_launch(line, cost=cost))
    for code in expect:
        assert code in got, (code, got)
    want = sorted(d.code for d in JAX.analyze_launch(line, cost=cost))
    assert not [c for c in want if c.startswith("NNST70")], want
    got = [c for c in got if not c.startswith("NNST70")]
    if "NNST962" in expect:
        assert "NNST960" in want and "NNST962" not in want
        want = [c for c in want if c != "NNST960"]
        got = [c for c in got if c != "NNST962"]
    assert got == want, (got, want)


@pytest.mark.parametrize("name,eligible", [
    ("launch_lines_shard.txt", "NNST470"),
    ("launch_lines_pool.txt", "NNST960"),
    ("launch_lines_threads.txt", "NNST620")])
def test_validate_strict_on_mesh_and_pool_files(eight_devices, name,
                                                eligible):
    """What the reference's ``nnshard``/``nnpool``/``nnsan-c`` steps of
    ci.sh assert, through the port's CLI on 8 devices: the file fails
    ``--strict`` (with ``--cost`` where the file asks for it) and its one
    eligible line alone is strict-clean."""
    path = os.path.join(ROOT, "examples", name)
    cost = ["--cost"] if name != "launch_lines_threads.txt" else []
    assert PORT.validate.main(["--strict", *cost, "--file", path]) == 2
    lines = [line for _, line, e in fixture_expects(name)
             if e == [eligible]]
    assert len(lines) == 1
    assert PORT.validate.main(["--strict", *cost, lines[0]]) == 0


def test_repeated_device_row_of_the_over_budget_shard_line(monkeypatch):
    """The shard file's over-budget line planned over eight distinct
    devices and over one device repeated eight times: each distinct
    device holds one position's share, the repeated one all eight — the
    sum the distinct devices hold together."""
    line = [line for _, line, e in fixture_expects("launch_lines_shard.txt")
            if e == ["NNST700"]][0]
    plan_memory = sys.modules["nnstreamer_tpu_torch.analysis.memplan"] \
        .plan_memory
    monkeypatch.setenv("NNSTPU_TORCH_DEVICES",
                       ",".join(f"cuda:{i}" for i in range(8)))
    distinct = plan_memory(PORT.parse_launch(line))
    monkeypatch.setenv("NNSTPU_TORCH_DEVICES", "cuda:0*8")
    one = plan_memory(PORT.parse_launch(line))
    assert len(distinct["per_device_bytes"]) == 8
    assert one["per_device_bytes"] == {"cuda:0": one["total_bytes"]}
    assert one["total_bytes"] == distinct["aggregate_bytes"]
    assert distinct["total_bytes"] * 8 == distinct["aggregate_bytes"]
