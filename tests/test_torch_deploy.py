"""nndeploy (NNST99x, ``analysis/deploy.py``, ``edge/wiring.py``,
``validate --deploy``) through the port, on the CPU, against the JAX
package.

Every case of the reference's tests/test_deploy.py, restated for the port
on the same examples/fleet fixtures (codes, severities, member and element
attribution, ``<spec>:<line>`` spans, zero-compile, spec-origin threading,
registration-order independence, the ``--json`` exit contract, the inert
unused pass), and per fixture the codes against the JAX package's
analyzer. Under this jax the reference's cost model raises inside
``program_cost`` (ROADMAP queue 3 item 2), which takes three verdicts out
of its runs and fails three of its cases; the port is held to the
fixture's annotation there:

- ``slo_infeasible.deploy``: the reference gives no NNST993 (no plant
  seed without the cost model), the port gives the annotated NNST993
  (``TestCapacity993``: both cases fail in the reference);
- ``hbm_overcommit.deploy``: the reference gives no NNST994 (its memory
  plan needs the cost model), the port gives the annotated NNST994
  (``TestPacking994::test_co_resident_overcommit_with_repack_hint`` fails
  in the reference);
- on every fixture the port's cost model adds its NNST701/702 rows,
  which the reference's cannot give.

Both packages' element-name counters are emptied at the module's end.
"""

import json
import os
import sys

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from nnstreamer_tpu.analysis.deploy import (  # noqa: E402
    analyze_deploy as jax_analyze_deploy,
)
from nnstreamer_tpu_torch.analysis import analyze_launch, exit_code  # noqa: E402
from nnstreamer_tpu_torch.analysis.deploy import (  # noqa: E402
    analyze_deploy,
    parse_deploy_text,
)
from nnstreamer_tpu_torch.analysis.diagnostics import CODES  # noqa: E402
from nnstreamer_tpu_torch.pipeline.element import State  # noqa: E402
from nnstreamer_tpu_torch.tools import validate as validate_tool  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _equal_name_counters():
    """Both packages name unnamed elements from their own counters; this
    module builds pipelines in both, so it empties both at its end."""
    yield
    for name in ("nnstreamer_tpu", "nnstreamer_tpu_torch"):
        sys.modules[f"{name}.pipeline.element"].Element._name_counters.clear()


FLEET_DIR = os.path.join(os.path.dirname(__file__), "..", "examples",
                         "fleet")


def spec_path(name: str) -> str:
    return os.path.normpath(os.path.join(FLEET_DIR, name))


def codes(diags):
    return [d.code for d in diags]


def by_code(diags, code):
    return [d for d in diags if d.code == code]


# --- the seven verdicts, one fixture each -----------------------------------


class TestSummary990:
    def test_clean_spec_emits_summary(self):
        path = spec_path("clean.deploy")
        diags, _ = analyze_deploy(path)
        hits = by_code(diags, "NNST990")
        assert len(hits) == 1
        d = hits[0]
        assert d.severity == "info"
        assert d.element == "fleet"
        assert d.path == path and d.line == 1
        # the summary names every member with its resolved role/device
        for frag in ("infer-a[server]@dev0", "infer-b[server]@dev1",
                     "camera[client]", "telemetry[server]",
                     "dashboard[client]"):
            assert frag in d.message
        assert "camera->infer-a (:9100)" in d.message
        assert "dashboard->telemetry (mqtt fleet/telemetry)" in d.message
        assert "offered-rps 50" in d.message and "slo-ms 500" in d.message

    def test_clean_spec_is_strict_clean_and_99x_free(self):
        diags, _ = analyze_deploy(spec_path("clean.deploy"))
        bad = [d.code for d in diags
               if d.code.startswith("NNST99") and d.code != "NNST990"]
        assert bad == []
        assert exit_code(diags, strict=True) == 0


class TestWiring991:
    def test_port_collision_topic_and_endpoint(self):
        path = spec_path("broken_wiring.deploy")
        diags, _ = analyze_deploy(path)
        hits = by_code(diags, "NNST991")
        assert all(d.severity == "error" for d in hits)
        msgs = {d.message.split(":")[0]: d for d in hits}
        col = next(d for d in hits if "port collision" in d.message)
        assert col.member == "infer-b" and col.element == "qs_b"
        assert col.path == path and col.line == 16
        # span cites the port= token inside the member's launch line
        a, b = col.span
        assert col.source[a:b] == "port=9200"
        dangle = next(d for d in hits
                      if "no member listening" in d.message)
        assert dangle.member == "camera" and dangle.element == "qc"
        assert dangle.line == 19
        a, b = dangle.span
        assert dangle.source[a:b] == "port=9999"
        mqtt = next(d for d in hits if "MQTT topic mismatch" in d.message)
        assert mqtt.member == "dashboard" and mqtt.element == "sub"
        assert mqtt.line == 22
        a, b = mqtt.span
        assert mqtt.source[a:b] == "topic=fleet/telemetry"
        assert msgs  # sanity: dict built

    def test_spec_errors_are_991(self):
        text = ("videotestsrc num-buffers=1 ! tensor_sink name=s\n"
                "device dev0 hbm=nonsense\n"
                "member lonely role=server\n")
        spec, diags = parse_deploy_text(text, "inline.spec")
        hits = by_code(diags, "NNST991")
        assert any("unparseable hbm=" in d.message for d in hits)
        assert any("launch line outside a member" in d.message
                   and d.line == 1 for d in hits)
        assert any("has no launch line" in d.message and d.line == 3
                   for d in hits)
        assert spec.members == []


class TestSignature992:
    def test_caps_mismatch_across_the_wire(self):
        path = spec_path("sig_mismatch.deploy")
        diags, _ = analyze_deploy(path)
        hits = by_code(diags, "NNST992")
        assert len(hits) == 1
        d = hits[0]
        assert d.severity == "error"
        assert d.member == "camera" and d.element == "qc"
        assert d.path == path and d.line == 15
        assert d.span is not None and d.source is not None
        assert "infer/qs" in d.message and ":9100" in d.message

    def test_matched_caps_stay_silent(self):
        diags, _ = analyze_deploy(spec_path("clean.deploy"))
        assert by_code(diags, "NNST992") == []


class TestCapacity993:
    def test_offered_load_exceeds_fleet_capacity(self):
        path = spec_path("slo_infeasible.deploy")
        diags, fleet = analyze_deploy(path)
        hits = by_code(diags, "NNST993")
        assert len(hits) == 1
        d = hits[0]
        assert d.severity == "error"
        assert d.element == "fleet"
        # attributed to the offered-rps directive line in the spec
        assert d.path == path and d.line == 11
        a, b = d.span
        assert d.source[a:b] == "offered-rps 100000"
        assert "infer=" in d.message and "x1 replica" in d.message
        assert "under slo-ms 50" in d.message
        # the priced capacity is recorded on the fleet for consumers
        assert 0 < fleet.capacities["infer"] < 100000

    def test_feasible_load_stays_silent(self):
        diags, fleet = analyze_deploy(spec_path("clean.deploy"))
        assert by_code(diags, "NNST993") == []
        # capacity was still priced (two serving members)
        assert set(fleet.capacities) == {"infer-a", "infer-b"}
        assert sum(fleet.capacities.values()) > 50


class TestPacking994:
    def test_co_resident_overcommit_with_repack_hint(self):
        path = spec_path("hbm_overcommit.deploy")
        diags, _ = analyze_deploy(path)
        hits = by_code(diags, "NNST994")
        assert len(hits) == 1
        d = hits[0]
        assert d.severity == "error"
        assert d.element == "dev0"
        assert d.member == "vision-b"  # the (tie-broken) biggest resident
        # attributed to the device declaration line
        assert d.path == path and d.line == 11
        a, b = d.span
        assert d.source[a:b] == "device dev0 hbm=16G"
        assert "vision-a=9216 MB" in d.message
        assert "vision-b=9216 MB" in d.message
        assert "16384 MB budget" in d.message
        assert "move vision-b (9216 MB) to device dev1" in d.hint

    def test_parity_with_per_member_plan_memory(self):
        from nnstreamer_tpu_torch.analysis.memplan import plan_memory
        from nnstreamer_tpu_torch.pipeline.parse import parse_launch

        _, fleet = analyze_deploy(spec_path("hbm_overcommit.deploy"))
        assert set(fleet.memplans) == {"vision-a", "vision-b"}
        for m in fleet.spec.members:
            solo = plan_memory(parse_launch(m.launch))
            assert fleet.memplans[m.name]["total_bytes"] == \
                solo["total_bytes"]

    def test_each_member_alone_fits(self):
        # the verdict is genuinely fleet-level: neither member trips the
        # per-pipeline NNST700 budget check on its own
        diags, _ = analyze_deploy(spec_path("hbm_overcommit.deploy"))
        assert by_code(diags, "NNST700") == []


class TestRollout995:
    def test_candidate_link_failure_and_ridless_hedge(self):
        path = spec_path("rollout_hazard.deploy")
        diags, _ = analyze_deploy(path)
        hits = by_code(diags, "NNST995")
        assert all(d.severity == "error" for d in hits)
        link = [d for d in hits if "rollout-model=mobilenet_v2" in
                d.message]
        assert len(link) == 1
        assert link[0].member == "infer" and link[0].element == "f"
        assert link[0].path == path and link[0].line == 15
        a, b = link[0].span
        assert link[0].source[a:b] == "rollout-model=mobilenet_v2"
        hedges = [d for d in hits if "no _rid dedup" in d.message]
        assert len(hedges) == 2  # one per rid-less hedge target
        for d in hedges:
            assert d.member == "camera" and d.element == "qc"
            assert d.line == 24
            a, b = d.span
            assert d.source[a:b] == "hedge-after-ms=50"
        assert {":9301" in d.message or ":9302" in d.message
                for d in hedges} == {True}

    def test_rid_capable_hedge_is_clean(self):
        diags, _ = analyze_deploy(spec_path("clean.deploy"))
        assert by_code(diags, "NNST995") == []


class TestColdStart996:
    def test_cold_fleet_prices_warmup(self, tmp_path, monkeypatch):
        monkeypatch.setenv("NNSTPU_AOT_CACHE", str(tmp_path))
        path = spec_path("cold_start.deploy")
        diags, _ = analyze_deploy(path)
        hits = by_code(diags, "NNST996")
        assert len(hits) == 2  # one per cold member
        for d in hits:
            assert d.severity == "warning"
        a = next(d for d in hits if d.member == "infer-a")
        b = next(d for d in hits if d.member == "infer-b")
        assert a.element == "f_a" and a.path == path and a.line == 14
        assert b.element == "f_b" and b.line == 17
        assert "across 2 member(s)" in a.message
        assert "NNSTPU_AOT_CACHE" in a.hint

    def test_aot_disabled_members_not_flagged(self, tmp_path,
                                              monkeypatch):
        # clean.deploy members run aot:0 — no cache participation, no
        # cold-start verdict to price
        monkeypatch.setenv("NNSTPU_AOT_CACHE", str(tmp_path))
        diags, _ = analyze_deploy(spec_path("clean.deploy"))
        assert by_code(diags, "NNST996") == []


# --- cross-cutting contracts -------------------------------------------------


ALL_SPECS = ["clean.deploy", "broken_wiring.deploy",
             "sig_mismatch.deploy", "slo_infeasible.deploy",
             "hbm_overcommit.deploy", "rollout_hazard.deploy",
             "cold_start.deploy"]


class TestZeroCompile:
    @pytest.mark.parametrize("name", ALL_SPECS)
    def test_no_traces_no_playing(self, name, tmp_path, monkeypatch):
        from nnstreamer_tpu_torch.elements.filter import TensorFilter

        monkeypatch.setenv("NNSTPU_AOT_CACHE", str(tmp_path))
        _, fleet = analyze_deploy(spec_path(name))
        assert fleet.spec.members  # every fixture has members
        for m in fleet.spec.members:
            assert m.pipeline is not None
            assert m.pipeline.state == State.NULL  # never PLAYING
            for e in m.pipeline.elements.values():
                if isinstance(e, TensorFilter) and e.fw is not None:
                    assert e.fw.compile_stats()["jit_traces"] == 0, \
                        f"{name}:{m.name}/{e.name} compiled during lint"


class TestSpecOriginThreading:
    """Satellite: per-member PIPELINE diagnostics (not just fleet
    verdicts) cite ``<spec>:<line>`` and the member name."""

    def test_member_pipeline_diag_cites_spec_line(self):
        text = ("member wedge role=server\n"
                "tensor_query_serversrc name=qs id=w port=9400 serve=1"
                " serve-batch=8 serve-queue-depth=64"
                " caps=other/tensors,num-tensors=1,dimensions=4,"
                "types=float32,framerate=0/1"
                " ! tensor_filter name=f framework=jax model=add"
                " custom=k:1,aot:0 ! tensor_query_serversink name=qk"
                " id=w\n")
        diags, _ = analyze_deploy("wedge.spec", text=text)
        # the unbounded reply send is a PER-PIPELINE verdict (NNST622,
        # nnsan-c) — threaded through, it must carry the spec origin
        hits = by_code(diags, "NNST622")
        assert hits, "expected the per-pipeline NNST622 to surface"
        d = hits[0]
        assert d.member == "wedge"
        assert d.path == "wedge.spec" and d.line == 2
        assert "wedge/" in d.format() and "wedge.spec:2" in d.format()


class TestDeterminism:
    CLEAN = spec_path("clean.deploy")

    def _render(self):
        diags, _ = analyze_deploy(self.CLEAN)
        return "\n".join(d.format() for d in diags)

    def test_two_runs_byte_identical(self):
        assert self._render() == self._render()

    def test_shuffled_registration_byte_identical(self, monkeypatch):
        # satellite: pass-registration order must not leak into output —
        # reverse the registry dict and demand byte-identical reports
        import nnstreamer_tpu_torch.analysis.registry as registry

        baseline = self._render()
        shuffled = dict(reversed(list(registry._passes.items())))
        assert list(shuffled) != list(registry._passes)
        monkeypatch.setattr(registry, "_passes", shuffled)
        assert self._render() == baseline

    def test_shuffled_registration_single_pipeline(self, monkeypatch):
        # same contract for plain launch-line lint (every element named:
        # auto-name counters are process-global)
        import nnstreamer_tpu_torch.analysis.registry as registry

        line = ("tensor_query_serversrc name=qs id=d port=0 serve=1 "
                "serve-batch=8 serve-queue-depth=64 replicas=4 "
                "caps=other/tensors,num-tensors=1,dimensions=4,"
                "types=float32,framerate=0/1 "
                "! tensor_filter name=f framework=jax model=add "
                "custom=k:1,aot:0 ! tensor_query_serversink name=qk "
                "id=d")
        baseline = "\n".join(d.format() for d in analyze_launch(line))
        shuffled = dict(reversed(list(registry._passes.items())))
        monkeypatch.setattr(registry, "_passes", shuffled)
        again = "\n".join(d.format() for d in analyze_launch(line))
        assert again == baseline

    def test_diagnostics_sorted_by_stable_key(self):
        diags, _ = analyze_deploy(spec_path("broken_wiring.deploy"))
        keys = [(d.code, d.member or "", d.element) for d in diags]
        assert keys == sorted(keys)


class TestValidateCli:
    def _main(self, args, capsys):
        rc = validate_tool.main(args)
        return rc, capsys.readouterr().out

    def test_json_exit_contract_clean(self, capsys):
        rc, out = self._main(
            ["--strict", "--json", "--deploy", spec_path("clean.deploy")],
            capsys)
        doc = json.loads(out)
        assert rc == 0 and doc["exit"] == 0
        (res,) = doc["results"]
        assert res["exit"] == 0
        assert any(d["code"] == "NNST990" for d in res["diagnostics"])

    def test_json_exit_contract_error(self, capsys):
        rc, out = self._main(
            ["--json", "--deploy", spec_path("broken_wiring.deploy")],
            capsys)
        doc = json.loads(out)
        assert rc == 2 and doc["exit"] == 2
        (res,) = doc["results"]
        assert res["exit"] == 2
        d = next(x for x in res["diagnostics"]
                 if x["code"] == "NNST991")
        # the structured record carries the full attribution contract
        assert d["severity"] == "error"
        assert d["member"] and d["element"]
        assert d["path"].endswith("broken_wiring.deploy")
        assert isinstance(d["line"], int) and d["line"] > 0
        assert isinstance(d["span"], list) and len(d["span"]) == 2

    def test_json_exit_contract_warning_and_strict(self, capsys,
                                                   tmp_path,
                                                   monkeypatch):
        monkeypatch.setenv("NNSTPU_AOT_CACHE", str(tmp_path))
        path = spec_path("cold_start.deploy")
        rc, out = self._main(["--json", "--deploy", path], capsys)
        assert rc == 1 and json.loads(out)["exit"] == 1
        rc, out = self._main(["--strict", "--json", "--deploy", path],
                             capsys)
        assert rc == 2 and json.loads(out)["exit"] == 2

    def test_json_byte_identical_across_runs(self, capsys):
        args = ["--json", "--deploy", spec_path("clean.deploy")]
        _, first = self._main(args, capsys)
        _, second = self._main(args, capsys)
        assert first == second

    def test_mixed_deploy_and_launch_subjects(self, capsys):
        rc, out = self._main(
            ["--json", "--deploy", spec_path("clean.deploy"),
             "videotestsrc name=v num-buffers=1 ! tensor_converter "
             "name=c ! tensor_sink name=s"],
            capsys)
        doc = json.loads(out)
        assert [r["exit"] for r in doc["results"]] == [0, 0]
        assert rc == 0


class TestUnusedPassIsInert:
    """MIGRATION contract: zero behavior change when --deploy is not
    requested — the explicit pass never runs, single-pipeline output is
    byte-identical run to run and NNST99x-free."""

    LINE = ("appsrc name=src caps=other/tensors,num-tensors=1,"
            "dimensions=4:2,types=float32,framerate=0/1 "
            "! tensor_filter name=f framework=jax model=add "
            "custom=k:1,aot:0 ! tensor_sink name=out")

    def test_no_99x_without_deploy(self):
        assert not any(d.code.startswith("NNST99")
                       for d in analyze_launch(self.LINE))

    def test_single_pipeline_validate_byte_identical(self, capsys):
        rc1 = validate_tool.main(["--verbose", self.LINE])
        out1 = capsys.readouterr().out
        rc2 = validate_tool.main(["--verbose", self.LINE])
        out2 = capsys.readouterr().out
        assert (rc1, out1) == (rc2, out2)
        assert "NNST99" not in out1

    def test_explicit_pass_skips_regular_pipeline(self):
        from nnstreamer_tpu_torch.analysis.registry import run_passes
        from nnstreamer_tpu_torch.pipeline.parse import parse_launch

        diags = run_passes(parse_launch(self.LINE), passes=["deploy"])
        assert diags == []


class TestSeverityTable:
    def test_99x_codes_registered(self):
        want = {"NNST990": "info", "NNST991": "error",
                "NNST992": "error", "NNST993": "error",
                "NNST994": "error", "NNST995": "error",
                "NNST996": "warning"}
        for code, sev in want.items():
            assert CODES[code][0] == sev


# --- every fixture against the JAX package -----------------------------------

#: the codes the reference's jax fault takes out of its run, per fixture:
#: the port gives them as the fixture annotates (see the module docstring)
REFERENCE_FAULT = {"slo_infeasible.deploy": {"NNST993"},
                   "hbm_overcommit.deploy": {"NNST994"}}


def _annotated(name):
    with open(spec_path(name)) as f:
        head = f.readline()
    return [c for c in ("NNST991", "NNST992", "NNST993", "NNST994",
                        "NNST995", "NNST996") if c in head]


@pytest.mark.parametrize("name", ALL_SPECS)
def test_fixture_codes_match_reference(name, tmp_path, monkeypatch):
    monkeypatch.setenv("NNSTPU_AOT_CACHE", str(tmp_path))
    got = sorted(d.code for d in analyze_deploy(spec_path(name))[0])
    want = sorted(d.code for d in jax_analyze_deploy(spec_path(name))[0])
    # the port's cost model rows, which the reference's cannot give
    got = [c for c in got if c not in ("NNST701", "NNST702")]
    extra = REFERENCE_FAULT.get(name, set())
    assert not set(want) & extra  # the reference's fault, as noted
    assert [c for c in got if c not in extra] == want
    for code in _annotated(name):
        assert code in got, (name, code, got)
    assert ("NNST990" in got) and (name != "clean.deploy"
                                   or not _annotated(name))
