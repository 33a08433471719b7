"""The environment checker (``tools/doctor.py``) of the port, on the CPU,
against the JAX package's.

The report's sections are the reference's, with the JAX probes replaced:
``torch`` (versions), ``devices`` (the cards ``torch.cuda`` sees, else the
CPU) and ``kernels`` (``nvcc`` and whether this checkout's kernel library
is built) stand where the reference reports ``jax.devices`` and its
native core. The renderers of saved tracer reports (``--aot``,
``--rollout``, ``--serving``, ``--ctl``, ``--locks``, ``--timeline``)
give the JAX package's text for the same report; ``--aot`` also lists the
compile cache; ``--tune``, ``--lint`` and ``--deploy`` hand over to
``tools/validate.py`` and exit as the JAX package's doctor does on the
same input. Both packages' element-name counters are emptied at the
module's end.
"""

import json
import os
import sys

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from nnstreamer_tpu.tools import doctor as jax_doctor  # noqa: E402
from nnstreamer_tpu_torch import trace  # noqa: E402
from nnstreamer_tpu_torch.buffer import Buffer  # noqa: E402
from nnstreamer_tpu_torch.filters import aot  # noqa: E402
from nnstreamer_tpu_torch.pipeline import parse_launch  # noqa: E402
from nnstreamer_tpu_torch.tools import doctor  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPS = "other/tensors,num-tensors=1,dimensions=4:2,types=float32,framerate=0/1"
LINE = (f"appsrc name=src caps={CAPS} ! tensor_filter name=f framework=jax "
        "model=add custom=k:1,aot:0 ! tensor_sink name=out")
FLEET = os.path.join(REPO, "examples", "fleet")


@pytest.fixture(scope="module", autouse=True)
def _equal_name_counters():
    """Both packages name unnamed elements from their own counters; this
    module builds pipelines in both, so it empties both at its end."""
    yield
    for name in ("nnstreamer_tpu", "nnstreamer_tpu_torch"):
        sys.modules[f"{name}.pipeline.element"].Element._name_counters.clear()


@pytest.fixture
def aot_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("NNSTPU_AOT_CACHE", str(tmp_path / "aot"))
    return tmp_path / "aot"


# --- the report ---------------------------------------------------------------

def test_report_sections_match_the_reference():
    ref = jax_doctor.collect(probe_device=False)
    got = doctor.collect(probe_device=True)
    assert set(got) == (set(ref) - {"native"}) | {
        "torch", "kernels", "devices", "default_backend"}
    assert set(got["subplugins"]) == set(ref["subplugins"])
    assert set(got["config"]) == set(ref["config"])
    assert set(got["hw"]) >= {"platform", "cpu_count"}


def test_report_probes_torch_the_card_and_nvcc(monkeypatch):
    import torch

    got = doctor.collect()
    assert got["torch"]["version"] == torch.__version__
    if not torch.cuda.is_available():
        assert got["devices"] == ["cpu"] and got["default_backend"] == "cpu"
    k = got["kernels"]
    assert len(k["digest"]) == 16 and k["library"].endswith(
        os.path.join(k["digest"], "libnnstpu_kernels.so"))
    assert k["built"] == os.path.exists(k["library"])
    # nvcc: the compiler's path, or None where there is none (no build)
    monkeypatch.setenv("PATH", "")
    from nnstreamer_tpu_torch.ops import _cuda

    want = "/usr/local/cuda/bin/nvcc" if os.path.exists(
        "/usr/local/cuda/bin/nvcc") else None
    assert doctor.kernel_library()["nvcc"] == want
    assert _cuda.CSRC == doctor.kernel_library()["csrc"]


def test_json_and_text_cli(capsys):
    assert doctor.main(["--json", "--no-device"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert {"kernels", "torch", "subplugins", "elements"} <= set(rep)
    assert "jax" in rep["subplugins"]["filter"]
    assert doctor.main([]) == 0
    out = capsys.readouterr().out
    for token in ("nnstreamer_tpu_torch doctor", "devices:", "nvcc:",
                  "kernel library:", "filter:"):
        assert token in out, token


# --- the renderers against the reference's -------------------------------------

def _played_report():
    """A tracer report with an aot and a rollout section, from the port."""
    from nnstreamer_tpu_torch.filters.base import (
        register_custom_easy,
        unregister_custom_easy,
    )
    from nnstreamer_tpu_torch.buffer import Event
    from nnstreamer_tpu_torch.types import TensorsInfo

    info = TensorsInfo.from_strings("4:2", "float32")
    register_custom_easy("doc_b", lambda xs: [np.asarray(xs[0]) * 3.0],
                         info, info)
    try:
        p = parse_launch(LINE.replace("aot:0", "aot:1 accelerator=true:cpu"))
        t = trace.attach(p)
        p.play()
        p["src"].push_buffer(Buffer(tensors=[np.ones((2, 4), np.float32)]))
        p["src"].end_of_stream()
        assert p.bus.wait_eos(60)
        p.stop()
        q = parse_launch(
            f"appsrc name=src caps={CAPS} ! tensor_filter name=g "
            "framework=custom-easy model=doc_b rollout-canary-frames=1 "
            "! tensor_sink name=out")
        t2 = trace.attach(q)
        q.play()
        q["src"].push_buffer(Buffer(tensors=[np.ones((2, 4), np.float32)]))
        q["g"].sink_pad.receive_event(Event("rollout-model",
                                            {"model": "doc_b"}))
        q["src"].push_buffer(Buffer(tensors=[np.ones((2, 4), np.float32)]))
        q["src"].end_of_stream()
        assert q.bus.wait_eos(30)
        q.stop()
    finally:
        unregister_custom_easy("doc_b")
    rep = t.report()
    rep["rollout"] = t2.report()["rollout"]
    return rep


SERVING = {"serving": {"s1": {
    "batches": 4, "batch_fill": 7.5, "rows": 30, "padded_rows": 2,
    "enqueued": 30, "shed": 1, "shed_reasons": {"queue_full": 1},
    "replies": 30, "reply_drops": 0,
    "queue_depth": {"count": 4, "p50": 3, "max": 8},
    "time_in_queue": {"count": 4, "p50_us": 1200.0, "p95_us": 3400.0},
    "per_tenant": {"a": {"enqueued": 30, "shed": 1, "replies": 30,
                         "goodput_rps": 12.5}},
    "per_replica": {"0": {"batches": 2}, "1": {"batches": 2}}}}}
CTL = {"ctl": {"s1": {"knobs": {"serve_batch": 8}, "dropped_decisions": 0,
                      "decisions": [{"t_ms": 12.0, "rule": "grow",
                                     "knob": "serve_batch", "before": 4,
                                     "after": 8, "reason": "fill",
                                     "observed": {"admitted_p99_ms": 3.0}}]}}}
LOCKS = {"locks": {"filter.window": {"acquisitions": 10, "contended": 2,
                                     "held_p50_us": 1.0, "held_p95_us": 4.0,
                                     "wait_p95_us": 2.0}}}
TIMELINE = {"components_ms_per_batch": {"filter": 2.0, "queue": 0.5},
            "host_stack_ms_per_batch": 2.5,
            "device_compute_ms_per_batch": 1.5, "batches": 8}


@pytest.mark.parametrize("name,report", [
    ("render_serving", SERVING), ("render_ctl", CTL),
    ("render_locks", LOCKS), ("render_timeline", TIMELINE),
])
def test_renderers_match_reference(name, report):
    assert getattr(doctor, name)(report) == getattr(jax_doctor, name)(report)


def test_aot_and_rollout_renderers_match_reference(aot_cache):
    rep = _played_report()
    assert rep["aot"]["f"]["misses"] == 1
    assert doctor.render_aot(rep) == jax_doctor.render_aot(rep)
    assert "nnaot f: 0 hits, 1 misses" in doctor.render_aot(rep)
    assert doctor.render_rollout(rep) == jax_doctor.render_rollout(rep)
    assert "1 started, 1 promoted" in doctor.render_rollout(rep)


# --- --aot: the cache ----------------------------------------------------------

def test_doctor_aot_lists_entries_quarantine_and_report(aot_cache, tmp_path,
                                                        capsys):
    rep = _played_report()
    path = tmp_path / "report.json"
    path.write_text(json.dumps(rep, default=str))
    assert doctor.main(["--aot", str(path)]) == 0
    out = capsys.readouterr().out
    assert "nnaot f: 0 hits, 1 misses" in out
    assert f"AOT cache {aot.cache_dir()}: 1 entries" in out
    assert "model=add" in out
    # the in-process event log of this process
    assert "events:" in out and "miss-compiled" in out
    entry = aot.cache_entries()[0]["path"]
    with open(entry, "wb") as f:
        f.write(b"junk")
    assert aot.load(entry) is None
    assert doctor.main(["--aot"]) == 0
    assert "quarantine: 1 unreadable entry" in capsys.readouterr().out
    assert doctor.main(["--aot-purge"]) == 0
    assert "purged 1 AOT cache entry" in capsys.readouterr().out


def test_doctor_rollout_renders_a_saved_report(tmp_path, aot_cache, capsys):
    rep = _played_report()
    path = tmp_path / "report.json"
    path.write_text(json.dumps(rep, default=str))
    assert doctor.main(["--rollout", str(path)]) == 0
    assert "nnfleet-r g: 1 started" in capsys.readouterr().out


# --- the validate hand-overs ----------------------------------------------------

def test_doctor_delegates_tune(capsys):
    assert doctor.main(["--tune", "--no-measure", LINE]) == 0
    assert "nntune:" in capsys.readouterr().out


def test_doctor_lint_and_cost_delegate(capsys):
    assert doctor.main(["--lint", LINE]) == jax_doctor.main(["--lint", LINE])
    capsys.readouterr()
    assert doctor.main(["--lint", "nosuchelement ! tensor_sink"]) == 2


@pytest.mark.parametrize("spec,rc", [("clean.deploy", 0),
                                     ("broken_wiring.deploy", 2),
                                     ("cold_start.deploy", 1)])
def test_doctor_deploy_exits_as_the_reference(spec, rc, aot_cache, capsys):
    path = os.path.join(FLEET, spec)
    assert doctor.main(["--deploy", path]) == rc
    out = capsys.readouterr().out
    assert jax_doctor.main(["--deploy", path]) == rc
    assert ("NNST99" in out) == (rc != 0)


def test_doctor_lint_aot_runs_the_static_pass(aot_cache, capsys):
    line = LINE.replace("aot:0", "aot:1")
    assert doctor.main(["--lint", "--aot", "--verbose", line]) == 1
    out = capsys.readouterr().out
    assert "NNST970" in out and "NNST971" in out
