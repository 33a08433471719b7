"""The port's tracer (``nnstreamer_tpu_torch/trace.py``), its hooks in the
pipeline runtime and ``platform.py``, on the CPU, against the JAX
package's own.

Unit cases are tests/test_spans.py's and test_trace_checkpoint.py's on
the port's classes. The parity cases run the same ``model=add`` and
``custom-easy`` lines through both packages (the port's backend with
``accelerator=true:cpu``) and compare the tracer's report: the same keys,
the same chain counts per element, and the same crossing counts and bytes
per element. The lines end in a host sink, so both packages' residency
planners make the filter the point where outputs reach the host.
Timings are only checked for sign and order. The port's Chrome traces
must pass both packages' ``validate_chrome_trace``.
"""

import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_shared import (  # noqa: E402,F401 (fixtures)
    equal_name_counters,
    one_torch_thread,
)
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from nnstreamer_tpu import trace as jax_trace  # noqa: E402
from nnstreamer_tpu_torch import trace  # noqa: E402
from nnstreamer_tpu_torch.buffer import Buffer  # noqa: E402
from nnstreamer_tpu_torch.meta import TRACE_CTX_META  # noqa: E402
from nnstreamer_tpu_torch.pipeline import parse_launch  # noqa: E402

from test_torch_filter_props import PKGS, both  # noqa: E402


@pytest.fixture(autouse=True)
def _no_stale_lock_stats():
    """The JAX tracer's report carries a ``locks`` section whenever its
    lock witness holds statistics, which a sanitizer test run earlier in
    the same process (tests/test_analysis.py) leaves behind: clear them,
    so the report is the one this test's pipeline makes."""
    from nnstreamer_tpu.analysis import lockwitness

    lockwitness.reset()

CAPS4 = ("other/tensors,num-tensors=1,dimensions=4:1,types=float32,"
         "framerate=0/1")


def add_filter(pkg, extra=""):
    if pkg.name == "jax":
        return ("tensor_filter name=f framework=jax model=add "
                f"custom=k:1,aot:0 {extra}")
    return ("tensor_filter name=f framework=jax model=add custom=k:1 "
            f"accelerator=true:cpu {extra}")


def run_traced(pkg, filt, n=16, spans=False, tail="! queue name=q "
               "! tensor_sink name=out materialize=true"):
    p = pkg.parse_launch(f"appsrc name=src caps={CAPS4} ! {filt} {tail}")
    tracer = pkg.trace.attach(p, spans=spans)
    p.play()
    for i in range(n):
        p["src"].push_buffer(pkg.Buffer(
            tensors=[np.full((1, 4), float(i), np.float32)]))
    p["src"].end_of_stream()
    assert p.bus.wait_eos(60), p.bus.error
    assert p.bus.error is None, p.bus.error
    outs = [np.asarray(b.tensors[0]) for b in p["out"].collected]
    p.stop()
    return p, tracer, outs


# -- unit: series, histogram, span ring, validator -------------------------

def test_series_late_samples_shift_percentiles():
    s = trace._Series()
    for _ in range(4096):
        s.add(0.001)
    for _ in range(3 * 4096):
        s.add(0.1)
    st = s.stats()
    assert st["count"] == 4 * 4096
    assert st["p95_us"] == pytest.approx(0.1 * 1e6)
    assert st["p50_us"] == pytest.approx(0.1 * 1e6)
    assert st["mean_us"] == pytest.approx(
        (4096 * 0.001 + 3 * 4096 * 0.1) / (4 * 4096) * 1e6)


def test_series_matches_jax_reservoir():
    rng = np.random.default_rng(11)
    vals = rng.exponential(0.01, 20_000)
    a, b = trace._Series(), jax_trace._Series()
    for v in vals:
        a.add(float(v))
        b.add(float(v))
    assert a.values == b.values
    assert a.stats() == b.stats() and a.stats_raw() == b.stats_raw()


def test_hist_matches_jax_buckets():
    a, b = trace._Hist(), jax_trace._Hist()
    for us in (0.3, 1.0, 1.5, 4.3, 100.0, 1e5, 1e9):
        a.add(us / 1e6)
        b.add(us / 1e6)
    assert a.to_dict() == b.to_dict()
    assert trace.HIST_LE_US == jax_trace.HIST_LE_US
    for q in (0.1, 0.4, 0.5, 0.99):
        assert a.quantile_us(q) == b.quantile_us(q)


def test_span_ring_exports_valid_nested_trace():
    ring = trace.SpanRing(cap=64)
    t0 = time.perf_counter()
    ring.emit("inner", "dispatch", t0 + 0.001, t0 + 0.002, track="t")
    ring.emit("outer", "chain", t0, t0 + 0.003, track="t")
    ring.emit("wait", "queue", t0, t0 + 0.004, track="q", aid=7)
    ring.emit("instant", "chain", t0, t0, track="t")
    doc = ring.chrome_trace()
    assert trace.validate_chrome_trace(doc) == []
    assert jax_trace.validate_chrome_trace(doc) == []
    phases = [e["ph"] for e in doc["traceEvents"]]
    assert phases.count("B") == 2 and phases.count("E") == 2
    assert phases.count("b") == 1 and phases.count("X") == 1


def test_span_ring_is_bounded_flight_recorder():
    ring = trace.SpanRing(cap=8)
    for i in range(20):
        ring.emit(f"s{i}", "chain", float(i), float(i) + 0.5)
    assert len(ring.records()) == 8 and ring.dropped == 12
    assert ring.records()[-1][1] == "s19"


@pytest.mark.parametrize("doc,problem", [
    ({"traceEvents": [{"name": "x", "cat": "c", "ph": "E", "ts": 1.0,
                       "pid": 1, "tid": 1}]}, "E without open B"),
    ({"traceEvents": [{"name": "x", "cat": "c", "ph": "B", "ts": 5.0,
                       "pid": 1, "tid": 1},
                      {"name": "x", "cat": "c", "ph": "E", "ts": 1.0,
                       "pid": 1, "tid": 1}]}, "not monotonic"),
    ({"traceEvents": [{"ph": "B", "ts": 1.0}]}, "missing"),
    ({}, "no traceEvents list"),
])
def test_validator_agrees_with_jax(doc, problem):
    got = trace.validate_chrome_trace(doc)
    assert got == jax_trace.validate_chrome_trace(doc)
    assert any(problem in p for p in got)


def test_attach_is_idempotent_and_upgrades_spans():
    p = parse_launch(f"appsrc name=src caps={CAPS4} ! tensor_sink name=out")
    t1 = trace.attach(p)
    t1.record_chain("probe", 0.0, 0.001)
    assert t1.spans is None
    t2 = trace.attach(p, spans=True)
    assert t2 is t1 and t1.spans is not None and "probe" in t2.report()
    t3 = trace.attach(p, replace=True)
    assert t3 is not t1 and p.tracer is t3


def test_disabled_by_default():
    p = parse_launch(f"appsrc name=src caps={CAPS4} ! tensor_sink name=out")
    assert p.tracer is None
    p.play()
    p["src"].push_buffer(Buffer(tensors=[np.zeros((1, 4), np.float32)]))
    assert p["out"].pull(timeout=5.0) is not None
    p.stop()
    assert p.tracer is None


def test_env_var_auto_attaches_span_tracer(monkeypatch):
    monkeypatch.setenv(trace.SPAN_ENV, "1")
    p = parse_launch(f"appsrc name=src caps={CAPS4} ! tensor_sink name=out")
    assert p.tracer is None
    p.play()
    assert p.tracer is not None and p.tracer.spans is not None
    p["src"].push_buffer(Buffer(tensors=[np.zeros((1, 4), np.float32)]))
    p["src"].end_of_stream()
    assert p.bus.wait_eos(10)
    p.stop()
    cats = {r[2] for r in p.tracer.spans.records()}
    assert {"chain", "source", "emit"} <= cats


# -- parity: the tracer's report through both packages ---------------------

#: lines whose outputs reach the host at the filter in both packages
PARITY_LINES = {
    "add_batch_feed_window": ("add", "batch-size=4 feed-depth=2 "
                                     "fetch-window=2"),
    "add_sync": ("add", "sync=1"),
    "add_feed_window": ("add", "feed-depth=3 fetch-window=4"),
    "easy_window": ("easy", "fetch-window=3"),
    "easy_batch_window": ("easy", "batch-size=2 fetch-window=2"),
}


@pytest.fixture
def trace_dev():
    """custom-easy trace_dev in both packages: device outputs x + 1."""
    for pkg in PKGS.values():
        info = pkg.TensorsInfo.from_strings("4:1", "float32")
        pkg.base.register_custom_easy(
            "trace_dev",
            lambda ins, dev=pkg.to_device: [dev(np.asarray(ins[0]) + 1)],
            info, info)
    yield
    for pkg in PKGS.values():
        pkg.base.unregister_custom_easy("trace_dev")


def _filter_of(pkg, kind, extra):
    if kind == "add":
        return add_filter(pkg, extra)
    return f"tensor_filter name=f framework=custom-easy model=trace_dev {extra}"


@pytest.mark.parametrize("case", sorted(PARITY_LINES))
def test_report_parity(trace_dev, case):
    kind, extra = PARITY_LINES[case]
    got = both(lambda pkg: run_traced(pkg, _filter_of(pkg, kind, extra)))
    (_, tj, oj), (_, tp, op) = got["jax"], got["port"]
    assert len(oj) == len(op) == 16
    for a, b in zip(oj, op):
        np.testing.assert_array_equal(a, b)
    rj, rp = tj.report(), tp.report()
    assert set(rj) == set(rp)
    for el in ("f", "q", "out"):
        assert set(rj[el]) == set(rp[el]), el
        assert rj[el]["proctime"]["count"] == rp[el]["proctime"]["count"]
    assert set(rj["residency"]) == set(rp["residency"])
    for edge in rj["residency"]:
        assert rj["residency"][edge]["count"] == \
            rp["residency"][edge]["count"], edge
    assert rj.get("crossings") == rp.get("crossings")
    assert set(rj["metrics"]) == set(rp["metrics"])
    assert set(rj["metrics"]["histograms"]) == \
        set(rp["metrics"]["histograms"])


def test_crossings_count_one_upload_per_batch_one_fetch_per_window():
    _, tracer, _ = run_traced(PKGS["port"], add_filter(
        PKGS["port"], "batch-size=4 feed-depth=2 fetch-window=2"))
    cr = tracer.crossings()["per_element"]["f"]
    # 16 frames: 4 batches of 4 uploaded, 2 windows of 2 batches fetched
    assert (cr["h2d"], cr["d2h"]) == (4, 2)
    assert cr["h2d_bytes"] == cr["d2h_bytes"] == 16 * 4 * 4
    res = tracer.report()["residency"]
    assert res["upload-window:f"]["count"] == 4
    assert res["fetch-window:f"]["count"] == 4


def test_spans_off_no_per_buffer_context():
    p, tracer, _ = run_traced(PKGS["port"], add_filter(
        PKGS["port"], "batch-size=4 feed-depth=2"))
    assert tracer.spans is None
    for buf in p["out"].collected:
        assert TRACE_CTX_META not in buf.meta
    assert tracer.report()["f"]["proctime"]["count"] > 0


def test_span_coverage_and_buffer_context():
    p, tracer, _ = run_traced(PKGS["port"], add_filter(
        PKGS["port"], "batch-size=4 feed-depth=2 fetch-window=2"),
        spans=True)
    doc = tracer.export_chrome_trace()
    assert trace.validate_chrome_trace(doc) == []
    assert jax_trace.validate_chrome_trace(doc) == []
    cats = {e.get("cat") for e in doc["traceEvents"]
            if e.get("ph") in ("B", "b")}
    assert {"source", "chain", "queue", "h2d", "dispatch", "compute",
            "d2h", "batch"} <= cats
    bufs = [e["args"]["buf"] for e in doc["traceEvents"]
            if e.get("ph") == "B" and e.get("cat") == "chain"]
    assert bufs and all(isinstance(b, int) for b in bufs)
    for buf in p["out"].collected:
        assert buf.meta[TRACE_CTX_META].buffer_id >= 0
        assert buf.meta[TRACE_CTX_META].depth == 0
    cr = tracer.crossings()
    assert len([r for r in tracer.spans.records() if r[2] == "d2h"]) == \
        cr["d2h"]


def test_host_stack_report_keys_match_jax():
    reps = both(lambda pkg: run_traced(pkg, add_filter(
        pkg, "batch-size=4 feed-depth=2 fetch-window=2"), spans=True)[1]
        .host_stack_report())
    assert set(reps["jax"]) == set(reps["port"])
    assert set(reps["jax"]["components_ms_per_batch"]) == \
        set(reps["port"]["components_ms_per_batch"])
    rp = reps["port"]
    assert rp["batches"] == 4  # one dispatch per micro-batch
    assert all(v >= 0 for v in rp["components_ms_per_batch"].values())


def test_element_self_ms_splits_chain_time():
    _, tracer, _ = run_traced(PKGS["port"], add_filter(
        PKGS["port"], "batch-size=4 fetch-window=2"), spans=True,
        tail="! tensor_sink name=out")
    own = tracer.element_self_ms(batches=4)
    assert {"f", "out"} <= set(own)
    assert all(v >= 0 for v in own.values())
    # self times never exceed the inclusive chain time they came from
    rep = tracer.report()
    for el, ms in own.items():
        total = rep[el]["proctime"]["mean_us"] * \
            rep[el]["proctime"]["count"] / 1e3 / 4
        assert ms <= total + 1e-6, el


def test_fault_attributed_to_tracer():
    """on-error=drop on a failing invoke: the drop is counted against the
    element in both tracers."""
    def run(pkg):
        info = pkg.TensorsInfo.from_strings("4:1", "float32")

        def boom(xs):
            raise RuntimeError("boom")

        pkg.base.register_custom_easy("trace_boom", boom, info, info)
        try:
            p = pkg.parse_launch(
                f"appsrc name=src caps={CAPS4} ! tensor_filter name=f "
                "framework=custom-easy model=trace_boom on-error=drop "
                "! tensor_sink name=out")
            tracer = pkg.trace.attach(p)
            p.play()
            for _ in range(3):
                p["src"].push_buffer(pkg.Buffer(
                    tensors=[np.zeros((1, 4), np.float32)]))
            p["src"].end_of_stream()
            assert p.bus.wait_eos(10)
            p.stop()
            return tracer.faults()
        finally:
            pkg.base.unregister_custom_easy("trace_boom")

    got = both(run)
    assert got["jax"] == got["port"] == {"f": {"drop": 3}}


# -- tests/test_trace_checkpoint.py's tracer cases, both packages ----------

def test_proctime_and_fps():
    def run(pkg):
        p = pkg.parse_launch(
            "appsrc name=src caps=other/tensors,format=static,dimensions=64,"
            "types=float32 ! tensor_transform mode=arithmetic option=mul:2 "
            "! tensor_sink name=out")
        tracer = pkg.trace.attach(p)
        p.play()
        for _ in range(20):
            p["src"].push_buffer(pkg.Buffer(
                tensors=[np.zeros(64, np.float32)]))
        for _ in range(20):
            assert p["out"].pull(timeout=5.0) is not None
        p.stop()
        rep = tracer.report()
        t = next(v for k, v in rep.items()
                 if k.startswith("tensor_transform"))
        return t["proctime"]["count"], "fps" in t, tracer.summary()

    for name, (count, fps, summary) in both(run).items():
        assert count == 20 and fps, name
        assert "tensor_transform" in summary, name


def test_queue_residency_and_src_latency():
    def run(pkg):
        p = pkg.parse_launch(
            "appsrc name=src caps=other/tensors,format=static,dimensions=64,"
            "types=float32 ! queue name=q max-size-buffers=4 "
            "! tensor_transform mode=arithmetic option=add:1 "
            "! tensor_sink name=out")
        tracer = pkg.trace.attach(p)
        p.play()
        for _ in range(12):
            p["src"].push_buffer(pkg.Buffer(
                tensors=[np.zeros(64, np.float32)]))
        for _ in range(12):
            assert p["out"].pull(timeout=5.0) is not None
        time.sleep(0.05)
        p.stop()
        rep = tracer.report()
        tname = next(k for k in rep if k.startswith("tensor_transform"))
        top = tracer.top_residency(3)
        return (rep["residency"]["queue:q"]["count"],
                rep[tname]["src_latency"]["count"], top[0]["edge"],
                "residency" in tracer.summary())

    got = both(run)
    assert got["jax"] == got["port"] == (12, 12, "queue:q", True)


def test_fetch_window_hold_residency(trace_dev):
    def run(pkg):
        _, tracer, _ = run_traced(
            pkg, "tensor_filter name=f framework=custom-easy "
            "model=trace_dev fetch-window=3", n=6,
            tail="! tensor_sink name=out")
        return tracer.report()["residency"]["fetch-window:f"]["count"]

    assert both(run) == {"jax": 6, "port": 6}


# -- metrics endpoint ------------------------------------------------------

def test_metrics_text_and_histograms():
    _, tracer, _ = run_traced(PKGS["port"], add_filter(
        PKGS["port"], "fetch-window=2"), n=8)
    rep = tracer.report()
    hists = rep["metrics"]["histograms"]["proctime_us"]
    assert "f" in hists and hists["f"]["count"] == 8
    text = tracer.metrics_text()
    assert 'nnstpu_proctime_us_bucket{element="f",le="1"}' in text
    assert 'le="+Inf"' in text and "nnstpu_crossings_total" in text
    # the JAX package renders the port's saved report identically
    saved = json.loads(json.dumps(rep, default=str))
    assert jax_trace.metrics_text(saved) == trace.metrics_text(saved)


def test_sampler_produces_time_series():
    p = parse_launch(f"appsrc name=src caps={CAPS4} ! tensor_sink name=out")
    tracer = trace.attach(p)
    tracer.start_metrics_sampler(interval_s=0.05)
    p.play()
    for _ in range(6):
        p["src"].push_buffer(Buffer(tensors=[np.zeros((1, 4), np.float32)]))
        time.sleep(0.04)
    p["src"].end_of_stream()
    assert p.bus.wait_eos(10)
    p.stop()
    tracer.stop_metrics_sampler()
    series = tracer.metrics_series()
    assert len(series) >= 2
    ts = [s["t_s"] for s in series]
    assert ts == sorted(ts)
    assert any("elements" in s for s in series)
    assert tracer.report()["metrics"]["series"]


# -- Chrome traces: merge, torch.profiler ----------------------------------

def _two_docs():
    _, a, _ = run_traced(PKGS["port"], add_filter(PKGS["port"],
                                                   "fetch-window=2"),
                         n=4, spans=True)
    _, b, _ = run_traced(PKGS["port"], add_filter(PKGS["port"], "sync=1"),
                         n=4, spans=True)
    return a.export_chrome_trace(), b.export_chrome_trace()


@pytest.mark.parametrize("stitch", [False, True])
def test_merge_chrome_traces_matches_jax(stitch):
    client, server = _two_docs()
    samples = None
    if stitch:
        e0 = client["otherData"]["epoch_perf_ns"]
        samples = [(e0 + 1000, e0 + 1500, e0 + 1600, e0 + 2200)]
    mine = trace.merge_chrome_traces(client, server, samples=samples)
    theirs = jax_trace.merge_chrome_traces(client, server, samples=samples)
    assert mine == theirs
    assert mine["otherData"]["stitched"] is stitch
    assert trace.validate_chrome_trace(mine) == []


def test_torch_profile_writes_valid_chrome_trace(tmp_path):
    with trace.torch_profile(str(tmp_path / "prof")) as path:
        _, tracer, _ = run_traced(PKGS["port"], add_filter(
            PKGS["port"], "fetch-window=2"), n=4)
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    assert doc["traceEvents"]
    assert trace.validate_chrome_trace(doc) == []
    assert jax_trace.validate_chrome_trace(doc) == []
    assert trace.validate_chrome_trace(path) == []


# -- platform.py ------------------------------------------------------------

def test_hw_capabilities_reads_torch():
    from nnstreamer_tpu_torch.platform import hw_capabilities

    caps = hw_capabilities()
    assert caps["platform"] == ("gpu" if torch.cuda.is_available()
                                else "cpu")
    assert caps["has_gpu"] == torch.cuda.is_available()
    assert caps["num_devices"] == torch.cuda.device_count()
    assert caps["cpu_count"] >= 1
    host = hw_capabilities(probe_device=False)
    assert host["platform"] == "unknown" and host["simd"] == caps["simd"]


def test_hw_capabilities_describes_the_card(monkeypatch):
    from types import SimpleNamespace

    from nnstreamer_tpu_torch.platform import hw_capabilities

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(
        torch.cuda, "get_device_properties",
        lambda i=0: SimpleNamespace(major=9, minor=0,
                                    total_memory=85 * 2**30))
    caps = hw_capabilities()
    assert (caps["platform"], caps["gpu_kind"], caps["sm_capability"],
            caps["num_devices"]) == ("gpu", "NVIDIA H100 80GB HBM3", "9.0",
                                     1)
    assert caps["total_memory_bytes"] == 85 * 2**30


def test_model_db_round_trip_matches_jax(tmp_path, monkeypatch):
    from nnstreamer_tpu import platform as jax_platform
    from nnstreamer_tpu_torch import platform

    monkeypatch.setenv("NNSTPU_MODEL_DB", str(tmp_path / "models.json"))
    model = tmp_path / "m.bin"
    model.write_bytes(b"x")
    platform.register_model_path("mbv2", str(model), version="3")
    for uri in ("mlagent://model/mbv2", "mlagent://model/mbv2/3",
                "plain/path.bin"):
        assert platform.resolve_model_uri(uri) == \
            jax_platform.resolve_model_uri(uri)
    for bad in ("mlagent://model/none", "mlagent://x/mbv2",
                "mlagent://model/mbv2/9"):
        with pytest.raises(ValueError):
            platform.resolve_model_uri(bad)


def test_jax_arrays_stay_in_the_jax_package():
    """The JAX probe above returns jax arrays; the port's never does."""
    from nnstreamer_tpu_torch.buffer import is_backend_tensor

    assert not is_backend_tensor(jnp.zeros(2))
    assert is_backend_tensor(torch.zeros(2))
    assert not is_backend_tensor(np.zeros(2))
