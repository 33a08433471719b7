"""The compile cache (``filters/aot.py``, ``filters/aot_worker.py``,
``custom=aot:1``, ``validate --aot``, NNST970–972) through the port, on the
CPU, against the JAX package's cache.

The counterpart of the reference's tests/test_aot.py (24 cases), which
passes in full on this machine:

- the key's dimensions: the same inputs give equal keys and each changed
  dimension (custom, signature, donate, loop window, launch depth, serve
  batch, placement, mesh, runtime, model content) a distinct one, with the
  same pattern in both packages;
- hit, miss, quarantine, ``refused-budget``, eviction order and purge for
  the same sequence of events in both packages, each with real worker
  processes;
- a loaded program's outputs bit-equal to an in-process build, with the
  worker run as a real subprocess on the CPU (the add model and a narrow
  MobileNet-v2 with the fused preamble and the postproc);
- NNST970–972 on ``examples/launch_lines_aot.txt`` equal to the
  reference's, and the warm, drift and quarantine cases;
- both packages sharing one ``NNSTPU_AOT_CACHE``, each staying warm.

The port's lines name ``accelerator=true:cpu`` (its default device is the
card): the key's platform is the filter's device, so a line is linted
with the same property it plays with. Cases that test the cache's
bookkeeping rather than the child process run the worker's ``build`` in
the test's process (``inproc_worker``). Both packages' element-name
counters are emptied at the module's end.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import torch  # noqa: E402

import nnstreamer_tpu.analysis as jax_analysis  # noqa: E402
import nnstreamer_tpu.filters.aot as jax_aot  # noqa: E402
import nnstreamer_tpu.pipeline as jax_pipeline  # noqa: E402
from nnstreamer_tpu.buffer import Buffer as JaxBuffer  # noqa: E402
from nnstreamer_tpu_torch import trace  # noqa: E402
from nnstreamer_tpu_torch.analysis import analyze_launch  # noqa: E402
from nnstreamer_tpu_torch.buffer import Buffer  # noqa: E402
from nnstreamer_tpu_torch.filters import aot, aot_worker  # noqa: E402
from nnstreamer_tpu_torch.pipeline import parse_launch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPS = "other/tensors,num-tensors=1,dimensions=4:2,types=float32,framerate=0/1"
CPU = "accelerator=true:cpu"
SIG = [((2, 4), "float32")]
DEV = torch.device("cpu")


@pytest.fixture
def aot_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("NNSTPU_AOT_CACHE", str(tmp_path / "aot"))
    return tmp_path / "aot"


@pytest.fixture
def inproc_worker(monkeypatch):
    """The worker's ``build`` in this process instead of a child (the
    bookkeeping cases); counts the builds."""
    built = []

    def run(spec, path, tag):
        aot_worker.build(spec)
        built.append(spec["model"])
        return path

    monkeypatch.setattr(aot, "_run_worker", run)
    return built


@pytest.fixture(scope="module", autouse=True)
def _equal_name_counters():
    """Both packages name unnamed elements from their own counters; this
    module builds unnamed elements in both, so it empties both at its end
    (a later file in the same process looks elements up by name)."""
    yield
    for name in ("nnstreamer_tpu", "nnstreamer_tpu_torch"):
        sys.modules[f"{name}.pipeline.element"].Element._name_counters.clear()


def compile_port(custom="k:1", sig=None, **kw):
    return aot.maybe_aot_compile("add", custom, sig or SIG, device=DEV, **kw)


def play(line, frames, parse=parse_launch, buf=Buffer, tracer=False):
    p = parse(line)
    t = trace.attach(p) if tracer else None
    p.play()
    for x in frames:
        p["src"].push_buffer(buf(tensors=[x]))
    p["src"].end_of_stream()
    assert p.bus.wait_eos(60)
    outs = [np.asarray(b[0]) for b in p["out"].collected]
    fw = p["f"].fw if "f" in p.elements else None
    stats = fw.compile_stats() if fw is not None else None
    p.stop()
    return outs, stats, t


FRAMES = [np.full((2, 4), float(i), np.float32) for i in range(3)]


def add_line(custom, extra=CPU):
    return (f"appsrc name=src caps={CAPS} ! tensor_filter name=f "
            f"framework=jax model=add custom={custom} {extra} "
            "! tensor_sink name=out")


# --- the cache through the port --------------------------------------------

class TestAotCache:
    def test_compile_load_roundtrip_in_a_real_worker(self, aot_cache):
        program = compile_port("k:3")
        assert program is not None
        entries = os.listdir(aot_cache / aot.SUBDIR)
        assert entries == [f"{aot.cache_entries()[0]['key']}{aot.SUFFIX}"]
        from nnstreamer_tpu_torch.filters.cuda_filter import compose

        x = np.arange(8, dtype=np.float32).reshape(2, 4)
        out = compose([torch.from_numpy(x)], None, program.head.apply_fn,
                      None, None)[0]
        # the JAX package's add model on the same input
        from nnstreamer_tpu.models import get_model

        b = get_model("add", {"k": "3"})
        np.testing.assert_array_equal(out.numpy(),
                                      np.asarray(b.apply_fn(b.params, x)))
        assert aot.LAST_WORKER["bytes"] == 0  # the add model has no state

    def test_cache_hit_skips_worker(self, aot_cache, inproc_worker,
                                    monkeypatch):
        assert compile_port("k:1") is not None

        def boom(*a, **k):
            raise AssertionError("worker must not run on cache hit")

        monkeypatch.setattr(aot, "compile_in_subprocess", boom)
        assert compile_port("k:1") is not None

    def test_filter_aot_matches_in_process_and_jax(self, aot_cache):
        """custom=aot:1 streams the same bytes as aot:0 (the in-process
        build) and as the JAX package's aot:0; the cached program runs
        with zero in-process builds."""
        got, stats, t = play(add_line("k:2,aot:1"), FRAMES, tracer=True)
        assert stats == {"jit_traces": 0}
        rep = t.report()["aot"]["f"]
        assert rep["misses"] == 1 and rep["hits"] == 0
        base, stats0, _ = play(add_line("k:2,aot:0"), FRAMES)
        assert stats0 == {"jit_traces": 1}
        ref, _, _ = play(add_line("k:2,aot:0", ""), FRAMES,
                         jax_pipeline.parse_launch, JaxBuffer)
        assert len(got) == 3
        for a, b, r in zip(got, base, ref):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, r)

    def test_filter_donate_matches_default(self, aot_cache, inproc_worker):
        results = {}
        for mode in ("donate:1", "donate:0"):
            results[mode], _, _ = play(add_line(f"k:3,{mode},aot:1"), FRAMES)
        assert len(results["donate:1"]) == 3
        for a, b in zip(results["donate:1"], results["donate:0"]):
            np.testing.assert_array_equal(a, b)
        # donation is a key dimension: two entries
        assert len(aot.cache_entries()) == 2
        assert sorted(bool((r["spec"] or {}).get("donate"))
                      for r in aot.cache_entries()) == [False, True]

    def test_worker_failure_falls_back_in_process(self, aot_cache,
                                                  monkeypatch):
        monkeypatch.setattr(aot, "compile_in_subprocess",
                            lambda *a, **k: None)
        got, stats, t = play(add_line("k:5,aot:1"), FRAMES[:1], tracer=True)
        np.testing.assert_array_equal(got[0],
                                      np.full((2, 4), 5.0, np.float32))
        assert stats == {"jit_traces": 1}  # built in process
        ev = t.report()["aot"]["f"]["events"]
        assert [e["outcome"] for e in ev] == ["miss-failed"]


class TestModelFingerprint:
    def test_content_hash_survives_a_b_a_swap_as_in_jax(self, tmp_path):
        m = tmp_path / "model.bin"
        m.write_bytes(b"weights-A" * 100)
        fa = aot._model_fingerprint(str(m))
        assert fa.startswith("sha256:") and fa == jax_aot._model_fingerprint(
            str(m))
        m.write_bytes(b"weights-B" * 100)  # same size, new content
        fb = aot._model_fingerprint(str(m))
        assert fb != fa and fb == jax_aot._model_fingerprint(str(m))
        m.write_bytes(b"weights-A" * 100)  # same content, new mtime
        assert aot._model_fingerprint(str(m)) == fa

    def test_zoo_model_fingerprint_is_the_name(self):
        assert aot._model_fingerprint("add") == "add" \
            == jax_aot._model_fingerprint("add")


# --- key dimensions, in both packages ----------------------------------------

def _keys(mod, platform, variants):
    return [mod.cache_key("add", v.get("custom", "k:1"),
                          v.get("sig", SIG), platform, spec=v.get("spec"))
            for v in variants]


def _pattern(keys):
    """Which variants share a key: the same pattern in both packages."""
    return [keys.index(k) for k in keys]


class TestCacheKeyDimensions:
    def _both(self, variants):
        port = _keys(aot, "cpu", variants)
        ref = _keys(jax_aot, "cpu", variants)
        assert _pattern(port) == _pattern(ref)
        return port

    def test_same_inputs_same_key(self):
        keys = self._both([{}, {}, {"spec": {}}])
        assert len(set(keys)) == 1

    def test_flip_each_spec_dimension_misses(self):
        base = {"donate": False, "loop_window": 1, "launch_depth": 1}
        flips = ({"donate": True}, {"loop_window": 8}, {"launch_depth": 2},
                 {"stages_pre": [["typecast", "float32"]]})
        keys = self._both([{"spec": base}]
                          + [{"spec": dict(base, **f)} for f in flips])
        assert len(set(keys)) == len(keys)

    def test_custom_and_signature_key(self):
        keys = self._both([{}, {"custom": "k:2"},
                           {"sig": [((4, 4), "float32")]},
                           {"sig": [((2, 4), "uint8")]}])
        assert len(set(keys)) == 4

    def test_serve_batch_and_placement_key(self):
        keys = self._both([
            {"spec": {"placement": "replica", "serve_batch": [[8, 2, 4]]}},
            {"spec": {"placement": "replica", "serve_batch": [[16, 2, 4]]}},
            {"spec": {}},
            {"spec": {"placement": "replica", "serve_batch": [[8, 2, 4]],
                      "device_index": 1}}])
        assert len(set(keys)) == 4

    def test_mesh_rides_the_key_custom_channel(self):
        def shard(mode, n, tp):
            return "k:1|shard=" + json.dumps(
                {"mode": mode, "shard_devices": n, "tp_devices": tp},
                sort_keys=True)

        keys = self._both([{}, {"custom": shard("dp", 8, 1)},
                           {"custom": shard("tp", 8, 8)},
                           {"custom": shard("dpxtp", 8, 2)}])
        assert len(set(keys)) == 4

    def test_runtime_upgrade_is_a_miss(self, monkeypatch):
        base = _keys(aot, "cpu", [{}])[0]
        monkeypatch.setattr(aot, "runtime_fingerprint", lambda *a: {
            "torch": "999.0.0", "cuda": "99.9", "kernels": "0" * 16})
        assert _keys(aot, "cpu", [{}])[0] != base

    def test_runtime_fingerprint_names_the_port_runtime(self):
        fp = aot.runtime_fingerprint("cpu")
        assert fp["torch"] == torch.__version__
        assert fp["device_kind"] == "cpu" and len(fp["kernels"]) == 16
        assert fp["code"] == aot.code_digest()
        assert _keys(aot, "cpu", [{}]) != _keys(aot, "cuda", [{}])

    def test_code_digest_covers_the_python_that_builds_an_entry(
            self, tmp_path):
        """An edit to the seed draw, the fold or the restore (models/,
        ops/fused_block.py, ops/fusion_stages.py, filters/aot.py,
        aot_worker.py) changes the runtime fingerprint's ``code``."""
        import shutil

        pkg = os.path.join(REPO, "nnstreamer_tpu_torch")
        for rel in aot.CODE_FILES:
            src, dst = os.path.join(pkg, rel), tmp_path / rel
            if os.path.isdir(src):
                shutil.copytree(src, dst,
                                ignore=shutil.ignore_patterns("__pycache__"))
            else:
                dst.parent.mkdir(parents=True, exist_ok=True)
                shutil.copy(src, dst)
        base = aot.code_digest(str(tmp_path))
        assert base == aot.code_digest()
        for rel in ("models/mobilenet_v2.py", "ops/fused_block.py",
                    "filters/aot_worker.py"):
            f = tmp_path / rel
            text = f.read_text()
            f.write_text(text + "\n# edited\n")
            assert aot.code_digest(str(tmp_path)) != base, rel
            f.write_text(text)
        assert aot.code_digest(str(tmp_path)) == base

    def test_model_content_is_a_key_dimension(self, tmp_path):
        m = tmp_path / "m.bin"
        m.write_bytes(b"A" * 64)
        k1 = aot.cache_key(str(m), "", SIG, "cpu")
        m.write_bytes(b"B" * 64)
        assert aot.cache_key(str(m), "", SIG, "cpu") != k1


# --- bookkeeping: the same events in both packages --------------------------

def _sequence(mod, compile_fn, cache_root, monkeypatch):
    """One sequence of cache events; returns what each step observed."""
    log = []
    ev = []

    def step(custom, **kw):
        out = compile_fn(custom, observer=ev.append, **kw)
        log.append((custom, ev[-1]["outcome"], out is not None))

    step("k:1")
    step("k:1")
    step("k:1", budget_bytes=1)
    step("k:1", budget_bytes=1 << 40)
    step("k:2")
    rows = mod.cache_entries()
    log.append(("entries", len(rows)))
    k1 = next(r for r in rows if r["custom"] == "k:1")
    with open(k1["path"], "wb") as f:
        f.write(b"rotted")
    log.append(("load-corrupt", mod.load(k1["path"]) is None,
                os.path.exists(k1["path"]), len(mod.quarantined_entries())))
    step("k:1")  # the slot repopulates through a fresh worker
    # age k:2's last load an hour back, budget for exactly one entry
    k2 = next(r for r in mod.cache_entries() if r["custom"] == "k:2")
    past = k2["last_load"] - 3600
    os.utime(k2["path"], (past, past))
    keep = max(r["size"] for r in mod.cache_entries())
    monkeypatch.setenv("NNSTPU_AOT_CACHE_MAX_BYTES", str(keep))
    log.append(("evicted", mod.enforce_cache_budget(),
                [r["custom"] for r in mod.cache_entries()]))
    monkeypatch.delenv("NNSTPU_AOT_CACHE_MAX_BYTES")
    log.append(("purged", mod.purge_cache(), mod.cache_entries(),
                mod.quarantined_entries()))
    return log


def test_housekeeping_sequence_matches_jax(tmp_path, monkeypatch):
    """hit, miss, refused-budget, quarantine, eviction order and purge:
    the same events give the same outcomes in both packages, each with
    its real worker processes."""
    monkeypatch.setenv("NNSTPU_AOT_CACHE", str(tmp_path / "jax"))
    ref = _sequence(jax_aot, lambda c, **kw: jax_aot.maybe_aot_compile(
        "add", c, SIG, **kw), tmp_path / "jax", monkeypatch)
    monkeypatch.setenv("NNSTPU_AOT_CACHE", str(tmp_path / "port"))
    got = _sequence(aot, lambda c, **kw: compile_port(c, **kw),
                    tmp_path / "port", monkeypatch)
    assert got == ref
    assert [o for _, o, _ in got[:5]] == [
        "miss-compiled", "hit", "refused-budget", "hit", "miss-compiled"]
    assert got[-2] == ("evicted", 1, ["k:1"])


class TestCacheHousekeeping:
    def test_corrupt_entry_quarantined_not_raised(self, aot_cache,
                                                  inproc_worker):
        assert compile_port("k:7") is not None
        path = aot.cache_entries()[0]["path"]
        with open(path, "wb") as f:
            f.write(b"not an npz")
        assert aot.load(path, DEV) is None
        assert not os.path.exists(path)
        assert len(aot.quarantined_entries()) == 1
        assert compile_port("k:7") is not None
        assert len(inproc_worker) == 2

    def test_entries_hold_no_pickle(self, aot_cache, inproc_worker):
        """An entry is an npz of plain arrays plus JSON: it loads with
        allow_pickle=False, and a planted object array is quarantined."""
        assert compile_port("k:7") is not None
        path = aot.cache_entries()[0]["path"]
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
        assert meta["model"] == "add" and meta["custom"] == "k:7"
        with open(path, "wb") as f:
            np.savez(f, __meta__=np.array([{"x": 1}], dtype=object))
        assert aot.load(path, DEV) is None
        assert len(aot.quarantined_entries()) == 1

    def test_cache_dir_must_be_private(self, tmp_path, monkeypatch):
        d = tmp_path / "open"
        d.mkdir(mode=0o755)
        os.chmod(d, 0o755)
        monkeypatch.setenv("NNSTPU_AOT_CACHE", str(d))
        with pytest.raises(RuntimeError, match="group/world-accessible"):
            aot.cache_dir()
        os.chmod(d, 0o700)
        assert aot.cache_dir() == str(d / aot.SUBDIR)

    def test_memplan_refused_hit_is_miss_not_oom(self, aot_cache,
                                                 inproc_worker):
        assert compile_port("k:9") is not None
        events = []
        assert compile_port("k:9", budget_bytes=1,
                            observer=events.append) is None
        assert events[-1]["outcome"] == "refused-budget"
        events.clear()
        assert compile_port("k:9", budget_bytes=1 << 40,
                            observer=events.append) is not None
        assert events[-1]["outcome"] == "hit"


def test_both_packages_share_one_cache_and_stay_warm(aot_cache):
    """The port keeps its entries under ``torch/``: the JAX package's
    listing, eviction and purge never reach them, and the port never
    reads the JAX package's entries."""
    assert jax_aot.maybe_aot_compile("add", "k:2", SIG) is not None
    assert compile_port("k:2") is not None
    assert [r["file"].endswith(".nnstpu-aot")
            for r in jax_aot.cache_entries()] == [True]
    assert [r["file"].endswith(aot.SUFFIX)
            for r in aot.cache_entries()] == [True]
    os.environ["NNSTPU_AOT_CACHE_MAX_BYTES"] = "1"
    try:
        assert jax_aot.enforce_cache_budget() == 1  # its own entry only
    finally:
        del os.environ["NNSTPU_AOT_CACHE_MAX_BYTES"]
    ev = []
    assert compile_port("k:2", observer=ev.append) is not None
    assert ev[-1]["outcome"] == "hit"
    assert jax_aot.maybe_aot_compile("add", "k:2", SIG) is not None
    assert jax_aot.purge_cache() == 1
    ev.clear()
    assert compile_port("k:2", observer=ev.append) is not None
    assert ev[-1]["outcome"] == "hit"
    assert jax_aot.cache_entries() == []


# --- a loaded program bit-equal to the in-process build -----------------------

MBV2 = "seed:0,fused:pallas,size:32,width:0.35,classes:10,postproc:argmax"


def test_mobilenet_program_bit_equal_to_in_process(aot_cache):
    """A narrow MobileNet-v2 with the fused preamble: the worker (a real
    subprocess) folds on the CPU, the parent loads; the labels composed
    around the loaded model and its folded forward's logits equal the
    in-process build's bit for bit."""
    from nnstreamer_tpu_torch.filters.cuda_filter import compose, make_postproc
    from nnstreamer_tpu_torch.models import build_bundle
    from nnstreamer_tpu_torch.ops.fusion_stages import build_stage_fn

    pre = [["typecast", "float32"], ["arith", [["mul", 1.0]]]]
    program = aot.maybe_aot_compile(
        "mobilenet_v2", MBV2, [((4, 32, 32, 3), "uint8")], device=DEV,
        spec={"stages_pre": pre})
    assert program is not None
    assert program.meta["programs"]["head"]["form"] == "folded"
    assert program.head.recipe["kind"] == "mobilenet_v2"
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (4, 32, 32, 3), dtype=np.uint8))
    cd = aot.custom_dict(MBV2)
    live = build_bundle("mobilenet_v2", cd, DEV)
    stage = build_stage_fn(pre)
    want = compose([x], stage, live.apply_fn, make_postproc(cd), None)
    got = compose([x], stage, program.head.apply_fn, make_postproc(cd), None)
    assert torch.equal(got[0], want[0])
    xf = x.to(torch.float32)
    assert torch.equal(program.head.apply_fn(xf), live.apply_fn(xf))
    flat, _ = live.folded()
    loaded = program.head.module.tensors()
    assert sorted(loaded) == sorted(flat)
    assert all(torch.equal(loaded[k], flat[k]) for k in flat)


def test_mobilenet_line_aot_equals_in_process(aot_cache):
    caps = ("other/tensors,num-tensors=1,dimensions=3:32:32:2,types=uint8,"
            "framerate=0/1")
    frames = [np.random.default_rng(i).integers(0, 256, (2, 32, 32, 3),
                                                dtype=np.uint8)
              for i in range(2)]
    outs = {}
    for mode in ("aot:1", "aot:0"):
        line = (f"appsrc name=src caps={caps} ! tensor_filter name=f "
                f"framework=jax model=mobilenet_v2 custom={MBV2},{mode} "
                f"{CPU} ! tensor_sink name=out")
        outs[mode], stats, _ = play(line, frames)
        assert stats == {"jit_traces": 0 if mode == "aot:1" else 1}
    for a, b in zip(outs["aot:1"], outs["aot:0"]):
        np.testing.assert_array_equal(a, b)


NARROW = "fused:pallas,size:32,width:0.35,classes:10"


def _save_seed(path, seed):
    from nnstreamer_tpu_torch.models import build_bundle, save_state

    b = build_bundle("mobilenet_v2", aot.custom_dict(f"seed:{seed},{NARROW}"),
                     DEV)
    save_state(b.module.state_dict(), str(path))


def test_params_file_rewritten_is_a_miss(aot_cache, tmp_path, inproc_worker):
    """An entry holds the weights ``params:<path>`` names, so the file's
    content keys it: rewritten between two plays, the second play is a
    miss and streams the new weights' logits, as ``aot:0`` does."""
    params = tmp_path / "w.npz"
    caps = ("other/tensors,num-tensors=1,dimensions=3:32:32:1,types=uint8,"
            "framerate=0/1")
    frames = [np.random.default_rng(3).integers(0, 256, (1, 32, 32, 3),
                                                dtype=np.uint8)]

    def line(mode):
        return (f"appsrc name=src caps={caps} ! tensor_filter name=f "
                f"framework=jax model=mobilenet_v2 "
                f"custom=params:{params},{NARROW},{mode} {CPU} "
                "! tensor_sink name=out")

    plays = []
    for seed in (0, 1):
        _save_seed(params, seed)
        got, _, t = play(line("aot:1"), frames, tracer=True)
        want, _, _ = play(line("aot:0"), frames)
        np.testing.assert_array_equal(got[0], want[0])
        plays.append((got[0], [e["outcome"]
                               for e in t.report()["aot"]["f"]["events"]]))
    assert [o for _, o in plays] == [["miss-compiled"], ["miss-compiled"]]
    assert not np.array_equal(plays[0][0], plays[1][0])
    assert len(aot.cache_entries()) == 2
    assert aot.params_fingerprint(f"params:{params},{NARROW}") \
        == aot._model_fingerprint(str(params))
    assert aot.params_fingerprint(NARROW) == ""


def test_chain_tail_params_file_keys_the_chain(tmp_path):
    """A chain tail's ``params:`` file content rides the head's chain
    spec, so a tail retrained in place keys the chain apart."""
    from nnstreamer_tpu_torch.filters.base import FilterProperties
    from nnstreamer_tpu_torch.filters.cuda_filter import TorchCudaFilter
    from nnstreamer_tpu_torch.ops.fusion_stages import ModelStage

    params = tmp_path / "tail.npz"
    _save_seed(params, 0)
    tail = TorchCudaFilter()
    tail.open(FilterProperties(framework="jax", model_files=["mobilenet_v2"],
                               custom=f"params:{params},{NARROW}",
                               accelerator="true:cpu"))
    head = TorchCudaFilter()
    head.open(FilterProperties(framework="jax", model_files=["add"],
                               custom="k:1", accelerator="true:cpu"))
    head._chain_stages = [("model", ModelStage("t", tail))]
    first = head._chain_spec()
    assert first[0][1]["params"] == aot._model_fingerprint(str(params))
    _save_seed(params, 1)
    second = head._chain_spec()
    assert second != first
    assert aot.cache_key("add", "k:1", SIG, "cpu", spec={"chain": first}) \
        != aot.cache_key("add", "k:1", SIG, "cpu", spec={"chain": second})
    head.close()
    tail.close()


def test_checkpoint_model_keys_on_its_bytes(aot_cache, tmp_path,
                                            inproc_worker):
    """model=<checkpoint> custom=arch:<zoo>: the file's bytes are the
    model's fingerprint, so two checkpoints of one signature are two
    entries, and A again is a hit."""
    from nnstreamer_tpu_torch.models import build_bundle, save_state

    cd = "fused:pallas,size:32,width:0.35,classes:10"
    paths = []
    for seed in (0, 1):
        b = build_bundle("mobilenet_v2", aot.custom_dict(f"seed:{seed},{cd}"),
                         DEV)
        paths.append(str(tmp_path / f"m{seed}.npz"))
        save_state(b.module.state_dict(), paths[-1])
    sig = [((1, 32, 32, 3), "uint8")]
    ev = []
    for path in paths + paths[:1]:
        assert aot.maybe_aot_compile(path, f"arch:mobilenet_v2,{cd}", sig,
                                     device=DEV, observer=ev.append)
    assert [e["outcome"] for e in ev] == ["miss-compiled", "miss-compiled",
                                          "hit"]


# --- a fresh process warm-starts --------------------------------------------

def test_fresh_process_warm_starts_with_zero_builds(aot_cache):
    parent, _, _ = play(add_line("k:2,aot:1"), FRAMES)
    assert len(aot.cache_entries()) == 1
    code = textwrap.dedent("""
        import json, sys
        sys.path.insert(0, %r)
        import numpy as np
        from nnstreamer_tpu_torch import trace
        from nnstreamer_tpu_torch.buffer import Buffer
        from nnstreamer_tpu_torch.pipeline import parse_launch
        p = parse_launch(%r)
        tracer = trace.attach(p)
        p.play()
        for i in range(3):
            p["src"].push_buffer(Buffer(tensors=[
                np.full((2, 4), float(i), np.float32)]))
        p["src"].end_of_stream()
        assert p.bus.wait_eos(60)
        outs = [np.asarray(b[0]).tolist() for b in p["out"].collected]
        rep = (tracer.report().get("aot") or {}).get("f") or {}
        print(json.dumps({
            "outs": outs,
            "jit_traces": p["f"].fw.compile_stats()["jit_traces"],
            "hits": rep.get("hits", 0), "misses": rep.get("misses", 0)}))
        p.stop()
    """ % (REPO, add_line("k:2,aot:1")))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=dict(os.environ))
    assert r.returncode == 0, r.stderr[-800:]
    child = json.loads(r.stdout.strip().splitlines()[-1])
    assert child["jit_traces"] == 0
    assert child["hits"] == 1 and child["misses"] == 0
    for mine, theirs in zip(parent, child["outs"]):
        np.testing.assert_array_equal(mine, np.asarray(theirs, np.float32))
    assert len(aot.cache_entries()) == 1


# --- NNST970–972 -------------------------------------------------------------

def _fixture_lines():
    out, expect = [], None
    with open(os.path.join(REPO, "examples", "launch_lines_aot.txt")) as f:
        for i, raw in enumerate(f, 1):
            line = raw.strip()
            if line.startswith("# EXPECT:"):
                expect = line.split(":", 1)[1].strip()
            elif line and not line.startswith("#"):
                out.append((i, line, expect))
                expect = None
    return out


@pytest.mark.parametrize("lineno,line,expect", _fixture_lines(),
                         ids=[str(i) for i, _, _ in _fixture_lines()])
def test_fixture_codes_match_reference(lineno, line, expect, tmp_path,
                                       monkeypatch):
    """On a cold cache each line of the fixture gives the reference's
    codes (the WARM line is cold until played, hence its EXPECT lists
    NNST971 too)."""
    monkeypatch.setenv("NNSTPU_AOT_CACHE", str(tmp_path / "aot"))
    got = sorted(d.code for d in analyze_launch(line, extra=["aot"]))
    want = sorted(d.code for d in jax_analysis.analyze_launch(
        line, extra=["aot"]))
    assert got == want
    for code in expect.split(","):
        assert code in got, (code, got)


class TestAotAnalysisPass:
    LINE = add_line("k:2,aot:1")

    def _diags(self):
        return analyze_launch(self.LINE, extra=["aot"])

    def _play_once(self):
        play(self.LINE, FRAMES[:1])

    def test_nnst970_and_971_on_cold_cache(self, aot_cache):
        diags = self._diags()
        d970 = next(d for d in diags if d.code == "NNST970")
        assert d970.severity == "info" and "0/1 predicted warm" in d970.message
        d971 = next(d for d in diags if d.code == "NNST971")
        assert d971.severity == "warning" and d971.element == "f"
        assert "aot_prefetch" in (d971.hint or "")

    def test_warm_cache_lints_strict_clean_in_both_packages(self, aot_cache):
        """After one PLAYING the predicted key MATCHES the entry the
        runtime wrote — in each package against its own cache."""
        self._play_once()
        play(add_line("k:2,aot:1", ""), FRAMES[:1],
             jax_pipeline.parse_launch, JaxBuffer)
        for diags in (self._diags(), jax_analysis.analyze_launch(
                add_line("k:2,aot:1", ""), extra=["aot"])):
            codes = {d.code for d in diags}
            assert "NNST970" in codes, codes
            assert not codes & {"NNST971", "NNST972"}, codes
            d970 = next(d for d in diags if d.code == "NNST970")
            assert "1/1 predicted warm" in d970.message

    def test_nnst972_on_runtime_drift(self, aot_cache, inproc_worker,
                                      monkeypatch):
        self._play_once()
        monkeypatch.setattr(aot, "runtime_fingerprint", lambda *a: {
            "torch": "999.0.0", "cuda": "99.9", "kernels": "0" * 16})
        diags = self._diags()
        codes = {d.code for d in diags}
        assert "NNST971" in codes and "NNST972" in codes
        d972 = next(d for d in diags if d.code == "NNST972")
        assert "never be loaded again" in d972.message
        assert "--aot-purge" in (d972.hint or "")

    def test_nnst972_on_quarantined_entry(self, aot_cache, inproc_worker):
        self._play_once()
        path = aot.cache_entries()[0]["path"]
        with open(path, "wb") as f:
            f.write(b"rotted")
        assert aot.load(path, DEV) is None  # → quarantine/
        d972 = [d for d in self._diags() if d.code == "NNST972"]
        assert d972 and "quarantined" in d972[0].message

    def test_default_lint_emits_no_nnst97x(self, aot_cache):
        assert not [d for d in analyze_launch(self.LINE)
                    if d.code.startswith("NNST97")]

    def test_aot_off_line_emits_no_nnst97x(self, aot_cache):
        line = self.LINE.replace("aot:1", "aot:0")
        assert not [d for d in analyze_launch(line, extra=["aot"])
                    if d.code.startswith("NNST97")]

    def test_validate_cli_aot_flag(self, aot_cache, capsys):
        from nnstreamer_tpu_torch.tools import validate

        assert validate.main(["--aot", "--json", self.LINE]) == 1
        doc = json.loads(capsys.readouterr().out)
        assert {d["code"] for d in doc["results"][0]["diagnostics"]
                if d["code"].startswith("NNST97")} == {"NNST970", "NNST971"}


class TestMeshAot:
    def test_sharded_aot_matches_in_process(self, aot_cache, monkeypatch):
        """custom=shard:dp,aot:1 over eight CPU positions: the mesh
        program's entry keys the shard, and the streamed result equals
        the in-process mesh's."""
        monkeypatch.setenv("NNSTPU_TORCH_DEVICES", "cpu*8")
        x = np.arange(32, dtype=np.float32).reshape(8, 4)
        caps = ("other/tensors,num-tensors=1,dimensions=4:8,"
                "types=float32,framerate=0/1")
        results = {}
        for tag, custom in (("jit", "k:2.5,shard:dp"),
                            ("aot", "k:2.5,shard:dp,aot:1")):
            line = (f"appsrc name=src caps={caps} ! tensor_filter name=f "
                    f"framework=jax model=add custom={custom} {CPU} "
                    "! tensor_sink name=out")
            results[tag], _, _ = play(line, [x])
        rows = aot.cache_entries()
        assert len(rows) == 1 and "|shard=" not in rows[0]["custom"]
        assert json.loads(json.dumps(rows[0]["spec"])) == {}
        meta = aot.entry_meta(rows[0]["path"])
        assert meta["shard"] == {"mode": "dp", "shard_devices": 8,
                                 "tp_devices": 2}
        np.testing.assert_array_equal(results["aot"][0], results["jit"][0])
        np.testing.assert_allclose(results["aot"][0], x + 2.5, rtol=1e-6)


# --- the window and the replica pool under the cache --------------------------

def test_loop_window_keys_apart_and_matches(aot_cache, inproc_worker):
    """loop-window=4 launch-depth=2: the window's program is an entry of
    its own (the window and depth are key dimensions), and the stream
    equals the solo program's."""
    frames = [np.full((2, 4), float(i), np.float32) for i in range(8)]
    solo, _, _ = play(add_line("k:2,aot:1"), frames)
    looped, _, t = play(add_line("k:2,aot:1",
                                 f"{CPU} loop-window=4 launch-depth=2"),
                        frames, tracer=True)
    for a, b in zip(looped, solo):
        np.testing.assert_array_equal(a, b)
    ev = t.report()["aot"]["f"]["events"]
    assert [e["outcome"] for e in ev] == ["miss-compiled"]
    assert ev[0]["spec"] == {"loop_window": 4, "launch_depth": 2}
    assert len(aot.cache_entries()) == 2


def test_replica_pool_loads_one_program_per_replica(aot_cache, monkeypatch,
                                                    inproc_worker):
    """Two replicas under the cache: each loads its own entry (the
    placement, the serve batch and the replica's index key it), and each
    replica's outputs equal the in-process pool's."""
    from nnstreamer_tpu_torch.filters.base import FilterProperties
    from nnstreamer_tpu_torch.filters.cuda_filter import TorchCudaFilter

    monkeypatch.setenv("NNSTPU_TORCH_DEVICES", "cpu*2")
    x = np.arange(32, dtype=np.float32).reshape(8, 4)
    outs = {}
    for mode in ("aot:1", "aot:0"):
        fw = TorchCudaFilter()
        fw.open(FilterProperties(framework="jax", model_files=["add"],
                                 custom=f"k:4,{mode}",
                                 accelerator="true:cpu"))
        assert fw.build_replicas(2)
        outs[mode] = [fw.invoke_replica(r, [x])[0].numpy()
                      for r in (0, 1)]
        events = fw.take_aot_events()
        fw.close()
        if mode == "aot:1":
            assert [e["outcome"] for e in events] == ["miss-compiled"] * 2
            assert [e["spec"]["device_index"] for e in events] == [0, 1]
            assert {e["spec"]["placement"] for e in events} == {"replica"}
    for a, b in zip(outs["aot:1"], outs["aot:0"]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, x + 4.0)


def test_chain_under_the_cache_swaps_in_the_tails_state(aot_cache,
                                                         monkeypatch):
    """A chain-fused head and tail, both ``aot:1``: the head's entry holds
    the tail's state too, which the load swaps in for the tail's skeleton;
    the filter composes the chain with its own code, so nothing builds in
    the streaming process, and the stream equals ``aot:0``'s."""
    from nnstreamer_tpu_torch.filters import cuda_filter

    caps = ("other/tensors,num-tensors=1,dimensions=3:32:32:2,types=uint8,"
            "framerate=0/1")
    frames = [np.random.default_rng(i).integers(0, 256, (2, 32, 32, 3),
                                                dtype=np.uint8)
              for i in range(2)]

    def line(mode):
        return (f"appsrc name=src caps={caps} ! tensor_filter name=f "
                f"framework=jax model=mobilenet_v2 "
                f"custom=seed:0,{NARROW},{mode} {CPU} ! tensor_filter name=h "
                f"framework=jax model=matmul custom=dim:10,seed:1,{mode} "
                f"{CPU} ! tensor_sink name=out")

    want, _, _ = play(line("aot:0"), frames)
    built = []
    real = cuda_filter.build_bundle
    monkeypatch.setattr(cuda_filter, "build_bundle",
                        lambda *a, **k: built.append(a[0]) or real(*a, **k))
    got, stats, t = play(line("aot:1"), frames, tracer=True)
    ev = t.report()["aot"]["f"]["events"]
    assert [e["outcome"] for e in ev] == ["miss-compiled"]
    assert ev[0]["spec"]["chain"][0][1]["model"] == "matmul"
    assert built == [] and stats == {"jit_traces": 0}
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
