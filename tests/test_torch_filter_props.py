"""tensor_filter's micro-batching (``batch-size``), upload window
(``feed-depth``), fetch window (``fetch-window=K|eos|auto``) and quiescence
flush (``fetch-timeout-ms``) through both packages, on the CPU.

The cases of tests/test_microbatch.py, test_upload_window.py and
test_fetch_window.py that need no unported feature: the same launch line
and the same frames (made with numpy) go through the JAX package and the
port, each with its own ``custom-easy`` probe or ``fake-rtt`` backend
registered in its own registry. Both must give the same outputs (exactly:
the probes compute ``x * 2`` or ``x * 3`` in float32), the same pts, the
same invoke count and batch sizes at the probe, the same order and the
same EOS drain. "Device" outputs are ``jax.Array``s in the JAX package and
torch tensors in the port (``buffer.is_backend_tensor``). Timing
assertions keep the JAX tests' own bars.
"""

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

from test_torch_pipeline import CUSTOM, N_FRAMES, weights  # noqa: E402,F401

CAPS = ("other/tensors,num-tensors=1,dimensions=4:1,types=float32,"
        "framerate=30/1")
CAPS_1D = ("other/tensors,num-tensors=1,dimensions=4,types=float32,"
           "framerate=30/1")


class Pkg:
    """One package's entry points, so a case reads the same for both."""

    def __init__(self, name):
        self.name = name
        if name == "jax":
            from nnstreamer_tpu import registry, trace
            from nnstreamer_tpu.buffer import Buffer, Event
            from nnstreamer_tpu.elements.filter import TensorFilter
            from nnstreamer_tpu.filters import base
            from nnstreamer_tpu.pipeline import parse_launch
            from nnstreamer_tpu.types import TensorsInfo

            self.to_device = jnp.asarray
        else:
            from nnstreamer_tpu_torch import registry, trace
            from nnstreamer_tpu_torch.buffer import Buffer, Event
            from nnstreamer_tpu_torch.elements.filter import TensorFilter
            from nnstreamer_tpu_torch.filters import base
            from nnstreamer_tpu_torch.pipeline import parse_launch
            from nnstreamer_tpu_torch.types import TensorsInfo

            self.to_device = lambda a: torch.from_numpy(np.array(a))
        self.registry, self.trace = registry, trace
        self.Buffer, self.Event = Buffer, Event
        self.TensorFilter, self.base = TensorFilter, base
        self.parse_launch, self.TensorsInfo = parse_launch, TensorsInfo

    def register(self, model, fn):
        info = self.TensorsInfo.from_strings("4:1", "float32")
        self.base.register_custom_easy(model, fn, info, info)

    def unregister(self, model):
        self.base.unregister_custom_easy(model)


PKGS = {name: Pkg(name) for name in ("jax", "port")}


def both(fn):
    """fn(pkg) for each package → {name: result}."""
    return {name: fn(pkg) for name, pkg in PKGS.items()}


def frames_of(n, shape=(1, 4)):
    return [np.full(shape, float(i), np.float32) for i in range(n)]


def run_line(pkg, line, frames, eos_timeout=30):
    """Push frames (pts i*1000), EOS, collect: (outputs as numpy, pts)."""
    p = pkg.parse_launch(line)
    p.play()
    for i, f in enumerate(frames):
        p["src"].push_buffer(pkg.Buffer(tensors=[f], pts=i * 1000))
    p["src"].end_of_stream()
    assert p.bus.wait_eos(eos_timeout)
    err = p.bus.error
    collected = list(p["out"].collected)
    p.stop()
    if err:
        raise err.data["error"]
    return ([np.asarray(b.tensors[0]) for b in collected],
            [b.pts for b in collected], collected)


def assert_same(results, frames, factor):
    """Both packages: one output per frame, in order, x * factor, pts kept."""
    for name, (outs, pts, _) in results.items():
        assert len(outs) == len(frames), name
        for i, out in enumerate(outs):
            np.testing.assert_array_equal(
                out.reshape(frames[i].shape), frames[i] * factor)
        assert pts == [i * 1000 for i in range(len(frames))], name
    jo, po = results["jax"][0], results["port"][0]
    for a, b in zip(jo, po):
        np.testing.assert_array_equal(a, b)


# -- custom-easy probes ----------------------------------------------------

@pytest.fixture
def probes():
    """batch_probe (host x*2, records batch sizes), dev_double (device
    x*2, records batch sizes), host_triple (host x*3) in both packages."""
    calls = {name: {"batch_probe": [], "dev_double": []} for name in PKGS}

    for name, pkg in PKGS.items():
        def probe(xs, c=calls[name]["batch_probe"]):
            c.append(int(np.asarray(xs[0]).shape[0]))
            time.sleep(0.0002)  # measurable invoke time for latency
            return [np.asarray(xs[0]) * 2]

        def dev_double(xs, c=calls[name]["dev_double"], dev=pkg.to_device):
            c.append(int(np.asarray(xs[0]).shape[0]))
            return [dev(np.asarray(xs[0]) * 2)]

        pkg.register("batch_probe", probe)
        pkg.register("dev_double", dev_double)
        pkg.register("host_triple", lambda xs: [np.asarray(xs[0]) * 3])
    yield calls
    for pkg in PKGS.values():
        for m in ("batch_probe", "dev_double", "host_triple"):
            pkg.unregister(m)


def easy_line(model, extra="", caps=CAPS):
    return (f"appsrc name=src caps={caps} ! tensor_filter name=f "
            f"framework=custom-easy model={model} {extra} "
            "! tensor_sink name=out")


# -- micro-batching (tests/test_microbatch.py) ------------------------------

@pytest.mark.parametrize("n,batch,invokes", [
    (4, 2, [2, 2]),   # full batches
    (3, 2, [2, 2]),   # partial batch padded at EOS
    (3, 1, [1, 1, 1]),  # batch one is passthrough
])
def test_micro_batch(probes, n, batch, invokes):
    frames = frames_of(n)
    res = both(lambda pkg: run_line(
        pkg, easy_line("batch_probe", f"batch-size={batch}"), frames))
    assert_same(res, frames, 2)
    for name in PKGS:
        assert probes[name]["batch_probe"] == invokes


def test_non_batch_major_frames_stacked(probes):
    frames = [np.full(4, v, np.float32) for v in (1.0, 2.0)]
    res = both(lambda pkg: run_line(
        pkg, easy_line("batch_probe", "batch-size=2", CAPS_1D), frames))
    for name, (outs, _, _) in res.items():
        assert probes[name]["batch_probe"] == [2]
        assert len(outs) == 2
        np.testing.assert_array_equal(outs[0].reshape(-1), np.full(4, 2.0))
        np.testing.assert_array_equal(outs[1].reshape(-1), np.full(4, 4.0))
        assert outs[0].shape == res["jax"][0][0].shape


def _latency_run(pkg, extra, n, sleeps=None):
    p = pkg.parse_launch(easy_line("batch_probe", extra))
    p.play()
    for i in range(n):
        p["src"].push_buffer(pkg.Buffer(
            tensors=[np.full((1, 4), float(i), np.float32)]))
        if sleeps and sleeps(i):
            time.sleep(0.05)
    p["src"].end_of_stream()
    assert p.bus.wait_eos(10)
    out = (p.query_latency(), p["f"].get_property("latency"),
           p["f"].get_property("latency-e2e"))
    p.stop()
    return out


def test_reported_latency(probes):
    for name, (lat, avg_us, _) in both(lambda pkg: _latency_run(
            pkg, "latency=1 latency-report=1", 5)).items():
        assert avg_us > 0, name
        assert lat == pytest.approx(avg_us * 1.15 * 1000, rel=0.1), name


def test_latency_report_alone_measures(probes):
    for name, (lat, _, _) in both(lambda pkg: _latency_run(
            pkg, "latency-report=1", 4)).items():
        assert lat > 0, name


def test_no_report_no_latency(probes):
    for name, (lat, _, _) in both(lambda pkg: _latency_run(
            pkg, "latency=1", 1)).items():
        assert lat == 0, name


def test_e2e_latency_includes_batch_wait(probes):
    """latency is per-frame compute; latency-e2e includes the fill wait."""
    for name, (_, compute_us, e2e_us) in both(lambda pkg: _latency_run(
            pkg, "batch-size=4 latency=1", 8,
            sleeps=lambda i: i % 4 != 3)).items():
        assert compute_us > 0 and e2e_us > 0, name
        assert e2e_us >= 50_000, (name, e2e_us)
        assert compute_us < 20_000, (name, compute_us)
        assert e2e_us > 2 * compute_us, name


def test_e2e_latency_equals_invoke_at_batch_one(probes):
    for name, (_, compute_us, e2e_us) in both(lambda pkg: _latency_run(
            pkg, "latency=1", 11)).items():
        assert e2e_us >= compute_us > 0, name
        assert e2e_us < compute_us + 150_000, name


def test_e2e_enable_alone_stamps(probes):
    for name, (_, _, e2e_us) in both(lambda pkg: _latency_run(
            pkg, "latency-e2e=1", 4)).items():
        assert e2e_us > 0, name


# -- fetch window (tests/test_fetch_window.py) ------------------------------

@pytest.mark.parametrize("n,extra,invokes", [
    (6, "fetch-window=3", [1] * 6),
    (7, "fetch-window=3", [1] * 7),  # partial window flushed at EOS
    (8, "batch-size=2 fetch-window=2", [2] * 4),
    (12, "batch-size=4 fetch-window=2", [4] * 3),
    (12, "fetch-window=auto", [1] * 12),
    (10, "fetch-window=eos", [1] * 10),
])
def test_fetch_window(probes, n, extra, invokes):
    frames = frames_of(n)
    res = both(lambda pkg: run_line(pkg, easy_line("dev_double", extra),
                                    frames))
    assert_same(res, frames, 2)
    for name, (_, _, bufs) in res.items():
        assert probes[name]["dev_double"] == invokes, name
        # materialized at the window's one transfer
        assert all(isinstance(b.tensors[0], np.ndarray) for b in bufs)


def _held_until(pkg, line, first, then=1, timeout=0.5):
    """Push ``first`` frames: nothing may come out; push ``then`` more:
    something must. Returns (early, late)."""
    p = pkg.parse_launch(line)
    p.play()
    for _ in range(first):
        p["src"].push_buffer(pkg.Buffer(
            tensors=[np.zeros((1, 4), np.float32)]))
    early = p["out"].pull(timeout=timeout)
    for _ in range(then):
        p["src"].push_buffer(pkg.Buffer(
            tensors=[np.zeros((1, 4), np.float32)]))
    late = p["out"].pull(timeout=5.0)
    p["src"].end_of_stream()
    assert p.bus.wait_eos(10)
    p.stop()
    return early, late


def test_outputs_held_until_window_full(probes):
    for name, (early, late) in both(lambda pkg: _held_until(
            pkg, easy_line("dev_double", "fetch-window=4"), 3)).items():
        assert early is None and late is not None, name


def test_host_outputs_bypass_window(probes):
    for name, (early, _) in both(lambda pkg: _held_until(
            pkg, easy_line("host_triple", "fetch-window=8"), 1,
            timeout=5.0)).items():
        assert early is not None, name  # emitted at once
        np.testing.assert_array_equal(early[0],
                                      np.zeros((1, 4), np.float32))


def test_eos_window_holds_until_eos(probes):
    for name, (early, late) in both(lambda pkg: _held_until(
            pkg, easy_line("dev_double", "fetch-window=eos"), 10, then=0,
            timeout=0.3)).items():
        assert early is None, name


def _pull_n(p, n, deadline_s=5.0):
    got, deadline = [], time.time() + deadline_s
    while len(got) < n and time.time() < deadline:
        b = p["out"].pull(timeout=0.5)
        if b is not None:
            got.append(b)
    return got


@pytest.mark.parametrize("model,extra", [
    ("dev_double", "batch-size=4 fetch-window=8 fetch-timeout-ms=150"),
    ("dev_double", "fetch-window=8 fetch-timeout-ms=150"),
])
def test_fetch_timeout_flushes_quiescent_stream(probes, model, extra):
    """A live pipeline that never sends EOS: the quiescence flush (on the
    timer thread, under the window lock) emits the partial batch and the
    held window, in order."""
    def run(pkg):
        p = pkg.parse_launch(easy_line(model, extra))
        p.play()
        for i in range(6):
            p["src"].push_buffer(pkg.Buffer(
                tensors=[np.full((1, 4), float(i), np.float32)],
                pts=i * 1000))
        got = _pull_n(p, 6)
        err = p.bus.error
        p.stop()
        return got, err

    for name, (got, err) in both(run).items():
        assert err is None, (name, err)
        assert len(got) == 6, (name, len(got))
        for i, out in enumerate(got):
            np.testing.assert_array_equal(np.asarray(out[0]),
                                          np.full((1, 4), i * 2.0))


def test_auto_window_stays_bounded_and_retunes(probes):
    def run(pkg):
        p = pkg.parse_launch(easy_line("dev_double", "fetch-window=auto"))
        p.play()
        for _ in range(64):
            p["src"].push_buffer(pkg.Buffer(
                tensors=[np.zeros((1, 4), np.float32)]))
        p["src"].end_of_stream()
        assert p.bus.wait_eos(10)
        f = p["f"]
        out = (f._auto_window, f._last_flush_t, len(p["out"].collected))
        p.stop()
        return out

    for name, (w, last, n) in both(run).items():
        cls = PKGS[name].TensorFilter
        assert 1 <= w <= cls._AUTO_WINDOW_MAX, name
        assert last is not None and n == 64, name


def test_auto_constants_match():
    a, b = PKGS["jax"].TensorFilter, PKGS["port"].TensorFilter
    for k in ("_AUTO_WINDOW_MAX", "_AUTO_OVERHEAD", "_AUTO_SATURATED_WINDOW",
              "_EOS_WINDOW_CAP"):
        assert getattr(a, k) == getattr(b, k), k
    assert (b._AUTO_WINDOW_MAX, b._AUTO_OVERHEAD,
            b._AUTO_SATURATED_WINDOW) == (64, 0.25, 16)


#: injected regimes for fetch-window=auto: (idle, busy) EWMAs, the window
#: before, seconds since the last flush, then (k, t_block, t_fetch)
RETUNE_CASES = {
    "saturated_snaps": ((0.001, 0.1), 2, 0.25, (2, 0.0, 0.1)),
    "saturated_holds": ((0.001, 0.1), 16, 2.0, (16, 0.0, 1.5)),
    "live_cheap_fetch_shrinks": ((1.0, 0.1), 16, 0.35, (16, 0.0, 0.001)),
    "live_rtt_fetch_steps": ((0.033, 0.002), 2, 0.25, (2, 0.0, 0.1)),
    "live_grows_by_doubling": ((0.05, 0.001), 4, 0.02, (4, 0.001, 0.05)),
    "no_history": ((None, None), 2, None, (3, 0.002, 0.0004)),
    "block_dominates": ((0.02, 0.01), 8, 0.001, (8, 0.08, 0.01)),
}


@pytest.mark.parametrize("case", sorted(RETUNE_CASES))
def test_auto_retune_matches_on_injected_timings(probes, case, monkeypatch):
    """The same window decision from the same timings: the clock is pinned
    and the regime EWMAs, the window and the last flush are injected."""
    (idle, busy), w0, gap, (k, t_block, t_fetch) = RETUNE_CASES[case]
    now = 1000.0
    monkeypatch.setattr(time, "perf_counter", lambda: now)

    def decide(pkg):
        f = pkg.TensorFilter(name="f", framework="custom-easy",
                             model="dev_double", fetch_window="auto")
        f._arr_idle_ewma, f._arr_busy_ewma = idle, busy
        f._auto_window = w0
        f._last_flush_t = None if gap is None else now - gap
        f._retune_auto_window(k, t_block=t_block, t_fetch=t_fetch)
        return f._auto_window, f._stream_saturated()

    got = both(decide)
    assert got["jax"] == got["port"], got


# -- upload window (tests/test_upload_window.py) ----------------------------

def make_rtt_backend(pkg, device_outputs):
    """The fake-rtt backend of tests/test_upload_window.py in ``pkg``:
    prefetch starts an 'upload' that completes RTT seconds later
    independently of other in-flight uploads; invoke blocks until its
    input's upload completed (inline: one full RTT)."""
    PrefetchedInputs = pkg.base.PrefetchedInputs

    class RttBackend(pkg.base.FilterFramework):
        NAME = "fake-rtt"
        RTT = 0.05

        def __init__(self):
            super().__init__()
            self.prefetch_calls = 0
            self.invoke_batches = []

        def get_model_info(self):
            info = pkg.TensorsInfo.from_strings("4:1", "float32")
            return info, info

        def prefetch(self, inputs):
            self.prefetch_calls += 1
            h = PrefetchedInputs([np.asarray(x) for x in inputs],
                                 donatable=True)
            h.ready_at = time.monotonic() + self.RTT
            return h

        def invoke(self, inputs):
            if isinstance(inputs, PrefetchedInputs):
                wait = inputs.ready_at - time.monotonic()
                if wait > 0:
                    time.sleep(wait)
            else:
                time.sleep(self.RTT)
            x = np.asarray(inputs[0])
            self.invoke_batches.append(int(x.shape[0]) if x.ndim else 0)
            out = x * 2
            return [pkg.to_device(out) if device_outputs else out]

    return RttBackend


@pytest.fixture
def rtt():
    """fake-rtt (host outputs) and fake-rtt-dev (device outputs) in both
    registries; yields {package: [backend instances]}."""
    instances = {name: [] for name in PKGS}
    for name, pkg in PKGS.items():
        for fw_name, dev in (("fake-rtt", False), ("fake-rtt-dev", True)):
            cls = make_rtt_backend(pkg, dev)

            def factory(cls=cls, out=instances[name]):
                fw = cls()
                out.append(fw)
                return fw

            pkg.registry.register(pkg.registry.FILTER, fw_name)(factory)
    yield instances
    for pkg in PKGS.values():
        for fw_name in ("fake-rtt", "fake-rtt-dev"):
            pkg.registry.unregister(pkg.registry.FILTER, fw_name)


def rtt_line(extra, framework="fake-rtt"):
    return (f"appsrc name=src caps={CAPS} ! tensor_filter name=f "
            f"framework={framework} model=m {extra} ! tensor_sink name=out")


def prefetches(instances):
    return sum(fw.prefetch_calls for fw in instances)


@pytest.mark.parametrize("n,extra,framework,n_prefetch,batches", [
    (4, "", "fake-rtt", 0, [1] * 4),  # default depth is inline
    (3, "feed-depth=1", "fake-rtt", 0, [1] * 3),
    (6, "feed-depth=4", "fake-rtt", 6, [1] * 6),  # order kept, EOS drains
    (8, "batch-size=2 feed-depth=2", "fake-rtt", 4, [2] * 4),
    (8, "feed-depth=2 fetch-window=2", "fake-rtt-dev", 8, [1] * 8),
    (12, "batch-size=2 feed-depth=2 fetch-window=2", "fake-rtt-dev", 6,
     [2] * 6),
    (7, "feed-depth=3 fetch-window=eos", "fake-rtt-dev", 7, [1] * 7),
])
def test_upload_window(rtt, n, extra, framework, n_prefetch, batches):
    frames = frames_of(n)
    res = both(lambda pkg: run_line(pkg, rtt_line(extra, framework),
                                    frames))
    assert_same(res, frames, 2)
    for name in PKGS:
        assert prefetches(rtt[name]) == n_prefetch, name
        assert [b for fw in rtt[name] for b in fw.invoke_batches] == \
            batches, name


def test_pipelined_uploads_beat_serial(rtt):
    """feed-depth=8 delivers at least 4x the frames/s of feed-depth=1 on
    the 50 ms fake link (the JAX test's bar), in both packages."""
    n = 16

    def fps(pkg, extra):
        t0 = time.perf_counter()
        outs, _, _ = run_line(pkg, rtt_line(extra), frames_of(n))
        assert len(outs) == n
        return n / (time.perf_counter() - t0)

    for name, (fps1, fps8) in both(lambda pkg: (
            fps(pkg, "feed-depth=1"), fps(pkg, "feed-depth=8"))).items():
        assert fps8 >= 4.0 * fps1, (name, fps1, fps8)


def test_outputs_held_until_depth_reached(rtt):
    for name, (early, late) in both(lambda pkg: _held_until(
            pkg, rtt_line("feed-depth=4"), 3)).items():
        assert early is None and late is not None, name


def test_qos_drop_composes(rtt):
    """QoS drops happen BEFORE the upload starts: throttled frames never
    enter the in-flight queue."""
    def run(pkg):
        p = pkg.parse_launch(rtt_line("feed-depth=4"))
        p.play()
        p["f"]._qos_earliest = 3000
        for i in range(6):
            p["src"].push_buffer(pkg.Buffer(
                tensors=[np.full((1, 4), float(i), np.float32)],
                pts=i * 1000))
        p["src"].end_of_stream()
        assert p.bus.wait_eos(30)
        pts = [b.pts for b in p["out"].collected]
        p.stop()
        return pts

    for name, pts in both(run).items():
        assert pts == [3000, 4000, 5000], name
        assert prefetches(rtt[name]) == 3, name


def test_fetch_timeout_drains_feed_queue(rtt):
    def run(pkg):
        p = pkg.parse_launch(rtt_line("feed-depth=8 fetch-timeout-ms=150"))
        p.play()
        for i in range(3):
            p["src"].push_buffer(pkg.Buffer(
                tensors=[np.full((1, 4), float(i), np.float32)],
                pts=i * 1000))
        got = _pull_n(p, 3)
        p.stop()
        return [np.asarray(b[0]) for b in got]

    for name, got in both(run).items():
        assert len(got) == 3, name
        for i, out in enumerate(got):
            np.testing.assert_array_equal(out, np.full((1, 4), i * 2.0))


def test_upload_hold_visible_in_tracer_and_e2e(rtt):
    def run(pkg):
        p = pkg.parse_launch(rtt_line("feed-depth=4 latency-e2e=1"))
        tracer = pkg.trace.attach(p)
        p.play()
        for i in range(6):
            p["src"].push_buffer(pkg.Buffer(
                tensors=[np.full((1, 4), float(i), np.float32)],
                pts=i * 1000))
        p["src"].end_of_stream()
        assert p.bus.wait_eos(30)
        res = tracer.report().get("residency", {})
        out = (res.get("upload-window:f", {}).get("count"),
               p["f"].get_property("latency-e2e"),
               p["f"].get_property("latency"))
        p.stop()
        return out

    for name, (count, e2e_us, compute_us) in both(run).items():
        assert count == 6, name
        assert e2e_us > 0 and e2e_us >= compute_us, name


def test_backend_without_prefetch_runs_inline(probes):
    """A backend without the hook (base prefetch returns None) invokes
    inline: feed-depth adds no queueing."""
    for name, (early, _) in both(lambda pkg: _held_until(
            pkg, easy_line("host_triple", "feed-depth=8"), 1,
            timeout=5.0)).items():
        assert early is not None, name
        np.testing.assert_array_equal(early[0], np.zeros((1, 4)))


ADD_CAPS = ("other/tensors,num-tensors=1,dimensions=4:2,types=float32,"
            "framerate=0/1")


def add_line(pkg, custom, extra):
    """framework=jax model=add: the JAX backend (AOT cache off, as its own
    tests run it) or the port's torch backend on the CPU."""
    acc = ",aot:0" if pkg.name == "jax" else ""
    cpu = "" if pkg.name == "jax" else "accelerator=true:cpu "
    return (f"appsrc name=src caps={ADD_CAPS} ! tensor_filter name=f "
            f"framework=jax model=add custom={custom}{acc} {cpu}{extra} "
            "! tensor_sink name=out")


@pytest.mark.parametrize("extra", ["", "feed-depth=3",
                                   "feed-depth=2 batch-size=2 fetch-window=2"])
def test_backend_prefetch_matches_inline(extra):
    """framework=jax model=add with and without the upload window: the
    same x + 2 in both packages (the port's prefetch hands invoke its
    tensors; on the card, its pinned staging ring)."""
    frames = [np.full((2, 4), float(i), np.float32) for i in range(5)]
    res = both(lambda pkg: run_line(pkg, add_line(pkg, "k:2", extra),
                                    frames))
    for name, (outs, _, _) in res.items():
        assert len(outs) == 5, name
        for i, out in enumerate(outs):
            np.testing.assert_array_equal(out.reshape(2, 4), frames[i] + 2)


def test_port_prefetch_handle_is_consumed_by_invoke():
    from nnstreamer_tpu_torch.filters.base import (
        FilterProperties,
        PrefetchedInputs,
    )
    from nnstreamer_tpu_torch.filters.cuda_filter import TorchCudaFilter

    fw = TorchCudaFilter()
    fw.open(FilterProperties(framework="jax", model_files=["add"],
                             custom="k:2", accelerator="true:cpu",
                             feed_depth=2))
    try:
        h = fw.prefetch([np.ones((2, 4), np.float32)])
        assert isinstance(h, PrefetchedInputs) and h.donatable
        assert isinstance(h[0], torch.Tensor)
        out = fw.invoke(h)
        np.testing.assert_array_equal(np.asarray(out[0]),
                                      np.full((2, 4), 3.0))
    finally:
        fw.close()


def test_reload_model_drains_in_flight_uploads():
    """A reload-model event invokes the frames already uploaded for the
    OLD model against it before the swap (model=add k:1, then scaler)."""
    def run(pkg):
        caps = ("other/tensors,num-tensors=1,dimensions=4,"
                "types=float32,framerate=0/1")
        line = add_line(pkg, "k:1", "feed-depth=8").replace(
            f"caps={ADD_CAPS}", f"caps={caps}")
        p = pkg.parse_launch(line)
        p.play()
        for i in range(3):
            p["src"].push_buffer(pkg.Buffer(
                tensors=[np.full(4, float(i), np.float32)]))
        deadline = time.time() + 10
        while len(p["f"]._feed_pending) < 3 and time.time() < deadline:
            time.sleep(0.05)
        assert len(p["f"]._feed_pending) == 3
        p["f"].sink_pad.receive_event(pkg.Event("reload-model",
                                                {"model": "scaler"}))
        for i in range(2):
            p["src"].push_buffer(pkg.Buffer(
                tensors=[np.full(4, float(i), np.float32)]))
        p["src"].end_of_stream()
        assert p.bus.wait_eos(60)
        assert p.bus.error is None, p.bus.error
        outs = [float(np.asarray(b[0]).ravel()[0])
                for b in p["out"].collected]
        p.stop()
        return outs

    got = both(run)
    assert got["jax"] == got["port"] == [1.0, 2.0, 3.0, 0.0, 2.0], got


# -- shared-tensor-filter-key with custom-easy (test_upload_window.py) -----

@pytest.mark.parametrize("second,shares", [
    (dict(custom="a:1"), True),
    (dict(custom="donate:1"), False),
    (dict(model_files=["other"]), False),
])
def test_shared_key_props_match(probes, second, shares):
    from nnstreamer_tpu_torch.filters.base import (
        FilterProperties,
        acquire_framework,
        release_framework,
    )

    base = dict(framework="custom-easy", model_files=["host_triple"],
                custom="a:1", shared_key="uw-key")
    fw1 = acquire_framework("custom-easy", FilterProperties(**base))
    try:
        if shares:
            fw2 = acquire_framework("custom-easy",
                                    FilterProperties(**dict(base, **second)))
            assert fw2 is fw1
            release_framework(fw2, "uw-key")
        else:
            with pytest.raises(ValueError, match="different properties"):
                acquire_framework("custom-easy",
                                  FilterProperties(**dict(base, **second)))
    finally:
        release_framework(fw1, "uw-key")


# -- invoke-dynamic --------------------------------------------------------

@pytest.mark.parametrize("extra", ["invoke-dynamic=true",
                                   "invoke-dynamic=true batch-size=2",
                                   "invoke-dynamic=true fetch-window=2"])
def test_invoke_dynamic_outputs_flexible(probes, extra):
    """invoke-dynamic: flexible caps downstream, each output a flexible
    tensor (meta header + payload) with the same bytes in both packages."""
    frames = frames_of(4)

    def run(pkg):
        p = pkg.parse_launch(easy_line("dev_double", extra).replace(
            "! tensor_sink name=out", "! tensor_sink name=out "
            "materialize=false"))
        p.play()
        for i, f in enumerate(frames):
            p["src"].push_buffer(pkg.Buffer(tensors=[f], pts=i))
        p["src"].end_of_stream()
        assert p.bus.wait_eos(10)
        caps = str(p["out"].sink_pads[0].caps)
        outs = [bytes(b.tensors[0]) for b in p["out"].collected]
        p.stop()
        return caps, outs

    got = both(run)
    assert "flexible" in got["port"][0] and "flexible" in got["jax"][0]
    assert got["jax"][1] == got["port"][1]
    from nnstreamer_tpu_torch.meta import unwrap_flexible

    for i, blob in enumerate(got["port"][1]):
        arr, info = unwrap_flexible(blob)
        np.testing.assert_array_equal(arr.reshape(1, 4), frames[i] * 2)


# -- the flagship line at a small size ---------------------------------------

LIVE_PROPS = "feed-depth=2 batch-size=4 fetch-window=auto"


def _flagship(custom, extra="", fpt=1, labels=None):
    tail = (f"! tensor_decoder mode=image_labeling option1={labels} "
            if labels else "")
    return ("appsrc name=src caps=video/x-raw,format=RGB,width=64,height=64,"
            f"framerate=30/1 ! tensor_converter frames-per-tensor={fpt} "
            "! tensor_filter name=f framework=jax model=mobilenet_v2 "
            f"custom={custom} {extra} ! queue {tail}! tensor_sink name=out")


def _frames_out(pkg, line, frames):
    p = pkg.parse_launch(line)
    p.play()
    for f in frames:
        p["src"].push_buffer(pkg.Buffer(tensors=[f]))
    p["src"].end_of_stream()
    assert p.bus.wait_eos(120)
    assert p.bus.error is None, p.bus.error
    out = list(p["out"].collected)
    p.stop()
    return out


def test_flagship_live_props_logits_match(weights):
    """The flagship line fed one frame per buffer with feed-depth=2
    batch-size=4 fetch-window=auto: flax's seed:0 weights in the JAX
    package, the same weights carried across by from_jax_variables in the
    port (accelerator=true:cpu). The line computes in bf16 in both, so the
    logits are held at the JAX package's bf16 tolerance for this line
    (atol 0.15, rtol 0.05, tests/test_torch_pipeline.py); test_torch_model's
    5e-4 is its float32 tolerance, which no launch line selects. The
    port's logits are also bit-equal to its own frames-per-tensor=4 line
    without the properties: batching, the upload window and the auto
    window change no number."""
    _, _, npz_seed0, _, frames = weights
    want = _frames_out(PKGS["jax"], _flagship(f"seed:0,{CUSTOM}",
                                              LIVE_PROPS), frames)
    cpu = "accelerator=true:cpu "
    got = _frames_out(PKGS["port"], _flagship(
        f"params:{npz_seed0},{CUSTOM}", cpu + LIVE_PROPS), frames)
    plain = _frames_out(PKGS["port"], _flagship(
        f"params:{npz_seed0},{CUSTOM}", cpu, fpt=4), frames)
    assert len(got) == len(want) == N_FRAMES
    g = np.concatenate([np.asarray(b.tensors[0]) for b in got])
    w = np.concatenate([np.asarray(b.tensors[0]) for b in want])
    assert g.shape == w.shape == (N_FRAMES, 16)
    np.testing.assert_allclose(g, w, atol=0.15, rtol=0.05)
    np.testing.assert_array_equal(
        g, np.concatenate([np.asarray(b.tensors[0]) for b in plain]))


def test_flagship_live_props_labels_match(weights):
    msgpack, npz, _, labels, frames = weights
    want = _frames_out(PKGS["jax"], _flagship(
        f"params:{msgpack},postproc:argmax,{CUSTOM}", LIVE_PROPS,
        labels=labels), frames)
    got = _frames_out(PKGS["port"], _flagship(
        f"params:{npz},postproc:argmax,{CUSTOM}",
        "accelerator=true:cpu " + LIVE_PROPS, labels=labels), frames)
    want_labels = [b.meta["label"] for b in want]
    got_labels = [b.meta["label"] for b in got]
    assert len(got_labels) == N_FRAMES
    assert got_labels == want_labels
    assert len(set(want_labels)) > 1
