"""The multi-stream and flow elements through both packages, on the CPU.

  - every case of the reference's tests/test_streams.py (mux with the
    slowest and nosync policies, demux, merge, split, aggregator, if,
    crop, rate, repo recurrence, sparse, round-robin and join) runs
    through ``nnstreamer_tpu`` and ``nnstreamer_tpu_torch`` with the same
    inputs: the sinks' arrays are equal (same dtype, same values: these
    elements move and compare values, they compute nothing in floating
    point), and so are the sinks' caps and the tracer's crossing counts;
  - the same elements fed by a filter (``model=add``; the port's filter on
    the CPU with ``accelerator=true:cpu``, whose torch tensors count as
    the backend's, ``buffer.is_backend_tensor``): equal outputs and equal
    h2d/d2h crossing counts and bytes, per element: both packages' residency
    planners make the filter the boundary and bill the fetch there, and a
    tee fan-out fetches once for all its branches;
  - the fan-in line of examples/launch_lines.txt;
  - the three lines the port runs on the card, at a small size:
      A. two cameras merged into one MobileNet-v2 batch and split back per
         camera: labels equal to the JAX package's (perturbed flax
         weights carried across with ``from_jax_variables``), logits on
         flax's seed:0 weights within the flagship's bf16 tolerance
         (atol 0.15, rtol 0.05, tests/test_torch_pipeline.py), crossings
         equal;
      B. detect, then crop: ``tensor_region`` on the JAX SSD's raw
         tensors, its converter and ``tensor_crop`` byte-equal through
         both packages; the whole line through the port (the JAX SSD's
         weights with ``params:<npz>``) cropping exactly the frame at the
         regions its own decoder gives on its own forward, with the
         JAX line's crossing counts; and ``tensor_region`` wired straight
         into ``tensor_crop.info`` failing the same way in both;
      C. the gated live camera: ``tensor_if`` skips the dark frames
         before a ``batch-size`` filter, and exactly the bright frames are
         labelled, in order, as the ungated ``frames-per-tensor`` line
         labels them, in both packages.
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

import nnstreamer_tpu.buffer  # noqa: E402
import nnstreamer_tpu.elements.flow  # noqa: E402
import nnstreamer_tpu.elements.repo  # noqa: E402
import nnstreamer_tpu.filters.base  # noqa: E402
import nnstreamer_tpu.pipeline  # noqa: E402
import nnstreamer_tpu.trace  # noqa: E402
import nnstreamer_tpu.types  # noqa: E402
import nnstreamer_tpu_torch.buffer  # noqa: E402
import nnstreamer_tpu_torch.elements.flow  # noqa: E402
import nnstreamer_tpu_torch.elements.repo  # noqa: E402
import nnstreamer_tpu_torch.filters.base  # noqa: E402
import nnstreamer_tpu_torch.pipeline  # noqa: E402
import nnstreamer_tpu_torch.trace  # noqa: E402
import nnstreamer_tpu_torch.types  # noqa: E402
from test_torch_pipeline import CUSTOM, N_FRAMES, weights  # noqa: E402,F401


class Pkg:
    """One package's modules under one set of names."""

    def __init__(self, name):
        import sys

        mod = sys.modules
        self.name = name
        self.pipeline = mod[f"{name}.pipeline"]
        self.trace = mod[f"{name}.trace"]
        self.Buffer = mod[f"{name}.buffer"].Buffer
        self.flow = mod[f"{name}.elements.flow"]
        self.repo = mod[f"{name}.elements.repo"]
        self.filters = mod[f"{name}.filters.base"]
        self.types = mod[f"{name}.types"]
        #: the filter properties that run the package's backend on the CPU
        self.cpu = "accelerator=true:cpu" if name == "nnstreamer_tpu_torch" \
            else ""


JAX, PORT = Pkg("nnstreamer_tpu"), Pkg("nnstreamer_tpu_torch")

T1 = ("other/tensors,format=static,num_tensors=1,dimensions={d},types={t},"
      "framerate=30/1")


def _crossings(tracer):
    c = tracer.crossings()
    return {k: c[k] for k in ("h2d", "d2h", "h2d_bytes", "d2h_bytes")}


def run(pkg, line, pushes, sinks=("out",), eos=None, wait=5.0):
    """Parse ``line``, attach a tracer, push ``pushes`` ([(src, array or
    Buffer kwargs)]) in order, send EOS on every pushed source (or
    ``eos``) and wait for it. Returns {sink: [[arrays] per buffer]},
    {sink: caps string}, crossing totals, the pipeline."""
    p = pkg.pipeline.parse_launch(line)
    tracer = pkg.trace.attach(p)
    p.play()
    for src, item in pushes:
        if isinstance(item, dict):
            p[src].push_buffer(pkg.Buffer(**item))
        else:
            p[src].push_buffer(item)
    for src in (eos if eos is not None else dict.fromkeys(s for s, _ in pushes)):
        p[src].end_of_stream()
    assert p.bus.wait_eos(wait)
    assert p.bus.error is None, p.bus.error
    outs = {s: [b.as_numpy() for b in p[s].collected] for s in sinks}
    caps = {s: str(p[s].sink_pad.caps) for s in sinks}
    cross = _crossings(tracer)
    p.stop()
    return outs, caps, cross, p


def assert_same(got, want):
    """Equal arrays, dtype and shape included, buffer by buffer."""
    assert got.keys() == want.keys()
    for s in want:
        assert len(got[s]) == len(want[s]), s
        for gb, wb in zip(got[s], want[s]):
            assert len(gb) == len(wb)
            for g, w in zip(gb, wb):
                assert g.dtype == w.dtype and g.shape == w.shape
                np.testing.assert_array_equal(g, w)


def both(fn):
    """fn(pkg) for the JAX package, then for the port."""
    return fn(JAX), fn(PORT)


# -- the reference's cases ----------------------------------------------------

def _f(n, v, dt=np.float32):
    return np.full(n, v, dt)


CASES = {
    "mux_slowest": (
        "tensor_mux name=m ! tensor_sink name=out "
        f"appsrc name=a caps={T1.format(d=2, t='float32')} ! m. "
        f"appsrc name=b caps={T1.format(d=3, t='int32')} ! m.",
        [p for i in range(3) for p in (("a", _f(2, i)),
                                        ("b", _f(3, 10 + i, np.int32)))]),
    "demux_default": (
        "appsrc name=src caps=other/tensors,format=static,num_tensors=2,"
        "dimensions=2.3,types=float32.int32,framerate=30/1 ! tensor_demux "
        "name=d d.src_0 ! tensor_sink name=o1 d.src_1 ! tensor_sink name=o2",
        [("src", [np.zeros(2, np.float32), np.ones(3, np.int32)])],
        ("o1", "o2")),
    "demux_tensorpick_groups": (
        "appsrc name=src caps=other/tensors,format=static,num_tensors=3,"
        "dimensions=1.1.1,types=float32.float32.float32,framerate=30/1 ! "
        "tensor_demux name=d tensorpick=2:0,1 d.src_0 ! tensor_sink name=o1 "
        "d.src_1 ! tensor_sink name=o2",
        [("src", [_f(1, i) for i in range(3)])], ("o1", "o2")),
    "merge_linear_dim0": (
        "tensor_merge name=m option=0 ! tensor_sink name=out "
        f"appsrc name=a caps={T1.format(d=2, t='float32')} ! m. "
        f"appsrc name=b caps={T1.format(d=3, t='float32')} ! m.",
        [("a", np.array([1, 2], np.float32)),
         ("b", np.array([3, 4, 5], np.float32))]),
    "split": (
        f"appsrc name=src caps={T1.format(d=5, t='float32')} ! tensor_split "
        "name=s tensorseg=2,3 s.src_0 ! tensor_sink name=o1 s.src_1 ! "
        "tensor_sink name=o2",
        [("src", np.array([1, 2, 3, 4, 5], np.float32))], ("o1", "o2")),
    "aggregate_4_frames": (
        f"appsrc name=src caps={T1.format(d='2:1:1:1', t='float32')} ! "
        "tensor_aggregator frames-out=4 frames-dim=3 ! tensor_sink name=out",
        [("src", np.full((1, 1, 2), i, np.float32)) for i in range(8)]),
    "sliding_window": (
        f"appsrc name=src caps={T1.format(d='1', t='float32')} ! "
        "tensor_aggregator frames-out=3 frames-flush=1 frames-dim=1 ! "
        "tensor_sink name=out",
        [("src", _f(1, i)) for i in range(5)]),
    "if_average_value_branch": (
        f"appsrc name=src caps={T1.format(d=4, t='float32')} ! tensor_if "
        "compared-value=TENSOR_AVERAGE_VALUE compared-value-option=0 "
        "operator=gt supplied-value=5 then=PASSTHROUGH else=SKIP ! "
        "tensor_sink name=out",
        [("src", _f(4, v)) for v in (10, 1, 7)]),
    "if_fill_zero": (
        f"appsrc name=src caps={T1.format(d=2, t='float32')} ! tensor_if "
        "compared-value=A_VALUE compared-value-option=0:0 operator=lt "
        "supplied-value=0 then=FILL_WITH_ZERO else=PASSTHROUGH ! "
        "tensor_sink name=out",
        [("src", np.array([-1, 5], np.float32))]),
    "crop_regions": (
        "tensor_crop name=c ! tensor_sink name=out "
        f"appsrc name=raw caps={T1.format(d='3:8:6', t='uint8')} ! c.raw "
        f"appsrc name=info caps={T1.format(d='4:2', t='int32')} ! c.info",
        [("raw", np.arange(6 * 8 * 3, dtype=np.uint8).reshape(6, 8, 3)),
         ("info", np.array([[1, 2, 4, 3], [0, 0, 2, 2]], np.int32))]),
    "rate_downsample": (
        f"appsrc name=src caps={T1.format(d=1, t='float32')} ! tensor_rate "
        "framerate=10/1 name=r ! tensor_sink name=out",
        [("src", {"tensors": [_f(1, i)], "pts": int(i * 1e9 / 30)})
         for i in range(30)]),
    "sparse_enc_dec_roundtrip": (
        f"appsrc name=src caps={T1.format(d='4:2', t='float32')} ! "
        "tensor_sparse_enc ! tensor_sparse_dec ! tensor_sink name=out",
        [("src", np.array([[0, 1, 0, 2], [0, 0, 3, 0]], np.float32))]),
    "sparse_caps": (
        f"appsrc name=src caps={T1.format(d='4', t='float32')} ! "
        "tensor_sparse_enc ! tensor_sink name=out",
        [("src", np.zeros(4, np.float32))]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_case(case):
    line, pushes, *sinks = CASES[case]
    sinks = sinks[0] if sinks else ("out",)
    (jo, jc, jx, jp), (po, pc, px, pp) = both(
        lambda pkg: run(pkg, line, pushes, sinks))
    assert_same(po, jo)
    assert pc == jc
    assert px == jx
    assert sum(len(v) for v in jo.values()) > 0
    if case == "rate_downsample":
        assert pp["r"].get_property("drop") == jp["r"].get_property("drop") > 0
    if case == "sparse_caps":
        assert "sparse" in pc["out"]


def test_mux_nosync_emits_on_any():
    """a, then b, then b again (a stale): the first full set and b's
    update, in both packages."""
    def go(pkg):
        p = pkg.pipeline.parse_launch(
            "tensor_mux name=m sync-mode=nosync ! tensor_sink name=out "
            f"appsrc name=a caps={T1.format(d=1, t='float32')} ! m. "
            f"appsrc name=b caps={T1.format(d=1, t='float32')} ! m.")
        p.play()
        for src, v in (("a", 0), ("b", 1), ("b", 2)):
            p[src].push_buffer(_f(1, v))
            time.sleep(0.2)  # arrival order is the policy under test
        p["a"].end_of_stream()
        p["b"].end_of_stream()
        assert p.bus.wait_eos(5)
        p.stop()
        return [[np.asarray(t) for t in b.tensors]
                for b in p["out"].collected]

    want, got = both(go)
    assert len(got) == len(want) == 2
    assert_same({"out": got}, {"out": want})


def test_split_bad_sizes_errors():
    def go(pkg):
        p = pkg.pipeline.parse_launch(
            f"appsrc name=src caps={T1.format(d=5, t='float32')} ! "
            "tensor_split name=s tensorseg=2,2 s.src_0 ! fakesink "
            "s.src_1 ! fakesink")
        p.play()
        p["src"].push_buffer(np.zeros(5, np.float32))
        t0 = time.monotonic()
        while p.bus.error is None and time.monotonic() - t0 < 5:
            time.sleep(0.05)
        err = p.bus.error
        p.stop()
        return err

    want, got = both(go)
    assert want is not None and got is not None
    assert "does not sum" in str(got.data) and "does not sum" in str(want.data)


def test_if_custom_condition():
    def go(pkg):
        pkg.flow.register_if_condition(
            "sumpos", lambda arrs: float(arrs[0].sum()) > 0)
        try:
            out, _, _, _ = run(
                pkg, f"appsrc name=src caps={T1.format(d=2, t='float32')} ! "
                "tensor_if compared-value=CUSTOM compared-value-option=sumpos "
                "then=PASSTHROUGH else=SKIP ! tensor_sink name=out",
                [("src", np.array([1, 1], np.float32)),
                 ("src", np.array([-5, 1], np.float32))])
        finally:
            pkg.flow.unregister_if_condition("sumpos")
        return out

    want, got = both(go)
    assert len(got["out"]) == 1
    assert_same(got, want)


def test_repo_recurrence_cycle():
    """The RNN loop (tests/nnstreamer_repo_rnn pattern): input muxed with
    the previous output through tensor_reposink/tensor_reposrc: a running
    sum, in both packages."""
    def go(pkg):
        repo = pkg.repo.repo
        repo.reset()
        make = pkg.pipeline.element_factory_make
        info2 = pkg.types.TensorsInfo.from_strings("1.1", "float32.float32")
        info1 = pkg.types.TensorsInfo.from_strings("1", "float32")
        pkg.filters.register_custom_easy(
            "rnn_step", lambda xs: [np.asarray(xs[0]) + np.asarray(xs[1])],
            info2, info1)
        pl = pkg.pipeline.Pipeline()
        src = make("appsrc", "src", caps=T1.format(d=1, t="float32"))
        rsrc = make("tensor_reposrc", "rsrc", slot_index=7,
                    caps=T1.format(d=1, t="float32"), initial_dim="1",
                    initial_type="float32")
        mux = make("tensor_mux", "mux")
        filt = make("tensor_filter", "f", framework="custom-easy",
                    model="rnn_step")
        tee = make("tee", "t")
        rsink = make("tensor_reposink", "rsink", slot_index=7)
        sink = make("tensor_sink", "out")
        pl.add(src, rsrc, mux, filt, tee, rsink, sink)
        pl.link(src, mux)
        pl.link(rsrc, mux)
        pl.link(mux, filt, tee)
        pl.link(tee, rsink)
        pl.link(tee, sink)
        try:
            pl.play()
            for _ in range(4):
                src.push_buffer(np.full(1, 1.0, np.float32))
            deadline = time.monotonic() + 5
            while len(sink.collected) < 4 and time.monotonic() < deadline:
                time.sleep(0.02)
            src.end_of_stream()
            pl.stop()
            return [float(np.asarray(b[0])[0]) for b in sink.collected[:4]]
        finally:
            pkg.filters.unregister_custom_easy("rnn_step")
            repo.reset()

    want, got = both(go)
    assert got == want == [1.0, 2.0, 3.0, 4.0]


def test_round_robin_alternates_and_joins():
    def go(pkg):
        p = pkg.pipeline.parse_launch(
            "appsrc name=src caps=other/tensors,format=static,dimensions=2,"
            "types=float32 ! round_robin name=rr "
            "rr. ! queue ! tensor_transform mode=arithmetic option=add:100 "
            "! join name=j rr. ! queue ! tensor_transform mode=arithmetic "
            "option=add:200 ! j. j. ! tensor_sink name=out")
        p.play()
        for i in range(6):
            p["src"].push_buffer(pkg.Buffer(tensors=[_f(2, float(i))]))
        got = [np.asarray(p["out"].pull(timeout=5.0).tensors[0])
               for _ in range(6)]
        p.stop()
        # the queues race: compare as a set of (branch, frame)
        return sorted((int(g[0]) // 100, int(g[0]) % 100) for g in got)

    want, got = both(go)
    assert got == want
    assert sorted(f for _, f in got) == list(range(6))
    assert {b for b, _ in got} == {1, 2}


# -- the same elements fed by a filter: crossings -------------------------

C42 = "other/tensors,num-tensors=1,dimensions=4:2,types=float32,framerate=0/1"
FED = {
    "split": ("tensor_split name=s tensorseg=1,1 dimension=1 "
              "s.src_0 ! tensor_sink name=o1 s.src_1 ! tensor_sink name=o2",
              ("o1", "o2")),
    "if": ("tensor_if compared-value=TENSOR_AVERAGE_VALUE operator=gt "
           "supplied-value=2 ! tensor_sink name=o1", ("o1",)),
    "if_fill_zero": ("tensor_if compared-value=A_VALUE "
                     "compared-value-option=0:0 operator=lt "
                     "supplied-value=3 then=FILL_WITH_ZERO "
                     "else=PASSTHROUGH ! tensor_sink name=o1", ("o1",)),
    "sparse": ("tensor_sparse_enc ! tensor_sparse_dec ! tensor_sink name=o1",
               ("o1",)),
    "demux": ("tensor_demux name=d d.src_0 ! tensor_sink name=o1", ("o1",)),
    "mux": ("m.sink_0 appsrc name=b caps=" + C42 + " ! m.sink_1 tensor_mux "
            "name=m ! tensor_sink name=o1", ("o1",)),
    "merge": ("m.sink_0 appsrc name=b caps=" + C42 + " ! m.sink_1 "
              "tensor_merge name=m option=1 ! tensor_sink name=o1", ("o1",)),
    "debug": ("tensor_debug capability=all ! tensor_sink name=o1", ("o1",)),
    "rate": ("tensor_rate framerate=10/1 ! tensor_sink name=o1", ("o1",)),
    "round_robin_join": ("round_robin name=r r. ! queue ! j. r. ! queue ! j. "
                         "join name=j ! tensor_sink name=o1", ("o1",)),
    # the fan-out: one boundary at the filter serves both branches
    "tee": ("tee name=t t. ! queue ! tensor_sink name=o1 "
            "t. ! queue ! tensor_sink name=o2", ("o1", "o2")),
}


@pytest.mark.parametrize("case", sorted(FED))
def test_filter_fed_crossings(case):
    """appsrc ! tensor_filter model=add ! <element>: the same outputs and
    the same h2d/d2h crossings (count and bytes) in both packages, in
    total and per element."""
    tail, sinks = FED[case]

    def go(pkg):
        line = (f"appsrc name=src caps={C42} ! tensor_filter name=f "
                f"framework=jax model=add custom=k:1,aot:0 {pkg.cpu} "
                f"! {tail}")
        pushes = []
        for i in range(3):
            pushes.append(("src", {"tensors": [np.full((2, 4), i, np.float32)],
                                   "pts": i * 10 ** 8}))
            if "appsrc name=b" in tail:
                pushes.append(("b", {"tensors": [np.full((2, 4), 9.0,
                                                         np.float32)],
                                     "pts": i * 10 ** 8}))
        return run(pkg, line, pushes, sinks, wait=10)

    (jo, jc, jx, jp), (po, pc, px, pp) = both(go)
    if case == "round_robin_join":  # the queues race: compare as sets
        key = lambda o: sorted(float(b[0].sum()) for b in o["o1"])  # noqa: E731
        assert key(po) == key(jo)
    else:
        assert_same(po, jo)
    assert pc == jc
    assert px == jx and px["d2h"] > 0
    per = pp.tracer.crossings()["per_element"]
    assert per == jp.tracer.crossings()["per_element"]
    if case == "tee":
        # 3 buffers: 3 d2h and 96 B, all at the filter
        assert per == {"f": {"h2d": 3, "d2h": 3, "h2d_bytes": 96,
                             "d2h_bytes": 96}}


def test_fan_in_launch_line():
    """examples/launch_lines.txt's fan-in line as written: two streams
    muxed into one frame of two tensors."""
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "launch_lines.txt")
    with open(path, encoding="utf-8") as f:
        text = f.read().splitlines()
    line = text[text.index("# fan-in: two tensor streams muxed into one "
                           "frame") + 2]

    def go(pkg):
        p = pkg.pipeline.parse_launch(line)
        sink = [e for e in p.elements.values()
                if type(e).__name__ == "TensorSink"][0]
        p.play()
        for i in range(3):
            p["sa"].push_buffer(pkg.Buffer(tensors=[_f(4, i)]))
            p["sb"].push_buffer(pkg.Buffer(tensors=[_f(4, 10 + i)]))
        p["sa"].end_of_stream()
        p["sb"].end_of_stream()
        assert p.bus.wait_eos(5)
        p.stop()
        return ([[np.asarray(t) for t in b.tensors] for b in sink.collected],
                str(sink.sink_pad.caps))

    (want, jc), (got, pc) = both(go)
    assert len(got) == 3 and all(len(b) == 2 for b in got)
    assert_same({"o": got}, {"o": want})
    assert pc == jc


# -- line A: two cameras into one model --------------------------------------

FPT = 2  # frames per tensor per camera: 2 merged batches of 4


def _two_cameras(pkg, custom, labels=None):
    cam = ("appsrc name=c{i} caps=video/x-raw,format=RGB,width=64,height=64,"
           f"framerate=1000/1 ! tensor_converter frames-per-tensor={FPT} "
           "! m.sink_{i} ")
    branch = (f"s.src_{{i}} ! tensor_decoder mode=image_labeling "
              f"option1={labels} ! tensor_sink name=o{{i}} " if labels else
              "s.src_{i} ! tensor_sink name=o{i} ")
    return (cam.format(i=0) + cam.format(i=1)
            + "tensor_merge name=m mode=linear option=3 ! tensor_filter "
            f"name=f framework=jax model=mobilenet_v2 custom={custom} "
            f"{pkg.cpu} ! tensor_split name=s tensorseg={FPT},{FPT} "
            "dimension=" + ("0 " if labels else "1 ")
            + branch.format(i=0) + branch.format(i=1))


def _run_two_cameras(pkg, line, frames):
    half = len(frames) // 2
    pushes = [p for k in range(half)
              for p in (("c0", {"tensors": [frames[k]], "pts": k}),
                        ("c1", {"tensors": [frames[half + k]], "pts": k}))]
    p = pkg.pipeline.parse_launch(line)
    tracer = pkg.trace.attach(p)
    p.play()
    for src, item in pushes:
        p[src].push_buffer(pkg.Buffer(**item))
    p["c0"].end_of_stream()
    p["c1"].end_of_stream()
    assert p.bus.wait_eos(120)
    assert p.bus.error is None, p.bus.error
    out = [list(p[f"o{i}"].collected) for i in range(2)]
    cross = _crossings(tracer)
    per = tracer.crossings()["per_element"]
    p.stop()
    return out, cross, per


def test_two_cameras_labels(weights):
    """Line A with labels: each camera's labels equal the JAX package's,
    the frames take more than one label, and the line crosses once per
    merged batch each way."""
    msgpack, npz, _, labels, frames = weights
    want, jx, jper = _run_two_cameras(JAX, _two_cameras(
        JAX, f"params:{msgpack},postproc:argmax,{CUSTOM}", labels), frames)
    got, px, per = _run_two_cameras(PORT, _two_cameras(
        PORT, f"params:{npz},postproc:argmax,{CUSTOM}", labels), frames)
    lab = [[lb for b in cam for lb in b.meta["label"]] for cam in got]
    assert lab == [[lb for b in cam for lb in b.meta["label"]]
                   for cam in want]
    assert len(lab[0]) == len(lab[1]) == N_FRAMES // 2
    assert len(set(lab[0] + lab[1])) > 1
    assert px == jx
    n_batches = N_FRAMES // (2 * FPT)
    assert (px["h2d"], px["d2h"]) == (n_batches, n_batches)
    # the one fetch is the filter's, the residency boundary before the
    # split, in both packages
    assert per == jper
    assert per["f"]["d2h"] == n_batches and "s" not in per


def test_two_cameras_logits(weights):
    """Line A without postproc, split along the batch dim of the logits:
    each camera's rows within the flagship's bf16 tolerance of the JAX
    package's, and equal to the port's own forward of the merged batch."""
    _, _, npz_seed0, _, frames = weights
    want, jx, _ = _run_two_cameras(JAX, _two_cameras(
        JAX, f"seed:0,{CUSTOM}"), frames)
    got, px, _ = _run_two_cameras(PORT, _two_cameras(
        PORT, f"params:{npz_seed0},{CUSTOM}"), frames)
    assert px == jx
    for g_cam, w_cam in zip(got, want):
        g = np.concatenate([np.asarray(b.tensors[0]) for b in g_cam])
        w = np.concatenate([np.asarray(b.tensors[0]) for b in w_cam])
        assert g.shape == w.shape == (N_FRAMES // 2, 16)
        np.testing.assert_allclose(g, w, atol=0.15, rtol=0.05)
    # the port's split rows are the rows of its own merged forward
    from nnstreamer_tpu_torch.models import get_model

    fw = get_model("mobilenet_v2", dict(kv.split(":", 1) for kv in (
        f"params:{npz_seed0},{CUSTOM}").split(",")), "cpu")
    half = N_FRAMES // 2
    for k in range(half // FPT):
        merged = np.stack(frames[k * FPT:(k + 1) * FPT]
                          + frames[half + k * FPT:half + (k + 1) * FPT])
        with torch.inference_mode():
            direct = fw.apply_fn(torch.from_numpy(merged)).float().numpy()
        np.testing.assert_array_equal(
            np.asarray(got[0][k].tensors[0]), direct[:FPT])
        np.testing.assert_array_equal(
            np.asarray(got[1][k].tensors[0]), direct[FPT:])


# -- line B: detect, then crop -------------------------------------------------

SSD = 96  # the reference SSD line's size (tests/test_torch_vision_lines.py)
TOP = 4


@pytest.fixture(scope="module")
def ssd(tmp_path_factory):
    """(JAX variables, jitted JAX apply, port npz, priors file, frames)."""
    from test_torch_vision_lines import _jax

    from nnstreamer_tpu.models.ssd_mobilenet import write_box_priors

    variables, apply, npz = _jax("ssd", tmp_path_factory)
    priors = str(tmp_path_factory.mktemp("ssd_priors") / "priors.txt")
    write_box_priors(priors, SSD)
    rng = np.random.default_rng(3)
    cell = SSD // 4
    frames = [np.kron(rng.integers(0, 256, (4, 4, 3)),
                      np.ones((cell, cell, 1))).astype(np.uint8)
              for _ in range(3)]
    return variables, apply, npz, priors, frames


def _region_opts(priors):
    return f"option1={TOP} option3={priors}:0.5 option4={SSD}:{SSD}"


def _crop_line(priors, raw, converter=True):
    """The crop half of line B, fed the SSD's raw tensors ``raw`` on
    appsrc."""
    return (
        f"appsrc name=boxes caps={_raw_caps(raw)} ! tensor_decoder "
        "mode=tensor_region "
        f"{_region_opts(priors)} "
        + ("! tensor_converter " if converter else "")
        + "! c.info appsrc name=raw caps=video/x-raw,format=RGB,"
        f"width={SSD},height={SSD},framerate=30/1 ! tensor_converter "
        "! c.raw tensor_crop name=c ! tensor_sink name=out")


def _raw_caps(raw):
    dims = [":".join(str(d) for d in reversed(t.shape)) for t in raw]
    return ("other/tensors,format=static,num_tensors=2,dimensions="
            f"{'.'.join(dims)},types=float32.float32,framerate=30/1")


def _ssd_raw(ssd, frame):
    variables, apply, *_ = ssd
    out = apply(variables, frame[None])
    return [np.asarray(o, np.float32)[0] for o in out]


def _crops(pkg, line, frames, raws):
    p = pkg.pipeline.parse_launch(line)
    p.play()
    for i, (f, r) in enumerate(zip(frames, raws)):
        p["raw"].push_buffer(pkg.Buffer(tensors=[f], pts=i))
        p["boxes"].push_buffer(pkg.Buffer(tensors=list(r), pts=i))
    p["raw"].end_of_stream()
    p["boxes"].end_of_stream()
    p.bus.wait_eos(30)
    err = p.bus.error
    out = [[bytes(np.ascontiguousarray(t)) + str(np.shape(t)).encode()
            for t in b.tensors] for b in p["out"].collected]
    p.stop()
    return out, err


def test_detect_then_crop_on_the_jax_ssd_outputs(ssd):
    """tensor_region on the JAX SSD's raw tensors, then the converter's
    flexible path and tensor_crop: the crops byte-equal (and shaped the
    same) through both packages, TOP regions per frame."""
    _, _, _, priors, frames = ssd
    raws = [_ssd_raw(ssd, f) for f in frames]
    (want, jerr), (got, perr) = both(
        lambda pkg: _crops(pkg, _crop_line(priors, raws[0]), frames, raws))
    assert jerr is None and perr is None
    assert len(got) == len(frames) and all(len(c) == TOP for c in got)
    assert got == want
    assert any(len(c) > 20 for fr in got for c in fr)  # a non-empty crop


def test_region_straight_into_crop_fails_alike(ssd):
    """Without the converter, tensor_crop reads tensor_region's flexible
    blob as raw bytes and cannot reshape it into regions: both packages
    fail the same way (the port keeps the JAX behaviour)."""
    _, _, _, priors, frames = ssd
    raws = [_ssd_raw(ssd, f) for f in frames[:1]]
    (want, jerr), (got, perr) = both(
        lambda pkg: _crops(pkg, _crop_line(priors, raws[0], converter=False),
                           frames[:1], raws))
    assert got == want == []
    assert jerr is not None and perr is not None
    assert "reshape" in str(jerr.data) and "reshape" in str(perr.data)


def _detect_crop_line(pkg, custom, priors):
    return (f"appsrc name=src caps=video/x-raw,format=RGB,width={SSD},"
            f"height={SSD},framerate=1000/1 ! tensor_converter ! tee name=t "
            "t. ! queue ! tensor_filter name=f framework=jax "
            f"model=ssd_mobilenet custom={custom} {pkg.cpu} "
            f"! tensor_decoder mode=tensor_region {_region_opts(priors)} "
            "! tensor_converter ! c.info "
            "t. ! queue ! c.raw tensor_crop name=c ! tensor_sink name=out")


def _run_detect_crop(pkg, line, frames):
    p = pkg.pipeline.parse_launch(line)
    tracer = pkg.trace.attach(p)
    p.play()
    for i, f in enumerate(frames):
        p["src"].push_buffer(pkg.Buffer(tensors=[f], pts=i))
    p["src"].end_of_stream()
    assert p.bus.wait_eos(120)
    assert p.bus.error is None, p.bus.error
    out = [[np.asarray(t) for t in b.tensors] for b in p["out"].collected]
    cross = _crossings(tracer)
    p.stop()
    return out, cross


def test_detect_then_crop_line(ssd):
    """Line B whole, one frame per buffer: through the port (the JAX
    SSD's weights, params:<npz>) every frame's crops are the frame sliced
    at the regions the port's tensor_region gives on the port's own
    forward of that frame; the crossing totals equal the JAX line's."""
    from test_torch_vision_lines import _port_custom

    from nnstreamer_tpu_torch.buffer import Buffer
    from nnstreamer_tpu_torch.decoders.tensor_region import TensorRegion
    from nnstreamer_tpu_torch.meta import unwrap_flexible
    from nnstreamer_tpu_torch.models import get_model
    from nnstreamer_tpu_torch.types import (
        TensorInfo,
        TensorsConfig,
        TensorsInfo,
    )

    _, _, npz, priors, frames = ssd
    custom = _port_custom("ssd", npz) + ",fused:pallas"
    got, px = _run_detect_crop(PORT, _detect_crop_line(
        PORT, custom, priors), frames)
    import nnstreamer_tpu.models as jm
    from test_torch_shared import jit_init

    with pytest.MonkeyPatch.context() as mp:  # the zoo's init, jitted
        mp.setattr(jm, "_init_on_cpu", jit_init)
        _, jx = _run_detect_crop(JAX, _detect_crop_line(
            JAX, "seed:0,size:96,width:0.35,classes:8", priors), frames)
    assert px == jx
    bundle = get_model("ssd_mobilenet", dict(
        kv.split(":", 1) for kv in custom.split(",")), "cpu")
    dec = TensorRegion()
    dec.init([str(TOP), None, f"{priors}:0.5", f"{SSD}:{SSD}"]
             + [None] * 5)
    assert len(got) == len(frames)
    for f, crops in zip(frames, got):
        with torch.inference_mode():
            raw = [o.float().numpy()
                   for o in bundle.apply_fn(torch.from_numpy(f[None]))]
        cfg = TensorsConfig(TensorsInfo(tensors=[
            TensorInfo.from_np_shape(r.shape, "float32") for r in raw]),
            30, 1)
        dec.get_out_caps(cfg)
        blob = dec.decode(Buffer(tensors=raw), cfg).tensors[0]
        regions = unwrap_flexible(blob)[0].reshape(-1, 4).astype(np.int64)
        assert len(crops) == TOP
        for (x, y, w, h), c in zip(regions, crops):
            want = f[y:max(y, min(SSD, y + h)), x:max(x, min(SSD, x + w))]
            assert c.shape == want.shape
            np.testing.assert_array_equal(c, want)


# -- line C: the gated live camera ---------------------------------------------

GATE = ("tensor_if compared-value=TENSOR_AVERAGE_VALUE "
        "compared-value-option=0 operator=gt supplied-value=16 "
        "then=PASSTHROUGH else=SKIP ")
LIVE = "batch-size=4 fetch-timeout-ms=50"


def _gated_line(pkg, custom, labels, gate=True, fpt=1, extra=LIVE):
    return ("appsrc name=src caps=video/x-raw,format=RGB,width=64,height=64,"
            f"framerate=30/1 ! tensor_converter frames-per-tensor={fpt} ! "
            + (f"{GATE}! " if gate else "")
            + "tensor_filter name=f framework=jax model=mobilenet_v2 "
            f"custom={custom} {extra} {pkg.cpu} ! queue ! tensor_decoder "
            f"mode=image_labeling option1={labels} ! tensor_sink name=out")


def _gated_frames(frames):
    """The weights' 8 frames twice, a seeded quarter of the 16 made dark
    (mean below 16)."""
    rng = np.random.default_rng(4)
    out = [f.copy() for f in frames + frames]
    dark = sorted(rng.choice(len(out), len(out) // 4, replace=False))
    for i in dark:
        out[i] = (out[i] // 16).astype(np.uint8)
    return out, dark


def _labels(pkg, line, frames):
    p = pkg.pipeline.parse_launch(line)
    p.play()
    for i, f in enumerate(frames):
        p["src"].push_buffer(pkg.Buffer(tensors=[f], pts=i))
    p["src"].end_of_stream()
    assert p.bus.wait_eos(120)
    assert p.bus.error is None, p.bus.error
    out = []
    for b in p["out"].collected:
        lab = b.meta["label"]
        out.extend(lab if isinstance(lab, list) else [lab])
    pts = [b.pts for b in p["out"].collected]
    p.stop()
    return out, pts


def test_gated_live_camera(weights):
    """Line C: the dark frames skipped, exactly the bright ones labelled
    in order, with the labels of the ungated frames-per-tensor=4 line on
    the bright frames; the same in both packages."""
    msgpack, npz, _, labels, frames = weights
    gated, dark = _gated_frames(frames)
    assert all(gated[i].mean() < 16 for i in dark)
    bright = [i for i in range(len(gated)) if i not in dark]
    assert all(gated[i].mean() > 16 for i in bright)
    assert len(bright) % 4 == 0
    res = {}
    for pkg, custom in ((JAX, f"params:{msgpack},postproc:argmax,{CUSTOM}"),
                        (PORT, f"params:{npz},postproc:argmax,{CUSTOM}")):
        got, pts = _labels(pkg, _gated_line(pkg, custom, labels), gated)
        want, _ = _labels(pkg, _gated_line(pkg, custom, labels, gate=False,
                                           fpt=4, extra=""),
                          [gated[i] for i in bright])
        assert got == want
        if pkg is PORT:  # one buffer per frame, the bright ones in order
            assert pts == bright
        res[pkg.name] = got
    assert res["nnstreamer_tpu_torch"] == res["nnstreamer_tpu"]
    assert len(set(res["nnstreamer_tpu"])) > 1
