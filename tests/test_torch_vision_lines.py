"""The detection, segmentation and pose lines through both packages, on
the CPU.

Weights: the JAX zoo's own ``seed:0`` flax variables (its builders' init,
jitted here for speed: the same values), carried across with
``from_jax_variables`` into an ``.npz`` the port loads with
``params:<npz>``; the port's filter runs with ``accelerator=true:cpu``.

  - decoders: the same raw tensors (the JAX models' outputs on the
    reference lines' videotestsrc frames) go into both packages'
    ``bounding_boxes`` (``mobilenet-ssd``, ``mobilenet-ssd-postprocess``,
    ``yolov8``), ``image_segment`` and ``pose_estimation``: overlays
    byte-equal, ``meta`` equal. Where a box's top lies below the frame
    the JAX decoder raises; the port's skips the edge
    (:func:`test_box_below_the_frame`);
  - lines: the reference's own lines (tests/test_models.py:83-139,
    tests/test_detection_pp.py:93-130, tests/test_decoders.py:438-463)
    run through the port's ``parse_launch``, and the filter's outputs of
    the same line without its decoder are held to the JAX model's on the
    same frames. Both compute in bfloat16, whose rounding differences
    scale with the activations' magnitude rather than each output's, and
    flax's init leaves the outputs small (up to 4e-2 for SSD's logits,
    1e-3 for DeepLab's, 4e-6 for PoseNet's heatmaps): the absolute
    tolerance is 2^-4 of the largest output (16 bf16 ulps there)
    and the relative one 0.05 (the JAX package's bf16 rtol,
    tests/test_fused_block.py::test_model_zoo_fused_custom); DeepLab's
    per-pixel classes and SSD's per-anchor classes agree above 0.99
    (tests/test_fused_block.py::test_deeplab_zoo_fused_custom); the pp
    quads by the near-agreement rule of test_ssd_zoo_fused_pp_custom.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_shared import jit_init  # noqa: E402
from test_torch_shared import (  # noqa: E402,F401 (fixtures)
    equal_name_counters,
    one_torch_thread,
)
jax = pytest.importorskip("jax")

from nnstreamer_tpu_torch.models.convert import (  # noqa: E402
    from_jax_variables,
    save_state_dict,
)

#: bf16 tolerance: absolute, as a share of the largest output; relative
ATOL_SHARE, RTOL = 2.0 ** -4, 0.05

#: the reference lines' models: zoo name, frame size, custom (seed:0 ...)
MODELS = {
    "ssd": ("ssd_mobilenet", 96, "size:96,width:0.35,classes:8"),
    "ssd_pp": ("ssd_mobilenet", 96, "size:96,width:0.35,classes:8,"
               "postproc:pp,pp_topk:16,pp_score:0.3"),
    "deeplab": ("deeplab_v3", 65, "size:65,width:0.35,classes:8"),
    "posenet": ("posenet", 33, "size:33,width:0.35,keypoints:5"),
    "yolov8": ("yolov8", 64, "size:64,classes:4"),
    "yolov8_pp": ("yolov8", 64, "size:64,classes:4,postproc:pp,pp_topk:16,"
                  "pp_score:0.01"),
}

def _custom(spec):
    return dict(kv.split(":", 1) for kv in spec.split(","))


_BUNDLES = {}


def _jax(name, tmp_path_factory):
    """(variables, jitted JAX apply, npz path) of one reference model:
    the zoo's seed:0 variables."""
    if name not in _BUNDLES:
        import nnstreamer_tpu.models as jm

        zoo, _, spec = MODELS[name]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jm, "_init_on_cpu", jit_init)
            b = jm.get_model(zoo, {"seed": "0", **_custom(spec)})
        variables = jax.device_get(b.params)
        npz = str(tmp_path_factory.mktemp(name) / "w.npz")
        save_state_dict(from_jax_variables(variables, model=zoo), npz)
        _BUNDLES[name] = (variables, jax.jit(b.apply_fn), npz)
    return _BUNDLES[name]


def _port_custom(name, npz):
    spec = ",".join(kv for kv in MODELS[name][2].split(",")
                    if not kv.startswith("seed:"))
    return f"params:{npz},{spec}"


def _videotest_frame(mod, size):
    p = mod.parse_launch(f"videotestsrc num-buffers=1 width={size} "
                         f"height={size} ! tensor_converter "
                         "! tensor_sink name=out")
    p.play()
    assert p.bus.wait_eos(60)
    frame = np.asarray(p["out"].collected[0][0])
    p.stop()
    return frame


@pytest.fixture(scope="module")
def frames():
    """The reference lines' videotestsrc frame per size, from the JAX
    package, and the port's videotestsrc's, which must be the same."""
    from nnstreamer_tpu import pipeline as jp
    from nnstreamer_tpu_torch import pipeline as tp

    out = {}
    for size in sorted({v[1] for v in MODELS.values()}):
        out[size] = _videotest_frame(jp, size)
        np.testing.assert_array_equal(_videotest_frame(tp, size), out[size])
    return out


def _raw(name, tmp_path_factory, frame):
    variables, apply, _ = _jax(name, tmp_path_factory)
    out = apply(variables, frame)
    return [np.asarray(o) for o in (out if isinstance(out, tuple)
                                    else (out,))]


# -- decoders: the same raw tensors into both packages ----------------------

def _decode(pkg, mode, options, tensors):
    import importlib

    dmod = importlib.import_module(f"{pkg}.decoders.{mode}")
    types = importlib.import_module(f"{pkg}.types")
    buffer = importlib.import_module(f"{pkg}.buffer")
    cls = {"bounding_boxes": "BoundingBoxes", "image_segment": "ImageSegment",
           "pose_estimation": "PoseEstimation"}[mode]
    dec = getattr(dmod, cls)()
    dec.init(list(options) + [None] * (9 - len(options)))
    cfg = types.TensorsConfig(info=types.TensorsInfo(tensors=[
        types.TensorInfo.from_np_shape(t.shape, str(t.dtype))
        for t in tensors]), rate_n=30, rate_d=1)
    caps = dec.get_out_caps(cfg)
    out = dec.decode(buffer.Buffer(tensors=[t.copy() for t in tensors]), cfg)
    return str(caps), np.asarray(out.tensors[0]), dict(out.meta)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from nnstreamer_tpu.models.ssd_mobilenet import write_box_priors

    d = tmp_path_factory.mktemp("files")
    write_box_priors(str(d / "priors.txt"), 96)
    (d / "labels.txt").write_text("\n".join(f"c{i}" for i in range(91)))
    (d / "pose.txt").write_text("\n".join(f"kp{i} {(i + 1) % 5}"
                                          for i in range(5)))
    return d


_DECODER_CASES = {
    "ssd": ("bounding_boxes",
            lambda f: ["mobilenet-ssd", f / "labels.txt",
                       f"{f / 'priors.txt'}:0.5", "96:96", "96:96"]),
    "ssd_pp": ("bounding_boxes",
               lambda f: ["mobilenet-ssd-postprocess", f / "labels.txt",
                          "0:1:2:3,0", "96:96", "96:96"]),
    "yolov8": ("bounding_boxes",
               lambda f: ["yolov8", None, "1:0.25:0.45", "64:64", "64:64"]),
    "yolov8_pp": ("bounding_boxes",
                  lambda f: ["mobilenet-ssd-postprocess", f / "labels.txt",
                             "0:1:2:3,0", "64:64", "64:64"]),
    "deeplab": ("image_segment", lambda f: ["tflite-deeplab"]),
    "posenet": ("pose_estimation",
                lambda f: ["33:33", "33:33", f / "pose.txt",
                           "heatmap-offset"]),
}


@pytest.mark.parametrize("name", sorted(_DECODER_CASES))
def test_decoders_match_on_the_same_tensors(name, frames, files,
                                            tmp_path_factory):
    mode, opts = _DECODER_CASES[name]
    options = [None if o is None else str(o) for o in opts(files)]
    tensors = _raw(name, tmp_path_factory, frames[MODELS[name][1]])
    want = _decode("nnstreamer_tpu", mode, options, tensors)
    got = _decode("nnstreamer_tpu_torch", mode, options, tensors)
    assert got[0] == want[0]
    assert got[1].dtype == want[1].dtype and got[1].shape == want[1].shape
    assert got[1].tobytes() == want[1].tobytes()
    assert got[2].keys() == want[2].keys()
    for k in want[2]:
        np.testing.assert_equal(got[2][k], want[2][k])
    if mode == "bounding_boxes":
        assert want[2]["objects"], "no detection to compare"


# -- the reference's lines through the port ---------------------------------

def _run_port(line, frames_in=None):
    from nnstreamer_tpu_torch.buffer import Buffer
    from nnstreamer_tpu_torch.pipeline import parse_launch

    p = parse_launch(line)
    p.play()
    if frames_in is not None:
        for f in frames_in:
            p["src"].push_buffer(Buffer(tensors=[f]))
        p["src"].end_of_stream()
    assert p.bus.wait_eos(120), p.bus.error and p.bus.error.data
    assert p.bus.error is None, p.bus.error.data
    out = [[np.asarray(t) for t in b.tensors] for b in p["out"].collected]
    p.stop()
    return out


def _filter(name, npz):
    return (f"tensor_filter framework=jax model={MODELS[name][0]} "
            f"custom={_port_custom(name, npz)} accelerator=true:cpu")


_LINE_TAILS = {
    "ssd": lambda f: ("tensor_decoder mode=bounding_boxes "
                      f"option1=mobilenet-ssd option2={f / 'labels.txt'} "
                      f"option3={f / 'priors.txt'}:0.5 option4=96:96 "
                      "option5=96:96"),
    "deeplab": lambda f: ("tensor_decoder mode=image_segment "
                          "option1=tflite-deeplab"),
    "posenet": lambda f: ("tensor_decoder mode=pose_estimation "
                          "option1=33:33 option2=33:33 "
                          f"option3={f / 'pose.txt'} "
                          "option4=heatmap-offset"),
    "yolov8": lambda f: ("tensor_decoder mode=bounding_boxes option1=yolov8 "
                         "option3=1:0.25:0.45 option4=64:64 option5=64:64"),
}


def _assert_bf16_close(name, got, want):
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=ATOL_SHARE * np.abs(w).max())
    if name in ("deeplab", "ssd"):
        agree = (got[-1].argmax(-1) == want[-1].argmax(-1)).mean()
        assert agree > 0.99, agree


@pytest.mark.parametrize("name", sorted(_LINE_TAILS))
def test_reference_line_through_the_port(name, frames, files,
                                         tmp_path_factory):
    """tests/test_models.py's line, weights by npz: one RGBA overlay of
    the frame's size; the same line without its decoder emits the JAX
    model's outputs on that frame."""
    _, size, _ = MODELS[name]
    npz = _jax(name, tmp_path_factory)[2]
    head = (f"videotestsrc num-buffers=1 width={size} height={size} "
            f"! tensor_converter ! {_filter(name, npz)} ! ")
    out = _run_port(head + f"{_LINE_TAILS[name](files)} "
                    "! tensor_sink name=out")
    assert len(out) == 1 and out[0][0].shape == (size, size, 4)
    raw = _run_port(head + "tensor_sink name=out")
    assert len(raw) == 1
    _assert_bf16_close(name, raw[0],
                       _raw(name, tmp_path_factory, frames[size]))


@pytest.mark.parametrize("name", ["ssd_pp", "yolov8_pp"])
def test_pp_line_through_the_port(name, files, tmp_path_factory):
    """tests/test_detection_pp.py's line: two random frames through the
    pp model into mobilenet-ssd-postprocess, one overlay each; the quads
    of the line without its decoder near the JAX bundle's (the rule of
    tests/test_torch_vision.py::test_pp_bundle_matches_jax_on_the_same_weights)."""
    _, size, _ = MODELS[name]
    variables, apply_jax, npz = _jax(name, tmp_path_factory)
    rng = np.random.default_rng(0)
    pushed = [rng.integers(0, 256, (size, size, 3), np.uint8)
              for _ in range(2)]
    head = (f"appsrc name=src caps=video/x-raw,format=RGB,width={size},"
            f"height={size},framerate=0/1 ! tensor_converter "
            f"! {_filter(name, npz)} ! ")
    out = _run_port(head + "tensor_decoder mode=bounding_boxes "
                    "option1=mobilenet-ssd-postprocess "
                    f"option2={files / 'labels.txt'} option3=0:1:2:3,0 "
                    f"option4={size}:{size} option5={size}:{size} "
                    "! tensor_sink name=out", pushed)
    assert len(out) == 2 and out[0][0].shape == (size, size, 4)
    quads = _run_port(head + "tensor_sink name=out", pushed)
    for f, got in zip(pushed, quads):
        want = [np.asarray(o) for o in apply_jax(variables, f)]
        assert [g.shape for g in got] == [w.shape for w in want]
        n_want, n_got = int(want[3].reshape(-1)[0]), int(
            got[3].reshape(-1)[0])
        assert abs(n_want - n_got) <= max(3, n_want // 10), (n_want, n_got)
        lead = min(n_want, n_got, 10)
        assert lead > 0
        np.testing.assert_allclose(got[2][:, :lead], want[2][:, :lead],
                                   atol=5e-3, rtol=5e-3)
        # the class scores under flax's init lie within 1e-2 of 0.5, so
        # the order of near-tied leaders is rounding: each must match a
        # JAX detection of its class, score and box instead
        for i in range(lead):
            assert any(want[1][0, j] == got[1][0, i]
                       and abs(want[2][0, j] - got[2][0, i]) <= 5e-3
                       and np.abs(want[0][0, j] - got[0][0, i]).max() <= 5e-3
                       for j in range(min(lead + 3, want[1].shape[1]))), i


def test_split_batch_line_through_the_port(files, tmp_path_factory):
    """tests/test_decoders.py's split-batch line: three frames per tensor
    from the converter, one overlay per frame from the decoder."""
    npz = _jax("ssd", tmp_path_factory)[2]
    out = _run_port(
        "videotestsrc num-buffers=3 width=96 height=96 "
        "! tensor_converter frames-per-tensor=3 "
        f"! {_filter('ssd', npz)} ! tensor_decoder split-batch=3 "
        "mode=bounding_boxes option1=mobilenet-ssd "
        f"option2={files / 'labels.txt'} option3={files / 'priors.txt'}:0.5 "
        "option4=96:96 option5=96:96 ! tensor_sink name=out")
    assert len(out) == 3
    assert all(o[0].shape == (96, 96, 4) for o in out)


@pytest.mark.parametrize("top", [103, 120])
def test_box_below_the_frame(top):
    """A detection whose top lies below the frame: the JAX decoder's draw
    indexes past the canvas and raises; the port's draws the other boxes
    exactly as the JAX decoder draws them without it, and of the box what
    the reference's clamps leave inside the frame: its bottom edge, which
    ``min(height - 1, ...)`` moves to the last row, and the visible part
    of its label (none at top 120)."""
    from nnstreamer_tpu.decoders import detections as jdet
    from nnstreamer_tpu.decoders import rasterfont
    from nnstreamer_tpu_torch.decoders import detections as tdet

    def dets(mod, n):
        return mod.make_detections(
            x=[4, 40, 10][:n], y=[6, 30, top][:n], width=[20, 30, 20][:n],
            height=[10, 40, 20][:n], class_id=[1, 2, 1][:n],
            prob=[0.9, 0.8, 0.7][:n])

    labels = ["bg", "a", "b"]
    want = np.zeros((96, 96), np.uint32)
    jdet.draw_boxes(want, dets(jdet, 2), 96, 96, labels)
    want[95, 10:31] = jdet.PIXEL_VALUE
    if top - 14 < 96:
        rasterfont.draw_text(want, 10, top - 14, "a",
                             color=int(jdet.PIXEL_VALUE))
    with pytest.raises(IndexError):
        jdet.draw_boxes(np.zeros((96, 96), np.uint32), dets(jdet, 3), 96, 96,
                        labels)
    got = np.zeros((96, 96), np.uint32)
    tdet.draw_boxes(got, dets(tdet, 3), 96, 96, labels)
    assert got.tobytes() == want.tobytes()
