"""The port's detection, segmentation and pose models against the JAX
package's flax models, and its device-side detection post-process against
``nnstreamer_tpu.ops.detection``.

Each model is built in float32 from flax's own init with the BatchNorm
statistics perturbed away from the identity (so the fold matters), carried
across by ``from_jax_variables``. The unfused module and the BN-folded
forwards ('kernel': the fused:pallas forward, whose stride-1 blocks take
the kernel's plain version on a CPU tensor; 'plain'; 'xla') are held to
the flax model at the reference's own tolerances
(tests/test_fused_block.py): 2e-3 absolute and relative for SSD and
DeepLab (argmax agreement above 0.999 for DeepLab's per-pixel classes),
5e-4 for PoseNet and YOLOv8; the port's 'xla' forward to the JAX
``fused:xla`` forward alike. The ``postproc:pp`` bundles against the JAX
bundles are in tests/test_torch_vision_pp.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_shared import (  # noqa: E402,F401 (fixtures)
    equal_name_counters,
    one_torch_thread,
)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nnstreamer_tpu_torch.models.convert import from_jax_variables  # noqa: E402


def _perturbed(model, x, seed):
    """flax init at ``x``'s shape with BatchNorm statistics moved off the
    identity; returns (variables, flax outputs as numpy)."""
    rng = np.random.default_rng(seed)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    stats = jax.tree_util.tree_map(
        lambda a: a + rng.uniform(0.0, 0.1, a.shape).astype(np.float32),
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    out = jax.jit(model.apply)(variables, jnp.asarray(x))
    outs = out if isinstance(out, tuple) else (out,)
    return variables, tuple(np.asarray(o) for o in outs)


def _outs(out):
    outs = out if isinstance(out, tuple) else (out,)
    return tuple(o.numpy() for o in outs)


# name, flax module, port module class, kwargs, input shape, tolerance
_CASES = {
    "ssd": ("nnstreamer_tpu.models.ssd_mobilenet", "SSDMobileNetV2",
            "nnstreamer_tpu_torch.models.ssd_mobilenet",
            dict(num_classes=7, width_mult=0.35), (1, 96, 96, 3), 2e-3),
    "deeplab": ("nnstreamer_tpu.models.deeplab_v3", "DeepLabV3",
                "nnstreamer_tpu_torch.models.deeplab_v3",
                dict(num_classes=5, width_mult=0.35), (1, 65, 65, 3), 2e-3),
    "posenet": ("nnstreamer_tpu.models.posenet", "PoseNet",
                "nnstreamer_tpu_torch.models.posenet",
                dict(num_keypoints=5, width_mult=0.35), (2, 33, 33, 3), 5e-4),
    "yolov8": ("nnstreamer_tpu.models.yolov8", "YoloV8",
               "nnstreamer_tpu_torch.models.yolov8",
               dict(num_classes=4), (2, 64, 64, 3), 5e-4),
}
_ZOO = {"ssd": "ssd_mobilenet", "deeplab": "deeplab_v3",
        "posenet": "posenet", "yolov8": "yolov8"}


def _mod(name):
    import importlib

    return importlib.import_module(name)


_FLAX = {}


def _case(name):
    """(flax module, variables, x, flax outputs, tolerance), made once per
    model."""
    if name not in _FLAX:
        jmod, cls, _, kw, shape, tol = _CASES[name]
        flax_model = getattr(_mod(jmod), cls)(dtype=jnp.float32, **kw)
        x = np.random.default_rng(4).normal(0, 1, shape).astype(np.float32)
        variables, want = _perturbed(flax_model, x, seed=len(name))
        _FLAX[name] = (flax_model, variables, x, want, tol)
    return _FLAX[name]


#: the models with a BN-folded forward (YOLOv8 has none, in either package)
_FOLDED = ("deeplab", "posenet", "ssd")


def _port(name, variables):
    jmod, cls, tmod, kw, _, _ = _CASES[name]
    m = getattr(_mod(tmod), cls)(dtype=torch.float32, **kw)
    m.load_state_dict(from_jax_variables(variables, model=_ZOO[name]))
    return m.eval()


def _close(name, got, want, tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol)
    if name == "deeplab":
        agree = (got[0].argmax(-1) == want[0].argmax(-1)).mean()
        assert agree > 0.999, agree


@pytest.mark.parametrize("name", sorted(_CASES))
def test_unfused_module_matches_flax(name):
    _, variables, x, want, tol = _case(name)
    with torch.no_grad():
        got = _outs(_port(name, variables)(torch.from_numpy(x)))
    _close(name, got, want, tol)


@pytest.mark.parametrize("mode", ["kernel", "plain", "xla"])
@pytest.mark.parametrize("name", _FOLDED)
def test_fused_forward_matches_flax(name, mode):
    _, variables, x, want, tol = _case(name)
    fused = _mod(_CASES[name][2])._make_fused_apply(
        _port(name, variables), mode=mode, compute_dtype=torch.float32)
    _close(name, _outs(fused(torch.from_numpy(x))), want, tol)


@pytest.mark.parametrize("name", _FOLDED)
def test_xla_forward_matches_jax_fused_xla(name):
    flax_model, variables, x, _, tol = _case(name)
    jax_fused = _mod(_CASES[name][0])._make_fused_apply(
        flax_model, mode="xla", compute_dtype=jnp.float32)
    out = jax.jit(jax_fused)(variables, jnp.asarray(x))
    want = tuple(np.asarray(o) for o in (out if isinstance(out, tuple)
                                          else (out,)))
    got = _outs(_mod(_CASES[name][2])._make_fused_apply(
        _port(name, variables), mode="xla",
        compute_dtype=torch.float32)(torch.from_numpy(x)))
    _close(name, got, want, tol)


@pytest.mark.parametrize("name", sorted(_CASES))
def test_tree_names_its_model(name):
    """Without ``model=`` the converter tells the trees apart by their
    modules, and names the same mapping."""
    _, variables, _, _, _ = _case(name)
    a = from_jax_variables(variables)
    b = from_jax_variables(variables, model=_ZOO[name])
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("name,mode,fused,conv,plain", [
    ("ssd", "kernel", 17, 0, 0),
    ("ssd", "plain", 0, 0, 17),
    ("ssd", "xla", 0, 17, 0),
    ("deeplab", "kernel", 13, 4, 0),
    ("deeplab", "plain", 0, 4, 13),
    ("deeplab", "xla", 0, 17, 0),
])
def test_fused_forward_routes_blocks(monkeypatch, name, mode, fused, conv,
                                     plain):
    """Which function each block goes to: in 'kernel' mode the undilated
    blocks, stride 1 and 2, to fused_inverted_residual (17 for SSD, 13 for
    DeepLab) through inverted_residual_auto, the dilated ones to
    inverted_residual_conv (0 and 4), and inverted_residual_plain only
    from inside the kernel's wrapper (its CPU path); in 'plain' mode the
    kernel's blocks to inverted_residual_plain itself; in 'xla' mode every
    block to inverted_residual_conv."""
    from nnstreamer_tpu_torch.ops import fused_block as fb

    calls = {"fused": 0, "conv": 0, "plain": 0, "plain_outside": 0,
             "dilated": 0}
    inside = []

    def spy(key, real):
        def wrapped(x, folded, **kw):
            if key == "plain" and not inside:
                calls["plain_outside"] += 1
            if key == "conv" and kw.get("dilation", 1) != 1:
                calls["dilated"] += 1
            calls[key] += 1
            inside.append(key)
            try:
                return real(x, folded, **kw)
            finally:
                inside.pop()
        return wrapped

    for key, attr in (("fused", "fused_inverted_residual"),
                      ("conv", "inverted_residual_conv"),
                      ("plain", "inverted_residual_plain")):
        monkeypatch.setattr(fb, attr, spy(key, getattr(fb, attr)))
    tmod = _mod(_CASES[name][2])
    m = getattr(tmod, _CASES[name][1])(dtype=torch.float32,
                                        **_CASES[name][3])
    tmod.init_weights(m, 0)
    forward = tmod._make_fused_apply(m.eval(), mode=mode,
                                     compute_dtype=torch.float32)
    size = _CASES[name][4][1]
    x = torch.from_numpy(np.random.default_rng(6).normal(
        0, 1, (1, size, size, 3)).astype(np.float32))
    outs = _outs(forward(x))
    assert all(np.isfinite(o).all() for o in outs)
    assert calls["fused"] == fused and calls["conv"] == conv
    assert calls["dilated"] == (4 if name == "deeplab" else 0)
    if mode == "kernel":  # the wrapper's CPU path, once per kernel block
        assert calls["plain"] == fused and calls["plain_outside"] == 0
    else:
        assert calls["plain"] == calls["plain_outside"] == plain


@pytest.mark.parametrize("name,size,blocks", [
    ("ssd", 300, [(150, 32, 32, 16, 1), (150, 16, 96, 24, 2),
                  (75, 24, 144, 24, 1), (75, 24, 144, 32, 2),
                  (38, 32, 192, 32, 1), (38, 32, 192, 32, 1),
                  (38, 32, 192, 64, 2), (19, 64, 384, 64, 1),
                  (19, 64, 384, 64, 1), (19, 64, 384, 64, 1),
                  (19, 64, 384, 96, 1), (19, 96, 576, 96, 1),
                  (19, 96, 576, 96, 1), (19, 96, 576, 160, 2),
                  (10, 160, 960, 160, 1), (10, 160, 960, 160, 1),
                  (10, 160, 960, 320, 1)]),
    ("deeplab", 257, [(129, 32, 32, 16, 1), (129, 16, 96, 24, 2),
                      (65, 24, 144, 24, 1), (65, 24, 144, 32, 2),
                      (33, 32, 192, 32, 1), (33, 32, 192, 32, 1),
                      (33, 32, 192, 64, 2), (17, 64, 384, 64, 1),
                      (17, 64, 384, 64, 1), (17, 64, 384, 64, 1),
                      (17, 64, 384, 96, 1), (17, 96, 576, 96, 1),
                      (17, 96, 576, 96, 1)]),
])
def test_kernel_block_shapes(name, size, blocks):
    """The (H, Cin, Ch, Cout, stride) of the blocks the kernel runs at full
    width, from ``kernel_block_shapes`` (chip_smoke.py's kernel rows): the
    shapes the main path gives the kernel, the stride-2 blocks (odd maps
    75, 19, 129, 65 and 33 among their inputs and outputs) included and
    DeepLab's 4 dilated blocks left out."""
    from nnstreamer_tpu_torch.models.mobilenet_v2 import kernel_block_shapes

    m = getattr(_mod(_CASES[name][2]), _CASES[name][1])()
    got = [(H, cin, ch, cout, stride) for _, H, W, cin, ch, cout, stride
           in kernel_block_shapes(m, size)]
    assert got == blocks


# -- anchors and the device post-process ----------------------------------

@pytest.mark.parametrize("size", [300, 96, 65])
def test_box_priors_file_is_the_jax_file(tmp_path, size):
    from nnstreamer_tpu.models import ssd_mobilenet as jssd
    from nnstreamer_tpu_torch.models import ssd_mobilenet as tssd

    a, b = tmp_path / "jax.txt", tmp_path / "port.txt"
    assert jssd.write_box_priors(str(a), size) == \
        tssd.write_box_priors(str(b), size) == tssd.num_anchors(size) == \
        jssd.num_anchors(size)
    assert a.read_bytes() == b.read_bytes()
    np.testing.assert_array_equal(tssd.generate_anchors(size),
                                  jssd.generate_anchors(size))


def _det_inputs(seed, B=3, N=300, levels=8):
    """Boxes around a few centres (so NMS has overlaps to suppress),
    scores quantised to ``levels`` values (so ties are many) and classes
    that name each row's index (so the order of ties shows)."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(0.2, 0.8, (B, 6, 2))
    pick = rng.integers(0, 6, (B, N))
    c = np.take_along_axis(centres, pick[..., None], axis=1) \
        + rng.normal(0, 0.03, (B, N, 2))
    hw = rng.uniform(0.05, 0.3, (B, N, 2))
    boxes = np.concatenate([c - hw / 2, c + hw / 2], -1).astype(np.float32)
    scores = (rng.integers(0, levels, (B, N)) / (levels - 1)).astype(
        np.float32)
    classes = np.broadcast_to(np.arange(N), (B, N)).astype(np.int32)
    return boxes, scores, classes


@pytest.mark.parametrize("k,iou,thr,n", [(100, 0.5, 0.5, 300),
                                         (16, 0.3, 0.0, 300),
                                         (50, 0.6, 0.2, 20)])
def test_detection_postprocess_matches_jax(k, iou, thr, n):
    """Tied scores break by the lower index as lax.top_k's, survivors
    compact in score order: classes (the original indices here), scores
    and num equal, boxes within 1e-6; k above N pads."""
    from nnstreamer_tpu.ops.detection import detection_postprocess as jpp
    from nnstreamer_tpu_torch.ops.detection import detection_postprocess

    boxes, scores, classes = _det_inputs(k + n, N=n)
    want = [np.asarray(o) for o in jpp(jnp.asarray(boxes),
                                       jnp.asarray(scores),
                                       jnp.asarray(classes), k=k,
                                       iou_thr=iou, score_thr=thr)]
    got = [o.numpy() for o in detection_postprocess(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        torch.from_numpy(classes).long(), k=k, iou_thr=iou, score_thr=thr)]
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], atol=1e-6, rtol=0)
    assert 0 < want[3].min() and want[3].max() < min(k, n)  # NMS did work


def test_nms_valid_matches_jax():
    from nnstreamer_tpu.ops.detection import _nms_valid as jnms
    from nnstreamer_tpu_torch.ops.detection import _nms_valid

    boxes, _, _ = _det_inputs(9, B=4, N=64)
    got = _nms_valid(torch.from_numpy(boxes), 0.4).numpy()
    for b in range(4):
        want = np.asarray(jnms(jnp.asarray(boxes[b]), 0.4))
        np.testing.assert_array_equal(got[b], want)
    assert not got.all()


def test_ssd_decode_boxes_matches_jax():
    from nnstreamer_tpu.models.ssd_mobilenet import generate_anchors
    from nnstreamer_tpu.ops.detection import ssd_decode_boxes as jdec
    from nnstreamer_tpu_torch.ops.detection import ssd_decode_boxes

    priors = generate_anchors(96)
    enc = np.random.default_rng(1).normal(
        0, 1, (2, priors.shape[1], 4)).astype(np.float32)
    want = np.asarray(jdec(jnp.asarray(enc), jnp.asarray(priors)))
    got = ssd_decode_boxes(torch.from_numpy(enc),
                           torch.from_numpy(priors)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name,cfg,size,inp,out", [
    ("ssd_mobilenet", {"width": "0.35", "classes": "7"}, 96, "3:96:96",
     "4:1:204.7:204"),
    ("ssd_mobilenet", {"width": "0.35", "classes": "7", "postproc": "pp",
                       "pp_topk": "16"}, 96, "3:96:96", "4:16.16.16.1"),
    ("ssd_mobilenet", {}, 300, "3:300:300", "4:1:1917.91:1917"),
    ("deeplab_v3", {"width": "0.35", "classes": "5"}, 65, "3:65:65",
     "5:65:65"),
    ("posenet", {"width": "0.35", "keypoints": "5"}, 33, "3:33:33",
     "5:3:3.10:3:3"),
    ("yolov8", {"classes": "4"}, 64, "3:64:64", "8:84"),
    ("yolov8", {"classes": "4", "postproc": "pp"}, 64, "3:64:64",
     "4:100.100.100.1"),
])
def test_zoo_caps_and_output_info(name, cfg, size, inp, out):
    """Caps as the JAX builders state them (``dimensions_string`` trims
    the trailing 1s), and ``infer_output`` for a batch of 3 equal to the
    shapes the bundle returns."""
    from nnstreamer_tpu_torch.models import get_model
    from nnstreamer_tpu_torch.types import TensorsInfo

    tb = get_model(name, {"seed": "0", "size": str(size), **cfg},
                   device="cpu")
    assert tb.input_info.dimensions_string() == inp
    assert tb.input_info.types_string() == "uint8"
    assert tb.output_info.dimensions_string() == out
    assert set(tb.output_info.types_string().split(".")) == {"float32"}
    if size > 100:
        return  # caps only: no full-size forward on the CPU
    o = tb.apply_fn(torch.from_numpy(np.zeros((3, size, size, 3), np.uint8)))
    outs = o if isinstance(o, tuple) else (o,)
    info = tb.infer_output(
        TensorsInfo.from_strings(f"3:{size}:{size}:3", "uint8"))
    assert [t.np_shape() for t in info.tensors] == \
        [tuple(t.shape) for t in outs]


def test_seed_init_is_deterministic():
    from nnstreamer_tpu_torch.models import get_model

    for name, cfg in [("ssd_mobilenet", {"size": "96", "width": "0.35"}),
                      ("deeplab_v3", {"size": "65", "width": "0.35"}),
                      ("posenet", {"size": "33", "width": "0.35"}),
                      ("yolov8", {"size": "64"})]:
        a = get_model(name, {"seed": "3", **cfg},
                      device="cpu").module.state_dict()
        b = get_model(name, {"seed": "3", **cfg},
                      device="cpu").module.state_dict()
        c = get_model(name, {"seed": "4", **cfg},
                      device="cpu").module.state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a), name
        assert any(not torch.equal(a[k], c[k]) for k in a), name

