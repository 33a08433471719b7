"""SSD-MobileNet-v2 detection (counterpart of the JAX package's
``models/ssd_mobilenet.py``; the reference's bounding-box example, mode
``mobilenet-ssd`` in box_properties/mobilenetssd.cc).

MobileNet-v2 feature extractor with six SSD heads. Outputs match the
decoder contract (tensordec-boundingbox.cc mobilenet-ssd mode):

  tensors[0]: box encodings, numpy (B, N, 1, 4): ty, tx, th, tw
  tensors[1]: class logits,  numpy (B, N, C): raw scores, class 0 =
              background (the decoder sigmoids and thresholds them)

The anchor ("box prior") generator reproduces the tflite SSD convention
(linear scales, aspect ratios, an extra geometric-mean scale for ratio 1)
and ``write_box_priors`` writes the 4-line ycenter/xcenter/h/w file the
decoder's option3 reads, so model and decoder agree on anchors.

Three forwards, as in ``models/mobilenet_v2.py``: the module's own
(unfused); the train forward (the bundle's ``train_apply_fn``: every
BatchNorm of the backbone and the extra blocks by the batch's statistics,
:func:`models.batch_norm_train`, the raw ``(boxes, scores)`` out, also
for a ``postproc:pp`` bundle, as in the JAX package); and
:func:`_make_fused_apply` (BatchNorm folded, again after a trainer
changed the weights; the 17 backbone blocks, 13 stride-1 and 4
stride-2, through the fused-block kernel on CUDA with ``fused:pallas``,
every ``fused:xla`` block through three convolutions). The 12 head convolutions
are plain ``F.conv2d`` with bias, as the JAX package computes them
outside any Pallas kernel. Each head's NCHW output is permuted to NHWC before it is
flattened, so the anchors come in the priors file's (y, x, anchor) order.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from nnstreamer_tpu_torch.models import (
    ModelBundle,
    batch_of,
    init_conv_bn,
    load_or_init,
    preprocess_frames,
    refolding,
    register_model,
    resolve_fused_apply,
)
from nnstreamer_tpu_torch.models.mobilenet_v2 import (
    InvertedResidual,
    MobileNetV2,
    _conv,
    _conv_bn,
    _make_divisible,
    _relu6,
    fold_blocks,
)
from nnstreamer_tpu_torch.types import TensorInfo, TensorsInfo

# Per-feature-map anchors for 300x300 input: grids 19,10,5,3,2,1 with
# 3 anchors on the first map and 6 on the rest → 1917 total, the classic
# ssd_mobilenet anchor count.
_ASPECTS_FIRST = (1.0, 2.0, 0.5)
_ASPECTS_REST = (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0)

#: the heads' init, as RetinaNet's detection heads: normal weights scaled
#: to give the logits a spread of about 1, and the class biases at the
#: logit of a 1% prior. He-normal heads on these relu6 features give
#: logits of spread ~6, and 9 in 10 anchors pass the decoder's 0.5 score;
#: std 0.006 gives a spread ~1 and a few percent of the anchors
_HEAD_STD = 0.006
_CLS_PRIOR_BIAS = -math.log(99.0)


def _feature_grids(size: int) -> List[int]:
    """Grid sizes of the six SSD feature maps for a square input."""
    g = [math.ceil(size / 16)]  # stride-16 map, then repeated /2
    while len(g) < 6:
        g.append(max(1, math.ceil(g[-1] / 2)))
    return g


def generate_anchors(size: int = 300,
                     scale_min: float = 0.2,
                     scale_max: float = 0.95) -> np.ndarray:
    """tflite-SSD anchor boxes. Returns (4, N): ycenter, xcenter, h, w —
    the row layout of the decoder's box-priors file
    (box_properties/mobilenetssd.cc prior loading)."""
    grids = _feature_grids(size)
    k = len(grids)
    scales = [scale_min + (scale_max - scale_min) * i / (k - 1) for i in range(k)]
    scales.append(1.0)
    rows: List[Tuple[float, float, float, float]] = []
    for i, g in enumerate(grids):
        aspects = _ASPECTS_FIRST if i == 0 else _ASPECTS_REST
        anchors: List[Tuple[float, float]] = []
        for a in aspects:
            s = scales[i]
            anchors.append((s / math.sqrt(a), s * math.sqrt(a)))  # (h, w)
        if i > 0 and len(aspects) == 5:
            # tflite convention: ratio-1 extra anchor appended
            anchors.append((math.sqrt(scales[i] * scales[i + 1]),) * 2)
        for y in range(g):
            for x in range(g):
                cy = (y + 0.5) / g
                cx = (x + 0.5) / g
                for h, w in anchors:
                    rows.append((cy, cx, h, w))
    return np.asarray(rows, np.float32).T.copy()  # (4, N)


def write_box_priors(path: str, size: int = 300) -> int:
    """Write the decoder's option3 box-priors file; returns anchor count."""
    pri = generate_anchors(size)
    with open(path, "w", encoding="utf-8") as f:
        for row in pri:
            f.write(" ".join(f"{v:.6f}" for v in row) + "\n")
    return pri.shape[1]


def _anchors_per_cell(i: int) -> int:
    return len(_ASPECTS_FIRST) if i == 0 else len(_ASPECTS_REST) + 1


def num_anchors(size: int = 300) -> int:
    return sum(g * g * _anchors_per_cell(i)
               for i, g in enumerate(_feature_grids(size)))


class _ExtraBlock(nn.Module):
    """SSD extra feature block: 1x1 reduce + 3x3 stride-2 expand."""

    def __init__(self, in_ch: int, out_ch: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.reduce_conv = nn.Conv2d(in_ch, out_ch // 2, 1, bias=False)
        self.reduce_bn = nn.BatchNorm2d(out_ch // 2)
        self.expand_conv = nn.Conv2d(out_ch // 2, out_ch, 3, stride=2,
                                     bias=False)
        self.expand_bn = nn.BatchNorm2d(out_ch)

    def forward(self, x: torch.Tensor,
                new_state: Optional[list] = None) -> torch.Tensor:  # NCHW
        dt, ns = self.dtype, new_state
        x = _relu6(_conv_bn(x, self.reduce_conv, self.reduce_bn, dt, ns))
        return _relu6(_conv_bn(x, self.expand_conv, self.expand_bn, dt, ns))


class SSDMobileNetV2(nn.Module):
    """MobileNet-v2 backbone + 6 SSD heads, NHWC in.

    Feature taps: the output of the 96-channel stage (stride 16) and the
    backbone's 1x1 head (stride 32), then four extra stride-2 blocks —
    grids 19, 10, 5, 3, 2, 1 at 300 px."""

    CFG = MobileNetV2.CFG
    #: the stride-16 tap follows the fifth stage's last block
    TAP_BLOCK = sum(n for _, _, n, _ in MobileNetV2.CFG[:5]) - 1

    def __init__(self, num_classes: int = 91, width_mult: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_classes, self.width_mult, self.dtype = (
            num_classes, width_mult, dtype)
        ch = _make_divisible(32 * width_mult)
        self.stem_conv = nn.Conv2d(3, ch, 3, stride=2, bias=False)
        self.stem_bn = nn.BatchNorm2d(ch)
        blocks, tap_ch = [], []
        for expand, c, n, s in self.CFG:
            out_ch = _make_divisible(c * width_mult)
            for i in range(n):
                blocks.append(InvertedResidual(ch, out_ch, s if i == 0 else 1,
                                               expand, dtype=dtype))
                ch = out_ch
            if len(blocks) - 1 == self.TAP_BLOCK:
                tap_ch.append(ch)
        self.blocks = nn.ModuleList(blocks)
        last = _make_divisible(1280 * max(1.0, width_mult))
        self.head_conv = nn.Conv2d(ch, last, 1, bias=False)
        self.head_bn = nn.BatchNorm2d(last)
        tap_ch.append(last)
        extras, ch = [], last
        for out_ch in (512, 256, 256, 128):
            extras.append(_ExtraBlock(ch, out_ch, dtype))
            tap_ch.append(out_ch)
            ch = out_ch
        self.extras = nn.ModuleList(extras)
        self.box_heads = nn.ModuleList(
            nn.Conv2d(c, _anchors_per_cell(i) * 4, 3)
            for i, c in enumerate(tap_ch))
        self.cls_heads = nn.ModuleList(
            nn.Conv2d(c, _anchors_per_cell(i) * num_classes, 3)
            for i, c in enumerate(tap_ch))

    def forward(self, x: torch.Tensor, new_state: Optional[list] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """NHWC float frames → (boxes (B, N, 1, 4), logits (B, N, C)),
        float32 (the unfused forward; with ``new_state`` the train
        forward, see :func:`models.mobilenet_v2._conv_bn`)."""
        dt, ns = self.dtype, new_state
        y = _relu6(_conv_bn(x.permute(0, 3, 1, 2), self.stem_conv,
                            self.stem_bn, dt, ns))
        taps = []
        for i, blk in enumerate(self.blocks):
            y = blk.forward_nchw(y, ns)
            if i == self.TAP_BLOCK:
                taps.append(y)
        y = _relu6(_conv_bn(y, self.head_conv, self.head_bn, dt, ns))
        taps.append(y)
        for extra in self.extras:
            y = extra(y, ns)
            taps.append(y)
        return _assemble(
            [_conv(f, h, dt).permute(0, 2, 3, 1)
             for f, h in zip(taps, self.box_heads)],
            [_conv(f, h, dt).permute(0, 2, 3, 1)
             for f, h in zip(taps, self.cls_heads)],
            self.num_classes)


def _assemble(locs, confs, num_classes: int):
    """The heads' NHWC outputs → (boxes (B, N, 1, 4), logits (B, N, C)),
    float32: each map flattened in (y, x, anchor) order, maps in tap
    order. Boxes carry the (B, N, 1, 4) layout whose dims read 4:1:N:B,
    the tflite-zoo layout the decoder checks."""
    b = locs[0].shape[0]
    boxes = torch.cat([v.reshape(b, -1, 4) for v in locs], dim=1)
    scores = torch.cat([v.reshape(b, -1, num_classes) for v in confs], dim=1)
    return boxes.float()[:, :, None, :], scores.float()


def init_heads(box_heads, cls_heads, seed: int,
               std: float = _HEAD_STD) -> None:
    """Detection-head init: weights N(0, ``std``) from
    ``np.random.default_rng(seed)``, box biases 0, class biases at the
    logit of a 1% prior."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for h in list(box_heads) + list(cls_heads):
            h.weight.copy_(torch.from_numpy(rng.normal(
                0.0, std, h.weight.shape).astype(np.float32)))
            h.bias.zero_()
        for h in cls_heads:
            h.bias.fill_(_CLS_PRIOR_BIAS)


def init_weights(model: SSDMobileNetV2, seed: int) -> None:
    """:func:`models.init_conv_bn`, then :func:`init_heads`."""
    init_conv_bn(model, seed)
    init_heads(model.box_heads, model.cls_heads, seed + 1)


def _make_fused_apply(model: SSDMobileNetV2, mode: str = "kernel",
                      compute_dtype: torch.dtype = None):
    """BN-folded forward, the counterpart of the JAX ``_make_fused_apply``:
    every backbone and extra-block BatchNorm folds into its conv, the
    blocks go where :func:`models.mobilenet_v2.fold_blocks` routes them for
    ``mode`` ('kernel', 'xla' or 'plain'), and the SSD heads (bias convs,
    no BatchNorm) run as they are. It folds again at the first call after
    a trainer changed the weights (:func:`models.refolding`)."""
    return refolding(model,
                     lambda: (_fold(model, mode, compute_dtype), None))


def _fold(model: SSDMobileNetV2, mode: str, compute_dtype):
    from nnstreamer_tpu_torch.ops.fused_block import fold_conv_bn_apply

    cd = compute_dtype or model.dtype
    dev = model.stem_conv.weight.device

    def conv(c, bn=None, act="relu6"):
        return fold_conv_bn_apply(c, bn, act=act, compute_dtype=cd,
                                  device=dev)

    with torch.no_grad():
        stem = conv(model.stem_conv, model.stem_bn)
        blocks = fold_blocks(model.blocks, mode, cd, dev)
        head = conv(model.head_conv, model.head_bn)
        extras = [(conv(e.reduce_conv, e.reduce_bn),
                   conv(e.expand_conv, e.expand_bn)) for e in model.extras]
        box_heads = [conv(h, act=None) for h in model.box_heads]
        cls_heads = [conv(h, act=None) for h in model.cls_heads]

    def forward(x: torch.Tensor):
        y = stem(x).contiguous()  # NHWC for the blocks
        taps = []
        for i, (fn, fw, stride, dilation) in enumerate(blocks):
            y = fn(y, fw, stride=stride, dilation=dilation, compute_dtype=cd)
            if i == model.TAP_BLOCK:
                taps.append(y)
        y = head(y)
        taps.append(y)
        for reduce, expand in extras:
            y = expand(reduce(y))
            taps.append(y)
        return _assemble([h(f) for f, h in zip(taps, box_heads)],
                         [h(f) for f, h in zip(taps, cls_heads)],
                         model.num_classes)

    return torch.no_grad()(forward)


def _pp_info(batch: int, k: int) -> TensorsInfo:
    """The pp quad's info: locations (B, k, 4), classes (B, k), scores
    (B, k), num (B, 1), float32."""
    return TensorsInfo(tensors=[
        TensorInfo.from_np_shape(shape, "float32")
        for shape in ((batch, k, 4), (batch, k), (batch, k), (batch, 1))])


def pp_options(custom: Dict[str, str]) -> Tuple[int, float, float]:
    """``postproc:pp``'s (top-k, IoU threshold, score threshold) from
    ``pp_topk`` / ``pp_iou`` / ``pp_score`` (defaults 100, 0.5, 0.5)."""
    return (int(custom.get("pp_topk", "100")),
            float(custom.get("pp_iou", "0.5")),
            float(custom.get("pp_score", "0.5")))


def ssd_postprocess(boxes_enc: torch.Tensor, logits: torch.Tensor,
                    priors: torch.Tensor, k: int = 100, iou: float = 0.5,
                    thr: float = 0.5):
    """``postproc:pp``: the forward's raw outputs → the reference's
    post-processed quad (box_properties/mobilenetssdpp.cc: locations,
    classes, scores, num) on the device: priors → box decode → sigmoid
    scores → top-k → NMS (``ops/detection.py``). Class 0 is background:
    the best class is taken over classes 1.. (mobilenetssd.cc:83) and
    emitted background-excluded (best, not best+1), the class space of the
    TFLite Detection_PostProcess op that the mobilenet-ssd-postprocess
    decoder consumes."""
    from nnstreamer_tpu_torch.ops.detection import (
        detection_postprocess,
        ssd_decode_boxes,
    )

    cls_scores = torch.sigmoid(logits[..., 1:].float())
    xyxy = ssd_decode_boxes(boxes_enc.reshape(*logits.shape[:2], 4), priors)
    return detection_postprocess(
        xyxy, torch.amax(cls_scores, dim=-1),
        torch.argmax(cls_scores, dim=-1), k=k, iou_thr=iou, score_thr=thr)


def build(custom: Dict[str, str], device: torch.device) -> ModelBundle:
    size = int(custom.get("size", 300))
    width = float(custom.get("width", 1.0))
    classes = int(custom.get("classes", 91))
    model = SSDMobileNetV2(num_classes=classes, width_mult=width)
    load_or_init(model, custom, init_weights)
    model = model.to(device).eval()
    apply_fn = resolve_fused_apply(custom, model, _make_fused_apply)
    if apply_fn is None:
        def apply_fn(x):
            with torch.no_grad():
                return model(preprocess_frames(x, "pm1", model.dtype))

    def train_apply_fn(x):
        new_state = []
        out = model(preprocess_frames(x, "pm1", model.dtype), new_state)
        return out, new_state

    n = num_anchors(size)
    in_info = TensorsInfo.from_strings(f"3:{size}:{size}:1", "uint8")

    if custom.get("postproc") == "pp":
        k, iou, thr = pp_options(custom)
        priors = torch.from_numpy(generate_anchors(size)).to(device)

        @torch.no_grad()
        def pp_apply(x, _base=apply_fn):
            return ssd_postprocess(*_base(x), priors, k, iou, thr)

        return ModelBundle(
            apply_fn=pp_apply, module=model, input_info=in_info,
            output_info=TensorsInfo.from_strings(
                f"4:{k}:1.{k}:1.{k}:1.1:1", "float32.float32.float32.float32"),
            infer_output=lambda info: _pp_info(batch_of(info), k),
            train_apply_fn=train_apply_fn)

    def infer_output(info: TensorsInfo) -> TensorsInfo:
        b, n = batch_of(info), num_anchors(info.tensors[0].np_shape()[-3])
        return TensorsInfo(tensors=[
            TensorInfo.from_np_shape((b, n, 1, 4), "float32"),
            TensorInfo.from_np_shape((b, n, classes), "float32")])

    return ModelBundle(
        apply_fn=apply_fn, module=model, input_info=in_info,
        output_info=TensorsInfo.from_strings(
            f"4:1:{n}:1.{classes}:{n}:1", "float32.float32"),
        infer_output=infer_output, train_apply_fn=train_apply_fn)


register_model("ssd_mobilenet")(build)
register_model("ssd_mobilenet_v2")(build)
