"""PoseNet single-person pose estimation (counterpart of the JAX package's
``models/posenet.py``; the reference's pose example, heatmap+offset
decoding in tensordec-pose.c).

MobileNet-v1-style depthwise-separable backbone at output stride 16 with
two float32 heads:

  tensors[0]: keypoint heatmaps, numpy (B, G, G, K)    dims ``K:G:G:B``
  tensors[1]: short offsets,     numpy (B, G, G, 2K)   dims ``2K:G:G:B``

matching the decoder's ``heatmap-offset`` mode. K defaults to 17 (COCO
keypoints); 257x257 input gives a 17x17 grid.

Three forwards: the module's own (unfused), the train forward (the
bundle's ``train_apply_fn``: every BatchNorm by the batch's statistics,
:func:`models.batch_norm_train`), and :func:`_make_fused_apply`
(``fused:xla``/``fused:pallas``: every BatchNorm folded into its conv,
again after a trainer changed the weights).
The v1 blocks have no expand conv and no residual, so the fused-block
kernel does not apply: every mode runs the folded convolutions, as the
JAX package's does.
"""

from __future__ import annotations

from typing import Dict, Optional

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
    _conv,
    _conv_bn,
    _make_divisible,
    _relu6,
)
from nnstreamer_tpu_torch.types import TensorInfo, TensorsInfo


class SeparableConv(nn.Module):
    """MobileNet-v1 depthwise-separable conv block. NCHW in and out."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.dw_conv = nn.Conv2d(in_ch, in_ch, 3, stride=stride,
                                 groups=in_ch, bias=False)
        self.dw_bn = nn.BatchNorm2d(in_ch)
        self.pw_conv = nn.Conv2d(in_ch, out_ch, 1, bias=False)
        self.pw_bn = nn.BatchNorm2d(out_ch)

    def forward(self, x: torch.Tensor,
                new_state: Optional[list] = None) -> torch.Tensor:
        dt, ns = self.dtype, new_state
        x = _relu6(_conv_bn(x, self.dw_conv, self.dw_bn, dt, ns))
        return _relu6(_conv_bn(x, self.pw_conv, self.pw_bn, dt, ns))


class PoseNet(nn.Module):
    """MobileNet-v1 backbone (output stride 16: the final stage unstrided)
    with heatmap + offset heads, NHWC in."""

    # (out_ch, stride) — the v1 stack with the stride-32 stage kept at 16
    CFG = (
        (64, 1), (128, 2), (128, 1), (256, 2), (256, 1),
        (512, 2), (512, 1), (512, 1), (512, 1), (512, 1), (512, 1),
        (1024, 1), (1024, 1),
    )

    def __init__(self, num_keypoints: int = 17, width_mult: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_keypoints, self.width_mult, self.dtype = (
            num_keypoints, width_mult, dtype)
        ch = _make_divisible(32 * width_mult)
        self.stem_conv = nn.Conv2d(3, ch, 3, stride=2, bias=False)
        self.stem_bn = nn.BatchNorm2d(ch)
        blocks = []
        for c, s in self.CFG:
            out_ch = _make_divisible(c * width_mult)
            blocks.append(SeparableConv(ch, out_ch, s, dtype))
            ch = out_ch
        self.blocks = nn.ModuleList(blocks)
        self.heatmap_head = nn.Conv2d(ch, num_keypoints, 1)
        self.offset_head = nn.Conv2d(ch, 2 * num_keypoints, 1)

    def forward(self, x: torch.Tensor, new_state: Optional[list] = None):
        """NHWC float frames → (heatmaps, offsets), float32 NHWC (the
        unfused forward; with ``new_state`` the train forward, see
        :func:`models.mobilenet_v2._conv_bn`). The heatmaps are raw
        logits: the decoder applies the sigmoid."""
        y = _relu6(_conv_bn(x.permute(0, 3, 1, 2), self.stem_conv,
                            self.stem_bn, self.dtype, new_state))
        for blk in self.blocks:
            y = blk(y, new_state)
        return tuple(_conv(y, h, torch.float32).permute(0, 2, 3, 1)
                     .contiguous()
                     for h in (self.heatmap_head, self.offset_head))


def init_weights(model: PoseNet, seed: int) -> None:
    init_conv_bn(model, seed)


def _make_fused_apply(model: PoseNet, mode: str = "xla",
                      compute_dtype: torch.dtype = None):
    """BN-folded forward, the counterpart of the JAX ``_make_fused_apply``:
    each separable block is folded-dw-conv → relu6 → folded-1x1 → relu6,
    the heads float32 convs with bias. ``mode`` is accepted for the
    ``fused:pallas|xla`` wiring and changes nothing: there is no kernel for
    v1 blocks. It folds again at the first call after a trainer changed
    the weights (:func:`models.refolding`)."""
    if mode not in ("kernel", "xla", "plain"):
        raise ValueError(f"unknown fused forward mode {mode!r}")
    return refolding(model, lambda: (_fold(model, compute_dtype), None))


def _fold(model: PoseNet, compute_dtype):
    from nnstreamer_tpu_torch.ops.fused_block import fold_conv_bn_apply

    cd = compute_dtype or model.dtype
    dev = model.stem_conv.weight.device

    def conv(c, bn=None, act="relu6", dtype=cd):
        return fold_conv_bn_apply(c, bn, act=act, compute_dtype=dtype,
                                  device=dev)

    with torch.no_grad():
        layers = [conv(model.stem_conv, model.stem_bn)]
        for blk in model.blocks:
            layers += [conv(blk.dw_conv, blk.dw_bn),
                       conv(blk.pw_conv, blk.pw_bn)]
        heads = [conv(h, act=None, dtype=torch.float32)
                 for h in (model.heatmap_head, model.offset_head)]

    def forward(x: torch.Tensor):
        y = x
        for layer in layers:
            y = layer(y)
        return tuple(h(y).contiguous() for h in heads)

    return torch.no_grad()(forward)


def build(custom: Dict[str, str], device: torch.device) -> ModelBundle:
    size = int(custom.get("size", 257))
    width = float(custom.get("width", 1.0))
    keypoints = int(custom.get("keypoints", 17))
    model = PoseNet(num_keypoints=keypoints, width_mult=width)
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

    grid = -(-size // 16)  # four SAME-padded stride-2 convs: ceil(size/16)

    def infer_output(info: TensorsInfo) -> TensorsInfo:
        h, w = (-(-v // 16) for v in info.tensors[0].np_shape()[-3:-1])
        b = batch_of(info)
        return TensorsInfo(tensors=[
            TensorInfo.from_np_shape((b, h, w, keypoints), "float32"),
            TensorInfo.from_np_shape((b, h, w, 2 * keypoints), "float32")])

    return ModelBundle(
        apply_fn=apply_fn, module=model,
        input_info=TensorsInfo.from_strings(f"3:{size}:{size}:1", "uint8"),
        output_info=TensorsInfo.from_strings(
            f"{keypoints}:{grid}:{grid}:1.{2 * keypoints}:{grid}:{grid}:1",
            "float32.float32"),
        infer_output=infer_output, train_apply_fn=train_apply_fn)


register_model("posenet")(build)
