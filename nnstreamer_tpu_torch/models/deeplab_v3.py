"""DeepLab-v3 semantic segmentation (counterpart of the JAX package's
``models/deeplab_v3.py``; the reference's image-segment example,
``tflite-deeplab`` mode in tensordec-imagesegment.c).

MobileNet-v2 backbone at output stride 16 (the last two stages run dilated
instead of strided), ASPP with rates 6/12/18 plus image pooling, a biased
float32 class conv and a bilinear resize back to the input resolution.
Output: one float32 tensor, numpy (B, H, W, classes) (dims ``C:W:H:B``);
the decoder takes the argmax over the class axis.

The resize: ``jax.image.resize(..., "bilinear")`` samples at half-pixel
centres and, upsampling, applies no antialias; its counterpart is
``F.interpolate(mode="bilinear", align_corners=False)``, which clamps at
the edges where the JAX resize renormalises its weights to the same
result.

Three forwards, as in ``models/mobilenet_v2.py``: the module's own
(unfused); the train forward (the bundle's ``train_apply_fn``: the
backbone's and the ASPP's BatchNorms by the batch's statistics,
:func:`models.batch_norm_train`); and :func:`_make_fused_apply`
(BatchNorm folded, again after a trainer changed the weights; the 13
undilated blocks, 10 stride-1 and 3 stride-2, through the fused-block
kernel on CUDA with ``fused:pallas``; the 4 dilated blocks, and every
``fused:xla`` block, through three convolutions; the ASPP's conv+BN
branches folded too).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
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
    _conv,
    _conv_bn,
    _make_divisible,
    _relu6,
    fold_blocks,
    run_blocks,
)
from nnstreamer_tpu_torch.types import TensorInfo, TensorsInfo


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling (a 1x1 branch, three dilated 3x3
    branches, image pooling), the DeepLab-v3 head. NCHW in and out."""

    def __init__(self, in_ch: int, out_ch: int = 256,
                 rates: Sequence[int] = (6, 12, 18),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.branches = nn.ModuleList(
            [nn.Conv2d(in_ch, out_ch, 1, bias=False)]
            + [nn.Conv2d(in_ch, out_ch, 3, dilation=r, bias=False)
               for r in rates])
        self.branch_bns = nn.ModuleList(
            nn.BatchNorm2d(out_ch) for _ in range(1 + len(rates)))
        self.pool_conv = nn.Conv2d(in_ch, out_ch, 1, bias=False)
        self.pool_bn = nn.BatchNorm2d(out_ch)
        self.project_conv = nn.Conv2d(out_ch * (2 + len(rates)), out_ch, 1,
                                      bias=False)
        self.project_bn = nn.BatchNorm2d(out_ch)

    def forward(self, x: torch.Tensor,
                new_state: Optional[list] = None) -> torch.Tensor:
        """``new_state``: train-mode BatchNorms, see
        :func:`models.mobilenet_v2._conv_bn`."""
        dt, ns = self.dtype, new_state
        outs = [F.relu(_conv_bn(x, c, bn, dt, ns))
                for c, bn in zip(self.branches, self.branch_bns)]
        g = x.float().mean(dim=(2, 3), keepdim=True).to(dt)
        g = F.relu(_conv_bn(g, self.pool_conv, self.pool_bn, dt, ns))
        outs.append(g.expand(-1, -1, x.shape[2], x.shape[3]))
        return F.relu(_conv_bn(torch.cat(outs, dim=1), self.project_conv,
                               self.project_bn, dt, ns))


class DeepLabV3(nn.Module):
    """MobileNet-v2 (output stride 16) + ASPP + bilinear upsample, NHWC
    in, float32 NHWC logits out."""

    # (expand, out_ch, repeats, stride, dilation)
    CFG = (
        (1, 16, 1, 1, 1),
        (6, 24, 2, 2, 1),
        (6, 32, 3, 2, 1),
        (6, 64, 4, 2, 1),
        (6, 96, 3, 1, 1),
        (6, 160, 3, 1, 2),  # stride-2 → dilated: keeps output stride at 16
        (6, 320, 1, 1, 2),
    )

    def __init__(self, num_classes: int = 21, width_mult: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_classes, self.width_mult, self.dtype = (
            num_classes, width_mult, dtype)
        ch = _make_divisible(32 * width_mult)
        self.stem_conv = nn.Conv2d(3, ch, 3, stride=2, bias=False)
        self.stem_bn = nn.BatchNorm2d(ch)
        blocks = []
        for expand, c, n, s, d in self.CFG:
            out_ch = _make_divisible(c * width_mult)
            for i in range(n):
                blocks.append(InvertedResidual(ch, out_ch, s if i == 0 else 1,
                                               expand, dilation=d,
                                               dtype=dtype))
                ch = out_ch
        self.blocks = nn.ModuleList(blocks)
        self.aspp = ASPP(ch, dtype=dtype)
        self.classifier = nn.Conv2d(256, num_classes, 1)

    def forward(self, x: torch.Tensor,
                new_state: Optional[list] = None) -> torch.Tensor:
        """NHWC float frames → float32 (B, H, W, classes) logits (the
        unfused forward; with ``new_state`` the train forward)."""
        dt, ns = self.dtype, new_state
        in_hw = (x.shape[1], x.shape[2])
        y = _relu6(_conv_bn(x.permute(0, 3, 1, 2), self.stem_conv,
                            self.stem_bn, dt, ns))
        for blk in self.blocks:
            y = blk.forward_nchw(y, ns)
        y = _conv(self.aspp(y, ns), self.classifier, torch.float32)
        return _resize(y.permute(0, 2, 3, 1), in_hw)


def _resize(y: torch.Tensor, hw) -> torch.Tensor:
    """Bilinear resize of float32 NHWC logits to ``hw`` (half-pixel
    centres, no antialias), as ``jax.image.resize(..., "bilinear")``
    upsamples."""
    o = F.interpolate(y.permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear",
                      align_corners=False)
    return o.permute(0, 2, 3, 1).contiguous()


def init_weights(model: DeepLabV3, seed: int) -> None:
    init_conv_bn(model, seed)


def _make_fused_apply(model: DeepLabV3, mode: str = "kernel",
                      compute_dtype: torch.dtype = None):
    """BN-folded forward, the counterpart of the JAX ``_make_fused_apply``:
    every BatchNorm folds into its conv, the backbone blocks go where
    :func:`models.mobilenet_v2.fold_blocks` routes them for ``mode``
    ('kernel', 'xla' or 'plain'; dilated blocks to the convolutions), the
    ASPP's five conv+BN pairs fold too, and the class conv (biased,
    float32) and the resize run as the module runs them. It folds again
    at the first call after a trainer changed the weights
    (:func:`models.refolding`)."""
    return refolding(model,
                     lambda: (_fold(model, mode, compute_dtype), None))


def _fold(model: DeepLabV3, mode: str, compute_dtype):
    from nnstreamer_tpu_torch.ops.fused_block import fold_conv_bn_apply

    cd = compute_dtype or model.dtype
    dev = model.stem_conv.weight.device
    a = model.aspp

    def conv(c, bn=None, act="relu", dtype=cd):
        return fold_conv_bn_apply(c, bn, act=act, compute_dtype=dtype,
                                  device=dev)

    with torch.no_grad():
        stem = conv(model.stem_conv, model.stem_bn, act="relu6")
        blocks = fold_blocks(model.blocks, mode, cd, dev)
        branches = [conv(c, bn) for c, bn in zip(a.branches, a.branch_bns)]
        pool = conv(a.pool_conv, a.pool_bn)
        project = conv(a.project_conv, a.project_bn)
        classifier = conv(model.classifier, act=None, dtype=torch.float32)

    def forward(x: torch.Tensor) -> torch.Tensor:
        in_hw = (x.shape[1], x.shape[2])
        y = run_blocks(stem(x).contiguous(), blocks, cd)
        outs = [b(y) for b in branches]
        g = pool(y.float().mean(dim=(1, 2), keepdim=True).to(cd))
        outs.append(g.expand(-1, y.shape[1], y.shape[2], -1))
        y = project(torch.cat(outs, dim=-1))
        return _resize(classifier(y), in_hw)

    return torch.no_grad()(forward)


def build(custom: Dict[str, str], device: torch.device) -> ModelBundle:
    size = int(custom.get("size", 257))
    width = float(custom.get("width", 1.0))
    classes = int(custom.get("classes", 21))
    model = DeepLabV3(num_classes=classes, width_mult=width)
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

    def infer_output(info: TensorsInfo) -> TensorsInfo:
        h, w = info.tensors[0].np_shape()[-3:-1]
        return TensorsInfo(tensors=[TensorInfo.from_np_shape(
            (batch_of(info), h, w, classes), "float32")])

    return ModelBundle(
        apply_fn=apply_fn, module=model,
        input_info=TensorsInfo.from_strings(f"3:{size}:{size}:1", "uint8"),
        output_info=TensorsInfo.from_strings(f"{classes}:{size}:{size}:1",
                                             "float32"),
        infer_output=infer_output, train_apply_fn=train_apply_fn)


register_model("deeplab_v3")(build)
register_model("deeplabv3")(build)
