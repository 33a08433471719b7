"""YOLOv8 detection (counterpart of the JAX package's ``models/yolov8.py``;
the reference decodes it in box_properties/yolo.cc, mode ``yolov8``).

CSP-style backbone, PAN neck and anchor-free decoupled heads at strides
8/16/32, as ``nn.Module``s (NCHW inside, NHWC frames in). The box decode
(grid offsets, stride scaling) runs on the device after the heads, so the
filter emits ready-to-threshold rows.

Output (yolo.cc v8): one float32 tensor, numpy (B, cells, 4 + nc) — cells
= (s/8)² + (s/16)² + (s/32)², rows cx, cy, w, h in pixels (decoder
option3=1, scaled output) then nc class scores, already sigmoided.

It reaches no kernel but the uint8 preamble's ``normalize_u8``: the JAX
package runs it outside any Pallas kernel. ``postproc:pp`` adds the
device-side top-k + NMS of ``ops/detection.py``. The train forward (the
bundle's ``train_apply_fn``, also a ``pp`` bundle's, as in the JAX
package) takes every ``ConvBNSiLU``'s BatchNorm by the batch's
statistics (:func:`models.batch_norm_train`) and returns the rows.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from nnstreamer_tpu_torch.models import (
    ModelBundle,
    batch_of,
    init_conv_bn,
    load_or_init,
    preprocess_frames,
    register_model,
)
from nnstreamer_tpu_torch.models.mobilenet_v2 import _conv, _conv_bn
from nnstreamer_tpu_torch.models.ssd_mobilenet import (
    _pp_info,
    init_heads,
    pp_options,
)
from nnstreamer_tpu_torch.types import TensorInfo, TensorsInfo


class ConvBNSiLU(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride,
                              bias=False)
        self.bn = nn.BatchNorm2d(out_ch)

    def forward(self, x: torch.Tensor,
                new_state: Optional[list] = None) -> torch.Tensor:
        """``new_state``: train-mode BatchNorm, see
        :func:`models.mobilenet_v2._conv_bn`."""
        return F.silu(_conv_bn(x, self.conv, self.bn, self.dtype, new_state))


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, shortcut: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cv1 = ConvBNSiLU(in_ch, out_ch, 3, dtype=dtype)
        self.cv2 = ConvBNSiLU(out_ch, out_ch, 3, dtype=dtype)
        self.residual = shortcut and in_ch == out_ch

    def forward(self, x: torch.Tensor,
                new_state: Optional[list] = None) -> torch.Tensor:
        y = self.cv2(self.cv1(x, new_state), new_state)
        return y + x if self.residual else y


class C2f(nn.Module):
    """YOLOv8's cross-stage partial block: split, n bottlenecks, concat."""

    def __init__(self, in_ch: int, out_ch: int, n: int = 1,
                 shortcut: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        half = out_ch // 2
        self.cv1 = ConvBNSiLU(in_ch, out_ch, 1, dtype=dtype)
        self.m = nn.ModuleList(Bottleneck(half, half, shortcut, dtype)
                               for _ in range(n))
        self.cv2 = ConvBNSiLU((2 + n) * half, out_ch, 1, dtype=dtype)

    def forward(self, x: torch.Tensor,
                new_state: Optional[list] = None) -> torch.Tensor:
        outs = list(torch.chunk(self.cv1(x, new_state), 2, dim=1))
        b = outs[-1]
        for m in self.m:
            b = m(b, new_state)
            outs.append(b)
        return self.cv2(torch.cat(outs, dim=1), new_state)


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): three chained 5x5 max-pools."""

    def __init__(self, in_ch: int, out_ch: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        half = out_ch // 2
        self.cv1 = ConvBNSiLU(in_ch, half, 1, dtype=dtype)
        self.cv2 = ConvBNSiLU(4 * half, out_ch, 1, dtype=dtype)

    def forward(self, x: torch.Tensor,
                new_state: Optional[list] = None) -> torch.Tensor:
        outs = [self.cv1(x, new_state)]
        for _ in range(3):  # SAME: padded with -inf, as flax's max_pool
            outs.append(F.max_pool2d(outs[-1], 5, stride=1, padding=2))
        return self.cv2(torch.cat(outs, dim=1), new_state)


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsampling (NCHW): output pixel i reads input i // 2, as
    ``jax.image.resize(..., "nearest")`` does at an exact 2x."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class YoloV8(nn.Module):
    """Scaled-down ('n'-ish) YOLOv8: CSP backbone, PAN neck, anchor-free
    heads. ``depth``/``width`` scale block counts and channels. ``convs``
    and ``c2fs`` hold the ConvBNSiLU and C2f layers in the order the flax
    module creates them."""

    STRIDES = (8, 16, 32)

    def __init__(self, num_classes: int = 80, width: float = 0.25,
                 depth: float = 0.34, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_classes, self.dtype = num_classes, dtype
        w = lambda c: max(16, int(c * width) // 8 * 8)  # noqa: E731
        d = lambda n: max(1, round(n * depth))  # noqa: E731
        c64, c128, c256, c512, c1024 = (w(c) for c in (64, 128, 256, 512,
                                                       1024))
        cbs = lambda i, o: ConvBNSiLU(i, o, 3, 2, dtype)  # noqa: E731
        self.convs = nn.ModuleList([
            cbs(3, c64), cbs(c64, c128), cbs(c128, c256), cbs(c256, c512),
            cbs(c512, c1024), cbs(c256, c256), cbs(c512, c512)])
        self.c2fs = nn.ModuleList([
            C2f(c128, c128, d(3), dtype=dtype),
            C2f(c256, c256, d(6), dtype=dtype),                  # p3
            C2f(c512, c512, d(6), dtype=dtype),                  # p4
            C2f(c1024, c1024, d(3), dtype=dtype),
            C2f(c1024 + c512, c512, d(3), False, dtype),         # t4
            C2f(c512 + c256, c256, d(3), False, dtype),          # t3
            C2f(c256 + c512, c512, d(3), False, dtype),          # b4
            C2f(c512 + c1024, c1024, d(3), False, dtype)])       # b5
        self.sppf = SPPF(c1024, c1024, dtype)
        feats = (c256, c512, c1024)
        self.box_heads = nn.ModuleList(nn.Conv2d(c, 4, 1) for c in feats)
        self.cls_heads = nn.ModuleList(nn.Conv2d(c, num_classes, 1)
                                       for c in feats)

    def forward(self, x: torch.Tensor,
                new_state: Optional[list] = None) -> torch.Tensor:
        """NHWC float frames → float32 (B, cells, 4 + nc) rows (with
        ``new_state`` the train forward)."""
        ns = new_state

        def cv(i, y):
            return self.convs[i](y, ns)

        def c2(i, y):
            return self.c2fs[i](y, ns)

        y = cv(1, cv(0, x.permute(0, 3, 1, 2).to(self.dtype)))
        y = c2(0, y)
        p3 = c2(1, cv(2, y))
        p4 = c2(2, cv(3, p3))
        p5 = self.sppf(c2(3, cv(4, p4)), ns)
        # PAN neck: top-down then bottom-up
        t4 = c2(4, torch.cat([_upsample2(p5), p4], dim=1))
        t3 = c2(5, torch.cat([_upsample2(t4), p3], dim=1))
        b4 = c2(6, torch.cat([cv(5, t3), t4], dim=1))
        b5 = c2(7, torch.cat([cv(6, b4), p5], dim=1))
        rows = []
        for feat, stride, bh, ch in zip((t3, b4, b5), self.STRIDES,
                                        self.box_heads, self.cls_heads):
            box = _conv(feat, bh, torch.float32).permute(0, 2, 3, 1)
            cls = _conv(feat, ch, torch.float32).permute(0, 2, 3, 1)
            b, gh, gw, _ = box.shape
            gy, gx = torch.meshgrid(
                torch.arange(gh, dtype=torch.float32, device=box.device),
                torch.arange(gw, dtype=torch.float32, device=box.device),
                indexing="ij")
            # anchor-free decode: centre offset in the cell + size, in
            # pixels
            cx = (torch.sigmoid(box[..., 0]) + gx) * stride
            cy = (torch.sigmoid(box[..., 1]) + gy) * stride
            bw = torch.exp(box[..., 2].clamp(-10.0, 8.0)) * stride
            bh_ = torch.exp(box[..., 3].clamp(-10.0, 8.0)) * stride
            row = torch.cat([torch.stack([cx, cy, bw, bh_], dim=-1),
                             torch.sigmoid(cls)], dim=-1)
            rows.append(row.reshape(b, gh * gw, 4 + self.num_classes))
        return torch.cat(rows, dim=1)


def num_cells(size: int) -> int:
    return (size // 8) ** 2 + (size // 16) ** 2 + (size // 32) ** 2


#: class-head weights' std: this net's SiLU features are small (about 1
#: over the square root of their width), so std 1 gives the class logits
#: a spread of about 1, as SSD's 0.006 does its relu6 features
_HEAD_STD = 1.0


def init_weights(model: YoloV8, seed: int) -> None:
    """:func:`models.init_conv_bn`, then the detection heads as SSD's
    (:func:`models.ssd_mobilenet.init_heads`), the box heads' weights
    scaled to flax's default (lecun-normal) std, 1 over the square root
    of their fan-in: the train forward's batch-normalised features are
    about 1, so at std 1 the box logits would spread about that square
    root and the rows' exp(clamp(logit, -10, 8)) sizes would reach the
    clamp, which the JAX package's seed init does not do."""
    init_conv_bn(model, seed)
    init_heads(model.box_heads, model.cls_heads, seed + 1, _HEAD_STD)
    with torch.no_grad():
        for h in model.box_heads:
            h.weight.mul_(h.weight[0].numel() ** -0.5)


def build(custom: Dict[str, str], device: torch.device) -> ModelBundle:
    size = int(custom.get("size", 320))
    if size % 32 != 0:
        raise ValueError(
            f"yolov8 input size must be a multiple of 32 (the stride-32 PAN "
            f"neck requires aligned grids), got {size}")
    classes = int(custom.get("classes", 80))
    width = float(custom.get("width", 0.25))
    depth = float(custom.get("depth", 0.34))
    model = YoloV8(num_classes=classes, width=width, depth=depth)
    load_or_init(model, custom, init_weights)
    model = model.to(device).eval()

    @torch.no_grad()
    def apply_fn(x):
        return model(preprocess_frames(x, "unit", model.dtype))

    def train_apply_fn(x):
        new_state = []
        out = model(preprocess_frames(x, "unit", model.dtype), new_state)
        return out, new_state

    in_info = TensorsInfo.from_strings(f"3:{size}:{size}:1", "uint8")

    if custom.get("postproc") == "pp":
        # the detection post-process (top-k + NMS) on the device, emitting
        # the pp SSD models' quad for the mobilenet-ssd-postprocess mode
        from nnstreamer_tpu_torch.ops.detection import detection_postprocess

        k, iou, thr = pp_options(custom)

        @torch.no_grad()
        def pp_apply(x):
            rows = apply_fn(x)  # (B, cells, 4+nc): cx,cy,w,h px + scores
            cx, cy, w, h = rows[..., :4].unbind(-1)
            xyxy = torch.stack(
                [(cy - h / 2) / size, (cx - w / 2) / size,
                 (cy + h / 2) / size, (cx + w / 2) / size], dim=-1)
            cls_scores = rows[..., 4:]
            return detection_postprocess(
                xyxy, torch.amax(cls_scores, dim=-1),
                torch.argmax(cls_scores, dim=-1), k=k, iou_thr=iou,
                score_thr=thr)

        return ModelBundle(
            apply_fn=pp_apply, module=model, input_info=in_info,
            output_info=TensorsInfo.from_strings(
                f"4:{k}:1.{k}:1.{k}:1.1:1", "float32.float32.float32.float32"),
            infer_output=lambda info: _pp_info(batch_of(info), k),
            train_apply_fn=train_apply_fn)

    def infer_output(info: TensorsInfo) -> TensorsInfo:
        cells = num_cells(info.tensors[0].np_shape()[-3])
        return TensorsInfo(tensors=[TensorInfo.from_np_shape(
            (batch_of(info), cells, 4 + classes), "float32")])

    return ModelBundle(
        apply_fn=apply_fn, module=model, input_info=in_info,
        output_info=TensorsInfo.from_strings(
            f"{4 + classes}:{num_cells(size)}:1", "float32"),
        infer_output=infer_output, train_apply_fn=train_apply_fn)


register_model("yolov8")(build)
