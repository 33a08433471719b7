"""MobileNet-v2 — the flagship classification model (counterpart of the
JAX package's ``models/mobilenet_v2.py``; the reference's image-labeling
example runs mobilenet_v2_1.0_224.tflite).

``nn.Module``s with the JAX package's public layout: NHWC in, logits out,
the same ``CFG``, channel rounding and ``size``/``width``/``classes``
customs and caps (``3:{size}:{size}:1`` uint8 in, ``{classes}:1`` float32
out). Convolutions use TF/XLA 'SAME' padding, as flax does.

Three forwards:
  - the module's own (unfused): conv + BatchNorm + relu6 layers, as the
    flax module computes them;
  - the train forward (the bundle's ``train_apply_fn``, the flax module
    with ``train=True``): the same layers with each BatchNorm normalizing
    by the batch's statistics (:func:`models.batch_norm_train`), the
    running statistics' EMA returned beside the logits;
  - :func:`_make_fused_apply`: BatchNorm folded (again whenever a trainer
    changed the weights since the last fold), the 13 stride-1
    inverted-residual blocks through the fused-block kernel on CUDA
    (``fused:pallas``; its plain version on the CPU) or every block through
    three convolutions (``fused:xla``, as the JAX package's ``fused:xla``
    runs ``inverted_residual_xla``); the stem, the 4 stride-2 blocks, the
    head 1x1 conv, the pool and the Dense layer are torch ops, as the JAX
    package computes them with XLA outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nnstreamer_tpu_torch.models import (
    FoldedState,
    ModelBundle,
    batch_norm_train,
    load_or_init,
    preprocess_frames,
    register_model,
    resolve_fused_apply,
    weights_version,
)
from nnstreamer_tpu_torch.types import TensorInfo, TensorsInfo


def _make_divisible(v: float, divisor: int = 8) -> int:
    """Round channel counts the way the reference architecture does, keeping
    them multiples of 8."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def _same_pad_nchw(x: torch.Tensor, k: int, stride: int,
                   dilation: int = 1) -> torch.Tensor:
    """Pad an NCHW tensor for a TF/XLA 'SAME' conv (extra on the high
    side, as flax pads)."""
    k_eff = (k - 1) * dilation + 1
    pads = []
    for size in (x.shape[3], x.shape[2]):  # F.pad order: W, then H
        out = -(-size // stride)
        total = max((out - 1) * stride + k_eff - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


def _conv(x: torch.Tensor, conv: nn.Conv2d,
          dtype: torch.dtype) -> torch.Tensor:
    """NCHW conv ('SAME') in ``dtype``, plus its bias in ``dtype`` when it
    has one (as flax adds a Conv's bias in the layer's dtype)."""
    k, s, d = conv.kernel_size[0], conv.stride[0], conv.dilation[0]
    y = F.conv2d(_same_pad_nchw(x.to(dtype), k, s, d), conv.weight.to(dtype),
                 stride=s, dilation=d, groups=conv.groups)
    if conv.bias is not None:
        y = y + conv.bias.to(dtype).reshape(1, -1, 1, 1)
    return y


def _conv_bn(x: torch.Tensor, conv: nn.Conv2d, bn: nn.BatchNorm2d,
             dtype: torch.dtype, new_state: Optional[list] = None
             ) -> torch.Tensor:
    """NCHW conv ('SAME') then BatchNorm, in ``dtype``: inference
    BatchNorm, or with ``new_state`` (a list) the train-mode BatchNorm,
    which appends its running statistics' update there."""
    y = _conv(x, conv, dtype)
    if new_state is not None:
        return batch_norm_train(y, bn, dtype, new_state)
    y = F.batch_norm(y.float(), bn.running_mean, bn.running_var, bn.weight,
                     bn.bias, training=False, eps=bn.eps)
    return y.to(dtype)


def _relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 6.0)


class InvertedResidual(nn.Module):
    """MobileNet-v2 inverted residual block (expand → depthwise → project).
    NHWC in and out. ``dilation`` > 1 dilates the depthwise conv."""

    def __init__(self, in_ch: int, out_ch: int, stride: int, expand: int,
                 dilation: int = 1, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        hidden = in_ch * expand
        self.stride, self.dilation, self.dtype = stride, dilation, dtype
        self.expand_conv = (nn.Conv2d(in_ch, hidden, 1, bias=False)
                            if expand != 1 else None)
        self.expand_bn = nn.BatchNorm2d(hidden) if expand != 1 else None
        self.dw_conv = nn.Conv2d(hidden, hidden, 3, stride=stride,
                                 dilation=dilation, groups=hidden, bias=False)
        self.dw_bn = nn.BatchNorm2d(hidden)
        self.proj_conv = nn.Conv2d(hidden, out_ch, 1, bias=False)
        self.proj_bn = nn.BatchNorm2d(out_ch)
        self.use_residual = stride == 1 and in_ch == out_ch

    def forward_nchw(self, x: torch.Tensor,
                     new_state: Optional[list] = None) -> torch.Tensor:
        """``new_state``: train-mode BatchNorms, see :func:`_conv_bn`."""
        dt, ns = self.dtype, new_state
        h = x
        if self.expand_conv is not None:
            h = _relu6(_conv_bn(h, self.expand_conv, self.expand_bn, dt, ns))
        h = _relu6(_conv_bn(h, self.dw_conv, self.dw_bn, dt, ns))
        h = _conv_bn(h, self.proj_conv, self.proj_bn, dt, ns)
        if self.use_residual:
            h = h + x.to(dt)
        return h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.forward_nchw(x.permute(0, 3, 1, 2))
        return y.permute(0, 2, 3, 1)


class MobileNetV2(nn.Module):
    """width_mult-scalable MobileNet-v2, NHWC, 1001 classes (tflite zoo
    convention: background + 1000 imagenet)."""

    # (expand, out_ch, repeats, stride)
    CFG: Sequence[Tuple[int, int, int, int]] = (
        (1, 16, 1, 1),
        (6, 24, 2, 2),
        (6, 32, 3, 2),
        (6, 64, 4, 2),
        (6, 96, 3, 1),
        (6, 160, 3, 2),
        (6, 320, 1, 1),
    )

    def __init__(self, num_classes: int = 1001, width_mult: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_classes, self.width_mult, self.dtype = (
            num_classes, width_mult, dtype)
        ch = _make_divisible(32 * width_mult)
        self.stem_conv = nn.Conv2d(3, ch, 3, stride=2, bias=False)
        self.stem_bn = nn.BatchNorm2d(ch)
        blocks = []
        for expand, c, n, s in self.CFG:
            out_ch = _make_divisible(c * width_mult)
            for i in range(n):
                blocks.append(InvertedResidual(ch, out_ch, s if i == 0 else 1,
                                               expand, dtype=dtype))
                ch = out_ch
        self.blocks = nn.ModuleList(blocks)
        last = _make_divisible(1280 * max(1.0, width_mult))
        self.head_conv = nn.Conv2d(ch, last, 1, bias=False)
        self.head_bn = nn.BatchNorm2d(last)
        self.classifier = nn.Linear(last, num_classes)

    def forward(self, x: torch.Tensor,
                new_state: Optional[list] = None) -> torch.Tensor:
        """NHWC float frames → float32 logits (the unfused forward; with
        ``new_state`` the train forward, see :func:`_conv_bn`). The pool
        averages in float32 and rounds to the compute dtype, as
        ``jnp.mean`` of a bfloat16 tensor does; the classifier runs in its
        weights' dtype (float32 as built)."""
        dt, ns = self.dtype, new_state
        y = _relu6(_conv_bn(x.permute(0, 3, 1, 2), self.stem_conv,
                            self.stem_bn, dt, ns))
        for blk in self.blocks:
            y = blk.forward_nchw(y, ns)
        y = _relu6(_conv_bn(y, self.head_conv, self.head_bn, dt, ns))
        y = y.float().mean(dim=(2, 3)).to(dt)  # global average pool
        y = y.to(self.classifier.weight.dtype)
        return self.classifier(y)


def init_weights(model: nn.Module, seed: int) -> None:
    """Deterministic weights from ``np.random.default_rng(seed)``: He-normal
    convs, BatchNorm scale/bias and running statistics that are not the
    identity, a small random classifier with zero-mean rows.

    This does NOT reproduce the JAX package's ``seed:`` weights: flax's
    initializers and ``jax.random`` make those, and this package cannot
    run them. To run both packages on the same weights, carry the flax variables
    across with :func:`models.convert.from_jax_variables` and load them
    with ``custom=params:<file>.npz``."""
    rng = np.random.default_rng(seed)
    state = model.state_dict()
    new = {}
    for name, t in state.items():
        shape = tuple(t.shape)
        if name.endswith("num_batches_tracked"):
            new[name] = t
            continue
        if "conv" in name:  # conv weight, OIHW
            fan_in = int(np.prod(shape[1:]))
            a = rng.normal(0.0, np.sqrt(2.0 / fan_in), shape)
        elif name.endswith("running_var"):
            a = rng.uniform(0.8, 1.2, shape)
        elif name.endswith("running_mean"):
            a = rng.normal(0.0, 0.1, shape)
        elif "bn" in name and name.endswith("weight"):
            a = rng.uniform(0.8, 1.2, shape)
        elif name.endswith("bias"):
            a = rng.normal(0.0, 0.1, shape)
        else:  # classifier weight [out, in], rows centered: the pooled
            # relu6 features are all positive, and an uncentered row's sum
            # would decide the class for every frame alike
            a = rng.normal(0.0, 1.0 / np.sqrt(shape[1]), shape)
            a -= a.mean(axis=1, keepdims=True)
        new[name] = torch.from_numpy(a.astype(np.float32))
    model.load_state_dict(new)


def fold_blocks(blocks, mode: str, compute_dtype: torch.dtype, device):
    """Fold each :class:`InvertedResidual` once, for the BN-folded forwards
    of the models built on these blocks (MobileNet-v2, SSD, DeepLab).
    Returns (function, folded, stride, dilation) per block, the folded
    weights cast once on ``device``. ``mode``:
      - 'kernel' (``fused:pallas``): :func:`inverted_residual_auto` (the
        stride-1 blocks to :func:`fused_inverted_residual`, the kernel on
        CUDA and its plain version on the CPU; stride-2 blocks to
        :func:`inverted_residual_conv`), dilated blocks to
        :func:`inverted_residual_conv` directly, as the JAX DeepLab sends
        them to ``inverted_residual_xla``;
      - 'xla' (``fused:xla``): every block through
        :func:`inverted_residual_conv`;
      - 'plain': the 'kernel' forward with the kernel's plain version in
        its place (the blocks the kernel would run through
        :func:`inverted_residual_plain`, the others as in 'kernel'): the
        whole-model oracle on the card, which differs from 'kernel' only
        where the kernel runs.
    The kernel reads float32 biases; the convolutions add theirs in the
    compute dtype, so each block's biases are cast for its route."""
    from nnstreamer_tpu_torch.ops import fused_block as fb

    if mode not in ("kernel", "xla", "plain"):
        raise ValueError(f"unknown fused forward mode {mode!r}")
    cd = compute_dtype
    out = []
    for blk in blocks:
        kernel = fb.fused_block_eligible(blk.stride, blk.dilation)
        if mode == "xla" or not kernel:
            fn, bias_dtype = fb.inverted_residual_conv, cd
            if mode == "kernel" and blk.dilation == 1:
                fn = fb.inverted_residual_auto
        elif mode == "plain":
            fn, bias_dtype = fb.inverted_residual_plain, torch.float32
        else:
            fn, bias_dtype = fb.inverted_residual_auto, torch.float32
        fw = fb.cast_folded(fb.fold_inverted_residual(blk), cd, device,
                            bias_dtype)
        out.append((fn, fw, blk.stride, blk.dilation))
    return out


def kernel_block_shapes(model, size: int):
    """(index, H, W, Cin, Ch, Cout) of each block of ``model.blocks`` that
    :func:`fold_blocks` sends to the fused-block kernel, for square
    ``size`` input behind the stride-2 stem: the shapes the main path
    gives the kernel."""
    from nnstreamer_tpu_torch.ops.fused_block import fused_block_eligible

    out, hw = [], -(-size // 2)
    for i, blk in enumerate(model.blocks):
        if fused_block_eligible(blk.stride, blk.dilation):
            cin = blk.dw_conv.in_channels if blk.expand_conv is None \
                else blk.expand_conv.in_channels
            out.append((i, hw, hw, cin, blk.dw_conv.out_channels,
                        blk.proj_conv.out_channels))
        hw = -(-hw // blk.stride)
    return out


def run_blocks(y: torch.Tensor, blocks, compute_dtype: torch.dtype
               ) -> torch.Tensor:
    """Run :func:`fold_blocks`' blocks on an NHWC tensor."""
    for fn, fw, stride, dilation in blocks:
        y = fn(y, fw, stride=stride, dilation=dilation,
               compute_dtype=compute_dtype)
    return y


#: the block functions a folded state's recipe names (:func:`fold_state`)
_BLOCK_ROUTES = ("inverted_residual_auto", "inverted_residual_conv",
                 "inverted_residual_plain")


def fold_state(model: MobileNetV2, mode: str, compute_dtype: torch.dtype,
               device):
    """The BN-folded forward's state: (flat tensors, JSON recipe). The
    tensors are folded and cast once, on ``device``, as :func:`fold_blocks`
    and :func:`fused_block.fold_conv_bn_weights` do; the recipe holds what
    :func:`folded_forward` needs besides them (each block's route, stride
    and dilation, the stem's geometry, the compute dtype)."""
    from nnstreamer_tpu_torch.ops import fused_block as fb

    cd = compute_dtype
    flat: Dict[str, torch.Tensor] = {}
    with torch.no_grad():
        flat["stem.w"], flat["stem.b"] = fb.fold_conv_bn_weights(
            model.stem_conv, model.stem_bn, compute_dtype=cd, device=device)
        recipe = {"kind": "mobilenet_v2", "mode": mode,
                  "compute_dtype": str(cd).replace("torch.", ""),
                  "stem": fb.conv_geometry(model.stem_conv), "blocks": []}
        for i, (fn, fw, stride, dilation) in enumerate(
                fold_blocks(model.blocks, mode, cd, device)):
            route = next(r for r in _BLOCK_ROUTES if getattr(fb, r) is fn)
            recipe["blocks"].append({"route": route, "stride": stride,
                                     "dilation": dilation})
            for k, v in fw.items():
                flat[f"blocks.{i}.{k}"] = v
        k, b = fb.fold_conv_bn(model.head_conv, model.head_bn)
        head = fb.cast_folded({"w": k[:, :, 0, 0].t(), "b": b}, cd, device)
        flat["head.w"], flat["head.b"] = head["w"], head["b"]
        flat["dense_w"] = (model.classifier.weight.detach().float().t()
                           .contiguous())
        flat["dense_b"] = model.classifier.bias.detach().float().clone()
    return flat, recipe


def folded_forward(flat: Dict[str, torch.Tensor], recipe: dict):
    """The BN-folded forward over a folded state (:func:`fold_state`):
    NHWC compute-dtype frames → float32 logits. Folds nothing."""
    from nnstreamer_tpu_torch.ops import fused_block as fb

    cd = getattr(torch, recipe["compute_dtype"])
    stem = fb.conv_apply(flat["stem.w"], flat["stem.b"], **recipe["stem"],
                         compute_dtype=cd)
    blocks = []
    for i, blk in enumerate(recipe["blocks"]):
        if blk["route"] not in _BLOCK_ROUTES:
            raise ValueError(f"unknown block route {blk['route']!r}")
        pre = f"blocks.{i}."
        fw = {k[len(pre):]: v for k, v in flat.items() if k.startswith(pre)}
        blocks.append((getattr(fb, blk["route"]), fw, blk["stride"],
                       blk["dilation"]))
    head_w, head_b = flat["head.w"], flat["head.b"]
    dense_w, dense_b = flat["dense_w"], flat["dense_b"]

    def forward(x: torch.Tensor) -> torch.Tensor:
        y = stem(x).contiguous()  # NHWC for the blocks
        y = run_blocks(y, blocks, cd)
        B, H, W, C = y.shape
        o = y.reshape(-1, C) @ head_w + head_b.to(cd)
        o = _relu6(o).reshape(B, H * W, -1)
        pooled = o.float().mean(dim=1).to(cd).float()
        return pooled @ dense_w + dense_b

    return torch.no_grad()(forward)


def _make_fused_apply(model: MobileNetV2, mode: str = "kernel",
                      compute_dtype: torch.dtype = None):
    """BN-folded forward, the counterpart of the JAX ``_make_fused_apply``:
    the blocks as :func:`fold_blocks` routes them for ``mode`` ('kernel',
    'xla' or 'plain'); the stem, the head 1x1 conv, the pool and the Dense
    layer are torch ops, as the JAX package computes them with XLA outside
    any Pallas kernel. Folding and the casts to the compute dtype happen
    here (:func:`fold_state`), on the model's device, and again at the
    first call after a trainer changed the weights
    (:func:`models.weights_version`): the JAX package folds inside the
    jitted forward from the variables it is given, so its folded forward
    always runs the current weights. A model nobody trains folds once.
    ``forward.folded()`` gives the current folded state and recipe."""
    cd = compute_dtype or model.dtype
    dev = model.stem_conv.weight.device
    f = {}

    def fold() -> None:
        flat, recipe = fold_state(model, mode, cd, dev)
        f.update(version=weights_version(model), flat=flat, recipe=recipe,
                 fwd=folded_forward(flat, recipe))

    fold()

    def forward(x: torch.Tensor) -> torch.Tensor:
        if f["version"] != weights_version(model):
            fold()
        return f["fwd"](x)

    def folded():
        if f["version"] != weights_version(model):
            fold()
        return f["flat"], f["recipe"]

    forward.folded = folded
    return forward


def infer_output(in_info: TensorsInfo, classes: int) -> TensorsInfo:
    """[B, H, W, 3] (or [H, W, 3]) frames → [B, classes] float32 logits."""
    shape = in_info.tensors[0].np_shape()
    batch = shape[0] if len(shape) == 4 else 1
    return TensorsInfo(tensors=[
        TensorInfo.from_np_shape((batch, classes), "float32")])


def build(custom: Dict[str, str], device: torch.device) -> ModelBundle:
    size = int(custom.get("size", 224))
    width = float(custom.get("width", 1.0))
    classes = int(custom.get("classes", 1001))
    model = MobileNetV2(num_classes=classes, width_mult=width)
    load_or_init(model, custom, init_weights)
    model = model.to(device).eval()
    apply_fn = resolve_fused_apply(custom, model, _make_fused_apply)
    folded = getattr(apply_fn, "folded", None)
    if apply_fn is None:
        def apply_fn(x):
            with torch.no_grad():
                return model(preprocess_frames(x, "pm1", model.dtype))

    def train_apply_fn(x):
        new_state = []
        logits = model(preprocess_frames(x, "pm1", model.dtype), new_state)
        return logits, new_state

    return ModelBundle(
        apply_fn=apply_fn, module=model,
        input_info=TensorsInfo.from_strings(f"3:{size}:{size}:1", "uint8"),
        output_info=TensorsInfo.from_strings(f"{classes}:1", "float32"),
        infer_output=lambda info: infer_output(info, classes),
        train_apply_fn=train_apply_fn, folded=folded)


def restore(state: Dict[str, torch.Tensor], recipe: dict,
            custom: Dict[str, str], device: torch.device) -> ModelBundle:
    """The ``fused:`` bundle around a folded state (:func:`fold_state`)
    already on ``device``: the compile cache's load (filters/aot.py)."""
    size = int(custom.get("size", 224))
    classes = int(state["dense_b"].shape[0])
    fwd = folded_forward(state, recipe)
    cd = getattr(torch, recipe["compute_dtype"])

    def apply_fn(x):
        return fwd(preprocess_frames(x, "pm1", cd))

    return ModelBundle(
        apply_fn=apply_fn, module=FoldedState(state),
        input_info=TensorsInfo.from_strings(f"3:{size}:{size}:1", "uint8"),
        output_info=TensorsInfo.from_strings(f"{classes}:1", "float32"),
        infer_output=lambda info: infer_output(info, classes),
        folded=lambda: (state, recipe))


register_model("mobilenet_v2")(build)
