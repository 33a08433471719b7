"""Fused inverted-residual block (expand 1x1 → depthwise 3x3 → project 1x1)
— counterpart of the JAX package's ``ops/fused_block.py``.

The block's 6x-wide hidden tensor is what makes MobileNet-v2 memory-bound
when each conv runs on its own: it makes two round trips through device
memory between the expand, depthwise and project convs. The kernel in
``csrc/fused_block.cu`` keeps it in shared memory for the whole block.

BatchNorm is folded into conv weights and biases beforehand
(:func:`fold_conv_bn`, inference semantics, running statistics). The
folded dict has the JAX package's layout: ``w1`` [Cin, Ch] (absent when
expand == 1), ``wd`` [9, Ch] tap-major, ``w2`` [Ch, Cout], float32 biases
``b1``/``bd``/``b2``.

Three functions compute the block:
  - :func:`fused_inverted_residual`, the kernel's wrapper: a stride-1
    block on a CUDA tensor launches the kernel for every shape (it masks
    ragged tiles itself, so there is no counterpart of
    ``_tiling_valid``/``fused_block_eligible``); a CPU tensor runs the
    plain version; a stride-2 block goes to :func:`inverted_residual_conv`,
    as the JAX function sends it to ``inverted_residual_xla``;
  - :func:`inverted_residual_plain`, the kernel's plain version: the
    kernel's rounding points spelled out in PyTorch (the CPU tests' path
    and the kernel's oracle on the card);
  - :func:`inverted_residual_conv`, the counterpart of
    ``inverted_residual_xla``: three convolutions, as the JAX package runs
    the stride-2 blocks and ``fused:xla`` outside any Pallas kernel.

:func:`inverted_residual_auto` routes a block between the first and the
last (the counterpart of the JAX function of that name), and
:func:`fold_conv_bn_apply` is the one fold-then-conv helper of every
BN-folded forward (MobileNet-v2, SSD, DeepLab, PoseNet).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from nnstreamer_tpu_torch.ops import _cuda

#: float32 kernel: threads x accumulators per thread (csrc/fused_block.cu)
_MAX_OUTPUTS = 256 * 32
#: dynamic shared memory one CTA may use (the H100's 227 KB opt-in limit)
_SMEM_BUDGET = 227 * 1024
#: bfloat16 kernel: (FM, FN) 16x16 project fragments per warp along pixels
#: and output channels, one instantiation each; keep in step with
#: csrc/fused_block.cu kVariants
_TC_VARIANTS = ((2, 1), (2, 2), (1, 3), (1, 5), (1, 6))
_TC_WARPS = 16
#: hidden channels per chunk, in the order of preference (multiples of 16)
_TC_CHUNKS = (64, 48, 32, 16)
#: most output pixels in one bfloat16 work item
_TC_MAX_PIXELS = 512


def fold_conv_bn(conv: torch.nn.Conv2d, bn: torch.nn.BatchNorm2d
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold an inference BatchNorm into the preceding bias-free conv.

    Returns (kernel', bias') in float32 with ``conv(x, kernel') + bias' ==
    BN(conv(x, kernel))`` under running statistics; kernel' keeps the conv's
    OIHW layout. eps is the BatchNorm's (1e-5, as in the JAX package)."""
    mult = (bn.weight.detach().float()
            / torch.sqrt(bn.running_var.float() + bn.eps))
    k = conv.weight.detach().float() * mult.reshape(-1, 1, 1, 1)
    b = bn.bias.detach().float() - bn.running_mean.float() * mult
    return k, b


def fold_inverted_residual(block) -> Dict[str, torch.Tensor]:
    """Fold one :class:`models.mobilenet_v2.InvertedResidual`'s BatchNorms
    into the folded-weight dict :func:`fused_inverted_residual` and
    :func:`inverted_residual_plain` take."""
    fw: Dict[str, torch.Tensor] = {}
    if block.expand_conv is not None:
        k, b = fold_conv_bn(block.expand_conv, block.expand_bn)
        fw["w1"], fw["b1"] = k[:, :, 0, 0].t().contiguous(), b
    k, b = fold_conv_bn(block.dw_conv, block.dw_bn)
    fw["wd"], fw["bd"] = k[:, 0].reshape(k.shape[0], 9).t().contiguous(), b
    k, b = fold_conv_bn(block.proj_conv, block.proj_bn)
    fw["w2"], fw["b2"] = k[:, :, 0, 0].t().contiguous(), b
    return fw


def cast_folded(folded: Dict[str, Any], compute_dtype: torch.dtype,
                device=None, bias_dtype: torch.dtype = torch.float32
                ) -> Dict[str, torch.Tensor]:
    """Weights in the compute dtype, biases in ``bias_dtype``, all
    contiguous on ``device``. The defaults are the form the kernel reads;
    :func:`inverted_residual_conv` adds its biases in the compute dtype, so
    its blocks take ``bias_dtype=compute_dtype``. Done once, at model
    open."""
    out = {}
    for k, v in folded.items():
        dt = bias_dtype if k.startswith("b") else compute_dtype
        out[k] = v.to(device=device, dtype=dt).contiguous()
    return out


def _relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 6.0)


def _same_pads(size: int, stride: int, k_eff: int) -> Tuple[int, int]:
    """TF/XLA 'SAME' padding (extra pad on the high side)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k_eff - size, 0)
    return total // 2, total - total // 2


def inverted_residual_plain(x: torch.Tensor, folded: Dict[str, Any], *,
                            stride: int = 1, dilation: int = 1,
                            residual: Optional[bool] = None,
                            compute_dtype: torch.dtype = torch.bfloat16
                            ) -> torch.Tensor:
    """The block in plain PyTorch on NHWC tensors — the counterpart of
    ``inverted_residual_xla`` and the kernel's plain version.

    It rounds where the Pallas kernel (and the CUDA kernel) round: the
    1x1 products sum in float32 and round to the compute dtype after
    bias (+ relu6); each depthwise product is rounded to the compute dtype
    before the float32 tap sum; the residual add is in the compute dtype.
    In float32 every rounding is a no-op and this is the plain folded
    block."""
    cd = compute_dtype
    f32 = torch.float32
    B, H, W, Cin = x.shape
    w1 = folded.get("w1")
    wd, bd, w2, b2 = folded["wd"], folded["bd"], folded["w2"], folded["b2"]
    Ch, Cout = wd.shape[-1], w2.shape[-1]
    if residual is None:
        residual = stride == 1 and Cin == Cout
    xc = x.to(cd)
    h = xc
    if w1 is not None:
        h = _relu6(xc.reshape(-1, Cin).to(f32) @ w1.to(cd).to(f32)
                   + folded["b1"].to(f32)).to(cd).reshape(B, H, W, Ch)
    k_eff = 2 * dilation + 1
    pt, pb = _same_pads(H, stride, k_eff)
    pl, pr = _same_pads(W, stride, k_eff)
    hp = F.pad(h, (0, 0, pl, pr, pt, pb))  # post-activation zeros
    Ho, Wo = -(-H // stride), -(-W // stride)
    wdc = wd.to(cd).to(f32)
    acc = torch.zeros((B, Ho, Wo, Ch), dtype=f32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            r0, c0 = dy * dilation, dx * dilation
            tap = hp[:, r0:r0 + (Ho - 1) * stride + 1:stride,
                     c0:c0 + (Wo - 1) * stride + 1:stride, :]
            acc = acc + (tap.to(f32) * wdc[dy * 3 + dx]).to(cd).to(f32)
    d = _relu6(acc + bd.to(f32)).to(cd)
    o = (d.reshape(-1, Ch).to(f32) @ w2.to(cd).to(f32)
         + b2.to(f32)).to(cd).reshape(B, Ho, Wo, Cout)
    if residual:
        o = (o.to(f32) + xc.to(f32)).to(cd)
    return o


def inverted_residual_conv(x: torch.Tensor, folded: Dict[str, Any], *,
                           stride: int = 1, dilation: int = 1,
                           residual: Optional[bool] = None,
                           compute_dtype: torch.dtype = torch.bfloat16
                           ) -> torch.Tensor:
    """The block as three convolutions on NHWC tensors — the counterpart of
    the JAX package's ``inverted_residual_xla``, which runs outside any
    Pallas kernel (the stride-2 and dilated blocks, and ``fused:xla``).

    The NHWC tensors are viewed as channels-last NCHW (no copy) for
    ``F.conv2d``: the 1x1 convs and the depthwise conv (``groups=Ch``) with
    TF "SAME" padding (:func:`_same_pads`, the extra pad on the high side).
    It rounds where the JAX function rounds: each conv's output in the
    compute dtype, then ``+ b`` in the compute dtype as a separate add,
    relu6, and the residual add in the compute dtype."""
    cd = compute_dtype
    B, H, W, Cin = x.shape
    w1 = folded.get("w1")
    wd, bd, w2, b2 = folded["wd"], folded["bd"], folded["w2"], folded["b2"]
    Ch, Cout = wd.shape[-1], w2.shape[-1]
    if residual is None:
        residual = stride == 1 and Cin == Cout

    def bias(b):
        return b.to(cd).reshape(1, -1, 1, 1)

    xc = x.to(cd).permute(0, 3, 1, 2)  # NCHW view of the NHWC tensor
    h = xc
    if w1 is not None:
        h = _relu6(F.conv2d(h, w1.to(cd).t().reshape(Ch, Cin, 1, 1))
                   + bias(folded["b1"]))
    k_eff = 2 * dilation + 1
    pt, pb = _same_pads(H, stride, k_eff)
    pl, pr = _same_pads(W, stride, k_eff)
    if pt or pb or pl or pr:
        h = F.pad(h, (pl, pr, pt, pb))  # post-activation zeros
    d = F.conv2d(h, wd.to(cd).t().reshape(Ch, 1, 3, 3), stride=stride,
                 dilation=dilation, groups=Ch)
    d = _relu6(d + bias(bd))
    o = F.conv2d(d, w2.to(cd).t().reshape(Cout, Ch, 1, 1)) + bias(b2)
    if residual:
        o = o + xc
    return o.permute(0, 2, 3, 1)


def _activate(o: torch.Tensor, act) -> torch.Tensor:
    if callable(act):
        return act(o)
    if act == "relu6":
        return _relu6(o)
    if act == "relu":
        return F.relu(o)
    if act is None:
        return o
    raise ValueError(f"unknown activation {act!r}")


def fold_conv_bn_apply(conv: torch.nn.Conv2d,
                       bn: Optional[torch.nn.BatchNorm2d] = None, *,
                       act="relu6",
                       compute_dtype: torch.dtype = torch.bfloat16,
                       device=None):
    """Fold one conv+BN pair once and return its apply, ``v -> out`` on
    NHWC tensors: the TF "SAME" conv with the folded kernel (the conv's
    own stride, dilation and groups), the folded bias, then ``act``
    ('relu6' | 'relu' | None | a callable). ``bn=None`` applies the conv
    as it is, with its own bias if it has one (the detection heads and the
    class convs).

    The counterpart of the JAX package's ``fold_conv_bn_apply``, the one
    home of the fold-then-conv pattern of every BN-folded forward. It
    rounds where the JAX function rounds: the conv's output in the compute
    dtype, then ``+ b`` in the compute dtype as a separate add. The NHWC
    tensor is viewed as channels-last NCHW (no copy) for ``F.conv2d``."""
    w, bias = fold_conv_bn_weights(conv, bn, compute_dtype=compute_dtype,
                                   device=device)
    return conv_apply(w, bias, **conv_geometry(conv), act=act,
                      compute_dtype=compute_dtype)


def fold_conv_bn_weights(conv: torch.nn.Conv2d,
                         bn: Optional[torch.nn.BatchNorm2d] = None, *,
                         compute_dtype: torch.dtype = torch.bfloat16,
                         device=None):
    """The (kernel, bias) :func:`fold_conv_bn_apply` convolves with: the
    folded OIHW kernel in the compute dtype and the folded bias as
    [1, C, 1, 1] in the compute dtype (None for a bias-free conv without
    BatchNorm)."""
    cd = compute_dtype
    if bn is None:
        k = conv.weight.detach().float()
        b = None if conv.bias is None else conv.bias.detach().float()
    else:
        k, b = fold_conv_bn(conv, bn)
    w = k.to(device=device, dtype=cd).contiguous()
    bias = None if b is None else b.to(device=device, dtype=cd).reshape(
        1, -1, 1, 1)
    return w, bias


def conv_geometry(conv: torch.nn.Conv2d) -> Dict[str, int]:
    """The geometry :func:`conv_apply` needs besides the weights."""
    return {"ksize": conv.kernel_size[0], "stride": conv.stride[0],
            "dilation": conv.dilation[0], "groups": conv.groups}


def conv_apply(w: torch.Tensor, bias: Optional[torch.Tensor], *,
               ksize: int, stride: int, dilation: int, groups: int,
               act="relu6", compute_dtype: torch.dtype = torch.bfloat16):
    """The apply of :func:`fold_conv_bn_apply` around given folded weights
    (:func:`fold_conv_bn_weights`), for a forward rebuilt from a saved
    folded state (filters/aot.py)."""
    cd = compute_dtype
    k_eff = (ksize - 1) * dilation + 1

    def apply(v: torch.Tensor) -> torch.Tensor:
        x = v.to(cd).permute(0, 3, 1, 2)  # NCHW view of the NHWC tensor
        pt, pb = _same_pads(x.shape[2], stride, k_eff)
        pl, pr = _same_pads(x.shape[3], stride, k_eff)
        if pt or pb or pl or pr:
            x = F.pad(x, (pl, pr, pt, pb))
        o = F.conv2d(x, w, stride=stride, dilation=dilation, groups=groups)
        if bias is not None:
            o = o + bias
        return _activate(o, act).permute(0, 2, 3, 1)

    return apply


def fused_block_eligible(stride: int, dilation: int = 1) -> bool:
    """Whether a block runs the fused kernel: stride 1, undilated. The
    kernel masks ragged row tiles and plans every map size itself, so
    there is no counterpart of the JAX package's shape gate
    (``_tiling_valid``, the tile budget) and no environment opt-out."""
    return stride == 1 and dilation == 1


def inverted_residual_auto(x: torch.Tensor, folded: Dict[str, Any], *,
                           stride: int = 1, dilation: int = 1,
                           residual: Optional[bool] = None,
                           compute_dtype: torch.dtype = torch.bfloat16
                           ) -> torch.Tensor:
    """The counterpart of the JAX package's ``inverted_residual_auto``: a
    block :func:`fused_block_eligible` accepts goes to
    :func:`fused_inverted_residual` (the kernel on a CUDA tensor, its plain
    version on a CPU one), every other block (stride 2, dilated) to
    :func:`inverted_residual_conv`."""
    if fused_block_eligible(stride, dilation):
        return fused_inverted_residual(x, folded, stride=stride,
                                       residual=residual,
                                       compute_dtype=compute_dtype)
    return inverted_residual_conv(x, folded, stride=stride,
                                  dilation=dilation, residual=residual,
                                  compute_dtype=compute_dtype)


class FusedPlan(NamedTuple):
    """What one launch of ``csrc/fused_block.cu`` needs besides the
    tensors. ``kind`` "tc": the bfloat16 kernel (tensor-core 1x1s,
    persistent CTAs over (image, R rows) work items, every output channel
    in one CTA); "fma": the float32 kernel (one CTA per image, R rows and
    CoT output channels)."""
    kind: str
    R: int         # output rows per work item
    Cc: int        # hidden channels per chunk
    CoT: int       # output channels per CTA
    variant: int   # index into _TC_VARIANTS ("tc"); -1 ("fma")
    WM: int        # warps along pixels; the rest along channels ("tc")
    smem: int      # dynamic shared memory bytes per CTA


def _r16(v: int) -> int:
    return -(-v // 16) * 16


def _tc_smem(H: int, W: int, Cin: int, Cout: int, R: int, Cc: int,
             expand: bool) -> int:
    """Dynamic shared memory of the bfloat16 kernel: two input buffers,
    two weight buffers, the hidden tile, the depthwise output (aliased by
    the output stage) and b2. Keep in step with csrc/fused_block.cu
    make_layout, which refuses a launch given less."""
    cin_p, cout_p = _r16(Cin), _r16(Cout)
    xs = _r16(2 * _r16(min(R + 2, H) * W) * (cin_p + 8))
    wd = (_r16(2 * cin_p * (Cc + 8)) if expand else 0) + _r16(
        2 * Cc * (cout_p + 8))
    wbuf = wd + _r16(2 * 9 * Cc) + 2 * _r16(4 * Cc)
    hid = _r16(2 * (R + 2) * (W + 2) * (Cc + 8))
    stage = _r16(2 * _r16(R * W) * max(Cc + 8, cout_p + 8))
    return 2 * xs + 2 * wbuf + hid + stage + _r16(4 * cout_p)


def _tc_fit(R: int, W: int, Cout: int) -> Optional[Tuple[int, int]]:
    """(variant, WM) with the fewest accumulators whose warps cover the
    [R*W x Cout] project output in 16x16 fragments, or None."""
    mt, nt = -(-R * W // 16), _r16(Cout) // 16
    best = None
    for v, (fm, fn) in enumerate(_TC_VARIANTS):
        for wm in (1, 2, 4, 8, 16):
            if mt <= fm * wm and nt <= fn * (_TC_WARPS // wm):
                if best is None or fm * fn < best[0]:
                    best = (fm * fn, v, wm)
    return None if best is None else best[1:]


@functools.lru_cache(maxsize=None)
def _plan_tiles(H: int, W: int, Cin: int, Ch: int, Cout: int,
                itemsize: int, expand: bool = True) -> FusedPlan:
    """The launch plan for one block shape (cached: the per-call host path
    is a lookup).

    bfloat16 (itemsize 2): the most rows per work item with R*W at most
    ``_TC_MAX_PIXELS`` (whole images at 14x14 and 7x7, so nothing is
    recomputed; 4-14 rows at 28x28 and up), split evenly over H; the hidden
    chunk that pads Ch least (largest first); the variant with the fewest
    accumulators that covers R*W x Cout; all within ``_SMEM_BUDGET``,
    shrinking the chunk and then R.

    float32 (itemsize 4): R*W*CoT fits the FMA kernel's register
    accumulators (``_MAX_OUTPUTS``); the shared-memory tiles fit the budget,
    shrinking the hidden chunk first and then the row tile."""
    if itemsize == 2:
        chunks = sorted(_TC_CHUNKS, key=lambda c: (-(-Ch // c) * c - Ch, -c))
        rows = sorted({-(-H // n) for n in range(1, H + 1)}, reverse=True)
        for r in rows:
            if r > 1 and r * W > _TC_MAX_PIXELS:
                continue
            fit = _tc_fit(r, W, Cout)
            if fit is None:
                continue
            for cc in chunks:
                smem = _tc_smem(H, W, Cin, Cout, r, cc, expand)
                if smem <= _SMEM_BUDGET:
                    return FusedPlan("tc", r, cc, Cout, fit[0], fit[1], smem)
        raise ValueError(f"fused block: no bfloat16 plan for H={H} W={W} "
                         f"Cin={Cin} Ch={Ch} Cout={Cout} within "
                         f"{_SMEM_BUDGET} bytes of shared memory and "
                         f"{_TC_WARPS} warps of {_TC_VARIANTS} fragments")
    if itemsize != 4:
        raise ValueError(f"fused block: no kernel for itemsize {itemsize}")
    if W > _MAX_OUTPUTS:
        raise ValueError(f"fused block: width {W} exceeds the kernel's "
                         f"{_MAX_OUTPUTS}-output tile")
    cot = min(Cout, _MAX_OUTPUTS // W)
    r_max = min(H, max(1, _MAX_OUTPUTS // (W * cot)))
    n_tiles = -(-H // r_max)
    r = -(-H // n_tiles)  # even split of H into the fewest tiles
    cc = min(32, Ch)

    def smem(r, cc):
        return 4 * ((r + 2) * W * Cin + (r + 2) * (W + 2) * cc
                    + r * W * cc + Cin * cc + cc * cot)

    while smem(r, cc) > _SMEM_BUDGET:
        if cc > 8:
            cc //= 2
        elif r > 1:
            r = (r + 1) // 2
        else:
            raise ValueError(
                f"fused block: H={H} W={W} Cin={Cin} needs "
                f"{smem(r, cc)} bytes of shared memory per CTA, more "
                f"than {_SMEM_BUDGET}")
    return FusedPlan("fma", r, cc, cot, -1, 0, smem(r, cc))


def fused_kernel_attributes(plan: FusedPlan) -> dict:
    """What the kernel of ``plan`` asks of the current CUDA device:
    registers per thread, dynamic shared memory and resident CTAs per SM."""
    out = (ctypes.c_int * 3)()
    _cuda.check(_cuda.lib().nnstpu_fused_attributes(plan.variant, plan.smem,
                                                    out),
                "fused_kernel_attributes")
    return dict(zip(("registers", "dynamic_smem_bytes", "ctas_per_sm"), out))


@functools.lru_cache(maxsize=None)
def _resident_ctas(plan: FusedPlan, device_index: int) -> int:
    """CTAs of ``plan``'s kernel the card holds at once: the persistent
    grid's size."""
    with torch.cuda.device(device_index):
        per_sm = fused_kernel_attributes(plan)["ctas_per_sm"]
    _cuda.require(per_sm >= 1, f"fused block: {plan} does not fit an SM")
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return sms * per_sm


class _Weights(NamedTuple):
    """One folded dict in the kernel's form on one device, checked once."""
    source: Tuple[Tuple[str, Any], ...]  # the dict's items when prepared
    tensors: Dict[str, torch.Tensor]     # what the pointers point into
    ptrs: Tuple[int, ...]                # w1, b1, wd, bd, w2, b2 (0: none)
    Cin: int
    Ch: int
    Cout: int
    launches: Dict[tuple, Any]           # _launch_params by input shape


#: prepared weights by (id of the folded dict, dtype, device); an entry is
#: used only while the dict still holds the very tensors it was made from
_WEIGHTS: Dict[tuple, _Weights] = {}
_WEIGHTS_MAX = 256
#: the replica pool's workers prepare weights from several threads
_WEIGHTS_LOCK = threading.Lock()
#: set on a thread inside :func:`transient_weights`
_TRANSIENT = threading.local()


@contextlib.contextmanager
def transient_weights():
    """Inside it, this thread's calls prepare their weights anew and keep
    nothing in the cache: for folded dicts that live one invoke (the tp
    mesh path's gathered weights, filters/cuda_filter.py), which the cache
    would otherwise hold alive after their forward returned."""
    prev = getattr(_TRANSIENT, "on", False)
    _TRANSIENT.on = True
    try:
        yield
    finally:
        _TRANSIENT.on = prev


def _weights(folded: Dict[str, Any], cd: torch.dtype, device) -> _Weights:
    """Cast and check ``folded`` once; later calls with the same dict (the
    model's folded blocks, cast at open) cost a lookup."""
    key = (id(folded), cd, device)
    hit = _WEIGHTS.get(key)
    if hit is not None and len(hit.source) == len(folded) and all(
            folded.get(k) is v for k, v in hit.source):
        return hit
    fw = cast_folded(folded, cd, device)  # no copy when already cast
    w1 = fw.get("w1")
    Ch, Cout = fw["wd"].shape[-1], fw["w2"].shape[-1]
    _cuda.require(tuple(fw["wd"].shape) == (9, Ch), "wd must be [9, Ch]")
    _cuda.require(fw["w2"].shape[0] == Ch, "w2 must be [Ch, Cout]")
    Cin = Ch if w1 is None else w1.shape[0]
    _cuda.require(w1 is None or tuple(w1.shape) == (Cin, Ch),
                  "w1 must be [Cin, Ch]")
    ptrs = tuple(fw[k].data_ptr() if k in fw else 0
                 for k in ("w1", "b1", "wd", "bd", "w2", "b2"))
    w = _Weights(tuple(folded.items()), fw, ptrs, Cin, Ch, Cout, {})
    if getattr(_TRANSIENT, "on", False):
        return w
    with _WEIGHTS_LOCK:
        if len(_WEIGHTS) >= _WEIGHTS_MAX:
            _WEIGHTS.pop(next(iter(_WEIGHTS)))
        _WEIGHTS[key] = w
    return w


def _launch_fields(w: _Weights, H: int, W: int, residual: bool,
                   cd: torch.dtype, dev: int) -> List[int]:
    """The plan of one block and input size in the C entry point's F_*
    order (csrc/fused_block.cu): R, CoT, Cc, variant, WM, grid, residual,
    shared-memory bytes. The grid is the card's resident CTAs (the kernel
    caps it at the batch's work items). Both routes to the kernel pass it:
    the ctypes launch below and the TorchScript op under tracing."""
    plan = _plan_tiles(H, W, w.Cin, w.Ch, w.Cout, torch.finfo(cd).bits // 8,
                       w.ptrs[0] != 0)
    grid = _resident_ctas(plan, dev) if plan.kind == "tc" else 0
    return [plan.R, plan.CoT, plan.Cc, plan.variant, plan.WM, grid,
            int(residual), plan.smem]


def _launch_params(w: _Weights, B: int, H: int, W: int, residual: bool,
                   cd: torch.dtype, dev: int):
    """The C entry point's fixed arguments for one block and input shape,
    as host arrays built once: the weight pointers, the shape (B, H, W,
    Cin, Ch, Cout), the dtype code and :func:`_launch_fields`."""
    key = (B, H, W, residual, cd, dev)
    params = w.launches.get(key)
    if params is None:
        fields = _launch_fields(w, H, W, residual, cd, dev)
        params = w.launches[key] = (
            (ctypes.c_void_p * 6)(*[p or None for p in w.ptrs]),
            (ctypes.c_longlong * 6)(B, H, W, w.Cin, w.Ch, w.Cout),
            _cuda.DTYPE_CODES[cd],
            (ctypes.c_longlong * len(fields))(*fields), len(fields))
    return params


def fused_inverted_residual(x: torch.Tensor, folded: Dict[str, Any], *,
                            stride: int = 1,
                            residual: Optional[bool] = None,
                            compute_dtype: torch.dtype = torch.bfloat16
                            ) -> torch.Tensor:
    """Run one inverted-residual block as a single fused kernel.

    x: [B, H, W, Cin]; folded: w1/b1 (absent for expand=1), wd [9, Ch],
    bd, w2 [Ch, Cout], b2. Returns [B, H, W, Cout] in compute_dtype. A
    stride-2 block runs :func:`inverted_residual_conv`. The weights are
    cast and checked once per folded dict, and the plan and the launch
    arguments once per input shape, so a call costs the input checks and
    one launch. Under ``torch.jit.trace`` a CUDA tensor takes the
    TorchScript op (ops/_script_ops.py) with the same plan, which the trace
    records."""
    if stride != 1:
        return inverted_residual_conv(x, folded, stride=stride,
                                      residual=residual,
                                      compute_dtype=compute_dtype)
    if _cuda.plain_route(x):
        return inverted_residual_plain(x, folded, residual=residual,
                                       compute_dtype=compute_dtype)
    cd = compute_dtype
    _cuda.require(cd in (torch.float32, torch.bfloat16),
                  f"fused block computes in float32 or bfloat16, not {cd}")
    _cuda.require(x.dim() == 4, f"fused block takes NHWC, got {tuple(x.shape)}")
    B, H, W, Cin = x.shape
    w = _weights(folded, cd, x.device)
    _cuda.require(Cin == w.Cin, f"x has {Cin} channels, the block takes "
                  f"{w.Cin}")
    if residual is None:
        residual = Cin == w.Cout
    _cuda.require(not residual or Cin == w.Cout, "residual needs Cin == Cout")
    xc = x if x.dtype == cd and x.is_contiguous() else x.to(cd).contiguous()
    dev = x.device.index
    if dev is None:
        dev = torch.cuda.current_device()
    if torch.jit.is_tracing():  # a launch the trace records
        from nnstreamer_tpu_torch.ops import _script_ops

        return _script_ops.fused_inverted_residual(
            xc, w.tensors, _launch_fields(w, H, W, bool(residual), cd, dev))
    out = torch.empty((B, H, W, w.Cout), dtype=cd, device=x.device)
    params = _launch_params(w, B, H, W, bool(residual), cd, dev)
    lib = _cuda.launcher("fused_inverted_residual")
    args = (xc.data_ptr(), out.data_ptr(), *params, _cuda.stream_handle(x))
    if torch.cuda.current_device() == dev:
        err = lib.nnstpu_fused_inverted_residual(*args)
    else:
        with torch.cuda.device(dev):
            err = lib.nnstpu_fused_inverted_residual(*args)
    _cuda.check(err, "fused_inverted_residual")
    _cuda.count_launch("fused_inverted_residual")
    _cuda.bill_launch("fused_inverted_residual", inverted_residual_plain, x,
                      folded, residual=bool(residual), compute_dtype=cd)
    return out
