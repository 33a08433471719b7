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

Routing, as in the JAX package: stride-1 blocks on a CUDA tensor launch the
kernel for every shape (it masks ragged tiles itself, so there is no
counterpart of ``_tiling_valid``/``fused_block_eligible``); stride-2 and
dilated blocks run :func:`inverted_residual_plain`, as the JAX package
sends them to ``inverted_residual_xla``; a CPU tensor runs the plain
version.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from nnstreamer_tpu_torch.ops import _cuda

#: threads x accumulators per thread of the kernel (csrc/fused_block.cu)
_MAX_OUTPUTS = 256 * 32
#: shared memory one CTA may use (the card allows 227 KB)
_SMEM_BUDGET = 200 * 1024


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
                device=None) -> Dict[str, torch.Tensor]:
    """Weights in the compute dtype, biases in float32, all contiguous on
    ``device`` — the form the kernel reads (done once, at model open)."""
    out = {}
    for k, v in folded.items():
        dt = torch.float32 if k.startswith("b") else compute_dtype
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


def _plan_tiles(H: int, W: int, Cin: int, Ch: int, Cout: int,
                itemsize: int) -> Tuple[int, int, int, int]:
    """Tile plan for the kernel: (R output rows, CoT output channels, Cc
    hidden channels per chunk, shared-memory bytes). R*W*CoT fits the
    kernel's register accumulators; the shared-memory tiles fit the
    budget, shrinking the hidden chunk first and then the row tile."""
    if W > _MAX_OUTPUTS:
        raise ValueError(f"fused block: width {W} exceeds the kernel's "
                         f"{_MAX_OUTPUTS}-output tile")
    cot = min(Cout, _MAX_OUTPUTS // W)
    r_max = min(H, max(1, _MAX_OUTPUTS // (W * cot)))
    n_tiles = -(-H // r_max)
    r = -(-H // n_tiles)  # even split of H into the fewest tiles
    cc = min(32, Ch)

    def smem(r, cc):
        return itemsize * ((r + 2) * W * Cin + (r + 2) * (W + 2) * cc
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
    return r, cot, cc, smem(r, cc)


def fused_inverted_residual(x: torch.Tensor, folded: Dict[str, Any], *,
                            stride: int = 1,
                            residual: Optional[bool] = None,
                            compute_dtype: torch.dtype = torch.bfloat16
                            ) -> torch.Tensor:
    """Run one inverted-residual block as a single fused kernel.

    x: [B, H, W, Cin]; folded: w1/b1 (absent for expand=1), wd [9, Ch],
    bd, w2 [Ch, Cout], b2. Returns [B, H, W, Cout] in compute_dtype."""
    if stride != 1 or _cuda.on_cpu(x):
        return inverted_residual_plain(x, folded, stride=stride,
                                       residual=residual,
                                       compute_dtype=compute_dtype)
    cd = compute_dtype
    _cuda.require(cd in (torch.float32, torch.bfloat16),
                  f"fused block computes in float32 or bfloat16, not {cd}")
    _cuda.require(x.dim() == 4, f"fused block takes NHWC, got {tuple(x.shape)}")
    B, H, W, Cin = x.shape
    fw = cast_folded(folded, cd, x.device)
    w1 = fw.get("w1")
    Ch, Cout = fw["wd"].shape[-1], fw["w2"].shape[-1]
    _cuda.require(fw["wd"].shape == (9, Ch), "wd must be [9, Ch]")
    _cuda.require(fw["w2"].shape[0] == Ch, "w2 must be [Ch, Cout]")
    if w1 is not None:
        _cuda.require(tuple(w1.shape) == (Cin, Ch), "w1 must be [Cin, Ch]")
    else:
        _cuda.require(Ch == Cin, "expand=1 needs Ch == Cin")
    if residual is None:
        residual = Cin == Cout
    _cuda.require(not residual or Cin == Cout, "residual needs Cin == Cout")
    xc = x.to(cd).contiguous()
    out = torch.empty((B, H, W, Cout), dtype=cd, device=x.device)
    r, cot, cc, smem = _plan_tiles(H, W, Cin, Ch, Cout, xc.element_size())
    lib = _cuda.lib()
    with torch.cuda.device(x.device):
        err = lib.nnstpu_fused_inverted_residual(
            xc.data_ptr(), w1.data_ptr() if w1 is not None else None,
            fw["b1"].data_ptr() if w1 is not None else None,
            fw["wd"].data_ptr(), fw["bd"].data_ptr(), fw["w2"].data_ptr(),
            fw["b2"].data_ptr(), out.data_ptr(), B, H, W, Cin, Ch, Cout,
            r, cot, cc, int(w1 is not None), int(residual),
            _cuda.DTYPE_CODES[cd], smem, _cuda.stream_handle(x))
    _cuda.check(err, "fused_inverted_residual")
    _cuda.LAUNCHES["fused_inverted_residual"] += 1
    return out
