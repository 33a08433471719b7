"""Single-device attention (counterpart of the single-device half of the
JAX package's ``ops/attention.py``).

  - :func:`flash_attention_plain`: the blockwise recurrence with a running
    (m, l, acc) per query row, over key blocks of ``block_k`` (the last
    block may be shorter) — the plain version of the kernel;
  - :func:`flash_attention`: the JAX package's ``flash_attention``, whose
    block is ``block_size`` halved until it divides the key length;
  - :func:`plain_attention`: scores materialized, one softmax;
  - :func:`flash_attention_cuda`: the kernel wrapper, the counterpart of
    ``flash_attention_pallas``. A CUDA tensor launches the hand-written
    kernel in ``csrc/attention.cu`` or raises; a CPU tensor runs
    :func:`flash_attention_plain` at the kernel's own block size;
  - :func:`flash_attention_auto`: the model's entry point. A CUDA tensor
    always goes to the kernel, which takes ragged sequences and head_dim
    32, 64 and 128: the JAX package's tiling gate (head_dim % 128, block
    divisibility, the VMEM budget) and its ``NNSTPU_PALLAS`` opt-out are
    TPU matters and have no counterpart. A CPU tensor keeps the JAX
    package's routing among the plain functions, so the CPU tests compare
    like with like.

Every function takes ``(..., seq, head_dim)`` and returns ``q``'s shape and
dtype. Rounding points follow ``_block_attn``: scores ``q·kᵀ`` in float32
times ``scale``; masked scores ``-1e30``; ``p = exp(s - m)`` in float32,
summed into ``l`` in float32 and rounded to the value dtype before ``p·v``,
which accumulates in float32; the output ``acc / max(l, 1e-37)`` rounded
once. Ring and Ulysses attention wait for the multi-GPU slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from nnstreamer_tpu_torch.ops import _cuda

_NEG_INF = -1e30

#: the kernel's tile: query rows per CTA and keys per K/V tile
BLOCK_Q = 64
BLOCK_K = 64
#: head dims the kernel is instantiated for (csrc/attention.cu)
HEAD_DIMS = (32, 64, 128)

#: the JAX package's short-sequence cutover for its non-kernel route
_PLAIN_SEQ_LIMIT = 512 * 512


def _scale(d: int, scale: Optional[float]) -> float:
    return scale if scale is not None else 1.0 / (d ** 0.5)


def _block_attn(q, k, v, m, l, acc, scale, causal_mask=None):
    """One flash-attention update step, batched over the leading dim.

    q: (b, sq, d); k, v: (b, sk, d); m, l: (b, sq) float32;
    acc: (b, sq, d) float32. Returns the updated (m, l, acc)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal_mask is not None:
        s = torch.where(causal_mask, s, _NEG_INF)
    m_blk = s.amax(dim=-1)
    m_new = torch.maximum(m, m_blk)
    # guard fully-masked rows (m_new == -inf): exp(0)=1 row weight, l stays 0
    m_safe = torch.where(m_new <= _NEG_INF / 2, 0.0, m_new)
    p = torch.exp(s - m_safe[..., None])
    if causal_mask is not None:
        p = torch.where(causal_mask, p, 0.0)
    dead = m <= _NEG_INF / 2
    corr = torch.exp(torch.where(dead, _NEG_INF, m) - m_safe)
    corr = torch.where(dead, 0.0, corr)
    l_new = corr * l + p.sum(dim=-1)
    acc_new = corr[..., None] * acc + torch.matmul(
        p.to(v.dtype).float(), v.float())
    return m_new, l_new, acc_new


def flash_attention_plain(q, k, v, *, causal: bool = False,
                          scale: Optional[float] = None,
                          block_k: int = BLOCK_K):
    """Blockwise attention over key blocks of ``block_k``, the last one
    shorter when ``block_k`` does not divide the key length. The kernel's
    plain version: ``p``'s rounding depends on the running max at each
    block, so the kernel is compared with this at its own ``block_k``."""
    *lead, sq, d = q.shape
    sk = k.shape[-2]
    scale = _scale(d, scale)
    q3 = q.reshape(-1, sq, d)
    k3 = k.reshape(-1, sk, d)
    v3 = v.reshape(-1, sk, d)
    bh = q3.shape[0]
    m = torch.full((bh, sq), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((bh, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((bh, sq, d), dtype=torch.float32, device=q.device)
    q_pos = torch.arange(sq, device=q.device)
    for k0 in range(0, sk, block_k):
        kb, vb = k3[:, k0:k0 + block_k], v3[:, k0:k0 + block_k]
        mask = None
        if causal:
            k_pos = k0 + torch.arange(kb.shape[1], device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
        m, l, acc = _block_attn(q3, kb, vb, m, l, acc, scale, mask)
    out = (acc / torch.clamp(l, min=1e-37)[..., None]).to(q.dtype)
    return out.reshape(*lead, sq, d)


def flash_attention(q, k, v, *, causal: bool = False, block_size: int = 512,
                    scale: Optional[float] = None):
    """The JAX package's blockwise attention: blocks of ``block_size``,
    halved until they divide the key length."""
    sk = k.shape[-2]
    blk = min(block_size, sk)
    while sk % blk != 0:
        blk //= 2
    return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                 block_k=blk)


def plain_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None):
    """Direct softmax attention with the scores materialized; float32
    scores and accumulation, as the flash paths."""
    d = q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * _scale(d, scale)
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(mask, s, _NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def flash_attention_cuda(q, k, v, *, causal: bool = False,
                         scale: Optional[float] = None):
    """Flash-attention forward through the hand-written CUDA kernel.

    q: (..., sq, d); k, v: (..., sk, d) with the same leading dims; bf16;
    d in :data:`HEAD_DIMS`; any sq, sk. A CPU tensor runs
    :func:`flash_attention_plain` at the kernel's ``BLOCK_K``."""
    *lead, sq, d = q.shape
    sk = k.shape[-2]
    scale = _scale(d, scale)
    if _cuda.on_cpu(q):
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     block_k=BLOCK_K)
    _cuda.require(q.dtype == k.dtype == v.dtype == torch.bfloat16,
                  "flash_attention takes bfloat16 q, k, v on CUDA, got "
                  f"{q.dtype}, {k.dtype}, {v.dtype}")
    _cuda.require(d in HEAD_DIMS, f"flash_attention takes head_dim in "
                  f"{HEAD_DIMS}, got {d}")
    _cuda.require(k.shape == v.shape and tuple(k.shape[:-2]) == tuple(lead)
                  and k.shape[-1] == d,
                  f"flash_attention shapes disagree: q {tuple(q.shape)}, "
                  f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    _cuda.require(k.device == q.device and v.device == q.device,
                  "flash_attention: q, k, v on different devices")
    _cuda.require(sk > 0, "flash_attention needs at least one key")
    q3, k3, v3 = (_aligned(t.reshape(-1, t.shape[-2], d)) for t in (q, k, v))
    bh = q3.shape[0]
    out = torch.empty_like(q3)
    if bh == 0 or sq == 0:
        return out.reshape(q.shape)
    lib = _cuda.lib()
    with torch.cuda.device(q.device):
        err = lib.nnstpu_flash_attention(
            q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), out.data_ptr(), bh,
            sq, sk, d, float(scale), int(bool(causal)),
            _cuda.stream_handle(q))
    _cuda.check(err, "flash_attention")
    _cuda.LAUNCHES["flash_attention"] += 1
    return out.reshape(q.shape)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, on a 16-byte boundary (the kernel's vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _jax_kernel_tiles(sq: int, sk: int, d: int, itemsize: int) -> bool:
    """Whether the JAX package's ``_pallas_tiling`` would take these
    shapes: its routing on the CPU depends on it."""
    if d % 128 or 2 * sk * d * itemsize > 8 * 1024 * 1024:
        return False
    blocks = (512, 256, 128, 64, 32, 16, 8)
    return any(sq % b == 0 for b in blocks) and any(sk % b == 0
                                                    for b in blocks)


def flash_attention_auto(q, k, v, *, causal: bool = False,
                         scale: Optional[float] = None,
                         block_size: int = 512):
    """The kernel for a CUDA tensor, whatever its shape; for a CPU tensor
    the JAX package's choice among the plain functions: ``plain_attention``
    for short sequences the Pallas kernel cannot tile (scores ≤ 512²),
    blockwise otherwise."""
    if not _cuda.on_cpu(q):
        return flash_attention_cuda(q, k, v, causal=causal, scale=scale)
    sq, sk, d = q.shape[-2], k.shape[-2], q.shape[-1]
    if (not _jax_kernel_tiles(sq, sk, d, q.element_size())
            and sq * sk <= _PLAIN_SEQ_LIMIT):
        return plain_attention(q, k, v, causal=causal, scale=scale)
    return flash_attention(q, k, v, causal=causal, scale=scale,
                           block_size=block_size)
