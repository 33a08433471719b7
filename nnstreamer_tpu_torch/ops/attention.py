"""Attention (counterpart of the JAX package's ``ops/attention.py``).

Single device:

  - :func:`flash_chunk_plain`: one flash-attention CHUNK update, the inner
    step of every function here: it folds the attention of ``q`` against
    one K/V chunk into running (m, l, acc) carries, over key blocks of
    ``block_k`` (the last block may be shorter), with causal masking at the
    global positions ``q_offset + i >= k_offset + j``. Blocks past the
    chunk's last row's diagonal are skipped, so a chunk wholly in the
    causal future leaves the carries bit for bit as they were. The plain
    version of the chunk kernel;
  - :func:`flash_attention_plain`: fresh carries, one chunk update at
    offsets 0, then ``acc / l`` — the plain version of the flash kernel;
  - :func:`flash_attention`: the JAX package's ``flash_attention``, whose
    block is ``block_size`` halved until it divides the key length;
  - :func:`plain_attention`: scores materialized, one softmax;
  - :func:`flash_attention_cuda` and :func:`flash_chunk_cuda`: the kernel
    wrappers, counterparts of ``flash_attention_pallas`` and
    ``flash_chunk_pallas``. A CUDA tensor launches the hand-written kernel
    in ``csrc/attention.cu`` or raises; a CPU tensor runs the plain version
    at the kernel's own key block (:func:`key_block`). The kernels take
    bfloat16 and float32 at every head_dim from 1 up (:func:`kernel_instance`
    names the body and instantiation each one runs; above
    :data:`SLICE_COLS` the output's columns are split over the grid);
  - :func:`flash_attention_auto`: the model's entry point. A CUDA tensor
    always goes to the kernel, which takes ragged sequences: the JAX
    package's tiling gate (head_dim % 128, block divisibility, the VMEM
    budget) and its ``NNSTPU_PALLAS`` opt-out are TPU matters and have no
    counterpart. A CPU tensor keeps the JAX package's routing among the
    plain functions, so the CPU tests compare like with like.

Sequence parallel, over an axis of a :class:`parallel.mesh.Mesh` that one
process drives (the reference runs the same algorithms under
``shard_map``; here shards move between the axis's devices by
device-to-device copies, and two shards on one device pass the tensor
along):

  - :func:`ring_attention`: q stays on its shard; K/V chunks rotate around
    the ring, each hop one :func:`flash_chunk_cuda` per shard;
    :func:`ring_attention_plain` is the same ring over
    :func:`flash_chunk_plain`, the whole path's plain version;
  - :func:`ulysses_attention`: one all-to-all scatters heads and gathers
    the sequence, :func:`flash_attention_auto` runs per shard over the
    full sequence, a second all-to-all restores sequence sharding.

Every function takes ``(..., seq, head_dim)`` (Ulysses: ``(batch, heads,
seq, head_dim)``) and returns ``q``'s shape and dtype. Rounding points
follow ``_block_attn``: scores ``q·kᵀ`` in float32 times ``scale``; masked
scores ``-1e30``; ``p = exp(s - m)`` in float32, summed into ``l`` in
float32 and rounded to the value dtype before ``p·v``, which accumulates
in float32; the output ``acc / max(l, 1e-37)`` rounded once.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from nnstreamer_tpu_torch.ops import _cuda

_NEG_INF = -1e30

#: the kernel's tile (``kBlockQ``/``kBlockK`` in csrc/attention.cu): query
#: rows per CTA of the tensor-core bodies, 64 per consumer warpgroup, and
#: keys per K/V tile of the simple body and of the tensor-core body up to
#: head_dim 128; p's bf16 rounding depends on the key block, so the plain
#: versions run at each instance's own (:func:`key_block`)
BLOCK_Q = 128
BLOCK_K = 128
#: the kernels' instantiations (kTcDims, kTcKeyBlocks, kSimpleDims,
#: kSliceCols, kPanelCols, kSplitKeyBlock in csrc/attention.cu): the
#: tensor-core body's D and the keys of its K/V tiles at each; the simple
#: body's D; the output columns one CTA of either split body writes (the
#: splits take every head_dim above the simple body's widest); the
#: head-dim panel of the tensor-core split, which takes bf16 at multiples
#: of it, and its key block
TC_HEAD_DIMS = (16, 32, 64, 128, 256)
TC_KEY_BLOCKS = (128, 128, 128, 128, 64)
SIMPLE_HEAD_DIMS = (32, 64, 128, 256)
SLICE_COLS = 256
PANEL_COLS = 64
SPLIT_KEY_BLOCK = 64
#: the dtypes the kernels read and write
KERNEL_DTYPES = (torch.bfloat16, torch.float32)

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


def flash_chunk_plain(q, k, v, m, l, acc, *, q_offset: int, k_offset: int,
                      causal: bool, scale: float,
                      block_k: Optional[int] = None):
    """Fold the attention of ``q`` against one K/V chunk into the carries,
    over key blocks of ``block_k`` (default: the chunk kernel's own,
    :func:`key_block`); returns new (m, l, acc).

    q: (bh, sq, d); k, v: (bh, sk, d); m, l: (bh, sq) float32; acc:
    (bh, sq, d) float32. Query row ``i`` sits at global position
    ``q_offset + i``, key ``j`` at ``k_offset + j``. Causal blocks past the
    last row's diagonal are skipped, so a chunk wholly in the future
    returns the carries themselves. ``p``'s rounding depends on the running
    max at each block, so the kernel is compared with this at its own
    ``block_k``; ``block_k = sk`` is the JAX package's XLA hop (one block
    over the whole chunk)."""
    sq, sk = q.shape[-2], k.shape[-2]
    if block_k is None:
        block_k = key_block(q.shape[-1], q.dtype)
    n_kb = -(-sk // block_k)
    if causal:
        # floor division: the difference is negative for a future chunk
        n_kb = min(max((q_offset + sq - 1 - k_offset) // block_k + 1, 0),
                   n_kb)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    for k0 in range(0, n_kb * block_k, block_k):
        kb, vb = k[:, k0:k0 + block_k], v[:, k0:k0 + block_k]
        mask = None
        if causal:
            k_pos = k_offset + k0 + torch.arange(kb.shape[1], device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
        m, l, acc = _block_attn(q, kb, vb, m, l, acc, scale, mask)
    return m, l, acc


def _fresh_carries(bh: int, sq: int, d: int, device):
    return (torch.full((bh, sq), _NEG_INF, dtype=torch.float32, device=device),
            torch.zeros((bh, sq), dtype=torch.float32, device=device),
            torch.zeros((bh, sq, d), dtype=torch.float32, device=device))


def _normalize(l, acc, dtype):
    return (acc / torch.clamp(l, min=1e-37)[..., None]).to(dtype)


def flash_attention_plain(q, k, v, *, causal: bool = False,
                          scale: Optional[float] = None,
                          block_k: Optional[int] = None):
    """Blockwise attention over key blocks of ``block_k``, the last one
    shorter when ``block_k`` does not divide the key length: one
    :func:`flash_chunk_plain` from fresh carries at offsets 0. The flash
    kernel's plain version, at the kernel's own key block by default
    (:func:`key_block`)."""
    *lead, sq, d = q.shape
    sk = k.shape[-2]
    q3 = q.reshape(-1, sq, d)
    _, l, acc = flash_chunk_plain(
        q3, k.reshape(-1, sk, d), v.reshape(-1, sk, d),
        *_fresh_carries(q3.shape[0], sq, d, q.device), q_offset=0,
        k_offset=0, causal=causal, scale=_scale(d, scale), block_k=block_k)
    return _normalize(l, acc, q.dtype).reshape(*lead, sq, d)


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


def _tc_split(d: int, dtype: torch.dtype) -> bool:
    return (dtype == torch.bfloat16 and d > SLICE_COLS
            and d % PANEL_COLS == 0)


def kernel_instance(d: int, dtype: torch.dtype):
    """``(body, D)``: the CTA body and instantiation the kernels run for
    head_dim ``d`` in ``dtype``, as ``instance_of`` in csrc/attention.cu
    picks them. The tensor-core body (wgmma, TMA) takes bf16 at ``d`` in
    :data:`TC_HEAD_DIMS`, and its split (``tensor_core_split``) bf16 above
    :data:`SLICE_COLS` at multiples of :data:`PANEL_COLS`; the simple body
    (float32 FMAs) takes the rest up to the widest of
    :data:`SIMPLE_HEAD_DIMS`, at the least D not below ``d``, and above it
    its split (``simple_split``). A split runs :func:`head_dim_slices`
    CTAs per q tile, each writing ``D =`` :data:`SLICE_COLS` output
    columns (the last slice fewer)."""
    _check_kernel_dims("flash attention", d, dtype)
    if dtype == torch.bfloat16 and d in TC_HEAD_DIMS:
        return "tensor_core", d
    if _tc_split(d, dtype):
        return "tensor_core_split", SLICE_COLS
    if d > SIMPLE_HEAD_DIMS[-1]:
        return "simple_split", SLICE_COLS
    return "simple", min(D for D in SIMPLE_HEAD_DIMS if D >= d)


def key_block(d: int, dtype: torch.dtype) -> int:
    """Keys per K/V tile of the instance that head_dim ``d`` in ``dtype``
    runs: :data:`TC_KEY_BLOCKS` on the tensor-core body,
    :data:`SPLIT_KEY_BLOCK` on its split, :data:`BLOCK_K` on the simple
    body (and for any dtype no kernel takes). A bf16 p is rounded at the
    running max of its key block, so this is the block the kernel's plain
    version runs at."""
    if dtype == torch.bfloat16 and d in TC_HEAD_DIMS:
        return TC_KEY_BLOCKS[TC_HEAD_DIMS.index(d)]
    if _tc_split(d, dtype):
        return SPLIT_KEY_BLOCK
    return BLOCK_K


def head_dim_slices(d: int) -> int:
    """CTAs per q tile along the grid's third dimension: 1 up to
    :data:`SLICE_COLS`, then one per ``SLICE_COLS`` output columns."""
    return 1 if d <= SLICE_COLS else -(-d // SLICE_COLS)


def _check_kernel_dims(what: str, d: int, dtype: torch.dtype) -> None:
    _cuda.require(dtype in KERNEL_DTYPES, f"{what} takes bfloat16 or "
                  f"float32 on CUDA, got {dtype}")
    _cuda.require(d >= 1, f"{what} takes head_dim of at least 1, got {d}")


def _check_kernel_inputs(what: str, q, k, v) -> None:
    _cuda.require(q.dtype == k.dtype == v.dtype, f"{what} takes q, k, v of "
                  f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    _check_kernel_dims(what, q.shape[-1], q.dtype)


def flash_attention_cuda(q, k, v, *, causal: bool = False,
                         scale: Optional[float] = None):
    """Flash-attention forward through the hand-written CUDA kernel.

    q: (..., sq, d); k, v: (..., sk, d) with the same leading dims; bf16 or
    float32, the output in their dtype; any d from 1 up; any sq, sk. A CPU
    tensor runs :func:`flash_attention_plain` at the kernel's key block
    (:func:`key_block`)."""
    *lead, sq, d = q.shape
    sk = k.shape[-2]
    if _cuda.on_cpu(q):
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    _check_kernel_inputs("flash_attention", q, k, v)
    scale = _scale(d, scale)
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
    lib = _cuda.launcher("flash_attention")
    with torch.cuda.device(q.device):
        err = lib.nnstpu_flash_attention(
            q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), out.data_ptr(), bh,
            sq, sk, d, _cuda.DTYPE_CODES[q.dtype], float(scale),
            int(bool(causal)), _cuda.stream_handle(q))
    _cuda.check(err, "flash_attention")
    _cuda.count_launch("flash_attention")
    _cuda.bill_launch("flash_attention", flash_attention_plain, q, k, v,
                      causal=causal, scale=scale)
    return out.reshape(q.shape)


def flash_chunk_cuda(q, k, v, m, l, acc, *, q_offset: int, k_offset: int,
                     causal: bool = False, scale: Optional[float] = None):
    """One chunk update through the hand-written CUDA kernel. Updates the
    carries IN PLACE and returns them: a caller that compares carries
    clones them first. Above :data:`SLICE_COLS` every CTA of a q tile
    reads the old m and l, so the kernel writes the new ones to scratch
    allocated here, and the library copies them over the carries after
    the kernel, in stream order.

    q: (bh, sq, d); k, v: (bh, sk, d), bf16 or float32, any d from 1 up,
    any sq and sk; m, l: (bh, sq) and acc: (bh, sq, d), float32,
    contiguous and 16-byte aligned. A CPU tensor runs
    :func:`flash_chunk_plain` at the kernel's key block (:func:`key_block`)
    and copies its result into the carries."""
    bh, sq, d = q.shape
    sk = k.shape[-2]
    if _cuda.on_cpu(q):
        new = flash_chunk_plain(q, k, v, m, l, acc, q_offset=q_offset,
                                k_offset=k_offset, causal=causal,
                                scale=_scale(d, scale))
        for carry, value in zip((m, l, acc), new):
            if value is not carry:
                carry.copy_(value)
        return m, l, acc
    _check_kernel_inputs("flash_chunk", q, k, v)
    scale = _scale(d, scale)
    _cuda.require(k.shape == v.shape and k.shape[0] == bh and k.shape[-1] == d
                  and m.shape == l.shape == (bh, sq)
                  and acc.shape == q.shape,
                  f"flash_chunk shapes disagree: q {tuple(q.shape)}, "
                  f"k {tuple(k.shape)}, v {tuple(v.shape)}, m "
                  f"{tuple(m.shape)}, l {tuple(l.shape)}, acc "
                  f"{tuple(acc.shape)}")
    _cuda.require(all(c.dtype == torch.float32 and c.is_contiguous()
                      and c.data_ptr() % 16 == 0 for c in (m, l, acc)),
                  "flash_chunk updates its carries in place: m, l, acc must "
                  "be float32, contiguous and 16-byte aligned")
    _cuda.require(all(t.device == q.device for t in (k, v, m, l, acc)),
                  "flash_chunk: tensors on different devices")
    _cuda.require(max(abs(q_offset), abs(k_offset)) < 2 ** 30,
                  f"flash_chunk offsets out of range: {q_offset}, {k_offset}")
    if bh == 0 or sq == 0 or sk == 0:
        return m, l, acc
    q, k, v = (_aligned(t) for t in (q, k, v))
    ml = (torch.empty((2, bh, sq), dtype=torch.float32, device=q.device)
          if head_dim_slices(d) > 1 else None)
    lib = _cuda.launcher("flash_chunk")
    with torch.cuda.device(q.device):
        err = lib.nnstpu_flash_chunk(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(),
            l.data_ptr(), acc.data_ptr(),
            0 if ml is None else ml.data_ptr(), bh, sq, sk, d,
            _cuda.DTYPE_CODES[q.dtype], int(q_offset), int(k_offset),
            float(scale), int(bool(causal)), _cuda.stream_handle(q))
    _cuda.check(err, "flash_chunk")
    _cuda.count_launch("flash_chunk")
    _cuda.bill_launch("flash_chunk", flash_chunk_plain, q, k, v, m, l, acc,
                      q_offset=q_offset, k_offset=k_offset, causal=causal,
                      scale=scale)
    return m, l, acc


def flash_kernel_attributes(d: int, carry: bool = False,
                            dtype: torch.dtype = torch.bfloat16) -> dict:
    """What the instantiation that head_dim ``d`` in ``dtype`` reaches (the
    chunk kernel's with ``carry``) asks of the current CUDA device:
    registers per thread at launch (the tensor-core bodies' warpgroups
    then trade them with ``setmaxnreg``), dynamic shared memory and
    resident CTAs per SM, with the body, its D (:func:`kernel_instance`)
    and its key block (:func:`key_block`)."""
    body, D = kernel_instance(d, dtype)
    block = key_block(d, dtype)
    out = (ctypes.c_int * 6)()
    _cuda.check(_cuda.lib().nnstpu_flash_attributes(
        d, int(bool(carry)), _cuda.DTYPE_CODES[dtype], out),
        "flash_kernel_attributes")
    bodies = {0: "simple", 1: "tensor_core", 2: "simple_split",
              3: "tensor_core_split"}
    if bodies.get(out[3]) != body or out[4] != D or out[5] != block:
        raise RuntimeError(f"the library runs head_dim {d} {dtype} on "
                           f"body {out[3]} at D {out[4]} with {out[5]}-key "
                           f"tiles, not {body} {D} with {block}")
    return {"registers": out[0], "dynamic_smem_bytes": out[1],
            "ctas_per_sm": out[2], "body": body, "instance_d": D,
            "key_block": block}


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, on a 16-byte boundary (the TMA maps' base address)."""
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


# -- sequence parallelism over a mesh axis ---------------------------------

def _shard(x: torch.Tensor, devices, dim: int):
    """Split ``x`` evenly along ``dim``, one contiguous piece per device."""
    return [c.contiguous().to(dev)
            for c, dev in zip(x.tensor_split(len(devices), dim), devices)]


def _ring(q, k, v, mesh, axis_name: str, causal: bool,
          scale: Optional[float], update):
    devices = mesh.axis_devices(axis_name)
    n = len(devices)
    *lead, s, d = q.shape
    s_kv = k.shape[-2]
    if s % n or s_kv % n:
        raise ValueError(
            f"sequence lengths {s} (q) and {s_kv} (k, v) must divide over "
            f"the {axis_name} axis ({n} devices)")
    sq, sk = s // n, s_kv // n
    scale = _scale(d, scale)
    qs = _shard(q.reshape(-1, s, d), devices, 1)
    kc = _shard(k.reshape(-1, s_kv, d), devices, 1)
    vc = _shard(v.reshape(-1, s_kv, d), devices, 1)
    carries = [_fresh_carries(qs[0].shape[0], sq, d, dev) for dev in devices]
    # n is the mesh size: an unrolled loop, the rotation skipped after the
    # last hop, as in the reference
    for step in range(n):
        for idx in range(n):
            # the K/V chunk shard idx holds came from shard (idx - step) % n
            src = (idx - step) % n
            carries[idx] = update(
                qs[idx], kc[idx], vc[idx], *carries[idx], q_offset=idx * sq,
                k_offset=src * sk, causal=causal, scale=scale)
        if step < n - 1:
            # rotate: the chunk on shard i moves to shard i + 1
            kc = [kc[i - 1].to(devices[i]) for i in range(n)]
            vc = [vc[i - 1].to(devices[i]) for i in range(n)]
    out = torch.cat([_normalize(l, acc, q.dtype).to(q.device)
                     for _, l, acc in carries], dim=1)
    return out.reshape(*lead, s, d)


def ring_attention(q, k, v, mesh, axis_name: str = "sp", *,
                   causal: bool = False, scale: Optional[float] = None):
    """Sequence-parallel attention: the sequence dim of q, k, v (``(...,
    seq, head_dim)``) split over the devices of ``mesh``'s ``axis_name``.
    Each shard keeps its q and fresh (m, l, acc) carries; at each of the n
    hops every shard folds the K/V chunk it holds into its carries through
    :func:`flash_chunk_cuda` (the kernel on a CUDA shard, never a plain
    path), then the chunks move one shard on. Normalised once, gathered
    onto q's device. Raises when a sequence length does not divide."""
    return _ring(q, k, v, mesh, axis_name, causal, scale, flash_chunk_cuda)


def ring_attention_plain(q, k, v, mesh, axis_name: str = "sp", *,
                         causal: bool = False, scale: Optional[float] = None,
                         block_k: Optional[int] = None):
    """:func:`ring_attention` with every hop through
    :func:`flash_chunk_plain` at ``block_k`` (default: the chunk kernel's
    own): the plain version of the whole ring."""
    def update(*args, **kw):
        return flash_chunk_plain(*args, block_k=block_k, **kw)

    return _ring(q, k, v, mesh, axis_name, causal, scale, update)


def _all_to_all(shards, devices, split_dim: int, cat_dim: int):
    """The tiled ``lax.all_to_all`` over one process's shards: shard j of
    the result concatenates along ``cat_dim``, in source order, piece j of
    every source shard split evenly along ``split_dim``."""
    n = len(devices)
    pieces = [t.tensor_split(n, split_dim) for t in shards]
    return [torch.cat([pieces[i][j].to(devices[j]) for i in range(n)],
                      dim=cat_dim) for j in range(n)]


def ulysses_attention(q, k, v, mesh, axis_name: str = "sp", *,
                      causal: bool = False, scale: Optional[float] = None,
                      block_size: int = 512):
    """All-to-all sequence-parallel attention (Ulysses style).

    q/k/v: (batch, heads, seq, head_dim), the sequence split over the
    devices of ``mesh``'s ``axis_name``; ``heads`` must divide by the axis
    size. One all-to-all of the stacked q/k/v scatters heads and gathers
    the sequence, each shard attends its head slice over the FULL sequence
    through :func:`flash_attention_auto` (the kernel on CUDA, one launch
    per shard), and a second all-to-all restores sequence sharding."""
    if q.ndim != 4:
        raise ValueError(
            f"ulysses_attention wants (batch, heads, seq, head_dim), "
            f"got rank {q.ndim}"
        )
    devices = mesh.axis_devices(axis_name)
    n = len(devices)
    if q.shape[1] % n:
        raise ValueError(
            f"heads ({q.shape[1]}) must divide over the {axis_name} axis "
            f"({n} devices) — use ring_attention otherwise"
        )
    if q.shape[2] % n:
        raise ValueError(f"sequence length {q.shape[2]} must divide over "
                         f"the {axis_name} axis ({n} devices)")
    # (3, b, H, s/n, d) per shard → (3, b, H/n, s, d): one collective
    stacked = _all_to_all(_shard(torch.stack([q, k, v]), devices, 3),
                          devices, 2, 3)
    outs = [flash_attention_auto(t[0], t[1], t[2], causal=causal,
                                 scale=scale, block_size=block_size)
            for t in stacked]
    # (b, H/n, s, d) → (b, H, s/n, d), then gathered onto q's device
    outs = _all_to_all(outs, devices, 2, 1)
    return torch.cat([o.to(q.device) for o in outs], dim=2)
