"""Fused uint8 → float normalization (counterpart of the JAX package's
``ops/preprocess.py``).

The canonical pipeline preamble — video bytes to model-ready floats — as
one pass: read uint8, convert, scale and offset, write the compute dtype.
On a CUDA tensor :func:`normalize_u8` launches the hand-written kernel in
``csrc/preprocess.cu``; on a CPU tensor it runs :func:`normalize_u8_plain`.
Unlike the Pallas kernel, the CUDA kernel takes every size (no
``size % 1024`` gate). Under ``torch.jit.trace`` a CUDA tensor reaches the
kernel through its TorchScript op (ops/_script_ops.py), which the trace
records.
"""

from __future__ import annotations

import torch

from nnstreamer_tpu_torch.ops import _cuda


def normalize_u8_plain(x: torch.Tensor, scale: float = 1.0 / 127.5,
                       offset: float = -1.0,
                       out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """y = float32(x) * scale + offset, rounded once to ``out_dtype``."""
    return (x.to(torch.float32) * scale + offset).to(out_dtype)


def normalize_u8(x: torch.Tensor, scale: float = 1.0 / 127.5,
                 offset: float = -1.0,
                 out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """y = x * scale + offset, uint8 in, float32 or bfloat16 out,
    shape-preserving. Defaults map [0,255] → [-1,1) (the MobileNet
    preamble)."""
    if _cuda.plain_route(x):
        return normalize_u8_plain(x, scale, offset, out_dtype)
    _cuda.require(x.dtype == torch.uint8,
                  f"normalize_u8 takes uint8, got {x.dtype}")
    _cuda.require(out_dtype in (torch.float32, torch.bfloat16),
                  f"normalize_u8 writes float32 or bfloat16, not {out_dtype}")
    x = x.contiguous()
    if torch.jit.is_tracing():  # a launch the trace records
        from nnstreamer_tpu_torch.ops import _script_ops

        return _script_ops.normalize_u8(x, scale, offset, out_dtype)
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    vec_ok = int(x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0)
    lib = _cuda.launcher("normalize_u8")
    with torch.cuda.device(x.device):
        err = lib.nnstpu_normalize_u8(
            x.data_ptr(), y.data_ptr(), x.numel(), float(scale),
            float(offset), _cuda.DTYPE_CODES[out_dtype], vec_ok,
            _cuda.stream_handle(x))
    _cuda.check(err, "normalize_u8")
    _cuda.count_launch("normalize_u8")
    _cuda.bill_launch("normalize_u8", normalize_u8_plain, x, scale, offset,
                      out_dtype)
    return y
