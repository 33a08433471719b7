"""tensor_transform arithmetic chains as one pass (counterpart of the JAX
package's ``ops/transform_ops.py``).

The reference's tensor_transform applies its op chain with per-op ORC SIMD
loops over CPU buffers (gsttensor_transform.c arithmetic grammar
'[typecast:T,]add:V,mul:V,...'). Here the whole chain — typecast, any
sequence of add/mul/div, optional clamp — runs in one read and one write.
On a CUDA tensor :func:`arith_chain` launches the hand-written kernel in
``csrc/transform_ops.cu``; on a CPU tensor it runs :func:`arith_chain_plain`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from nnstreamer_tpu_torch.ops import _cuda

Op = Tuple[str, float]  # ("add"|"mul"|"div", value)

_OPCODES = {"add": 0, "mul": 1, "div": 2}
#: the kernel's op-list capacity (csrc/transform_ops.cu kMaxOps)
MAX_OPS = 16
IN_DTYPES = (torch.uint8, torch.int8, torch.uint16, torch.int16,
              torch.int32, torch.float32)
_OUT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _check_ops(ops: Sequence[Op]):
    for kind, _ in ops:
        if kind not in _OPCODES:
            raise ValueError(f"unknown arithmetic op {kind!r}")


def _apply_chain(x: torch.Tensor, ops: Sequence[Op],
                 clamp: Optional[Tuple[float, float]]) -> torch.Tensor:
    """The chain on a float32 tensor, one float32 rounding per op. Each
    value is a 0-d float32 tensor so every op is tensor-tensor float32
    arithmetic (no scalar fast path may rewrite a division)."""
    _check_ops(ops)
    for kind, v in ops:
        t = torch.tensor(v, dtype=torch.float32, device=x.device)
        if kind == "add":
            x = x + t
        elif kind == "mul":
            x = x * t
        else:
            x = x / t
    if clamp is not None:
        lo = torch.tensor(clamp[0], dtype=torch.float32, device=x.device)
        hi = torch.tensor(clamp[1], dtype=torch.float32, device=x.device)
        x = torch.minimum(torch.maximum(x, lo), hi)
    return x


def arith_chain_plain(x: torch.Tensor, ops: Sequence[Op],
                      out_dtype: Optional[torch.dtype] = None,
                      clamp: Optional[Tuple[float, float]] = None
                      ) -> torch.Tensor:
    """Typecast to float32, the chain, optional clamp, cast to out_dtype
    (default: x.dtype)."""
    out_dtype = out_dtype or x.dtype
    return _apply_chain(x.to(torch.float32), ops, clamp).to(out_dtype)


def arith_chain(x: torch.Tensor, ops: Sequence[Op],
                out_dtype: Optional[torch.dtype] = None,
                clamp: Optional[Tuple[float, float]] = None) -> torch.Tensor:
    """Apply an arithmetic chain elementwise in float32; returns out_dtype
    (default: x.dtype). Accumulates in float32, which bit-matches numpy's
    float32 path for the chains tensor_transform routes here."""
    out_dtype = out_dtype or x.dtype
    if _cuda.plain_route(x):
        return arith_chain_plain(x, ops, out_dtype, clamp)
    _check_ops(ops)
    _cuda.require(len(ops) <= MAX_OPS,
                  f"arith_chain takes at most {MAX_OPS} ops, got {len(ops)}")
    _cuda.require(x.dtype in IN_DTYPES,
                  f"arith_chain does not read {x.dtype}")
    _cuda.require(out_dtype in _OUT_DTYPES,
                  f"arith_chain does not write {out_dtype}")
    x = x.contiguous()
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    codes = (ctypes.c_int * MAX_OPS)(*[_OPCODES[k] for k, _ in ops])
    vals = (ctypes.c_float * MAX_OPS)(*[float(v) for _, v in ops])
    lo, hi = clamp if clamp is not None else (0.0, 0.0)
    vec_ok = int(x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0)
    lib = _cuda.launcher("arith_chain")
    with torch.cuda.device(x.device):
        err = lib.nnstpu_arith_chain(
            x.data_ptr(), y.data_ptr(), x.numel(),
            _cuda.DTYPE_CODES[x.dtype], _cuda.DTYPE_CODES[out_dtype],
            ctypes.addressof(codes), ctypes.addressof(vals), len(ops),
            int(clamp is not None), float(lo), float(hi), vec_ok,
            _cuda.stream_handle(x))
    _cuda.check(err, "arith_chain")
    _cuda.count_launch("arith_chain")
    _cuda.bill_launch("arith_chain", arith_chain_plain, x, ops, out_dtype,
                      clamp)
    return y
