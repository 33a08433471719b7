"""Fused transform stages: the planner's spec tuples → one torch function
(counterpart of the JAX package's ``ops/fusion_stages.py``,
``build_stage_fn``).

The fusion planner (pipeline/planner.py) reduces eligible
``tensor_transform`` elements to plain spec tuples; this module turns a
spec list into ONE callable the filter backend composes around its model
function, so the transform's math runs on the device after the upload and
the upload carries the transform's INPUT bytes (the flagship preamble
uploads uint8 frames, not float32).

  - ``("arith", ops)`` and ``("clamp", lo, hi)`` go through
    :func:`ops.transform_ops.arith_chain`: the hand-written CUDA kernel on a
    CUDA tensor (it launches or raises), its plain version on a CPU
    tensor. An arith stage followed by a clamp is one launch (the kernel
    clamps after the chain, in float32, keeping NaN as ``jnp.clip`` does).
    An arith stage's input of a type the kernel does not read (float64,
    float16, int64, uint32, bool, ...) is first converted to float32: the
    stage's grammar starts with ``typecast:float32``, so this is the same
    rounding as the element's ``astype(float32)``;
  - ``("typecast", dtype)`` is ``Tensor.to`` — the plain convert the JAX
    stage leaves to XLA, outside any Pallas kernel;
  - ``("stand", mode)`` is float32 ``mean`` and the population ``std``
    (``correction=0``, as ``jnp.std``) with ``max(std, 1e-10)``.

Parity contract (gates enforced by the planner, mirror of the transform's
device path): typecast, arith and clamp are bit-identical to the numpy
element; stand accumulates in float32 on the device against the host
path's float64 two-pass, so it is float-tolerance parity (about 1e-6
relative), as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from nnstreamer_tpu_torch.ops.transform_ops import IN_DTYPES


def _torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a numpy dtype name ('int32', 'float16', ...)."""
    return torch.from_numpy(np.zeros(0, np.dtype(name))).dtype


def build_stage_fn(specs: Sequence[tuple]) -> Optional[Callable]:
    """specs (planner tuples, upstream→downstream order) → one function
    applied per tensor, or None for an empty list."""
    if not specs:
        return None
    from nnstreamer_tpu_torch.ops.transform_ops import arith_chain

    steps = []
    specs = list(specs)
    i = 0
    while i < len(specs):
        spec = specs[i]
        kind = spec[0]
        if kind == "arith":
            clamp = None
            if i + 1 < len(specs) and specs[i + 1][0] == "clamp":
                i += 1
                clamp = (float(specs[i][1]), float(specs[i][2]))
            ops = [(op, float(v)) for op, v in spec[1]]
            steps.append(lambda x, ops=ops, clamp=clamp: arith_chain(
                kernel_input(x), ops, out_dtype=torch.float32, clamp=clamp))
        elif kind == "clamp":
            # the planner admits a clamp only on a float32 input
            lim = (float(spec[1]), float(spec[2]))
            steps.append(lambda x, lim=lim: arith_chain(
                x, [], out_dtype=torch.float32, clamp=lim))
        elif kind == "typecast":
            dt = _torch_dtype(spec[1])
            steps.append(lambda x, dt=dt: x.to(dt))
        elif kind == "stand":
            steps.append(lambda x, mode=spec[1]: _stand(x, mode))
        else:
            raise ValueError(f"unknown fused stage {kind!r}")
        i += 1

    def fn(x):
        for step in steps:
            x = step(x)
        return x

    return fn


def kernel_input(x: torch.Tensor) -> torch.Tensor:
    """x as the leading ``typecast:float32`` of an arith stage leaves it
    for :func:`arith_chain`: unchanged where the kernel reads its type,
    else converted to float32."""
    return x if x.dtype in IN_DTYPES else x.to(torch.float32)


def _stand(x: torch.Tensor, mode: str) -> torch.Tensor:
    y = x.to(torch.float32)
    mean = y.mean()
    if mode == "dc-average":
        return y - mean
    std = torch.clamp(y.std(correction=0), min=1e-10)
    return (y - mean) / std
