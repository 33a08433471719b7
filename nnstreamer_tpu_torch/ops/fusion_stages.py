"""Fused transform stages: the planner's spec tuples → one torch function,
and whole-chain stage lists → one list→list function (counterpart of the
JAX package's ``ops/fusion_stages.py``: ``build_stage_fn``,
``ModelStage`` and ``build_chain_fn``).

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

Chain fusion (:func:`build_chain_fn`) composes a downstream filter's
whole model after the head's program: a ``("model", ModelStage)`` stage
calls the tail backend's ``chain_callable`` on the tensor list, and a
``("stages", specs)`` run between two members goes through
:func:`build_stage_fn`, so a gap transform's arithmetic is the same
``arith_chain`` launch as a fused pre/post stage.

Parity contract (gates enforced by the planner, mirror of the transform's
device path): typecast, arith and clamp are bit-identical to the numpy
element; stand accumulates in float32 on the device against the host
path's float64 two-pass, so it is float-tolerance parity (about 1e-6
relative), as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

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


class ModelStage:
    """Whole-model composition stage (chain fusion): wraps a downstream
    tensor_filter's backend so the chain planner can splice model B onto
    model A's outputs inside the head's one program. Unlike the
    elementwise spec tuples above, a model stage maps the whole tensor
    LIST (a model may take several inputs and produce several outputs),
    so :func:`build_chain_fn` — not :func:`build_stage_fn` — builds it.

    The wrapped framework object is the identity: two stages are equal
    when they wrap the SAME open backend, which is what lets the
    planner's unchanged-plan check skip the rebuild on a PAUSED→PLAYING
    cycle. The callable resolves lazily (``chain_callable``) so a rebuild
    picks up the tail backend's current model, stages and postproc."""

    def __init__(self, name: str, fw, element=None):
        self.name = name
        self.fw = fw
        #: the owning tensor_filter element, when known: resolution
        #: prefers ITS current backend so a tail restarted between plans
        #: composes the live one, while equality stays pinned to the fw
        #: captured at plan time
        self.element = element

    def __repr__(self) -> str:
        return f"ModelStage({self.name!r})"

    def __eq__(self, other) -> bool:
        return isinstance(other, ModelStage) and other.fw is self.fw

    def __hash__(self) -> int:
        return id(self.fw)

    def backend(self):
        return getattr(self.element, "fw", None) or self.fw

    def resolve(self, meta: bool = False) -> Optional[Callable]:
        """The tail's per-invoke program as a list→list callable on its
        own weights, or with ``meta`` its rebuild on the ``meta`` device
        (the data-free composition check)."""
        fn = getattr(self.backend(), "chain_callable", None)
        return fn(meta=meta) if callable(fn) else None


def build_chain_fn(stages: Sequence[tuple],
                   meta: bool = False) -> Optional[Callable]:
    """Chain-fusion stage list → one list→list torch function, or None
    when any stage cannot be resolved (the planner then leaves the chain
    un-fused). ``stages`` alternate:

      ("stages", (<spec tuple>, ...))  — elementwise transform run
                                         (applied per tensor)
      ("model", ModelStage)            — a whole downstream model
                                         (applied to the tensor list)

    ``meta`` resolves every model stage on the ``meta`` device."""
    if not stages:
        return None
    resolved: List[Tuple[str, Callable]] = []
    for stage in stages:
        kind, payload = stage[0], stage[1]
        if kind == "stages":
            fn = build_stage_fn(payload)
            if fn is not None:
                resolved.append(("elem", fn))
        elif kind == "model":
            fn = payload.resolve(meta=meta)
            if fn is None:
                return None
            resolved.append(("model", fn))
        else:
            return None

    def chain_fn(outs):
        for kind, f in resolved:
            if kind == "elem":
                outs = [f(o) for o in outs]
            else:
                outs = f(outs)
        return outs

    return chain_fn
