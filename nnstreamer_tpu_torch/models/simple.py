"""Tiny test models — parity with the reference's vendored test fixtures
(tests/test_models/models/add.tflite, passthrough custom filters in
tests/nnstreamer_example); counterpart of the JAX package's
``models/simple.py``. Each takes any input shape: the output info is the
input's (``matmul``: the last dim becomes ``dim``, float32)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from nnstreamer_tpu_torch.models import ModelBundle, load_or_init, register_model
from nnstreamer_tpu_torch.types import TensorInfo, TensorsInfo


def _same_info(info: TensorsInfo) -> TensorsInfo:
    return info


def _bundle(apply_fn, module=None, infer_output=_same_info) -> ModelBundle:
    return ModelBundle(apply_fn=apply_fn, module=module or torch.nn.Module(),
                       infer_output=infer_output)


@register_model("add")
def build_add(custom: Dict[str, str], device) -> ModelBundle:
    """y = x + k (add.tflite parity; k via custom=k:<v>, default 2), in
    the input's dtype."""
    k = float(custom.get("k", 2.0))

    def apply_fn(x):
        # a fill on the device, not a host copy: capturable in a CUDA graph
        return x + torch.full((), k, dtype=x.dtype, device=x.device)

    return _bundle(apply_fn)


@register_model("passthrough")
def build_passthrough(custom: Dict[str, str], device) -> ModelBundle:
    def apply_fn(*xs):
        return xs if len(xs) > 1 else xs[0]

    return _bundle(apply_fn)


@register_model("scaler")
def build_scaler(custom: Dict[str, str], device) -> ModelBundle:
    """y = x * scale in float32, cast back to the input's dtype (scaler
    custom-filter parity)."""
    s = float(custom.get("scale", 2.0))

    def apply_fn(x):
        return (x.to(torch.float32) * s).to(x.dtype)

    return _bundle(apply_fn)


class _MatMul(torch.nn.Module):
    def __init__(self, n: int):
        super().__init__()
        self.register_buffer("w", torch.zeros((n, n), dtype=torch.float32))


@register_model("matmul")
def build_matmul(custom: Dict[str, str], device) -> ModelBundle:
    """y = x @ W in bf16, float32 out — a tensor-core micro model for perf
    sanity (custom=dim:<n>). W is (n, n) standard normal from numpy with
    ``custom=seed:<s>`` (the JAX package draws it from PRNGKey(0), so the
    two packages' W differ)."""
    n = int(custom.get("dim", 512))

    def init(m: _MatMul, seed: int) -> None:
        rng = np.random.default_rng(seed)
        m.w.copy_(torch.from_numpy(
            rng.standard_normal((n, n)).astype(np.float32)))

    module = _MatMul(n)
    load_or_init(module, custom, init)
    module = module.to(device=device, dtype=torch.bfloat16)

    def apply_fn(x):
        return (x.to(torch.bfloat16) @ module.w).to(torch.float32)

    def infer(info: TensorsInfo) -> TensorsInfo:
        shape = info.tensors[0].np_shape()[:-1] + (n,)
        return TensorsInfo(tensors=[TensorInfo.from_np_shape(shape,
                                                             "float32")])

    return _bundle(apply_fn, module, infer)
