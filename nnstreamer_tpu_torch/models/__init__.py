"""Model zoo for the torch/CUDA filter backend (counterpart of the JAX
package's ``models/__init__.py``).

A model is an ``nn.Module`` whose weights are placed on the device once,
when the bundle is built, plus an ``apply_fn(*inputs) -> output`` the
filter calls per buffer. The zoo registers builders by name so pipelines
can say ``tensor_filter framework=jax model=mobilenet_v2`` (the JAX
package's launch lines run unchanged). Weights come from
``custom=params:<file>.npz`` (a saved state dict, e.g. carried across from
the JAX package by :mod:`models.convert`) or are made from
``custom=seed:<n>`` with numpy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from nnstreamer_tpu_torch.types import TensorsInfo

_zoo: Dict[str, Callable[..., "ModelBundle"]] = {}


@dataclass
class ModelBundle:
    """Everything the filter backend needs to run a model."""

    apply_fn: Callable  # apply_fn(*inputs) -> output tensor or tuple
    module: torch.nn.Module  # weights, already on the bundle's device
    input_info: Optional[TensorsInfo] = None
    output_info: Optional[TensorsInfo] = None
    #: output info for a proposed input info (the counterpart of the JAX
    #: backend's jax.eval_shape probe) — computed from shapes, no launch
    infer_output: Optional[Callable[[TensorsInfo], TensorsInfo]] = None


def register_model(name: str):
    """Decorator: register ``builder(custom: dict, device) -> ModelBundle``."""

    def deco(builder):
        _zoo[name.lower()] = builder
        return builder

    return deco


def _load_builtins() -> None:
    import importlib

    for mod in ("mobilenet_v2", "ssd_mobilenet", "deeplab_v3", "posenet",
                "yolov8", "vit", "simple"):
        importlib.import_module(f"nnstreamer_tpu_torch.models.{mod}")


def load_or_init(module: torch.nn.Module, custom: Dict[str, str],
                 init_fn: Callable[[torch.nn.Module, int], None]) -> None:
    """Shared builder plumbing: weights from a saved state dict
    (``custom=params:<file>.npz``, one array per state-dict key) or
    deterministic numpy init from ``custom=seed:<n>``."""
    params_path = custom.get("params")
    if params_path:
        with np.load(params_path) as z:
            state = {k: torch.from_numpy(np.array(z[k])) for k in z.files}
        module.load_state_dict(state)
    else:
        init_fn(module, int(custom.get("seed", 0)))


def init_conv_bn(module: torch.nn.Module, seed: int) -> None:
    """Deterministic weights from ``np.random.default_rng(seed)`` for a
    model of convolutions and BatchNorms, module by module in registration
    order: He-normal conv kernels (fan-in over the conv's group), conv
    biases N(0, 0.1), BatchNorm scale, bias and running statistics that
    are not the identity (as MobileNet-v2's ``init_weights``). A model
    sets its heads' biases afterwards where it wants a prior.

    Like every ``seed:`` init of this package it does NOT reproduce the
    JAX package's flax init: carry flax variables across with
    :mod:`models.convert` to run both packages on the same weights."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.Conv2d):
                shape = tuple(m.weight.shape)
                fan_in = int(np.prod(shape[1:]))
                m.weight.copy_(torch.from_numpy(rng.normal(
                    0.0, np.sqrt(2.0 / fan_in), shape).astype(np.float32)))
                if m.bias is not None:
                    m.bias.copy_(torch.from_numpy(rng.normal(
                        0.0, 0.1, m.bias.shape).astype(np.float32)))
            elif isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                for t, a in ((m.weight, rng.uniform(0.8, 1.2, n)),
                             (m.bias, rng.normal(0.0, 0.1, n)),
                             (m.running_mean, rng.normal(0.0, 0.1, n)),
                             (m.running_var, rng.uniform(0.8, 1.2, n))):
                    t.copy_(torch.from_numpy(a.astype(np.float32)))


def batch_of(info: TensorsInfo) -> int:
    """The batch of frames a model's input info carries: the leading dim
    of an [B, H, W, C] tensor, 1 for one [H, W, C] frame."""
    shape = info.tensors[0].np_shape()
    return shape[0] if len(shape) == 4 else 1


def preprocess_frames(x: torch.Tensor, scale: str = "pm1",
                      compute_dtype: torch.dtype = torch.bfloat16
                      ) -> torch.Tensor:
    """Shared frame preprocessing: uint8 normalization (``scale``: 'pm1' →
    [-1, 1); 'unit' → [0, 1)) and batch-dim fixup.

    A uint8 CUDA tensor goes through the ``normalize_u8`` kernel, which
    writes the compute dtype directly; a CPU tensor computes the JAX
    package's expression as written, in float32."""
    if x.dtype == torch.uint8:
        if x.is_cuda:
            from nnstreamer_tpu_torch.ops.preprocess import normalize_u8

            scale_v, offset = ((1.0 / 127.5, -1.0) if scale == "pm1"
                               else (1.0 / 255.0, 0.0))
            x = normalize_u8(x, scale=scale_v, offset=offset,
                             out_dtype=compute_dtype)
        else:
            x = (x.to(torch.float32) / 127.5 - 1.0 if scale == "pm1"
                 else x.to(torch.float32) / 255.0)
    if x.dim() == 3:
        x = x[None]
    return x


def resolve_fused_apply(custom: Dict[str, str], model, make_fused,
                        scale: str = "pm1"):
    """Shared ``custom=fused:pallas|xla`` wiring: ``pallas`` runs the
    BN-folded forward through the package's CUDA kernels (``make_fused``
    mode 'kernel'), ``xla`` the same folded forward as the JAX package's
    ``fused:xla`` computes it, outside any kernel (mode 'xla'). BN folds
    once, here (at open).
    Returns None when the custom key is absent."""
    fused = custom.get("fused")
    if fused is None:
        return None
    if fused not in ("pallas", "xla"):
        raise ValueError(f"unknown fused mode {fused!r} (use fused:pallas "
                         "or fused:xla)")
    raw = make_fused(model, mode="kernel" if fused == "pallas" else "xla")

    def apply_fn(x):
        return raw(preprocess_frames(x, scale, model.dtype))

    return apply_fn


def get_model(name: str, custom: Optional[Dict[str, str]] = None,
              device="cuda") -> ModelBundle:
    name = name.lower()
    if name not in _zoo:
        _load_builtins()
    if name not in _zoo:
        raise ValueError(f"unknown model {name!r}; zoo: {sorted(_zoo)}")
    return _zoo[name](custom or {}, torch.device(device))

