"""Carry the JAX package's flax weights across to this package's modules.

:func:`from_jax_variables` maps flax variables (``{"params": ...,
"batch_stats": ...}`` as nested dicts of numpy arrays) onto the state dict
of :class:`models.mobilenet_v2.MobileNetV2` or of one
:class:`models.mobilenet_v2.InvertedResidual`. Rules, from the module names
flax creates:

  - conv kernels HWIO → OIHW (the depthwise ``(3,3,1,Ch)`` → ``(Ch,1,3,3)``
    by the same transpose);
  - the Dense kernel ``(in, out)`` → ``(out, in)``;
  - BatchNorm scale/bias/mean/var come over as they are (eps 1e-5 on both
    sides, as in ``fold_conv_bn``).

Inside ``InvertedResidual_{i}`` flax numbers its layers in creation order,
and the JAX package folds them by ``sorted(keys)``: ``Conv_0..2`` are
expand, depthwise, project (``Conv_0..1`` = depthwise, project when
expand == 1), with the BatchNorms alike.

The machine that runs this package on the GPU has no JAX: conversion
happens where the JAX package runs (the CPU tests), and the result travels
as an ``.npz`` that ``custom=params:<file>.npz`` loads
(:func:`save_state_dict`).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _conv(kernel) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(kernel, np.float32).transpose(3, 2, 0, 1)))


def _bn(out: Dict[str, torch.Tensor], prefix: str, params: Mapping,
        stats: Mapping) -> None:
    def t(v):
        return torch.from_numpy(np.array(v, np.float32))

    out[f"{prefix}.weight"] = t(params["scale"])
    out[f"{prefix}.bias"] = t(params["bias"])
    out[f"{prefix}.running_mean"] = t(stats["mean"])
    out[f"{prefix}.running_var"] = t(stats["var"])
    out[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def _block(out: Dict[str, torch.Tensor], prefix: str, params: Mapping,
           stats: Mapping) -> None:
    names = sorted(params.keys())
    convs = [n for n in names if n.startswith("Conv")]
    bns = [n for n in names if n.startswith("BatchNorm")]
    roles = (["expand", "dw", "proj"] if len(convs) == 3 else ["dw", "proj"])
    for role, cname, bname in zip(roles, convs, bns):
        out[f"{prefix}{role}_conv.weight"] = _conv(params[cname]["kernel"])
        _bn(out, f"{prefix}{role}_bn", params[bname], stats[bname])


def from_jax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax variables of a MobileNetV2 (has ``Dense_0``) or of one
    InvertedResidual → a state dict for the matching module here."""
    params, stats = variables["params"], variables["batch_stats"]
    out: Dict[str, torch.Tensor] = {}
    if "Dense_0" not in params:
        _block(out, "", params, stats)
        return out
    out["stem_conv.weight"] = _conv(params["Conv_0"]["kernel"])
    _bn(out, "stem_bn", params["BatchNorm_0"], stats["BatchNorm_0"])
    i = 0
    while f"InvertedResidual_{i}" in params:
        name = f"InvertedResidual_{i}"
        _block(out, f"blocks.{i}.", params[name], stats[name])
        i += 1
    out["head_conv.weight"] = _conv(params["Conv_1"]["kernel"])
    _bn(out, "head_bn", params["BatchNorm_1"], stats["BatchNorm_1"])
    dense = params["Dense_0"]
    out["classifier.weight"] = torch.from_numpy(
        np.ascontiguousarray(np.asarray(dense["kernel"], np.float32).T))
    out["classifier.bias"] = torch.from_numpy(
        np.array(dense["bias"], np.float32))
    return out


def save_state_dict(state: Mapping[str, torch.Tensor], path: str) -> None:
    """Write a state dict as the ``.npz`` that ``custom=params:`` loads."""
    np.savez(path, **{k: v.detach().cpu().numpy() for k, v in state.items()})
