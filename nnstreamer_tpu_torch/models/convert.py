"""Carry the JAX package's flax weights across to this package's modules.

:func:`from_jax_variables` maps flax variables (``{"params": ...}`` and,
for MobileNet-v2, ``"batch_stats"``, as nested dicts of numpy arrays) onto
the state dict of :class:`models.mobilenet_v2.MobileNetV2`, of one
:class:`models.mobilenet_v2.InvertedResidual`, or of
:class:`models.vit.ViT` / :class:`models.vit.StreamTransformer`. The tree
says which: ``InvertedResidual_0`` is MobileNet-v2, ``_Block_0`` a
transformer (ViT when it has the patchify ``Conv_0``). Rules, from the
module names flax creates:

  - conv kernels HWIO → OIHW (the depthwise ``(3,3,1,Ch)`` → ``(Ch,1,3,3)``
    by the same transpose);
  - the Dense kernel ``(in, out)`` → ``(out, in)``;
  - BatchNorm scale/bias/mean/var come over as they are (eps 1e-5 on both
    sides, as in ``fold_conv_bn``); LayerNorm scale/bias likewise;
  - a transformer block's ``LayerNorm_0, qkv, proj, LayerNorm_1, Dense_0,
    Dense_1`` become ``ln1, qkv, proj, ln2, fc1, fc2``; the top-level
    ``LayerNorm_0`` is ``norm``; ViT's ``Dense_0`` is ``head``, the stream
    transformer's ``Dense_0``/``Dense_1`` are ``embed``/``head``; ``cls``
    and ``pos`` come over as they are.

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


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def _bn(out: Dict[str, torch.Tensor], prefix: str, params: Mapping,
        stats: Mapping) -> None:
    out[f"{prefix}.weight"] = _t(params["scale"])
    out[f"{prefix}.bias"] = _t(params["bias"])
    out[f"{prefix}.running_mean"] = _t(stats["mean"])
    out[f"{prefix}.running_var"] = _t(stats["var"])
    out[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def _dense(out: Dict[str, torch.Tensor], prefix: str, p: Mapping) -> None:
    """flax Dense kernel (in, out) → torch Linear weight (out, in)."""
    out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"], np.float32).T)
    out[f"{prefix}.bias"] = _t(p["bias"])


def _ln(out: Dict[str, torch.Tensor], prefix: str, p: Mapping) -> None:
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])


def _transformer(params: Mapping) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    i = 0
    while f"_Block_{i}" in params:
        blk, pre = params[f"_Block_{i}"], f"blocks.{i}."
        _ln(out, pre + "ln1", blk["LayerNorm_0"])
        _dense(out, pre + "qkv", blk["qkv"])
        _dense(out, pre + "proj", blk["proj"])
        _ln(out, pre + "ln2", blk["LayerNorm_1"])
        _dense(out, pre + "fc1", blk["Dense_0"])
        _dense(out, pre + "fc2", blk["Dense_1"])
        i += 1
    _ln(out, "norm", params["LayerNorm_0"])
    out["pos"] = _t(params["pos"])
    if "Conv_0" in params:  # ViT
        out["patch_embed.weight"] = _conv(params["Conv_0"]["kernel"])
        out["patch_embed.bias"] = _t(params["Conv_0"]["bias"])
        out["cls"] = _t(params["cls"])
        _dense(out, "head", params["Dense_0"])
    else:  # StreamTransformer
        _dense(out, "embed", params["Dense_0"])
        _dense(out, "head", params["Dense_1"])
    return out


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
    """flax variables of a MobileNetV2 (has ``InvertedResidual_0``), a ViT
    or StreamTransformer (has ``_Block_0``) or of one InvertedResidual → a
    state dict for the matching module here."""
    params = variables["params"]
    if "_Block_0" in params:
        return _transformer(params)
    stats = variables["batch_stats"]
    out: Dict[str, torch.Tensor] = {}
    if "InvertedResidual_0" not in params:
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
    _dense(out, "classifier", params["Dense_0"])
    return out


def save_state_dict(state: Mapping[str, torch.Tensor], path: str) -> None:
    """Write a state dict as the ``.npz`` that ``custom=params:`` loads."""
    np.savez(path, **{k: v.detach().cpu().numpy() for k, v in state.items()})
