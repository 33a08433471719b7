"""Carry the JAX package's flax weights across to this package's modules.

:func:`from_jax_variables` maps flax variables (``{"params": ...}`` and,
for the conv/BN models, ``"batch_stats"``, as nested dicts of numpy
arrays) onto the state dict of a zoo module here: MobileNet-v2,
SSD-MobileNet-v2, DeepLab-v3, PoseNet, YOLOv8, ViT or StreamTransformer,
or one :class:`models.mobilenet_v2.InvertedResidual`. The caller may name
the model (``model="deeplab_v3"``); otherwise the tree says which:
``_ExtraBlock_0`` is SSD, ``ASPP_0`` DeepLab, ``SeparableConv_0`` PoseNet,
``C2f_0`` YOLOv8, ``InvertedResidual_0`` alone MobileNet-v2, ``_Block_0``
a transformer (ViT when it has the patchify ``Conv_0``). Rules, from the
module names flax creates:

  - conv kernels HWIO → OIHW (the depthwise ``(3,3,1,Ch)`` → ``(Ch,1,3,3)``
    by the same transpose); a biased conv's bias comes over as it is;
  - the Dense kernel ``(in, out)`` → ``(out, in)``;
  - BatchNorm scale/bias/mean/var come over as they are (eps 1e-5 on both
    sides, as in ``fold_conv_bn``); LayerNorm scale/bias likewise;
  - a transformer block's ``LayerNorm_0, qkv, proj, LayerNorm_1, Dense_0,
    Dense_1`` become ``ln1, qkv, proj, ln2, fc1, fc2``; the top-level
    ``LayerNorm_0`` is ``norm``; ViT's ``Dense_0`` is ``head``, the stream
    transformer's ``Dense_0``/``Dense_1`` are ``embed``/``head``; ``cls``
    and ``pos`` come over as they are;
  - the top-level ``Conv_1`` is MobileNet-v2's and SSD's BN'd 1x1 head,
    but DeepLab's biased class conv; each model's function below names
    the rest.

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

from typing import Dict, Mapping, Optional

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


def _conv_bn_pair(out: Dict[str, torch.Tensor], prefix: str, params: Mapping,
                  stats: Mapping, conv: str, bn: str, conv_name: str = "conv",
                  bn_name: str = "bn") -> None:
    out[f"{prefix}{conv_name}.weight"] = _conv(params[conv]["kernel"])
    _bn(out, f"{prefix}{bn_name}", params[bn], stats[bn])


def _biased_conv(out: Dict[str, torch.Tensor], prefix: str,
                 p: Mapping) -> None:
    out[f"{prefix}.weight"] = _conv(p["kernel"])
    out[f"{prefix}.bias"] = _t(p["bias"])


def _mobilenet_body(out: Dict[str, torch.Tensor], params: Mapping,
                    stats: Mapping) -> None:
    """The stem ``Conv_0``/``BatchNorm_0`` and the ``InvertedResidual_{i}``
    blocks, shared by MobileNet-v2, SSD and DeepLab."""
    _conv_bn_pair(out, "", params, stats, "Conv_0", "BatchNorm_0",
                  "stem_conv", "stem_bn")
    i = 0
    while f"InvertedResidual_{i}" in params:
        name = f"InvertedResidual_{i}"
        _block(out, f"blocks.{i}.", params[name], stats[name])
        i += 1


def _mobilenet_v2(params: Mapping, stats: Mapping) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    _mobilenet_body(out, params, stats)
    _conv_bn_pair(out, "", params, stats, "Conv_1", "BatchNorm_1",
                  "head_conv", "head_bn")
    _dense(out, "classifier", params["Dense_0"])
    return out


def _ssd(params: Mapping, stats: Mapping) -> Dict[str, torch.Tensor]:
    """SSD: the MobileNet-v2 body and its BN'd ``Conv_1`` head, the
    ``_ExtraBlock_{e}`` (``Conv_0..1``/``BatchNorm_0..1``: reduce, expand)
    and the biased ``box_head_{i}``/``cls_head_{i}``."""
    out: Dict[str, torch.Tensor] = {}
    _mobilenet_body(out, params, stats)
    _conv_bn_pair(out, "", params, stats, "Conv_1", "BatchNorm_1",
                  "head_conv", "head_bn")
    e = 0
    while f"_ExtraBlock_{e}" in params:
        name = f"_ExtraBlock_{e}"
        for j, role in enumerate(("reduce", "expand")):
            _conv_bn_pair(out, f"extras.{e}.", params[name], stats[name],
                          f"Conv_{j}", f"BatchNorm_{j}", f"{role}_conv",
                          f"{role}_bn")
        e += 1
    i = 0
    while f"box_head_{i}" in params:
        _biased_conv(out, f"box_heads.{i}", params[f"box_head_{i}"])
        _biased_conv(out, f"cls_heads.{i}", params[f"cls_head_{i}"])
        i += 1
    return out


def _deeplab(params: Mapping, stats: Mapping) -> Dict[str, torch.Tensor]:
    """DeepLab: the MobileNet-v2 body, ``ASPP_0`` (``Conv_0..3`` the 1x1
    and dilated branches, ``Conv_4`` the image pooling, ``Conv_5`` the
    projection, each with its BatchNorm) and the top-level biased class
    conv ``Conv_1``."""
    out: Dict[str, torch.Tensor] = {}
    _mobilenet_body(out, params, stats)
    ap, ast = params["ASPP_0"], stats["ASPP_0"]
    for j in range(4):
        _conv_bn_pair(out, "aspp.", ap, ast, f"Conv_{j}", f"BatchNorm_{j}",
                      f"branches.{j}", f"branch_bns.{j}")
    _conv_bn_pair(out, "aspp.", ap, ast, "Conv_4", "BatchNorm_4",
                  "pool_conv", "pool_bn")
    _conv_bn_pair(out, "aspp.", ap, ast, "Conv_5", "BatchNorm_5",
                  "project_conv", "project_bn")
    _biased_conv(out, "classifier", params["Conv_1"])
    return out


def _posenet(params: Mapping, stats: Mapping) -> Dict[str, torch.Tensor]:
    """PoseNet: the stem, ``SeparableConv_{i}`` (``Conv_0`` depthwise,
    ``Conv_1`` pointwise) and the biased heads."""
    out: Dict[str, torch.Tensor] = {}
    _conv_bn_pair(out, "", params, stats, "Conv_0", "BatchNorm_0",
                  "stem_conv", "stem_bn")
    i = 0
    while f"SeparableConv_{i}" in params:
        name = f"SeparableConv_{i}"
        for j, role in enumerate(("dw", "pw")):
            _conv_bn_pair(out, f"blocks.{i}.", params[name], stats[name],
                          f"Conv_{j}", f"BatchNorm_{j}", f"{role}_conv",
                          f"{role}_bn")
        i += 1
    _biased_conv(out, "heatmap_head", params["heatmap_head"])
    _biased_conv(out, "offset_head", params["offset_head"])
    return out


def _cbs(out: Dict[str, torch.Tensor], prefix: str, params: Mapping,
         stats: Mapping) -> None:
    """One ConvBNSiLU (``Conv_0``/``BatchNorm_0``)."""
    _conv_bn_pair(out, prefix, params, stats, "Conv_0", "BatchNorm_0")


def _c2f(out: Dict[str, torch.Tensor], prefix: str, params: Mapping,
         stats: Mapping) -> None:
    """One C2f: ``ConvBNSiLU_0`` (cv1), ``Bottleneck_{j}`` (each
    ``ConvBNSiLU_0..1``), ``ConvBNSiLU_1`` (cv2)."""
    for j, cv in enumerate(("cv1", "cv2")):
        _cbs(out, f"{prefix}{cv}.", params[f"ConvBNSiLU_{j}"],
             stats[f"ConvBNSiLU_{j}"])
    j = 0
    while f"Bottleneck_{j}" in params:
        bp, bs = params[f"Bottleneck_{j}"], stats[f"Bottleneck_{j}"]
        for k, cv in enumerate(("cv1", "cv2")):
            _cbs(out, f"{prefix}m.{j}.{cv}.", bp[f"ConvBNSiLU_{k}"],
                 bs[f"ConvBNSiLU_{k}"])
        j += 1


def _yolov8(params: Mapping, stats: Mapping) -> Dict[str, torch.Tensor]:
    """YOLOv8: the top-level ``ConvBNSiLU_{i}`` and ``C2f_{i}`` in creation
    order (``convs``, ``c2fs``), ``SPPF_0`` (``ConvBNSiLU_0..1``) and the
    biased ``box_head_s{8,16,32}``/``cls_head_s{8,16,32}``."""
    out: Dict[str, torch.Tensor] = {}
    i = 0
    while f"ConvBNSiLU_{i}" in params:
        _cbs(out, f"convs.{i}.", params[f"ConvBNSiLU_{i}"],
             stats[f"ConvBNSiLU_{i}"])
        i += 1
    i = 0
    while f"C2f_{i}" in params:
        _c2f(out, f"c2fs.{i}.", params[f"C2f_{i}"], stats[f"C2f_{i}"])
        i += 1
    for j, cv in enumerate(("cv1", "cv2")):
        _cbs(out, f"sppf.{cv}.", params["SPPF_0"][f"ConvBNSiLU_{j}"],
             stats["SPPF_0"][f"ConvBNSiLU_{j}"])
    for i, s in enumerate((8, 16, 32)):
        _biased_conv(out, f"box_heads.{i}", params[f"box_head_s{s}"])
        _biased_conv(out, f"cls_heads.{i}", params[f"cls_head_s{s}"])
    return out


_MODELS = {
    "mobilenet_v2": _mobilenet_v2,
    "ssd_mobilenet": _ssd,
    "deeplab_v3": _deeplab,
    "posenet": _posenet,
    "yolov8": _yolov8,
}


def _model_of(params: Mapping) -> str:
    """The zoo model a flax tree belongs to, by the modules only it has."""
    if "_ExtraBlock_0" in params:
        return "ssd_mobilenet"
    if "ASPP_0" in params:
        return "deeplab_v3"
    if "SeparableConv_0" in params:
        return "posenet"
    if "C2f_0" in params:
        return "yolov8"
    return "mobilenet_v2"


def from_jax_variables(variables: Mapping, model: Optional[str] = None
                       ) -> Dict[str, torch.Tensor]:
    """flax variables → a state dict for the matching module here: a
    MobileNetV2, SSDMobileNetV2, DeepLabV3, PoseNet or YoloV8 (``model``:
    its zoo name; without it the tree's modules say which), a ViT or
    StreamTransformer (has ``_Block_0``), or one InvertedResidual (a tree
    with none of these)."""
    params = variables["params"]
    if "_Block_0" in params:
        return _transformer(params)
    stats = variables["batch_stats"]
    if model is None:
        if not any(k in params for k in ("InvertedResidual_0",
                                         "SeparableConv_0", "C2f_0")):
            out: Dict[str, torch.Tensor] = {}
            _block(out, "", params, stats)
            return out
        model = _model_of(params)
    name = {"ssd_mobilenet_v2": "ssd_mobilenet",
            "deeplabv3": "deeplab_v3"}.get(model, model)
    if name not in _MODELS:
        raise ValueError(f"no flax mapping for model {model!r}; known: "
                         f"{sorted(_MODELS)}")
    return _MODELS[name](params, stats)


def save_state_dict(state: Mapping[str, torch.Tensor], path: str) -> None:
    """Write a state dict as the ``.npz`` that ``custom=params:`` loads
    (:func:`models.save_state`)."""
    from nnstreamer_tpu_torch.models import save_state

    save_state(state, path)
