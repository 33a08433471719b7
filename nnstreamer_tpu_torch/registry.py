"""L2 subplugin registry with lazy dynamic loading.

Mirrors the reference's name→vtable hash per subplugin type with lazy
``g_module_open`` of ``libnnstreamer_{type}_{name}.so`` from configured paths
(nnstreamer_subplugin.h:40-52, register_subplugin/get_subplugin
nnstreamer_subplugin.c:61-92, dlopen at :116, path lookup :164).

Python-native redesign: a subplugin is any object registered under a
(type, name) key. Built-ins self-register via the ``@register(...)``
decorator when their module is imported; ``get()`` lazily imports
(a) the built-in module table below (our "constructor self-registration"),
then (b) ``nns_tpu_{type}_{name}.py`` files on the conf-configured search
paths (the .so search parity). Custom property descriptions
(subplugin_set_custom_property_desc) are kept alongside.
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

from nnstreamer_tpu_torch.config import conf
from nnstreamer_tpu_torch.log import logw

# subplugin types (nnstreamer_subplugin.h:40-52)
FILTER = "filter"
DECODER = "decoder"
CONVERTER = "converter"
TRAINER = "trainer"
CUSTOM_FILTER = "custom_filter"  # custom-easy (tensor_filter_custom_easy.h)
CUSTOM_DECODER = "custom_decoder"
CUSTOM_CONVERTER = "custom_converter"
IF_CONDITION = "if"  # tensor_if custom conditions (tensor_if.h:22-77)

_registry: Dict[Tuple[str, str], Any] = {}
_prop_desc: Dict[Tuple[str, str], Dict[str, str]] = {}
_lock = threading.RLock()

# Built-in subplugins: (type, name) -> module to import, whose import-time
# @register calls populate the table. This is the analogue of each .so's
# constructor calling register_subplugin.
_BUILTINS: Dict[Tuple[str, str], str] = {
    # launch lines written for the JAX package say framework=jax: in this
    # package that name resolves to the torch/CUDA backend
    (FILTER, "jax"): "nnstreamer_tpu_torch.filters.cuda_filter",
    (FILTER, "torch_cuda"): "nnstreamer_tpu_torch.filters.cuda_filter",
    (TRAINER, "jax"): "nnstreamer_tpu_torch.trainers.cuda_trainer",
    (TRAINER, "torch_cuda"): "nnstreamer_tpu_torch.trainers.cuda_trainer",
    (FILTER, "custom-easy"): "nnstreamer_tpu_torch.filters.custom_easy",
    (FILTER, "python3"): "nnstreamer_tpu_torch.filters.python3",
    (FILTER, "torch"): "nnstreamer_tpu_torch.filters.torch_filter",
    (FILTER, "pytorch"): "nnstreamer_tpu_torch.filters.torch_filter",
    # the CPU-runtime backends: registered always, each raises at open()
    # by name where its runtime is not installed
    (FILTER, "tensorflow-lite"): "nnstreamer_tpu_torch.filters.tflite_filter",
    (FILTER, "tensorflow2-lite"): "nnstreamer_tpu_torch.filters.tflite_filter",
    (FILTER, "tensorflow1-lite"): "nnstreamer_tpu_torch.filters.tflite_filter",
    (FILTER, "tflite"): "nnstreamer_tpu_torch.filters.tflite_filter",
    (FILTER, "tensorflow"): "nnstreamer_tpu_torch.filters.tflite_filter",
    (FILTER, "onnxruntime"): "nnstreamer_tpu_torch.filters.onnx_filter",
    (FILTER, "onnx"): "nnstreamer_tpu_torch.filters.onnx_filter",
    (FILTER, "passthrough"): "nnstreamer_tpu_torch.filters.passthrough",
    (FILTER, "custom"): "nnstreamer_tpu_torch.filters.custom",
    (FILTER, "lua"): "nnstreamer_tpu_torch.filters.lua_filter",
    (DECODER, "image_labeling"): "nnstreamer_tpu_torch.decoders.image_labeling",
    (DECODER, "bounding_boxes"): "nnstreamer_tpu_torch.decoders.bounding_boxes",
    (DECODER, "image_segment"): "nnstreamer_tpu_torch.decoders.image_segment",
    (DECODER, "pose_estimation"): "nnstreamer_tpu_torch.decoders.pose_estimation",
    (DECODER, "direct_video"): "nnstreamer_tpu_torch.decoders.direct_video",
    (DECODER, "octet_stream"): "nnstreamer_tpu_torch.decoders.octet_stream",
    (DECODER, "tensor_region"): "nnstreamer_tpu_torch.decoders.tensor_region",
    (DECODER, "flexbuf"): "nnstreamer_tpu_torch.decoders.flexbuf",
    (DECODER, "python3"): "nnstreamer_tpu_torch.decoders.python3",
    (DECODER, "protobuf"): "nnstreamer_tpu_torch.decoders.protobuf",
    (DECODER, "flatbuf"): "nnstreamer_tpu_torch.decoders.flatbuf",
    (CONVERTER, "flexbuf"): "nnstreamer_tpu_torch.converters.flexbuf",
    (CONVERTER, "python3"): "nnstreamer_tpu_torch.converters.python3",
    (CONVERTER, "protobuf"): "nnstreamer_tpu_torch.converters.protobuf",
    (CONVERTER, "flatbuf"): "nnstreamer_tpu_torch.converters.flatbuf",
}


def register(sp_type: str, name: str):
    """Decorator/function: register a subplugin object under (type, name).

    Parity: register_subplugin (nnstreamer_subplugin.c:61)."""

    def deco(obj):
        with _lock:
            key = (sp_type, name.lower())
            if key in _registry and _registry[key] is not obj:
                logw("subplugin %s/%s re-registered", sp_type, name)
            _registry[key] = obj
        return obj

    return deco


def unregister(sp_type: str, name: str) -> bool:
    with _lock:
        return _registry.pop((sp_type, name.lower()), None) is not None


def get(sp_type: str, name: str) -> Optional[Any]:
    """Lookup with lazy load (get_subplugin, nnstreamer_subplugin.c:~150)."""
    name = name.lower()
    with _lock:
        obj = _registry.get((sp_type, name))
    if obj is not None:
        return obj
    # 1) built-in module self-registration
    mod = _BUILTINS.get((sp_type, name))
    if mod is not None:
        try:
            importlib.import_module(mod)
        except ImportError as e:
            logw("builtin subplugin %s/%s failed to import: %s", sp_type, name, e)
    # 2) external search paths: nns_tpu_{type}_{name}.py (dlopen parity)
    if (sp_type, name) not in _registry:
        for path in conf().subplugin_paths(sp_type):
            cand = os.path.join(path, f"nns_tpu_{sp_type}_{name}.py")
            if os.path.isfile(cand):
                _load_module_file(cand, f"nns_tpu_{sp_type}_{name}")
                break
    with _lock:
        return _registry.get((sp_type, name))


def _load_module_file(path: str, modname: str) -> None:
    spec = importlib.util.spec_from_file_location(modname, path)
    if spec and spec.loader:
        m = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(m)


def names(sp_type: str) -> List[str]:
    """All currently-registered names of a type (loaded builtins only)."""
    with _lock:
        return sorted(n for t, n in _registry if t == sp_type)


def available(sp_type: str) -> List[str]:
    """Registered + known-builtin names (for the doctor tool / error msgs)."""
    with _lock:
        loaded = {n for t, n in _registry if t == sp_type}
    builtin = {n for t, n in _BUILTINS if t == sp_type}
    return sorted(loaded | builtin)


def set_custom_property_desc(sp_type: str, name: str, desc: Dict[str, str]) -> None:
    """subplugin_set_custom_property_desc parity."""
    with _lock:
        _prop_desc[(sp_type, name.lower())] = dict(desc)


def get_custom_property_desc(sp_type: str, name: str) -> Dict[str, str]:
    with _lock:
        return dict(_prop_desc.get((sp_type, name.lower()), {}))
