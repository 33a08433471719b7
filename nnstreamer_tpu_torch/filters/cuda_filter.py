"""The torch/CUDA filter backend — the counterpart of the JAX package's
``filters/jax_filter.py`` solo path (open, set_input_info, invoke).

Registered as ``jax`` (so the JAX package's launch lines run unchanged)
and as ``torch_cuda``. Its device is ``cuda`` unless the tensor_filter
property ``accelerator=true:cpu`` asks for the CPU (how the CPU tests run);
a card that is asked for and absent makes ``open`` raise.

  - **weights once**: the model's parameters go to the device, and its
    BatchNorm folds, once at ``open`` (models/*.build);
  - **async**: ``invoke`` enqueues CUDA work and returns CUDA tensors
    without synchronising; the element's fetch window or the sink
    materializes them;
  - **upload window**: ``prefetch`` (the element's ``feed-depth`` > 1)
    copies each host input into one of ``feed-depth + 1`` page-locked
    staging buffers, allocated once per shape and dtype and reused, and
    starts its upload on a dedicated copy stream; ``invoke`` makes the
    compute stream wait for that copy's event. A staging buffer is
    rewritten only after its last upload completed;
  - **on-device postproc**: ``custom=postproc:argmax|top1|softmax`` runs on
    the device, so only the small result crosses to the host;
  - **build counter**: one count per new input signature, the counterpart
    of the JAX backend's ``jit_traces``;
  - **fused stages**: ``fuse_stages`` composes the planner's pre/post
    transform stages (ops/fusion_stages.py) around the model: the
    pre-stage runs on each input after its upload, on the stream the
    model runs on, so the upload carries the transform's input bytes; the
    post-stage runs on each output after the postproc.

Model naming: zoo names (``mobilenet_v2``) with weights from
``custom=seed:<n>`` or ``custom=params:<path>`` (an ``.npz``, or what the
trainer saved: a file or a directory), and embedded-Python ``.py`` model
files (:func:`models.load_py_model`, the JAX backend's ``_load_py_model``).
The JAX backend's ``.jaxexport``/``.msgpack``/SavedModel sources, its mesh
sharding, replicas, steady loop, AOT cache and chain fusion are not
ported; the custom keys that would ask for them raise.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.buffer import dtype_name
from nnstreamer_tpu_torch.filters.base import (
    FilterFramework,
    FilterProperties,
    PrefetchedInputs,
)
from nnstreamer_tpu_torch.models import ModelBundle, get_model, load_py_model
from nnstreamer_tpu_torch.types import TensorInfo, TensorsInfo

#: custom keys of the JAX backend whose features this backend lacks
_NOT_PORTED_CUSTOM = ("shard", "shard_devices", "tp_devices", "donate", "aot",
                      "arch")
#: ``custom=aot:<v>`` values that turn the JAX backend's ahead-of-time
#: compile off, which is what this backend always does: accepted
_AOT_OFF = ("0", "false", "no")


def make_postproc(custom: Dict[str, str]):
    """On-device post-processing from ``custom=postproc:...``."""
    pp = custom.get("postproc")
    if pp in ("argmax", "top1", "argmax8"):
        dt = torch.uint8 if pp == "argmax8" else torch.int32

        def _argmax(out):
            o = out[0] if isinstance(out, (list, tuple)) else out
            return torch.argmax(o, dim=-1).to(dt)

        return _argmax
    if pp == "softmax":
        def _softmax(out):
            o = out[0] if isinstance(out, (list, tuple)) else out
            return torch.softmax(o.float(), dim=-1)

        return _softmax
    if pp == "pp":
        # the detection post-process of the pp models: their builders
        # (ssd_mobilenet, yolov8) consume it, nothing to do here
        return None
    if pp:
        raise ValueError(f"unknown postproc {pp!r}")
    return None


def _postproc_info(pp: Optional[str], info: TensorsInfo) -> TensorsInfo:
    """Output info after postproc — computed from shapes (the counterpart
    of the JAX backend's jax.eval_shape probe)."""
    if pp in ("argmax", "top1", "argmax8"):
        shape = info.tensors[0].np_shape()[:-1] or (1,)
        dt = "uint8" if pp == "argmax8" else "int32"
        return TensorsInfo(tensors=[TensorInfo.from_np_shape(shape, dt)])
    if pp == "softmax":
        shape = info.tensors[0].np_shape()
        return TensorsInfo(tensors=[TensorInfo.from_np_shape(shape, "float32")])
    return info


def pick_device(accelerator: str) -> torch.device:
    """``accelerator`` (the tensor_filter property) → device: the CPU only
    when asked for (``true:cpu``), otherwise ``cuda``, which must exist."""
    acc = (accelerator or "").lower()
    if "cpu" in acc and not any(k in acc for k in ("gpu", "cuda")):
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the torch_cuda filter needs a CUDA device and torch sees none; "
            "set accelerator=true:cpu to run on the CPU")
    return torch.device("cuda")


class _StagingRing:
    """Page-locked host staging for the upload window: per (shape, dtype),
    ``slots`` pinned buffers used round robin, each with the CUDA event of
    the last upload that read it. :meth:`upload` waits for a slot's event
    before it rewrites the slot, copies the host array in (host time),
    and starts the non-blocking device copy on the copy stream."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.slots = max(2, int(slots))
        self.stream = torch.cuda.Stream(device)
        self._rings: Dict[tuple, list] = {}  # key -> [next, [(buf, evt)]]

    def upload(self, x: np.ndarray) -> Tuple[torch.Tensor, Any]:
        x = np.ascontiguousarray(x)
        key = (x.shape, x.dtype.str)
        ring = self._rings.get(key)
        if ring is None:
            src = torch.from_numpy(x)
            ring = self._rings[key] = [0, [
                (torch.empty(src.shape, dtype=src.dtype, pin_memory=True),
                 None) for _ in range(self.slots)]]
        i = ring[0]
        ring[0] = (i + 1) % self.slots
        buf, evt = ring[1][i]
        if evt is not None:
            evt.synchronize()  # the slot's previous upload has read it
        np.copyto(buf.numpy(), x)
        with torch.cuda.stream(self.stream):
            dev = torch.empty(buf.shape, dtype=buf.dtype, device=self.device)
            dev.copy_(buf, non_blocking=True)
            evt = torch.cuda.Event()
            evt.record(self.stream)
        ring[1][i] = (buf, evt)
        return dev, evt


class TorchCudaFilter(FilterFramework):
    NAME = "torch_cuda"
    ASYNC = True
    RESHAPABLE = True
    DEVICE_CAPABLE = True

    def __init__(self):
        super().__init__()
        self._bundle: Optional[ModelBundle] = None
        self._device: Optional[torch.device] = None
        self._postproc = None
        self._postproc_name: Optional[str] = None
        # input signatures seen so far: a new one counts one build, the
        # counterpart of the JAX backend's jit trace counter
        self._signatures: set = set()
        self._staging: Optional[_StagingRing] = None
        # fusion-planner stages (ops/fusion_stages.py): applied per input
        # before the model and per output after the postproc
        self._stage_pre = None
        self._stage_post = None

    # -- open/close --------------------------------------------------------
    def open(self, props: FilterProperties) -> None:
        super().open(props)
        custom = props.custom_dict()
        model = props.model_file
        if not model:
            raise ValueError("torch_cuda filter needs model=<zoo-name>")
        bad = [k for k in _NOT_PORTED_CUSTOM if k in custom
               and not (k == "aot" and custom[k] in _AOT_OFF)]
        if bad:
            raise ValueError(f"custom={','.join(bad)} is not supported by the "
                             "torch_cuda backend")
        is_py = model.endswith(".py")
        if "." in model.rsplit("/", 1)[-1] and not is_py:
            raise ValueError(f"model {model!r}: the torch_cuda backend runs "
                             "zoo models (weights via custom=params:<path>) "
                             "and .py model files")
        self._device = pick_device(props.accelerator)
        self._postproc = make_postproc(custom)
        self._postproc_name = custom.get("postproc")
        self._bundle = (load_py_model(model, custom, self._device) if is_py
                        else get_model(model, custom, self._device))
        self._signatures = set()
        self._staging = None

    def close(self) -> None:
        self._bundle = None
        self._postproc = None
        self._staging = None
        self._stage_pre = self._stage_post = None
        super().close()

    def fuse_stages(self, pre_specs, post_specs) -> bool:
        """Install (or clear, both empty) the planner's stages. Declines
        only where the JAX backend does: when no model is open to compose
        them with."""
        if not pre_specs and not post_specs:
            self._stage_pre = self._stage_post = None
            return True
        if self._bundle is None:
            return False
        from nnstreamer_tpu_torch.ops.fusion_stages import build_stage_fn

        self._stage_pre = build_stage_fn(pre_specs)
        self._stage_post = build_stage_fn(post_specs)
        return True

    # -- model info --------------------------------------------------------
    def get_model_info(self) -> Tuple[Optional[TensorsInfo], Optional[TensorsInfo]]:
        in_info = self._bundle.input_info
        if in_info is None:
            return None, self._bundle.output_info
        return self.set_input_info(in_info)

    def set_input_info(self, in_info: TensorsInfo) -> Tuple[TensorsInfo, TensorsInfo]:
        """Answer shape proposals from shapes alone — no launch, no
        commitment (plugin_api_filter.h:333-336 probing semantics)."""
        if self._bundle.infer_output is None:
            raise NotImplementedError(f"{self._bundle} cannot reshape")
        out = self._bundle.infer_output(in_info)
        return in_info, _postproc_info(self._postproc_name, out)

    def compile_stats(self) -> Dict[str, int]:
        return {"jit_traces": len(self._signatures)}

    # -- hot path ----------------------------------------------------------
    def _to_device(self, x: Any) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self._device, non_blocking=True)
        return torch.from_numpy(np.ascontiguousarray(np.asarray(x))).to(
            self._device, non_blocking=True)

    def prefetch(self, inputs: Sequence[Any]) -> PrefetchedInputs:
        """Start every host input's upload NOW (see the module docstring):
        pinned staging, a copy stream, one event per input. Tensors
        already on the device pass through. On the CPU the handle holds
        the inputs as tensors (there is nothing to copy)."""
        if self._device.type != "cuda":
            return PrefetchedInputs([self._to_device(x) for x in inputs],
                                    donatable=True)
        if self._staging is None:
            self._staging = _StagingRing(
                self._device, int(self.props.feed_depth) + 1)
        xs, events = [], []
        for x in inputs:
            if isinstance(x, torch.Tensor):
                xs.append(x.to(self._device, non_blocking=True))
                continue
            dev, evt = self._staging.upload(np.asarray(x))
            xs.append(dev)
            events.append(evt)
        handle = PrefetchedInputs(xs, donatable=True)
        handle.events = events
        return handle

    def _consume(self, handle: PrefetchedInputs) -> List[torch.Tensor]:
        """The compute stream waits for the handle's uploads, and each
        uploaded tensor is marked used on it: it was allocated on the copy
        stream, and without the mark the caching allocator could hand its
        memory to the next upload while the model still reads it."""
        compute = torch.cuda.current_stream(self._device)
        for evt in getattr(handle, "events", ()):
            compute.wait_event(evt)
        for x in handle:
            if x.is_cuda:
                x.record_stream(compute)
        return list(handle)

    def invoke(self, inputs: Sequence[Any]) -> List[Any]:
        t0 = time.perf_counter()
        if isinstance(inputs, PrefetchedInputs) and self._device.type == "cuda":
            xs = self._consume(inputs)
        else:
            xs = [self._to_device(x) for x in inputs]
        self._signatures.add(tuple((tuple(x.shape), dtype_name(x)) for x in xs))
        with torch.inference_mode():
            if self._stage_pre is not None:
                # fused upstream tensor_transform chain, on the device
                # after the upload (the planner's parity gates guarantee
                # numpy equivalence)
                xs = [self._stage_pre(x) for x in xs]
            out = self._bundle.apply_fn(*xs)
            if self._postproc is not None:
                out = self._postproc(out)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        if self._stage_post is not None:
            with torch.inference_mode():
                outs = [self._stage_post(o) for o in outs]
        # async: no synchronise here; stats record enqueue time
        self.stats.record((time.perf_counter() - t0) * 1e6)
        return outs


registry.register(registry.FILTER, "jax")(TorchCudaFilter)
registry.register(registry.FILTER, "torch_cuda")(TorchCudaFilter)
