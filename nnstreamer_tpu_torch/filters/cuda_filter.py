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
  - **build counter**: one count per new input signature of each installed
    composition (a chain installed or changed is a new composition), the
    counterpart of the JAX backend's ``jit_traces`` (``_jit_trace_count``);
  - **fused stages**: ``fuse_stages`` composes the planner's pre/post
    transform stages (ops/fusion_stages.py) around the model: the
    pre-stage runs on each input after its upload, on the stream the
    model runs on, so the upload carries the transform's input bytes; the
    post-stage runs on each output after the postproc;
  - **chain fusion**: ``fuse_chain`` installs a downstream filter chain
    (ops/fusion_stages.py ``build_chain_fn``: each tail backend's
    ``chain_callable`` and the gap transforms' stages) after this
    backend's postproc, so one invoke — and one window replay — runs the
    whole composition; it first runs the composition on ``meta`` tensors
    at this filter's signature and declines, with a warning, where a link
    does not compose or a tail lives on another device;
  - **steady loop**: ``build_loop`` installs the window program of the
    element's ``loop-window`` (ops/steady_loop.py): on the card one
    replay of a CUDA graph per window of N frames, captured once per
    (signature, window) — eagerly when the element knows the signature,
    else at the first window — and recaptured when a trainer changed the
    weights; on the CPU a Python loop over the window. ``loop_stage``
    stages a stacked window, ``loop_invoke`` runs it;
  - **cost program**: ``cost_program`` is the composition rebuilt on the
    ``meta`` device, for the cost model (analysis/costmodel.py) and the
    window's data-free check;
  - **donation**: ``custom=donate:1`` donates the input buffers no other
    element can hold — the device copy ``invoke`` makes of a host input,
    and a prefetch handle's uploads (``donatable``); an upstream device
    tensor is never donated. The composition drops its last reference to
    a donated buffer as soon as the first stage (the fused pre-stage) has
    read it, so the caching allocator can hand the block to the forward's
    activations in the same invoke. Nothing is written in place, so the
    outputs are bit-equal to ``donate`` off and a watchdog fallback that
    re-invokes the same inputs reads them unchanged. A prefetched upload
    was allocated on the copy stream and is marked used on the compute
    stream, so the allocator reuses its block only once the compute
    stream has passed that mark: its bytes leave ``memory_allocated`` at
    once, but not the reserved pool.

  - **mesh** (``build_shard``, the element's NNST470-licensed ``shard=``,
    or the legacy ``custom=shard:dp|tp|dpxtp[,shard_devices:N]
    [,tp_devices:T]``): a (dp, tp) mesh over ``parallel/mesh.py``'s
    devices, where a device may repeat (``NNSTPU_TORCH_DEVICES=cuda:0*4``
    runs four mesh positions on one card). dp splits each input's rows
    over the dp rows of the mesh: row group i runs on dp row i's device,
    under that row's own CUDA stream (so the rows of one card overlap),
    through the same kernels as the solo forward, with that row's own
    copy of the weights; the outputs are gathered onto row 0's device
    after the caller's stream waited for every row's. ``prefetch`` places
    each row group on its row as it uploads. tp holds each param leaf the
    rule of ``parallel/mesh.tp_leaf_sharded`` splits as tp slices along
    its output-channel dim, one per mesh position, and every other leaf
    whole on every position; the solo weights leave the device meanwhile.
    Where a layer reads a leaf, the row gathers it onto the device it
    computes on: each invoke rebuilds the model around the gathered
    leaves (``models.build_with_state``), BatchNorm folds there (exact,
    since the scale is per output channel), the forward runs with the
    fused block's weight cache off (``ops.fused_block.transient_weights``)
    and everything gathered is freed when the invoke returns. The
    activations replicate over tp, as XLA's partitioner leaves them
    around a kernel it cannot split, so one position of each row
    computes them; splitting the compute itself is later work;
  - **replicas** (``build_replicas``, the query server's NNST960-licensed
    ``replicas=``): N copies of the model, replica r on the r-th visible
    device with its own weights and CUDA stream; ``invoke_replica`` runs
    one serve-batch there. Replica 0 on this backend's device is the solo
    model itself.

  - **compile cache** (``custom=aot:1``, or ``NNSTPU_AOT=1``;
    filters/aot.py): ``open`` builds only a skeleton of the model on the
    ``meta`` device (``models.skeleton_bundle``: shapes for negotiation,
    no weights), and the first invoke of each input signature resolves
    its key (the signature and the composition: fused stages, chain,
    window, mesh, replica placement) in the cache — or, on a miss, has a
    child process (filters/aot_worker.py) build the entry on this device
    first. The entry is the models' state folded and cast by that child;
    its bundles are swapped in for the skeleton (a chain tail's for the
    tail's own skeleton) and the filter composes around them with its own
    code, as it does in process. Nothing is folded, no seed is drawn and
    no ``nvcc`` runs in this process. A miss the child could not fill
    (``miss-failed``) or an entry over the memory budget
    (``refused-budget``) builds in process, through the same kernels.
    ``aot_prefetch`` warms an entry without loading it (reload-model's
    model B, a pended serve-batch); ``take_aot_events`` drains the
    outcome records the element forwards to the tracer.

Model naming: zoo names (``mobilenet_v2``) with weights from
``custom=seed:<n>`` or ``custom=params:<path>`` (an ``.npz``, or what the
trainer saved: a file or a directory), checkpoint files
(``model=<file> custom=arch:<zoo-name>``: what ``models.save_state``
wrote, where the JAX backend reads a flax ``.msgpack``), and
embedded-Python ``.py`` model files (:func:`models.load_py_model`, the JAX
backend's ``_load_py_model``). The JAX backend's ``.jaxexport`` and
SavedModel sources are not ported.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.buffer import ShardedBatch, as_torch, dtype_name
from nnstreamer_tpu_torch.filters.base import (
    FilterFramework,
    FilterProperties,
    PrefetchedInputs,
)
from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.models import (
    FoldedState,
    ModelBundle,
    build_bundle,
    build_with_state,
    restore_folded,
    skeleton_bundle,
    weights_version,
)
from nnstreamer_tpu_torch.types import TensorInfo, TensorsInfo

log = get_logger("torch_cuda")


def _aot_enabled(custom: Dict[str, str]) -> bool:
    """The compile cache's gate: ``custom=aot:0|1`` first, then
    ``NNSTPU_AOT=0|1``, else off (the JAX backend turns it on by default
    on a TPU, where an in-process compile degrades its transfer link;
    nothing here degrades, so the default is off)."""
    v = custom.get("aot", os.environ.get("NNSTPU_AOT", ""))
    return str(v).strip().lower() in ("1", "true", "yes")


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


def wants_cpu(accelerator: str) -> bool:
    """Does ``accelerator`` (the tensor_filter property) ask for the CPU
    (``true:cpu``) and name no card?"""
    acc = (accelerator or "").lower()
    return "cpu" in acc and not any(k in acc for k in ("gpu", "cuda"))


def pick_device(accelerator: str) -> torch.device:
    """``accelerator`` (the tensor_filter property) → device: the CPU only
    when asked for (``true:cpu``), otherwise ``cuda``, which must exist."""
    if wants_cpu(accelerator):
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
        self._pre_specs: List[tuple] = []
        self._post_specs: List[tuple] = []
        self._custom: Dict[str, str] = {}
        # chain-fusion state: the installed stage list and the function it
        # builds, run on the postproc's outputs; ``_composition`` counts the
        # installed compositions, so a new one counts as a new build
        self._chain_stages: Optional[List[tuple]] = None
        self._chain_fn = None
        self._composition = 0
        # steady-loop window program (ops/steady_loop.py): the installed
        # window and launch depth, and on the card one captured graph per
        # input signature
        self._loop_window = 0
        self._loop_depth = 1
        self._loop_graphs: Dict[tuple, Any] = {}
        # custom=donate:1 (see the module docstring)
        self._donate = False
        # mesh (see the module docstring): the installed Mesh, its recipe,
        # whether the element's planner installed it (build_shard) rather
        # than custom=shard:, the dp path's per-row bundles, the tp path's
        # placed leaves, the per-row streams and staging, and the solo
        # weights parked on the host while tp holds them split
        self._mesh = None
        self._shard_spec: Optional[dict] = None
        self._shard_installed = False
        self._mesh_bundles: List[ModelBundle] = []
        self._mesh_params: Optional[Dict[str, Any]] = None
        self._mesh_pending = False
        self._mesh_streams: List[Any] = []
        self._mesh_staging: List[Optional[_StagingRing]] = []
        self._solo_state: Optional[Dict[str, torch.Tensor]] = None
        # replica pool: per replica its device, bundle, stream and the
        # sanitizer's busy-gate token
        self._replica_devices: List[torch.device] = []
        self._replica_bundles: List[ModelBundle] = []
        self._replica_streams: List[Any] = []
        self._replica_tokens: List[Any] = []
        # compile cache (see the module docstring): whether this open
        # wants it, whether the bundle is still the meta skeleton, per key
        # (kind, signature) whether the cache served it, and the outcome
        # records the element drains
        self._aot_wanted = False
        self._skeleton = False
        self._aot_tried: Dict[tuple, bool] = {}
        self._aot_events: List[Dict] = []
        self._model_name: Optional[str] = None
        self._custom_str = ""
        # the last solo invoke's signature; it survives a reload, so the
        # swap's prefetch warms the signature the stream runs at
        self._last_sig: Optional[tuple] = None
        # replica pool under the cache: per serve-batch signature whether
        # the cache served every replica
        self._replica_served: Dict[tuple, bool] = {}
        self._replica_lock = threading.Lock()

    # -- open/close --------------------------------------------------------
    def open(self, props: FilterProperties) -> None:
        super().open(props)
        custom = props.custom_dict()
        model = props.model_file
        if not model:
            raise ValueError("torch_cuda filter needs model=<zoo-name|"
                             ".py|checkpoint with custom=arch:>")
        self._device = pick_device(props.accelerator)
        self._custom = custom
        self._postproc = make_postproc(custom)
        self._postproc_name = custom.get("postproc")
        from nnstreamer_tpu_torch.pipeline.planner import donation_requested

        self._donate = donation_requested(props.custom)
        self._model_name, self._custom_str = model, props.custom or ""
        self._aot_wanted = _aot_enabled(custom)
        self._aot_tried = {}
        self._skeleton = False
        if self._aot_wanted:
            try:
                self._bundle = skeleton_bundle(model, custom)
                self._skeleton = True
            except Exception as e:  # noqa: BLE001 — not buildable on meta
                log.info("no skeleton of %s (%s); building in process",
                         model, str(e).splitlines()[0][:120] if str(e)
                         else repr(e))
        if not self._skeleton:
            self._bundle = build_bundle(model, custom, self._device)
        self._signatures = set()
        self._staging = None
        self._open_legacy_shard(custom)

    def _open_legacy_shard(self, custom: Dict[str, str]) -> None:
        """``custom=shard:dp|tp|dpxtp[,shard_devices:N][,tp_devices:T]``:
        the mesh at open, over the first N visible devices (all when N is
        0 or absent); fewer than two devices runs unsharded, with a
        warning, as the JAX backend does."""
        self._mesh, self._shard_spec, self._shard_installed = None, None, False
        sh = custom.get("shard")
        if not sh:
            return
        if sh not in ("dp", "tp", "dpxtp"):
            raise ValueError(
                f"unknown shard mode {sh!r} (supported: dp, tp, dpxtp)")
        from nnstreamer_tpu_torch.parallel.mesh import (
            mesh_from_spec,
            visible_devices,
        )

        n = int(custom.get("shard_devices", "0") or 0)
        devs = visible_devices()
        if n:
            devs = devs[:n]
        if len(devs) < 2:
            log.warning("shard:%s requested but only %d device(s) visible; "
                        "running unsharded", sh, len(devs))
            return
        # an explicit tp_devices:0 passes through so mesh_from_spec
        # rejects it (only absence defaults to 2)
        raw_tp = str(custom.get("tp_devices", "")).strip()
        spec = {"mode": sh, "shard_devices": len(devs),
                "tp_devices": int(raw_tp) if raw_tp else 2}
        self._install_mesh(mesh_from_spec(spec, devs), spec)

    def close(self) -> None:
        self._solo_state = None  # nothing to restore
        self._clear_mesh()
        self.build_replicas(0)
        self._aot_tried, self._skeleton = {}, False
        self._bundle = None
        self._postproc = None
        self._staging = None
        self._stage_pre = self._stage_post = None
        self._pre_specs, self._post_specs = [], []
        self._chain_stages, self._chain_fn = None, None
        self.build_loop(0)
        super().close()

    def fuse_stages(self, pre_specs, post_specs) -> bool:
        """Install (or clear, both empty) the planner's stages. Declines
        only where the JAX backend does: when no model is open to compose
        them with."""
        # a captured window holds the composition it was captured with:
        # it recaptures at the next window; a resolved cache key held the
        # old composition and re-resolves per signature
        self._loop_graphs = {}
        self._aot_tried = {}
        if not pre_specs and not post_specs:
            self._stage_pre = self._stage_post = None
            self._pre_specs, self._post_specs = [], []
            return True
        if self._bundle is None:
            return False
        from nnstreamer_tpu_torch.ops.fusion_stages import build_stage_fn

        self._stage_pre = build_stage_fn(pre_specs)
        self._stage_post = build_stage_fn(post_specs)
        self._pre_specs, self._post_specs = list(pre_specs), list(post_specs)
        return True

    def fuse_chain(self, stages, in_shapes=None) -> bool:
        """Install (or clear, empty list) a chain-fusion stage list after
        this backend's postproc. ``in_shapes`` is the per-invoke input
        signature (ShapeDtype list) where the element knows it, else the
        model's declared input info: the whole composition first runs on
        ``meta`` tensors there, so a link that does not compose declines
        HERE, with a warning, and the planner falls back un-fused instead
        of the first invoke failing. A tail backend on another device
        declines too."""
        from nnstreamer_tpu_torch.ops.fusion_stages import build_chain_fn

        # a captured window holds the composition it was captured with,
        # and a resolved cache key the composition it was keyed on
        self._loop_graphs = {}
        self._aot_tried = {}
        if not stages:
            if self._chain_stages:
                self._chain_stages, self._chain_fn = None, None
                self._composition += 1
            return True
        if self._bundle is None:
            return False
        for kind, payload in stages:
            dev = (getattr(payload.backend(), "_device", None)
                   if kind == "model" else None)
            if dev is not None and dev != self._device:
                log.warning("chain member %r runs on %s, this filter on %s; "
                            "declining whole-chain fusion", payload.name,
                            dev, self._device)
                return False
        fn = build_chain_fn(stages)
        if fn is None:
            return False
        reason = self._chain_composes(stages, in_shapes)
        if reason is not None:
            log.warning("chain composition does not compose on meta tensors "
                        "(%s); declining whole-chain fusion", reason)
            return False
        self._chain_stages, self._chain_fn = list(stages), fn
        self._composition += 1
        return True

    def _chain_composes(self, stages, in_shapes) -> Optional[str]:
        """None when this backend's program followed by ``stages`` runs on
        ``meta`` tensors at the signature, else the reason it does not.
        Without a known signature there is nothing to run: None."""
        from nnstreamer_tpu_torch.analysis.costmodel import (
            ShapeDtype,
            meta_tensors,
        )
        from nnstreamer_tpu_torch.ops.fusion_stages import build_chain_fn

        if in_shapes is None:
            info = self.props.input_info or self._bundle.input_info
            if info is None:
                return None
            in_shapes = [ShapeDtype(tuple(t.np_shape()),
                                    np.dtype(t.dtype.np_dtype)) for t in info]
        solo = self.chain_callable(meta=True)
        tail = build_chain_fn(stages, meta=True)
        if solo is None or tail is None:
            return "a member's program cannot be built on the meta device"
        try:
            with torch.no_grad():
                tail(solo(meta_tensors(in_shapes)))
        except Exception as e:  # noqa: BLE001 — incomposable: decline
            return str(e).splitlines()[0][:120] if str(e) else repr(e)
        return None

    def chain_callable(self, meta: bool = False):
        """This backend's per-invoke program (fused stages, model,
        postproc) as a list→list callable, which an UPSTREAM chain head
        runs after its own; with ``meta`` the same program rebuilt on the
        ``meta`` device (the head's composition check). None when no model
        is open. An installed chain of this backend's own is not part of
        it. The real program reads the backend at each call: under the
        compile cache a head's entry may swap this backend's skeleton for
        its loaded bundle first, else the first call builds in process."""
        if self._bundle is None:
            return None
        if meta:
            prog = self.cost_program()
            if prog is None:
                return None
            fn, params = prog[0], prog[1]
            return lambda xs: _as_list(fn(params, *xs))
        return lambda xs: compose(xs, self._stage_pre,
                                  self._real_bundle().apply_fn,
                                  self._postproc, self._stage_post)

    @property
    def _jit_trace_count(self) -> int:
        """Builds so far: the counterpart of the JAX backend's jit trace
        counter (``compile_stats()["jit_traces"]``)."""
        return len(self._signatures)

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
        return {"jit_traces": self._jit_trace_count}

    # -- hot path ----------------------------------------------------------
    def _to_device(self, x: Any) -> torch.Tensor:
        return as_torch(x).to(self._device, non_blocking=True)

    def _fresh(self, inputs: Sequence[Any]) -> bool:
        """Will every input reach the device as a buffer of this invoke's
        own (no upstream device tensor among them)?"""
        return not any(isinstance(x, ShardedBatch) or (
            isinstance(x, torch.Tensor) and x.device == self._device)
            for x in inputs)

    def prefetch(self, inputs: Sequence[Any]) -> PrefetchedInputs:
        """Start every host input's upload NOW (see the module docstring):
        pinned staging, a copy stream, one event per input. Tensors
        already on the device pass through. On the CPU the handle holds
        the inputs as tensors (there is nothing to copy)."""
        donatable = self._fresh(inputs)
        if self._mesh is not None:
            return self._prefetch_mesh(inputs)
        if self._device.type != "cuda":
            return PrefetchedInputs([self._to_device(x) for x in inputs],
                                    donatable=donatable)
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
        handle = PrefetchedInputs(xs, donatable=donatable)
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

    def _compose(self, xs: Sequence[torch.Tensor],
                 donate: bool = False) -> List[torch.Tensor]:
        """:func:`compose` with this backend's stages, model and postproc,
        then the installed chain, on device tensors: the whole per-invoke
        composition, which ``invoke`` and the window program run."""
        with torch.inference_mode():
            outs = compose(xs, self._stage_pre, self._bundle.apply_fn,
                           self._postproc, self._stage_post, donate=donate)
            if self._chain_fn is not None:
                outs = self._chain_fn(outs)
            return outs

    def invoke(self, inputs: Sequence[Any]) -> List[Any]:
        if self._mesh is not None:
            return self._invoke_mesh(inputs)
        t0 = time.perf_counter()
        prefetched = isinstance(inputs, PrefetchedInputs)
        donate = self._donate and (inputs.donatable if prefetched
                                   else self._fresh(inputs))
        if prefetched and self._device.type == "cuda":
            xs = self._consume(inputs)
        else:
            xs = [self._to_device(x) for x in inputs]
        if donate and prefetched:
            inputs.clear()  # the caller's references to the donated uploads
        sig = self._last_sig = tuple((tuple(x.shape), dtype_name(x))
                                     for x in xs)
        if not (self._aot_wanted and self._maybe_load_aot(sig)):
            # the in-process program: a new signature counts one build
            self._real_bundle()
            self._signatures.add((self._composition,) + sig)
        outs = self._compose(xs, donate=donate)
        # async: no synchronise here; stats record enqueue time
        self.stats.record((time.perf_counter() - t0) * 1e6)
        return outs

    # -- compile cache (filters/aot.py) ------------------------------------
    def _declared_sig(self) -> Optional[tuple]:
        """The signature the filter's input info declares (negotiation's,
        else the model's), when every dim is known."""
        info = None
        if self.props is not None and self.props.input_info is not None:
            info = self.props.input_info
        elif self._bundle is not None:
            info = self._bundle.input_info
        if info is None:
            return None
        sig = tuple((tuple(int(d) for d in t.np_shape()),
                     np.dtype(t.dtype.np_dtype).name) for t in info)
        if any(d <= 0 for shape, _ in sig for d in shape):
            return None
        return sig

    def _real_bundle(self) -> ModelBundle:
        """The bundle with its weights: while the open bundle is the
        skeleton (no cache program was adopted yet), the in-process
        build."""
        if not self._skeleton:
            return self._bundle
        self._bundle = build_bundle(self._model_name, self._custom,
                                    self._device)
        self._skeleton = False
        return self._bundle

    def _adopt(self, program) -> None:
        """Swap a loaded entry's bundles in: while the open bundle is the
        skeleton its head model becomes the bundle, and each chain tail's
        goes to the tail's backend while that one is a skeleton too. A
        real bundle stays: an entry of the same model, weights and custom
        holds the same state, whatever its signature or composition."""
        if self._skeleton:
            self._bundle, self._skeleton = program.head, False
        for i, tail in program.tails.items():
            fw = self._chain_stages[i][1].backend()
            if getattr(fw, "_skeleton", False):
                fw._bundle, fw._skeleton = tail, False

    def _resolve(self, key: tuple, sig: tuple, spec: Optional[dict],
                 adopt, shard: Optional[dict] = None, device=None,
                 n_devices: int = 1) -> bool:
        """Whether the cache serves ``key`` (resolved once per key): the
        entry filters/aot.py loads or compiles goes to ``adopt``; False
        for the in-process build (no reproducible composition, a miss the
        worker could not fill, an entry over the budget)."""
        if key not in self._aot_tried:
            from nnstreamer_tpu_torch.filters import aot

            program = None
            if spec is not None:
                program = aot.maybe_aot_compile(
                    self._model_name, self._custom_str, list(sig),
                    shard=shard, device=device or self._device, spec=spec,
                    budget_bytes=self._aot_budget(n_devices),
                    observer=self._record_aot_event)
            else:
                log.info("AOT skipped for %s: composition not reproducible "
                         "out of process", self._model_name)
            if program is not None:
                adopt(program)
            self._aot_tried[key] = program is not None
        return self._aot_tried[key]

    def _maybe_load_aot(self, sig: tuple) -> bool:
        """Whether the cache serves the solo (or mesh) program of
        signature ``sig``; else the in-process build runs."""
        shard = self._shard_spec if self._mesh is not None else None
        return self._resolve(
            ("mesh" if shard else "solo",) + sig, sig,
            self._composition_spec(), self._adopt, shard=shard,
            n_devices=shard["shard_devices"] if shard else 1)

    def _composition_spec(self) -> Optional[Dict]:
        """The planner-resolved composition of this backend's per-invoke
        program as a JSON-able dict — the cache-key dimensions beyond
        (model, custom, signature, platform), which the lint predicts,
        and the chain's models the worker builds: fused stage specs, the
        chain, donation. None when the
        composition cannot be reproduced out of process (a chain tail on
        another backend). Loop, mesh and replica dims are added by their
        callers."""
        spec: Dict = {}
        if self._pre_specs:
            spec["stages_pre"] = [list(s) for s in self._pre_specs]
        if self._post_specs:
            spec["stages_post"] = [list(s) for s in self._post_specs]
        if self._chain_stages:
            chain = self._chain_spec()
            if chain is None:
                return None
            spec["chain"] = chain
        if self._donate:
            spec["donate"] = True
        return spec

    def _chain_spec(self) -> Optional[List]:
        """The installed chain for the key and the worker: elementwise
        runs as they are; a model stage as its tail's (model, custom,
        content fingerprints of its model and its ``params:`` file, own
        fused stage specs). None when a tail is not a rebuildable backend
        of this package."""
        from nnstreamer_tpu_torch.filters import aot

        out: List = []
        for kind, payload in self._chain_stages:
            if kind == "stages":
                out.append(["stages", [list(s) for s in payload]])
                continue
            fw = payload.backend()
            if (not isinstance(fw, TorchCudaFilter) or not fw._model_name
                    or fw._bundle is None or fw._mesh is not None):
                return None
            entry = {"model": fw._model_name, "custom": fw._custom_str,
                     # the tail's CONTENT rides the key: the head's model
                     # fingerprint alone would miss a tail edit
                     "fingerprint": aot._model_fingerprint(fw._model_name)}
            params = aot.params_fingerprint(fw._custom_str)
            if params:
                entry["params"] = params
            if fw._pre_specs:
                entry["stages_pre"] = [list(s) for s in fw._pre_specs]
            if fw._post_specs:
                entry["stages_post"] = [list(s) for s in fw._post_specs]
            out.append(["model", entry])
        return out

    def _aot_budget(self, n_devices: int = 1) -> Optional[int]:
        """The live per-device memory budget a cache hit must fit
        (analysis/memplan) — an entry that no longer fits is a MISS, not an
        out-of-memory error at PLAYING."""
        try:
            from nnstreamer_tpu_torch.analysis import memplan

            if n_devices > 1:
                return memplan.mesh_memory_budget(n_devices)[0]
            return memplan._budget_of(self._device)[0]
        except Exception:  # noqa: BLE001 — no budget known: no gate
            return None

    def take_aot_events(self) -> List[Dict]:
        """Drain the per-call cache outcome records (the owning element
        forwards them to the pipeline tracer's ``aot`` section)."""
        ev, self._aot_events = self._aot_events, []
        return ev

    def _record_aot_event(self, event: Dict) -> None:
        self._aot_events.append(event)
        del self._aot_events[:-64]  # bounded: drained per invoke

    def aot_prefetch(self, model: Optional[str] = None,
                     shapes=None) -> bool:
        """Warm the cache for ``model`` (default: the current one) WITHOUT
        loading it: the child builds the entry while the CURRENT model
        still serves, so the next open, reload or swap of that model is a
        hit. ``shapes``: the signatures to warm (default: those resolved
        so far, else the last invoke's, else the declared one). True when
        one entry is warm."""
        if self._bundle is None or not _aot_enabled(self._custom):
            return False
        spec = self._composition_spec()
        if spec is None:
            return False
        sigs = (list(shapes) if shapes is not None else
                [k[1:] for k in self._aot_tried if k[0] in ("solo", "mesh")])
        if not sigs:
            sig = self._last_sig or self._declared_sig()
            if sig is None:
                return False
            sigs = [sig]
        from nnstreamer_tpu_torch.filters import aot

        shard = self._shard_spec if self._mesh is not None else None
        warm = False
        for sig in sigs:
            ok = aot.prefetch_compile(
                model or self._model_name, self._custom_str, list(sig),
                shard=shard, spec=spec, observer=self._record_aot_event,
                device=self._device)
            warm = warm or ok
        return warm

    # -- cost program (analysis/costmodel.py) ------------------------------
    def cost_program(self):
        """(fn(params, *xs), params, input_info) — the SOLO per-invoke
        composition (fused stages, model, postproc) rebuilt on the
        ``meta`` device, data-free; None when the model cannot be built
        there. An installed chain is not part of it: the chain analyzer
        (analysis/chain.py) models the composed program with every
        member's params billed once, while the solo costs stay
        attributable to their elements."""
        from nnstreamer_tpu_torch.analysis.costmodel import meta_composition

        if self._bundle is None:
            return None
        try:
            fn, module, _ = meta_composition(
                self.props.model_file, self._custom, self._pre_specs,
                self._post_specs)
        except Exception:  # noqa: BLE001 — not buildable on meta
            return None
        return fn, module, self._bundle.input_info

    # -- mesh (analysis/shard.py, NNST470-licensed) ------------------------
    def shard_supported(self) -> bool:
        """The mesh needs a model to re-place, and no installed chain,
        window or replica pool owning the program; a mesh from
        ``custom=shard:`` owns the placement already."""
        return (self._bundle is not None
                and not self._chain_stages
                and self._loop_window == 0
                and not self._replica_devices
                and (self._mesh is None or self._shard_installed))

    def build_shard(self, cfg) -> bool:
        """Install (or clear, ``cfg`` falsy) the NNST470-licensed mesh of
        ``cfg`` = {"mode", "dp", "tp"} over the first dp·tp visible
        devices. Declines (False) when the program cannot be placed — the
        element then runs unsharded, numerically the same."""
        if not cfg:
            if self._shard_installed:
                self._clear_mesh()
            return True
        if not self.shard_supported():
            return False
        from nnstreamer_tpu_torch.parallel.mesh import mesh_from_axes

        dp, tp = int(cfg["dp"]), int(cfg["tp"])
        try:
            self._install_mesh(mesh_from_axes(dp, tp), {
                "mode": str(cfg.get("mode", "dp")),
                "shard_devices": dp * tp, "tp_devices": tp})
        except Exception as e:  # noqa: BLE001 — a failed install declines
            # (the element falls back loudly unsharded), never leaves a
            # half-placed backend behind
            self._clear_mesh()
            log.warning("mesh install failed (%s); declining shard "
                        "(unsharded execution)",
                        str(e).splitlines()[0][:120])
            return False
        self._shard_installed = True
        return True

    def _install_mesh(self, mesh, spec: dict) -> None:
        """Place the solo model over ``mesh`` (see the module docstring):
        per dp row a bundle when tp is 1, else the placed leaves with the
        solo weights parked on the host. Under the compile cache the mesh
        program's entry is keyed by the invoke signature: with none known
        yet, the placement waits for the first invoke or prefetch."""
        self._clear_mesh()
        self._mesh, self._shard_spec = mesh, dict(spec)
        self._mesh_pending = self._skeleton and self._aot_wanted
        if not self._mesh_pending:
            self._place_mesh(None)

    def _place_mesh(self, sig: Optional[tuple]) -> None:
        from nnstreamer_tpu_torch.parallel.mesh import (
            row_device,
            shard_params_for_tp,
        )

        mesh, spec = self._mesh, self._shard_spec
        self._mesh_pending = False
        dp, tp = mesh.shape["dp"], mesh.shape["tp"]
        if self._skeleton and self._aot_wanted and sig is not None:
            # the mesh program of the cache: its state, placed below
            self._resolve(
                ("mesh",) + sig, sig, self._composition_spec(), self._adopt,
                shard=dict(spec), device=row_device(mesh, 0),
                n_devices=int(spec["shard_devices"]))
        module = self._real_bundle().module
        rows = [row_device(mesh, r) for r in range(dp)]
        if tp == 1:
            self._mesh_bundles = [
                self._bundle if r == 0 and dev == self._device
                else self._copy_bundle(dev) for r, dev in enumerate(rows)]
        else:
            self._mesh_params = shard_params_for_tp(mesh, module)
            self._solo_state = {k: v.detach().to("cpu", copy=True)
                                for k, v in module.state_dict().items()}
            self._bundle = self._build(torch.device("meta"), {
                k: torch.empty_like(v, device="meta")
                for k, v in self._solo_state.items()})
        from nnstreamer_tpu_torch.ops._cuda import side_stream

        self._mesh_streams = [side_stream(dev, f"mesh-row{r}")
                              if dev.type == "cuda" else None
                              for r, dev in enumerate(rows)]
        self._mesh_staging = [None] * dp
        self._loop_graphs = {}

    def _mesh_ready(self, inputs: Sequence[Any]) -> None:
        """A mesh waiting for its first signature is placed now."""
        if self._mesh_pending:
            self._place_mesh(tuple((tuple(np.shape(x)), dtype_name(x))
                                   for x in inputs))

    def _clear_mesh(self) -> None:
        """Back to the solo model: the parked weights return to the device."""
        if self._solo_state is not None:
            self._bundle = self._build(self._device, {
                k: v.to(self._device) for k, v in self._solo_state.items()})
        self._mesh, self._shard_spec, self._shard_installed = None, None, False
        self._mesh_pending = False
        self._mesh_bundles, self._mesh_params = [], None
        self._mesh_streams, self._mesh_staging = [], []
        self._solo_state = None

    def _build(self, device, state) -> ModelBundle:
        """The model rebuilt on ``device`` around ``state``: a bundle the
        compile cache restored rebuilds from its folded state."""
        recipe = getattr(self._bundle, "recipe", None)
        if recipe is not None:
            return restore_folded(recipe, FoldedState.unflatten(state),
                                  self._custom, device)
        return build_with_state(self.props.model_file, self._custom, device,
                                state)

    def _copy_bundle(self, device) -> ModelBundle:
        """The solo model rebuilt on ``device`` around its own copy of the
        solo weights."""
        return self._build(device, {
            k: v.detach().to(device, copy=True)
            for k, v in self._bundle.module.state_dict().items()})

    def mesh_param_bytes(self) -> Dict[tuple, int]:
        """Bytes of weights each mesh position holds: {(i, j): bytes}."""
        from nnstreamer_tpu_torch.analysis.costmodel import param_bytes_of
        from nnstreamer_tpu_torch.parallel.mesh import mesh_positions

        if self._mesh is None:
            return {}
        if self._mesh_params is None:
            return {(r, 0): param_bytes_of(b.module)
                    for r, b in enumerate(self._mesh_bundles)}
        return {pos: sum(leaf.nbytes_at(pos)
                         for leaf in self._mesh_params.values())
                for pos in mesh_positions(self._mesh)}

    def _mesh_rows(self, inputs: Sequence[Any]) -> List[List[Any]]:
        """Each input's rows split into dp groups (host arrays or tensors
        as given): ``[row][input]``."""
        dp = self._mesh.shape["dp"]
        out: List[List[Any]] = [[] for _ in range(dp)]
        for x in inputs:
            if isinstance(x, ShardedBatch) and len(x) == dp:
                for r in range(dp):  # placed on the rows already
                    out[r].append(x[r])
                continue
            if isinstance(x, ShardedBatch):
                x = torch.cat([p.to(x[0].device) for p in x], dim=0)
            n = int(x.shape[0]) if len(np.shape(x)) else 0
            if n % dp:
                raise ValueError(
                    f"sharded inference needs the batch (leading dim {n}) "
                    f"to divide the dp axis ({dp}): size batch-size or "
                    f"frames-per-tensor to a multiple of {dp}")
            g = n // dp
            for r in range(dp):
                out[r].append(x[r * g:(r + 1) * g])
        return out

    def _prefetch_mesh(self, inputs: Sequence[Any]) -> PrefetchedInputs:
        """Start each row group's upload onto its mesh row now, from a
        page-locked staging ring of that row's (on the CPU: slices).
        The handle holds ``[row][input]`` tensors and per row the events
        of its uploads."""
        from nnstreamer_tpu_torch.parallel.mesh import row_device

        self._mesh_ready(inputs)
        rows = self._mesh_rows(inputs)
        placed, events = [], []
        for r, xs in enumerate(rows):
            dev = row_device(self._mesh, r)
            if dev.type != "cuda":
                placed.append([as_torch(x).to(dev) for x in xs])
                events.append([])
                continue
            ring = self._mesh_staging[r]
            if ring is None:
                ring = self._mesh_staging[r] = _StagingRing(
                    dev, int(self.props.feed_depth) + 1)
            ts, evs = [], []
            for x in xs:
                if isinstance(x, torch.Tensor):
                    ts.append(x.to(dev, non_blocking=True))
                    continue
                t, evt = ring.upload(np.asarray(x))
                ts.append(t)
                evs.append(evt)
            placed.append(ts)
            events.append(evs)
        handle = PrefetchedInputs(placed, donatable=self._fresh(inputs))
        handle.mesh_events = events
        return handle

    def _invoke_mesh(self, inputs: Sequence[Any]) -> List[Any]:
        """One invoke over the mesh: every dp row computes its row group
        on its own stream; the outputs are gathered onto row 0's device,
        on the caller's stream there."""
        from nnstreamer_tpu_torch.parallel.mesh import row_device

        t0 = time.perf_counter()
        mesh = self._mesh
        dp = mesh.shape["dp"]
        if isinstance(inputs, PrefetchedInputs) and hasattr(inputs,
                                                            "mesh_events"):
            rows, events = list(inputs), inputs.mesh_events
        else:
            self._mesh_ready(inputs)
            rows, events = self._mesh_rows(inputs), [[] for _ in range(dp)]
        out_dev = row_device(mesh, 0)
        caller = (torch.cuda.current_stream(out_dev)
                  if out_dev.type == "cuda" else None)
        per_row = []
        for r in range(dp):
            dev, stream = row_device(mesh, r), self._mesh_streams[r]
            with (torch.cuda.stream(stream) if stream is not None
                  else contextlib.nullcontext()):
                if stream is not None:
                    if caller is not None and caller.device == dev:
                        stream.wait_stream(caller)
                    for evt in events[r]:
                        stream.wait_event(evt)
                xs = []
                for x in rows[r]:
                    t = as_torch(x).to(dev, non_blocking=True)
                    if stream is not None and t.is_cuda:
                        t.record_stream(stream)
                    xs.append(t)
                if r == 0:
                    self._signatures.add((self._composition, "mesh") + tuple(
                        (tuple(x.shape), dtype_name(x)) for x in xs))
                per_row.append(self._run_row(r, xs, dev))
        if caller is not None:
            # the gather and the caller's consumers read the rows'
            # outputs: order the caller's stream after every row's, and
            # keep their blocks from reuse until it has passed
            for stream in self._mesh_streams:
                if stream is not None:
                    caller.wait_stream(stream)
            for o in per_row:
                for t in o:
                    if t.is_cuda:
                        t.record_stream(caller)
        outs = per_row[0] if dp == 1 else [
            torch.cat([o[i].to(out_dev, non_blocking=True) for o in per_row],
                      dim=0) for i in range(len(per_row[0]))]
        self.stats.record((time.perf_counter() - t0) * 1e6)
        return outs

    def _run_row(self, r: int, xs: List[torch.Tensor],
                 dev: torch.device) -> List[torch.Tensor]:
        """dp row ``r``'s forward on its device: its own bundle (tp 1), or
        a bundle built around the leaves gathered from the row's
        positions, which lives for this call only."""
        from nnstreamer_tpu_torch.ops.fused_block import transient_weights

        if self._mesh_params is None:
            return self._compose_with(self._mesh_bundles[r].apply_fn, xs)
        with transient_weights():
            bundle = self._build(dev, {
                k: leaf.gather(r, dev)
                for k, leaf in self._mesh_params.items()})
            outs = self._compose_with(bundle.apply_fn, xs)
            del bundle
        return outs

    def _compose_with(self, apply_fn, xs) -> List[torch.Tensor]:
        with torch.inference_mode():
            return compose(list(xs), self._stage_pre, apply_fn,
                           self._postproc, self._stage_post)

    # -- replica pool (analysis/pool.py, NNST960-licensed) -----------------
    def replica_supported(self) -> bool:
        """Replicas need a model to copy, and no chain, window or mesh
        owning the program."""
        return (self._bundle is not None and not self._chain_stages
                and self._loop_window == 0 and self._mesh is None)

    def replica_count(self) -> int:
        return len(self._replica_devices)

    def replica_gate(self, replica: int):
        toks = self._replica_tokens
        return toks[replica] if 0 <= replica < len(toks) else self

    def replica_stream(self, replica: int):
        """Replica ``replica``'s CUDA stream (None off the card): its
        worker runs the invoke and the fetch under it."""
        if 0 <= replica < len(self._replica_streams):
            return self._replica_streams[replica]
        return None

    def build_replicas(self, n: int) -> bool:
        """Install (n > 1) or clear (<= 1) the replica pool over the first
        n visible devices. Declines (False) when the program cannot be
        copied or fewer devices are visible — the server then serves from
        one replica, numerically the same."""
        self._replica_served = {}
        if n <= 1:
            self._replica_devices, self._replica_bundles = [], []
            self._replica_streams, self._replica_tokens = [], []
            return True
        if not self.replica_supported():
            return False
        from nnstreamer_tpu_torch.parallel.mesh import visible_devices

        devs = visible_devices()
        if len(devs) < n:
            return False
        devs = devs[:n]
        if self._skeleton and self._aot_wanted:
            # under the compile cache each replica loads its bundle at its
            # first serve-batch signature (invoke_replica); none is copied
            bundles = [None] * n
        else:
            try:
                bundles = self._copy_replicas(devs)
            except Exception as e:  # noqa: BLE001 — placement failed
                log.warning("replica placement failed (%s); declining "
                            "replicas (single-replica serving)",
                            str(e).splitlines()[0][:120])
                return False
        self._replica_devices, self._replica_bundles = devs, bundles
        from nnstreamer_tpu_torch.ops._cuda import side_stream

        self._replica_streams = [side_stream(d, f"replica{r}")
                                 if d.type == "cuda" else None
                                 for r, d in enumerate(devs)]
        # namespace tokens: the sanitizer's busy gate writes its marker
        # attribute onto the gate object
        self._replica_tokens = [SimpleNamespace(name=f"{self.NAME}[r{r}]")
                                for r in range(n)]
        return True

    def _copy_replicas(self, devs) -> List[ModelBundle]:
        """The solo model's copies for the replicas that hold no bundle
        yet (each replica keeps one it has)."""
        bundle = self._real_bundle()
        held = self._replica_bundles or [None] * len(devs)
        return [b if b is not None
                else bundle if r == 0 and dev == self._device
                else self._copy_bundle(dev)
                for r, (b, dev) in enumerate(zip(held, devs))]

    def _replica_program(self, replica: int, sig: tuple):
        """Replica ``replica``'s run function for serve-batch signature
        ``sig``: under the compile cache each replica device's entry is
        resolved once per signature (keyed with the placement, the serve
        batch and the replica's index: warm scale-up is N loads) and the
        first one loaded becomes that replica's bundle; a replica the
        cache did not serve gets the in-process copy."""
        if sig not in self._replica_served:
            with self._replica_lock:
                if sig not in self._replica_served:
                    self._replica_served[sig] = self._replica_aot(sig)
        if self._replica_bundles[replica] is None:
            with self._replica_lock:
                if self._replica_bundles[replica] is None:
                    self._replica_bundles = self._copy_replicas(
                        self._replica_devices)
        bundle = self._replica_bundles[replica]
        return lambda xs: self._compose_with(bundle.apply_fn, xs)

    def _replica_aot(self, sig: tuple) -> bool:
        """Whether the cache served every replica device at ``sig``."""
        if not self._aot_wanted:
            return False
        spec = self._composition_spec()
        if spec is None:
            return False
        spec["placement"] = "replica"
        spec["serve_batch"] = [list(s) for s, _ in sig]
        n = len(self._replica_devices)
        for r, dev in enumerate(self._replica_devices):
            if not self._resolve(
                    ("replica", r) + sig, sig, dict(spec, device_index=r),
                    lambda program, r=r: self._adopt_replica(r, program),
                    device=dev, n_devices=n):
                return False
        log.info("replica pool warm-started from the compile cache: %d "
                 "programs for %s %s", n, self._model_name, sig)
        return True

    def _adopt_replica(self, replica: int, program) -> None:
        """A loaded entry's head becomes replica ``replica``'s bundle when
        it has none (replica 0 on this backend's device is the solo model:
        a skeleton there takes it too)."""
        if self._replica_bundles[replica] is None:
            self._replica_bundles[replica] = program.head
        if replica == 0 and self._replica_devices[0] == self._device:
            self._adopt(program)

    def invoke_replica(self, replica: int, inputs: Sequence[Any]
                       ) -> List[Any]:
        """One serve-batch on replica ``replica``: its inputs go to its
        device and its forward runs on its stream; the outputs return
        unsynchronised, ordered after that stream for the caller's."""
        t0 = time.perf_counter()
        dev = self._replica_devices[replica]
        stream = self._replica_streams[replica]
        caller = torch.cuda.current_stream(dev) if stream is not None else None
        own = caller is None or caller == stream
        if not own:
            stream.wait_stream(caller)
        with (torch.cuda.stream(stream) if not own
              else contextlib.nullcontext()):
            xs = [as_torch(x).to(dev, non_blocking=True) for x in inputs]
            sig = tuple((tuple(x.shape), dtype_name(x)) for x in xs)
            run = self._replica_program(replica, sig)
            if not self._replica_served[sig]:
                self._signatures.add((self._composition,) + sig)
            with torch.inference_mode():
                outs = run(xs)
        if not own:
            caller.wait_stream(stream)
            for t in outs:
                if t.is_cuda:
                    t.record_stream(caller)
        self.stats.record((time.perf_counter() - t0) * 1e6)
        return outs

    # -- steady loop (ops/steady_loop.py) ----------------------------------
    def loop_supported(self) -> bool:
        return (self._bundle is not None and self._mesh is None
                and not self._replica_devices)

    def build_loop(self, window: int, depth: int = 1,
                   in_info: Optional[TensorsInfo] = None) -> bool:
        """Install (window > 1) or clear (<= 1) the window program.
        ``in_info`` is the per-frame input signature where the element
        knows it statically: on the CPU the window is then checked
        data-free on the meta device (a window that does not compose
        declines here, and the element falls back per-buffer); on the
        card its graph is captured now rather than at the first window,
        and a capture that fails declines."""
        from nnstreamer_tpu_torch.ops.steady_loop import (
            LoopDeclined,
            validate_window,
        )

        self._loop_graphs = {}
        if window <= 1:
            self._loop_window, self._loop_depth = 0, 1
            return True
        if not self.loop_supported():
            return False
        if in_info is not None and any(
                int(d) <= 0 for t in in_info for d in t.np_shape()):
            in_info = None
        prog = (self.cost_program() if in_info is not None
                and self._device.type != "cuda" else None)
        solo_meta = (None if prog is None
                     else (lambda xs, fn=prog[0]: fn(None, *xs)))
        if solo_meta is not None and self._chain_stages:
            from nnstreamer_tpu_torch.ops.fusion_stages import build_chain_fn

            tail = build_chain_fn(self._chain_stages, meta=True)
            solo_meta = (None if tail is None else
                         (lambda xs, head=solo_meta: tail(_as_list(head(xs)))))
        reason = validate_window(solo_meta, window, in_info)
        if reason is not None:
            log.warning("window program does not compose (%s); declining "
                        "loop-window=%d", reason, window)
            return False
        self._loop_window, self._loop_depth = int(window), max(1, int(depth))
        if in_info is not None and self._aot_wanted:
            self._loop_program(tuple(
                (tuple(int(d) for d in t.np_shape()),
                 np.dtype(t.dtype.np_dtype).name) for t in in_info))
        if in_info is not None and self._device.type == "cuda":
            shapes = [(int(window),) + tuple(t.np_shape()) for t in in_info]
            dtypes = [np.dtype(t.dtype.np_dtype) for t in in_info]
            try:
                self._loop_graph(shapes, dtypes)
            except LoopDeclined as e:
                log.warning("%s; declining loop-window=%d", e, window)
                self._loop_window, self._loop_depth = 0, 1
                self._loop_graphs = {}
                return False
        return True

    def _loop_program(self, sig: tuple) -> bool:
        """Whether the cache serves the window's program for per-frame
        signature ``sig``: keyed with the window and the launch depth, so a
        re-planned window re-resolves; the capture happens after the
        load. A miss the worker cannot fill builds in process."""
        spec = self._composition_spec()
        if spec is not None:
            spec.update(loop_window=self._loop_window,
                        launch_depth=self._loop_depth)
        served = self._resolve(
            ("loop", self._loop_window, self._loop_depth) + sig, sig, spec,
            self._adopt)
        self._real_bundle()
        return served

    def _loop_graph(self, shapes, dtypes):
        """The captured window program for one signature (captured at its
        first use; counted as one build)."""
        from nnstreamer_tpu_torch.ops.steady_loop import (
            CudaGraphWindow,
            LoopDeclined,
            build_window_fn,
        )

        key = tuple((tuple(s), np.dtype(d).str) for s, d in zip(shapes,
                                                                 dtypes))
        g = self._loop_graphs.get(key)
        if g is None:
            if self._aot_wanted:
                self._loop_program(tuple(
                    (tuple(s[1:]), np.dtype(d).name)
                    for s, d in zip(shapes, dtypes)))
            module = self._real_bundle().module
            try:
                g = CudaGraphWindow(
                    build_window_fn(self._compose), shapes,
                    [torch.from_numpy(np.empty(0, d)).dtype for d in dtypes],
                    self._device, self._loop_depth + 1,
                    version=lambda: weights_version(module))
            except Exception as e:  # noqa: BLE001 — the capture refused
                raise LoopDeclined(f"window capture failed: {e}") from e
            self._loop_graphs[key] = g
            self._signatures.add(("loop", self._composition) + key)
        return g

    def loop_slot(self, row: Sequence[Any], window: int):
        """Where the element stacks a window whose first frame is ``row``:
        on the card the next page-locked slot of the window's graph (so
        the host copies the window once), on the CPU None (a fresh
        array)."""
        if self._device.type != "cuda" or self._loop_window <= 1:
            return None
        xs = [np.asarray(x) for x in row]
        return self._loop_graph([(int(window),) + x.shape for x in xs],
                                [x.dtype for x in xs]).slot()

    def loop_stage(self, stacked: Sequence[Any]):
        """Stage one stacked window: on the card into its graph's input
        ring (through a page-locked slot, on the compute stream), on the
        CPU as tensors. Returns the handle ``loop_invoke`` runs."""
        if self._loop_window <= 1:
            raise RuntimeError("no window program is installed")
        if self._device.type != "cuda":
            return [torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
                    for x in stacked]
        g = self._loop_graph([np.shape(x) for x in stacked],
                             [np.asarray(x).dtype for x in stacked])
        g.stage(stacked)
        return g

    def loop_invoke(self, staged) -> List[Any]:
        """ONE dispatch runs the whole window: one graph replay on the
        card, the composition in a loop over the window on the CPU.
        Returns the stacked outputs without synchronising."""
        from nnstreamer_tpu_torch.ops.steady_loop import build_window_fn

        t0 = time.perf_counter()
        if isinstance(staged, list):
            if not (self._aot_wanted and self._loop_program(tuple(
                    (tuple(x.shape[1:]), dtype_name(x)) for x in staged))):
                self._signatures.add(("loop", self._composition) + tuple(
                    (tuple(x.shape), dtype_name(x)) for x in staged))
            outs = build_window_fn(self._compose)(staged)
        else:
            outs = staged.replay()
        self.stats.record((time.perf_counter() - t0) * 1e6)
        return outs

    def loop_stats(self) -> Dict[str, Any]:
        """Captures, replays, capture ms and the launches one replay
        makes, summed over this backend's window graphs."""
        gs = list(self._loop_graphs.values())
        launches: Dict[str, int] = {}
        for g in gs:
            for k, n in g.launches.items():
                launches[k] = launches.get(k, 0) + n
        return {"captures": sum(g.captures for g in gs),
                "replays": sum(g.replays for g in gs),
                "capture_ms": sum(g.capture_ms for g in gs),
                "launches_per_replay": launches}


def _as_list(out) -> List[Any]:
    return list(out) if isinstance(out, (list, tuple)) else [out]


def compose(xs: Sequence[torch.Tensor], stage_pre, apply_fn, postproc,
            stage_post, donate: bool = False) -> List[torch.Tensor]:
    """The full per-invoke composition: the fused pre-stage per input
    (the planner's parity gates guarantee numpy equivalence), the model,
    the postproc, the fused post-stage per output. ``invoke``, the window
    program and the cost model's meta run (analysis/costmodel.py) all run
    this one function; a stage or postproc of None is skipped. With
    ``donate`` the list ``xs`` holds the last references to the inputs:
    it is emptied once the pre-stage has read them, which frees their
    blocks for the model's activations."""
    if stage_pre is not None:
        staged = [stage_pre(x) for x in xs]
        if donate:
            xs.clear()
        xs = staged
    out = apply_fn(*xs)
    if postproc is not None:
        out = postproc(out)
    outs = _as_list(out)
    if stage_post is not None:
        outs = [stage_post(o) for o in outs]
    return outs


registry.register(registry.FILTER, "jax")(TorchCudaFilter)
registry.register(registry.FILTER, "torch_cuda")(TorchCudaFilter)
