"""Filter framework ABI — the stable contract between tensor_filter and
NN backends.

Mirrors GstTensorFilterFramework v1
(nnstreamer_plugin_api_filter.h:290-441): open/close lifecycle, invoke,
getModelInfo (GET_IN_OUT_INFO / SET_INPUT_INFO), eventHandler
(RELOAD_MODEL etc.), per-framework statistics
(nnstreamer_plugin_api_filter.h:143-148), and the shared-model table that
lets N filter instances share one loaded model
(``shared_model_table`` tensor_filter_common.c:102, API
nnstreamer_plugin_api_filter.h:544-590).

A backend subclasses FilterFramework and registers a *factory* under
registry type 'filter'. Instances are per-open (or shared via
shared_tensor_filter_key).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.analysis import lockwitness
from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.types import TensorsInfo

log = get_logger("filter")


@dataclass
class FilterProperties:
    """Subset of GstTensorFilterProperties the backends consume
    (nnstreamer_plugin_api_filter.h:96-141)."""

    framework: str = "auto"
    model_files: List[str] = field(default_factory=list)  # num_models >1: caffe2-style pairs
    custom: str = ""  # free-form custom_properties (:129)
    accelerator: str = ""  # e.g. 'true:cpu' (default: cuda)
    input_info: Optional[TensorsInfo] = None  # user override / negotiated
    output_info: Optional[TensorsInfo] = None
    shared_key: Optional[str] = None  # shared-tensor-filter-key (:544-590)
    invoke_dynamic: bool = False  # flexible output per invoke (:135 invoke-dynamic)
    #: the element's upload window (``feed-depth``): how many prefetched
    #: inputs it keeps in flight, which sizes a backend's staging ring
    feed_depth: int = 1

    @property
    def model_file(self) -> Optional[str]:
        return self.model_files[0] if self.model_files else None

    def custom_dict(self) -> Dict[str, str]:
        """Parse 'k1:v1,k2:v2' custom strings (common backend convention)."""
        out: Dict[str, str] = {}
        for part in self.custom.split(","):
            part = part.strip()
            if not part:
                continue
            k, _, v = part.partition(":")
            out[k.strip()] = v.strip()
        return out


@dataclass
class FilterStatistics:
    """GstTensorFilterFrameworkStatistics parity
    (nnstreamer_plugin_api_filter.h:143-148). Thread-safe: one framework
    instance may be shared across parallel filter branches
    (shared-tensor-filter-key + round_robin serving)."""

    total_invoke_num: int = 0
    total_invoke_latency_us: int = 0
    total_overhead_latency_us: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def record(self, invoke_us: float, overhead_us: float = 0.0) -> None:
        with self._lock:
            self.total_invoke_num += 1
            self.total_invoke_latency_us += int(invoke_us)
            self.total_overhead_latency_us += int(overhead_us)


class PrefetchedInputs(list):
    """Inputs a backend's :meth:`FilterFramework.prefetch` started to
    upload, passed back to ``invoke()`` in place of the host inputs. It
    IS the input sequence (list subclass), so backends that ignore the
    upload window keep working unchanged. ``donatable`` marks buffers the
    prefetch itself created (no other element holds them); a backend may
    attach what its invoke needs to consume them (the CUDA backend: the
    copy's event)."""

    def __init__(self, arrays, donatable: bool = False):
        super().__init__(arrays)
        self.donatable = donatable


class FilterFramework:
    """Backend base class (GstTensorFilterFramework v1 vtable analogue)."""

    #: framework name (subplugin registry key)
    NAME: str = "base"
    #: backend executes asynchronously (returned CUDA tensors may not be
    #: computed yet); sinks synchronize
    ASYNC: bool = False
    #: backend tolerates set_input_info reshape requests
    RESHAPABLE: bool = False
    #: backend runs on (and accepts/produces) device-resident tensors —
    #: tensor_filter's accepts_device/produces_device source of truth
    DEVICE_CAPABLE: bool = False

    def __init__(self):
        self.props: Optional[FilterProperties] = None
        self.stats = FilterStatistics()

    # -- lifecycle (open/close, nnstreamer_plugin_api_filter.h:290-296) ----
    def open(self, props: FilterProperties) -> None:
        self.props = props

    def close(self) -> None:
        self.props = None

    # -- model info (getModelInfo GET_IN_OUT_INFO, :418-441) ---------------
    def get_model_info(self) -> Tuple[Optional[TensorsInfo], Optional[TensorsInfo]]:
        """Returns (input_info, output_info); either may be None if the model
        accepts any shape (then set_input_info decides)."""
        raise NotImplementedError

    def set_input_info(self, in_info: TensorsInfo) -> Tuple[TensorsInfo, TensorsInfo]:
        """SET_INPUT_INFO: propose an input shape; backend answers with the
        (possibly adjusted) in/out infos. Negotiation may probe several
        shapes before settling — do not commit resources until invoke
        (plugin_api_filter.h:333-336)."""
        raise NotImplementedError(f"{self.NAME} is not reshapable")

    # -- hot path ----------------------------------------------------------
    def invoke(self, inputs: Sequence[Any]) -> List[Any]:
        """One frame in → one frame out. Inputs are ndarray-likes matching
        input_info; outputs likewise. May return device-resident tensors
        when ASYNC."""
        raise NotImplementedError

    def prefetch(self, inputs: Sequence[Any]) -> Optional[PrefetchedInputs]:
        """Optional upload-window hook (the input-side mirror of the
        element's fetch-window): START a non-blocking host→device transfer
        for ``inputs`` NOW and return a handle that a later ``invoke()``
        consumes without a second copy. The element's ``feed-depth=N``
        keeps up to N handles in flight, so a batch's upload overlaps the
        compute of the batches before it.

        Return None to decline — the element then invokes inline. Must
        NOT block on the transfer; the backend's invoke orders its compute
        after it. Base: no prefetch support."""
        return None

    def fuse_stages(self, pre_specs: Sequence[tuple],
                    post_specs: Sequence[tuple]) -> bool:
        """Fusion-planner hook: compose elementwise pre/post stages (spec
        tuples from pipeline/planner.py) around this backend's model.
        Returns True when installed — the planner then turns the
        originating tensor_transform elements into passthrough shells.
        Both lists empty = clear any installed stages (always succeeds on
        the base). Base: stage fusion unsupported — the planner leaves
        the chain un-fused, bit-identical behavior."""
        return not pre_specs and not post_specs

    def fuse_chain(self, stages: Sequence[tuple], in_shapes=None) -> bool:
        """Chain-fusion hook (pipeline/planner.py): compose a DOWNSTREAM
        filter chain — alternating elementwise stage runs and whole-model
        :class:`ops.fusion_stages.ModelStage` entries — after this
        backend's per-invoke program, so a pad-linked filter→filter chain
        runs as ONE program (one upload, one dispatch, one fetch).
        ``in_shapes`` is the per-invoke input signature where the element
        knows it (for a data-free check of the composition).
        Returns True when installed — the planner then turns the chain's
        downstream members into passthrough shells. An empty list clears
        any installed chain (always succeeds on the base). Base: chain
        fusion unsupported — the planner leaves the chain un-fused,
        per-filter behavior unchanged."""
        return not stages

    def chain_callable(self, meta: bool = False):
        """Chain-composition hook: this backend's per-invoke program as a
        ``list-of-tensors -> list-of-tensors`` callable (fused stages,
        model, postproc) that an UPSTREAM head filter runs after its own,
        or with ``meta`` the same program rebuilt on the ``meta`` device
        (the head's data-free composition check); None when the program
        cannot be composed. Base: not composable."""
        return None

    # -- mesh partitioning (analysis/shard.py, NNST470-licensed) -----------
    def shard_supported(self) -> bool:
        """Can this backend place its program over a device mesh
        (``tensor_filter shard=dp|tp|dpxtp mesh=AxB``)? Base: no."""
        return False

    def build_shard(self, cfg: Optional[dict]) -> bool:
        """Install (``cfg`` = {"mode", "dp", "tp"}) or clear (None/empty)
        the NNST470-licensed mesh placement. A False return makes the
        element fall back LOUDLY to unsharded execution. Base: clearing
        always succeeds, installing never does."""
        return not cfg

    # -- replica pool (analysis/pool.py, NNST960-licensed) -----------------
    def replica_supported(self) -> bool:
        """Can this backend copy its model per device (the replica-serving
        tier)? Base: no — backends are presumed stateful."""
        return False

    def build_replicas(self, n: int) -> bool:
        """Install (n > 1) or clear (n <= 1) the replica pool. False
        (single-replica serving) when the backend declines."""
        return n <= 1

    def replica_count(self) -> int:
        """Installed replica count (0 = no pool)."""
        return 0

    def invoke_replica(self, replica: int, inputs: Sequence[Any]
                       ) -> List[Any]:
        """Invoke on replica ``replica``. Base: the plain invoke."""
        return self.invoke(inputs)

    def replica_gate(self, replica: int):
        """The object the NNST601 sanitizer busy gate keys on for one
        replica's invokes (each replica owns its own weights, so
        concurrent invokes on DIFFERENT replicas are legal). Base: the
        framework itself."""
        return self

    def replica_stream(self, replica: int):
        """The CUDA stream replica ``replica`` runs on, or None."""
        return None

    def compile_stats(self) -> dict:
        """Build counters (the counterpart of the JAX backend's jit trace
        count). Base backends build nothing per input signature."""
        return {"jit_traces": 0}

    # -- events (eventHandler, RELOAD_MODEL :351-357) ----------------------
    def handle_event(self, event_type: str, data: Optional[dict] = None) -> None:
        if event_type == "reload_model" and self.props is not None:
            props = self.props
            self.close()
            self.open(props)

    # -- capability flags --------------------------------------------------
    @property
    def name(self) -> str:
        return self.NAME


def detect_framework(models: List[str]) -> str:
    """Framework auto-detection: model extension → configured priority list
    (gst_tensor_filter_detect_framework tensor_filter_common.c:1224-1270,
    _detect_framework_from_config :1177). Zoo names (no extension) run on
    the backend registered as ``jax`` (this package's torch/CUDA one)."""
    import os

    from nnstreamer_tpu_torch import registry as reg
    from nnstreamer_tpu_torch.config import conf

    if not models:
        raise ValueError("no framework/model given")
    if os.path.isdir(models[0]) and os.path.exists(
        os.path.join(models[0], "saved_model.pb")
    ):
        return "tensorflow"
    ext = os.path.splitext(models[0])[1].lstrip(".").lower()
    if not ext:
        return "jax"
    for cand in conf().framework_priority(ext):
        cand = conf().resolve_alias(cand)
        if reg.get(reg.FILTER, cand) is not None:
            return cand
    return "python3" if ext == "py" else "jax"


# --- shared model table (tensor_filter_common.c:102) -----------------------
_shared_table: Dict[str, Tuple[FilterFramework, int]] = {}
_shared_lock = lockwitness.make_lock("filters.shared_table")


def _framework_name_conflict(fw: FilterFramework, name: str) -> bool:
    """True when ``name`` denotes a DIFFERENT backend than ``fw``. The
    registry registers one class under several names (pytorch/torch,
    onnx/onnxruntime, the tflite family), so an alias mismatch is not a
    conflict — resolve ``name`` and accept it when it yields fw's own
    class."""
    if fw.name == name:
        return False
    factory = registry.get(registry.FILTER, name)
    if isinstance(factory, type) and isinstance(fw, factory):
        return False  # alias of the same backend class
    return True


def _shared_props_conflict(fw: FilterFramework, name: str,
                           props: FilterProperties) -> Optional[str]:
    """A shared-key hit must describe the SAME open: a reuse that differs
    in framework/model/custom/accelerator/info overrides would silently
    serve a framework opened with other properties (e.g. a donate:1
    latency pipeline handed a non-donating instance). Returns a
    human-readable mismatch description, or None when the reuse is
    sound."""
    opened = fw.props
    if opened is None:
        return None  # not opened through acquire (custom factories)
    if _framework_name_conflict(fw, name):
        return f"framework: opened with {fw.name!r}, requested {name!r}"
    checks = (
        ("model", list(opened.model_files), list(props.model_files)),
        ("custom", opened.custom, props.custom),
        ("accelerator", opened.accelerator, props.accelerator),
        ("invoke-dynamic", opened.invoke_dynamic, props.invoke_dynamic),
        ("input override", opened.input_info, props.input_info),
        ("output override", opened.output_info, props.output_info),
    )
    for field_name, have, want in checks:
        if have != want:
            return f"{field_name}: opened with {have!r}, requested {want!r}"
    return None


def acquire_framework(
    name: str, props: FilterProperties
) -> FilterFramework:
    """Instantiate (or share) an opened framework. With a shared_key, N filter
    instances reuse one open model (nnstreamer_plugin_api_filter.h:544-590).
    Reuse asserts the properties match the original open (ADVICE r5): a
    key collision across differing configs raises instead of silently
    serving the wrong framework."""
    key = props.shared_key
    if key:
        with _shared_lock:
            if key in _shared_table:
                fw, refs = _shared_table[key]
                conflict = _shared_props_conflict(fw, name, props)
                if conflict:
                    raise ValueError(
                        f"shared-tensor-filter-key {key!r} is already open "
                        f"with different properties ({conflict}); use a "
                        "distinct key per configuration"
                    )
                _shared_table[key] = (fw, refs + 1)
                return fw
    factory = registry.get(registry.FILTER, name)
    if factory is None:
        raise ValueError(
            f"unknown filter framework {name!r}; available: {registry.available(registry.FILTER)}"
        )
    fw: FilterFramework = factory() if callable(factory) else factory
    fw.open(props)
    if key:
        with _shared_lock:
            _shared_table[key] = (fw, 1)
    return fw


def release_framework(fw: FilterFramework, shared_key: Optional[str] = None) -> None:
    if shared_key:
        with _shared_lock:
            entry = _shared_table.get(shared_key)
            if entry is not None:
                _, refs = entry
                if refs > 1:
                    _shared_table[shared_key] = (fw, refs - 1)
                    return
                del _shared_table[shared_key]
    fw.close()


# --- custom-easy: in-process callable filters ------------------------------
class _CustomEasyFramework(FilterFramework):
    """Wraps a registered python callable
    (NNS_custom_easy_register parity, tensor_filter_custom_easy.h:62)."""

    NAME = "custom-easy"

    def __init__(self, fn: Callable, in_info: TensorsInfo,
                 out_info: TensorsInfo, replica_safe: bool = False):
        super().__init__()
        self._fn = fn
        self._in = in_info
        self._out = out_info
        self._replica_safe = bool(replica_safe)
        self._replica_tokens: List[object] = []

    def get_model_info(self):
        return self._in, self._out

    def invoke(self, inputs):
        out = self._fn(inputs)
        return list(out) if isinstance(out, (list, tuple)) else [out]

    # -- replica pool: a callable registered replica_safe=True declares
    # itself a pure function — N "replicas" share it, and concurrent
    # invokes from the per-replica workers are legal
    def replica_supported(self) -> bool:
        return self._replica_safe

    def build_replicas(self, n: int) -> bool:
        if n <= 1:
            self._replica_tokens = []
            return True
        if not self._replica_safe:
            return False
        from types import SimpleNamespace

        # namespace tokens: the sanitizer's busy gate writes its marker
        # attribute onto the gate object
        self._replica_tokens = [SimpleNamespace(name=f"{self.NAME}[r{r}]")
                                for r in range(int(n))]
        return True

    def replica_count(self) -> int:
        return len(self._replica_tokens)

    def replica_gate(self, replica: int):
        toks = self._replica_tokens
        return toks[replica] if 0 <= replica < len(toks) else self


def register_custom_easy(
    name: str,
    fn: Callable[[Sequence[Any]], Sequence[Any]],
    in_info: TensorsInfo,
    out_info: TensorsInfo,
    replica_safe: bool = False,
) -> None:
    """NNS_custom_easy_register: expose ``fn`` as filter model ``name`` for
    ``tensor_filter framework=custom-easy model=<name>``.
    ``replica_safe=True`` declares ``fn`` a pure function safe to invoke
    concurrently from the replica pool's per-replica workers."""

    def factory():
        return _CustomEasyFramework(fn, in_info, out_info,
                                    replica_safe=replica_safe)

    registry.register(registry.CUSTOM_FILTER, name)(factory)


def unregister_custom_easy(name: str) -> bool:
    return registry.unregister(registry.CUSTOM_FILTER, name)
