"""tensor_filter — THE inference element (counterpart of the JAX package's
``elements/filter.py``, solo path).

Mirrors the reference's GstBaseTransform hot loop (tensor_filter.c:643-944)
and shared property engine (tensor_filter_common.c): framework
auto-detection from the model extension (tensor_filter_common.c:1224-1270),
input/output info overrides, input/output-combination selection
(:716-758, :850-869), invoke statistics (`latency`/`throughput` props,
tensor_filter.c:366-478), QoS throttling (:512), shared-tensor-filter-key
and hot model reload events.

Invoke enqueues CUDA work and returns without synchronising: outputs flow
downstream as CUDA tensors while everything downstream takes them
(``device_ok`` on the src pad, the residency planner's verdict); where a
host consumer follows, this filter is the materialization boundary and
fetches them itself. The element's amortizers, as in the JAX package:

  - ``batch-size=N`` micro-batches N frames into one invoke (a partial
    batch at EOS or at the ``fetch-timeout-ms`` quiescence flush is padded
    with its last frame) and splits the outputs back per frame;
  - ``feed-depth=N`` is the upload window: the backend's ``prefetch``
    starts each entry's host→device copy at once and up to N entries wait
    in flight while earlier ones compute;
  - ``fetch-window=K|eos|auto`` holds device outputs and brings a whole
    window to the host in ONE batched device→host transfer where this
    filter is the boundary (or the graph is unplanned); ``auto`` sizes the
    window from the measured fetch and buffer period;
  - ``invoke-dynamic`` emits each output as a flexible tensor.

Stage fusion: the planner may install adjacent ``tensor_transform`` chains
as pre/post stages on the backend (``install_fusion``); the upload then
carries the transform's input bytes, caps map through the fused chain, and
the stages are reinstalled on a reopened or reloaded backend.

Chain fusion: where the chain analyzer (analysis/chain.py) verdicts
NNST450, the planner installs the downstream filters and the gap
transforms between them on this filter's backend (``install_chain``): one
invoke runs the whole chain, this filter's src caps carry the end of the
chain, and each claimed filter becomes a shell that forwards buffers and
caps untouched and invokes nothing (``fused-into:<head>`` on the tracer).
``chain-fusion=off`` on a filter keeps it out of every chain. A reload on
the head reinstalls the chain; a reload on a shell recomposes the head.

Steady loop: ``loop-window=N|auto`` with ``launch-depth=K`` — where the
loop analyzer (analysis/loop.py) verdicts NNST460 the planner installs the
backend's window program (``install_loop``): frames collect into a window
of N, a full window is ONE stacked upload, ONE dispatch (on the card one
CUDA-graph replay) and, once K windows are banked, ONE drain of the oldest
— the loop owns both transfer amortizers, so the batch/feed/fetch paths
never see its frames. A partial window at EOS, at the ``fetch-timeout-ms``
quiescence flush, on reload or on stop dispatches padded (the padded rows
are never pushed). NNST461/462 and a declined window run per-buffer
launches, loudly (``_loop_refused``).

The tracer (``trace.attach``) sees the upload and fetch crossings, the
upload-window and fetch-window holds, and, with spans on, the batch,
dispatch, compute, h2d and d2h spans of each invoke.

Invoke watchdog: ``invoke-timeout-ms=T`` runs each backend invoke on a
persistent worker thread and abandons it past the deadline (a hung
backend cannot wedge the streaming thread): the trip is counted
(``watchdog-trips``), posted on the bus and the tracer, and raised into
the ``on-error`` policy. After ``fallback-after`` (default 3) consecutive
trips, ``fallback-framework=<name>|auto`` re-opens the model on a fresh
backend instance carrying the installed preamble and chain
(``degraded-to``); a backend that cannot carry them fails the switch
loudly (``fallback-failed``). An abandoned invoke cannot be cancelled on
the card: its kernels still run, on the stream the streaming thread
invokes on (the worker adopts it), so the fallback's launches queue
behind them; neither writes the inputs, so the fallback re-reads them
unchanged. The loop analyzer refuses ``loop-window`` beside the watchdog
(NNST461, as in the JAX package; per-buffer launches, ``_loop_refused``),
so a CUDA-graph capture never runs while an abandoned invoke launches on
another thread.

Donation: ``custom=donate:1`` lets the backend drop a host-fed input's
device buffer as soon as its first stage has read it; a donating filter
behind a tee is refused at construction.

Mesh partitioning (``shard=dp|tp|dpxtp mesh=AxB``): the PLAYING planner
installs the mesh on the backend (``install_shard``) where
analysis/shard.py verdicts NNST470; any other verdict, or a backend that
declines, runs unsharded, loudly (``_shard_refused``), with the same
outputs. A host transfer of a sharded filter is billed to the tracer with
its per-device split.

Replica serving (the query server's ``replicas=N``): the planner installs
N copies of the model on the backend (``install_replicas``) and starts
one worker thread per replica, each with a bounded inbox. A serve-batch
the scheduler stamped with its least-loaded replica (``serve_replica``)
goes to that replica's inbox and the streaming thread returns at once;
the worker invokes (under the replica's CUDA stream, the fault points
tagged ``<name>@rN``, the sanitizer's busy gate per replica),
materializes and pushes downstream. A failed replica invoke runs the
element's ``on-error`` policy off the streaming thread and tells the
batch's clients now (SERVER_BUSY, ``replica-error``).

Safe rollout (``rollout-model``, ``rollout-canary-frames``,
``rollout-rollback``): a ``rollout-model`` sink event prefetches model B
into the compile cache while A serves, drains and flips to B through the
reload-model machinery, then watches ``rollout-canary-frames`` frames
(default 64) on the pipeline's fault ledger and, behind a serving source,
the admitted p99 since the flip. A clean window promotes B; a regression
(or an invoke that raises inside the window) rolls back to A, whose
program is still in the cache (``rollout-rollback=auto``), or records the
verdict and keeps B (``off``). Each decision goes to the tracer's
``rollout`` section and the bus.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from nnstreamer_tpu_torch import meta as meta_mod
from nnstreamer_tpu_torch.analysis import lockwitness, sanitizer
from nnstreamer_tpu_torch.analysis.schema import Prop
from nnstreamer_tpu_torch.buffer import (
    Buffer,
    Event,
    concat_tensors,
    is_backend_tensor,
    materialize_tensors,
    nbytes_of,
    residency_of,
    stack_tensors,
)
from nnstreamer_tpu_torch.caps import Caps
from nnstreamer_tpu_torch.config import conf
from nnstreamer_tpu_torch.filters.base import (
    FilterProperties,
    PrefetchedInputs,
    acquire_framework,
    release_framework,
)
from nnstreamer_tpu_torch.log import ElementError, get_logger
from nnstreamer_tpu_torch.pipeline.element import Element, FlowReturn, Pad, element_register
from nnstreamer_tpu_torch.types import (
    TensorFormat,
    TensorInfo,
    TensorsConfig,
    TensorsInfo,
)

log = get_logger("tensor_filter")

def _block_until_ready(tensors) -> None:
    """Wait for the CUDA work that makes ``tensors``: one synchronise of
    the current stream per device involved. CPU tensors are ready."""
    for dev in {t.device for t in tensors
                if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.current_stream(dev).synchronize()


def _shape(t) -> tuple:
    return tuple(t.shape) if hasattr(t, "shape") else np.shape(t)


def _caller_stream(fw):
    """The current CUDA stream of the calling thread on ``fw``'s device,
    or None for a backend off the card. The watchdog's worker invokes on
    it, so an invoke runs on the same stream whichever thread makes it."""
    dev = getattr(fw, "_device", None)
    if isinstance(dev, torch.device) and dev.type == "cuda":
        return torch.cuda.current_stream(dev)
    return None


def _worker_inputs(inputs):
    """The list the watchdog's worker invokes with: a prefetched handle is
    copied (its upload events and donation mark included), so a donating
    backend that drops the worker's references leaves the element's list
    whole for a fallback re-invoke of the same inputs."""
    if not isinstance(inputs, PrefetchedInputs):
        return inputs
    own = PrefetchedInputs(inputs, donatable=inputs.donatable)
    own.__dict__.update(inputs.__dict__)
    return own


@element_register
class TensorFilter(Element):
    ELEMENT_NAME = "tensor_filter"
    SINK_TEMPLATE = "other/tensors"
    SRC_TEMPLATE = "other/tensors"
    PROPERTY_SCHEMA = {
        "framework": Prop("str", doc="backend name or 'auto'"),
        "model": Prop("str", doc="model file(s), comma separated"),
        "custom": Prop("str", doc="backend-specific options"),
        "accelerator": Prop("str"),
        "shared_tensor_filter_key": Prop("str"),
        "invoke_dynamic": Prop("bool"),
        "input": Prop("str", doc="input dims override (with input-type)"),
        "inputtype": Prop("str"),
        "inputname": Prop("str"),
        "output": Prop("str"),
        "outputtype": Prop("str"),
        "outputname": Prop("str"),
        "input_combination": Prop("str", doc="comma-separated indices"),
        "output_combination": Prop("str", doc="iN/oN tokens"),
        "batch_size": Prop("int", doc="micro-batch N frames per invoke"),
        "feed_depth": Prop("int", doc="upload-window in-flight prefetches"),
        "fetch_window": Prop(
            "str",
            validate=lambda v: (
                None if str(v).strip().lower() in ("auto", "eos")
                or str(v).strip().lstrip("-").isdigit()
                else f"expected an integer, 'auto' or 'eos', got {v!r}"),
            doc="device→host transfer amortizer"),
        "fetch_timeout_ms": Prop("number"),
        "latency": Prop("bool"),
        "latency_report": Prop("bool"),
        "latency_e2e": Prop("bool"),
        "throughput": Prop("bool"),
        "sync": Prop("bool", doc="materialize outputs on the streaming "
                                 "thread"),
        "loop_window": Prop(
            "str",
            validate=lambda v: (
                None if str(v).strip().lower() == "auto"
                or str(v).strip().lstrip("-").isdigit()
                else f"expected an integer or 'auto', got {v!r}"),
            doc="steady loop: ONE dispatch per N frames (a CUDA-graph "
                "window; auto = largest budget-feasible candidate)"),
        "launch_depth": Prop(
            "int",
            doc="bank up to K un-synced window launches before draining"),
        "chain_fusion": Prop("enum", enum=("auto", "off"),
                             doc="per-element whole-chain fusion opt-out"),
        "invoke_timeout_ms": Prop("number", doc="watchdog deadline"),
        "fallback_framework": Prop("str", doc="backend name or 'auto'"),
        "fallback_after": Prop("int"),
        "shard": Prop(
            "enum", enum=("off", "dp", "tp", "dpxtp"),
            doc="mesh-partitioned execution (NNST470-licensed): dp "
                "splits the batch axis, tp splits wide channel params, "
                "dpxtp both over a 2-D mesh"),
        "mesh": Prop(
            "str",
            validate=lambda v: (
                None if str(v).strip() == ""
                or all(p.isdigit() and int(p) > 0
                       for p in str(v).strip().lower().split("x"))
                else f"expected AxB (e.g. 4x2) or N, got {v!r}"),
            doc="shard mesh axes as dp x tp (e.g. mesh=4x2); empty = "
                "all visible devices on the mode's own axis"),
        "rollout_model": Prop(
            "str",
            doc="safe versioned hot-swap candidate (model B): prefetched "
                "into the compile cache, drained-and-flipped on the "
                "'rollout-model' sink event, then canaried (nnfleet-r)"),
        "rollout_canary_frames": Prop(
            "int",
            doc="canary window after the flip: N frames watched on the "
                "fault ledger + admitted-p99 before the candidate is "
                "promoted (0 = no canary — NNST981 under rollback=auto)"),
        "rollout_rollback": Prop(
            "enum", enum=("auto", "off"),
            doc="auto rolls back to the pre-flip model on a canary "
                "regression (a warm compile-cache load)"),
    }

    #: default canary window (frames) when `rollout-canary-frames` unset
    ROLLOUT_CANARY_FRAMES = 64

    #: fetch-window=auto bounds + fetch-overhead target (fetch cost ≤ ~25%
    #: of window compute ⇒ K ≈ 4·t_fetch/t_batch)
    _AUTO_WINDOW_MAX = 64
    _AUTO_OVERHEAD = 0.25
    #: the window auto holds while the stream is saturated (throughput
    #: regime, no live consumer): the JAX package's hand-validated
    #: constant, kept so both packages decide alike
    _AUTO_SATURATED_WINDOW = 16
    #: fetch-window=eos memory backstop: flush after this many held buffers
    _EOS_WINDOW_CAP = 4096

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.fw = None
        # per-thread invoke-window stamps (serve_invoke reply headers):
        # replica workers invoke concurrently, so the stamps an _emit_now
        # pairs with its outputs must be THIS thread's
        self._inv_tls = threading.local()
        # rollout canary state: set by the 'rollout-model' sink event
        # after the drain-and-flip to model B, cleared on promote /
        # rollback. {old_model, model, frames_left, baseline_faults,
        # baseline_p99, since, rollback, sched} — chain() checks it per
        # frame (two counter reads when quiet, never a lock)
        self._rollout: Optional[dict] = None
        self._fw_props: Optional[FilterProperties] = None
        self._in_info: Optional[TensorsInfo] = None
        self._out_info: Optional[TensorsInfo] = None
        self._in_config: Optional[TensorsConfig] = None
        self._latencies_us: deque = deque(maxlen=10)  # last-10 window (:981-987)
        # per-buffer arrival → emit, batching wait and window holds
        # included — the `latency-e2e` property
        self._e2e_us: deque = deque(maxlen=10)
        self._out_times: deque = deque(maxlen=50)
        self._qos_earliest: int = -1
        self._invoke_count = 0
        # micro-batching: (buf, tensors, inputs) rows awaiting one invoke
        self._pending: List[tuple] = []
        # fetch-window: (rows, buf, tensors, outputs) entries awaiting one
        # batched device→host transfer, with their hold stamps (tracer)
        self._fetch_pending: List[tuple] = []
        self._fetch_t: List[float] = []
        # upload window (feed-depth): (rows, buf, tensors, payload) entries
        # whose payload is the backend's prefetch handle (or the raw
        # inputs when it declined); rows is the micro-batch's rows
        self._feed_pending: List[tuple] = []
        self._feed_t: List[float] = []
        self._auto_window = 2  # fetch-window=auto state
        self._last_flush_t: Optional[float] = None
        # fetch-window=auto regime detection: EWMAs of the idle gap
        # between chain() calls and of the time spent inside chain(); a
        # saturated feed has idle ≈ 0, a live feed idles between frames
        self._arr_idle_ewma: Optional[float] = None
        self._arr_busy_ewma: Optional[float] = None
        self._chain_exit_t: Optional[float] = None
        # span-mode per-invoke sync sampling (NNSTPU_TRACE_SYNC_SAMPLE)
        self._sync_sample_n = 0
        # serializes the hot loop, the fetch-timeout-ms timer's flush and
        # reload events (the invoke runs under it, by design)
        self._window_lock = lockwitness.make_rlock(
            "filter.window", blocking_ok=True, invoke_ok=True)
        # fetch-timeout-ms: one long-lived timer per filter; the chain
        # path only stamps _last_activity, the callback re-arms itself
        # until the stream actually goes quiet
        self._flush_timer: Optional[threading.Timer] = None
        self._last_activity = 0.0
        # fusion-planner state: adjacent tensor_transform elements run as
        # stages on this filter's backend (pipeline/planner.py). The
        # element lists drive caps mapping; the spec lists reinstall the
        # stages after a backend reopen (restart policy / reload-model)
        self._fused_pre: List = []
        self._fused_post: List = []
        self._pre_specs: List[tuple] = []
        self._post_specs: List[tuple] = []
        # chain-fusion state (planner _plan_chain_fusion): set on a
        # DOWNSTREAM member composed into a chain head's program — chain()
        # is a passthrough shell until the next (re)plan, and
        # is_transparent() counts the shell as residency-transparent
        self._fused_into: Optional[str] = None
        # set on the chain HEAD: the ordered downstream elements (gap
        # transforms + member filters) whose caps effect this filter's src
        # caps carry, and the installed stage list (reinstalled onto a
        # reopened or reloaded backend, as _pre_specs are)
        self._chain_tail_elems: List = []
        self._chain_specs: List[tuple] = []
        # steady-loop state (planner _plan_steady_loop, NNST460-licensed):
        # {"window": N, "depth": K} while the window program is installed;
        # frames collect in _loop_rows until a window fills, dispatched
        # windows bank in _loop_inflight (up to K un-synced launches)
        # until their drain. _loop_refused carries the (code, reason) of a
        # loud per-buffer fallback.
        self._loop_state: Optional[dict] = None
        self._loop_rows: List[tuple] = []
        self._loop_inflight: deque = deque()
        self._loop_refused: Optional[tuple] = None
        # invoke watchdog (`invoke-timeout-ms`) + graceful degradation
        # (`fallback-framework`): trip counters and the degraded-to marker
        self._watchdog_trips = 0
        self._watchdog_consec = 0
        self._degraded_to: Optional[str] = None
        # (done_event, framework) of an abandoned (tripped) invoke still
        # running on its worker thread — gates re-entry so one framework
        # instance never runs two invokes concurrently
        self._wd_busy: Optional[tuple] = None
        # persistent watchdog worker (thread, queue): one long-lived thread
        # serves every guarded invoke; a trip retires it and the next
        # invoke spawns a replacement
        self._wd_worker: Optional[tuple] = None
        # mesh-partition state (planner _plan_sharding, NNST470-licensed):
        # {"mode", "dp", "tp"} while the placement is installed on the
        # backend; _shard_refused carries the (code, reason) of a loud
        # unsharded fallback
        self._shard_state: Optional[dict] = None
        self._shard_refused: Optional[tuple] = None
        # replica-pool state (planner _plan_pool, NNST960-licensed):
        # {"replicas": N} while the backend holds the replicas; one
        # (thread, inbox) worker per replica; _replica_refused carries the
        # (code, reason) of a loud single-replica fallback
        self._replica_state: Optional[dict] = None
        self._replica_refused: Optional[tuple] = None
        self._replica_workers: List[tuple] = []

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        """NULL→READY opens the framework (gst_tensor_filter_start
        tensor_filter.c:1548 → common_open_fw tensor_filter_common.c:2465)."""
        fw_name = str(self.properties.get("framework", "auto"))
        model = self.properties.get("model")
        models = str(model).split(",") if model else []
        if any(m.startswith("mlagent://") for m in models):
            # mlagent://model/<name>/<ver> → registered file path
            # (mlagent_get_model_path_from parity, ml_agent.c:33-70)
            from nnstreamer_tpu_torch.platform import resolve_model_uri

            models = [resolve_model_uri(m) for m in models]
        fw_name = conf().resolve_alias(fw_name) or "auto"
        if fw_name in ("auto", ""):
            fw_name = self._detect_framework(models)
        fprops = FilterProperties(
            framework=fw_name,
            model_files=models,
            custom=str(self.properties.get("custom", "")),
            accelerator=str(self.properties.get("accelerator", "")),
            shared_key=self.properties.get("shared_tensor_filter_key"),
            invoke_dynamic=bool(self.properties.get("invoke_dynamic", False)),
            feed_depth=self._feed_depth(),
        )
        # user input/output overrides (input=dims input-type=...; :894-1030)
        if self.properties.get("input") and self.properties.get("inputtype"):
            fprops.input_info = TensorsInfo.from_strings(
                str(self.properties["input"]), str(self.properties["inputtype"]),
                self.properties.get("inputname"),
            )
        if self.properties.get("output") and self.properties.get("outputtype"):
            fprops.output_info = TensorsInfo.from_strings(
                str(self.properties["output"]), str(self.properties["outputtype"]),
                self.properties.get("outputname"),
            )
        # donation safety (the NNST802 lint's runtime counterpart): a tee
        # fan-out upstream — even behind queues — hands the SAME tensor
        # objects to sibling branches, which may still hold the buffer a
        # donating backend releases. Refuse at setup, loudly.
        from nnstreamer_tpu_torch.pipeline.planner import (
            donation_requested,
            upstream_fanout_holder,
        )

        if donation_requested(self.properties.get("custom", "")):
            holder = upstream_fanout_holder(self)
            if holder is not None:
                raise ElementError(
                    self.name,
                    f"custom=donate:1 is unsafe here: upstream "
                    f"{holder.name!r} fans the stream out, so a sibling "
                    f"branch can hold the input buffer a donating backend "
                    f"releases — drop donate:1 or move the tee below this "
                    f"filter")
        try:
            self.fw = acquire_framework(fw_name, fprops)
        except Exception as e:
            raise ElementError(self.name, f"cannot open framework {fw_name!r}: {e}")
        self._fw_props = fprops
        in_info, out_info = self.fw.get_model_info()
        self._in_info = fprops.input_info or in_info
        self._out_info = fprops.output_info or out_info
        self._invoke_count = 0
        self._latencies_us.clear()
        self._e2e_us.clear()
        # a restart re-opens the PRIMARY backend: degradation state resets
        # (trip totals stay cumulative for visibility)
        self._watchdog_consec = 0
        self._degraded_to = None
        # fused stages must survive a backend reopen (on-error=restart):
        # the upstream transforms are passthrough shells, so running the
        # reopened backend WITHOUT the stages would corrupt the stream
        if fprops.shared_key and (self._pre_specs or self._post_specs):
            # ...unless the reopen landed on a SHARED backend (a key added
            # after a private fused epoch): the planner never fuses shared
            # backends, so these specs are stale — drop them; the PLAYING
            # replan reactivates the upstream transforms
            log.warning("[%s] dropping fusion stages from a private epoch: "
                        "backend is now shared (key=%r)", self.name,
                        fprops.shared_key)
            self._fused_pre, self._fused_post = [], []
            self._pre_specs, self._post_specs = [], []
        else:
            self._reinstall_stages("reopened")
        # the chain across a reopen: a MID-STREAM reopen (on-error=restart)
        # reinstalls it — the members are live shells, so the reopened head
        # running without the chain would drop their math — or fails
        # loudly. On a cold start the PLAYING replan re-decides from
        # scratch after every member reopened, so stale specs are dropped
        # (raising would brick a restart whose point was to re-plan, e.g.
        # after chain-fusion=off); so is a chain on a backend that is now
        # shared (the planner never chain-fuses those)
        if self._chain_specs:
            mid_stream = (self.pipeline is not None
                          and getattr(self.pipeline.state, "name", "")
                          == "PLAYING")
            if fprops.shared_key or not mid_stream:
                self._chain_tail_elems, self._chain_specs = [], []
            elif not self.fw.fuse_chain(self._chain_specs,
                                        self._chain_in_shapes()):
                raise ElementError(
                    self.name, "reopened backend declined the installed "
                    "chain composition; downstream chain members are "
                    "fused-out shells and cannot be restored mid-stream")
        # the loop across a reopen: rebuilt on the fresh backend mid-stream
        # (a decline falls back loudly per-buffer, numerically identical);
        # a cold start drops it and the PLAYING replan re-decides
        if self._loop_state is not None:
            mid_stream = (self.pipeline is not None
                          and getattr(self.pipeline.state, "name", "")
                          == "PLAYING")
            if not mid_stream or not self._rebuild_loop("reopened"):
                self._loop_state = None
        # the mesh and the replica pool across a reopen: rebuilt on the
        # fresh backend mid-stream (a decline falls back loudly, with the
        # same outputs); a cold start drops them and the PLAYING replan
        # re-licenses through the analyzers
        mid_stream = (self.pipeline is not None
                      and getattr(self.pipeline.state, "name", "")
                      == "PLAYING")
        if self._shard_state is not None:
            if not mid_stream:
                self._shard_state = None
            elif not self.fw.build_shard(self._shard_state):
                log.warning("[%s] reopened backend declined the mesh "
                            "placement — unsharded execution", self.name)
                self._shard_state = None
        if self._replica_state is not None:
            if not mid_stream:
                self._replica_state = None
                self._stop_replica_workers()
            elif not self.fw.build_replicas(
                    self._replica_state["replicas"]):
                self._drop_replica_pool(
                    "reopened backend declined the replica pool")
            else:
                # a mid-stream reopen (on-error=restart) stopped the
                # workers in stop(): the rebuilt pool needs fresh ones
                self._start_replica_workers(self._replica_state["replicas"])

    def _reinstall_stages(self, what: str) -> None:
        """Put the installed stages back on a backend that was reopened or
        reloaded; fail loudly when it declines — the fused-out transforms
        cannot be restored mid-stream."""
        if (self._pre_specs or self._post_specs) and not self.fw.fuse_stages(
                self._pre_specs, self._post_specs):
            raise ElementError(
                self.name, f"{what} backend declined the installed fusion "
                "stages; upstream transforms are fused-out and cannot be "
                "restored mid-stream")

    def stop(self) -> None:
        if self._flush_timer is not None:
            self._flush_timer.cancel()
        # an armed canary dies with the stream — the flipped model stays
        # (stop is not a verdict; the decision ring already has 'started')
        self._rollout = None
        # replica workers drain their queued serve-batches (assembled,
        # clients waiting), then exit — before the backend is released
        # under them; a hung replica is abandoned after the bounded join
        self._stop_replica_workers()
        if self._wd_worker is not None:
            self._wd_worker[1].put(None)  # pill: the worker exits when free
            self._wd_worker = None
        with self._window_lock:
            self._flush_timer = None
            # banked windows were already dispatched: their frames exist
            # on the device and downstream (sinks stop AFTER this filter)
            # can still take them — emit rather than strand; a teardown
            # hiccup is logged, never raised out of stop(). Undispatched
            # partial rows are dropped like _pending (stop is not EOS)
            if self._loop_inflight:
                try:
                    self._drain_loop()
                except Exception:  # noqa: BLE001 — teardown best-effort
                    log.warning("[%s] draining %d in-flight loop window(s) "
                                "failed during stop()", self.name,
                                len(self._loop_inflight), exc_info=True)
            self._loop_rows = []
            self._loop_inflight.clear()
            if self.fw is not None:
                release_framework(self.fw, self._fw_props.shared_key)
                self.fw = None
            self._pending = []
            self._fetch_pending = []
            self._fetch_t = []
            self._feed_pending = []
            self._feed_t = []
        self._auto_window = 2
        self._last_flush_t = None

    def _detect_framework(self, models: List[str]) -> str:
        from nnstreamer_tpu_torch.filters.base import detect_framework

        try:
            return detect_framework(models)
        except ValueError as e:
            raise ElementError(self.name, str(e)) from e

    # -- fusion planner wiring (pipeline/planner.py) -----------------------
    def install_fusion(self, pre: List, pre_specs: List[tuple],
                       post: List, post_specs: List[tuple]) -> bool:
        """Attach fused pre/post transform stages to the open backend.
        Returns False (nothing changes anywhere) when the backend declines
        — the planner then leaves the transforms active."""
        if self.fw is None or not self.fw.fuse_stages(pre_specs, post_specs):
            return False
        self._fused_pre, self._fused_post = list(pre), list(post)
        self._pre_specs, self._post_specs = list(pre_specs), list(post_specs)
        return True

    # -- chain-fusion wiring (planner _plan_chain_fusion) -------------------
    def install_chain(self, tail_elems: List, stages: List[tuple]) -> bool:
        """Attach a composed downstream chain (gap-transform stage runs +
        whole-model stages) to the open backend. Returns False (nothing
        changes anywhere) when the backend declines — the planner then
        leaves every chain member live, per-filter behavior."""
        if self.fw is None or not self.fw.fuse_chain(
                stages, self._chain_in_shapes()):
            return False
        self._chain_tail_elems = list(tail_elems)
        self._chain_specs = list(stages)
        return True

    def clear_chain(self) -> None:
        self._chain_tail_elems, self._chain_specs = [], []
        if self.fw is not None:
            self.fw.fuse_chain([])

    def _chain_in_shapes(self):
        """The per-invoke input signature (micro-batched, as _flush_batch
        assembles it) where it is known statically, for the backend's
        data-free composition check; None otherwise."""
        from nnstreamer_tpu_torch.analysis.costmodel import _batched_shape

        info = self._loop_in_info()
        if info is None or any(int(d) <= 0 for t in info
                               for d in t.np_shape()):
            return None
        return [_batched_shape(tuple(int(d) for d in t.np_shape()),
                               self._batch_size(), t.dtype.np_dtype)
                for t in info]

    def _recompose_chain_head(self) -> None:
        """After this chain-fused shell's backend changed (reload-model),
        rebuild the head's composition so the next invoke runs the CURRENT
        tail model instead of the stale one. Fails loudly when the head
        cannot recompose (the new model's shapes break the link) — a
        silently stale composition is stream corruption."""
        head = (self.pipeline.elements.get(self._fused_into)
                if self.pipeline is not None else None)
        if head is None or not head._chain_specs:
            return
        with head._window_lock:
            if head.fw is None or not head.fw.fuse_chain(
                    head._chain_specs, head._chain_in_shapes()):
                raise ElementError(
                    self.name,
                    f"chain head {self._fused_into!r} could not recompose "
                    f"after this member's reload (shape/dtype no longer "
                    f"links, or the backend declined) — re-plan with "
                    f"chain-fusion=off or reload a compatible model")

    def _map_caps_through_chain(self, caps: Caps) -> Caps:
        """Chain-head src caps: this filter emits the END of the fused
        chain, so its out caps carry every claimed member's effect (gap
        transforms map per-tensor info; member filters run their own caps
        transform — the shells pass caps through untouched, so downstream
        negotiates against what actually flows)."""
        from nnstreamer_tpu_torch.elements.transform import TensorTransform

        for m in self._chain_tail_elems:
            if isinstance(m, TensorTransform):
                cfg = caps.to_config()
                info = TensorsInfo(
                    tensors=[m._transform_info(t) for t in cfg.info],
                    format=cfg.info.format)
                caps = Caps.from_config(
                    TensorsConfig(info, cfg.rate_n, cfg.rate_d))
            else:
                with m._window_lock:
                    caps = m._transform_caps_locked(None, caps)
        return caps

    # -- steady-loop wiring (planner _plan_steady_loop) ---------------------
    def install_loop(self, window: int, depth: int) -> bool:
        """Install the window program on the open backend. Returns False
        (per-buffer behavior, nothing changes) when the backend declines —
        the loop fallback is always numerically safe."""
        if self.fw is None or not self.fw.build_loop(
                int(window), max(1, int(depth)), self._loop_in_info()):
            return False
        self._loop_state = {"window": int(window), "depth": max(1, int(depth))}
        self._drain_aot_events()
        return True

    # -- mesh-partition wiring (planner _plan_sharding) --------------------
    def install_shard(self, cfg: dict) -> bool:
        """Install the NNST470-licensed mesh placement on the open
        backend. False (unsharded, nothing changes) when it declines."""
        if self.fw is None or not self.fw.build_shard(dict(cfg)):
            return False
        self._shard_state = {"mode": str(cfg["mode"]),
                             "dp": int(cfg["dp"]), "tp": int(cfg["tp"])}
        self._drain_aot_events()
        return True

    def clear_shard(self) -> None:
        self._shard_state = None
        if self.fw is not None:
            self.fw.build_shard(None)

    def _shard_devices(self) -> int:
        """dp-axis width of the installed mesh — the shard count one host
        payload splits across (billed per device on the tracer); 1 when
        unsharded."""
        state = self._shard_state
        return int(state["dp"]) if state else 1

    # -- replica-pool wiring (planner _plan_pool) --------------------------
    def install_replicas(self, n: int) -> bool:
        """Install the NNST960-licensed replica pool on the open backend
        and start one dispatch worker per replica. False (single-replica,
        nothing changes) when the backend declines."""
        if self.fw is None or not self.fw.build_replicas(int(n)):
            return False
        self._replica_state = {"replicas": int(n)}
        self._start_replica_workers(int(n))
        self._drain_aot_events()
        return True

    def clear_replicas(self) -> None:
        self._replica_state = None
        self._stop_replica_workers()
        if self.fw is not None:
            self.fw.build_replicas(0)

    def _drain_aot_events(self) -> None:
        """Forward the backend's compile-cache outcome records (hit/miss/
        load-ms/compile-ms per resolution) to the pipeline tracer's
        ``aot`` section. Cheap when there is nothing to drain — called
        from the invoke path and the composition install points."""
        take = getattr(self.fw, "take_aot_events", None)
        if take is None:
            return
        events = take()
        if not events:
            return
        tracer = (getattr(self.pipeline, "tracer", None)
                  if self.pipeline is not None else None)
        if tracer is not None and hasattr(tracer, "record_aot"):
            for ev in events:
                tracer.record_aot(self.name, ev)

    def _prefetch_swap_aot(self, model: Optional[str] = None) -> None:
        """Warm the compile cache for an incoming model swap (reload-model's
        model B, or the fallback framework re-opening the current model)
        BEFORE the serving backend is torn down: the child process builds
        while frames still flow, and the swapped-in program's first invoke
        is a cache load. Best effort — a backend without the hook, or a
        failed prefetch, just pays the cold start."""
        pf = getattr(self.fw, "aot_prefetch", None)
        if pf is None:
            return
        try:
            pf(model)
        except Exception as e:  # noqa: BLE001 — warmup must never break
            # the swap machinery it exists to accelerate
            log.warning("[%s] AOT swap prefetch failed (%s)", self.name,
                        str(e).splitlines()[0][:120])
        self._drain_aot_events()

    def _drop_replica_pool(self, why: str) -> None:
        """Mid-stream pool teardown (reopen or fallback decline): clear
        this filter's replica state AND the serving source's, so the
        scheduler stops stamping ``serve_replica``."""
        log.warning("[%s] %s — single-replica serving", self.name, why)
        self._replica_state = None
        self._stop_replica_workers()
        from nnstreamer_tpu_torch.analysis.pool import serving_src_for_filter

        src = serving_src_for_filter(self)
        if src is not None and getattr(src, "_pool_state", None):
            src.clear_pool()
            src._pool_refused = ("NNST961", why)

    def _start_replica_workers(self, n: int) -> None:
        import queue as _queue

        self._stop_replica_workers()
        workers = []
        for r in range(int(n)):
            # bounded inbox: the streaming thread blocks (backpressure)
            # rather than piling batches onto one replica
            q: "_queue.Queue" = _queue.Queue(maxsize=2)
            t = threading.Thread(target=self._replica_worker, args=(r, q),
                                 daemon=True,
                                 name=f"replica:{self.name}:r{r}")
            t.start()
            workers.append((t, q))
        self._replica_workers = workers

    def _stop_replica_workers(self) -> None:
        import queue as _queue

        workers, self._replica_workers = self._replica_workers, []
        for _, q in workers:
            q.put(None)  # pill after the queued batches: drain, then exit
        cur = threading.current_thread()
        for t, _ in workers:
            if t is not cur:  # a worker tearing the pool down must not
                t.join(timeout=5.0)  # join itself
        # a dispatch can race the teardown and land behind the pill:
        # shed those batches instead of stranding their clients
        for _, q in workers:
            while True:
                try:
                    item = q.get_nowait()
                except _queue.Empty:
                    break
                try:
                    if item is not None:
                        self._shed_replica_batch(item[0], "draining")
                finally:
                    q.task_done()

    def _shed_replica_batch(self, buf: Buffer, reason: str) -> None:
        """Tell a stranded serve-batch's clients now (SERVER_BUSY with
        ``reason``) and release the replica's in-flight slot."""
        routes = buf.meta.get("serve_routes")
        key = buf.meta.get("serve_server")
        if not routes or key is None:
            return
        from nnstreamer_tpu_torch.elements.query import get_scheduler

        sched = get_scheduler(str(key))
        if sched is not None:
            sched.shed_batch(routes, reason)
            sched.note_reply_batch(None,
                                   replica=buf.meta.get("serve_replica"))

    def _replica_worker(self, r: int, q) -> None:
        """One replica's dispatch loop: invoke on replica ``r`` under its
        CUDA stream, materialize at the boundary, push downstream — all
        off the streaming thread, so N replicas overlap their device legs
        and a slow replica stalls only itself."""
        while True:
            item = q.get()
            try:
                if item is None:
                    return
                buf, tensors, inputs = item
                lockwitness.handoff_recv(
                    "filter.replica_inbox", item,
                    [t for t in inputs if hasattr(t, "flags")])
                stream = self.fw.replica_stream(r)
                try:
                    with (torch.cuda.stream(stream) if stream is not None
                          else contextlib.nullcontext()):
                        outputs = self._invoke(inputs, replica=r)
                        self._emit_now(buf, tensors, outputs)
                except Exception as e:  # noqa: BLE001 — worker thread:
                    # the error must reach the policy machinery AND the
                    # batch's waiting clients, never vanish with the thread
                    try:
                        self._replica_batch_error(r, buf, tensors, inputs,
                                                  e)
                    except Exception:  # noqa: BLE001 — the worker loop
                        # must survive its own error path
                        log.exception("[%s] replica %d error handling "
                                      "failed", self.name, r)
            finally:
                q.task_done()

    def _replica_batch_error(self, r: int, buf: Buffer, tensors, inputs,
                             err) -> None:
        """A replica worker's invoke failed: the element's on-error policy
        off-thread — ``retry:<N>`` re-invokes the same batch with backoff,
        ``drop`` sheds the batch's clients with SERVER_BUSY (reason
        ``replica-error``), ``restart`` reopens the element and sheds this
        batch, ``abort`` escalates to a pipeline fatal."""
        kind, retries = self.error_policy()
        if kind == "retry":
            base = float(self.properties.get(
                "retry_backoff_ms", self.DEFAULT_RETRY_BACKOFF_MS)) / 1e3
            for attempt in range(retries):
                self.error_stats["retries"] += 1
                self._note_fault("retry", err, policy=kind, replica=r,
                                 attempt=attempt + 1)
                time.sleep(base * (2 ** attempt))
                try:
                    outputs = self._invoke(inputs, replica=r)
                    self._emit_now(buf, tensors, outputs)
                    return  # the retry cured it
                except Exception as e2:  # noqa: BLE001 — next attempt
                    err = e2
            kind = "abort"  # exhausted: escalate like the inline path
        self.error_stats["dropped"] += 1
        self._note_fault("replica-error", err, replica=r,
                         count=self.error_stats["dropped"])
        self.post_message("replica-error", {
            "replica": r, "error": str(err),
            "dropped": self.error_stats["dropped"]})
        # whatever the policy, THIS batch's clients learn now
        self._shed_replica_batch(buf, "replica-error")
        if kind == "drop":
            return
        if kind == "restart":
            self._dispatch_error(None, None, err)
            return
        if self.pipeline is not None:  # abort
            self.pipeline.post_fatal(self.name, err)

    def clear_loop(self) -> None:
        self._loop_state = None
        if self.fw is not None:
            self.fw.build_loop(0)

    def _rebuild_loop(self, what: str) -> bool:
        """Rebuild the installed window on a reopened or reloaded backend;
        a decline is a loud per-buffer fallback, never a failure."""
        if self.fw.build_loop(self._loop_state["window"],
                              self._loop_state["depth"],
                              self._loop_in_info()):
            return True
        log.warning("[%s] %s backend declined the window program — "
                    "per-buffer launches", self.name, what)
        return False

    def _loop_in_info(self) -> Optional[TensorsInfo]:
        """The per-frame signature the window stacks, where it is known
        statically (the sink caps, live or from the dry negotiation): the
        backend checks and captures the window at it up front."""
        from nnstreamer_tpu_torch.analysis.costmodel import _caps_input_info

        return _caps_input_info(self)

    def clear_fusion(self) -> None:
        self._fused_pre, self._fused_post = [], []
        self._pre_specs, self._post_specs = [], []
        if self.fw is not None:
            self.fw.fuse_stages([], [])

    def _map_info_through(self, info: TensorsInfo, chain: List) -> TensorsInfo:
        """Map a TensorsInfo through a fused transform chain's per-tensor
        info transforms (caps stay honest while the math runs on device)."""
        if info.num_tensors == 0:
            return info
        for t in chain:
            info = TensorsInfo(
                tensors=[t._transform_info(ti) for ti in info],
                format=info.format)
        return info

    # -- residency negotiation (memory:HBM lane) ---------------------------
    def _fw_device_capable(self) -> bool:
        if self.fw is not None:
            return bool(getattr(self.fw, "DEVICE_CAPABLE", False))
        # before the backend opens (static analysis) the framework
        # property is the best hint
        return str(self.properties.get("framework", "")) in ("jax",
                                                              "torch_cuda")

    def accepts_device(self, pad: Pad) -> bool:
        return self._fw_device_capable()

    def produces_device(self, pad: Pad) -> bool:
        # sync=1 materializes every output in _emit_now, invoke_dynamic
        # wraps outputs into flexible host bytes and a looped filter
        # drains its windows to the host — never stamp memory:HBM on a
        # stream that will actually carry host data. A chain-fused shell
        # produces nothing of its own: residency propagates through it by
        # transparency (is_transparent), as through a fused transform
        return (self._fused_into is None
                and self._loop_state is None
                and self._fw_device_capable()
                and not self.properties.get("sync")
                and not self.properties.get("invoke_dynamic"))

    def _src_device_ok(self):
        """Downstream residency verdict for the (single) src pad: True =
        hand device tensors through untouched, False = this filter is the
        materialization boundary, None = unplanned."""
        return self.src_pads[0].device_ok if self.src_pads else None

    def _outputs_cross_here(self, strict: bool = False) -> bool:
        """Will outputs land on the host AT this element? sync=1 and
        invoke_dynamic always materialize here; otherwise the planner's
        verdict decides. strict=True means definitely (a planned
        boundary); strict=False also counts an undetermined lane
        (device_ok None — unplanned graph, where the host consumers
        fetch) — the window-engage predicate. THE single spelling of this
        gate: every materialization site calls it."""
        if self.properties.get("sync") or self.properties.get("invoke_dynamic"):
            return True
        ok = self._src_device_ok()
        return ok is False if strict else ok is not True

    # -- negotiation -------------------------------------------------------
    def transform_caps(self, pad: Pad, caps: Caps) -> Optional[Caps]:
        """Fixed sink caps → src caps from the model's output info
        (gst_tensor_filter_configure_tensor tensor_filter.c:953)."""
        if self._fused_into is not None:
            # chain-fused shell: the head's src caps already carry this
            # member's effect; caps (like buffers) pass through untouched
            return caps
        with self._window_lock:
            return self._transform_caps_locked(pad, caps)

    def _transform_caps_locked(self, pad: Pad, caps: Caps) -> Optional[Caps]:
        config = caps.to_config()
        self._in_config = config
        in_info = config.info
        # input-combination narrows what the model sees (:716-758)
        sel = self.properties.get("input_combination")
        if sel and in_info.num_tensors > 0:
            idx = [int(i) for i in str(sel).split(",")]
            in_info = TensorsInfo(tensors=[in_info.tensors[i] for i in idx],
                                  format=in_info.format)
        if self._fused_pre:
            # fused upstream transforms pass caps through untouched; the
            # model sees the POST-stage info (the backend applies the
            # stages on the device before the model)
            in_info = self._map_info_through(in_info, self._fused_pre)
        if config.format == TensorFormat.STATIC and in_info.num_tensors > 0:
            if self._in_info is not None and self._in_info.num_tensors > 0:
                if not (self._in_info == in_info):
                    # model disagrees: try reshape (SET_INPUT_INFO :418-441)
                    if self.fw is not None and self.fw.RESHAPABLE:
                        self._in_info, self._out_info = self.fw.set_input_info(in_info)
                    else:
                        raise ElementError(
                            self.name,
                            f"incoming tensors {in_info.dimensions_string()}/"
                            f"{in_info.types_string()} do not match model input "
                            f"{self._in_info.dimensions_string()}/{self._in_info.types_string()}",
                        )
            elif self.fw is not None and self.fw.RESHAPABLE:
                self._in_info, self._out_info = self.fw.set_input_info(in_info)
        if self.properties.get("invoke_dynamic"):
            # flexible output: each tensor carries its own meta header
            return Caps.from_config(TensorsConfig(
                TensorsInfo(format=TensorFormat.FLEXIBLE),
                rate_n=config.rate_n, rate_d=config.rate_d))
        if self._out_info is None:
            raise ElementError(self.name, "cannot determine output info")
        out_info = self._out_info
        # output-combination mixes inputs back into the output caps (:850-869)
        ocomb = self.properties.get("output_combination")
        if ocomb:
            tensors = []
            for tok in str(ocomb).split(","):
                tok = tok.strip()
                if tok.startswith("i"):
                    tensors.append(config.info.tensors[int(tok[1:])])
                else:
                    tensors.append(out_info.tensors[int(tok[1:]) if tok.startswith("o") else int(tok)])
            out_info = TensorsInfo(tensors=tensors)
        if self._fused_post:
            # fused downstream transforms run inside the backend: this
            # filter's src caps already carry their effect
            out_info = self._map_info_through(out_info, self._fused_post)
        out_caps = Caps.from_config(
            TensorsConfig(out_info, config.rate_n, config.rate_d))
        if self._chain_tail_elems:
            # chain head: the emitted buffers are the END of the fused
            # chain — map the caps through every claimed member
            out_caps = self._map_caps_through_chain(out_caps)
        return out_caps

    # -- events ------------------------------------------------------------
    def _on_sink_event(self, pad: Pad, event: Event) -> None:
        if event.type == "rollout-model":
            self._handle_rollout_event(pad, event)
            return
        if event.type == "reload-model":
            new_model = event.data.get("model")
            if new_model:
                # prefetch model B's program(s) into the compile cache
                # while model A STILL SERVES — before taking the window
                # lock, so the hot loop keeps streaming through the child
                # build; the reopened backend's first invoke then LOADS
                self._prefetch_swap_aot(str(new_model))
            # serialized with the hot loop: frames already batched or
            # uploaded for the OLD model invoke against it, and held
            # window entries are emitted, before the swap
            with self._window_lock:
                if self._loop_rows:
                    self._dispatch_loop_window()
                if self._loop_inflight:
                    self._drain_loop()
                if self._pending:
                    self._flush_batch(self._batch_size())
                if self._feed_pending:
                    self._drain_feed()
                if self._fetch_pending:
                    self._flush_fetch_window()
                if new_model:
                    self.properties["model"] = new_model
                    self._fw_props.model_files = str(new_model).split(",")
                    if (self.fw.props is not None
                            and self.fw.props is not self._fw_props):
                        self.fw.props.model_files = list(
                            self._fw_props.model_files)
                self.fw.handle_event("reload_model")
                # the reload's close() dropped the installed stages and
                # chain while the claimed elements stay passthrough shells
                self._reinstall_stages("reloaded")
                if self._chain_specs and not self.fw.fuse_chain(
                        self._chain_specs, self._chain_in_shapes()):
                    raise ElementError(
                        self.name, "reloaded backend declined the installed "
                        "chain composition; downstream chain members are "
                        "fused-out shells")
                if self._loop_state is not None and \
                        not self._rebuild_loop("reloaded"):
                    self._loop_state = None
                # the mesh and the replica pool re-place the reloaded
                # model; a decline falls back loudly (the same outputs)
                if self._shard_state is not None and \
                        not self.fw.build_shard(self._shard_state):
                    log.warning("[%s] reloaded backend declined the mesh "
                                "placement — unsharded execution",
                                self.name)
                    self._shard_state = None
                if self._replica_state is not None and \
                        not self.fw.build_replicas(
                            self._replica_state["replicas"]):
                    self._drop_replica_pool(
                        "reloaded backend declined the replica pool")
            if self._fused_into is not None:
                # chain-fused SHELL reloaded: its model runs inside the
                # HEAD's composition, which still holds the old model —
                # rebuild it (it resolves this reloaded backend; a captured
                # window recaptures). Taken OUTSIDE this element's lock:
                # head→member is the caps-mapping lock order, and inverting
                # it here could deadlock a concurrent renegotiation
                self._recompose_chain_head()
            self._drain_aot_events()
            self.post_message("model-reloaded", {"model": new_model})
            return
        super()._on_sink_event(pad, event)

    # -- nnfleet-r safe rollout --------------------------------------------
    def _handle_rollout_event(self, pad: Pad, event: Event) -> None:
        """Safe versioned hot-swap: AOT-prefetch + drain + flip to model B
        (the reload-model machinery, reused as it is), then arm the canary
        window — N frames watched on the pipeline fault ledger and the
        serving tier's admitted-p99. A regression inside the window rolls
        back to A (``rollout-rollback=auto``): A's program is still in the
        compile cache, so the rollback is a warm load, not a build."""
        new_model = str(event.data.get("model")
                        or self.properties.get("rollout_model") or "")
        if not new_model:
            raise ElementError(
                self.name,
                "rollout-model event without a candidate: set "
                "rollout-model= or carry model in the event data")
        old_model = str(self.properties.get("model") or "")
        canary = int(event.data.get(
            "canary_frames",
            self.properties.get("rollout_canary_frames",
                                self.ROLLOUT_CANARY_FRAMES)
            or 0))
        rollback = str(event.data.get(
            "rollback",
            self.properties.get("rollout_rollback", "auto") or "auto"))
        sched = self._rollout_sched()
        now = time.monotonic()
        # pre-flip baselines: the monotonic fault counter (ring length
        # lies once it wraps) and the last-30s admitted-p99
        baseline_faults = self._bus_fault_total()
        baseline_p99 = (sched.recent_wait_p99(now - 30.0)
                        if sched is not None else None)
        slo_ms = 0
        if sched is not None:
            slo_ms = int(sched.health_snapshot().get("slo_ms", 0) or 0)
        t0 = time.perf_counter()
        try:
            self._on_sink_event(pad, Event("reload-model",
                                           {"model": new_model}))
        except Exception as e:  # noqa: BLE001 — a flip that failed half-
            # way must not strand the pipeline on a broken backend: put
            # A back (warm AOT load) and surface the decision
            log.warning("[%s] rollout flip to %s failed (%s) — restoring "
                        "%s", self.name, new_model, e, old_model)
            self._on_sink_event(pad, Event("reload-model",
                                           {"model": old_model}))
            self._record_rollout({
                "decision": "rolled-back", "model": new_model,
                "old_model": old_model, "reason": f"flip failed: {e}",
                "frames_used": 0, "flip_ms": round(
                    (time.perf_counter() - t0) * 1e3, 3)})
            self._note_rollout_fault()
            self.post_message("rollout-rolled-back", {
                "model": new_model, "old_model": old_model,
                "reason": f"flip failed: {e}"})
            return
        flip_ms = round((time.perf_counter() - t0) * 1e3, 3)
        started = {
            "decision": "started", "model": new_model,
            "old_model": old_model, "canary_frames": canary,
            "rollback": rollback, "flip_ms": flip_ms,
            "baseline_p99_ms": baseline_p99, "slo_ms": slo_ms,
        }
        self._record_rollout(started)
        self.post_message("rollout-started", dict(started))
        if canary <= 0:
            # no canary window: the flip IS the promotion (the NNST981
            # hazard when rollback=auto — nothing can ever trigger it)
            self._record_rollout({
                "decision": "promoted", "model": new_model,
                "old_model": old_model, "frames_used": 0,
                "reason": "no canary window"})
            self.post_message("rollout-promoted", {"model": new_model})
            return
        self._rollout = {
            "old_model": old_model, "model": new_model,
            "frames_left": canary, "canary_frames": canary,
            "baseline_faults": baseline_faults,
            "baseline_p99": baseline_p99, "slo_ms": slo_ms,
            "since": now, "rollback": rollback, "sched": sched,
        }

    def _rollout_sched(self):
        """The serving scheduler feeding this filter's admitted-p99 canary
        leg, or None (fault-ledger-only canary outside the serving tier)."""
        from nnstreamer_tpu_torch.analysis.pool import serving_src_for_filter

        src = serving_src_for_filter(self)
        return getattr(src, "_sched", None) if src is not None else None

    def _bus_fault_total(self) -> int:
        bus = (getattr(self.pipeline, "bus", None)
               if self.pipeline is not None else None)
        if bus is None or not hasattr(bus, "fault_total"):
            return 0
        return bus.fault_total()

    def _record_rollout(self, event: dict) -> None:
        tracer = (getattr(self.pipeline, "tracer", None)
                  if self.pipeline is not None else None)
        if tracer is not None and hasattr(tracer, "record_rollout"):
            tracer.record_rollout(self.name, event)

    def _note_rollout_fault(self) -> None:
        tracer = (getattr(self.pipeline, "tracer", None)
                  if self.pipeline is not None else None)
        if tracer is not None:
            tracer.record_fault(self.name, "rollout-rollback")
        if self.pipeline is not None:
            self.pipeline.bus.record_fault(
                self.name, "rollout-rollback", "model restored")

    def _rollout_tick(self, pad: Pad) -> None:
        """Per-frame canary check (active rollout only): the pipeline-wide
        monotonic fault counter must not advance, and the admitted-p99
        since the flip must stay under the SLO gate (or 2x the pre-flip
        baseline when no SLO is configured). Cheap: two counter reads,
        plus a bounded percentile over the scheduler's recent-wait ring
        when serving."""
        ro = self._rollout
        if ro is None:
            return
        fault_delta = self._bus_fault_total() - ro["baseline_faults"]
        if fault_delta > 0:
            self._rollout_regressed(
                pad, f"fault ledger advanced (+{fault_delta}) during "
                     f"canary", fault_delta=fault_delta)
            return
        sched = ro["sched"]
        if sched is not None:
            p99 = sched.recent_wait_p99(ro["since"])
            gate = float(ro["slo_ms"] or 0.0)
            if gate <= 0.0 and ro["baseline_p99"]:
                gate = 2.0 * float(ro["baseline_p99"])
            if p99 is not None and gate > 0.0 and p99 > gate:
                self._rollout_regressed(
                    pad, f"admitted p99 {p99:.1f}ms over gate "
                         f"{gate:.1f}ms during canary", p99_ms=p99)
                return
        ro["frames_left"] -= 1
        if ro["frames_left"] <= 0:
            self._rollout = None
            done = {
                "decision": "promoted", "model": ro["model"],
                "old_model": ro["old_model"],
                "frames_used": ro["canary_frames"],
                "p99_ms": (sched.recent_wait_p99(ro["since"])
                           if sched is not None else None),
            }
            self._record_rollout(done)
            self.post_message("rollout-promoted", dict(done))

    def _rollout_regressed(self, pad: Pad, reason: str, **observed) -> None:
        """Canary verdict: regression. ``rollback=auto`` restores model A
        through the same drain-and-flip (warm AOT load — milliseconds);
        ``rollback=off`` records the verdict and keeps B serving."""
        ro, self._rollout = self._rollout, None
        frames_used = ro["canary_frames"] - ro["frames_left"]
        if ro["rollback"] != "auto":
            rec = {"decision": "regressed", "model": ro["model"],
                   "old_model": ro["old_model"], "reason": reason,
                   "frames_used": frames_used, **observed}
            self._record_rollout(rec)
            self.post_message("rollout-regressed", dict(rec))
            return
        t0 = time.perf_counter()
        self._on_sink_event(pad, Event("reload-model",
                                       {"model": ro["old_model"]}))
        rec = {"decision": "rolled-back", "model": ro["model"],
               "old_model": ro["old_model"], "reason": reason,
               "frames_used": frames_used,
               "rollback_ms": round((time.perf_counter() - t0) * 1e3, 3),
               **observed}
        self._record_rollout(rec)
        self._note_rollout_fault()
        self.post_message("rollout-rolled-back", dict(rec))

    def on_upstream_event(self, pad: Pad, event: Event) -> None:
        if event.type == "qos":
            # QoS throttling (gst_tensor_filter_check_throttling_delay :512)
            self._qos_earliest = max(self._qos_earliest, int(event.data.get("earliest", -1)))
        self.send_upstream_event(event)

    # -- hot loop ----------------------------------------------------------
    def chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        """Timing shim around the hot loop: tracks the idle/busy EWMAs the
        fetch-window=auto regime detector reads (_stream_saturated)."""
        if self._fused_into is not None:
            # chain-fused shell: this filter's model already ran inside
            # the head's composition — buffers pass through untouched (no
            # invoke, no batching, no windows)
            return self.push(buf)
        t_in = time.perf_counter()
        if self._chain_exit_t is not None:
            idle = max(0.0, t_in - self._chain_exit_t)
            self._arr_idle_ewma = (
                idle if self._arr_idle_ewma is None
                else 0.8 * self._arr_idle_ewma + 0.2 * idle)
        try:
            try:
                ret = self._chain_impl(pad, buf)
            except Exception as e:  # noqa: BLE001 — the canary absorbs the
                # failing frame: an invoke raise during an armed rollout
                # is the regression the window exists to catch — rolling
                # back (and dropping this one frame) keeps the stream
                # alive on model A instead of killing the pipeline
                if (self._rollout is not None
                        and self._rollout["rollback"] == "auto"):
                    self._rollout_regressed(
                        pad, f"invoke raised during canary: {e}")
                    if buf.meta.get("serve_routes"):
                        # serving batch: tell the waiting clients NOW
                        # (SERVER_BUSY) — a silent drop would strand them
                        # until their own timeout
                        self._shed_replica_batch(buf, "rollout-rollback")
                    return FlowReturn.DROPPED
                raise
            if self._rollout is not None:
                self._rollout_tick(pad)
            return ret
        finally:
            t_out = time.perf_counter()
            busy = t_out - t_in
            self._arr_busy_ewma = (
                busy if self._arr_busy_ewma is None
                else 0.8 * self._arr_busy_ewma + 0.2 * busy)
            self._chain_exit_t = t_out

    def _stream_saturated(self) -> bool:
        """True when upstream never waits on us (idle ≪ busy): the
        throughput/finite-stream regime where fetch-window growth cannot
        hurt a live consumer (there is none pacing the stream)."""
        return (self._arr_idle_ewma is not None
                and self._arr_busy_ewma is not None
                and self._arr_idle_ewma < 0.1 * self._arr_busy_ewma)

    def _chain_impl(self, pad: Pad, buf: Buffer) -> FlowReturn:
        if self.fw is None:
            return FlowReturn.NOT_NEGOTIATED
        # QoS drop (tensor_filter.c:512 → FLOW_DROPPED)
        if self._qos_earliest > 0 and 0 <= buf.pts < self._qos_earliest:
            return FlowReturn.DROPPED
        if self._measuring():
            # arrival stamp for the e2e latency window (rides the buffer
            # through batching, upload and fetch-window holds to _emit_now)
            buf._nns_t_in = time.monotonic()
        tensors = list(buf.tensors)
        fmt = self._in_config.format if self._in_config else TensorFormat.STATIC
        if fmt == TensorFormat.FLEXIBLE:
            # strip per-tensor headers (:706-708)
            tensors = [meta_mod.unwrap_flexible(t)[0] if isinstance(t, (bytes, bytearray, memoryview)) else t
                       for t in tensors]
        elif self._in_config is not None and self._in_config.info.num_tensors == len(tensors):
            # bytes payloads on static streams: view as typed arrays
            tensors = [
                np.frombuffer(bytes(t), dtype=i.dtype.np_dtype).reshape(i.np_shape())
                if isinstance(t, (bytes, bytearray, memoryview)) else t
                for t, i in zip(tensors, self._in_config.info)
            ]
        # input-combination selection (:716-758)
        sel = self.properties.get("input_combination")
        inputs = [tensors[int(i)] for i in str(sel).split(",")] if sel else tensors
        # replica-pool dispatch: a serve-batch the scheduler stamped with
        # its least-loaded replica goes to THAT replica's inbox and the
        # streaming thread returns to assemble the next batch. Buffers
        # without the stamp take the inline path on the solo model
        rep = buf.meta.get("serve_replica")
        workers = self._replica_workers
        if rep is not None and self._replica_state is not None and workers:
            item = (buf, tensors, inputs)
            # the batch's host arrays cross to the worker here: a
            # sender-side alias mutating them in flight is NNST612
            lockwitness.handoff_send(
                "filter.replica_inbox", item,
                [t for t in inputs if hasattr(t, "flags")])
            workers[int(rep) % len(workers)][1].put(item)
            return FlowReturn.OK
        batch = self._batch_size()
        with self._window_lock:
            if self._loop_state is not None:
                # steady loop: frames collect into the window; the loop
                # owns both transfer amortizers, so the batch/feed/fetch
                # paths below never see these frames
                ret = self._loop_feed(buf, tensors, inputs)
                if self._loop_rows or self._loop_inflight:
                    self._arm_flush_timer()
                return ret
            if batch > 1:
                if self._pending and self._pending[-1][0] is buf:
                    # on-error retry re-chains the batch's trigger buffer
                    # and the failed flush restored the rows — replace the
                    # trigger's row instead of duplicating the frame
                    self._pending[-1] = (buf, tensors, inputs)
                else:
                    self._pending.append((buf, tensors, inputs))
                if len(self._pending) < batch:
                    self._arm_flush_timer()
                    return FlowReturn.OK
                ret = self._flush_batch(batch)
            elif self._feed_depth() > 1:
                ret = self._feed(None, buf, tensors, inputs)
            else:
                outputs = self._invoke(inputs)
                ret = self._emit(buf, tensors, outputs)
            if self._pending or self._fetch_pending or self._feed_pending:
                self._arm_flush_timer()
            return ret

    def _measuring(self) -> bool:
        return any(self.properties.get(k) for k in
                   ("latency", "throughput", "latency_report", "latency_e2e"))

    def _batch_size(self) -> int:
        return int(self.properties.get("batch_size", 1) or 1)

    # -- upload window (feed-depth) ----------------------------------------
    def _feed_depth(self) -> int:
        return int(self.properties.get("feed_depth", 1) or 1)

    def _feed(self, rows, buf, tensors, inputs) -> FlowReturn:
        """feed-depth > 1: start the host→device transfer NOW (backend
        ``prefetch``, non-blocking) and park the entry in the bounded
        in-flight queue; the oldest entry invokes once the queue holds
        ``feed-depth`` uploads, so uploads overlap earlier compute."""
        spans = self._spans()
        t_pf = time.perf_counter() if spans is not None else 0.0
        try:
            handle = self.fw.prefetch(inputs)
        except Exception as e:
            raise ElementError(self.name, f"prefetch failed: {e}") from e
        if handle is not None and any(not is_backend_tensor(x) for x in inputs):
            host_bytes = nbytes_of(
                [x for x in inputs if not is_backend_tensor(x)])
            # the upload started here, not at invoke: bill it here (split
            # per shard when a mesh is installed)
            self._record_crossing("h2d", nbytes=host_bytes,
                                  devices=self._shard_devices())
            if spans is not None:
                # the host side of the non-blocking upload (staging); the
                # copy itself completes on the device's copy stream
                spans.emit("h2d", "h2d", t_pf, time.perf_counter(),
                           args={"element": self.name,
                                 "nbytes": host_bytes})
        if handle is None and not self._feed_pending:
            # backend has no prefetch hook (or declined): nothing is in
            # flight to overlap — invoke inline
            return self._invoke_entry(rows, buf, tensors, inputs)
        # a declined prefetch behind queued entries still joins the queue:
        # bypassing it would reorder the stream
        self._feed_pending.append(
            (rows, buf, tensors, handle if handle is not None else inputs))
        self._feed_t.append(time.perf_counter())
        ret = FlowReturn.OK
        while len(self._feed_pending) >= self._feed_depth():
            ret = self._pop_feed()
            if ret not in (FlowReturn.OK, FlowReturn.DROPPED):
                break
        return ret

    def _pop_feed(self) -> FlowReturn:
        """Invoke + emit the oldest in-flight upload. Its hold time is the
        upload-window residency (tracer ``upload-window:<name>``);
        `latency-e2e` includes it (the arrival stamp rides the buffer)."""
        rows, buf, tensors, payload = self._feed_pending.pop(0)
        t0 = self._feed_t.pop(0)
        tracer = (getattr(self.pipeline, "tracer", None)
                  if self.pipeline else None)
        if tracer is not None:
            tracer.record_residency(f"upload-window:{self.name}",
                                    time.perf_counter() - t0)
        return self._invoke_entry(rows, buf, tensors, payload)

    def _drain_feed(self) -> FlowReturn:
        """Invoke every in-flight upload in order (EOS, quiescence,
        reload): no stranded frames."""
        ret = FlowReturn.OK
        while self._feed_pending:
            ret = self._pop_feed()
            if ret not in (FlowReturn.OK, FlowReturn.DROPPED):
                break
        return ret

    def _invoke_entry(self, rows, buf, tensors, payload) -> FlowReturn:
        """Invoke one queue entry: a single frame (rows None) or a whole
        micro-batch (rows = the pending (buf, tensors, inputs) list)."""
        if rows is None:
            return self._emit(buf, tensors, self._invoke(payload))
        outputs = self._invoke(payload, frames=len(rows))
        return self._emit_batch_rows(rows, outputs)

    # -- steady loop (loop-window / launch-depth) ---------------------------
    def _loop_feed(self, buf, tensors, inputs) -> FlowReturn:
        """Collect one frame into the loop window; a full window
        dispatches as ONE window program (ops/steady_loop.py). The
        per-frame Python work here is one list append — the dispatch cost
        is paid once per window."""
        if self._loop_rows and self._loop_rows[-1][0] is buf:
            # on-error retry re-chains the window's trigger buffer and the
            # failed dispatch restored the rows — replace, don't duplicate
            self._loop_rows[-1] = (buf, tensors, inputs)
        else:
            self._loop_rows.append((buf, tensors, inputs))
        # >= : a failed dispatch may have restored rows on top of a frame
        # that arrived since; the dispatch takes exactly ONE window's rows
        if len(self._loop_rows) >= self._loop_state["window"]:
            return self._dispatch_loop_window()
        return FlowReturn.OK

    def _restore_loop_rows(self, rows) -> None:
        """A failed staging or dispatch: the window's frames survive into
        the on-error policy — retry restores the whole window, drop loses
        exactly the trigger frame."""
        kind, _ = self.error_policy()
        keep = rows if kind in ("retry", "restart") else rows[:-1]
        self._loop_rows = list(keep) + self._loop_rows

    def _dispatch_loop_window(self) -> FlowReturn:
        """Stage + dispatch the collected window: stack the frames
        (padding a partial window by repeating the last row, so every
        window presents ONE program shape — padded rows are masked at
        emit), ONE staged upload, ONE dispatch. The un-synced launch
        banks in ``_loop_inflight``; the oldest drains once
        ``launch-depth`` windows are in flight."""
        from nnstreamer_tpu_torch.ops.steady_loop import (
            LoopDeclined,
            stack_window,
        )

        window = self._loop_state["window"]
        rows, self._loop_rows = (self._loop_rows[:window],
                                 self._loop_rows[window:])
        if not rows:
            return FlowReturn.OK
        spans = self._spans()
        t_asm = time.perf_counter() if spans is not None else 0.0
        try:
            slot = self.fw.loop_slot(rows[0][2], window)
        except LoopDeclined as e:
            return self._decline_loop(rows, str(e))
        try:
            stacked, n_valid = stack_window([r[2] for r in rows], window,
                                            out=slot)
        except ValueError as e:
            raise ElementError(self.name, str(e))
        if spans is not None:
            spans.emit("batch-assemble", "batch", t_asm, time.perf_counter(),
                       args={"element": self.name, "rows": n_valid,
                             "pad": window - n_valid, "window": window})
        host_bytes = nbytes_of(stacked)
        t_h2d = time.perf_counter() if spans is not None else 0.0
        try:
            staged = self.fw.loop_stage(stacked)
        except Exception as e:
            self._restore_loop_rows(rows)
            raise ElementError(self.name, f"loop staging failed: {e}") from e
        # the whole (padded) window crosses in one staged upload
        self._record_crossing("h2d", nbytes=host_bytes)
        if spans is not None:
            spans.emit("h2d", "h2d", t_h2d, time.perf_counter(),
                       args={"element": self.name, "nbytes": host_bytes,
                             "window": window})
        t0 = time.perf_counter()
        try:
            outs = self.fw.loop_invoke(staged)
        except Exception as e:
            self._restore_loop_rows(rows)
            raise ElementError(self.name, f"invoke failed: {e}") from e
        self._invoke_count += 1
        self._drain_aot_events()
        self._inv_tls.t0 = t0
        self._inv_tls.disp = 0.0
        self._inv_tls.done = 0.0
        self._inv_tls.replica = None
        if spans is not None:
            t_disp = time.perf_counter()
            spans.emit("dispatch", "dispatch", t0, t_disp,
                       args={"element": self.name, "frames": n_valid,
                             "window": window})
            self._inv_tls.disp = t_disp
        if self._measuring():
            _block_until_ready(outs)
            if self._invoke_count > 1:  # the first window builds
                self._latencies_us.append(
                    (time.perf_counter() - t0) * 1e6 / n_valid)
            self._out_times.append(time.monotonic())
        meta = [self._strip_for_window(b, t) for b, t, _ in rows[:n_valid]]
        self._loop_inflight.append((meta, n_valid, outs))
        ret = FlowReturn.OK
        while len(self._loop_inflight) >= self._loop_state["depth"]:
            ret = self._drain_oldest_loop()
            if ret not in (FlowReturn.OK, FlowReturn.DROPPED):
                break
        return ret

    def _decline_loop(self, rows, reason: str) -> FlowReturn:
        """The backend could not build the window at its first use (a
        refused capture): fall back LOUDLY to per-buffer launches, as for
        a window declined at install — banked windows drain first, then
        this window's and every collected frame run one by one."""
        log.warning("[%s] loop-window: %s — per-buffer launches",
                    self.name, reason)
        self._loop_refused = ("NNST460", reason)
        ret = self._drain_loop()
        self.clear_loop()
        pending, self._loop_rows = list(rows) + self._loop_rows, []
        for buf, tensors, inputs in pending:
            if ret not in (FlowReturn.OK, FlowReturn.DROPPED):
                break
            ret = self._emit(buf, tensors, self._invoke(inputs))
        return ret

    def _drain_oldest_loop(self) -> FlowReturn:
        """Drain the oldest banked window: one wait on its stacked
        outputs, ONE fetch of the whole window, then emit the valid rows
        in order — padded tail rows are never emitted."""
        meta, n_valid, outs = self._loop_inflight.popleft()
        flat = [o for o in outs if is_backend_tensor(o)]
        if flat:
            got, _, _ = self._drain_and_fetch(flat, window=len(meta))
            fetched = iter(got)
            outs = [next(fetched) if is_backend_tensor(o) else o
                    for o in outs]
        ret = FlowReturn.OK
        for k in range(n_valid):
            buf, tensors = meta[k]
            ret = self._emit_now(buf, tensors, [o[k] for o in outs])
            if ret not in (FlowReturn.OK, FlowReturn.DROPPED):
                return ret
        return ret

    def _drain_loop(self) -> FlowReturn:
        """Drain every banked window in dispatch order (EOS, quiescence,
        reload, stop): no stranded frames."""
        ret = FlowReturn.OK
        while self._loop_inflight:
            ret = self._drain_oldest_loop()
            if ret not in (FlowReturn.OK, FlowReturn.DROPPED):
                break
        return ret

    # -- fetch-timeout-ms quiescence flush ---------------------------------
    def _arm_flush_timer(self) -> None:
        """Note activity for the quiescence timer when fetch-timeout-ms is
        set. The chain path only stamps ``_last_activity``; the one timer
        re-arms itself for the rest of the window until the stream is
        quiet."""
        t_ms = float(self.properties.get("fetch_timeout_ms", 0) or 0)
        if t_ms <= 0:
            return
        self._last_activity = time.monotonic()
        if self._flush_timer is None:
            self._start_flush_timer(t_ms / 1000.0)

    def _start_flush_timer(self, delay: float) -> None:
        self._flush_timer = threading.Timer(delay, self._timeout_flush)
        self._flush_timer.daemon = True
        self._flush_timer.start()

    def _timeout_flush(self) -> None:
        """Quiescence expired: flush the partial micro-batch (padded), the
        upload window and any held fetch window, so a live pipeline that
        never sends EOS does not strand its trailing frames. Runs on the
        timer thread under the window lock; a failure is posted to the bus
        as the element's error."""
        t = float(self.properties.get("fetch_timeout_ms", 0) or 0) / 1000.0
        with self._window_lock:
            self._flush_timer = None
            if self.fw is None:  # stopped while the timer was in flight
                return
            remaining = self._last_activity + t - time.monotonic()
            if remaining > 0.001:
                if (self._pending or self._fetch_pending
                        or self._feed_pending or self._loop_rows
                        or self._loop_inflight):
                    self._start_flush_timer(remaining)
                return
            try:
                if self._loop_rows:
                    self._dispatch_loop_window()
                if self._loop_inflight:
                    self._drain_loop()
                if self._pending:
                    self._flush_batch(self._batch_size())
                if self._feed_pending:
                    self._drain_feed()
                if self._fetch_pending:
                    self._flush_fetch_window()
            except Exception as e:  # noqa: BLE001 — timer thread: report
                log.exception("[%s] fetch-timeout flush failed", self.name)
                self.post_error(e)

    # -- invoke ------------------------------------------------------------
    def _invoke(self, inputs: List, frames: int = 1,
                replica: Optional[int] = None) -> List:
        """One backend invoke. ``frames`` > 1 on micro-batched calls: the
        measured time is divided per frame so the latency window keeps
        per-buffer compute semantics (the batching wait is in
        `latency-e2e`). With latency measurement on, the outputs are
        synchronised so the window holds compute time, not enqueue time."""
        spans = self._spans()
        device_fw = bool(getattr(self.fw, "DEVICE_CAPABLE", False))
        if (device_fw and not isinstance(inputs, PrefetchedInputs)
                and any(not is_backend_tensor(x) for x in inputs)):
            # the backend uploads these host tensors inline, one transfer
            # per invoke (prefetched entries were billed at prefetch)
            self._record_crossing("h2d", nbytes=nbytes_of(
                [x for x in inputs if not is_backend_tensor(x)]),
                devices=self._shard_devices())
        elif not device_fw and any(is_backend_tensor(x) for x in inputs):
            # a host-only backend fed device tensors: ONE batched fetch,
            # billed, instead of the backend's own per-input conversion
            dev_bytes = nbytes_of([x for x in inputs if is_backend_tensor(x)])
            t_m = time.perf_counter()
            inputs = materialize_tensors(list(inputs))
            self._record_crossing("d2h", nbytes=dev_bytes)
            if spans is not None:
                spans.emit("d2h", "d2h", t_m, time.perf_counter(),
                           args={"element": self.name, "nbytes": dev_bytes})
        t0 = time.perf_counter()
        try:
            outputs = self._invoke_backend(inputs, replica=replica)
        except ElementError:
            raise
        except Exception as e:
            raise ElementError(self.name, f"invoke failed: {e}") from e
        self._invoke_count += 1
        self._drain_aot_events()
        # invoke window for the serving reply headers (serve_invoke): bare
        # float stamps, per THREAD (replica workers invoke concurrently —
        # _emit_now must pair outputs with ITS thread's stamps); span mode
        # adds the dispatch/compute split below
        self._inv_tls.t0 = t0
        self._inv_tls.disp = 0.0
        self._inv_tls.done = 0.0
        self._inv_tls.replica = replica
        if spans is not None:
            # invoke decomposition: `dispatch` is the backend call until
            # its (async) launches return; a device sync after it puts
            # the device compute on the filter's device track. The sync
            # is SAMPLED (1 in NNSTPU_TRACE_SYNC_SAMPLE invokes, default
            # 4), so span mode does not serialize every invoke; unsampled
            # compute lands in the window drain's `device-drain` span.
            t_disp = time.perf_counter()
            spans.emit("dispatch", "dispatch", t0, t_disp,
                       args={"element": self.name, "frames": frames})
            dev_outs = [o for o in outputs if is_backend_tensor(o)]
            s = max(1, int(os.environ.get(
                "NNSTPU_TRACE_SYNC_SAMPLE", "4") or 1))
            sampled = (self._sync_sample_n % s) == 0
            self._sync_sample_n += 1
            if dev_outs and sampled:
                _block_until_ready(dev_outs)
                t_done = time.perf_counter()
                spans.emit("device-compute", "compute", t_disp, t_done,
                           track=f"device:{self.name}",
                           args={"element": self.name, "sync_sample": s})
                # the same interval on THIS thread as a `sync` span, so
                # the roll-up carves it out of the chain's self time
                spans.emit("device-sync", "sync", t_disp, t_done,
                           args={"element": self.name, "sync_sample": s})
                self._inv_tls.done = t_done
            self._inv_tls.disp = t_disp
        if self._measuring():
            _block_until_ready(outputs)
            if self._invoke_count > 1:  # the first invoke builds; keep it out
                self._latencies_us.append(
                    (time.perf_counter() - t0) * 1e6 / frames)
            self._out_times.append(time.monotonic())
        return outputs

    # -- invoke watchdog + graceful degradation ----------------------------
    def _call_backend(self, fw, inputs: List,
                      replica: Optional[int] = None) -> List:
        """The raw backend call, carrying the invoke fault points
        (testing/faults.py): ``invoke-raise`` fails it, ``invoke-hang``
        stalls it on the host before the backend launches anything, so
        the watchdog trips without a genuinely hung backend. A replica
        dispatch tags the fault point ``<name>@rN``, so a test can hang
        ONE replica while its siblings stay healthy (``match=<name>``
        still hits every replica). With the sanitizer on, the NNST601
        busy gate wraps the call."""
        from nnstreamer_tpu_torch.testing import faults

        tag = self.name if replica is None else f"{self.name}@r{replica}"
        if faults.check("invoke-raise", tag) is not None:
            raise faults.FaultInjected(f"injected invoke-raise in {tag}")
        f = faults.check("invoke-hang", tag)
        if f is not None:
            time.sleep(f.delay_s)

        def call():
            return (fw.invoke(inputs) if replica is None
                    else fw.invoke_replica(replica, inputs))

        if sanitizer.active():
            # one framework instance, one invoke at a time: concurrent
            # entry through a shared key or a tripped watchdog worker is
            # a violation naming both elements. Replica invokes gate per
            # REPLICA (each owns its own weights), so N workers on one
            # instance are legal while two entries on ONE replica trip
            gate = fw if replica is None else fw.replica_gate(replica)
            with sanitizer.invoke_gate(gate, self.name):
                return call()
        return call()

    def _invoke_backend(self, inputs: List,
                        replica: Optional[int] = None) -> List:
        """The backend invoke under the optional watchdog.

        ``invoke-timeout-ms=T``: the call runs on the worker thread (on
        the caller's CUDA stream); past the deadline the streaming thread
        abandons it, counts a trip, optionally degrades to
        ``fallback-framework`` after ``fallback-after`` consecutive trips,
        and raises so the element's ``on-error`` policy decides what
        happens to the frame. Unset (the default): inline call, no
        thread."""
        t_ms = float(self.properties.get("invoke_timeout_ms", 0) or 0)
        if t_ms <= 0:
            outputs = self._call_backend(self.fw, inputs, replica=replica)
            self._watchdog_consec = 0
            return outputs
        fw = self.fw
        busy = self._wd_busy
        if busy is not None:
            evt, busy_fw = busy
            if busy_fw is fw:
                # a previously tripped invoke is STILL inside this backend:
                # wait the deadline out for it; still busy counts as
                # another trip, finished means its stale result is
                # discarded and the fresh invoke proceeds
                if not evt.wait(t_ms / 1e3):
                    return self._on_watchdog_trip(t_ms, fw, inputs)
            self._wd_busy = None
        box: dict = {}
        done = threading.Event()
        in_q = self._wd_worker_queue()
        in_q.put((fw, _worker_inputs(inputs), box, done, _caller_stream(fw),
                  replica))
        if not done.wait(t_ms / 1e3):
            self._wd_busy = (done, fw)
            # retire the stuck worker: the pill makes it exit once the
            # hung call returns; the next invoke spawns a fresh one
            in_q.put(None)
            self._wd_worker = None
            return self._on_watchdog_trip(t_ms, fw, inputs)
        if "err" in box:
            raise box["err"]
        self._watchdog_consec = 0
        return box["out"]

    def _wd_worker_queue(self):
        """The persistent watchdog worker's input queue (lazily spawned)."""
        if self._wd_worker is not None:
            return self._wd_worker[1]
        import queue as _queue

        in_q: "_queue.Queue" = _queue.Queue()

        def loop():
            while True:
                item = in_q.get()
                if item is None:
                    return  # retired (trip) or stopped
                fw, inputs, box, done, stream, rep = item
                try:
                    with (torch.cuda.stream(stream) if stream is not None
                          else contextlib.nullcontext()):
                        box["out"] = self._call_backend(fw, inputs,
                                                        replica=rep)
                except Exception as e:  # noqa: BLE001 — rethrown by caller
                    box["err"] = e
                finally:
                    done.set()

        t = threading.Thread(target=loop, daemon=True,
                             name=f"invoke-wd:{self.name}")
        t.start()
        self._wd_worker = (t, in_q)
        return in_q

    def _on_watchdog_trip(self, t_ms: float, fw, inputs: List) -> List:
        """Count + surface one watchdog trip, then degrade to the fallback
        backend (returns ITS outputs) or raise into the element's
        on-error policy."""
        self._watchdog_trips += 1
        self._watchdog_consec += 1
        self.error_stats["watchdog_trips"] = self._watchdog_trips
        tracer = (getattr(self.pipeline, "tracer", None)
                  if self.pipeline else None)
        if tracer is not None:
            tracer.record_fault(self.name, "watchdog-trip")
        if self.pipeline is not None:
            self.pipeline.bus.record_fault(
                self.name, action="watchdog-trip", timeout_ms=t_ms,
                consecutive=self._watchdog_consec, backend=fw.name)
        self.post_message("watchdog-trip", {
            "timeout_ms": t_ms, "consecutive": self._watchdog_consec})
        log.warning("[%s] invoke watchdog tripped (%gms, %d consecutive)",
                    self.name, t_ms, self._watchdog_consec)
        if self._maybe_fallback():
            return self._invoke_backend(inputs)
        raise ElementError(
            self.name,
            f"invoke exceeded invoke-timeout-ms={t_ms:g} "
            f"(trip {self._watchdog_trips}, backend {fw.name})")

    def _maybe_fallback(self) -> bool:
        """After ``fallback-after`` (default 3) consecutive watchdog trips,
        re-open the model on a fresh instance of the fallback backend
        (``fallback-framework=<name>|auto``; auto walks the configured
        framework priority for the model's extension to the next
        registered backend). One switchover per open; surfaced on the bus,
        the tracer and the ``degraded-to`` property. The old backend is
        NOT closed: the abandoned invoke may still run inside it on the
        watchdog's worker thread. Kernels are built once per process
        (ops/_cuda.py), so the fresh instance rebuilds none. A ``jax`` or
        ``torch_cuda`` target's compile-cache entries are warmed first
        from the old backend (``_prefetch_swap_aot``)."""
        target = self.properties.get("fallback_framework")
        if not target or self._degraded_to is not None:
            return False
        k = int(self.properties.get("fallback_after", 3) or 3)
        if self._watchdog_consec < k:
            return False
        target = str(target)
        if target == "auto":
            target = self._next_priority_framework()
            if target is None:
                return False
        from dataclasses import replace as _dc_replace

        if target in ("jax", "torch_cuda"):
            # the fallback target rebuilds the same model — warm its
            # cache entries from the OLD backend (still open, still
            # serving) so the swapped-in program loads at the next invoke
            self._prefetch_swap_aot()
        fprops = _dc_replace(self._fw_props, framework=target,
                             shared_key=None)
        try:
            new_fw = acquire_framework(target, fprops)
        except Exception as e:  # noqa: BLE001 — fallback open failed: report
            self.post_message("fallback-failed",
                              {"framework": target, "error": str(e)})
            return False
        if (self._pre_specs or self._post_specs) and not new_fw.fuse_stages(
                self._pre_specs, self._post_specs):
            # upstream transforms are fused-out passthroughs: a fallback
            # backend that can't carry the stages would corrupt the stream
            release_framework(new_fw, None)
            self.post_message("fallback-failed", {
                "framework": target,
                "error": "fallback backend cannot carry the installed "
                         "fusion stages"})
            return False
        if self._chain_specs and not new_fw.fuse_chain(
                self._chain_specs, self._chain_in_shapes()):
            # same contract for a chain head: downstream members are
            # passthrough shells
            release_framework(new_fw, None)
            self.post_message("fallback-failed", {
                "framework": target,
                "error": "fallback backend cannot carry the installed "
                         "chain composition"})
            return False
        old_name = self.fw.name if self.fw is not None else "?"
        # the mesh and the replica pool follow the swap or fall back
        # loudly (the same outputs either way)
        if self._shard_state is not None and not new_fw.build_shard(
                self._shard_state):
            log.warning("[%s] fallback backend declined the mesh "
                        "placement — unsharded execution", self.name)
            self._shard_state = None
        if self._replica_state is not None and not new_fw.build_replicas(
                self._replica_state["replicas"]):
            self._drop_replica_pool(
                "fallback backend declined the replica pool")
        self.fw = new_fw
        self._fw_props = fprops
        in_info, out_info = new_fw.get_model_info()
        self._in_info = fprops.input_info or in_info
        self._out_info = fprops.output_info or out_info
        self._invoke_count = 0
        self._latencies_us.clear()
        self._degraded_to = target
        self._watchdog_consec = 0
        self.error_stats["fallbacks"] = self.error_stats.get("fallbacks", 0) + 1
        if self.pipeline is not None:
            # the fallback backend may not be device-capable: re-plan
            # residency so upstream device lanes move their
            # materialization boundary (pad flags only — safe mid-stream)
            from nnstreamer_tpu_torch.pipeline.planner import _plan_residency

            _plan_residency(self.pipeline)
        tracer = (getattr(self.pipeline, "tracer", None)
                  if self.pipeline else None)
        if tracer is not None:
            tracer.record_fault(self.name, "fallback")
        if self.pipeline is not None:
            self.pipeline.bus.record_fault(
                self.name, action="fallback",
                from_framework=old_name, to_framework=target)
        self.post_message("filter-degraded", {"from": old_name, "to": target})
        log.warning("[%s] degraded to fallback framework %r (from %r)",
                    self.name, target, old_name)
        return True

    def _next_priority_framework(self) -> Optional[str]:
        """fallback-framework=auto: the next registered backend in the
        configured priority list for the model's extension (the
        detect_framework order)."""
        from nnstreamer_tpu_torch import registry as reg

        model = self._fw_props.model_file or ""
        ext = os.path.splitext(model)[1].lstrip(".").lower()
        cur = self.fw.name if self.fw is not None else ""
        for cand in conf().framework_priority(ext):
            cand = conf().resolve_alias(cand)
            if cand and cand != cur and reg.get(reg.FILTER, cand) is not None:
                return cand
        return None

    # -- fetch window --------------------------------------------------------
    def _emit(self, buf: Buffer, tensors: List, outputs: List) -> FlowReturn:
        if not outputs:
            # backend signalled per-frame drop (tensor_filter.c:843-845)
            return FlowReturn.DROPPED
        # the window engages where outputs will actually cross to the
        # host: downstream is not a negotiated device lane, or sync=1
        # forces the materialization _emit_now would pay per buffer
        window = self._fetch_window_size()
        if window > 1 and self._outputs_cross_here() and (
            any(is_backend_tensor(o) for o in outputs)
            # host outputs join a non-empty window too: bypassing it would
            # emit them ahead of earlier outputs still being held
            or self._fetch_pending
        ):
            buf, tensors = self._strip_for_window(buf, tensors)
            self._fetch_pending.append((None, buf, tensors, outputs))
            self._fetch_t.append(time.perf_counter())
            if len(self._fetch_pending) < window:
                return FlowReturn.OK
            return self._flush_fetch_window()
        return self._emit_now(buf, tensors, outputs)

    def _strip_for_window(self, buf: Buffer, tensors):
        """Held window entries must not pin the stream's input frames in
        host memory; inputs are only needed after the flush when
        output-combination passes them through."""
        if self.properties.get("output_combination"):
            return buf, tensors
        nb = buf.with_tensors([])
        t_in = getattr(buf, "_nns_t_in", None)
        if t_in is not None:
            nb._nns_t_in = t_in
        return nb, []

    def _fetch_window_size(self) -> int:
        prop = str(self.properties.get("fetch_window", 1)).strip().lower()
        if prop == "auto":
            return self._auto_window
        if prop == "eos":
            return self._EOS_WINDOW_CAP
        return int(prop or 1)

    def _retune_auto_window(self, k: int, t_block: float, t_fetch: float) -> None:
        """fetch-window=auto: pick the window so the per-window fetch stays
        a small fraction (``_AUTO_OVERHEAD``) of the window's buffer
        period, moving at most a doubling or a halving per flush. While
        the stream is saturated (no live consumer pacing it) auto holds
        ``_AUTO_SATURATED_WINDOW``; once the feed idles between frames
        the ratio rule resumes. The JAX package's rule, step for step."""
        if str(self.properties.get("fetch_window", 1)).strip().lower() != "auto":
            return
        now = time.perf_counter()
        flush_gap = (now - self._last_flush_t
                     if self._last_flush_t is not None else None)
        # per-buffer wall period: covers dispatch + H2D + compute + feed
        # gaps, whichever dominates
        period = max(t_block / max(k, 1), 1e-6)
        if flush_gap is not None:
            period = max(period, (flush_gap - t_fetch) / max(k, 1))
        self._last_flush_t = now
        if self._stream_saturated():
            self._auto_window = self._AUTO_SATURATED_WINDOW
            return
        want = t_fetch / (self._AUTO_OVERHEAD * period)
        target = max(1, min(self._AUTO_WINDOW_MAX, int(round(want))))
        w = max(1, self._auto_window)
        if target > w:
            self._auto_window = min(target, w * 2)
        else:
            self._auto_window = max(target, w // 2, 1)

    def _flush_fetch_window(self) -> FlowReturn:
        """Bring every held window entry to the host in ONE batched
        device→host transfer, then emit them in order.

        Entries are ``(None, buf, tensors, outputs)`` (one frame) or
        ``(rows, None, None, outputs)`` (a micro-batch: rows are
        ``(buf, tensors)`` pairs and ``outputs`` the whole batched
        results, split per row only after the transfer, so the window
        moves a few batched tensors instead of one per frame)."""
        pending, self._fetch_pending = self._fetch_pending, []
        stamps, self._fetch_t = self._fetch_t, []
        tracer = (getattr(self.pipeline, "tracer", None)
                  if self.pipeline else None)
        if tracer is not None:
            now = time.perf_counter()
            for ts in stamps:
                # window hold = parked time between invoke and emit
                tracer.record_residency(f"fetch-window:{self.name}",
                                        now - ts)
        if not pending:
            return FlowReturn.OK
        fetched, times = self._fetch_held(
            [(outputs, [tensors or []] if rows is None
              else [r for _, r in rows])
             for rows, _, tensors, outputs in pending],
            window=len(pending))
        if times is not None:
            # retune in window ENTRIES (one entry is a whole batch on the
            # micro-batch path)
            self._retune_auto_window(len(pending), *times)
        ret = FlowReturn.OK
        for (rows, buf, _, _), (outs, held) in zip(pending, fetched):
            if rows is None:
                ret = self._emit_now(buf, held[0], outs)
                if ret not in (FlowReturn.OK, FlowReturn.DROPPED):
                    return ret
                continue
            for k, ((rbuf, _), rtensors) in enumerate(zip(rows, held)):
                ret = self._emit_now(rbuf, rtensors,
                                     [o[k:k + 1] for o in outs])
                if ret not in (FlowReturn.OK, FlowReturn.DROPPED):
                    return ret
        return ret

    def _fetch_held(self, entries: List[tuple],
                    window: Optional[int] = None):
        """ONE batched device→host fetch for held results at a boundary.

        ``entries`` are ``(outputs, rows)``, ``rows`` the input tensor
        lists of the frames behind those outputs. Every backend output
        crosses, and so do the 'iN' passthrough inputs the
        output-combination references when _emit_now will emit them
        here; an unreferenced input is never emitted, so its bytes stay
        put. The drain waits on the NEWEST output (held inputs were
        uploaded before their invoke and are long ready); a fetch-window
        flush (``window`` set) always drains. Returns the entries with
        the host arrays swapped in, and ``(block_s, fetch_s)`` or None
        when nothing was on the device."""
        idxs = (self._ocomb_input_indices()
                if self._ocomb_inputs_cross_here() else set())
        flat = [o for outs, _ in entries for o in outs
                if is_backend_tensor(o)]
        anchor = flat[-1] if flat else None
        flat += [t for _, rows in entries for rt in rows
                 for i, t in enumerate(rt)
                 if i in idxs and is_backend_tensor(t)]
        if not flat:
            return entries, None
        got, dt_block, dt_fetch = self._drain_and_fetch(
            flat, anchor=anchor, always_drain=window is not None,
            window=window)
        fetched = iter(got)
        # swap back in the order flat was built: every entry's outputs
        # first, then its held inputs
        outs = [[next(fetched) if is_backend_tensor(o) else o for o in o_]
                for o_, _ in entries]
        rows = [[[next(fetched) if i in idxs and is_backend_tensor(t) else t
                  for i, t in enumerate(rt)] for rt in r_]
                for _, r_ in entries]
        return list(zip(outs, rows)), (dt_block, dt_fetch)

    def _drain_and_fetch(self, flat: List, anchor=None,
                         always_drain: bool = True,
                         window: Optional[int] = None):
        """THE device→host drain + fetch every materialization site calls
        (window flush, boundary / sync / invoke-dynamic materialization):
        waits once for ``anchor``'s stream (the newest invoke output,
        default the last of ``flat``; skipped when ``always_drain`` is
        False and spans are off — the fetch's own wait suffices), brings
        ``flat`` over in ONE batched transfer and bills the d2h crossing.
        Returns ``(fetched, block_seconds, fetch_seconds)``."""
        spans = self._spans()
        t0 = time.perf_counter()
        if always_drain or spans is not None:
            _block_until_ready([anchor] if anchor is not None else flat[-1:])
        t1 = time.perf_counter()
        if spans is not None:
            spans.emit("device-drain", "compute", t0, t1,
                       track=f"device:{self.name}",
                       args={"element": self.name})
            spans.emit("drain-sync", "sync", t0, t1,
                       args={"element": self.name})
        fetched = materialize_tensors(flat)
        t2 = time.perf_counter()
        flat_bytes = nbytes_of(flat)
        self._record_crossing("d2h", nbytes=flat_bytes,
                              devices=self._shard_devices())
        if spans is not None:
            args = {"element": self.name, "nbytes": flat_bytes}
            if window is not None:
                args["window"] = window
            spans.emit("d2h", "d2h", t1, t2, args=args)
        return fetched, t1 - t0, t2 - t1

    def _ocomb_inputs_cross_here(self) -> bool:
        """output-combination 'iN' passthrough inputs will be materialized
        by _emit_now (sync=1 or this filter is the residency boundary):
        the batch paths fetch them alongside the outputs in one transfer."""
        return bool(self.properties.get("output_combination")) and \
            self._outputs_cross_here(strict=True)

    def _ocomb_input_indices(self) -> set:
        """Input indices the output-combination spec references — the only
        inputs whose bytes must cross at a boundary. Malformed tokens are
        ignored here; _emit_now surfaces them."""
        idxs = set()
        for tok in str(self.properties.get("output_combination") or "").split(","):
            tok = tok.strip()
            if tok.startswith("i"):
                try:
                    idxs.add(int(tok[1:]))
                except ValueError:
                    pass
        return idxs

    def _materialize_outputs(self, outputs: List) -> List:
        """ONE batched device→host fetch for every backend tensor in
        ``outputs``."""
        flat = [o for o in outputs if is_backend_tensor(o)]
        if not flat:
            return outputs
        got, _, _ = self._drain_and_fetch(flat, always_drain=False)
        fetched = iter(got)
        return [next(fetched) if is_backend_tensor(o) else o for o in outputs]

    def _emit_now(self, buf: Buffer, tensors: List, outputs: List) -> FlowReturn:
        # output-combination (:850-869): 'iN' passthrough input N, 'oN' output N
        ocomb = self.properties.get("output_combination")
        if ocomb:
            outs = []
            for tok in str(ocomb).split(","):
                tok = tok.strip()
                if tok.startswith("i"):
                    outs.append(tensors[int(tok[1:])])
                else:
                    outs.append(outputs[int(tok[1:]) if tok.startswith("o") else int(tok)])
            outputs = outs
        if self._outputs_cross_here(strict=True):
            # materialize on THIS streaming thread: sync=1 asks for it,
            # invoke-dynamic's flexible outputs are host bytes, or the
            # planner made this filter the boundary (downstream is
            # host-only). Runs on the COMBINED list so 'iN' passthrough
            # inputs on the device cross here too, never leaking past
            # the boundary
            outputs = self._materialize_outputs(outputs)
        if self.properties.get("invoke_dynamic"):
            # flexible output: wrap each tensor with a meta header (:906-917)
            outputs = [meta_mod.wrap_flexible(
                a, TensorInfo.from_np_shape(a.shape, a.dtype))
                for a in (np.asarray(o) for o in outputs)]
        t_in = getattr(buf, "_nns_t_in", None)
        if t_in is not None:
            self._e2e_us.append((time.monotonic() - t_in) * 1e6)
        out_buf = buf.with_tensors(outputs)
        out_buf.meta["residency"] = residency_of(outputs)
        if "serve_routes" in out_buf.meta or "_tracex" in out_buf.meta:
            # the serving/query reply path turns this window into the
            # request's device stage(s) (elements/query.py). t1 is stamped
            # HERE, so a boundary materialization above is inside the
            # window. The disp/done stamps only exist in span mode — >=
            # guards drop stale ones from an earlier span-mode invoke
            t_inv0 = getattr(self._inv_tls, "t0", 0.0)
            if t_inv0:
                win = {"t0_ns": int(t_inv0 * 1e9)}
                disp = getattr(self._inv_tls, "disp", 0.0)
                if disp >= t_inv0:
                    win["disp_ns"] = int(disp * 1e9)
                    done = getattr(self._inv_tls, "done", 0.0)
                    if done >= disp:
                        win["done_ns"] = int(done * 1e9)
                win["t1_ns"] = time.perf_counter_ns()
                rep = getattr(self._inv_tls, "replica", None)
                if rep is not None:
                    win["replica"] = int(rep)
                out_buf.meta["serve_invoke"] = win
        return self.push(out_buf)

    # -- micro-batching ----------------------------------------------------
    def _flush_batch(self, batch: int) -> FlowReturn:
        """Invoke once over the pending frames, split results back per
        frame (timestamps/meta preserved).

        Frames with a leading batch dim of 1 are concatenated along it;
        frames without one (a converter's single frame, the caps shape
        verbatim) are stacked on a new axis. A partial batch is padded by
        repeating the last frame so every invoke sees ONE input shape (one
        build), and the padded rows are dropped after the invoke."""
        pending, self._pending = self._pending, []
        if not pending:
            return FlowReturn.OK
        for _, _, inp in pending:
            for t in inp:
                if len(_shape(t)) == 0:
                    raise ElementError(
                        self.name, "batch-size > 1 cannot batch scalar frames")
        pad_frames = batch - len(pending) if len(pending) < batch else 0
        spans = self._spans()
        t_asm = time.perf_counter() if spans is not None else 0.0
        stacked = []
        mixed_bytes = 0
        for j in range(len(pending[0][2])):
            parts = [p[2][j] for p in pending]
            parts.extend([pending[-1][2][j]] * pad_frames)
            if any(is_backend_tensor(t) for t in parts):
                # the backend's tensors stack where they are; host parts
                # mixed in go up with the assembly, a crossing
                mixed_bytes += nbytes_of(
                    [t for t in parts if not is_backend_tensor(t)])
            if all(_shape(t) and _shape(t)[0] == 1 for t in parts):
                stacked.append(concat_tensors(parts))
            else:
                stacked.append(stack_tensors(parts))
        if mixed_bytes:
            self._record_crossing("h2d", nbytes=mixed_bytes,
                                  devices=self._shard_devices())
        if spans is not None:
            # micro-batch assembly (concat/stack + padding): the
            # `batching_padding` leg of the host-stack attribution
            spans.emit("batch-assemble", "batch", t_asm,
                       time.perf_counter(),
                       args={"element": self.name, "rows": len(pending),
                             "pad": pad_frames})
        if self._feed_depth() > 1:
            # upload window: the assembled batch prefetches as ONE entry
            # and invokes when the in-flight queue fills
            return self._feed(pending, None, None, stacked)
        try:
            outputs = self._invoke(stacked, frames=len(pending))
        except Exception:
            # the rows survive the failure into the element's on-error
            # policy: retry re-invokes the SAME batch, drop loses exactly
            # the trigger frame
            kind, _ = self.error_policy()
            self._pending = (pending if kind in ("retry", "restart")
                             else pending[:-1])
            raise
        return self._emit_batch_rows(pending, outputs)

    def _emit_batch_rows(self, pending: List[tuple], outputs: List) -> FlowReturn:
        """Post-invoke half of the micro-batch path (shared with the
        upload-window pop): hold the BATCHED outputs as one fetch-window
        entry, or split them back one row per frame (padded tail rows are
        dropped). Rows of a device output are views into the one batched
        tensor."""
        if not outputs:
            return FlowReturn.DROPPED
        window = self._fetch_window_size()
        if window > 1 and self._outputs_cross_here() and (
            any(is_backend_tensor(o) for o in outputs) or self._fetch_pending
        ):
            rows = [self._strip_for_window(b, t) for b, t, _ in pending]
            self._fetch_pending.append((rows, None, None, outputs))
            self._fetch_t.append(time.perf_counter())
            if len(self._fetch_pending) < window:
                return FlowReturn.OK
            return self._flush_fetch_window()
        if self._outputs_cross_here(strict=True):
            # the boundary (or sync=1 / invoke-dynamic) without a fetch
            # window: ONE batched fetch of the batched outputs — and of
            # the referenced 'iN' inputs the ocomb block re-emits —
            # before the split, not one per row
            [(outputs, held)], _ = self._fetch_held(
                [(outputs, [tensors for _, tensors, _ in pending])])
            pending = [(buf, tensors, inp) for (buf, _, inp), tensors
                       in zip(pending, held)]
        ret = FlowReturn.OK
        for k, (buf, tensors, _) in enumerate(pending):
            ret = self._emit(buf, tensors, [o[k:k + 1] for o in outputs])
            if ret not in (FlowReturn.OK, FlowReturn.DROPPED):
                break
        return ret

    def on_eos(self) -> None:
        if self._flush_timer is not None:
            self._flush_timer.cancel()
        # replica workers first: EOS must not overtake serve-batches still
        # in a replica's inbox or mid-invoke
        for _, q in self._replica_workers:
            q.join()
        with self._window_lock:
            self._flush_timer = None
            # the steady loop first: a partial window dispatches padded
            # (padded rows masked, never emitted), then every banked
            # launch drains in dispatch order
            if self._loop_rows:
                self._dispatch_loop_window()
            if self._loop_inflight:
                self._drain_loop()
            # order matters: a partial micro-batch may enter the upload
            # window, whose drained invokes may enter the fetch window —
            # flush upstream-most first so nothing strands in flight
            if self._pending:
                self._flush_batch(self._batch_size())
            if self._feed_pending:
                self._drain_feed()
            if self._fetch_pending:
                self._flush_fetch_window()

    def query_latency(self) -> int:
        """Estimated per-buffer latency in ns with 15% headroom
        (tensor_filter.c:1381-1421) when latency-report is enabled."""
        if not self.properties.get("latency_report") or not self._latencies_us:
            return 0
        avg_us = sum(self._latencies_us) / len(self._latencies_us)
        return int(avg_us * 1.15 * 1000)

    # -- stats (read-only runtime props, tensor_filter_common.c:981-995) ---
    def get_property(self, key: str):
        key = key.replace("-", "_")
        if key == "latency":
            return int(sum(self._latencies_us) / len(self._latencies_us)) if self._latencies_us else 0
        if key == "latency_e2e":
            return int(sum(self._e2e_us) / len(self._e2e_us)) if self._e2e_us else 0
        if key == "throughput":
            # outputs/sec × 10
            if len(self._out_times) >= 2:
                dt = self._out_times[-1] - self._out_times[0]
                if dt > 0:
                    return int((len(self._out_times) - 1) / dt * 10)
            return 0
        if key == "invoke_stats":
            s = self.fw.stats if self.fw else None
            return (s.total_invoke_num, s.total_invoke_latency_us) if s else (0, 0)
        if key == "watchdog_trips":
            # cumulative invoke-timeout-ms trips (watchdog visibility)
            return self._watchdog_trips
        if key == "degraded_to":
            # fallback-framework switchover marker: the backend now
            # serving, or None while the primary is healthy
            return self._degraded_to
        return super().get_property(key)
