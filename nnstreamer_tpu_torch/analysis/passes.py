"""Built-in analyzer passes (nnlint; counterpart of the JAX package's
``analysis/passes.py``).

Static passes over a constructed pipeline graph, each importing the
element classes it inspects lazily (element modules import the analysis
schema, so module-level imports here would cycle), in registration
order:

  graph        NNST0xx — dangling pads, reachability, pad-linked cycles
  properties   NNST1xx — schema validation of every element's properties
  negotiation  NNST2xx — static caps/shape/dtype dry run (analysis/nego)
  residency    NNST3xx — avoidable crossings + predicted crossing counts
  fusion       NNST4xx — fusion-safety (shared backends, sync lanes,
                          double-claimed transforms)
  chain        NNST45x — whole-chain filter→filter composition verdicts
                          (fusable / blocked / over-budget / link mismatch)
  loop         NNST46x — steady-loop window eligibility verdicts
                          (eligible / ineligible / ring over the budget)
  shard        NNST47x — mesh-partition verdicts (shard=dp|tp|dpxtp
                          mesh=AxB: eligible / ineligible / reshard
                          hazard)
  deadlock     NNST5xx — bounded-queue diamonds, collect-pads starvation
  serving      NNST90x — serving misconfiguration
  threads      NNST62x — thread topology of a serving route, wait cycles
                          and unbounded reply sends
  pool         NNST96x — replica-serving eligibility verdicts
  fleet        NNST98x — rollout/hedging licensing (hedge without
                          idempotent pairing, unreachable auto-rollback,
                          single-endpoint hedge no-op)
  ctl          NNST95x — serving-controller SLO feasibility and pins
  churn        NNST800 — variable-shape caps rebuilding a device program;
               NNST802/803 — donation safety and missed donation
  costmodel    NNST701 — per-filter program cost (opt-in: a meta run of
                          every filter's program); NNST801 — a python
                          scalar widening stream data in that run
  memplan      NNST700/702/703 — whole-pipeline device-memory footprint vs
                          budget + roofline bottleneck (opt-in)
  tuner        NNST850/851/852 — the static tune of the launch line's
                          config space (explicit only: ``passes=["tuner"]``)
  aot          NNST97x — compile-cache compile-point summary, cold-start
                          warnings, stale-entry detection (explicit only:
                          stats the on-disk cache)
  deploy       NNST99x — fleet deployment verdicts over a deploy spec
                          (explicit only: ``validate --deploy``)
"""

from __future__ import annotations

from typing import Dict, List, Set

from nnstreamer_tpu_torch.analysis.registry import AnalysisContext, analysis_pass
from nnstreamer_tpu_torch.analysis.schema import check_value, closest_key, schema_for


# --- NNST0xx: graph structure ----------------------------------------------

@analysis_pass("graph")
def graph_pass(ctx: AnalysisContext) -> None:
    from nnstreamer_tpu_torch.pipeline.element import SourceElement

    elems = list(ctx.pipeline.elements.values())
    if not elems:
        ctx.emit("NNST000", "pipeline", "pipeline has no elements")
        return

    for e in elems:
        for p in e.sink_pads:
            if p.peer is None:
                ctx.emit("NNST001", e, f"sink pad {p.name!r} is not linked")
        if e.src_pads and all(p.peer is None for p in e.src_pads):
            # element-declared capability (satellite: no hard-coded class
            # name list — a Tee subclass or rename keeps the exemption)
            if not getattr(e, "MAY_DANGLE_SRC", False):
                ctx.emit("NNST002", e,
                         "no src pad is linked (output dropped)")

    sources = [e for e in elems
               if isinstance(e, SourceElement) or not e.sink_pads]
    if not sources:
        ctx.emit("NNST003", "pipeline", "no source elements")
    reachable: Set[str] = set()
    stack = list(sources)
    while stack:
        e = stack.pop()
        if e.name in reachable:
            continue
        reachable.add(e.name)
        for sp in e.src_pads:
            if sp.peer is not None:
                stack.append(sp.peer.element)
    for e in elems:
        if e.name not in reachable:
            ctx.emit("NNST004", e, "unreachable from any source")

    # cycle detection (white/gray/black DFS; unwinds fully so acyclic
    # ancestors are never falsely implicated from later roots)
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {e.name: WHITE for e in elems}
    flagged: Set[str] = set()

    def dfs(e) -> None:
        color[e.name] = GRAY
        for sp in e.src_pads:
            if sp.peer is None:
                continue
            nxt = sp.peer.element
            if color[nxt.name] == GRAY:
                if nxt.name not in flagged:
                    flagged.add(nxt.name)
                    ctx.emit("NNST005", nxt,
                             "pad-linked cycle (use tensor_repo pairs for "
                             "recurrence)")
            elif color[nxt.name] == WHITE:
                dfs(nxt)
        color[e.name] = BLACK

    for e in elems:
        if color[e.name] == WHITE:
            dfs(e)


# --- NNST1xx: property schemas ----------------------------------------------

@analysis_pass("properties")
def properties_pass(ctx: AnalysisContext) -> None:
    for e in ctx.pipeline.elements.values():
        schema = schema_for(type(e))
        spans = getattr(e, "_prop_spans", {})
        for key, value in e.properties.items():
            spec = schema.get(key)
            span = spans.get(key)
            if spec is None:
                guess = closest_key(key, schema)
                ctx.emit(
                    "NNST100", e,
                    f"unknown property {key.replace('_', '-')!r} "
                    f"(silently ignored at runtime)",
                    hint=(f"did you mean "
                          f"{guess.replace('_', '-')!r}?" if guess else None),
                    span=span)
                continue
            err = check_value(spec, value)
            if err is not None:
                code, msg = err
                ctx.emit(code, e,
                         f"property {key.replace('_', '-')!r}: {msg}",
                         span=span)
        for key, spec in schema.items():
            if spec.required and key not in e.properties:
                ctx.emit("NNST104", e,
                         f"required property {key.replace('_', '-')!r} "
                         f"is not set")
        _subplugin_checks(ctx, e)


def _subplugin_checks(ctx, e) -> None:
    """Registry-backed value checks a static enum can't express."""
    from nnstreamer_tpu_torch import registry as reg
    from nnstreamer_tpu_torch.elements.decoder import TensorDecoder

    if isinstance(e, TensorDecoder):
        mode = e.properties.get("mode")
        if mode and reg.get(reg.CUSTOM_DECODER, str(mode)) is None \
                and reg.get(reg.DECODER, str(mode)) is None:
            ctx.emit(
                "NNST105", e,
                f"decoder mode {mode!r} is not registered "
                f"(available: {sorted(reg.available(reg.DECODER))})",
                span=getattr(e, "_prop_spans", {}).get("mode"))


# --- NNST2xx: static negotiation --------------------------------------------

@analysis_pass("negotiation")
def negotiation_pass(ctx: AnalysisContext) -> None:
    from nnstreamer_tpu_torch.analysis import nego

    nego.dry_run(ctx)


# --- NNST3xx: residency ------------------------------------------------------

@analysis_pass("residency")
def residency_pass(ctx: AnalysisContext) -> None:
    from nnstreamer_tpu_torch.analysis.residency import predict_crossings

    elems = list(ctx.pipeline.elements.values())

    # avoidable host hop: device producer → host-only element → device
    # consumer (each hop pays a d2h and a re-upload)
    flagged: Set[str] = set()
    for e in elems:
        for sp in e.src_pads:
            if not e.produces_device(sp):
                continue
            for hop, hop_pad in _first_nontransparent(sp):
                if hop.accepts_device(hop_pad) or hop.name in flagged:
                    continue
                if _any_device_consumer_beyond(hop):
                    flagged.add(hop.name)
                    ctx.emit(
                        "NNST300", hop,
                        f"avoidable host crossing: device producer "
                        f"{e.name!r} feeds host-only {hop.name!r} ahead of "
                        f"a device-capable consumer (the buffer pays a d2h "
                        f"+ re-upload on this hop)")

    # predicted crossing counts from the planner's boundary placement —
    # the number CI asserts against the runtime tracer
    try:
        pred = predict_crossings(ctx.pipeline, n_buffers=1)
    except Exception:  # noqa: BLE001 — prediction is advisory at lint time
        return
    if pred["per_element"]:
        parts = []
        for name, c in sorted(pred["per_element"].items()):
            kinds = [f"{d}={c[d]}" for d in ("h2d", "d2h") if c.get(d)]
            parts.append(f"{name}({', '.join(kinds)})")
        ctx.emit(
            "NNST301", "pipeline",
            f"predicted link crossings per source buffer: "
            f"{', '.join(parts)}"
            + (f"; unmodeled: {pred['unmodeled']}" if pred["unmodeled"]
               else ""))


def _first_nontransparent(pad, _seen=None):
    """Follow a src pad downstream through residency-transparent elements
    to the first element that actually touches tensor payloads."""
    from nnstreamer_tpu_torch.pipeline.planner import is_transparent

    if _seen is None:
        _seen = set()
    peer = pad.peer
    if peer is None:
        return []
    e = peer.element
    if id(e) in _seen:
        return []
    _seen.add(id(e))
    if not is_transparent(e):
        return [(e, peer)]
    out = []
    for sp in e.src_pads:
        out.extend(_first_nontransparent(sp, _seen))
    return out


def _any_device_consumer_beyond(e, _seen=None) -> bool:
    if _seen is None:
        _seen = set()
    if id(e) in _seen:
        return False
    _seen.add(id(e))
    for sp in e.src_pads:
        if sp.peer is None:
            continue
        nxt = sp.peer.element
        if nxt.accepts_device(sp.peer):
            return True
        if _any_device_consumer_beyond(nxt, _seen):
            return True
    return False


# --- NNST4xx: fusion safety --------------------------------------------------

@analysis_pass("fusion")
def fusion_pass(ctx: AnalysisContext) -> None:
    from nnstreamer_tpu_torch.elements.filter import TensorFilter
    from nnstreamer_tpu_torch.elements.transform import TensorTransform
    from nnstreamer_tpu_torch.pipeline.planner import (
        FUSABLE_MODES,
        _fusion_enabled,
        _walk_transform_chain,
    )

    enabled = _fusion_enabled(ctx.pipeline)
    filters = [e for e in ctx.pipeline.elements.values()
               if isinstance(e, TensorFilter)]
    for f in filters:
        if not f._fw_device_capable():
            continue
        up = _walk_transform_chain(
            f.sink_pads[0] if f.sink_pads else None, upstream=True)
        down = _walk_transform_chain(
            f.src_pads[0] if f.src_pads else None, upstream=False)
        fusable = [t for t in up + down if t._mode in FUSABLE_MODES]
        shared = bool(f.properties.get("shared_tensor_filter_key"))
        if enabled and fusable and shared:
            ctx.emit(
                "NNST400", f,
                f"shared-tensor-filter-key backend never fuses: the "
                f"adjacent transform chain "
                f"({', '.join(t.name for t in fusable)}) stays un-fused "
                f"(stages installed on a shared framework object would "
                f"run inside every sharer's invokes)",
                hint="drop the shared key, or set fusion=off to make the "
                     "un-fused plan explicit")
        inhib = [k for k in ("invoke_dynamic", "input_combination",
                             "output_combination")
                 if f.properties.get(k)]
        if enabled and fusable and not shared and inhib:
            ctx.emit(
                "NNST403", f,
                f"fusion will not engage: "
                f"{', '.join(k.replace('_', '-') for k in inhib)} "
                f"changes per-tensor routing the fused stages can't mirror "
                f"(chain {', '.join(t.name for t in fusable)} stays "
                f"un-fused)")
        if f.properties.get("sync") and f.src_pads:
            for nxt, nxt_pad in _first_nontransparent(f.src_pads[0]):
                if nxt.accepts_device(nxt_pad):
                    ctx.emit(
                        "NNST401", f,
                        f"sync=1 materializes every output on the "
                        f"streaming thread while downstream "
                        f"{nxt.name!r} accepts device-resident tensors "
                        f"— the memory:HBM lane is paid for and unused",
                        hint="drop sync=1 (or accept the per-buffer d2h "
                             "+ re-upload)")
                    break

    # a transform with a filter on BOTH sides can fuse into at most one
    # filter program (a double claim would run its math twice)
    for t in ctx.pipeline.elements.values():
        if not isinstance(t, TensorTransform) or t._mode not in FUSABLE_MODES:
            continue
        if len(t.sink_pads) != 1 or len(t.src_pads) != 1:
            continue
        if _adjacent_filter(t, upstream=True) and \
                _adjacent_filter(t, upstream=False):
            ctx.emit(
                "NNST402", t,
                f"transform {t.name!r} sits between two tensor_filters: "
                f"it can fuse into at most one filter program (planner "
                f"claims it for the first filter planned)",
                hint="set fusion=off on this transform if the ambiguity "
                     "matters, or split the chain explicitly")


def _adjacent_filter(t, upstream: bool) -> bool:
    from nnstreamer_tpu_torch.elements.filter import TensorFilter
    from nnstreamer_tpu_torch.elements.transform import TensorTransform

    pad = (t.sink_pads[0] if upstream else t.src_pads[0]).peer
    while pad is not None:
        e = pad.element
        if isinstance(e, TensorFilter):
            return e._fw_device_capable()
        if not isinstance(e, TensorTransform) \
                or len(e.sink_pads) != 1 or len(e.src_pads) != 1:
            return False
        nxt = e.sink_pads[0] if upstream else e.src_pads[0]
        pad = nxt.peer
    return False


# --- NNST45x: chain composition (nnchain) ------------------------------------

@analysis_pass("chain")
def chain_pass(ctx: AnalysisContext) -> None:
    """Whole-chain filter→filter fusion verdicts (analysis/chain.py):
    NNST450 fusable (with modeled saved launches/crossings), NNST451
    blocked at a named link, NNST452 composed-program-over-HBM (pruned
    before any compile), NNST453 shape/dtype mismatch at a link. Cheap
    on pipelines without filter→filter links (discovery alone); the
    heavy composition runs only when a plausible chain exists."""
    from nnstreamer_tpu_torch.analysis.chain import chain_pass_body

    chain_pass_body(ctx)


# --- NNST46x: steady-state loop (nnloop) -------------------------------------

@analysis_pass("loop")
def loop_pass(ctx: AnalysisContext) -> None:
    """Steady-loop eligibility verdicts (analysis/loop.py): NNST460
    eligible (windowed scan licensed, with the resolved window/depth),
    NNST461 ineligible with the blocking reason, NNST462 window ring
    over the HBM budget (pruned before any compile).  Free on pipelines
    that never request loop-window (two dict reads per filter); the
    memory-plan feasibility check runs only when a window is asked for
    and the cheap gates pass."""
    from nnstreamer_tpu_torch.analysis.loop import loop_pass_body

    loop_pass_body(ctx)


# --- NNST5xx: deadlock / starvation ------------------------------------------

# --- NNST47x: mesh partitioning (nnshard) ------------------------------------

@analysis_pass("shard")
def shard_pass(ctx: AnalysisContext) -> None:
    """Static mesh-partition verdicts (analysis/shard.py): NNST470
    shard-eligible (resolved layout + per-shard bytes), NNST471
    ineligible naming the blocking dim/reason (loud unsharded fallback),
    NNST472 resharding hazard on a memory:HBM edge between filters with
    incompatible specs. Free on pipelines that never request shard=."""
    from nnstreamer_tpu_torch.analysis.shard import shard_pass_body

    shard_pass_body(ctx)


@analysis_pass("deadlock")
def deadlock_pass(ctx: AnalysisContext) -> None:
    from nnstreamer_tpu_torch.elements.basic import QueueElement
    from nnstreamer_tpu_torch.elements.mux import _SyncCombiner

    for e in ctx.pipeline.elements.values():
        if isinstance(e, QueueElement):
            size = e.properties.get("max_size_buffers")
            if size is not None and int(size) <= 0:
                ctx.emit(
                    "NNST503", e,
                    "max-size-buffers<=0 makes this queue unbounded: a "
                    "stalled consumer grows it without backpressure "
                    "until the host OOMs")

    for m in ctx.pipeline.elements.values():
        if not isinstance(m, _SyncCombiner) or len(m.sink_pads) < 2:
            continue
        branches = [_upstream_set(p) for p in m.sink_pads]
        common = set.intersection(*branches) if branches else set()
        uniq = [b - common for b in branches]
        dropping = [any(_drops_frames(x) for x in b) for b in uniq]
        diamond = bool(common) and any(
            sum(1 for sp in f.src_pads if sp.peer is not None) > 1
            for f in common)
        sync = m._sync
        if sync == "slowest":
            if diamond and any(dropping) and not all(dropping):
                culprits = sorted(x.name for b, d in zip(uniq, dropping)
                                  if d for x in b if _drops_frames(x))
                ctx.emit(
                    "NNST500", m,
                    f"slowest-sync diamond with unbalanced frame "
                    f"dropping ({', '.join(culprits)} drops on one "
                    f"branch only): the other pad's bounded FIFO fills "
                    f"and the combiner stalls (collect-pads "
                    f"backpressure)",
                    hint="use sync-mode=nosync/basepad, or drop frames "
                         "upstream of the tee so branches stay aligned")
            lengths = set()
            for b in branches:
                for s in b:
                    n = s.properties.get("num_buffers") if not s.sink_pads \
                        or not any(p.peer for p in s.sink_pads) else None
                    if n is not None and int(n) > 0:
                        lengths.add(int(n))
            if len(lengths) > 1:
                ctx.emit(
                    "NNST501", m,
                    f"slowest-sync combiner fed by finite sources of "
                    f"unequal length ({sorted(lengths)}): the longer "
                    f"stream's tail is never emitted (waits forever for "
                    f"the exhausted pad)")
        elif sync in ("basepad", "refresh") and dropping and dropping[0]:
            culprits = sorted(x.name for x in uniq[0] if _drops_frames(x))
            ctx.emit(
                "NNST502", m,
                f"{sync}-sync emission is driven by pad 0, whose branch "
                f"drops frames ({', '.join(culprits)}): output rate "
                f"collapses to the driver branch's survivors")


# --- NNST9xx: serving tier (nnserve) -----------------------------------------

@analysis_pass("serving")
def serving_pass(ctx: AnalysisContext) -> None:
    """Static serving-misconfiguration lints:

    NNST900  serve-batch disagrees with the downstream filter's compiled
             batch signature (explicit ``input=`` override) — every
             serving buffer would retrace or reject
    NNST901  serving with an unbounded admission queue (queue-depth<=0):
             overload grows the pool without backpressure until OOM
             instead of shedding SERVER_BUSY
    NNST902  a query server feeding a device filter WITHOUT serving
             batching: under concurrent clients every request pays its
             own program launch (the per-request dispatch tax serving
             exists to amortize)
    """
    from nnstreamer_tpu_torch.elements.filter import TensorFilter
    from nnstreamer_tpu_torch.elements.query import TensorQueryServerSrc

    for e in ctx.pipeline.elements.values():
        if not isinstance(e, TensorQueryServerSrc):
            continue
        serving = bool(e.properties.get("serve"))
        filt = _downstream_filter(e)
        if not serving:
            if (filt is not None and filt._fw_device_capable()
                    and int(filt.properties.get("batch_size", 1) or 1) <= 1):
                ctx.emit(
                    "NNST902", e,
                    f"query server pops one request at a time into device "
                    f"filter {filt.name!r}: N concurrent clients pay N "
                    f"program launches (and N h2d/d2h round trips) where "
                    f"one batched launch would do",
                    hint="set serve=1 serve-batch=<N> on this "
                         "tensor_query_serversrc (see README 'Serving')")
            continue
        depth = e.properties.get("serve_queue_depth")
        if depth is not None and int(depth) <= 0:
            ctx.emit(
                "NNST901", e,
                "serve-queue-depth<=0 makes the admission pool unbounded: "
                "overload queues requests without backpressure (latency "
                "and host memory grow until collapse) instead of "
                "shedding SERVER_BUSY",
                hint="set serve-queue-depth to a small multiple of "
                     "serve-batch (bounded time-in-queue)",
                span=getattr(e, "_prop_spans", {}).get("serve_queue_depth"))
        if filt is None:
            continue
        batch = int(e.properties.get("serve_batch", 1) or 1)
        sig_batch = _filter_signature_batch(filt)
        if sig_batch is not None and batch != sig_batch:
            ctx.emit(
                "NNST900", e,
                f"serve-batch={batch} but filter {filt.name!r} declares a "
                f"compiled batch signature of {sig_batch} (input= "
                f"override): every serving buffer "
                f"{'exceeds' if batch > sig_batch else 'under-fills'} the "
                f"compiled shape — a retrace (or hard reject) per batch",
                hint=f"set serve-batch={sig_batch}, or drop the filter's "
                     f"input= override so the serving caps decide the "
                     f"signature",
                span=getattr(e, "_prop_spans", {}).get("serve_batch"))


# --- NNST98x: fleet resilience (nnfleet-r) -----------------------------------

# --- NNST62x: thread topology (nnsan-c static side) --------------------------

@analysis_pass("threads")
def threads_pass(ctx: AnalysisContext) -> None:
    """Static thread-topology lint (analysis/threads.py): NNST620
    topology summary per serve=1 route (info), NNST621 bounded-capacity
    wait cycle (replicas + unbounded reply send), NNST622 blocking-reply
    hazard (serversink send with no timeout= bound)."""
    from nnstreamer_tpu_torch.analysis.threads import threads_pass_body

    threads_pass_body(ctx)


# --- NNST96x: replica serving (nnpool) ---------------------------------------

@analysis_pass("pool")
def pool_pass(ctx: AnalysisContext) -> None:
    """Replica-serving eligibility verdicts (analysis/pool.py): NNST960
    eligible (resolved N + modeled per-device bytes), NNST961 ineligible
    with the blocking reason (loud single-replica fallback), NNST962
    replicas over the per-device budget. Free on pipelines that never
    request ``replicas=``."""
    from nnstreamer_tpu_torch.analysis.pool import pool_pass_body

    pool_pass_body(ctx)


@analysis_pass("fleet")
def fleet_pass(ctx: AnalysisContext) -> None:
    """Fleet failover licensing (analysis/fleet.py): NNST980 hedging
    without the endpoints= idempotent pairing (error — a hedge would be
    double-invoked), NNST982 single-endpoint hedge no-op (warning). Free:
    two dict reads per element."""
    from nnstreamer_tpu_torch.analysis.fleet import fleet_pass_body

    fleet_pass_body(ctx)


# --- NNST95x: serving controller (nnctl) -------------------------------------

@analysis_pass("ctl")
def ctl_pass(ctx: AnalysisContext) -> None:
    """Closed-loop controller feasibility (analysis/ctl.py): NNST950 SLO
    statically infeasible per the plant model even at the best
    serve-batch the controller bounds allow, NNST951 bounds excluding the
    modeled optimum, NNST952 conflicting controller pins. Free on
    pipelines without ``ctl=``/``slo-ms=``; the plant model runs only
    when a controller or SLO is declared."""
    from nnstreamer_tpu_torch.analysis.ctl import ctl_pass_body

    ctl_pass_body(ctx)


def _downstream_filter(e):
    """First tensor_filter reachable downstream of ``e`` (through any
    intermediate elements — queues, transforms, converters)."""
    from nnstreamer_tpu_torch.elements.filter import TensorFilter

    seen = set()
    stack = [sp.peer.element for sp in e.src_pads if sp.peer is not None]
    while stack:
        x = stack.pop()
        if id(x) in seen:
            continue
        seen.add(id(x))
        if isinstance(x, TensorFilter):
            return x
        stack.extend(sp.peer.element for sp in x.src_pads
                     if sp.peer is not None)
    return None


def _filter_signature_batch(filt):
    """The filter's statically declared batch dimension: the leading
    numpy dim of an explicit ``input=`` override (the compiled signature
    the user pinned). None when the model decides (no override)."""
    from nnstreamer_tpu_torch.types import TensorsInfo

    if not (filt.properties.get("input") and filt.properties.get("inputtype")):
        return None
    try:
        info = TensorsInfo.from_strings(
            str(filt.properties["input"]), str(filt.properties["inputtype"]),
            filt.properties.get("inputname"))
    except Exception:  # noqa: BLE001 — NNST1xx owns malformed overrides
        return None
    if info.num_tensors == 0:
        return None
    shape = info.tensors[0].np_shape()
    return int(shape[0]) if shape else 1


# --- NNST8xx: compile churn + donation safety (always-on, caps-level) -------

@analysis_pass("churn")
def churn_pass(ctx: AnalysisContext) -> None:
    """NNST800: variable-shape caps reaching a device filter rebuild its
    program per distinct shape. NNST802: ``custom=donate:1`` behind a
    fan-out (the filter refuses it at setup). NNST803: a host-fed private
    filter whose inputs die after the invoke could donate them."""
    from nnstreamer_tpu_torch.analysis.costmodel import _variable_shape_upstream
    from nnstreamer_tpu_torch.elements.filter import TensorFilter
    from nnstreamer_tpu_torch.pipeline.planner import (
        donation_requested,
        upstream_fanout_holder,
    )

    for e in ctx.pipeline.elements.values():
        if not isinstance(e, TensorFilter) or not e._fw_device_capable():
            continue
        custom = str(e.properties.get("custom", ""))
        donating = donation_requested(custom)
        holder = upstream_fanout_holder(e)
        if _variable_shape_upstream(e):
            ctx.emit(
                "NNST800", e,
                "variable-shape upstream caps reach this device filter: "
                "every distinct runtime shape rebuilds the program (a "
                "per-frame shape change rebuilds per frame)",
                hint="pin the caps (fixed dims), declare input/input-type, "
                     "or batch via tensor_converter so one signature "
                     "reaches the backend")
        if donating and holder is not None:
            ctx.emit(
                "NNST802", e,
                f"custom=donate:1 but {holder.name!r} fans the stream out "
                f"upstream: a sibling branch can still hold the input "
                f"buffer the donating backend releases (tensor_filter "
                f"refuses this at setup)",
                hint=f"drop donate:1 on {e.name!r}, or move the tee below "
                     f"the filter")
        elif (not donating and holder is None
                and not e.properties.get("shared_tensor_filter_key")
                and "shard:" not in custom
                and not _ocomb_references_inputs(e)
                and e.sink_pads
                and not (e.sink_pads[0].peer is not None
                         and e.sink_pads[0].peer.device_resident)):
            # host-fed private filter whose inputs die after the invoke:
            # donation would free their device copy for the forward's
            # activations instead of holding it through the invoke
            ctx.emit(
                "NNST803", e,
                "inputs are dead after invoke (no fan-out holds them, no "
                "output-combination re-emits them): custom=donate:1 would "
                "let the backend reuse their device allocation")


def _ocomb_references_inputs(e) -> bool:
    return any(tok.strip().startswith("i")
               for tok in str(e.properties.get("output_combination")
                              or "").split(","))


# --- NNST7xx: opt-in program cost & memory passes ----------------------------

@analysis_pass("costmodel", opt_in=True)
def costmodel_pass(ctx: AnalysisContext) -> None:
    from nnstreamer_tpu_torch.analysis.costmodel import filter_cost
    from nnstreamer_tpu_torch.elements.filter import TensorFilter

    for e in ctx.pipeline.elements.values():
        if not isinstance(e, TensorFilter) or not e._fw_device_capable():
            continue
        cost = filter_cost(e)
        if cost is None:
            continue
        ctx.emit(
            "NNST701", e,
            f"per-invoke (batch={cost['batch']}): "
            f"{cost['flops'] / 1e9:.3f} GFLOP, "
            f"{cost['hbm_bytes'] / 2**20:.2f} MB HBM traffic, "
            f"peak live {cost['peak_live_bytes'] / 2**20:.2f} MB, "
            f"params {cost['param_bytes'] / 2**20:.2f} MB "
            f"[{cost['method']}]")
        for hazard in cost.get("weak_type_hazards", ()):
            ctx.emit(
                "NNST801", e,
                f"python scalar leaked into the device program: {hazard}",
                hint="make the scalar a tensor of the stream's dtype "
                     "(torch.full((), v, dtype=x.dtype)) so the program "
                     "dtype is pinned")


@analysis_pass("memplan", opt_in=True)
def memplan_pass(ctx: AnalysisContext) -> None:
    from nnstreamer_tpu_torch.analysis.costmodel import static_report
    from nnstreamer_tpu_torch.analysis.memplan import (
        NEAR_BUDGET_FRACTION,
        fix_hint,
        plan_memory,
    )

    plan = plan_memory(ctx.pipeline)
    if plan["rows"]:
        total_mb = plan["total_bytes"] / 2**20
        budget_mb = plan["budget_bytes"] / 2**20
        if plan["total_bytes"] > plan["budget_bytes"]:
            ctx.emit(
                "NNST700", "pipeline",
                f"predicted HBM footprint {total_mb:.0f} MB exceeds the "
                f"device budget {budget_mb:.0f} MB "
                f"({plan['budget_source']}): this pipeline OOMs at "
                f"PLAYING",
                hint=fix_hint(plan))
        elif plan["utilization"] > NEAR_BUDGET_FRACTION:
            ctx.emit(
                "NNST703", "pipeline",
                f"predicted HBM footprint {total_mb:.0f} MB is "
                f"{plan['utilization'] * 100:.0f}% of the device budget "
                f"{budget_mb:.0f} MB ({plan['budget_source']}): one "
                f"renegotiation or fragmentation away from an OOM",
                hint=fix_hint(plan))
    report = static_report(ctx.pipeline)
    b = report["bottleneck"]
    if b is not None:
        ctx.emit(
            "NNST702", b["element"],
            f"static roofline: {b['element']!r} is the predicted "
            f"bottleneck ({b['resource']}-bound, "
            f"~{b['per_buffer_ms']:.3f} ms/buffer → "
            f"~{1e3 / b['per_buffer_ms'] if b['per_buffer_ms'] else 0:.0f} "
            f"buffers/s ceiling)")


# --- NNST85x: autotuner (nntune) — explicit-only ----------------------------

@analysis_pass("tuner", opt_in=True, explicit=True)
def tuner_pass(ctx: AnalysisContext) -> None:
    """Static tune of the launch line's config space (no measured runs):

    NNST851  search summary (enumerated/pruned/survivor counts and the
             best modeled config)
    NNST850  dominated config in use: the static model predicts at
             least ``headroom_warn_pct`` headroom over the line's
             current knobs
    NNST852  every enumerated point was pruned — no statically feasible
             configuration exists for this graph

    Explicit-only (never part of ``--cost``): it evaluates the whole
    space. Needs the launch source to re-parse per point; API-built
    pipelines are skipped (``validate --tune`` is the full CLI)."""
    from nnstreamer_tpu_torch.analysis.tuner import (
        TUNE_CONSTANTS,
        config_fragment,
        tune_report,
    )

    if ctx.source is None:
        return  # no launch line to re-parse: the tuner cannot search
    try:
        rep = tune_report(ctx.source, measure=False)
    except Exception:  # noqa: BLE001 — pass bodies never raise; broken
        # lines are already diagnosed by the construction passes
        return
    counts = rep.get("counts", {})
    if not counts.get("enumerated"):
        return  # nothing tunable
    survivors = counts["evaluated"] + counts["validated"]
    if survivors == 0:
        ctx.emit(
            "NNST852", "pipeline",
            f"every enumerated tuning point is statically infeasible "
            f"({counts['enumerated']} pruned: "
            + ", ".join(f"{k} x{v}"
                        for k, v in rep["pruned_by_code"].items())
            + ") — no configuration of this graph fits the device",
            hint="raise the budget (NNSTPU_HBM_BYTES), shrink the model, "
                 "or split the batch upstream")
        return
    chosen = rep["chosen"]
    ctx.emit(
        "NNST851", "pipeline",
        f"tuner: {counts['enumerated']} points enumerated, "
        f"{counts['pruned']} statically pruned, {survivors} evaluated; "
        f"best modeled config: {chosen['launch_fragment']} "
        f"(~{chosen['predicted']['modeled_fps']:.0f} frames/s, "
        f"{chosen['predicted']['bound']}-bound)")
    headroom = rep.get("headroom_pct")
    if headroom is not None and headroom >= TUNE_CONSTANTS[
            "headroom_warn_pct"]:
        base = rep["baseline"]
        ctx.emit(
            "NNST850", "pipeline",
            f"dominated config in use: the static model predicts "
            f"{headroom:.0f}% headroom over the current knobs "
            f"({config_fragment(base['config'])})",
            hint=f"try: {chosen['launch_fragment']} (doctor --tune "
                 f"validates the top candidates with measured runs)")


def _upstream_set(pad) -> set:
    """Every element on any path upstream of a sink pad (pad's own
    element excluded)."""
    out = set()
    stack = [pad.peer.element] if pad.peer is not None else []
    while stack:
        e = stack.pop()
        if e in out:
            continue
        out.add(e)
        for p in e.sink_pads:
            if p.peer is not None:
                stack.append(p.peer.element)
    return out


def _drops_frames(e) -> bool:
    """Statically known to drop/decimate frames mid-stream."""
    from nnstreamer_tpu_torch.elements.basic import QueueElement
    from nnstreamer_tpu_torch.elements.flow import TensorIf, TensorRate

    if isinstance(e, QueueElement):
        return e.properties.get("leaky") == "downstream"
    if isinstance(e, TensorRate):
        return e.rate_n > 0
    if isinstance(e, TensorIf):
        return "SKIP" in (e.then_action, e.else_action)
    return False


# --- NNST97x: the compile cache (nnaot) — explicit-only ------------------

@analysis_pass("aot", opt_in=True, explicit=True)
def aot_pass(ctx: AnalysisContext) -> None:
    """Compile-cache verdicts (analysis/aot.py): NNST970
    compile-point summary with predicted warm/cold outcome per
    planner-resolved program, NNST971 cold-start warning (element +
    missing key dimensions + estimated in-line build cost), NNST972
    stale/quarantined entries that can never be loaded again.

    Explicit-only (``validate --aot`` / ``doctor --aot``): it stats the
    on-disk cache, so default analyzer output stays byte-identical —
    and zero NNST97x on pipelines whose AOT gate is off."""
    from nnstreamer_tpu_torch.analysis.aot import aot_pass_body

    aot_pass_body(ctx)


# --- NNST99x: fleet deployment lint (nndeploy) — explicit-only --------------

@analysis_pass("deploy", opt_in=True, explicit=True)
def deploy_pass(ctx: AnalysisContext) -> None:
    """Fleet-level deployment verdicts (analysis/deploy.py): NNST990
    summary, NNST991 broken wiring, NNST992 cross-process signature
    mismatch, NNST993 fleet SLO infeasibility, NNST994 per-device HBM
    overcommit from co-resident members, NNST995 rollout hazards,
    NNST996 cold-start exposure.

    Explicit-only (``validate --deploy <spec>`` / ``doctor --deploy``):
    its subject is a :class:`analysis.deploy.Fleet` built from a deploy
    spec, not a single pipeline — on a regular pipeline it is a no-op,
    so default analyzer output stays byte-identical."""
    from nnstreamer_tpu_torch.analysis.deploy import deploy_pass_body

    deploy_pass_body(ctx)
