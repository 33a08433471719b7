"""PLAYING-transition planner: chain fusion, transform fusion, steady-loop
windows and device-residency lanes (counterpart of the JAX package's
``pipeline/planner.py``).

Run by Pipeline.set_state immediately before the sources start (no data
in flight):

0. **Chain-fusion planner** — consumes the static chain-composition
   analyzer (analysis/chain.py, NNST45x): pad-linked ``tensor_filter``
   chains connected through residency-transparent elements whose
   composition the analyzer PROVED sound (NNST450 — the members compose
   on meta tensors and the composed program fits the device budget) are
   installed on the chain's head filter (``install_chain``): one invoke
   runs the head's program, then each downstream model, with the gap
   transforms between them as ``arith_chain`` stages. The downstream
   members and gap transforms become passthrough shells
   (``fused-into:<head>`` on the tracer), so a multi-filter line does one
   upload, one dispatch and one fetch per buffer. Gated by
   ``fusion=auto|off`` plus the dedicated ``chain-fusion=auto|off``
   (pipeline attribute, per-element property, ``NNSTPU_CHAIN_FUSION``
   env). A backend that declines the composition falls back un-fused —
   per-filter behavior, no change. It plans FIRST: a gap transform the
   chain claims is invisible to the per-filter walks below, so its math
   runs exactly once.

1. **Fusion planner** — walks linear ``tensor_transform`` runs directly
   pad-linked to a ``tensor_filter`` and installs the bit-parity-eligible
   suffix/prefix in the filter's backend as pre/post stages
   (ops/fusion_stages.py: the arithmetic through the ``arith_chain``
   kernel, after the upload, on the stream the model runs on). Fused
   transforms become passthrough shells, visible on the tracer as
   ``fused-into:<filter>``. The eligibility gates are the transform's
   device-path gates (leading float32 typecast for arithmetic, no
   per-channel, no mid-chain casts, clamp needs a statically known
   float32 input), so fused and unfused paths are bit-identical —
   except ``stand``, whose float32 device accumulation against the host's
   float64 two-pass is float-tolerance parity (~1e-6 relative); anything
   else stays un-fused, with no behavior change.

2. **Residency negotiation** — each pad advertises whether it accepts /
   produces the backend's tensors (``Element.accepts_device`` /
   ``produces_device``, the ``memory:HBM`` caps feature). Adjacent
   device-capable elements hand CUDA tensors through untouched; the
   planner marks exactly one materialization boundary
   (``Pad.device_ok = False``) at the last device-capable element before a
   host-only consumer, looking through residency-transparent elements
   (queue/tee/…). The boundary element materializes with the filter's
   fetch machinery, so the flagship transform→filter→decoder line does
   ONE upload per batch and ONE fetch, at the filter, and a tee fan-out
   fetches once for all its branches.

Between the two runs the **steady-loop planner**: every filter the loop
analyzer (analysis/loop.py, fed by the cost model and the memory plan)
verdicts NNST460 gets its window program installed (``install_loop``)
over its FINAL composition (stages and chain); NNST461/462 and a
declining backend fall back LOUDLY to per-buffer launches. It runs before
residency because a looped filter drains its windows to the host, which
moves the materialization boundary.

Before the loop, the **mesh** and **pool** planners: every filter the
shard analyzer (analysis/shard.py) verdicts NNST470 gets its mesh
installed (``install_shard``); every serving source the pool analyzer
(analysis/pool.py) verdicts NNST960 gets its served filter's replicas and
its scheduler's least-loaded dispatch (``install_replicas``,
``install_pool``), and a serving source whose served filter engaged
``shard=dp`` places each serve-batch straight into the filter's shards
(``install_placement``). Every other verdict, and a declining backend,
falls back LOUDLY to unsharded / single-replica execution.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from nnstreamer_tpu_torch.log import get_logger

log = get_logger("planner")

#: transform modes the fusion planner understands (subset of
#: transform.MODES; everything else is an automatic un-fused fallback)
FUSABLE_MODES = ("typecast", "arithmetic", "clamp", "stand")


def plan_pipeline(pipeline) -> None:
    """Run the planning passes. Idempotent — each PLAYING transition
    re-plans from scratch (a PAUSED→PLAYING cycle or an edited graph gets
    fresh decisions). Chain fusion plans FIRST (it claims whole filters
    plus the gap transforms between them: a transform claimed by a chain
    is invisible to the per-filter walks, so its math runs exactly once,
    inside the composition), then per-filter transform fusion, the loop
    and residency."""
    from nnstreamer_tpu_torch.elements.filter import TensorFilter
    from nnstreamer_tpu_torch.elements.transform import TensorTransform

    # shells always reset here (ONE home for the reset — the chain and
    # transform planners both claim via _fused_into); backend programs
    # are cleared/rebuilt only when their plan actually changes
    for e in pipeline.elements.values():
        if isinstance(e, (TensorFilter, TensorTransform)):
            e._fused_into = None
    _plan_chain_fusion(pipeline)
    _plan_fusion(pipeline)
    # mesh partitioning plans after the fusion passes (a chain-claimed
    # filter can't shard; the analyzer's cheap gates encode that) and
    # before the loop (shard and loop-window are mutually exclusive)
    _plan_sharding(pipeline)
    # the replica pool plans after sharding (the pool analyzer's gates
    # read the shard decision) and wires the sharded serve-batch
    # placement for serving sources whose served filter engaged shard=dp
    _plan_pool(pipeline)
    _plan_steady_loop(pipeline)
    _plan_residency(pipeline)


# --- fusion planning ------------------------------------------------------

def _fusion_enabled(pipeline) -> bool:
    if os.environ.get("NNSTPU_FUSION", "").lower() in ("0", "off", "false"):
        return False
    return str(getattr(pipeline, "fusion", "auto")).lower() != "off"


def _elem_fusion_off(e) -> bool:
    return str(e.properties.get("fusion", "auto")).lower() == "off"


def _chain_fusion_enabled(pipeline) -> bool:
    """Whole-chain fusion gate: rides the transform-fusion gate (fusion
    off disables every planner optimization) plus its own
    ``chain-fusion=auto|off`` pipeline attribute and
    ``NNSTPU_CHAIN_FUSION`` env override."""
    if not _fusion_enabled(pipeline):
        return False
    if os.environ.get("NNSTPU_CHAIN_FUSION", "").lower() in (
            "0", "off", "false"):
        return False
    return str(getattr(pipeline, "chain_fusion", "auto")).lower() != "off"


# --- chain-fusion planning (analysis/chain.py is the oracle) --------------

def _plan_chain_fusion(pipeline) -> None:
    from nnstreamer_tpu_torch.elements.filter import TensorFilter

    filters = [e for e in pipeline.elements.values()
               if isinstance(e, TensorFilter)]
    if not filters:
        return
    tracer = getattr(pipeline, "tracer", None)
    fused_heads = set()
    if _chain_fusion_enabled(pipeline):
        from nnstreamer_tpu_torch.analysis.chain import analyze_chains

        for chain in analyze_chains(pipeline):
            # the analyzer is the oracle: only NNST450 chains (proved
            # composable AND inside the budget) are ever composed —
            # NNST451/452/453 chains run per-filter, unchanged
            if chain.code != "NNST450":
                continue
            head = chain.members[0]
            for m in chain.members[1:]:
                # a member's stages from an earlier per-filter epoch would
                # run inside its chain callable on top of the gap stages
                if m._pre_specs or m._post_specs:
                    m.clear_fusion()
            stages = chain.stage_list()
            tail_elems = chain.claimed_elements()
            if (stages == head._chain_specs
                    and tail_elems == head._chain_tail_elems):
                installed = True  # unchanged plan: the composition holds
            else:
                installed = head.install_chain(tail_elems, stages)
                if not installed:
                    head.clear_chain()  # drop a prior epoch's stale chain
            if not installed:
                log.info("[%s] backend declined whole-chain fusion; the "
                         "chain stays per-filter", head.name)
                continue
            fused_heads.add(id(head))
            for m in tail_elems:
                m._fused_into = head.name
                if tracer is not None:
                    tracer.record_fusion(m.name, head.name)
            log.info("[%s] chain-fused %d downstream filter(s) + %d gap "
                     "transform(s) into one program (%s)", head.name,
                     len(chain.members) - 1,
                     sum(len(g) for g in chain.gaps), chain.label())
    # heads whose chain dissolved (edited graph, gates flipped): tear the
    # stale composition down so the solo program serves again
    for f in filters:
        if id(f) not in fused_heads and (f._chain_specs
                                         or f._chain_tail_elems):
            f.clear_chain()


def transform_fusion_spec(transform, cur_dtype, batch: int):
    """Eligibility of ONE transform for device-side fusion.

    Returns ``(spec, out_dtype)`` or None. ``cur_dtype`` is the (possibly
    unknown = None) dtype entering this stage; ``batch`` is the adjacent
    filter's batch-size (stand is granularity-hazardous under filter
    micro-batching: a fused stand would normalize over the whole batch
    jointly while the unfused element normalizes per buffer).

    Specs are plain tuples (hashable, backend-independent):
      ("typecast", "<dtype name>")         — non-64-bit targets only
      ("arith", (("add", v), …))           — leading typecast:float32 grammar
      ("clamp", lo, hi)                    — float32 input required
      ("stand", "default"|"dc-average")    — whole-tensor, float32 out
    """
    from nnstreamer_tpu_torch.types import TensorDType

    mode, opt = transform._mode, transform._option
    if mode == "typecast":
        try:
            dt = TensorDType.from_any(opt).np_dtype
        except Exception:  # noqa: BLE001 — unparseable: not fusable
            return None
        if np.dtype(dt).itemsize == 8:
            # 64-bit targets: the JAX package's gate (x64=off truncates),
            # kept so both packages fuse the same chains
            return None
        return ("typecast", np.dtype(dt).name), np.dtype(dt)
    if mode == "arithmetic":
        # the device-path gates verbatim: no per-channel, leading
        # typecast:float32, no mid-chain casts
        if "@" in opt or "per-channel" in opt:
            return None
        toks = [t.strip() for t in opt.split(",") if t.strip()]
        if not toks or not toks[0].startswith("typecast:"):
            return None
        try:
            cast = TensorDType.from_any(toks[0].split(":")[1]).np_dtype
        except Exception:  # noqa: BLE001
            return None
        if cast != np.float32:
            return None
        ops = []
        for tok in toks[1:]:
            k, _, v = tok.partition(":")
            if k == "typecast" or k not in ("add", "mul", "div"):
                return None
            try:
                ops.append((k, float(v)))
            except ValueError:
                # unparseable operand: not fusable — the error surfaces
                # per-buffer through the element path, never from set_state
                return None
        return ("arith", tuple(ops)), np.dtype(np.float32)
    if mode == "clamp":
        # numpy clip on non-f32 promotes; only a statically-known float32
        # input bit-matches the kernel's float32 clamp
        if cur_dtype is None or np.dtype(cur_dtype) != np.float32:
            return None
        try:
            lo, hi = (float(x) for x in opt.split(":"))
        except Exception:  # noqa: BLE001
            return None
        return ("clamp", lo, hi), np.dtype(np.float32)
    if mode == "stand":
        if batch > 1:
            return None  # per-buffer vs per-batch normalization hazard
        parts = opt.split(":") if opt else ["default"]
        if "per-channel" in parts:
            return None
        if parts[0] not in ("default", "dc-average"):
            return None
        return ("stand", parts[0]), np.dtype(np.float32)
    return None


def _chain_specs(chain: List, seed_dtype, batch: int) -> Optional[List[tuple]]:
    """Specs for a whole transform chain (upstream→downstream order), or
    None when any stage is ineligible."""
    specs: List[tuple] = []
    cur = seed_dtype
    for t in chain:
        r = transform_fusion_spec(t, cur, batch)
        if r is None:
            return None
        spec, cur = r
        specs.append(spec)
    return specs


def _walk_transform_chain(start_pad, upstream: bool) -> List:
    """Collect the maximal run of singly-linked tensor_transform elements
    from a pad, walking upstream (via sink pads) or downstream (via src
    pads). Returned nearest-the-filter-first."""
    from nnstreamer_tpu_torch.elements.transform import TensorTransform

    chain = []
    pad = start_pad.peer if start_pad is not None else None
    while pad is not None:
        e = pad.element
        if (not isinstance(e, TensorTransform)
                or len(e.sink_pads) != 1 or len(e.src_pads) != 1
                or _elem_fusion_off(e)
                # already claimed by another filter this plan (a transform
                # between two filters is reachable from both — fusing it
                # into both would apply its math twice)
                or e._fused_into is not None):
            break
        chain.append(e)
        nxt = e.sink_pads[0] if upstream else e.src_pads[0]
        pad = nxt.peer
    return chain


def _info_dtype(info) -> Optional[np.dtype]:
    """The single dtype of a TensorsInfo when all tensors agree, else None."""
    if info is None or info.num_tensors == 0:
        return None
    dts = {t.dtype.np_dtype for t in info}
    return np.dtype(next(iter(dts))) if len(dts) == 1 else None


def _plan_fusion(pipeline) -> None:
    """Per-filter transform fusion. Shell reset happens in plan_pipeline
    (shared with the chain planner, which claims elements first); filter
    stages are cleared/rebuilt only when their plan actually CHANGES."""
    from nnstreamer_tpu_torch.elements.filter import TensorFilter

    enabled = _fusion_enabled(pipeline)
    tracer = getattr(pipeline, "tracer", None)
    for f in pipeline.elements.values():
        if not isinstance(f, TensorFilter):
            continue
        if f._fused_into is not None:
            # chain-fused shell: its model runs inside the head's
            # composition; it owns no program to fuse stages into
            continue
        pre: List = []
        pre_specs: List[tuple] = []
        post: List = []
        post_specs: List[tuple] = []
        shared = bool(f.properties.get("shared_tensor_filter_key"))
        eligible = (enabled and f.fw is not None and not _elem_fusion_off(f)
                    and not shared
                    and not (f.properties.get("invoke_dynamic")
                             or f.properties.get("input_combination")
                             or f.properties.get("output_combination")))
        # combination indices and flexible output change per-tensor
        # routing in ways the simple per-tensor stages can't mirror.
        # Shared backends (shared_tensor_filter_key) are never fused:
        # stages live on the framework object, which acquire_framework
        # hands to EVERY filter sharing the key — installing (or
        # clearing) stages for one filter would silently run them (or
        # drop them) inside every sharer's invokes, while only this
        # filter's upstream transforms became passthrough shells
        if eligible:
            batch = int(f.properties.get("batch_size", 1) or 1)

            # pre-chain: nearest-first upstream walk, then the longest
            # eligible SUFFIX adjacent to the filter (an ineligible stage
            # cuts everything upstream of it, not the whole run)
            up = _walk_transform_chain(
                f.sink_pads[0] if f.sink_pads else None, upstream=True)
            up.reverse()  # upstream→downstream order
            for start in range(len(up)):
                specs = _chain_specs(up[start:], None, batch)
                if specs is not None:
                    pre, pre_specs = up[start:], specs
                    break

            # post-chain: model-output dtype is known, so eligibility
            # folds forward; an ineligible stage keeps the eligible PREFIX
            down = _walk_transform_chain(
                f.src_pads[0] if f.src_pads else None, upstream=False)
            cur = _info_dtype(getattr(f, "_out_info", None))
            for t in down:
                r = transform_fusion_spec(t, cur, batch)
                if r is None:
                    break
                spec, cur = r
                post.append(t)
                post_specs.append(spec)

        if not pre and not post:
            # shared backends are left untouched — unless THIS filter has
            # an install on record (a key added after stages were planned
            # onto the then-private backend): its own stale stages would
            # otherwise keep running while the transforms go live again,
            # applying their math twice
            if not shared or f._pre_specs or f._post_specs:
                f.clear_fusion()  # backend no-ops when nothing was installed
            continue
        if (pre_specs == f._pre_specs and post_specs == f._post_specs
                and pre == f._fused_pre and post == f._fused_post):
            installed = True  # unchanged plan: the installed stages hold
        else:
            installed = f.install_fusion(pre, pre_specs, post, post_specs)
            if not installed:
                f.clear_fusion()  # drop stale stages from a prior plan
        if not installed:
            log.info("[%s] backend declined stage fusion; chains stay "
                     "un-fused", f.name)
            continue
        for t in pre + post:
            t._fused_into = f.name
            if tracer is not None:
                tracer.record_fusion(t.name, f.name)
        log.info("[%s] fused %d pre + %d post transform stage(s) into the "
                 "backend", f.name, len(pre), len(post))


# --- mesh-partition planning (analysis/shard.py is the oracle) --------------

def _plan_sharding(pipeline) -> None:
    """Install the mesh placement on every filter the shard analyzer
    verdicts NNST470; everything else falls back LOUDLY to unsharded
    execution — numerically identical, so an ineligible or declined shard
    is a warning, never an error. NNST472 (reshard hazard) is advisory:
    the edge still flows, the downstream filter pays the re-split."""
    from nnstreamer_tpu_torch.analysis.shard import analyze_shards
    from nnstreamer_tpu_torch.elements.filter import TensorFilter

    filters = [e for e in pipeline.elements.values()
               if isinstance(e, TensorFilter)]
    if not filters:
        return
    # neutralize this epoch's state (the analyzer's resolution must read
    # THIS graph, not last epoch's decisions); an UNCHANGED plan
    # restores it without rebuilding the compiled program
    from nnstreamer_tpu_torch.analysis.loop import requested_window

    prior = {}
    for f in filters:
        prior[id(f)] = f._shard_state
        f._shard_state = None
        f.__dict__.pop("_nnshard_cache", None)
        # a PRIOR epoch's installed window whose property flipped off
        # must not veto this epoch's shard decision: the loop planner's
        # own teardown runs AFTER this pass, but shard_supported() reads
        # the backend's installed window — tear the stale program down
        # here (when the window IS still requested, the analyzer's
        # loop-interaction gate blocks the shard instead)
        if (f.fw is not None and getattr(f.fw, "_loop_window", 0) > 0
                and requested_window(f) == 1):
            f.clear_loop()
    planned = set()
    for v in analyze_shards(pipeline):
        e = pipeline.elements.get(v.element)
        if e is None or v.code == "NNST472":
            continue  # hazards are advisory, not install decisions
        e._shard_refused = None
        if v.code == "NNST470":
            pv = prior.get(id(e))
            if (pv == v.config and e.fw is not None
                    and getattr(e.fw, "_shard_installed", False)):
                e._shard_state = pv  # unchanged plan: program still valid
                planned.add(id(e))
                continue
            if e.install_shard(v.config):
                planned.add(id(e))
                log.info("[%s] mesh placement installed: shard=%s over a "
                         "%dx%d mesh (rows land on their shard at upload)",
                         e.name, v.config["mode"], v.config["dp"],
                         v.config["tp"])
                continue
            e._shard_refused = ("NNST470",
                                "backend declined the mesh placement")
            log.warning("[%s] shard=: backend declined the mesh "
                        "placement — unsharded execution", e.name)
        else:
            e._shard_refused = (v.code, v.message)
            log.warning("[%s] shard= falls back to unsharded execution "
                        "(%s): %s", e.name, v.code, v.message)
    # filters whose mesh dissolved (edited graph, prop flipped, a
    # fallback verdict this plan): tear the stale placement down
    for f in filters:
        if id(f) not in planned and (prior.get(id(f)) is not None
                                     or f._shard_state is not None):
            f.clear_shard()
    # marks the shard decision as MADE for this epoch: the crossing
    # predictor and the memory plan read installed state (ground truth)
    # instead of re-deriving a resolution an open backend may have
    # declined
    pipeline._shard_planned = True


# --- replica-pool planning (analysis/pool.py is the oracle) ----------------

def _plan_pool(pipeline) -> None:
    """Install the NNST960-licensed replica pool on every serving
    source the pool analyzer licenses, and wire sharded serve-batch
    placement wherever the served filter engaged ``shard=dp``;
    everything else falls back LOUDLY to single-replica / host-stacked
    serving — numerically identical, so an ineligible or declined pool
    is a warning, never an error."""
    from nnstreamer_tpu_torch.elements.filter import TensorFilter
    from nnstreamer_tpu_torch.elements.query import TensorQueryServerSrc

    srcs = [e for e in pipeline.elements.values()
            if isinstance(e, TensorQueryServerSrc)]
    if not srcs:
        pipeline._pool_planned = True
        return
    from nnstreamer_tpu_torch.analysis.pool import analyze_pool

    # neutralize this epoch's state (the analyzer's resolution must
    # read THIS graph, not last epoch's decisions)
    for e in srcs:
        e._pool_refused = None
        e.clear_pool()
    pipeline.__dict__.pop("_nnpool_cache", None)
    engaged_filters = set()
    for v in analyze_pool(pipeline):
        e = pipeline.elements.get(v.element)
        if e is None:
            continue
        if v.code != "NNST960":
            e._pool_refused = (v.code, v.message)
            log.warning("[%s] replicas= falls back to single-replica "
                        "serving (%s): %s", e.name, v.code, v.message)
            continue
        filt = pipeline.elements.get(v.filter or "")
        if filt is None:
            continue
        if filt.install_replicas(v.replicas):
            e.install_pool(v.replicas)
            engaged_filters.add(id(filt))
            log.info("[%s] replica pool installed: %d per-device "
                     "replicas of %r, least-loaded dispatch", e.name,
                     v.replicas, filt.name)
        else:
            e._pool_refused = ("NNST960",
                               "backend declined the replica pool")
            log.warning("[%s] replicas=: backend declined the replica "
                        "pool — single-replica serving", e.name)
    # filters whose pool dissolved (edited graph, prop flipped, a
    # fallback verdict this plan): tear the stale programs down
    for f in pipeline.elements.values():
        if isinstance(f, TensorFilter) and id(f) not in engaged_filters \
                and f._replica_state is not None:
            f.clear_replicas()
    # sharded-placement wiring: a serving source whose served filter
    # engaged shard=dp gets its serve-batches placed straight into the
    # sharded layout (licensed by the filter's own NNST470 verdict —
    # the resolver re-reads live state per batch)
    from nnstreamer_tpu_torch.analysis.pool import served_filter

    for e in srcs:
        filt = (served_filter(e)
                if e.properties.get("serve") else None)
        state = getattr(filt, "_shard_state", None) if filt else None
        if state and state.get("mode") == "dp" \
                and int(state.get("dp", 1)) > 1:
            e.install_placement(filt)
            log.info("[%s] sharded serve-batch placement engaged: rows "
                     "land on %r's %dx%d mesh at H2D time", e.name,
                     filt.name, state["dp"], state["tp"])
        else:
            e.clear_placement()
    # marks the pool decision as MADE for this epoch: the memplan
    # billing reads installed state (ground truth) instead of
    # re-deriving a resolution an open backend may have declined
    pipeline._pool_planned = True


# --- steady-loop planning (analysis/loop.py is the oracle) -----------------

def _plan_steady_loop(pipeline) -> None:
    """Install the window program on every filter the loop analyzer
    verdicts NNST460; everything else falls back LOUDLY to per-buffer
    launches — the fallback is numerically identical, so an ineligible or
    declined loop is a warning, never an error."""
    from nnstreamer_tpu_torch.analysis.loop import analyze_loops
    from nnstreamer_tpu_torch.elements.filter import TensorFilter

    filters = [e for e in pipeline.elements.values()
               if isinstance(e, TensorFilter)]
    if not filters:
        return
    # the eligibility gates (produces_device via _device_fed) must read
    # THIS epoch's graph, not last epoch's decisions. State is neutralized
    # (not torn down) so an UNCHANGED plan keeps its captured program
    prior = {}
    for f in filters:
        prior[id(f)] = f._loop_state
        f._loop_state = None
    planned = set()
    for v in analyze_loops(pipeline):
        e = pipeline.elements.get(v.element)
        if e is None:
            continue
        e._loop_refused = None
        if v.code == "NNST460":
            pv = prior.get(id(e))
            if (pv == {"window": v.window, "depth": v.depth}
                    and e.fw is not None
                    and getattr(e.fw, "_loop_window", 0) == v.window):
                e._loop_state = pv  # unchanged plan: program still valid
                planned.add(id(e))
                continue
            if e.install_loop(v.window, v.depth):
                planned.add(id(e))
                log.info("[%s] steady loop installed: ONE dispatch per %d "
                         "frames, launch-depth=%d", e.name, v.window,
                         v.depth)
                continue
            e._loop_refused = ("NNST460",
                               "backend declined the window program")
            log.warning("[%s] loop-window: backend declined the window "
                        "program — per-buffer launches", e.name)
        else:
            e._loop_refused = (v.code, v.message)
            log.warning("[%s] loop-window falls back to per-buffer "
                        "launches (%s): %s", e.name, v.code, v.message)
    # filters whose window dissolved (edited graph, a flipped property, a
    # fallback verdict this plan): tear the stale program down
    for f in filters:
        if id(f) not in planned and (prior.get(id(f)) is not None
                                     or f._loop_state is not None):
            f.clear_loop()
    # the loop decision is MADE for this epoch: the crossing predictor
    # reads installed state instead of re-deriving eligibility that an
    # open backend may have declined
    pipeline._loop_planned = True


def donation_requested(custom) -> bool:
    """Does a filter's ``custom`` string ask for input donation? Parses
    through the SAME custom_dict() grammar the backend uses (whitespace
    tolerated: ``donate: 1`` donates), so the safety gate and the NNST802
    lint can never disagree with the runtime about whether the backend
    will donate."""
    from nnstreamer_tpu_torch.filters.base import FilterProperties

    cd = FilterProperties(custom=str(custom or "")).custom_dict()
    return cd.get("donate") in ("1", "true", "input")


def upstream_fanout_holder(e):
    """The nearest upstream element that hands the SAME tensor objects to
    more than one consumer (a tee — possibly behind queues or other
    residency-transparent forwarders): a sibling branch can still hold
    the buffer this element receives. Keys on the element-declared
    ``DUPLICATES_BUFFERS`` capability, NOT on pad count — routers and
    splitters hand each buffer to exactly one consumer. Non-transparent
    elements rewrap tensors, which ends the shared-ownership chain."""
    seen = set()

    def walk(el):
        if el is None or id(el) in seen:
            return None
        seen.add(id(el))
        if not is_transparent(el):
            return None
        if getattr(el, "DUPLICATES_BUFFERS", False) and \
                sum(1 for sp in el.src_pads if sp.peer is not None) > 1:
            return el
        for p in el.sink_pads:
            if p.peer is not None:
                hit = walk(p.peer.element)
                if hit is not None:
                    return hit
        return None

    for p in e.sink_pads:
        if p.peer is not None:
            hit = walk(p.peer.element)
            if hit is not None:
                return hit
    return None


# --- residency negotiation ------------------------------------------------

def is_transparent(e) -> bool:
    """Residency-transparent: forwards tensor payloads untouched. Fused
    transforms are passthrough shells, hence transparent."""
    return e.DEVICE_TRANSPARENT or getattr(e, "_fused_into", None) is not None


def downstream_accepts_device(pad, _memo=None) -> bool:
    """Does everything downstream of this src pad (looking through
    transparent elements, across every branch) accept the backend's
    tensors? A tee with one host-only branch answers False — one
    materialization boundary serves all branches.

    Verdicts memoize per element so reconverging (diamond) topologies —
    tee branches rejoining at a mux — get the element's COMPUTED answer
    on revisit, not a blanket False that would plant a premature
    boundary. ``None`` in the memo marks in-progress: a true pad-linked
    cycle conservatively stays host."""
    peer = pad.peer
    if peer is None:
        return False
    e = peer.element
    if _memo is None:
        _memo = {}
    if e.accepts_device(peer):
        return True
    if not is_transparent(e):
        return False
    key = id(e)
    if key in _memo:
        v = _memo[key]
        return False if v is None else v
    _memo[key] = None  # in-progress
    linked = [sp for sp in e.src_pads if sp.peer is not None]
    verdict = bool(linked) and all(
        downstream_accepts_device(sp, _memo) for sp in linked)
    _memo[key] = verdict
    return verdict


def _plan_residency(pipeline) -> None:
    # topo order (sources→sinks) so device_resident propagates forward
    # through transparent forwarders: an edge is stamped memory:HBM only
    # when device buffers will actually flow on it
    for e in pipeline._topo_order():
        upstream_dev = any(
            sp.peer is not None and sp.peer.device_resident
            for sp in e.sink_pads)
        for sp in e.src_pads:
            sp.device_ok = downstream_accepts_device(sp)
            sp.device_resident = bool(
                sp.device_ok and (e.produces_device(sp)
                                  or (is_transparent(e) and upstream_dev)))
