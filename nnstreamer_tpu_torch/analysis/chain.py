"""nnchain — static chain-composition analyzer, NNST45x (counterpart of the
JAX package's ``analysis/chain.py``).

Walks pad-linked ``tensor_filter`` chains connected through
residency-transparent elements (the transparency notion the residency
planner uses), composes the members' programs statically — model B
applied to model A's outputs, with any fusable ``tensor_transform`` gap
stages in between — and emits one verdict per chain:

  NNST450  chain-fusable: the composition runs cleanly on ``meta``
           tensors AND the composed program fits the device budget.
           Carries the modeled savings (program launches and interior
           link crossings per buffer). The PLAYING planner
           (pipeline/planner.py ``_plan_chain_fusion``) consumes exactly
           these chains.
  NNST451  chain-blocked, naming the FIRST blocking link and its reason:
           shared backend key, ``sync=1``, ``invoke-dynamic``/dynamic
           shapes, a fan-out tee between the filters, i/o-combination
           re-routing, micro-batching on a non-head member,
           non-composable backends, ineligible gap transforms. The chain
           runs per-filter, unchanged.
  NNST452  composed-program-over-budget: the composed program run through
           ``memplan.plan_memory`` (member rows replaced by ONE composed
           row, params billed once per backend) busts the device budget —
           fusion is pruned BEFORE anything runs, and the chain runs
           per-filter.
  NNST453  shape/dtype mismatch at a specific link, with a fix hint — the
           composition is structurally eligible but model B cannot
           consume what the chain produces at that link.

The JAX package composes with ``jax.eval_shape``; here each member's
program (the open backend's ``cost_program``, else the lint-time rebuild)
runs on ``meta`` tensors: shapes and dtypes, no data, no launch (the
kernel wrappers route meta tensors to their plain versions). The composed
program's cost comes from the same meta run
(``costmodel.program_cost``). The analysis is the proof that licenses
the optimization: the planner never composes a chain this module did not
mark NNST450.

The composition runs ONLY when a structurally plausible chain exists, so
pipelines without filter→filter links pay nothing on the default lint.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch


def _chain_off(e) -> bool:
    return str(e.properties.get("chain_fusion", "auto")).lower() == "off"


@dataclass
class FilterChain:
    """One discovered filter→filter run (>= 2 members) plus its verdict.

    ``members`` are the tensor_filter elements upstream→downstream;
    ``gaps[i]`` holds the tensor_transform elements between members[i]
    and members[i+1] (transparent forwarders — queues etc. — are looked
    through and not recorded). ``code`` is the NNST45x verdict after
    :func:`analyze_chains`."""

    members: List
    gaps: List[List]
    blocked: Optional[Tuple[object, str]] = None  # (element, reason)
    code: Optional[str] = None
    message: str = ""
    hint: Optional[str] = None
    element: Optional[str] = None  # diagnostic attribution
    gap_specs: List[List[tuple]] = field(default_factory=list)
    composed_cost: Optional[dict] = None
    plan: Optional[dict] = None
    savings: Optional[dict] = None

    def label(self) -> str:
        return "->".join(m.name for m in self.members)

    def claimed_elements(self) -> List:
        """Every element the planner turns into a passthrough shell: the
        non-head members plus all gap transforms, in stream order — also
        the elements whose caps effect the head's src caps must carry."""
        out: List = []
        for i, m in enumerate(self.members[1:]):
            out.extend(self.gaps[i])
            out.append(m)
        return out

    def stage_list(self) -> List[tuple]:
        """The planner-facing stage list for ``install_chain``:
        alternating ("stages", specs) elementwise runs and ("model",
        ModelStage) whole-model stages. Only meaningful on an NNST450
        chain with OPEN member backends (plan time)."""
        from nnstreamer_tpu_torch.ops.fusion_stages import ModelStage

        stages: List[tuple] = []
        for i, m in enumerate(self.members[1:]):
            specs = tuple(self.gap_specs[i]) if i < len(self.gap_specs) \
                else ()
            if specs:
                stages.append(("stages", specs))
            stages.append(("model", ModelStage(m.name, m.fw, m)))
        return stages


# --------------------------------------------------------------------------
# discovery
# --------------------------------------------------------------------------

def _member_candidate(e) -> bool:
    from nnstreamer_tpu_torch.elements.filter import TensorFilter

    return (isinstance(e, TensorFilter) and e._fw_device_capable()
            and not _chain_off(e))


def _next_link(f):
    """Follow ``f``'s src pad downstream to the next tensor_filter through
    transparent elements and candidate gap transforms. Returns ``(tail,
    gap_transforms, blocker)`` or None when no filter is reachable that
    way (the chain simply ends). A fan-out on the way is recorded as a
    blocker (a sibling branch observes the interior stream, so removing it
    from the wire breaks that branch) and EVERY branch is searched for the
    would-be tail, so the NNST451 verdict names the tee regardless of
    launch-line branch order."""
    if len(f.src_pads) != 1:
        return None
    return _walk_pad(f.src_pads[0].peer, [], None, set())


def _walk_pad(pad, gap: List, blocker, seen: set):
    from nnstreamer_tpu_torch.elements.filter import TensorFilter
    from nnstreamer_tpu_torch.elements.transform import TensorTransform
    from nnstreamer_tpu_torch.pipeline.planner import _elem_fusion_off

    while pad is not None:
        e = pad.element
        if id(e) in seen:
            return None  # pad-linked cycle: NNST005's problem
        seen.add(id(e))
        if isinstance(e, TensorFilter):
            return e, gap, blocker
        if isinstance(e, TensorTransform) and e._mode:
            if len(e.sink_pads) != 1 or len(e.src_pads) != 1:
                return None
            if _elem_fusion_off(e):
                return None  # must stay live: the chain cannot span it
            gap.append(e)
            pad = e.src_pads[0].peer
            continue
        if getattr(e, "DEVICE_TRANSPARENT", False):
            if sum(1 for p in e.sink_pads if p.peer is not None) > 1:
                return None  # another stream merges in: not a chain
            linked = [sp for sp in e.src_pads if sp.peer is not None]
            if not linked:
                return None
            if len(linked) > 1:
                blk = blocker or (
                    e, f"fan-out between the filters: {e.name!r} hands "
                       f"the interior stream to {len(linked)} sibling "
                       f"branches, which would observe nothing once the "
                       f"link is fused away")
                for sp in linked:
                    hit = _walk_pad(sp.peer, list(gap), blk, seen)
                    if hit is not None:
                        return hit
                return None
            pad = linked[0].peer
            continue
        return None
    return None


def discover_chains(pipeline) -> List[FilterChain]:
    """Maximal filter→filter runs in topo order, GATE-AWARE: a blocked
    link or a member failing its gates ends the run but never discards
    the fusable work around it — the clean prefix (>= 2 members) is
    emitted as its own chain, the blocked link as a separate two-member
    chain carrying the blocker (so NNST451 names it), and the blocking
    filter is left free to HEAD its own downstream run."""
    chains: List[FilterChain] = []
    consumed = set()
    for f in pipeline._topo_order():
        if not _member_candidate(f) or id(f) in consumed:
            continue
        head_reason = _member_blocker(f, is_head=True)
        if head_reason is not None:
            # cannot head a chain: emit the blocked verdict if a link
            # exists, and leave downstream filters free for their own run
            link = _next_link(f)
            if link is not None and _member_candidate(link[0]):
                chains.append(FilterChain(
                    members=[f, link[0]], gaps=[link[1]],
                    blocked=(f, head_reason)))
            continue
        members, gaps = [f], []
        cur = f
        while True:
            link = _next_link(cur)
            if link is None:
                break
            tail, gap, blk = link
            if not _member_candidate(tail):
                break
            if blk is None:
                reason = _member_blocker(tail, is_head=False)
                if reason is not None:
                    blk = (tail, reason)
            if blk is not None:
                # blocked link: a separate two-member chain carries the
                # verdict; the clean prefix still fuses, and the tail may
                # head its own downstream run
                chains.append(FilterChain(
                    members=[cur, tail], gaps=[gap], blocked=blk))
                break
            members.append(tail)
            gaps.append(gap)
            cur = tail
        if len(members) >= 2:
            consumed.update(id(m) for m in members)
            chains.append(FilterChain(members=members, gaps=gaps))
    return chains


def fusable_chains(pipeline) -> List[FilterChain]:
    """Structurally eligible chains (discovery and the member/link gates,
    no composition): what the tuner keys the ``chain-fusion`` knob on. A
    chain here may still be pruned by NNST452/453 once composed."""
    return [c for c in discover_chains(pipeline)
            if c.blocked is None and _first_member_blocker(c) is None]


# --------------------------------------------------------------------------
# member / link gates (NNST451 reasons)
# --------------------------------------------------------------------------

def _member_blocker(m, is_head: bool) -> Optional[str]:
    from nnstreamer_tpu_torch.analysis.shard import requested_shard

    if requested_shard(m) is not None:
        return ("shard= mesh placement on a member (a mesh-partitioned "
                "program cannot splice into a composed single-device "
                "chain — drop shard= or chain-fusion)")
    if m.properties.get("shared_tensor_filter_key"):
        return ("shared backend key: chain stages live on the framework "
                "object every sharer invokes")
    if m.properties.get("invoke_dynamic"):
        return "invoke-dynamic output (per-invoke shapes cannot compose)"
    if m.properties.get("sync"):
        return "sync=1 forces a host materialization at this link"
    if m.properties.get("input_combination") \
            or m.properties.get("output_combination"):
        return ("input/output-combination re-routes tensors in ways the "
                "composed program cannot mirror")
    if not is_head:
        b = int(m.properties.get("batch_size", 1) or 1)
        if b > 1:
            return (f"batch-size={b} on a non-head member (its "
                    f"micro-batch assembly cannot run inside the head's "
                    f"program)")
    return None


def _first_member_blocker(c: FilterChain):
    """(element, reason) for the first member-gate violation in stream
    order, or None."""
    from nnstreamer_tpu_torch.analysis.costmodel import (
        _variable_shape_upstream,
    )

    for i, m in enumerate(c.members):
        reason = _member_blocker(m, is_head=(i == 0))
        if reason is not None:
            return m, reason
    if _variable_shape_upstream(c.members[0]):
        return c.members[0], ("dynamic-shape upstream caps (every "
                              "distinct shape would rebuild the composed "
                              "program)")
    return None


# --------------------------------------------------------------------------
# composition (NNST452 / NNST453 / the NNST450 proof)
# --------------------------------------------------------------------------

def _np_dtype(t: torch.Tensor) -> Optional[np.dtype]:
    """The numpy dtype of a tensor's dtype; None where numpy has none
    (bfloat16)."""
    try:
        return np.dtype(str(t.dtype).replace("torch.", ""))
    except TypeError:
        return None


def _single_dtype(tensors) -> Optional[np.dtype]:
    dts = {_np_dtype(t) for t in tensors}
    return next(iter(dts)) if len(dts) == 1 else None


def _as_list(out) -> List:
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _member_fn(m):
    """(fn(params, *xs), params) of one member's per-invoke program — the
    open backend's composition when available, else the deterministic
    lint-time rebuild. Unlike ``filter_program`` this does NOT need the
    member's own sink caps resolved: interior links get their signatures
    from the stepwise composition itself."""
    from nnstreamer_tpu_torch.analysis.costmodel import _lint_time_program

    prog = None
    if m.fw is not None and hasattr(m.fw, "cost_program"):
        prog = m.fw.cost_program()
    if prog is None:
        prog = _lint_time_program(m)
    if prog is None:
        return None
    return prog[0], prog[1]


def _annotate(m, cur) -> None:
    """Publish the composed signature entering member ``m`` as its
    resolved input signature: the dry negotiation cannot see past a
    reshapable upstream model, but the memory plan and the roofline can
    model the member off this annotation (costmodel.filter_program's
    last resort)."""
    from nnstreamer_tpu_torch.buffer import dtype_name
    from nnstreamer_tpu_torch.types import TensorInfo, TensorsInfo

    try:
        m.__dict__["_nnchain_in_info"] = TensorsInfo(tensors=[
            TensorInfo.from_np_shape(tuple(int(d) for d in a.shape),
                                     dtype_name(a)) for a in cur])
    except Exception:  # noqa: BLE001 — the annotation is best-effort
        pass


def _compose(chain: FilterChain, pipeline):
    """Stepwise composition of the chain on ``meta`` tensors. Fills
    ``chain.gap_specs`` and returns either ``(fn, params_tuple,
    head_shapes)`` for the composed program, or an (element, code,
    message, hint) failure tuple."""
    from nnstreamer_tpu_torch.analysis.costmodel import (
        filter_program,
        meta_tensors,
    )
    from nnstreamer_tpu_torch.ops.fusion_stages import build_stage_fn
    from nnstreamer_tpu_torch.pipeline.planner import transform_fusion_spec

    head_prog = filter_program(chain.members[0])
    if head_prog is None:
        return (chain.members[0], "NNST451",
                f"head {chain.members[0].name!r} has no statically "
                f"modelable program (non-torch framework, a model that "
                f"cannot be built on the meta device, or an unresolved "
                f"input signature) — the composition cannot be proved",
                None)
    progs = [(head_prog[0], head_prog[1])]
    for m in chain.members[1:]:
        prog = _member_fn(m)
        if prog is None:
            return (m, "NNST451",
                    f"backend of {m.name!r} is not composable (no "
                    f"statically modelable torch program: a model that "
                    f"cannot be built on the meta device, or a non-torch "
                    f"framework)", None)
        progs.append(prog)
    head_shapes = head_prog[2]
    batch = int(chain.members[0].properties.get("batch_size", 1) or 1)

    chain.gap_specs = []
    gap_fns: List = []
    cur = meta_tensors(head_shapes)
    prev = chain.members[0]
    with torch.no_grad():
        for i, (fn, params) in enumerate(progs):
            m = chain.members[i]
            if i > 0:
                # gap transforms between members[i-1] and members[i]: each
                # must reduce to a device-parity stage spec at the dtype
                # flowing through the link
                specs: List[tuple] = []
                cur_dt = _single_dtype(cur)
                for t in chain.gaps[i - 1]:
                    r = transform_fusion_spec(t, cur_dt, batch)
                    if r is None:
                        return (t, "NNST451",
                                f"gap transform {t.name!r} (mode="
                                f"{t._mode}) is not device-parity fusable "
                                f"at this link; the chain cannot span it",
                                None)
                    spec, cur_dt = r
                    specs.append(spec)
                chain.gap_specs.append(specs)
                gfn = build_stage_fn(specs)
                gap_fns.append(gfn)
                if gfn is not None:
                    cur = [gfn(a) for a in cur]
                _annotate(m, cur)
            try:
                out = fn(params, *cur)
            except Exception as e:  # noqa: BLE001 — the link mismatch verdict
                got = ", ".join(f"{tuple(a.shape)}/"
                                f"{str(a.dtype).replace('torch.', '')}"
                                for a in cur)
                return (m, "NNST453",
                        f"chain link {prev.name!r} -> {m.name!r}: the "
                        f"produced tensors ({got}) do not compose into "
                        f"{m.name!r}'s model "
                        f"({str(e).splitlines()[0][:120]})",
                        f"insert a tensor_transform (typecast/reshape) at "
                        f"the link, or set input=/input-type on {m.name!r} "
                        f"so the model reshapes to what the chain produces")
            cur = _as_list(out)
            prev = m

    gap_fns_t = tuple(gap_fns)
    fns = tuple(fn for fn, _ in progs)

    def run(params_tuple, *xs):
        outs = list(xs)
        for i, f in enumerate(fns):
            if i > 0 and gap_fns_t[i - 1] is not None:
                outs = [gap_fns_t[i - 1](o) for o in outs]
            outs = _as_list(f(params_tuple[i], *outs))
        return tuple(outs) if len(outs) > 1 else outs[0]

    run.derived_bytes = sum(int(getattr(f, "derived_bytes", 0))
                            for f in fns)
    params_tuple = tuple(p for _, p in progs)
    return run, params_tuple, head_shapes


def _modeled_savings(chain: FilterChain, pipeline) -> dict:
    """What fusing this chain removes per source buffer: the non-head
    members' program launches (each a Python dispatch and its kernel
    launches today) and any interior link crossings the unfused plan
    bills on the claimed elements (usually zero on a pure device lane —
    launches, not bytes, are the win there)."""
    from nnstreamer_tpu_torch.analysis.residency import predict_crossings

    saved_launches = len(chain.members) - 1
    interior_h2d = interior_d2h = 0
    try:
        pred = predict_crossings(pipeline, n_buffers=1)
        for e in chain.claimed_elements():
            c = pred["per_element"].get(e.name, {})
            interior_h2d += c.get("h2d", 0)
            interior_d2h += c.get("d2h", 0)
        # the FINAL member's boundary d2h is not saved — the fused plan
        # pays the same fetch wherever its single boundary lands (the head
        # or the sink); only genuinely interior crossings disappear
        last = pred["per_element"].get(chain.members[-1].name, {})
        interior_d2h = max(0, interior_d2h - last.get("d2h", 0))
    except Exception:  # noqa: BLE001 — savings are advisory
        pass
    return {"launches_per_buffer": saved_launches,
            "interior_h2d": interior_h2d, "interior_d2h": interior_d2h}


def _analysis_fingerprint(pipeline, chains) -> tuple:
    """Everything the verdicts depend on, cheaply: the discovered chain
    structure, each member's open backend identity and properties, the gap
    transforms, and the device budget. A PAUSED→PLAYING cycle with nothing
    changed hits the memo instead of re-composing; reopened backends,
    edited properties or a budget override miss."""
    from nnstreamer_tpu_torch.analysis.memplan import device_memory_budget

    return (
        tuple(
            (tuple((id(m), id(m.fw), str(sorted(m.properties.items())))
                   for m in c.members),
             tuple(tuple((id(t), t._mode, t._option) for t in g)
                   for g in c.gaps),
             c.blocked[0].name if c.blocked else None)
            for c in chains),
        device_memory_budget(),
    )


def _blocked(c: FilterChain, el, reason: str) -> None:
    c.code, c.element = "NNST451", el.name
    c.message = (f"chain {c.label()} blocked at {el.name!r}: {reason} — the "
                 f"chain runs per-filter")


def analyze_chains(pipeline) -> List[FilterChain]:
    """Discover and fully analyze every chain; each returned FilterChain
    carries its NNST45x ``code``/``message``/``hint``/``element``. Never
    raises (pass contract): a chain whose composition errors unexpectedly
    is blocked (NNST451), not fatal. Memoized on the pipeline (see
    _analysis_fingerprint) — discovery runs every call, the composition
    only when something it depends on changed."""
    from nnstreamer_tpu_torch.analysis.costmodel import program_cost
    from nnstreamer_tpu_torch.analysis.memplan import plan_memory

    chains = discover_chains(pipeline)
    fp = _analysis_fingerprint(pipeline, chains)
    cached = pipeline.__dict__.get("_nnchain_cache")
    if cached is not None and cached[0] == fp:
        return cached[1]
    for c in chains:
        label = c.label()
        if c.blocked is not None:
            _blocked(c, *c.blocked)
            continue
        hit = _first_member_blocker(c)
        if hit is not None:
            _blocked(c, *hit)
            continue
        try:
            res = _compose(c, pipeline)
        except Exception as e:  # noqa: BLE001 — pass bodies never raise
            res = (c.members[0], "NNST451",
                   f"chain {label}: composition failed unexpectedly "
                   f"({str(e).splitlines()[0][:120]}) — the chain runs "
                   f"per-filter", None)
        if len(res) == 4:
            el, c.code, c.message, c.hint = res
            c.element = el.name
            continue
        fn, params_tuple, head_shapes = res
        try:
            cost = program_cost(fn, params_tuple, head_shapes)
        except Exception as e:  # noqa: BLE001 — treat as incomposable
            c.code, c.element = "NNST451", c.members[0].name
            c.message = (f"chain {label}: composed program cannot be "
                         f"evaluated on meta tensors "
                         f"({str(e).splitlines()[0][:120]}) — the chain "
                         f"runs per-filter")
            continue
        cost["batch"] = int(
            c.members[0].properties.get("batch_size", 1) or 1)
        c.composed_cost = cost
        # the composed program through the whole-pipeline memory plan:
        # member rows collapse into ONE composed row on the head (params
        # of every member billed once, the composed run's activation
        # peak) — NNST700-class violations become NNST452 and prune
        # fusion BEFORE anything runs
        override = {c.members[0].name: cost}
        for m in c.members[1:]:
            override[m.name] = None
        try:
            plan = plan_memory(pipeline, cost_override=override)
        except Exception:  # noqa: BLE001 — no budget verdict: stay eligible
            plan = None
        c.plan = plan
        if plan is not None and plan["total_bytes"] > plan["budget_bytes"]:
            c.code, c.element = "NNST452", c.members[0].name
            c.message = (
                f"chain {label}: composed program predicts "
                f"{plan['total_bytes'] / 2**20:.0f} MB of device memory "
                f"against the {plan['budget_bytes'] / 2**20:.0f} MB budget "
                f"({plan['budget_source']}) — fusion pruned before anything "
                f"runs; the chain runs per-filter")
            c.hint = ("keep the chain per-filter (chain-fusion=off makes "
                      "it explicit), shrink batch-size on the head, or "
                      "raise NNSTPU_HBM_BYTES if the budget is wrong")
            continue
        c.savings = _modeled_savings(c, pipeline)
        c.code, c.element = "NNST450", c.members[0].name
        cross = ""
        if c.savings["interior_h2d"] or c.savings["interior_d2h"]:
            cross = (f" + {c.savings['interior_h2d']} h2d/"
                     f"{c.savings['interior_d2h']} d2h interior "
                     f"crossing(s)")
        peak = (f"; composed peak "
                f"{plan['total_bytes'] / 2**20:.0f} MB of "
                f"{plan['budget_bytes'] / 2**20:.0f} MB budget"
                if plan is not None else "")
        c.message = (
            f"chain {label} is fusable into ONE program: saves "
            f"{c.savings['launches_per_buffer']} program launch(es) per "
            f"buffer{cross}{peak}")
    pipeline.__dict__["_nnchain_cache"] = (fp, chains)
    return chains


# --------------------------------------------------------------------------
# the analyzer pass body (registered in analysis/passes.py)
# --------------------------------------------------------------------------

def chain_pass_body(ctx) -> None:
    from nnstreamer_tpu_torch.pipeline.planner import _chain_fusion_enabled

    # the analysis always runs (its composed-signature annotations let the
    # memory plan and the roofline model interior members the dry
    # negotiation cannot resolve), but verdicts are emitted only when chain
    # fusion would actually engage — with chain-fusion=off the runtime
    # never composes, so the lint stays byte-identical too
    chains = analyze_chains(ctx.pipeline)
    if not _chain_fusion_enabled(ctx.pipeline):
        return
    for c in chains:
        if c.code is None:
            continue
        ctx.emit(c.code, c.element or c.members[0].name, c.message,
                 hint=c.hint)
