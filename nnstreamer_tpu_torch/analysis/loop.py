"""Static steady-loop eligibility analyzer, NNST46x (counterpart of the
JAX package's ``analysis/loop.py``).

``tensor_filter loop-window=N`` amortizes the per-frame host cost once
per WINDOW: at PLAYING the planner installs the filter's full per-invoke
composition as a windowed program (ops/steady_loop.py: on the card one
replay of a CUDA graph that runs the composition N times) — one staged
upload of the N-frame input ring, ONE dispatch for the whole window, one
drain of N outputs. This analysis is the proof that licenses it: the
planner never installs a windowed program this module did not verdict
NNST460:

  NNST460  loop-eligible: shape-stable (NNST800-clean), the staged ring
           is built from host frames this filter alone owns (no upstream
           fan-out holds them), and the ring + in-flight windows fit the
           device budget (billed through ``plan_memory``). Carries the
           resolved window/depth.
  NNST461  loop-ineligible, naming the blocking reason: ``sync=1``,
           ``invoke-dynamic``, i/o-combination re-routing, micro-batch
           (``batch-size>1``), a chain-fused shell, a shared backend key,
           a serving head (the scheduler owns batching), an invoke
           watchdog, variable-shape upstream caps, an upstream fan-out
           holding the inputs, a device-resident upstream lane, or a
           non-composable backend.
           The filter falls back LOUDLY to per-buffer launches — never
           wrong output, never a silent no-op.
  NNST462  the window ring + launch-depth in-flight windows bust the
           device budget (``plan_memory`` loop billing): the loop is
           pruned BEFORE any capture and the filter runs per-buffer.

``loop-window=auto`` resolves to the largest candidate whose ring the
memory plan proves feasible.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

#: env spellings: NNSTPU_LOOP_WINDOW supplies a default window for
#: filters that don't set the property; NNSTPU_LAUNCH_DEPTH likewise
LOOP_WINDOW_ENV = "NNSTPU_LOOP_WINDOW"
LAUNCH_DEPTH_ENV = "NNSTPU_LAUNCH_DEPTH"

#: loop-window=auto candidates, largest-first: auto picks the largest
#: feasible one (a saturated stream only loses from a SMALL window, the
#: fetch-window=auto lesson)
AUTO_LOOP_CANDIDATES = (16, 8, 4)


@dataclass
class LoopVerdict:
    """One filter's steady-loop verdict (code + resolved config)."""

    element: str
    code: str  # NNST460 | NNST461 | NNST462
    message: str
    hint: Optional[str] = None
    window: int = 1
    depth: int = 1


# --------------------------------------------------------------------------
# configuration resolution
# --------------------------------------------------------------------------

def requested_window(e):
    """The filter's asked-for loop window: an int, ``"auto"``, or 1
    (off).  The property wins; ``NNSTPU_LOOP_WINDOW`` supplies a
    default when the property is unset."""
    prop = e.properties.get("loop_window")
    if prop is None or str(prop).strip() == "":
        prop = os.environ.get(LOOP_WINDOW_ENV, "").strip() or None
    if prop is None:
        return 1
    s = str(prop).strip().lower()
    if s == "auto":
        return "auto"
    try:
        return max(1, int(s))
    except ValueError:
        return 1


def requested_depth(e) -> int:
    """launch-depth: how many un-synced window launches the streaming
    thread may bank (1 = dispatch then drain inline, today's sync
    discipline at window granularity)."""
    prop = e.properties.get("launch_depth")
    if prop is None or str(prop).strip() == "":
        prop = os.environ.get(LAUNCH_DEPTH_ENV, "").strip() or None
    if prop is None:
        return 1
    try:
        return max(1, int(str(prop)))
    except ValueError:
        return 1


# --------------------------------------------------------------------------
# cheap static gates (the NNST461 reasons) — no cost model, no compile
# --------------------------------------------------------------------------

def static_blocker(e) -> Optional[str]:
    """The first cheap-gate reason this filter cannot run the windowed
    loop, or None. Shared by the analyzer, the memplan billing and the
    crossing predictor so they can never disagree about whether the loop
    engages."""
    from nnstreamer_tpu_torch.analysis.costmodel import (
        _variable_shape_upstream,
    )
    from nnstreamer_tpu_torch.pipeline.planner import upstream_fanout_holder

    if getattr(e, "_fused_into", None) is not None:
        return ("chain-fused shell: its model already runs inside the "
                "head's program (set loop-window on the chain head)")
    if e.properties.get("shared_tensor_filter_key"):
        return ("shared backend key: the windowed program lives on the "
                "framework object every sharer invokes")
    if e.properties.get("sync"):
        return "sync=1 demands per-invoke materialization on the " \
               "streaming thread"
    if e.properties.get("invoke_dynamic"):
        return "invoke-dynamic output (per-invoke shapes cannot stack " \
               "into one compiled window)"
    if e.properties.get("input_combination") \
            or e.properties.get("output_combination"):
        return ("input/output-combination re-routes tensors per frame "
                "in ways the stacked window cannot mirror")
    if int(e.properties.get("batch_size", 1) or 1) > 1:
        return ("batch-size>1: the micro-batch path owns frame "
                "assembly (size the window instead — one knob per "
                "amortization axis)")
    if float(e.properties.get("invoke_timeout_ms", 0) or 0) > 0:
        return ("invoke-timeout-ms watchdog guards per-invoke backend "
                "calls; the windowed dispatch would bypass it")
    if _serving_head_upstream(e):
        return ("a serve=1 query server feeds this filter: the serving "
                "scheduler owns batching (serve-batch), a second "
                "window would double-hold requests")
    if _variable_shape_upstream(e):
        return ("variable-shape upstream caps (NNST800): every "
                "distinct shape would retrace the windowed program")
    holder = upstream_fanout_holder(e)
    if holder is not None:
        return (f"{holder.name!r} fans the stream out upstream: a "
                f"sibling branch can still hold the frames the window "
                f"ring stages")
    if _device_fed(e):
        return ("device-resident upstream lane: the window ring "
                "re-stages frames that already live on device (keep "
                "the per-buffer lane, or loop the producing filter)")
    if str(e.properties.get("framework", "auto")) not in (
            "auto", "jax", "torch_cuda") and e.fw is None:
        return (f"framework="
                f"{e.properties.get('framework')!r} has no composable "
                f"program to wrap in a window")
    if e.fw is not None:
        sup = getattr(e.fw, "loop_supported", None)
        if sup is None or not sup():
            return "backend cannot compose a windowed program"
    return None


def _serving_head_upstream(e) -> bool:
    """True when a ``serve=1`` tensor_query_serversrc feeds this filter
    (through any intermediates) — serving batching and loop windowing
    are the same amortization, and the scheduler owns it there."""
    from nnstreamer_tpu_torch.elements.query import TensorQueryServerSrc

    seen = set()
    stack = [p.peer.element for p in e.sink_pads if p.peer is not None]
    while stack:
        x = stack.pop()
        if id(x) in seen:
            continue
        seen.add(id(x))
        if isinstance(x, TensorQueryServerSrc):
            return bool(x.properties.get("serve"))
        stack.extend(p.peer.element for p in x.sink_pads
                     if p.peer is not None)
    return False


def _device_fed(e) -> bool:
    """True when the first non-transparent upstream element produces
    device-resident tensors toward this filter (a memory:HBM lane feeds
    it) — static, planner-independent."""
    from nnstreamer_tpu_torch.pipeline.planner import is_transparent

    seen = set()

    def walk(el) -> bool:
        if el is None or id(el) in seen:
            return False
        seen.add(id(el))
        if not is_transparent(el):
            return any(el.produces_device(sp) for sp in el.src_pads)
        return any(p.peer is not None and walk(p.peer.element)
                   for p in el.sink_pads)

    return any(p.peer is not None and walk(p.peer.element)
               for p in e.sink_pads)


# --------------------------------------------------------------------------
# HBM feasibility + auto resolution (plan_memory is the oracle)
# --------------------------------------------------------------------------

def _ring_fits(pipeline, e, window: int, depth: int,
               resolved=None) -> Optional[bool]:
    """Does the memory plan with THIS (window, depth) billed on ``e`` —
    and every ALREADY-resolved filter's engaged ring billed alongside —
    fit the budget?  None when the plan cannot model the filter (no
    verdict — stay eligible, the runtime trace is the backstop)."""
    from nnstreamer_tpu_torch.analysis.memplan import plan_memory

    override = dict(resolved or {})
    override[e.name] = (window, depth)
    try:
        plan = plan_memory(pipeline, loop_override=override)
    except Exception:  # noqa: BLE001 — unmodelable: no budget verdict
        return None
    if e.name in plan.get("unmodeled", ()):
        return None
    return plan["total_bytes"] <= plan["budget_bytes"]


def _loop_fingerprint(pipeline) -> tuple:
    """Everything the joint resolution depends on, cheaply: each
    filter's identity/open backend/properties/shell state, the env
    defaults, and the HBM budget.  A replan (or lint re-run) with
    nothing changed hits the memo instead of re-planning memory per
    candidate — the analyze_chains unchanged-plan economy."""
    from nnstreamer_tpu_torch.analysis.memplan import device_memory_budget
    from nnstreamer_tpu_torch.elements.filter import TensorFilter

    return (
        tuple(
            (id(e), str(sorted((k, str(v))
                               for k, v in e.properties.items())),
             id(e.fw), e._fused_into,
             # an installed loop flips produces_device (host drain), so
             # the _device_fed gate of DOWNSTREAM filters depends on
             # it: epoch transitions must miss the memo
             repr(getattr(e, "_loop_state", None)))
            for e in pipeline.elements.values()
            if isinstance(e, TensorFilter)),
        os.environ.get(LOOP_WINDOW_ENV, ""),
        os.environ.get(LAUNCH_DEPTH_ENV, ""),
        device_memory_budget(),
    )


def resolve_loops(pipeline) -> dict:
    """The engaged (window, depth) per device-capable filter, resolved
    JOINTLY in graph order: each filter's ring feasibility is probed
    with every already-resolved upstream ring billed alongside, so two
    individually-feasible loops that jointly bust the budget resolve
    first-come-first-served (upstream wins, downstream falls back
    NNST462) instead of both installing and OOMing at runtime.
    Memoized on the pipeline (see _loop_fingerprint)."""
    from nnstreamer_tpu_torch.elements.filter import TensorFilter

    fp = _loop_fingerprint(pipeline)
    cached = pipeline.__dict__.get("_nnloop_cache")
    if cached is not None and cached[0] == fp:
        return cached[1]
    resolved: dict = {}
    notes: dict = {}
    for e in pipeline._topo_order():
        if not isinstance(e, TensorFilter) or not e._fw_device_capable():
            continue
        resolved[e.name], notes[e.name] = _resolve_one(pipeline, e,
                                                       resolved)
    pipeline.__dict__["_nnloop_notes"] = notes
    pipeline.__dict__["_nnloop_cache"] = (fp, resolved)
    return resolved


def loop_resolution_note(pipeline, e) -> Optional[str]:
    """Why a requested window resolved OFF: ``"overbudget"`` (the ring
    busts the plan — NNST462) or ``"unmodeled"`` (auto could not size a
    window the plan cannot model — NNST461, never a phantom budget
    claim).  None when the window engaged or was never requested."""
    resolve_loops(pipeline)
    return pipeline.__dict__.get("_nnloop_notes", {}).get(e.name)


def _resolve_one(pipeline, e, resolved):
    """((window, depth), note) — note classifies an OFF resolution for
    the verdict (see loop_resolution_note)."""
    req = requested_window(e)
    if req == 1 or static_blocker(e) is not None:
        return (1, 1), None
    depth = requested_depth(e)
    if req == "auto":
        saw_over = False
        for w in AUTO_LOOP_CANDIDATES:
            fit = _ring_fits(pipeline, e, w, depth, resolved)
            if fit:
                return (w, depth), None
            if fit is False:
                saw_over = True
        # every candidate refused (overbudget) vs the plan simply
        # cannot model this filter (auto never guesses a window it
        # cannot prove — but that is NOT a budget verdict)
        return (1, 1), "overbudget" if saw_over else "unmodeled"
    if _ring_fits(pipeline, e, int(req), depth, resolved) is False:
        return (1, 1), "overbudget"  # NNST462: explicit window refused
    # an unmodelable plan leaves an EXPLICIT window eligible (the
    # runtime trace is the backstop)
    return (int(req), depth), None


def runtime_loop_config(pipeline, e) -> Tuple[int, int]:
    """The (window, depth) the RUNTIME will actually engage for this
    filter: (1, 1) when no window is requested, a cheap gate blocks it,
    or the (jointly-resolved) ring busts the budget — the runtime falls
    back per-buffer there, and billing must mirror the fallback, not
    the ask.  The single resolution the memplan billing and the crossing
    predictor share."""
    return resolve_loops(pipeline).get(e.name, (1, 1))


# --------------------------------------------------------------------------
# the full verdict (what the planner consumes)
# --------------------------------------------------------------------------

def analyze_loop(pipeline, e) -> Optional[LoopVerdict]:
    """The NNST46x verdict for one filter, or None when no loop window
    is requested (the common case pays two dict reads)."""
    req = requested_window(e)
    if req == 1:
        return None
    if e.name not in resolve_loops(pipeline):
        # not a device-capable candidate STATICALLY (e.g.
        # framework=auto before the backend opens): no verdict — a
        # budget claim here would be a phantom (no plan ever ran); the
        # PLAYING planner re-analyzes with the backend open and real
        return None
    reason = static_blocker(e)
    if reason is not None:
        return LoopVerdict(
            element=e.name, code="NNST461",
            message=(f"loop-window={req} on {e.name!r} is ineligible: "
                     f"{reason} — per-buffer launches"),
            hint="drop loop-window here, or remove the blocking "
                 "property so the windowed program can engage")
    depth = requested_depth(e)
    window, _ = resolve_loops(pipeline).get(e.name, (1, 1))
    if window <= 1:
        ask = (f"loop-window=auto (candidates "
               f"{'/'.join(map(str, AUTO_LOOP_CANDIDATES))})"
               if req == "auto" else f"loop-window={req}")
        if loop_resolution_note(pipeline, e) == "unmodeled":
            # auto on a program the plan cannot model: auto never
            # guesses — but this is NOT a budget verdict, and a
            # raise-the-budget hint would send the user chasing a
            # phantom OOM
            return LoopVerdict(
                element=e.name, code="NNST461",
                message=(f"{ask} on {e.name!r}: the program cannot be "
                         f"statically modeled, so auto cannot prove a "
                         f"window size — per-buffer launches"),
                hint="set an explicit loop-window=N (the runtime build "
                     "is the backstop) or use a modelable program")
        return LoopVerdict(
            element=e.name, code="NNST462",
            message=(f"{ask} on {e.name!r}: the window ring + {depth} "
                     f"in-flight window(s) exceed the HBM budget "
                     f"(plan_memory loop billing, other engaged rings "
                     f"included) — loop pruned before any capture, "
                     f"per-buffer launches"),
            hint=f"shrink loop-window/launch-depth on {e.name!r}, or "
                 f"raise NNSTPU_HBM_BYTES if the budget is wrong")
    return LoopVerdict(
        element=e.name, code="NNST460",
        message=(f"steady loop on {e.name!r}: ONE dispatch per "
                 f"{window} frames (dispatch + per-invoke sync "
                 f"amortized {window}x), staged input ring, "
                 f"launch-depth={depth} async window(s) in flight"),
        window=window, depth=depth)


def analyze_loops(pipeline) -> List[LoopVerdict]:
    """Verdicts for every filter that requests a loop window (empty for
    pipelines that never mention loop-window — the default lint stays
    byte-identical)."""
    from nnstreamer_tpu_torch.elements.filter import TensorFilter

    out: List[LoopVerdict] = []
    for e in pipeline.elements.values():
        if not isinstance(e, TensorFilter):
            continue
        v = analyze_loop(pipeline, e)
        if v is not None:
            out.append(v)
    return out


def loop_pass_body(ctx) -> None:
    """The ``loop`` analyzer pass (analysis/passes.py): one NNST46x
    diagnostic per filter that requests a window."""
    for v in analyze_loops(ctx.pipeline):
        ctx.emit(v.code, v.element, v.message, hint=v.hint)
