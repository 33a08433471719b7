"""nnpool — static replica-serving analyzer (NNST96x); counterpart of
the JAX package's ``analysis/pool.py``.

N per-device *replicas* of the served filter's model behind one
``tensor_query_serversrc serve=1``, with the scheduler dispatching
assembled serve-batches least-loaded-first and per-replica worker
threads keeping every device busy (``replicas=N|auto``). This analysis is
the *proof* that licenses the runtime feature — the PLAYING planner
installs replicas ONLY on servers this module verdicts NNST960. The
devices are ``parallel/mesh.visible_devices()``, where a device may
repeat (``NNSTPU_TORCH_DEVICES=cuda:0*4``: four replicas on one card,
each with its own weights and CUDA stream; the memory plan sums them on
that device):

  NNST960  replica-eligible: the requested count resolves against the
           visible devices, the served filter's backend can replicate
           its model (one copy of the weights per replica), and the
           modeled PER-DEVICE footprint (params replicated per replica
           + the serving batch + activations) fits each device's own
           budget.  Carries the resolved N and the modeled per-device
           bytes.
  NNST961  replica-ineligible, naming the blocking reason: serving off
           (``replicas=`` without ``serve=1``), no downstream filter, a
           shard=/chain/loop interaction (one placement strategy per
           filter), a shared backend key, micro-batch/feed-depth/
           fetch-window amortizers the per-replica dispatch path
           bypasses, ``invoke-dynamic``, a stateful/non-replicable
           backend, or insufficient visible devices.  The server falls
           back LOUDLY to single-replica serving — never wrong output,
           never a silent no-op.
  NNST962  replicas-over-per-device-budget: the per-device footprint
           (params are REPLICATED per replica, unlike a dp shard's
           split) busts the binding per-device budget — the minimum
           over the N devices the pool would span, not device 0's
           historical read.  Pruned before anything is built; single-replica
           serving.

``replicas=auto`` resolves the LARGEST per-device-HBM-feasible N via
``plan_memory`` with per-device budgets (the nnshard
``device_memory_budget`` machinery).  Pipelines that never mention
``replicas=`` produce zero NNST96x diagnostics — default analyzer
output is byte-identical.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

#: replicas=auto candidates are the visible-device count walked down
#: through these steps (largest HBM-feasible wins)
AUTO_REPLICA_STEPS = (8, 4, 2)


@dataclass
class PoolVerdict:
    """One serving source's replica verdict (code + resolved config)."""

    element: str  # the tensor_query_serversrc
    code: str  # NNST960 | NNST961 | NNST962
    message: str
    hint: Optional[str] = None
    replicas: int = 1
    filter: Optional[str] = None  # the served filter the replicas clone


# --------------------------------------------------------------------------
# configuration resolution
# --------------------------------------------------------------------------

def requested_replicas(e):
    """The serversrc's asked-for replica count: an int (>1), ``"auto"``,
    or None (off).  ``0``/``1``/``off``/empty all mean off — the
    property is opt-in."""
    prop = e.properties.get("replicas")
    if prop is None:
        return None
    s = str(prop).strip().lower()
    if s in ("", "0", "1", "off", "false"):
        return None
    if s == "auto":
        return "auto"
    try:
        n = int(s)
    except ValueError:
        return None  # NNST1xx owns the malformed-value diagnostics
    return n if n > 1 else None


def _visible_devices() -> int:
    from nnstreamer_tpu_torch.analysis.shard import _visible_devices as n

    return n()


def served_filter(src):
    """The tensor_filter a serving source feeds (the one the replicas
    clone), or None."""
    from nnstreamer_tpu_torch.analysis.passes import _downstream_filter

    return _downstream_filter(src)


def serving_src_for_filter(e):
    """The ``serve=1`` tensor_query_serversrc upstream of filter ``e``
    (through any intermediates), or None — the inverse of
    :func:`served_filter`, used by the memplan billing walk."""
    from nnstreamer_tpu_torch.elements.query import TensorQueryServerSrc

    seen = set()
    stack = [p.peer.element for p in e.sink_pads if p.peer is not None]
    while stack:
        x = stack.pop()
        if id(x) in seen:
            continue
        seen.add(id(x))
        if isinstance(x, TensorQueryServerSrc):
            return x if x.properties.get("serve") else None
        stack.extend(p.peer.element for p in x.sink_pads
                     if p.peer is not None)
    return None


# --------------------------------------------------------------------------
# cheap static gates (the NNST961 reasons) — no cost model, no build
# --------------------------------------------------------------------------

def static_pool_blocker(pipeline, src) -> Optional[str]:
    """The first cheap-gate reason this serving source cannot run
    replicas, or None.  Shared by the analyzer, the memplan billing and
    the planner so they can never disagree about whether the pool
    engages."""
    from nnstreamer_tpu_torch.analysis.loop import requested_window
    from nnstreamer_tpu_torch.analysis.shard import requested_shard
    from nnstreamer_tpu_torch.filters.base import FilterProperties

    if not src.properties.get("serve"):
        return ("replicas= needs serve=1 (the serving scheduler owns "
                "batch assembly and least-loaded dispatch)")
    f = served_filter(src)
    if f is None:
        return "no downstream tensor_filter to replicate"
    if getattr(f, "_fused_into", None) is not None \
            or getattr(f, "_chain_specs", None):
        return (f"chain interaction: a composed chain owns "
                f"{f.name!r}'s program (the spliced composition cannot "
                f"be cloned per device)")
    if requested_window(f) != 1:
        return (f"loop interaction: loop-window's donated scan ring "
                f"owns {f.name!r}'s program — one placement strategy "
                f"per filter")
    cd = FilterProperties(
        custom=str(f.properties.get("custom", "") or "")).custom_dict()
    if requested_shard(f) is not None or cd.get("shard") \
            or getattr(f, "_shard_state", None) is not None:
        return (f"shard interaction: {f.name!r} requests a mesh "
                f"partition — sharded serve-batch placement owns "
                f"multi-device serving there (one strategy per filter)")
    if f.properties.get("shared_tensor_filter_key"):
        return ("shared backend key: the replica programs live on the "
                "framework object every sharer invokes")
    if int(f.properties.get("batch_size", 1) or 1) > 1:
        return (f"batch-size>1 on {f.name!r}: the micro-batch path "
                f"owns frame assembly — the serving scheduler already "
                f"batches (size serve-batch instead)")
    if int(f.properties.get("feed_depth", 1) or 1) > 1:
        return (f"feed-depth>1 on {f.name!r}: the upload window "
                f"prefetches onto ONE device — per-replica dispatch "
                f"places each batch on its own device instead")
    fw_prop = str(f.properties.get("fetch_window", 1)).strip().lower()
    if fw_prop not in ("", "1"):
        return (f"fetch-window on {f.name!r}: replica workers "
                f"materialize each serve-batch as it completes — a "
                f"held window would reorder batches across replicas")
    if f.properties.get("invoke_dynamic"):
        return ("invoke-dynamic output: per-invoke shapes cannot pin "
                "one program per device")
    if str(f.properties.get("framework", "auto")) not in (
            "auto", "jax", "torch_cuda") and f.fw is None:
        return (f"framework={f.properties.get('framework')!r} cannot "
                f"be proved replicable before it opens (torch_cuda "
                f"programs replicate; custom backends must declare "
                f"replica safety at registration)")
    if f.fw is not None:
        sup = getattr(f.fw, "replica_supported", None)
        if sup is None or not sup():
            return (f"backend of {f.name!r} cannot replicate its "
                    f"program (stateful backend, closed artifact, no "
                    f"params pytree, or a composed chain/loop/mesh "
                    f"program already installed)")
    return None


# --------------------------------------------------------------------------
# HBM feasibility + auto resolution (plan_memory is the oracle)
# --------------------------------------------------------------------------

def _pool_fits(pipeline, f, n: int):
    """(fits, per_device_mb) for the memory plan with ``f`` billed at N
    replicas against every device's budget — (None, 0.0) when the plan
    cannot model the filter (no verdict — stay eligible, the runtime
    trace is the backstop).  The modeled MB rides into the NNST960
    message so the verdict never re-walks the plan it already ran."""
    from nnstreamer_tpu_torch.analysis.memplan import plan_memory

    try:
        plan = plan_memory(pipeline, replica_override={f.name: n})
    except Exception:  # noqa: BLE001 — unmodelable: no budget verdict
        return None, 0.0
    if f.name in plan.get("unmodeled", ()):
        return None, 0.0
    row = next((r for r in plan["rows"] if r["element"] == f.name), None)
    mb = ((plan["param_bytes_total"] + row["total_bytes"]) / 2**20
          if row is not None else 0.0)
    return plan["total_bytes"] <= plan["budget_bytes"], mb


def _pool_fingerprint(pipeline) -> tuple:
    from nnstreamer_tpu_torch.analysis.memplan import device_memory_budget
    from nnstreamer_tpu_torch.elements.filter import TensorFilter
    from nnstreamer_tpu_torch.elements.query import TensorQueryServerSrc

    return (
        tuple(
            (id(e), str(sorted((k, str(v))
                               for k, v in e.properties.items())))
            for e in pipeline.elements.values()
            if isinstance(e, TensorQueryServerSrc)),
        tuple(
            (id(e), str(sorted((k, str(v))
                               for k, v in e.properties.items())),
             id(e.fw), getattr(e, "_fused_into", None),
             repr(getattr(e, "_shard_state", None)),
             repr(getattr(e, "_replica_state", None)))
            for e in pipeline.elements.values()
            if isinstance(e, TensorFilter)),
        _visible_devices(),
        device_memory_budget(),
    )


def resolve_pool(pipeline
                 ) -> Dict[str, Tuple[int, Optional[str], str, float]]:
    """{serversrc name: (replicas, note, filter name, per_device_mb)}
    for every serving source that requests replicas.  ``note``
    classifies an OFF resolution: ``"blocked:<reason>"`` (cheap gate),
    ``"overbudget"`` (NNST962) or ``"unmodeled"`` (auto could not size
    a pool the plan cannot model).  Memoized on the pipeline."""
    from nnstreamer_tpu_torch.elements.query import TensorQueryServerSrc

    fp = _pool_fingerprint(pipeline)
    cached = pipeline.__dict__.get("_nnpool_cache")
    if cached is not None and cached[0] == fp:
        return cached[1]
    if pipeline.__dict__.get("_nnpool_resolving"):
        # re-entrancy guard: a feasibility probe's plan_memory call can
        # wander through the loop resolver back into this resolver
        # before the memo is set — the nested view bills single-replica
        # (the loop/pool interaction gates make that exact anyway)
        return {}
    pipeline.__dict__["_nnpool_resolving"] = True
    try:
        out: Dict[str, Tuple[int, Optional[str], str, float]] = {}
        for e in pipeline.elements.values():
            if not isinstance(e, TensorQueryServerSrc):
                continue
            req = requested_replicas(e)
            if req is None:
                continue
            out[e.name] = _resolve_one(pipeline, e, req)
    finally:
        pipeline.__dict__.pop("_nnpool_resolving", None)
    pipeline.__dict__["_nnpool_cache"] = (fp, out)
    return out


def _resolve_one(pipeline, src, req):
    reason = static_pool_blocker(pipeline, src)
    f = served_filter(src)
    fname = f.name if f is not None else ""
    if reason is not None:
        return 1, f"blocked:{reason}", fname, 0.0
    n_dev = _visible_devices()
    if n_dev < 2:
        return 1, (f"blocked:only {n_dev} device(s) visible — a replica "
                   f"pool needs >= 2"), fname, 0.0
    if req == "auto":
        cands = sorted({n for n in (n_dev,) + AUTO_REPLICA_STEPS
                        if 2 <= n <= n_dev}, reverse=True)
        saw_over = False
        for n in cands:
            fit, mb = _pool_fits(pipeline, f, n)
            if fit:
                return n, None, fname, mb
            if fit is False:
                saw_over = True
        return 1, ("overbudget" if saw_over else "unmodeled"), fname, 0.0
    n = int(req)
    if n > n_dev:
        return 1, (f"blocked:replicas={n} but only {n_dev} device(s) "
                   f"visible"), fname, 0.0
    fit, mb = _pool_fits(pipeline, f, n)
    if fit is False:
        return 1, "overbudget", fname, 0.0
    # an unmodelable plan leaves an EXPLICIT count eligible (the
    # runtime trace is the backstop)
    return n, None, fname, mb


def runtime_filter_replicas(pipeline, f) -> int:
    """The replica count the RUNTIME will actually engage for filter
    ``f``: the installed ground truth once the planner decided, the
    static resolution before that, 1 when the pool falls back.  The
    single resolution the memplan billing shares — billing must mirror
    the fallback, never the ask."""
    state = getattr(f, "_replica_state", None)
    if state is not None:
        return int(state.get("replicas", 1))
    if getattr(pipeline, "_pool_planned", False):
        return 1  # planner ran and decided against (or fell back)
    src = serving_src_for_filter(f)
    if src is None or requested_replicas(src) is None:
        return 1
    return resolve_pool(pipeline).get(src.name, (1,))[0]


# --------------------------------------------------------------------------
# verdicts (what the planner consumes)
# --------------------------------------------------------------------------

def analyze_pool(pipeline) -> List[PoolVerdict]:
    """NNST96x verdicts for every serving source that requests replicas
    (empty for pipelines that never mention ``replicas=`` — the default
    lint stays byte-identical)."""
    out: List[PoolVerdict] = []
    for name, (n, note, fname, mb) in sorted(
            resolve_pool(pipeline).items()):
        src = pipeline.elements.get(name)
        if src is None:
            continue
        req = requested_replicas(src)
        ask = f"replicas={req}"
        if note is not None and note.startswith("blocked:"):
            out.append(PoolVerdict(
                element=name, code="NNST961", replicas=1, filter=fname,
                message=(f"{ask} on {name!r} is ineligible: "
                         f"{note[len('blocked:'):]} — single-replica "
                         f"serving"),
                hint="fix the named blocker (or drop replicas=) so the "
                     "replica pool can engage"))
            continue
        if note == "unmodeled":
            out.append(PoolVerdict(
                element=name, code="NNST961", replicas=1, filter=fname,
                message=(f"{ask} on {name!r}: the served program cannot "
                         f"be statically modeled, so auto cannot prove "
                         f"a per-device footprint — single-replica "
                         f"serving"),
                hint="set an explicit replicas=N (the runtime trace is "
                     "the backstop) or use a modelable program"))
            continue
        if note == "overbudget":
            out.append(PoolVerdict(
                element=name, code="NNST962", replicas=1, filter=fname,
                message=(f"{ask} on {name!r}: each replica REPLICATES "
                         f"{fname!r}'s params + serving batch per "
                         f"device, and that per-device footprint busts "
                         f"the binding per-device budget (min over the "
                         f"pool's devices) — pruned before any "
                         f"build, single-replica serving"),
                hint=f"lower replicas= on {name!r} (or use shard=dp, "
                     f"which SPLITS the batch instead of replicating "
                     f"the program), or raise NNSTPU_HBM_BYTES if the "
                     f"budget is wrong"))
            continue
        per_dev = (f"; ~{mb:.1f} MB/device modeled" if mb >= 0.05
                   else "")
        out.append(PoolVerdict(
            element=name, code="NNST960", replicas=n, filter=fname,
            message=(f"{ask} on {name!r}: {n} per-device replicas of "
                     f"{fname!r} (each with its own weights and stream; "
                     f"least-loaded dispatch via the serversink ack "
                     f"channel"
                     f"{per_dev}) — the planner installs the pool at "
                     f"PLAYING")))
    return out


def pool_pass_body(ctx) -> None:
    for v in analyze_pool(ctx.pipeline):
        ctx.emit(v.code, v.element, v.message, hint=v.hint)
