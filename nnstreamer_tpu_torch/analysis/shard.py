"""nnshard — static mesh-partition analyzer (NNST47x); counterpart of
the JAX package's ``analysis/shard.py``.

A static analyzer is the *proof* that licenses the runtime feature: the
PLAYING planner installs a mesh (``tensor_filter shard=dp|tp|dpxtp
mesh=AxB``, filters/cuda_filter.py) ONLY on filters this module verdicts
NNST470. The device count is ``parallel/mesh.visible_devices()`` (a device
may repeat: ``NNSTPU_TORCH_DEVICES=cuda:0*4`` is four mesh positions on
one card); the program signature comes from the cost model's data-free
run of the composition on ``meta`` tensors (the reference's
``jax.eval_shape``).

  NNST470  shard-eligible: the requested mesh resolves over the visible
           devices, every input's leading (batch) dim divides the dp
           axis, and (for tp) the params pytree has at least one
           channel dim the tp axis divides.  Carries the resolved
           layout and the modeled per-shard bytes (inputs/params/
           outputs per mesh position).
  NNST471  shard-ineligible, naming the blocking dim/reason:
           indivisible batch (the dim and axis are named), no shardable
           channel dim, ``invoke-dynamic``, ``sync=1``, a shared
           backend key, chain/loop interaction (the composed chain or
           the donated scan ring owns the filter's program), a legacy
           ``custom=shard:`` mesh, insufficient visible devices, or a
           non-composable backend.  The filter falls back LOUDLY to
           unsharded execution — never wrong output, never a silent
           no-op.
  NNST472  resharding hazard: two filters joined by a ``memory:HBM``
           edge (through residency-transparent elements) carry
           INCOMPATIBLE engaged shard specs — the downstream filter
           re-splits (or gathers) every buffer at the link.  The fix
           hint names the matching spec.

Per-shard budgets ride in :mod:`analysis.memplan` (params billed
replicated-or-sharded per spec, a mesh-aware NNST700/703 against the
PER-DEVICE budget, every position that lands on one device summed there).
Pipelines that never mention ``shard=`` produce zero NNST47x
diagnostics — single-device analyzer output is byte-identical.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class ShardVerdict:
    """One filter's mesh-partition verdict (code + resolved config)."""

    element: str
    code: str  # NNST470 | NNST471 | NNST472
    message: str
    hint: Optional[str] = None
    #: resolved config on NNST470: {"mode", "dp", "tp"}
    config: Optional[Dict] = None
    #: modeled per-shard byte table on NNST470
    per_shard: Dict = field(default_factory=dict)


# --------------------------------------------------------------------------
# configuration resolution
# --------------------------------------------------------------------------

def requested_shard(e) -> Optional[str]:
    """The filter's asked-for shard mode (``dp``/``tp``/``dpxtp``), or
    None when unset/off.  Unknown spellings are None here — the property
    schema's enum check (NNST102) owns the typo diagnostics."""
    s = str(e.properties.get("shard", "") or "").strip().lower()
    return s if s in ("dp", "tp", "dpxtp") else None


def _visible_devices() -> int:
    from nnstreamer_tpu_torch.parallel.mesh import visible_device_count

    try:
        return visible_device_count()
    except ValueError:  # a malformed NNSTPU_TORCH_DEVICES: single device
        return 1


# --------------------------------------------------------------------------
# cheap static gates (NNST471 reasons) — no cost model, no compile
# --------------------------------------------------------------------------

def static_shard_blocker(e) -> Optional[str]:
    """The first cheap-gate reason this filter cannot run sharded, or
    None.  Shared by the analyzer, the memplan billing, the crossing
    predictor, the planner and the tuner's knob gating so they can
    never disagree about whether the mesh engages."""
    from nnstreamer_tpu_torch.analysis.loop import requested_window
    from nnstreamer_tpu_torch.pipeline.planner import donation_requested

    if getattr(e, "_fused_into", None) is not None \
            or getattr(e, "_chain_specs", None):
        return ("chain interaction: a composed chain owns this filter's "
                "program (the spliced composition cannot span a mesh)")
    if requested_window(e) != 1:
        return ("loop interaction: loop-window's donated scan ring owns "
                "this filter's program (the ring cannot be sharded — "
                "drop loop-window to shard)")
    if e.properties.get("shared_tensor_filter_key"):
        return ("shared backend key: the mesh placement lives on the "
                "framework object every sharer invokes")
    if e.properties.get("sync"):
        return ("sync=1 materializes every output on the streaming "
                "thread — a per-invoke all-device gather")
    if e.properties.get("invoke_dynamic"):
        return ("invoke-dynamic output (per-invoke shapes cannot pin "
                "one partitioned program)")
    if e.properties.get("input_combination") \
            or e.properties.get("output_combination"):
        return ("input/output-combination re-routes tensors per frame "
                "in ways the per-shard byte accounting cannot mirror")
    from nnstreamer_tpu_torch.filters.base import FilterProperties

    cd = FilterProperties(
        custom=str(e.properties.get("custom", "") or "")).custom_dict()
    if cd.get("shard"):
        return ("legacy custom=shard: already configures a mesh at "
                "open — use ONE spelling (the shard= property)")
    if donation_requested(e.properties.get("custom", "")):
        return ("custom=donate:1: the donating program and the sharded "
                "placement cannot both own the input buffers")
    model = str(e.properties.get("model", "") or "")
    if model.endswith(".jaxexport"):
        return ("closed .jaxexport artifact: its StableHLO cannot be "
                "re-partitioned in-process")
    if str(e.properties.get("framework", "auto")) not in (
            "auto", "jax", "torch_cuda") and e.fw is None:
        return (f"framework={e.properties.get('framework')!r} has no "
                f"partitionable program")
    if e.fw is not None:
        sup = getattr(e.fw, "shard_supported", None)
        if sup is None or not sup():
            return ("backend cannot re-partition its program (closed "
                    "artifact, no params pytree, or a composed "
                    "chain/loop program already installed)")
    return None


# --------------------------------------------------------------------------
# divisibility + per-shard byte model (the NNST470 proof)
# --------------------------------------------------------------------------

def _program_signature(e):
    """(input ShapeDtypes with batch folded, params, output meta tensors)
    of the filter's per-invoke program, or None when unmodelable. Reuses
    the cost model's program construction and runs it on ``meta``
    tensors, so the signature the proof checks is exactly the one the
    runtime runs."""
    import torch

    from nnstreamer_tpu_torch.analysis.costmodel import (
        filter_program,
        meta_tensors,
    )

    prog = filter_program(e)
    if prog is None:
        return None
    fn, params, shapes = prog
    try:
        with torch.no_grad():
            out = fn(params, *meta_tensors(shapes))
    except Exception:  # noqa: BLE001 — unmodelable program
        return None
    leaves = out if isinstance(out, (list, tuple)) else [out]
    return shapes, params, list(leaves)


def _leaf_shards(params, tp: int) -> Tuple[int, int, List[str]]:
    """(sharded_bytes, replicated_bytes, sharded_leaf_dims) under the
    ``shard_params_for_tp`` placement rule — consulted via the SAME
    ``tp_leaf_sharded`` predicate (on the same output-channel dims) the
    runtime placement uses, so the bill and the placement can never
    disagree."""
    from nnstreamer_tpu_torch.parallel.mesh import (
        channel_dims,
        param_leaves,
        tp_leaf_sharded,
    )

    sharded = replicated = 0
    dims: List[str] = []
    ch = channel_dims(params)
    for key, leaf in param_leaves(params).items():
        if not hasattr(leaf, "shape"):
            continue
        nb = int(leaf.numel() * leaf.element_size())
        dim = ch.get(key, -1)
        if tp_leaf_sharded(leaf, tp, dim):
            shape = tuple(leaf.shape)
            sharded += nb
            dims.append(f"{shape}[{dim}]={shape[dim]}/{tp}")
        else:
            replicated += nb
    return sharded, replicated, dims


def _nbytes(avals) -> int:
    import numpy as np

    return int(sum(
        int(np.prod(tuple(a.shape), dtype=np.int64))
        * (a.element_size() if hasattr(a, "element_size")
           else np.dtype(a.dtype).itemsize)
        for a in avals))


def resolve_shard(pipeline, e):
    """The full static resolution for one filter: ``(config, billing,
    None)`` when the mesh engages, ``(None, None, reason)`` when it
    falls back (reason is the NNST471 text), or ``(None, None, None)``
    when no shard is requested.

    ``config``  = {"mode", "dp", "tp"}
    ``billing`` = the per-shard byte table memplan and the verdict share:
        devices, input_bytes_per_device, output_bytes_per_device,
        param_bytes_per_device, param_bytes_replicated/sharded, layout.

    Memoized per element on everything the answer depends on (props,
    visible devices, runtime shard/chain state)."""
    from nnstreamer_tpu_torch.parallel.mesh import resolve_shard_axes

    mode = requested_shard(e)
    if mode is None:
        return None, None, None
    n_dev = _visible_devices()
    key = (
        str(sorted((k, str(v)) for k, v in e.properties.items())),
        n_dev, id(e.fw), getattr(e, "_fused_into", None),
        bool(getattr(e, "_chain_specs", None)),
    )
    cached = e.__dict__.get("_nnshard_cache")
    if cached is not None and cached[0] == key:
        return cached[1]
    result = _resolve_uncached(e, mode, n_dev, resolve_shard_axes)
    e.__dict__["_nnshard_cache"] = (key, result)
    return result


def _resolve_uncached(e, mode, n_dev, resolve_shard_axes):
    reason = static_shard_blocker(e)
    if reason is not None:
        return None, None, reason
    try:
        dp, tp = resolve_shard_axes(
            mode, str(e.properties.get("mesh", "") or ""), n_dev)
    except ValueError as err:
        return None, None, str(err)
    sig = _program_signature(e)
    if sig is None:
        return None, None, ("the program cannot be statically modeled "
                            "at this signature, so the partition layout "
                            "cannot be proved sound")
    shapes, params, outs = sig
    if dp > 1:
        for i, s in enumerate(shapes):
            lead = int(s.shape[0]) if s.shape else 0
            if lead % dp:
                return None, None, (
                    f"indivisible batch: input {i} leading dim {lead} "
                    f"does not divide the dp axis ({dp} devices) — size "
                    f"batch-size/frames-per-tensor to a multiple of {dp}")
    sharded_b = repl_b = 0
    layout_dims: List[str] = []
    if tp > 1:
        sharded_b, repl_b, layout_dims = _leaf_shards(params, tp)
        if sharded_b == 0:
            return None, None, (
                f"no shardable channel dim: no param leaf has a last "
                f"dim the tp axis ({tp}) divides — shard=dp splits the "
                f"batch instead")
    else:
        from nnstreamer_tpu_torch.analysis.costmodel import param_bytes_of

        repl_b = param_bytes_of(params)
    in_b, out_b = _nbytes(shapes), _nbytes(outs)
    billing = {
        "devices": dp * tp,
        "dp": dp,
        "tp": tp,
        # inputs/outputs shard their leading dim over dp (replicated on
        # the tp axis); params shard channel dims over tp and replicate
        # over dp — exactly the layout the runtime places
        "input_bytes_per_device": in_b // dp,
        "output_bytes_per_device": out_b // dp,
        "param_bytes_sharded": sharded_b,
        "param_bytes_replicated": repl_b,
        "param_bytes_per_device": sharded_b // max(1, tp) + repl_b,
        "layout": {
            "inputs": "P('dp')",
            "params": (f"P(None, 'tp') on {len(layout_dims)} leaf/leaves"
                       if tp > 1 else "replicated"),
        },
    }
    return {"mode": mode, "dp": dp, "tp": tp}, billing, None


def runtime_shard_config(pipeline, e) -> Optional[Dict]:
    """The shard config the RUNTIME will actually engage for this
    filter: the installed ground truth (``_shard_state``) once the
    planner decided, the static resolution before that, None when the
    mesh falls back.  The single resolution the memplan billing, the
    crossing predictor and the tuner objective all share — billing must
    mirror the fallback, never the ask."""
    state = getattr(e, "_shard_state", None)
    if state is not None:
        return dict(state)
    if getattr(pipeline, "_shard_planned", False):
        return None  # planner ran and decided against (or fell back)
    cfg, _, _ = resolve_shard(pipeline, e)
    return cfg


def shard_billing(pipeline, e) -> Optional[Dict]:
    """The per-shard byte table for an ENGAGED shard (None otherwise) —
    what plan_memory bills per device."""
    cfg = runtime_shard_config(pipeline, e)
    if cfg is None:
        return None
    rcfg, billing, _ = resolve_shard(pipeline, e)
    if billing is None or rcfg is None:
        return None
    return billing


# --------------------------------------------------------------------------
# verdicts (what the planner consumes)
# --------------------------------------------------------------------------

def analyze_shard(pipeline, e) -> Optional[ShardVerdict]:
    """The NNST470/471 verdict for one filter, or None when no shard is
    requested (the common case pays one dict read)."""
    mode = requested_shard(e)
    if mode is None:
        return None
    mesh_s = str(e.properties.get("mesh", "") or "").strip() or "(all)"
    cfg, billing, reason = resolve_shard(pipeline, e)
    if cfg is None:
        return ShardVerdict(
            element=e.name, code="NNST471",
            message=(f"shard={mode} mesh={mesh_s} on {e.name!r} is "
                     f"ineligible: {reason} — unsharded execution"),
            hint="fix the named blocker (or drop shard=) so the mesh "
                 "placement can engage")
    mb = billing["param_bytes_per_device"] / 2**20
    return ShardVerdict(
        element=e.name, code="NNST470",
        message=(f"shard={mode} on {e.name!r}: {billing['dp']}x"
                 f"{billing['tp']} mesh — inputs P('dp') "
                 f"({billing['input_bytes_per_device']} B/shard), params "
                 f"{billing['layout']['params']} ({mb:.1f} MB/device), "
                 f"outputs {billing['output_bytes_per_device']} B/shard; "
                 f"the planner installs the mesh placement at PLAYING"),
        config=cfg, per_shard=billing)


def analyze_shards(pipeline) -> List[ShardVerdict]:
    """Per-filter NNST470/471 verdicts plus the NNST472 reshard-hazard
    walk.  Empty for pipelines that never mention ``shard=`` — the
    default lint stays byte-identical."""
    from nnstreamer_tpu_torch.elements.filter import TensorFilter

    out: List[ShardVerdict] = []
    any_shard = False
    for e in pipeline.elements.values():
        if not isinstance(e, TensorFilter):
            continue
        v = analyze_shard(pipeline, e)
        if v is not None:
            any_shard = True
            out.append(v)
    if any_shard:
        out.extend(_reshard_hazards(pipeline))
    return out


def _downstream_filters(e):
    """Device-capable filters reachable from ``e``'s src pads through
    residency-transparent elements (the elements a device edge looks
    through) — each is a link sharded device tensors would ride."""
    from nnstreamer_tpu_torch.elements.filter import TensorFilter
    from nnstreamer_tpu_torch.pipeline.planner import is_transparent

    hits, seen = [], set()
    stack = [sp.peer.element for sp in e.src_pads if sp.peer is not None]
    while stack:
        x = stack.pop()
        if id(x) in seen:
            continue
        seen.add(id(x))
        if isinstance(x, TensorFilter) and x._fw_device_capable() \
                and getattr(x, "_fused_into", None) is None:
            hits.append(x)
            continue
        if is_transparent(x):
            stack.extend(sp.peer.element for sp in x.src_pads
                         if sp.peer is not None)
    return hits


def _reshard_hazards(pipeline) -> List[ShardVerdict]:
    """NNST472 per filter→filter device edge whose two ends carry
    incompatible engaged shard configs (one sharded + one not counts:
    the unsharded consumer forces a gather onto one device)."""
    from nnstreamer_tpu_torch.elements.filter import TensorFilter

    out: List[ShardVerdict] = []
    for up in pipeline.elements.values():
        if not isinstance(up, TensorFilter) or not up._fw_device_capable():
            continue
        if getattr(up, "_fused_into", None) is not None:
            continue
        up_cfg = runtime_shard_config(pipeline, up)
        if up_cfg is None:
            continue
        # the hazard needs a device edge: an upstream that materializes
        # (sync/invoke-dynamic) hands HOST arrays downstream — no
        # resharding, the gather already happened at the boundary
        if not up.produces_device(up.src_pads[0] if up.src_pads else None):
            continue
        spec_s = (f"shard={up_cfg['mode']} "
                  f"mesh={up_cfg['dp']}x{up_cfg['tp']}")
        for down in _downstream_filters(up):
            down_cfg = runtime_shard_config(pipeline, down)
            if down_cfg == up_cfg:
                continue
            have = ("unsharded" if down_cfg is None else
                    f"shard={down_cfg['mode']} mesh={down_cfg['dp']}x"
                    f"{down_cfg['tp']}")
            out.append(ShardVerdict(
                element=down.name, code="NNST472",
                message=(f"resharding hazard on the {up.name!r} → "
                         f"{down.name!r} device edge: {up.name!r} emits "
                         f"{spec_s} device tensors but {down.name!r} is "
                         f"{have} — every buffer takes an implicit "
                         f"gather/reshard at the link"),
                hint=f"give {down.name!r} the matching {spec_s} (or "
                     f"unshard both sides of the edge)"))
    return out


def shard_pass_body(ctx) -> None:
    for v in analyze_shards(ctx.pipeline):
        ctx.emit(v.code, v.element, v.message, hint=v.hint)
