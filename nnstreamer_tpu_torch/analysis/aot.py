"""nnaot — the compile-cache analyzer (NNST97x; counterpart of the JAX
package's ``analysis/aot.py``).

The compile cache (filters/aot.py) covers the WHOLE resolved execution
spec: solo programs, donated programs, chain-fused heads, steady-loop
windows, mesh partitions and per-device replica entries all key on their
composition and warm-start from disk.
This module is the static view of that cache: BEFORE a pipeline reaches
PLAYING it enumerates every compile-point the planner will resolve,
predicts each one's cache outcome (warm load vs cold in-line compile),
and surfaces entries that can never be loaded again.

Following the house pattern (nncost licensing memory plans, nnpool
licensing replica pools), the verdicts are:

  NNST970  compile-point summary (info): every executable this pipeline
           builds at PLAYING — element, kind (solo/loop/shard/replica/
           chain-head), predicted key, predicted outcome.  Strict-clean:
           a fully warm pipeline lints clean under --strict.
  NNST971  cold start (warning): a compile-point has no cache entry —
           the first PLAYING pays the worker build in line.  Names the
           element, the missing key dimension set, and an estimated
           build cost.
  NNST972  stale/incompatible entry (warning): a cache entry matches a
           compile-point's (model, custom, signature) but its key
           differs — some key dimension moved (torch/CUDA upgrade,
           device change, kernel edit, model content edit, composition
           change) —
           or the entry was quarantined as unreadable.  Either way it
           will never be loaded again; ``doctor --aot-purge`` reclaims
           the bytes.

The pass is EXPLICIT (``validate --aot`` / ``run_passes(passes=[...,
'aot'])``): it stats the on-disk cache, so the default analyzer output
stays byte-identical for pipelines (and CI lint lines) that never asked.
Filters whose cache gate is off (``aot:0``, or no ``aot:1`` and no
``NNSTPU_AOT=1``) produce no NNST97x at all. Each point's platform is its
filter's device (``accelerator=true:cpu`` the CPU, else ``cuda``), as
the runtime keys it.

Key-prediction honesty: solo, loop and shard points predict the EXACT
cache key (the same :func:`~nnstreamer_tpu_torch.filters.aot.cache_key` the
runtime computes).  Replica serve-batches and gap-fused chain stages are
resolved at PLAYING by the scheduler/planner, so those points fall back
to a meta-scan prediction (an entry with the same model + placement
class counts as warm) and say so in the summary.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

#: deterministic build-cost model for the NNST971 message: a worker pays
#: the interpreter, the torch import and the model's build and fold
#: (about 5 s for the add model's entry on a CPU host), plus the kernel
#: library's nvcc build on a card whose checkout lacks it (about 20 s on
#: an H100 host, ops/_cuda.py)
_COMPILE_BASE_S = 5.0
_KERNEL_BUILD_S = 20.0


@dataclass
class AotPoint:
    """One executable the planner will resolve at PLAYING."""

    element: str
    kind: str  # solo | loop | shard | replica | chain-head
    model: str
    custom: str
    shapes: List  # [[shape...], dtype] rows (empty when PLAYING-resolved)
    spec: Dict
    key: Optional[str] = None  # exact predicted key; None = meta-scan only
    cached: Optional[bool] = None
    est_compile_s: float = 0.0
    count: int = 1  # replica points: one entry per device
    stale: List[str] = field(default_factory=list)  # stale entry files


def _platform(e) -> str:
    """The key's platform of a filter: its device's type (the CPU when
    ``accelerator`` asks for it, else ``cuda``)."""
    from nnstreamer_tpu_torch.filters.cuda_filter import wants_cpu

    return "cpu" if wants_cpu(str(e.properties.get("accelerator", "")
                                  or "")) else "cuda"


def _aot_filters(pipeline) -> List:
    """The tensor_filters whose AOT gate is ON — the only elements that
    produce NNST97x.  Mirrors the runtime gate exactly (cuda_filter
    ``_aot_enabled``): custom ``aot:`` wins, then ``NNSTPU_AOT``, else
    off."""
    from nnstreamer_tpu_torch.elements.filter import TensorFilter
    from nnstreamer_tpu_torch.filters.base import FilterProperties
    from nnstreamer_tpu_torch.filters.cuda_filter import _aot_enabled

    out = []
    for e in pipeline.elements.values():
        if not isinstance(e, TensorFilter):
            continue
        if str(e.properties.get("framework", "")) not in ("jax",
                                                            "torch_cuda"):
            continue
        if not e.properties.get("model"):
            continue
        cd = FilterProperties(
            custom=str(e.properties.get("custom", "") or "")).custom_dict()
        try:
            if _aot_enabled(cd):
                out.append((e, cd))
        except Exception:  # noqa: BLE001 — unreadable gate: off
            continue
    return out


def _sig_rows(shapes) -> List:
    """ShapeDtypes (costmodel's view) → the [[shape], dtype] rows
    aot.cache_key hashes — MUST match the runtime's signature encoding
    (cuda_filter sig tuples) or predicted keys never match real ones."""
    import numpy as np

    return [[list(int(d) for d in s.shape), str(np.dtype(s.dtype))]
            for s in shapes]


def _info_rows(info) -> List:
    import numpy as np

    return [[list(int(d) for d in t.np_shape()),
             str(np.dtype(t.dtype.np_dtype))] for t in info]


def _base_spec(cd: Dict) -> Dict:
    """The lint-time mirror of TorchCudaFilter._composition_spec for an
    UNFUSED filter (the validate path never reaches PLAYING, so no
    planner stage fusion is installed): donation only."""
    spec: Dict = {}
    from nnstreamer_tpu_torch.pipeline.planner import donation_requested

    if donation_requested(",".join(f"{k}:{v}" for k, v in cd.items())):
        spec["donate"] = True
    return spec


def _est_compile_s(e) -> float:
    est = _COMPILE_BASE_S
    if _platform(e) == "cuda":
        from nnstreamer_tpu_torch.ops import _cuda

        try:
            if not _cuda.library_built():
                est += _KERNEL_BUILD_S
        except OSError:  # no kernel sources: nothing to build
            pass
    return est


def _chain_role(pipeline, e) -> Optional[str]:
    """``"head"``/``"member"`` when an ELIGIBLE chain run owns this
    filter's program at PLAYING, else None.  A member's executable is
    the head's composition — it gets no compile-point of its own."""
    try:
        from nnstreamer_tpu_torch.analysis.chain import analyze_chains

        for v in analyze_chains(pipeline):
            if getattr(v, "blocked", None) is not None:
                continue
            if len(v.members) < 2:
                continue
            if e is v.members[0]:
                return "head"
            if any(e is m for m in v.members[1:]):
                return "member"
    except Exception:  # noqa: BLE001 — chain analyzer unavailable
        return None
    return None


def aot_points(pipeline) -> List[AotPoint]:
    """Every compile-point the planner resolves at PLAYING, with the
    predicted cache outcome.  Placement strategies are mutually
    exclusive per filter (the chain/loop/shard/pool static blockers
    enforce it), so each AOT-on filter yields exactly one point — except
    chain members, absorbed into their head's composition."""
    from nnstreamer_tpu_torch.analysis.costmodel import (
        _lint_time_program,
        filter_program,
    )
    from nnstreamer_tpu_torch.analysis.loop import runtime_loop_config
    from nnstreamer_tpu_torch.analysis.pool import resolve_pool, served_filter
    from nnstreamer_tpu_torch.analysis.shard import resolve_shard
    from nnstreamer_tpu_torch.filters import aot

    # replica pools attach to the SERVED filter
    pooled: Dict[int, int] = {}
    try:
        for name, (n, note, fname, _mb) in resolve_pool(pipeline).items():
            if n > 1 and note is None:
                src = pipeline.elements.get(name)
                f = served_filter(src) if src is not None else None
                if f is not None:
                    pooled[id(f)] = n
    except Exception:  # noqa: BLE001 — no serving tier in this pipeline
        pass

    points: List[AotPoint] = []
    for e, cd in _aot_filters(pipeline):
        model = str(e.properties.get("model"))
        custom = str(e.properties.get("custom", "") or "")
        role = _chain_role(pipeline, e)
        if role == "member":
            continue  # the head's composition owns this program
        spec = _base_spec(cd)
        point = AotPoint(element=e.name, kind="solo", model=model,
                         custom=custom, shapes=[], spec=spec)
        key_custom = custom

        if role == "head":
            # gap-fused stage specs are planner-resolved — predict by
            # meta-scan (an entry whose spec records a chain of this
            # model counts as warm)
            point.kind = "chain-head"
        elif id(e) in pooled:
            n = pooled[id(e)]
            point.kind = "replica"
            point.count = n
            point.spec = dict(spec, placement="replica")
        else:
            window, depth = (1, 1)
            try:
                window, depth = runtime_loop_config(pipeline, e)
            except Exception:  # noqa: BLE001 — loop analyzer unavailable
                pass
            shard_cfg = None
            try:
                shard_cfg, _billing, _reason = resolve_shard(pipeline, e)
            except Exception:  # noqa: BLE001 — shard analyzer unavailable
                pass
            if window > 1:
                point.kind = "loop"
                point.spec = dict(spec, loop_window=int(window),
                                  launch_depth=int(depth))
                # build_loop keys the MODEL signature (props/bundle
                # input_info), not the negotiated arriving caps
                prog = _lint_time_program(e)
                if prog is not None and prog[2] is not None:
                    point.shapes = _info_rows(prog[2])
            elif shard_cfg is not None:
                point.kind = "shard"
                dp, tp = int(shard_cfg["dp"]), int(shard_cfg["tp"])
                sspec = {"mode": str(shard_cfg["mode"]),
                         "shard_devices": dp * tp, "tp_devices": tp}
                key_custom = custom + "|shard=" + json.dumps(
                    sspec, sort_keys=True)
            if not point.shapes:
                prog = filter_program(e)
                if prog is not None:
                    point.shapes = _sig_rows(prog[2])

        if point.shapes and point.kind not in ("chain-head", "replica"):
            try:
                point.key = aot.cache_key(
                    model, key_custom,
                    [(tuple(s), d) for s, d in point.shapes],
                    _platform(e), spec=point.spec)
                point.cached = os.path.exists(aot.cache_path(point.key))
            except Exception:  # noqa: BLE001 — unreadable model file
                point.key = None
        if point.key is None:
            point.cached = _meta_scan(point)
        if not point.cached:
            point.est_compile_s = _est_compile_s(e) * point.count
        points.append(point)

    _find_stale(points)
    return points


def _meta_scan(point: AotPoint) -> Optional[bool]:
    """Warm/cold prediction for PLAYING-resolved compositions: an entry
    recording the same model path and placement class counts as warm.
    None (unknown) when the cache cannot be read."""
    from nnstreamer_tpu_torch.filters import aot

    try:
        rows = aot.cache_entries()
    except Exception:  # noqa: BLE001 — cache dir refused/unreadable
        return None
    for r in rows:
        if not r.get("meta_ok"):
            continue
        if r.get("model") != point.model:
            continue
        rspec = r.get("spec") or {}
        if point.kind == "replica" and rspec.get("placement") == "replica":
            return True
        if point.kind == "chain-head" and rspec.get("chain"):
            return True
    return False


def _find_stale(points: List[AotPoint]) -> None:
    """Mark entries that match a point's (model, custom, signature) but
    carry a DIFFERENT key: some key dimension moved underneath them
    (runtime upgrade, model content edit, composition change) and they
    will never be loaded again."""
    from nnstreamer_tpu_torch.filters import aot

    try:
        rows = aot.cache_entries()
    except Exception:  # noqa: BLE001 — cache dir refused/unreadable
        return
    live = {p.key for p in points if p.key}
    for p in points:
        if p.key is None:
            continue
        for r in rows:
            if not r.get("meta_ok") or r["key"] in live:
                continue
            if (r.get("model") == p.model and r.get("custom") == p.custom
                    and r.get("shapes") == p.shapes):
                p.stale.append(r["file"])


def aot_pass_body(ctx) -> None:
    points = aot_points(ctx.pipeline)
    if not points:
        return
    total = sum(p.count for p in points)
    warm = sum(p.count for p in points if p.cached)
    rows = []
    for p in points:
        outcome = ("warm hit" if p.cached
                   else "cold compile" if p.cached is not None
                   else "unknown (cache unreadable)")
        n = f" x{p.count}" if p.count > 1 else ""
        keyed = (f" key={p.key[:12]}" if p.key
                 else " (key resolved at PLAYING)")
        rows.append(f"{p.element}[{p.kind}{n}]{keyed}: {outcome}")
    ctx.emit(
        "NNST970", points[0].element,
        f"AOT compile-points: {warm}/{total} predicted warm — "
        + "; ".join(rows))
    for p in points:
        if p.cached:
            continue
        dims = sorted(p.spec) if p.spec else ["(solo program)"]
        est = (f"~{p.est_compile_s:.0f}s estimated in-line worker build"
               if p.est_compile_s else "in-line build cost unknown")
        ctx.emit(
            "NNST971", p.element,
            f"cold start: no cache entry for {p.element!r}'s {p.kind} "
            f"program (key dims: {', '.join(str(d) for d in dims)}) — "
            f"the first PLAYING pays {est}",
            hint="warm the cache before deploy: play the pipeline once "
                 "on this runtime, or call aot_prefetch from a "
                 "provisioning job")
        for f in p.stale:
            ctx.emit(
                "NNST972", p.element,
                f"stale AOT entry {f}: matches {p.element!r}'s model + "
                f"signature but a key dimension moved (runtime upgrade, "
                f"kernel edit, model content edit, or composition change) "
                f"— it will never be loaded again",
                hint="doctor --aot lists entries; --aot-purge reclaims "
                     "the bytes")
    _emit_quarantine(ctx, points)


def _emit_quarantine(ctx, points: List[AotPoint]) -> None:
    from nnstreamer_tpu_torch.filters import aot

    try:
        q = aot.quarantined_entries()
    except Exception:  # noqa: BLE001 — cache dir refused/unreadable
        return
    if q:
        ctx.emit(
            "NNST972", points[0].element,
            f"{len(q)} quarantined AOT cache entr"
            f"{'y' if len(q) == 1 else 'ies'} "
            f"(unreadable at load: a damaged or stale entry file): "
            f"{', '.join(q[:4])}"
            + (" ..." if len(q) > 4 else ""),
            hint="doctor --aot-purge clears the quarantine")
