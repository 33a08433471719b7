"""nnctl static analysis (NNST95x; counterpart of the JAX package's
``analysis/ctl.py``): SLO feasibility and controller-bound sanity for the
closed-loop serving controller, checked BEFORE anything serves.

The controller (serving/controller.py) can only steer within its
``ctl-bounds`` and can never beat physics: if the plant model
(:mod:`analysis.plant` — the same model the controller's predictive
shed gate prices requests with) says the zero-load latency floor
already exceeds the declared ``slo-ms`` at every reachable serve-batch,
no amount of runtime feedback will meet the SLO.  That is a config
error worth failing at lint time, not a pager at 3am:

- **NNST950** (error) — SLO statically infeasible: even the best
  serve-batch inside ``ctl-bounds`` prices a zero-load p99 floor above
  ``slo-ms``.  Fix hint names the floor and the dominant term.
- **NNST951** (warning) — the controller's bounds exclude the modeled
  optimum: the largest serve-batch whose floor still fits the SLO (the
  capacity-headroom optimum the controller would converge to) lies
  outside ``ctl-bounds``.
- **NNST952** (warning) — conflicting pins: ``ctl=1`` on a server
  whose downstream filter pins its compiled batch signature with an
  explicit ``input=`` override (every actuation would retrace or
  reject), a launch-line ``serve-batch`` (e.g. an nntune-chosen pin)
  outside ``ctl-bounds`` (the controller's first move abandons the
  pin), or ``ctl=1`` without ``serve=1`` (nothing to control).

The model-backed verdicts (950/951) run only when the downstream
filter is statically modelable (the torch/CUDA backend — the cost
model's meta run, :func:`analysis.plant.serving_launch_model`); custom
backends skip them quietly.  NNST952 is pure property arithmetic and
always runs.
"""

from __future__ import annotations

from typing import Optional

from nnstreamer_tpu_torch.analysis.registry import AnalysisContext


def _ctl_enabled(e) -> bool:
    return bool(e.properties.get("ctl"))


def _slo_ms(e) -> float:
    try:
        return float(e.properties.get("slo_ms", 0) or 0)
    except (TypeError, ValueError):
        return 0.0


def _bounds(e) -> Optional[dict]:
    from nnstreamer_tpu_torch.serving.controller import parse_ctl_bounds

    try:
        return parse_ctl_bounds(e.properties.get("ctl_bounds", ""))
    except ValueError:
        return None  # NNST103 (property validator) owns malformed bounds


def ctl_pass_body(ctx: AnalysisContext) -> None:
    from nnstreamer_tpu_torch.analysis.passes import (
        _downstream_filter,
        _filter_signature_batch,
    )
    from nnstreamer_tpu_torch.analysis.plant import (
        predict_latency,
        serving_launch_model,
        slo_optimal_batch,
    )
    from nnstreamer_tpu_torch.elements.query import TensorQueryServerSrc

    # ONE static report shared across every query server on this
    # pipeline (the report is element-keyed; re-walking the whole graph
    # per server would pay the meta run N times)
    rep_cache = {"tried": False, "report": None}

    def _static_report():
        if not rep_cache["tried"]:
            rep_cache["tried"] = True
            from nnstreamer_tpu_torch.analysis.costmodel import static_report

            try:
                rep_cache["report"] = static_report(ctx.pipeline)
            except Exception:  # noqa: BLE001 — unmodelable graph
                rep_cache["report"] = None
        return rep_cache["report"]

    for e in ctx.pipeline.elements.values():
        if not isinstance(e, TensorQueryServerSrc):
            continue
        ctl = _ctl_enabled(e)
        slo = _slo_ms(e)
        if not ctl and slo <= 0:
            continue  # nothing controller-shaped on this server
        serving = bool(e.properties.get("serve"))
        if ctl and not serving:
            ctx.emit(
                "NNST952", e,
                "ctl=1 without serve=1: the controller steers the "
                "serving scheduler's knobs — a non-serving server has "
                "nothing to control",
                hint="set serve=1 serve-batch=<N> (see README 'Serving') "
                     "or drop ctl=1",
                span=getattr(e, "_prop_spans", {}).get("ctl"))
            continue
        bounds = _bounds(e)
        if bounds is None:
            continue
        lo_b, hi_b = bounds["batch"]
        serve_batch = int(e.properties.get("serve_batch", 1) or 1)

        # conflicting pins (pure property arithmetic, no model needed)
        if ctl:
            filt = _downstream_filter(e)
            pin = _filter_signature_batch(filt) if filt is not None else None
            if pin is not None and (lo_b != pin or hi_b != pin):
                ctx.emit(
                    "NNST952", e,
                    f"ctl=1 would vary serve-batch inside "
                    f"[{lo_b}, {hi_b}] but filter {filt.name!r} pins its "
                    f"compiled batch signature to {pin} (input= "
                    f"override): every actuation retraces or rejects",
                    hint=f"drop the filter's input= override, or pin the "
                         f"controller with ctl-bounds=batch:{pin}:{pin}",
                    span=getattr(e, "_prop_spans", {}).get("ctl_bounds"))
            elif not (lo_b <= serve_batch <= hi_b):
                ctx.emit(
                    "NNST952", e,
                    f"launch line pins serve-batch={serve_batch} outside "
                    f"ctl-bounds [{lo_b}, {hi_b}]: the controller's first "
                    f"move abandons the pinned value (an nntune-chosen "
                    f"pin and a controller range must agree)",
                    hint=f"widen ctl-bounds to include {serve_batch}, or "
                         f"start from a serve-batch inside the bounds",
                    span=getattr(e, "_prop_spans", {}).get("serve_batch"))

        # model-backed feasibility (needs a statically modelable filter)
        if slo <= 0:
            continue
        model = serving_launch_model(ctx.pipeline, e,
                                     report=_static_report())
        if model is None:
            continue
        cfg = {
            "row_device_ms": model["row_device_ms"],
            "linger_ms": float(e.properties.get("serve_linger_ms", 0) or 0),
            "queue_depth": int(e.properties.get("serve_queue_depth", 64)
                               or 0),
        }
        # the batches this server can actually RUN at: with ctl on, the
        # controller's bounds (an out-of-bounds serve-batch pin is
        # NNST952's problem — the controller's first move abandons it);
        # with ctl off, exactly the pinned serve-batch — a batch-1 floor
        # must not excuse a server that only ever launches at batch 64
        if ctl:
            reachable = {lo_b, hi_b}
            if lo_b <= serve_batch <= hi_b:
                reachable.add(serve_batch)
            where = f"the best reachable serve-batch (bounds " \
                    f"[{lo_b}, {hi_b}])"
        else:
            reachable = {serve_batch}
            where = f"the pinned serve-batch {serve_batch}"
        floors = {
            b: predict_latency(dict(cfg, serve_batch=b),
                               {"arrival_rps": 0.0})["p99_ms"]
            for b in sorted(reachable)
        }
        best_floor = min(floors.values())
        if best_floor > slo:
            from nnstreamer_tpu_torch.analysis.plant import PLANT_CONSTANTS

            worst_term = (
                "the per-launch dispatch floor"
                if PLANT_CONSTANTS["dispatch_ms_per_launch"]
                >= model["row_device_ms"] * min(reachable)
                else "the device leg")
            ctx.emit(
                "NNST950", e,
                f"slo-ms={slo:g} is statically infeasible: the plant "
                f"model's zero-load p99 floor is {best_floor:g} ms at "
                f"{where}, dominated by {worst_term}",
                hint="raise slo-ms above the modeled floor, or shrink "
                     "the pipeline's per-launch cost (smaller model, "
                     "chain fusion, steady loop)",
                span=getattr(e, "_prop_spans", {}).get("slo_ms"))
            continue
        if ctl:
            opt = slo_optimal_batch(cfg, slo)
            if opt is not None and not (lo_b <= opt <= hi_b):
                ctx.emit(
                    "NNST951", e,
                    f"ctl-bounds [{lo_b}, {hi_b}] exclude the modeled "
                    f"optimum serve-batch {opt} (the largest batch whose "
                    f"zero-load floor still fits slo-ms={slo:g} — the "
                    f"capacity headroom the controller would converge "
                    f"to)",
                    hint=f"widen ctl-bounds to batch:{min(lo_b, opt)}:"
                         f"{max(hi_b, opt)} (or accept the reduced "
                         f"capacity ceiling deliberately)",
                    span=getattr(e, "_prop_spans", {}).get("ctl_bounds"))
