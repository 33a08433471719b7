"""nnfleet-r static licensing (NNST98x; counterpart of the JAX package's
``analysis/fleet.py``): rollout + failover/hedging.

The fleet client's hedging and the tensor_filter rollout canary both
have configurations that *cannot* work — not "slow", but semantically
broken — and both are detectable from properties alone:

  NNST980  error    hedge-after-ms without an ``endpoints=`` fleet: the
                    legacy single-connection path stamps no ``_rid``, so
                    the server cannot deduplicate a hedged resend — the
                    same frame would be invoked twice (and billed twice
                    by admission control).
  NNST981  error    rollout-rollback=auto with rollout-canary-frames=0:
                    the canary window is what observes the regression;
                    with zero frames watched, the auto-rollback decision
                    is unreachable and a bad model B serves forever.
  NNST982  warning  endpoints= with exactly one entry plus hedging: the
                    client takes the legacy single-connection path
                    (byte-identical wire), so the hedge knob is a no-op.

Free: two dict reads per element, no cost model, no compile.
"""

from __future__ import annotations

from nnstreamer_tpu_torch.analysis.registry import AnalysisContext


def fleet_pass_body(ctx: AnalysisContext) -> None:
    from nnstreamer_tpu_torch.edge.fleet import parse_endpoints
    from nnstreamer_tpu_torch.elements.filter import TensorFilter
    from nnstreamer_tpu_torch.elements.query import TensorQueryClient

    for e in ctx.pipeline.elements.values():
        if isinstance(e, TensorQueryClient):
            _check_hedge(ctx, e, parse_endpoints)
        elif isinstance(e, TensorFilter):
            _check_rollout(ctx, e)


def _check_hedge(ctx: AnalysisContext, e, parse_endpoints) -> None:
    hedge_ms = float(e.properties.get("hedge_after_ms", 0) or 0)
    if hedge_ms <= 0:
        return
    spec = str(e.properties.get("endpoints", "") or "").strip()
    n_eps = 0
    if spec:
        try:
            n_eps = len(parse_endpoints(spec))
        except ValueError:
            # malformed endpoints= — the properties pass / start() will
            # reject it; for hedging purposes there is no fleet
            n_eps = 0
    if n_eps >= 2:
        return
    if n_eps == 1:
        ctx.emit(
            "NNST982", e,
            f"hedge-after-ms={hedge_ms:g} with a single endpoint in "
            f"endpoints=: a hedged resend has no second server to go "
            f"to — the client takes the legacy single-connection path "
            f"and the knob does nothing",
            hint="list >=2 endpoints (or a discovery topic feeding "
                 "several) to make hedging effective",
            span=getattr(e, "_prop_spans", {}).get("hedge_after_ms"))
        return
    ctx.emit(
        "NNST980", e,
        f"hedge-after-ms={hedge_ms:g} without endpoints=: single-"
        f"connection frames carry no _rid idempotency token, so the "
        f"server cannot deduplicate a hedged resend — the same request "
        f"would be invoked (and admission-billed) twice",
        hint="set endpoints=host:port,host:port — fleet frames stamp "
             "_rid and the server's RidFilter acks duplicates with "
             "SERVER_BUSY detail=hedge-duplicate",
        span=getattr(e, "_prop_spans", {}).get("hedge_after_ms"))


def _check_rollout(ctx: AnalysisContext, e) -> None:
    configured = (e.properties.get("rollout_model")
                  or e.properties.get("rollout_canary_frames") is not None
                  or e.properties.get("rollout_rollback"))
    if not configured:
        return
    rollback = str(e.properties.get("rollout_rollback", "auto") or "auto")
    if rollback != "auto":
        return
    from nnstreamer_tpu_torch.elements.filter import TensorFilter

    canary = int(e.properties.get("rollout_canary_frames",
                                  TensorFilter.ROLLOUT_CANARY_FRAMES) or 0)
    if canary > 0:
        return
    ctx.emit(
        "NNST981", e,
        "rollout-rollback=auto with rollout-canary-frames=0: no frame "
        "is ever watched after the flip, so the regression that would "
        "trigger the rollback can never be observed — a bad model B "
        "serves forever",
        hint="set rollout-canary-frames>0 (default 64) or "
             "rollout-rollback=off if the flip is meant to be final",
        span=getattr(e, "_prop_spans", {}).get("rollout_canary_frames"))
