"""nnfleet-r static licensing (NNST98x; counterpart of the JAX package's
``analysis/fleet.py``): failover and hedging.

The fleet client's hedging has configurations that *cannot* work — not
"slow", but semantically broken — detectable from properties alone:

  NNST980  error    hedge-after-ms without an ``endpoints=`` fleet: the
                    legacy single-connection path stamps no ``_rid``, so
                    the server cannot deduplicate a hedged resend — the
                    same frame would be invoked twice (and billed twice
                    by admission control).
  NNST982  warning  endpoints= with exactly one entry plus hedging: the
                    client takes the legacy single-connection path
                    (byte-identical wire), so the hedge knob is a no-op.

The JAX package's NNST981 (``rollout-rollback=auto`` with a zero canary
window) reads the filter's ``rollout-*`` properties, which this package's
tensor_filter refuses at construction until rollout is ported (ROADMAP.md
queue 1): such a line never reaches the passes, so the check waits with
rollout.

Free: two dict reads per element, no cost model.
"""

from __future__ import annotations

from nnstreamer_tpu_torch.analysis.registry import AnalysisContext


def fleet_pass_body(ctx: AnalysisContext) -> None:
    from nnstreamer_tpu_torch.edge.fleet import parse_endpoints
    from nnstreamer_tpu_torch.elements.query import TensorQueryClient

    for e in ctx.pipeline.elements.values():
        if isinstance(e, TensorQueryClient):
            _check_hedge(ctx, e, parse_endpoints)


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
