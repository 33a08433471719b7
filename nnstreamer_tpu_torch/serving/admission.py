"""Admission control + per-tenant fairness for the serving scheduler.

Three small, separately testable pieces:

- :class:`TokenBucket` — classic rate/burst bucket (continuous refill,
  monotonic clock injected for tests).
- :func:`parse_weights` — the ``serve-weights="tenantA:2,tenantB:1"``
  grammar.
- :class:`AdmissionController` — per-tenant admission verdicts (queue
  bound first, then the token bucket) plus a stride scheduler for
  weighted-fair dequeue: each tenant carries a *pass* value advanced by
  ``1/weight`` per dequeued request, and the next request always comes
  from the backlogged tenant with the smallest pass — over any window
  the dequeue ratio converges to the weight ratio without per-batch
  bookkeeping (the WFQ flavor vLLM-style servers use for fairness).

The controller never touches sockets or buffers: it answers "admit or
shed?" and "whose request next?"; the scheduler owns the queues.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Optional

#: admission verdicts (the shed reason that rides the SERVER_BUSY reply)
SHED_QUEUE_FULL = "queue-full"
SHED_RATE_LIMITED = "rate-limited"


class TokenBucket:
    """``rate`` tokens/sec refill up to ``burst``; ``take()`` is O(1)."""

    def __init__(self, rate: float, burst: float, now: Optional[float] = None):
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self._tokens = self.burst
        self._t = time.monotonic() if now is None else now

    def take(self, now: Optional[float] = None) -> bool:
        if self.rate <= 0:
            return True  # unlimited
        if now is None:
            now = time.monotonic()
        self._tokens = min(self.burst, self._tokens + (now - self._t) * self.rate)
        self._t = now
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False

    def set_rate(self, rate: Optional[float] = None,
                 burst: Optional[float] = None,
                 now: Optional[float] = None) -> None:
        """Hot-set the bucket mid-stream (the nnctl actuation path).

        The balance is settled FIRST at the old rate up to ``now`` —
        tokens already earned are never repriced — then the new
        rate/burst apply; a shrunk burst clamps the balance so a rate
        cut takes effect immediately instead of riding a stale surplus.
        Lock-ordering contract: buckets are only ever touched under the
        owning :class:`ServingScheduler`'s lock (``admit`` runs there,
        and the controller actuates via ``ServingScheduler.set_tenant_
        rate`` which takes the same lock) — this method takes none."""
        if now is None:
            now = time.monotonic()
        if self.rate > 0:
            self._tokens = min(self.burst,
                               self._tokens + (now - self._t) * self.rate)
        self._t = now
        if rate is not None:
            self.rate = float(rate)
        if burst is not None:
            self.burst = max(1.0, float(burst))
        self._tokens = min(self._tokens, self.burst)


def parse_weights(spec) -> Dict[str, float]:
    """``"tenantA:2,tenantB:1"`` → {"tenantA": 2.0, "tenantB": 1.0}.
    Malformed entries raise ValueError (a typo'd weight must fail at
    construction, not silently mean weight 1)."""
    out: Dict[str, float] = {}
    for tok in str(spec or "").split(","):
        tok = tok.strip()
        if not tok:
            continue
        name, sep, w = tok.rpartition(":")
        if not sep or not name:
            raise ValueError(f"bad serve-weights entry {tok!r} "
                             f"(expected tenant:weight)")
        weight = float(w)
        if weight <= 0:
            raise ValueError(f"serve-weights weight for {name!r} must be "
                             f"positive, got {w!r}")
        out[name.strip()] = weight
    return out


class AdmissionController:
    """Per-tenant admission + weighted-fair dequeue order.

    ``queue_depth <= 0`` means unbounded (the NNST901 lint flags it);
    ``rate <= 0`` disables the token bucket. Weights default to 1 for
    tenants not named in ``weights``.
    """

    def __init__(self, queue_depth: int = 64, rate: float = 0.0,
                 burst: Optional[float] = None,
                 weights: Optional[Dict[str, float]] = None):
        self.queue_depth = int(queue_depth)
        self.rate = float(rate)
        self.burst = float(burst) if burst else max(1.0, self.rate)
        self.weights = dict(weights or {})
        self._buckets: Dict[str, TokenBucket] = {}
        # per-tenant (rate, burst) overrides the controller hot-sets;
        # tenants without one keep the constructor defaults
        self._rate_overrides: Dict[str, tuple] = {}
        self._pass: Dict[str, float] = {}
        self._global_pass = 0.0

    # -- admission ---------------------------------------------------------
    def admit(self, tenant: str, waiting: int,
              now: Optional[float] = None) -> Optional[str]:
        """Verdict for one arriving request: None = admitted, else the
        shed reason. ``waiting`` is the tenant's current queue depth
        (the scheduler owns the queues)."""
        if self.queue_depth > 0 and waiting >= self.queue_depth:
            return SHED_QUEUE_FULL
        bucket = self._buckets.get(tenant)
        if bucket is None:
            rate, burst = self._rate_overrides.get(
                tenant, (self.rate, self.burst))
            bucket = self._buckets[tenant] = TokenBucket(
                rate, burst, now=now)
        if not bucket.take(now):
            return SHED_RATE_LIMITED
        return None

    def set_rate(self, tenant: str, rate: Optional[float] = None,
                 burst: Optional[float] = None,
                 now: Optional[float] = None) -> Dict[str, float]:
        """Hot-set one tenant's token-bucket rate/burst (nnctl).  The
        override survives bucket (re)creation.  Returns the tenant's
        effective {rate, burst} after the change.  Same lock-ordering
        contract as :meth:`TokenBucket.set_rate`: callers hold the
        owning scheduler's lock."""
        cur_rate, cur_burst = self._rate_overrides.get(
            tenant, (self.rate, self.burst))
        new_rate = cur_rate if rate is None else float(rate)
        new_burst = cur_burst if burst is None else max(1.0, float(burst))
        self._rate_overrides[tenant] = (new_rate, new_burst)
        bucket = self._buckets.get(tenant)
        if bucket is not None:
            bucket.set_rate(new_rate, new_burst, now=now)
        return {"rate": new_rate, "burst": new_burst}

    def tenant_rate(self, tenant: str) -> Dict[str, float]:
        rate, burst = self._rate_overrides.get(
            tenant, (self.rate, self.burst))
        return {"rate": rate, "burst": burst}

    # -- weighted-fair dequeue (stride scheduling) -------------------------
    def weight(self, tenant: str) -> float:
        return float(self.weights.get(tenant, 1.0))

    def pick(self, backlogged: Iterable[str]) -> Optional[str]:
        """The tenant whose request dequeues next: smallest pass value
        among tenants with waiting work (ties broken by name for
        determinism). Callers MUST follow with :meth:`advance`."""
        best = None
        best_pass = None
        for t in backlogged:
            p = self._pass.get(t)
            if p is None:
                # late joiner starts at the current virtual time, not 0 —
                # otherwise a new tenant would monopolize the scheduler
                # until its pass catches up with long-running tenants
                p = self._pass[t] = self._global_pass
            if best_pass is None or p < best_pass or (
                    p == best_pass and t < best):
                best, best_pass = t, p
        return best

    def advance(self, tenant: str) -> None:
        p = self._pass.get(tenant, self._global_pass) + 1.0 / self.weight(tenant)
        self._pass[tenant] = p
        self._global_pass = max(self._global_pass, p)
