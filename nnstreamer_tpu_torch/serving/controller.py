"""nnctl — the SLO-driven closed-loop serving controller.

Serving tail latency lives mostly in the pool, not on the device: most
of the p99 sits in knobs (serve-batch, linger-ms, admission rate, queue
depth) that an offline tuner can only pick and request tracing can only
observe.  This module closes the loop: a
controller runs beside the :class:`ServingScheduler`, samples the live
measurement window each tick, and actuates the hot knobs *while
serving* — the Clipper-style adaptive-batching / SLO-feedback pattern
(Crankshaw et al., NSDI'17), with the nncost plant model
(:func:`analysis.plant.predict_latency`) pricing the decisions the
heuristics alone cannot.

Actuation rules, in fixed priority (one knob move per tick — a control
loop, not a solver):

- **revert** — the previous move made observed p99 materially worse:
  undo it and burn that direction for a few ticks (AIMD safety net; a
  plant model mispricing a non-linear launch cost cannot wedge the
  system in a bad config).
- **queue-shrink** — queue_ms dominates p99 while batches run
  UNDER-filled: the queue time is batch assembly/linger, not backlog —
  shrink serve-batch toward the observed fill and cut linger.
- **grow** — two licenses: queue_ms dominates with SATURATED fill
  (backlog — more rows per launch buys capacity wherever the launch
  cost is sub-linear, which the next tick's revert check verifies), or
  device_ms dominates with saturated fill and SLO headroom (throughput
  objective while latency is healthy).
- **rate-cut** — observed admitted p99 breaches the SLO and growing is
  not available (at the bound, burned, or under-filled): cut the
  offending tenants' token-bucket rates multiplicatively.
- **rate-restore** — sustained healthy ticks restore cut rates toward
  their configured values (the additive half of AIMD).
- **burst-spend** — tenants bank burst credits while they run under
  SLO and under their rate; a rate-limited burst from a credited
  tenant spends them as a temporary bucket-burst raise instead of
  shedding a well-behaved client's spike.
- **shed-gate** — continuous, not a knob move: the predictive shed
  gate (:meth:`ServingScheduler.set_ctl_gate`) is recalibrated from
  the observed batch cycle so admission prices each request's
  completion with the plant model instead of a fixed queue bound
  (sheds carry reason ``ctl_predicted_miss``).

Determinism is a hard contract: the controller reads time ONLY through
an injected clock and metrics ONLY through its feed; a scripted
:class:`ReplayFeed` + :class:`SimClock` replay produces a byte-identical
decision log (ci.sh diffs two runs).  The live path
(:class:`SchedulerFeed`) samples the scheduler's measurement window —
no tracer required; when one is attached, every decision is also
published as a ``ctl`` report section and a before→after annotated
span on the ``ctl:<server>`` Perfetto track.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from nnstreamer_tpu_torch.analysis.plant import PLANT_CONSTANTS, predict_latency
from nnstreamer_tpu_torch.log import get_logger

log = get_logger("nnctl")

#: default controller tick interval (ms) — ``ctl-interval-ms=``
DEFAULT_INTERVAL_MS = 100.0
#: fallback knob bounds when ``ctl-bounds=`` is not given
DEFAULT_BOUNDS = {
    "batch": (1, 64),
    "linger": (0.0, 50.0),   # ms
    "rate": (1.0, 1e9),      # requests/s per tenant
}
#: burst-credit economics: accrual per healthy tick, bank cap, spend size
CREDIT_ACCRUAL = 1
CREDIT_CAP = 20
CREDIT_SPEND = 5
#: ticks a reverted direction stays burned
BURN_TICKS = 8
#: decision-log ring bound (oldest evicted; evictions counted)
DECISION_CAP = 512


def parse_ctl_bounds(spec) -> Dict[str, tuple]:
    """``ctl-bounds=batch:2:32,linger:0:10,rate:5:500`` → per-knob
    (lo, hi) over the :data:`DEFAULT_BOUNDS`.  Malformed entries raise
    ValueError (a typo'd bound must fail at parse, not silently mean
    the default — the NNST103 property validator calls this)."""
    out = {k: tuple(v) for k, v in DEFAULT_BOUNDS.items()}
    for tok in str(spec or "").split(","):
        tok = tok.strip()
        if not tok:
            continue
        parts = tok.split(":")
        if len(parts) != 3:
            raise ValueError(
                f"bad ctl-bounds entry {tok!r} (expected knob:lo:hi)")
        knob = parts[0].strip()
        if knob not in DEFAULT_BOUNDS:
            raise ValueError(
                f"unknown ctl-bounds knob {knob!r} "
                f"(one of {sorted(DEFAULT_BOUNDS)})")
        lo, hi = float(parts[1]), float(parts[2])
        if lo < 0 or hi < lo:
            raise ValueError(
                f"ctl-bounds {knob} range {lo}:{hi} is empty or negative")
        out[knob] = (int(lo), int(hi)) if knob == "batch" else (lo, hi)
    return out


class SimClock:
    """Deterministic injectable clock (seconds): tests advance it."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, seconds: float) -> float:
        self.t += float(seconds)
        return self.t


class ReplayFeed:
    """Scripted metric feed: each :meth:`sample` pops the next snapshot
    (the determinism harness — two replays of one script through one
    controller config must produce byte-identical decision logs)."""

    def __init__(self, snapshots):
        self._snaps = list(snapshots)
        self._i = 0

    def sample(self) -> Optional[Dict]:
        if self._i >= len(self._snaps):
            return None
        snap = self._snaps[self._i]
        self._i += 1
        return dict(snap)


def _p(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    return sorted_vals[min(len(sorted_vals) - 1,
                           int(q * len(sorted_vals)))]


class SchedulerFeed:
    """Live metric feed over :meth:`ServingScheduler.ctl_window` (no
    tracer required — the scheduler's own measurement window carries
    pool waits, sink-acked device windows, assemble stamps and counter
    deltas).  Produces the same snapshot shape the ReplayFeed scripts."""

    def __init__(self, scheduler, clock: Callable[[], float] = None):
        self._sched = scheduler
        self._clock = clock or time.monotonic
        self._t_last: Optional[float] = None

    def sample(self) -> Dict:
        now = self._clock()
        dt = (now - self._t_last) if self._t_last is not None else 0.0
        self._t_last = now
        win = self._sched.ctl_window()
        waits = sorted(win["waits_ms"])
        devs = sorted(win["device_ms"])
        asm = win["assemble_t"]
        cycles = sorted(b - a for a, b in zip(asm, asm[1:]) if b > a)
        d = win["deltas"]
        batches = max(0, d.get("batches", 0))
        rows = max(0, d.get("rows", 0))
        snap = {
            "dt_s": round(dt, 6),
            "arrival_rps": round(
                (d.get("enqueued", 0) + d.get("shed", 0)) / dt, 3)
            if dt > 0 else 0.0,
            "admitted_rps": round(d.get("enqueued", 0) / dt, 3)
            if dt > 0 else 0.0,
            "queue_p99_ms": round(_p(waits, 0.99), 3),
            "queue_p50_ms": round(_p(waits, 0.50), 3),
            "device_p99_ms": round(_p(devs, 0.99), 3),
            "batch_cycle_ms": round(_p(cycles, 0.50) * 1e3, 3),
            "batch_fill": round(rows / batches, 3) if batches else 0.0,
            "serve_batch": win["serve_batch"],
            "serve_batch_pending": win["serve_batch_pending"],
            "linger_ms": win["linger_ms"],
            "queue_depth": win["queue_depth"],
            "replicas": win.get("replicas", 1),
            "waiting": win["waiting"],
            "shed_reasons": win["shed_reasons"],
            "tenants": {
                t: {
                    "arrival_rps": round(n / dt, 3) if dt > 0 else 0.0,
                    "rate": win["tenant_rates"][t]["rate"],
                    "burst": win["tenant_rates"][t]["burst"],
                }
                for t, n in sorted(win["tenant_arrivals"].items())
            },
        }
        # admitted p99 ≈ pool wait p99 + one device window: the wait is
        # measured per request, the device leg is per launch — together
        # they bound what the client sees minus the wire legs
        snap["admitted_p99_ms"] = round(
            snap["queue_p99_ms"] + snap["device_p99_ms"], 3)
        return snap


class ServingController:
    """One controller per serving ``tensor_query_serversrc``.

    ``scheduler`` is the live :class:`ServingScheduler` (or any object
    with its hot-knob API); ``clock``/``feed`` are injectable for the
    determinism tests; ``tracer_fn`` returns the pipeline tracer (or
    None) at publish time so late attachment works."""

    def __init__(self, scheduler, *, slo_ms: float = 0.0,
                 interval_ms: float = DEFAULT_INTERVAL_MS,
                 bounds: Optional[Dict] = None,
                 constants: Optional[Dict] = None,
                 stats_key: str = "0",
                 clock: Optional[Callable[[], float]] = None,
                 feed=None, tracer_fn=None):
        self.sched = scheduler
        self.slo_ms = float(slo_ms or 0.0)
        self.interval_ms = max(1.0, float(interval_ms or
                                          DEFAULT_INTERVAL_MS))
        self.bounds = {k: tuple(v) for k, v in
                       (bounds or DEFAULT_BOUNDS).items()}
        for k, v in DEFAULT_BOUNDS.items():
            self.bounds.setdefault(k, tuple(v))
        self.constants = dict(PLANT_CONSTANTS, **(constants or {}))
        self.stats_key = str(stats_key)
        self.clock = clock or time.monotonic
        self.feed = feed if feed is not None else SchedulerFeed(
            scheduler, self.clock)
        self._tracer_fn = tracer_fn or (lambda: None)
        self._t0 = self.clock()
        self._tick_n = 0
        self._good_ticks = 0
        self._credits: Dict[str, int] = {}
        self._burst_spent: Dict[str, float] = {}
        self._burst_base: Dict[str, float] = {}
        self._base_rates: Dict[str, Dict[str, float]] = {}
        # AIMD memory: the last knob move awaiting its verdict, and
        # directions burned by a revert
        self._last_move: Optional[Dict] = None
        self._burned: Dict[tuple, int] = {}
        self._gate_cycle_ms = 0.0
        self.decisions: List[Dict] = []
        self.dropped_decisions = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_ms / 1e3):
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 — the loop must survive
                    log.exception("nnctl tick failed")

        self._thread = threading.Thread(
            target=loop, daemon=True, name=f"nnctl-{self.stats_key}")
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=2.0)
        self._thread = None
        self.sched.set_ctl_gate(None, None)

    # -- decision plumbing -------------------------------------------------
    def _record(self, snap: Dict, rule: str, knob: str, before, after,
                reason: str, extra: Optional[Dict] = None) -> Dict:
        d = {
            "tick": self._tick_n,
            "t_ms": round((self.clock() - self._t0) * 1e3, 3),
            "rule": rule,
            "knob": knob,
            "before": before,
            "after": after,
            "reason": reason,
            "observed": {
                k: snap.get(k) for k in (
                    "arrival_rps", "admitted_p99_ms", "queue_p99_ms",
                    "device_p99_ms", "batch_fill", "batch_cycle_ms")
            },
        }
        if extra:
            d.update(extra)
        if len(self.decisions) >= DECISION_CAP:
            del self.decisions[0]
            self.dropped_decisions += 1
        self.decisions.append(d)
        tracer = self._tracer_fn()
        if tracer is not None:
            tracer.record_ctl_decision(self.stats_key, d)
            spans = getattr(tracer, "spans", None)
            if spans is not None:
                # before→after annotated actuation marker on the ctl
                # virtual track: every knob move auditable in Perfetto
                # next to the serving/device spans it affects
                t = time.perf_counter()
                spans.emit(f"ctl:{rule}", "ctl", t, t,
                           track=f"ctl:{self.stats_key}",
                           args={"rule": rule, "knob": knob,
                                 "before": str(before),
                                 "after": str(after), "reason": reason})
        return d

    def decision_log_text(self) -> str:
        """Canonical rendering of the decision log — the byte-diff
        surface of the ci.sh determinism gate."""
        import json

        return "\n".join(json.dumps(d, sort_keys=True)
                         for d in self.decisions) + (
            "\n" if self.decisions else "")

    # -- helpers -----------------------------------------------------------
    def _observed_load(self, snap: Dict) -> Dict:
        obs: Dict[str, Any] = {"arrival_rps": snap.get("arrival_rps", 0.0)}
        if snap.get("device_p99_ms"):
            obs["device_ms_per_launch"] = snap["device_p99_ms"]
        if snap.get("batch_cycle_ms"):
            obs["batch_cycle_ms"] = snap["batch_cycle_ms"]
        return obs

    def _predict(self, snap: Dict, batch: int) -> Dict:
        cur = max(1, int(snap.get("serve_batch", 1) or 1))
        obs = self._observed_load(snap)
        dev = obs.get("device_ms_per_launch")
        if dev is not None and batch != cur:
            # the measured launch window was taken at the CURRENT batch;
            # scale it linearly for the candidate (the conservative
            # assumption — the revert rule catches the sub-linear case
            # the grow probe is betting on)
            obs["device_ms_per_launch"] = dev * batch / cur
            obs.pop("batch_cycle_ms", None)
        return predict_latency(
            {"serve_batch": batch,
             "linger_ms": snap.get("linger_ms", 0.0),
             "queue_depth": snap.get("queue_depth", 0),
             # nnpool: the plant divides the device leg by the ACTIVE
             # replica count (absent → 1, replay logs byte-identical)
             "replicas": snap.get("replicas", 1)},
            obs, self.constants)

    def _burned_now(self, knob: str, direction: str) -> bool:
        until = self._burned.get((knob, direction))
        return until is not None and self._tick_n <= until

    def _grow_step(self, b: int) -> int:
        lo, hi = self.bounds["batch"]
        return min(int(hi), max(int(lo), b * 2))

    def _shrink_step(self, b: int, fill: float) -> int:
        # one multiplicative step per tick (the next tick shrinks again
        # if batches still run under-filled), never below the observed
        # fill — a batch the load actually fills must not be cut under
        # the load
        lo, hi = self.bounds["batch"]
        target = max(b // 2, max(1, int(fill)))
        return min(int(hi), max(int(lo), target))

    # -- the tick ----------------------------------------------------------
    def tick(self, snap: Optional[Dict] = None) -> List[Dict]:
        """One control step.  ``snap`` overrides the feed (tests); a
        None sample (exhausted replay) is a quiet tick."""
        if snap is None:
            snap = self.feed.sample()
        if snap is None:
            return []
        self._tick_n += 1
        made: List[Dict] = []
        batch = max(1, int(snap.get("serve_batch", 1) or 1))
        fill = float(snap.get("batch_fill", 0.0) or 0.0)
        fill_ratio = fill / batch if batch else 0.0
        q99 = float(snap.get("queue_p99_ms", 0.0) or 0.0)
        d99 = float(snap.get("device_p99_ms", 0.0) or 0.0)
        adm99 = float(snap.get("admitted_p99_ms", 0.0) or (q99 + d99))
        arrival = float(snap.get("arrival_rps", 0.0) or 0.0)
        lo_b, hi_b = self.bounds["batch"]

        # shed-gate recalibration (continuous; a decision only when the
        # calibration moved materially — the gate itself sheds per
        # request inside the scheduler's admission path)
        if self.slo_ms > 0:
            cycle = float(snap.get("batch_cycle_ms", 0.0) or 0.0)
            if not cycle:
                cycle = self._predict(snap, batch)["cycle_ms"]
            if cycle > 0 and self._gate_cycle_ms > 0:
                # EWMA-damped: per-window cycle medians jitter with the
                # batch phase; the gate should track the trend, not flap
                cycle = round(0.5 * self._gate_cycle_ms + 0.5 * cycle, 3)
            if cycle > 0 and (
                    self._gate_cycle_ms <= 0
                    or abs(cycle - self._gate_cycle_ms)
                    > 0.2 * self._gate_cycle_ms):
                before = round(self._gate_cycle_ms, 3)
                self.sched.set_ctl_gate(self.slo_ms, cycle)
                self._gate_cycle_ms = cycle
                made.append(self._record(
                    snap, "shed-gate", "gate-cycle-ms", before,
                    round(cycle, 3),
                    "plant-priced admission: predicted completion over "
                    f"slo={self.slo_ms:g}ms sheds ctl_predicted_miss"))

        # AIMD verdict on the previous knob move: materially worse p99
        # (or a superlinear cycle blow-up after a grow) → revert and
        # burn the direction.  A move the scheduler PENDED (in-flight
        # window not yet drained) has not produced an observation window
        # at the new batch — the verdict is DEFERRED, not consumed, or
        # the safety net would silently skip every pended grow.
        if self._last_move is not None and not self._last_move.get(
                "judged"):
            mv = self._last_move
            if snap.get("serve_batch") == mv["after"]:
                mv["judged"] = True
                worse_p99 = (mv["p99_before"] > 0 and adm99
                             > 1.25 * mv["p99_before"])
                cycle_now = float(snap.get("batch_cycle_ms", 0.0) or 0.0)
                # a grow only pays if the launch cost is sub-linear in
                # rows; a near-linear cycle blow-up means the probe
                # bought nothing per-row and just parked more latency
                # in each launch
                blew_cycle = (mv["rule"] == "grow"
                              and mv["cycle_before"] > 0
                              and cycle_now > 1.7 * mv["cycle_before"])
                if worse_p99 or blew_cycle:
                    self.sched.set_knobs(batch=mv["before"])
                    self._burned[("serve_batch", mv["direction"])] = (
                        self._tick_n + BURN_TICKS)
                    made.append(self._record(
                        snap, "revert", "serve-batch", mv["after"],
                        mv["before"],
                        "previous move regressed observed p99/cycle — "
                        f"undone, direction burned {BURN_TICKS} ticks"))
                    self._last_move = None
                    return made
            elif snap.get("serve_batch_pending") != mv["after"]:
                # neither applied nor pending: the knob moved elsewhere
                # (operator/another rule) — the verdict is moot
                mv["judged"] = True
            # else: still pended behind the in-flight window — defer

        # a serve-batch change still pended behind the in-flight window
        # blocks further batch moves this tick: re-firing would log a
        # duplicate decision per drain tick and overwrite the AIMD
        # baseline the deferred revert verdict compares against
        batch_pended = snap.get("serve_batch_pending") is not None
        moved = False
        breach = self.slo_ms > 0 and adm99 > self.slo_ms
        queue_dom = q99 > d99 > 0 or (q99 > 0 and d99 == 0)
        device_dom = d99 >= q99 > 0 or (d99 > 0 and q99 == 0)

        # queue-dominated, UNDER-filled: latency is batch assembly, not
        # backlog — shrink the batch toward the fill, cut linger
        if (not moved and not batch_pended and queue_dom
                and fill_ratio < 0.5 and batch > lo_b
                and not self._burned_now("serve_batch", "shrink")):
            target = self._shrink_step(batch, fill)
            if target < batch:
                pred = self._predict(snap, target)
                cur = self._predict(snap, batch)
                if pred["p99_ms"] <= cur["p99_ms"]:
                    before_p99 = adm99
                    self.sched.set_knobs(batch=target)
                    made.append(self._record(
                        snap, "queue-shrink", "serve-batch", batch, target,
                        "queue_ms dominates p99 with under-filled batches "
                        f"(fill {fill:g}/{batch})",
                        {"predicted_p99_ms": pred["p99_ms"]}))
                    lo_l, _hi_l = self.bounds["linger"]
                    if snap.get("linger_ms", 0.0) > lo_l:
                        before_l = snap.get("linger_ms", 0.0)
                        self.sched.set_knobs(linger_ms=lo_l)
                        made.append(self._record(
                            snap, "queue-shrink", "linger-ms", before_l,
                            lo_l, "linger adds assembly wait the load "
                                  "does not repay"))
                    self._last_move = {
                        "rule": "queue-shrink", "direction": "shrink",
                        "before": batch, "after": target,
                        "p99_before": before_p99,
                        "cycle_before": float(
                            snap.get("batch_cycle_ms", 0.0) or 0.0),
                        "judged": False}
                    moved = True

        # grow: queue-dominated saturation (backlog — capacity probe) or
        # device-dominated with SLO headroom (throughput objective)
        if not moved and not batch_pended and batch < hi_b \
                and fill_ratio >= 0.75 \
                and not self._burned_now("serve_batch", "grow"):
            reason = None
            if queue_dom:
                reason = ("queue_ms dominates p99 with saturated fill "
                          f"({fill:g}/{batch}): backlog — probe a bigger "
                          "launch for capacity")
            elif device_dom and (self.slo_ms <= 0
                                 or adm99 <= 0.7 * self.slo_ms):
                reason = ("device_ms dominates p99 with saturated fill "
                          "and SLO headroom: amortize the launch over "
                          "more rows")
            if reason is not None:
                target = self._grow_step(batch)
                if target > batch:
                    self.sched.set_knobs(batch=target)
                    made.append(self._record(
                        snap, "grow", "serve-batch", batch, target, reason,
                        {"predicted_p99_ms":
                         self._predict(snap, target)["p99_ms"]}))
                    self._last_move = {
                        "rule": "grow", "direction": "grow",
                        "before": batch, "after": target,
                        "p99_before": adm99,
                        "cycle_before": float(
                            snap.get("batch_cycle_ms", 0.0) or 0.0),
                        "judged": False}
                    moved = True

        # SLO breach with no batch move available: cut the offending
        # tenants' rates (multiplicative decrease)
        tenants = snap.get("tenants") or {}
        if breach and not moved:
            lo_r, _hi_r = self.bounds["rate"]
            for name in sorted(tenants):
                t = tenants[name]
                t_arr = float(t.get("arrival_rps", 0.0) or 0.0)
                cur_rate = float(t.get("rate", 0.0) or 0.0)
                eff = cur_rate if cur_rate > 0 else t_arr
                if eff <= 0:
                    continue
                new_rate = max(float(lo_r), round(0.75 * eff, 3))
                if cur_rate > 0 and new_rate >= cur_rate:
                    continue
                base = self._base_rates.setdefault(
                    name, {"rate": cur_rate,
                           "burst": float(t.get("burst", 0.0) or 0.0),
                           # the effective rate at cut time: the restore
                           # target when the configured rate was
                           # unlimited (rate 0)
                           "eff": eff})
                self.sched.set_tenant_rate(name, rate=new_rate)
                made.append(self._record(
                    snap, "rate-cut", f"rate[{name}]",
                    cur_rate if cur_rate > 0 else "unlimited", new_rate,
                    f"admitted p99 {adm99:g}ms breaches slo="
                    f"{self.slo_ms:g}ms — multiplicative rate decrease",
                    {"base_rate": base["rate"]}))
                moved = True

        # burst credits: healthy, under-rate tenants accrue; a
        # rate-limited spike from a credited tenant spends them as a
        # temporary burst raise instead of shedding the spike
        shed_rate_limited = int(
            (snap.get("shed_reasons") or {}).get("rate-limited", 0))
        healthy = self.slo_ms <= 0 or adm99 <= 0.7 * self.slo_ms
        if healthy:
            self._good_ticks += 1
            for name in sorted(tenants):
                self._credits[name] = min(
                    CREDIT_CAP, self._credits.get(name, 0) + CREDIT_ACCRUAL)
        else:
            self._good_ticks = 0
        spent_this_tick = False
        if healthy and shed_rate_limited > 0:
            for name in sorted(tenants):
                credits = self._credits.get(name, 0)
                cur_burst = float(tenants[name].get("burst", 0.0) or 0.0)
                if credits >= CREDIT_SPEND and cur_burst > 0:
                    self._burst_base.setdefault(name, cur_burst)
                    new_burst = cur_burst + CREDIT_SPEND
                    self.sched.set_tenant_rate(name, burst=new_burst)
                    self._credits[name] = credits - CREDIT_SPEND
                    self._burst_spent[name] = self._burst_spent.get(
                        name, 0.0) + CREDIT_SPEND
                    made.append(self._record(
                        snap, "burst-spend", f"burst[{name}]", cur_burst,
                        new_burst,
                        f"rate-limited sheds ({shed_rate_limited}) while "
                        "the system runs under SLO: spend banked burst "
                        "credits on the spike",
                        {"credits_left": self._credits[name]}))
                    spent_this_tick = True
                    break  # one spend per tick

        # additive restore of cut rates / spent burst once the system
        # has been healthy for a sustained run of ticks
        if self._good_ticks >= 5:
            for name in sorted(self._base_rates):
                base = self._base_rates[name]
                t = tenants.get(name) or {}
                cur_rate = float(t.get("rate", 0.0) or 0.0)
                base_rate = float(base.get("rate", 0.0) or 0.0)
                if cur_rate > 0 and (base_rate <= 0
                                     or cur_rate < base_rate):
                    if base_rate > 0:
                        new_rate = (base_rate
                                    if cur_rate * 1.25 >= base_rate
                                    else round(cur_rate * 1.25, 3))
                    else:
                        # base was UNLIMITED: ramp multiplicatively
                        # until the pre-cut effective rate is covered,
                        # then drop the limit entirely — the restore
                        # must TERMINATE, not bump forever
                        eff = float(base.get("eff", 0.0) or 0.0)
                        new_rate = (0.0 if eff <= 0
                                    or cur_rate * 1.25 >= eff
                                    else round(cur_rate * 1.25, 3))
                    self.sched.set_tenant_rate(name, rate=new_rate)
                    made.append(self._record(
                        snap, "rate-restore", f"rate[{name}]", cur_rate,
                        new_rate if new_rate > 0 else "unlimited",
                        "sustained healthy ticks: restore the cut rate "
                        "toward its configured value"))
                    if new_rate == 0.0 or (base_rate > 0
                                           and new_rate >= base_rate):
                        self._base_rates.pop(name, None)
                    break  # one restore per tick
            else:
                # decay spent burst back toward its banked base (never
                # in the same tick as a spend — the snapshot's burst is
                # stale the moment we raise it)
                if not spent_this_tick:
                    for name in sorted(self._burst_spent):
                        spent = self._burst_spent[name]
                        base = self._burst_base.get(name)
                        if spent <= 0 or base is None:
                            continue
                        remaining = spent - min(1.0, spent)
                        self._burst_spent[name] = remaining
                        self.sched.set_tenant_rate(
                            name, burst=base + remaining)
                        if remaining <= 0:
                            self._burst_base.pop(name, None)
                            self._burst_spent.pop(name, None)
                        break

        return made
