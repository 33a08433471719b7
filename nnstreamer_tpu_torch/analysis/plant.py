"""Shared performance plant model — the objective the tuner searches
offline and the serving controller (nnctl) steers against online.

The JAX package's tuner carried the host-side objective constants and the
roofline-leg arithmetic inline; the nnctl controller needs the SAME
model as its *plant* — the thing its actuations are priced against —
so both now live here:

- :data:`OBJECTIVE_CONSTANTS` — the PROFILE.md-derived host constants
  (per-launch python dispatch, per-flush sync) the tuner objective
  amortizes.  ``analysis/tuner.py`` re-exports them as
  ``TUNE_CONSTANTS`` (same keys, same values — the tuner's signed
  report is unchanged).
- :func:`leg_times_ms` — one static-report row → (device, serial) leg
  times, the per-invoke arithmetic ``predict_point`` used inline.
- :func:`predict_latency` — the serving-tier latency plant:
  ``predict_latency(config, observed_load)`` prices a (serve-batch,
  linger, queue-depth) configuration under an observed arrival rate
  with an M/D/1-flavored backlog term, clamped by the admission bound.
  This is what the controller's predictive shed gate and the NNST95x
  static feasibility verdicts both evaluate — one model, audited in
  one place.

A copy of the pure part of the JAX package's ``analysis/plant.py``. Its
``serving_launch_model`` (the static seed derived from the cost model's
report) waits for this package's cost model; until then the serving
controller gets no static seed and steers on measurements alone, as the
JAX controller does for a filter it cannot model.

Everything here is pure arithmetic over plain dicts: no wall clock, no
RNG, results rounded to fixed precision — the controller's decision
log and the ctl pass verdicts stay byte-reproducible.
"""

from __future__ import annotations

from typing import Dict, Optional

#: host-side objective constants — order-of-magnitude numbers from the
#: recorded profiling campaign (PROFILE.md rounds 3-7: ~12 ms/batch
#: python dispatch stack, low-ms per-flush sync).  The tuner re-exports
#: these as TUNE_CONSTANTS; absolute accuracy matters less than the
#: ordering they induce.
OBJECTIVE_CONSTANTS = {
    "dispatch_ms_per_launch": 12.0,   # host python stack per program launch
    "sync_ms_per_flush": 2.0,         # per fetch-window flush (d2h sync)
    "headroom_warn_pct": 25.0,        # NNST850 threshold
}

#: serving-plant extras layered over the shared objective constants
PLANT_CONSTANTS = dict(
    OBJECTIVE_CONSTANTS,
    reply_ms_per_row=0.2,      # serversink demux + send per valid row
    residual_cycle_factor=0.5,  # pull model: mean wait on the in-flight batch
    p99_queue_factor=3.0,       # backlog p99 ≈ factor × mean backlog wait
)

#: fixed serve-batch candidate grid the static optimum (NNST951)
#: searches — append-only, the order is part of the ctl pass
#: determinism contract
SERVE_BATCH_CANDIDATES = (1, 2, 4, 8, 16, 32, 64, 128)


def leg_times_ms(row: Dict, ndev: int = 1):
    """One ``costmodel.static_report`` row → ``(dev_ms, serial_ms)``:
    the device leg (compute + HBM, split across an engaged mesh) and
    the serialized per-invoke time including the host link."""
    dev = (float(row["compute_ms"]) + float(row["hbm_ms"])) / max(
        1, int(ndev))
    return dev, dev + float(row["link_ms"])


def predict_latency(config: Dict, observed_load: Optional[Dict] = None,
                    constants: Optional[Dict] = None) -> Dict:
    """Price one serving configuration under an observed load.

    ``config``: ``serve_batch`` (rows per launch), ``linger_ms``,
    ``queue_depth`` (admission bound in requests, <=0 unbounded),
    ``row_device_ms`` (static per-row device+link cost, the
    :func:`serving_launch_model` seed) and ``replicas`` (nnpool active
    replica count, default 1 — N per-device replicas overlap their
    device legs, so the effective device time per launch divides by N
    while the host legs stay serial).

    ``observed_load``: live measurements override the static seed —
    ``arrival_rps``, ``device_ms_per_launch`` (measured invoke window
    at the CURRENT batch), ``batch_cycle_ms`` (measured assemble-to-
    assemble gap; can only raise the modeled cycle, never lower it).

    The model (documented in README "Adaptive serving control"):

    - cycle = device leg + ``dispatch_ms_per_launch`` + per-row reply
      cost — one continuous-batching launch, wire to wire,
    - capacity = batch / cycle; utilization rho = arrival / capacity,
    - backlog wait: M/D/1 Pollaczek-Khinchine mean ``cycle *
      rho / (2(1-rho))``, p99 = ``p99_queue_factor`` x mean, both
      clamped by the admission bound (a full pool drains in
      ``depth/batch`` cycles — the queue CANNOT hold more latency than
      that, it sheds instead),
    - pull-model residual: a request waits half the in-flight cycle on
      average before its batch can even assemble,
    - fill wait: ``linger`` holds an under-filled batch open, bounded
      by the time the observed arrival rate needs to fill it.

    Returns a rounded dict: ``p99_ms``, ``mean_ms``, ``queue_p99_ms``,
    ``cycle_ms``, ``capacity_rps``, ``utilization``, ``shed_fraction``.
    Pure arithmetic — byte-reproducible for identical inputs.
    """
    c = dict(PLANT_CONSTANTS, **(constants or {}))
    obs = dict(observed_load or {})
    batch = max(1, int(config.get("serve_batch", 1) or 1))
    linger = max(0.0, float(config.get("linger_ms", 0.0) or 0.0))
    depth = int(config.get("queue_depth", 0) or 0)
    replicas = max(1, int(config.get("replicas", 1) or 1))
    launch_dev = obs.get("device_ms_per_launch")
    if launch_dev is None:
        launch_dev = float(config.get("row_device_ms", 0.0) or 0.0) * batch
    launch_dev = max(0.0, float(launch_dev))
    # nnpool replica division: N per-device replicas overlap their
    # device legs (least-loaded dispatch keeps them busy), so the
    # device time each launch effectively occupies the serving cycle
    # divides by N — the host legs (dispatch, per-row reply) stay
    # serial on the streaming/demux threads and do NOT divide
    launch_dev /= replicas
    cycle = (launch_dev + float(c["dispatch_ms_per_launch"])
             + float(c["reply_ms_per_row"]) * batch)
    measured_cycle = float(obs.get("batch_cycle_ms", 0.0) or 0.0)
    if measured_cycle > cycle:
        # a measured cycle can only RAISE the floor (it includes host
        # work the analytic terms missed), never lower it below the
        # modeled device+dispatch legs
        cycle = measured_cycle
    capacity = batch * 1e3 / cycle if cycle > 0 else float("inf")
    arrival = max(0.0, float(obs.get("arrival_rps", 0.0) or 0.0))
    rho = arrival / capacity if capacity > 0 else float("inf")
    if rho < 0.999:
        q_mean = cycle * rho / (2.0 * (1.0 - rho))
    else:
        q_mean = float("inf")
    q_p99 = q_mean * float(c["p99_queue_factor"]) if q_mean != float(
        "inf") else float("inf")
    if depth > 0:
        # the admission bound caps how much latency the pool can hold:
        # a full pool drains in depth/batch cycles, anything beyond
        # sheds at the door instead of queueing
        q_cap = (float(depth) / batch + 1.0) * cycle
        q_mean = min(q_mean, 0.5 * q_cap)
        q_p99 = min(q_p99, q_cap)
    residual = float(c["residual_cycle_factor"]) * cycle
    if arrival > 0:
        fill_wait = min(linger, (batch - 1) * 1e3 / arrival)
    else:
        fill_wait = linger
    mean_ms = fill_wait + residual + q_mean + cycle
    p99_ms = fill_wait + residual + q_p99 + cycle
    shed = max(0.0, 1.0 - 1.0 / rho) if rho > 1.0 else 0.0

    def r(v):
        return round(v, 3) if v != float("inf") else v

    return {
        "p99_ms": r(p99_ms),
        "mean_ms": r(mean_ms),
        "queue_p99_ms": r(q_p99 + residual),
        "cycle_ms": r(cycle),
        "capacity_rps": r(capacity),
        "utilization": round(rho, 4) if rho != float("inf") else rho,
        "shed_fraction": round(shed, 4),
    }


def slo_optimal_batch(config: Dict, slo_ms: float,
                      constants: Optional[Dict] = None) -> Optional[int]:
    """The statically modeled optimum for an SLO-bound server: the
    LARGEST candidate batch whose zero-load latency floor still fits
    ``slo_ms`` — maximum capacity headroom that cannot itself breach
    the SLO.  None when no candidate fits (the SLO is infeasible at
    every batch — NNST950's condition)."""
    best = None
    for b in SERVE_BATCH_CANDIDATES:
        pred = predict_latency(dict(config, serve_batch=b),
                               {"arrival_rps": 0.0}, constants)
        if pred["p99_ms"] <= float(slo_ms):
            best = b
    return best
