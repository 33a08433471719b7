"""Pipeline tracing (counterpart of the JAX package's ``trace.py``):
per-element proctime / interlatency / framerate, link crossings, parked
time per edge, fault counts, plus the nntrace *span* layer: per-buffer
begin/end spans across the whole dataflow, recorded into a bounded
flight-recorder ring and exportable as Chrome trace-event JSON (loadable
in Perfetto / chrome://tracing).

Reference counterpart: SURVEY.md §5 — the reference has no in-tree tracer
and points users at GstShark (proctime/interlatency/framerate tracers,
tools/tracing/README.md) plus per-filter invoke statistics
(tensor_filter.c:366-478). Attach a Tracer to a pipeline and every
element chain() is timed (proctime), buffer arrival gaps become
interlatency/framerate, and the report aggregates p50/p95. Device-side
profiling goes through :func:`torch_profile` (``torch.profiler`` with CPU
and CUDA activities, written as a Chrome trace).

Span tracing is OPT-IN (``NNSTPU_TRACE_SPANS=1`` or
``attach(pipeline, spans=True)``): the aggregate counters stay always-on
and cheap, while spans pay a per-hop record into the ring and one output
sync every few invokes (to split dispatch from device compute).
:meth:`Tracer.host_stack_report` names where host time per batch goes;
:meth:`Tracer.element_self_ms` splits the chain spans' self time by
element.

The serving tier's records (``serving()``: admission, shed, batch fill,
pool wait, replies; the ``serving_wait_us`` and ``request_rtt_us``
histograms), the nntrace-x request records (``tracex_report``,
``clock_samples``) and the serving controller's decision log
(``ctl_report``) are the JAX tracer's, under its keys and counter names,
as are the compile cache's outcome records (``record_aot``,
``aot_report``; filters/aot.py) and the rollout canary's decisions
(``record_rollout``, ``rollout_report``; elements/filter.py).
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import threading
import time
from collections import defaultdict, deque
from typing import Dict, List, Optional

from nnstreamer_tpu_torch.analysis import lockwitness

__all__ = ["Tracer", "SpanRing", "attach", "torch_profile",
           "validate_chrome_trace", "metrics_text", "merge_chrome_traces"]

#: env opt-in for span tracing (pipelines auto-attach a span-enabled
#: tracer at PLAYING when set and no tracer is attached yet)
SPAN_ENV = "NNSTPU_TRACE_SPANS"
#: env override for the flight-recorder capacity (spans, not events)
SPAN_CAP_ENV = "NNSTPU_TRACE_SPAN_CAP"


class _Series:
    __slots__ = ("values", "count", "total", "vmax", "_stride")

    def __init__(self):
        self.values: List[float] = []
        self.count = 0
        self.total = 0.0  # exact running sum (mean/total never truncate)
        self.vmax = 0.0
        # deterministic-stride reservoir: when the buffer fills, every
        # other kept sample is dropped and the stride doubles, so the
        # kept set always spans the WHOLE run at uniform spacing. The
        # old first-4096 reservoir froze percentiles on warmup (compile
        # invokes included) — a long run's p95 never saw late samples.
        self._stride = 1

    def add(self, v: float, keep: int = 4096) -> None:
        self.count += 1
        self.total += v
        if v > self.vmax:
            self.vmax = v
        if (self.count - 1) % self._stride == 0:
            self.values.append(v)
            if len(self.values) >= keep:
                self.values = self.values[::2]
                self._stride *= 2

    def stats(self) -> Dict[str, float]:
        if not self.values:
            return {"count": 0}
        import math

        vs = sorted(self.values)
        n = len(vs)
        # mean/max cover the WHOLE run (running aggregates); percentiles
        # come from the first-4096 reservoir — consistent nearest-rank
        # (floor for p50, ceil for p95) so p50 <= p95 for any n
        return {
            "count": self.count,
            "mean_us": self.total / self.count * 1e6,
            "p50_us": vs[int(0.5 * (n - 1))] * 1e6,
            "p95_us": vs[math.ceil(0.95 * (n - 1))] * 1e6,
            "max_us": self.vmax * 1e6,
        }

    def stats_raw(self) -> Dict[str, float]:
        """Unscaled stats for series that aren't durations (queue depths,
        fill counts): same reservoir percentiles, no µs conversion."""
        if not self.values:
            return {"count": 0}
        import math

        vs = sorted(self.values)
        n = len(vs)
        return {
            "count": self.count,
            "mean": self.total / self.count,
            "p50": vs[int(0.5 * (n - 1))],
            "p95": vs[math.ceil(0.95 * (n - 1))],
            "max": self.vmax,
        }


#: fixed log-bucket boundaries for the metrics endpoint, µs (powers of
#: two, 1 µs … ~67 s, +Inf overflow). FIXED by contract: time-series
#: snapshots and cross-run diffs compare bucket-to-bucket without
#: rebinning, and the Prometheus text renders the same `le` labels on
#: every host.
HIST_LE_US = tuple(float(1 << k) for k in range(27))


class _Hist:
    """Fixed-log-bucket latency histogram (see :data:`HIST_LE_US`).

    ``exemplars`` keeps, per bucket, the LAST trace_id whose sample
    landed there (nntrace-x): the metrics endpoint attaches them to the
    latency buckets so a scraper alert on a high bucket comes with a
    concrete request to pull up in ``doctor --trace-request``."""

    __slots__ = ("counts", "count", "sum_us", "exemplars")

    def __init__(self):
        self.counts = [0] * (len(HIST_LE_US) + 1)  # +Inf tail
        self.count = 0
        self.sum_us = 0.0
        self.exemplars: Dict[int, tuple] = {}  # bucket -> (trace_id, us)

    def add(self, seconds: float, trace_id: Optional[str] = None) -> None:
        us = seconds * 1e6
        self.count += 1
        self.sum_us += us
        # ceil BEFORE bucketing: 1.5 µs belongs in le=2, not le=1 — a
        # truncated fraction would put every (2^k, 2^k+1) sample one
        # bucket low and break the Prometheus `le` contract
        n = -int(-us // 1)
        i = (n - 1).bit_length() if n > 1 else 0  # smallest k: us <= 2^k
        if i >= len(HIST_LE_US):
            i = len(HIST_LE_US)
        self.counts[i] += 1
        if trace_id:
            self.exemplars[i] = (str(trace_id), round(us, 1))

    def merge(self, other: "_Hist") -> "_Hist":
        self.count += other.count
        self.sum_us += other.sum_us
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.exemplars.update(other.exemplars)
        return self

    def quantile_us(self, q: float) -> float:
        """Upper bucket boundary at quantile ``q`` (conservative)."""
        if not self.count:
            return 0.0
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= target:
                return HIST_LE_US[i] if i < len(HIST_LE_US) else float("inf")
        return float("inf")

    def to_dict(self) -> Dict:
        d = {"counts": list(self.counts), "count": self.count,
             "sum_us": round(self.sum_us, 1)}
        if self.exemplars:
            # JSON object keys are strings; metrics_text re-indexes
            d["exemplars"] = {str(i): [tid, us]
                              for i, (tid, us) in self.exemplars.items()}
        return d


class SpanRing:
    """Bounded flight-recorder of completed spans (the nntrace span layer).

    Each record is one finished span: ``(track, name, cat, t0, t1, args,
    aid)`` with perf_counter stamps. Sync spans (``aid`` None) follow the
    emitting call stack, so per track they are properly nested — they
    export as Chrome ``B``/``E`` pairs. Cross-thread waits (queue
    residency, serving pool wait) overlap freely, so they carry an async
    id and export as ``b``/``e`` async pairs. The ring is bounded
    (:data:`SPAN_CAP_ENV`, default 65536 spans): under sustained load it
    keeps the most recent window — a flight recorder, not a log."""

    def __init__(self, cap: Optional[int] = None):
        if cap is None:
            cap = int(os.environ.get(SPAN_CAP_ENV, "") or 65536)
        self.cap = int(cap)
        self._records: deque = deque(maxlen=self.cap)
        self._emitted = 0
        self._lock = lockwitness.make_lock("trace.spanring")
        self.epoch = time.perf_counter()
        # wall-clock anchor for the monotonic epoch: exported in the trace
        # metadata so device-side captures (``torch_profile``, which
        # stamps in its own clock) can be aligned with these host spans
        self.epoch_unix = time.time()

    def emit(self, name: str, cat: str, t0: float, t1: float,
             track: Optional[str] = None, args: Optional[Dict] = None,
             aid=None) -> None:
        """Record one finished span [t0, t1] (perf_counter seconds).
        ``track`` defaults to the current thread's name (one timeline row
        per streaming thread); virtual tracks (``device:<filter>``,
        ``queue:<name>``, ``serving:<id>``) are named explicitly."""
        if track is None:
            track = threading.current_thread().name
        if t1 < t0:
            t1 = t0
        with self._lock:
            self._emitted += 1
            self._records.append((track, name, cat, t0, t1, args, aid))

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self._emitted = 0

    def records(self) -> List[tuple]:
        with self._lock:
            return list(self._records)

    @property
    def dropped(self) -> int:
        """Spans evicted by the bounded ring (flight-recorder wraparound)."""
        with self._lock:
            return max(0, self._emitted - len(self._records))

    def chrome_trace(self) -> Dict:
        """Chrome trace-event JSON (Perfetto-loadable): sorted ``B``/``E``
        (and async ``b``/``e``) events, one ``tid`` per track with
        ``thread_name`` metadata, timestamps in µs from the ring epoch."""
        recs = self.records()
        dropped = self.dropped
        pid = os.getpid()
        tids: Dict[str, int] = {}
        sortable = []
        for track, name, cat, t0, t1, args, aid in recs:
            tid = tids.setdefault(track, len(tids) + 1)
            ts0 = max(0.0, (t0 - self.epoch) * 1e6)
            ts1 = max(ts0, (t1 - self.epoch) * 1e6)
            if ts1 <= ts0:
                # zero-duration span (sync or async): a begin/end pair at
                # one timestamp would sort end-before-begin (ends close
                # before begins at ts ties) and fail the validator's
                # pairing checks — export as a complete event instead
                x = {"name": name, "cat": cat, "ph": "X", "ts": ts0,
                     "dur": 0, "pid": pid, "tid": tid}
                if args or aid is not None:
                    x["args"] = dict(args or {})
                    if aid is not None:
                        x["args"]["id"] = str(aid)
                sortable.append(((ts0, 1, 0.0), x))
                continue
            b = {"name": name, "cat": cat, "ph": "B" if aid is None else "b",
                 "ts": ts0, "pid": pid, "tid": tid}
            e = {"name": name, "cat": cat, "ph": "E" if aid is None else "e",
                 "ts": ts1, "pid": pid, "tid": tid}
            if args:
                b["args"] = dict(args)
            if aid is not None:
                b["id"] = e["id"] = str(aid)
            # sort keys guarantee proper nesting at equal timestamps:
            # ends before begins; of two begins the longer span opens
            # first; of two ends the inner (later-begun) closes first
            sortable.append(((ts0, 1, -ts1), b))
            sortable.append(((ts1, 0, -ts0), e))
        sortable.sort(key=lambda kv: kv[0])
        meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                 "args": {"name": "nnstreamer_tpu_torch"}}]
        for track, tid in sorted(tids.items(), key=lambda kv: kv[1]):
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tid, "args": {"name": track}})
        return {
            "traceEvents": meta + [ev for _, ev in sortable],
            "displayTimeUnit": "ms",
            "otherData": {
                "monotonic_epoch_unix_s": round(self.epoch_unix, 6),
                # the ring epoch in RAW perf_counter ns: what lets
                # merge_chrome_traces map an ntp-estimated clock offset
                # (also perf_counter ns) onto these relative timestamps
                "epoch_perf_ns": int(self.epoch * 1e9),
                "spans": len(recs),
                "dropped_spans": dropped,
            },
        }


class Tracer:
    """Collects per-element timing; attach via ``trace.attach(pipeline)``."""

    def __init__(self, spans: bool = False):
        self._proc: Dict[str, _Series] = defaultdict(_Series)
        self._gap: Dict[str, _Series] = defaultdict(_Series)
        self._last_in: Dict[str, float] = {}
        self._src_lat: Dict[str, _Series] = defaultdict(_Series)
        self._residency: Dict[str, _Series] = defaultdict(_Series)
        # fault-domain events: {element: {kind: count}} — degradation must
        # be visible, never silent (watchdog trips, backend fallback,
        # policy drops/retries/restarts)
        self._faults: Dict[str, Dict[str, int]] = defaultdict(
            lambda: defaultdict(int))
        # link-crossing counters: every host→device upload and device→host
        # materialization attributed to its element, with the bytes each
        # moved — tests and chip_smoke.py assert the COUNT (one upload per
        # batch, one fetch per window) instead of inferring it from timing
        self._crossings: Dict[str, int] = {"h2d": 0, "d2h": 0,
                                           "h2d_bytes": 0, "d2h_bytes": 0}
        self._crossings_el: Dict[str, Dict[str, int]] = defaultdict(
            lambda: {"h2d": 0, "d2h": 0, "h2d_bytes": 0, "d2h_bytes": 0})
        # fusion-planner decisions: {element: "fused-into:<filter>"}
        self._fusion: Dict[str, str] = {}
        # nntrace span flight-recorder (None = spans off; every span site
        # gates on one attribute read). Aggregate counters above stay on
        # either way.
        self.spans: Optional[SpanRing] = SpanRing() if spans else None
        # metrics endpoint: fixed-log-bucket latency histograms — per
        # element (proctime) and per serving (server, tenant) pool wait —
        # always-on (one bit_length + two adds per sample), rendered as
        # Prometheus text by metrics_text()
        self._hist: Dict[str, _Hist] = defaultdict(_Hist)
        self._hist_serving: Dict[str, _Hist] = defaultdict(_Hist)
        # serving controller decisions, keyed by query-server id: bounded
        # per-server decision ring + latest knob values
        self._ctl_log: Dict[str, dict] = {}
        # compile-cache outcomes, keyed by element: bounded per-element
        # event ring (hit/miss/prefetch with load vs compile milliseconds)
        # + running counters — the warm-start audit trail `doctor --aot`
        # renders; elements drain the backend's observer events here
        self._aot_log: Dict[str, dict] = {}
        # rollout decisions, keyed by element: bounded ring of canary
        # outcomes (promoted / rolled-back with the observed fault delta
        # and admitted-p99) — the audit trail `doctor --rollout` renders;
        # stays empty (and absent from reports) when no rollout ever ran,
        # so default reports are byte-identical
        self._rollout_log: Dict[str, dict] = {}
        # serving-tier stats, keyed by the query-server id both serversrc
        # and serversink share: queue depth / time-in-queue series,
        # batch fill, shed counts and per-tenant goodput
        self._serving: Dict[str, dict] = {}
        # nntrace-x cross-process request records (client side): bounded
        # recent window + tail-retained exemplars (the slowest requests
        # and every shed survive the window rolling over), per-component
        # series, clock samples for trace stitching, and a per-peer RTT
        # histogram
        self._tracex = {
            "recent": deque(maxlen=256),
            "slow": [],  # heap of (rtt_ms, seq, record) — top-N retained
            "shed": deque(maxlen=128),
            "clock_samples": deque(maxlen=256),
            "components": defaultdict(_Series),
            "count": 0,
            "shed_count": 0,
        }
        self._hist_rpc: Dict[str, _Hist] = defaultdict(_Hist)
        # periodic metrics snapshots (time-series, not just end-of-run).
        # The ring is bounded: evictions are COUNTED (dropped_snapshots
        # in the series envelope) so a consumer can tell a quiet period
        # from an evicted one.
        self._metrics_series: deque = deque(maxlen=1024)
        self._series_dropped = 0
        self._t_start = time.monotonic()
        self._sampler: Optional[threading.Thread] = None
        self._sampler_stop: Optional[threading.Event] = None
        self._lock = lockwitness.make_lock("trace.tracer")

    def _serving_entry(self, server: str) -> dict:
        s = self._serving.get(server)
        if s is None:
            s = self._serving[server] = {
                "enqueued": 0, "shed": 0, "batches": 0, "rows": 0,
                "padded_rows": 0, "replies": 0, "reply_drops": 0,
                "depth": _Series(), "wait": _Series(), "fill": _Series(),
                "shed_reasons": defaultdict(int),
                "tenants": defaultdict(lambda: {
                    "enqueued": 0, "shed": 0, "replies": 0,
                    "t_first": None, "t_last": None}),
                # nnpool per-replica dispatch counters — empty (and absent
                # from reports) on replicas=off servers
                "replicas": defaultdict(int),
            }
        return s

    def enable_spans(self, cap: Optional[int] = None) -> SpanRing:
        """Turn the span flight-recorder on (idempotent)."""
        if self.spans is None:
            self.spans = SpanRing(cap)
        return self.spans

    def reset_spans(self) -> None:
        """Drop recorded spans (e.g. after warmup, so the attribution
        window excludes compile)."""
        if self.spans is not None:
            self.spans.clear()

    # called from Element._chain_guard (hot path — keep it lean)
    def record_chain(self, element_name: str, t0: float, t1: float) -> None:
        with self._lock:
            self._proc[element_name].add(t1 - t0)
            self._hist[element_name].add(t1 - t0)
            last = self._last_in.get(element_name)
            if last is not None:
                self._gap[element_name].add(t0 - last)
            self._last_in[element_name] = t0

    def record_interlatency(self, element_name: str, seconds: float) -> None:
        """Source-origin → this element's chain start (the GstShark
        *interlatency* tracer role): how old a buffer already is when
        each element first touches it. The stamp is set at the first
        traced chain the buffer enters (the source edge); elements that
        REWRAP buffers restart the clock there — the report shows latency
        accumulated since the last rewrap, which for the standard
        elements (converter/filter preserve the stamp) is the source."""
        with self._lock:
            self._src_lat[element_name].add(seconds)

    def record_residency(self, edge: str, seconds: float) -> None:
        """Time a buffer spent parked BETWEEN two chains on a named edge:
        a queue's bounded buffer (``queue:<name>``), a filter's held
        fetch window (``fetch-window:<name>``), or its in-flight upload
        window (``upload-window:<name>``, feed-depth holds). This is
        where pipeline p50 hides when per-element proctime looks
        innocent — VERDICT r4 found 125 ms of e2e that no chain owned."""
        with self._lock:
            self._residency[edge].add(seconds)

    def record_fault(self, element_name: str, kind: str) -> None:
        """Count a fault-domain event against its element: ``watchdog-trip``,
        ``fallback``, and the error-policy actions (``drop`` / ``retry`` /
        ``restart`` / ``abort``). Surfaced in :meth:`report` under
        ``faults`` so a degraded run is visible in the same artifact as
        its timings."""
        with self._lock:
            self._faults[element_name][kind] += 1

    def faults(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {el: dict(kinds) for el, kinds in self._faults.items()}

    def record_crossing(self, element_name: str, direction: str,
                        n: int = 1, nbytes: int = 0,
                        devices: int = 1) -> None:
        """Count ``n`` link crossings (``h2d`` uploads / ``d2h``
        materializations) against an element. One pipelined transfer of
        many arrays counts ONCE — the unit is a round trip on the link,
        which is what RTT-bound tunnels bill for, not array count.
        ``nbytes`` is the payload the crossing moved (every
        device_put/device_get call site threads it here); byte totals
        accumulate independently of the count so a pipelined many-array
        fetch reports one crossing carrying the sum of its arrays.
        ``devices`` > 1 marks a mesh-sharded transfer (nnshard): the
        payload splits evenly across that many shards, so the
        per-DEVICE bytes (``<dir>_bytes_per_device``) accumulate at
        nbytes/devices — banked only for sharded crossings, so
        unsharded reports stay byte-identical."""
        with self._lock:
            self._crossings[direction] += n
            self._crossings[direction + "_bytes"] += int(nbytes)
            el = self._crossings_el[element_name]
            el[direction] += n
            el[direction + "_bytes"] += int(nbytes)
            if devices > 1:
                key = direction + "_bytes_per_device"
                el[key] = el.get(key, 0) + int(nbytes) // int(devices)

    def crossings(self) -> Dict:
        """{"h2d": N, "d2h": M, "h2d_bytes": B, "d2h_bytes": B',
        "per_element": {el: {"h2d": n, "d2h": m, "h2d_bytes": b,
        "d2h_bytes": b'}}} — count AND bytes per direction per element."""
        with self._lock:
            return {
                "h2d": self._crossings["h2d"],
                "d2h": self._crossings["d2h"],
                "h2d_bytes": self._crossings["h2d_bytes"],
                "d2h_bytes": self._crossings["d2h_bytes"],
                "per_element": {el: dict(c)
                                for el, c in self._crossings_el.items()},
            }


    # -- serving tier (nnserve) --------------------------------------------
    def record_serving_enqueue(self, server: str, tenant: str,
                               depth: int) -> None:
        """One request admitted into the serving pool; ``depth`` is the
        pool's total waiting count AFTER the enqueue (queue-depth
        series)."""
        with self._lock:
            s = self._serving_entry(server)
            s["enqueued"] += 1
            s["depth"].add(float(depth))
            s["tenants"][tenant]["enqueued"] += 1

    def record_serving_shed(self, server: str, tenant: str,
                            reason: str) -> None:
        """One request shed with SERVER_BUSY (queue-full / rate-limited /
        unbatchable / draining)."""
        with self._lock:
            s = self._serving_entry(server)
            s["shed"] += 1
            s["shed_reasons"][reason] += 1
            s["tenants"][tenant]["shed"] += 1

    def record_serving_batch(self, server: str, fill: int,
                             batch: int) -> None:
        """One micro-batch assembled: ``fill`` valid rows padded to
        ``batch`` (the fill series is the batch-fill ratio numerator)."""
        with self._lock:
            s = self._serving_entry(server)
            s["batches"] += 1
            s["rows"] += int(fill)
            s["padded_rows"] += max(0, int(batch) - int(fill))
            s["fill"].add(float(fill))

    def record_serving_wait(self, server: str, seconds: float,
                            tenant: str = "_default",
                            trace_id: Optional[str] = None) -> None:
        """Time one request spent in the admission pool before its batch
        assembled (time-in-queue — where overload latency lives). Also
        feeds the per-(server, tenant) metrics-endpoint histogram;
        ``trace_id`` (nntrace-x sampled requests) becomes the bucket's
        exemplar in the Prometheus text."""
        with self._lock:
            self._serving_entry(server)["wait"].add(seconds)
            self._hist_serving[f"{server}|{tenant}"].add(seconds, trace_id)

    def record_serving_reply(self, server: str, tenant: str) -> None:
        """One reply routed back to its client (the goodput numerator;
        per-tenant rates derive from first/last reply stamps)."""
        now = time.monotonic()
        with self._lock:
            s = self._serving_entry(server)
            s["replies"] += 1
            t = s["tenants"][tenant]
            t["replies"] += 1
            if t["t_first"] is None:
                t["t_first"] = now
            t["t_last"] = now

    def record_serving_replica(self, server: str, replica: int) -> None:
        """One serve-batch dispatched to replica ``replica`` (the nnpool
        least-loaded decision) — the per-replica load split."""
        with self._lock:
            self._serving_entry(server)["replicas"][int(replica)] += 1

    def record_serving_reply_drop(self, server: str) -> None:
        """A reply could not be delivered (client gone) — the serversink
        drop counter the fault record mirrors."""
        with self._lock:
            self._serving_entry(server)["reply_drops"] += 1

    # -- nntrace-x: cross-process request traces (client side) -------------
    #: slowest-request exemplars retained past the recent window
    TRACEX_SLOW_KEEP = 16

    def record_request_trace(self, peer: str, record: Dict,
                             sample=None) -> None:
        """One sampled request's client-observed decomposition (the
        :func:`nnstreamer_tpu_torch.edge.tracex.decompose` dict: rtt_ms,
        network/queue/batch/device/reply components, optional shed
        reason). ``peer`` labels the server (host:port) in the RTT
        histogram; ``sample`` is the request's (t1,t2,t3,t4) clock
        sample, banked for offline trace stitching. Head sampling bounds
        how many requests get here; tail retention keeps the slow and
        shed ones after the recent window rolls."""
        import heapq

        rec = dict(record)
        rec["peer"] = peer
        with self._lock:
            tx = self._tracex
            tx["count"] += 1
            tx["recent"].append(rec)
            if sample is not None:
                tx["clock_samples"].append(tuple(int(v) for v in sample))
            rtt = float(rec.get("rtt_ms", 0.0))
            if rec.get("shed"):
                tx["shed_count"] += 1
                tx["shed"].append(rec)
            else:
                for k, v in rec.items():
                    if k.endswith("_ms") and isinstance(v, (int, float)):
                        tx["components"][k].add(float(v))
                heapq.heappush(tx["slow"], (rtt, tx["count"], rec))
                if len(tx["slow"]) > self.TRACEX_SLOW_KEEP:
                    heapq.heappop(tx["slow"])  # evict the fastest
            if rtt > 0:
                self._hist_rpc[peer].add(rtt / 1e3, rec.get("trace_id"))

    def clock_samples(self) -> List[tuple]:
        """Banked (t1, t2, t3, t4) ns samples — the offset-estimation
        input :func:`merge_chrome_traces` uses to stitch this process's
        trace with its peer's."""
        with self._lock:
            return list(self._tracex["clock_samples"])

    def tracex_report(self) -> Dict:
        """The ``trace_x`` report section: per-component latency stats
        over the sampled admitted requests, plus the retained slow/shed
        exemplars (each carrying its trace_id — the handle
        ``doctor --trace-request`` looks up in a merged trace)."""
        with self._lock:
            tx = self._tracex
            slow = [r for _, _, r in sorted(tx["slow"], reverse=True)]
            return {
                "sampled": tx["count"],
                "shed_sampled": tx["shed_count"],
                "components_ms": {k: s.stats_raw()
                                  for k, s in tx["components"].items()},
                "slow_exemplars": slow,
                "shed_exemplars": list(tx["shed"]),
                "recent": list(tx["recent"])[-32:],
            }

    def serving(self) -> Dict[str, dict]:
        """{server_id: {enqueued, shed, shed_reasons, batches, rows,
        padded_rows, batch_fill, replies, reply_drops, queue_depth,
        time_in_queue, per_tenant}} — plain dicts, safe to JSON."""
        with self._lock:
            out = {}
            for server, s in self._serving.items():
                tenants = {}
                for name, t in s["tenants"].items():
                    span = ((t["t_last"] - t["t_first"])
                            if t["t_first"] is not None else 0.0)
                    tenants[name] = {
                        "enqueued": t["enqueued"], "shed": t["shed"],
                        "replies": t["replies"],
                        "goodput_rps": round((t["replies"] - 1) / span, 2)
                        if span > 0 and t["replies"] > 1 else 0.0,
                    }
                out[server] = {
                    "enqueued": s["enqueued"], "shed": s["shed"],
                    "shed_reasons": dict(s["shed_reasons"]),
                    "batches": s["batches"], "rows": s["rows"],
                    "padded_rows": s["padded_rows"],
                    "batch_fill": round(s["rows"] / s["batches"], 3)
                    if s["batches"] else 0.0,
                    "replies": s["replies"],
                    "reply_drops": s["reply_drops"],
                    "queue_depth": s["depth"].stats_raw(),
                    "time_in_queue": s["wait"].stats(),
                    "per_tenant": tenants,
                }
                if s["replicas"]:
                    # nnpool only: replicas=off reports carry no key
                    out[server]["per_replica"] = {
                        str(r): {"batches": n}
                        for r, n in sorted(s["replicas"].items())}
            return out

    # -- nnctl: controller decisions ---------------------------------------
    #: per-server decision-ring bound (oldest evicted, evictions counted)
    CTL_DECISIONS_KEEP = 256

    def record_ctl_decision(self, server: str, decision: Dict) -> None:
        """One nnctl actuation: the decision dict (tick, rule, knob,
        before→after, reason, observed metrics) appended to the server's
        bounded ring; the latest knob values index the trajectory.
        Rendered by ``doctor --ctl`` from a saved report."""
        with self._lock:
            entry = self._ctl_log.get(server)
            if entry is None:
                entry = self._ctl_log[server] = {
                    "decisions": deque(maxlen=self.CTL_DECISIONS_KEEP),
                    "dropped_decisions": 0,
                    "knobs": {},
                }
            dq = entry["decisions"]
            if len(dq) == dq.maxlen:
                entry["dropped_decisions"] += 1
            dq.append(dict(decision))
            knob = decision.get("knob")
            if knob:
                entry["knobs"][str(knob)] = decision.get("after")

    def ctl_report(self) -> Dict[str, dict]:
        """The ``ctl`` report section: per-server decision log + latest
        knob values (plain dicts, safe to JSON)."""
        with self._lock:
            return {
                server: {
                    "decisions": list(e["decisions"]),
                    "dropped_decisions": e["dropped_decisions"],
                    "knobs": dict(e["knobs"]),
                }
                for server, e in self._ctl_log.items()
            }

    def top_residency(self, n: int = 3) -> List[Dict]:
        """The n worst edges by total parked time — the first place to
        look for a latency budget overrun (GstShark interlatency role,
        reference tools/tracing/README.md)."""
        with self._lock:
            rows = []
            for edge, s in self._residency.items():
                st = s.stats()
                if not st.get("count"):
                    continue
                st["edge"] = edge
                st["total_ms"] = round(s.total * 1e3, 3)  # exact sum
                rows.append(st)
        rows.sort(key=lambda r: r["total_ms"], reverse=True)
        return rows[:n]

    def record_fusion(self, element_name: str, filter_name: str) -> None:
        """The fusion planner folded ``element_name`` into
        ``filter_name``'s backend — the element is now a passthrough
        shell, visible here as ``fused-into:<filter>``."""
        with self._lock:
            self._fusion[element_name] = f"fused-into:{filter_name}"

    def fusions(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._fusion)

    AOT_EVENTS_KEEP = 128

    def record_aot(self, element: str, event: Dict) -> None:
        """One AOT cache outcome for ``element``: hit / miss-compiled /
        refused-budget / prefetch-* with the measured load vs compile
        milliseconds, appended to the element's bounded ring with
        running counters. Rendered by ``doctor --aot``."""
        with self._lock:
            entry = self._aot_log.get(element)
            if entry is None:
                entry = self._aot_log[element] = {
                    "events": deque(maxlen=self.AOT_EVENTS_KEEP),
                    "dropped_events": 0,
                    "hits": 0, "misses": 0, "refused": 0, "prefetch": 0,
                    "load_ms": 0.0, "compile_ms": 0.0,
                }
            dq = entry["events"]
            if len(dq) == dq.maxlen:
                entry["dropped_events"] += 1
            dq.append(dict(event))
            outcome = str(event.get("outcome", ""))
            if outcome == "hit":
                entry["hits"] += 1
            elif outcome == "refused-budget":
                entry["refused"] += 1
            elif outcome.startswith("prefetch"):
                entry["prefetch"] += 1
            elif outcome.startswith("miss"):
                entry["misses"] += 1
            entry["load_ms"] += float(event.get("load_ms", 0.0) or 0.0)
            entry["compile_ms"] += float(
                event.get("compile_ms", 0.0) or 0.0)

    def aot_report(self) -> Dict[str, dict]:
        """The ``aot`` report section: per-element cache outcomes —
        hit/miss/refused/prefetch counts, cumulative load vs compile
        milliseconds, and the bounded event ring (plain dicts, safe to
        JSON)."""
        with self._lock:
            return {
                el: {
                    "hits": e["hits"], "misses": e["misses"],
                    "refused": e["refused"], "prefetch": e["prefetch"],
                    "load_ms": round(e["load_ms"], 3),
                    "compile_ms": round(e["compile_ms"], 3),
                    "events": list(e["events"]),
                    "dropped_events": e["dropped_events"],
                }
                for el, e in self._aot_log.items()
            }

    ROLLOUT_EVENTS_KEEP = 64

    def record_rollout(self, element: str, event: Dict) -> None:
        """One nnfleet-r rollout decision for ``element``: started /
        promoted / rolled-back / regressed, with the candidate model, the
        canary window consumed, the fault-ledger delta and the observed
        admitted-p99 — appended to the element's bounded ring with
        running counters. Rendered by ``doctor --rollout``."""
        with self._lock:
            entry = self._rollout_log.get(element)
            if entry is None:
                entry = self._rollout_log[element] = {
                    "events": deque(maxlen=self.ROLLOUT_EVENTS_KEEP),
                    "dropped_events": 0,
                    "started": 0, "promoted": 0, "rolled_back": 0,
                }
            dq = entry["events"]
            if len(dq) == dq.maxlen:
                entry["dropped_events"] += 1
            dq.append(dict(event))
            decision = str(event.get("decision", ""))
            if decision == "started":
                entry["started"] += 1
            elif decision == "promoted":
                entry["promoted"] += 1
            elif decision == "rolled-back":
                entry["rolled_back"] += 1

    def rollout_report(self) -> Dict[str, dict]:
        """The ``rollout`` report section: per-element canary decisions —
        started/promoted/rolled-back counters plus the bounded event ring
        (plain dicts, safe to JSON)."""
        with self._lock:
            return {
                el: {
                    "started": e["started"], "promoted": e["promoted"],
                    "rolled_back": e["rolled_back"],
                    "events": list(e["events"]),
                    "dropped_events": e["dropped_events"],
                }
                for el, e in self._rollout_log.items()
            }

    def record_fusion(self, element_name: str, filter_name: str) -> None:
        """The fusion planner folded ``element_name`` into
        ``filter_name``'s XLA program — the element is now a passthrough
        shell, visible here as ``fused-into:<filter>``."""
        with self._lock:
            self._fusion[element_name] = f"fused-into:{filter_name}"

    def fusions(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._fusion)

    def top_residency(self, n: int = 3) -> List[Dict]:
        """The n worst edges by total parked time — the first place to
        look for a latency budget overrun (GstShark interlatency role,
        reference tools/tracing/README.md)."""
        with self._lock:
            rows = []
            for edge, s in self._residency.items():
                st = s.stats()
                if not st.get("count"):
                    continue
                st["edge"] = edge
                st["total_ms"] = round(s.total * 1e3, 3)  # exact sum
                rows.append(st)
        rows.sort(key=lambda r: r["total_ms"], reverse=True)
        return rows[:n]

    def report(self) -> Dict[str, Dict]:
        """{element: {proctime, interlatency (arrival gap), src_latency
        (source→element age), fps}} plus a ``residency`` map of parked
        time per queue/window edge."""
        out: Dict[str, Dict] = {}
        with self._lock:
            names = set(self._proc) | set(self._gap) | set(self._src_lat)
            for name in names:
                gaps = self._gap[name]
                entry = {
                    "proctime": self._proc[name].stats(),
                    "interlatency": gaps.stats(),
                }
                if name in self._src_lat:
                    entry["src_latency"] = self._src_lat[name].stats()
                if gaps.values:
                    mean_gap = statistics.fmean(gaps.values)
                    entry["fps"] = (1.0 / mean_gap) if mean_gap > 0 else 0.0
                out[name] = entry
            if self._residency:
                out["residency"] = {
                    edge: s.stats() for edge, s in self._residency.items()
                }
            if self._faults:
                out["faults"] = {
                    el: dict(kinds) for el, kinds in self._faults.items()
                }
            if self._crossings["h2d"] or self._crossings["d2h"]:
                out["crossings"] = {
                    "h2d": self._crossings["h2d"],
                    "d2h": self._crossings["d2h"],
                    "h2d_bytes": self._crossings["h2d_bytes"],
                    "d2h_bytes": self._crossings["d2h_bytes"],
                    "per_element": {el: dict(c)
                                    for el, c in self._crossings_el.items()},
                }
            if self._fusion:
                out["fusion"] = dict(self._fusion)
            if (self._hist or self._hist_serving or self._hist_rpc
                    or self._metrics_series):
                out["metrics"] = {
                    "histograms": {
                        "proctime_us": {el: h.to_dict()
                                        for el, h in self._hist.items()},
                        "serving_wait_us": {
                            key: h.to_dict()
                            for key, h in self._hist_serving.items()},
                        "request_rtt_us": {
                            peer: h.to_dict()
                            for peer, h in self._hist_rpc.items()},
                        "le_us": list(HIST_LE_US),
                    },
                    "series": list(self._metrics_series),
                    # ring evictions: a consumer can tell a quiet period
                    # (no snapshots) from an evicted one (counter > 0)
                    "dropped_snapshots": self._series_dropped,
                }
            tracex_any = self._tracex["count"] or self._tracex["shed_count"]
            ctl_any = bool(self._ctl_log)
            aot_any = bool(self._aot_log)
            rollout_any = bool(self._rollout_log)
        if self._serving:
            out["serving"] = self.serving()
        if ctl_any:
            out["ctl"] = self.ctl_report()
        if aot_any:
            out["aot"] = self.aot_report()
        if rollout_any:
            out["rollout"] = self.rollout_report()
        if tracex_any:
            out["trace_x"] = self.tracex_report()
        # lock observability: per-lock held/wait histograms on the
        # HIST_LE_US contract. Present ONLY when the lock witness recorded
        # something (sanitizer on + at least one witnessed acquisition) —
        # sanitizer-off reports stay byte-identical.
        locks = lockwitness.locks_report()
        if locks:
            out["locks"] = locks
        return out

    # -- metrics endpoint (histograms + time-series snapshots) -------------
    def metrics_text(self, openmetrics: bool = False) -> str:
        """Prometheus-style text exposition of the live counters (the
        same rendering ``doctor --metrics`` applies to a saved report).
        ``openmetrics=True`` switches to OpenMetrics (trailing ``# EOF``)
        and attaches the nntrace-x trace_id exemplars to the latency
        buckets — exemplar syntax is OpenMetrics-only, so the default
        classic exposition omits them (a 0.0.4 scraper would reject the
        whole page otherwise)."""
        return metrics_text(self.report(), openmetrics=openmetrics)

    def metrics_series(self) -> List[Dict]:
        with self._lock:
            return list(self._metrics_series)

    @property
    def dropped_snapshots(self) -> int:
        """Periodic-series snapshots evicted by the bounded ring."""
        with self._lock:
            return self._series_dropped

    def _metrics_snapshot(self) -> Dict:
        """One time-series sample: cumulative counts + histogram-derived
        percentiles per element and per serving pool, stamped relative to
        tracer start. Appended to the bounded series ring."""
        snap: Dict = {"t_s": round(time.monotonic() - self._t_start, 3)}
        with self._lock:
            if self._hist:
                snap["elements"] = {
                    el: {"count": h.count,
                         "p50_us": h.quantile_us(0.5),
                         "p99_us": h.quantile_us(0.99)}
                    for el, h in self._hist.items()}
            if self._serving:
                serving = {}
                for server, s in self._serving.items():
                    wait = _Hist()
                    for key, h in self._hist_serving.items():
                        if key.partition("|")[0] == server:
                            wait.merge(h)
                    serving[server] = {
                        "admitted": s["enqueued"], "shed": s["shed"],
                        "replies": s["replies"], "batches": s["batches"],
                        "batch_fill": round(s["rows"] / s["batches"], 3)
                        if s["batches"] else 0.0,
                        "wait_p99_ms": round(wait.quantile_us(0.99) / 1e3, 3),
                    }
                snap["serving"] = serving
            if self._ctl_log:
                # knob trajectory sample: the controller's current knob
                # values ride the periodic series
                snap["ctl"] = {server: dict(e["knobs"])
                               for server, e in self._ctl_log.items()}
            if len(self._metrics_series) == self._metrics_series.maxlen:
                self._series_dropped += 1
            self._metrics_series.append(snap)
        return snap

    def start_metrics_sampler(self, interval_s: float = 1.0) -> None:
        """Sample the metrics endpoint every ``interval_s`` DURING the run
        (a time series, not just an end-of-run snapshot). Bounded ring of
        1024 samples."""
        if self._sampler is not None:
            return
        import weakref

        stop = threading.Event()
        # the loop must NOT keep the tracer alive: a tracer orphaned with
        # its sampler running (pipeline torn down, attach(replace=True))
        # would otherwise be pinned forever by its own daemon thread —
        # via a weakref the thread exits when the tracer is collected
        ref = weakref.ref(self)

        def loop():
            while not stop.wait(interval_s):
                tracer = ref()
                if tracer is None:
                    return
                tracer._metrics_snapshot()
                del tracer

        t = threading.Thread(target=loop, daemon=True,
                             name="nntrace-metrics")
        self._sampler_stop = stop
        self._sampler = t
        t.start()

    def stop_metrics_sampler(self) -> None:
        if self._sampler is None:
            return
        self._sampler_stop.set()
        self._sampler.join(timeout=2.0)
        self._sampler = None
        self._sampler_stop = None
        self._metrics_snapshot()  # short runs still get >= 1 sample

    # -- span export & roll-up ---------------------------------------------
    def export_chrome_trace(self, path: Optional[str] = None) -> Dict:
        """Chrome trace-event JSON of the span flight-recorder (load in
        Perfetto). Writes to ``path`` when given; returns the dict."""
        if self.spans is None:
            raise RuntimeError(
                "span tracing is off — attach(pipeline, spans=True) or "
                f"{SPAN_ENV}=1")
        doc = self.spans.chrome_trace()
        samples = self.clock_samples()
        if samples:
            # ship the banked NTP-style samples with the trace so
            # merge_chrome_traces can stitch it against the peer's doc
            doc["otherData"]["clock_samples_ns"] = [list(s) for s in samples]
        if path:
            with open(path, "w", encoding="utf-8") as f:
                json.dump(doc, f)
        return doc

    #: span categories summed into the host-stack attribution (device
    #: compute, source produce, and serving waits are reported alongside,
    #: not inside — they overlap other threads' busy time)
    HOST_STACK_COMPONENTS = ("queue_wait", "python_dispatch",
                             "batching_padding", "fetch_plumbing",
                             "caps_meta_chain")

    def host_stack_report(self, batches: Optional[int] = None) -> Dict:
        """Roll the span ring up into a named decomposition of host-stack
        time per batch: where ``host_stack_ms_per_batch`` goes.

        Sync spans are attributed by SELF time (a chain span's nested
        dispatch/h2d/d2h/batch children are subtracted, so components
        never double-count); async waits (queue residency, serving pool
        wait) contribute their full parked duration. ``batches`` defaults
        to the number of recorded invoke dispatches. ``queue_wait`` is
        parked time on a thread boundary — it overlaps other threads'
        busy time, so in a multi-thread pipeline the component sum can
        legitimately exceed wall-derived host time."""
        if self.spans is None:
            raise RuntimeError(
                "span tracing is off — attach(pipeline, spans=True) or "
                f"{SPAN_ENV}=1")
        recs = self.spans.records()
        by_track: Dict[str, List[tuple]] = defaultdict(list)
        async_full: Dict[str, float] = defaultdict(float)
        counts: Dict[str, int] = defaultdict(int)
        for track, name, cat, t0, t1, args, aid in recs:
            counts[cat] += 1
            if aid is not None:
                async_full[cat] += t1 - t0
            else:
                by_track[track].append((t0, t1, cat, name, args))
        self_time: Dict[str, float] = defaultdict(float)
        # sync parks split by NAME: `device-sync` is the SAMPLED
        # per-invoke park (1 in NNSTPU_TRACE_SYNC_SAMPLE invokes pays
        # it — the per-frame dispatch-tax serialization the steady loop
        # deletes), `drain-sync` the boundary/window drain (device
        # compute finishing — paid once per flush whatever the mode).
        # Both are carved out of chain self time by category; the
        # device-sync total is SCALED by each span's recorded sample
        # rate so it estimates the every-invoke cost the sampling
        # avoided paying.  The estimate is an UPPER BOUND when device
        # work queues behind unsampled invokes (a sampled park then
        # also drains its predecessors' compute before being scaled) —
        # the raw unscaled parks ship alongside so a reader can tell;
        # on per-invoke-drained pipelines (a boundary materialization
        # each invoke, the common case) there is no backlog and the
        # estimate is unbiased.
        sync_named: Dict[str, float] = defaultdict(float)
        sync_raw: Dict[str, float] = defaultdict(float)
        for rs in by_track.values():
            rs.sort(key=lambda r: (r[0], -r[1]))
            stack: List[list] = []  # [t0, t1, child_sum, cat, name, args]

            def close(fin):
                self = max(0.0, (fin[1] - fin[0]) - fin[2])
                self_time[fin[3]] += self
                if fin[3] == "sync":
                    scale = float((fin[5] or {}).get("sync_sample", 1))
                    sync_named[fin[4]] += self * max(1.0, scale)
                    sync_raw[fin[4]] += self
                if stack:
                    stack[-1][2] += fin[1] - fin[0]

            for t0, t1, cat, name, args in rs:
                while stack and t0 >= stack[-1][1] - 1e-9:
                    close(stack.pop())
                stack.append([t0, t1, 0.0, cat, name, args])
            while stack:
                close(stack.pop())
        n = batches or counts.get("dispatch") or counts.get("chain") or 1

        def ms(seconds: float) -> float:
            return seconds / n * 1e3

        components = {
            "queue_wait": ms(async_full.get("queue", 0.0)),
            # backend-call dispatch plus the source's per-frame pad-push
            # plumbing (src-emit self time: what no chain span owns)
            "python_dispatch": ms(self_time.get("dispatch", 0.0)
                                  + self_time.get("emit", 0.0)),
            "batching_padding": ms(self_time.get("batch", 0.0)),
            "fetch_plumbing": ms(self_time.get("h2d", 0.0)
                                 + self_time.get("d2h", 0.0)),
            "caps_meta_chain": ms(self_time.get("chain", 0.0)),
        }
        return {
            "batches": n,
            "components_ms_per_batch": {k: round(v, 4)
                                        for k, v in components.items()},
            "host_stack_ms_per_batch": round(sum(components.values()), 4),
            "device_compute_ms_per_batch": round(
                ms(self_time.get("compute", 0.0)), 4),
            # the streaming thread's sync parks, split (see sync_named
            # above): carved OUT of the host components (they mirror
            # device time), but published so dispatch+sync amortization
            # — the steady-loop success metric — is a recorded number,
            # not an inference. device_sync is the sample-rate-SCALED
            # estimate of the every-invoke park; drain_sync is the
            # actual boundary/window drains paid.
            "device_sync_ms_per_batch": round(
                ms(sync_named.get("device-sync", 0.0)), 4),
            "device_sync_sampled_ms_per_batch": round(
                ms(sync_raw.get("device-sync", 0.0)), 4),
            "drain_sync_ms_per_batch": round(
                ms(sync_named.get("drain-sync", 0.0)), 4),
            # produce spans cover create() INCLUDING its wait for data, so
            # they overlap the feeder thread's busy time — reported beside
            # the host sum (like device compute), never inside it
            "source_produce_ms_per_batch": round(
                ms(self_time.get("source", 0.0)), 4),
            "serving_wait_ms_per_batch": round(
                ms(async_full.get("serving", 0.0)
                   + self_time.get("serving", 0.0)), 4),
            "span_counts": dict(counts),
            "dropped_spans": self.spans.dropped,
        }

    def element_self_ms(self, batches: int) -> Dict[str, float]:
        """Host milliseconds per batch that each element's chain spent in
        its OWN code: a chain span's duration less its nested downstream
        chains (elements called inline on the same thread, counted under
        their own names) and its ``sync`` children (the thread parked on
        the device), so the elements' times add up without counting
        anything twice. Its dispatch / h2d / d2h / batch children are its
        own work and stay in. Needs spans on."""
        if self.spans is None:
            raise RuntimeError(
                "span tracing is off — attach(pipeline, spans=True) or "
                f"{SPAN_ENV}=1")
        by_track: Dict[str, List[tuple]] = defaultdict(list)
        for track, name, cat, t0, t1, args, aid in self.spans.records():
            if aid is None:
                by_track[track].append((t0, t1, cat, name))
        own: Dict[str, float] = defaultdict(float)
        for rs in by_track.values():
            rs.sort(key=lambda r: (r[0], -r[1]))
            stack: List[list] = []  # [t0, t1, chain_child_sum, cat, name]

            def close(fin):
                if fin[3] == "chain":
                    own[fin[4]] += max(0.0, (fin[1] - fin[0]) - fin[2])
                if stack and (fin[3] in ("chain", "sync")):
                    # a nested chain is its own element's time, a sync the
                    # device's; any other child is the enclosing chain's
                    stack[-1][2] += fin[1] - fin[0]

            for t0, t1, cat, name in rs:
                while stack and t0 >= stack[-1][1] - 1e-9:
                    close(stack.pop())
                stack.append([t0, t1, 0.0, cat, name])
            while stack:
                close(stack.pop())
        n = max(1, int(batches))
        return {el: v / n * 1e3 for el, v in sorted(own.items())}

    def summary(self) -> str:
        lines = []
        for name, e in sorted(self.report().items()):
            if name in ("residency", "faults", "crossings", "fusion",
                        "metrics", "serving", "ctl", "trace_x"):
                continue
            pt = e["proctime"]
            fps = e.get("fps")
            lines.append(
                f"{name}: n={pt.get('count', 0)} "
                f"proctime p50={pt.get('p50_us', 0):.0f}us "
                f"p95={pt.get('p95_us', 0):.0f}us"
                + (f" fps={fps:.1f}" if fps else "")
            )
        for r in self.top_residency():
            lines.append(
                f"residency {r['edge']}: n={r['count']} "
                f"p50={r.get('p50_us', 0):.0f}us total={r['total_ms']:.1f}ms")
        return "\n".join(lines)


def attach(pipeline, spans: Optional[bool] = None,
           replace: bool = False) -> Tracer:
    """Enable tracing on a pipeline (before or during PLAYING).

    Idempotent: attaching to a pipeline that already has a tracer returns
    THE EXISTING tracer — accumulated stats/crossings survive — instead
    of silently replacing it; pass ``replace=True`` for a fresh one.
    ``spans=True`` opts into the per-buffer span flight-recorder
    (default: the ``NNSTPU_TRACE_SPANS`` env var decides; the aggregate
    counters are always on either way)."""
    if spans is None:
        spans = os.environ.get(SPAN_ENV, "") == "1"
    existing = getattr(pipeline, "tracer", None)
    if existing is not None and not replace:
        if spans:
            existing.enable_spans()
        return existing
    t = Tracer(spans=bool(spans))
    pipeline.tracer = t
    return t


def validate_chrome_trace(trace) -> List[str]:
    """Validate a Chrome trace-event document (dict, or a path to one)
    against the contract ci.sh gates on: required keys per event,
    per-track monotonic timestamps, properly nested matched ``B``/``E``
    pairs, and balanced async ``b``/``e`` pairs. Returns a list of
    problems — empty means valid."""
    if isinstance(trace, str):
        with open(trace, "r", encoding="utf-8") as f:
            trace = json.load(f)
    problems: List[str] = []
    events = trace.get("traceEvents") if isinstance(trace, dict) else None
    if not isinstance(events, list):
        return ["no traceEvents list"]
    last_ts: Dict = {}
    stacks: Dict = {}
    apending: Dict = defaultdict(int)
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        for key in ("name", "ph", "pid", "tid"):
            if key not in ev:
                problems.append(f"event {i}: missing {key!r}")
        ph = ev.get("ph")
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event {i}: bad ts {ts!r}")
            continue
        track = (ev.get("pid"), ev.get("tid"))
        if ts < last_ts.get(track, 0.0) - 1e-6:
            problems.append(f"event {i}: ts {ts} not monotonic on track "
                            f"{track}")
        last_ts[track] = max(ts, last_ts.get(track, 0.0))
        if ph == "B":
            stacks.setdefault(track, []).append(ev.get("name"))
        elif ph == "E":
            st = stacks.get(track)
            if not st:
                problems.append(f"event {i}: E without open B on {track}")
            elif st[-1] != ev.get("name"):
                problems.append(
                    f"event {i}: E {ev.get('name')!r} closes open "
                    f"B {st[-1]!r} on {track}")
            else:
                st.pop()
        elif ph == "b":
            apending[(ev.get("cat"), ev.get("id"), ev.get("name"))] += 1
        elif ph == "e":
            key = (ev.get("cat"), ev.get("id"), ev.get("name"))
            apending[key] -= 1
            if apending[key] < 0:
                problems.append(f"event {i}: async e without b ({key})")
    for track, st in stacks.items():
        if st:
            problems.append(f"unclosed B spans on {track}: {st}")
    for key, n in apending.items():
        if n > 0:
            problems.append(f"unclosed async span {key}")
    return problems


#: default clock-offset error bound past which merge_chrome_traces
#: refuses to rebase (the asymmetry bound exceeds what a per-request
#: waterfall could survive) and degrades to an unmerged-but-valid doc
MERGE_MAX_ERR_NS = 20_000_000


def merge_chrome_traces(client_doc, server_doc, samples=None,
                        max_err_ns: int = MERGE_MAX_ERR_NS) -> Dict:
    """Stitch a client and a server Chrome trace into ONE validated doc.

    The server's events are rebased into the client's timebase using an
    NTP-style offset estimate
    (:func:`nnstreamer_tpu_torch.edge.ntp.estimate_offset`) over
    ``samples`` — (t1,t2,t3,t4) perf_counter-ns exchanges, defaulting
    to the ``clock_samples_ns`` the client doc banked at export — mapped
    onto the docs' ``epoch_perf_ns`` ring anchors. The server process
    keeps its own pid (tracks stay separate; request identity lives in
    the ``trace_id`` span args), so one Perfetto load shows the client
    gap and the server stages on one timeline.

    When offset confidence is poor (no usable samples, or the
    asymmetry-proof error bound exceeds ``max_err_ns``), stitching
    DEGRADES instead of lying: the traces are combined un-rebased
    (``otherData.stitched`` false, reason recorded) — still a valid
    Chrome trace, just without cross-process time alignment. Raises
    ValueError only when the merged doc fails validation (malformed
    inputs)."""
    if isinstance(client_doc, str):
        with open(client_doc, "r", encoding="utf-8") as f:
            client_doc = json.load(f)
    if isinstance(server_doc, str):
        with open(server_doc, "r", encoding="utf-8") as f:
            server_doc = json.load(f)
    cod = client_doc.get("otherData") or {}
    sod = server_doc.get("otherData") or {}
    if samples is None:
        samples = cod.get("clock_samples_ns") or []
    from nnstreamer_tpu_torch.edge import ntp

    est = ntp.estimate_offset(tuple(s) for s in samples)
    reason = None
    if est is None:
        reason = "no usable clock samples"
    elif not est.good(max_err_ns):
        reason = (f"offset error bound {est.err_ns} ns > {max_err_ns} ns")
    elif "epoch_perf_ns" not in cod or "epoch_perf_ns" not in sod:
        reason = "trace docs carry no epoch_perf_ns anchor"
    stitched = reason is None
    cl_events = client_doc.get("traceEvents") or []
    sv_events = server_doc.get("traceEvents") or []
    cpids = {ev.get("pid") for ev in cl_events if isinstance(ev, dict)}
    spid = max((p for p in cpids if isinstance(p, int)), default=0) + 1
    delta_us = 0.0
    if stitched:
        delta_us = (sod["epoch_perf_ns"] + est.offset_ns
                    - cod["epoch_perf_ns"]) / 1e3
    # a negative rebased timestamp (server ring born before the client's)
    # shifts EVERY event right by the same amount — relative timing is
    # what the waterfall reads, and the validator requires ts >= 0
    shift = 0.0
    if stitched:
        smin = min((ev.get("ts", 0.0) + delta_us for ev in sv_events
                    if isinstance(ev, dict) and ev.get("ph") != "M"
                    and isinstance(ev.get("ts"), (int, float))),
                   default=0.0)
        shift = max(0.0, -min(0.0, smin))
    merged: List[Dict] = []
    for ev in cl_events:
        ev = dict(ev)
        if ev.get("ph") != "M" and isinstance(ev.get("ts"), (int, float)):
            ev["ts"] = ev["ts"] + shift
        merged.append(ev)
    for ev in sv_events:
        ev = dict(ev)
        ev["pid"] = spid
        if ev.get("ph") == "M":
            if ev.get("name") == "process_name":
                name = ((ev.get("args") or {}).get("name") or "peer")
                ev["args"] = {"name": f"{name} (server)"}
        elif isinstance(ev.get("ts"), (int, float)):
            ev["ts"] = ev["ts"] + (delta_us if stitched else 0.0) + shift
        merged.append(ev)
    doc = {
        "traceEvents": merged,
        "displayTimeUnit": "ms",
        "otherData": {
            "monotonic_epoch_unix_s": cod.get("monotonic_epoch_unix_s"),
            "stitched": stitched,
            "offset_ns": est.offset_ns if stitched else None,
            "offset_err_ns": est.err_ns if est is not None else None,
            "offset_samples": est.n_samples if est is not None else 0,
            "unstitched_reason": reason,
            "spans": (cod.get("spans") or 0) + (sod.get("spans") or 0),
            "dropped_spans": (cod.get("dropped_spans") or 0)
            + (sod.get("dropped_spans") or 0),
        },
    }
    problems = validate_chrome_trace(doc)
    if problems:
        raise ValueError(f"merged trace invalid: {problems[:5]}")
    return doc


#: method alias — ``Tracer.merge_traces(client_doc, server_doc)`` is the
#: documented entry point for stitching two process traces
Tracer.merge_traces = staticmethod(merge_chrome_traces)


def _prom_labels(labels: Dict[str, str]) -> str:
    # Prometheus exposition escaping — tenant labels are CLIENT-controlled
    # wire data (request meta), and one bad label value would make a
    # scraper reject the whole page, not just that series
    def esc(v) -> str:
        return (str(v).replace("\\", "\\\\").replace('"', '\\"')
                .replace("\n", "\\n"))

    inner = ",".join(f'{k}="{esc(v)}"' for k, v in labels.items())
    return "{" + inner + "}"


def metrics_text(report: Dict, openmetrics: bool = False) -> str:
    """Prometheus-style text exposition of a tracer report (live or
    loaded from a saved JSON artifact — ``doctor --metrics``): per-element
    proctime histograms, per-(server, tenant) serving wait and per-peer
    request-RTT histograms, crossing/shed/reply counters, batch-fill
    gauges. ``openmetrics=True`` emits OpenMetrics instead (terminating
    ``# EOF``) and attaches the banked nntrace-x trace_id exemplars to
    the latency buckets; the classic default leaves them out, because a
    Prometheus 0.0.4 parser treats anything after the value as a
    timestamp and would reject the whole page."""
    m = report.get("metrics") or {}
    hists = m.get("histograms") or {}
    le_us = hists.get("le_us") or list(HIST_LE_US)
    lines: List[str] = []

    def render_hist(metric: str, labels: Dict[str, str], h: Dict) -> None:
        counts = h.get("counts") or []
        exemplars = h.get("exemplars") or {} if openmetrics else {}
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            le = f"{le_us[i]:g}" if i < len(le_us) else "+Inf"
            line = (f"{metric}_bucket"
                    + _prom_labels(dict(labels, le=le)) + f" {cum}")
            ex = exemplars.get(str(i)) or exemplars.get(i)
            if ex:
                # OpenMetrics exemplar: the trace_id of a request that
                # landed in this bucket — what turns a p99 alert into a
                # `doctor --trace-request <id>` waterfall. trace ids are
                # wire data, so they go through the same label escaping.
                tid, val = (ex[0], ex[1]) if isinstance(
                    ex, (list, tuple)) else (ex, 0)
                line += (" # " + _prom_labels({"trace_id": tid})
                         + f" {val}")
            lines.append(line)
        lines.append(f"{metric}_count" + _prom_labels(labels)
                     + f" {h.get('count', 0)}")
        lines.append(f"{metric}_sum" + _prom_labels(labels)
                     + f" {h.get('sum_us', 0)}")

    proc = hists.get("proctime_us") or {}
    if proc:
        lines.append("# TYPE nnstpu_proctime_us histogram")
        for el in sorted(proc):
            render_hist("nnstpu_proctime_us", {"element": el}, proc[el])
    sw = hists.get("serving_wait_us") or {}
    if sw:
        lines.append("# TYPE nnstpu_serving_wait_us histogram")
        for key in sorted(sw):
            server, _, tenant = key.partition("|")
            render_hist("nnstpu_serving_wait_us",
                        {"server": server, "tenant": tenant or "_default"},
                        sw[key])
    rtt = hists.get("request_rtt_us") or {}
    if rtt:
        lines.append("# TYPE nnstpu_request_rtt_us histogram")
        for peer in sorted(rtt):
            render_hist("nnstpu_request_rtt_us", {"peer": peer}, rtt[peer])
    cr = report.get("crossings") or {}
    per_el = cr.get("per_element") or {}
    if per_el:
        lines.append("# TYPE nnstpu_crossings_total counter")
        for el in sorted(per_el):
            for d in ("h2d", "d2h"):
                lines.append(
                    "nnstpu_crossings_total"
                    + _prom_labels({"element": el, "direction": d})
                    + f" {per_el[el].get(d, 0)}")
                lines.append(
                    "nnstpu_crossing_bytes_total"
                    + _prom_labels({"element": el, "direction": d})
                    + f" {per_el[el].get(d + '_bytes', 0)}")
    serving = report.get("serving") or {}
    if serving:
        lines.append("# TYPE nnstpu_serving_requests_total counter")
        for server in sorted(serving):
            s = serving[server]
            lab = {"server": server}
            lines.append("nnstpu_serving_admitted_total"
                         + _prom_labels(lab) + f" {s.get('enqueued', 0)}")
            lines.append("nnstpu_serving_replies_total"
                         + _prom_labels(lab) + f" {s.get('replies', 0)}")
            lines.append("nnstpu_serving_batch_fill"
                         + _prom_labels(lab) + f" {s.get('batch_fill', 0.0)}")
            for reason, n in sorted((s.get("shed_reasons") or {}).items()):
                lines.append(
                    "nnstpu_serving_shed_total"
                    + _prom_labels(dict(lab, reason=reason)) + f" {n}")
            for tenant, t in sorted((s.get("per_tenant") or {}).items()):
                lines.append(
                    "nnstpu_serving_tenant_replies_total"
                    + _prom_labels(dict(lab, tenant=tenant))
                    + f" {t.get('replies', 0)}")
    if openmetrics and lines:
        lines.append("# EOF")
    return "\n".join(lines) + ("\n" if lines else "")




def _as_chrome_trace(path: str) -> Dict:
    """Rewrite the Chrome trace ``torch.profiler`` exported at ``path`` in
    the form :func:`validate_chrome_trace` checks: metadata events first,
    then every timed event in timestamp order (Kineto writes them grouped
    by source, not by time), and a ``pid``/``tid`` on every event (a
    metadata event may lack one). Returns the rewritten document."""
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    events = [ev for ev in doc.get("traceEvents") or []
              if isinstance(ev, dict)]
    for ev in events:
        ev.setdefault("pid", 0)
        ev.setdefault("tid", 0)
        ev.setdefault("name", "")
    meta = [ev for ev in events if ev.get("ph") == "M"]
    timed = sorted((ev for ev in events if ev.get("ph") != "M"),
                   key=lambda ev: float(ev.get("ts", 0.0)))
    doc["traceEvents"] = meta + timed
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    return doc


@contextlib.contextmanager
def torch_profile(logdir: str):
    """Capture a device profile around a pipeline run with
    ``torch.profiler`` — CPU activity, and CUDA activity when a card is
    present — and write it as a Chrome trace, ``<logdir>/trace.json``
    (load in Perfetto; :func:`validate_chrome_trace` accepts it). Yields
    that path; the file exists once the block exits. The device-side
    complement of :class:`Tracer`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)
    _as_chrome_trace(path)
