"""ServingScheduler — the continuous micro-batcher between the query
server socket and the pipeline.

Pull-model continuous batching: the serversrc's ``create()`` (the
pipeline's streaming thread) calls :meth:`next_batch` whenever the
pipeline can accept a buffer. The scheduler drains every request the
socket has queued into a pool keyed by (caps signature, tenant), applies
admission control per arriving request (shed → ``SERVER_BUSY`` reply,
never a growing queue), and assembles the next micro-batch from *all*
waiting clients the moment it is asked — a request never waits for its
own client to fill a batch (Orca/vLLM-style continuous batching, scoped
to the per-invoke granularity this pipeline runs at).

Batches are padded to exactly ``batch`` rows by repeating the last row,
so every emitted buffer carries ONE shape and the downstream filter sees
one input signature; padded rows carry no route and are dropped at the
serversink demux.

A copy of the JAX package's scheduler. The batch is stacked on the host
(numpy) and the filter uploads it, except where the served filter engaged
``shard=dp`` (sharded placement, :meth:`configure_pool`): then each
shard's row group is stacked and put on its mesh row, one put per shard.
With a replica pool (``replicas=N``) each batch is stamped with the
least-loaded replica (fewest un-acked batches, round robin among ties),
whose worker in the filter runs it. A pended serve-batch change warms
the served program's compile-cache entry at the new batch in a background
thread (the filter's ``aot_prefetch``), and the admitted pool waits feed
the rollout canary's since-the-flip p99 (``recent_wait_p99``), as in the
JAX scheduler. One change: each ingest
drains only the requests queued when it began (the JAX scheduler drains
until the queue is empty, which under overload holds every batch back
until arrivals stop).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from nnstreamer_tpu_torch.analysis import lockwitness
from nnstreamer_tpu_torch.buffer import Buffer, ShardedBatch
from nnstreamer_tpu_torch.edge import protocol as proto
from nnstreamer_tpu_torch.edge import tracex
from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.serving.admission import AdmissionController

log = get_logger("serving")

#: shed reason for requests whose payloads cannot join a batch (non-array
#: payloads on a serving stream — serving requires static tensor caps)
SHED_UNBATCHABLE = "unbatchable"
#: shed reason for requests still queued when the server drains (EOS/stop)
SHED_DRAINING = "draining"
#: shed reason for requests the nnctl predictive gate refuses: the plant
#: model prices this request's completion (backlog ahead of it × the
#: observed batch cycle) past the declared SLO — shedding NOW beats
#: serving a reply the client's deadline already wrote off
SHED_CTL_PREDICTED = "ctl_predicted_miss"

#: meta keys the batched buffer carries downstream (the serversink demux
#: contract): routes is a list of per-valid-row dicts
META_ROUTES = "serve_routes"
META_FILL = "serve_fill"
META_BATCH = "serve_batch"
#: replica-pool meta (nnpool): the least-loaded replica this batch was
#: dispatched to, and the server id the filter's worker error path uses
#: to reach this scheduler (shed-on-replica-failure)
META_REPLICA = "serve_replica"
META_SERVER = "serve_server"
#: shed reason for batches whose replica invoke failed (the filter's
#: worker sheds the batch's clients instead of letting them time out)
SHED_REPLICA_ERROR = "replica-error"
#: shed reason for a hedged resend whose original was already admitted
#: here (nnfleet-r): the request id (`_rid`) was seen before, so this
#: copy is acknowledged-but-not-invoked — the idempotence guarantee that
#: makes client-side hedging safe. The hedging client treats this BUSY
#: as benign (the original is still being served).
SHED_HEDGE_DUP = "hedge-duplicate"


@dataclass
class PendingRequest:
    """One admitted request waiting in the pool."""

    client_id: int
    tenant: str
    tensors: List[Any]
    pts: int
    duration: int
    meta: Dict[str, Any]
    signature: Tuple
    t_arrival: float
    seq: int = 0
    extra: dict = field(default_factory=dict)


def _signature(tensors: List[Any]) -> Optional[Tuple]:
    """Batchability signature: per-tensor (shape, dtype). None when any
    payload is not an ndarray (flexible/raw bytes can't stack)."""
    sig = []
    for t in tensors:
        if not isinstance(t, np.ndarray):
            return None
        sig.append((t.shape, str(t.dtype)))
    return tuple(sig)


class ServingScheduler:
    """Request pool + batcher for one query server.

    ``element`` is the owning serversrc (bus/tracer attribution); pass
    None in unit tests. ``stats_key`` names this server in the tracer's
    ``serving`` section (the server ``id`` both src and sink share).

    **Lock-ordering contract (nnctl hot knobs).** ``_lock`` is the ONE
    lock in the serving tier: the admission controller, its token
    buckets, the request pools and every hot-settable knob are only
    ever touched under it.  The controller thread actuates exclusively
    through :meth:`set_knobs` / :meth:`set_tenant_rate` /
    :meth:`set_ctl_gate` (each takes ``_lock`` and nothing else), and
    the controller itself holds no lock of its own while calling in —
    so there is no second lock to order against, by construction.
    """

    def __init__(self, server, *, batch: int, stats_key: str = "0",
                 element=None, queue_depth: int = 64, rate: float = 0.0,
                 burst: Optional[float] = None,
                 weights: Optional[Dict[str, float]] = None,
                 tenant_key: str = "tenant",
                 linger_ms: float = 0.0):
        self.server = server
        self.batch = max(1, int(batch))
        self.stats_key = str(stats_key)
        self.element = element
        self.tenant_key = str(tenant_key or "tenant")
        self.linger_s = max(0.0, float(linger_ms)) / 1e3
        self.admission = AdmissionController(
            queue_depth=queue_depth, rate=rate, burst=burst, weights=weights)
        # pool: signature → tenant → FIFO of PendingRequest
        self._pools: Dict[Tuple, Dict[str, List[PendingRequest]]] = {}
        self._waiting = 0
        self._arrival_seq = 0
        # the ONE serving-tier lock (contract above) — witnessed under
        # NNSTPU_SANITIZE so any second lock nested inside it shows up
        # in the nnsan-c order graph
        self._lock = lockwitness.make_lock("serving.scheduler")
        # counters mirrored on the tracer (kept here too so raw-scheduler
        # unit tests and the bench leg read them without a pipeline)
        self.stats = {"enqueued": 0, "shed": 0, "batches": 0, "rows": 0,
                      "padded_rows": 0, "hedge_dupes": 0}
        self.shed_reasons: Dict[str, int] = {}
        # nnfleet-r hedge dedup: requests carrying a `_rid` (fleet
        # clients only — legacy frames have none and are never deduped)
        # are admitted at most once; the second copy of a hedged pair is
        # shed as SHED_HEDGE_DUP instead of invoked twice
        from nnstreamer_tpu_torch.edge.fleet import RidFilter

        self.rid_filter = RidFilter()
        # nnfleet-r health/canary taps (both non-draining — ctl_window
        # stays the controller's exclusive drain): _health_last prices the
        # shed rate between health broadcasts; _wait_recent keeps
        # timestamped admitted pool-waits for the rollout canary's
        # since-the-flip p99
        self._health_last = {"t": time.perf_counter(), "enqueued": 0,
                             "shed": 0, "permille": 0}
        self._wait_recent: deque = deque(maxlen=512)
        # nnctl hot-knob state: a serve-batch change is PENDED while any
        # batch built at the old shape is still in flight (the serversink
        # acks each demuxed batch via note_reply_batch) — every emitted
        # buffer carries exactly ONE shape, and the downstream jit cache
        # grows by at most one trace per DISTINCT serve-batch value.
        # In-flight batches are tracked as assemble timestamps: a batch
        # that never reaches the sink (filter error, downstream drop)
        # EXPIRES after `inflight_expire_s` instead of leaking forever —
        # a leaked counter would wedge pended changes and inflate the
        # predictive gate with phantom backlog.
        self._batch_pending: Optional[int] = None
        self._inflight_t: List[float] = []
        self.inflight_expire_s = 10.0
        self._sink_feedback = False  # becomes True at the first sink ack
        # nnpool replica pool (planner-installed, NNST960-licensed):
        # per-replica in-flight windows (assemble stamps) drive the
        # least-loaded dispatch — the sink ack (note_reply_batch with the
        # batch's replica) drains them; a batch that never reaches the
        # sink EXPIRES like the global window, so a hung replica reads as
        # loaded (the pool routes around it) but never wedges forever
        self._replicas = 1
        self._replica_inflight: List[List[float]] = []
        self._replica_rr = 0  # round-robin tiebreak among least-loaded
        # nnpool sharded-placement mode: a callable resolving the served
        # filter's ENGAGED dp layout ({"mesh", "dp", "element"}) or None —
        # re-read per batch so a mid-stream fallback degrades to the host
        # stack, never errors
        self._placement_fn = None
        self._placement_warned = False
        # predictive-shed gate (nnctl): None = off; else the plant-priced
        # admission bound {slo_ms, cycle_ms} the controller recalibrates
        self._ctl_gate: Optional[Dict[str, float]] = None
        # compile-cache warm path: the last assembled row signature lets
        # a serve-batch change prefetch the served program's entry at the
        # NEW batch shape while old-shape batches still serve (one
        # background thread at a time — a stampede of compile workers
        # would thrash the cache budget)
        self._last_row_sig: Optional[Tuple] = None
        self._aot_prefetching = False
        # controller-facing measurement window (drained per tick by the
        # LiveFeed): pool waits, per-launch device windows (sink acks),
        # assemble timestamps, per-tenant arrival counts
        self._ctl_win = {"wait_ms": [], "device_ms": [], "assemble_t": [],
                         "tenant_arrivals": {}, "last_stats": dict(self.stats),
                         "last_shed": {}}

    # -- tracer plumbing ---------------------------------------------------
    def _tracer(self):
        if self.element is not None and self.element.pipeline is not None:
            return getattr(self.element.pipeline, "tracer", None)
        return None

    # -- ingest ------------------------------------------------------------
    def _ingest_nonblocking(self) -> None:
        """Ingest the requests queued when the call began, and no more.
        Under overload requests arrive faster than they are decoded and
        shed; a drain that ran until the queue was empty would hold
        ``next_batch`` until the clients stopped sending, and no batch
        would leave while they sent."""
        for _ in range(self.server.recv_queue.qsize()):
            try:
                item = self.server.recv_queue.get_nowait()
            except Exception:  # noqa: BLE001 — queue.Empty
                return
            self._ingest_one(item)

    def _ingest_one(self, item) -> None:
        cid, msg = item
        ctx = msg.trace  # nntrace-x context the client propagated, or None
        buf = proto.message_to_buffer(msg)
        meta = dict(buf.meta)
        meta.pop("client_id", None)
        tenant = str(meta.get(self.tenant_key, "") or "_default")
        if self.rid_filter.seen(meta.get("_rid")):
            # hedge duplicate: the original already entered admission —
            # shed (never invoke) BEFORE the gate so the duplicate spends
            # no tokens and skews no arrival counts
            self.stats["hedge_dupes"] += 1
            self._shed(cid, tenant, meta, SHED_HEDGE_DUP, ctx=ctx)
            return
        sig = _signature(buf.tensors)
        if sig is None:
            self._shed(cid, tenant, meta, SHED_UNBATCHABLE, ctx=ctx)
            return
        with self._lock:
            waiting_t = sum(
                len(q.get(tenant, ())) for q in self._pools.values())
            verdict = self._ctl_gate_verdict_locked()
            if verdict is None:
                verdict = self.admission.admit(tenant, waiting_t)
            # arrivals count admitted AND shed: a tenant the controller
            # throttled to near-100% shed must stay visible in the
            # measurement window, or rate-restore/burst-spend would skip
            # exactly the tenants the controller cut
            ta = self._ctl_win["tenant_arrivals"]
            ta[tenant] = ta.get(tenant, 0) + 1
            if verdict is None:
                self._arrival_seq += 1
                req = PendingRequest(
                    client_id=cid, tenant=tenant, tensors=list(buf.tensors),
                    pts=buf.pts, duration=buf.duration, meta=meta,
                    signature=sig, t_arrival=time.perf_counter(),
                    seq=self._arrival_seq)
                if ctx is not None:
                    # wire-receive → scheduler-ingest is the first server
                    # stage of the request's SLO decomposition
                    ctx.add_stage(tracex.STAGE_INGEST, ctx.t_wire_recv_ns,
                                  time.perf_counter_ns())
                    req.extra["trace"] = ctx
                self._pools.setdefault(sig, {}).setdefault(
                    tenant, []).append(req)
                self._waiting += 1
                self.stats["enqueued"] += 1
                depth = self._waiting
            else:
                depth = self._waiting
        if verdict is not None:
            self._shed(cid, tenant, meta, verdict, ctx=ctx)
            return
        # nnsan-c handoff witness: the request's tensors now belong to the
        # batching thread — the ingest thread mutating them after this
        # point is a cross-thread handoff race (NNST612)
        lockwitness.handoff_send("serving.pool", req, req.tensors)
        tracer = self._tracer()
        if tracer is not None:
            tracer.record_serving_enqueue(self.stats_key, tenant, depth)

    def _shed(self, cid: int, tenant: str, meta: Dict, reason: str,
              ctx=None) -> None:
        """Overload shedding: tell the client NOW (SERVER_BUSY) instead of
        letting it time out against a queue that would never serve it —
        on-error=drop semantics, observable at both ends. A traced
        request's BUSY echoes its context (shed flag + server stamps) so
        the client's exemplar store and the merged trace both carry the
        terminated request with its reason."""
        self.stats["shed"] += 1
        self.shed_reasons[reason] = self.shed_reasons.get(reason, 0) + 1
        reply = {"reason": "SERVER_BUSY", "detail": reason}
        if "_seq" in meta:
            reply["_seq"] = meta["_seq"]
        if tenant != "_default":
            reply[self.tenant_key] = tenant
        busy = proto.Message(proto.MSG_BUSY, reply)
        if ctx is not None:
            rctx = tracex.reply_context(ctx, shed=True, shed_reason=reason)
            rctx.stages = list(ctx.stages)
            rctx.t_reply_ns = time.perf_counter_ns()
            busy.trace = rctx
        try:
            self.server.send_to(cid, busy)
        except Exception:  # noqa: BLE001 — client already gone: shed stands
            pass
        tracer = self._tracer()
        if tracer is not None:
            tracer.record_serving_shed(self.stats_key, tenant, reason)
            spans = tracer.spans
            if spans is not None and ctx is not None:
                # terminated span: the request died here, and the merged
                # trace must say why (the shed reason) under its trace_id
                t0 = (ctx.t_wire_recv_ns or time.perf_counter_ns()) / 1e9
                spans.emit(f"shed:{reason}", "serving", t0,
                           time.perf_counter(),
                           track=f"serving:{self.stats_key}",
                           aid=f"{ctx.trace_hex}/shed",
                           args={"trace_id": ctx.trace_hex,
                                 "tenant": tenant, "shed_reason": reason,
                                 "terminated": True})
        if self.element is not None:
            # the tracer counts EVERY shed (bounded counters); the bus
            # ledger and message queue are unbounded lists, so under
            # sustained overload (thousands of sheds/sec is the design
            # point) they are sampled: the first shed and every 100th
            n = self.stats["shed"]
            if n == 1 or n % 100 == 0:
                if self.element.pipeline is not None:
                    self.element.pipeline.bus.record_fault(
                        self.element.name, action="shed", reason=reason,
                        tenant=tenant, client_id=cid, total_shed=n)
                self.element.post_message(
                    "request-shed", {"tenant": tenant, "reason": reason,
                                     "client_id": cid, "total_shed": n})

    # -- batching ----------------------------------------------------------
    def next_batch(self, timeout: float = 0.2) -> Optional[Buffer]:
        """Assemble the next micro-batch, blocking up to ``timeout`` for
        the FIRST request only. Waiting requests are batched the moment
        this is called (the pipeline is idle by construction of the pull
        model); ``serve-linger-ms`` optionally holds an under-filled
        batch open that long to trade latency for fill."""
        deadline = time.perf_counter() + timeout
        while True:
            self._ingest_nonblocking()
            if self._waiting:
                if self.linger_s > 0 and self._waiting < self.batch:
                    self._linger(deadline)
                return self._assemble()
            rem = deadline - time.perf_counter()
            if rem <= 0:
                return None
            item = self.server.pop(timeout=min(rem, 0.05))
            if item is not None:
                self._ingest_one(item)

    def _linger(self, deadline: float) -> None:
        """Hold an under-filled batch open up to linger-ms past the OLDEST
        waiting request's arrival (never past the caller's deadline): a
        fill/latency trade the default (0) disables — continuous batching
        proper never waits."""
        with self._lock:
            oldest = min((r.t_arrival for q in self._pools.values()
                          for reqs in q.values() for r in reqs),
                         default=time.perf_counter())
        until = min(oldest + self.linger_s, deadline)
        while self._waiting < self.batch:
            rem = until - time.perf_counter()
            if rem <= 0:
                return
            item = self.server.pop(timeout=min(rem, 0.02))
            if item is not None:
                self._ingest_one(item)
            self._ingest_nonblocking()

    def _assemble(self) -> Optional[Buffer]:
        with self._lock:
            # a pended serve-batch change applies HERE, between batches,
            # once the in-flight window has drained — one shape per
            # emitted buffer, old shape until the old window is out
            self._maybe_apply_pending_locked()
            # snapshot the pad target ONCE: a concurrent set_knobs must
            # never split one batch between two shapes (collect at one
            # target, pad at another)
            target = self.batch
            # the signature whose head request waited longest goes first —
            # FIFO across signature groups, so a rare-caps client is never
            # starved behind a popular signature
            sig = None
            oldest = None
            for s, tenants in self._pools.items():
                for reqs in tenants.values():
                    if reqs and (oldest is None or reqs[0].seq < oldest):
                        oldest = reqs[0].seq
                        sig = s
            if sig is None:
                return None
            self._last_row_sig = sig
            pool = self._pools[sig]
            rows: List[PendingRequest] = []
            while len(rows) < target:
                backlogged = [t for t, reqs in pool.items() if reqs]
                if not backlogged:
                    break
                t = self.admission.pick(backlogged)
                rows.append(pool[t].pop(0))
                self.admission.advance(t)
                self._waiting -= 1
            if not any(pool.values()):
                self._pools.pop(sig, None)
            now_pc = time.perf_counter()
            self._expire_inflight_locked(now_pc)
            self._inflight_t.append(now_pc)
            win = self._ctl_win
            win["assemble_t"].append(now_pc)
            if len(win["assemble_t"]) > 512:
                del win["assemble_t"][:-512]
        for r in rows:
            lockwitness.handoff_recv("serving.pool", r, r.tensors)
        return self._build_buffer(rows, target)

    def _build_buffer(self, rows: List[PendingRequest],
                      target: Optional[int] = None) -> Buffer:
        valid = len(rows)
        if target is None:
            target = self.batch
        pad = target - valid
        now = time.perf_counter()
        n_tensors = len(rows[0].tensors)
        placement = self._resolve_placement(target)
        stacked = []
        placed_bytes = 0
        for j in range(n_tensors):
            parts = [r.tensors[j] for r in rows]
            parts.extend([rows[-1].tensors[j]] * pad)
            if placement is not None:
                arr, nb = self._place_sharded(parts, placement)
                stacked.append(arr)
                placed_bytes += nb
            else:
                # host stack: the filter uploads the batch (through its
                # feed-depth staging when that is set)
                stacked.append(np.stack(parts, axis=0))
        if placement is not None and placed_bytes and \
                self.element is not None:
            # the batch crossed HERE, straight into the shards (one put
            # per shard): bill the h2d on the serversrc with its
            # per-device split; the filter sees its own layout and bills
            # nothing
            self.element._record_crossing(
                "h2d", nbytes=placed_bytes, devices=placement["dp"])
        now_ns = time.perf_counter_ns()
        routes = []
        for r in rows:
            route = {"client_id": r.client_id, "tenant": r.tenant,
                     "pts": r.pts, "duration": r.duration, "meta": r.meta}
            ctx = r.extra.get("trace")
            if ctx is not None:
                # pool wait: ingest → this batch assembling (the serversink
                # closes the decomposition with batch/device/reply stages)
                ingest = ctx.stage(tracex.STAGE_INGEST)
                t0 = ingest[1] if ingest else ctx.t_wire_recv_ns
                ctx.add_stage(tracex.STAGE_ADMIT, t0, now_ns)
                route["trace"] = ctx
            routes.append(route)
        self.stats["batches"] += 1
        self.stats["rows"] += valid
        self.stats["padded_rows"] += pad
        with self._lock:
            waits = self._ctl_win["wait_ms"]
            waits.extend((now - r.t_arrival) * 1e3 for r in rows)
            if len(waits) > 2048:
                del waits[:-2048]
            # canary tap (non-draining): timestamped copies so the
            # rollout canary reads a since-the-flip p99 without stealing
            # the controller's measurement window
            self._wait_recent.extend(
                (now, (now - r.t_arrival) * 1e3) for r in rows)
        tracer = self._tracer()
        if tracer is not None:
            tracer.record_serving_batch(self.stats_key, valid, target)
            spans = tracer.spans
            for r in rows:
                ctx = r.extra.get("trace")
                tid = ctx.trace_hex if ctx is not None else None
                tracer.record_serving_wait(self.stats_key,
                                           now - r.t_arrival, r.tenant,
                                           trace_id=tid)
                if spans is not None:
                    # serve-wait span: admission → batch assembly, one per
                    # request on the server's virtual track (async-id'd by
                    # arrival seq — pool waits overlap freely); the reply
                    # half (`serve-reply`, serversink) closes the
                    # enqueue→batch→reply serving timeline
                    args = {"tenant": r.tenant, "client": r.client_id}
                    if tid is not None:
                        args["trace_id"] = tid
                    spans.emit("serve-wait", "serving", r.t_arrival, now,
                               track=f"serving:{self.stats_key}",
                               aid=r.seq, args=args)
        meta = {META_ROUTES: routes, META_FILL: valid,
                META_BATCH: target, META_SERVER: self.stats_key}
        replica = self._pick_replica(now)
        if replica is not None:
            meta[META_REPLICA] = replica
            spans = tracer.spans if tracer is not None else None
            if spans is not None:
                # per-replica serving track: the dispatch decision next
                # to the replica's device lane in Perfetto
                spans.emit("serve-dispatch", "serving", now,
                           time.perf_counter(),
                           track=f"serving:{self.stats_key}:r{replica}",
                           args={"replica": replica, "fill": valid,
                                 "batch": target})
        return Buffer(
            tensors=stacked, pts=rows[0].pts, duration=rows[0].duration,
            meta=meta)

    # -- nnpool: replica pool + sharded placement --------------------------
    def configure_pool(self, replicas: Optional[int] = None,
                       placement_fn=None) -> None:
        """Install (or clear) the planner's nnpool decisions: the
        NNST960-licensed replica count and/or the sharded-placement
        resolver for an NNST470-engaged ``shard=dp`` served filter."""
        with self._lock:
            if replicas is not None:
                n = max(1, int(replicas))
                self._replicas = n
                self._replica_inflight = ([[] for _ in range(n)]
                                          if n > 1 else [])
                self._replica_rr = 0
            if placement_fn is not None or replicas is None:
                self._placement_fn = placement_fn
                self._placement_warned = False

    def _pick_replica(self, now: float) -> Optional[int]:
        """Least-loaded-first dispatch: the replica with the fewest
        unacked in-flight batches takes the next one (round robin among
        ties). A hung replica's window stays outstanding until the expiry
        sweep, so the pool routes around it."""
        with self._lock:
            n = self._replicas
            if n <= 1 or not self._replica_inflight:
                return None
            self._expire_inflight_locked(now)
            r = min(range(n),
                    key=lambda i: (len(self._replica_inflight[i]),
                                   (i - self._replica_rr) % n))
            self._replica_rr = (r + 1) % n
            self._replica_inflight[r].append(now)
        tracer = self._tracer()
        if tracer is not None:
            tracer.record_serving_replica(self.stats_key, r)
        return r

    def shed_batch(self, routes, reason: str) -> None:
        """Shed every client of one assembled batch (the filter's replica
        worker calls this when a replica invoke fails): each route's
        client gets SERVER_BUSY with the reason NOW instead of timing
        out."""
        for route in routes or ():
            meta = dict(route.get("meta") or {})
            self._shed(int(route["client_id"]),
                       str(route.get("tenant", "_default")), meta,
                       reason, ctx=route.get("trace"))

    def _resolve_placement(self, target: int):
        """The engaged sharded-placement layout for THIS batch, or None
        (host stack). Re-resolved per batch: a mid-stream fallback on the
        served filter degrades to the host path, never errors."""
        fn = self._placement_fn
        if fn is None:
            return None
        try:
            placement = fn()
        except Exception:  # noqa: BLE001 — resolver raced a teardown
            placement = None
        if placement is None:
            return None
        dp = int(placement.get("dp", 1))
        if dp <= 1 or target % dp:
            return None  # indivisible batch: host stack, filter re-splits
        return placement

    def _place_sharded(self, parts: List, placement) -> tuple:
        """Place one input tensor's rows straight into the served filter's
        dp layout: each shard's row GROUP stacks on the host and is put on
        its mesh row's device, one put per shard — no host stack of the
        whole batch. Returns (per-row tensors, bytes moved); the filter
        takes the list of row tensors as its own layout. Falls back to the
        host stack on any placement failure (warned once)."""
        import torch

        from nnstreamer_tpu_torch.parallel.mesh import row_device

        mesh, dp = placement["mesh"], int(placement["dp"])
        g = len(parts) // dp
        try:
            rows, nbytes = [], 0
            for i in range(dp):
                block = np.stack(parts[i * g:(i + 1) * g], axis=0)
                nbytes += block.nbytes
                t = torch.from_numpy(block)
                dev = row_device(mesh, i)
                rows.append(t.pin_memory().to(dev, non_blocking=True)
                            if dev.type == "cuda" else t.to(dev))
            return ShardedBatch(rows), nbytes
        except Exception as e:  # noqa: BLE001 — degrade, don't drop
            if not self._placement_warned:
                self._placement_warned = True
                log.warning("sharded serve-batch placement failed (%s); "
                            "falling back to the host stack",
                            str(e).splitlines()[0][:120])
            return np.stack(parts, axis=0), 0

    # -- nnctl hot knobs + measurement window ------------------------------
    def _expire_inflight_locked(self, now: float) -> None:
        """Drop in-flight entries older than ``inflight_expire_s``: a
        batch the sink never acked (errored/dropped downstream) must not
        wedge pended knob changes or pad the predictive gate's backlog
        forever.  ``_lock`` is held by the caller."""
        cutoff = now - self.inflight_expire_s
        while self._inflight_t and self._inflight_t[0] < cutoff:
            self._inflight_t.pop(0)
        for lst in self._replica_inflight:
            while lst and lst[0] < cutoff:
                lst.pop(0)

    def _maybe_apply_pending_locked(self) -> None:
        """Apply a pended serve-batch once the in-flight window drained.
        Without sink feedback (raw-scheduler tests, no serversink) there
        is no drain signal — the change applies at the next batch
        boundary, which still keeps every emitted buffer single-shape."""
        if self._batch_pending is None:
            return
        self._expire_inflight_locked(time.perf_counter())
        if self._sink_feedback and self._inflight_t:
            return
        self.batch = self._batch_pending
        self._batch_pending = None

    def _ctl_gate_verdict_locked(self) -> Optional[str]:
        """Predictive shed (nnctl): price THIS request's completion with
        the plant-calibrated cycle — the batches queued ahead of it plus
        the in-flight window, each one observed batch cycle — and shed
        ``ctl_predicted_miss`` when that already blows the SLO.  Runs
        BEFORE the token bucket (a predicted miss must not spend the
        tenant's tokens).  ``_lock`` is held by the caller."""
        g = self._ctl_gate
        if g is None:
            return None
        self._expire_inflight_locked(time.perf_counter())
        batches_ahead = self._waiting // max(1, self.batch) + 1
        predicted_ms = (batches_ahead + len(self._inflight_t)) \
            * g["cycle_ms"]
        if predicted_ms > g["slo_ms"]:
            return SHED_CTL_PREDICTED
        return None

    def set_knobs(self, batch: Optional[int] = None,
                  linger_ms: Optional[float] = None,
                  queue_depth: Optional[int] = None) -> Dict[str, Any]:
        """Hot-set serving knobs mid-stream (the nnctl actuation path;
        also callable by operators).  Thread-safe under the scheduler's
        single lock.  A serve-batch change is PENDED while batches built
        at the old shape are still in flight (see the class docstring's
        lock-ordering contract and :meth:`note_reply_batch`): until the
        window drains, assembly keeps padding to the OLD shape, so no
        jit dispatch ever sees a mixed batch and the downstream compile
        count stays bounded by the number of distinct serve-batch
        values.  Returns {knob: applied-or-{"pending": v}}."""
        out: Dict[str, Any] = {}
        with self._lock:
            if linger_ms is not None:
                self.linger_s = max(0.0, float(linger_ms)) / 1e3
                out["linger_ms"] = self.linger_s * 1e3
            if queue_depth is not None:
                self.admission.queue_depth = int(queue_depth)
                out["queue_depth"] = self.admission.queue_depth
            if batch is not None:
                b = max(1, int(batch))
                if b == self.batch:
                    self._batch_pending = None
                    out["serve_batch"] = b
                elif self._sink_feedback and self._inflight_t:
                    self._batch_pending = b
                    out["serve_batch"] = {"pending": b}
                else:
                    self.batch = b
                    self._batch_pending = None
                    out["serve_batch"] = b
        if batch is not None and "serve_batch" in out \
                and max(1, int(batch)) != self.batch:
            # pended change: warm the served program's cache entry at the
            # NEW batch shape NOW, off the actuation path — by the time
            # the in-flight window drains and the shape flips, the first
            # new-shape batch loads instead of building under load
            self._prefetch_serve_batch(max(1, int(batch)))
        return out

    def _prefetch_serve_batch(self, b: int) -> None:
        """Background-build the served filter's program at serve-batch
        ``b`` in the compile cache's worker (filters/aot.prefetch_compile
        via the filter's ``aot_prefetch``). Best effort — no served
        filter, no cache gate, or no signature seen yet all decline
        silently; streaming never depends on it."""
        sig = self._last_row_sig
        if sig is None or self.element is None or self._aot_prefetching:
            return
        try:
            from nnstreamer_tpu_torch.analysis.passes import (
                _downstream_filter,
            )

            f = _downstream_filter(self.element)
        except Exception:  # noqa: BLE001 — no graph context (unit test)
            return
        pf = getattr(getattr(f, "fw", None), "aot_prefetch", None)
        if pf is None:
            return
        shapes = [tuple(((int(b),) + tuple(s), d) for s, d in sig)]
        self._aot_prefetching = True

        def work():
            try:
                pf(shapes=shapes)
            except Exception:  # noqa: BLE001 — warm path only
                pass
            finally:
                self._aot_prefetching = False

        threading.Thread(target=work, name="nnaot-prefetch",
                         daemon=True).start()

    def set_tenant_rate(self, tenant: str, rate: Optional[float] = None,
                        burst: Optional[float] = None) -> Dict[str, float]:
        """Hot-set one tenant's admission rate/burst (nnctl rate-cut /
        burst-credit actuations) under the scheduler lock."""
        with self._lock:
            return self.admission.set_rate(tenant, rate, burst)

    def set_ctl_gate(self, slo_ms: Optional[float],
                     cycle_ms: Optional[float]) -> None:
        """(Re)calibrate the predictive shed gate; None disables it."""
        with self._lock:
            if not slo_ms or not cycle_ms or cycle_ms <= 0:
                self._ctl_gate = None
            else:
                self._ctl_gate = {"slo_ms": float(slo_ms),
                                  "cycle_ms": float(cycle_ms)}

    def note_reply_batch(self, invoke_win: Optional[Dict] = None,
                         replica: Optional[int] = None) -> None:
        """Serversink ack: one emitted batch fully demuxed.  Drives (a)
        the in-flight drain count gating pended serve-batch changes,
        (b) the per-launch device window measurement (``serve_invoke``
        stamps) the controller's LiveFeed consumes, and (c) the
        per-replica in-flight window the least-loaded dispatch reads
        (``replica`` = the batch's ``serve_replica`` stamp)."""
        with self._lock:
            self._sink_feedback = True
            if self._inflight_t:
                self._inflight_t.pop(0)
            if replica is not None and 0 <= int(replica) < len(
                    self._replica_inflight):
                lst = self._replica_inflight[int(replica)]
                if lst:
                    lst.pop(0)
            if invoke_win:
                t0 = invoke_win.get("t0_ns")
                t1 = invoke_win.get("t1_ns")
                if t0 and t1 and t1 > t0:
                    devs = self._ctl_win["device_ms"]
                    devs.append((t1 - t0) / 1e6)
                    if len(devs) > 512:
                        del devs[:-512]

    def recent_wait_p99(self, since: float) -> Optional[float]:
        """p99 (ms) of admitted pool-waits assembled after perf-counter
        time ``since`` — the rollout canary's latency source. None when
        nothing was admitted in the window yet."""
        with self._lock:
            vals = sorted(w for t, w in self._wait_recent if t >= since)
        if not vals:
            return None
        return vals[min(len(vals) - 1, int(0.99 * len(vals)))]

    def health_snapshot(self) -> Dict[str, int]:
        """Live headroom for the capability health TLV (edge/fleet.py
        keys). NON-draining — ``ctl_window`` stays the controller's
        exclusive drain; the shed rate here is priced between successive
        health calls (the broadcaster is this method's only consumer)."""
        now = time.perf_counter()
        with self._lock:
            self._expire_inflight_locked(now)
            enq, shed = self.stats["enqueued"], self.stats["shed"]
            last = self._health_last
            d_enq = enq - last["enqueued"]
            d_shed = shed - last["shed"]
            seen = d_enq + d_shed
            if seen > 0:
                permille = int(round(1000.0 * d_shed / seen))
                last.update(t=now, enqueued=enq, shed=shed,
                            permille=permille)
            elif now - last["t"] > 5.0:
                last.update(t=now, permille=0)  # idle: stale rate decays
            slo = 0
            if self._ctl_gate is not None:
                slo = int(self._ctl_gate.get("slo_ms", 0))
            return {
                "depth": self._waiting,
                "inflight": len(self._inflight_t),
                "shed_permille": last["permille"],
                "serve_batch": self.batch,
                "slo_ms": slo,
            }

    def knobs(self) -> Dict[str, Any]:
        """Current hot-knob values (pending serve-batch included)."""
        with self._lock:
            return {
                "serve_batch": self.batch,
                "serve_batch_pending": self._batch_pending,
                "linger_ms": round(self.linger_s * 1e3, 3),
                "queue_depth": self.admission.queue_depth,
            }

    def ctl_window(self) -> Dict[str, Any]:
        """Drain the controller-facing measurement window: everything
        accumulated since the last call (pool waits, per-launch device
        windows, assemble timestamps, counter deltas, per-tenant
        arrivals) plus the current knob values.  One consumer — the
        controller's LiveFeed ticks it."""
        with self._lock:
            win = self._ctl_win
            waits, win["wait_ms"] = win["wait_ms"], []
            devs, win["device_ms"] = win["device_ms"], []
            asm, win["assemble_t"] = win["assemble_t"], []
            tenants, win["tenant_arrivals"] = win["tenant_arrivals"], {}
            cur = dict(self.stats)
            deltas = {k: cur[k] - win["last_stats"].get(k, 0) for k in cur}
            win["last_stats"] = cur
            shed_now = dict(self.shed_reasons)
            shed_delta = {k: v - win["last_shed"].get(k, 0)
                          for k, v in shed_now.items()
                          if v - win["last_shed"].get(k, 0)}
            win["last_shed"] = shed_now
            tenant_rates = {t: self.admission.tenant_rate(t)
                            for t in sorted(tenants)}
            pool = {}
            if self._replicas > 1:
                # nnpool view for the controller: the plant model divides
                # the device leg by the ACTIVE replica count
                pool = {
                    "replicas": self._replicas,
                    "replica_inflight": [len(lst) for lst in
                                         self._replica_inflight],
                }
            return dict(pool, **{
                "waits_ms": waits,
                "device_ms": devs,
                "assemble_t": asm,
                "deltas": deltas,
                "shed_reasons": shed_delta,
                "tenant_arrivals": tenants,
                "tenant_rates": tenant_rates,
                "waiting": self._waiting,
                "inflight_batches": len(self._inflight_t),
                "serve_batch": self.batch,
                "serve_batch_pending": self._batch_pending,
                "linger_ms": round(self.linger_s * 1e3, 3),
                "queue_depth": self.admission.queue_depth,
            })

    # -- drain -------------------------------------------------------------
    def shutdown(self) -> int:
        """Drain on stop/EOS: requests still queued are shed with
        SERVER_BUSY (observable at the client, counted on the tracer) —
        never silently dropped, never a hang. Returns the shed count."""
        with self._lock:
            leftover = [r for q in self._pools.values()
                        for reqs in q.values() for r in reqs]
            self._pools.clear()
            self._waiting = 0
        for r in leftover:
            self._shed(r.client_id, r.tenant, r.meta, SHED_DRAINING,
                       ctx=r.extra.get("trace"))
        # requests the socket queued but nobody ingested yet
        while True:
            item = self.server.pop(timeout=0.0)
            if item is None:
                break
            cid, msg = item
            meta = dict(msg.meta)
            meta.pop("client_id", None)
            tenant = str(meta.get(self.tenant_key, "") or "_default")
            self._shed(cid, tenant, meta, SHED_DRAINING, ctx=msg.trace)
            leftover.append(None)
        if leftover:
            log.info("serving scheduler drained %d queued request(s) with "
                     "SERVER_BUSY", len(leftover))
        return len(leftover)
