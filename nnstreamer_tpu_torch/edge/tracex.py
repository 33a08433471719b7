"""nntrace-x: compact trace-context propagation over the edge wire.

The Dapper model (Sigelman et al., 2010) scoped to the NTEQ protocol: a
request that crosses the client→server wire carries a fixed binary
header — trace id, parent span id, the client's monotonic send stamp and
a sampling bit — and the reply carries the same context back augmented
with the server's receive/reply stamps plus a per-stage timing block
(admission wait, batch fill, device invoke, reply serialize). Because
every stage is a *duration* in the server's own monotonic clock, the
client can decompose its observed RTT (network vs queue vs batch vs
device vs reply) without any clock agreement; the four absolute stamps
(t1 client-send, t2 server-recv, t3 server-send, t4 client-recv) double
as one NTP-style sample for :func:`nnstreamer_tpu_torch.edge.ntp.estimate_offset`,
which is what rebases the server's *span timeline* into the client's
timebase when two process traces are stitched
(:func:`nnstreamer_tpu_torch.trace.merge_chrome_traces`).

Wire layout (little-endian), carried only on frames whose msg-type byte
has :data:`~nnstreamer_tpu_torch.edge.protocol.TRACE_FLAG` set — negotiated
via MSG_CAPABILITY, so a peer that never advertised the capability sees
byte-identical frames:

    u16 hdr_len | u8 ver | u8 flags | u64 trace_id | u64 span_id
    | u64 t_send_ns | u64 t_recv_ns | u64 t_reply_ns
    | u8 n_stages | (u8 kind, u64 t0_ns, u64 t1_ns) * n_stages
    | <trailing bytes a newer peer may append — skipped, never fatal>

Parsing is forward-compatible by construction: unknown stage kinds are
kept verbatim (renderers skip what they don't name), and any bytes past
the declared stages inside ``hdr_len`` are ignored.
"""

from __future__ import annotations

import random
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

VERSION = 1

#: flags bits
FLAG_SAMPLED = 0x01
FLAG_SHED = 0x02

_CORE = struct.Struct("<BBQQQQQB")  # ver, flags, trace, span, t1, t2, t3, n
_STAGE = struct.Struct("<BQQ")  # kind, t0_ns, t1_ns

#: server-side stage kinds (reply-direction timing block). The numeric
#: values are wire contract — renumbering breaks cross-version peers.
STAGE_INGEST = 1  # wire receive → scheduler ingest
STAGE_ADMIT = 2  # admitted into the pool → batch assembled
STAGE_BATCH = 3  # batch assembled → filter invoke entered
STAGE_DISPATCH = 4  # invoke entered → XLA dispatch returned
STAGE_COMPUTE = 5  # dispatch returned → device outputs ready
STAGE_D2H = 6  # device outputs ready → host materialization done
STAGE_DEVICE = 7  # whole invoke window (coarse, when no span detail)
STAGE_REPLY = 8  # invoke done → reply frame built (demux + serialize)

STAGE_NAMES = {
    STAGE_INGEST: "ingest",
    STAGE_ADMIT: "admission",
    STAGE_BATCH: "batch",
    STAGE_DISPATCH: "dispatch",
    STAGE_COMPUTE: "device-compute",
    STAGE_D2H: "d2h",
    STAGE_DEVICE: "device",
    STAGE_REPLY: "reply",
}

#: decomposition buckets (bench/report keys) per stage kind
_COMPONENT_OF = {
    STAGE_INGEST: "queue_ms",
    STAGE_ADMIT: "queue_ms",
    STAGE_BATCH: "batch_ms",
    STAGE_DISPATCH: "device_ms",
    STAGE_COMPUTE: "device_ms",
    STAGE_D2H: "device_ms",
    STAGE_DEVICE: "device_ms",
    STAGE_REPLY: "reply_ms",
}


def new_id() -> int:
    """Non-zero random 64-bit id (trace or span)."""
    return random.getrandbits(64) | 1


@dataclass
class TraceContext:
    """One request's trace context — the in-memory form of the header."""

    trace_id: int
    span_id: int
    sampled: bool = True
    shed: bool = False
    #: client monotonic send stamp (t1) — set by the client, echoed back
    t_send_ns: int = 0
    #: server monotonic receive stamp (t2) — reply direction only
    t_recv_ns: int = 0
    #: server monotonic reply-build stamp (t3) — reply direction only
    t_reply_ns: int = 0
    #: (kind, t0_ns, t1_ns) stage timings, server monotonic clock
    stages: List[Tuple[int, int, int]] = field(default_factory=list)
    #: LOCAL receive stamp (t4 on the client) — set by the transport the
    #: moment the frame is parsed; never on the wire
    t_wire_recv_ns: int = 0
    #: shed reason (BUSY replies) — rides the message meta, mirrored here
    shed_reason: str = ""
    #: client-local waterfall legs ((name, t0_ns, t1_ns), e.g. the
    #: serialize/deserialize work around the wire) — never on the wire
    client_spans: List[Tuple[str, int, int]] = field(default_factory=list)

    @property
    def trace_hex(self) -> str:
        return f"{self.trace_id:016x}"

    def stage(self, kind: int) -> Optional[Tuple[int, int]]:
        for k, t0, t1 in self.stages:
            if k == kind:
                return (t0, t1)
        return None

    def add_stage(self, kind: int, t0_ns: int, t1_ns: int) -> None:
        self.stages.append((int(kind), int(t0_ns), max(int(t0_ns),
                                                       int(t1_ns))))


def pack(ctx: TraceContext) -> bytes:
    flags = (FLAG_SAMPLED if ctx.sampled else 0) | (
        FLAG_SHED if ctx.shed else 0)
    stages = ctx.stages[:255]
    parts = [_CORE.pack(VERSION, flags, ctx.trace_id & (2**64 - 1),
                        ctx.span_id & (2**64 - 1), ctx.t_send_ns,
                        ctx.t_recv_ns, ctx.t_reply_ns, len(stages))]
    for kind, t0, t1 in stages:
        parts.append(_STAGE.pack(kind & 0xFF, t0, t1))
    return b"".join(parts)


def parse(data: bytes) -> Optional[TraceContext]:
    """Parse one trace header blob. Forward-compatible: a newer peer's
    longer core (trailing bytes past the stages) is skipped, unknown
    stage kinds are preserved verbatim. Returns None only when the blob
    is too short to carry even the v1 core — a truncated header must
    not kill the connection (the payload framing is independent)."""
    if len(data) < _CORE.size:
        return None
    ver, flags, trace_id, span_id, t1, t2, t3, n = _CORE.unpack_from(data, 0)
    ctx = TraceContext(
        trace_id=trace_id, span_id=span_id,
        sampled=bool(flags & FLAG_SAMPLED), shed=bool(flags & FLAG_SHED),
        t_send_ns=t1, t_recv_ns=t2, t_reply_ns=t3)
    off = _CORE.size
    for _ in range(n):
        if off + _STAGE.size > len(data):
            break  # truncated stage block: keep what parsed
        kind, s0, s1 = _STAGE.unpack_from(data, off)
        ctx.stages.append((kind, s0, s1))
        off += _STAGE.size
    # anything after the declared stages (a NEWER peer's extension) is
    # deliberately ignored — skipped, not fatal
    return ctx


def reply_context(req: TraceContext, *, shed: bool = False,
                  shed_reason: str = "") -> TraceContext:
    """The server's reply header for a request that carried ``req``:
    echoes trace id and the client send stamp, adds the server receive
    stamp and a fresh server span id. Stage timings are appended by the
    serving path as the request moves through it."""
    return TraceContext(
        trace_id=req.trace_id, span_id=new_id(), sampled=req.sampled,
        shed=shed, shed_reason=shed_reason, t_send_ns=req.t_send_ns,
        t_recv_ns=req.t_wire_recv_ns)


def clock_sample(ctx: TraceContext) -> Optional[Tuple[int, int, int, int]]:
    """The (t1, t2, t3, t4) NTP-style sample one traced reply carries:
    client-send, server-recv, server-send, client-recv — the input to
    :func:`nnstreamer_tpu_torch.edge.ntp.estimate_offset`."""
    t1, t2, t3, t4 = (ctx.t_send_ns, ctx.t_recv_ns, ctx.t_reply_ns,
                      ctx.t_wire_recv_ns)
    if not (t1 and t2 and t3 and t4) or t4 < t1 or t3 < t2:
        return None
    return (t1, t2, t3, t4)


def decompose(ctx: TraceContext) -> Optional[Dict[str, float]]:
    """Client-side per-request SLO decomposition, in milliseconds.

    Every component is a *duration* — the server stages in the server's
    clock, the RTT in the client's — so no clock offset enters:
    ``network_ms = rtt - (t3 - t2)`` and the stage durations tile
    ``t3 - t2`` (the residual the stages don't cover is
    ``unattributed_ms``). Returns None when the reply carried no usable
    timing (an untraced or half-stamped exchange)."""
    sample = clock_sample(ctx)
    if sample is None:
        return None
    t1, t2, t3, t4 = sample
    rtt_ns = t4 - t1
    server_ns = t3 - t2
    comp = {"queue_ms": 0.0, "batch_ms": 0.0, "device_ms": 0.0,
            "reply_ms": 0.0}
    staged_ns = 0
    for kind, s0, s1 in ctx.stages:
        key = _COMPONENT_OF.get(kind)
        if key is None:
            continue  # unknown stage from a newer peer: skipped
        d = max(0, s1 - s0)
        comp[key] += d / 1e6
        staged_ns += d
    out = {
        "trace_id": ctx.trace_hex,
        "rtt_ms": rtt_ns / 1e6,
        "network_ms": max(0.0, (rtt_ns - server_ns)) / 1e6,
        "server_ms": server_ns / 1e6,
        "unattributed_ms": max(0, server_ns - staged_ns) / 1e6,
        **comp,
    }
    if ctx.shed:
        out["shed"] = ctx.shed_reason or "overload"
    return out


#: the component keys (sum ≈ rtt_ms) bench aggregates into p50/p99
COMPONENT_KEYS = ("network_ms", "queue_ms", "batch_ms", "device_ms",
                  "reply_ms", "unattributed_ms")


def emit_request_spans(spans, ctx: TraceContext) -> Optional[int]:
    """Emit one request's cross-process waterfall into a client-side span
    ring: the server stages are rebased into the client's timebase with
    this request's own NTP sample (offset error ≤ delay/2, so rebased
    stages always land inside the client's send→reply window — clamped
    anyway for the validator's monotonic-track contract). Async spans on
    the ``request:<trace_id>`` virtual track, ids unique per stage.
    Returns the per-request offset (client−server, ns) or None when the
    reply carried no usable sample."""
    sample = clock_sample(ctx)
    if sample is None:
        if ctx.shed and ctx.t_send_ns and ctx.t_wire_recv_ns:
            track = f"request:{ctx.trace_hex}"
            spans.emit(f"shed:{ctx.shed_reason or 'overload'}", "tracex",
                       ctx.t_send_ns / 1e9, ctx.t_wire_recv_ns / 1e9,
                       track=track, aid=f"{ctx.trace_hex}/shed",
                       args={"trace_id": ctx.trace_hex,
                             "shed_reason": ctx.shed_reason or "overload",
                             "terminated": True})
        return None
    t1, t2, t3, t4 = sample
    # client − server, same convention as ntp.estimate_offset: ADD it to
    # a server stamp to land in the client's timebase
    offset_ns = ((t1 - t2) + (t4 - t3)) // 2
    track = f"request:{ctx.trace_hex}"

    def emit(name, a_ns, b_ns, stage_key, extra=None):
        a = min(max(a_ns, t1), t4) / 1e9
        b = min(max(b_ns, t1), t4) / 1e9
        args = {"trace_id": ctx.trace_hex}
        if extra:
            args.update(extra)
        spans.emit(name, "tracex", a, b, track=track,
                   aid=f"{ctx.trace_hex}/{stage_key}", args=args)

    t2c, t3c = t2 + offset_ns, t3 + offset_ns
    for j, (name, c0, c1) in enumerate(ctx.client_spans):
        # client-local legs (serialize/deserialize): trusted stamps in
        # the client's own clock — emitted unclamped
        spans.emit(name, "tracex", c0 / 1e9, max(c0, c1) / 1e9,
                   track=track, aid=f"{ctx.trace_hex}/c{j}-{name}",
                   args={"trace_id": ctx.trace_hex})
    emit("net-request", t1, t2c, "net-req")
    for i, (kind, s0, s1) in enumerate(ctx.stages):
        name = STAGE_NAMES.get(kind, f"stage-{kind}")
        emit(name, s0 + offset_ns, s1 + offset_ns, f"s{i}-{name}")
    emit("net-reply", t3c, t4, "net-rep")
    if ctx.shed:
        emit(f"shed:{ctx.shed_reason or 'overload'}", t2c, t3c, "shed",
             {"shed_reason": ctx.shed_reason or "overload",
              "terminated": True})
    return offset_ns
