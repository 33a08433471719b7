"""nnsan-c static side — thread-topology lint (NNST62x); counterpart of
the JAX package's ``analysis/threads.py``.

The lock witness (:mod:`analysis.lockwitness`) checks the schedules a
run actually takes; this pass checks the topology a launch line *would*
spawn, without PLAYING anything. The model is cheap and structural: a
``serve=1`` query server runs the streaming thread plus the scheduler's
ingest path, ``replicas=N`` adds N dispatch workers fed through bounded
per-replica inboxes, the serversink acks each demuxed batch back to the
scheduler (the in-flight window drains ONLY on that ack), ``ctl=1``
adds the controller tick thread, and ``serve-queue-depth`` bounds
admission. Three lints ride on the model:

  NNST620  thread-topology summary (info): the threads, channels and
           bounds a serving route will run — the map a human needs
           before reading a witness report.
  NNST621  bounded-capacity wait cycle (warning): with replicas the
           reply path closes a loop — replica in-flight windows drain
           only on the serversink's ack, the admission pool is bounded,
           and an UNBOUNDED reply send (no ``timeout=`` on the
           serversink) can block the streaming thread forever on one
           dead client; everything upstream then backs up until the
           route stalls.
  NNST622  blocking-reply hazard (warning): a serversink sync send with
           no ``timeout=`` bound blocks the streaming thread on the
           slowest client's socket — one stuck receiver stalls every
           other client's replies.

Pipelines with no query serversink and no ``serve=1`` emit nothing —
default analyzer output stays byte-identical.
"""

from __future__ import annotations

from typing import List, Optional


def _reply_bounded(sink) -> bool:
    """Whether the serversink's reply send carries a timeout bound
    (``timeout=`` unset or <=0 means block forever)."""
    try:
        return float(sink.properties.get("timeout", 0) or 0) > 0
    except (TypeError, ValueError):
        return False


def _paired_sinks(pipeline, src) -> List:
    """The serversinks routing this server's replies (same ``id`` key)."""
    from nnstreamer_tpu_torch.elements.query import TensorQueryServerSink

    key = str(src.properties.get("id", "0"))
    return [e for e in pipeline.elements.values()
            if isinstance(e, TensorQueryServerSink)
            and str(e.properties.get("id", "0")) == key]


def _requested_replicas(src) -> Optional[object]:
    from nnstreamer_tpu_torch.analysis.pool import requested_replicas

    return requested_replicas(src)


def describe_topology(pipeline, src) -> str:
    """Deterministic one-line thread/wait-for map for one ``serve=1``
    route (the NNST620 payload; also reused by tests)."""
    sinks = _paired_sinks(pipeline, src)
    req = _requested_replicas(src)
    depth = int(src.properties.get("serve_queue_depth", 64) or 0)
    parts = [
        "streaming thread (scheduler next-batch -> filter -> serversink)",
        "per-client recv threads -> scheduler ingest (ONE scheduler lock)",
    ]
    if req is not None:
        n = "auto" if req == "auto" else str(req)
        parts.append(f"{n} replica dispatch workers (bounded inboxes, "
                     f"in-flight windows drain on serversink ack)")
    if sinks:
        parts.append("serversink reply sends ("
                     + ", ".join(
                         f"{s.name}: "
                         + ("bounded" if _reply_bounded(s) else "UNBOUNDED")
                         for s in sorted(sinks, key=lambda e: e.name))
                     + ") -> ack channel back to the scheduler")
    if bool(src.properties.get("ctl")):
        iv = src.properties.get("ctl_interval_ms", 100) or 100
        parts.append(f"nnctl tick thread ({iv} ms)")
    parts.append("admission: "
                 + (f"bounded (serve-queue-depth={depth})" if depth > 0
                    else "UNBOUNDED (see NNST901)"))
    return "; ".join(parts)


def threads_pass_body(ctx) -> None:
    from nnstreamer_tpu_torch.elements.query import (TensorQueryServerSink,
                                               TensorQueryServerSrc)

    pipeline = ctx.pipeline
    for e in pipeline.elements.values():
        if isinstance(e, TensorQueryServerSink) and not _reply_bounded(e):
            ctx.emit(
                "NNST622", e,
                f"serversink {e.name!r} sends replies synchronously on "
                f"the streaming thread with no timeout= bound: one stuck "
                f"client socket (full TCP window, dead peer before the "
                f"RST) blocks the send forever, stalling every other "
                f"client's replies behind it",
                hint="set timeout=<seconds> on this tensor_query_"
                     "serversink (a timed-out reply is dropped loudly: "
                     "fault record + tracer drop counter)",
                span=getattr(e, "_prop_spans", {}).get("timeout"))

    for src in pipeline.elements.values():
        if not isinstance(src, TensorQueryServerSrc):
            continue
        if not bool(src.properties.get("serve")):
            continue
        ctx.emit("NNST620", src,
                 f"thread topology of serving route "
                 f"{str(src.properties.get('id', '0'))!r}: "
                 + describe_topology(pipeline, src))
        req = _requested_replicas(src)
        if req is None:
            continue
        unbounded = [s for s in _paired_sinks(pipeline, src)
                     if not _reply_bounded(s)]
        if not unbounded:
            continue
        names = ", ".join(sorted(s.name for s in unbounded))
        ctx.emit(
            "NNST621", src,
            f"bounded-capacity wait cycle on serving route "
            f"{str(src.properties.get('id', '0'))!r}: replica in-flight "
            f"windows drain only on the serversink ack, the ack is sent "
            f"AFTER the reply, and the reply send ({names}) has no "
            f"timeout= bound — one dead client wedges a replica's "
            f"window, the bounded admission pool backs up behind it, "
            f"and the whole route stalls (replicas -> ack-drain -> "
            f"pending-drain cycle)",
            hint=f"set timeout= on {names} so a stuck reply is dropped "
                 f"(loudly) instead of wedging the dispatch window")


def analyze_threads(pipeline):
    """Standalone entry mirroring the other analyzers: the NNST62x
    diagnostics for ``pipeline`` as (code, element name, message)
    triples — tests use this without building a full lint context."""
    out = []

    class _Ctx:
        def __init__(self, p):
            self.pipeline = p

        def emit(self, code, element, message, hint=None, span=None):
            name = getattr(element, "name", str(element))
            out.append((code, name, message))

    threads_pass_body(_Ctx(pipeline))
    return out
