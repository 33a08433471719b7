"""Fleet-resilience primitives: health TLV codec, hedge dedup, endpoint
scoring (nnfleet-r).

Three small, independently testable pieces the fleet layer is built
from:

* **Health TLV** — the capacity gossip that rides MSG_CAPABILITY as a
  *payload* (never meta): ``NTHL`` magic + u8 version, then
  ``u8 type | u16 len | value`` entries. Old peers parse the capability
  frame, ignore payloads they never asked about, and see byte-identical
  legacy meta — the same compat contract as the nntrace-x header
  (protocol.py docstring). Unknown TLV types are length-delimited and
  skipped, so a newer server's extra fields never break an older fleet
  client.

* **RidFilter** — the server-side hedge dedup: a bounded
  recently-seen-request-id set. A hedged resend carries the same
  ``_rid`` (derived from the client's ``_seq`` + connection identity) as
  the original, so whichever copy arrives second is shed as
  ``hedge-duplicate`` instead of invoked twice. Bounded (ring) because
  a serving process lives for days.

* **Endpoint parsing/scoring** — ``endpoints=host:port,host:port`` and
  the headroom score the fleet client routes by (advertised queue depth
  + shed rate; lower is better, blacklisted is worst).
"""

from __future__ import annotations

import struct
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from nnstreamer_tpu_torch.analysis import lockwitness

HEALTH_MAGIC = b"NTHL"
HEALTH_VERSION = 1

_TLV_HEAD = struct.Struct("<BH")  # type, value length
_U32 = struct.Struct("<I")
_U16 = struct.Struct("<H")

#: TLV types (append-only wire contract — never renumber)
TLV_DEPTH = 1          # u32: admission queue depth (pending requests)
TLV_INFLIGHT = 2       # u32: dispatched-but-unacked serve batches
TLV_SHED_PERMILLE = 3  # u16: shed rate over the live ctl window, ‰
TLV_SERVE_BATCH = 4    # u16: current serve-batch size
TLV_SLO_MS = 5         # u32: declared SLO (ms), 0 = none

_U32_TYPES = (TLV_DEPTH, TLV_INFLIGHT, TLV_SLO_MS)
_U16_TYPES = (TLV_SHED_PERMILLE, TLV_SERVE_BATCH)

_KEY_BY_TLV = {
    TLV_DEPTH: "depth",
    TLV_INFLIGHT: "inflight",
    TLV_SHED_PERMILLE: "shed_permille",
    TLV_SERVE_BATCH: "serve_batch",
    TLV_SLO_MS: "slo_ms",
}
_TLV_BY_KEY = {v: k for k, v in _KEY_BY_TLV.items()}


def pack_health(health: Dict[str, int]) -> bytes:
    """Encode a health dict into the NTHL TLV payload. Unknown keys are
    ignored (forward compat is the *decoder's* job; the encoder only
    ships what this version defines)."""
    parts = [HEALTH_MAGIC, bytes((HEALTH_VERSION,))]
    for key in ("depth", "inflight", "shed_permille", "serve_batch",
                "slo_ms"):
        if key not in health:
            continue
        t = _TLV_BY_KEY[key]
        v = max(0, int(health[key]))
        if t in _U32_TYPES:
            body = _U32.pack(min(v, 0xFFFFFFFF))
        else:
            body = _U16.pack(min(v, 0xFFFF))
        parts.append(_TLV_HEAD.pack(t, len(body)))
        parts.append(body)
    return b"".join(parts)


def parse_health(raw: bytes) -> Optional[Dict[str, int]]:
    """Decode an NTHL payload; None when it isn't one (wrong magic /
    truncated — the frame survives, the payload is just not health).
    Unknown TLV types are skipped by length, never fatal."""
    if len(raw) < 5 or raw[:4] != HEALTH_MAGIC:
        return None
    out: Dict[str, int] = {}
    off = 5  # magic + version; future versions only ever append TLVs
    while off + _TLV_HEAD.size <= len(raw):
        t, ln = _TLV_HEAD.unpack_from(raw, off)
        off += _TLV_HEAD.size
        if off + ln > len(raw):
            break  # truncated trailing TLV: keep what parsed cleanly
        body = raw[off:off + ln]
        off += ln
        key = _KEY_BY_TLV.get(t)
        if key is None:
            continue  # newer peer's TLV — skipped, not fatal
        try:
            if t in _U32_TYPES and ln == _U32.size:
                out[key] = _U32.unpack(body)[0]
            elif t in _U16_TYPES and ln == _U16.size:
                out[key] = _U16.unpack(body)[0]
        except struct.error:  # pragma: no cover — lengths checked above
            continue
    return out


class RidFilter:
    """Bounded recently-seen request-id set (server-side hedge dedup).

    ``seen(rid)`` returns True when ``rid`` was already admitted —
    the caller sheds the duplicate instead of invoking it twice. The
    window is a ring (OrderedDict in insertion order): old rids age out,
    which is correct because a hedge races its original by milliseconds,
    not by thousands of requests."""

    def __init__(self, capacity: int = 4096):
        self.capacity = max(16, int(capacity))
        self._seen: "OrderedDict[str, None]" = OrderedDict()
        self._lock = lockwitness.make_lock("edge.fleet.dedup")
        #: monotonic duplicate count — tests pin this at 0 to prove a
        #: hedge was never double-invoked, the chaos bench reports it
        self.dupes = 0

    def seen(self, rid: Optional[str]) -> bool:
        if not rid:
            return False  # legacy frames carry no rid: never deduped
        with self._lock:
            if rid in self._seen:
                self.dupes += 1
                return True
            self._seen[rid] = None
            while len(self._seen) > self.capacity:
                self._seen.popitem(last=False)
            return False


def parse_endpoints(spec: str) -> List[Tuple[str, int]]:
    """``host:port,host:port,…`` → ordered unique (host, port) list.
    Raises ValueError on malformed entries (the element surfaces it as a
    property error at start)."""
    out: List[Tuple[str, int]] = []
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        host, _, port_s = part.rpartition(":")
        if not host or not port_s.isdigit():
            raise ValueError(f"malformed endpoint {part!r} "
                             "(expected host:port)")
        ep = (host, int(port_s))
        if ep not in out:
            out.append(ep)
    return out


def headroom_score(health: Optional[Dict[str, int]]) -> float:
    """Lower is better. No advertisement yet = neutral 0.5 (a fresh
    endpoint should win over a visibly loaded one but lose to a
    provably idle one). Depth dominates; shed rate is a strong penalty
    (a shedding server has NO headroom regardless of queue depth)."""
    if not health:
        return 0.5
    depth = float(health.get("depth", 0))
    inflight = float(health.get("inflight", 0))
    shed = float(health.get("shed_permille", 0)) / 1000.0
    return depth + 0.5 * inflight + 100.0 * shed
