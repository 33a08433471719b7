"""Fault-injection harness: named fault points installable from tests and
from ``bench.py --inject``.

The error-policy runtime (``on-error=…``), the invoke watchdog
(``invoke-timeout-ms``), backend fallback, and the edge reconnect paths
all exist to survive failures that are rare and timing-dependent in the
wild. This module makes them deterministic: production code calls
:func:`check` at a handful of *named fault points*, and a test (or a
bench leg) arms a point with :func:`install` to make the failure happen
on demand — on CPU, with no TPU or flaky network required.

Named fault points (stable API — tests and ``bench.py --inject`` use
these names):

========== =====================================================
invoke-raise    raise :class:`FaultInjected` from inside the filter's
                backend invoke (checked in ``elements/filter.py``)
invoke-hang     sleep ``delay_s`` inside the backend invoke — trips the
                ``invoke-timeout-ms`` watchdog without a hung backend
socket-drop     hard-close the socket instead of sending — peers see a
                dropped connection (``edge/protocol.send_message``)
partial-write   send only the first half of the wire frame, then close
                (truncated-frame handling on the receive side)
slow-link       sleep ``delay_s`` before each send (RTT inflation)
accept-hang     sleep ``delay_s`` inside the server's accept loop —
                new connections stall while existing ones keep
                streaming (``edge/handle.EdgeServer``)
byzantine-reply corrupt the first payload's flexible-tensor header
                before encoding — the wire frame stays structurally
                valid but ``unwrap_flexible`` on the peer raises
                (``edge/protocol.send_message``)
link-flap       recurring hard-close: every ``every``-th matching send
                drops the connection instead (a flapping link, not a
                single cut — ``edge/protocol.send_message``)
proc-kill       no in-process fault point; :func:`proc_kill` SIGKILLs a
                subprocess server for two-process failover tests
========== =====================================================

A fault is scoped by (``times``, ``after``, ``match``): it fires on the
``after+1``-th through ``after+times``-th passages whose *tag* (usually
the element or endpoint name) contains ``match``, then disarms itself.
The module-level fast path (`_armed`) keeps the hot-loop cost of an
unarmed harness to one attribute read.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from nnstreamer_tpu_torch.analysis import lockwitness

NAMES = ("invoke-raise", "invoke-hang", "socket-drop", "partial-write",
         "slow-link", "accept-hang", "byzantine-reply", "link-flap")


class FaultInjected(RuntimeError):
    """Raised by an armed ``invoke-raise`` fault point (and usable by
    custom test fault points). Deliberately a plain RuntimeError so the
    error-policy runtime treats it like any real backend failure."""


@dataclass
class Fault:
    name: str
    times: Optional[int] = 1  # how many times to fire; None = forever
    delay_s: float = 0.0      # hang/slow duration
    after: int = 0            # skip the first N passages
    match: str = ""           # only fire when the tag contains this
    every: int = 1            # fire on every N-th eligible passage (flap cadence)
    fired: int = 0
    seen: int = 0
    #: tags of the passages that fired (attribution for assertions)
    trips: List[str] = field(default_factory=list)


_active: Dict[str, Fault] = {}
_lock = lockwitness.make_lock("testing.faults")
_armed = False  # fast path: hot loops read this before taking the lock


def install(name: str, times: Optional[int] = 1, delay_s: float = 0.0,
            after: int = 0, match: str = "", every: int = 1) -> Fault:
    """Arm a named fault point. Returns the live Fault record (its
    ``fired``/``trips`` fields update as the point fires)."""
    global _armed
    if name not in NAMES:
        raise ValueError(f"unknown fault point {name!r}; known: {NAMES}")
    f = Fault(name=name, times=times, delay_s=delay_s, after=after,
              match=match, every=max(1, int(every)))
    with _lock:
        _active[name] = f
        _armed = True
    return f


def clear(name: Optional[str] = None) -> None:
    """Disarm one fault point, or all of them (``clear()`` belongs in
    every test's teardown — faults are process-global)."""
    global _armed
    with _lock:
        if name is None:
            _active.clear()
        else:
            _active.pop(name, None)
        _armed = bool(_active)


def active() -> Dict[str, Fault]:
    with _lock:
        return dict(_active)


def check(name: str, tag: str = "") -> Optional[Fault]:
    """Called by production code at a fault point: returns the armed
    Fault when it should fire for this passage, else None. Unarmed cost
    is a single module-attribute read."""
    if not _armed:
        return None
    with _lock:
        f = _active.get(name)
        if f is None:
            return None
        if f.match and f.match not in tag:
            return None
        f.seen += 1
        if f.seen <= f.after:
            return None
        if f.times is not None and f.fired >= f.times:
            return None
        if f.every > 1 and (f.seen - f.after) % f.every != 0:
            return None  # flap cadence: only every N-th eligible passage
        f.fired += 1
        f.trips.append(tag)
        return f


def parse_spec(spec: str) -> Fault:
    """Parse a ``bench.py --inject`` spec and install it.

    Grammar: ``name[:key=value[:key=value…]]`` with keys
    ``times`` (int | 'inf'), ``delay_ms`` (float), ``after`` (int),
    ``match`` (str), ``every`` (int). Example:
    ``invoke-hang:delay_ms=500:times=2`` or
    ``link-flap:every=20:times=inf``."""
    parts = spec.split(":")
    name = parts[0].strip()
    kwargs: dict = {}
    for part in parts[1:]:
        if not part.strip():
            continue
        k, _, v = part.partition("=")
        k = k.strip().replace("-", "_")
        v = v.strip()
        if k == "times":
            kwargs["times"] = None if v in ("inf", "forever") else int(v)
        elif k == "delay_ms":
            kwargs["delay_s"] = float(v) / 1e3
        elif k == "after":
            kwargs["after"] = int(v)
        elif k == "match":
            kwargs["match"] = v
        elif k == "every":
            kwargs["every"] = int(v)
        else:
            raise ValueError(f"unknown fault spec key {k!r} in {spec!r}")
    return install(name, **kwargs)


def corrupt_flexible_payload(raw: bytes) -> bytes:
    """The ``byzantine-reply`` corruption: flip bytes inside the flexible
    tensor wrap's dims region (header bytes 12..44) so the frame still
    parses at the wire layer — magic intact, lengths intact — but
    ``meta.unwrap_flexible`` on the receiving peer rejects it. A peer
    that validates payloads drops the FRAME; one that trusts them would
    feed garbage shapes downstream."""
    if len(raw) < 44:
        return bytes(b ^ 0xFF for b in raw)  # too short to target dims
    buf = bytearray(raw)
    for i in range(12, 44):
        buf[i] ^= 0xA5
    return bytes(buf)


def proc_kill(proc) -> None:
    """SIGKILL a subprocess server (two-process chaos scenarios). Not an
    in-process fault point: the whole point is that the peer dies without
    a goodbye — no MSG_BYE, no FIN ordering guarantees."""
    import signal

    try:
        proc.send_signal(signal.SIGKILL)
    except (ProcessLookupError, OSError):
        pass  # already dead — the scenario still holds
    try:
        proc.wait(timeout=5.0)
    except Exception:  # noqa: BLE001 — reaped elsewhere / wait unsupported
        pass
