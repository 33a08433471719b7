"""NTP-based cross-device timestamp sync (gst/mqtt/ntputil.c parity).

The reference's MQTT elements stamp outgoing messages with an NTP-derived
epoch so receivers on other devices can align stream clocks
(Documentation/synchronization-in-mqtt-elements.md).

We implement the same SNTP client exchange (mode 3 request → server
transmit timestamp) with a fallback to the local clock when no NTP server
is reachable (common in airgapped deployments and CI).

A copy of the JAX package's module: the SNTP client (``sntp_query``,
``get_epoch``, which mqttsink samples once at start when ``ntp=true``),
the clock-offset estimate and :class:`ClockSync` (edgesrc's and mqttsrc's
timestamp rebasing).
"""

from __future__ import annotations

import socket
import struct
import time
from dataclasses import dataclass
from typing import Iterable, Optional, Sequence, Tuple

# seconds between NTP epoch (1900) and Unix epoch (1970)
NTP_DELTA = 2208988800
DEFAULT_SERVERS = (("pool.ntp.org", 123),)


def sntp_query(host: str, port: int = 123, timeout: float = 1.0) -> float:
    """One SNTP exchange; returns the server's transmit time as a Unix
    epoch float (ntputil_get_epoch, ntputil.c:140)."""
    packet = bytearray(48)
    packet[0] = (0 << 6) | (4 << 3) | 3  # LI=0, VN=4, mode=3 (client)
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.settimeout(timeout)
        s.sendto(bytes(packet), (host, port))
        data, _ = s.recvfrom(512)
    if len(data) < 48:
        raise ValueError("short NTP response")
    secs, frac = struct.unpack("!II", data[40:48])  # transmit timestamp
    return secs - NTP_DELTA + frac / 2**32


def get_epoch(
    servers: Optional[Sequence] = None, timeout: float = 1.0
) -> int:
    """Best-effort epoch in microseconds: first reachable NTP server wins,
    else the local wall clock (the reference falls back the same way).
    ``servers=[]`` explicitly skips the network and uses the local clock."""
    for entry in DEFAULT_SERVERS if servers is None else servers:
        host, port = entry if isinstance(entry, (tuple, list)) else (entry, 123)
        try:
            return int(sntp_query(str(host), int(port), timeout) * 1e6)
        except (OSError, ValueError):
            continue
    return int(time.time() * 1e6)


@dataclass
class OffsetEstimate:
    """Clock offset between two monotonic clocks, from NTP-style
    four-stamp samples (t1 local-send, t2 remote-recv, t3 remote-send,
    t4 local-recv). ``offset_ns`` is LOCAL − REMOTE: add it to a remote
    stamp to land in the local timebase. ``err_ns`` is the classic
    worst-case bound — half the round-trip delay of the best sample —
    which holds for ANY split of that delay between the two directions
    (asymmetric links shift the estimate, never past the bound)."""

    offset_ns: int
    delay_ns: int
    err_ns: int
    n_samples: int

    def good(self, max_err_ns: int) -> bool:
        return self.err_ns <= int(max_err_ns)


def estimate_offset(
    samples: Iterable[Tuple[int, int, int, int]],
) -> Optional[OffsetEstimate]:
    """Estimate the local−remote clock offset from (t1, t2, t3, t4)
    samples (ns). The minimum-delay sample wins (Cristian/NTP filter:
    the least-queued exchange bounds the error tightest); offset =
    ((t1−t2) + (t4−t3)) / 2 — LOCAL minus REMOTE under the
    symmetric-delay assumption, with ``err_ns = delay/2`` as the
    asymmetry-proof bound. Returns None when no sample is usable
    (empty, or non-causal stamps)."""
    best = None
    n = 0
    for t1, t2, t3, t4 in samples:
        if t4 < t1 or t3 < t2 or (t4 - t1) < (t3 - t2):
            continue  # non-causal: corrupt or cross-paired stamps
        n += 1
        delay = (t4 - t1) - (t3 - t2)
        if best is None or delay < best[0]:
            best = (delay, ((t1 - t2) + (t4 - t3)) // 2)
    if best is None:
        return None
    delay, offset = best
    return OffsetEstimate(offset_ns=int(offset), delay_ns=int(delay),
                          err_ns=int(delay) // 2 + 1, n_samples=n)


class ClockSync:
    """Tracks the epoch offset between this host and a stream publisher so
    received buffer timestamps can be rebased onto the local clock."""

    def __init__(self):
        self._offset_us = 0

    def observe(self, remote_epoch_us: int, local_epoch_us: Optional[int] = None) -> None:
        local = local_epoch_us if local_epoch_us is not None else int(time.time() * 1e6)
        self._offset_us = local - remote_epoch_us

    @property
    def offset_us(self) -> int:
        return self._offset_us

    def to_local_ns(self, remote_pts_ns: int) -> int:
        if remote_pts_ns < 0:
            return remote_pts_ns
        return remote_pts_ns + self._offset_us * 1000
