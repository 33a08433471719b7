"""Lock-witness runtime sanitizer (nnsan-c) — ``NNSTPU_SANITIZE=1``
(counterpart of the JAX package's ``analysis/lockwitness.py``).

The serving stack is concurrent — the serversink→scheduler ack channel,
the controller tick thread, fleet redial/hedge threads, per-client recv
threads, the filter's invoke watchdog — held together by lock contracts
(the scheduler SINGLE lock, the chain head→member order). Every framework
lock site creates its lock through :func:`make_lock` / :func:`make_rlock`
/ :func:`make_condition`, and with the sanitizer on each lock is a
*witness* recording per-thread acquisition stacks and a global lock-order
graph. Four checks ride on that record, all reported as
:mod:`analysis.sanitizer` violations:

  NNST610  **lock-order inversion**: acquiring B while holding A adds
           the edge A→B to the order graph; if a path B→…→A already
           exists, two threads can deadlock under the right schedule.
           Reported with BOTH acquisition stacks and thread names, on
           the *potential* — this schedule need not actually deadlock
           (and the report never blocks: violations are recorded, not
           raised mid-acquire).
  NNST611  **blocking call under a framework lock**: a socket
           send/recv, device sync, subprocess spawn or sleep runs while
           a lock not declared ``blocking_ok`` is held — every other
           user of that lock stalls for the full blocking latency.
           Chokepoints: the wire protocol send/recv and a patched
           ``time.sleep`` (installed with the sanitizer). The patch wraps
           whatever ``time.sleep`` is when it is installed (the JAX
           package's witness may have patched it already in the same
           process) and puts exactly that back when it is removed.
  NNST612  **cross-thread handoff mutation**: :func:`handoff_send`
           freezes host arrays (``WRITEABLE``) and fingerprints what
           crosses a thread boundary; :func:`handoff_recv` re-checks — a
           mismatch names the channel and both threads. Host arrays are
           fingerprinted by their bytes; a torch tensor by its version
           counter (``_version``, moved by every in-place write through
           any view), so a tensor on the card is never fetched to the
           host to be checked.
  NNST613  **lock held across a backend invoke** (warning): contention
           hazard — the device latency is paid by every waiter. Locks
           that exist to serialize invokes (the filter window lock) opt
           out with ``invoke_ok=True``.

Overhead discipline: with the sanitizer OFF the factories return plain
``threading`` primitives — zero wrapper objects, zero per-acquire cost.
Module-level locks created at import time are plain unless
``NNSTPU_SANITIZE=1`` was set at process launch; instance locks created
after ``sanitizer.enable(True)`` are witnessed either way.

Witness internals use plain locks and never call back into witnessed
code, so the witness cannot deadlock with the locks it watches.
Acquisition stacks are captured as raw (file, line, function) frame
walks — formatting is deferred to the moment a violation is reported.

Per-lock held-time and wait-time histograms (the tracer ``locks``
section, HIST_LE_US contract) accumulate here as a side effect of the
same instrumentation; sanitizer-off reports carry no ``locks`` section
and stay byte-identical.
"""

from __future__ import annotations

import sys
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

import torch

from nnstreamer_tpu_torch.analysis import sanitizer
from nnstreamer_tpu_torch.testing import schedfuzz

__all__ = [
    "make_lock", "make_rlock", "make_condition", "blocking_call",
    "check_invoke", "handoff_send", "handoff_recv", "held_locks",
    "order_edges", "locks_report", "reset", "install_probes",
    "uninstall_probes",
]

#: frames kept per acquisition stack (raw tuples; formatted lazily)
STACK_DEPTH = 8
#: handoff side-table cap: entries never received are evicted FIFO
HANDOFF_CAP = 4096

_tls = threading.local()

# witness bookkeeping lock (plain on purpose: the witness must never
# witness itself) guarding the order graph, stats and handoff table
_wlock = threading.Lock()
#: order graph: src lock name -> {dst lock name: (thread, stack_src,
#: stack_dst)} — the stacks are those of the two acquisitions that
#: created the edge (holding src, acquiring dst)
_edges: Dict[str, Dict[str, Tuple[str, tuple, tuple]]] = {}
#: cycles already reported (frozenset of edge names) — one NNST610 per
#: distinct inversion, not one per schedule repetition
_reported: set = set()
#: per-lock-name stats: acquisitions/contended counters + held/wait
#: histograms (trace._Hist, imported lazily to avoid an import cycle)
_stats: Dict[str, dict] = {}
#: in-flight handoffs: id(token) -> (channel, fingerprint, sender thread)
_handoffs: Dict[int, Tuple[str, tuple, str]] = {}
_handoff_order: List[int] = []


def _held() -> list:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


def _capture_stack() -> tuple:
    """Raw frame walk — (file, line, function) tuples, innermost first,
    skipping witness frames. ~1µs; no line-text I/O until formatting."""
    out = []
    f = sys._getframe(2)
    while f is not None and len(out) < STACK_DEPTH:
        co = f.f_code
        if "lockwitness" not in co.co_filename:
            out.append((co.co_filename, f.f_lineno, co.co_name))
        f = f.f_back
    return tuple(out)


def _fmt_stack(stack: tuple) -> str:
    return " <- ".join(f"{fn.rsplit('/', 1)[-1]}:{ln}({fun})"
                       for fn, ln, fun in stack)


def _stat_entry(name: str) -> dict:
    s = _stats.get(name)
    if s is None:
        from nnstreamer_tpu_torch.trace import _Hist

        s = _stats[name] = {"acquisitions": 0, "contended": 0,
                            "held": _Hist(), "wait": _Hist()}
    return s


def _path_exists(src: str, dst: str) -> Optional[List[str]]:
    """BFS in the order graph; returns the node path src..dst or None.
    Caller holds ``_wlock``."""
    if src == dst:
        return [src]
    seen = {src}
    frontier = [[src]]
    while frontier:
        path = frontier.pop(0)
        for nxt in _edges.get(path[-1], ()):
            if nxt == dst:
                return path + [nxt]
            if nxt not in seen:
                seen.add(nxt)
                frontier.append(path + [nxt])
    return None


def _record_inversion(held_name: str, held_stack: tuple, path: List[str],
                      new_stack: tuple) -> None:
    """NNST610: the about-to-be-added edge held_name→path[0] closes the
    cycle path[0]→…→held_name. Caller holds ``_wlock``."""
    key = frozenset(zip(path, path[1:])) | {(held_name, path[0])}
    if key in _reported:
        return
    _reported.add(key)
    me = threading.current_thread().name
    # the reverse ordering's provenance: the first edge of the existing
    # path carries the thread + both stacks that established it
    rev_thread, rev_src_stack, rev_dst_stack = _edges[path[0]][path[1]]
    cycle = " -> ".join(path + [path[0]]) if len(path) > 2 else None
    msg = (
        f"lock-order inversion: thread {me!r} acquires "
        f"{path[0]!r} while holding {held_name!r} "
        f"[{held_name!r} acquired at {_fmt_stack(held_stack)}; "
        f"{path[0]!r} acquired at {_fmt_stack(new_stack)}], but thread "
        f"{rev_thread!r} acquired {path[1]!r} while holding {path[0]!r} "
        f"[{path[0]!r} acquired at {_fmt_stack(rev_src_stack)}; "
        f"{path[1]!r} acquired at {_fmt_stack(rev_dst_stack)}]"
        + (f" (full cycle: {cycle})" if cycle else "")
        + " — a schedule interleaving these threads deadlocks")
    sanitizer._record("NNST610", path[0], msg)


class _Hold:
    __slots__ = ("lock", "stack", "t", "count")

    def __init__(self, lock, stack, t):
        self.lock = lock
        self.stack = stack
        self.t = t
        self.count = 1


class _WitnessBase:
    """Shared acquire/release instrumentation over a real primitive."""

    _reentrant = False

    def __init__(self, name: str, *, blocking_ok: bool = False,
                 invoke_ok: bool = False):
        self.name = name
        self.blocking_ok = blocking_ok
        self.invoke_ok = invoke_ok
        self._real = (threading.RLock() if self._reentrant
                      else threading.Lock())

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        schedfuzz.jitter("lock.acquire", self.name)
        held = _held()
        mine = None
        for h in held:
            if h.lock is self:
                mine = h
                break
        stack = _capture_stack()
        if mine is None and held and sanitizer.active():
            with _wlock:
                for h in held:
                    if h.lock.name == self.name:
                        continue  # same lock class: no self-edge
                    path = _path_exists(self.name, h.lock.name)
                    if path is not None:
                        _record_inversion(h.lock.name, h.stack, path,
                                          stack)
                    dsts = _edges.setdefault(h.lock.name, {})
                    if self.name not in dsts:
                        dsts[self.name] = (
                            threading.current_thread().name, h.stack,
                            stack)
        # contention probe: a non-blocking try-acquire, not .locked()
        # (RLock grew .locked() only recently, and a failed try IS the
        # contended case we want to time)
        if mine is None and self._real.acquire(False):
            contended = False
            self._real.release()
        else:
            contended = mine is None
        t0 = time.perf_counter()
        ok = (self._real.acquire(blocking, timeout) if timeout != -1
              else self._real.acquire(blocking))
        if not ok:
            return False
        now = time.perf_counter()
        if mine is not None:
            mine.count += 1
            return True
        with _wlock:
            s = _stat_entry(self.name)
            s["acquisitions"] += 1
            if contended:
                s["contended"] += 1
                s["wait"].add(now - t0)
        held.append(_Hold(self, stack, now))
        return True

    def release(self) -> None:
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            h = held[i]
            if h.lock is self:
                h.count -= 1
                if h.count == 0:
                    del held[i]
                    with _wlock:
                        _stat_entry(self.name)["held"].add(
                            time.perf_counter() - h.t)
                break
        self._real.release()
        schedfuzz.jitter("lock.release", self.name)

    def locked(self) -> bool:
        try:
            return self._real.locked()
        except AttributeError:  # RLock pre-3.14: probe with a try-acquire
            if self._real.acquire(False):
                self._real.release()
                return False
            return True

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r}>"


class WitnessLock(_WitnessBase):
    _reentrant = False


class WitnessRLock(_WitnessBase):
    _reentrant = True


class WitnessCondition:
    """Condition bound to a witness lock: enter/exit run the witness
    bookkeeping; ``wait`` suspends the hold record (the real lock is
    released for the duration, so held-time must not bill the wait and
    the order graph must not treat post-wait reacquisition as nesting)."""

    def __init__(self, lock: _WitnessBase, name: Optional[str] = None):
        self._witness = lock
        self.name = name or f"{lock.name}.cond"
        self._real = threading.Condition(lock._real)

    def acquire(self, *a, **kw):
        return self._witness.acquire(*a, **kw)

    def release(self):
        self._witness.release()

    def __enter__(self):
        self._witness.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self._witness.release()

    def wait(self, timeout: Optional[float] = None) -> bool:
        held = _held()
        entry = None
        for i in range(len(held) - 1, -1, -1):
            if held[i].lock is self._witness:
                entry = held.pop(i)
                break
        if entry is not None:
            with _wlock:
                _stat_entry(self._witness.name)["held"].add(
                    time.perf_counter() - entry.t)
        try:
            return self._real.wait(timeout)
        finally:
            if entry is not None:
                entry.t = time.perf_counter()
                entry.stack = _capture_stack()
                held.append(entry)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        end = None if timeout is None else time.monotonic() + timeout
        result = predicate()
        while not result:
            remaining = None if end is None else end - time.monotonic()
            if remaining is not None and remaining <= 0:
                break
            self.wait(remaining)
            result = predicate()
        return result

    def notify(self, n: int = 1) -> None:
        self._real.notify(n)

    def notify_all(self) -> None:
        self._real.notify_all()


# --- factories ---------------------------------------------------------------

def make_lock(name: str, *, blocking_ok: bool = False,
              invoke_ok: bool = False):
    """A framework mutex: witness-wrapped when the sanitizer is active at
    creation, a plain ``threading.Lock`` otherwise (zero overhead off).

    ``blocking_ok`` declares the lock's job is to serialize a blocking
    operation (per-connection send mutexes, the dlopen lock) — NNST611
    never fires for it. ``invoke_ok`` declares the lock exists to
    serialize backend invokes — NNST613 never fires for it.
    """
    if not sanitizer.active():
        return threading.Lock()
    _sync_probes()
    return WitnessLock(name, blocking_ok=blocking_ok, invoke_ok=invoke_ok)


def make_rlock(name: str, *, blocking_ok: bool = False,
               invoke_ok: bool = False):
    if not sanitizer.active():
        return threading.RLock()
    _sync_probes()
    return WitnessRLock(name, blocking_ok=blocking_ok,
                        invoke_ok=invoke_ok)


def make_condition(lock, name: Optional[str] = None):
    """Condition over a lock from :func:`make_lock`/:func:`make_rlock`
    (either flavor: witness conditions pair with witness locks, plain
    with plain)."""
    if isinstance(lock, _WitnessBase):
        return WitnessCondition(lock, name)
    return threading.Condition(lock)


# --- NNST611: blocking under a framework lock --------------------------------

def blocking_call(kind: str, detail: str = "") -> None:
    """Chokepoint hook: production code calls this immediately before a
    blocking operation (socket send/recv, device block/compile,
    subprocess). Records NNST611 for every non-``blocking_ok`` witness
    lock the current thread holds."""
    if not sanitizer.active():
        return
    held = getattr(_tls, "held", None)
    if not held:
        return
    now = time.perf_counter()
    site = _fmt_stack(_capture_stack())
    for h in held:
        if h.lock.blocking_ok:
            continue
        sanitizer._record(
            "NNST611", h.lock.name,
            f"blocking call ({kind}{': ' + detail if detail else ''}) "
            f"under framework lock {h.lock.name!r} held for "
            f"{(now - h.t) * 1e3:.3f} ms by thread "
            f"{threading.current_thread().name!r} at {site} "
            f"[lock acquired at {_fmt_stack(h.stack)}]")


#: what ``time.sleep`` was when the probe went in (put back on removal)
_real_sleep = time.sleep
_probes_installed = False


def _witness_sleep(seconds):
    # schedfuzz stalls go through its own captured sleep and never reach
    # this wrapper; a zero-duration sleep is a scheduler hint, not a
    # blocking wait
    if seconds and seconds > 0:
        blocking_call("sleep", f"{float(seconds):g}s")
    _real_sleep(seconds)


def install_probes() -> None:
    """Patch the patchable blocking primitives (``time.sleep``) so
    sleeping under a framework lock is caught even outside the explicit
    chokepoints. The wrapper calls whatever ``time.sleep`` is now.
    Idempotent; :func:`uninstall_probes` restores."""
    global _probes_installed, _real_sleep
    if _probes_installed:
        return
    _real_sleep = time.sleep
    time.sleep = _witness_sleep
    _probes_installed = True


def uninstall_probes() -> None:
    """Put back the ``time.sleep`` the probe wrapped. When another patch
    went in over this one since (it may call this wrapper), the chain
    stays as it is and the probe counts as installed: the wrapper checks
    nothing while the sanitizer is off, and a later install must not
    wrap a patch that calls back into it."""
    global _probes_installed
    if _probes_installed and time.sleep is _witness_sleep:
        time.sleep = _real_sleep
        _probes_installed = False


def _sync_probes() -> None:
    if sanitizer.active():
        install_probes()
    else:
        uninstall_probes()


# --- NNST613: lock held across a backend invoke ------------------------------

def check_invoke(element_name: str) -> None:
    """Called from the sanitizer's invoke gate: every held witness lock
    not declared ``invoke_ok`` is a contention hazard (the device
    latency is paid by all waiters)."""
    held = getattr(_tls, "held", None)
    if not held:
        return
    now = time.perf_counter()
    for h in held:
        if h.lock.invoke_ok:
            continue
        sanitizer._record(
            "NNST613", h.lock.name,
            f"framework lock {h.lock.name!r} held across the backend "
            f"invoke of {element_name!r} (held "
            f"{(now - h.t) * 1e3:.3f} ms at invoke entry, thread "
            f"{threading.current_thread().name!r}; acquired at "
            f"{_fmt_stack(h.stack)}) — every waiter stalls for the "
            f"device latency")


# --- NNST612: cross-thread handoff mutation ----------------------------------

def _fingerprint(arrays) -> tuple:
    """(CRC of the host arrays' bytes, version counters of the torch
    tensors): the bytes of a tensor on the card are never read."""
    fp = 0
    versions = []
    for a in arrays:
        if isinstance(a, torch.Tensor):
            versions.append(a._version)
            continue
        try:
            mv = memoryview(a).cast("B")
        except TypeError:
            continue
        # bytes decide, shape seeds: full-content CRC (sanitizer-only
        # cost), so any aliased write between send and recv flips it
        fp = zlib.crc32(mv, zlib.crc32(repr(getattr(a, "shape", len(mv)))
                                       .encode(), fp))
    return fp, tuple(versions)


def handoff_send(channel: str, token, arrays) -> None:
    """Fingerprint + freeze tensors crossing a thread boundary (queue,
    ack channel, serving route, replica inbox). ``token`` is the object
    that travels (the queue item / pending request): recv looks the
    fingerprint up by its identity."""
    if not sanitizer.active():
        return
    schedfuzz.jitter("handoff.send", channel)
    for a in arrays:
        if hasattr(a, "flags") and a.flags.writeable:
            a.flags.writeable = False  # NNST600-style freeze
    fp = _fingerprint(arrays)
    with _wlock:
        key = id(token)
        if key not in _handoffs and len(_handoff_order) >= HANDOFF_CAP:
            _handoffs.pop(_handoff_order.pop(0), None)
        if key not in _handoffs:
            _handoff_order.append(key)
        _handoffs[key] = (channel, fp, threading.current_thread().name)


def handoff_recv(channel: str, token, arrays) -> None:
    """Verify a handoff on the receiving thread: a fingerprint mismatch
    means some thread mutated the tensors in flight (typically through a
    pre-freeze alias the WRITEABLE bit cannot police)."""
    if not sanitizer.active():
        return
    schedfuzz.jitter("handoff.recv", channel)
    with _wlock:
        rec = _handoffs.pop(id(token), None)
        if rec is not None:
            try:
                _handoff_order.remove(id(token))
            except ValueError:
                pass
    if rec is None:
        return
    sent_channel, fp, sender = rec
    if _fingerprint(arrays) != fp:
        sanitizer._record(
            "NNST612", sent_channel,
            f"cross-thread handoff mutation on channel "
            f"{sent_channel!r}: tensors handed off by thread "
            f"{sender!r} were mutated before thread "
            f"{threading.current_thread().name!r} received them "
            f"(content fingerprint mismatch; an alias created before "
            f"the handoff freeze still writes through)")


# --- introspection / reporting ----------------------------------------------

def held_locks() -> List[str]:
    """Names of the witness locks the current thread holds (tests +
    contract assertions)."""
    return [h.lock.name for h in getattr(_tls, "held", ())]


def order_edges() -> Dict[str, List[str]]:
    """Snapshot of the lock-order graph: {src: sorted [dst, …]}. The
    satellite contract tests pin documented orders on this (e.g. the
    scheduler lock never nests: no edges in or out)."""
    with _wlock:
        return {src: sorted(dsts) for src, dsts in _edges.items()}


def locks_report() -> Dict[str, dict]:
    """Per-lock observability (the tracer ``locks`` section): held-time
    and wait-time histograms on the HIST_LE_US contract plus
    acquisition/contention counters. Empty (section absent, reports
    byte-identical) when no witness lock was ever acquired."""
    out: Dict[str, dict] = {}
    with _wlock:
        for name in sorted(_stats):
            s = _stats[name]
            if not s["acquisitions"]:
                continue
            out[name] = {
                "acquisitions": s["acquisitions"],
                "contended": s["contended"],
                "held_us": s["held"].to_dict(),
                "held_p50_us": round(s["held"].quantile_us(0.5), 3),
                "held_p95_us": round(s["held"].quantile_us(0.95), 3),
                "wait_us": s["wait"].to_dict(),
                "wait_p95_us": round(s["wait"].quantile_us(0.95), 3),
            }
    return out


def reset() -> None:
    """Clear the order graph, stats, handoff table and reported-cycle
    dedup (test isolation; violations are cleared separately through
    ``sanitizer.clear()``)."""
    with _wlock:
        _edges.clear()
        _reported.clear()
        _stats.clear()
        _handoffs.clear()
        del _handoff_order[:]
    _sync_probes()


# a process launched with NNSTPU_SANITIZE=1 gets the sleep probe from
# the first lockwitness import (module-level locks created at import
# time are then witnessed too)
_sync_probes()
