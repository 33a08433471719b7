"""Runtime sanitizer — ``NNSTPU_SANITIZE=1`` (counterpart of the JAX
package's ``analysis/sanitizer.py``).

Three dynamic checks:

  NNST600  **tee aliasing**: after a tee fan-out every branch holds the
           SAME tensor objects; an in-place mutation corrupts the
           siblings. Host ndarrays are frozen (``WRITEABLE=False``), so
           the first in-place write raises and the error interceptor
           turns it into a violation naming the MUTATING element. A
           ``torch.Tensor`` has no such flag: the tee records each
           tensor's version counter (``_version``, shared by views and
           ``detach()``, bumped by every in-place op), and the exit of
           each element's chain compares the counters of the tensors it
           received — the first chain to exit after the write is the one
           that wrote, so the violation names it and not a sibling
           branch. The write has happened by then (the check detects; it
           cannot forbid), and reading a counter never touches the
           device.
  NNST601  **busy gate**: one framework instance must never run two
           invokes concurrently (backends are not reentrant;
           shared-tensor-filter-key and an abandoned watchdog invoke make
           this reachable). Guarded by a test-and-set around every invoke.
  NNST602  **un-billed materialization**: an element that receives the
           backend's tensors (``buffer.is_backend_tensor``) and pushes
           host tensors downstream WITHOUT recording a d2h crossing has
           materialized outside the pipelined-fetch path.

Overhead when disabled: one module-attribute read per hook. Violations
are both recorded (:func:`violations`) and raised as
:class:`SanitizerError` so the element's ``on-error`` policy surfaces them
on the bus with the offending element attached. This module's switch and
records are this package's own: enabling the JAX package's sanitizer
does not arm this one, nor the reverse.
"""

from __future__ import annotations

import contextlib
import os
import threading
import weakref
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from nnstreamer_tpu_torch.log import ElementError, get_logger

log = get_logger("sanitizer")

_tls = threading.local()
_violations: List["Violation"] = []
_vlock = threading.Lock()
_gate_lock = threading.Lock()
#: tee-shared torch tensors: id -> (weakref, version counter at fan-out)
_frozen: Dict[int, Tuple[weakref.ref, int]] = {}
# re-entrant: a weakref callback may run (garbage collection) while the
# thread that triggered it holds the lock
_flock = threading.RLock()


def _env_active() -> bool:
    return os.environ.get("NNSTPU_SANITIZE", "").strip().lower() in (
        "1", "on", "true", "yes")


#: the hot-path switch: read once at import (the env var is a process-
#: launch decision), overridden by enable()/reset(). Every hook costs
#: exactly one module-attribute read when the sanitizer is off.
_enabled: bool = _env_active()


class SanitizerError(ElementError):
    """A sanitizer violation, raised into the element's on-error policy
    (default abort → fatal bus message naming the offending element)."""


@dataclass
class Violation:
    code: str
    element: str
    message: str


def active() -> bool:
    return _enabled


def enable(flag: bool = True) -> None:
    """Force the sanitizer on/off regardless of NNSTPU_SANITIZE (tests)."""
    global _enabled
    _enabled = flag
    _sync_lockwitness()


def reset() -> None:
    """Back to env-var control (re-read now); clear recorded violations."""
    global _enabled
    _enabled = _env_active()
    clear()
    _sync_lockwitness()


def _sync_lockwitness() -> None:
    """Keep the lock-witness probes (patched time.sleep) in step with the
    sanitizer switch. Lazy import: lockwitness imports this module."""
    from nnstreamer_tpu_torch.analysis import lockwitness

    lockwitness._sync_probes()


def violations() -> List[Violation]:
    with _vlock:
        return list(_violations)


def clear() -> None:
    with _vlock:
        _violations.clear()
    with _flock:
        _frozen.clear()


def _record(code: str, element: str, message: str) -> Violation:
    v = Violation(code, element, message)
    with _vlock:
        _violations.append(v)
    log.error("%s [%s] %s", code, element, message)
    return v


# --- chain frames (who is processing what, per thread) ---------------------

def _frames() -> list:
    st = getattr(_tls, "frames", None)
    if st is None:
        st = _tls.frames = []
    return st


def enter_chain(element, buf) -> None:
    """Called by Element._chain_guard on entry (sanitize mode only)."""
    from nnstreamer_tpu_torch.buffer import is_backend_tensor

    tensors = list(getattr(buf, "tensors", ()))
    _frames().append({
        "elem": element,
        "tensors": tensors,
        "dev_in": any(is_backend_tensor(t) for t in tensors),
        "billed_d2h": False,
    })


def exit_chain(element) -> Optional[SanitizerError]:
    """Called by Element._chain_guard when ``element``'s chain returns or
    raises: pops its frame and returns the NNST600 error when the chain
    moved the version counter of a tee-shared torch tensor it received
    (None otherwise). The recorded counter moves on with it, so the
    chains that exit after this one (the tee, upstream elements) do not
    report the same write again."""
    st = _frames()
    if not st or st[-1]["elem"] is not element:
        return None
    fr = st.pop()
    moved = []
    with _flock:
        for t in fr["tensors"]:
            rec = _frozen.get(id(t))
            if rec is None or rec[0]() is not t:
                continue
            v = t._version
            if v != rec[1]:
                moved.append((tuple(t.shape), str(t.device), v - rec[1]))
                _frozen[id(t)] = (rec[0], v)
    if not moved:
        return None
    msg = (f"in-place mutation of a tee-shared tensor in {element.name!r} "
           f"(copy-on-write required): version counter moved on "
           + ", ".join(f"{shape} on {dev} (+{n})" for shape, dev, n in moved))
    _record("NNST600", element.name, msg)
    return SanitizerError(element.name, f"NNST600: {msg}")


def _frame_for(element):
    for fr in reversed(_frames()):
        if fr["elem"] is element:
            return fr
    return None


def note_crossing(element, direction: str) -> None:
    """Element._record_crossing mirror: billing observed for ``element``
    in the current chain frame."""
    if direction != "d2h":
        return
    fr = _frame_for(element)
    if fr is not None:
        fr["billed_d2h"] = True


def check_push(element, buf) -> None:
    """Called from Pad.push before a buffer goes downstream: backend
    tensors came in, host tensors go out, and no d2h was billed →
    NNST602."""
    fr = _frame_for(element)
    if fr is None or not fr["dev_in"] or fr["billed_d2h"]:
        return
    from nnstreamer_tpu_torch.buffer import is_backend_tensor

    tensors = getattr(buf, "tensors", ())
    if not tensors or any(is_backend_tensor(t) for t in tensors):
        return
    msg = (f"device-resident input materialized to host inside "
           f"{element.name!r} without billing a d2h crossing (outside the "
           f"pipelined-fetch path)")
    _record("NNST602", element.name, msg)
    raise SanitizerError(
        element.name,
        f"NNST602: {msg}; route the fetch through "
        f"buffer.materialize_tensors + _record_crossing('d2h')")


# --- tee aliasing (WRITEABLE freeze, version counters) ----------------------

def _forget(key: int):
    def drop(_ref) -> None:
        with _flock:
            rec = _frozen.get(key)
            if rec is not None and rec[0] is _ref:
                del _frozen[key]
    return drop


def freeze_buffer(buf) -> None:
    """Called by the tee before it fans ``buf`` out. Host ndarrays get
    ``WRITEABLE=False`` (an in-place write raises and
    :func:`intercept_chain_error` attributes it); torch tensors get their
    version counter recorded (:func:`exit_chain` attributes a write)."""
    for t in getattr(buf, "tensors", ()):
        if isinstance(t, np.ndarray):
            try:
                t.flags.writeable = False
            except ValueError:
                pass  # non-owning view of an unwritable base: already safe
        elif isinstance(t, torch.Tensor):
            key = id(t)
            with _flock:
                rec = _frozen.get(key)
                if rec is None or rec[0]() is not t:
                    _frozen[key] = (weakref.ref(t, _forget(key)), t._version)


_READONLY_MARKERS = ("read-only", "not writeable", "not writable",
                     "WRITEABLE")


def intercept_chain_error(element, err: Exception) -> Optional[Exception]:
    """Convert a frozen-array write error escaping ``chain()`` into an
    attributed NNST600 violation (the mutating element is exactly the one
    whose chain raised). Returns the replacement exception or None."""
    if isinstance(err, SanitizerError):
        return None
    if not isinstance(err, (ValueError, RuntimeError)):
        return None
    s = str(err)
    if not any(m in s for m in _READONLY_MARKERS):
        return None
    msg = (f"in-place mutation of a tee-shared tensor in {element.name!r} "
           f"(copy-on-write required): {s}")
    _record("NNST600", element.name, msg)
    return SanitizerError(element.name, f"NNST600: {msg}")


# --- busy gate (concurrent invoke) -----------------------------------------

@contextlib.contextmanager
def invoke_gate(fw, element_name: str):
    """Test-and-set around one backend invoke: a second concurrent invoke
    on the SAME framework instance is an NNST601 violation naming both
    elements. Also the NNST613 chokepoint: any framework lock still held
    at invoke entry is a contention hazard (lock-witness check)."""
    from nnstreamer_tpu_torch.analysis import lockwitness

    lockwitness.check_invoke(element_name)
    with _gate_lock:
        other = getattr(fw, "_nnst_invoking", None)
        if other is not None:
            msg = (f"concurrent invoke on framework instance "
                   f"{getattr(fw, 'name', type(fw).__name__)!r}: "
                   f"{element_name!r} entered while {other!r} is still "
                   f"inside invoke (busy-gate violation; backends are not "
                   f"reentrant)")
            _record("NNST601", element_name, msg)
            raise SanitizerError(element_name, f"NNST601: {msg}")
        fw._nnst_invoking = element_name
    try:
        yield
    finally:
        with _gate_lock:
            fw._nnst_invoking = None
