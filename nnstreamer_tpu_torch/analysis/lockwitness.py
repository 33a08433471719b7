"""Lock factories under the JAX package's names.

The JAX package's ``analysis/lockwitness.py`` wraps framework locks in
witnesses while its sanitizer is active and returns plain ``threading``
primitives otherwise. The sanitizer is not part of this package, so these
factories always return the plain primitives; the arguments are accepted
so element code reads the same in both packages.
"""

from __future__ import annotations

import threading
from typing import Optional


def make_lock(name: str, *, blocking_ok: bool = False,
              invoke_ok: bool = False):
    return threading.Lock()


def make_rlock(name: str, *, blocking_ok: bool = False,
               invoke_ok: bool = False):
    return threading.RLock()


def make_condition(lock, name: Optional[str] = None):
    return threading.Condition(lock)
