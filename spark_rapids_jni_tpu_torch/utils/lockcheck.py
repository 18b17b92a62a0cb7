"""Named lock constructors (the names of ``utils/lockcheck.py``).

The JAX package wraps every lock of its execution services in an
order-tracking shim; the port keeps the constructors' names, so its
modules read the same, and returns the plain ``threading`` primitives.
The lock-order checker itself is not ported.
"""

from __future__ import annotations

import threading


def make_lock(name: str):
    """A ``threading.Lock`` (``name`` documents the call site)."""
    return threading.Lock()


def make_rlock(name: str):
    """A ``threading.RLock`` (``name`` documents the call site)."""
    return threading.RLock()


def make_condition(lock) -> threading.Condition:
    """A ``threading.Condition`` sharing ``lock``."""
    return threading.Condition(lock)


def note_blocking(what: str) -> None:
    """Mark a blocking call (a device launch, a disk read); the JAX
    package's checker reports a tracked lock held across one. A no-op
    here."""
