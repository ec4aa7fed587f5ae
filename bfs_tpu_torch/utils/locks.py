"""Named locks for the query server's shared state.

:func:`make_lock` returns a plain ``threading.Lock`` or ``RLock``; the name
says which field it guards.  The reference's lock-order recorder
(``BFS_TPU_LOCK_ORDER``), which records the order locks of each name nest
in and reports cycles, has no counterpart in the port yet.
"""

from __future__ import annotations

import threading


def make_lock(name: str, kind: str = "lock"):
    """A lock for the field named ``name``: ``kind`` ``'lock'`` or ``'rlock'``."""
    if kind not in ("lock", "rlock"):
        raise ValueError(f"{name}: unknown lock kind {kind!r}; use 'lock' or 'rlock'")
    return threading.RLock() if kind == "rlock" else threading.Lock()
