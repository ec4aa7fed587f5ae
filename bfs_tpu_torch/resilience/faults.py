"""Phase-boundary fault injection (``BFS_TPU_TORCH_FAULT``) and file
corruption: the port of ``bfs_tpu.resilience.faults``.

Instrumented code calls :func:`fault_point(name)` at a phase boundary.  The
hook does nothing unless ``BFS_TPU_TORCH_FAULT`` is set:

    BFS_TPU_TORCH_FAULT=kill:<phase>[:nth]    SIGKILL the process (no
                                              cleanup, no atexit)
    BFS_TPU_TORCH_FAULT=raise:<phase>[:nth]   raise FaultInjected
    BFS_TPU_TORCH_FAULT=phase:<phase>[:nth]   alias for kill:
    BFS_TPU_TORCH_FAULT=delay:<phase>[:secs]  sleep ``secs`` (default 1.0)
                                              at EVERY arrival: a hung call

``nth`` (default 1) selects the nth arrival at that phase.  Per-item
boundaries are named ``family:<item>`` and a spec's phase matches either
the exact boundary name or the family prefix.  ``delay`` takes seconds (a
float) where the others take ``nth``, and fires on every matching arrival
until the variable is cleared.

The query server has two boundaries: ``serve.batch`` fires inside every
watchdog-guarded device batch call (``delay:serve.batch:2`` wedges the
tick, ``raise:serve.batch`` fails it permanently) and ``serve.verify``
inside the sampled integrity check (where a ``raise`` counts as a FAILED
verdict, which quarantines the executable).

:func:`corrupt_file` truncates a file or flips a byte in it, the damage a
torn write or bit rot leaves.
"""

from __future__ import annotations

import os
import signal
import threading
import time

from .. import knobs


class FaultInjected(RuntimeError):
    """Raised by :func:`fault_point` under ``BFS_TPU_TORCH_FAULT=raise:...``."""


_lock = threading.Lock()
_counts: dict[str, int] = {}  # guarded-by: _lock


def reset() -> None:
    """Forget arrival counts (tests)."""
    with _lock:
        _counts.clear()


def fault_spec(env: str | None = None) -> tuple[str, str, float] | None:
    """``BFS_TPU_TORCH_FAULT`` (or ``env``) as ``(action, phase, arg)``, or
    None when unset.  ``action`` is ``'kill'``, ``'raise'`` or ``'delay'``
    (``phase:`` is an alias for ``kill``); ``arg`` is the 1-based nth
    arrival for kill and raise and the sleep in seconds for delay."""
    spec = env if env is not None else knobs.get("BFS_TPU_TORCH_FAULT")
    spec = spec.strip()
    if not spec:
        return None
    action, _, rest = spec.partition(":")
    if action == "phase":
        action = "kill"
    if action not in ("kill", "raise", "delay") or not rest:
        raise ValueError(
            f"bad BFS_TPU_TORCH_FAULT {spec!r}; use "
            "kill:<phase>[:nth] | raise:<phase>[:nth] | phase:<phase>[:nth]"
            " | delay:<phase>[:seconds]"
        )
    head, _, tail = rest.rpartition(":")
    if action == "delay":
        phase, seconds = rest, 1.0
        # A positive trailing float is the sleep; anything else (including
        # "0", as in the nth rule below) is part of the phase name.
        try:
            if head and float(tail) > 0:
                phase, seconds = head, float(tail)
        except ValueError:
            pass
        return action, phase, seconds
    phase, nth = rest, 1
    # A trailing 0 (or any non-positive integer) is part of the phase name:
    # ``kill:repeat:0`` targets the boundary "repeat:0".
    if head and tail.isdigit() and int(tail) >= 1:
        phase, nth = head, int(tail)
    return action, phase, nth


def fault_point(name: str) -> None:
    """Mark a phase boundary; acts here iff ``BFS_TPU_TORCH_FAULT`` targets
    this arrival at ``name``.  Free when the variable is unset."""
    spec = fault_spec()
    if spec is None:
        return
    action, phase, nth = spec
    if name != phase and not name.startswith(phase + ":"):
        return
    if action == "delay":
        # Every matching arrival sleeps: the watchdog must see a boundary
        # that stays wedged.
        time.sleep(nth)  # nth carries seconds for delay specs
        return
    with _lock:
        _counts[phase] = _counts.get(phase, 0) + 1
        hit = _counts[phase] == nth
    if not hit:
        return
    if action == "kill":
        import sys

        print(f"[fault] SIGKILL at phase boundary {name!r}", file=sys.stderr, flush=True)
        os.kill(os.getpid(), signal.SIGKILL)
    raise FaultInjected(f"injected fault at phase boundary {name!r}")


def corrupt_file(path: str, *, mode: str = "truncate", at: int | None = None) -> None:
    """Damage ``path`` in place: ``mode='truncate'`` cuts it to ``at`` bytes
    (default half), ``mode='flip'`` XOR-flips the byte at ``at`` (default
    the middle)."""
    size = os.path.getsize(path)
    if mode == "truncate":
        with open(path, "r+b") as f:
            f.truncate(size // 2 if at is None else at)
        return
    if mode == "flip":
        pos = size // 2 if at is None else at
        with open(path, "r+b") as f:
            f.seek(pos)
            b = f.read(1)
            f.seek(pos)
            f.write(bytes([b[0] ^ 0xFF]) if b else b"\xff")
        return
    raise ValueError(f"unknown corruption mode {mode!r}")
