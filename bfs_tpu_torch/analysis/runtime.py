"""Runtime sanitizers: the dynamic half of the analysis package, the port
of ``bfs_tpu.analysis.runtime``.

Three families, each free when its knob is off:

**Transfer guard.**  :func:`guarded_region` runs a block under
``torch.cuda.set_sync_debug_mode`` when ``BFS_TPU_TORCH_TRANSFER_GUARD`` is
set, so an implicit host sync inside the serve device batch (``.item()``,
``float()`` of a tensor, a pageable copy, ``torch.nonzero``) raises at the
offending line instead of silently stalling the card.  Values: ``1`` /
``disallow`` (the mode ``"error"``), ``log`` (``"warn"``), unset or ``0``
(off, the CPU default).  A transfer the code means to make stays allowed,
as ``jax.device_get`` does under the reference's ``disallow``: it runs
under :func:`explicit_transfer`, which lifts the mode for its block (the
level loop's read of its control block, a result's copy to the host).
The mode is one setting of the process, not of a thread: a region
restores the mode it found, and the serve path enters one only under
``DEVICE_LOCK``, so no other thread's device work runs inside it.  On a
machine without a card the mode cannot be set and a region is a plain
block.

**Retrace counter.**  The port compiles no traced programs; its
counterparts of a retrace are a CUDA-graph capture of a level loop
(``models/loop.py``) and a build of a serve executable
(``serve/executor.py``'s cache miss).  Each is counted under its key by
:func:`bump_retrace` (or a function wrapped by :func:`traced`);
:func:`retrace_report` snapshots the counts, and the load generator and
``chaos_run`` print :func:`format_retrace_report` at exit.

**Lock-order recorder.**  Under ``BFS_TPU_TORCH_LOCK_ORDER=1`` the named
serve locks are built by :func:`make_lock` as recording proxies: every
"acquired B while holding A" adds the edge A -> B to a process-global
order graph, and an edge that closes a cycle (the two-thread AB/BA
deadlock shape) is recorded (``raise``: :class:`LockOrderError` at that
acquisition).  Re-entering a held ``RLock`` records nothing.
:func:`lock_order_report` returns the edges and cycles.  With the knob
unset :func:`make_lock` returns a plain ``threading.Lock`` or ``RLock``.
"""

from __future__ import annotations

import contextlib
import functools
import threading

from .. import knobs

_lock = threading.Lock()
_retrace_counts: dict[str, int] = {}  # guarded-by: _lock
_hot_registry: dict[str, object] = {}  # guarded-by: _lock
#: Guarded regions open in the process (their mode is the process's).
_guard_depth = [0]  # guarded-by: _lock

#: The message torch gives a sync under the ``"error"`` mode.
SYNC_VIOLATION = "called a synchronizing CUDA operation"


def transfer_guard_level() -> str | None:
    """The configured sync-debug mode: ``"error"`` / ``"warn"`` / None (off)."""
    return knobs.get("BFS_TPU_TORCH_TRANSFER_GUARD")


def _sync_mode_api():
    """``(get, set)`` of torch's sync-debug mode, or None where it cannot
    be set (no card): the seam the CPU tests replace."""
    import torch

    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_sync_debug_mode, torch.cuda.set_sync_debug_mode


@contextlib.contextmanager
def guarded_region(name: str):
    """A block in which an implicit host sync is an error (``log``: a
    warning).  A no-op unless ``BFS_TPU_TORCH_TRANSFER_GUARD`` is set and a
    card is present.  A guard violation re-raises with the region's name
    prepended; every other exception passes through untouched.  The mode
    found at entry is restored at exit."""
    level = transfer_guard_level()
    api = _sync_mode_api() if level is not None else None
    if api is None:
        yield
        return
    get_mode, set_mode = api
    prev = get_mode()
    set_mode(level)
    with _lock:
        _guard_depth[0] += 1
    try:
        yield
    except Exception as exc:
        # Only a guard violation is named: an OOM, a ValueError of the
        # workload or a retry-path error must reach its classifier as it was
        # raised.  Mutating args keeps the type and the traceback.
        head = str(exc.args[0]) if exc.args else ""
        if SYNC_VIOLATION in head:
            exc.args = (f"[transfer-guard:{name}] {head}",) + tuple(exc.args[1:])
        raise
    finally:
        with _lock:
            _guard_depth[0] -= 1
        set_mode(prev)


@contextlib.contextmanager
def explicit_transfer():
    """A transfer the code means to make, allowed inside a guarded region:
    the sync-debug mode is lifted for the block and restored after.  Free
    outside a region."""
    with _lock:
        active = _guard_depth[0] > 0
    api = _sync_mode_api() if active else None
    if api is None:
        yield
        return
    get_mode, set_mode = api
    prev = get_mode()
    set_mode(0)
    try:
        yield
    finally:
        set_mode(prev)


def hot_region(fn=None, *, name: str | None = None):
    """Decorator marking a function as a hot region: the lint treats its
    body as a ``# bfs_tpu_torch: hot`` pragma does, and a call runs in
    :func:`guarded_region` when the guard is on.  Bare (``@hot_region``) or
    named (``@hot_region(name=...)``)."""

    def deco(f):
        region = name or f"{f.__module__}.{f.__qualname__}"
        with _lock:
            _hot_registry[region] = f

        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            if transfer_guard_level() is None:
                return f(*args, **kwargs)
            with guarded_region(region):
                return f(*args, **kwargs)

        wrapper.__bfs_tpu_torch_hot__ = region
        return wrapper

    return deco if fn is None else deco(fn)


def hot_registry() -> dict[str, object]:
    with _lock:
        return dict(_hot_registry)


# --------------------------------------------------------------------------
# Retrace counting: captures and executable builds.
# --------------------------------------------------------------------------

def bump_retrace(name: str, by: int = 1) -> None:
    with _lock:
        _retrace_counts[name] = _retrace_counts.get(name, 0) + by


def traced(name: str):
    """Count every call of the wrapped function under ``name``: wrap what
    runs once per capture or build."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            bump_retrace(name)
            return fn(*args, **kwargs)

        return wrapper

    return deco


def retrace_report() -> dict[str, int]:
    """``{key: captures or builds this process}``.  Steady traffic freezes
    every count; a count that moves names the loop or executable rebuilt."""
    with _lock:
        return dict(_retrace_counts)


def reset_retrace_counts() -> None:
    with _lock:
        _retrace_counts.clear()


def format_retrace_report(baseline: dict[str, int] | None = None) -> str:
    """The counts as a table; with ``baseline`` (an earlier snapshot) a
    drift column: a non-zero drift after warm-up is a rebuild leak."""
    now = retrace_report()
    if not now:
        return "retraces: none recorded (no capture or executable build)"
    lines = ["retraces (captures and executable builds this process):"]
    for name in sorted(now):
        drift = ""
        if baseline is not None:
            d = now[name] - baseline.get(name, 0)
            drift = f"  (+{d} since warmup)" if d else "  (steady)"
        lines.append(f"  {now[name]:6d}  {name}{drift}")
    return "\n".join(lines)


# --------------------------------------------------------------------------
# Lock-order recording.
# --------------------------------------------------------------------------

class LockOrderError(RuntimeError):
    """An acquisition closed a cycle in the lock-order graph: the
    two-thread deadlock shape, caught at the acquisition that makes it."""


_lock_edges: dict[tuple[str, str], int] = {}  # guarded-by: _lock
_lock_cycles: list[list[str]] = []  # guarded-by: _lock
_lock_tls = threading.local()


def lock_order_mode() -> str | None:
    """``"record"`` / ``"raise"`` / None (off, the default)."""
    return knobs.get("BFS_TPU_TORCH_LOCK_ORDER")


def _held_stack() -> list:
    stack = getattr(_lock_tls, "held", None)
    if stack is None:
        stack = _lock_tls.held = []
    return stack


# bfs_tpu_torch: holds _lock
def _find_path(src: str, dst: str) -> list[str] | None:
    """A path src -> ... -> dst in the edge graph (the caller holds _lock)."""
    stack, seen = [(src, [src])], {src}
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        for a, b in _lock_edges:
            if a == node and b not in seen:
                seen.add(b)
                stack.append((b, path + [b]))
    return None


def _record_acquire(name: str) -> None:
    """Called before blocking on ``name``: the ordering edge exists once the
    thread commits to the acquisition, whether or not it ever returns (the
    deadlocked case)."""
    held = _held_stack()
    cycle = None
    with _lock:
        for h in held:
            if h == name:
                continue  # a re-entrant acquisition orders nothing
            edge = (h, name)
            if edge not in _lock_edges:
                # A new edge h -> name closes a cycle iff name already
                # reaches h through the recorded edges.
                path = _find_path(name, h)
                if path is not None:
                    cycle = path + [name]
                    _lock_cycles.append(cycle)
            _lock_edges[edge] = _lock_edges.get(edge, 0) + 1
    if cycle is not None and lock_order_mode() == "raise":
        raise LockOrderError("lock-order cycle: " + " -> ".join(cycle)
                             + f" (acquired '{name}' while holding '{cycle[-2]}')")


class _OrderedLock:
    """A recording proxy around a real lock: the ``with`` protocol, plain
    acquire/release, and ``threading.Condition`` over it."""

    def __init__(self, name: str, inner):
        self._name = name
        self._inner = inner

    def acquire(self, blocking: bool = True, timeout: float = -1):
        # Only blocking acquisitions order locks: a try-acquire can never be
        # the blocked arm of a deadlock, and Condition._is_owned probes with
        # acquire(False) while holding other locks.  The edge is recorded
        # before the call: the deadlocked interleaving never returns.
        if blocking:
            _record_acquire(self._name)
        got = self._inner.acquire(blocking, timeout)
        if got:
            _held_stack().append(self._name)
        return got

    def release(self):
        self._inner.release()
        held = _held_stack()
        for i in range(len(held) - 1, -1, -1):
            if held[i] == self._name:
                del held[i]
                break

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()

    def __repr__(self):
        return f"<_OrderedLock {self._name} {self._inner!r}>"


def make_lock(name: str, kind: str = "lock"):
    """A named lock for a ``# guarded-by:`` field: ``kind`` ``'lock'`` or
    ``'rlock'``.  With ``BFS_TPU_TORCH_LOCK_ORDER`` unset (read when the lock
    is made) a plain ``threading.Lock`` or ``RLock``; set, a recording
    proxy.  The name keys the order graph, so every instance of a class
    shares one node: the recorder orders lock classes, not instances."""
    if kind not in ("lock", "rlock"):
        raise ValueError(f"{name}: unknown lock kind {kind!r}; use 'lock' or 'rlock'")
    inner = threading.RLock() if kind == "rlock" else threading.Lock()
    if lock_order_mode() is None:
        return inner
    return _OrderedLock(name, inner)


def lock_order_report() -> dict:
    """``{"edges": {"a->b": count}, "cycles": [[...], ...]}``: ``cycles`` is
    non-empty iff some interleaving of the recorded acquisitions can
    deadlock."""
    with _lock:
        return {
            "edges": {f"{a}->{b}": n for (a, b), n in sorted(_lock_edges.items())},
            "cycles": [list(c) for c in _lock_cycles],
        }


def reset_lock_order() -> None:
    with _lock:
        _lock_edges.clear()
        _lock_cycles.clear()


def assert_lock_order_clean() -> None:
    """Raise :class:`LockOrderError` if any cycle was recorded: the chaos
    run's exit gate."""
    report = lock_order_report()
    if report["cycles"]:
        raise LockOrderError(
            f"{len(report['cycles'])} lock-order cycle(s): "
            + "; ".join(" -> ".join(c) for c in report["cycles"]))
