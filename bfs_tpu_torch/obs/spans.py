"""Nestable wall-clock spans exported as Chrome trace events: the port of
``bfs_tpu.obs.spans`` without its run-journal stitching.

The buffer is process-global and bounded; each closed span becomes one
Chrome ``"ph": "X"`` complete event (name, ts/dur in µs, pid/tid), which
Perfetto and ``chrome://tracing`` load as they are: nesting follows from
containment on one tid.  ``ts`` is wall-clock epoch µs.  A span costs a
``perf_counter_ns`` pair and a list append, on the host only; nothing
here reads a device value.
"""

from __future__ import annotations

import functools
import os
import threading
import time

#: Past this many buffered events new ones are dropped and counted.
MAX_EVENTS = 200_000

_lock = threading.Lock()
_events: list[dict] = []  # guarded by _lock
_dropped = 0  # guarded by _lock
_open: dict[int, dict] = {}  # guarded by _lock: span id -> start info
_next_id = [0]  # guarded by _lock


def _wall_us() -> int:
    return time.time_ns() // 1_000


def _emit(event: dict) -> None:
    global _dropped
    with _lock:
        if len(_events) >= MAX_EVENTS:
            _dropped += 1
            return
        _events.append(event)


class _Span:
    """One span: a context manager and a decorator (``@span("name")``)."""

    __slots__ = ("name", "attrs", "_id", "_t0")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self._id = None
        self._t0 = 0

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        with _lock:
            _next_id[0] += 1
            self._id = _next_id[0]
            _open[self._id] = {
                "ts": _wall_us(), "tid": threading.get_ident(),
                "args": dict(self.attrs),
            }
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._id is None:
            return False
        dur_us = (time.perf_counter_ns() - self._t0) // 1_000
        with _lock:
            info = _open.pop(self._id, None)
        self._id = None
        if info is not None:
            args = info["args"]
            if exc_type is not None:
                args = {**args, "error": exc_type.__name__}
            _emit({
                "name": self.name, "ph": "X", "ts": info["ts"],
                "dur": max(int(dur_us), 1), "pid": os.getpid(),
                "tid": info["tid"], "cat": "bfs_tpu", "args": args,
            })
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with _Span(self.name, self.attrs):
                return fn(*a, **kw)

        return wrapper


def span(name: str, **attrs) -> _Span:
    """``with span("layout.build", kind="relay"): ...`` or ``@span("tick")``."""
    return _Span(name, attrs)


def instant(name: str, **attrs) -> None:
    """One zero-duration marker event (Chrome ``ph: "i"``)."""
    _emit({
        "name": name, "ph": "i", "ts": _wall_us(), "s": "p",
        "pid": os.getpid(), "tid": threading.get_ident(),
        "cat": "bfs_tpu", "args": dict(attrs),
    })


def snapshot_events() -> list[dict]:
    with _lock:
        return list(_events)


def drain_events() -> list[dict]:
    """Return and clear the buffer (and its drop count)."""
    global _dropped
    with _lock:
        out = list(_events)
        _events.clear()
        _dropped = 0
        return out


def span_report() -> dict:
    """Per name: count and total seconds of the closed spans."""
    out: dict[str, dict] = {}
    for ev in snapshot_events():
        if ev.get("ph") != "X":
            continue
        rec = out.setdefault(ev["name"], {"count": 0, "total_s": 0.0})
        rec["count"] += 1
        rec["total_s"] += ev.get("dur", 0) / 1e6
    return out


def chrome_trace(events: list[dict] | None = None) -> dict:
    """The Chrome/Perfetto trace document of ``events`` (default: the
    buffer)."""
    evs = snapshot_events() if events is None else list(events)
    with _lock:
        dropped = _dropped
    doc = {"traceEvents": evs, "displayTimeUnit": "ms"}
    if dropped:
        doc["otherData"] = {"dropped_events": dropped}
    return doc
