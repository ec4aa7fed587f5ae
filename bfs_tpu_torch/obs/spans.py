"""Nestable wall-clock spans exported as Chrome trace events: the port of
``bfs_tpu.obs.spans``.

The buffer is process-global and bounded; each closed span becomes one
Chrome ``"ph": "X"`` complete event (name, ts/dur in µs, pid/tid), which
Perfetto and ``chrome://tracing`` load as they are: nesting follows from
containment on one tid.  ``ts`` is wall-clock epoch µs, so the segments of
a killed and resumed run land on one timeline with the gap between them.
Spans are on unless ``BFS_TPU_TORCH_SPANS=0``.  A span costs a
``perf_counter_ns`` pair and a list append, on the host only; nothing
here reads a device value.

Traces that outlive a crash: :func:`journal_spans` drains the buffer into
one ``spans:<k>`` record of a :class:`~bfs_tpu_torch.resilience.journal.
RunJournal` (one a process generation), and :func:`stitch_journal_trace`
reads every generation's record back from the journal file into one
trace; :func:`flush_open_spans` closes the spans still open when a run is
interrupted.
"""

from __future__ import annotations

import functools
import json
import os
import threading
import time

from .. import knobs

#: Past this many buffered events new ones are dropped and counted.
MAX_EVENTS = 200_000

_lock = threading.Lock()
_events: list[dict] = []  # guarded-by: _lock
_dropped = 0  # guarded-by: _lock
_open: dict[int, dict] = {}  # guarded-by: _lock (span id -> start info)
_next_id = [0]  # guarded-by: _lock


def spans_enabled() -> bool:
    return knobs.get("BFS_TPU_TORCH_SPANS")


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
        if not spans_enabled():
            return self
        self._t0 = time.perf_counter_ns()
        with _lock:
            _next_id[0] += 1
            self._id = _next_id[0]
            _open[self._id] = {
                "name": self.name, "ts": _wall_us(), "t0": self._t0,
                "tid": threading.get_ident(), "args": dict(self.attrs),
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
    if not spans_enabled():
        return
    _emit({
        "name": name, "ph": "i", "ts": _wall_us(), "s": "p",
        "pid": os.getpid(), "tid": threading.get_ident(),
        "cat": "bfs_tpu", "args": dict(attrs),
    })


def flush_open_spans(note: str = "flushed") -> int:
    """Close every span still open now (the path of a signal that ends the
    process): each gets its duration so far and ``args.flushed``, so an
    interrupted run's trace shows which phase the signal landed in.
    Returns the number of spans flushed."""
    now_ns = time.perf_counter_ns()
    with _lock:
        open_now = list(_open.values())
        _open.clear()
    for info in open_now:
        _emit({
            "name": info["name"], "ph": "X", "ts": info["ts"],
            "dur": max((now_ns - info["t0"]) // 1_000, 1),
            "pid": os.getpid(), "tid": info["tid"], "cat": "bfs_tpu",
            "args": {**info["args"], "flushed": note},
        })
    return len(open_now)


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


def export_chrome_trace(path: str, events: list[dict] | None = None) -> str:
    """Write the trace JSON atomically; returns ``path``."""
    doc = chrome_trace(events)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return path


# --------------------------------------------------------------- journal --

def journal_spans(jr) -> str | None:
    """Drain this process generation's events into one durable
    ``spans:<k>`` record of ``jr`` (a RunJournal), ``k`` counting the
    earlier generations.  With no journal, or nothing to journal, the
    buffer is left as it is and None returned."""
    if jr is None:
        return None
    events = drain_events()
    if not events:
        return None
    k = sum(1 for p in jr.phases() if p.startswith("spans:"))
    phase = f"spans:{k}"
    jr.put(phase, {"events": events})
    return phase


def stitch_journal_trace(journal_path: str) -> dict:
    """The Chrome trace of every ``spans:<k>`` record of a journal FILE, in
    generation order (records read leniently: crc-checked line by line, a
    torn tail skipped; no config needed)."""
    from ..resilience.journal import read_records

    recs = [r for r in read_records(journal_path) if r["phase"].startswith("spans:")]
    recs.sort(key=lambda r: int(r["phase"].split(":", 1)[1]))
    events: list[dict] = []
    for rec in recs:
        events.extend(rec["payload"].get("events", ()))
    return {"traceEvents": events, "displayTimeUnit": "ms"}
