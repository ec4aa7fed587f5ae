"""Per-superstep run metrics, TEPS accounting, the artifact-cache
counters and the query server's request metrics: the port of
``bfs_tpu.utils.metrics``.

Each superstep records its level, frontier size and seconds; the run
reports traversed edges per second (TEPS, the Graph500 convention: the
directed edge count over the summed superstep seconds) and the
reference's per-iteration log lines (``Elapsed time [i] ==> ...``).

The query server (:mod:`bfs_tpu_torch.serve`) leaves a
:class:`QueryRecord` per admitted query (queue wait, the batch it rode in,
executable- and result-cache hits, supersteps, end-to-end latency), and
:class:`ServeMetrics` aggregates them into the report (p50/p99,
queries/s, cache hit rates).
"""

from __future__ import annotations

import json
import threading
from dataclasses import asdict, dataclass, field

_artifact_lock = threading.Lock()
_artifact_counters: dict[str, int] = {}  # guarded-by: _artifact_lock


def bump_artifact(name: str, by: int = 1) -> None:
    """Count one artifact-cache event (e.g. ``layout_cache_hits``);
    thread-safe, process-global."""
    with _artifact_lock:
        _artifact_counters[name] = _artifact_counters.get(name, 0) + by


def artifact_report() -> dict:
    """The artifact-cache counters plus the layout cache's hit rate
    (``None`` when it saw no traffic in this process)."""
    with _artifact_lock:
        out: dict = dict(_artifact_counters)
    h, m = out.get("layout_cache_hits", 0), out.get("layout_cache_misses", 0)
    out["layout_cache_hit_rate"] = h / (h + m) if h + m else None
    return out


@dataclass
class SuperstepRecord:
    level: int
    frontier_size: int
    seconds: float


@dataclass
class RunMetrics:
    """Accumulated metrics for one BFS run."""

    num_vertices: int = 0
    num_edges: int = 0  # directed
    supersteps: list[SuperstepRecord] = field(default_factory=list)

    def record(self, level: int, frontier_size: int, seconds: float) -> None:
        self.supersteps.append(SuperstepRecord(level, frontier_size, seconds))

    @property
    def total_seconds(self) -> float:
        return sum(r.seconds for r in self.supersteps)

    @property
    def num_levels(self) -> int:
        return len(self.supersteps)

    @property
    def vertices_settled(self) -> int:
        return sum(r.frontier_size for r in self.supersteps)

    def teps(self, *, num_traversals: int = 1) -> float:
        """Traversed edges per second; ``num_traversals`` scales for batched
        runs (each source traverses the edge set once)."""
        t = self.total_seconds
        return (self.num_edges * num_traversals / t) if t > 0 else float("inf")

    def to_json(self) -> str:
        d = asdict(self)
        d["total_seconds"] = self.total_seconds
        d["teps"] = self.teps()
        return json.dumps(d)

    def log_lines(self):
        """Per-iteration lines in the reference's log style."""
        for r in self.supersteps:
            yield (
                f"Elapsed time [{r.level}] ==> {r.seconds * 1e3:.3f} ms "
                f"(frontier {r.frontier_size})"
            )


def percentile(values, q: float) -> float:
    """Linear-interpolation percentile (``q`` in [0, 100]) of a sequence;
    0.0 on an empty input."""
    vals = sorted(float(v) for v in values)
    if not vals:
        return 0.0
    if len(vals) == 1:
        return vals[0]
    pos = (len(vals) - 1) * (q / 100.0)
    lo = int(pos)
    hi = min(lo + 1, len(vals) - 1)
    frac = pos - lo
    return vals[lo] * (1.0 - frac) + vals[hi] * frac


@dataclass
class QueryRecord:
    """Per-request record, attached to every served reply.

    ``status`` is one of ``'ok'`` (device batch), ``'result_cache'`` (LRU
    hit, never queued), ``'oracle'`` (sequential degradation),
    ``'timeout'`` or ``'error'``.  ``compile_hit`` (an executable-cache
    hit) is None for paths that never reach the executable cache."""

    graph: str = ""
    engine: str = ""
    status: str = "ok"
    epoch: int = 0  # graph epoch the answer was computed against
    num_sources: int = 1
    batch_size: int = 0  # padded device batch the request rode in
    supersteps: int = 0
    queue_wait_s: float = 0.0  # admission -> batch formation
    service_s: float = 0.0  # device (or oracle) execution, batch-shared
    total_s: float = 0.0  # admission -> reply
    compile_hit: bool | None = None
    result_cache_hit: bool = False


class ServeMetrics:
    """Thread-safe aggregator for the query server.

    Counters are free-form (``bump('evictions')``) and exact for the
    process lifetime; query records feed the latency and batching
    statistics and are kept in a bounded window (``max_records``), so
    percentiles are over the most recent window.  ``report()`` returns a
    JSON-ready dict."""

    def __init__(self, max_records: int = 100_000):
        from collections import deque

        from .locks import make_lock

        self._lock = make_lock("metrics._lock")
        self.records: deque[QueryRecord] = deque(maxlen=max_records)  # guarded-by: _lock
        self.counters: dict[str, int] = {}  # guarded-by: _lock
        self._first_ts: float | None = None  # guarded-by: _lock
        self._last_ts: float | None = None  # guarded-by: _lock
        from ..obs.registry import get_registry

        get_registry().register_serve(self)

    def bump(self, name: str, by: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + by

    def count(self, name: str) -> int:
        with self._lock:
            return self.counters.get(name, 0)

    def record_query(self, rec: QueryRecord, *, ts: float | None = None) -> None:
        with self._lock:
            self.records.append(rec)
            if ts is not None:
                if self._first_ts is None:
                    self._first_ts = ts
                self._last_ts = ts

    @staticmethod
    def _rate(counters: dict, hits: str, misses: str) -> float | None:
        h, m = counters.get(hits, 0), counters.get(misses, 0)
        return h / (h + m) if h + m else None

    def report(self) -> dict:
        with self._lock:
            records = list(self.records)
            counters = dict(self.counters)
            span = (
                (self._last_ts - self._first_ts)
                if self._first_ts is not None and self._last_ts is not None
                else 0.0
            )
        ok = [r for r in records if r.status in ("ok", "result_cache", "oracle")]
        lat = [r.total_s for r in ok]
        waits = [r.queue_wait_s for r in records if r.batch_size > 0]
        batches = [r.batch_size for r in records if r.batch_size > 0]
        out = {
            "queries": len(records),
            "served": len(ok),
            "timeouts": sum(r.status == "timeout" for r in records),
            "errors": sum(r.status == "error" for r in records),
            "latency_p50_ms": percentile(lat, 50) * 1e3,
            "latency_p99_ms": percentile(lat, 99) * 1e3,
            "latency_mean_ms": (sum(lat) / len(lat) * 1e3) if lat else 0.0,
            "queue_wait_p99_ms": percentile(waits, 99) * 1e3,
            "batch_size_mean": (sum(batches) / len(batches)) if batches else 0.0,
            "batch_size_max": max(batches, default=0),
            "queries_per_sec": (len(ok) / span) if span > 0 else 0.0,
            "counters": counters,
        }
        # Retries against degradations at a glance: rising device_retries
        # with no device_errors is a flaky transport that recovers; rising
        # device_errors means the oracle is serving what the card should.
        out["retries"] = {
            "device_retries": counters.get("device_retries", 0),
            "device_retry_successes": counters.get("device_retry_successes", 0),
            "device_errors": counters.get("device_errors", 0),
        }
        out["compile_hit_rate"] = self._rate(counters, "compile_hits", "compile_misses")
        out["result_cache_hit_rate"] = self._rate(
            counters, "result_cache_hits", "result_cache_misses")
        out["artifact_caches"] = artifact_report()
        return out

    def to_json(self) -> str:
        return json.dumps(self.report(), indent=2, sort_keys=True)
