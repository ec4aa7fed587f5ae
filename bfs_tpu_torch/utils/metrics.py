"""Per-superstep run metrics, TEPS accounting and the artifact-cache
counters: the port of the run-level and artifact halves of
``bfs_tpu.utils.metrics``.

Each superstep records its level, frontier size and seconds; the run
reports traversed edges per second (TEPS, the Graph500 convention: the
directed edge count over the summed superstep seconds) and the
reference's per-iteration log lines (``Elapsed time [i] ==> ...``).
"""

from __future__ import annotations

import json
import threading
from dataclasses import asdict, dataclass, field

_artifact_lock = threading.Lock()
_artifact_counters: dict[str, int] = {}  # guarded by _artifact_lock


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
