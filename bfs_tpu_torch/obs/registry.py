"""One process-global :class:`MetricsRegistry`: every counter behind one
snapshot.  The port of ``bfs_tpu.obs.registry``.  Its retrace counters are
the port's counterparts of a retrace (a loop's CUDA-graph capture, a serve
executable's build; :mod:`bfs_tpu_torch.analysis.runtime`), with their
drift since a ``retrace_baseline`` snapshot when one is passed.

Free-form counters live here (``graph_evictions``, ``watchdog_timeouts``);
every :class:`~bfs_tpu_torch.utils.metrics.ServeMetrics` registers itself
at construction, weakly, so a dropped server is not kept alive by its
metrics; :meth:`MetricsRegistry.snapshot` composes the counters, the
artifact-cache counters, the span summary and every live server's report
into one JSON-ready dict; :func:`prometheus_text` renders it as
Prometheus exposition text under the reference's ``bfs_tpu_`` prefix, so
a dashboard scrapes either package under the same names.
"""

from __future__ import annotations

import json
import re
import threading
import weakref


class MetricsRegistry:
    """Thread-safe process-global metrics hub."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}  # guarded-by: _lock
        self._serve: list = []  # guarded-by: _lock (weakref.ref of ServeMetrics)

    def counter(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + by

    def count(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def counters(self) -> dict:
        with self._lock:
            return dict(self._counters)

    def register_serve(self, metrics) -> None:
        """Adopt a ServeMetrics instance (idempotent; weakly held)."""
        with self._lock:
            live = [r for r in self._serve if r() is not None]
            if not any(r() is metrics for r in live):
                live.append(weakref.ref(metrics))
            self._serve = live

    def _serve_reports(self) -> list[dict]:
        with self._lock:
            refs = list(self._serve)
        return [m.report() for m in (r() for r in refs) if m is not None]

    def snapshot(self, retrace_baseline: dict | None = None) -> dict:
        """Registry counters, artifact caches, retrace counters (with each
        key's drift since ``retrace_baseline`` when given: a non-zero drift
        after warm-up names the loop or executable rebuilt), span summary
        and every live ServeMetrics report."""
        from ..analysis.runtime import retrace_report
        from ..utils.metrics import artifact_report
        from .spans import span_report

        retraces = retrace_report()
        out = {
            "counters": self.counters(),
            "artifact_caches": artifact_report(),
            "retraces": retraces,
            "spans": span_report(),
            "serve": self._serve_reports(),
        }
        if retrace_baseline is not None:
            out["retrace_drift"] = {name: n - retrace_baseline.get(name, 0)
                                    for name, n in retraces.items()
                                    if n - retrace_baseline.get(name, 0)}
        return out

    def to_json(self, retrace_baseline: dict | None = None) -> str:
        return json.dumps(self.snapshot(retrace_baseline), indent=2, sort_keys=True)

    def to_prometheus(self, retrace_baseline: dict | None = None) -> str:
        return prometheus_text(self.snapshot(retrace_baseline))


_REGISTRY_LOCK = threading.Lock()
_REGISTRY: list[MetricsRegistry] = []  # guarded-by: _REGISTRY_LOCK


def get_registry() -> MetricsRegistry:
    """THE process-global registry (created on first use)."""
    with _REGISTRY_LOCK:
        if not _REGISTRY:
            _REGISTRY.append(MetricsRegistry())
        return _REGISTRY[0]


_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(*parts: str) -> str:
    name = "_".join(_NAME_RE.sub("_", str(p)).strip("_") for p in parts if p != "")
    return f"bfs_tpu_{name}"


def _flatten(prefix: tuple, obj, out: list) -> None:
    if isinstance(obj, bool):
        out.append((_prom_name(*prefix), int(obj)))
    elif isinstance(obj, (int, float)):
        out.append((_prom_name(*prefix), obj))
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _flatten(prefix + (str(k),), v, out)
    elif isinstance(obj, (list, tuple)):
        # A list is indexed (serve reports nest one dict a server); a leaf
        # that is not a number or a dict is not a gauge.
        for i, v in enumerate(obj):
            if isinstance(v, (dict, int, float)) and not isinstance(v, bool):
                _flatten(prefix + (str(i),), v, out)


def prometheus_text(snapshot: dict) -> str:
    """Prometheus exposition text (untyped gauges) of a snapshot dict: its
    numeric leaves as ``bfs_tpu_<path> <value>`` lines, names sanitized to
    the metric charset, the first of duplicate names kept, other leaves
    skipped."""
    gauges: list[tuple[str, float]] = []
    _flatten((), snapshot, gauges)
    lines = []
    seen = set()
    for name, value in gauges:
        if name in seen:
            continue
        seen.add(name)
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {value}")
    return "\n".join(lines) + "\n"
