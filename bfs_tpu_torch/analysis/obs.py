"""Observability discipline (OBS001): the port of ``bfs_tpu.analysis.obs``.

Telemetry rides the level loop's carry and is read once when the loop
ends; reporting calls (``snapshot()``, ``artifact_report()``,
``retrace_report()``, ``span_report()``, ``chrome_trace()``, ...) are
legal anywhere but a hot region, where each would read state per tick or
per superstep.  Span and counter writes (``span(...)``, ``bump(...)``) are
host-side appends and are not flagged.
"""

from __future__ import annotations

import ast

from .core import Finding, SourceFile, dotted_name, hot_regions
from .transfer import _region_for

#: Call names (the dotted tail) that read telemetry or metrics state.
_OBS_READ_CALLS = {
    "read_telemetry",
    "snapshot",
    "artifact_report",
    "retrace_report",
    "lock_order_report",
    "span_report",
    "chrome_trace",
    "stitch_journal_trace",
    "to_prometheus",
}


def check_obs(src: SourceFile) -> list[Finding]:
    regions = hot_regions(src)
    if not regions:
        return []
    findings: list[Finding] = []
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.Call):
            continue
        region = _region_for(node.lineno, regions)
        if region is None:
            continue
        fn = node.func
        # The called name's tail, whatever its receiver (get_registry().snapshot()).
        tail = fn.attr if isinstance(fn, ast.Attribute) else dotted_name(fn)
        if tail in _OBS_READ_CALLS:
            f = src.finding("OBS001", node,
                            f"hot region '{region.name}': telemetry/metrics read {tail}() "
                            "inside the hot path; read it once after the loop")
            if f is not None:
                findings.append(f)
    return findings
