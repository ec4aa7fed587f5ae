"""The knob rung (KNB000-KNB005): the port of ``bfs_tpu.analysis.knobs``.

``python -m bfs_tpu_torch.analysis --knobs`` proves the contract of the
typed registry (:mod:`bfs_tpu_torch.knobs`) against the sources, the live
key builders, the registry module's own table and the parsers
(:mod:`.knob_rules`).  The surface is the package and ``chip_smoke.py``.
The pass is fast enough to run whole every time, so it keeps no result
cache (the reference caches its verdicts by content).
"""

from __future__ import annotations

import os

from .. import knobs
from .core import Finding, SourceFile, iter_python_files, repo_root
from .knob_rules import (
    REGISTRY_PATH,
    check_docs,
    check_key_completeness,
    check_parsers,
    check_provenance,
    check_scope,
)


def surface_paths(root: str) -> list[str]:
    """The knob rung's surface: everywhere the port's code reads env."""
    return [p for p in (os.path.join(root, "bfs_tpu_torch"), os.path.join(root, "chip_smoke.py"))
            if os.path.exists(p)]


def collect_sources(root: str) -> tuple[list[SourceFile], list[Finding]]:
    sources: list[SourceFile] = []
    findings: list[Finding] = []
    for path in iter_python_files(surface_paths(root)):
        try:
            sources.append(SourceFile(path, root))
        except SyntaxError as exc:
            rel = os.path.relpath(os.path.abspath(path), root).replace(os.sep, "/")
            findings.append(Finding(rule="KNB000", path=rel, line=exc.lineno or 0, col=0,
                                    message=f"could not parse: {exc.msg}",
                                    snippet=f"knb:parse:{rel}"))
    return sources, findings


def analyze_knobs(knob_table: dict | None = None, *, providers: dict | None = None,
                  doc: str | None = None, root: str | None = None) -> tuple[list, dict]:
    """Run the rung: ``(findings, meta)``, ``meta`` naming the knobs
    checked.  ``knob_table``, ``providers`` and ``doc`` (the registry's
    docstring) replace the live ones (test fixtures)."""
    root = root or repo_root()
    table = knobs.KNOBS if knob_table is None else knob_table
    sources, findings = collect_sources(root)
    findings.extend(check_provenance(sources, knob_table))
    findings.extend(check_key_completeness(knob_table, providers))
    findings.extend(check_scope(sources, knob_table))
    findings.extend(check_docs((knobs.__doc__ or "") if doc is None else doc, knob_table))
    findings.extend(check_parsers(knob_table))
    findings.sort(key=lambda f: (f.path, f.rule, f.snippet))
    return findings, {"knobs": sorted(table), "registry": REGISTRY_PATH}
