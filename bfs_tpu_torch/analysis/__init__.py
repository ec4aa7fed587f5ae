"""bfs_tpu_torch.analysis: the port's linter and runtime sanitizers, the
counterpart of ``bfs_tpu.analysis``.

Static half (stdlib only, never imports torch): AST rules over the port's
own sources --

* **host syncs** (TRC001-TRC005): ``.item()``, conversions, host copies,
  data-shaped ops and ``print`` inside declared hot regions;
* **executable caches** (RCD005): build closures that read a value the
  cache key does not carry;
* **lock discipline** (LCK001-LCK002): ``# guarded-by:`` fields accessed
  outside their lock;
* **observability** (OBS001) and **pragma hygiene** (PRG001);

and two rungs that import the package: the knob rung (KNB000-KNB005,
:mod:`.knobs`) and the kernel registry (KRN000-KRN001, :mod:`.kernels`).

Runtime half (:mod:`.runtime`): the transfer guard, the retrace counter and
the lock-order recorder.

CLI: ``python -m bfs_tpu_torch.analysis [paths] [--knobs] [--kernels]
[--all]``.  Exit 0 = clean modulo the committed baseline.

The reference's passes over jaxprs, HLO and Mosaic kernels (``ir.py``,
``hlo.py``, ``hlo_rules.py``, ``pallas_rules.py``, the jit rules
RCD001-RCD004 and TRC006) have no torch counterpart; ``collectives.py``
waits for the port's multi-card engines.
"""

from __future__ import annotations

import os

from .core import (
    RULES,
    Baseline,
    Finding,
    SourceFile,
    iter_python_files,
    repo_root,
)
from .locks import check_locks
from .obs import check_obs
from .recompile import check_recompile
from .runtime import (
    format_retrace_report,
    guarded_region,
    hot_region,
    retrace_report,
    traced,
    transfer_guard_level,
)
from .transfer import check_transfer

__all__ = [
    "RULES", "Baseline", "Finding", "SourceFile",
    "analyze_file", "analyze_paths", "default_baseline_path", "iter_python_files", "repo_root",
    "guarded_region", "hot_region", "traced",
    "retrace_report", "format_retrace_report", "transfer_guard_level",
]

_CHECKERS = (check_transfer, check_recompile, check_locks, check_obs)


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "baseline.txt")


def analyze_file(path: str, root: str, text: str | None = None) -> list[Finding]:
    """Every AST finding of one module; a syntax error is one finding."""
    try:
        src = SourceFile(path, root, text=text)
    except SyntaxError as exc:
        rel = os.path.relpath(os.path.abspath(path), root).replace(os.sep, "/")
        return [Finding(rule="PRG001", path=rel, line=exc.lineno or 0, col=0,
                        message=f"could not parse: {exc.msg}", snippet="")]
    findings: list[Finding] = []
    for line, msg in src.pragma_problems:
        if not src.suppressed(line, "PRG001"):
            findings.append(Finding(rule="PRG001", path=src.path, line=line, col=0,
                                    message=msg, snippet=src.snippet(line)))
    for checker in _CHECKERS:
        findings.extend(checker(src))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def analyze_paths(paths: list[str], root: str) -> list[Finding]:
    findings: list[Finding] = []
    for path in iter_python_files(paths):
        findings.extend(analyze_file(path, root))
    return findings
