"""Host-sync rules (TRC001-TRC005), recast for PyTorch: the port of
``bfs_tpu.analysis.transfer``.

A level-synchronous superstep only wins while the card runs ahead of the
host; one stray ``.item()``, ``.cpu()`` or ``print`` of a tensor inside a
served tick or a level loop puts a host round-trip back in every
superstep.  The rules apply only inside hot regions (:mod:`.core`); the
same constructs are fine in build and reporting code.  A line inside
``with explicit_transfer():`` is an intended transfer and exempt.

The reference's TRC006 (Python control flow on a traced value) has no
counterpart in eager torch: a Python branch on a tensor is a host sync,
which TRC002 already catches through its ``bool()``.
"""

from __future__ import annotations

import ast

from .core import Finding, HotRegion, SourceFile, dotted_name, explicit_spans, hot_regions

#: Call targets that copy their argument to the host.
_MATERIALIZERS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array", "np.copy",
                  "numpy.copy"}
#: Methods that copy a tensor to the host.
_HOST_METHODS = {"tolist", "cpu", "numpy"}
#: Ops whose output shape depends on the data (the host waits for it).
_SHAPE_SYNCS = {"nonzero", "masked_select", "argwhere"}


def _is_constant_expr(node: ast.AST) -> bool:
    """Literals and arithmetic over literals: ``int(1e9)`` is fine."""
    return all(isinstance(n, (ast.Constant, ast.BinOp, ast.UnaryOp, ast.operator, ast.unaryop,
                              ast.expr_context)) for n in ast.walk(node))


def _region_for(line: int, regions: list[HotRegion]) -> HotRegion | None:
    best: HotRegion | None = None
    for r in regions:
        if r.start <= line <= r.end and (best is None or r.start > best.start):
            best = r  # the innermost (largest start) wins
    return best


def check_transfer(src: SourceFile) -> list[Finding]:
    regions = hot_regions(src)
    if not regions:
        return []
    exempt = explicit_spans(src)
    findings: list[Finding] = []

    def emit(rule: str, node: ast.AST, msg: str) -> None:
        f = src.finding(rule, node, msg)
        if f is not None:
            findings.append(f)

    for node in ast.walk(src.tree):
        if not isinstance(node, ast.Call):
            continue
        line = node.lineno
        region = _region_for(line, regions)
        if region is None or any(a <= line <= b for a, b in exempt):
            continue
        fname = dotted_name(node.func)
        attr = node.func.attr if isinstance(node.func, ast.Attribute) else None
        where = f"hot region '{region.name}'"
        if attr == "item":
            emit("TRC001", node, f"{where}: .item() forces a device->host sync per call")
        elif fname in ("float", "int", "bool") and node.args and not all(
                _is_constant_expr(a) for a in node.args):
            emit("TRC002", node, f"{where}: {fname}() of a tensor syncs; hoist it out of the "
                                 "hot region or make the read explicit")
        elif fname in _MATERIALIZERS or attr in _HOST_METHODS:
            what = fname if fname in _MATERIALIZERS else f".{attr}()"
            emit("TRC003", node, f"{where}: {what} copies its tensor to the host")
        elif attr in _SHAPE_SYNCS or fname.rsplit(".", 1)[-1] in _SHAPE_SYNCS:
            emit("TRC004", node, f"{where}: {fname or attr}() has a data-dependent shape: "
                                 "the host waits for the card")
        elif fname == "print":
            emit("TRC005", node, f"{where}: print() syncs its tensor arguments")
    return findings
