"""Rule logic of the knob rung (KNB001-KNB005): the port of
``bfs_tpu.analysis.knob_rules``.

Pure functions over ASTs and the registry (:mod:`bfs_tpu_torch.knobs`).
The contract: every ``BFS_TPU_TORCH_*`` read of the shipped code goes
through the typed accessors (``knobs.get`` / ``knobs.raw``); every
registered knob is read somewhere; each knob's ``affects`` equals the
knobs each key builder really hashes (imported, not grepped); no
call-scoped knob is baked in at import or read inside a captured region;
``knobs.py``'s own table (the port keeps its knob table there, not in the
README) agrees with the registry; every parser takes its default and
refuses its canary with an error that names the knob.
"""

from __future__ import annotations

import ast
import importlib
import re

from .. import knobs as registry
from .core import Finding, SourceFile, dotted_name, hot_regions

REGISTRY_PATH = "bfs_tpu_torch/knobs.py"
PREFIX = "BFS_TPU_TORCH_"

_ACCESSOR_ATTRS = frozenset({"get", "raw"})


def _literal_knob(node) -> str | None:
    """The ``BFS_TPU_TORCH_*`` literal at ``node``, else None (a name held in
    a variable, as the key builders' loops over their tuples, is KNB002's)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        if node.value.startswith(PREFIX):
            return node.value
    return None


def _is_environ(node) -> bool:
    return ((isinstance(node, ast.Attribute) and node.attr == "environ")
            or (isinstance(node, ast.Name) and node.id == "environ"))


def iter_env_reads(tree: ast.AST):
    """``(node, knob name, kind)`` for every raw environment read of a
    literal ``BFS_TPU_TORCH_*`` name: ``environ.get``/``getenv`` (``get``)
    or ``environ[...]`` loaded (``subscript``).  Writes, ``pop`` and ``del``
    are not reads."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fn = node.func
            if (isinstance(fn, ast.Attribute) and fn.attr == "get" and _is_environ(fn.value)
                    and node.args):
                name = _literal_knob(node.args[0])
                if name:
                    yield node, name, "get"
            elif dotted_name(fn) in ("os.getenv", "getenv") and node.args:
                name = _literal_knob(node.args[0])
                if name:
                    yield node, name, "get"
        elif isinstance(node, ast.Subscript):
            if isinstance(node.ctx, ast.Load) and _is_environ(node.value):
                name = _literal_knob(node.slice)
                if name:
                    yield node, name, "subscript"


def iter_accessor_reads(tree: ast.AST):
    """``(node, knob name, attr)`` for every ``knobs.get("...")`` /
    ``knobs.raw("...")`` with a literal name."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if (isinstance(fn, ast.Attribute) and fn.attr in _ACCESSOR_ATTRS
                and isinstance(fn.value, ast.Name) and fn.value.id == "knobs" and node.args):
            name = _literal_knob(node.args[0])
            if name:
                yield node, name, fn.attr


def _registry_finding(rule: str, message: str, snippet: str) -> Finding:
    return Finding(rule=rule, path=REGISTRY_PATH, line=0, col=0, message=message,
                   snippet=snippet)


# --------------------------------------------------------------------------
# KNB001: provenance, both ways.
# --------------------------------------------------------------------------

def check_provenance(sources: list[SourceFile], knob_table: dict | None = None) -> list[Finding]:
    """A raw environment read of a ``BFS_TPU_TORCH_*`` name outside the
    registry module; an accessor read of an unregistered name; a registered
    knob with no accessor read anywhere on the surface (a dead row)."""
    table = registry.KNOBS if knob_table is None else knob_table
    findings: list[Finding] = []
    read_names: set[str] = set()
    for src in sources:
        if src.path != REGISTRY_PATH:
            for node, name, kind in iter_env_reads(src.tree):
                spelled = "os.environ[...]" if kind == "subscript" else "os.environ.get/getenv"
                msg = (f"raw {spelled} read of registered knob {name} bypasses the typed "
                       "accessor: use knobs.get (typed, validated) or knobs.raw"
                       if name in table else
                       f"environment read of unregistered knob {name}: every "
                       f"{PREFIX}* knob needs a row in {REGISTRY_PATH} before it is read")
                f = src.finding("KNB001", node, msg)
                if f:
                    findings.append(f)
        for node, name, _attr in iter_accessor_reads(src.tree):
            read_names.add(name)
            if name not in table:
                f = src.finding("KNB001", node, f"accessor read of unregistered knob {name}: "
                                                "knobs.get/raw would raise; add the row")
                if f:
                    findings.append(f)
    for name in sorted(set(table) - read_names):
        findings.append(_registry_finding(
            "KNB001", f"registered knob {name} has no accessor read anywhere on the lint "
                      "surface: prune the row or restore the read", f"knb:{name}:unread"))
    return findings


# --------------------------------------------------------------------------
# KNB002: key completeness against the live key builders.
# --------------------------------------------------------------------------

#: domain -> (module, attribute) holding the knob names that key it.
KEY_PROVIDERS: dict[str, tuple[str, str]] = {
    "layout": ("bfs_tpu_torch.cache.layout", "_LAYOUT_ENV"),
    "tiles": ("bfs_tpu_torch.cache.layout", "_TILES_ENV"),
    "labels": ("bfs_tpu_torch.cache.layout", "_LABELS_ENV"),
    "probe": ("bfs_tpu_torch.cache.layout", "_PROBE_ENV"),
    "journal": ("bfs_tpu_torch.resilience.journal", "ENV_CONFIG_KEYS"),
    "serve": ("bfs_tpu_torch.serve.registry", "ENGINE_FLAVOR_ENV"),
}


def check_key_completeness(knob_table: dict | None = None,
                           providers: dict | None = None) -> list[Finding]:
    """Import each key provider and set-compare its tuple with the knobs
    whose ``affects`` declare the domain, both ways; a provider that does
    not import is KNB000.  ``providers`` entries may be plain sequences
    (test fixtures).  Also: a knob carries a ``journal_key`` exactly when
    it declares ``journal``."""
    table = registry.KNOBS if knob_table is None else knob_table
    provs = KEY_PROVIDERS if providers is None else providers
    findings: list[Finding] = []
    for domain in sorted(provs):
        spec = provs[domain]
        declared = {k.name for k in table.values() if domain in k.affects}
        if (isinstance(spec, tuple) and len(spec) == 2 and all(isinstance(s, str) for s in spec)
                and "." in spec[0]):
            mod_name, attr = spec
            try:
                live = set(getattr(importlib.import_module(mod_name), attr))
            except Exception as exc:
                findings.append(_registry_finding(
                    "KNB000", f"[{domain}] key provider {mod_name}.{attr} failed to import: "
                              f"{type(exc).__name__}: {exc}; an unchecked key is unproven",
                    f"knb:{domain}:provider"))
                continue
            where = f"{mod_name}.{attr}"
        else:
            live, where = set(spec), f"<fixture:{domain}>"
        for name in sorted(declared - live):
            findings.append(_registry_finding(
                "KNB002", f"{name} declares affects['{domain}'] but is missing from {where}: "
                          "a warm entry would be reused under a value it was never keyed on",
                f"knb:{name}:{domain}:unkeyed"))
        for name in sorted(live - declared):
            findings.append(_registry_finding(
                "KNB002", f"{where} keys on {name}, which does not declare "
                          f"affects['{domain}']: declare it or stop keying on it",
                f"knb:{name}:{domain}:undeclared"))
    for name in sorted(table):
        k = table[name]
        if (k.journal_key is not None) != ("journal" in k.affects):
            findings.append(_registry_finding(
                "KNB002", f"{name}: a journal_key goes with affects['journal'] and only "
                          "with it", f"knb:{name}:journal-key"))
    return findings


# --------------------------------------------------------------------------
# KNB003: scope.
# --------------------------------------------------------------------------

def _function_lines(tree: ast.AST) -> set[int]:
    lines: set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            lines.update(range(node.lineno, (node.end_lineno or node.lineno) + 1))
    return lines


def check_scope(sources: list[SourceFile], knob_table: dict | None = None) -> list[Finding]:
    """A ``scope='call'`` knob read at module or class level (baked into an
    import-time constant: a later change of the environment does nothing),
    and any knob read inside a captured region (its value would be fixed
    in the CUDA graph while looking like a switch)."""
    table = registry.KNOBS if knob_table is None else knob_table
    findings: list[Finding] = []
    for src in sources:
        in_fn = _function_lines(src.tree)
        captured = [(r.start, r.end) for r in hot_regions(src) if r.captured]
        for node, name, _attr in iter_accessor_reads(src.tree):
            k = table.get(name)
            if k is None:
                continue  # KNB001's
            line = node.lineno
            if line not in in_fn and k.scope != "import":
                f = src.finding("KNB003", node, f"call-scoped knob {name} read at import time: "
                                                "read it where the run resolves it, or declare "
                                                "scope='import'")
                if f:
                    findings.append(f)
            for start, end in captured:
                if start <= line <= end:
                    f = src.finding("KNB003", node, f"knob {name} read inside a captured region "
                                                    f"(lines {start}-{end}): resolve it before "
                                                    "the capture and pass the value in")
                    if f:
                        findings.append(f)
                    break
    return findings


# --------------------------------------------------------------------------
# KNB004: knobs.py's table against the registry.
# --------------------------------------------------------------------------

_ROW = re.compile(rf"^\s+({PREFIX}\w+)\s+(\w+)\s+(\S+)")


def doc_table_rows(doc: str) -> dict[str, tuple[int, str, str]]:
    """``{name: (line, type, default)}`` of the rows of the table in
    ``knobs.py``'s docstring (``""`` read as the empty default)."""
    rows: dict[str, tuple[int, str, str]] = {}
    for i, line in enumerate(doc.splitlines(), start=1):
        m = _ROW.match(line)
        if m and m.group(1) not in rows:
            default = "" if m.group(3) == '""' else m.group(3)
            rows[m.group(1)] = (i, m.group(2), default)
    return rows


def check_docs(doc: str, knob_table: dict | None = None) -> list[Finding]:
    """Every registered knob has a row with its type and default, and every
    row names a registered knob."""
    table = registry.KNOBS if knob_table is None else knob_table
    rows = doc_table_rows(doc)
    findings: list[Finding] = []
    for name in sorted(set(table) - set(rows)):
        findings.append(_registry_finding(
            "KNB004", f"registered knob {name} has no row in the table of knobs.py's "
                      "docstring", f"knb:{name}:undocumented"))
    for name in sorted(set(rows) - set(table)):
        findings.append(_registry_finding(
            "KNB004", f"the table of knobs.py's docstring documents {name}, which is not "
                      "registered", f"knb:{name}:stale-row"))
    for name in sorted(set(rows) & set(table)):
        _, typ, default = rows[name]
        k = table[name]
        if (typ, default) != (k.type, k.default):
            findings.append(_registry_finding(
                "KNB004", f"{name}: the table says {typ} {default!r}, the registry "
                          f"{k.type} {k.default!r}", f"knb:{name}:doc-drift"))
    return findings


# --------------------------------------------------------------------------
# KNB005: parser round-trips.
# --------------------------------------------------------------------------

_FREEFORM_TYPES = frozenset({"path"})


def check_parsers(knob_table: dict | None = None) -> list[Finding]:
    """Each default parses; each canary is refused with an error naming the
    knob; a knob of a validated type without a canary is a finding."""
    table = registry.KNOBS if knob_table is None else knob_table
    live = knob_table is None
    findings: list[Finding] = []
    for name in sorted(table):
        k = table[name]
        try:
            registry.parse_value(name, k.default) if live else k.parse(k.default)
        except Exception as exc:
            findings.append(_registry_finding(
                "KNB005", f"{name}: default {k.default!r} refused by its own parser ({exc})",
                f"knb:{name}:default-rejected"))
            continue
        if k.canary is None:
            if k.type not in _FREEFORM_TYPES:
                findings.append(_registry_finding(
                    "KNB005", f"{name}: no canary; a {k.type} parser must refuse something",
                    f"knb:{name}:no-canary"))
            continue
        try:
            registry.parse_value(name, k.canary) if live else k.parse(k.canary)
            rejected = named = False
        except (ValueError, TypeError) as exc:
            rejected, named = True, (not live) or name in str(exc)
        if not rejected:
            findings.append(_registry_finding(
                "KNB005", f"{name}: canary {k.canary!r} was accepted", f"knb:{name}:canary-accepted"))
        elif not named:
            findings.append(_registry_finding(
                "KNB005", f"{name}: the refusal does not name the knob", f"knb:{name}:error-unnamed"))
    return findings
