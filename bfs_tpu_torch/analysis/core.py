"""Shared infrastructure of the port's lint: findings, pragma parsing,
hot-region discovery and the committed baseline.  The port of
``bfs_tpu.analysis.core`` for PyTorch sources.

Stdlib only (``ast`` + ``tokenize``): the pass runs on a bare CPU image
and never imports torch.

Pragmas (comments, invisible at run time):

``# bfs_tpu_torch: hot``
    Marks the next ``def`` at or below the comment (or the ``def`` on the
    same line) as a hot region: the host-sync rules apply to its body.
    Functions decorated with :func:`bfs_tpu_torch.analysis.runtime.hot_region`
    are hot too.  ``# bfs_tpu_torch: hot captured`` marks a body that runs
    under a CUDA-graph capture (the port's counterpart of a traced body):
    KNB003 refuses a knob read there.

``# bfs_tpu_torch: hot-start`` / ``# bfs_tpu_torch: hot-end``
    Bracket a line range as hot.

``# bfs_tpu_torch: ok RULE[,RULE] [reason]``
    Suppress the named rules on this line (a comment on a line of its own
    covers the next line too).  ``ok *`` suppresses everything.

``# guarded-by: lockname[|alt ...]``
    On a field's assignment: every later read or write must hold the lock
    (LCK001).

``# bfs_tpu_torch: holds lockname[,lockname]``
    On a ``def``: callers hold the named locks for the whole body.

Inside a hot region, a line in a ``with explicit_transfer():`` block (the
runtime's marker of an intended transfer) is a transfer, not a finding.

Baseline: one accepted finding per line, ``RULE  fingerprint
justification``.  The fingerprint hashes the rule, the repo-relative path
and the stripped source line, not the line number: an edit above a
finding keeps it, an edit of the line forces a new triage.
"""

from __future__ import annotations

import ast
import hashlib
import io
import os
import tokenize
from dataclasses import dataclass, field

PRAGMA = "bfs_tpu_torch:"

#: rule id -> (severity, one-line description); the catalog the CLI prints.
RULES: dict[str, tuple[str, str]] = {
    # -- host syncs in hot regions -----------------------------------------
    "TRC001": ("error", ".item() in a hot region forces a device->host sync"),
    "TRC002": ("error", "float()/int()/bool() of a non-constant in a hot region "
                        "syncs on a tensor"),
    "TRC003": ("error", ".tolist()/.cpu()/.numpy()/np.asarray/np.array in a hot "
                        "region copies a tensor to the host; make an intended copy "
                        "explicit (with explicit_transfer(): ...)"),
    "TRC004": ("error", "torch.nonzero/masked_select in a hot region: the output's "
                        "shape depends on the data, so the host waits for it"),
    "TRC005": ("error", "print() in a hot region syncs its tensor arguments"),
    # -- executable caches -------------------------------------------------
    "RCD005": ("error", "executable-cache build closure reads a local that is not "
                        "part of the cache key (under-keyed executable or loop)"),
    # -- observability -----------------------------------------------------
    "OBS001": ("error", "telemetry/metrics read inside a hot region: read it once "
                        "after the loop, never per superstep"),
    # -- pragma hygiene ----------------------------------------------------
    "PRG001": ("error", "overlapping '# bfs_tpu_torch: hot-start': the previous "
                        "span was still open"),
    # -- lock discipline ---------------------------------------------------
    "LCK001": ("error", "guarded-by field accessed outside its declared lock"),
    "LCK002": ("warning", "shared mutable field in a lock-owning class has no "
                          "guarded-by annotation"),
    # -- knob provenance (analysis/knobs.py) -------------------------------
    "KNB000": ("error", "knob pass could not prove a surface: a module failed to "
                        "parse or a key provider failed to import"),
    "KNB001": ("error", "knob provenance broken: a raw os.environ read of a "
                        "BFS_TPU_TORCH_* name, an unregistered name, or a "
                        "registered knob with no read site"),
    "KNB002": ("error", "cache-key completeness broken: a knob's affects disagree "
                        "with the knobs a key builder hashes"),
    "KNB003": ("error", "knob scope broken: a call-scoped knob baked in at import, "
                        "or a knob read inside a captured region"),
    "KNB004": ("error", "knob doc table broken: knobs.py's table and the registry "
                        "disagree"),
    "KNB005": ("error", "knob parser round-trip broken: a default refused, a "
                        "canary accepted, or an error that does not name the knob"),
    # -- kernel registry (analysis/kernels.py) -----------------------------
    "KRN000": ("error", "kernel registry pin broken: a __global__ kernel without a "
                        "spec (or a spec without one), launch keys that are not "
                        "LAUNCHES's, a wrapper or plain version that does not "
                        "import, or a reference kernel uncovered"),
    "KRN001": ("error", "a kernel disagrees with its plain version at lint scale "
                        "(run on a card)"),
}

#: Rules never accepted from the baseline: a kernel that disagrees with its
#: plain version computes wrong answers.
NEVER_BASELINE = frozenset({"KRN001"})


@dataclass
class Finding:
    rule: str
    path: str  # repo-relative, forward slashes
    line: int
    col: int
    message: str
    snippet: str = ""

    @property
    def severity(self) -> str:
        return RULES.get(self.rule, ("error", ""))[0]

    def fingerprint(self) -> str:
        basis = f"{self.rule}|{self.path}|{self.snippet.strip()}"
        return hashlib.blake2b(basis.encode(), digest_size=6).hexdigest()

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} [{self.severity}] {self.message}"


def _parse_pragma(text: str) -> tuple[str, str] | None:
    """``'# bfs_tpu_torch: hot-start'`` -> ``('hot-start', '')``;
    ``'# guarded-by: _lock'`` -> ``('guarded-by', '_lock')``; else None."""
    body = text.lstrip("#").strip()
    if body.startswith(PRAGMA):
        rest = body[len(PRAGMA):].strip()
        if not rest:
            return None
        word, _, arg = rest.partition(" ")
        return word, arg.strip()
    if body.startswith("guarded-by:"):
        return "guarded-by", body[len("guarded-by:"):].strip()
    return None


class SourceFile:
    """One parsed module: its AST and pragma maps."""

    def __init__(self, path: str, root: str, text: str | None = None):
        self.abspath = os.path.abspath(path)
        self.path = os.path.relpath(self.abspath, root).replace(os.sep, "/")
        if text is None:
            with open(self.abspath, encoding="utf-8") as f:
                text = f.read()
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=self.path)
        self.suppressions: dict[int, set[str]] = {}
        self.guard_decls: dict[int, str] = {}
        #: def-line pragmas: line -> True for '# bfs_tpu_torch: hot captured'
        self.hot_pragma_lines: dict[int, bool] = {}
        self.holds_decls: dict[int, list[str]] = {}
        self.hot_spans: list[tuple[int, int]] = []
        self.pragma_problems: list[tuple[int, str]] = []
        self._scan_comments()

    def _scan_comments(self) -> None:
        open_start: int | None = None
        try:
            tokens = tokenize.generate_tokens(io.StringIO(self.text).readline)
            comments = [(t.start[0], t.string) for t in tokens if t.type == tokenize.COMMENT]
        except tokenize.TokenError:
            comments = []
        for lineno, text in comments:
            pragma = _parse_pragma(text)
            if pragma is None:
                continue
            kind, arg = pragma
            own_line = self.lines[lineno - 1].strip().startswith("#")
            if kind == "ok":
                rules = {r.strip() for r in arg.split(" ")[0].split(",") if r.strip()} or {"*"}
                self.suppressions.setdefault(lineno, set()).update(rules)
                if own_line:
                    self.suppressions.setdefault(lineno + 1, set()).update(rules)
            elif kind == "hot":
                self.hot_pragma_lines[lineno] = arg.split(" ")[0] == "captured"
            elif kind == "hot-start":
                if open_start is not None:
                    # Keep the coverage (close the first span here) and flag it.
                    self.hot_spans.append((open_start, lineno))
                    self.pragma_problems.append((
                        lineno, f"hot-start while the span opened at line {open_start} is "
                                "still open (missing hot-end?)"))
                open_start = lineno
            elif kind == "hot-end":
                if open_start is not None:
                    self.hot_spans.append((open_start, lineno))
                    open_start = None
            elif kind == "holds":
                locks = [x.strip() for x in arg.replace(",", " ").split() if x.strip()]
                self.holds_decls[lineno] = locks
                if own_line:
                    self.holds_decls.setdefault(lineno + 1, locks)
            elif kind == "guarded-by":
                self.guard_decls[lineno] = arg.split(" ")[0] if arg else ""
        if open_start is not None:  # an unclosed span is hot to the end
            self.hot_spans.append((open_start, len(self.lines)))

    def snippet(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def suppressed(self, lineno: int, rule: str) -> bool:
        rules = self.suppressions.get(lineno, ())
        return "*" in rules or rule in rules

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding | None:
        line = getattr(node, "lineno", 0)
        if self.suppressed(line, rule):
            return None
        return Finding(rule=rule, path=self.path, line=line,
                       col=getattr(node, "col_offset", 0), message=message,
                       snippet=self.snippet(line))


def dotted_name(node: ast.AST) -> str:
    """``torch.cuda.synchronize`` -> that string; '' for anything else."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


_HOT_DECORATORS = {"hot_region", "runtime.hot_region", "analysis.hot_region"}


def _pragma_applies(src: SourceFile, fn: ast.FunctionDef) -> bool | None:
    """A ``# bfs_tpu_torch: hot`` comment marks the next def at or below it.
    Returns None (no pragma) or the pragma's captured flag."""
    first = min([d.lineno for d in fn.decorator_list] + [fn.lineno])
    for line, captured in src.hot_pragma_lines.items():
        if line == fn.lineno or (line < first and _no_def_between(src, line, first)):
            return captured
    return None


def _no_def_between(src: SourceFile, lo: int, hi: int) -> bool:
    for ln in range(lo + 1, hi):
        stripped = src.lines[ln - 1].lstrip() if ln <= len(src.lines) else ""
        if stripped.startswith(("def ", "async def ", "class ")):
            return False
    return True


@dataclass
class HotRegion:
    """One region the host-sync rules police; ``captured`` regions (a body
    run under a CUDA-graph capture) also refuse knob reads (KNB003)."""

    start: int
    end: int
    captured: bool
    name: str
    node: ast.AST | None = None


def hot_regions(src: SourceFile) -> list[HotRegion]:
    regions: list[HotRegion] = []
    for node in ast.walk(src.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        pragma = _pragma_applies(src, node)
        marked = pragma is not None or any(
            dotted_name(d) in _HOT_DECORATORS
            or (isinstance(d, ast.Call) and dotted_name(d.func) in _HOT_DECORATORS)
            for d in node.decorator_list)
        if marked:
            regions.append(HotRegion(node.lineno, node.end_lineno or node.lineno,
                                     bool(pragma), node.name, node))
    for start, end in src.hot_spans:
        regions.append(HotRegion(start, end, False, f"span@{start}"))
    return regions


_EXPLICIT = {"explicit_transfer", "runtime.explicit_transfer", "analysis.runtime.explicit_transfer"}


def explicit_spans(src: SourceFile) -> list[tuple[int, int]]:
    """Line spans of ``with explicit_transfer():`` blocks: intended
    transfers, exempt from the host-sync rules."""
    spans = []
    for node in ast.walk(src.tree):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                expr = item.context_expr
                if isinstance(expr, ast.Call) and dotted_name(expr.func) in _EXPLICIT:
                    spans.append((node.lineno, node.end_lineno or node.lineno))
    return spans


#: Directories never linted, even under a path given.
SKIP_DIRS = {".git", "__pycache__", ".bench_cache", "build", "dist", "_build", "fixtures"}


def repo_root() -> str:
    """The checkout that holds this package."""
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def iter_python_files(paths: list[str]):
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = sorted(d for d in dirnames if d not in SKIP_DIRS and not d.startswith("."))
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)


@dataclass
class Baseline:
    """The committed accepted-findings file: ``entries`` maps fingerprint ->
    (rule, justification); ``used`` records which entries matched this run,
    so the CLI can report stale ones."""

    path: str | None = None
    entries: dict[str, tuple[str, str]] = field(default_factory=dict)
    used: set[str] = field(default_factory=set)

    @classmethod
    def load(cls, path: str | None) -> "Baseline":
        bl = cls(path=path)
        if path is None or not os.path.exists(path):
            return bl
        with open(path, encoding="utf-8") as f:
            for raw in f:
                line = raw.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split(None, 2)
                if len(parts) < 2:
                    continue
                bl.entries[parts[1]] = (parts[0], parts[2] if len(parts) > 2 else "")
        return bl

    def accepts(self, finding: Finding) -> bool:
        if finding.rule in NEVER_BASELINE:
            return False
        fp = finding.fingerprint()
        if fp in self.entries:
            self.used.add(fp)
            return True
        return False

    def stale(self) -> list[str]:
        return [fp for fp in self.entries if fp not in self.used]

    @staticmethod
    def render(findings: list[Finding], justification: str = "TODO: justify") -> str:
        lines = [
            "# bfs_tpu_torch.analysis baseline: accepted findings.",
            "# One per line: RULE  fingerprint  [path:line] justification.",
            "# Fingerprints hash (rule, path, source line): line-number drift is",
            "# fine; editing the flagged line forces a new triage.",
        ]
        seen = set()
        for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
            if f.fingerprint() not in seen:  # one entry accepts every identical line
                seen.add(f.fingerprint())
                lines.append(f"{f.rule}  {f.fingerprint()}  [{f.path}:{f.line}] {justification}")
        return "\n".join(lines) + "\n"
