"""Lock-discipline rules (LCK001-LCK002): ``# guarded-by:`` checking, the
port of ``bfs_tpu.analysis.locks``.

The query server threads shared state through its server, registry,
executor, health and metrics objects, each field behind a named lock
(:func:`bfs_tpu_torch.utils.locks.make_lock`).  The annotation makes the
invariant explicit; the checker enforces it.  The model is lexical, as the
reference's:

* a field annotated ``# guarded-by: _lock`` on its initializing
  assignment must, in every other method of its class, be read or written
  inside a ``with self._lock`` block (module-level globals: ``with _lock``
  in the module's functions);
* ``a|b`` accepts either lock, and ``self._cond =
  threading.Condition(self._lock)`` makes ``_cond`` an alias of ``_lock``;
* ``# bfs_tpu_torch: holds _lock`` on a ``def`` declares that callers
  hold the lock (the body is checked as if it were held);
* ``__init__``/``__new__``/``__post_init__``/``__del__`` are exempt;
* a nested def is checked with the locks held where it is defined.

LCK002 (a warning) flags a mutable container assigned in a lock-owning
class without an annotation.  The dynamic complement, the order in which
locks nest across threads, is :mod:`.runtime`'s lock-order recorder.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from .core import Finding, SourceFile, dotted_name

_EXEMPT_METHODS = {"__init__", "__new__", "__post_init__", "__del__"}
_LOCK_FACTORIES = {
    "threading.Lock", "threading.RLock", "threading.Condition",
    "Lock", "RLock", "Condition", "threading.Semaphore",
    # the lock-order recorder's factory: a class building its lock through
    # it owns one.
    "make_lock", "runtime.make_lock",
}
_MUTABLE_FACTORIES = {
    "dict", "list", "set", "OrderedDict", "collections.OrderedDict",
    "deque", "collections.deque", "defaultdict", "collections.defaultdict",
}


@dataclass
class _ClassInfo:
    node: ast.ClassDef
    guards: dict[str, set[str]] = field(default_factory=dict)  # field -> locks
    guard_decl_line: dict[str, int] = field(default_factory=dict)
    aliases: dict[str, set[str]] = field(default_factory=dict)  # cond -> locks
    owns_lock: bool = False
    mutable_fields: dict[str, ast.AST] = field(default_factory=dict)


def _parse_guard_spec(spec: str) -> set[str]:
    return {s.strip() for s in spec.split("|") if s.strip()}


def _guard_spec_for(src: SourceFile, node: ast.AST) -> str | None:
    """The guarded-by spec attached to a statement: on a standalone
    comment line directly above it, on its first line, or (multi-line
    assignments) on any line through its last.  A trailing comment on the
    PREVIOUS statement's line never bleeds down."""
    start = getattr(node, "lineno", 0)
    end = getattr(node, "end_lineno", start) or start
    above = src.guard_decls.get(start - 1)
    if above and 1 <= start - 1 <= len(src.lines) and (
        src.lines[start - 2].strip().startswith("#")
    ):
        return above
    for line in range(start, end + 1):
        spec = src.guard_decls.get(line)
        if spec:
            return spec
    return None


def _self_attr(node: ast.AST) -> str | None:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _collect_class(src: SourceFile, cls: ast.ClassDef) -> _ClassInfo:
    info = _ClassInfo(cls)
    for node in ast.walk(cls):
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            continue
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        value = node.value
        for tgt in targets:
            name = _self_attr(tgt)
            if name is None:
                continue
            spec = _guard_spec_for(src, node)
            if spec:
                info.guards.setdefault(name, set()).update(_parse_guard_spec(spec))
                info.guard_decl_line[name] = node.lineno
            if isinstance(value, ast.Call):
                fname = dotted_name(value.func)
                if fname in _LOCK_FACTORIES:
                    info.owns_lock = True
                    wrapped = {
                        a
                        for arg in value.args
                        if (a := _self_attr(arg)) is not None
                    }
                    if wrapped:
                        info.aliases.setdefault(name, set()).update(wrapped)
                elif fname in _MUTABLE_FACTORIES:
                    info.mutable_fields.setdefault(name, tgt)
            elif isinstance(value, (ast.Dict, ast.List, ast.Set)):
                info.mutable_fields.setdefault(name, tgt)
    return info


def _held_from_with(item_expr: ast.AST, *, selfish: bool) -> str | None:
    """The lock name a ``with`` item acquires: ``self._lock`` or a bare
    module-level name (``_lock``, or the card's ``DEVICE_LOCK``, which
    guards fields of the serve objects too); ``cond`` variants look
    identical."""
    if selfish and _self_attr(item_expr) is not None:
        return _self_attr(item_expr)
    if isinstance(item_expr, ast.Name):
        return item_expr.id
    return None


def _expand(held: set[str], aliases: dict[str, set[str]]) -> set[str]:
    out = set(held)
    for h in held:
        out |= aliases.get(h, set())
    return out


class _AccessChecker(ast.NodeVisitor):
    """Walk one function body tracking lexically-held locks."""

    def __init__(
        self,
        src: SourceFile,
        guards: dict[str, set[str]],
        aliases: dict[str, set[str]],
        *,
        selfish: bool,
        initial: set[str],
        scope: str,
        emit,
    ):
        self.src = src
        self.guards = guards
        self.aliases = aliases
        self.selfish = selfish
        self.held: set[str] = set(initial)
        self.scope = scope
        self.emit = emit
        self.reported: set[tuple[int, str]] = set()

    # ------------------------------------------------------------ holding --
    def visit_With(self, node: ast.With) -> None:
        self._visit_with(node)

    def visit_AsyncWith(self, node: ast.AsyncWith) -> None:
        self._visit_with(node)

    def _visit_with(self, node) -> None:
        acquired = set()
        for item in node.items:
            got = _held_from_with(item.context_expr, selfish=self.selfish)
            if got is not None:
                acquired.add(got)
            self.visit(item.context_expr)
        before = set(self.held)
        self.held |= acquired
        for stmt in node.body:
            self.visit(stmt)
        self.held = before

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        # Nested def: checked with definition-site locks (see module doc).
        holds = self.src.holds_decls.get(node.lineno, [])
        before = set(self.held)
        self.held |= set(holds)
        for stmt in node.body:
            self.visit(stmt)
        self.held = before

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda) -> None:
        # Same definition-site-locks simplification as nested defs.
        before = set(self.held)
        self.visit(node.body)
        self.held = before

    # ----------------------------------------------------------- accesses --
    def visit_Attribute(self, node: ast.Attribute) -> None:
        if self.selfish:
            name = _self_attr(node)
            if name is not None and name in self.guards:
                self._check(node, name)
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name) -> None:
        if not self.selfish and node.id in self.guards:
            self._check(node, node.id)

    def _check(self, node: ast.AST, name: str) -> None:
        needed = self.guards[name]
        if _expand(self.held, self.aliases) & needed:
            return
        key = (node.lineno, name)
        if key in self.reported:
            return
        self.reported.add(key)
        lock_desc = "|".join(sorted(needed))
        self.emit(
            "LCK001", node,
            f"{self.scope}: '{name}' is guarded-by {lock_desc} but this "
            f"access holds none of it",
        )


def check_locks(src: SourceFile) -> list[Finding]:
    findings: list[Finding] = []

    def emit(rule: str, node: ast.AST, msg: str) -> None:
        f = src.finding(rule, node, msg)
        if f is not None:
            findings.append(f)

    # ------------------------------------------------------ module globals --
    mod_guards: dict[str, set[str]] = {}
    for node in src.tree.body:
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
            spec = _guard_spec_for(src, node)
            if spec:
                for tgt in targets:
                    if isinstance(tgt, ast.Name):
                        mod_guards.setdefault(tgt.id, set()).update(
                            _parse_guard_spec(spec)
                        )
    if mod_guards:
        for node in src.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if node.name in _EXEMPT_METHODS:
                    continue
                checker = _AccessChecker(
                    src, mod_guards, {}, selfish=False,
                    initial=set(src.holds_decls.get(node.lineno, [])),
                    scope=f"{node.name}()", emit=emit,
                )
                for stmt in node.body:
                    checker.visit(stmt)

    # ------------------------------------------------------------- classes --
    for cls in [n for n in ast.walk(src.tree) if isinstance(n, ast.ClassDef)]:
        info = _collect_class(src, cls)
        if info.guards:
            for meth in cls.body:
                if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if meth.name in _EXEMPT_METHODS:
                    continue
                holds = set(src.holds_decls.get(meth.lineno, []))
                for d in meth.decorator_list:
                    holds |= set(src.holds_decls.get(d.lineno, []))
                checker = _AccessChecker(
                    src, info.guards, info.aliases, selfish=True,
                    initial=holds,
                    scope=f"{cls.name}.{meth.name}()", emit=emit,
                )
                for stmt in meth.body:
                    checker.visit(stmt)
        if info.owns_lock:
            for name, tgt in sorted(info.mutable_fields.items()):
                if name in info.guards or name in info.aliases:
                    continue
                emit(
                    "LCK002", tgt,
                    f"{cls.name}.{name} is a mutable container in a "
                    "lock-owning class with no '# guarded-by:' annotation "
                    "— annotate it (or mark it ok with why it is "
                    "single-threaded/immutable-after-init)",
                )
    return findings
