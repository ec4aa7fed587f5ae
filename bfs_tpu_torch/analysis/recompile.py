"""Under-keyed executable caches (RCD005): the port of the reference's
``bfs_tpu.analysis.recompile`` rule of that name.

The port's executables are cached in two places: the serve
:class:`~bfs_tpu_torch.serve.executor.ExecutableCache`
(``exe_cache.get(key, build)``) and each engine's ``_loops``
(``loop.cached(self._loops, kind, make)``), whose loops are captured into
CUDA graphs at first use.  A build closure that specializes on a value the
key does not carry serves a runner or a captured loop built for another
value.  RCD005 flags a free read of the closure that is a per-call local
of an enclosing function and absent from the key.  A key given as a name
is resolved to the expressions assigned to it; bare parameters (handles
threaded through) are context, as in the reference.

The reference's RCD001-RCD004 police ``jax.jit`` call sites (fresh
callables, computed static arguments, compiles in loops, per-call key
elements); eager torch has no such call site.
"""

from __future__ import annotations

import ast

from .core import Finding, SourceFile, dotted_name


def _enclosing_stack(tree: ast.AST) -> dict[int, list[ast.AST]]:
    """id(node) -> the chain of enclosing function nodes, outermost first."""
    chains: dict[int, list[ast.AST]] = {}

    def walk(node: ast.AST, stack: list[ast.AST]) -> None:
        for child in ast.iter_child_nodes(node):
            chains[id(child)] = stack
            nested = stack
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                nested = stack + [child]
            walk(child, nested)

    walk(tree, [])
    return chains


def _assigned_names(fn: ast.AST) -> set[str]:
    """Names a function body assigns (its per-call locals), nested defs'
    bodies excluded."""
    names: set[str] = set()
    for n in _own_nodes(fn):
        targets: list[ast.AST] = []
        if isinstance(n, ast.Assign):
            targets = list(n.targets)
        elif isinstance(n, (ast.AugAssign, ast.AnnAssign, ast.For)):
            targets = [n.target]
        elif isinstance(n, ast.NamedExpr):
            targets = [n.target]
        for tgt in targets:
            names.update(t.id for t in ast.walk(tgt) if isinstance(t, ast.Name))
    return names


def _own_nodes(fn: ast.AST):
    """The nodes of ``fn``'s body, not descending into nested functions."""
    stack = list(getattr(fn, "body", []))
    if isinstance(fn, ast.Lambda):
        stack = [fn.body]
    while stack:
        n = stack.pop()
        yield n
        for child in ast.iter_child_nodes(n):
            if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                stack.append(child)


def _params(fn: ast.AST) -> set[str]:
    a = fn.args
    return {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs} | (
        {a.vararg.arg} if a.vararg else set()) | ({a.kwarg.arg} if a.kwarg else set())


def _key_names(key: ast.AST, encl: list[ast.AST]) -> set[str]:
    """Names and attribute names in the key expression; a bare name is
    resolved to every expression assigned to it in the enclosing
    functions."""
    exprs = [key]
    if isinstance(key, ast.Name):
        for fn in encl:
            for n in _own_nodes(fn):
                if isinstance(n, ast.Assign) and any(
                        isinstance(t, ast.Name) and t.id == key.id for t in n.targets):
                    exprs.append(n.value)
    out: set[str] = set()
    for e in exprs:
        for n in ast.walk(e):
            if isinstance(n, ast.Name):
                out.add(n.id)
            elif isinstance(n, ast.Attribute):
                out.add(n.attr)
    return out


def _closure_reads(build: ast.AST) -> tuple[set[str], dict[str, set[str]]]:
    """Free names a build closure (a lambda or a def) loads, and for each
    the attributes it reads off it."""
    inner = _params(build) | (set() if isinstance(build, ast.Lambda) else _assigned_names(build))
    for n in ast.walk(build):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and n is not build:
            inner |= {n.name} | _params(n) | _assigned_names(n)
    reads: set[str] = set()
    attrs: dict[str, set[str]] = {}
    for n in ast.walk(build):
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) and n.id not in inner:
            reads.add(n.id)
        if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name):
            attrs.setdefault(n.value.id, set()).add(n.attr)
    return reads, attrs


def _find_def(name: str, encl: list[ast.AST]) -> ast.AST | None:
    for fn in reversed(encl):
        for n in _own_nodes(fn):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and n.name == name:
                return n
    return None


def _cache_call(node: ast.Call) -> tuple[ast.AST, ast.AST] | None:
    """``(key, build)`` of ``<..>.exe_cache.get(key, build)`` or
    ``cached(<..>._loops, key, make)``; else None."""
    name = dotted_name(node.func)
    tail = name.rsplit(".", 1)[-1] if name else ""
    if (isinstance(node.func, ast.Attribute) and node.func.attr == "get" and len(node.args) >= 2
            and dotted_name(node.func.value).rsplit(".", 1)[-1] in ("exe_cache",
                                                                    "executable_cache")):
        return node.args[0], node.args[1]
    if (tail == "cached" and len(node.args) >= 3
            and dotted_name(node.args[0]).rsplit(".", 1)[-1].endswith("_loops")):
        return node.args[1], node.args[2]
    return None


def check_recompile(src: SourceFile) -> list[Finding]:
    findings: list[Finding] = []
    chains = _enclosing_stack(src.tree)
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.Call):
            continue
        pair = _cache_call(node)
        if pair is None:
            continue
        key, build = pair
        encl = [n for n in chains.get(id(node), []) if not isinstance(n, ast.Lambda)]
        if not encl:
            continue
        if isinstance(build, ast.Name):
            build = _find_def(build.id, encl)
            if build is None:
                continue
        elif not isinstance(build, ast.Lambda):
            continue
        keyed = _key_names(key, encl)
        local = set().union(*(_assigned_names(fn) for fn in encl)) - {"self"}
        reads, attrs = _closure_reads(build)
        for name in sorted(reads & local):
            if name in keyed:
                continue
            read = attrs.get(name)
            if read and read <= keyed:
                continue  # every attribute the closure reads off it is keyed
            at = next(n for n in ast.walk(build)
                      if isinstance(n, ast.Name) and n.id == name and isinstance(n.ctx, ast.Load))
            f = src.finding("RCD005", at,
                            f"build closure reads '{name}', which is not part of the cache "
                            f"key: two calls differing only in '{name}' would share one "
                            "executable")
            if f is not None:
                findings.append(f)
    return findings
