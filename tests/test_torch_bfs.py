"""End to end: ``bfs_tpu_torch.bfs(..., device="cpu")`` against the JAX
reference ``RelayEngine`` (what ``bfs_tpu.bfs(engine="relay")`` runs), bit
for bit in dist, parent and num_levels, plus the port's guards."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bfs_tpu_torch as P

from bfs_tpu.graph import benes as j_benes
from bfs_tpu.graph import relay as j_relay
from bfs_tpu.graph.csr import Graph as JGraph
from bfs_tpu.models.bfs import RelayEngine as JRelayEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "test-sets", "tinyCG.txt")

needs_native = pytest.mark.skipif(
    not j_benes.native_available(), reason="native benes router unavailable"
)


def _disconnected() -> P.Graph:
    """Two R-MAT blocks with no edge between them, plus isolated vertices."""
    a = P.rmat_graph(7, 4, seed=8)
    shift = a.num_vertices
    edges = np.concatenate([
        np.stack([a.src, a.dst], axis=1),
        np.stack([a.src + shift, a.dst + shift], axis=1),
    ])
    return P.Graph.from_directed_edges(2 * shift + 20, edges)


GRAPHS = {
    "tinyCG": (lambda: P.read_sedgewick(TINY), (0, 3, 5)),
    "randomG": (lambda: P.read_sedgewick(os.path.join(REPO, "test-sets", "randomG.txt")), (0, 11, 249)),
    "rmat8": (lambda: P.rmat_graph(8, 8, seed=2), (0, 17, 200)),
    "rmat10": (lambda: P.rmat_graph(10, 6, seed=1), (1, 400, 1000)),
    "disconnected": (_disconnected, (0, 130, 260)),
    "path100": (lambda: P.path_graph(100), (0, 99)),
}


@needs_native
@pytest.mark.parametrize("name", list(GRAPHS))
def test_bfs_matches_reference(name):
    make, roots = GRAPHS[name]
    g = make()
    ours = P.RelayEngine(g, device="cpu")
    ref = JRelayEngine(JGraph(g.num_vertices, g.src.copy(), g.dst.copy()))
    for s in roots:
        got, want = ours.run(s), ref.run(s)
        np.testing.assert_array_equal(got.dist, want.dist)
        np.testing.assert_array_equal(got.parent, want.parent)
        assert got.num_levels == want.num_levels
        assert P.check(g, got.dist, got.parent, s) == []
    if name == "path100":
        assert got.num_levels == 100  # through the unpacked re-run
    if name == "disconnected":
        assert (got.dist == P.INF_DIST).any()


@needs_native
def test_bfs_on_tinycg_gives_the_papers_example():
    r = P.bfs(P.read_sedgewick(TINY), 0, engine="relay", device="cpu")
    assert r.dist.tolist() == [0, 1, 1, 2, 2, 1]
    assert r.parent.tolist() == [0, 0, 0, 2, 2, 0]
    assert r.num_levels == 3
    assert r.path_to(3) == [0, 2, 3] and r.has_path_to(4) and r.dist_to(5) == 1


@needs_native
@pytest.mark.parametrize("max_levels", [2, 70])
def test_max_levels_matches_reference(max_levels):
    g = P.path_graph(100)
    got = P.bfs(g, 0, engine="relay", device="cpu", max_levels=max_levels)
    want = JRelayEngine(JGraph(g.num_vertices, g.src.copy(), g.dst.copy())).run(
        0, max_levels=max_levels
    )
    np.testing.assert_array_equal(got.dist, want.dist)
    np.testing.assert_array_equal(got.parent, want.parent)
    assert got.num_levels == want.num_levels == max_levels


@needs_native
def test_engine_on_the_reference_layout():
    """The port runs the JAX package's layout, converted by
    ``from_reference_layout``, to the reference's results."""
    g = P.rmat_graph(9, 8, seed=6)
    jg = JGraph(g.num_vertices, g.src.copy(), g.dst.copy())
    jrg = j_relay.build_relay_graph(jg)
    ours = P.RelayEngine(P.from_reference_layout(j_relay.relay_to_arrays(jrg)), device="cpu")
    ref = JRelayEngine(jrg)
    for s in (3, 100):
        got, want = ours.run(s), ref.run(s)
        np.testing.assert_array_equal(got.dist, want.dist)
        np.testing.assert_array_equal(got.parent, want.parent)
        assert got.num_levels == want.num_levels


# ------------------------------------------------------------------ guards --

def test_bfs_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = P.read_sedgewick(TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        P.bfs(g, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        P.RelayEngine(g, device="cuda")
    with pytest.raises(ValueError):
        P.bfs(g, 0, device="cpu", engine="ell")
    with pytest.raises(ValueError):
        P.bfs(g, 6, device="cpu")


def test_import_leaves_jax_out():
    code = (
        "import sys; import bfs_tpu_torch, bfs_tpu_torch.ops.relay_cuda, "
        "bfs_tpu_torch.ops.relay_elem, bfs_tpu_torch.ops.relay_mxu, "
        "bfs_tpu_torch.graph.adj_tiles, bfs_tpu_torch.models.bfs, "
        "bfs_tpu_torch.models.multisource, bfs_tpu_torch.models.loop, "
        "bfs_tpu_torch.ops.control, bfs_tpu_torch.ops.relax, "
        "bfs_tpu_torch.ops.pull, bfs_tpu_torch.graph.ell, "
        "bfs_tpu_torch.graph.vertex, bfs_tpu_torch.config, "
        "bfs_tpu_torch.utils.checkpoint, bfs_tpu_torch.utils.metrics, "
        "bfs_tpu_torch.utils.logging, bfs_tpu_torch.utils.timing, "
        "bfs_tpu_torch.oracle.native, bfs_tpu_torch.runners.run_parallel, "
        "bfs_tpu_torch.runners.run_sequential, bfs_tpu_torch.knobs, "
        "bfs_tpu_torch.obs.telemetry, bfs_tpu_torch.models.direction, "
        "bfs_tpu_torch.oracle.device, bfs_tpu_torch.ops.sparse, "
        "bfs_tpu_torch.cache, bfs_tpu_torch.cache.layout, "
        "bfs_tpu_torch.graph.relay_device, bfs_tpu_torch.obs.spans, "
        "bfs_tpu_torch.obs.registry, bfs_tpu_torch.utils.locks, "
        "bfs_tpu_torch.resilience, bfs_tpu_torch.resilience.faults, "
        "bfs_tpu_torch.resilience.retry, bfs_tpu_torch.serve, "
        "bfs_tpu_torch.serve.executor, bfs_tpu_torch.serve.registry, "
        "bfs_tpu_torch.serve.health, bfs_tpu_torch.serve.server, "
        "bfs_tpu_torch.runners.run_serve, bfs_tpu_torch.resilience.journal, "
        "bfs_tpu_torch.resilience.superstep_ckpt, bfs_tpu_torch.algo, "
        "bfs_tpu_torch.algo.sssp, bfs_tpu_torch.algo.cc, bfs_tpu_torch.oracle.sssp, "
        "bfs_tpu_torch.oracle.cc, bfs_tpu_torch.serve.algo, "
        "bfs_tpu_torch.tools.graph500_run, bfs_tpu_torch.stream, "
        "bfs_tpu_torch.stream.store, bfs_tpu_torch.stream.cache, "
        "bfs_tpu_torch.stream.prefetch, bfs_tpu_torch.stream.runner, "
        "bfs_tpu_torch.serve.labels, bfs_tpu_torch.serve.router, "
        "bfs_tpu_torch.obs.__main__, bfs_tpu_torch.graph.io, "
        "bfs_tpu_torch.tools.serve_loadgen, bfs_tpu_torch.profiling, "
        "bfs_tpu_torch.tools.ledger_compare, bfs_tpu_torch.analysis, "
        "bfs_tpu_torch.analysis.runtime, bfs_tpu_torch.analysis.__main__, "
        "bfs_tpu_torch.analysis.knobs, bfs_tpu_torch.analysis.knob_rules, "
        "bfs_tpu_torch.analysis.kernels, bfs_tpu_torch.tools.chaos_run, "
        "bfs_tpu_torch.tools.cache_warm, bfs_tpu_torch.parallel, "
        "bfs_tpu_torch.parallel.compat, bfs_tpu_torch.parallel.exchange, "
        "bfs_tpu_torch.parallel.sharded, bfs_tpu_torch.algo.sharded; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'bfs_tpu' or m.startswith('bfs_tpu.')]; print(bad); "
        "sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_modules(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def test_no_jax_or_reference_imports_in_the_port():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "bfs_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for sub in (("cache", "__init__.py"), ("cache", "layout.py"),
                ("graph", "relay_device.py"), ("obs", "spans.py"), ("obs", "registry.py"),
                ("resilience", "faults.py"), ("resilience", "retry.py"),
                ("resilience", "journal.py"), ("resilience", "superstep_ckpt.py"),
                ("serve", "executor.py"), ("serve", "registry.py"), ("serve", "health.py"),
                ("serve", "server.py"), ("runners", "run_serve.py"),
                ("algo", "substrate.py"), ("algo", "sssp.py"), ("algo", "cc.py"),
                ("oracle", "sssp.py"), ("oracle", "cc.py"), ("serve", "algo.py"),
                ("tools", "graph500_run.py"), ("serve", "labels.py"), ("serve", "router.py"),
                ("obs", "__main__.py"), ("graph", "io.py"), ("tools", "serve_loadgen.py"),
                ("profiling.py",), ("tools", "ledger_compare.py"),
                ("analysis", "__init__.py"), ("analysis", "__main__.py"), ("analysis", "core.py"),
                ("analysis", "runtime.py"), ("analysis", "transfer.py"), ("analysis", "locks.py"),
                ("analysis", "obs.py"), ("analysis", "recompile.py"), ("analysis", "knobs.py"),
                ("analysis", "knob_rules.py"), ("analysis", "kernels.py"),
                ("tools", "chaos_run.py"), ("tools", "cache_warm.py"),
                ("parallel", "__init__.py"), ("parallel", "compat.py"),
                ("parallel", "exchange.py"), ("parallel", "sharded.py"),
                ("algo", "sharded.py")):
        assert os.path.join(REPO, "bfs_tpu_torch", *sub) in files
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "bfs_tpu"), f"{path} imports {mod}"
