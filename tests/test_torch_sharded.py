"""The port's mesh-sharded engine (``bfs_tpu_torch.parallel``) against the
JAX reference's (``bfs_tpu.parallel``) on the CPU.

The port stacks its shards on one device (``devices=[cpu] * n``); the
reference runs ``shard_map`` on the 8 virtual CPU devices of
``tests/conftest.py``.  Held here: the sharded layouts (edge shards, the
vertex-partitioned ELL, the per-shard relay layouts on both routes) byte
for byte; ``bfs_sharded`` and ``bfs_sharded_multi`` on pull, push and relay
against the reference's, the single-chip port and the oracle; the error
paths; the command line's ``--sharded``.  Reference results are computed
once per module (each is an XLA compile).  All comparisons are exact."""

import contextlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bfs_tpu_torch as P
from bfs_tpu_torch.graph import csr as PC
from bfs_tpu_torch.graph import ell as PE
from bfs_tpu_torch.graph import relay as PR
from bfs_tpu_torch.parallel import compat as PCOMP
from bfs_tpu_torch.parallel import sharded as SH

import jax

from bfs_tpu.graph import benes as j_benes
from bfs_tpu.graph import csr as JC
from bfs_tpu.graph import ell as JE
from bfs_tpu.graph import relay as JR
from bfs_tpu.models.multisource import bfs_multi as j_bfs_multi
from bfs_tpu.parallel import compat as JCOMP
from bfs_tpu.parallel import sharded as JS

pytestmark = pytest.mark.skipif(
    not j_benes.native_available(), reason="native benes router unavailable"
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
GRAPHS = {
    "rmat8": lambda: P.rmat_graph(8, 6, seed=3),
    "rmat9": lambda: P.rmat_graph(9, 8, seed=11),
    "path100": lambda: P.path_graph(100),
    "star300": lambda: P.star_graph(300),
}
_graphs: dict = {}
_ref: dict = {}


def _graph(name: str) -> P.Graph:
    if name not in _graphs:
        _graphs[name] = GRAPHS[name]()
    return _graphs[name]


def _jgraph(g: P.Graph) -> JC.Graph:
    return JC.Graph(g.num_vertices, g.src.copy(), g.dst.copy())


def mesh(graph: int, batch: int = 1) -> PCOMP.Mesh:
    return SH.make_mesh(graph=graph, batch=batch, devices=[CPU] * (graph * batch))


@contextlib.contextmanager
def reference_unchecked():
    """Run the reference's mesh programs with JAX's shard_map replication
    check off (``check_vma=False``), as its compat shim runs them on the
    JAX versions without the ``axis_names`` API (``check_rep=False``): the
    check is static and changes no value, but newer JAX rejects the
    telemetry and direction carries of some programs with it.  Where it
    patches, the compiled programs are dropped on exit, so no later caller
    in this process gets one compiled without the check.  The tests compare
    with the reference only in the configurations its own suites run."""
    if not JCOMP.has_axis_names_api():
        yield
        return
    orig = JCOMP._shard_map_new

    def unchecked(f, **kw):
        return orig(f, check_vma=False, **kw)

    JCOMP._shard_map_new = unchecked
    try:
        yield
    finally:
        JCOMP._shard_map_new = orig
        jax.clear_caches()


def _same(got, want) -> None:
    np.testing.assert_array_equal(got.dist, np.asarray(want.dist))
    np.testing.assert_array_equal(got.parent, np.asarray(want.parent))
    assert got.num_levels == int(want.num_levels)


def _oracle(g, res, s) -> None:
    d, p = P.canonical_bfs(g, s)
    np.testing.assert_array_equal(res.dist, d)
    np.testing.assert_array_equal(res.parent, p)
    assert P.check(g, res.dist, res.parent, s) == []


def _fields_equal(a, b, keys, skip=()) -> list:
    """The fields of two layouts whose values differ (arrays by dtype and
    bytes, class and stage tables by rows)."""
    bad = []
    for k in keys:
        if k in skip:
            continue
        x, y = getattr(a, k), getattr(b, k)
        if k in ("in_classes", "out_classes"):
            same = np.array_equal(PR.classes_to_rows(x), JR.classes_to_rows(y))
        elif k in ("vperm_table", "net_table"):
            same = np.array_equal(PR.table_to_rows(x), JR.table_to_rows(y))
        elif isinstance(y, np.ndarray):
            same = x.dtype == y.dtype and np.array_equal(x, y)
        elif isinstance(y, tuple):
            same = len(x) == len(y) and all(
                u.dtype == w.dtype and np.array_equal(u, w) for u, w in zip(x, y))
        else:
            same = x == y
        if not same:
            bad.append(k)
    return bad


# ------------------------------------------------------------------ layouts --

@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("name", ["rmat8", "rmat9", "path100"])
def test_edge_shards_match_the_reference(name, n):
    g = _graph(name)
    got = P.build_device_graph(g, num_shards=n, block=64)
    want = JC.build_device_graph(_jgraph(g), num_shards=n, block=64)
    assert _fields_equal(got, want, ("num_vertices", "num_edges", "num_shards", "src",
                                     "dst")) == []
    assert got.src.shape == ((got.padded_edges,) if n == 1 else (n, got.padded_edges // n))
    for a, b in zip(PC.unpad_edges(got), JC.unpad_edges(want)):
        np.testing.assert_array_equal(a, b)
    back = PC.reshard(got, 1, block=64)
    assert _fields_equal(back, JC.reshard(want, 1, block=64),
                         ("num_shards", "src", "dst")) == []


@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("name", ["rmat8", "rmat9", "path100", "star300"])
def test_sharded_pull_layout_matches_the_reference(name, n):
    g = _graph(name)
    for multiple in (32, 1024):
        got = P.build_sharded_pull_graph(g, n, block_multiple=multiple)
        want = JE.build_sharded_pull_graph(_jgraph(g), n, block_multiple=multiple)
        assert _fields_equal(got, want, ("num_vertices", "num_edges", "num_shards", "block",
                                         "ell0", "folds")) == []
    # From a multi-shard DeviceGraph too (its edges sorted again globally).
    dg = P.build_device_graph(g, num_shards=2, block=64)
    got = P.build_sharded_pull_graph(dg, n, block_multiple=32)
    want = JE.build_sharded_pull_graph(JC.build_device_graph(_jgraph(g), num_shards=2, block=64),
                                       n, block_multiple=32)
    assert _fields_equal(got, want, ("block", "ell0", "folds")) == []
    ell0, folds = PE.device_ell_sharded(got, CPU)
    j_ell0, j_folds = JE.device_ell_sharded(want)
    np.testing.assert_array_equal(ell0.numpy(), np.asarray(j_ell0))
    assert len(folds) == len(j_folds)
    for a, b in zip(folds, j_folds):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("name", ["rmat9", "path100", "star300"])
def test_sharded_relay_layout_matches_the_reference(name, n):
    """The native route gives the reference's layout byte for byte; the
    torch route every field but the masks and stage tables, and masks that
    route the same permutations (held by the searches below)."""
    g = _graph(name)
    want = JR.build_sharded_relay_graph(_jgraph(g), n)
    times: dict = {}
    got = P.build_sharded_relay_graph(g, n, route="native", stage_times=times)
    assert _fields_equal(got, want, PR.SHARDED_KEYS) == []
    assert times["route"] == "native" and times["shards"] > 0 and times["net route"] > 0
    torch_routed = P.build_sharded_relay_graph(g, n, route="torch", device="cpu")
    assert _fields_equal(torch_routed, want, PR.SHARDED_KEYS, skip=PR.MASK_FIELDS) == []
    assert torch_routed.vperm_masks.shape == want.vperm_masks.shape
    assert torch_routed.net_masks.shape == want.net_masks.shape


def test_sharded_relay_layout_from_a_sharded_device_graph():
    g = _graph("rmat8")
    got = P.build_sharded_relay_graph(P.build_device_graph(g, num_shards=2, block=64), 2,
                                      route="native")
    want = JR.build_sharded_relay_graph(JC.build_device_graph(_jgraph(g), num_shards=2, block=64),
                                        2)
    assert _fields_equal(got, want, PR.SHARDED_KEYS) == []


def test_own_word_table_matches_the_reference():
    g = _graph("rmat9")
    for n in (2, 8):
        got = P.build_sharded_relay_graph(g, n, route="native")
        want = JR.build_sharded_relay_graph(_jgraph(g), n)
        np.testing.assert_array_equal(SH._own_word_table(got), JS._own_word_table(want))
        np.testing.assert_array_equal(SH._sharded_adj_ranks(got), JS._sharded_adj_ranks(want))


# ------------------------------------------------------ single-source searches --

def _ref_single(name: str, engine: str, n: int, s: int = 0):
    key = ("single", name, engine, n, s)
    if key not in _ref:
        kw = {"block": 64, "vertex_block_multiple": 32} if engine != "relay" else {}
        with reference_unchecked():
            res = JS.bfs_sharded(_jgraph(_graph(name)), s, mesh=JS.make_mesh(graph=n),
                                 engine=engine, **kw)
        _ref[key] = res
    return _ref[key]


@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("engine", ["pull", "push", "relay"])
def test_bfs_sharded_matches_the_reference(engine, n):
    g = _graph("rmat9")
    kw = {"block": 64, "vertex_block_multiple": 32} if engine != "relay" else {}
    res = SH.bfs_sharded(g, 0, mesh=mesh(n), engine=engine, **kw)
    _same(res, _ref_single("rmat9", engine, n))
    _same(res, P.bfs(g, 0, device="cpu"))
    _oracle(g, res, 0)


def test_bfs_sharded_deep_path_reruns_unpacked():
    """Deeper than the packed carry's 62 levels: the packed relay run stops
    on its cap and runs again unpacked; pull and push carry no cap."""
    g = P.path_graph(257)
    for engine in ("relay", "pull", "push"):
        res = SH.bfs_sharded(g, 0, mesh=mesh(8), engine=engine, block=64,
                             vertex_block_multiple=32)
        assert res.num_levels == 257
        _oracle(g, res, 0)
    with reference_unchecked():
        want = JS.bfs_sharded(_jgraph(g), 0, mesh=JS.make_mesh(graph=8), engine="relay")
    _same(res, want)


def test_bfs_sharded_random_graphs_and_sources():
    """Disconnected graphs, sources other than 0, every engine at x4 and
    x8 against the oracle, and one against the reference."""
    for seed in range(3):
        g = P.gnm_graph(300, 900 if seed else 220, seed=seed)
        for n in (4, 8):
            for s in (0, 137):
                for engine in ("pull", "push", "relay"):
                    res = SH.bfs_sharded(g, s, mesh=mesh(n), engine=engine, block=16,
                                         vertex_block_multiple=32)
                    _oracle(g, res, s)
    g = P.gnm_graph(300, 220, seed=0)
    with reference_unchecked():
        want = JS.bfs_sharded(_jgraph(g), 137, mesh=JS.make_mesh(graph=4), engine="relay")
    _same(SH.bfs_sharded(g, 137, mesh=mesh(4), engine="relay"), want)
    assert (np.asarray(want.dist) == P.INF_DIST).any()


def test_bfs_sharded_tinycg_on_every_engine_and_mesh():
    g = P.read_sedgewick(os.path.join(REPO, "test-sets", "tinyCG.txt"))
    for n in (1, 2, 8):
        for engine in ("pull", "push", "relay"):
            for s in range(g.num_vertices):
                res = SH.bfs_sharded(g, s, mesh=mesh(n), engine=engine, block=8,
                                     vertex_block_multiple=32)
                _oracle(g, res, s)
    res = SH.bfs_sharded(g, 0, mesh=mesh(2), engine="relay")
    assert (res.dist.tolist(), res.parent.tolist(), res.num_levels) == (
        [0, 1, 1, 2, 2, 1], [0, 0, 0, 2, 2, 0], 3)


def test_prebuilt_layouts_keep_their_engine_and_loops():
    """An engine held on a prebuilt layout (the stateful API) keeps its
    captured loop for every later search, and equals the one-shot
    ``bfs_sharded`` on that layout, which builds an engine for the call and
    drops it (nothing is kept on the layout object)."""
    g = _graph("rmat8")
    m = mesh(2)
    layouts = {"relay": (P.build_sharded_relay_graph(g, 2, route="native"), SH.ShardedRelayEngine),
               "pull": (P.build_sharded_pull_graph(g, 2, block_multiple=32), SH.ShardedPullEngine),
               "push": (P.build_device_graph(g, num_shards=2, block=64), SH.ShardedPushEngine)}
    for engine, (layout, cls) in layouts.items():
        eng = cls(layout, m)
        for s in (0, 5, 100):
            res = eng.run(s)
            _oracle(g, res, s)
            _same(SH.bfs_sharded(layout, s, mesh=m, engine=engine), res)
        assert len(eng._loops) == 1, eng._loops.keys()
        assert not hasattr(layout, "_mesh_engines")


def test_relay_x1_equals_the_single_chip_engine():
    g = _graph("rmat9")
    single = P.RelayEngine(g, device="cpu", expansion="gather").run(3)
    _same(SH.bfs_sharded(g, 3, mesh=mesh(1), engine="relay"), single)


def test_pull_engine_eager_loop_equals_the_block_loop():
    g = _graph("rmat8")
    spg = P.build_sharded_pull_graph(g, 4, block_multiple=32)
    eng = SH.ShardedPullEngine(spg, mesh(4))
    blocks = eng.run(7)
    assert eng.last_run["host_reads"] == blocks.num_levels  # blocks of one superstep
    eng.loop = "eager"
    _same(eng.run(7), blocks)


def test_relay_dead_superstep_changes_nothing():
    """After a search has converged its loop's control block says not
    LIVE: a further block is dead and leaves every buffer as it was."""
    g = _graph("rmat8")
    srg = P.build_sharded_relay_graph(g, 2, route="native")
    eng = SH.ShardedRelayEngine(srg, mesh(2))
    for direction in ("pull", "auto"):
        eng.run(0, direction=direction, exchange="auto", telemetry=True)
        loop = next(v for k, v in eng._loops.items() if k[3] == direction)
        before = [b.clone() for b in loop.buffers]
        bodies = loop.bodies.values() if hasattr(loop, "bodies") else [loop]
        for body in bodies:
            body.dead_replay()
        for a, b in zip(before, loop.buffers):
            assert torch.equal(a, b)


# ------------------------------------------------------------------- batches --

@pytest.mark.parametrize("engine", ["pull", "push"])
@pytest.mark.parametrize("batch,graph", [(1, 8), (2, 4), (4, 2), (8, 1)])
def test_bfs_sharded_multi_on_2d_meshes(batch, graph, engine):
    g = P.gnm_graph(200, 600, seed=9)
    sources = list(range(8))
    res = SH.bfs_sharded_multi(g, sources, mesh=mesh(graph, batch), engine=engine, block=16,
                               vertex_block_multiple=32)
    key = ("multi", engine, batch, graph)
    if key not in _ref:
        with reference_unchecked():
            _ref[key] = JS.bfs_sharded_multi(_jgraph(g), sources,
                                             mesh=JS.make_mesh(graph=graph, batch=batch),
                                             engine=engine, block=16, vertex_block_multiple=32)
    want = _ref[key]
    np.testing.assert_array_equal(res.dist, np.asarray(want.dist))
    np.testing.assert_array_equal(res.parent, np.asarray(want.parent))
    if ("jm",) not in _ref:
        _ref[("jm",)] = j_bfs_multi(_jgraph(g), sources)
    single = _ref[("jm",)]
    np.testing.assert_array_equal(res.dist, np.asarray(single.dist))
    np.testing.assert_array_equal(res.parent, np.asarray(single.parent))


@pytest.mark.parametrize("batch,graph", [(2, 2), (1, 4), (4, 2)])
def test_bfs_sharded_multi_relay(batch, graph):
    """The lock-step relay batch on a 2-D mesh: every tree equals the
    oracle's and the reference's sharded relay search from its source (the
    configuration the reference's own relay suite runs), and the batch runs
    as many supersteps as its deepest tree."""
    g = _graph("rmat9")
    sources = [0, 5, 77, 300, 511, 2, 8, 120]
    res = SH.bfs_sharded_multi(g, sources, mesh=mesh(graph, batch), engine="relay")
    assert res.dist.shape == (8, g.num_vertices)
    levels = []
    for i, s in enumerate(sources):
        want = _ref_single("rmat9", "relay", graph, s)
        np.testing.assert_array_equal(res.dist[i], np.asarray(want.dist))
        np.testing.assert_array_equal(res.parent[i], np.asarray(want.parent))
        levels.append(int(want.num_levels))
        d, p = P.canonical_bfs(g, s)
        np.testing.assert_array_equal(res.dist[i], d)
        np.testing.assert_array_equal(res.parent[i], p)
    assert res.num_levels == max(levels)


def test_bfs_sharded_multi_relay_deep_reruns_unpacked():
    g = P.path_graph(100)
    sources = [0, 99, 50, 7]
    res = SH.bfs_sharded_multi(g, sources, mesh=mesh(2, 2), engine="relay")
    assert res.num_levels == 100
    for i, s in enumerate(sources):
        d, p = P.canonical_bfs(g, s)
        np.testing.assert_array_equal(res.dist[i], d)
        np.testing.assert_array_equal(res.parent[i], p)


# -------------------------------------------------------------------- errors --

def test_wrong_shard_counts_and_layouts_are_rejected():
    g = P.gnm_graph(64, 128, seed=0)
    m4 = mesh(4)
    with pytest.raises(ValueError, match="num_shards=4"):
        SH.bfs_sharded(P.build_device_graph(g, num_shards=2, block=8), 0, mesh=m4, engine="push")
    with pytest.raises(ValueError, match="num_shards=4"):
        SH.bfs_sharded(P.build_sharded_pull_graph(g, 2, block_multiple=32), 0, mesh=m4)
    srg = P.build_sharded_relay_graph(g, 2, route="native")
    with pytest.raises(ValueError, match="num_shards=4"):
        SH.bfs_sharded(srg, 0, mesh=m4, engine="relay")
    with pytest.raises(ValueError, match="only runs on engine='relay'"):
        SH.bfs_sharded(srg, 0, mesh=mesh(2), engine="pull")
    with pytest.raises(ValueError, match="only runs on engine='relay'"):
        SH.bfs_sharded(srg, 0, mesh=mesh(2), engine="push")
    with pytest.raises(ValueError, match="only runs on engine='pull'"):
        SH.bfs_sharded(P.build_sharded_pull_graph(g, 2), 0, mesh=mesh(2), engine="relay")
    with pytest.raises(ValueError, match="single-shard"):
        P.build_pull_graph(P.build_device_graph(g, num_shards=2, block=8))
    with pytest.raises(ValueError, match="unknown engine"):
        SH.bfs_sharded(g, 0, mesh=mesh(2), engine="elem")
    with pytest.raises(ValueError, match="telemetry"):
        SH.bfs_sharded(g, 0, mesh=mesh(2), engine="pull", telemetry=True)
    with pytest.raises(ValueError, match="not divisible"):
        SH.bfs_sharded_multi(g, [0, 1, 2], mesh=mesh(2, 2))
    with pytest.raises(ValueError, match="out of range"):
        SH.bfs_sharded(g, 64, mesh=mesh(2), engine="relay")
    with pytest.raises(ValueError):
        P.build_device_graph(g, num_shards=0)


def test_meshes_over_several_devices_are_refused():
    """A mesh whose shards sit on distinct devices is A12's later step;
    without a card there is no CPU fallback for the default devices."""
    with pytest.raises(ValueError, match="A12"):
        SH.make_mesh(graph=2, devices=[CPU, torch.device("meta")])
    with pytest.raises(ValueError, match="A12"):
        PCOMP.Mesh([[torch.device("cuda", 0), torch.device("cuda", 1)]])
    with pytest.raises(ValueError, match="needs 4 devices"):
        SH.make_mesh(graph=2, batch=2, devices=[CPU] * 3)
    m = SH.make_mesh(graph=2, batch=2, devices=[CPU] * 4)
    assert (m.shape, m.size, m.device) == ({"batch": 2, "graph": 2}, 4, CPU)
    assert m == mesh(2, 2) and hash(m) == hash(mesh(2, 2)) and m != mesh(4)
    assert SH.make_mesh(batch=2, devices=[CPU] * 6).shape["graph"] == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices="):
            SH.make_mesh(graph=2)
        with pytest.raises(RuntimeError):
            SH.bfs_sharded(P.path_graph(8), 0)


def test_collectives_on_stacked_shards():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(-50, 50, (4, 3, 5)).astype(np.int32))
    assert torch.equal(PCOMP.pmin(x, "graph"), x.amin(0))
    assert torch.equal(PCOMP.pmax(x, "batch"), x.amax(0))
    assert torch.equal(PCOMP.psum(x, "graph"), x.sum(0))
    assert torch.equal(PCOMP.all_gather(x, "graph"), x)
    assert torch.equal(PCOMP.all_gather(x, "graph", tiled=True), x.reshape(12, 5))
    assert torch.equal(PCOMP.all_gather(x, "graph", dim=1), x.permute(1, 0, 2))
    assert torch.equal(PCOMP.all_gather(x, "graph", tiled=True, dim=1),
                       x.permute(1, 0, 2).reshape(3, 20))
    assert PCOMP.axis_index(4, "graph", CPU).tolist() == [0, 1, 2, 3]
    with pytest.raises(ValueError):
        PCOMP.pmin(x, "model")


@pytest.mark.parametrize("n", [2, 8])
def test_shard_axis_supersteps_merge_with_one_pmin(n):
    """The merges the mesh runs (the reference's ``axis_name``): each edge
    shard's candidates merged with one ``pmin`` give the unsharded
    candidates, for the push engine's single and batched frontiers
    (``shard_push_candidates``) and SSSP's and CC's supersteps (``axis``)."""
    import importlib

    from bfs_tpu_torch.algo.substrate import edge_weights
    from bfs_tpu_torch.ops import relax as PX

    # The modules (``bfs_tpu_torch.algo`` exports functions of their names).
    PCC = importlib.import_module("bfs_tpu_torch.algo.cc")
    PS = importlib.import_module("bfs_tpu_torch.algo.sssp")
    g = _graph("rmat9")
    flat = P.build_device_graph(g, block=64)
    dg = P.build_device_graph(g, num_shards=n, block=64)
    src, dst = (torch.from_numpy(np.ascontiguousarray(a)) for a in (dg.src, dg.dst))
    fsrc, fdst = torch.from_numpy(flat.src), torch.from_numpy(flat.dst).long()
    v = g.num_vertices
    st, bst = PX.init_state(v, 3), PX.init_batched_state(v, [3, 9, 200])
    for _ in range(3):
        for state in (st, bst):
            got = PX.shard_push_candidates(state.frontier, src, dst.long(), v + 1, "graph")
            want = PX.shard_push_candidates(state.frontier, fsrc, fdst, v + 1)
            assert torch.equal(got, want)
        st = PX.relax_superstep(st, fsrc, fdst)
        bst = PX.relax_superstep_batched(bst, fsrc, fdst)
    w = edge_weights(src, dst, 255)
    sst = PS.init_sssp_state(v, 3, 64)
    csst = PCC.init_cc_state(v)
    for _ in range(3):
        a = PS.sssp_superstep(sst, src, dst.long(), w, 64, axis="graph")
        b = PS.sssp_superstep(sst, fsrc, fdst, edge_weights(fsrc, fdst, 255), 64)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        c = PCC.cc_superstep(csst, src, dst.long(), axis="graph")
        d = PCC.cc_superstep(csst, fsrc, fdst)
        assert all(torch.equal(x, y) for x, y in zip(c, d))
        sst, csst = b, d


# -------------------------------------------------------------- command line --

@pytest.mark.parametrize("argv", [["--sharded"], ["--sharded", "--engine", "relay",
                                                  "--mesh-graph", "2", "--mesh-batch", "1"],
                                  ["--fused", "--sharded", "--engine", "push", "--mesh-graph",
                                   "4"]])
def test_run_parallel_sharded_on_service_properties(argv):
    """``run_parallel --sharded`` on the repo's configuration (mesh keys
    from ``service.properties``, overridden by the flags), every file
    checked; exit 0."""
    proc = subprocess.run(
        [sys.executable, "-m", "bfs_tpu_torch.runners.run_parallel", "service.properties",
         "--device", "cpu", *argv],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = proc.stdout + proc.stderr
    assert "tinyCG.txt: 3 supersteps" in out and "randomG.txt" in out and "sharded" in out
