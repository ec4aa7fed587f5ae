"""The port's engines end to end on the CPU against ``bfs_tpu``, bit for bit:
``bfs()`` on push, pull and relay, ``bfs_multi()`` on push and pull, and
``SuperstepRunner`` on all three (every superstep's state), at several
level bounds, through the packed carry's 62-level cap and its unpacked
re-run, and the golden tinyCG states of ``tests/test_golden_supersteps.py``
through the port's ``state_to_vertices``.

All comparisons are exact (tolerance 0).  On the CPU the level loop runs
its blocks eagerly with the same gates and control step as the card's
captured blocks; ``loop = "eager"`` is its plain version."""

import inspect
import os

import numpy as np
import pytest

import bfs_tpu_torch as P
from bfs_tpu_torch.graph.vertex import state_to_vertices
from bfs_tpu_torch.models import loop as L

import bfs_tpu as J
from bfs_tpu.graph import benes as j_benes
from bfs_tpu.graph.csr import Graph as JGraph
from bfs_tpu.models.bfs import SuperstepRunner as JRunner

from test_golden_supersteps import GOLDEN

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "test-sets", "tinyCG.txt")

needs_native = pytest.mark.skipif(
    not j_benes.native_available(), reason="native benes router unavailable"
)

GRAPHS = {
    "tinyCG": (lambda: P.read_sedgewick(TINY), (0, 3, 5)),
    "randomG": (lambda: P.read_sedgewick(os.path.join(REPO, "test-sets", "randomG.txt")),
                (0, 11, 249)),
    "rmat10": (lambda: P.rmat_graph(10, 6, seed=1), (1, 400, 1000)),
    "path100": (lambda: P.path_graph(100), (0, 99)),  # past the packed cap
    "gnm": (lambda: P.gnm_graph(300, 280, seed=5), (0, 7)),  # several components
    "star_gnm": (lambda: _star_gnm(), (0, 5)),  # a hub whose ELL rows fold twice
}


def _star_gnm() -> P.Graph:
    g = P.gnm_graph(2000, 3000, seed=3)
    hub = np.stack([np.zeros(1999, np.int32), np.arange(1, 2000, dtype=np.int32)], axis=1)
    return P.Graph.from_undirected_edges(2000, np.concatenate([np.stack([g.src, g.dst], 1), hub]))
ENGINES = ("push", "pull")


def _jgraph(g: P.Graph) -> JGraph:
    return JGraph(g.num_vertices, g.src.copy(), g.dst.copy())


def _same(got, want) -> None:
    np.testing.assert_array_equal(got.dist, want.dist)
    np.testing.assert_array_equal(got.parent, want.parent)
    assert got.num_levels == want.num_levels


def test_defaults_follow_the_reference():
    for ours, ref in ((P.bfs, J.bfs), (P.bfs_multi, J.bfs_multi)):
        assert inspect.signature(ours).parameters["engine"].default == "pull"
        assert inspect.signature(ref).parameters["engine"].default == "pull"
    assert inspect.signature(P.SuperstepRunner).parameters["engine"].default == "push"


@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("engine", ENGINES)
def test_bfs_matches_reference(name, engine):
    make, roots = GRAPHS[name]
    g = make()
    jg = _jgraph(g)
    eng = P.EdgeEngine(g, engine=engine, device="cpu")
    for s in roots:
        _same(eng.run(s), J.bfs(jg, s, engine=engine))
    for max_levels in (1, 2, 5):
        _same(eng.run(roots[0], max_levels=max_levels),
              J.bfs(jg, roots[0], engine=engine, max_levels=max_levels))
    _same(P.bfs(g, roots[-1], device="cpu"), J.bfs(jg, roots[-1]))


@needs_native
@pytest.mark.parametrize("name", ["tinyCG", "rmat10", "path100"])
def test_bfs_relay_matches_reference(name):
    make, roots = GRAPHS[name]
    g = make()
    for s in roots:
        _same(P.bfs(g, s, engine="relay", device="cpu"),
              J.bfs(_jgraph(g), s, engine="relay"))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("loop", ["blocks", "eager"])
@pytest.mark.parametrize("k", [1, 3, 4])
def test_packed_cap_reruns_unpacked(monkeypatch, engine, loop, k):
    """path_graph(100) from 0: 62 levels on the packed carry, stopped by its
    cap, then the unpacked re-run to 100, on either loop and block size."""
    monkeypatch.setattr(L, "EDGE_BLOCK", k)
    g = P.path_graph(100)
    eng = P.EdgeEngine(g, engine=engine, device="cpu")
    eng.loop = loop
    res = eng.run(0)
    _same(res, J.bfs(_jgraph(g), 0, engine=engine))
    run = eng.last_run
    assert run["live"] == 62 + 100 and run["level"] == 100
    if loop == "eager":
        assert run["host_reads"] == run["issued"] == 162
    else:  # one host read per block, every block issued whole
        assert run["issued"] == run["host_reads"] * k
        assert run["host_reads"] == -(-62 // k) + -(-100 // k)
    # At the cap exactly: the packed run alone answers (no re-run).
    _same(eng.run(0, max_levels=62), J.bfs(_jgraph(g), 0, engine=engine, max_levels=62))
    assert eng.last_run["live"] == 62


@pytest.mark.parametrize("engine", ENGINES)
def test_loops_agree(engine):
    g = P.rmat_graph(10, 6, seed=1)
    eng = P.EdgeEngine(g, engine=engine, device="cpu")
    blocks = eng.run(400)
    eng.loop = "eager"
    _same(eng.run(400), blocks)


@pytest.mark.parametrize("name", ["tinyCG", "rmat10", "path100", "gnm", "star_gnm"])
@pytest.mark.parametrize("engine", ENGINES)
def test_bfs_multi_matches_reference(name, engine):
    make, roots = GRAPHS[name]
    g = make()
    sources = [*roots, roots[0]]  # a repeated source is its own tree
    got = P.bfs_multi(g, sources, engine=engine, device="cpu")
    want = J.bfs_multi(_jgraph(g), sources, engine=engine)
    np.testing.assert_array_equal(got.sources, want.sources)
    _same(got, want)
    for max_levels in (1, 2, 5):
        _same(P.bfs_multi(g, sources, engine=engine, device="cpu", max_levels=max_levels),
              J.bfs_multi(_jgraph(g), sources, engine=engine, max_levels=max_levels))
    state, v = P.bfs_multi_device(g, sources, engine=engine, device="cpu", packed=False)
    jstate, jv = J.models.multisource.bfs_multi_device(_jgraph(g), sources, engine=engine,
                                                       packed=False)
    assert v == jv and state.level == int(jstate.level)
    np.testing.assert_array_equal(state.dist.numpy(), np.asarray(jstate.dist))
    np.testing.assert_array_equal(state.parent.numpy(), np.asarray(jstate.parent))


def test_prebuilt_layouts_and_refusals():
    g = P.read_sedgewick(TINY)
    pg, dg = P.build_pull_graph(g), P.build_device_graph(g)
    want = J.bfs(_jgraph(g), 0)
    _same(P.bfs(pg, 0, device="cpu"), want)
    _same(P.bfs(dg, 0, engine="push", device="cpu"), want)
    _same(P.bfs(dg, 0, engine="pull", device="cpu"), want)
    for call in (
        lambda: P.bfs(pg, 0, engine="push", device="cpu"),
        lambda: P.bfs(g, 0, engine="ell", device="cpu"),
        lambda: P.bfs_multi(g, [0, 6], device="cpu"),
        lambda: P.SuperstepRunner(g, engine="ell", device="cpu"),
        lambda: P.SuperstepRunner(pg, engine="push", device="cpu"),
        lambda: P.SuperstepRunner(g, device="cpu").init(6),
    ):
        with pytest.raises(ValueError):
            call()


def _runner_engines():
    return [*ENGINES, pytest.param("relay", marks=needs_native)]


@pytest.mark.parametrize("name", ["tinyCG", "randomG", "rmat10", "path100"])
@pytest.mark.parametrize("engine", _runner_engines())
def test_superstep_runner_matches_reference(name, engine):
    make, roots = GRAPHS[name]
    g = make()
    source = roots[-1]
    ours = P.SuperstepRunner(g, engine=engine, device="cpu")
    ref = JRunner(_jgraph(g), engine=engine)
    st, jst = ours.init(source), ref.init(source)
    states = 0
    while True:
        for a, b in zip(ours.to_original(st, source=source), ref.to_original(jst, source=source)):
            np.testing.assert_array_equal(a, np.asarray(b))
        assert int(st.level) == int(jst.level) and bool(st.changed) == bool(jst.changed)
        assert ours.frontier_size(st) == ref.frontier_size(jst)
        if not bool(jst.changed):
            break
        st, jst = ours.step(st), ref.step(jst)
        states += 1
    assert states == int(jst.level)
    seen = []
    res = ours.run(source, observer=lambda level, s: seen.append(level))
    _same(res, ref.run(source))
    assert seen == list(range(1, res.num_levels + 1))
    _same(ours.run(source, max_levels=2), ref.run(source, max_levels=2))


@needs_native
def test_relay_runner_needs_the_source():
    ours = P.SuperstepRunner(P.read_sedgewick(TINY), engine="relay", device="cpu")
    with pytest.raises(ValueError, match="source"):
        ours.to_original(ours.init(0))


@pytest.mark.parametrize("engine", _runner_engines())
def test_golden_superstep_states(engine):
    g = P.read_sedgewick(TINY)
    runner = P.SuperstepRunner(g, engine=engine, device="cpu")
    state = runner.init(0)
    level = 0
    while bool(state.changed):
        state = runner.step(state)
        level = int(state.level)
        dist, parent, frontier = runner.to_original(state, source=0)
        got = [v.serialize() for v in state_to_vertices(g, dist, parent, frontier, source=0)]
        assert got == GOLDEN[level], f"superstep {level} state mismatch"
    assert level == 3
