"""The relay engine's sparse hybrid against ``bfs_tpu`` on the CPU, bit for
bit: the sparse body's plain ops (``extract_frontier_list``,
``take_sparse``, ``frontier_stats``, ``sparse_superstep`` packed and
unpacked, on every adjacency flavor) against the reference's
``_extract_frontier_list``, ``_take_sparse``, ``_frontier_stats`` and
``_sparse_superstep`` on seeded random inputs, at budgets clamped to the
graph and not; ``RelayEngine(sparse_hybrid=True)`` in all three modes on
both arms (``dist``, ``parent``, ``num_levels`` and the level-curve dict,
schedule included) against the reference's, past the packed cap too, and
with budgets small enough to force the dense body; the stepped bodies of
``step_dispatch``; the dead superstep of each captured body; and
``run_many_device`` on the hybrid.

All comparisons are exact (tolerance 0): integer bit arithmetic, and the
schedule's predicate compares the same float32 values."""

import importlib

import numpy as np
import pytest
import torch

import bfs_tpu_torch as P
from bfs_tpu_torch.models import bfs as p_bfs
from bfs_tpu_torch.ops import control as C
from bfs_tpu_torch.ops import relay as R
from bfs_tpu_torch.ops import sparse as S

import jax.numpy as jnp

from bfs_tpu.graph import benes as j_benes
from bfs_tpu.graph.csr import Graph as JGraph
from bfs_tpu.models.bfs import RelayEngine as JRelayEngine
from bfs_tpu.ops import relay as j_relay_ops

j_bfs = importlib.import_module("bfs_tpu.models.bfs")  # the package exports a function of that name

needs_native = pytest.mark.skipif(
    not j_benes.native_available(), reason="native benes router unavailable"
)

MODES = ("auto", "push", "pull")


def _switchy():
    """The reference's fixture: a G(n, m) whose frontier ramps through both
    thresholds from its max-degree vertex."""
    g = P.gnm_graph(1 << 10, 3 << 10, seed=5)
    return g, (int(np.argmax(np.bincount(g.src, minlength=g.num_vertices))),)


GRAPHS = {
    "switchy": _switchy,
    "star": lambda: (P.star_graph(256), (5, 0)),
    "gnm": lambda: (P.gnm_graph(300, 280, seed=5), (0, 7)),  # several components
    "rmat9": lambda: (P.rmat_graph(9, 8, seed=7), (0, 5)),
    "path80": lambda: (P.path_graph(80), (0,)),  # past the packed 62-level cap
}


def _jgraph(g: P.Graph) -> JGraph:
    return JGraph(g.num_vertices, g.src.copy(), g.dst.copy())


_CACHE: dict = {}


def _engines(name: str, mode: str, expansion: str):
    """``(graph, roots, port engine, reference engine)``, built once."""
    key = (name, mode, expansion)
    if key not in _CACHE:
        g, roots = GRAPHS[name]()
        _CACHE[key] = (g, roots,
                       P.RelayEngine(g, device="cpu", direction=mode, expansion=expansion),
                       JRelayEngine(_jgraph(g), sparse_hybrid=True, direction=mode,
                                    expansion=expansion))
    return _CACHE[key]


def _same(got, want) -> None:
    np.testing.assert_array_equal(got.dist, np.asarray(want.dist))
    np.testing.assert_array_equal(got.parent, np.asarray(want.parent))
    assert got.num_levels == int(want.num_levels)


def _words(rng, nw: int, density: float) -> np.ndarray:
    bits = rng.random(nw * 32) < density
    return np.packbits(bits.reshape(-1, 32), axis=1, bitorder="little").view("<u4").reshape(-1)


def _t(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(words, dtype=np.uint32).view(np.int32))


class _St:
    """A bare state with frontier words (what the reference's predicates read)."""

    def __init__(self, fwords):
        self.fwords = fwords


# ---------------------------------------------------------- the plain ops --

@pytest.mark.parametrize("nw,density,bv", [
    (8, 0.3, 256),  # bv clamped to vr: every bit fits
    (8, 0.3, 40),  # fewer slots than set bits: the list is cut
    (64, 0.01, 512),  # sparse, long padding
    (33, 0.0, 100),  # empty frontier: all padding
    (5, 1.0, 160),  # every bit set, bit 31 included
])
@pytest.mark.parametrize("seed", range(2))
def test_extract_frontier_list_matches_reference(nw, density, bv, seed):
    words = _words(np.random.default_rng(seed), nw, density)
    vr = nw * 32
    got = S.extract_frontier_list(_t(words), vr, bv)
    want = np.asarray(j_bfs._extract_frontier_list(jnp.asarray(words), vr, bv))
    np.testing.assert_array_equal(got.numpy(), want)
    bits = np.flatnonzero(np.unpackbits(words.view(np.uint8), bitorder="little"))
    np.testing.assert_array_equal(got.numpy()[: min(bv, bits.size)], bits[:bv])


@pytest.mark.parametrize("vr,n_adj,density,maxdeg", [
    (256, 900, 0.05, 8),  # both budgets clamped to the graph
    (1 << 16, 1 << 20, 0.002, 16),  # the module budgets: fits
    (1 << 16, 1 << 20, 0.6, 2),  # over the vertex budget
    (1 << 16, 1 << 20, 0.01, 5000),  # over the edge budget
    (1 << 16, 1 << 20, 0.0001, 200000),  # one degree past be + 1: the cap
])
def test_take_sparse_and_frontier_stats_match_reference(vr, n_adj, density, maxdeg):
    rng = np.random.default_rng(vr + maxdeg)
    words = _words(rng, vr // 32, density)
    outdeg = rng.integers(0, maxdeg + 1, vr).astype(np.int32)
    outdeg[rng.integers(0, vr)] = maxdeg
    got = bool(S.take_sparse(_t(words), torch.from_numpy(outdeg), vr, n_adj))
    want = bool(j_bfs._take_sparse(_St(jnp.asarray(words)), jnp.asarray(outdeg), vr, n_adj))
    assert got == want
    fsize, fedges = S.frontier_stats(_t(words), torch.from_numpy(outdeg), vr)
    jfs, jfe = j_bfs._frontier_stats(_St(jnp.asarray(words)), jnp.asarray(outdeg), vr)
    assert (int(fsize), int(fedges)) == (int(jfs), int(jfe))
    assert S.sparse_budgets(vr, n_adj) == j_bfs.sparse_budgets(vr, n_adj)
    assert (p_bfs.SPARSE_BV, p_bfs.SPARSE_BE) == (j_bfs.SPARSE_BV, j_bfs.SPARSE_BE)
    assert p_bfs.sparse_budgets is S.sparse_budgets


@needs_native
@pytest.mark.parametrize("expansion", ["gather", "mxu"])
def test_adjacency_flavors_match_reference(expansion):
    g = P.rmat_graph(9, 8, seed=7)
    eng = P.RelayEngine(g, device="cpu", expansion=expansion)
    rg, jrg = eng.relay_graph, JRelayEngine(_jgraph(g), expansion=expansion).relay_graph
    mxu = expansion == "mxu"
    for packed in (True, False):
        np.testing.assert_array_equal(S.sparse_third(rg, packed, mxu),
                                      np.asarray(j_bfs._sparse_third(jrg, packed, mxu)))
        adj = eng._sparse_tensors_for(packed)
        np.testing.assert_array_equal(adj.third.numpy(), S.sparse_third(rg, packed, mxu))
        assert adj.indptr is eng._sparse_tensors_for(not packed).indptr  # shipped once
    np.testing.assert_array_equal(eng.outdeg.numpy(), np.diff(rg.adj_indptr[: rg.vr + 1]))


def _random_state(rng, vr: int, packed: bool, level: int):
    """A carry of ``vr`` vertices at ``level``: about half reached (levels
    below it), the rest unreached."""
    reached = rng.random(vr) < 0.5
    if packed:
        words = ((rng.integers(0, level + 1, vr).astype(np.uint32) << np.uint32(26))
                 | rng.integers(0, 1 << 20, vr).astype(np.uint32))
        words[~reached] = 0xFFFFFFFF
        return (words,)
    dist = np.where(reached, rng.integers(0, level + 1, vr), 2**31 - 1).astype(np.int32)
    parent = np.where(reached, rng.integers(0, 1 << 20, vr), -1).astype(np.int32)
    return dist, parent


@needs_native
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("expansion", ["gather", "mxu"])
@pytest.mark.parametrize("seed,density", [(0, 0.02), (1, 0.2), (2, 0.9)])
def test_sparse_superstep_matches_reference(packed, expansion, seed, density):
    """Random frontiers and carries on a real layout's adjacency: the
    port's superstep against ``_sparse_superstep``, ungated and with a live
    control block; a dead one changes nothing."""
    g = P.rmat_graph(9, 8, seed=7)
    eng = P.RelayEngine(g, device="cpu", expansion=expansion)
    rg = eng.relay_graph
    vr, adj = rg.vr, eng._sparse_tensors_for(packed)
    rng = np.random.default_rng(seed)
    level = int(rng.integers(0, 40))
    fields = _random_state(rng, vr, packed, level)
    words = _words(rng, vr // 32, density)
    if packed:
        st = R.PackedRelayState(_t(fields[0]), _t(words), level, None)
        jst = j_relay_ops.PackedRelayState(jnp.asarray(fields[0]), jnp.asarray(words),
                                           jnp.int32(level), jnp.bool_(True))
    else:
        st = R.RelayState(*(torch.from_numpy(f) for f in fields), _t(words), level, None)
        jst = j_relay_ops.RelayState(*(jnp.asarray(f) for f in fields), jnp.asarray(words),
                                     jnp.int32(level), jnp.bool_(True))
    got = S.sparse_superstep(st, adj, vr)
    want = j_bfs._sparse_superstep(jst, *(jnp.asarray(t.numpy()) for t in adj[:3]), vr=vr,
                                   packed=packed)
    n = 1 if packed else 2
    for a, b in zip(got[:n], want[:n]):
        np.testing.assert_array_equal(a.numpy().view(np.uint32), np.asarray(b).view(np.uint32))
    np.testing.assert_array_equal(got.fwords.numpy().view(np.uint32), np.asarray(want.fwords))
    assert got.level == int(want.level) == level + 1
    assert bool(got.changed) == bool(want.changed)
    # Gated, in place through the scratch slot: live at the same level, then dead.
    for live in (1, 0):
        ext = tuple(torch.cat([f.clone(), f.new_zeros(1)]) for f in st[:n])
        ctl = C.new_ctl("cpu")
        C.init_ctl(ctl, 62)
        ctl[C.LEVEL], ctl[C.LIVE] = level, live
        gst = st._replace(**dict(zip(st._fields[:n], (e[:vr] for e in ext))), level=None)
        out = S.sparse_superstep(gst, adj, vr, ctl=ctl, ext=ext)
        wants = got if live else st
        for a, b in zip(out[: n + 1], wants[: n + 1]):
            assert torch.equal(a, b)
        assert bool(out.changed) == (bool(got.changed) and bool(live))
        assert out.level is None


# ------------------------------------------------------------- the engine --

@needs_native
@pytest.mark.parametrize("expansion", ["gather", "mxu"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_hybrid_matches_reference(name, mode, expansion):
    """``run`` and ``run_level_curve`` (the schedule included) against the
    reference's ``RelayEngine(sparse_hybrid=True, direction=mode)``; the
    supersteps issued by body add up to the schedule."""
    g, roots, eng, ref = _engines(name, mode, expansion)
    for s in roots:
        got = eng.run(s)
        _same(got, ref.run(s))
        run = dict(eng.last_run)
        curve = eng.run_level_curve(s)
        assert curve == ref.run_level_curve(s)
        sched = curve["direction_schedule"]
        assert len(sched["schedule"]) == got.num_levels
        if name == "path80":  # 62 packed levels, then the unpacked re-run's 80
            assert got.num_levels == 80 and curve["levels"] == 80
            assert run["live"] == 62 + 80
        elif mode != "pull":
            assert (run["issued_push"], run["issued_pull"]) == (sched["push_supersteps"],
                                                                sched["pull_supersteps"])
        if mode != "pull":  # no dead superstep on the switch loop
            assert run["issued"] == run["live"] == run["issued_push"] + run["issued_pull"]
    if mode == "auto" and name == "switchy":
        assert set(sched["schedule"]) == {"push", "pull"} and sched["switches"] >= 1
    if mode == "push":
        assert set(sched["schedule"]) == {"push"}  # the budgets hold the whole graph


@needs_native
@pytest.mark.parametrize("mode", ["auto", "push"])
def test_eager_loop_is_the_plain_version(mode):
    """The eager loop (a host read of ``changed`` and the next body per
    level, one of the first body) gives the switch loop's results and
    schedule, and as many supersteps by body."""
    g, roots, eng, _ = _engines("switchy", mode, "gather")
    s = roots[0]
    want, wcurve = eng.run(s), eng.run_level_curve(s)
    wrun = dict(eng.last_run)
    eng.loop = "eager"
    try:
        got, curve = eng.run(s), eng.run_level_curve(s)
        run = dict(eng.last_run)
    finally:
        eng.loop = "blocks"
    _same(got, want)
    assert curve == wcurve
    assert run["host_reads"] == run["issued"] + 1 == got.num_levels + 1
    assert (run["issued_push"], run["issued_pull"]) == (wrun["issued_push"], wrun["issued_pull"])


@needs_native
@pytest.mark.parametrize("expansion", ["gather", "mxu"])
@pytest.mark.parametrize("mode", ["auto", "push"])
def test_budgets_force_the_dense_body(monkeypatch, mode, expansion):
    """Budgets below the frontiers of the dense middle: ``push`` runs dense
    exactly where the frontier is over them, ``auto`` wherever Beamer's rule
    or the budgets say pull, as the reference does with the same budgets."""
    for mod in (S, j_bfs):
        monkeypatch.setattr(mod, "SPARSE_BV", 48)
        monkeypatch.setattr(mod, "SPARSE_BE", 160)
    g = P.gnm_graph(700, 2100, seed=11)  # this test's own graph: a fresh reference trace
    s = int(np.argmax(np.bincount(g.src, minlength=g.num_vertices)))
    eng = P.RelayEngine(g, device="cpu", direction=mode, expansion=expansion)
    ref = JRelayEngine(_jgraph(g), sparse_hybrid=True, direction=mode, expansion=expansion)
    _same(eng.run(s), ref.run(s))
    curve = eng.run_level_curve(s)
    assert curve == ref.run_level_curve(s)
    sched = curve["direction_schedule"]["schedule"]
    assert "push" in sched and "pull" in sched
    if mode == "push":
        dist = eng.run(s).dist
        outdeg = np.bincount(g.src, minlength=g.num_vertices)
        for lvl, body in enumerate(sched):
            f = dist == lvl
            fits = f.sum() <= 48 and np.minimum(outdeg[f], 161).sum() <= 160
            assert body == ("push" if fits else "pull"), (lvl, body)


@needs_native
def test_sparse_hybrid_off_is_dense_and_refuses_push(monkeypatch):
    g, roots = _switchy()
    eng = P.RelayEngine(g, device="cpu", sparse_hybrid=False)
    ref = JRelayEngine(_jgraph(g), sparse_hybrid=False, direction="auto")
    _same(eng.run(roots[0]), ref.run(roots[0]))
    assert eng.run_level_curve(roots[0]) == ref.run_level_curve(roots[0])
    assert eng.last_run["issued_push"] == 0 and eng.last_run["host_reads"] <= 3
    with pytest.raises(ValueError, match="sparse_hybrid"):
        P.RelayEngine(g, device="cpu", sparse_hybrid=False, direction="push")
    monkeypatch.setenv("BFS_TPU_TORCH_DIRECTION", "push")
    with pytest.raises(ValueError, match="sparse_hybrid"):
        P.RelayEngine(g, device="cpu", sparse_hybrid=False)
    assert P.RelayEngine(g, device="cpu").direction.mode == "push"


@needs_native
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("mode", ["auto", "push"])
def test_step_dispatch_matches_reference(mode, packed):
    """The stepped bodies: the sequence of bodies ``step_dispatch`` takes
    from a source, and each state, equal to the reference's; the frontier
    statistics beside them."""
    g, roots, eng, ref = _engines("switchy", mode, "gather")
    s = roots[0]
    st = eng.init_packed_state(s) if packed else eng.init_state(s)
    jst = ref.init_packed_state(s) if packed else ref.init_state(s)
    eng.warm_step_bodies(st)
    bodies, jbodies = [], []
    while bool(jst.changed):
        assert eng.take_sparse(st) == ref.take_sparse(jst)
        assert eng.frontier_stats(st) == ref.frontier_stats(jst)
        st, body = eng.step_dispatch(st)
        jst, jbody = ref.step_dispatch(jst)
        bodies.append(body)
        jbodies.append(jbody)
        for a, b in zip(st[: 2 if packed else 3], jst):
            np.testing.assert_array_equal(a.numpy().view(np.uint32), np.asarray(b).view(np.uint32))
        assert bool(st.changed) == bool(jst.changed) and st.level == int(jst.level)
    assert bodies == jbodies and "sparse" in bodies
    dense = P.RelayEngine(g, device="cpu", sparse_hybrid=False)
    assert not dense.take_sparse(dense.init_state(s))
    with pytest.raises(ValueError, match="sparse_hybrid=False"):
        dense.step_dispatch(dense.init_state(s), take_sparse=True)
    assert len(eng._dense_step_operands()) == len(ref._dense_step_operands()) == 3


@needs_native
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("mode", ["auto", "push"])
def test_dead_superstep_of_each_body_changes_nothing(mode, packed):
    """After a run the control block is not LIVE: one more superstep of
    either body leaves the carry, the accumulators, the decision state and
    the control block bit-identical."""
    g, roots, eng, _ = _engines("switchy", mode, "gather")
    eng.packed = packed
    try:
        eng.run(roots[0])
        loop = eng._switch_loop(packed)
        before = [b.clone() for b in loop.buffers]
        assert before[-1][C.LIVE] == 0 and sorted(loop.bodies) == [0, 1]
        for body in loop.bodies.values():
            body.dead_replay()
            for a, b in zip(before, loop.buffers):
                assert torch.equal(a, b)
    finally:
        eng.packed = True


@needs_native
@pytest.mark.parametrize("expansion", ["gather", "mxu"])
@pytest.mark.parametrize("mode", ["auto", "push"])
def test_run_many_device_matches_run(mode, expansion):
    """``run_many_device`` on the hybrid (one superstep of each live
    source's own body a round): every state equal to the reference's, and
    mapped to original ids equal to ``run``; the path past the packed cap
    comes back with ``changed`` set, as the reference's does."""
    g, _, eng, ref = _engines("rmat9", mode, expansion)
    roots = [0, 5, 77, 5]
    states = eng.run_many_device(roots)
    for s, st, jst in zip(roots, states, ref.run_many_device(roots)):
        np.testing.assert_array_equal(st.dist.numpy(), np.asarray(jst.dist))
        np.testing.assert_array_equal(st.parent.numpy(), np.asarray(jst.parent))
        assert (st.level, st.changed) == (int(jst.level), bool(jst.changed))
        want = eng.run(s)
        dist, parent = eng.to_original_device(st, s)
        np.testing.assert_array_equal(dist.numpy(), want.dist)
        np.testing.assert_array_equal(parent.numpy(), want.parent)
    assert eng.run_many_device(roots[:1])[0].level == eng.run(roots[0]).num_levels
    path = P.RelayEngine(P.path_graph(80), device="cpu", direction=mode, expansion=expansion)
    (st,) = path.run_many_device([0])
    assert st.changed and st.level == 62
    assert path.last_run["issued_push"] + path.last_run["issued_pull"] == 62
