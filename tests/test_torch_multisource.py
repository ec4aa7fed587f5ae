"""Batched multi-source BFS of the port against the JAX reference: the
element-major plain ops against ``bfs_tpu.ops.relay_elem`` and against K5
(``_run_elem_pass``) in interpret mode, and ``run_multi_elem``,
``run_multi``, ``bfs_multi`` and ``collapse_multi_source`` on
``device="cpu"`` against ``bfs_tpu``'s, bit for bit.  The card's elem
kernels are held against these plain versions in ``test_torch_cuda.py``.

All comparisons are exact (tolerance 0): everything here is integer bit
arithmetic.  Inputs are made with NumPy from a seed; element payloads set
bit 31 (tree 31 of a group, the sign bit of an int32) on purpose."""

import os

import numpy as np
import pytest
import torch

import bfs_tpu_torch as P
from bfs_tpu_torch.graph import benes as p_benes
from bfs_tpu_torch.graph import relay as p_relay
from bfs_tpu_torch.ops import relay_cuda as K
from bfs_tpu_torch.ops import relay_elem as RE

import jax
import jax.numpy as jnp

from bfs_tpu.graph import benes as j_benes
from bfs_tpu.graph import relay as j_relay
from bfs_tpu.graph.csr import Graph as JGraph
from bfs_tpu.models import multisource as JM
from bfs_tpu.models.bfs import RelayEngine as JRelayEngine
from bfs_tpu.ops import relay_elem as JRE
from bfs_tpu.ops import relay_pallas as JP

pytestmark = pytest.mark.skipif(
    not j_benes.native_available(), reason="native benes router unavailable"
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "test-sets", "tinyCG.txt")


def _t(a: np.ndarray) -> torch.Tensor:
    """uint32 array -> the port's int32 bit-pattern tensor."""
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))


def _u(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _elems(rng, shape, density: float = 0.5) -> np.ndarray:
    """uint32 elements, each bit set with ``density``, plus all-ones and
    bit-31-only elements mixed in."""
    bits = rng.random((*shape, 32)) < density
    x = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    x[rng.random(shape) < 0.05] = 0xFFFFFFFF
    x[rng.random(shape) < 0.05] = np.uint32(1 << 31)
    return x


def _jgraph(g: P.Graph) -> JGraph:
    return JGraph(g.num_vertices, g.src.copy(), g.dst.copy())


def _jstate(st: RE.ElemState) -> JRE.ElemState:
    return JRE.ElemState(
        visited=jnp.asarray(_u(st.visited)), frontier=jnp.asarray(_u(st.frontier)),
        dist_planes=jnp.asarray(_u(st.dist_planes)),
        rank_planes=jnp.asarray(_u(st.rank_planes)),
        level=jnp.int32(st.level), changed=jnp.bool_(True),
    )


def _pstate(st: JRE.ElemState) -> RE.ElemState:
    return RE.ElemState(
        visited=_t(np.asarray(st.visited)), frontier=_t(np.asarray(st.frontier)),
        dist_planes=_t(np.asarray(st.dist_planes)),
        rank_planes=_t(np.asarray(st.rank_planes)),
        level=int(st.level), changed=torch.tensor(bool(st.changed)),
    )


def _assert_states_equal(ours: RE.ElemState, ref: JRE.ElemState) -> None:
    for name in ("visited", "frontier", "dist_planes", "rank_planes"):
        np.testing.assert_array_equal(_u(getattr(ours, name)), np.asarray(getattr(ref, name)), name)
    assert ours.level == int(ref.level)
    assert bool(ours.changed) == bool(ref.changed)


def _disconnected() -> P.Graph:
    """Two R-MAT blocks with no edge between them, plus isolated vertices."""
    a = P.rmat_graph(7, 4, seed=8)
    shift = a.num_vertices
    edges = np.concatenate([
        np.stack([a.src, a.dst], axis=1),
        np.stack([a.src + shift, a.dst + shift], axis=1),
    ])
    return P.Graph.from_directed_edges(2 * shift + 20, edges)


def _random_graph(seed: int, v: int = 2500, ne: int = 7000) -> P.Graph:
    """The random graph of tests/test_multisource_elem.py."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, v, ne)
    w = rng.integers(0, v, ne)
    keep = u != w
    u, w = u[keep], w[keep]
    return P.Graph(v, np.concatenate([u, w]), np.concatenate([w, u]))


@pytest.fixture(scope="module", params=["rmat8", "rmat10"])
def layout(request):
    """An R-MAT layout (rank-major and vertex-major classes), built by the
    reference and converted into the port."""
    scale = {"rmat8": 8, "rmat10": 10}[request.param]
    g = P.rmat_graph(scale, 8, seed=3)
    rg = P.from_reference_layout(j_relay.relay_to_arrays(j_relay.build_relay_graph(_jgraph(g))))
    assert any(c.vertex_major for c in rg.in_classes)
    return rg


# ------------------------------------------------------------------ Beneš --

def test_apply_benes_elem_matches_jax_and_k5_interpret():
    """The plain element network against the XLA twin and K5 in interpret
    mode (outer, local and outer passes at tile_rows=128, outer_tt=32), and
    the port's split at the same tile (2^14 elements) run stage by stage
    through the wrappers, on random uint32[2, n] with bit 31 set."""
    rng = np.random.default_rng(9)
    n = 1 << 16
    perm = rng.permutation(n).astype(np.int64)
    masks, table = j_relay._compact_and_table(j_benes.route_std(perm), n)
    x = _elems(rng, (2, n))
    assert (x >> 31).any(axis=1).all()
    want = np.asarray(JRE.apply_benes_elem(jnp.asarray(x), jnp.asarray(masks), table, n))
    np.testing.assert_array_equal(want, x[:, perm])

    ps = JP.elem_pass_static(table, n, tile_rows=128, outer_tt=32)
    arrays = JP.prepare_elem_pass_masks(masks, table, n, tile_rows=128, outer_tt=32)
    assert [m[0] for m in ps] == ["outer", "local", "outer"]
    interp = jnp.asarray(x)
    for (mode, tr, tt, specs), arr in zip(ps, arrays):
        interp = JP._run_elem_pass(interp, jnp.asarray(arr), mode, tr, tt, specs, n, True)
    np.testing.assert_array_equal(np.asarray(interp), want)

    xt, mt = _t(x), _t(masks)
    np.testing.assert_array_equal(_u(RE.apply_benes_elem(xt, mt, table, n)), want)
    pre, local, suf, tile = K.split_elem_passes(table, n, 128 * 128)
    assert [len(pre), len(local), len(suf)] == [len(specs) for *_, specs in ps]
    K.reset_launches()
    y = xt
    for i in pre:
        y = K.benes_elem_outer_stage(y, mt, table[i], n)
    y = K.benes_elem_local_pass(y, mt, tuple(table[i] for i in local), n, tile)
    for i in suf:
        y = K.benes_elem_outer_stage(y, mt, table[i], n)
    np.testing.assert_array_equal(_u(y), want)
    np.testing.assert_array_equal(_u(K.apply_benes_elem(xt, mt, table, n)), want)
    assert all(v == 0 for v in K.LAUNCHES.values())  # CPU tensors: plain versions


@pytest.mark.parametrize("n", [1 << 13, 1 << 16, 1 << 20, 1 << 26])
def test_split_elem_passes_covers_every_stage(n):
    table = tuple(
        p_relay.StageSpec(d=p_benes.stage_distance(n, s), offset=0, nwords=0,
                          compact=False, lo=0, hi=0)
        for s in range(p_benes.num_stages(n))
    )
    for tile in (None, 1 << 10, n):
        pre, local, suf, t = K.split_elem_passes(table, n, tile)
        assert t == (min(K.MAX_TILE_ELEMS, n) if tile is None else tile)
        assert pre + local + suf == tuple(range(len(table)))  # each stage once, in order
        assert all(table[i].d >= t for i in pre + suf)
        assert all(table[i].d < t for i in local)
        assert len(pre) == len(suf) == max(n.bit_length() - t.bit_length(), 0)
    assert K.split_elem_passes(table, n, n)[:3] == ((), tuple(range(len(table))), ())
    for bad in (3000, 2 * n):
        with pytest.raises(ValueError):
            K.split_elem_passes(table, n, bad)


# ---------------------------------------------------- the other plain ops --

def test_init_elem_state_matches_jax(layout):
    rg = layout
    rng = np.random.default_rng(3)
    src = rng.integers(0, rg.num_vertices, (2, 32))
    src[0, 5] = src[0, 31]  # two trees of one group on one vertex
    src[1, 31] = src[0, 31]  # bit 31 of both groups on one vertex
    src_new = rg.old2new[src].astype(np.int32)
    _, pt = RE.rank_plane_layout(rg.in_classes)
    assert RE.rank_plane_layout(rg.in_classes) == JRE.rank_plane_layout(rg.in_classes)
    ours = RE.init_elem_state(rg.vr, src_new, pt)
    _assert_states_equal(ours, JRE.init_elem_state(rg.vr, src_new, pt))


def test_broadcast_l2_elem_matches_jax(layout):
    rg = layout
    assert any(c.vertex_major for c in rg.out_classes)
    y = _elems(np.random.default_rng(2), (2, rg.vperm_size))
    want = JRE.broadcast_l2_elem(jnp.asarray(y), rg.out_classes, rg.net_size)
    got = RE.broadcast_l2_elem(_t(y), rg.out_classes, rg.net_size)
    np.testing.assert_array_equal(_u(got), np.asarray(want))


@pytest.mark.parametrize("density", [0.02, 0.5])
def test_rowmin_elem_matches_jax(layout, density):
    rg = layout
    l1 = _elems(np.random.default_rng(int(density * 100)), (2, rg.net_size), density)
    valid = j_relay.valid_slot_words(rg.src_l1, rg.net_size)
    offsets, pt = RE.rank_plane_layout(rg.in_classes)
    found, rp = RE.rowmin_elem(_t(l1), _t(valid), rg.in_classes, rg.vr, offsets, pt)
    jfound, jrp = jax.jit(
        lambda a, v: JRE.rowmin_elem(a, v, rg.in_classes, rg.vr, offsets, pt)
    )(jnp.asarray(l1), jnp.asarray(valid))
    np.testing.assert_array_equal(_u(found), np.asarray(jfound))
    np.testing.assert_array_equal(_u(rp), np.asarray(jrp))


def _random_state(rng, rg, level: int) -> RE.ElemState:
    """A carry with random visited bits (frontier a subset) and random
    distance and rank planes, at ``level``."""
    _, pt = RE.rank_plane_layout(rg.in_classes)
    visited = _elems(rng, (2, rg.vr))
    frontier = visited & _elems(rng, (2, rg.vr))
    return RE.ElemState(
        visited=_t(visited), frontier=_t(frontier),
        dist_planes=_t(_elems(rng, (RE.DIST_PLANES, 2, rg.vr))),
        rank_planes=_t(_elems(rng, (2, pt))), level=level,
        changed=torch.tensor(True),
    )


@pytest.mark.parametrize("level", [0, 6, 31])
def test_elem_superstep_matches_jax(layout, level):
    """One superstep from a carry at ``level`` (31: the step past the cap,
    which writes no distance plane), the plain superstep and the wrapper's
    row-min/update (plain on the CPU) against the reference."""
    rg = layout
    rng = np.random.default_rng(level)
    st = _random_state(rng, rg, level)
    if level == 0:  # a real start: 64 sources, bit 31 of both groups set
        src = rng.choice(rg.num_vertices, 64, replace=False)
        _, pt = RE.rank_plane_layout(rg.in_classes)
        st = RE.init_elem_state(rg.vr, rg.old2new[src].reshape(2, 32), pt)
    offsets, pt = RE.rank_plane_layout(rg.in_classes)
    valid = j_relay.valid_slot_words(rg.src_l1, rg.net_size)
    statics = dict(
        vperm_table=rg.vperm_table, vperm_size=rg.vperm_size,
        out_classes=rg.out_classes, net_table=rg.net_table,
        net_size=rg.net_size, in_classes=rg.in_classes, vr=rg.vr,
        plane_offsets=offsets, pt=pt,
    )
    ref = jax.jit(
        lambda jst, vm, nm, vw: JRE.elem_superstep(
            jst, vperm_masks=vm, net_masks=nm, valid_words=vw, **statics
        )
    )(_jstate(st), jnp.asarray(rg.vperm_masks), jnp.asarray(rg.net_masks), jnp.asarray(valid))
    ours = RE.elem_superstep(
        st, vperm_masks=_t(rg.vperm_masks), net_masks=_t(rg.net_masks),
        valid_words=_t(valid), **statics,
    )
    _assert_states_equal(ours, ref)
    if level == 31:
        np.testing.assert_array_equal(_u(ours.dist_planes), _u(st.dist_planes))
    # The wrapper route (plain on the CPU) from the routed L1 elements.
    fw = torch.zeros((2, rg.vperm_size), dtype=torch.int32)
    fw[:, : rg.vr] = st.frontier
    y = K.apply_benes_elem(fw, _t(rg.vperm_masks), rg.vperm_table, rg.vperm_size)
    l2 = RE.broadcast_l2_elem(y, rg.out_classes, rg.net_size)
    l1 = K.apply_benes_elem(l2, _t(rg.net_masks), rg.net_table, rg.net_size)
    _assert_states_equal(K.elem_rowmin_update(l1, _t(valid), st, rg.in_classes, rg.vr), ref)


def test_extract_results_matches_jax():
    g = P.rmat_graph(10, 6, seed=1)
    jeng = JRelayEngine(_jgraph(g))
    rg = P.from_reference_layout(j_relay.relay_to_arrays(jeng.relay_graph))
    sources = np.random.default_rng(4).choice(g.num_vertices, 64, replace=False).astype(np.int32)
    jst = jeng.run_multi_elem_device(sources)
    want_d, want_p = JRE.extract_results(jst, jeng.relay_graph, sources)
    got_d, got_p = RE.extract_results(
        _pstate(jst), rg, sources, torch.from_numpy(rg.old2new.astype(np.int64)),
        torch.from_numpy(rg.src_l1),
    )
    np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_array_equal(got_p, want_p)


# ------------------------------------------------------------- end to end --

def _sources(g: P.Graph, count: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.choice(g.num_vertices, count, replace=g.num_vertices < count).astype(np.int32)


E2E = {
    "random": (lambda: _random_graph(21), 64),
    "rmat10": (lambda: P.rmat_graph(10, 6, seed=1), 64),
    "tinyCG": (lambda: P.read_sedgewick(TINY), 32),  # 6 vertices: repeats
    "disconnected": (_disconnected, 64),
}


@pytest.mark.parametrize("name", list(E2E))
def test_run_multi_elem_matches_reference(name):
    make, count = E2E[name]
    g = make()
    sources = _sources(g, count, seed=len(name))
    got = P.RelayEngine(g, device="cpu").run_multi_elem(sources)
    want = JRelayEngine(_jgraph(g)).run_multi_elem(sources)
    np.testing.assert_array_equal(got.dist, want.dist)
    np.testing.assert_array_equal(got.parent, want.parent)
    assert got.num_levels == int(want.num_levels)
    np.testing.assert_array_equal(got.sources, sources)
    for i in range(31, count, 32):  # bit 31 of every group
        dist, parent = P.canonical_bfs(g, int(sources[i]))
        np.testing.assert_array_equal(got.dist[i], dist)
        np.testing.assert_array_equal(got.parent[i], parent)
    if name == "disconnected":
        assert (got.dist == P.INF_DIST).any()


def test_deep_graph_falls_back_and_ecc_31_converges():
    """path(100): eccentricity > 31, so the elem run stays unconverged and
    run_multi_elem falls back to run_multi; path(32) from vertex 0 has
    eccentricity exactly 31 and converges on the step past the cap."""
    sources = np.array([0] * 16 + [50] * 8 + [99] * 8, dtype=np.int32)
    g = P.path_graph(100)
    eng = P.RelayEngine(g, device="cpu")
    assert bool(eng.run_multi_elem_device(sources).changed)
    got = eng.run_multi_elem(sources)
    want = JRelayEngine(_jgraph(g)).run_multi_elem(sources)
    np.testing.assert_array_equal(got.dist, want.dist)
    np.testing.assert_array_equal(got.parent, want.parent)
    assert got.num_levels == int(want.num_levels) == 100
    assert got.dist[0].max() == 99

    g = P.path_graph(32)
    eng = P.RelayEngine(g, device="cpu")
    st = eng.run_multi_elem_device(np.zeros(32, np.int32))
    assert not bool(st.changed) and st.level == 32
    got = eng.run_multi_elem(np.zeros(32, np.int32))
    dist, parent = P.canonical_bfs(g, 0)
    np.testing.assert_array_equal(got.dist[31], dist)
    np.testing.assert_array_equal(got.parent[31], parent)
    assert got.dist[0].max() == 31


LOCKSTEP = {
    "rmat10": (lambda: P.rmat_graph(10, 6, seed=1), None),
    "path100": (lambda: P.path_graph(100), None),  # past the packed 62 levels
    "path100_cap": (lambda: P.path_graph(100), 7),
}


@pytest.mark.parametrize(
    "name,count",
    [("rmat10", 5), ("rmat10", 33), ("path100", 5), ("path100_cap", 33)],
)
def test_run_multi_and_bfs_multi_match_reference(name, count):
    """The lock-step fallback and ``bfs_multi(engine="relay")``, roots of
    different eccentricities, ``num_levels`` included; then
    ``collapse_multi_source`` on the result."""
    make, max_levels = LOCKSTEP[name]
    g = make()
    sources = _sources(g, count, seed=count)
    want = JM.bfs_multi(_jgraph(g), sources, engine="relay", max_levels=max_levels)
    got = P.bfs_multi(g, sources, engine="relay", device="cpu", max_levels=max_levels)
    eng = P.RelayEngine(g, device="cpu")
    for ours in (got, eng.run_multi(sources, max_levels=max_levels)):
        np.testing.assert_array_equal(ours.dist, want.dist)
        np.testing.assert_array_equal(ours.parent, want.parent)
        assert ours.num_levels == int(want.num_levels)
    if max_levels is None:  # the trees converge at different levels
        ecc = np.where(got.dist == P.INF_DIST, -1, got.dist).max(axis=1)
        assert len(set(ecc.tolist())) > 1
    for a, b in zip(P.collapse_multi_source(got), JM.collapse_multi_source(want)):
        np.testing.assert_array_equal(a, b)


def test_multi_source_errors_match_reference():
    g = P.read_sedgewick(TINY)
    ours = P.RelayEngine(g, device="cpu")
    ref = JRelayEngine(_jgraph(g))
    for call in (
        lambda e: e.run_multi_elem([1, 2, 3]),  # not a multiple of 32
        lambda e: e.run_multi_elem(np.zeros(32, np.int32), max_levels=32),
        lambda e: e.run_multi_elem_device(np.full(32, 6, np.int32)),  # out of range
        lambda e: e.run_multi([0, 6]),
    ):
        with pytest.raises(ValueError):
            call(ref)
        with pytest.raises(ValueError):
            call(ours)
    with pytest.raises(ValueError):
        P.bfs_multi(g, [0], engine="ell", device="cpu")


def test_elem_wrappers_take_the_plain_version_on_cpu(layout):
    rg = layout
    K.reset_launches()
    st = _random_state(np.random.default_rng(8), rg, 4)
    l1 = _t(_elems(np.random.default_rng(5), (2, rg.net_size), 0.1))
    valid = _t(j_relay.valid_slot_words(rg.src_l1, rg.net_size))
    offsets, pt = RE.rank_plane_layout(rg.in_classes)
    found, rp = RE.rowmin_elem(l1, valid, rg.in_classes, rg.vr, offsets, pt)
    want = RE.apply_elem_found(st, found, rp, rg.in_classes, offsets)
    got = K.elem_rowmin_update(l1, valid, st, rg.in_classes, rg.vr)
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(_u(a), _u(b))
    # In place, as on the card: the given state holds the update.
    assert got.visited is st.visited and got.dist_planes is st.dist_planes
    assert got.rank_planes is st.rank_planes
    np.testing.assert_array_equal(_u(st.visited), _u(want.visited))
    assert all(v == 0 for v in K.LAUNCHES.values())
    meta = torch.empty((2, rg.net_size), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        K.apply_benes_elem(meta, _t(rg.net_masks), rg.net_table, rg.net_size)
