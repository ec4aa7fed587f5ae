"""The push and pull layouts and supersteps of the port
(``bfs_tpu_torch.graph.csr``/``graph.ell``, ``ops.relax``/``ops.pull``)
against their ``bfs_tpu`` twins on the same NumPy-seeded inputs.

Every comparison is exact (tolerance 0): the layouts byte for byte, the
supersteps in every field.  The gated forms (a control block, as inside
the level loop) are held against the ungated ones when live, and must
leave every carry field bit-identical when dead."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hs

import bfs_tpu_torch as P
from bfs_tpu_torch.graph import csr as PC
from bfs_tpu_torch.graph import ell as PE
from bfs_tpu_torch.ops import control as C
from bfs_tpu_torch.ops import pull as PP
from bfs_tpu_torch.ops import relax as PR

from bfs_tpu.graph import csr as JC
from bfs_tpu.graph import ell as JE
from bfs_tpu.ops import pull as JP
from bfs_tpu.ops import relax as JR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INT32_MAX = 2**31 - 1


def _star_gnm() -> P.Graph:
    """A sparse gnm graph plus a hub joined to every vertex: the hub's
    in-degree (1,999) needs two ELL folds at K = 32."""
    g = P.gnm_graph(2000, 3000, seed=3)
    hub = np.stack([np.zeros(1999, np.int32), np.arange(1, 2000, dtype=np.int32)], axis=1)
    return P.Graph.from_undirected_edges(2000, np.concatenate([np.stack([g.src, g.dst], 1), hub]))


GRAPHS = {
    "tinyCG": lambda: P.read_sedgewick(os.path.join(REPO, "test-sets", "tinyCG.txt")),
    "randomG": lambda: P.read_sedgewick(os.path.join(REPO, "test-sets", "randomG.txt")),
    "path100": lambda: P.path_graph(100),
    "rmat10": lambda: P.rmat_graph(10, 6, seed=1),
    "star_gnm": _star_gnm,
    "rmat8": lambda: P.rmat_graph(8, 6, seed=9),
}


def _jgraph(g: P.Graph) -> JC.Graph:
    return JC.Graph(g.num_vertices, g.src.copy(), g.dst.copy())


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _eq(got, want) -> None:
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# ------------------------------------------------------------------ layouts --

@pytest.mark.parametrize("name", list(GRAPHS))
def test_device_graph_bytes(name):
    g = GRAPHS[name]()
    got = P.build_device_graph(g, block=256)
    want = JC.build_device_graph(_jgraph(g), block=256)
    assert (got.num_vertices, got.num_edges, got.padded_edges, got.sentinel) == (
        want.num_vertices, want.num_edges, want.padded_edges, want.sentinel)
    for a, b in ((got.src, want.src), (got.dst, want.dst)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for a, b in zip(PC.unpad_edges(got), JC.unpad_edges(want)):
        assert a.tobytes() == b.tobytes()


def test_native_dst_sort_matches_lexsort():
    g = P.rmat_graph(14, 8, seed=4)  # > 100,000 edges: the native path
    got = PC._sorted_by_dst(g.src, g.dst)
    order = np.lexsort((g.src, g.dst))
    for a, b in zip(got, (g.src[order], g.dst[order])):
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("from_device_graph", [False, True])
def test_pull_graph_bytes(name, from_device_graph):
    g = GRAPHS[name]()
    if from_device_graph:
        got = P.build_pull_graph(P.build_device_graph(g))
        want = JE.build_pull_graph(JC.build_device_graph(_jgraph(g)))
    else:
        got, want = P.build_pull_graph(g), JE.build_pull_graph(_jgraph(g))
    assert (got.num_vertices, got.num_edges, got.k, got.padded_slots) == (
        want.num_vertices, want.num_edges, want.k, want.padded_slots)
    assert len(got.folds) == len(want.folds)
    for a, b in zip((got.ell0, *got.folds), (want.ell0, *want.folds)):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    arrays = PE.pull_to_arrays(got)
    assert arrays.keys() == JE.pull_to_arrays(want).keys()
    back = PE.pull_from_arrays(arrays)
    assert all(a.tobytes() == b.tobytes() for a, b in zip((back.ell0, *back.folds),
                                                          (got.ell0, *got.folds)))
    ell0, folds = PE.device_ell(got, "cpu")
    jell0, jfolds = JE.device_ell(want)
    for a, b in zip((ell0, *folds), (jell0, *jfolds)):
        _eq(a, b)


def test_star_graph_folds_twice():
    assert len(P.build_pull_graph(_star_gnm()).folds) == 2


def test_pull_graph_rejects_narrow_rows():
    with pytest.raises(ValueError):
        P.build_pull_graph(GRAPHS["tinyCG"](), k=1)


# ---------------------------------------------------------------- supersteps --

def _random_state(rng, n: int, trees: int | None, level: int):
    """dist/parent/frontier of a plausible carry (vertices at levels
    <= level, the frontier among those at ``level``); int32/bool NumPy."""
    shape = (n,) if trees is None else (trees, n)
    dist = np.where(rng.random(shape) < 0.4, rng.integers(0, level + 1, shape), INT32_MAX)
    dist[..., -1] = INT32_MAX
    parent = np.where(dist == INT32_MAX, -1, rng.integers(0, n - 1, shape))
    frontier = (dist == level) & (rng.random(shape) < 0.8)
    return dist.astype(np.int32), parent.astype(np.int32), frontier


def _packed_of(dist, parent):
    words = (dist.astype(np.int64) << 26) | parent.astype(np.int64)
    return np.where(dist == INT32_MAX, 0xFFFFFFFF, words).astype(np.uint32)


def _states(rng, n, trees, level):
    dist, parent, frontier = _random_state(rng, n, trees, level)
    lvl, chg = np.int32(level), np.bool_(True)
    port = PR.BfsState(_t(dist), _t(parent), _t(frontier), _t(lvl), _t(chg))
    ref = JR.BfsState(jnp.asarray(dist), jnp.asarray(parent), jnp.asarray(frontier),
                      jnp.int32(level), jnp.bool_(True))
    words = _packed_of(dist, parent)
    pport = PR.PackedBfsState(_t(words.view(np.int32)), _t(frontier), _t(lvl), _t(chg))
    pref = JR.PackedBfsState(jnp.asarray(words), jnp.asarray(frontier), jnp.int32(level),
                             jnp.bool_(True))
    return (port, ref), (pport, pref)


def _host(x, field: str) -> np.ndarray:
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.uint32) if field == "packed" else a


def _same_state(got, want) -> None:
    """Every field equal; packed words compared as uint32 (the port holds
    their int32 bit patterns)."""
    for f in got._fields:
        np.testing.assert_array_equal(_host(getattr(got, f), f), _host(getattr(want, f), f),
                                      err_msg=f)


_LAYOUT_CACHE: dict = {}


def _layouts(name):
    """``(graph, (port, reference) push operands, (port, reference) pull
    operands)``, built once per graph."""
    if name not in _LAYOUT_CACHE:
        _LAYOUT_CACHE[name] = _build_layouts(GRAPHS[name]())
    return _LAYOUT_CACHE[name]


def _build_layouts(g):
    dg, jdg = P.build_device_graph(g), JC.build_device_graph(_jgraph(g))
    pg, jpg = P.build_pull_graph(g), JE.build_pull_graph(_jgraph(g))
    push = (_t(dg.src), _t(dg.dst).long()), (jnp.asarray(jdg.src), jnp.asarray(jdg.dst))
    pull = PE.device_ell(pg, "cpu"), JE.device_ell(jpg)
    return g, push, pull


SUPERSTEPS = {
    # name: (port fn, reference fn, layout, packed, batched)
    "push": (PR.relax_superstep, JR.relax_superstep, "push", False, False),
    "push_packed": (PR.relax_superstep_packed, JR.relax_superstep_packed, "push", True, False),
    "push_batched": (PR.relax_superstep_batched, JR.relax_superstep_batched, "push", False, True),
    "push_batched_packed": (PR.relax_superstep_batched_packed,
                            JR.relax_superstep_batched_packed, "push", True, True),
    "pull": (PP.relax_pull_superstep, JP.relax_pull_superstep, "pull", False, False),
    "pull_packed": (PP.relax_pull_superstep_packed, JP.relax_pull_superstep_packed,
                    "pull", True, False),
    "pull_batched": (PP.relax_pull_superstep, JP.relax_pull_superstep, "pull", False, True),
    "pull_batched_packed": (PP.relax_pull_superstep_packed, JP.relax_pull_superstep_packed,
                            "pull", True, True),
}


@pytest.mark.parametrize("name", ["tinyCG", "rmat10", "star_gnm"])
@pytest.mark.parametrize("step", list(SUPERSTEPS))
def test_superstep_matches_reference(name, step):
    port_fn, ref_fn, layout, packed, batched = SUPERSTEPS[step]
    g, push, pull = _layouts(name)
    (p_ops, j_ops) = push if layout == "push" else pull
    rng = np.random.default_rng(len(step) * 7 + g.num_vertices)
    for level in (0, 3, 40):
        unpacked, packed_pair = _states(rng, g.num_vertices + 1, 5 if batched else None, level)
        got_in, want_in = packed_pair if packed else unpacked
        got = port_fn(got_in, *p_ops)
        _same_state(got, ref_fn(want_in, *j_ops))
        # Gated at the same level, live: equal to the ungated superstep but
        # for the level field, which the control block holds.
        ctl = C.new_ctl("cpu")
        C.init_ctl(ctl, 62)
        ctl[C.LEVEL] = level
        gated = port_fn(got_in, *p_ops, ctl=ctl)
        _same_state(gated._replace(level=got.level), got)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_candidates_and_tables(name):
    g, push, pull = _layouts(name)
    rng = np.random.default_rng(11)
    (port, ref), _ = _states(rng, g.num_vertices + 1, None, 2)
    (src, dst), (jsrc, jdst) = push
    _eq(PR._push_candidates(port.frontier, src, dst, g.num_vertices + 1),
        JR._push_candidates(ref.frontier, jsrc, jdst, g.num_vertices + 1))
    values = rng.integers(-50, 50, src.shape[0]).astype(np.int32)
    _eq(PR.combine_min(_t(values), dst, g.num_vertices + 1),
        JR.combine_min(jnp.asarray(values), jdst, g.num_vertices + 1))
    _eq(PP.frontier_table(port), JP.frontier_table(ref))
    (ell0, folds), (jell0, jfolds) = pull
    _eq(PP.pull_candidates(PP.frontier_table(port), ell0, folds),
        JP.pull_candidates(JP.frontier_table(ref), jell0, jfolds))
    _eq(PR.frontier_size(port), JR.frontier_size(ref))


@pytest.mark.parametrize("batched", [False, True])
def test_pull_chunks_equal_one_gather(monkeypatch, batched):
    g, _, pull = _layouts("star_gnm")
    (ell0, folds), (jell0, jfolds) = pull
    rng = np.random.default_rng(2)
    (port, ref), _ = _states(rng, g.num_vertices + 1, 3 if batched else None, 1)
    want = JP.pull_candidates(JP.frontier_table(ref), jell0, jfolds)
    for elems in (1, 100, 4096):  # one row per chunk, a few rows, whole levels
        monkeypatch.setattr(PP, "CHUNK_ELEMS", elems)
        _eq(PP.pull_candidates(PP.frontier_table(port), ell0, folds), want)


@pytest.mark.parametrize("batched", [False, True])
def test_init_and_unpack_match_reference(batched):
    v, sources = 50, [0, 7, 49]
    if batched:
        got, want = PR.init_batched_state(v, sources), JR.init_batched_state(v, sources)
        pgot, pwant = PR.init_packed_batched_state(v, sources), JR.init_packed_batched_state(v, sources)
    else:
        got, want = PR.init_state(v, 7), JR.init_state(v, 7)
        pgot, pwant = PR.init_packed_state(v, 7), JR.init_packed_state(v, 7)
    _same_state(got, want)
    _same_state(pgot, pwant)
    rng = np.random.default_rng(5)
    _, (pport, pref) = _states(rng, 80, 4 if batched else None, 61)
    _same_state(PR.unpack_bfs_state(pport), JR.unpack_bfs_state(pref))


# ------------------------------------------------------ the dead superstep --

@settings(max_examples=25, deadline=None)
@given(seed=hs.integers(0, 2**31 - 1), level=hs.integers(0, 61),
       step=hs.sampled_from(sorted(SUPERSTEPS)))
def test_dead_superstep_leaves_the_carry(seed, level, step):
    """A superstep gated by a control block that is not LIVE (converged, or
    at its cap) returns every carry field bit-identical, the frontier
    included, and raises no flag."""
    port_fn, _, layout, packed, batched = SUPERSTEPS[step]
    _, push, pull = _layouts("rmat8")
    p_ops = (push if layout == "push" else pull)[0]
    rng = np.random.default_rng(seed)
    unpacked, packed_pair = _states(rng, 257, 3 if batched else None, level)
    state = (packed_pair if packed else unpacked)[0]
    ctl = C.new_ctl("cpu")
    C.init_ctl(ctl, 62)
    ctl[C.LEVEL], ctl[C.LIVE] = level, 0
    if seed % 2:
        ctl[C.CHANGED] = 0
    out = port_fn(state, *p_ops, ctl=ctl)
    for f in state._fields[:-2]:  # the arrays; level and changed live in ctl
        assert torch.equal(getattr(out, f), getattr(state, f)), f
    assert out.level is state.level
    assert not bool(out.changed)
