"""The lock-step batched relay loop of the port against the JAX reference
on the CPU: ``RelayEngine.run_multi_device`` and ``run_multi`` (both
expansion arms, packed and unpacked carries) against ``bfs_tpu``'s, the
batched plain ops (the ``[S, n]`` operands of the kernels' plain versions)
against ``bfs_tpu.ops.relay`` and ``bfs_tpu.ops.relay_mxu`` under
``jax.vmap``, a dead superstep of the batch's loop, and a serve relay tick
of 4 against ``bfs_tpu.serve``.  The card's batched kernels are held
against these plain versions in ``test_torch_cuda.py``.

All comparisons are exact (tolerance 0): everything here is integer bit
arithmetic.  Inputs are made with NumPy from a seed; layouts come across
through ``from_reference_layout``."""

import numpy as np
import pytest
import torch

import bfs_tpu_torch as P
from bfs_tpu_torch.graph import adj_tiles as PT
from bfs_tpu_torch.ops import control as C
from bfs_tpu_torch.ops import relay as R
from bfs_tpu_torch.ops import relay_cuda as K
from bfs_tpu_torch.ops import relay_mxu as PM

import jax
import jax.numpy as jnp

from bfs_tpu.graph import adj_tiles as JT
from bfs_tpu.graph import benes as j_benes
from bfs_tpu.graph import relay as j_relay
from bfs_tpu.graph.csr import Graph as JGraph
from bfs_tpu.models.bfs import RelayEngine as JRelayEngine
from bfs_tpu.ops import relay as JR
from bfs_tpu.ops import relay_mxu as JM

pytestmark = pytest.mark.skipif(
    not j_benes.native_available(), reason="native benes router unavailable"
)

GRAPHS = {
    "rmat8": lambda: P.rmat_graph(8, 8, seed=3),
    "rmat10": lambda: P.rmat_graph(10, 6, seed=1),
    "path100": lambda: P.path_graph(100),  # deeper than the packed carry's 62 levels
}
_cache: dict = {}


def _t(a: np.ndarray) -> torch.Tensor:
    """uint32 array -> the port's int32 bit-pattern tensor."""
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))


def _u(a) -> np.ndarray:
    """A port tensor or a reference array as uint32 bit patterns."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a).view(np.uint32)


def _words(rng, shape, density: float = 0.3) -> np.ndarray:
    bits = rng.random((*shape, 32)) < density
    w = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    w[rng.random(shape) < 0.05] = 0xFFFFFFFF
    return w


def _jgraph(g: P.Graph) -> JGraph:
    return JGraph(g.num_vertices, g.src.copy(), g.dst.copy())


def _setup(name: str, expansion: str):
    """(graph, reference layout, port engine, reference engine), the port's
    layout converted from the reference's; kept per test module."""
    key = (name, expansion)
    if key not in _cache:
        g = GRAPHS[name]()
        jrg = j_relay.build_relay_graph(_jgraph(g))
        rg = P.from_reference_layout(j_relay.relay_to_arrays(jrg))
        eng = P.RelayEngine(rg, device="cpu", expansion=expansion)
        _cache[key] = (g, jrg, eng, JRelayEngine(_jgraph(g), expansion=expansion))
    return _cache[key]


def _sources(g: P.Graph, count: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, g.num_vertices, count).astype(np.int32)


def _assert_state(ours: R.RelayState, want) -> None:
    for name in ("dist", "parent", "fwords"):
        np.testing.assert_array_equal(_u(getattr(ours, name)), _u(getattr(want, name)), name)
    assert ours.level == int(want.level)
    assert ours.changed == bool(want.changed)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
@pytest.mark.parametrize("name,expansion", [
    ("rmat8", "gather"), ("rmat10", "gather"), ("rmat8", "mxu"), ("path100", "gather"),
])
def test_run_multi_device_state_matches_reference(name, expansion, packed):
    """The batched state bit for bit (parents L1 slots on the gather arm,
    original ids on the MXU arm), on the block loop and the eager loop; each
    tree mapped by ``multi_tree_to_original_device`` equals ``run``."""
    g, _, eng, jeng = _setup(name, expansion)
    sources = _sources(g, 5, seed=len(name))
    want = jeng.run_multi_device(sources, packed=packed)
    ours = eng.run_multi_device(sources, packed=packed)
    _assert_state(ours, want)
    assert ours.dist.shape == (5, eng.relay_graph.vr)
    assert ours.fwords.shape == (5, eng.relay_graph.vr // 32)
    if name == "path100":  # the packed carry stops at its cap, still changing
        assert ours.changed == packed and (ours.level == 62) == packed
    eng.loop = "eager"
    try:
        _assert_state(eng.run_multi_device(sources, packed=packed), want)
    finally:
        eng.loop = "blocks"
    if ours.changed:
        return
    ours = eng.run_multi_device(sources, packed=packed)
    for i, s in enumerate(sources.tolist()):
        dist, parent = eng.multi_tree_to_original_device(ours, i, s)
        one = eng.run(s)
        np.testing.assert_array_equal(dist.numpy(), one.dist)
        np.testing.assert_array_equal(parent.numpy(), one.parent)


@pytest.mark.parametrize("name,expansion,sources,max_levels", [
    ("rmat10", "gather", [17], None),  # S = 1
    ("rmat10", "gather", [3, 3, 900, 3], None),  # repeated sources
    ("rmat10", "gather", [0, 5, 77, 300, 1023], 3),  # cut by max_levels
    ("rmat8", "mxu", [0, 3, 9, 17, 200], None),
    ("path100", "gather", [0, 50, 99], None),  # the packed cap, then the unpacked re-run
    ("path100", "mxu", [99, 0], None),
])
def test_run_multi_matches_reference(name, expansion, sources, max_levels):
    _, _, eng, jeng = _setup(name, expansion)
    sources = np.asarray(sources, dtype=np.int32)
    want = jeng.run_multi(sources, max_levels=max_levels)
    got = eng.run_multi(sources, max_levels=max_levels)
    np.testing.assert_array_equal(got.dist, np.asarray(want.dist))
    np.testing.assert_array_equal(got.parent, np.asarray(want.parent))
    assert got.num_levels == int(want.num_levels)
    np.testing.assert_array_equal(got.sources, sources)
    run = eng.last_run
    assert run["unpacked_rerun"] == (name == "path100")
    assert run["loop_s"] > 0 and run["result_s"] > 0 and run["level"] == got.num_levels
    if max_levels is not None:
        assert got.num_levels == max_levels
        return
    for i, s in enumerate(sources.tolist()):  # every tree equals the single search
        one = eng.run(s)
        np.testing.assert_array_equal(got.dist[i], one.dist)
        np.testing.assert_array_equal(got.parent[i], one.parent)
    if name == "path100":
        assert got.num_levels == 100 and got.dist.max() == 99  # the last level changes nothing


def test_run_multi_keeps_each_batch_size_loop():
    """One captured loop per batch size and carry, reused by the next batch
    of that size; a streamed engine still refuses the batch."""
    eng = _setup("rmat10", "gather")[2]
    eng.run_multi([1, 2, 3])
    eng.run_multi([4, 5, 6])
    eng.run_multi([1, 2])
    kinds = {key[0] for key in eng._loops}
    assert {("multi_packed", 3), ("multi_packed", 2)} <= kinds
    stream = P.RelayEngine(P.rmat_graph(8, 8, seed=3), device="cpu", expansion="mxu",
                           tiles_mode="stream")
    with pytest.raises(RuntimeError, match="run_streamed"):
        stream.run_multi([0, 1])


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
def test_dead_superstep_leaves_the_batch_bit_identical(packed):
    """After the batch converged its control block is not LIVE: a block of
    its loop issued again changes no tree, the level or the flag."""
    g, _, eng, _ = _setup("rmat10", "gather")
    sources = _sources(g, 4, seed=9)
    st = eng.run_multi_device(sources, packed=packed)
    assert not st.changed
    loop = (eng._packed_loop if packed else eng._unpacked_loop)(trees=4)
    before = [b.clone() for b in loop.buffers]
    assert int(loop.ctl[C.LIVE]) == 0
    loop.dead_replay()
    for a, b in zip(before, loop.buffers):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def ops():
    """The rmat8 layout's operands and a seeded generator."""
    g, jrg, eng, _ = _setup("rmat8", "gather")
    rng = np.random.default_rng(4)
    rg = eng.relay_graph
    valid = j_relay.valid_slot_words(rg.src_l1, rg.net_size)
    return dict(g=g, jrg=jrg, rg=rg, eng=eng, rng=rng, valid=valid)


@pytest.mark.parametrize("network", ["vperm", "net"])
def test_batched_benes_matches_reference_under_vmap(ops, network):
    jrg, rg = ops["jrg"], ops["rg"]
    n = rg.vperm_size if network == "vperm" else rg.net_size
    masks = rg.vperm_masks if network == "vperm" else rg.net_masks
    jtable = jrg.vperm_table if network == "vperm" else jrg.net_table
    table = rg.vperm_table if network == "vperm" else rg.net_table
    words = _words(ops["rng"], (3, n // 32))
    want = jax.vmap(lambda w: JR.apply_benes_std(w, jnp.asarray(masks), jtable, n))(
        jnp.asarray(words))
    K.reset_launches()
    for got in (R.apply_benes_std(_t(words), _t(masks), table, n),
                K.apply_benes(_t(words), _t(masks), table, n)):
        assert got.shape == (3, n // 32)
        np.testing.assert_array_equal(_u(got), np.asarray(want))
    assert all(v == 0 for v in K.LAUNCHES.values())  # the plain version on the CPU
    # each tree as its own single search
    for i in range(3):
        np.testing.assert_array_equal(
            _u(R.apply_benes_std(_t(words[i]), _t(masks), table, n)), np.asarray(want[i]))


@pytest.mark.parametrize("trees", [2, 3, 5, 17])
def test_batched_broadcast_and_rowmin_match_reference_under_vmap(ops, trees):
    """The broadcast and the row-min on ``trees`` trees whose L1 densities
    differ within the batch (none, 1e-4, 0.02, 0.5 and all bits, in turn),
    so that the trees of one group of the card's kernel find their ranks at
    different rows: against ``jax.vmap`` of the JAX twins and of the Pallas
    tournament in interpret mode, and each tree alone."""
    from bfs_tpu.ops import relay_pallas as JP

    jrg, rg = ops["jrg"], ops["rg"]
    rng = np.random.default_rng(trees)
    y = _words(rng, (trees, rg.vperm_size // 32))
    want = jax.jit(jax.vmap(lambda w: JR.broadcast_l2(w, jrg.out_classes, jrg.net_size,
                                                      jrg.out_space)))(jnp.asarray(y))
    l2 = R.broadcast_l2(_t(y), rg.out_classes, rg.net_size, rg.out_space)
    np.testing.assert_array_equal(_u(l2), np.asarray(want))
    densities = (0.0, 1e-4, 0.02, 0.5, 1.0)
    l1 = np.stack([np.packbits(rng.random(rg.net_size) < densities[i % len(densities)],
                               bitorder="little").view(np.uint32) for i in range(trees)])
    valid, jv = ops["valid"], jnp.asarray(ops["valid"])
    want = np.asarray(jax.jit(jax.vmap(
        lambda w: JR.rowmin_ranks(w, jv, jrg.in_classes, jrg.vr)))(jnp.asarray(l1)))
    np.testing.assert_array_equal(want, np.asarray(jax.vmap(
        lambda w: JP.rowmin_ranks_pallas(w, jv, jrg.in_classes, jrg.vr, interpret=True))(
        jnp.asarray(l1))))
    for got in (R.rowmin_ranks(_t(l1), _t(valid), rg.in_classes, rg.vr),
                K.rowmin_ranks(_t(l1), _t(valid), rg.in_classes, rg.vr)):
        assert got.shape == (trees, rg.vr)
        np.testing.assert_array_equal(_u(got), want)
    for i in range(trees):
        np.testing.assert_array_equal(
            _u(R.rowmin_ranks(_t(l1[i]), _t(valid), rg.in_classes, rg.vr)), want[i])
    assert (want[0] == 0xFFFFFFFF).all()  # no frontier bit: no rank
    assert trees < 4 or (want[3] != 0xFFFFFFFF).any()


@pytest.mark.parametrize("level", [0, 5])
def test_batched_updates_match_reference_under_vmap(ops, level):
    """The packed update (kernel wrapper and plain) and the unpacked merge
    on 3 trees at one shared level; ``changed`` is any tree's, and a tree
    that changes nothing leaves the batch's flag to the others."""
    rg, rng = ops["rg"], ops["rng"]
    vr = rg.vr
    packed = np.where(rng.random((3, vr)) < 0.5, 0xFFFFFFFF,
                      rng.integers(0, 1 << 26, (3, vr))).astype(np.uint32)
    cand = np.where(rng.random((3, vr)) < 0.7, 0xFFFFFFFF,
                    rng.integers(0, 1 << 26, (3, vr))).astype(np.uint32)
    cand[1] = 0xFFFFFFFF  # tree 1 changes nothing
    fw0 = _words(rng, (3, vr // 32))

    def ref(pk, c):
        st = JR.PackedRelayState(pk, jnp.zeros(vr // 32, jnp.uint32), jnp.int32(level),
                                 jnp.bool_(True))
        return JR.apply_relay_candidates_packed(st, c)

    want = jax.vmap(ref)(jnp.asarray(packed), jnp.asarray(cand))
    assert not bool(want.changed[1])
    st = R.PackedRelayState(_t(packed), _t(fw0), level, None)
    for got in (R.apply_relay_candidates_packed(st, _t(cand)),
                K.apply_relay_candidates_packed(st._replace(packed=_t(packed)), _t(cand))):
        np.testing.assert_array_equal(_u(got.packed), np.asarray(want.packed))
        np.testing.assert_array_equal(_u(got.fwords), np.asarray(want.fwords))
        assert bool(got.changed) == bool(want.changed.any()) and got.level == level + 1
    # gated by a live control block at that level: the same words, in place
    ctl = C.new_ctl("cpu")
    C.init_ctl(ctl, 62)
    ctl[C.LEVEL] = level
    work, fout = _t(packed), _t(fw0)
    K.apply_relay_candidates_packed(R.PackedRelayState(work, fout, None, None), _t(cand),
                                    fwords_out=fout, ctl=ctl)
    np.testing.assert_array_equal(_u(work), np.asarray(want.packed))
    np.testing.assert_array_equal(_u(fout), np.asarray(want.fwords))
    assert int(ctl[C.FLAG]) == int(bool(want.changed.any()))

    dist = np.where(rng.random((3, vr)) < 0.5, np.iinfo(np.int32).max,
                    rng.integers(0, level + 1, (3, vr))).astype(np.int32)
    parent = rng.integers(-1, vr, (3, vr)).astype(np.int32)
    slots = np.where(rng.random((3, vr)) < 0.6, np.iinfo(np.int32).max,
                     rng.integers(0, rg.net_size, (3, vr))).astype(np.int32)
    slots[2] = np.iinfo(np.int32).max

    def ref_unpacked(d, p, c):
        st = JR.RelayState(d, p, jnp.zeros(vr // 32, jnp.uint32), jnp.int32(level),
                           jnp.bool_(True))
        return JR.apply_relay_candidates(st, c)

    want = jax.vmap(ref_unpacked)(jnp.asarray(dist), jnp.asarray(parent), jnp.asarray(slots))
    got = R.apply_relay_candidates(
        R.RelayState(torch.from_numpy(dist), torch.from_numpy(parent), _t(fw0), level, None),
        torch.from_numpy(slots))
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(want.dist))
    np.testing.assert_array_equal(got.parent.numpy(), np.asarray(want.parent))
    np.testing.assert_array_equal(_u(got.fwords), np.asarray(want.fwords))
    assert bool(got.changed) == bool(want.changed.any())


@pytest.mark.parametrize("rows,cols,e", [(300, 300, 1200), (4000, 600, 5000)])
def test_batched_mxu_expansion_matches_reference_under_vmap(rows, cols, e):
    rng = np.random.default_rng(e)
    src = rng.integers(0, rows, e)
    dst = rng.integers(0, cols, e)
    n2o = rng.permutation(rows).astype(np.int64)
    jat = JT.build_adj_tiles_host(src, dst, rows=rows, cols=cols,
                                  keys2d=JT.keys_from_new2old(n2o, rows))
    at = PT.build_adj_tiles_device(src, dst, rows=rows, cols=cols,
                                   keys2d=PT.keys_from_new2old(n2o, rows))
    kw = dict(rows=rows, cols=cols, rtp=jat.rtp, vtp=jat.vtp)
    nfw = -(-rows // 32)
    fw = np.stack([_words(rng, (nfw,), d) for d in (0.02, 0.3, 0.0, 0.9)])
    want = jax.vmap(lambda f: JM.expand_frontier_mxu_xla(f, JM.mxu_device_operands(jat), **kw))(
        jnp.asarray(fw))
    ops = PM.mxu_device_operands(at, "cpu")
    for got in (PM.expand_frontier_mxu_plain(_t(fw), ops, **kw),
                K.expand_frontier_mxu(_t(fw), ops, **kw)):
        assert got.shape == (4, cols)
        np.testing.assert_array_equal(_u(got), np.asarray(want))
    # min-merged into a caller's [S, vtp] output, as a launch with out=
    out = torch.full((4, jat.vtp), -1, dtype=torch.int32)
    out[:, :cols] = _t(np.asarray(want))
    out[0, 0] = 0  # below every candidate: kept
    merged = K.expand_frontier_mxu(_t(fw), ops, out=out, **kw)
    assert merged.shape == (4, cols) and int(merged[0, 0]) == 0
    np.testing.assert_array_equal(_u(merged[1:]), np.asarray(want)[1:])


def test_wrappers_validate_the_tree_axis():
    """``[n]`` is one tree, ``[S, n]`` S trees; an output must match its
    input's shape exactly."""
    w = torch.zeros((3, 8), dtype=torch.int32)
    assert K._trees("x", w[0], 8) == 1 and K._trees("x", w, 8) == 3
    for bad in (w[:, :4], w.reshape(3, 2, 4), w.t()):
        with pytest.raises(ValueError):
            K._trees("x", bad, 8)
    K._like("out", w, 3, 8)
    with pytest.raises(ValueError):
        K._like("out", w[0], 3, 8)
    # candidates: rows of a wider array, as the MXU arm's [S, vtp] output
    wide = torch.zeros((3, 12), dtype=torch.int32)
    assert K._rows("c", wide[:, :8], 3, 8) == 12 and K._rows("c", w[0], 8) == 8
    for bad in (wide[:, 4:].t(), wide.reshape(2, 18)[:, ::2], w.to(torch.int64)):
        with pytest.raises(ValueError):
            K._rows("c", bad, *bad.shape)


def test_init_relay_batch_stacks_single_inits():
    vr = 96
    sources = [0, 31, 95, 31]
    for packed, single in ((True, R.init_packed_relay_state), (False, R.init_relay_state)):
        batch = R.init_relay_batch(vr, sources, "cpu", packed)
        assert batch.level == 0 and bool(batch.changed)
        for i, s in enumerate(sources):
            one = single(vr, s)
            for a, b in zip(batch[:-2], one[:-2]):
                assert torch.equal(a[i], b)


def test_serve_relay_tick_of_4_matches_the_reference(monkeypatch):
    """Ticks of 4 relay sources (bucket 4: below the element-major 32) go
    through the lock-step loop, one batch each, and reply as
    ``bfs_tpu.serve`` does, bit for bit."""
    from bfs_tpu.serve import BfsServer as JServer
    from bfs_tpu_torch.serve import BfsServer

    batches = []
    real = P.RelayEngine.run_multi_device

    def spy(self, sources, **kw):
        batches.append(len(sources))
        return real(self, sources, **kw)

    monkeypatch.setattr(P.RelayEngine, "run_multi_device", spy)
    for g, ticks in (
        (P.gnm_graph(150, 400, seed=11),
         [[("single", [0]), ("single", [7]), ("tree", [5, 60])],
          [("collapse", [3, 77, 140]), ("single", [149])]]),
        (P.path_graph(70), [[("single", [0]), ("tree", [3, 35, 69])]]),
    ):
        replies = []
        for cls, graph, kw in ((BfsServer, g, {"device": "cpu"}),
                               (JServer, _jgraph(g), {})):
            with cls(engine="relay", max_batch=32, **kw) as srv:
                srv.register("g", graph)
                got = []
                for tick in ticks:
                    srv.pause()
                    futs = [srv.submit("g", srcs, mode=mode) for mode, srcs in tick]
                    srv.resume()
                    got += [f.result(300) for f in futs]
            replies.append(got)
        for a, b in zip(*replies):
            np.testing.assert_array_equal(a.dist, b.dist)
            np.testing.assert_array_equal(a.parent, b.parent)
            assert (a.num_levels, a.record.status, a.record.batch_size, a.mode) == (
                b.num_levels, b.record.status, b.record.batch_size, b.mode)
            assert a.record.batch_size == 4
    assert batches and set(batches) == {4}
