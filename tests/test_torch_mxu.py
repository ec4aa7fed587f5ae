"""The MXU expansion arm of the port against the JAX reference, bit for bit:
the tile builders against ``bfs_tpu.graph.adj_tiles``, the plain expansion
against the reference's XLA twin and its Pallas kernel (interpret mode, as
``tests/test_expansion_mxu.py`` runs it), ``RelayEngine(expansion="mxu")``
on the CPU against the reference engine's MXU arm and the port's gather
arm, and the choice of arm.  Inputs come from seeded numpy; every comparison is
exact (integer bit arithmetic)."""

import numpy as np
import pytest
import torch

import bfs_tpu_torch as P
from bfs_tpu_torch.graph import adj_tiles as PT
from bfs_tpu_torch.models import bfs as p_bfs
from bfs_tpu_torch.ops import packed as p_packed
from bfs_tpu_torch.ops import relay_cuda as K
from bfs_tpu_torch.ops import relay_mxu as PM
from bfs_tpu_torch.utils import cuda_build

from bfs_tpu.graph import adj_tiles as JT
from bfs_tpu.graph import benes as j_benes
from bfs_tpu.graph import relay as j_relay
from bfs_tpu.graph.csr import Graph as JGraph
from bfs_tpu.models.bfs import RelayEngine as JRelayEngine
from bfs_tpu.ops import packed as j_packed
from bfs_tpu.ops import relay_mxu as JM

needs_native = pytest.mark.skipif(
    not j_benes.native_available(), reason="native benes router unavailable"
)

FIELDS = ("tiles", "row_idx", "col_id", "keys2d")


def _jgraph(g: P.Graph) -> JGraph:
    return JGraph(g.num_vertices, g.src.copy(), g.dst.copy())


def _star(n: int = 256) -> P.Graph:
    leaves = np.arange(1, n, dtype=np.int32)
    return P.Graph.from_undirected_edges(
        n, np.stack([np.zeros(n - 1, np.int32), leaves], axis=1)
    )


def _edges(rows: int, cols: int, e: int, seed: int):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, rows, e)
    dst = rng.integers(0, cols, e)
    if e:  # duplicate edges must OR onto the same bit
        src = np.concatenate([src, src[:7]])
        dst = np.concatenate([dst, dst[:7]])
    return rng, src, dst


def assert_same_layout(ours: PT.AdjTiles, ref) -> None:
    for f in FIELDS:
        got = getattr(ours, f).cpu().numpy()
        want = np.asarray(getattr(ref, f))
        assert got.dtype == np.int32 and got.shape == want.shape, f
        assert got.tobytes() == want.tobytes(), f
    assert (ours.rows, ours.cols, ours.rtp, ours.vtp, ours.nt, ours.ntp) == (
        ref.rows, ref.cols, ref.rtp, ref.vtp, ref.nt, ref.ntp
    )


def assert_same(a, b) -> None:
    np.testing.assert_array_equal(a.dist, b.dist)
    np.testing.assert_array_equal(a.parent, b.parent)
    assert a.num_levels == b.num_levels


# ------------------------------------------------------------------ layout --

@pytest.mark.parametrize("rows,cols,e", [(200, 200, 900), (4000, 300, 2500),
                                         (64, 9000, 50), (64, 64, 0)])
def test_tile_builders_match_reference(rows, cols, e):
    rng, src, dst = _edges(rows, cols, e, rows + cols + e)
    n2o = rng.permutation(rows).astype(np.int64)
    jkeys = JT.keys_from_new2old(n2o, rows)
    want_host = JT.build_adj_tiles_host(src, dst, rows=rows, cols=cols, keys2d=jkeys)
    want_dev = JT.build_adj_tiles_device(src, dst, rows=rows, cols=cols, keys2d=jkeys)
    keys = PT.keys_from_new2old(n2o, rows)
    assert keys.numpy().view(np.uint32).tobytes() == jkeys.tobytes()
    for build in (PT.build_adj_tiles_host, PT.build_adj_tiles_device):
        got = build(src, dst, rows=rows, cols=cols, keys2d=keys)
        assert_same_layout(got, want_host)
        assert_same_layout(got, want_dev)


def test_budget_gate_raises(monkeypatch):
    monkeypatch.delenv("BFS_TPU_MXU_TILE_GB", raising=False)
    assert PM.DEFAULT_TILES_BUDGET_BYTES == JM.tiles_budget_bytes()
    monkeypatch.setenv("BFS_TPU_MXU_TILE_GB", "0.000001")  # about 1 KB
    _, src, dst = _edges(4096, 4096, 4000, 0)
    keys = PT.keys_from_new2old(np.arange(4096), 4096)
    with pytest.raises(ValueError):
        JT.build_adj_tiles_host(src, dst, rows=4096, cols=4096,
                                keys2d=JT.keys_from_new2old(np.arange(4096), 4096),
                                budget_bytes=JM.tiles_budget_bytes())
    for build in (PT.build_adj_tiles_host, PT.build_adj_tiles_device):
        with pytest.raises(ValueError, match="budget"):
            build(src, dst, rows=4096, cols=4096, keys2d=keys,
                  budget_bytes=JM.tiles_budget_bytes())
    # exactly at the budget passes: the gate compares nt * 2 KB against it
    nt = PT.build_adj_tiles_host(src[:10], dst[:10], rows=4096, cols=4096, keys2d=keys).nt
    PT.build_adj_tiles_device(src[:10], dst[:10], rows=4096, cols=4096, keys2d=keys,
                              budget_bytes=nt * PT.TILE_BYTES)


@needs_native
def test_relay_layout_and_occupancy_match_reference():
    g = P.rmat_graph(8, 8, seed=7)
    rg = P.build_relay_graph(g)
    jat = JT.build_adj_tiles_from_relay(j_relay.build_relay_graph(_jgraph(g)), builder="host")
    for builder in ("device", "host"):
        at = PT.build_adj_tiles_from_relay(rg, builder=builder)
        assert_same_layout(at, jat)
    assert PT.tile_occupancy_hist(at) == JT.tile_occupancy_hist(jat)
    assert at.vtp // PT.SB_VERTS == JT.num_superblocks(jat)
    with pytest.raises(ValueError, match="builder"):
        PT.build_adj_tiles_from_relay(rg, builder="gpu")


def test_occupancy_hist_matches_reference_on_dense_tiles():
    """Every bucket, up to full 16384-bit tiles."""
    rng = np.random.default_rng(11)
    src, dst = [], []
    for i, fill in enumerate((1, 20, 100, 600, 3000, 9000, 16384)):
        cells = rng.choice(128 * 128, fill, replace=False)
        src.append(cells // 128)
        dst.append(i * 128 + cells % 128)
    src, dst = np.concatenate(src), np.concatenate(dst)
    jat = JT.build_adj_tiles_host(src, dst, rows=128, cols=7 * 128,
                                  keys2d=JT.keys_from_new2old(np.arange(128), 128))
    at = PT.build_adj_tiles_device(src, dst, rows=128, cols=7 * 128,
                                   keys2d=PT.keys_from_new2old(np.arange(128), 128))
    assert_same_layout(at, jat)
    hist = PT.tile_occupancy_hist(at)
    assert hist == JT.tile_occupancy_hist(jat)
    assert all(v > 0 for v in hist["buckets"].values())


# --------------------------------------------------------------- expansion --

def _fwords(rng, rows: int, fr: float):
    fbits = rng.random(rows) < fr
    fw = np.zeros(PT.round_up(rows, 32) // 32, np.uint32)
    for u in np.flatnonzero(fbits):
        fw[u >> 5] |= np.uint32(1) << np.uint32(u & 31)
    return fbits, fw


@pytest.mark.parametrize("rows,cols,e,fr", [
    (200, 200, 900, 0.4), (4000, 300, 2500, 0.02), (500, 9000, 3000, 0.9),
])
def test_plain_expansion_matches_reference(rows, cols, e, fr):
    import jax.numpy as jnp

    rng = np.random.default_rng(e)
    src = rng.integers(0, rows, e)
    dst = rng.integers(0, cols, e)
    n2o = rng.permutation(rows).astype(np.int64)
    jat = JT.build_adj_tiles_host(src, dst, rows=rows, cols=cols,
                                  keys2d=JT.keys_from_new2old(n2o, rows))
    fbits, fw = _fwords(rng, rows, fr)
    kw = dict(rows=rows, cols=cols, rtp=jat.rtp, vtp=jat.vtp)
    jops = JM.mxu_device_operands(jat)
    twin = np.asarray(JM.expand_frontier_mxu_xla(jnp.asarray(fw), jops, **kw))
    kern = np.asarray(JM.expand_frontier_mxu(jnp.asarray(fw), jops, interpret=True, **kw))

    at = PT.build_adj_tiles_device(src, dst, rows=rows, cols=cols,
                                   keys2d=PT.keys_from_new2old(n2o, rows))
    ops = PM.mxu_device_operands(at, "cpu")
    fwt = torch.from_numpy(fw.view(np.int32))
    got = PM.expand_frontier_mxu_plain(fwt, ops, **kw)
    assert got.dtype == torch.int32 and got.shape == (cols,)
    for want in (twin, kern):
        assert got.numpy().view(np.uint32).tobytes() == want.tobytes()
    # chunking is order-free; the wrapper takes the plain version on the CPU
    small = PM.expand_frontier_mxu_plain(fwt, ops, chunk=7, **kw)
    assert torch.equal(small, got)
    assert torch.equal(K.expand_frontier_mxu(fwt, ops, **kw), got)
    # brute force: the min original id over frontier in-neighbours
    ref = np.full(cols, 0xFFFFFFFF, np.uint64)
    for u, v in zip(src, dst):
        if fbits[u]:
            ref[v] = min(ref[v], int(n2o[u]))
    np.testing.assert_array_equal(got.numpy().view(np.uint32).astype(np.uint64), ref)


def test_empty_frontier_and_empty_layout():
    keys = PT.keys_from_new2old(np.arange(300), 300)
    for e in (0, 500):
        _, src, dst = _edges(300, 300, e, 3)
        at = PT.build_adj_tiles_device(src, dst, rows=300, cols=300, keys2d=keys)
        ops = PM.mxu_device_operands(at, "cpu")
        kw = dict(rows=300, cols=300, rtp=at.rtp, vtp=at.vtp)
        zero = torch.zeros(PT.round_up(300, 32) // 32, dtype=torch.int32)
        assert (PM.expand_frontier_mxu_plain(zero, ops, **kw) == -1).all()
        full = torch.full_like(zero, -1)
        got = PM.expand_frontier_mxu_plain(full, ops, **kw)
        assert (got == -1).all() == (e == 0)


def test_wrapper_device_rules(monkeypatch):
    """A CPU call never builds the library; a device mix raises."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor must not build the kernels")

    monkeypatch.setattr(cuda_build, "load", refuse)
    monkeypatch.setattr(cuda_build, "build", refuse)
    _, src, dst = _edges(256, 256, 400, 9)
    at = PT.build_adj_tiles_device(src, dst, rows=256, cols=256,
                                   keys2d=PT.keys_from_new2old(np.arange(256), 256))
    ops = PM.mxu_device_operands(at, "cpu")
    kw = dict(rows=256, cols=256, rtp=at.rtp, vtp=at.vtp)
    fw = torch.full((8,), -1, dtype=torch.int32)
    K.expand_frontier_mxu(fw, ops, **kw)
    with pytest.raises(ValueError):
        K.expand_frontier_mxu(fw.to("meta"), ops, **kw)


def test_packed_parent_matches_reference():
    words = np.array([0, 5, (3 << 26) | 12345, 0xFFFFFFFF, (62 << 26) | ((1 << 26) - 1)],
                     dtype=np.uint32)
    got = p_packed.packed_parent(torch.from_numpy(words.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_packed.packed_parent(words)))
    for v in (1, 1 << 26, (1 << 26) + 1):
        assert p_packed.packed_parent_fits(v) == j_packed.packed_parent_fits(v)


# ------------------------------------------------------------------ engine --

GRAPHS = {
    "rmat": (lambda: P.rmat_graph(8, 8, seed=7), (0, 3, 17)),
    "star": (_star, (0, 3)),
    "gnm": (lambda: P.gnm_graph(1 << 10, 3 << 10, seed=5), (3, 500)),
    "path70": (lambda: P.path_graph(70), (0,)),
}


@needs_native
@pytest.mark.parametrize("name", list(GRAPHS))
def test_mxu_engine_matches_reference_and_gather(name):
    make, roots = GRAPHS[name]
    g = make()
    ours = P.RelayEngine(g, device="cpu", expansion="mxu")
    gather = P.RelayEngine(g, device="cpu", expansion="gather")
    ref = JRelayEngine(_jgraph(g), expansion="mxu")
    assert ours.expansion == "mxu" and ours.adj_tiles is not None
    assert ref.expansion == "mxu"
    assert_same_layout(ours.adj_tiles, ref.adj_tiles)
    for s in roots:
        got = ours.run(s)
        assert_same(got, ref.run(s))
        assert_same(got, gather.run(s))
        assert P.check(g, got.dist, got.parent, s) == []
    if name == "path70":
        assert got.num_levels == 70  # past the packed cap: the unpacked re-run


@needs_native
def test_mxu_unpacked_carry_when_ids_overflow_the_parent_field(monkeypatch):
    """Forced mxu with V past 2^26 drops to the unpacked carry (faked
    here: the fixture is small)."""
    g = P.rmat_graph(8, 8, seed=7)
    monkeypatch.setattr(p_bfs, "packed_parent_fits", lambda v: False)
    eng = P.RelayEngine(g, device="cpu", expansion="mxu")
    assert not eng.packed and eng.expansion == "mxu"
    assert P.RelayEngine(g, device="cpu", expansion="gather").packed
    assert_same(eng.run(3), JRelayEngine(_jgraph(g), expansion="mxu").run(3))


@needs_native
def test_mxu_multi_source_matches_reference():
    g = P.rmat_graph(8, 8, seed=7)
    sources = [0, 3, 9, 17]
    ours = P.RelayEngine(g, device="cpu", expansion="mxu")
    want = JRelayEngine(_jgraph(g), expansion="mxu").run_multi(sources)
    for got in (ours.run_multi(sources),
                P.RelayEngine(g, device="cpu").run_multi(sources)):
        np.testing.assert_array_equal(got.dist, np.asarray(want.dist))
        np.testing.assert_array_equal(got.parent, np.asarray(want.parent))
        assert got.num_levels == want.num_levels
    # the element-major batch stays on the gather formulation
    batch = np.arange(32, dtype=np.int32) * 7
    a = ours.run_multi_elem(batch)
    b = P.RelayEngine(g, device="cpu").run_multi_elem(batch)
    np.testing.assert_array_equal(a.dist, b.dist)
    np.testing.assert_array_equal(a.parent, b.parent)


@needs_native
def test_mxu_engine_budget_refusal(monkeypatch):
    g = P.rmat_graph(8, 8, seed=7)
    with pytest.raises(ValueError, match="budget"):
        P.RelayEngine(g, device="cpu", expansion="mxu", tiles_budget_bytes=4096)
    monkeypatch.setattr(PM, "DEFAULT_TILES_BUDGET_BYTES", 4096)
    with pytest.raises(ValueError, match="budget"):
        P.RelayEngine(g, device="cpu", expansion="mxu")
    # the explicit argument wins over the default
    eng = P.RelayEngine(g, device="cpu", expansion="mxu", tiles_budget_bytes=1 << 30)
    assert eng.adj_tiles.nt > 0


# ------------------------------------------------------------ arm choice --

def test_resolve_expansion_and_refusals():
    # auto is the default, as the reference's (BFS_TPU_EXPANSION)
    assert PM.resolve_expansion() == P.resolve_expansion() == JM.resolve_expansion() == "auto"
    for mode in PM.EXPANSION_MODES:
        assert PM.resolve_expansion(mode) == mode
    for bad in ("tensor", "", "Auto"):
        with pytest.raises(ValueError, match="expansion"):
            PM.resolve_expansion(bad)


@needs_native
def test_mxu_engine_tiles_equal_the_host_oracle():
    g = P.rmat_graph(7, 4, seed=3)
    eng = P.RelayEngine(g, device="cpu", expansion="mxu")
    assert eng.expansion == "mxu" and eng.expansion_basis == "requested"
    host = PT.build_adj_tiles_from_relay(eng.relay_graph, builder="host")
    for f in FIELDS:
        assert torch.equal(getattr(eng.adj_tiles, f), getattr(host, f)), f
    assert_same(eng.run(1), P.RelayEngine(g, device="cpu", expansion="gather").run(1))
    auto = P.RelayEngine(g, device="cpu", expansion="auto")  # valid now; the CPU gate
    assert auto.expansion == "gather" and auto.adj_tiles is None
    with pytest.raises(ValueError, match="expansion"):
        P.RelayEngine(g, device="cpu", expansion="tensor")


@needs_native
def test_default_expansion_is_gather():
    g = P.rmat_graph(8, 8, seed=7)
    eng = P.RelayEngine(g, device="cpu")
    assert eng.expansion == "gather" and eng.adj_tiles is None
    assert eng.expansion_requested == "auto"
    assert eng.expansion_basis.startswith("auto -> gather: cpu device")
    ref = JRelayEngine(_jgraph(g), expansion="auto")  # off a TPU: gather too
    assert ref.expansion == "gather" and ref.adj_tiles is None
    assert_same(eng.run(3), ref.run(3))
