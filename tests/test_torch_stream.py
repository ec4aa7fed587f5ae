"""The streamed MXU arm of the port (``bfs_tpu_torch.stream``) against the
reference's (``bfs_tpu.stream``) on the CPU.

On the reference test's fixtures (``tests/test_stream.py``): a star, a path
deeper than the packed carry's 62 levels, G(n, m) at 2^10, an R-MAT, and
the 2^15-vertex G(n, m) whose 16384-vertex column superblocks let a cache
evict.  Held bit for bit: the tile layout's ``sb_indptr``, the tiles
bundle's key and arrays (a bundle of either package loads in the other),
the host store's slabs, bytes, row blocks and fingerprints, the demand set
along a search (and against the kernel's per-tile early-out), the cache's
counters over one sequence of gets, the plain per-superblock expansion
against the reference's superblock program, and ``run_streamed`` under
forced eviction: ``dist``/``parent``/``num_levels``, the direction schedule
and every ledger row.  Then the cache's pathologies, epochs that cross
between streamed and segmented runs of both packages, the knobs and
routing, and the command-line runner's ``--config stream``.  Inputs come
from seeded generators; every comparison is exact."""

import json

import numpy as np
import pytest
import torch

import bfs_tpu_torch as P
from bfs_tpu_torch import knobs
from bfs_tpu_torch.cache.layout import LayoutCache, load_or_build_tiles, tiles_key
from bfs_tpu_torch.graph import adj_tiles as PT
from bfs_tpu_torch.ops import relay_cuda as K
from bfs_tpu_torch.ops import relay_mxu as PM
from bfs_tpu_torch.resilience import faults as F
from bfs_tpu_torch.resilience.faults import FaultInjected
from bfs_tpu_torch.resilience.superstep_ckpt import CkptConfig, SuperstepCheckpointer, _runner_main
from bfs_tpu_torch.stream import HostTileStore, SuperblockCache, demand_set, iter_prefetched
from bfs_tpu_torch.stream.cache import stream_verify_enabled
from bfs_tpu_torch.stream.store import superblock_fingerprint

from bfs_tpu.cache import layout as JL
from bfs_tpu.graph import adj_tiles as JT
from bfs_tpu.graph import benes as j_benes
from bfs_tpu.graph.csr import Graph as JGraph
from bfs_tpu.models.bfs import RelayEngine as JRelay
from bfs_tpu.resilience import superstep_ckpt as JS
from bfs_tpu.stream import HostTileStore as JStore
from bfs_tpu.stream import SuperblockCache as JCache
from bfs_tpu.stream import demand_set as j_demand_set

pytestmark = pytest.mark.skipif(
    not j_benes.native_available(), reason="native benes router unavailable"
)

SOURCE = 3


def _star(n: int = 256) -> P.Graph:
    leaves = np.arange(1, n, dtype=np.int32)
    return P.Graph.from_undirected_edges(n, np.stack([np.zeros(n - 1, np.int32), leaves], axis=1))


MAKERS = {
    "star": _star,
    "path300": lambda: P.path_graph(300),
    "gnm": lambda: P.gnm_graph(1 << 10, 3 << 10, seed=5),
    "rmat": lambda: P.rmat_graph(8, 8, seed=7),
}


def _jgraph(g) -> JGraph:
    return JGraph(g.num_vertices, np.asarray(g.src).copy(), np.asarray(g.dst).copy())


def _same(a, b) -> None:
    np.testing.assert_array_equal(a.dist, np.asarray(b.dist))
    np.testing.assert_array_equal(a.parent, np.asarray(b.parent))
    assert a.num_levels == b.num_levels


def _slab_np(slab):
    tiles, row_idx, col_local = (np.asarray(t) for t in slab)
    return tiles.view(np.uint32), row_idx, col_local


def _max_budget(store) -> int:
    return max(store.sb_bytes(g) for g in range(store.num_superblocks))


@pytest.fixture(scope="module")
def gnm():
    return MAKERS["gnm"]()


@pytest.fixture(scope="module")
def big_gnm():
    """Over 16384 vertices: several column superblocks (the eviction shape)."""
    return P.gnm_graph(1 << 15, 1 << 17, seed=11)


@pytest.fixture(scope="module")
def big(big_gnm):
    """The port's streamed and resident MXU engines and the reference's
    streamed engine on one graph, built once (the expensive part)."""
    stream = P.RelayEngine(big_gnm, device="cpu", expansion="mxu", direction="auto",
                           tiles_mode="stream")
    resident = P.RelayEngine(stream.relay_graph, device="cpu", expansion="mxu", direction="auto")
    ref = JRelay(_jgraph(big_gnm), expansion="mxu", direction="auto", tiles_mode="stream")
    return stream, resident, ref


@pytest.fixture(scope="module")
def big_runs(big):
    """``run_streamed`` with telemetry under a budget of one largest
    superblock, on both packages, and the port's resident run: (port
    result, curve, ledger, reference result, curve, ledger, resident
    result)."""
    stream, resident, ref = big
    budget = _max_budget(stream.stream_store)
    res, curve = stream.run_streamed(SOURCE, telemetry=True, cache_budget_bytes=budget)
    ledger = stream.stream_report
    jres, jcurve = ref.run_streamed(SOURCE, telemetry=True, cache_budget_bytes=budget)
    return res, curve, ledger, jres, jcurve, ref.stream_report, resident.run(SOURCE)


# ------------------------------------------------------- the layout's index --

@pytest.mark.parametrize("name", list(MAKERS))
def test_sb_indptr_and_helpers_match_the_reference(name):
    g = MAKERS[name]()
    rg = P.build_relay_graph(g)
    jat = JT.build_adj_tiles_from_relay(JRelay(_jgraph(g), expansion="mxu").relay_graph,
                                        builder="host")
    for builder in ("device", "host"):
        at = PT.build_adj_tiles_from_relay(rg, builder=builder)
        assert at.sb_indptr.numpy().tobytes() == jat.sb_indptr.tobytes()
        assert at.nbytes == jat.nbytes
        assert PT.num_superblocks(at) == JT.num_superblocks(jat)
        for sb in range(PT.num_superblocks(at)):
            assert PT.sb_span(at, sb) == JT.sb_span(jat, sb)
            np.testing.assert_array_equal(PT.sb_row_blocks(at, sb), JT.sb_row_blocks(jat, sb))


def test_tiles_builder_knob(monkeypatch):
    monkeypatch.delenv("BFS_TPU_TORCH_TILES_BUILD", raising=False)
    assert PT.resolve_tiles_builder() == "device"
    monkeypatch.setenv("BFS_TPU_TORCH_TILES_BUILD", "host")
    assert PT.resolve_tiles_builder() == "host"
    assert PT.resolve_tiles_builder("device") == "device"  # the argument wins
    monkeypatch.setenv("BFS_TPU_TORCH_TILES_BUILD", "gpu")
    with pytest.raises(ValueError):
        PT.resolve_tiles_builder()


# ----------------------------------------------------------- the tiles bundle --

def test_tiles_bundle_key_and_arrays_equal_the_reference(gnm):
    rg = P.build_relay_graph(gnm)
    jrg = JRelay(_jgraph(gnm)).relay_graph
    assert tiles_key(rg) == JL.tiles_key(jrg)
    at, info = load_or_build_tiles(rg)
    assert info["cache"] == "disabled" and info["builder"] == "device"
    ours = PT.tiles_to_arrays(at)
    want = JT.tiles_to_arrays(JT.build_adj_tiles_from_relay(jrg, builder="host"))
    assert sorted(ours) == sorted(want)
    for k in want:
        assert ours[k].dtype == want[k].dtype and ours[k].tobytes() == want[k].tobytes(), k
    back = PT.tiles_from_arrays(ours)
    for f in ("tiles", "row_idx", "col_id", "sb_indptr", "keys2d"):
        assert torch.equal(getattr(back, f), getattr(at, f)), f


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_tiles_bundle_loads_across_packages(gnm, tmp_path, writer):
    rg = P.build_relay_graph(gnm)
    jrg = JRelay(_jgraph(gnm)).relay_graph
    if writer == "port":
        _, info = load_or_build_tiles(rg, cache=LayoutCache(str(tmp_path)))
        assert info["cache"] == "miss"
        jat, jinfo = JL.load_or_build_tiles(jrg, cache=JL.LayoutCache(str(tmp_path)))
        assert jinfo["cache"] == "hit"
        want = JT.tiles_to_arrays(jat)
        at = PT.build_adj_tiles_from_relay(rg)
    else:
        jat, jinfo = JL.load_or_build_tiles(jrg, cache=JL.LayoutCache(str(tmp_path)))
        assert jinfo["cache"] == "miss"
        at, info = load_or_build_tiles(rg, cache=LayoutCache(str(tmp_path)))
        assert info["cache"] == "hit"
        want = JT.tiles_to_arrays(jat)
    got = PT.tiles_to_arrays(at)
    for k in want:
        assert got[k].tobytes() == np.asarray(want[k]).tobytes(), k


def test_tiles_cache_knob_and_warm_budget(gnm, tmp_path, monkeypatch):
    rg = P.build_relay_graph(gnm)
    monkeypatch.setenv("BFS_TPU_TORCH_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("BFS_TPU_TORCH_TILES_CACHE", raising=False)
    assert load_or_build_tiles(rg)[1]["cache"] == "disabled"
    monkeypatch.setenv("BFS_TPU_TORCH_TILES_CACHE", "1")
    assert load_or_build_tiles(rg, builder="host")[1]["cache"] == "miss"
    at, info = load_or_build_tiles(rg)
    assert info["cache"] == "hit" and info["builder"] == "host"  # the build's, replayed
    with pytest.raises(ValueError, match="budget"):
        load_or_build_tiles(rg, budget_bytes=at.nbytes - 1)  # a warm hit is gated too


# ---------------------------------------------------------------- the store --

@pytest.mark.parametrize("name", list(MAKERS))
def test_store_equals_the_reference(name):
    g = MAKERS[name]()
    eng = P.RelayEngine(g, device="cpu", expansion="mxu", tiles_mode="stream")
    jstore = JStore(JRelay(_jgraph(g), expansion="mxu").adj_tiles)
    store = eng.stream_store
    assert eng.adj_tiles is None and eng.mxu_operands is None  # no resident tiles
    assert not store.pinned
    assert store.report() == jstore.report() and store.nbytes == jstore.nbytes
    for sb in range(store.num_superblocks):
        assert (store.real_tiles(sb), store.pad_tiles(sb), store.sb_bytes(sb)) == (
            jstore.real_tiles(sb), jstore.pad_tiles(sb), jstore.sb_bytes(sb))
        np.testing.assert_array_equal(store.row_blocks(sb), jstore.row_blocks(sb))
        assert store.fingerprint(sb) == jstore.fingerprint(sb)
        for ours, want in zip(_slab_np(store.fetch(sb)), jstore.fetch(sb)):
            assert ours.dtype == want.dtype and ours.tobytes() == want.tobytes()
    tiles, row_idx, col_local = store.fetch(0)
    assert superblock_fingerprint(tiles, row_idx, col_local) == store.fingerprint(0)
    bad = tiles.clone()
    bad[0, 0, 0] ^= 1
    assert superblock_fingerprint(bad, row_idx, col_local) != store.fingerprint(0)


# ------------------------------------------------------------ the demand set --

def _early_out_demand(at, fwords) -> np.ndarray:
    """The kernel's own per-tile test, taken from the port's ``live_tiles``:
    the superblocks of the live real tiles."""
    ops = PM.mxu_device_operands(at, "cpu")
    live = PM.live_tiles(torch.from_numpy(fwords.view(np.int32)), ops, rows=at.rows, rtp=at.rtp)
    live = live[live < at.nt]
    return np.unique((at.col_id[live] // PT.SB_TILES).numpy()).astype(np.int32)


@pytest.mark.parametrize("name", list(MAKERS))
def test_demand_set_equals_the_reference_and_the_early_out(name):
    g = MAKERS[name]()
    at = PT.build_adj_tiles_from_relay(P.build_relay_graph(g))
    store = HostTileStore(at)
    jstore = JStore(JRelay(_jgraph(g), expansion="mxu").adj_tiles)
    rng = np.random.default_rng(3)
    nwords = -(-at.rows // 32)
    cases = [np.zeros(nwords, np.uint32), np.zeros(nwords, np.uint32),
             rng.integers(0, 1 << 32, nwords, dtype=np.uint32),
             (rng.integers(0, 1 << 32, nwords, dtype=np.uint32)
              * (rng.random(nwords) < 0.1)).astype(np.uint32)]
    cases[1][0] = 1
    # and every frontier of a search
    eng = P.RelayEngine(g, device="cpu", expansion="mxu", sparse_hybrid=False)
    st = eng.init_packed_state(SOURCE)
    while bool(st.changed):
        cases.append(st.fwords.numpy().view(np.uint32).copy())
        st = eng.superstep_packed(st)
    for fwords in cases:
        got = demand_set(store, fwords)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, j_demand_set(jstore, fwords))
        np.testing.assert_array_equal(got, _early_out_demand(at, fwords))
        assert all(store.real_tiles(int(sb)) > 0 for sb in got)


# ---------------------------------------------------------------- the cache --

def test_cache_counters_equal_the_reference(big):
    stream, _, ref = big
    store = stream.stream_store
    jstore = JStore(ref.adj_tiles)
    assert store.num_superblocks >= 2, "the eviction shape needs two superblocks"
    rng = np.random.default_rng(7)
    gets = rng.integers(0, store.num_superblocks, 24).tolist()
    for budget in (_max_budget(store), 2 * _max_budget(store), 1):
        cache, jcache = SuperblockCache(store, budget_bytes=budget), JCache(jstore, budget_bytes=budget)
        for sb in gets:
            cache.get(sb)
            jcache.get(sb)
            assert cache.counters() == jcache.counters()
            assert cache.resident_bytes() == jcache.resident_bytes()
        assert cache.report() == jcache.report()


def test_cache_eviction_under_one_superblock_budget(big):
    store = big[0].stream_store
    budget = _max_budget(store)
    cache = SuperblockCache(store, budget_bytes=budget)
    demanded = [sb for sb in range(store.num_superblocks) if store.real_tiles(sb)]
    for _ in range(2):
        for sb in demanded:
            cache.get(sb)
    assert cache.misses >= len(demanded) and cache.evictions > 0
    assert cache.resident_bytes() <= budget
    assert cache.bytes_streamed >= sum(store.sb_bytes(sb) for sb in demanded)
    assert cache.report()["evictions"] == cache.evictions


def test_cache_oversized_allowance_and_hits(gnm):
    store = P.RelayEngine(gnm, device="cpu", expansion="mxu", tiles_mode="stream").stream_store
    cache = SuperblockCache(store, budget_bytes=1)  # smaller than any slab
    slab = cache.get(0)
    assert cache.resident_bytes() == store.sb_bytes(0)  # in alone
    assert cache.get(0) is slab and cache.hits == 1
    cache = SuperblockCache(store, budget_bytes=1 << 30)
    a = cache.get(0)
    assert cache.get(0) is a and (cache.hits, cache.misses) == (1, 1)
    assert cache.bytes_streamed == store.sb_bytes(0)
    assert a[0] is not store.fetch(0)[0]  # an upload, not the host slab
    for ours, host in zip(a, store.fetch(0)):
        assert torch.equal(ours, host)


def test_corrupt_superblock_fetched_again(gnm, monkeypatch):
    from bfs_tpu_torch.obs.registry import get_registry

    store = P.RelayEngine(gnm, device="cpu", expansion="mxu", tiles_mode="stream").stream_store
    monkeypatch.setenv("BFS_TPU_TORCH_STREAM_VERIFY", "1")
    cache = SuperblockCache(store, budget_bytes=1 << 30)
    assert cache.verify
    slab = cache.get(0)
    before = get_registry().count("superblock_corrupt_refetches")
    slab[0][0, 0, 0] ^= 1  # one flipped bit on the device
    fresh = cache.get(0)
    assert cache.corrupt_refetches == 1 and cache.misses == 2
    assert get_registry().count("superblock_corrupt_refetches") == before + 1
    assert torch.equal(fresh[0], store.fetch(0)[0])  # the host's bytes again
    cache.get(0)  # a clean verified hit
    assert cache.corrupt_refetches == 1 and cache.hits == 1


def test_stream_verify_knob(monkeypatch):
    monkeypatch.delenv("BFS_TPU_TORCH_STREAM_VERIFY", raising=False)
    assert stream_verify_enabled() is False
    monkeypatch.setenv("BFS_TPU_TORCH_STREAM_VERIFY", "1")
    assert stream_verify_enabled() is True
    assert stream_verify_enabled(False) is False  # the argument wins
    monkeypatch.setenv("BFS_TPU_TORCH_STREAM_VERIFY", "yes")
    with pytest.raises(ValueError):
        stream_verify_enabled()


def test_evictions_reach_the_registry_and_spans(big):
    from bfs_tpu_torch.obs.registry import get_registry
    from bfs_tpu_torch.obs.spans import snapshot_events

    store = big[0].stream_store
    before = get_registry().count("superblock_evictions")
    cache = SuperblockCache(store, budget_bytes=_max_budget(store))
    for sb in (0, 1, 0):
        cache.get(sb)
    assert cache.evictions == 2
    assert get_registry().count("superblock_evictions") == before + 2
    marks = [e for e in snapshot_events() if e.get("name") == "stream.evict"]
    assert marks and marks[-1]["args"]["bytes"] == store.sb_bytes(1)


def test_iter_prefetched_order_and_lookahead(gnm):
    store = P.RelayEngine(gnm, device="cpu", expansion="mxu", tiles_mode="stream").stream_store
    cache = SuperblockCache(store, budget_bytes=1 << 30)
    demand = np.asarray([sb for sb in range(store.num_superblocks) if store.real_tiles(sb)],
                        np.int32)
    seen = []
    for sb, _slab in iter_prefetched(cache, np.concatenate([demand, demand])):
        seen.append((sb, cache.misses + cache.hits))
    # each slab is handed out after the next one was asked for
    assert [sb for sb, _ in seen] == [int(x) for x in np.concatenate([demand, demand])]
    assert [n for _, n in seen[:-1]] == list(range(2, len(seen) + 1))
    assert list(iter_prefetched(cache, np.asarray([], np.int32))) == []


# ---------------------------------------------- the per-superblock expansion --

def test_superblock_expansion_equals_the_reference_program(big):
    """Every superblock through the plain per-superblock expansion and the
    wrapper's ``out=`` on the CPU, against the reference's superblock
    program; the assembled grid against the whole-layout plain expansion."""
    from bfs_tpu.stream.runner import (
        _cand_init_program,
        _frontier_blocks_program,
        _sb_expand_program,
    )

    stream, resident, ref = big
    import jax.numpy as jnp

    store, jstore = stream.stream_store, JStore(ref.adj_tiles)
    rows, cols, rtp, vtp, _ = stream.mxu_geometry
    keys2d = store.keys2d
    rng = np.random.default_rng(5)
    nwords = rows // 32
    for density in (0.02, 0.5):
        fw = (rng.integers(0, 1 << 32, nwords, dtype=np.uint32)
              * (rng.random(nwords) < density)).astype(np.uint32)
        fwt = torch.from_numpy(fw.view(np.int32).copy())
        grid = torch.full((vtp,), -1, dtype=torch.int32)
        wrapped = torch.full((vtp,), -1, dtype=torch.int32)
        jgrid = _cand_init_program(vtp)()
        fwp4 = _frontier_blocks_program(rows, rtp)(jnp.asarray(fw))
        for sb in range(store.num_superblocks):
            view = PM.expand_superblock_plain(fwt, store.fetch(sb), keys2d, sb, grid, rows=rows,
                                              rtp=rtp)
            assert view.data_ptr() == grid[sb * PT.SB_VERTS :].data_ptr()
            K.expand_frontier_mxu(fwt, (*store.fetch(sb), keys2d), rows=rows, cols=PT.SB_VERTS,
                                  rtp=rtp, vtp=PT.SB_VERTS,
                                  out=wrapped[sb * PT.SB_VERTS : (sb + 1) * PT.SB_VERTS])
            jgrid = _sb_expand_program(jstore.pad_tiles(sb))(
                jgrid, fwp4, jnp.asarray(jstore.keys2d), *map(jnp.asarray, jstore.fetch(sb)),
                jnp.int32(sb))
        np.testing.assert_array_equal(grid.numpy().view(np.uint32), np.asarray(jgrid).reshape(-1))
        assert torch.equal(wrapped, grid)
        want = PM.expand_frontier_mxu_plain(fwt, resident.mxu_operands, rows=rows, cols=cols,
                                            rtp=rtp, vtp=vtp)
        assert torch.equal(grid[:cols], want)


def test_out_merges_and_a_dead_superstep_writes_nothing(gnm):
    from bfs_tpu_torch.ops import control as C

    eng = P.RelayEngine(gnm, device="cpu", expansion="mxu")
    rows, cols, rtp, vtp, _ = eng.mxu_geometry
    fw = torch.full((rows // 32,), -1, dtype=torch.int32)
    want = PM.expand_frontier_mxu_plain(fw, eng.mxu_operands, rows=rows, cols=cols, rtp=rtp,
                                        vtp=vtp)
    out = torch.full((vtp,), -1, dtype=torch.int32)
    out[5] = 0  # an earlier, smaller candidate stays
    got = K.expand_frontier_mxu(fw, eng.mxu_operands, rows=rows, cols=cols, rtp=rtp, vtp=vtp,
                                out=out)
    assert got.data_ptr() == out.data_ptr() and int(got[5]) == 0
    assert torch.equal(torch.cat([got[:5], got[6:]]), torch.cat([want[:5], want[6:]]))
    dead = C.new_ctl("cpu")
    fresh = torch.full((vtp,), -1, dtype=torch.int32)
    K.expand_frontier_mxu(fw, eng.mxu_operands, rows=rows, cols=cols, rtp=rtp, vtp=vtp,
                          out=fresh, ctl=dead)
    assert (fresh == -1).all()


@pytest.mark.parametrize("rows,cols,e", [(200, 200, 900), (4000, 300, 2500), (64, 20000, 3000)])
def test_expand_into_plain_equals_the_plain_expansion(rows, cols, e):
    rng = np.random.default_rng(rows + cols)
    src, dst = rng.integers(0, rows, e), rng.integers(0, cols, e)
    at = PT.build_adj_tiles_host(src, dst, rows=rows, cols=cols,
                                 keys2d=PT.keys_from_new2old(rng.permutation(rows), rows))
    ops = PM.mxu_device_operands(at, "cpu")
    for density in (0.05, 1.0):
        fw = torch.from_numpy((rng.integers(0, 1 << 32, -(-rows // 32), dtype=np.uint32)
                               * (rng.random(-(-rows // 32)) < density)).astype(np.uint32)
                              .view(np.int32))
        want = PM.expand_frontier_mxu_plain(fw, ops, rows=rows, cols=cols, rtp=at.rtp, vtp=at.vtp)
        out = torch.full((at.vtp,), -1, dtype=torch.int32)
        PM.expand_into_plain(fw, ops, out, rows=rows, rtp=at.rtp, vtp=at.vtp)
        assert torch.equal(out[:cols], want)


# ---------------------------------------------------- run_streamed: parity --

def test_run_streamed_equals_the_reference_under_eviction(big, big_runs):
    """THE parity core: a budget of one largest superblock forces evictions
    and fetches mid-search; results, schedule and every ledger row are the
    reference's, and the resident arm's."""
    res, curve, ledger, jres, jcurve, jledger, want = big_runs
    _same(res, jres)
    _same(res, want)
    assert curve["direction_schedule"] == jcurve["direction_schedule"]
    assert curve["occupancy"] == jcurve["occupancy"]
    assert ledger == jledger
    assert ledger["evictions"] > 0 and ledger["bytes_streamed"] > 0
    rows = ledger["levels"]
    assert [r["arm"] for r in rows] == curve["direction_schedule"]["schedule"]
    assert sum(r["bytes_streamed"] for r in rows) == ledger["bytes_streamed"]
    assert all(r["bytes_streamed"] == r["demanded"] == 0 for r in rows if r["arm"] == "push")
    json.dumps(ledger)


def test_run_streamed_counts_and_routing(big, big_runs, monkeypatch):
    """``run`` on a stream engine takes the streamed path; on the CPU the
    wrapper's launches count nothing, but the pull levels expand exactly
    the demanded superblocks."""
    stream = big[0]
    calls = []
    real = K.expand_frontier_mxu

    def spy(*args, **kwargs):
        if kwargs.get("out") is not None:  # the resident arm's launches take none
            calls.append(kwargs["out"].data_ptr())
        return real(*args, **kwargs)

    monkeypatch.setattr(K, "expand_frontier_mxu", spy)
    res = stream.run(SOURCE)
    _same(res, big_runs[-1])
    rows = stream.stream_report["levels"]
    assert len(calls) == sum(r["demanded"] for r in rows if r["arm"] == "pull")
    assert stream.last_run["issued_pull"] == sum(r["arm"] == "pull" for r in rows)
    assert stream.last_run["issued"] == stream.last_run["live"] == res.num_levels


@pytest.mark.parametrize("name", list(MAKERS))
def test_streamed_equals_resident_and_reference_small_shapes(name):
    g = MAKERS[name]()
    resident = P.RelayEngine(g, device="cpu", expansion="mxu", direction="auto")
    streamed = P.RelayEngine(resident.relay_graph, device="cpu", expansion="mxu",
                             direction="auto", tiles_mode="stream")
    jeng = JRelay(_jgraph(g), expansion="mxu", direction="auto", tiles_mode="stream")
    got = streamed.run(SOURCE)
    _same(got, resident.run(SOURCE))
    _same(got, jeng.run(SOURCE))
    assert streamed.stream_report == jeng.stream_report
    if name == "path300":
        assert got.num_levels > 62  # past the packed cap: the unpacked re-run


@pytest.mark.parametrize("mode,hybrid", [("pull", True), ("push", True), ("auto", False)])
def test_streamed_schedules_match_the_reference(gnm, mode, hybrid):
    eng = P.RelayEngine(gnm, device="cpu", expansion="mxu", direction=mode, sparse_hybrid=hybrid,
                        tiles_mode="stream")
    jeng = JRelay(_jgraph(gnm), expansion="mxu", direction=mode, sparse_hybrid=hybrid,
                  tiles_mode="stream")
    res, curve = eng.run_streamed(SOURCE, telemetry=True)
    jres, jcurve = jeng.run_streamed(SOURCE, telemetry=True)
    _same(res, jres)
    assert curve["direction_schedule"] == jcurve["direction_schedule"]
    assert eng.stream_report == jeng.stream_report


# ------------------------------------------------------------- checkpoints --

def _mgr(path, k=1):
    return SuperstepCheckpointer(str(path), {"cfg": "stream-test"}, cfg=CkptConfig("every", k))


@pytest.fixture
def fault(monkeypatch):
    import contextlib

    @contextlib.contextmanager
    def setting(spec):
        monkeypatch.setenv("BFS_TPU_TORCH_FAULT", spec)
        F.reset()
        try:
            yield
        finally:
            monkeypatch.delenv("BFS_TPU_TORCH_FAULT")
            F.reset()

    return setting


def test_streamed_resume_with_a_cold_cache(gnm, tmp_path, fault):
    golden_eng = P.RelayEngine(gnm, device="cpu", expansion="mxu", direction="auto",
                               tiles_mode="stream")
    golden, golden_curve = golden_eng.run_streamed(SOURCE, telemetry=True)
    eng = P.RelayEngine(gnm, device="cpu", expansion="mxu", direction="auto", tiles_mode="stream")
    with fault("raise:superstep:2"):
        with pytest.raises(FaultInjected):
            eng.run_streamed(SOURCE, ckpt=_mgr(tmp_path), telemetry=True)
    resumed = P.RelayEngine(gnm, device="cpu", expansion="mxu", direction="auto",
                            tiles_mode="stream")
    mgr = _mgr(tmp_path)
    res, curve = resumed.run_streamed(SOURCE, ckpt=mgr, telemetry=True)
    assert mgr.resumed_from_epoch == 2
    _same(res, golden)
    assert curve["direction_schedule"] == golden_curve["direction_schedule"]
    assert curve["occupancy"] == golden_curve["occupancy"]
    assert [r["level"] for r in resumed.stream_report["levels"]] == list(
        range(3, golden.num_levels + 1))
    assert mgr.epochs() == []  # cleared at the end


@pytest.mark.parametrize("writer", ["segmented", "streamed"])
def test_streamed_and_segmented_epochs_interchange(gnm, tmp_path, fault, writer):
    resident = P.RelayEngine(gnm, device="cpu", expansion="mxu", direction="auto")
    streamed = P.RelayEngine(resident.relay_graph, device="cpu", expansion="mxu",
                             direction="auto", tiles_mode="stream")
    golden, golden_curve = resident.run_segmented(SOURCE, ckpt=_mgr(tmp_path / "g"),
                                                  telemetry=True)
    first, then = (resident, streamed) if writer == "segmented" else (streamed, resident)
    with fault("raise:superstep:2"):
        with pytest.raises(FaultInjected):
            first.run_segmented(SOURCE, ckpt=_mgr(tmp_path), telemetry=True)
    mgr = _mgr(tmp_path)
    res, curve = then.run_segmented(SOURCE, ckpt=mgr, telemetry=True)
    assert mgr.resumed_from_epoch == 2 and mgr.report()["fresh_fallbacks"] == 0
    _same(res, golden)
    assert curve["direction_schedule"] == golden_curve["direction_schedule"]


def test_reference_epoch_resumes_streamed(gnm, tmp_path):
    """An epoch of the reference's streamed run (``mu``/``prev``) resumes
    in the port's streamed run through the engine's restore rule."""
    from bfs_tpu.resilience import faults as JF
    from bfs_tpu.resilience.faults import FaultInjected as JFault

    jeng = JRelay(_jgraph(gnm), expansion="mxu", direction="auto", tiles_mode="stream")
    jmgr = JS.SuperstepCheckpointer(str(tmp_path), {"cfg": "stream-test"},
                                    cfg=JS.CkptConfig("every", 1))
    import os

    os.environ["BFS_TPU_FAULT"] = "raise:superstep:2"
    JF.reset()
    try:
        with pytest.raises(JFault):
            jeng.run_streamed(SOURCE, ckpt=jmgr, telemetry=True)
    finally:
        os.environ.pop("BFS_TPU_FAULT", None)
        JF.reset()
    want, want_curve = JRelay(_jgraph(gnm), expansion="mxu", direction="auto",
                              tiles_mode="stream").run_streamed(SOURCE, telemetry=True)
    eng = P.RelayEngine(gnm, device="cpu", expansion="mxu", direction="auto", tiles_mode="stream")
    mgr = _mgr(tmp_path)
    res, curve = eng.run_streamed(SOURCE, ckpt=mgr, telemetry=True)
    assert mgr.resumed_from_epoch == 2
    _same(res, want)
    assert curve["direction_schedule"] == want_curve["direction_schedule"]


# ------------------------------------------------------- knobs and routing --

def test_tiles_mode_and_cache_budget_knobs(monkeypatch):
    from bfs_tpu.ops import relay_mxu as JM

    monkeypatch.delenv("BFS_TPU_TORCH_TILES", raising=False)
    assert PM.resolve_tiles_mode() == "resident" == JM.resolve_tiles_mode()
    assert PM.TILES_MODES == JM.TILES_MODES
    monkeypatch.setenv("BFS_TPU_TORCH_TILES", "stream")
    assert PM.resolve_tiles_mode() == "stream"
    assert PM.resolve_tiles_mode("auto") == "auto"  # the argument wins
    monkeypatch.setenv("BFS_TPU_TORCH_TILES", "paged")
    with pytest.raises(ValueError):
        PM.resolve_tiles_mode()
    with pytest.raises(ValueError, match="tiles mode"):
        PM.resolve_tiles_mode("paged")
    monkeypatch.delenv("BFS_TPU_TORCH_STREAM_CACHE_GB", raising=False)
    assert PM.stream_cache_budget_bytes() == 1 << 30 == JM.stream_cache_budget_bytes()
    monkeypatch.setenv("BFS_TPU_TORCH_STREAM_CACHE_GB", "0.5")
    assert PM.stream_cache_budget_bytes() == (1 << 30) // 2
    monkeypatch.setenv("BFS_TPU_TORCH_STREAM_CACHE_GB", "0")
    with pytest.raises(ValueError):
        PM.stream_cache_budget_bytes()
    assert knobs.get("BFS_TPU_TORCH_TILES_CACHE") is False


def test_engine_takes_the_knob(gnm, monkeypatch):
    monkeypatch.setenv("BFS_TPU_TORCH_TILES", "stream")
    eng = P.RelayEngine(gnm, device="cpu", expansion="mxu")
    assert eng.tiles_mode == "stream" and eng._stream_effective() and eng.adj_tiles is None
    with pytest.raises(RuntimeError, match="run_streamed"):
        eng.run_level_curve(SOURCE)  # the dense body needs resident tiles
    _same(eng.run(SOURCE), P.RelayEngine(gnm, device="cpu", expansion="mxu",
                                         tiles_mode="resident").run(SOURCE))


def test_stream_needs_the_mxu_arm(gnm):
    eng = P.RelayEngine(gnm, device="cpu", expansion="gather", tiles_mode="stream")
    assert not eng._stream_effective()  # a gather engine stays resident
    with pytest.raises(ValueError, match="mxu"):
        eng.run_streamed(SOURCE)
    jeng = JRelay(_jgraph(gnm), expansion="gather", tiles_mode="stream")
    assert not jeng._stream_effective()
    _same(eng.run(SOURCE), jeng.run(SOURCE))


def test_auto_streams_only_over_the_budget(gnm, monkeypatch):
    def budget(gb: str) -> None:  # the port's knob and the reference's
        monkeypatch.setenv("BFS_TPU_TORCH_STREAM_CACHE_GB", gb)
        monkeypatch.setenv("BFS_TPU_STREAM_CACHE_GB", gb)

    budget("1")
    eng = P.RelayEngine(gnm, device="cpu", expansion="mxu", tiles_mode="auto")
    jeng = JRelay(_jgraph(gnm), expansion="mxu", tiles_mode="auto")
    assert eng.tiles_nbytes == jeng.adj_tiles.nbytes
    assert not eng._stream_effective() and not jeng._stream_effective()
    assert eng.adj_tiles is not None  # resident: it fits
    want = eng.run(SOURCE)
    assert eng.stream_report is None
    budget(str(eng.tiles_nbytes / 2 / (1 << 30)))
    assert eng._stream_effective() and jeng._stream_effective()
    _same(eng.run(SOURCE), want)  # streamed now, from a store cut at first use
    assert eng.stream_report["misses"] >= 1
    over = P.RelayEngine(eng.relay_graph, device="cpu", expansion="mxu", tiles_mode="auto")
    assert over.adj_tiles is None  # over the budget at init: the host store only
    _same(over.run(SOURCE), want)


# ---------------------------------------------------------- the command line --

def test_cli_stream_config_kill_and_resume(tmp_path, fault):
    out = tmp_path / "o.json"
    args = ["--config", "stream", "--device", "cpu", "--ckpt-dir", str(tmp_path / "c"),
            "--out", str(out)]
    with fault("raise:superstep:2"):
        with pytest.raises(FaultInjected):
            _runner_main(args)
    assert not out.exists()
    assert _runner_main(args) == 0
    doc = json.loads(out.read_text())
    assert doc["superstep_ckpt"]["resumed_from_epoch"] == 4  # two segments of 2
    g = P.rmat_graph(8, 4, seed=3)
    eng = P.RelayEngine(g, device="cpu", expansion="mxu", direction="auto", tiles_mode="stream")
    res, curve = eng.run_streamed(SOURCE, telemetry=True)
    from bfs_tpu_torch.resilience.superstep_ckpt import _hash

    assert (doc["dist_hash"], doc["parent_hash"], doc["num_levels"]) == (
        _hash(res.dist), _hash(res.parent), res.num_levels)
    assert doc["direction_schedule"] == curve["direction_schedule"]
    assert doc["stream"]["budget_bytes"] == _max_budget(eng.stream_store)
    assert doc["stream"]["levels"][0]["level"] == 5  # the resumed run's rows


def test_stream_report_shape():
    from bfs_tpu.obs.telemetry import stream_report as j_stream_report
    from bfs_tpu_torch.obs.telemetry import stream_report

    rows = [
        {"level": 1, "arm": "push", "demanded": 0, "bytes_streamed": 0, "hits": 0, "misses": 0,
         "evictions": 0, "corrupt_refetches": 0},
        {"level": 2, "arm": "pull", "demanded": 2, "bytes_streamed": 64, "hits": 1, "misses": 2,
         "evictions": 1, "corrupt_refetches": 0},
    ]
    kw = dict(budget_bytes=128, store={"num_superblocks": 2, "real_tiles": 4,
                                       "host_store_bytes": 256, "max_superblock_bytes": 128},
              cache={"hits": 5, "misses": 9})
    doc = stream_report(rows, **kw)
    assert doc == j_stream_report(rows, **kw)
    assert doc["levels"] == rows and doc["levels"] is not rows
    json.dumps(doc)
