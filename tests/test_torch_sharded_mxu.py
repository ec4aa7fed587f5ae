"""The mesh's MXU arm (``bfs_tpu_torch.parallel.sharded`` with
``expansion="mxu"``) against the JAX reference's on the CPU.

Held here: each shard's tile layout
(``bfs_tpu_torch.graph.adj_tiles.build_adj_tiles_sharded``, host and device
builders) byte for byte against the reference's, and its budget refused
per shard; ``bfs_sharded(engine="relay", expansion="mxu")`` at 1, 2 and 8
shards on the ``pull``, ``auto`` and ``push`` schedules against the
reference's (run with its replication check off, see
``test_torch_sharded.reference_unchecked``), the port's single-chip MXU
arm, its gather arm on the mesh and the oracle, level curves included;
the four exchange arms; the packed carry's unpacked re-run past 62
levels; the arm's resolution (``auto`` builds no tile, forced ``mxu``
without the adjacency raises, the packed parent field's test); a dead
superstep of the arm's loops.  All comparisons are exact."""

import types

import numpy as np
import pytest
import torch

import bfs_tpu_torch as P
from bfs_tpu_torch.graph import adj_tiles as PAT
from bfs_tpu_torch.parallel import sharded as SH

from bfs_tpu.graph import adj_tiles as JAT
from bfs_tpu.graph import benes as j_benes
from bfs_tpu.graph import relay as JR
from bfs_tpu.parallel import sharded as JS

from test_torch_sharded import _jgraph, _oracle, _same, mesh, reference_unchecked

pytestmark = pytest.mark.skipif(
    not j_benes.native_available(), reason="native benes router unavailable"
)

ARMS = ("flat", "bitmap", "delta", "auto")
SOURCE = 3
_cache: dict = {}


def _layouts(n: int, name: str = "rmat9"):
    """(graph, port layout, reference layout) of the sharded relay, built
    once per shard count."""
    key = (name, n)
    if key not in _cache:
        g = {"rmat9": lambda: P.rmat_graph(9, 8, seed=11),
             "path257": lambda: P.path_graph(257)}[name]()
        _cache[key] = (g, P.build_sharded_relay_graph(g, n, route="native"),
                       JR.build_sharded_relay_graph(_jgraph(g), n))
    return _cache[key]


def _engine(n: int, expansion: str = "mxu", name: str = "rmat9") -> SH.ShardedRelayEngine:
    key = ("engine", name, n, expansion)
    if key not in _cache:
        _cache[key] = SH.ShardedRelayEngine(_layouts(n, name)[1], mesh(n), expansion=expansion)
    return _cache[key]


def _assert_curves(got, want) -> None:
    for k in ("occupancy", "levels", "reachable", "cap", "direction_schedule", "exchange"):
        assert got[k] == want[k], k


# ----------------------------------------------------------------- the tiles --

@pytest.mark.parametrize("builder", ["host", "device"])
@pytest.mark.parametrize("n", [2, 8])
def test_sharded_tiles_match_the_reference(n, builder):
    _, srg, jsrg = _layouts(n)
    got = PAT.build_adj_tiles_sharded(srg, builder=builder)
    want = JAT.build_adj_tiles_sharded(jsrg, builder=builder)
    assert len(got) == len(want) == n
    for a, b in zip(got, want):
        x, y = PAT.tiles_to_arrays(a), JAT.tiles_to_arrays(b)
        assert set(x) == set(y)
        for k in y:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k
    assert PAT.count_tiles_sharded(srg) == [a.nt for a in want]


def test_sharded_tiles_budget_is_per_shard():
    """The budget holds each shard's layout, not their sum: the largest
    shard's bytes pass (the sum is far over), one tile less is refused by
    the builder and by the engine before any tile is built."""
    _, srg, jsrg = _layouts(8)
    nts = PAT.count_tiles_sharded(srg)
    most = max(nts) * PAT.TILE_BYTES
    assert sum(nts) * PAT.TILE_BYTES > most
    assert [a.nt for a in PAT.build_adj_tiles_sharded(srg, budget_bytes=most)] == nts
    for builder in ("host", "device"):
        with pytest.raises(ValueError, match="budget"):
            PAT.build_adj_tiles_sharded(srg, builder=builder, budget_bytes=most - 1)
    with pytest.raises(ValueError, match="budget"):
        JAT.build_adj_tiles_sharded(jsrg, budget_bytes=most - 1)
    with pytest.raises(ValueError, match="budget"):
        SH.ShardedRelayEngine(srg, mesh(8), expansion="mxu", tiles_budget_bytes=most - 1)
    eng = SH.ShardedRelayEngine(srg, mesh(8), expansion="mxu", tiles_budget_bytes=most)
    assert eng.tiles.info["nt"] == nts and eng.tiles.info["ntp"] == max(nts)


def test_engine_stacks_the_reference_operands():
    """The engine's stacked operands are the reference's ``_sharded_tiles_dev``
    (each shard padded to the largest tile count with inert tiles), and the
    arm ships no Beneš mask and no valid-slot words."""
    _, srg, jsrg = _layouts(8)
    eng = _engine(8)
    ops, geo = JS._sharded_tiles_dev(jsrg)
    assert eng.tiles.geometry == tuple(geo)
    for got, want, dtype in zip(eng.tiles[:5], ops, (np.uint32, np.int32, np.int32, np.int32,
                                                    np.uint32)):
        assert np.array_equal(got.numpy().view(dtype), np.asarray(want))
    assert eng.vperm_masks is None and eng.net_masks is None and eng.valid_words is None
    assert eng.tiles.info["pad_bytes"] == (8 * geo[4] - sum(eng.tiles.info["nt"])) * PAT.TILE_BYTES
    np.testing.assert_array_equal(SH._sharded_adj_keys(srg), JS._sharded_adj_keys(jsrg))


# -------------------------------------------------------------- the searches --

def _ref_mxu(n: int, direction: str):
    key = ("ref", n, direction)
    if key not in _cache:
        jsrg = _layouts(n)[2]
        with reference_unchecked():
            _cache[key] = JS.bfs_sharded(jsrg, SOURCE, mesh=JS.make_mesh(graph=n), engine="relay",
                                         telemetry=True, direction=direction, exchange="auto",
                                         expansion="mxu")
    return _cache[key]


@pytest.mark.parametrize("direction", ["pull", "auto", "push"])
@pytest.mark.parametrize("n", [1, 2, 8])
def test_mxu_matches_the_reference(n, direction):
    """dist, parent, num_levels and the level curve (occupancy, direction
    schedule, the exchange's arms and bytes) equal to the reference's MXU
    arm on the mesh, to the port's gather arm on the same mesh, to the
    single-chip MXU arm and to the oracle."""
    g = _layouts(n)[0]
    eng = _engine(n)
    res, curve = eng.run(SOURCE, telemetry=True, direction=direction, exchange="auto")
    want, want_curve = _ref_mxu(n, direction)
    _same(res, want)
    _assert_curves(curve, want_curve)
    gres, gcurve = _engine(n, "gather").run(SOURCE, telemetry=True, direction=direction,
                                            exchange="auto")
    _same(res, gres)
    _assert_curves(curve, gcurve)
    single = P.RelayEngine(g, device="cpu", expansion="mxu", direction=direction)
    _same(res, single.run(SOURCE))
    _oracle(g, res, SOURCE)
    issued = (eng.last_run["issued_push"], eng.last_run["issued_pull"])
    sched = curve["direction_schedule"]["schedule"]
    if direction == "pull":  # blocks of gated supersteps, the last ones dead
        assert issued[0] == 0 and issued[1] >= res.num_levels
    else:  # the switch loop issues every superstep, one body each
        assert issued == (sched.count("push"), sched.count("pull"))


def test_mxu_bfs_sharded_one_shot_and_the_knob(monkeypatch):
    """``bfs_sharded`` builds the MXU engine for the call from a graph or a
    prebuilt layout, by argument or by ``BFS_TPU_TORCH_EXPANSION``."""
    g, srg, _ = _layouts(2)
    want = _engine(2).run(SOURCE)
    _same(SH.bfs_sharded(g, SOURCE, mesh=mesh(2), engine="relay", expansion="mxu"), want)
    monkeypatch.setenv("BFS_TPU_TORCH_EXPANSION", "mxu")
    _same(SH.bfs_sharded(srg, SOURCE, mesh=mesh(2), engine="relay"), want)
    monkeypatch.setenv("BFS_TPU_TORCH_EXPANSION", "bogus")
    with pytest.raises(ValueError, match="bogus"):
        SH.bfs_sharded(srg, SOURCE, mesh=mesh(2), engine="relay")


def test_mxu_sources_and_random_graphs():
    """Other sources, disconnected graphs and shard counts against the
    oracle and the gather arm."""
    for seed in range(2):
        g = P.gnm_graph(300, 900 if seed else 220, seed=seed)
        for n in (2, 4):
            srg = P.build_sharded_relay_graph(g, n, route="native")
            m = mesh(n)
            engines = {arm: SH.ShardedRelayEngine(srg, m, expansion=arm) for arm in ("mxu", "gather")}
            for s in (0, 137, 299):
                res = engines["mxu"].run(s, direction="auto")
                _oracle(g, res, s)
                _same(res, engines["gather"].run(s, direction="auto"))


def test_mxu_exchange_arms_bit_identical():
    """The four exchange arms on the MXU arm: the same results and
    schedules, and per level the same arms and bytes as on the gather arm
    (the exchange sees the same frontier)."""
    eng, geng = _engine(8), _engine(8, "gather")
    base = None
    for arm in ARMS:
        res, curve = eng.run(SOURCE, telemetry=True, direction="auto", exchange=arm)
        gres, gcurve = geng.run(SOURCE, telemetry=True, direction="auto", exchange=arm)
        _same(res, gres)
        _assert_curves(curve, gcurve)
        assert curve["exchange"]["arm"] == arm
        if base is None:
            base = (res, curve)
        _same(res, base[0])
        assert curve["occupancy"] == base[1]["occupancy"]
        assert curve["direction_schedule"] == base[1]["direction_schedule"]


def test_mxu_deep_path_reruns_unpacked():
    """Deeper than the packed carry's 62 levels: the packed MXU run stops on
    its cap and runs again unpacked, equal to the gather arm and the
    oracle."""
    g = _layouts(8, "path257")[0]
    for direction in ("pull", "auto"):
        eng = _engine(8, name="path257")
        assert eng.packed
        res, curve = eng.run(0, telemetry=True, direction=direction, exchange="delta")
        assert res.num_levels == 257 and not eng.last_run["packed"]
        _oracle(g, res, 0)
        gres, gcurve = _engine(8, "gather", "path257").run(0, telemetry=True, direction=direction,
                                                            exchange="delta")
        _same(res, gres)
        _assert_curves(curve, gcurve)


def test_dead_mxu_superstep_changes_nothing():
    """After a search has converged its loop's control block says not
    LIVE: a further superstep of either body is dead and leaves every
    buffer as it was."""
    eng = _engine(2)
    for direction in ("pull", "auto"):
        eng.run(0, direction=direction, exchange="auto", telemetry=True)
        loop = next(v for k, v in eng._loops.items() if k[3] == direction)
        before = [b.clone() for b in loop.buffers]
        for body in getattr(loop, "bodies", {0: loop}).values():
            body.dead_replay()
        for a, b in zip(before, loop.buffers):
            assert torch.equal(a, b)


# ------------------------------------------------------------ the arm choice --

def test_auto_and_gather_build_no_tiles(monkeypatch):
    _, srg, _ = _layouts(2)
    monkeypatch.setenv("BFS_TPU_TORCH_EXPANSION", "auto")
    for expansion in (None, "auto", "gather"):
        eng = SH.ShardedRelayEngine(srg, mesh(2), expansion=expansion)
        assert eng.expansion == "gather" and eng.tiles is None
        assert eng.vperm_masks is not None and eng.dense_launches()["class_rowmin"] == 1
    assert _engine(2).dense_launches() == {"mxu_expand": 1, "packed_update": 1}


def test_forced_mxu_needs_the_adjacency_and_the_batch_is_gather():
    """Forced ``mxu`` on a layout without the per-shard adjacency raises,
    as the reference's does; the lock-step batch on the mesh runs the
    gather arm only (the reference's ``bfs_sharded_multi`` has no arm)."""
    import dataclasses

    _, srg, jsrg = _layouts(2)
    bare = dataclasses.replace(srg, adj_indptr=None, adj_dst=None, adj_slot=None, outdeg=None)
    with pytest.raises(ValueError, match="adjacency"):
        SH.ShardedRelayEngine(bare, mesh(2), expansion="mxu")
    with pytest.raises(ValueError, match="adjacency"):
        SH.bfs_sharded(bare, 0, mesh=mesh(2), engine="relay", expansion="mxu")
    jbare = dataclasses.replace(jsrg, adj_indptr=None, adj_dst=None, adj_slot=None, outdeg=None)
    with pytest.raises(ValueError, match="adjacency"):
        JS._resolve_sharded_expansion("mxu", jbare, True)
    with pytest.raises(ValueError, match="gather"):
        _engine(2).run_multi([0, 1])


@pytest.mark.parametrize("v,packed,want", [
    (1 << 26, True, ("mxu", True)),
    ((1 << 26) + 1, True, ("mxu", False)),
    ((1 << 26) + 1, False, ("mxu", False)),
    (100, False, ("mxu", False)),
])
def test_resolver_drops_the_packed_carry_past_the_parent_field(v, packed, want):
    """The packed carry's parent field holds original ids on the MXU arm:
    past 2^26 vertices the arm runs unpacked; ``auto`` and ``gather`` keep
    the flavor."""
    layout = types.SimpleNamespace(num_vertices=v, adj_dst=np.zeros((2, 1), np.int32))
    assert SH._resolve_sharded_expansion("mxu", layout, packed) == want
    for arm in ("auto", "gather"):
        assert SH._resolve_sharded_expansion(arm, layout, packed) == ("gather", packed)
