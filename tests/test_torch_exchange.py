"""The mesh engine's frontier exchange (``bfs_tpu_torch.parallel.exchange``)
and the sharded relay's direction schedule, against the JAX reference on
the CPU.

Held here: the knobs and the budget; each arm's global words, bytes and
arm code on the same send words as the reference's arms (run under
the shim's ``shard_map`` on the 8 virtual CPU devices); ``exchange_report``; the
four arms bit-identical in results, their per-level bytes and arm codes
equal to the reference's ``exchange_report`` of the same search (the
reference run with its replication check off, see
``test_torch_sharded.reference_unchecked``); the ``auto`` and ``push``
direction schedules at x2 and x8 equal to the single-chip port's, and the
reference's at x2 ``auto`` (its ``auto`` at x8 and ``push`` at x2 fail in
the reference's own suite: there the single-chip port and the oracle are
the yardstick).  All comparisons are exact."""

import numpy as np
import pytest
import torch

import bfs_tpu_torch as P
from bfs_tpu_torch import knobs
from bfs_tpu_torch.parallel import exchange as PX
from bfs_tpu_torch.parallel import sharded as SH

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

from bfs_tpu.graph import benes as j_benes
from bfs_tpu.graph import relay as JR
from bfs_tpu.parallel import compat as JCOMP
from bfs_tpu.parallel import exchange as JX
from bfs_tpu.parallel import sharded as JS

from test_torch_sharded import CPU, _jgraph, _oracle, _same, mesh, reference_unchecked

pytestmark = pytest.mark.skipif(
    not j_benes.native_available(), reason="native benes router unavailable"
)

ARMS = ("flat", "bitmap", "delta", "auto")
_cache: dict = {}


def _layouts(name: str, n: int):
    """(graph, port layout, reference layout), built once."""
    key = (name, n)
    if key not in _cache:
        g = {"rmat9": lambda: P.rmat_graph(9, 8, seed=11),
             "switchy": lambda: P.gnm_graph(1 << 10, 3 << 10, seed=5),
             "path257": lambda: P.path_graph(257)}[name]()
        _cache[key] = (g, P.build_sharded_relay_graph(g, n, route="native"),
                       JR.build_sharded_relay_graph(_jgraph(g), n))
    return _cache[key]


# ------------------------------------------------------------------- knobs --

def test_resolve_exchange_env_knobs(monkeypatch):
    assert PX.resolve_exchange() == PX.ExchangeConfig("auto", 8)
    monkeypatch.setenv("BFS_TPU_TORCH_EXCHANGE", "delta")
    monkeypatch.setenv("BFS_TPU_TORCH_EXCHANGE_DIV", "4")
    cfg = PX.resolve_exchange()
    assert (cfg.mode, cfg.budget_div) == ("delta", 4)
    assert PX.resolve_exchange("flat").mode == "flat"  # an explicit arm wins
    monkeypatch.setenv("BFS_TPU_EXCHANGE", "flat")  # the reference's knob does not steer the port
    assert PX.resolve_exchange().mode == "delta"
    for name, value in (("BFS_TPU_TORCH_EXCHANGE", "zip"), ("BFS_TPU_TORCH_EXCHANGE_DIV", "0"),
                        ("BFS_TPU_TORCH_EXCHANGE_DIV", "many")):
        monkeypatch.setenv("BFS_TPU_TORCH_EXCHANGE", "auto")
        monkeypatch.setenv("BFS_TPU_TORCH_EXCHANGE_DIV", "8")
        monkeypatch.setenv(name, value)
        with pytest.raises(ValueError, match=name):
            PX.resolve_exchange()
        with pytest.raises(ValueError):
            SH.bfs_sharded(P.path_graph(8), 0, mesh=mesh(2), engine="relay")
    assert knobs.KNOBS["BFS_TPU_TORCH_EXCHANGE"].journal_key == "exchange"
    with pytest.raises(ValueError):
        PX.resolve_exchange("sideways")


@pytest.mark.parametrize("mode,div,kw", [("auto", 8, 64), ("auto", 8, 3), ("delta", 8, 64),
                                         ("bitmap", 3, 10), ("flat", 1, 7)])
def test_delta_budget_matches_the_reference(mode, div, kw):
    assert PX.ExchangeConfig(mode, div).delta_budget(kw) == \
        JX.ExchangeConfig(mode, div).delta_budget(kw)
    assert PX.ExchangeConfig(mode, div).key() == JX.ExchangeConfig(mode, div).key()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exchange_report_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    levels = int(rng.integers(1, 127))
    arms = np.zeros(128, np.int64)
    arms[1:levels + 1] = rng.integers(1, 4, levels)
    nbytes = np.where(arms > 0, rng.integers(4, 4096, 128), 0)
    for num_levels in (None, levels + 1, 300):
        cfg = PX.ExchangeConfig("auto", int(rng.integers(1, 9)))
        got = PX.exchange_report(nbytes, arms, cfg, 40, 12, 8, num_levels=num_levels)
        want = JX.exchange_report(nbytes, arms, JX.ExchangeConfig(*cfg.key()), 40, 12, 8,
                                  num_levels=num_levels)
        assert got == want


# ------------------------------------------------- one exchange, arm by arm --

def _reference_arm(arm: str, send: np.ndarray, own: np.ndarray, nw: int, budget: int):
    """The reference's arm on ``send[n, nw]`` under its ``shard_map`` shim
    over the graph axis: (global words, bytes, arm code) of shard 0."""
    n = send.shape[0]
    jmesh = JS.make_mesh(graph=n)

    def inner(w, own_all):
        w = w[0]
        own_local = own_all[jax.lax.axis_index(JS.GRAPH_AXIS)]
        if arm == "flat":
            fw, b, a = JX.exchange_flat(w, n, JS.GRAPH_AXIS)
        elif arm == "bitmap":
            fw, b, a = JX.exchange_bitmap(w, own_local, own_all, nw, JS.GRAPH_AXIS)
        else:
            fw, b, a = JX.exchange_delta(w, own_local, own_all, nw, budget, JS.GRAPH_AXIS)
        return fw[None], jnp.reshape(b, (1,)), jnp.reshape(a, (1,))

    with reference_unchecked():
        fn = JCOMP.shard_map(inner, mesh=jmesh, in_specs=(JP(JS.GRAPH_AXIS, None), JP()),
                             out_specs=(JP(JS.GRAPH_AXIS), JP(JS.GRAPH_AXIS), JP(JS.GRAPH_AXIS)),
                             axis_names={JS.GRAPH_AXIS, JS.BATCH_AXIS})
        fw, b, a = jax.jit(fn)(jnp.asarray(send.view(np.uint32)), jnp.asarray(own))
    return np.asarray(fw)[0].view(np.int32), int(np.asarray(b)[0]), int(np.asarray(a)[0])


@pytest.mark.parametrize("density", [0.0, 0.003, 0.05, 0.6])
@pytest.mark.parametrize("n", [2, 8])
def test_each_arm_matches_the_reference(n, density):
    """On a layout's own-word table, send words of a given density (only
    the shards' real words hold bits, as the sieve leaves them): each arm's
    global words, bytes and code equal the reference's; every arm's words
    are the flat arm's."""
    _, srg, _ = _layouts("rmat9", n)
    own = SH._own_word_table(srg)
    nw, kw = srg.block // 32, own.shape[1]
    rng = np.random.default_rng(int(density * 1000) + n)
    bits = (rng.random((n, nw, 32)) < density).astype(np.uint64)
    words = (bits << np.arange(32, dtype=np.uint64)).sum(axis=2).astype(np.uint32)
    real = np.zeros((n, nw), bool)
    real[np.arange(n)[:, None], own] = True
    words = np.where(real, words, 0).view(np.int32)
    send = torch.from_numpy(words)
    own_t = torch.from_numpy(own.astype(np.int64))
    flat = PX.exchange_flat(send)[0]
    for mode in ("flat", "bitmap", "delta", "auto"):
        cfg = PX.ExchangeConfig(mode, 8)
        budget = cfg.delta_budget(kw)
        got_w, got_b, got_a = PX.make_exchange(cfg, kw, nw)(send, own_t)
        arm = {"auto": "delta"}.get(mode, mode)
        want_w, want_b, want_a = _reference_arm(arm, words, own, nw, budget)
        np.testing.assert_array_equal(got_w.numpy(), want_w)
        assert (int(got_b), int(got_a)) == (want_b, want_a)
        assert torch.equal(got_w, flat)
    # The batch's exchange: the bitmap move per tree.
    rolled = torch.where(torch.from_numpy(real), torch.roll(send, 1, dims=1), 0)
    trees = torch.stack([send, rolled], dim=1)  # [n, 2, nw]
    got = PX.bitmap_gather(trees.gather(-1, own_t[:, None, :].expand(n, 2, kw)), own_t, nw)
    for t in range(2):
        assert torch.equal(got[t], PX.exchange_flat(trees[:, t])[0])


# ------------------------------------------------- whole searches, arm by arm --

def _ref_curve(name: str, n: int, s: int, direction: str, arm: str):
    key = ("curve", name, n, s, direction, arm)
    if key not in _cache:
        _, _, jsrg = _layouts(name, n)
        with reference_unchecked():
            _cache[key] = JS.bfs_sharded(jsrg, s, mesh=JS.make_mesh(graph=n), engine="relay",
                                         telemetry=True, direction=direction, exchange=arm)
    return _cache[key]


def _assert_curves(got_res, got_curve, want_res, want_curve) -> None:
    _same(got_res, want_res)
    assert got_curve["exchange"] == want_curve["exchange"]
    assert got_curve["direction_schedule"] == want_curve["direction_schedule"]
    for k in ("occupancy", "levels", "reachable", "cap"):
        assert got_curve[k] == want_curve[k]


@pytest.mark.parametrize("arm", ARMS)
def test_arms_bit_identical_with_the_reference_bytes_x2(arm):
    g, srg, _ = _layouts("rmat9", 2)
    res, curve = SH.bfs_sharded(srg, 0, mesh=mesh(2), engine="relay", telemetry=True,
                                direction="auto", exchange=arm)
    _oracle(g, res, 0)
    _assert_curves(res, curve, *_ref_curve("rmat9", 2, 0, "auto", arm))
    ex = curve["exchange"]
    assert ex["arm"] == arm and ex["total_bytes"] == sum(ex["bytes_per_level"])
    if arm == "flat":
        assert set(ex["schedule"]) == {"flat"} and ex["total_bytes"] == ex["flat_total_bytes"]
    if arm in ("bitmap", "auto"):
        assert ex["total_bytes"] <= ex["flat_total_bytes"]


def test_arms_bit_identical_x1_x8():
    """Every arm at x1 (the collectives degenerate) and x8 (the widest):
    the same results and schedules as the flat arm, each arm's bytes as
    its formula gives them."""
    g, _, _ = _layouts("rmat9", 2)
    for n in (1, 8):
        srg = P.build_sharded_relay_graph(g, n, route="native")
        kw, nw = SH._own_word_table(srg).shape[1], srg.block // 32
        base = None
        for arm in ARMS:
            res, curve = SH.bfs_sharded(srg, 0, mesh=mesh(n), engine="relay", telemetry=True,
                                        direction="pull", exchange=arm)
            _oracle(g, res, 0)
            if base is None:
                base = (res, curve)
            _same(res, base[0])
            assert curve["occupancy"] == base[1]["occupancy"]
            per = {"flat": 4 * n * nw, "bitmap": 4 * n * kw,
                   "delta": 4 * n * 2 * PX.ExchangeConfig(arm).delta_budget(kw)}
            ex = curve["exchange"]
            for b, a in zip(ex["bytes_per_level"], ex["schedule"]):
                assert b == per[a]


def test_deep_path_delta_reruns_unpacked_x8():
    g, srg, _ = _layouts("path257", 8)
    res, curve = SH.bfs_sharded(srg, 0, mesh=mesh(8), engine="relay", telemetry=True,
                                direction="auto", exchange="delta")
    _oracle(g, res, 0)
    assert res.num_levels == 257
    ex = curve["exchange"]
    assert set(ex["schedule"]) == {"delta"} and ex["supersteps"] == 257
    assert all(b == 8 * ex["budget_words"] * 4 * 2 for b in ex["bytes_per_level"][:-1])
    _assert_curves(res, curve, *_ref_curve("path257", 8, 0, "auto", "delta"))


def test_auto_arm_selects_by_density():
    g, srg, _ = _layouts("switchy", 8)
    s = int(np.argmax(np.bincount(g.src, minlength=g.num_vertices)))
    res_a, curve_a = SH.bfs_sharded(srg, s, mesh=mesh(8), engine="relay", telemetry=True,
                                    direction="pull", exchange="auto")
    res_f, curve_f = SH.bfs_sharded(srg, s, mesh=mesh(8), engine="relay", telemetry=True,
                                    direction="pull", exchange="flat")
    _same(res_a, res_f)
    ea = curve_a["exchange"]
    assert {"delta", "bitmap"} <= set(ea["schedule"]), ea["schedule"]
    assert ea["total_bytes"] < curve_f["exchange"]["total_bytes"]


# ------------------------------------------------------ direction schedules --

@pytest.fixture(scope="module")
def switchy():
    """(graph, hub source, the single-chip port's schedules per mode): a
    G(n, m) whose auto schedule switches both ways."""
    g = _layouts("switchy", 2)[0]
    s = int(np.argmax(np.bincount(g.src, minlength=g.num_vertices)))
    sched = {}
    for mode in ("auto", "push", "pull"):
        eng = P.RelayEngine(g, device="cpu", sparse_hybrid=True, direction=mode,
                            expansion="gather")
        sched[mode] = eng.run_level_curve(s)["direction_schedule"]["schedule"]
    assert {"push", "pull"} <= set(sched["auto"]), sched["auto"]
    return g, s, sched


@pytest.mark.parametrize("n,mode", [(2, "auto"), (8, "auto"), (2, "push"), (8, "push"),
                                    (8, "pull")])
def test_direction_schedule_parity(switchy, n, mode):
    """The mesh's schedule equals the single-chip relay engine's in every
    mode (and the reference's), and the results the oracle's: the push
    body is the per-shard sparse gather."""
    g, s, sched = switchy
    _, srg, _ = _layouts("switchy", n)
    # The reference's own suite passes at x2 `auto` with the bitmap arm.
    held = (n, mode) == (2, "auto")
    arm = "bitmap" if held else "auto"
    eng = SH.ShardedRelayEngine(srg, mesh(n))
    res, curve = eng.run(s, telemetry=True, direction=mode, exchange=arm)
    _oracle(g, res, s)
    assert curve["direction_schedule"]["schedule"] == sched[mode]
    issued = (eng.last_run["issued_push"], eng.last_run["issued_pull"])
    if mode == "pull":
        assert issued[0] == 0
    else:  # the switch loop issues every superstep, one body each
        assert issued == (sched[mode].count("push"), sched[mode].count("pull"))
        assert eng.last_run["host_reads"] == sum(issued) + 1
    if held:
        _assert_curves(res, curve, *_ref_curve("switchy", n, s, mode, arm))


def test_push_body_against_the_dense_body(switchy):
    """Each level of a forced-push search run densely instead: the same
    candidates, so the same tree (an unpacked carry, slots as parents)."""
    g, s, _ = switchy
    _, srg, _ = _layouts("switchy", 2)
    eng = SH.ShardedRelayEngine(srg, mesh(2))
    eng.packed = False
    want = eng.run(s, direction="pull")
    got = eng.run(s, direction="push")
    _same(got, want)
    _oracle(g, got, s)
