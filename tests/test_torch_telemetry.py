"""The port's level curves and telemetry against ``bfs_tpu.obs.telemetry``
on the CPU: ``bfs_level_curve`` and ``bfs_multi_level_curve`` on push and
pull, ``RelayEngine.run_level_curve`` against the reference's
``RelayEngine(g, sparse_hybrid=False)``, the packed cap's unpacked re-run,
the recorders (gated by LIVE: a dead superstep records nothing) and the
host dicts.  Every dict must equal the reference's exactly."""

import numpy as np
import pytest
import torch

import bfs_tpu_torch as P
from bfs_tpu_torch.obs import telemetry as T
from bfs_tpu_torch.ops import control as C

import jax.numpy as jnp

from bfs_tpu.graph import benes as j_benes
from bfs_tpu.graph.csr import Graph as JGraph
from bfs_tpu.models.bfs import RelayEngine as JRelayEngine
from bfs_tpu.models.bfs import bfs_level_curve as j_level_curve
from bfs_tpu.models.multisource import bfs_multi_level_curve as j_multi_level_curve
from bfs_tpu.obs import telemetry as JT
from bfs_tpu.oracle.bfs import queue_bfs

needs_native = pytest.mark.skipif(
    not j_benes.native_available(), reason="native benes router unavailable"
)

GRAPHS = {
    "rmat9": (lambda: P.rmat_graph(9, 8, seed=7), (0, 5)),
    "gnm": (lambda: P.gnm_graph(300, 280, seed=5), (7,)),  # several components
    "star": (lambda: P.star_graph(200), (3,)),
    "path100": (lambda: P.path_graph(100), (0,)),  # past the packed cap
}


def _jgraph(g: P.Graph) -> JGraph:
    return JGraph(g.num_vertices, g.src.copy(), g.dst.copy())


def _oracle(g, s):
    dist, _ = queue_bfs(_jgraph(g), s)
    reached = dist != P.INF_DIST
    return int(reached.sum()), [int(x) for x in np.bincount(dist[reached])]


@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("engine", ["pull", "push"])
def test_bfs_level_curve_matches_reference(name, engine):
    make, roots = GRAPHS[name]
    g = make()
    for s in roots:
        reached, hist = _oracle(g, s)
        got = P.bfs_level_curve(g, s, engine=engine, device="cpu", reference_reached=reached)
        want = j_level_curve(_jgraph(g), s, engine=engine, reference_reached=reached)
        assert got == want
        assert got["occupancy"] == hist and got["occupancy_sum_matches_reference"]
    for max_levels in (1, 3):
        assert (P.bfs_level_curve(g, roots[0], engine=engine, device="cpu", max_levels=max_levels)
                == j_level_curve(_jgraph(g), roots[0], engine=engine, max_levels=max_levels))


@pytest.mark.parametrize("name", ["rmat9", "gnm", "path100"])
@pytest.mark.parametrize("engine", ["pull", "push"])
def test_bfs_multi_level_curve_matches_reference(name, engine):
    make, roots = GRAPHS[name]
    g = make()
    sources = [*roots, 1, 9, 1]
    got = P.bfs_multi_level_curve(g, sources, engine=engine, device="cpu")
    want = j_multi_level_curve(_jgraph(g), sources, engine=engine)
    assert got == want
    assert got["reachable"] == sum(_oracle(g, s)[0] for s in sources)
    assert got["occupancy"][0] == len(sources)


@needs_native
@pytest.mark.parametrize("name,direction", [("rmat9", "auto"), ("gnm", "pull"),
                                            ("star", "auto"), ("path100", "pull")])
def test_relay_level_curve_matches_reference(name, direction):
    make, roots = GRAPHS[name]
    g = make()
    eng = P.RelayEngine(g, device="cpu", sparse_hybrid=False, direction=direction)
    ref = JRelayEngine(_jgraph(g), sparse_hybrid=False, direction=direction)
    for s in roots:
        reached, hist = _oracle(g, s)
        got = eng.run_level_curve(s, reference_reached=reached)
        assert got == ref.run_level_curve(s, reference_reached=reached)
        assert got["occupancy"] == hist and got["reachable"] == reached
        assert set(got["direction_schedule"]["schedule"]) == {"pull"}
        assert got["direction_schedule"]["mode"] == direction
        # The search itself is unchanged beside the curve.
        res = eng.run(s)
        assert eng.last_run["live"] == res.num_levels or name == "path100"
    if name == "rmat9":
        got = eng.run_level_curve(roots[0], max_levels=3)
        assert got == ref.run_level_curve(roots[0], max_levels=3)


@needs_native
def test_relay_level_curve_loops_and_arms_agree():
    """The eager loop (the plain version) and the MXU arm give the gather
    arm's curve; the packed run records 62 levels before the unpacked re-run
    records all 100 (the curve is the re-run's)."""
    g = P.rmat_graph(9, 8, seed=7)
    eng = P.RelayEngine(g, device="cpu")
    want = eng.run_level_curve(5)
    eng.loop = "eager"
    assert eng.run_level_curve(5) == want
    assert P.RelayEngine(g, device="cpu", expansion="mxu").run_level_curve(5) == want
    path = P.RelayEngine(P.path_graph(100), device="cpu")
    curve = path.run_level_curve(0)
    assert curve["levels"] == 100 and curve["occupancy"] == [1] * 100
    assert curve["cap"] == path.relay_graph.vr and path.last_run["live"] == 62 + 100


@needs_native
def test_relay_refuses_push_as_the_reference_does(monkeypatch):
    """``push`` raises only without the sparse hybrid, from the argument or
    from the knob, as the reference's engine does."""
    g = P.path_graph(10)
    with pytest.raises(ValueError, match="sparse_hybrid"):
        P.RelayEngine(g, device="cpu", sparse_hybrid=False, direction="push")
    with pytest.raises(ValueError, match="sparse_hybrid"):
        JRelayEngine(_jgraph(g), sparse_hybrid=False, direction="push")
    assert P.RelayEngine(g, device="cpu", direction="push").direction.mode == "push"
    monkeypatch.setenv("BFS_TPU_TORCH_DIRECTION", "push")
    with pytest.raises(ValueError, match="sparse_hybrid"):
        P.RelayEngine(g, device="cpu", sparse_hybrid=False)


@needs_native
def test_relay_runs_the_hybrid_under_the_push_knob(monkeypatch):
    """``BFS_TPU_TORCH_DIRECTION=push`` runs the relay entry points on the
    sparse hybrid's push schedule (the sparse superstep wherever the
    frontier fits its budgets), labelled as the reference labels it under
    ``BFS_TPU_DIRECTION=push``; the stepped runner and the lock-step batch
    stay dense, with the same results."""
    monkeypatch.setenv("BFS_TPU_TORCH_DIRECTION", "push")
    monkeypatch.setenv("BFS_TPU_DIRECTION", "push")
    g = P.gnm_graph(200, 600, seed=4)
    dist, parent = P.canonical_bfs(g, 3)
    res = P.bfs(g, 3, engine="relay", device="cpu")
    np.testing.assert_array_equal(res.dist, dist)
    np.testing.assert_array_equal(res.parent, parent)
    res = P.SuperstepRunner(g, engine="relay", device="cpu").run(3)
    np.testing.assert_array_equal(res.dist, dist)
    np.testing.assert_array_equal(res.parent, parent)
    multi = P.bfs_multi(g, [3, 7], engine="relay", device="cpu")
    np.testing.assert_array_equal(multi.dist[0], dist)
    curve = P.bfs_level_curve(g, 3, engine="relay", device="cpu")
    assert curve == JRelayEngine(_jgraph(g)).run_level_curve(3)
    sched = curve["direction_schedule"]
    assert sched["mode"] == "push" and set(sched["schedule"]) == {"push"}
    assert P.bfs_level_curve(g, 3, engine="push", device="cpu")["occupancy"] == curve["occupancy"]


def test_one_telemetry_read_per_curve(monkeypatch):
    """A curve costs one host read of the accumulators (a few hundred
    elements), never of the V-sized state."""
    calls = []
    real = T.read_telemetry

    def spy(*tensors):
        calls.append(sum(t.numel() for t in tensors))
        return real(*tensors)

    monkeypatch.setattr(T, "read_telemetry", spy)
    g = P.rmat_graph(9, 8, seed=7)
    P.bfs_level_curve(g, 0, engine="pull", device="cpu")
    P.bfs_multi_level_curve(g, [0, 1], engine="push", device="cpu")
    if j_benes.native_available():
        P.RelayEngine(g, device="cpu").run_level_curve(0)
    assert len(calls) == (3 if j_benes.native_available() else 2)
    assert max(calls) <= 3 * T.TEL_SLOTS


# --------------------------------------------------------------- the recorders --

@pytest.mark.parametrize("seed", range(3))
def test_recorders_match_reference(seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, 257, dtype=np.uint32)
    frontier = rng.random((3, 500)) < 0.3
    level = int(rng.integers(0, 200))  # past TEL_SLOTS clamps into the last slot
    acc = T.init_level_acc(4)
    jacc = JT.init_level_acc(4)
    T.record_frontier_words(acc, torch.from_numpy(words.view(np.int32)), torch.tensor(level))
    jacc = JT.record_frontier_words(jacc, jnp.asarray(words), jnp.int32(level))
    T.record_frontier_bools(acc, torch.from_numpy(frontier), torch.tensor(3))
    jacc = JT.record_frontier_bools(jacc, jnp.asarray(frontier), jnp.int32(3))
    T.record_count(acc, torch.tensor(level + 1), torch.tensor(17))
    jacc = JT.record_count(jacc, jnp.int32(level + 1), 17)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    dirs, jdirs = T.init_dir_acc(), JT.init_dir_acc()
    for lvl, code in ((1, T.DIR_PUSH), (2, T.DIR_PULL), (level, T.DIR_PULL)):
        T.record_direction(dirs, torch.tensor(lvl), code)
        jdirs = JT.record_direction(jdirs, jnp.int32(lvl), code)
    np.testing.assert_array_equal(dirs.numpy(), np.asarray(jdirs))
    dist = rng.integers(0, 140, 600).astype(np.int32)
    dist[rng.random(600) < 0.2] = P.INF_DIST
    outdeg = rng.integers(0, 50, 600).astype(np.int32)
    unreached = dist == P.INF_DIST
    np.testing.assert_array_equal(
        T.edge_curve_from_levels(torch.from_numpy(dist), torch.from_numpy(outdeg),
                                 torch.from_numpy(unreached)).numpy(),
        np.asarray(JT.edge_curve_from_levels(jnp.asarray(dist), jnp.asarray(outdeg),
                                             jnp.asarray(unreached))))


def test_dead_superstep_records_nothing():
    acc, dirs = T.init_level_acc(), T.init_dir_acc()
    frontier = torch.ones(40, dtype=torch.bool)
    dead = torch.tensor(False)
    T.record_frontier_bools(acc, frontier, torch.tensor(2), dead)
    T.record_frontier_words(acc, torch.full((4,), -1, dtype=torch.int32), torch.tensor(2), dead)
    T.record_direction(dirs, torch.tensor(2), T.DIR_PULL, dead)
    assert acc.tolist() == T.init_level_acc().tolist() and not dirs.any()
    T.record_direction(dirs, torch.tensor(2), T.DIR_PULL, torch.tensor(True))
    T.record_frontier_bools(acc, frontier, torch.tensor(2), torch.tensor(True))
    assert int(dirs[2]) == T.DIR_PULL and int(acc[2]) == 40


@needs_native
@pytest.mark.parametrize("packed", [True, False])
def test_relay_dead_block_leaves_the_accumulators(packed):
    eng = P.RelayEngine(P.rmat_graph(9, 8, seed=7), device="cpu")
    eng.packed = packed
    eng.run_level_curve(5)
    loop = eng._packed_loop(True) if packed else eng._unpacked_loop(True)
    before = [b.clone() for b in loop.buffers]
    assert before[-1][C.LIVE] == 0
    loop.dead_replay()
    for a, b in zip(before, loop.buffers):
        assert torch.equal(a, b)


def test_host_dicts_match_reference():
    rng = np.random.default_rng(1)
    for _ in range(20):
        fv = np.zeros(T.TEL_SLOTS, np.int64)
        n = int(rng.integers(0, 20))
        fv[:n] = rng.integers(0, 1000, n)
        if rng.random() < 0.2:
            fv[T.TEL_SLOTS - 1] = 7
        fe = rng.integers(0, 10**6, T.TEL_SLOTS).astype(np.float32)
        cap = int(rng.integers(1, 100))
        want = JT.level_curve(fv.astype(np.int32), fe, cap=cap, reference_reached=int(fv.sum()))
        assert T.level_curve(fv, fe, cap=cap, reference_reached=int(fv.sum())) == want
        assert T.level_curve(fv) == JT.level_curve(fv.astype(np.int32))
        dv = np.zeros(T.TEL_SLOTS, np.int32)
        dv[1 : n + 1] = rng.integers(1, 3, n)
        for mode in ("auto", "push"):
            assert (T.direction_schedule(dv, mode=mode, alpha=2.0, beta=3.5)
                    == JT.direction_schedule(dv, mode=mode, alpha=2.0, beta=3.5))
    assert (T.DIR_PUSH, T.DIR_PULL, T.DIR_NAMES, T.TEL_SLOTS) == (
        JT.DIR_PUSH, JT.DIR_PULL, JT.DIR_NAMES, JT.TEL_SLOTS)


def test_read_telemetry_is_one_copy_of_every_dtype():
    tensors = (torch.arange(5, dtype=torch.int64), torch.tensor([1.5, -2.0]),
               torch.tensor(True), torch.arange(6, dtype=torch.int32).reshape(2, 3))
    out = T.read_telemetry(*tensors)
    for t, h in zip(tensors, out):
        assert h.dtype == t.numpy().dtype and h.shape == tuple(t.shape)
        np.testing.assert_array_equal(h, t.numpy())
