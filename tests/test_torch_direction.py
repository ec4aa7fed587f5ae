"""The port's direction policy against ``bfs_tpu.models.direction`` on the
CPU, bit for bit: the knobs and their refusals, ``bfs_direction`` and
``bfs_multi_direction`` in all three modes (``dist``, ``parent``,
``num_levels`` and the schedule dict) on the reference's switchy fixture,
a star, a path past the packed cap, G(n, m), R-MAT and tinyCG; the Beamer
predicate and the frontier masses on random inputs; the thresholds that
move the switch; and the two-graph loop (its dead superstep on each body,
the eager loop as its plain version, the accounting per body).

All comparisons are exact (tolerance 0): the masses are integer sums and
the predicate compares the same float32 values."""

import os

import numpy as np
import pytest
import torch

import bfs_tpu_torch as P
from bfs_tpu_torch import knobs
from bfs_tpu_torch.models import direction as D
from bfs_tpu_torch.obs import telemetry as T
from bfs_tpu_torch.ops import control as C

import jax.numpy as jnp

from bfs_tpu import knobs as j_knobs
from bfs_tpu.graph.csr import Graph as JGraph
from bfs_tpu.models import direction as JD
from bfs_tpu.ops.relay import pack_std_host
from bfs_tpu.oracle.bfs import canonical_bfs, check

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("auto", "push", "pull")


def _switchy():
    """The reference's fixture: a G(n, m) whose frontier ramps through both
    thresholds from its max-degree vertex."""
    g = P.gnm_graph(1 << 10, 3 << 10, seed=5)
    return g, (int(np.argmax(np.bincount(g.src, minlength=g.num_vertices))),)


GRAPHS = {
    "switchy": _switchy,
    "star": lambda: (P.star_graph(256), (5, 0)),
    "path80": lambda: (P.path_graph(80), (0,)),  # past the packed 62-level cap
    "gnm": lambda: (P.gnm_graph(300, 280, seed=5), (0, 7)),  # several components
    "rmat10": lambda: (P.rmat_graph(10, 6, seed=1), (1, 400)),
    "tinyCG": lambda: (P.read_sedgewick(os.path.join(REPO, "test-sets", "tinyCG.txt")), (0, 3)),
}


def _jgraph(g: P.Graph) -> JGraph:
    return JGraph(g.num_vertices, g.src.copy(), g.dst.copy())


def _same(got, want) -> None:
    np.testing.assert_array_equal(got.dist, np.asarray(want.dist))
    np.testing.assert_array_equal(got.parent, np.asarray(want.parent))
    assert got.num_levels == int(want.num_levels)


# ------------------------------------------------------------- the knobs --

def test_resolve_direction_env_knobs(monkeypatch):
    assert D.resolve_direction() == D.DirectionConfig("auto", 14.0, 24.0)
    monkeypatch.setenv("BFS_TPU_TORCH_DIRECTION", "pull")
    monkeypatch.setenv("BFS_TPU_TORCH_DIRECTION_ALPHA", "7.5")
    monkeypatch.setenv("BFS_TPU_TORCH_DIRECTION_BETA", "48")
    cfg = D.resolve_direction()
    assert (cfg.mode, cfg.alpha, cfg.beta) == ("pull", 7.5, 48.0)
    assert D.resolve_direction("push").mode == "push"  # an explicit mode wins
    # The reference's own knobs do not steer the port.
    monkeypatch.setenv("BFS_TPU_DIRECTION", "push")
    assert D.resolve_direction().mode == "pull"


@pytest.mark.parametrize("name,value", [
    ("BFS_TPU_TORCH_DIRECTION", "sideways"),
    ("BFS_TPU_TORCH_DIRECTION_ALPHA", "-1"),
    ("BFS_TPU_TORCH_DIRECTION_ALPHA", "0"),
    ("BFS_TPU_TORCH_DIRECTION_BETA", "nan"),
    ("BFS_TPU_TORCH_DIRECTION_BETA", "many"),
])
def test_resolve_direction_rejects_bad_knobs(monkeypatch, name, value):
    monkeypatch.setenv(name, value)
    with pytest.raises(ValueError, match=name):
        D.resolve_direction()
    with pytest.raises(ValueError):
        P.RelayEngine(P.path_graph(8), device="cpu")


def test_knobs_mirror_the_reference():
    assert sorted(knobs.KNOBS) == [
        "BFS_TPU_TORCH_CACHE_DIR", "BFS_TPU_TORCH_CKPT", "BFS_TPU_TORCH_CKPT_MTBF_S",
        "BFS_TPU_TORCH_DIRECTION", "BFS_TPU_TORCH_DIRECTION_ALPHA",
        "BFS_TPU_TORCH_DIRECTION_BETA", "BFS_TPU_TORCH_EXCHANGE", "BFS_TPU_TORCH_EXCHANGE_DIV",
        "BFS_TPU_TORCH_EXPANSION", "BFS_TPU_TORCH_FAULT",
        "BFS_TPU_TORCH_JOURNAL", "BFS_TPU_TORCH_JOURNAL_DIR", "BFS_TPU_TORCH_LABELS",
        "BFS_TPU_TORCH_LABELS_GB", "BFS_TPU_TORCH_LABELS_VERIFY", "BFS_TPU_TORCH_LAYOUT_BUILD",
        "BFS_TPU_TORCH_LOCK_ORDER", "BFS_TPU_TORCH_MESH",
        "BFS_TPU_TORCH_PHASE_PROBE", "BFS_TPU_TORCH_ROUTER_COOLDOWN_S", "BFS_TPU_TORCH_ROUTER_FAILURES",
        "BFS_TPU_TORCH_SPANS", "BFS_TPU_TORCH_SSSP_DELTA", "BFS_TPU_TORCH_STREAM_CACHE_GB",
        "BFS_TPU_TORCH_STREAM_VERIFY", "BFS_TPU_TORCH_TILES",
        "BFS_TPU_TORCH_TILES_BUILD", "BFS_TPU_TORCH_TILES_CACHE", "BFS_TPU_TORCH_TRANSFER_GUARD"]
    for name, knob in knobs.KNOBS.items():
        ref = j_knobs.KNOBS[name.replace("BFS_TPU_TORCH_", "BFS_TPU_")]
        assert (knob.type, knob.default) == (ref.kind, ref.default)
        assert knobs.get(name) == ref.parse(ref.default)  # unset: the default
    with pytest.raises(KeyError):
        knobs.get("BFS_TPU_TORCH_NO_SUCH_KNOB")
    with pytest.raises(ValueError):
        D.resolve_direction("sideways")


def test_journal_map_mirrors_the_reference():
    """The port's journal fields are the reference's, restricted to the knobs
    the port has, under the same field names."""
    ref = {key: name.replace("BFS_TPU_", "BFS_TPU_TORCH_")
           for key, name in j_knobs.journal_map().items()}
    assert knobs.journal_map() == {k: v for k, v in ref.items() if v in knobs.KNOBS}
    assert len(knobs.journal_map()) == 10
    for knob in knobs.KNOBS.values():
        ref_knob = j_knobs.KNOBS[knob.name.replace("BFS_TPU_TORCH_", "BFS_TPU_")]
        assert knob.journal_key == ref_knob.journal_key


# ------------------------------------------------ bfs_direction against bfs_tpu --

@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("mode", MODES)
def test_bfs_direction_matches_reference(name, mode):
    g, roots = GRAPHS[name]()
    jg = _jgraph(g)
    cfg = D.DirectionConfig(mode=mode)
    eng = D.DirectionEngine.from_graph(g, device="cpu", config=cfg)
    for s in roots:
        got, sched = eng.run(s)
        want, jsched = JD.bfs_direction(jg, s, config=JD.DirectionConfig(mode=mode))
        _same(got, want)
        assert sched == jsched
        dist, parent = canonical_bfs(jg, s)
        np.testing.assert_array_equal(got.dist, dist)
        np.testing.assert_array_equal(got.parent, parent)
        assert check(jg, got.dist, got.parent, s) == []
        assert len(sched["schedule"]) == got.num_levels
        if mode != "auto":
            assert set(sched["schedule"]) == {mode}
        run = eng.last_run
        assert run["issued_push"] + run["issued_pull"] == run["issued"] == run["live"]
        if run["live"] == got.num_levels:  # no unpacked re-run
            assert run["issued_push"] == sched["push_supersteps"]
            assert run["issued_pull"] == sched["pull_supersteps"]
    # The functional entry point is the engine's run.
    got, sched = D.bfs_direction(g, roots[0], config=cfg, device="cpu")
    assert sched == eng.run(roots[0])[1]


def test_auto_switches_on_the_switchy_fixture():
    g, (s,) = _switchy()
    got, sched = D.bfs_direction(g, s, config=D.DirectionConfig(), device="cpu")
    assert "push" in sched["schedule"] and "pull" in sched["schedule"]
    assert sched["switches"] >= 1 and sched["schedule"][0] == "push"


def test_deep_path_reruns_unpacked_with_the_same_schedule():
    g = P.path_graph(80)
    eng = D.DirectionEngine.from_graph(g, device="cpu")
    got, sched = eng.run(0)
    assert got.num_levels == 80 and len(sched["schedule"]) == 80
    run = eng.last_run
    assert run["live"] == 62 + 80 and run["issued_push"] + run["issued_pull"] == run["issued"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["switchy", "rmat10", "path80"])
def test_bfs_multi_direction_matches_reference(name, mode):
    g, roots = GRAPHS[name]()
    sources = [*roots, 3, 11, 3]
    jg = _jgraph(g)
    got, sched = D.bfs_multi_direction(g, sources, config=D.DirectionConfig(mode=mode),
                                       device="cpu")
    want, jsched = JD.bfs_multi_direction(jg, sources, config=JD.DirectionConfig(mode=mode))
    np.testing.assert_array_equal(got.sources, np.asarray(want.sources))
    _same(got, want)
    assert sched == jsched
    ref = P.bfs_multi(g, sources, device="cpu")
    np.testing.assert_array_equal(got.dist, ref.dist)
    np.testing.assert_array_equal(got.parent, ref.parent)


@pytest.mark.parametrize("alpha,beta", [(1e-9, 1e9), (1e9, 1e9), (1e9, 1e-9), (2.0, 3.0)])
def test_thresholds_move_the_switch(alpha, beta):
    g, (s,) = _switchy()
    got, sched = D.bfs_direction(g, s, config=D.DirectionConfig("auto", alpha, beta),
                                 device="cpu")
    want, jsched = JD.bfs_direction(_jgraph(g), s,
                                    config=JD.DirectionConfig("auto", alpha, beta))
    _same(got, want)
    assert sched == jsched
    if (alpha, beta) == (1e-9, 1e9):
        # Every superstep but the last pushes (at the end the unexplored
        # mass is 0, so any frontier mass satisfies the pull test).
        assert set(sched["schedule"][:-1]) == {"push"}
    if (alpha, beta) == (1e9, 1e9):
        assert set(sched["schedule"]) == {"pull"}


def test_knob_thresholds_reach_the_engine(monkeypatch):
    monkeypatch.setenv("BFS_TPU_TORCH_DIRECTION_ALPHA", "1e-9")
    monkeypatch.setenv("BFS_TPU_TORCH_DIRECTION_BETA", "1e9")
    g, (s,) = _switchy()
    _, sched = D.bfs_direction(g, s, device="cpu")
    assert (sched["alpha"], sched["beta"]) == (1e-9, 1e9)
    assert set(sched["schedule"][:-1]) == {"push"}


# ------------------------------------------------ the predicate and the masses --

def test_take_pull_matches_reference():
    rng = np.random.default_rng(0)
    n = 1000
    prev = rng.random(n) < 0.5
    fsize = rng.integers(0, 1 << 20, n)
    fedges = rng.integers(0, 1 << 26, n)
    mu = rng.integers(0, 1 << 28, n).astype(np.float32)
    nv = rng.integers(1, 1 << 22, n)
    alpha = rng.choice([14.0, 1e-9, 2.5, 1e9], n)
    beta = rng.choice([24.0, 1e-9, 0.75, 1e9], n)
    # Boundary cases: equal masses on both sides of each test.
    fedges[:50], mu[:50], alpha[:50] = 100, 1400.0, 14.0
    fsize[50:100], nv[50:100], beta[50:100] = 1000, 24000, 24.0
    for i in range(n):
        got = D.take_pull(torch.tensor(bool(prev[i])), torch.tensor(int(fsize[i])),
                          torch.tensor(int(fedges[i])), torch.tensor(mu[i]), int(nv[i]),
                          float(alpha[i]), float(beta[i]))
        want = JD.take_pull(jnp.bool_(prev[i]), jnp.int32(fsize[i]), jnp.float32(fedges[i]),
                            jnp.float32(mu[i]), int(nv[i]), float(alpha[i]), float(beta[i]))
        assert bool(got) == bool(want), i


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("trees", [None, 5])
def test_frontier_masses_match_reference(seed, trees):
    rng = np.random.default_rng(seed)
    v = int(rng.integers(33, 3000))
    shape = (v + 1,) if trees is None else (trees, v + 1)
    frontier = rng.random(shape) < rng.random()
    frontier[..., v] = False
    outdeg = rng.integers(0, 200, v + 1).astype(np.int32)
    outdeg[v] = 0
    fs, fe = D.frontier_masses(torch.from_numpy(frontier), torch.from_numpy(outdeg))
    jfs, jfe = JD.frontier_masses(jnp.asarray(frontier), jnp.asarray(outdeg))
    assert (int(fs), int(fe)) == (int(jfs), int(jfe))
    if trees is None:
        n = -(-(v + 1) // 32) * 32
        bits = np.zeros(n, bool)
        bits[: v + 1] = frontier
        od = np.zeros(n, np.int32)
        od[: v + 1] = outdeg
        words = pack_std_host(bits)
        fs2, fe2 = D.frontier_masses_words(torch.from_numpy(words.view(np.int32)),
                                           torch.from_numpy(od), n)
        jfs2, jfe2 = JD.frontier_masses_words(jnp.asarray(words), jnp.asarray(od), n)
        assert (int(fs2), int(fe2)) == (int(jfs2), int(jfe2)) == (int(fs), int(fe))


def test_host_outdeg_matches_reference():
    dg = P.build_device_graph(P.rmat_graph(9, 6, seed=4))
    np.testing.assert_array_equal(D._host_outdeg(dg.num_vertices, dg.src),
                                  JD._host_outdeg(dg.num_vertices, dg.src))


# ------------------------------------------------------- the two-graph loop --

@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("trees", [None, 3])
def test_dead_superstep_on_each_body_changes_nothing(packed, trees):
    """After a run converged (LIVE 0), one more superstep of either body
    leaves the carry, the accumulators, the decision state and the control
    block bit-identical."""
    g, (s,) = _switchy()
    eng = D.DirectionEngine.from_graph(g, device="cpu")
    eng.packed = packed
    if trees is None:
        eng.run(s)
    else:
        eng.run_multi([s, 3, 11][:trees])
    loop = eng._loops[("auto", packed, trees)]
    before = [b.clone() for b in loop.buffers]
    assert before[-1][C.LIVE] == 0
    for body in (0, 1):
        loop.bodies[body].dead_replay()
        for a, b in zip(before, loop.buffers):
            assert torch.equal(a, b)


def test_eager_loop_is_the_plain_version():
    g, (s,) = _switchy()
    eng = D.DirectionEngine.from_graph(g, device="cpu")
    blocks = eng.run(s)
    run = dict(eng.last_run)
    eng.loop = "eager"
    eager = eng.run(s)
    _same(eager[0], blocks[0])
    assert eager[1] == blocks[1]
    erun = eng.last_run
    # One read of the first decision, then one per superstep on both loops.
    assert erun["host_reads"] == run["host_reads"] == blocks[0].num_levels + 1
    for body in ("push", "pull"):
        assert erun[f"issued_{body}"] == run[f"issued_{body}"] == blocks[1][f"{body}_supersteps"]
    assert run["issued"] == run["live"] == blocks[0].num_levels


def test_use_pull_word_and_decision_state():
    """USE_PULL after the run is the decision the loop took last; the
    decision state holds the thresholds and a nonnegative unexplored mass;
    the direction accumulator holds one code per settled level."""
    g, (s,) = _switchy()
    eng = D.DirectionEngine.from_graph(g, device="cpu",
                                       config=D.DirectionConfig("auto", 3.0, 5.0))
    _, sched = eng.run(s)
    *_, occ, dirs, dstate, ctl = eng._loops[("auto", True, None)].buffers
    assert int(ctl[C.USE_PULL]) in (0, 1)
    assert float(dstate[D.ALPHA]) == 3.0 and float(dstate[D.BETA]) == 5.0
    assert float(dstate[D.NTHRESH]) == g.num_vertices and float(dstate[D.MU]) >= 0
    codes = dirs[1 : int(ctl[C.LEVEL]) + 1].tolist()
    assert [T.DIR_NAMES[c] for c in codes] == sched["schedule"]
    assert int(occ.sum()) == int((canonical_bfs(_jgraph(g), s)[0] != P.INF_DIST).sum())


def test_refusals():
    g = P.path_graph(10)
    with pytest.raises(ValueError):
        D.DirectionEngine.from_graph(P.build_pull_graph(g), device="cpu")
    pull_only = D.DirectionEngine(pull=P.EdgeEngine(g, engine="pull", device="cpu"),
                                  config=D.DirectionConfig("auto"))
    with pytest.raises(ValueError, match="push"):
        pull_only.run(0)
    with pytest.raises(ValueError):
        D.DirectionEngine.from_graph(g, device="cpu").run(10)
    with pytest.raises(ValueError):
        D.DirectionEngine()


@pytest.mark.parametrize("n,hub", [(256, 0), (33, 7)])
def test_star_and_snap_generators_match_reference(n, hub):
    from bfs_tpu.graph import generators as JG

    a, b = P.star_graph(n, hub), JG.star_graph(n, hub)
    assert a.num_vertices == b.num_vertices
    np.testing.assert_array_equal(a.src, b.src)
    np.testing.assert_array_equal(a.dst, b.dst)
    np.testing.assert_array_equal(P.snap_shape_edges(1000 + n, 5000, seed=hub),
                                  JG.snap_shape_edges(1000 + n, 5000, seed=hub))


@pytest.mark.parametrize("engine", ["push", "pull", "direction"])
def test_results_outlive_the_next_run(engine):
    """A search past the packed cap ends on the unpacked carry, whose
    buffers the next run reuses: the host result it returned must not
    change when the engine runs again."""
    g = P.path_graph(80)
    if engine == "direction":
        eng = D.DirectionEngine.from_graph(g, device="cpu")
        first, again = eng.run(0)[0], lambda: eng.run(79)
    else:
        eng = P.EdgeEngine(g, engine=engine, device="cpu")
        first, again = eng.run(0), lambda: eng.run(79)
    dist, parent = first.dist.copy(), first.parent.copy()
    assert first.num_levels == 80
    again()
    np.testing.assert_array_equal(first.dist, dist)
    np.testing.assert_array_equal(first.parent, parent)
