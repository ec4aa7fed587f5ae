"""Weighted SSSP of the port (``bfs_tpu_torch.algo.sssp``) against the
reference's (``bfs_tpu.algo.sssp``, XLA on the CPU, no Pallas kernel) and
the host Dijkstra oracle, exact equality throughout.

On the reference test's graphs (star, path, gnm, rmat; source 3, max
weight 31): the endpoint-hash weights against ``edge_weights_np`` and the
reference's traced ``edge_weights`` (also on uint32 ids past 2^31); the
semiring table and the delta knob; ``dist``, ``parent`` and ``rounds``
packed and unpacked at delta 1, 17, inf and the default, on the captured
loop and the eager loop; the packed schedule identity and the
``path_graph(600)`` truncation fallback; the device check against the
reference's on correct and corrupted results; segmented runs at several
intervals, kill and resume under ``BFS_TPU_TORCH_FAULT``, and epochs that
either package writes resumed by the other; the ``graph500_run`` harness
(its statistics on the reference test's inputs, ``run_scale`` on the CPU).
"""

import importlib
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bfs_tpu_torch as P
from bfs_tpu import algo as J
from bfs_tpu.algo import substrate as JS
from bfs_tpu.graph.csr import Graph as JGraph
from bfs_tpu.oracle import sssp_device_check as j_sssp_device_check
from bfs_tpu.resilience import faults as JF
from bfs_tpu.resilience import superstep_ckpt as JC
from bfs_tpu_torch import knobs
from bfs_tpu_torch.algo import (
    DEFAULT_MAX_WEIGHT,
    SEMIRINGS,
    edge_weights_np,
    resolve_delta,
    sssp,
    sssp_segmented,
)
from bfs_tpu_torch.algo.substrate import clamp_cap, edge_weights
from bfs_tpu_torch.models import loop as L
from bfs_tpu_torch.oracle import SSSP_COUNT_FIELDS, check_sssp, dijkstra, sssp_device_check
from bfs_tpu_torch.resilience import faults as F
from bfs_tpu_torch.resilience.faults import FaultInjected
from bfs_tpu_torch.resilience.superstep_ckpt import CkptConfig, SuperstepCheckpointer

S = importlib.import_module("bfs_tpu_torch.algo.sssp")
JSS = importlib.import_module("bfs_tpu.algo.sssp")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAXW = 31
SOURCE = 3
DELTAS = [1, 17, "inf", None]

GRAPHS = {
    "star": lambda: P.star_graph(64),
    "path": lambda: P.path_graph(200),
    "gnm": lambda: P.gnm_graph(300, 2100, seed=5),
    "rmat": lambda: P.rmat_graph(7, 8, seed=2),
}

_cache: dict = {}


def _graph(name):
    if name not in _cache:
        _cache[name] = GRAPHS[name]()
    return _cache[name]


def _jgraph(g) -> JGraph:
    return JGraph(g.num_vertices, g.src.copy(), g.dst.copy())


def _oracle(g, source=SOURCE, max_weight=MAXW):
    return dijkstra(g, edge_weights_np(g.src, g.dst, max_weight), source)


def _same(got, want) -> None:
    np.testing.assert_array_equal(got.dist, np.asarray(want.dist))
    np.testing.assert_array_equal(got.parent, np.asarray(want.parent))
    assert got.rounds == want.rounds


def _mgr(path, k=1, config=None):
    return SuperstepCheckpointer(path, config if config is not None else {"algo": "sssp"},
                                 cfg=CkptConfig("every", k))


def _jmgr(path, k=1, config=None):
    return JC.SuperstepCheckpointer(path, config if config is not None else {"algo": "sssp"},
                                    cfg=JC.CkptConfig("every", k))


# ------------------------------------------------------------- substrate --

def test_semiring_table_is_the_reference_s():
    assert SEMIRINGS.keys() == JS.SEMIRINGS.keys()
    for name, row in SEMIRINGS.items():
        assert vars(row) == vars(JS.SEMIRINGS[name])
    assert DEFAULT_MAX_WEIGHT == JS.DEFAULT_MAX_WEIGHT


@pytest.mark.parametrize("name", list(GRAPHS))
def test_edge_weights_match_the_reference(name):
    g = _graph(name)
    dg = P.build_device_graph(g)
    for mw in (1, MAXW, DEFAULT_MAX_WEIGHT, 2**31 - 1):
        want = edge_weights_np(dg.src, dg.dst, mw)
        np.testing.assert_array_equal(want, JS.edge_weights_np(dg.src, dg.dst, mw))
        got = edge_weights(torch.from_numpy(dg.src), torch.from_numpy(dg.dst).long(), mw)
        np.testing.assert_array_equal(got.numpy(), want)
        traced = np.asarray(JS.edge_weights(jnp.asarray(dg.src), jnp.asarray(dg.dst), mw))
        np.testing.assert_array_equal(got.numpy(), traced)
    assert int(want.min()) >= 1


def test_edge_weights_on_ids_past_2_to_the_31():
    rng = np.random.default_rng(17)
    s = rng.integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32)
    d = rng.integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32)
    s[:4], d[:4] = [0, 2**31, 2**32 - 1, 2**31 - 1], [2**32 - 1, 2**31, 0, 2**31]
    for mw in (7, DEFAULT_MAX_WEIGHT, 2**31 - 1):
        want = JS.edge_weights_np(s, d, mw)
        np.testing.assert_array_equal(edge_weights_np(s, d, mw), want)
        st = torch.from_numpy(s.view(np.int32))  # the device's int32 bit patterns
        dt = torch.from_numpy(d.astype(np.int64))
        np.testing.assert_array_equal(edge_weights(st, dt, mw).numpy(), want)
    with pytest.raises(ValueError):
        edge_weights(st, dt, 0)


def test_resolve_delta_and_knob(monkeypatch):
    monkeypatch.delenv("BFS_TPU_TORCH_SSSP_DELTA", raising=False)
    assert resolve_delta() == 64 == JS.resolve_delta()
    for arg in (17, "inf", "single", 0, -3, "9", 2**40):
        assert resolve_delta(arg) == JS.resolve_delta(arg)
    for raw in ("9", "inf", "infinite", "single", "0", "-1", str(2**40)):
        monkeypatch.setenv("BFS_TPU_TORCH_SSSP_DELTA", raw)
        monkeypatch.setenv("BFS_TPU_SSSP_DELTA", raw)
        assert resolve_delta() == JS.resolve_delta()
        assert knobs.get("BFS_TPU_TORCH_SSSP_DELTA") == resolve_delta()
    monkeypatch.setenv("BFS_TPU_TORCH_SSSP_DELTA", "wide")
    with pytest.raises(ValueError):
        resolve_delta()


def test_packed16_gate_and_round_cap():
    assert S.packed16_fits(S.PACKED16_MAX_V - 1) and not S.packed16_fits(S.PACKED16_MAX_V)
    assert S.PACKED16_MAX_V == JSS.PACKED16_MAX_V
    assert S._rounds_cap(100, 31, None) == JSS._rounds_cap(100, 31, None)
    # Above R-MAT scale 22 at weight 255 the bound passes INT32_MAX: the CAP
    # word takes it clamped.
    assert S._rounds_cap(1 << 23, 255, None) > 2**31 - 1
    assert clamp_cap(S._rounds_cap(1 << 23, 255, None)) == 2**31 - 1


# -------------------------------------------------------- reference parity --

@pytest.mark.parametrize("delta", DELTAS)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_sssp_matches_reference_and_dijkstra(name, delta):
    g = _graph(name)
    odist, opar = _oracle(g)
    want = J.sssp(_jgraph(g), SOURCE, max_weight=MAXW, delta=delta, packed=False)
    np.testing.assert_array_equal(np.asarray(want.dist), odist)
    w = edge_weights_np(g.src, g.dst, MAXW)
    for packed in (False, True):
        got = sssp(g, SOURCE, max_weight=MAXW, delta=delta, packed=packed, device="cpu")
        _same(got, want)
        assert got.packed is packed and got.truncated_fallbacks == 0
        assert got.delta == want.delta
        assert check_sssp(g, w, got.dist, got.parent, SOURCE) == []
        # The run's stats: every superstep issued was live (blocks of one).
        assert got.run["live"] == got.rounds == got.run["issued"]


@pytest.mark.parametrize("name", list(GRAPHS))
def test_packed_matches_the_reference_packed_arm(name):
    g = _graph(name)
    want = J.sssp(_jgraph(g), SOURCE, max_weight=MAXW, packed=True)
    got = sssp(g, SOURCE, max_weight=MAXW, packed=True, device="cpu")
    _same(got, want)
    assert got.packed is want.packed is True


@pytest.mark.parametrize("name", list(GRAPHS))
def test_captured_and_eager_loops_agree(name):
    g = _graph(name)
    eng = P.EdgeEngine(g, engine="push", device="cpu")
    for packed in (False, True):
        blocks = sssp(eng, SOURCE, max_weight=MAXW, packed=packed)
        eng.loop = "eager"
        eager = sssp(eng, SOURCE, max_weight=MAXW, packed=packed)
        eng.loop = "blocks"
        _same(blocks, eager)
        assert eager.run["host_reads"] == eager.rounds
    # Loops and weights stay on the engine, keyed by flavour, delta and max weight.
    assert ("weights", MAXW) in eng._loops
    assert (("sssp", "packed", 64, MAXW), L.EDGE_BLOCK) in eng._loops
    assert (("sssp", "unpacked", 64, MAXW), L.EDGE_BLOCK) in eng._loops


def test_blocks_of_several_supersteps_agree(monkeypatch):
    g = _graph("gnm")
    base = sssp(g, SOURCE, max_weight=MAXW, packed=False, device="cpu")
    for k in (2, 3, 8):
        monkeypatch.setattr(L, "EDGE_BLOCK", k)
        for packed in (False, True):
            got = sssp(g, SOURCE, max_weight=MAXW, packed=packed, device="cpu")
            _same(got, base)
            assert got.run["issued"] >= got.rounds and got.run["live"] == got.rounds


def test_dead_superstep_changes_nothing():
    g = _graph("rmat")
    eng = P.EdgeEngine(g, engine="push", device="cpu")
    w = S.weights(eng._loops, eng.src, eng.dst, MAXW)
    from bfs_tpu_torch.ops import control as C

    ctl = C.new_ctl("cpu")
    C.init_ctl(ctl, 5)
    ctl[C.LIVE] = 0
    for packed in (False, True):
        init = (S.init_packed_sssp_state if packed else S.init_sssp_state)(
            g.num_vertices, SOURCE, 17)
        step = S.sssp_superstep_packed if packed else S.sssp_superstep
        st = step(init, eng.src, eng.dst, w, 17)  # one live superstep first
        dead = step(st, eng.src, eng.dst, w, 17, ctl)
        for a, b in zip(dead[:3], st[:3]):
            assert torch.equal(a, b)
        assert not bool(dead.changed)


def test_packed_schedule_identity_and_truncation_fallback():
    for name in GRAPHS:
        g = _graph(name)
        rp = sssp(g, SOURCE, max_weight=MAXW, packed=True, device="cpu")
        ru = sssp(g, SOURCE, max_weight=MAXW, packed=False, device="cpu")
        _same(rp, ru)
    # path(600) at weight 255: the true eccentricity overflows 16 bits, the
    # clamp canary fires and the driver re-runs unpacked, exact.
    g = P.path_graph(600)
    odist, opar = dijkstra(g, edge_weights_np(g.src, g.dst, DEFAULT_MAX_WEIGHT), 0)
    assert int(odist[odist != P.INF_DIST].max()) > 0xFFFE
    res = sssp(g, 0, packed=True, device="cpu")
    want = J.sssp(_jgraph(g), 0, packed=True)
    assert res.packed is False and res.truncated_fallbacks == 1 == want.truncated_fallbacks
    _same(res, want)
    np.testing.assert_array_equal(res.dist, odist)
    np.testing.assert_array_equal(res.parent, opar)
    with pytest.raises(ValueError, match="packed16"):
        sssp(P.path_graph(S.PACKED16_MAX_V), 0, packed=True, device="cpu")
    with pytest.raises(ValueError):
        sssp(g, 600, device="cpu")


# ---------------------------------------------------------- device check --

@pytest.mark.parametrize("name", list(GRAPHS))
def test_sssp_device_check_against_the_reference(name):
    g = _graph(name)
    res = sssp(g, SOURCE, max_weight=MAXW, packed=False, device="cpu")
    dg = P.build_device_graph(g)

    def both(dist, parent):
        got = sssp_device_check(torch.from_numpy(dg.src), torch.from_numpy(dg.dst), dist, parent,
                                SOURCE, g.num_vertices, MAXW)
        want = j_sssp_device_check(dg.src, dg.dst, dist, parent, SOURCE, g.num_vertices, MAXW)
        assert got == want
        assert sssp_device_check(g.src, g.dst, dist, parent, SOURCE, g.num_vertices, MAXW,
                                 device="cpu") == want
        return got

    assert both(res.dist, res.parent) == {}
    bad = res.dist.copy()
    bad[SOURCE] = 1
    assert both(bad, res.parent).get("source_dist_nonzero") == 1
    reached = np.flatnonzero((res.dist != P.INF_DIST) & (np.arange(g.num_vertices) != SOURCE))
    v = int(reached[-1])
    bad = res.dist.copy()
    bad[v] += 5  # too far: an in-edge is relaxable and its tree edge is loose
    assert both(bad, res.parent)
    badp = res.parent.copy()
    badp[v] = -1
    assert both(res.dist, badp).get("reached_without_parent") == 1
    badp[v] = (int(res.parent[v]) + 1) % g.num_vertices
    if badp[v] != res.parent[v]:
        assert both(res.dist, badp)
    assert set(SSSP_COUNT_FIELDS) >= set(both(bad, badp))


# ------------------------------------------------- segmented / kill-resume --

@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_segmented_bit_identical(name, packed, tmp_path):
    g = _graph(name)
    eng = P.EdgeEngine(g, engine="push", device="cpu")
    fused = sssp(eng, SOURCE, max_weight=MAXW, packed=packed)
    want = J.sssp_segmented(_jgraph(g), SOURCE, ckpt=_jmgr(tmp_path / "ref", k=3),
                            max_weight=MAXW, packed=packed)
    _same(fused, want)
    for k in (1, 2, 3, 1000):
        mgr = _mgr(tmp_path / f"k{k}", k=k)
        res = sssp_segmented(eng, SOURCE, ckpt=mgr, max_weight=MAXW, packed=packed)
        _same(res, fused)
        assert res.packed is fused.packed
        rep = mgr.report()
        assert rep["segments"] == -(-fused.rounds // k) and rep["epochs_written"] == rep["segments"]
        assert mgr.epochs() == []  # cleared at the end
    off = SuperstepCheckpointer(tmp_path / "off", {"algo": "sssp"}, cfg=CkptConfig("off"))
    _same(sssp_segmented(eng, SOURCE, ckpt=off, max_weight=MAXW, packed=packed), fused)
    assert not (tmp_path / "off").exists() or list((tmp_path / "off").iterdir()) == []


def test_segmented_truncation_falls_back_unpacked(tmp_path):
    g = P.path_graph(600)
    fused = sssp(g, 0, packed=True, device="cpu")
    res = sssp_segmented(g, 0, ckpt=_mgr(tmp_path, k=200), packed=True, device="cpu")
    _same(res, fused)
    assert res.truncated_fallbacks == 1 and res.packed is False


@pytest.mark.parametrize("packed", [False, True])
def test_kill_resume_bit_identical(packed, tmp_path, monkeypatch):
    g = _graph("gnm")
    fused = sssp(g, SOURCE, max_weight=MAXW, packed=packed, device="cpu")
    monkeypatch.setenv("BFS_TPU_TORCH_FAULT", "raise:superstep:2")
    F.reset()
    with pytest.raises(FaultInjected):
        sssp_segmented(g, SOURCE, ckpt=_mgr(tmp_path), max_weight=MAXW, packed=packed,
                       device="cpu")
    monkeypatch.delenv("BFS_TPU_TORCH_FAULT")
    F.reset()
    mgr = _mgr(tmp_path)
    res = sssp_segmented(g, SOURCE, ckpt=mgr, max_weight=MAXW, packed=packed, device="cpu")
    assert mgr.report()["resumed_from_epoch"] == 2
    assert res.run["live"] == fused.rounds - 2
    _same(res, fused)


@pytest.mark.parametrize("packed", [False, True])
def test_epochs_cross_between_the_packages(packed, tmp_path, monkeypatch):
    g = _graph("rmat")
    jg = _jgraph(g)
    fused = sssp(g, SOURCE, max_weight=MAXW, delta=17, packed=packed, device="cpu")
    cfg = {"algo": "sssp", "packed": packed}
    # The reference killed at its 3rd boundary; the port resumes its epoch.
    monkeypatch.setenv("BFS_TPU_FAULT", "raise:superstep:3")
    JF.reset()
    with pytest.raises(JF.FaultInjected):
        J.sssp_segmented(jg, SOURCE, ckpt=_jmgr(tmp_path / "a", config=cfg), max_weight=MAXW,
                         delta=17, packed=packed)
    monkeypatch.delenv("BFS_TPU_FAULT")
    JF.reset()
    mgr = _mgr(tmp_path / "a", config=cfg)
    res = sssp_segmented(g, SOURCE, ckpt=mgr, max_weight=MAXW, delta=17, packed=packed,
                         device="cpu")
    assert mgr.report()["resumed_from_epoch"] == 3
    _same(res, fused)
    # The port killed at its 3rd boundary; the reference resumes its epoch.
    monkeypatch.setenv("BFS_TPU_TORCH_FAULT", "raise:superstep:3")
    F.reset()
    with pytest.raises(FaultInjected):
        sssp_segmented(g, SOURCE, ckpt=_mgr(tmp_path / "b", config=cfg), max_weight=MAXW,
                       delta=17, packed=packed, device="cpu")
    monkeypatch.delenv("BFS_TPU_TORCH_FAULT")
    F.reset()
    (epoch,) = [f for f in os.listdir(tmp_path / "b") if f.endswith("epoch000003.npz")]
    z = np.load(tmp_path / "b" / epoch)
    word = "packed" if packed else "dist"
    assert z[word].dtype == (np.uint32 if packed else np.int32)
    assert z["dirty"].dtype == np.bool_ and z["changed"].dtype == np.bool_
    assert z["threshold"].dtype == z["rounds"].dtype == np.int32 and z["rounds"].shape == ()
    jmgr = _jmgr(tmp_path / "b", config=cfg)
    want = J.sssp_segmented(jg, SOURCE, ckpt=jmgr, max_weight=MAXW, delta=17, packed=packed)
    assert jmgr.report()["resumed_from_epoch"] == 3
    _same(res, want)


def test_segments_capture_nothing_on_a_captured_engine(tmp_path):
    # On the CPU no graph is captured; what is checked is that a segmented run
    # reuses the fused run's own loop object.
    g = _graph("gnm")
    eng = P.EdgeEngine(g, engine="push", device="cpu")
    sssp(eng, SOURCE, max_weight=MAXW, packed=False)
    loops = dict(eng._loops)
    sssp_segmented(eng, SOURCE, ckpt=_mgr(tmp_path, k=2), max_weight=MAXW, packed=False)
    assert eng._loops == loops


# ------------------------------------------------------- graph500 harness --

def _g5_ref():
    spec = importlib.util.spec_from_file_location(
        "graph500_run_ref", os.path.join(REPO, "tools", "graph500_run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_graph500_statistics_match_the_reference():
    from bfs_tpu_torch.tools import graph500_run as g5

    ref = _g5_ref()
    for times, nedges in ((np.array([1.0, 2.0, 4.0, 8.0]), np.full(4, 100.0)),
                          (np.array([2.0]), np.array([50.0])),
                          (np.array([1.0, 2.0]), np.array([10.0, 10.0]))):
        s = g5.kernel_stats(times, nedges)
        assert s == ref.kernel_stats(times, nedges)
    s = g5.kernel_stats(np.array([1.0, 2.0, 4.0, 8.0]), np.full(4, 100.0))
    assert s["harmonic_mean_TEPS"] == pytest.approx(4 / 0.15)
    assert g5.format_output(5, 16, 2, 0.1, 0.2, {"bfs": s, "sssp": s}) == \
        ref.format_output(5, 16, 2, 0.1, 0.2, {"bfs": s, "sssp": s})
    edges = np.array([[0, 1], [1, 2], [2, 0]], dtype=np.int32)
    g = P.Graph.from_undirected_edges(4, edges)
    roots = g5.sample_roots(g, nbfs=3, seed=7)
    assert 3 not in roots.tolist()
    np.testing.assert_array_equal(roots, ref.sample_roots(_jgraph(g), nbfs=3, seed=7))
    dist = np.array([0, 1, P.INF_DIST, 1], dtype=np.int32)
    assert g5.traversed_edges(g, dist) == ref.traversed_edges(_jgraph(g), dist)


@pytest.mark.parametrize("scale", [6, 8])
def test_graph500_run_scale_on_the_cpu(scale, tmp_path):
    from bfs_tpu_torch.tools import graph500_run as g5

    doc = g5.run_scale(scale, edgefactor=8, nbfs=3, seed=2, max_weight=MAXW, device="cpu")
    ref = _g5_ref().run_scale(scale, edgefactor=8, nbfs=3, seed=2, max_weight=MAXW)
    assert doc["roots"] == ref["roots"] and doc["nbfs"] == 3
    for kernel in ("bfs", "sssp"):
        for key in ("min_nedge", "median_nedge", "max_nedge", "mean_nedge"):
            assert doc[kernel][key] == ref[kernel][key]
        assert doc[kernel]["harmonic_mean_TEPS"] > 0
    lines = g5.capture_lines(doc)
    assert {line["metric"] for line in lines} == {
        f"graph500_s{scale}_bfs_harmonic_TEPS", f"graph500_s{scale}_sssp_harmonic_TEPS"}
    out, cap = tmp_path / "official.txt", tmp_path / "capture.jsonl"
    rc = g5.main(["--scales", str(scale), "--roots", "2", "--seed", "2", "--max-weight", "31",
                  "--out", str(out), "--capture", str(cap), "--no-journal", "--device", "cpu"])
    assert rc == 0
    text = out.read_text()
    assert f"SCALE: {scale}" in text and "sssp validation: PASSED" in text
    assert len(cap.read_text().splitlines()) == 2
