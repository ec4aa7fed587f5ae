"""Connected components of the port (``bfs_tpu_torch.algo.cc``) against the
reference's (``bfs_tpu.algo.cc``, XLA on the CPU) and the union-find
oracle, exact equality throughout.

On the reference test's graphs (a sparse multi-component G(n, m), star,
path, rmat): labels and ``rounds`` of the push, pull and ``auto`` arms on
the captured loop and the eager loop; the component queries; the device
check against the reference's on correct and corrupted labels and
``check_cc`` against the reference's; segmented runs at several intervals,
kill and resume under ``BFS_TPU_TORCH_FAULT``, and epochs that either
package writes resumed by the other."""

import os

import numpy as np
import pytest
import torch

import bfs_tpu_torch as P
from bfs_tpu import algo as J
from bfs_tpu.graph.csr import Graph as JGraph
from bfs_tpu.oracle import cc_device_check as j_cc_device_check
from bfs_tpu.oracle import check_cc as j_check_cc
from bfs_tpu.oracle import union_find_labels as j_union_find_labels
from bfs_tpu.resilience import faults as JF
from bfs_tpu.resilience import superstep_ckpt as JC
from bfs_tpu_torch.algo import cc, cc_segmented
from bfs_tpu_torch.models import loop as L
from bfs_tpu_torch.oracle import CC_COUNT_FIELDS, cc_device_check, check_cc, union_find_labels
from bfs_tpu_torch.resilience import faults as F
from bfs_tpu_torch.resilience.faults import FaultInjected
from bfs_tpu_torch.resilience.superstep_ckpt import CkptConfig, SuperstepCheckpointer

GRAPHS = {
    "gnm_multi": lambda: P.gnm_graph(200, 150, seed=7),
    "star": lambda: P.star_graph(64),
    "path": lambda: P.path_graph(200),
    "rmat": lambda: P.rmat_graph(7, 8, seed=2),
}

_cache: dict = {}


def _graph(name):
    if name not in _cache:
        _cache[name] = GRAPHS[name]()
    return _cache[name]


def _jgraph(g) -> JGraph:
    return JGraph(g.num_vertices, g.src.copy(), g.dst.copy())


def _same(got, want) -> None:
    np.testing.assert_array_equal(got.label, np.asarray(want.label))
    assert got.rounds == want.rounds


def _mgr(path, k=1, config=None):
    return SuperstepCheckpointer(path, config or {"algo": "cc"}, cfg=CkptConfig("every", k))


def _jmgr(path, k=1, config=None):
    return JC.SuperstepCheckpointer(path, config or {"algo": "cc"}, cfg=JC.CkptConfig("every", k))


@pytest.mark.parametrize("engine", ["push", "pull"])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_cc_matches_reference_and_union_find(name, engine):
    g = _graph(name)
    oracle = union_find_labels(g)
    np.testing.assert_array_equal(oracle, j_union_find_labels(_jgraph(g)))
    want = J.cc(_jgraph(g), engine=engine)
    got = cc(g, engine=engine, device="cpu")
    assert got.engine == want.engine == engine
    _same(got, want)
    np.testing.assert_array_equal(got.label, oracle)
    assert check_cc(g, got.label) == [] == j_check_cc(_jgraph(g), got.label)
    assert got.num_components == int(np.unique(oracle).size)
    assert got.run["live"] == got.rounds


@pytest.mark.parametrize("engine", ["push", "pull"])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_captured_and_eager_loops_agree(name, engine):
    g = _graph(name)
    eng = P.EdgeEngine(g, engine=engine, device="cpu")
    blocks = cc(eng)
    eng.loop = "eager"
    eager = cc(eng)
    eng.loop = "blocks"
    _same(blocks, eager)
    assert blocks.engine == eager.engine == engine
    assert eager.run["host_reads"] == eager.rounds
    assert (("cc", engine), L.EDGE_BLOCK) in eng._loops
    with pytest.raises(ValueError):
        cc(eng, engine="pull" if engine == "push" else "push")


def test_blocks_of_several_supersteps_agree(monkeypatch):
    g = _graph("gnm_multi")
    base = cc(g, device="cpu")
    for k in (2, 3, 8):
        monkeypatch.setattr(L, "EDGE_BLOCK", k)
        for engine in ("push", "pull"):
            got = cc(g, engine=engine, device="cpu")
            _same(got, base)
            assert got.run["live"] == got.rounds <= got.run["issued"]


def test_auto_engine_resolution_and_layouts():
    dense = P.gnm_graph(64, 1024, seed=1)  # E/V >= 8: pull
    sparse = P.path_graph(64)
    got = cc(dense, engine="auto", device="cpu")
    assert got.engine == J.cc(_jgraph(dense), engine="auto").engine == "pull"
    _same(got, J.cc(_jgraph(dense), engine="auto"))
    assert cc(sparse, engine="auto", device="cpu").engine == "push"
    np.testing.assert_array_equal(got.label, union_find_labels(dense))
    # A prebuilt layout of each arm.
    g = _graph("rmat")
    want = cc(g, device="cpu")
    _same(cc(P.build_device_graph(g), device="cpu"), want)
    _same(cc(P.build_pull_graph(g), engine="pull", device="cpu"), want)
    with pytest.raises(ValueError):
        cc(g, engine="relay", device="cpu")
    with pytest.raises(ValueError):
        cc(P.build_pull_graph(g), engine="push", device="cpu")


def test_component_queries_and_max_rounds():
    g = _graph("gnm_multi")
    res = cc(g, device="cpu")
    oracle = union_find_labels(g)
    assert res.num_components > 1
    same = np.flatnonzero(oracle == oracle[g.src[0]])
    assert res.same_component(int(same[0]), int(same[-1]))
    other = np.flatnonzero(oracle != oracle[g.src[0]])
    assert not res.same_component(int(same[0]), int(other[0]))
    path = _graph("path")
    for engine in ("push", "pull"):
        cut = cc(path, engine=engine, max_rounds=5, device="cpu")
        _same(cut, J.cc(_jgraph(path), engine=engine, max_rounds=5))
        assert cut.rounds == 5


@pytest.mark.parametrize("name", list(GRAPHS))
def test_cc_device_check_against_the_reference(name):
    g = _graph(name)
    res = cc(g, device="cpu")
    dg = P.build_device_graph(g)

    def both(label):
        got = cc_device_check(torch.from_numpy(dg.src), torch.from_numpy(dg.dst), label,
                              g.num_vertices)
        want = j_cc_device_check(dg.src, dg.dst, label, g.num_vertices)
        assert got == want
        assert cc_device_check(g.src, g.dst, label, g.num_vertices, device="cpu") == want
        assert set(got) <= set(CC_COUNT_FIELDS)
        return got

    assert both(res.label) == {}
    v = g.num_vertices - 1
    bad = res.label.copy()
    bad[v] = v  # detach the last vertex from its component's label
    if int(res.label[v]) != v:
        assert both(bad)
        assert check_cc(g, bad) == j_check_cc(_jgraph(g), bad) != []
    bad = res.label.copy()
    bad[0] = g.num_vertices + 3  # out of range and above its id
    assert both(bad).get("label_above_id") == 1


@pytest.mark.parametrize("name", list(GRAPHS))
def test_segmented_bit_identical(name, tmp_path):
    g = _graph(name)
    eng = P.EdgeEngine(g, engine="push", device="cpu")
    fused = cc(eng)
    _same(J.cc_segmented(_jgraph(g), ckpt=_jmgr(tmp_path / "ref", k=2)), fused)
    for k in (1, 2, 3, 1000):
        mgr = _mgr(tmp_path / f"k{k}", k=k)
        res = cc_segmented(eng, ckpt=mgr)
        _same(res, fused)
        assert mgr.report()["segments"] == -(-fused.rounds // k)
        assert mgr.epochs() == []
    off = SuperstepCheckpointer(tmp_path / "off", {"algo": "cc"}, cfg=CkptConfig("off"))
    _same(cc_segmented(g, ckpt=off, device="cpu"), fused)


def test_kill_resume_bit_identical(tmp_path, monkeypatch):
    g = _graph("gnm_multi")
    fused = cc(g, device="cpu")
    monkeypatch.setenv("BFS_TPU_TORCH_FAULT", "raise:superstep:2")
    F.reset()
    with pytest.raises(FaultInjected):
        cc_segmented(g, ckpt=_mgr(tmp_path), device="cpu")
    monkeypatch.delenv("BFS_TPU_TORCH_FAULT")
    F.reset()
    mgr = _mgr(tmp_path)
    res = cc_segmented(g, ckpt=mgr, device="cpu")
    assert mgr.report()["resumed_from_epoch"] == 2
    assert res.run["live"] == fused.rounds - 2
    _same(res, fused)


def test_epochs_cross_between_the_packages(tmp_path, monkeypatch):
    g = _graph("path")
    jg = _jgraph(g)
    fused = cc(g, device="cpu")
    cfg = {"algo": "cc", "graph": "path200"}
    monkeypatch.setenv("BFS_TPU_FAULT", "raise:superstep:4")
    JF.reset()
    with pytest.raises(JF.FaultInjected):
        J.cc_segmented(jg, ckpt=_jmgr(tmp_path / "a", k=2, config=cfg))
    monkeypatch.delenv("BFS_TPU_FAULT")
    JF.reset()
    mgr = _mgr(tmp_path / "a", k=2, config=cfg)
    _same(cc_segmented(g, ckpt=mgr, device="cpu"), fused)
    # The 4th boundary at segments of 2 is round 8.
    assert mgr.report()["resumed_from_epoch"] == 8
    monkeypatch.setenv("BFS_TPU_TORCH_FAULT", "raise:superstep:4")
    F.reset()
    with pytest.raises(FaultInjected):
        cc_segmented(g, ckpt=_mgr(tmp_path / "b", k=2, config=cfg), device="cpu")
    monkeypatch.delenv("BFS_TPU_TORCH_FAULT")
    F.reset()
    (epoch,) = [f for f in os.listdir(tmp_path / "b") if f.endswith("epoch000008.npz")]
    z = np.load(tmp_path / "b" / epoch)
    assert z["label"].dtype == np.int32 and z["frontier"].dtype == np.bool_
    assert z["rounds"].dtype == np.int32 and z["changed"].dtype == np.bool_
    assert int(z["packed_flag"]) == 0
    jmgr = _jmgr(tmp_path / "b", k=2, config=cfg)
    _same(fused, J.cc_segmented(jg, ckpt=jmgr))
    assert jmgr.report()["resumed_from_epoch"] == 8
