"""The mesh's SSSP and CC (``bfs_tpu_torch.algo.sharded``) against the JAX
reference's ``sssp_sharded`` / ``cc_sharded`` and the single-chip port on
the CPU, at 2 and 8 edge shards stacked on the CPU.  All comparisons are
exact."""

import numpy as np
import pytest
import torch

import bfs_tpu_torch as P
from bfs_tpu_torch.algo import cc, cc_sharded, sssp, sssp_sharded
from bfs_tpu_torch.oracle.sssp import dijkstra
from bfs_tpu_torch.algo.substrate import edge_weights_np
from bfs_tpu_torch.parallel import sharded as SH

from bfs_tpu.algo import sharded as JA

from test_torch_sharded import _jgraph, mesh, reference_unchecked

GRAPHS = {
    "rmat9": lambda: P.rmat_graph(9, 8, seed=3),
    "gnm": lambda: P.gnm_graph(300, 500, seed=2),  # several components
}
_cache: dict = {}


def _graph(name: str) -> P.Graph:
    if name not in _cache:
        _cache[name] = GRAPHS[name]()
    return _cache[name]


@pytest.mark.parametrize("delta", [None, "inf"])
@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("name", ["rmat9", "gnm"])
def test_sssp_sharded_matches_the_reference(name, n, delta):
    g = _graph(name)
    got = sssp_sharded(g, 5, mesh=mesh(n), delta=delta)
    with reference_unchecked():
        want = JA.sssp_sharded(_jgraph(g), 5, num_shards=n, delta=delta)
    np.testing.assert_array_equal(got.dist, np.asarray(want.dist))
    np.testing.assert_array_equal(got.parent, np.asarray(want.parent))
    assert (got.rounds, got.delta, got.packed) == (int(want.rounds), int(want.delta), False)
    single = sssp(g, 5, delta=delta, packed=False, device="cpu")
    np.testing.assert_array_equal(got.dist, single.dist)
    np.testing.assert_array_equal(got.parent, single.parent)
    assert got.rounds == single.rounds and got.run["issued"] == got.rounds


@pytest.mark.parametrize("delta", [1, 17, 1 << 20])
@pytest.mark.parametrize("n", [2, 8])
def test_sssp_sharded_matches_the_single_chip_and_dijkstra(n, delta):
    g = _graph("rmat9")
    got = sssp_sharded(g, 0, mesh=mesh(n), delta=delta, max_weight=31)
    single = sssp(g, 0, delta=delta, max_weight=31, packed=False, device="cpu")
    np.testing.assert_array_equal(got.dist, single.dist)
    np.testing.assert_array_equal(got.parent, single.parent)
    assert got.rounds == single.rounds
    dist, parent = dijkstra(g, edge_weights_np(g.src, g.dst, 31), 0)
    np.testing.assert_array_equal(got.dist, dist)
    np.testing.assert_array_equal(got.parent, parent)


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("name", ["rmat9", "gnm"])
def test_cc_sharded_matches_the_reference(name, n):
    g = _graph(name)
    got = cc_sharded(g, mesh=mesh(n))
    with reference_unchecked():
        want = JA.cc_sharded(_jgraph(g), num_shards=n)
    np.testing.assert_array_equal(got.label, np.asarray(want.label))
    assert (got.rounds, got.engine) == (int(want.rounds), want.engine)
    single = cc(g, device="cpu")
    np.testing.assert_array_equal(got.label, single.label)
    assert got.rounds == single.rounds


def test_sharded_algorithms_take_the_mesh_and_refuse_sharded_engines():
    g = _graph("gnm")
    assert cc_sharded(g, mesh=mesh(2, 2)).engine == "push_sharded_x2"
    if not torch.cuda.is_available():  # no card: the default mesh raises, no CPU fallback
        with pytest.raises(RuntimeError, match="devices="):
            cc_sharded(g, num_shards=2)
        with pytest.raises(RuntimeError):
            sssp_sharded(g, 0, num_shards=2)
    eng = SH.ShardedPushEngine(P.build_device_graph(g, num_shards=2, block=64), mesh(2))
    with pytest.raises(ValueError, match="sssp_sharded"):
        sssp(eng, 0)
    with pytest.raises(ValueError, match="cc_sharded"):
        cc(eng)
    with pytest.raises(ValueError, match="out of range"):
        sssp_sharded(g, 300, mesh=mesh(2))
