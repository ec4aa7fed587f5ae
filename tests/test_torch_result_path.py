"""The result path of the port on the CPU against the JAX reference, bit for
bit: ``to_original_device`` and ``multi_tree_to_original_device`` on the
reference's own device states carried across, and the chunked
``extract_results`` against ``bfs_tpu.ops.relay_elem.extract_results``.
The card's pinned copies and two-stream extraction are held against these
in ``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

import bfs_tpu_torch as P
from bfs_tpu_torch.models import bfs as p_bfs
from bfs_tpu_torch.ops import relay as R
from bfs_tpu_torch.ops import relay_elem as RE

from bfs_tpu.graph import benes as j_benes
from bfs_tpu.graph.csr import Graph as JGraph
from bfs_tpu.models.bfs import RelayEngine as JRelayEngine
from bfs_tpu.ops import relay_elem as JRE

pytestmark = pytest.mark.skipif(
    not j_benes.native_available(), reason="native benes router unavailable"
)


def _jgraph(g: P.Graph) -> JGraph:
    return JGraph(g.num_vertices, g.src.copy(), g.dst.copy())


def _t(a) -> torch.Tensor:
    """A reference array (int32 or uint32) -> the port's int32 tensor."""
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a.astype(np.int32))


def _elem_state(jst) -> RE.ElemState:
    return RE.ElemState(_t(jst.visited), _t(jst.frontier), _t(jst.dist_planes),
                        _t(jst.rank_planes), int(jst.level), bool(jst.changed))


@pytest.mark.parametrize("expansion", ["gather", "mxu"])
def test_to_original_device_matches_reference(expansion):
    """The reference's ``run_many_device`` states (slot parents on the
    gather arm, original ids on the MXU arm) mapped by both packages; the
    port's own ``run_many_device`` states map to the same arrays."""
    g = P.rmat_graph(9, 6, seed=4)
    roots = [0, 5, 300]
    ref = JRelayEngine(_jgraph(g), expansion=expansion)
    eng = P.RelayEngine(g, device="cpu", expansion=expansion)
    ours = eng.run_many_device(roots)
    for s, jst, st in zip(roots, ref.run_many_device(roots), ours):
        want_d, want_p = (np.asarray(a) for a in ref.to_original_device(jst, s))
        carried = R.RelayState(_t(jst.dist), _t(jst.parent), None, int(jst.level), None)
        for state in (carried, st):
            d, p = eng.to_original_device(state, s)
            assert d.dtype == p.dtype == torch.int32
            np.testing.assert_array_equal(d.numpy(), want_d)
            np.testing.assert_array_equal(p.numpy(), want_p)
        res = eng.run(s)
        np.testing.assert_array_equal(res.dist, want_d)
        np.testing.assert_array_equal(res.parent, want_p)


def test_multi_tree_to_original_device_matches_reference():
    g = P.rmat_graph(9, 6, seed=4)
    sources = np.random.default_rng(1).choice(g.num_vertices, 64, replace=False).astype(np.int32)
    ref = JRelayEngine(_jgraph(g))
    eng = P.RelayEngine(g, device="cpu")
    jst = ref.run_multi_elem_device(sources)
    st = _elem_state(jst)
    for i in (0, 1, 31, 32, 63):
        want = [np.asarray(a) for a in ref.multi_tree_to_original_device(jst, i, int(sources[i]))]
        got = eng.multi_tree_to_original_device(st, i, int(sources[i]))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b)
    # A state with a leading source axis maps tree by tree.
    many = eng.run_many_device(sources[:3].tolist())
    batched = R.RelayState(torch.stack([s.dist for s in many]),
                           torch.stack([s.parent for s in many]), None, None, None)
    for i in range(3):
        for a, b in zip(eng.multi_tree_to_original_device(batched, i, int(sources[i])),
                        eng.to_original_device(many[i], int(sources[i]))):
            assert torch.equal(a, b)


@pytest.mark.parametrize("chunk", [1, 5, 16, 32])
@pytest.mark.parametrize("count", [32, 96])
def test_chunked_extract_results_matches_reference(monkeypatch, chunk, count):
    """Chunks of 1, 5 (not dividing a group), 16 and 32 trees; one and
    three groups; repeated sources."""
    monkeypatch.setattr(RE, "EXTRACT_TREES", chunk)
    g = P.rmat_graph(8, 6, seed=2)
    rng = np.random.default_rng(count)
    sources = rng.choice(g.num_vertices, count, replace=True).astype(np.int32)
    ref = JRelayEngine(_jgraph(g))
    jst = ref.run_multi_elem_device(sources)
    want_d, want_p = JRE.extract_results(jst, ref.relay_graph, sources)
    eng = P.RelayEngine(g, device="cpu")
    rg = eng.relay_graph
    for tables in (None, eng._rank_tables_device()):
        got_d, got_p = RE.extract_results(_elem_state(jst), rg, sources, eng.old2new,
                                          eng.src_l1, tables)
        np.testing.assert_array_equal(got_d, want_d)
        np.testing.assert_array_equal(got_p, want_p)
    res = eng.run_multi_elem(sources)
    np.testing.assert_array_equal(res.dist, want_d)
    np.testing.assert_array_equal(res.parent, want_p)


def test_to_host_and_rank_tables():
    a = torch.arange(5, dtype=torch.int32)
    (h,) = p_bfs.to_host(a)
    assert isinstance(h, np.ndarray) and h.tolist() == [0, 1, 2, 3, 4]
    rg = P.build_relay_graph(P.rmat_graph(7, 4, seed=1))
    base, stride = RE.rank_tables(rg, "cpu")
    assert base.dtype == stride.dtype == torch.int32 and base.numel() == rg.vr
