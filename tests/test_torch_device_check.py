"""The port's on-device verifier (``bfs_tpu_torch.oracle.device``) against
``bfs_tpu.oracle.device`` and the host ``check()`` on the CPU: valid
results, corrupted parents and distances, the source invariant, coverage
words, and the relay engine's ``to_original_device`` path.  Verdicts must
equal the reference's exactly."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bfs_tpu_torch as P
from bfs_tpu_torch.oracle import device as PD

from bfs_tpu.graph import benes as j_benes
from bfs_tpu.graph.csr import Graph as JGraph
from bfs_tpu.oracle import device as JD
from bfs_tpu.oracle.bfs import canonical_bfs, check, queue_bfs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _graphs():
    tiny = P.read_sedgewick(os.path.join(REPO, "test-sets", "tinyCG.txt"))
    medium = P.read_sedgewick(os.path.join(REPO, "test-sets", "randomG.txt"))
    return {"tiny": tiny, "medium": medium}


def _jgraph(g: P.Graph) -> JGraph:
    return JGraph(g.num_vertices, g.src.copy(), g.dst.copy())


def _agree(g, dist, parent, sources):
    """The port's verdict equals the reference's, and both agree with the
    host ``check()`` on validity."""
    jg = _jgraph(g)
    host = check(jg, dist, parent, sources)
    dev = PD.DeviceChecker.from_graph(g, device="cpu").check(
        torch.from_numpy(np.asarray(dist)), torch.from_numpy(np.asarray(parent)), sources)
    ref = JD.DeviceChecker.from_graph(jg).check(jnp.asarray(dist), jnp.asarray(parent), sources)
    assert dev == ref
    assert (host == []) == (dev == {}), (host, dev)
    return host, dev


@pytest.mark.parametrize("name,sources", [("tiny", 0), ("tiny", 3), ("tiny", [0, 3]),
                                          ("medium", 0), ("medium", [5, 17, 200])])
def test_valid_results(name, sources):
    g = _graphs()[name]
    for bfs_fn in (queue_bfs, canonical_bfs):
        dist, parent = bfs_fn(_jgraph(g), sources)
        host, dev = _agree(g, dist, parent, sources)
        assert host == [] and dev == {}


def test_corrupted_parent_detected():
    g = _graphs()["medium"]
    dist, parent = queue_bfs(_jgraph(g), 0)
    bad = parent.copy()
    reached = np.flatnonzero((dist != P.INF_DIST) & (dist > 0))
    w = int(reached[-1])
    non_neighbours = np.setdiff1d(np.arange(g.num_vertices), _jgraph(g).adj(w))
    bad[w] = int(non_neighbours[non_neighbours != w][0])
    host, dev = _agree(g, dist, bad, 0)
    assert host != [] and ("tree_edge_missing" in dev or "tree_dist_mismatch" in dev)


def test_parentless_reached_vertex_detected():
    g = _graphs()["tiny"]
    dist, parent = queue_bfs(_jgraph(g), 0)
    bad = parent.copy()
    bad[int(np.flatnonzero(dist == 1)[0])] = P.NO_PARENT
    host, dev = _agree(g, dist, bad, 0)
    assert host != [] and dev.get("reached_without_parent") == 1


@pytest.mark.parametrize("value", [7, P.INF_DIST, 0])
def test_corrupted_dist_detected(value):
    g = _graphs()["medium"]
    dist, parent = queue_bfs(_jgraph(g), 0)
    bad = dist.copy()
    bad[int(np.flatnonzero(dist == 1)[0])] = value
    host, dev = _agree(g, bad, parent, 0)
    assert host != [] and dev


def test_source_distance_invariant():
    g = _graphs()["tiny"]
    dist, parent = queue_bfs(_jgraph(g), 0)
    bad = dist.copy()
    bad[0] = 1
    _, dev = _agree(g, bad, parent, 0)
    assert dev.get("source_dist_nonzero") == 1


@pytest.mark.parametrize("seed", range(4))
def test_random_corruptions_match_reference(seed):
    """Random dist and parent corruptions, sentinel-padded edges included
    (a DeviceGraph): the six counters equal the reference's."""
    rng = np.random.default_rng(seed)
    g = P.rmat_graph(8, 6, seed=seed)
    dg = P.build_device_graph(g, block=64)
    sources = rng.choice(g.num_vertices, 3, replace=False)
    dist, parent = canonical_bfs(_jgraph(g), sources)
    dist, parent = dist.copy(), parent.copy()
    idx = rng.choice(g.num_vertices, 10, replace=False)
    dist[idx[:5]] = rng.integers(0, 9, 5)
    parent[idx[5:]] = rng.integers(-1, g.num_vertices, 5)
    got = PD.DeviceChecker.from_graph(dg, device="cpu").counts(
        torch.from_numpy(dist), torch.from_numpy(parent), sources)
    want = JD.DeviceChecker(dg.src, dg.dst, dg.num_vertices).counts(
        jnp.asarray(dist), jnp.asarray(parent), sources)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_coverage_mismatch_counts_bits():
    g = _graphs()["tiny"]
    dist, _ = queue_bfs(_jgraph(g), 0)
    dc = PD.DeviceChecker.from_graph(g, device="cpu")
    ref = dc.packed_reached(torch.from_numpy(dist))
    jref = JD.DeviceChecker.from_graph(_jgraph(g)).packed_reached(jnp.asarray(dist))
    np.testing.assert_array_equal(ref.numpy().view(np.uint32), np.asarray(jref))
    assert dc.coverage_mismatch(torch.from_numpy(dist), ref) == 0
    other = dist.copy()
    other[4] = P.INF_DIST
    assert dc.coverage_mismatch(torch.from_numpy(other), ref) == 1


def test_engine_operands_and_sentinel_slots():
    """The push engine's device edges (dst int64) serve as they are, and a
    state with the engines' sentinel slot verifies as the cut one does."""
    g = _graphs()["medium"]
    eng = P.EdgeEngine(g, engine="push", device="cpu")
    dc = PD.DeviceChecker(eng.src, eng.dst, eng.num_vertices)
    st, _ = eng.fused(0, g.num_vertices, packed=False)
    assert st.dist.shape[0] == g.num_vertices + 1
    assert dc.check(st.dist, st.parent, 0) == {}
    assert dc.ok(st.dist[: g.num_vertices], st.parent[: g.num_vertices], 0)
    assert dc.edge_bytes == (eng.src.numel() + eng.dst.numel()) * 4


def test_relay_to_original_device_parity():
    if not j_benes.native_available():
        pytest.skip("requires the native benes router")
    g = _graphs()["medium"]
    eng = P.RelayEngine(g, device="cpu")
    state = eng.run_many_device([0])[0]
    dist_d, parent_d = eng.to_original_device(state, 0)
    res = eng.run(0)
    np.testing.assert_array_equal(dist_d.numpy(), res.dist)
    np.testing.assert_array_equal(parent_d.numpy(), res.parent)
    assert PD.DeviceChecker.from_graph(g, device="cpu").check(dist_d, parent_d, 0) == {}
    assert check(_jgraph(g), res.dist, res.parent, 0) == []


def test_fields_and_device_choice():
    assert PD.COUNT_FIELDS == JD.COUNT_FIELDS
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            PD.DeviceChecker.from_graph(_graphs()["tiny"])


def test_constructor_device_choice():
    """Host edge arrays go to the card unless the caller names the CPU
    (without a card that raises); tensor edges keep their device; a result
    tensor on another device than the checker's raises, not copied."""
    g = _graphs()["tiny"]
    src, dst = g.src.copy(), g.dst.copy()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            PD.DeviceChecker(src, dst, g.num_vertices)
    dc = PD.DeviceChecker(src, dst, g.num_vertices, device="cpu")
    assert dc.device == torch.device("cpu") and dc.src.dtype == torch.int32
    same = PD.DeviceChecker(torch.from_numpy(src), torch.from_numpy(dst), g.num_vertices)
    assert same.device == torch.device("cpu")
    dist, parent = canonical_bfs(_jgraph(g), 0)
    assert dc.check(dist, parent, 0) == {} == same.check(torch.from_numpy(dist), parent, 0)
    with pytest.raises(ValueError, match="meta"):
        dc.check(torch.empty(g.num_vertices, dtype=torch.int32, device="meta"), parent, 0)
