"""Registry-resident semiring algorithms of the port
(``bfs_tpu_torch.serve.algo``) against the reference's
(``bfs_tpu.serve.algo``) on the CPU.

On the reference test's graph (``gnm_graph(300, 2100, seed=5)``, source 3,
max weight 31): ``registry_sssp`` and ``registry_cc`` (push and pull) equal
the reference's replies bit for bit and the oracles; the second call rides
the same resident engine with no new upload and no new loop; the weights and
loops the engine keeps are counted by ``device_bytes``; no pin is left; the
engine-name guard; and the calls hold the server's device lock."""

import threading

import numpy as np
import pytest

import bfs_tpu_torch as P
from bfs_tpu.graph.csr import Graph as JGraph
from bfs_tpu.serve import GraphRegistry as JRegistry
from bfs_tpu.serve import registry_cc as j_registry_cc
from bfs_tpu.serve import registry_sssp as j_registry_sssp
from bfs_tpu_torch.algo import edge_weights_np
from bfs_tpu_torch.oracle import dijkstra, union_find_labels
from bfs_tpu_torch.serve import GraphRegistry, registry_cc, registry_sssp
from bfs_tpu_torch.serve.executor import DEVICE_LOCK
from bfs_tpu_torch.serve.registry import device_bytes

MAXW = 31
SOURCE = 3


@pytest.fixture(scope="module")
def graph():
    return P.gnm_graph(300, 2100, seed=5)


@pytest.fixture(scope="module")
def jregistry(graph):
    reg = JRegistry()
    reg.register("g", JGraph(graph.num_vertices, graph.src.copy(), graph.dst.copy()))
    return reg


@pytest.fixture()
def registry(graph):
    reg = GraphRegistry(device="cpu")
    reg.register("g", graph)
    return reg


@pytest.mark.parametrize("packed", [None, False])
@pytest.mark.parametrize("delta", [None, 17, "inf"])
def test_registry_sssp_matches_the_reference(registry, jregistry, graph, delta, packed):
    want = j_registry_sssp(jregistry, "g", SOURCE, max_weight=MAXW, delta=delta, packed=packed)
    odist, opar = dijkstra(graph, edge_weights_np(graph.src, graph.dst, MAXW), SOURCE)
    for _ in range(2):
        got = registry_sssp(registry, "g", SOURCE, max_weight=MAXW, delta=delta, packed=packed)
        np.testing.assert_array_equal(got.dist, np.asarray(want.dist))
        np.testing.assert_array_equal(got.parent, np.asarray(want.parent))
        assert (got.rounds, got.packed, got.delta) == (want.rounds, want.packed, want.delta)
        np.testing.assert_array_equal(got.dist, odist)
        np.testing.assert_array_equal(got.parent, opar)


@pytest.mark.parametrize("engine", ["push", "pull"])
def test_registry_cc_matches_the_reference(registry, jregistry, graph, engine):
    want = j_registry_cc(jregistry, "g", engine=engine)
    for _ in range(2):
        got = registry_cc(registry, "g", engine=engine)
        assert got.engine == want.engine == engine
        np.testing.assert_array_equal(got.label, np.asarray(want.label))
        assert got.rounds == want.rounds
        np.testing.assert_array_equal(got.label, union_find_labels(graph))
    cut = registry_cc(registry, "g", engine=engine, max_rounds=2)
    assert cut.rounds == j_registry_cc(jregistry, "g", engine=engine, max_rounds=2).rounds == 2


def test_second_call_rides_the_resident_engine(registry, graph):
    first = registry_sssp(registry, "g", SOURCE, max_weight=MAXW)
    assert ("g", 0, "push") in registry.resident_keys()
    eng = registry.acquire("g", "push")
    loops = dict(eng._loops)
    bytes_before = device_bytes(eng)
    again = registry_sssp(registry, "g", SOURCE, max_weight=MAXW)
    np.testing.assert_array_equal(first.dist, again.dist)
    registry_cc(registry, "g")  # the same resident push engine
    assert registry.acquire("g", "push") is eng
    assert registry.resident_keys().count(("g", 0, "push")) == 1
    # The second SSSP call made no new loop and no new weights.
    assert {k: v for k, v in eng._loops.items() if k in loops} == loops
    assert device_bytes(eng) >= bytes_before
    # The weights and the loop buffers are counted on the engine.
    fresh = P.EdgeEngine(registry.layout("g", "push"), engine="push", device="cpu")
    assert device_bytes(eng) >= device_bytes(fresh) + 4 * eng.src.numel() + 4 * (graph.num_vertices + 1)
    # The registry's budget counts them from the engine's next acquire.
    registry.acquire("g", "push")
    assert registry.resident_bytes() == device_bytes(eng)


def test_registry_algo_leaves_no_pins_and_checks_engines(registry):
    registry_sssp(registry, "g", SOURCE, max_weight=MAXW)
    registry_cc(registry, "g", engine="pull")
    assert registry.get("g").pins == 0
    with pytest.raises(ValueError, match="unknown engine"):
        registry_cc(registry, "g", engine="relay")
    with pytest.raises(ValueError):
        registry_sssp(registry, "g", 10_000)
    assert registry.get("g").pins == 0


def test_registry_calls_hold_the_device_lock(registry):
    """A call waits while another thread holds the server's device lock."""
    done = threading.Event()
    with DEVICE_LOCK:
        t = threading.Thread(target=lambda: (registry_cc(registry, "g"), done.set()))
        t.start()
        assert not done.wait(0.3)
    t.join(timeout=60)
    assert done.is_set()
