"""The port's serve fleet (``bfs_tpu_torch.serve.FleetRouter``) against the
reference's (``bfs_tpu.serve.FleetRouter``) on the CPU.

The replica ring hashed as the reference hashes it, for 50 seeded (graph,
sources) pairs and rings of 1 to 5 replicas; two replicas over one shared
bundle store (``gnm_graph(150, 400, seed=11)``, labels at K = 6): the
rolling register (replica 0 builds the label sidecar, replica 1 warm-hits
it), full and point queries exact against the oracle and, point by point,
equal to the reference fleet's replies, an epoch swap under load, failover
on a replica closed directly, ``kill_replica``, the router's breaker, and
every replica dead; the router counters of each script equal the
reference fleet's."""

import threading

import numpy as np
import pytest

import bfs_tpu_torch as P
from bfs_tpu_torch.cache.layout import LayoutCache
from bfs_tpu_torch.serve import FleetRouter, NoReplicaAvailable

pytestmark = pytest.mark.fleet_smoke

TIMEOUT = 300
G = "fleet-g"
K = 6


@pytest.fixture(scope="module")
def graphs():
    from bfs_tpu.graph.csr import Graph as JGraph

    g = P.gnm_graph(150, 400, seed=11)
    return g, JGraph(num_vertices=g.num_vertices, src=np.asarray(g.src), dst=np.asarray(g.dst))


def _fleets(graphs, tmp_path, monkeypatch, **kw):
    """The port's fleet on the CPU and the reference's, each over its own
    fresh store, labels at K while registering."""
    from bfs_tpu.cache.layout import LayoutCache as JCache
    from bfs_tpu.serve import FleetRouter as JRouter

    g, jg = graphs
    monkeypatch.setenv("BFS_TPU_TORCH_LABELS", str(K))
    monkeypatch.setenv("BFS_TPU_LABELS", str(K))
    rt = FleetRouter(replicas=2, layout_cache=LayoutCache(str(tmp_path / "p")), max_batch=8,
                     device="cpu", **kw)
    jrt = JRouter(replicas=2, layout_cache=JCache(tmp_path / "r"), max_batch=8, **kw)
    rt.register(G, g)
    jrt.register(G, jg)
    monkeypatch.delenv("BFS_TPU_TORCH_LABELS")
    monkeypatch.delenv("BFS_TPU_LABELS")
    return rt, jrt


@pytest.fixture()
def fleets(graphs, tmp_path, monkeypatch):
    rt, jrt = _fleets(graphs, tmp_path, monkeypatch)
    with rt, jrt:
        yield rt, jrt


def _truth(g, cache, u):
    if u not in cache:
        cache[u] = P.canonical_bfs(g, int(u))[0]
    return cache[u]


def _point(reply):
    return (reply.graph, reply.u, reply.v, reply.dist, reply.method, reply.landmark, reply.path)


def _router_counters(rt):
    return rt.report()["router"]


def _no_replica():
    """Either package's NoReplicaAvailable."""
    from bfs_tpu.serve import NoReplicaAvailable as JNoReplica

    return (NoReplicaAvailable, JNoReplica)


def test_ring_matches_reference():
    from bfs_tpu.serve import FleetRouter as JRouter

    rng = np.random.default_rng(50)
    for n in range(1, 6):
        rt, jrt = FleetRouter(servers=[None] * n), JRouter(servers=[None] * n)
        for i in range(50):
            graph = f"g{int(rng.integers(0, 1000))}"
            sources = rng.integers(0, 1 << 20, size=int(rng.integers(1, 4))).tolist()
            assert rt._ring(graph, sources) == jrt._ring(graph, sources)
            assert rt._ring(graph, np.asarray(sources, np.int32)) == rt._ring(graph, sources)
    assert {FleetRouter(servers=[None] * 2)._ring(G, [s])[0] for s in range(32)} == {0, 1}
    with pytest.raises(ValueError):
        FleetRouter(replicas=0)


def test_rolling_register_shares_the_sidecar(fleets):
    rt, jrt = fleets
    for fleet in fleets:
        counters = [srv.metrics.report()["counters"] for srv in fleet.servers]
        assert counters[0]["label_builds"] == 1
        assert counters[0]["label_build_cache_misses"] == 1
        assert counters[1]["label_builds"] == 1
        assert counters[1]["label_build_cache_hits"] == 1
    assert _router_counters(rt) == _router_counters(jrt)
    assert _router_counters(rt)["router_rolling_registers"] == 2
    assert rt.num_replicas == 2 and rt.alive() == [0, 1]


def test_full_and_point_queries_exact_and_equal(fleets, graphs):
    rt, jrt = fleets
    g, _ = graphs
    cache = {}
    rng = np.random.default_rng(0)
    for s in rng.integers(0, g.num_vertices, size=6).tolist():
        reply = rt.query(G, s).result(TIMEOUT)
        np.testing.assert_array_equal(reply.dist, _truth(g, cache, s))
        np.testing.assert_array_equal(reply.dist, jrt.query(G, s).result(TIMEOUT).dist)
    for u, w in rng.integers(0, g.num_vertices, size=(12, 2)).tolist():
        got = rt.query_dist(G, u, w, want_path=True).result(TIMEOUT)
        assert got.dist == int(_truth(g, cache, u)[w])
        assert _point(got) == _point(jrt.query_dist(G, u, w, want_path=True).result(TIMEOUT))
    assert _router_counters(rt) == _router_counters(jrt)
    assert _router_counters(rt)["router_point_queries"] == 12


def test_epoch_swap_under_load_stays_exact(fleets, graphs, monkeypatch):
    rt, jrt = fleets
    g, jg = graphs
    cache = {}
    v = g.num_vertices
    replies = []

    def load(part):
        for u in range(part, 32, 4):
            replies.append(rt.query_dist(G, u, (u * 7 + 3) % v))
            replies.append(rt.query(G, (u * 5 + 1) % v))

    threads = [threading.Thread(target=load, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    monkeypatch.setenv("BFS_TPU_TORCH_LABELS", str(K))
    rt.register(G, g)  # a rolling epoch bump mid-load
    for t in threads:
        t.join()
    replies += [rt.query_dist(G, u, (u * 5 + 1) % v) for u in range(8)]
    for f in replies:
        r = f.result(TIMEOUT)
        if hasattr(r, "u"):
            assert r.dist == int(_truth(g, cache, r.u)[r.v])
        else:
            np.testing.assert_array_equal(r.dist, _truth(g, cache, int(r.sources[0])))
    assert _router_counters(rt)["router_rolling_registers"] == 4
    assert all(srv.registry.epoch(G) == 1 for srv in rt.servers)
    assert all(list(srv.report()["labels"]) == [f"{G}@1"] for srv in rt.servers)
    # The reference's swap leaves the same replica state.
    monkeypatch.setenv("BFS_TPU_LABELS", str(K))
    jrt.register(G, jg)
    for srv, jsrv in zip(rt.servers, jrt.servers):
        c, jc = srv.metrics.report()["counters"], jsrv.metrics.report()["counters"]
        for key in ("label_builds", "label_build_cache_hits", "label_build_cache_misses",
                    "epochs_swapped"):
            assert c.get(key, 0) == jc.get(key, 0), key


def test_failover_on_a_closed_replica(fleets, graphs):
    rt, jrt = fleets
    g, _ = graphs
    cache = {}
    victim = rt._ring(G, [0, 1])[0]
    assert victim == jrt._ring(G, [0, 1])[0]
    for fleet in fleets:
        fleet.servers[victim].close()
    for fleet in fleets:
        reply = fleet.query_dist(G, 0, 1).result(TIMEOUT)
        assert reply.dist == int(_truth(g, cache, 0)[1])
        for s in range(10):
            reply = fleet.query(G, s).result(TIMEOUT)
            np.testing.assert_array_equal(reply.dist, _truth(g, cache, s))
    c = _router_counters(rt)
    assert c == _router_counters(jrt)
    assert c["router_failovers"] >= 1 and c["router_breaker_opens"] >= 1
    assert c["replicas"][victim]["breaker_open"]


def test_kill_replica_routes_around(fleets, graphs):
    rt, jrt = fleets
    g, _ = graphs
    cache = {}
    for fleet in fleets:
        fleet.kill_replica(1)
        assert fleet.alive() == [0]
        for s in (3, 90):
            np.testing.assert_array_equal(fleet.query(G, s).result(TIMEOUT).dist,
                                          _truth(g, cache, s))
        assert fleet.query_dist(G, 3, 90).result(TIMEOUT).dist == int(_truth(g, cache, 3)[90])
    c = _router_counters(rt)
    assert c == _router_counters(jrt)
    assert c["router_replicas_killed"] == 1 and c["replicas"][1]["dead"]
    rt.unregister(G)  # the dead replica is skipped
    with pytest.raises(KeyError):
        rt.query(G, 0)


def test_all_replicas_dead_raises(fleets, graphs):
    rt, jrt = fleets
    g, jg = graphs
    for fleet, graph in ((rt, g), (jrt, jg)):
        fleet.kill_replica(0)
        fleet.kill_replica(1)
        with pytest.raises(_no_replica()):
            fleet.query(G, 0)
        with pytest.raises(_no_replica()):
            fleet.query_dist(G, 0, 1)
        with pytest.raises(_no_replica()):
            fleet.register(G, graph)
    c = _router_counters(rt)
    assert c == _router_counters(jrt)
    assert c["router_rejected"] == 2 and c["router_replicas_killed"] == 2
    with pytest.raises(NoReplicaAvailable):
        rt.query(G, 0)


@pytest.mark.chaos
def test_breaker_falls_back_to_open_replicas(graphs, tmp_path, monkeypatch):
    """Both replicas closed directly, threshold 1: each rejection opens its
    breaker, so the next query finds no usable replica, takes the open
    ones as a last resort, and is rejected, as in the reference."""
    rt, jrt = _fleets(graphs, tmp_path, monkeypatch, failure_threshold=1, cooldown_s=60.0)
    with rt, jrt:
        for fleet in (rt, jrt):
            for srv in fleet.servers:
                srv.close()
            for _ in range(2):
                f = fleet.query(G, 5)
                with pytest.raises(_no_replica()):
                    f.result(TIMEOUT)
        c = _router_counters(rt)
        assert c == _router_counters(jrt)
        assert c["router_breaker_opens"] == 4 and c["router_rejected"] == 2
        assert all(st["breaker_open"] for st in c["replicas"])
