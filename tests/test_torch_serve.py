"""The port's query server (``bfs_tpu_torch.serve``) against the reference's
(``bfs_tpu.serve``) on the CPU.

The same ticks of queries (staged with ``pause``/``resume``, so each tick
is one batch in both servers) go through ``bfs_tpu.serve.BfsServer`` and
``bfs_tpu_torch.serve.BfsServer(device="cpu")`` on pull, push and relay
(relay at a bucket of 32, element-major, and below it, lock-step), on the
reference's serve fixture ``gnm_graph(150, 400, seed=11)`` and on a path
deeper than the packed carry's 62 levels and the element-major batch's 31:
every reply's ``dist``, ``parent``, ``num_levels``, status and batch size
are equal, and equal to the oracle.  Then the serve contract of
``tests/test_serve.py`` on the port: coalescing, the executable cache, the
result LRU, deadlines, backpressure, oracle degradation, eviction under a
capped budget, unregister, close and submit validation."""

import threading
import time

import numpy as np
import pytest
import torch

import bfs_tpu_torch as P
from bfs_tpu_torch.serve import (
    AdmissionError,
    BfsServer,
    GraphRegistry,
    QueryTimeout,
    ServerClosed,
)
from bfs_tpu_torch.serve.registry import device_bytes, layout_device_bytes

TIMEOUT = 300


def _ref_graph(g):
    from bfs_tpu.graph.csr import Graph as JGraph

    return JGraph(num_vertices=g.num_vertices, src=np.asarray(g.src), dst=np.asarray(g.dst))


def _graphs():
    return {
        "gnm": P.gnm_graph(150, 400, seed=11),
        "path": P.path_graph(70),
    }


GRAPHS = _graphs()

# One tick per entry: (mode, sources) requests.  The first tick mixes the
# three modes (3 + 3 + 2 = 8 sources: bucket 8), the second is 32 singles
# (bucket 32: relay runs element-major), the third 5 singles (bucket 8
# again: an executable-cache hit).
TICKS = {
    "gnm": [
        [("single", [0]), ("single", [7]), ("single", [149]), ("collapse", [3, 77, 140]),
         ("tree", [5, 60])],
        [("single", [s]) for s in range(10, 138, 4)],
        [("single", [s]) for s in (1, 2, 4, 8, 16)],
    ],
    "path": [
        [("single", [0]), ("single", [69]), ("collapse", [10, 50]), ("tree", [3, 35])],
        [("single", [s]) for s in range(1, 65, 2)],
    ],
}


def _serve(server_cls, graph, engine, ticks, **kw):
    """Each tick's requests staged while batching is held, then released:
    one batch per tick."""
    replies = []
    with server_cls(engine=engine, max_batch=32, **kw) as srv:
        srv.register("g", graph)
        for tick in ticks:
            srv.pause()
            futs = [srv.submit("g", srcs, mode=mode) for mode, srcs in tick]
            srv.resume()
            replies += [f.result(TIMEOUT) for f in futs]
        report = srv.report()
    return replies, report


def _oracle_check(g, mode, srcs, reply):
    if mode == "single":
        d, p = P.canonical_bfs(g, srcs[0])
        np.testing.assert_array_equal(reply.dist, d)
        np.testing.assert_array_equal(reply.parent, p)
    elif mode == "tree":
        for i, s in enumerate(srcs):
            d, p = P.canonical_bfs(g, s)
            np.testing.assert_array_equal(reply.dist[i], d)
            np.testing.assert_array_equal(reply.parent[i], p)
    else:
        d, _ = P.queue_bfs(g, srcs)
        np.testing.assert_array_equal(reply.dist, d)
        assert P.check(g, reply.dist, reply.parent, srcs) == []


@pytest.mark.parametrize("engine", ["pull", "push", "relay"])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_replies_match_the_reference_server(name, engine):
    from bfs_tpu.serve import BfsServer as JServer

    g = GRAPHS[name]
    ticks = TICKS[name]
    got, report = _serve(BfsServer, g, engine, ticks, device="cpu")
    want, _ = _serve(JServer, _ref_graph(g), engine, ticks)
    requests = [r for tick in ticks for r in tick]
    assert len(got) == len(want) == len(requests)
    for (mode, srcs), a, b in zip(requests, got, want):
        np.testing.assert_array_equal(a.dist, b.dist)
        np.testing.assert_array_equal(a.parent, b.parent)
        assert a.dist.dtype == b.dist.dtype == np.int32
        assert (a.num_levels, a.record.status, a.record.batch_size, a.mode) == (
            b.num_levels, b.record.status, b.record.batch_size, b.mode)
        _oracle_check(g, mode, srcs, a)
    assert {r.record.batch_size for r in got} == {8, 32}
    # Every tick ran on the device path of the port's engines.
    counters = report["counters"]
    assert counters.get("oracle_served", 0) == 0 and counters.get("device_errors", 0) == 0
    if name == "gnm":
        assert counters["compile_hits"] == 1  # the third tick, bucket 8 again


@pytest.mark.parametrize("engine", ["pull", "push", "relay"])
def test_resident_bytes_count_the_engines_tensors(engine):
    g = GRAPHS["gnm"]
    reg = GraphRegistry(device="cpu")
    reg.register("g", g)
    eng = reg.acquire("g", engine)
    layout = reg.layout("g", engine)
    assert layout_device_bytes(layout, engine) == device_bytes(eng)
    assert reg.resident_bytes() == device_bytes(eng)
    if engine == "push":
        assert eng.dst.dtype == torch.int64
        assert device_bytes(eng) == 12 * layout.padded_edges


# ------------------------------------------------------ the serve contract --


@pytest.fixture(scope="module")
def served_graph():
    return GRAPHS["gnm"]


@pytest.fixture(scope="module")
def server(served_graph):
    with BfsServer(device="cpu", max_batch=8) as srv:
        srv.register("g", served_graph)
        yield srv


def test_device_argument(served_graph):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BfsServer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GraphRegistry()
    reg = GraphRegistry(device="cpu")
    with pytest.raises(ValueError):
        BfsServer(reg, device="meta")


def test_batch_coalescing_across_concurrent_submitters(server):
    server.pause()
    futs = {}
    threads = []

    def submit(s):
        futs[s] = server.query("g", s)

    for s in range(100, 106):
        t = threading.Thread(target=submit, args=(s,))
        t.start()
        threads.append(t)
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    batches_before = server.metrics.count("batches")
    server.resume()
    replies = {s: futs[s].result(TIMEOUT) for s in futs}
    assert server.metrics.count("batches") == batches_before + 1
    assert {r.record.batch_size for r in replies.values()} == {8}  # 6 -> bucket 8
    for s, r in replies.items():
        _oracle_check(server.registry.get("g").graph, "single", [s], r)
    tick = server.tick_log()[-1]
    assert (tick["bucket"], tick["sources"], tick["requests"]) == (8, 6, 6)
    assert tick["kept_bytes"] == 6 * 2 * 4 * 150


def test_executable_cache_hit_on_second_same_shape_batch(served_graph):
    with BfsServer(device="cpu", max_batch=4, result_cache_size=0) as srv:
        srv.register("g", served_graph)
        first = srv.query("g", 1).result(TIMEOUT)
        assert first.record.compile_hit is False
        second = srv.query("g", 2).result(TIMEOUT)
        assert second.record.compile_hit is True
        assert srv.exe_cache.hits == 1 and srv.exe_cache.misses == 1
        assert srv.report()["compile_hit_rate"] == 0.5


def test_result_lru_cache_serves_repeats(served_graph):
    with BfsServer(device="cpu", max_batch=4) as srv:
        srv.register("g", served_graph)
        r1 = srv.query("g", 9).result(TIMEOUT)
        r2 = srv.query("g", 9).result(TIMEOUT)
        assert r1.record.status == "ok"
        assert r2.record.status == "result_cache"
        np.testing.assert_array_equal(r1.dist, r2.dist)
        np.testing.assert_array_equal(r1.parent, r2.parent)


def test_deadline_expiry_returns_timeout_not_wrong_answer(server):
    server.pause()
    expired = server.query("g", 120, timeout_s=0.0)
    live = server.query("g", 121, timeout_s=60.0)
    time.sleep(0.02)
    server.resume()
    with pytest.raises(QueryTimeout):
        expired.result(TIMEOUT)
    reply = live.result(TIMEOUT)
    assert reply.record.status == "ok"
    _oracle_check(server.registry.get("g").graph, "single", [121], reply)


def test_admission_queue_backpressure(served_graph):
    with BfsServer(device="cpu", max_batch=4, queue_depth=2, result_cache_size=0) as srv:
        srv.register("g", served_graph)
        srv.pause()
        srv.query("g", 1)
        srv.query("g", 2)
        with pytest.raises(AdmissionError):
            srv.query("g", 3)
        assert srv.metrics.count("rejected") == 1
        srv.resume()


def test_oracle_degradation_for_tiny_graphs():
    tiny = P.read_sedgewick("test-sets/tinyCG.txt")
    with BfsServer(device="cpu", oracle_max_vertices=100) as srv:
        srv.register("t", tiny)
        reply = srv.query("t", 0).result(TIMEOUT)
        assert reply.record.status == "oracle"
        assert reply.dist.tolist() == [0, 1, 1, 2, 2, 1]
        assert reply.parent.tolist() == [0, 0, 0, 2, 2, 0]
        assert len(srv.exe_cache) == 0
        assert srv.metrics.count("oracle_served") == 1


@pytest.mark.parametrize("engine", ["pull", "relay"])
def test_second_graph_evicts_first_under_capped_budget(served_graph, engine):
    other = P.gnm_graph(150, 400, seed=12)
    registry = GraphRegistry(device_budget_bytes=1, device="cpu")
    with BfsServer(registry, engine=engine, max_batch=4) as srv:
        srv.register("a", served_graph)
        srv.register("b", other)
        srv.query("a", 0).result(TIMEOUT)
        eng_a = registry.acquire("a", engine)
        srv.query("b", 0).result(TIMEOUT)
        # B displaced A: A's engine (tensors and captured loops) is gone.
        assert registry.resident_keys() == [("b", 0, engine)]
        assert registry.evictions == 1
        # A still serves correctly from a NEW engine; its runner is a hit.
        ra2 = srv.query("a", 3).result(TIMEOUT)
        assert ra2.record.compile_hit is True
        _oracle_check(served_graph, "single", [3], ra2)
        assert registry.acquire("a", engine) is not eng_a
        assert registry.evictions == 2


def test_device_error_degrades_to_oracle(served_graph, monkeypatch):
    import bfs_tpu_torch.serve.server as server_mod

    def boom(*a, **k):
        raise RuntimeError("simulated device failure")

    monkeypatch.setattr(server_mod, "build_batch_runner", boom)
    with BfsServer(device="cpu", max_batch=4) as srv:
        srv.register("g", served_graph)
        reply = srv.query("g", 2).result(TIMEOUT)
        assert reply.record.status == "oracle"
        assert srv.metrics.count("device_errors") == 1
        _oracle_check(served_graph, "single", [2], reply)


def test_submit_validation(server):
    with pytest.raises(KeyError):
        server.query("nope", 0)
    with pytest.raises(ValueError):
        server.query("g", 150)  # out of range
    with pytest.raises(ValueError):
        server.submit("g", [1, 2], mode="single")
    with pytest.raises(ValueError):
        server.submit("g", [1], mode="bogus")
    with pytest.raises(ValueError):
        server.submit("g", [1], engine="bogus")
    with pytest.raises(ValueError):
        server.query_dist("g", 0, 150)


def test_query_dist_and_path_take_the_exact_path(server, served_graph):
    d, p = P.canonical_bfs(served_graph, 0)
    target = int(np.argmax(np.where(d == P.INF_DIST, -1, d)))
    reply = server.query_path("g", 0, target).result(TIMEOUT)
    assert (reply.dist, reply.method) == (int(d[target]), "exact")
    assert reply.path[0] == 0 and reply.path[-1] == target
    assert len(reply.path) == int(d[target]) + 1
    assert all(p[b] == a for a, b in zip(reply.path, reply.path[1:]))
    assert server.query_dist("g", 0, target).result(TIMEOUT).path is None


def test_close_fails_pending_and_rejects_new(served_graph):
    srv = BfsServer(device="cpu", max_batch=4)
    srv.register("g", served_graph)
    srv.pause()
    fut = srv.query("g", 1)
    srv.close()
    with pytest.raises(ServerClosed):
        fut.result(TIMEOUT)
    with pytest.raises(ServerClosed):
        srv.query("g", 2)


def test_unregister_invalidates_caches(served_graph):
    other = P.gnm_graph(150, 400, seed=13)
    with BfsServer(device="cpu", max_batch=4) as srv:
        srv.register("g", served_graph)
        stale = srv.query("g", 0).result(TIMEOUT)
        srv.unregister("g")
        assert len(srv.exe_cache) == 0
        assert srv.registry.resident_keys() == []
        srv.register("g", other)
        fresh = srv.query("g", 0).result(TIMEOUT)
        assert fresh.record.status == "ok"
        assert fresh.record.result_cache_hit is False
        _oracle_check(other, "single", [0], fresh)
        assert not np.array_equal(stale.dist, fresh.dist)


def test_deep_graph_supersteps(server):
    g = P.path_graph(40)
    server.register("path", g)
    reply = server.query("path", 0).result(TIMEOUT)
    np.testing.assert_array_equal(reply.dist, np.arange(40))
    assert reply.num_levels == 40


@pytest.mark.parametrize("ckpt", ["off", "every:64"])
def test_packed_cap_latch(ckpt, monkeypatch):
    """A batch deeper than the packed carry's 62 levels: the first tick
    runs packed, is cut by the cap and runs again unpacked, which latches
    the runner; the second tick runs the unpacked loop once, with the same
    rows.  A graph under the cap never leaves the packed carry.  The fused
    runner and the segmented one (``BFS_TPU_TORCH_CKPT``) alike."""
    from bfs_tpu_torch.serve import SegmentedBatchRunner, build_batch_runner

    monkeypatch.setenv("BFS_TPU_TORCH_CKPT", ckpt)
    deep, shallow = P.path_graph(600), P.gnm_graph(150, 400, seed=11)
    reg = GraphRegistry(device="cpu")
    reg.register("deep", deep)
    reg.register("shallow", shallow)
    sources = np.asarray([0, 599], dtype=np.int32)
    runner = build_batch_runner(reg, "deep", "pull", 2)
    assert isinstance(runner, SegmentedBatchRunner) == (ckpt != "off")
    assert runner.use_packed
    first = runner(sources)
    run1 = dict(runner.last_run)
    assert not runner.use_packed
    second = runner(sources)
    run2 = dict(runner.last_run)
    for res in (first, second):
        for i, s in enumerate(sources.tolist()):
            d, p = P.canonical_bfs(deep, s)
            np.testing.assert_array_equal(res.dist[i], d)
            np.testing.assert_array_equal(res.parent[i], p)
        assert res.num_levels == 600
    # Once: the second tick issues only the unpacked loop's supersteps, the
    # first the packed run's 62 (and, blocked, up to a block more) besides.
    assert run2["issued"] == run2["live"] == 600
    assert 600 + 62 <= run1["issued"] < run2["issued"] + 62 + 64
    if ckpt == "off":
        assert (run1["unpacked_rerun"], run2["unpacked_rerun"]) == (True, False)
    shallow_runner = build_batch_runner(reg, "shallow", "pull", 2)
    for _ in range(2):
        shallow_runner(np.asarray([0, 7], dtype=np.int32))
        assert shallow_runner.use_packed
        assert shallow_runner.last_run.get("unpacked_rerun", False) is False
