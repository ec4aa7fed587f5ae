"""The port's landmark label tier (``bfs_tpu_torch.serve.labels``, the label
bundle functions of ``bfs_tpu_torch.cache.layout`` and the label branches
of ``BfsServer``) against the reference's (``bfs_tpu.serve.labels``,
``bfs_tpu.cache.layout``, ``bfs_tpu.serve.BfsServer``) on the CPU.

On the reference tests' graphs (``gnm_graph(150, 400, seed=11)``,
``rmat_graph(7, 4, seed=5)``, a star and a disconnected pair of paths):
the landmarks, the label index (``landmarks``, ``dist``, ``parent`` bit for
bit, chunks of 1 and 64, and swept on a resident engine), the bounds
tuple of the lookup on 200 seeded pairs (``u == v`` and disconnected pairs
among them; ``best_k`` the first minimum, as ``jnp.argmin``'s), paths,
bundles written by either package loaded by the other under one key,
``verify_labels_bundle`` on good and corrupted bundles, the budget gate at
exactly ``device_bytes``, a killed build resumed at chunk 2, a reference
label epoch resumed by the port, and the server's replies (``dist``,
``method``, ``landmark``, ``path``) and label counters against the
reference server's for the same pairs and K."""

import os
import shutil

import numpy as np
import pytest
import torch

import bfs_tpu_torch as P
from bfs_tpu_torch.cache import layout as PC
from bfs_tpu_torch.resilience import faults as PF
from bfs_tpu_torch.resilience.superstep_ckpt import SuperstepCheckpointer
from bfs_tpu_torch.serve import BfsServer, LabelBudgetError, LabelOracle
from bfs_tpu_torch.serve import labels as PL

TIMEOUT = 300
K = 6


def _pair_graph():
    edges = np.array([[0, 1], [1, 2], [3, 4], [4, 5]], dtype=np.int32)
    return P.Graph.from_undirected_edges(6, edges)


GRAPHS = {
    "gnm": lambda: P.gnm_graph(150, 400, seed=11),
    "rmat": lambda: P.rmat_graph(7, 4, seed=5),
    "star": lambda: P.star_graph(40),
    "pair": _pair_graph,
}


def _ref_graph(g):
    from bfs_tpu.graph.csr import Graph as JGraph

    return JGraph(num_vertices=g.num_vertices, src=np.asarray(g.src), dst=np.asarray(g.dst))


def _graphs(name):
    g = GRAPHS[name]()
    return g, _ref_graph(g)


def _pairs(g, n, seed):
    """``n`` seeded pairs, the first ten with ``u == v``."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, g.num_vertices, size=n).astype(np.int32)
    v = rng.integers(0, g.num_vertices, size=n).astype(np.int32)
    v[:10] = u[:10]
    return u, v


def _same_index(a, b):
    assert a.num_vertices == b.num_vertices
    for f in ("landmarks", "dist", "parent"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f


# ------------------------------------------------------------- sampling --

@pytest.mark.parametrize("k", [1, K, 64])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_sample_landmarks_match_reference(name, k):
    from bfs_tpu.serve.labels import sample_landmarks

    g, jg = _graphs(name)
    got = PL.sample_landmarks(g, k)
    want = sample_landmarks(jg, k)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        PL.sample_landmarks(g, 0)


# ---------------------------------------------------------------- build --

@pytest.mark.parametrize("chunk", [1, 64])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_build_label_index_matches_reference(name, chunk, tmp_path):
    from bfs_tpu.serve.labels import build_label_index

    g, jg = _graphs(name)
    got = PL.build_label_index(g, 8, chunk=chunk, device="cpu", ckpt_dir=tmp_path / "p")
    want = build_label_index(jg, 8, chunk=chunk, ckpt_dir=tmp_path / "r")
    _same_index(got, want)
    # Swept on one resident engine (the server's way): the same rows.
    eng = P.EdgeEngine(g, engine="pull", device="cpu")
    resident = PL.build_label_index(g, 8, chunk=chunk, device="cpu", ckpt_dir=tmp_path / "e",
                                    sweep=lambda roots: eng.run_multi(roots))
    _same_index(resident, want)


# -------------------------------------------------------- device lookup --

@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_bounds_match_reference(name):
    import jax.numpy as jnp

    from bfs_tpu.serve.labels import LabelOracle as JOracle
    from bfs_tpu.serve.labels import _label_bounds, build_label_index

    g, jg = _graphs(name)
    idx = PL.build_label_index(g, K, device="cpu")
    jidx = build_label_index(jg, K)
    oracle = LabelOracle(idx, device="cpu")
    # The rows on the device: int16 bits of the uint16 labels, K x V x 2 bytes.
    assert oracle._dist_dev.dtype == torch.int16
    assert oracle._dist_dev.numel() * 2 == idx.device_bytes == K * g.num_vertices * 2
    u, v = _pairs(g, 200, seed=3)
    got = oracle.bounds(u, v)
    want = JOracle(jidx).bounds(u, v)
    host = PL.host_label_bounds(idx.dist, u, v)
    raw = [np.asarray(x) for x in _label_bounds(jnp.asarray(jidx.dist), jnp.asarray(u),
                                                 jnp.asarray(v))]
    for a, b, c, d in zip(got, want, host, raw):
        assert a.dtype == b.dtype == c.dtype == d.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(a, d)
    # best_k is the first landmark reaching ``upper`` (jnp.argmin's choice).
    du = jidx.dist[:, u].astype(np.int32)
    dv = jidx.dist[:, v].astype(np.int32)
    both = (du != PL.LABEL_INF) & (dv != PL.LABEL_INF)
    up = jnp.where(jnp.asarray(both), jnp.asarray(du + dv), P.INF_DIST)
    np.testing.assert_array_equal(got[2], np.asarray(jnp.argmin(up, axis=0)))
    assert got[1][:10].all() and (got[0][:10] == 0).all()  # u == v
    assert oracle.report() == {"k": K, "device_bytes": idx.device_bytes, "queries": 200,
                               "tight_hits": int(got[1].sum())}
    with pytest.raises(ValueError):
        oracle.bounds([0], [g.num_vertices])
    with pytest.raises(ValueError):
        oracle.bounds([0, 1], [1])


def test_disconnected_pairs_certified_like_the_reference():
    from bfs_tpu.serve.labels import LabelOracle as JOracle
    from bfs_tpu.serve.labels import build_label_index

    g, jg = _graphs("pair")
    got = LabelOracle(PL.build_label_index(g, 6, device="cpu"), device="cpu").dist(
        [0, 2, 1], [3, 5, 4])
    want = JOracle(build_label_index(jg, 6)).dist([0, 2, 1], [3, 5, 4])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[1].all() and (got[0] == P.INF_DIST).all()


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_path_matches_reference(name):
    from bfs_tpu.serve.labels import LabelOracle as JOracle
    from bfs_tpu.serve.labels import build_label_index

    g, jg = _graphs(name)
    oracle = LabelOracle(PL.build_label_index(g, K, device="cpu"), device="cpu")
    joracle = JOracle(build_label_index(jg, K))
    edges = set(zip(np.asarray(g.src).tolist(), np.asarray(g.dst).tolist()))
    u, v = _pairs(g, 60, seed=7)
    walks = 0
    for a, b in zip(u.tolist(), v.tolist()):
        got, want = oracle.path(a, b), joracle.path(a, b)
        assert got == want
        if got is not None and len(got) > 1:
            assert all((x, y) in edges for x, y in zip(got, got[1:]))
            assert len(got) - 1 == oracle.dist_one(a, b)[0]
            walks += 1
    assert walks or name == "star"


# ------------------------------------------------------- sidecar bundle --

@pytest.mark.parametrize("writer", ["port", "reference"])
def test_bundles_cross_load(writer, tmp_path):
    from bfs_tpu.cache.layout import LayoutCache as JCache
    from bfs_tpu.cache.layout import labels_key, load_or_build_labels

    g, jg = _graphs("gnm")
    assert PC.labels_key(g, 5) == labels_key(jg, 5)
    pcache, jcache = PC.LayoutCache(str(tmp_path)), JCache(tmp_path)
    if writer == "port":
        built, info = PC.load_or_build_labels(g, 5, cache=pcache, device="cpu")
        loaded, linfo = load_or_build_labels(jg, 5, cache=jcache)
    else:
        built, info = load_or_build_labels(jg, 5, cache=jcache)
        loaded, linfo = PC.load_or_build_labels(g, 5, cache=pcache, device="cpu")
    assert (info["cache"], linfo["cache"]) == ("miss", "hit")
    assert info["key"] == linfo["key"] == PC.labels_key(g, 5)
    _same_index(built, loaded)
    assert (info["engine"], info["k"]) == ("pull", 5)


def test_verify_labels_bundle_matches_reference(tmp_path):
    from bfs_tpu.cache.layout import LayoutCache as JCache
    from bfs_tpu.cache.layout import verify_labels_bundle

    g, jg = _graphs("gnm")

    def both(root_p, root_j):
        got = PC.verify_labels_bundle(g, 5, cache=PC.LayoutCache(str(root_p)))
        want = verify_labels_bundle(jg, 5, cache=JCache(root_j))
        assert got == want
        return got

    a, b = tmp_path / "a", tmp_path / "b"
    assert both(a, b)["status"] == "absent"
    idx, _ = PC.load_or_build_labels(g, 5, cache=PC.LayoutCache(str(a)), device="cpu")
    shutil.copytree(a, b)
    verdict = both(a, b)
    assert verdict["ok"] and verdict["device_bytes"] == idx.device_bytes
    assert verdict["index_bytes"] == idx.nbytes
    # Overwritten bytes fail the fingerprint: the bundle is dropped.
    key = PC.labels_key(g, 5)
    for root in (a, b):
        target = max((os.path.join(root, key, f) for f in os.listdir(root / key)),
                     key=os.path.getsize)
        with open(target, "r+b") as f:
            f.seek(0)
            f.write(b"\xff" * 64)
    assert both(a, b)["status"] == "absent"
    # A bundle whose arrays are well-formed but whose labels are not.
    arrays = PL.labels_to_arrays(idx)
    arrays["parent"] = arrays["parent"].copy()
    arrays["parent"][0, idx.landmarks[0]] = (idx.landmarks[0] + 1) % g.num_vertices
    for root in (a, b):
        PC.LayoutCache(str(root)).save(key, arrays)
    bad = both(a, b)
    assert not bad["ok"] and "own parent" in bad["status"]


def test_budget_gate_holds_at_device_bytes(monkeypatch):
    from bfs_tpu.serve.labels import LabelBudgetError as JBudget
    from bfs_tpu.serve.labels import LabelOracle as JOracle
    from bfs_tpu.serve.labels import build_label_index, labels_budget_bytes

    g, jg = _graphs("gnm")
    idx, jidx = PL.build_label_index(g, 4, device="cpu"), build_label_index(jg, 4)
    assert idx.device_bytes == jidx.device_bytes
    for oracle, err, index in ((LabelOracle, LabelBudgetError, idx),
                               (JOracle, JBudget, jidx)):
        kw = {"device": "cpu"} if oracle is LabelOracle else {}
        with pytest.raises(err):
            oracle(index, budget_bytes=index.device_bytes - 1, **kw)
        oracle(index, budget_bytes=index.device_bytes, **kw)  # exactly at budget: ok
    monkeypatch.setenv("BFS_TPU_TORCH_LABELS_GB", "0.5")
    monkeypatch.setenv("BFS_TPU_LABELS_GB", "0.5")
    assert PL.labels_budget_bytes() == labels_budget_bytes() == 1 << 29


# ------------------------------------------------- kill/resume precompute --

@pytest.mark.chaos
def test_killed_build_resumes_at_chunk_2(tmp_path, monkeypatch):
    g, _ = _graphs("gnm")
    golden = PL.build_label_index(g, 4, chunk=1, device="cpu", ckpt_dir=tmp_path / "golden")
    monkeypatch.setenv("BFS_TPU_TORCH_CKPT", "every:1")
    monkeypatch.setenv("BFS_TPU_TORCH_FAULT", "raise:superstep:2")
    PF.reset()
    try:
        with pytest.raises(PF.FaultInjected):
            PL.build_label_index(g, 4, chunk=1, device="cpu", ckpt_dir=tmp_path / "ck")
    finally:
        monkeypatch.delenv("BFS_TPU_TORCH_FAULT")
        PF.reset()
    ck = SuperstepCheckpointer(tmp_path / "ck", {
        "kind": "labels", "graph": PC.graph_content_hash(g), "k": 4, "engine": "pull",
        "chunk": 1})
    found = ck.load_latest()
    assert found is not None and int(found[0]) == 2
    calls = []
    resumed = PL.build_label_index(
        g, 4, chunk=1, device="cpu", ckpt_dir=tmp_path / "ck",
        sweep=lambda roots: calls.append(roots.tolist()) or P.bfs_multi(g, roots, device="cpu"))
    assert calls == [[int(x)] for x in golden.landmarks[2:]]  # chunks 2 and 3 only
    _same_index(resumed, golden)
    assert (resumed.dist != PL.LABEL_INF).any()
    assert ck.epochs() == []  # a finished build clears its epochs


@pytest.mark.chaos
def test_reference_label_epoch_resumes_in_the_port(tmp_path, monkeypatch):
    from bfs_tpu.resilience import faults as JF
    from bfs_tpu.resilience.faults import FaultInjected
    from bfs_tpu.serve.labels import build_label_index

    g, jg = _graphs("rmat")
    golden = build_label_index(jg, 4, chunk=1, ckpt_dir=tmp_path / "golden")
    monkeypatch.setenv("BFS_TPU_CKPT", "every:1")
    monkeypatch.setenv("BFS_TPU_FAULT", "raise:superstep:2")
    JF.reset()
    try:
        with pytest.raises(FaultInjected):
            build_label_index(jg, 4, chunk=1, ckpt_dir=tmp_path / "ck")
    finally:
        monkeypatch.delenv("BFS_TPU_FAULT")
        JF.reset()
    monkeypatch.setenv("BFS_TPU_TORCH_CKPT", "every:1")
    calls = []
    resumed = PL.build_label_index(
        g, 4, chunk=1, device="cpu", ckpt_dir=tmp_path / "ck",
        sweep=lambda roots: calls.append(roots.tolist()) or P.bfs_multi(g, roots, device="cpu"))
    assert len(calls) == 2  # the reference's epoch 2 was the start
    _same_index(resumed, golden)


# ------------------------------------------------------------ serve tier --

def _servers(g, jg, k, monkeypatch, env=()):
    """The port's and the reference's server over the same graph, labels at
    ``k`` (None: off) and ``env`` (name without prefix, value) set for
    both while registering."""
    from bfs_tpu.serve import BfsServer as JServer

    for name, value in (*(() if k is None else (("LABELS", str(k)),)), *env):
        monkeypatch.setenv(f"BFS_TPU_TORCH_{name}", value)
        monkeypatch.setenv(f"BFS_TPU_{name}", value)
    srv = BfsServer(max_batch=8, device="cpu")
    jsrv = JServer(max_batch=8)
    srv.register("g", g)
    jsrv.register("g", jg)
    return srv, jsrv


def _ask(srv, pairs, want_path=False):
    futs = [srv.query_dist("g", int(u), int(v), want_path=want_path) for u, v in pairs]
    out = []
    for f in futs:
        r = f.result(TIMEOUT)
        out.append((r.graph, r.u, r.v, r.dist, r.method, r.landmark, r.path))
    return out


def _label_counters(srv):
    return {k: v for k, v in srv.metrics.report()["counters"].items() if k.startswith("label_")}


def _truth(g, pairs):
    cache = {}
    out = []
    for u, v in pairs:
        if u not in cache:
            cache[u] = P.canonical_bfs(g, int(u))[0]
        out.append(int(cache[u][v]))
    return out


@pytest.mark.parametrize("name", ["gnm", "rmat", "pair"])
def test_server_replies_match_reference(name, monkeypatch):
    g, jg = _graphs(name)
    srv, jsrv = _servers(g, jg, K, monkeypatch)
    with srv, jsrv:
        u, v = _pairs(g, 25, seed=13)
        pairs = list(zip(u.tolist(), v.tolist()))
        got, want = _ask(srv, pairs), _ask(jsrv, pairs)
        assert got == want
        assert [r[3] for r in got] == _truth(g, pairs)
        paths = pairs[10:16]
        got_p, want_p = _ask(srv, paths, want_path=True), _ask(jsrv, paths, want_path=True)
        assert got_p == want_p
        c = _label_counters(srv)
        assert c == _label_counters(jsrv)
        assert c["label_builds"] == 1 and c["label_build_cache_misses"] == 1
        assert c.get("label_hits", 0) + c.get("label_fallbacks", 0) == len(pairs) + len(paths)
        methods = {r[4] for r in got}
        assert "labels" in methods
        for r in got:
            assert (r[5] is not None) == (r[4] == "labels")
        labels = srv.report()["labels"]
        assert list(labels) == ["g@0"] and labels["g@0"]["k"] == K


def test_server_star_leaf_pairs_fall_back_like_the_reference(monkeypatch):
    from bfs_tpu.serve.labels import sample_landmarks

    g, jg = _graphs("star")
    lm = set(sample_landmarks(jg, 4).tolist())
    leaves = [x for x in range(1, g.num_vertices) if x not in lm]
    pairs = list(zip(leaves[0::2], leaves[1::2]))[:4]
    srv, jsrv = _servers(g, jg, 4, monkeypatch)
    with srv, jsrv:
        got, want = _ask(srv, pairs, want_path=True), _ask(jsrv, pairs, want_path=True)
        assert got == want
        assert all(r[3] == 2 and r[4] == "exact" and r[6] is not None for r in got)
        c = _label_counters(srv)
        assert c == _label_counters(jsrv)
        assert c["label_fallbacks"] == len(pairs) and c.get("label_hits", 0) == 0


def test_server_sampled_verification_matches_reference(monkeypatch):
    g, jg = _graphs("gnm")
    srv, jsrv = _servers(g, jg, 8, monkeypatch, env=(("LABELS_VERIFY", "2"),))
    with srv, jsrv:
        u, v = _pairs(g, 30, seed=5)
        pairs = list(zip(u.tolist(), v.tolist()))
        got, want = _ask(srv, pairs), _ask(jsrv, pairs)
        assert got == want
        assert [r[3] for r in got] == _truth(g, pairs)
        c = _label_counters(srv)
        assert c == _label_counters(jsrv)
        assert c["label_verifies"] >= 1 and c.get("label_verify_failures", 0) == 0
        assert "labels_verified" in {r[4] for r in got}


def test_server_verify_failure_quarantines_the_index(monkeypatch):
    g, jg = _graphs("gnm")
    srv, jsrv = _servers(g, jg, 8, monkeypatch, env=(("LABELS_VERIFY", "1"),))
    with srv, jsrv:
        # Vertex w's labels overwritten with x's in both indexes: the pair
        # (landmark, w) stays tight (the landmark is at 0 from itself) but
        # answers d(landmark, x), one too many.
        import jax.numpy as jnp

        oracle, joracle = srv._label_oracle("g", 0), jsrv._label_oracle("g", 0)
        lm, row = int(oracle.index.landmarks[0]), oracle.index.dist[0]
        w, x = int(np.flatnonzero(row == 1)[0]), int(np.flatnonzero(row == 2)[0])
        for o in (oracle, joracle):
            o.index.dist[:, w] = o.index.dist[:, x]
        oracle._dist_dev[:, w] = oracle._dist_dev[:, x]
        joracle._dist_dev = jnp.asarray(joracle.index.dist)
        pair = (lm, w)
        assert oracle.dist_one(*pair)[:2] == (2, True)
        got, want = _ask(srv, [pair]), _ask(jsrv, [pair])
        assert got == want and got[0][4] == "exact"
        assert got[0][3] == _truth(g, [pair])[0]
        c = _label_counters(srv)
        assert c == _label_counters(jsrv) and c["label_verify_failures"] == 1
        assert srv._label_oracle("g", 0) is None  # quarantined
        assert _ask(srv, [pair]) == _ask(jsrv, [pair])
        assert _label_counters(srv)["label_misses"] == 1


def test_server_epoch_swap_matches_reference(monkeypatch):
    g, jg = _graphs("gnm")
    srv, jsrv = _servers(g, jg, K, monkeypatch)
    with srv, jsrv:
        srv.register("g", g)
        jsrv.register("g", jg)
        assert srv.registry.epoch("g") == jsrv.registry.epoch("g") == 1
        assert srv._label_oracle("g", 0) is None and srv._label_oracle("g", 1) is not None
        assert srv._label_graveyard == []  # the retired oracle's rows were freed
        pairs = [(3, 90), (0, 1), (7, 7), (17, 140)]
        got = _ask(srv, pairs, want_path=True)
        assert got == _ask(jsrv, pairs, want_path=True)
        assert [r[3] for r in got] == _truth(g, pairs)
        assert _label_counters(srv) == _label_counters(jsrv)
        assert list(srv.report()["labels"]) == ["g@1"]


def test_server_unregister_drops_label_state(monkeypatch):
    g, jg = _graphs("gnm")
    srv, jsrv = _servers(g, jg, 4, monkeypatch)
    with srv, jsrv:
        srv.unregister("g")
        jsrv.unregister("g")
        assert srv._label_oracle("g", 0) is None and jsrv._label_oracle("g", 0) is None
        assert srv.report()["labels"] == {} == jsrv.report()["labels"]
        with pytest.raises(KeyError):
            srv.query_dist("g", 0, 1)
        srv.register("g", g)  # a new epoch, a new index
        jsrv.register("g", jg)
        assert _ask(srv, [(3, 90)]) == _ask(jsrv, [(3, 90)])
        assert _label_counters(srv) == _label_counters(jsrv)


def test_server_budget_reject_matches_reference(monkeypatch):
    g, jg = _graphs("gnm")
    srv, jsrv = _servers(g, jg, K, monkeypatch, env=(("LABELS_GB", "0.0000001"),))
    with srv, jsrv:
        assert _label_counters(srv) == _label_counters(jsrv) == {"label_budget_rejects": 1}
        got = _ask(srv, [(3, 90)], want_path=True)
        assert got == _ask(jsrv, [(3, 90)], want_path=True)
        assert got[0][4] == "exact" and got[0][3] == _truth(g, [(3, 90)])[0]
        assert _label_counters(srv) == _label_counters(jsrv)
        assert _label_counters(srv)["label_misses"] == 1


def test_server_labels_off_matches_reference(monkeypatch):
    g, jg = _graphs("gnm")
    srv, jsrv = _servers(g, jg, None, monkeypatch)
    with srv, jsrv:
        pairs = [(0, 1), (3, 90)]
        got = _ask(srv, pairs, want_path=True)
        assert got == _ask(jsrv, pairs, want_path=True)
        assert {r[4] for r in got} == {"exact"}
        assert _label_counters(srv) == _label_counters(jsrv) == {"label_misses": 2}
        assert srv.report()["labels"] == {}


def test_server_layout_only_graph_skips_the_build(monkeypatch):
    from bfs_tpu.graph.ell import build_pull_graph as j_build_pull

    from bfs_tpu_torch.graph.ell import build_pull_graph

    g, jg = _graphs("gnm")
    monkeypatch.setenv("BFS_TPU_TORCH_LABELS", "4")
    monkeypatch.setenv("BFS_TPU_LABELS", "4")
    from bfs_tpu.serve import BfsServer as JServer

    with BfsServer(max_batch=8, device="cpu") as srv, JServer(max_batch=8) as jsrv:
        srv.register("g", build_pull_graph(g))
        jsrv.register("g", j_build_pull(jg))
        assert _label_counters(srv) == _label_counters(jsrv) == {"label_build_skipped": 1}
