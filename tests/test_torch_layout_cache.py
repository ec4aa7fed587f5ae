"""The port's layout-bundle cache (``bfs_tpu_torch.cache.layout``) on the CPU:
round trips, rejected and rebuilt bundles, keys, tags and the disabled
cache, as ``tests/test_layout_cache.py`` holds the reference's; and the
parity of the two packages: the same keys, and a bundle either package
writes loads in the other."""

import json
import os

import numpy as np
import pytest

import bfs_tpu_torch as P
from bfs_tpu_torch.cache import layout as C
from bfs_tpu_torch.graph import ell as p_ell
from bfs_tpu_torch.graph import relay as p_relay
from bfs_tpu_torch.obs import spans
from bfs_tpu_torch.utils import metrics

from bfs_tpu.cache import layout as j_cache
from bfs_tpu.graph import benes as j_benes
from bfs_tpu.graph import ell as j_ell
from bfs_tpu.graph import relay as j_relay
from bfs_tpu.graph.csr import Graph as JGraph

needs_native = pytest.mark.skipif(
    not j_benes.native_available(), reason="native benes router unavailable"
)

TINY_EDGES = [(0, 5), (2, 4), (2, 3), (1, 2), (0, 1), (3, 4), (3, 5), (0, 2)]


@pytest.fixture
def tiny():
    return P.Graph.from_undirected_edges(6, np.array(TINY_EDGES))


@pytest.fixture
def medium():
    return P.read_sedgewick(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "test-sets", "randomG.txt"))


@pytest.fixture
def cache(tmp_path):
    return C.LayoutCache(str(tmp_path / "layout"))


def _ref(g: P.Graph) -> JGraph:
    return JGraph(g.num_vertices, g.src.copy(), g.dst.copy())


def _same(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


def test_content_hash_distinguishes_graphs(tiny):
    other = P.gnm_graph(100, 200, seed=7)
    assert C.graph_content_hash(tiny) != C.graph_content_hash(other)
    assert C.graph_content_hash(tiny) == tiny._content_hash  # memoized


def test_pull_round_trip_bit_identical(tiny, cache):
    pg, info = C.load_or_build_pull(tiny, cache=cache)
    assert info["cache"] == "miss"
    pg2, info2 = C.load_or_build_pull(tiny, cache=cache)
    assert info2["cache"] == "hit"
    assert info2["build_seconds"] == pytest.approx(info["build_seconds"])
    _same(p_ell.pull_to_arrays(pg), p_ell.pull_to_arrays(pg2))


@needs_native
@pytest.mark.parametrize("builder", ["device", "host"])
def test_relay_round_trip_bit_identical(medium, cache, builder):
    rg, info = C.load_or_build_relay(medium, cache=cache, builder=builder, device="cpu")
    assert (info["cache"], info["builder"]) == ("miss", builder)
    rg2, info2 = C.load_or_build_relay(medium, cache=cache, builder=builder, device="cpu")
    assert (info2["cache"], info2["builder"]) == ("hit", builder)
    assert info2["build_stages"] == json.loads(json.dumps(info["build_stages"]))
    _same(p_relay.relay_to_arrays(rg), p_relay.relay_to_arrays(rg2))
    assert rg2.net_table == rg.net_table and rg2.vperm_table == rg.vperm_table
    assert rg2.in_classes == rg.in_classes and rg2.out_classes == rg.out_classes


@needs_native
def test_relay_builders_share_one_bundle(medium, tmp_path, monkeypatch):
    """The default builder is the device one; the host builder's bundle
    has the same key and bytes."""
    monkeypatch.delenv("BFS_TPU_TORCH_LAYOUT_BUILD", raising=False)
    dev, info = C.load_or_build_relay(medium, cache=C.LayoutCache(str(tmp_path / "a")),
                                      device="cpu")
    assert info["builder"] == "device"
    assert info["build_stages"]["device"] == "cpu"
    monkeypatch.setenv("BFS_TPU_TORCH_LAYOUT_BUILD", "host")
    host, info_h = C.load_or_build_relay(medium, cache=C.LayoutCache(str(tmp_path / "b")))
    assert info_h["builder"] == "host" and info_h["key"] == info["key"]
    _same(p_relay.relay_to_arrays(dev), p_relay.relay_to_arrays(host))
    monkeypatch.setenv("BFS_TPU_TORCH_LAYOUT_BUILD", "banana")
    with pytest.raises(ValueError):
        C.load_or_build_relay(medium, cache=None)


@needs_native
def test_large_fields_load_as_memmaps(cache, monkeypatch):
    monkeypatch.setattr(C, "_MMAP_MIN_BYTES", 1024)
    g = P.rmat_graph(9, 8, seed=1)
    C.load_or_build_relay(g, cache=cache, device="cpu")
    _, arrays = cache.load(C.relay_key(g))
    assert isinstance(arrays["net_masks"], np.memmap)
    assert not isinstance(arrays["vr"], np.memmap)
    rg, info = C.load_or_build_relay(g, cache=cache, device="cpu")
    assert info["cache"] == "hit"
    eng = P.RelayEngine(rg, device="cpu")
    np.testing.assert_array_equal(eng.run(0).dist, P.canonical_bfs(g, 0)[0])


def test_corrupted_array_rejected_and_rebuilt(tiny, cache):
    _, info = C.load_or_build_pull(tiny, cache=cache)
    key = info["key"]
    path = os.path.join(cache._dir(key), "ell0.npy")
    arr = np.load(path)
    arr[0, 0] += 1
    np.save(path, arr)
    assert cache.load(key) is None
    assert not cache.has(key)
    _, info2 = C.load_or_build_pull(tiny, cache=cache)
    assert info2["cache"] == "miss"
    assert cache.has(key)


def test_truncated_bundle_rejected(tiny, cache):
    _, info = C.load_or_build_pull(tiny, cache=cache)
    os.remove(os.path.join(cache._dir(info["key"]), "ell0.npy"))
    assert cache.load(info["key"]) is None


def test_stale_store_version_rejected(tiny, cache):
    _, info = C.load_or_build_pull(tiny, cache=cache)
    meta_path = os.path.join(cache._dir(info["key"]), "meta.json")
    with open(meta_path) as f:
        doc = json.load(f)
    doc["store_version"] = C.STORE_VERSION + 1
    with open(meta_path, "w") as f:
        json.dump(doc, f)
    assert cache.load(info["key"]) is None
    _, info2 = C.load_or_build_pull(tiny, cache=cache)
    assert info2["cache"] == "miss"


def test_keys_cover_params_and_code_version(tiny):
    assert C.pull_key(tiny, 32, 64) != C.pull_key(tiny, 16, 64)
    assert C.pull_key(tiny, 32, 64) != C.pull_key(tiny, 32, 128)
    assert C.relay_key(tiny) != C.pull_key(tiny, 32, 64)
    assert f"v{p_relay.LAYOUT_VERSION}" in C.relay_key(tiny)
    assert f"_s{C.STORE_VERSION}_" in C.relay_key(tiny)


def test_tag_alias_probes_warmth(tiny, cache):
    assert cache.resolve_tag("bench_s10") is None
    _, info = C.load_or_build_pull(tiny, cache=cache, tag="bench_s10")
    assert cache.resolve_tag("bench_s10") == info["key"]
    cache.invalidate(info["key"])
    assert cache.resolve_tag("bench_s10") is None


def test_disabled_cache_builds_directly(tiny):
    pg, info = C.load_or_build_pull(tiny, cache=None)
    assert info["cache"] == "disabled" and "key" not in info
    assert pg.num_vertices == tiny.num_vertices


def test_default_root_follows_the_knob(tmp_path, monkeypatch):
    monkeypatch.setenv("BFS_TPU_TORCH_CACHE_DIR", str(tmp_path))
    assert C.LayoutCache().root == os.path.join(str(tmp_path), "layout")
    monkeypatch.delenv("BFS_TPU_TORCH_CACHE_DIR")
    assert C.LayoutCache().root.endswith(os.path.join(".bench_cache", "layout"))


def test_counters_and_spans(tiny, cache):
    before = metrics.artifact_report()
    spans.drain_events()
    C.load_or_build_pull(tiny, cache=cache)
    C.load_or_build_pull(tiny, cache=cache)
    after = metrics.artifact_report()
    for name in ("layout_cache_hits", "layout_cache_misses"):
        assert after[name] == before.get(name, 0) + 1
    assert 0 < after["layout_cache_hit_rate"] < 1
    report = spans.span_report()
    assert report["layout.bundle_load"]["count"] == 2
    assert report["layout.build"]["count"] == report["layout.bundle_save"]["count"] == 1
    trace = spans.chrome_trace()
    assert {e["args"]["kind"] for e in trace["traceEvents"]} == {"pull"}
    assert len(spans.drain_events()) == 4 and not spans.snapshot_events()


def test_span_decorator_errors_and_instants():
    spans.drain_events()

    @spans.span("decorated", step=1)
    def step():
        spans.instant("mark", why="test")

    with pytest.raises(KeyError):
        with spans.span("fails"):
            raise KeyError("x")
    step()
    events = {e["name"]: e for e in spans.drain_events()}
    assert events["fails"]["args"]["error"] == "KeyError"
    assert events["mark"]["ph"] == "i" and events["decorated"]["args"] == {"step": 1}


# ------------------------------------------------ the two packages' bundles --

def test_keys_equal_the_reference(tiny, medium):
    for g in (tiny, medium):
        assert C.graph_content_hash(g) == j_cache.graph_content_hash(_ref(g))
        assert C.relay_key(g) == j_cache.relay_key(_ref(g))
        for k, rm in ((32, 64), (8, 128)):
            assert C.pull_key(g, k, rm) == j_cache.pull_key(_ref(g), k, rm)


@needs_native
def test_reference_relay_bundle_loads_in_the_port(medium, tmp_path):
    root = str(tmp_path / "shared")
    jrg, jinfo = j_cache.load_or_build_relay(_ref(medium), cache=j_cache.LayoutCache(root),
                                             builder="host")
    rg, info = C.load_or_build_relay(medium, cache=C.LayoutCache(root), device="cpu")
    assert (jinfo["cache"], info["cache"], info["key"]) == ("miss", "hit", jinfo["key"])
    built = P.build_relay_graph_device(medium, device="cpu")
    _same(p_relay.relay_to_arrays(rg), p_relay.relay_to_arrays(built))
    _same(p_relay.relay_to_arrays(rg), j_relay.relay_to_arrays(jrg))


@needs_native
def test_port_relay_bundle_loads_in_the_reference(medium, tmp_path):
    root = str(tmp_path / "shared")
    rg, info = C.load_or_build_relay(medium, cache=C.LayoutCache(root), device="cpu",
                                     builder="device")
    jrg, jinfo = j_cache.load_or_build_relay(_ref(medium), cache=j_cache.LayoutCache(root),
                                             builder="host")
    assert (info["cache"], jinfo["cache"], jinfo["builder"]) == ("miss", "hit", "device")
    _same(j_relay.relay_to_arrays(jrg), j_relay.relay_to_arrays(j_relay.build_relay_graph(
        _ref(medium))))
    _same(j_relay.relay_to_arrays(jrg), p_relay.relay_to_arrays(rg))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_pull_bundles_cross_load(medium, tmp_path, writer):
    root = str(tmp_path / "shared")
    jg = _ref(medium)
    if writer == "reference":
        _, first = j_cache.load_or_build_pull(jg, cache=j_cache.LayoutCache(root))
        pg, second = C.load_or_build_pull(medium, cache=C.LayoutCache(root))
    else:
        _, first = C.load_or_build_pull(medium, cache=C.LayoutCache(root))
        pg, second = j_cache.load_or_build_pull(jg, cache=j_cache.LayoutCache(root))
    assert (first["cache"], second["cache"], first["key"]) == ("miss", "hit", second["key"])
    theirs = (j_ell.pull_to_arrays(pg) if writer == "port" else p_ell.pull_to_arrays(pg))
    _same(theirs, j_ell.pull_to_arrays(j_ell.build_pull_graph(jg)))
