"""The port's device layout builder (``bfs_tpu_torch.graph.relay_device``)
on the CPU against the port's host builder and the reference's: byte parity
on the rmat/gnm/star/path/directed/sparse fixtures, the torch router
against the reference's JAX router bit for bit, the route arm and stage
times, and BFS on a torch-routed layout."""

import threading

import numpy as np
import pytest
import torch

import bfs_tpu_torch as P
from bfs_tpu_torch.cache import layout as p_cache
from bfs_tpu_torch.graph import benes as p_benes
from bfs_tpu_torch.graph import relay as p_relay
from bfs_tpu_torch.graph import relay_device as RD
from bfs_tpu_torch.graph.csr import unpad_edges
from bfs_tpu_torch.ops.relay import apply_benes_std, pack_std, unpack_std

from bfs_tpu.graph import benes as j_benes
from bfs_tpu.graph import relay as j_relay
from bfs_tpu.graph.csr import Graph as JGraph
from bfs_tpu.graph.relay_device import route_masks_device as j_route_masks_device

needs_native = pytest.mark.skipif(
    not j_benes.native_available(), reason="native benes router unavailable"
)

def _directed() -> P.Graph:
    """A directed multigraph: self-loops, repeated edges, and a hub whose
    in- and out-degrees differ (the two sides' classes differ)."""
    rng = np.random.default_rng(11)
    src = np.concatenate([rng.integers(0, 150, 900), np.full(60, 7), np.arange(40)])
    dst = np.concatenate([rng.integers(0, 150, 900), rng.integers(0, 150, 60), np.arange(40)])
    return P.Graph(150, src, dst)


FIXTURES = {
    "rmat": lambda: P.rmat_graph(9, 8, seed=7),
    "gnm": lambda: P.gnm_graph(300, 1800, seed=3),
    "star": lambda: P.star_graph(96),
    "path": lambda: P.path_graph(70),
    "directed": _directed,
    "sparse": lambda: P.gnm_graph(400, 120, seed=5),  # most vertices isolated
}

MASK_FIELDS = p_relay.MASK_FIELDS


def _ref(g: P.Graph) -> JGraph:
    return JGraph(g.num_vertices, g.src.copy(), g.dst.copy())


def _same(a: dict, b: dict, skip=()) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        if k in skip:
            continue
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


def _perms(g: P.Graph):
    """The net and vperm permutations the builders route for ``g``."""
    src, dst, v, _ = p_relay.extract_edges(g)
    in_w, out_w = p_relay.seg_degrees(src, dst, v)
    meta = p_relay.seg_classes(in_w, out_w, v)
    _, old2new, outpos = p_relay.seg_relabel(in_w, out_w, meta)
    _, l1, _ = p_relay.seg_l1_slots(src, dst, old2new, meta)
    l2 = p_relay.seg_l2_slots(src, outpos, meta)
    return (
        (p_relay.seg_net_assembly(l1, l2, meta), meta.n),
        (p_relay.seg_vperm_assembly(outpos, old2new, meta), meta.vp),
    )


def _torch_masks(perm: np.ndarray, n: int) -> np.ndarray:
    return RD.route_masks_device(perm, n=n, device="cpu").numpy().view(np.uint32)


# ------------------------------------------------------------ builder parity --

@needs_native
@pytest.mark.parametrize("name", list(FIXTURES))
def test_device_builder_byte_identical_native_route(name):
    """With the native route the device builder is byte-identical to the
    port's host builder and to the reference's."""
    g = FIXTURES[name]()
    dev = p_relay.relay_to_arrays(
        P.build_relay_graph_device(g, device="cpu", route="native")
    )
    _same(dev, p_relay.relay_to_arrays(P.build_relay_graph(g)))
    _same(dev, j_relay.relay_to_arrays(j_relay.build_relay_graph(_ref(g))))


@needs_native
@pytest.mark.parametrize("name", list(FIXTURES))
def test_torch_route_layout(name):
    """The torch route: every non-mask field byte-identical to the host
    builder, the masks those of the torch router compacted."""
    g = FIXTURES[name]()
    rg = P.build_relay_graph_device(g, device="cpu", route="torch")
    host_rg = P.build_relay_graph(g)
    _same(p_relay.relay_to_arrays(rg), p_relay.relay_to_arrays(host_rg), skip=MASK_FIELDS)
    assert p_relay.differing_fields(host_rg, rg, skip=MASK_FIELDS) == []
    (net, n), (vperm, vp) = _perms(g)
    masks, table = p_relay._compact_and_table(_torch_masks(net, n), n)
    np.testing.assert_array_equal(rg.net_masks, masks)
    assert rg.net_table == table
    masks, table = p_relay._compact_and_table(_torch_masks(vperm, vp), vp)
    np.testing.assert_array_equal(rg.vperm_masks, masks)
    assert rg.vperm_table == table


@needs_native
def test_device_builder_takes_a_device_graph():
    """A DeviceGraph gives its real edges in stored (dst-sorted) order, so
    its layout is that of those edges."""
    dg = P.build_device_graph(P.rmat_graph(8, 6, seed=4), block=256)
    ours = p_relay.relay_to_arrays(
        P.build_relay_graph_device(dg, device="cpu"))
    _same(ours, p_relay.relay_to_arrays(P.build_relay_graph(dg)))
    src, dst = unpad_edges(dg)
    _same(ours, j_relay.relay_to_arrays(j_relay.build_relay_graph(
        JGraph(dg.num_vertices, src, dst))))


# ---------------------------------------------------------------- the router --

@pytest.mark.parametrize("n", [32, 256, 4096, 1 << 14])
def test_torch_router_matches_jax_router(n):
    perm = np.random.default_rng(n).permutation(n).astype(np.int32)
    np.testing.assert_array_equal(
        _torch_masks(perm, n), np.asarray(j_route_masks_device(perm, n=n))
    )


@needs_native
@pytest.mark.parametrize("name", list(FIXTURES))
def test_torch_router_matches_jax_router_on_layout_networks(name):
    for perm, n in _perms(FIXTURES[name]()):
        np.testing.assert_array_equal(
            _torch_masks(perm, n), np.asarray(j_route_masks_device(perm, n=n))
        )


@pytest.mark.parametrize("n", [32, 512, 8192, 1 << 14])
def test_torch_router_realizes_permutations(n):
    """Through the port's plain applier: routing each bit plane of the
    element index gives ``perm`` back (``y[j] = x[perm[j]]``); the
    identity routes switch-free."""
    perm = np.random.default_rng(n + 1).permutation(n).astype(np.int32)
    masks, table = p_relay._compact_and_table(_torch_masks(perm, n), n)
    flat = torch.from_numpy(masks.view(np.int32))
    got = np.zeros(n, dtype=np.int64)
    for b in range(n.bit_length() - 1):
        bits = torch.from_numpy(((np.arange(n) >> b) & 1).astype(np.uint8))
        out = apply_benes_std(pack_std(bits), flat, table, n)
        got |= unpack_std(out, n).numpy().astype(np.int64) << b
    np.testing.assert_array_equal(got, perm)
    assert not _torch_masks(np.arange(n, dtype=np.int32), n).any()
    with pytest.raises(ValueError):
        RD.route_masks_device(np.arange(48, dtype=np.int32), n=48, device="cpu")


# ------------------------------------------------------ arms and stage times --

def test_arm_resolution(monkeypatch):
    assert RD.resolve_route(None) == ("native" if p_benes.native_available() else "torch")
    assert RD.resolve_route("torch") == "torch"
    monkeypatch.setattr(p_benes, "native_available", lambda: False)
    assert RD.resolve_route("auto") == "torch"
    with pytest.raises(ValueError):
        RD.resolve_route("jax")
    with pytest.raises(RuntimeError, match="native"):
        P.build_relay_graph_device(P.path_graph(8), device="cpu", route="native")


@needs_native
def test_stage_times():
    g = P.gnm_graph(120, 500, seed=1)
    times = {}
    P.build_relay_graph_device(g, device="cpu", stage_times=times)
    assert (times["route"], times["device"]) == ("native", "cpu")
    for key in ("ingest", "classes", "route_net", "route_vperm", "compact_net",
                "compact_vperm", "finalize", "layout.device_hist", "layout.device_relabel",
                "layout.device_slots", "layout.device_net_assembly",
                "layout.device_vperm_assembly", "layout.device_csr"):
        assert times[key] >= 0.0, key
    assert set(times["host_syncs"]) == {
        "ingest", "degree histograms", "class tables", "route input",
        "masks to the device", "stage ranges", "finalize"}


def test_host_sync_counts_across_threads():
    """Both tracks of a build count their syncs into one dict: no count
    is lost to a race."""
    syncs: dict = {}
    cpu = torch.device("cpu")

    def track():
        for _ in range(2000):
            with RD._host_sync(cpu, "finalize", syncs):
                pass

    threads = [threading.Thread(target=track) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert syncs == {"finalize": 8000}


@needs_native
def test_host_builder_stage_times():
    times = {}
    P.build_relay_graph(P.gnm_graph(120, 500, seed=1), stage_times=times)
    assert list(times) == ["degrees", "classes", "relabel", "l1 slots", "l2 slots",
                           "net perm assembly", "net route", "net compact", "vperm route",
                           "sparse CSR"]


def test_degree_overflow_raises(monkeypatch):
    """A degree past the width table lands in the histograms' scratch slot
    and the build raises, as the reference's dropped scatter makes it."""
    monkeypatch.setattr(RD, "_CANDIDATES", p_relay.width_candidates(4).astype(np.int32))
    with pytest.raises(RuntimeError, match="width table"):
        P.build_relay_graph_device(P.star_graph(12), device="cpu", route="torch")


def test_worker_failure_reraises(monkeypatch):
    def boom(*a, **kw):
        raise ArithmeticError("injected tail failure")

    monkeypatch.setattr(RD, "_csr_program", boom)
    with pytest.raises(ArithmeticError, match="injected"):
        P.build_relay_graph_device(P.path_graph(40), device="cpu", route="torch")


def test_without_a_card_the_default_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        P.build_relay_graph_device(P.path_graph(8))
    with pytest.raises(RuntimeError, match="CUDA"):
        P.load_or_build_relay(P.path_graph(8))


def test_device_build_failure_raises(monkeypatch):
    """No fallback: a device build that raises is not retried on the host."""
    def boom(*a, **kw):
        raise RuntimeError("injected device-build failure")

    monkeypatch.setattr(RD, "build_relay_graph_device", boom)
    monkeypatch.delenv("BFS_TPU_TORCH_LAYOUT_BUILD", raising=False)
    with pytest.raises(RuntimeError, match="injected"):
        p_cache.load_or_build_relay(P.gnm_graph(80, 240, seed=6), cache=None, device="cpu")


# --------------------------------------------------- BFS on built layouts --

@needs_native
@pytest.mark.parametrize("sparse_hybrid", [False, True])
def test_bfs_on_a_torch_routed_layout(sparse_hybrid):
    g = P.rmat_graph(8, 6, seed=2)
    rg = P.build_relay_graph_device(g, device="cpu", route="torch")
    eng = P.RelayEngine(rg, device="cpu", sparse_hybrid=sparse_hybrid)
    for s in (3, 100, 255):
        r = eng.run(s)
        dist, parent = P.canonical_bfs(g, s)
        np.testing.assert_array_equal(r.dist, dist)
        np.testing.assert_array_equal(r.parent, parent)
        assert P.check(g, r.dist, r.parent, s) == []
    r = P.bfs(rg, 3, engine="relay", device="cpu")
    np.testing.assert_array_equal(r.dist, P.canonical_bfs(g, 3)[0])


# ------------------------------------------------- shared segment helpers --

def test_width_table_matches_class_width():
    cand = p_relay.width_candidates()
    np.testing.assert_array_equal(cand, j_relay.width_candidates())
    deg = np.concatenate([
        np.arange(0, 4096),
        (1 << np.arange(0, 30)).astype(np.int64),
        (3 << np.arange(0, 28)).astype(np.int64),
        (1 << np.arange(2, 30)) - 1,
        (1 << np.arange(2, 30)) + 1,
    ])
    idx = np.searchsorted(cand, np.maximum(deg, 1))  # the device builder's lookup
    np.testing.assert_array_equal(p_relay._class_width(deg), cand[idx])
    np.testing.assert_array_equal(idx, j_relay.width_index(deg, cand))


@pytest.mark.parametrize("name", list(FIXTURES))
def test_segment_helpers_match_reference(name):
    g = FIXTURES[name]()
    src, dst, v, e = p_relay.extract_edges(g)
    jsrc, jdst, jv, je = j_relay.extract_edges(_ref(g))
    assert (v, e) == (jv, je)
    np.testing.assert_array_equal(src, jsrc)
    in_w, out_w = p_relay.seg_degrees(src, dst, v)
    widths, counts = np.unique(in_w, return_counts=True)
    ow, oc = np.unique(out_w, return_counts=True)
    ours = p_relay.seg_classes_from_counts(widths, counts, ow, oc, v)
    ref = j_relay.seg_classes_from_counts(widths, counts, ow, oc, v)
    assert ours.in_classes == tuple(p_relay.rows_to_classes(j_relay.classes_to_rows(ref.in_classes)))
    assert (ours.vr, ours.m1, ours.m2, ours.out_vb, ours.n, ours.vp) == (
        ref.vr, ref.m1, ref.m2, ref.out_vb, ref.n, ref.vp)
    want = (*j_relay.seg_relabel_in(in_w, ref), j_relay.seg_relabel_out(out_w, ref))
    for a, b in zip(p_relay.seg_relabel(in_w, out_w, ours), want, strict=True):
        np.testing.assert_array_equal(a, b)


@needs_native
def test_differing_fields_names_each_changed_field():
    g = FIXTURES["gnm"]()
    rg = P.build_relay_graph(g)
    assert p_relay.differing_fields(rg, rg) == []
    bent = p_relay.relay_from_arrays(
        {k: np.array(v) for k, v in p_relay.relay_to_arrays(rg).items()})
    bent.adj_dst[0] ^= 1
    bent.net_masks[-1] ^= 1
    assert p_relay.differing_fields(rg, bent) == ["net_masks", "adj_dst"]
    assert p_relay.differing_fields(rg, bent, skip=MASK_FIELDS) == ["adj_dst"]
