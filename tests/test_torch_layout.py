"""The port's host layer against the JAX reference: graphs, the Beneš router,
the relay layout (byte for byte), the layout converter, and the oracle."""

import os

import numpy as np
import pytest

import bfs_tpu_torch as P
from bfs_tpu_torch.graph import benes as p_benes
from bfs_tpu_torch.graph import native_gen as p_native_gen
from bfs_tpu_torch.graph import relay as p_relay

from bfs_tpu.graph import benes as j_benes
from bfs_tpu.graph import generators as j_gen
from bfs_tpu.graph import relay as j_relay
from bfs_tpu.graph.csr import Graph as JGraph
from bfs_tpu.graph.io import read_sedgewick as j_read
from bfs_tpu.oracle import bfs as j_oracle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "test-sets", "tinyCG.txt")
RANDOM_G = os.path.join(REPO, "test-sets", "randomG.txt")

needs_native = pytest.mark.skipif(
    not j_benes.native_available(), reason="native benes router unavailable"
)


def _graphs():
    return {
        "tinyCG": lambda: P.read_sedgewick(TINY),
        "randomG": lambda: P.read_sedgewick(RANDOM_G),
        "rmat8": lambda: P.rmat_graph(8, 8, seed=2),
        "rmat10": lambda: P.rmat_graph(10, 6, seed=1),
        "path100": lambda: P.path_graph(100),
    }


def _ref(g: P.Graph) -> JGraph:
    return JGraph(g.num_vertices, g.src.copy(), g.dst.copy())


def _same_arrays(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


@pytest.mark.parametrize("path", [TINY, RANDOM_G])
def test_read_sedgewick_matches_reference(path):
    g, r = P.read_sedgewick(path), j_read(path)
    assert g.num_vertices == r.num_vertices
    np.testing.assert_array_equal(g.src, r.src)
    np.testing.assert_array_equal(g.dst, r.dst)


@pytest.mark.parametrize(
    "make_port, make_ref",
    [
        (lambda: P.rmat_graph(9, 6, seed=4), lambda: j_gen.rmat_graph(9, 6, seed=4)),
        (lambda: P.gnm_graph(300, 900, seed=3), lambda: j_gen.gnm_graph(300, 900, seed=3)),
        (lambda: P.path_graph(64), lambda: j_gen.path_graph(64)),
    ],
    ids=["rmat", "gnm", "path"],
)
def test_generators_match_reference(make_port, make_ref):
    g, r = make_port(), make_ref()
    assert g.num_vertices == r.num_vertices
    np.testing.assert_array_equal(g.src, r.src)
    np.testing.assert_array_equal(g.dst, r.dst)


@needs_native
def test_route_std_matches_reference():
    rng = np.random.default_rng(3)
    perm = rng.permutation(1 << 12).astype(np.int32)
    np.testing.assert_array_equal(p_benes.route_std(perm), j_benes.route_std(perm))
    assert p_benes.num_stages(1 << 12) == j_benes.num_stages(1 << 12)
    for s in range(p_benes.num_stages(1 << 12)):
        assert p_benes.stage_distance(1 << 12, s) == j_benes.stage_distance(1 << 12, s)


@needs_native
@pytest.mark.parametrize("name", list(_graphs()))
def test_layout_byte_identical(name):
    g = _graphs()[name]()
    ours = p_relay.relay_to_arrays(p_relay.build_relay_graph(g))
    ref = j_relay.relay_to_arrays(j_relay.build_relay_graph(_ref(g)))
    _same_arrays(ours, ref)


@needs_native
def test_layout_numpy_helpers_match_native(monkeypatch):
    """The NumPy twins of the native gather/scatter/slot-assign/sort helpers
    give the same layout bytes."""
    g = P.rmat_graph(8, 8, seed=2)
    native = p_relay.relay_to_arrays(p_relay.build_relay_graph(g))
    monkeypatch.setattr(p_native_gen, "native_available", lambda: False)
    plain = p_relay.relay_to_arrays(p_relay.build_relay_graph(g))
    _same_arrays(native, plain)


@needs_native
def test_from_reference_layout_round_trips():
    g = P.rmat_graph(8, 8, seed=5)
    ref = j_relay.relay_to_arrays(j_relay.build_relay_graph(_ref(g)))
    rg = P.from_reference_layout(ref)
    assert isinstance(rg, p_relay.RelayGraph)
    _same_arrays(p_relay.relay_to_arrays(rg), ref)
    np.testing.assert_array_equal(
        p_relay.valid_slot_words(rg.src_l1, rg.net_size),
        j_relay.valid_slot_words(ref["src_l1"], int(ref["net_size"])),
    )
    broken = dict(ref)
    del broken["net_masks"]
    with pytest.raises(KeyError):
        P.from_reference_layout(broken)


@pytest.mark.parametrize("name", ["randomG", "rmat10", "path100"])
def test_oracle_matches_reference(name):
    g = _graphs()[name]()
    r = _ref(g)
    for s in (0, 7, g.num_vertices - 1):
        d, p = P.canonical_bfs(g, s)
        jd, jp = j_oracle.canonical_bfs(r, s)
        np.testing.assert_array_equal(d, jd)
        np.testing.assert_array_equal(p, jp)
        assert P.check(g, d, p, s) == [] == j_oracle.check(r, jd, jp, s)


def test_check_reports_what_the_reference_reports():
    g = P.read_sedgewick(RANDOM_G)
    d, p = P.canonical_bfs(g, 0)
    reached = np.flatnonzero((d != P.INF_DIST) & (np.arange(g.num_vertices) != 0))
    bad_p = p.copy()
    bad_p[reached[3]] = reached[4]  # a parent that is no graph neighbour's level
    bad_d = d.copy()
    bad_d[reached[5]] += 2
    for dist, parent in ((d, bad_p), (bad_d, p)):
        ours = P.check(g, dist, parent, 0)
        assert ours and ours == j_oracle.check(_ref(g), dist, parent, 0)
