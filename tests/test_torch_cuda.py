"""The card's kernels against their plain PyTorch versions (marker ``cuda``).

This file imports neither jax nor ``bfs_tpu``, so it also runs on a machine
with a card and no jax:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Each test decides inside a fixture whether a card is present and skips
without one.  Comparisons are exact (integer bit arithmetic)."""

import os
import threading
import time
import types

import numpy as np
import pytest
import torch

import bfs_tpu_torch as P
from bfs_tpu_torch.graph import adj_tiles as PT
from bfs_tpu_torch.graph import benes
from bfs_tpu_torch.graph import relay as p_relay
from bfs_tpu_torch.graph.relay import valid_slot_words
from bfs_tpu_torch.models import bfs as p_bfs
from bfs_tpu_torch.ops import relay as R
from bfs_tpu_torch.ops import relay_cuda as K
from bfs_tpu_torch.ops import relay_elem as RE
from bfs_tpu_torch.ops import relay_mxu as RM
from bfs_tpu_torch.utils import cuda_build

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if not benes.native_available():
        pytest.skip("native benes router unavailable")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def layout():
    return P.build_relay_graph(P.rmat_graph(10, 8, seed=3))


def _t(words: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)).to(device)


def _words(rng, n: int) -> np.ndarray:
    w = rng.integers(0, 2**32, n, dtype=np.uint32)
    w[rng.random(n) < 0.1] = 0xFFFFFFFF
    w[rng.random(n) < 0.2] = 0
    return w


def _eq(a: torch.Tensor, b: torch.Tensor) -> None:
    np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


def _passes(x, masks, table, n, tile, inplace):
    """The network as ``apply_benes`` runs it, at ``tile``: one
    ``benes_outer_pass`` per run of each side, one ``benes_local_pass``;
    in place or into fresh outputs.  Returns the words after the prefix
    and after the whole network."""
    pre, local, suf, _ = K.split_passes(table, n, tile)
    y = x.clone()
    for run in K.outer_plan(table, pre, n):
        stages = tuple(table[i] for i in run.stages)
        y = K.benes_outer_pass(y, masks, stages, n, out=y if inplace else None)
    after_pre = y.clone()
    y = K.benes_local_pass(y, masks, tuple(table[i] for i in local), n, tile,
                           out=y if inplace else None)
    for run in K.outer_plan(table, suf, n):
        stages = tuple(table[i] for i in run.stages)
        y = K.benes_outer_pass(y, masks, stages, n, out=y if inplace else None)
    return after_pre, y


def test_card_benes_kernels_match_plain(card, layout):
    rg = layout
    table, n = rg.net_table, rg.net_size
    x = _t(_words(np.random.default_rng(6), n // 32), card)
    masks = _t(rg.net_masks, card)
    want = R.apply_benes_std(x, masks, table, n)
    _eq(K.apply_benes(x, masks, table, n), want)
    for tile in (64, 256):  # small tiles force outer stages at this size
        pre, _, suf, _ = K.split_passes(table, n, tile)
        runs = len(K.outer_plan(table, pre, n)) + len(K.outer_plan(table, suf, n))
        for inplace in (False, True):
            K.reset_launches()
            after_pre, y = _passes(x, masks, table, n, tile, inplace)
            _eq(after_pre, R.apply_benes_std(x, masks, tuple(table[i] for i in pre), n))
            _eq(y, want)
            torch.cuda.synchronize()
            assert K.LAUNCHES["benes_local_pass"] == 1
            assert K.LAUNCHES["benes_outer_pass"] == runs > 0


def test_card_benes_per_word_copy_path(card, layout):
    """Mask slabs that are not 16-byte aligned take the local pass's
    per-word copy path: the layout's net with its masks one word off
    alignment, and networks of 32, 64 and 128 elements (tiles of 1, 2 and
    4 words; 4-, 8- and 16-byte slabs).  Words one word off alignment, or
    rows under 4 words (tile 2), take the outer pass's word-by-word copies
    and the local pass's per-word tile copy."""
    rg = layout
    table, n = rg.net_table, rg.net_size
    rng = np.random.default_rng(8)
    buf = torch.empty(rg.net_masks.size + 1, dtype=torch.int32, device=card)
    masks = buf[1:]
    masks.copy_(_t(rg.net_masks, card))
    assert masks.data_ptr() % 16
    x = _t(_words(rng, n // 32), card)
    want = R.apply_benes_std(x, masks, table, n)
    _eq(K.apply_benes(x, masks, table, n), want)
    for tile in (64, 256):
        _eq(_passes(x, masks, table, n, tile, True)[1], want)
    xbuf = torch.empty(n // 32 + 1, dtype=torch.int32, device=card)
    xm = xbuf[1:]
    xm.copy_(x)
    assert xm.data_ptr() % 16
    for tile in (2, 64):
        pre, _, _, _ = K.split_passes(table, n, tile)
        assert min(r.row_words for r in K.outer_plan(table, pre, n)) < 4 or tile != 2
        _eq(_passes(xm, masks, table, n, tile, False)[1], want)
        _eq(_passes(x, masks, table, n, tile, True)[1], want)
    for size in (32, 64, 128):
        m, tb = p_relay._compact_and_table(benes.route_std(rng.permutation(size)), size)
        m = _t(m, card)
        x = _t(_words(rng, size // 32), card)
        _eq(K.apply_benes(x, m, tb, size), R.apply_benes_std(x, m, tb, size))


@pytest.mark.parametrize("trees", [2, 5])
def test_card_benes_batch_per_word_copy_path(card, layout, trees):
    """The batch kernels' word-by-word copies, on ``[S, n/32]`` words
    against the plain batched network: masks one word off alignment; words
    one word off alignment; tiles of 2 words (rows under 4 words); and
    networks of 32, 64 and 128 elements, whose tree strides of 1, 2 and 4
    words leave every tree but the first unaligned."""
    rg = layout
    table, n = rg.net_table, rg.net_size
    rng = np.random.default_rng(10 + trees)
    buf = torch.empty(rg.net_masks.size + 1, dtype=torch.int32, device=card)
    masks = buf[1:]
    masks.copy_(_t(rg.net_masks, card))
    x = _t(_words(rng, trees * n // 32).reshape(trees, -1), card)
    want = R.apply_benes_std(x, masks, table, n)
    _eq(K.apply_benes(x, masks, table, n), want)
    xbuf = torch.empty(trees * (n // 32) + 1, dtype=torch.int32, device=card)
    xm = xbuf[1:].view(trees, n // 32)
    xm.copy_(x)
    ym = torch.empty_like(xbuf)[1:].view(trees, n // 32)
    assert xm.data_ptr() % 16 and ym.data_ptr() % 16
    for tile in (2, 64, 256):
        # From unaligned words into unaligned words, the passes as apply_benes chains them.
        pre, local, suf, _ = K.split_passes(table, n, tile)
        src = xm
        for run in K.outer_plan(table, pre, n):
            K.benes_outer_pass(src, masks, tuple(table[i] for i in run.stages), n, out=ym)
            src = ym
        K.benes_local_pass(src, masks, tuple(table[i] for i in local), n, tile, out=ym)
        for run in K.outer_plan(table, suf, n):
            K.benes_outer_pass(ym, masks, tuple(table[i] for i in run.stages), n, out=ym)
        _eq(ym, want)
        _eq(_passes(x, masks, table, n, tile, True)[1], want)
    for size in (32, 64, 128):
        m, tb = p_relay._compact_and_table(benes.route_std(rng.permutation(size)), size)
        m = _t(m, card)
        xs = _t(_words(rng, trees * size // 32).reshape(trees, -1), card)
        _eq(K.apply_benes(xs, m, tb, size), R.apply_benes_std(xs, m, tb, size))


def test_card_rowmin_and_update_match_plain(card, layout):
    rg = layout
    rng = np.random.default_rng(7)
    l1 = _t(_words(rng, rg.net_size // 32), card)
    valid = _t(valid_slot_words(rg.src_l1, rg.net_size), card)
    ranks = K.rowmin_ranks(l1, valid, rg.in_classes, rg.vr)
    _eq(ranks, R.rowmin_ranks(l1, valid, rg.in_classes, rg.vr))
    lv = rng.integers(0, 6, rg.vr).astype(np.uint32)
    packed = (lv << np.uint32(26)) | rng.integers(0, 1 << 10, rg.vr).astype(np.uint32)
    packed[rng.random(rg.vr) < 0.5] = 0xFFFFFFFF
    packed = _t(packed, card)
    st = R.PackedRelayState(packed, None, 5, None)
    want = R.apply_relay_candidates_packed(st, ranks)
    got = K.apply_relay_candidates_packed(st._replace(packed=packed.clone()), ranks)
    _eq(got.packed, want.packed)
    _eq(got.fwords, want.fwords)
    assert bool(got.changed.item()) == bool(want.changed)


def _wide_classes(tail: int = 64):
    """Rank-major widths 1, 3, 48 and 1,536 (2,048 vertices each), then
    vertex-major widths 64 and 1,000 (a warp per vertex) and 4,096 and
    131,072 (a block per vertex, rows not 16-byte aligned), and a sentinel
    tail: ``(classes, vr, slot words)``."""
    widths = np.array([1, 3, 48, 1536, 64, 1000, 4096, 131072])
    counts = np.array([2048, 2048, 2048, 2048, 3, 5, 2, 1])
    classes = tuple(p_relay._build_classes(widths, counts))
    return classes, classes[-1].vb + tail, -(-classes[-1].sb // 128) * 4


@pytest.mark.parametrize("density", [0.0, 1e-4, 0.01, 0.5, 1.0])
def test_card_class_rowmin_wide_classes_match_plain(card, density):
    classes, vr, nwords = _wide_classes()
    rng = np.random.default_rng(int(density * 1e4))
    l1 = np.packbits(rng.random(32 * nwords) < density, bitorder="little").view(np.uint32)
    valid = np.packbits(rng.random(32 * nwords) < 0.97, bitorder="little").view(np.uint32)
    if density == 1.0:
        valid[:] = 0xFFFFFFFF  # all ones: every vertex's rank is 0
    l1, valid = _t(l1, card), _t(valid, card)
    K.reset_launches()
    got = K.rowmin_ranks(l1, valid, classes, vr)
    torch.cuda.synchronize()
    assert K.LAUNCHES["class_rowmin"] == 1
    _eq(got, R.rowmin_ranks(l1, valid, classes, vr))
    if density == 1.0:
        assert bool((got[: classes[-1].vb] == 0).all()) and bool((got[classes[-1].vb :] == -1).all())


@pytest.mark.parametrize("trees", [5, 16])
def test_card_class_rowmin_batched_wide_classes_match_plain(card, trees):
    """``class_rowmin`` on ``[trees, nw]`` words of the wide classes, the
    trees' L1 densities mixed within each group of the batch's kernel (none,
    1e-4, 0.01, 0.5 and all bits, in turn), so that its trees finish at
    different rows and vertices: one launch, bit for bit its plain batched
    version and single launches; gated by a dead control block, nothing
    written."""
    from bfs_tpu_torch.ops import control as C

    classes, vr, nwords = _wide_classes()
    rng = np.random.default_rng(trees)
    densities = (0.0, 1e-4, 0.01, 0.5, 1.0)
    l1 = np.stack([np.packbits(rng.random(32 * nwords) < densities[i % 5], bitorder="little")
                   .view(np.uint32) for i in range(trees)])
    valid = np.packbits(rng.random(32 * nwords) < 0.97, bitorder="little").view(np.uint32)
    l1, valid = _t(l1, card), _t(valid, card)
    planes = K.rowmin_items(classes, vr, str(card)).planes
    assert planes == 6  # the 1,536-row class: 32 chunks of 48 rows
    assert 1 < K.rowmin_group(trees, planes) <= trees
    K.reset_launches()
    got = K.rowmin_ranks(l1, valid, classes, vr)
    torch.cuda.synchronize()
    assert K.LAUNCHES["class_rowmin"] == 1
    _eq(got, R.rowmin_ranks(l1, valid, classes, vr))
    _eq(got, torch.stack([K.rowmin_ranks(l1[i], valid, classes, vr) for i in range(trees)]))
    assert bool((got[0] == -1).all()) and bool((got[4] != -1).any())
    dead = C.new_ctl(card)
    C.init_ctl(dead, 62)
    dead[C.LIVE] = 0
    out = torch.full_like(got, 7)
    K.rowmin_ranks(l1, valid, classes, vr, out=out, ctl=dead)
    torch.cuda.synchronize()
    assert bool((out == 7).all())


def test_card_bfs_matches_cpu_and_oracle(card):
    g = P.rmat_graph(12, 6, seed=1)
    cpu = P.RelayEngine(g, device="cpu", sparse_hybrid=False)
    on_card = P.RelayEngine(g, sparse_hybrid=False, expansion="gather")  # dense: K1-K4
    assert p_bfs.resolve_device().type == "cuda"
    K.reset_launches()
    for s in (0, 9):
        a, b = on_card.run(s), cpu.run(s)
        np.testing.assert_array_equal(a.dist, b.dist)
        np.testing.assert_array_equal(a.parent, b.parent)
        assert a.num_levels == b.num_levels
        dist, parent = P.canonical_bfs(g, s)
        np.testing.assert_array_equal(a.dist, dist)
        np.testing.assert_array_equal(a.parent, parent)
    assert K.LAUNCHES["benes_local_pass"] > 0
    assert K.LAUNCHES["class_rowmin"] > 0 and K.LAUNCHES["packed_update"] > 0


def _state(rng, rg, level: int, card) -> RE.ElemState:
    """A G = 2 elem carry with random visited bits (frontier a subset) and
    random distance and rank planes."""
    _, pt = RE.rank_plane_layout(rg.in_classes)
    visited = _words(rng, 2 * rg.vr)
    frontier = visited & _words(rng, 2 * rg.vr)
    return RE.ElemState(
        _t(visited, card).reshape(2, rg.vr), _t(frontier, card).reshape(2, rg.vr),
        _t(_words(rng, RE.DIST_PLANES * 2 * rg.vr), card).reshape(RE.DIST_PLANES, 2, rg.vr),
        _t(_words(rng, 2 * pt), card).reshape(2, pt), level, None,
    )


def test_card_elem_benes_kernels_match_plain(card, layout):
    rg = layout
    x = _t(_words(np.random.default_rng(8), 2 * rg.net_size), card).reshape(2, rg.net_size)
    masks = _t(rg.net_masks, card)
    want = RE.apply_benes_elem(x, masks, rg.net_table, rg.net_size)
    _eq(K.apply_benes_elem(x, masks, rg.net_table, rg.net_size), want)
    K.reset_launches()
    for tile in (1024, 4096):  # small tiles force outer stages at this size
        pre, local, suf, _ = K.split_elem_passes(rg.net_table, rg.net_size, tile)
        y = x
        for i in pre:
            y = K.benes_elem_outer_stage(y, masks, rg.net_table[i], rg.net_size)
        y = K.benes_elem_local_pass(y, masks, tuple(rg.net_table[i] for i in local), rg.net_size, tile)
        for i in suf:
            y = K.benes_elem_outer_stage(y, masks, rg.net_table[i], rg.net_size)
        _eq(y, want)
    torch.cuda.synchronize()
    assert K.LAUNCHES["benes_elem_local_pass"] == 2 and K.LAUNCHES["benes_elem_outer_stage"] > 0


def _routed_network(log_n: int, seed: int, moved: float = 1.0):
    """Stored masks and stage table of a routed permutation of 2^log_n
    elements that moves the first ``moved`` of them and fixes the rest
    (whose masks are then zero: tiles there skip stages)."""
    n = 1 << log_n
    rng = np.random.default_rng(seed)
    k = int(n * moved)
    perm = np.concatenate([rng.permutation(k), np.arange(k, n)]).astype(np.int64)
    masks, table = p_relay._compact_and_table(benes.route_std(perm), n)
    return masks, table, n


@pytest.mark.parametrize("log_n,groups,tile,moved", [
    (16, 2, 1 << 15, 1.0),  # two tiles; compact stages in registers
    (13, 3, 1 << 13, 1.0),  # one tile: the whole network
    (16, 1, 1 << 12, 1.0),  # partial register windows (7, 2, 0, 5, 7), 16 tiles
    (18, 2, 1 << 15, 0.25),  # tiles past the moved quarter skip every stage
    (6, 2, 1 << 5, 1.0),  # a tile of 32 elements: one thread
])
def test_card_elem_local_pass_matches_plain(card, log_n, groups, tile, moved):
    """``benes_elem_local_pass`` (stages in registers between re-layouts)
    against the plain local run, into a fresh output and in place."""
    masks, table, n = _routed_network(log_n, log_n, moved)
    _, local, _, t = K.split_elem_passes(table, n, tile)
    stages = tuple(table[i] for i in local)
    x = _t(_words(np.random.default_rng(log_n), groups * n), card).reshape(groups, n)
    m = _t(masks, card)
    want = RE.apply_benes_elem(x, m, stages, n)
    K.reset_launches()
    _eq(K.benes_elem_local_pass(x, m, stages, n, t), want)
    y = x.clone()
    _eq(K.benes_elem_local_pass(y, m, stages, n, t, out=y), want)
    torch.cuda.synchronize()
    assert K.LAUNCHES["benes_elem_local_pass"] == 2


@pytest.mark.parametrize("level", [3, 31])
def test_card_elem_rowmin_update_matches_plain(card, layout, level):
    rg = layout
    rng = np.random.default_rng(level)
    l1 = _t(_words(rng, 2 * rg.net_size), card).reshape(2, rg.net_size)
    valid = _t(valid_slot_words(rg.src_l1, rg.net_size), card)
    st = _state(rng, rg, level, card)
    offsets, pt = RE.rank_plane_layout(rg.in_classes)
    found, rp = RE.rowmin_elem(l1, valid, rg.in_classes, rg.vr, offsets, pt)
    want = RE.apply_elem_found(st, found, rp, rg.in_classes, offsets)
    got = K.elem_rowmin_update(l1, valid, RE.ElemState(*(t.clone() for t in st[:4]), level, None),
                               rg.in_classes, rg.vr)
    for a, b in zip(got[:4], want[:4]):
        _eq(a, b)
    assert got.level == want.level
    assert bool(got.changed.item()) == bool(want.changed)


def _elem_classes(tail: int = 40):
    """Rank-major widths 1, 33, 256 and 1,536 (the scale-22 layout's widest
    rank-major class: 8 chunks of 192 rows), vertex-major widths 33 (padded
    to 64), 256 and 1,536 (a warp per vertex) and 8,192 (a block per
    vertex), and a tail of vertices in no class: ``(classes, vr, n)``."""
    widths = np.array([1, 33, 256, 1536, 33, 256, 1536, 8192])
    counts = np.array([300, 70, 300, 1600, 5, 3, 2, 2])
    classes = tuple(p_relay._build_classes(widths, counts))
    return classes, classes[-1].vb + tail, -(-classes[-1].sb // 128) * 128


@pytest.mark.parametrize("level", [3, 31])
@pytest.mark.parametrize("density", [0.0, 1e-4, 0.01, 0.5, 1.0])
def test_card_elem_rowmin_update_wide_classes_match_plain(card, density, level):
    """Every kind of the work table (chunked rank-major rows, a warp and a
    block per vertex-major vertex) against the plain row-min and update, at
    the l1 densities of the class_rowmin test (all ones with every slot
    valid: every unvisited tree is found at row 0)."""
    classes, vr, n = _elem_classes()
    rng = np.random.default_rng(int(density * 1e4) + level)
    bits = rng.random((2, n, 32)) < density
    l1 = np.packbits(bits, axis=-1, bitorder="little").view(np.uint32)[..., 0]
    valid = np.packbits(rng.random(n) < 0.97, bitorder="little").view(np.uint32)
    if density == 1.0:
        valid[:] = 0xFFFFFFFF
    l1, valid = _t(l1, card), _t(valid, card)
    offsets, pt = RE.rank_plane_layout(classes)
    visited = _words(rng, 2 * vr)
    st = RE.ElemState(
        _t(visited, card).reshape(2, vr), _t(visited & _words(rng, 2 * vr), card).reshape(2, vr),
        _t(_words(rng, RE.DIST_PLANES * 2 * vr), card).reshape(RE.DIST_PLANES, 2, vr),
        _t(_words(rng, 2 * pt), card).reshape(2, pt), level, None,
    )
    found, rp = RE.rowmin_elem(l1, valid, classes, vr, offsets, pt)
    want = RE.apply_elem_found(st, found, rp, classes, offsets)
    K.reset_launches()
    got = K.elem_rowmin_update(l1, valid, RE.ElemState(*(t.clone() for t in st[:4]), level, None),
                               classes, vr)
    torch.cuda.synchronize()
    assert K.LAUNCHES["elem_rowmin_update"] == 1
    for a, b in zip(got[:4], want[:4]):
        _eq(a, b)
    assert bool(got.changed.item()) == bool(want.changed)
    if density == 1.0:
        assert bool((got.frontier[:, : classes[-1].vb] == ~st.visited[:, : classes[-1].vb]).all())


def test_card_multi_elem_matches_cpu_and_oracle(card):
    g = P.rmat_graph(12, 6, seed=1)
    sources = np.random.default_rng(2).choice(g.num_vertices, 64, replace=False)
    K.reset_launches()
    a = P.RelayEngine(g).run_multi_elem(sources)
    b = P.RelayEngine(g, device="cpu").run_multi_elem(sources)
    np.testing.assert_array_equal(a.dist, b.dist)
    np.testing.assert_array_equal(a.parent, b.parent)
    assert a.num_levels == b.num_levels
    for i in (0, 31, 32, 63):
        dist, parent = P.canonical_bfs(g, int(sources[i]))
        np.testing.assert_array_equal(a.dist[i], dist)
        np.testing.assert_array_equal(a.parent[i], parent)
    for name in ("benes_elem_local_pass", "benes_elem_outer_stage", "elem_route_gather",
                 "elem_rowmin_update"):
        assert K.LAUNCHES[name] > 0, name


def test_card_route_index_kernels_match_plain(card, layout):
    """The index built through the K5 kernels equals the one built through
    the plain networks, on the card and on the CPU; the build launches
    the K5 local pass, a batch superstep none."""
    rg = layout
    eng = P.RelayEngine(rg)
    K.reset_launches()
    src = eng.route_index()
    torch.cuda.synchronize()
    assert K.LAUNCHES["benes_elem_local_pass"] == 2  # one per network at this size
    plain = RE.route_index(lambda x: eng.routed_elem(x, benes=RE.apply_benes_elem), rg.vr, card)
    _eq(src, plain)
    _eq(src, P.RelayEngine(rg, device="cpu").route_index())
    _, pt = RE.rank_plane_layout(rg.in_classes)
    st = RE.init_elem_state(rg.vr, rg.old2new[np.arange(32) % rg.num_vertices].reshape(1, 32), pt, card)
    K.reset_launches()
    eng.superstep_elem(st)
    torch.cuda.synchronize()
    assert K.LAUNCHES["elem_route_gather"] == 1 and K.LAUNCHES["elem_rowmin_update"] == 1
    assert K.LAUNCHES["benes_elem_local_pass"] == K.LAUNCHES["benes_elem_outer_stage"] == 0


@pytest.mark.parametrize("groups", [1, 2, 3, 4])
def test_card_elem_route_gather_matches_plain(card, layout, groups):
    """The gather (from the interleaved frontier at G = 2 and 4, one
    ``elem_frontier_interleave`` launch before it) against the plain gather
    and the route through the networks."""
    rg = layout
    eng = P.RelayEngine(rg)
    src = eng.route_index()
    f = _t(_words(np.random.default_rng(groups), groups * rg.vr), card).reshape(groups, rg.vr)
    K.reset_launches()
    got = K.elem_route_gather(f, src)
    torch.cuda.synchronize()
    assert K.LAUNCHES["elem_route_gather"] == 1
    assert K.LAUNCHES["elem_frontier_interleave"] == int(groups in K.INTERLEAVED_GROUPS)
    _eq(got, RE.route_gather(f, src))
    _eq(got, eng.routed_elem(f))  # the networks themselves, through the K5 kernels
    out = torch.full_like(got, 7)
    _eq(K.elem_route_gather(f, src, out=out), got)


@pytest.mark.parametrize("groups,vr", [(2, 4103), (4, 70001), (2, 1 << 20)])
def test_card_elem_frontier_interleave_matches_plain(card, groups, vr):
    f = _t(_words(np.random.default_rng(vr), groups * vr), card).reshape(groups, vr)
    K.reset_launches()
    got = K.elem_frontier_interleave(f)
    torch.cuda.synchronize()
    assert K.LAUNCHES["elem_frontier_interleave"] == 1
    _eq(got, RE.interleave_frontier(f))
    _eq(got, f.t())


# ------------------------------------------------------------ MXU arm (K6) --

def _tiles_on(card, src, dst, rows: int, cols: int, n2o):
    """The layout built on the card and its operand tuple there."""
    at = PT.build_adj_tiles_device(
        torch.from_numpy(np.asarray(src, np.int64)), torch.from_numpy(np.asarray(dst, np.int64)),
        rows=rows, cols=cols, keys2d=PT.keys_from_new2old(n2o, rows), device=card,
    )
    kw = dict(rows=rows, cols=cols, rtp=at.rtp, vtp=at.vtp)
    return at, RM.mxu_device_operands(at, card), kw


def _frontier(rng, rows: int, fr: float, card) -> torch.Tensor:
    bits = torch.from_numpy(rng.random(-(-rows // 32) * 32) < fr)
    return R.pack_std(bits).to(card)


@pytest.mark.parametrize("rows,cols,e,fr", [
    (200, 200, 900, 0.4), (4000, 300, 2500, 0.02), (500, 9000, 3000, 0.9),
    (20000, 20000, 400000, 0.3), (20000, 20000, 400000, 1.0),
])
def test_card_mxu_expand_matches_plain(card, rows, cols, e, fr):
    rng = np.random.default_rng(e)
    src = rng.integers(0, rows, e)
    dst = rng.integers(0, cols, e)
    _, ops, kw = _tiles_on(card, src, dst, rows, cols, rng.permutation(rows))
    fw = _frontier(rng, rows, fr, card)
    K.reset_launches()
    got = K.expand_frontier_mxu(fw, ops, **kw)
    torch.cuda.synchronize()
    assert K.LAUNCHES["mxu_expand"] == 1
    _eq(got, RM.expand_frontier_mxu_plain(fw, ops, **kw))


def test_card_mxu_expand_every_16bit_mask(card):
    """64 tiles whose 8 groups of 16 rows x 128 columns spell every 16-bit
    mask 0..65535, the whole frontier set: each output equals the
    brute-force min key, so every tensor-core sum was exact."""
    p = np.arange(1 << 16, dtype=np.int64)
    pi, b = np.nonzero((p[:, None] >> np.arange(16)) & 1)
    t, grp, v = pi // 1024, (pi // 128) % 8, pi % 128
    src = t * 128 + 16 * grp + b
    dst = t * 128 + v
    rows = cols = 64 * 128
    rng = np.random.default_rng(16)
    n2o = rng.permutation(rows)
    at, ops, kw = _tiles_on(card, src, dst, rows, cols, n2o)
    assert at.nt == 64
    want = np.full(cols, 0xFFFFFFFF, np.uint64)
    np.minimum.at(want, dst, n2o[src].astype(np.uint64))
    for fw in (torch.full((rows // 32,), -1, dtype=torch.int32, device=card),
               _frontier(rng, rows, 0.5, card)):
        got = K.expand_frontier_mxu(fw, ops, **kw)
        _eq(got, RM.expand_frontier_mxu_plain(fw, ops, **kw))
    got = K.expand_frontier_mxu(torch.full((rows // 32,), -1, dtype=torch.int32, device=card), ops, **kw)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32).astype(np.uint64), want)


def _ops_on(card, tiles: np.ndarray, row_idx, col_id, rows: int):
    """A hand-made operand tuple on the card (keys: a seeded permutation,
    the sentinel pad block)."""
    n2o = np.random.default_rng(rows).permutation(rows)
    return (_t(tiles.reshape(-1), card).reshape(-1, 128, 4),
            torch.tensor(row_idx, dtype=torch.int32, device=card),
            torch.tensor(col_id, dtype=torch.int32, device=card),
            PT.keys_from_new2old(n2o, rows).to(card))


def test_card_mxu_expand_mixes_both_paths_on_shared_columns(card):
    """One launch over tiles holding MXU_SPARSE_MAX_BITS - 1, MXU_SPARSE_MAX_BITS
    (sparse path) and MXU_SPARSE_MAX_BITS + 1 (tensor cores) reachable bits,
    every bit in the same 8 destination columns of one column block, so
    atomics of both paths meet on each output."""
    thr = K.MXU_SPARSE_MAX_BITS
    rows = cols = 16384
    rng = np.random.default_rng(thr)
    ks = [thr - 1] * 24 + [thr] * 24 + [thr + 1] * 24
    rng.shuffle(ks)
    tiles = np.zeros((len(ks), 128, 4), np.uint32)
    for i, k in enumerate(ks):
        cells = rng.choice(128 * 8, k, replace=False)  # (row u, column v < 8)
        np.bitwise_or.at(tiles[i, :, 0], cells // 8, np.uint32(1) << (cells % 8).astype(np.uint32))
    row_idx = rng.integers(0, rows // 128, len(ks))
    ops = _ops_on(card, tiles, row_idx, np.full(len(ks), 5), rows)
    kw = dict(rows=rows, cols=cols, rtp=rows, vtp=cols)
    full = torch.full((rows // 32,), -1, dtype=torch.int32, device=card)
    np.testing.assert_array_equal(RM.reachable_bits(full, ops, rows=rows, rtp=rows).cpu().numpy(), ks)
    for fw in (full, _frontier(rng, rows, 0.7, card)):
        K.reset_launches()
        got = K.expand_frontier_mxu(fw, ops, **kw)
        torch.cuda.synchronize()
        assert K.LAUNCHES["mxu_expand"] == 1
        _eq(got, RM.expand_frontier_mxu_plain(fw, ops, **kw))
    assert bool((got[5 * 128 : 5 * 128 + 8] != -1).all())


def test_card_mxu_expand_one_bit_tiles_pad_block_and_overflow(card):
    """5,000 one-bit tiles, with tiles on the zero frontier pad block (row
    block rtp / 128, bits set) and on the dropped overflow segment (column
    block vtp / 128, frontier set) mixed in: neither may write."""
    rows = cols = 16384
    rng = np.random.default_rng(1)
    nt = 5000
    tiles = np.zeros((nt, 128, 4), np.uint32)
    cell = rng.integers(0, 128 * 128, nt)
    tiles[np.arange(nt), cell // 128, (cell % 128) // 32] = np.uint32(1) << (cell % 32).astype(np.uint32)
    row_idx = rng.integers(0, rows // 128, nt)
    col_id = np.sort(rng.integers(0, cols // 128, nt))
    row_idx[rng.random(nt) < 0.1] = rows // 128  # the pad block
    col_id[rng.random(nt) < 0.1] = cols // 128  # the overflow segment
    ops = _ops_on(card, tiles, row_idx, col_id, rows)
    kw = dict(rows=rows, cols=cols, rtp=rows, vtp=cols)
    for fw in (torch.full((rows // 32,), -1, dtype=torch.int32, device=card),
               _frontier(rng, rows, 0.3, card)):
        got = K.expand_frontier_mxu(fw, ops, **kw)
        _eq(got, RM.expand_frontier_mxu_plain(fw, ops, **kw))
    assert bool((got != -1).any())


def test_card_mxu_expand_empty_frontier_and_devices(card, monkeypatch):
    rng = np.random.default_rng(5)
    src, dst = rng.integers(0, 3000, 9000), rng.integers(0, 3000, 9000)
    _, ops, kw = _tiles_on(card, src, dst, 3000, 3000, rng.permutation(3000))
    K.reset_launches()
    got = K.expand_frontier_mxu(torch.zeros(94, dtype=torch.int32, device=card), ops, **kw)
    torch.cuda.synchronize()
    assert K.LAUNCHES["mxu_expand"] == 1 and bool((got == -1).all())
    with pytest.raises(ValueError):  # a device mix
        K.expand_frontier_mxu(torch.zeros(94, dtype=torch.int32), ops, **kw)
    # a CPU call never builds a library
    cpu_ops = tuple(t.cpu() for t in ops)

    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor must not build the kernels")

    monkeypatch.setattr(cuda_build, "load", refuse)
    monkeypatch.setattr(cuda_build, "build", refuse)
    K.expand_frontier_mxu(torch.full((94,), -1, dtype=torch.int32), cpu_ops, **kw)


def test_card_mxu_engine_matches_gather_and_oracle(card):
    g = P.rmat_graph(12, 6, seed=1)
    mxu = P.RelayEngine(g, expansion="mxu", sparse_hybrid=False)
    gather = P.RelayEngine(g, sparse_hybrid=False, expansion="gather")
    assert mxu.adj_tiles.device.type == "cuda"
    K.reset_launches()
    for s in (0, 9):
        a, b = mxu.run(s), gather.run(s)
        np.testing.assert_array_equal(a.dist, b.dist)
        np.testing.assert_array_equal(a.parent, b.parent)
        assert a.num_levels == b.num_levels
    assert K.LAUNCHES["mxu_expand"] > 0 and K.LAUNCHES["packed_update"] > 0
    path = P.path_graph(70)  # past the packed cap: the unpacked re-run through K6
    res = P.RelayEngine(path, expansion="mxu").run(0)
    dist, parent = P.canonical_bfs(path, 0)
    np.testing.assert_array_equal(res.dist, dist)
    np.testing.assert_array_equal(res.parent, parent)
    assert res.num_levels == 70


# ------------------------------------------------ the block loop on the card --

#: Kernel launches per superstep of each block loop.
PER_STEP = {
    "gather": {"benes_outer_pass": 4, "benes_local_pass": 2, "class_rowmin": 1,
               "packed_update": 1, "loop_control": 1},
    "mxu": {"mxu_expand": 1, "packed_update": 1, "loop_control": 1},
    "elem": {"elem_frontier_interleave": 1, "elem_route_gather": 1, "elem_rowmin_update": 1,
             "loop_control": 1},
}


def _counts(names):
    torch.cuda.synchronize()
    return {n: K.LAUNCHES[n] for n in names}


@pytest.mark.parametrize("expansion", ["gather", "mxu"])
def test_card_captured_loop_matches_eager(card, expansion):
    """The captured block loop against the eager loop, bit for bit, and its
    accounting: launches = per-superstep count x supersteps issued, live
    supersteps = num_levels, one host read per replay."""
    from bfs_tpu_torch.models import loop as L

    g = P.rmat_graph(12, 6, seed=1)
    eng = P.RelayEngine(g, expansion=expansion, sparse_hybrid=False)  # the dense block loop
    eng.run(0)  # captures the graph
    per_step = dict(PER_STEP[expansion])
    if expansion == "gather":  # outer passes of both networks at this size
        rg = eng.relay_graph
        per_step["benes_outer_pass"] = sum(
            len(K.outer_plan(tb, side, n))
            for tb, n in ((rg.vperm_table, rg.vperm_size), (rg.net_table, rg.net_size))
            for side in K.split_passes(tb, n)[0:3:2])
    for s in (0, 9, 100):
        K.reset_launches()
        got = eng.run(s)
        run = dict(eng.last_run)
        assert _counts(per_step) == {n: c * run["issued"] for n, c in per_step.items()}
        assert run["live"] == got.num_levels and run["host_reads"] == run["replays"]
        assert run["issued"] == L.BLOCK * run["replays"]
        eng.loop = "eager"
        want = eng.run(s)
        eng.loop = "blocks"
        np.testing.assert_array_equal(got.dist, want.dist)
        np.testing.assert_array_equal(got.parent, want.parent)
        assert got.num_levels == want.num_levels
    # A block replayed past convergence changes nothing.
    loop = eng._packed_loop()
    before = [b.clone() for b in loop.buffers]
    loop.dead_replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(before, loop.buffers))
    # The unpacked re-run and the truncation through the captured loops.
    path = P.path_graph(100)
    a = P.RelayEngine(path, expansion=expansion).run(0)
    dist, parent = P.canonical_bfs(path, 0)
    np.testing.assert_array_equal(a.dist, dist)
    np.testing.assert_array_equal(a.parent, parent)
    assert a.num_levels == 100


def test_card_captured_elem_loop_matches_eager(card):
    from bfs_tpu_torch.models import loop as L

    g = P.rmat_graph(12, 6, seed=1)
    sources = np.random.default_rng(2).choice(g.num_vertices, 64, replace=False)
    eng = P.RelayEngine(g)
    eng.run_multi_elem_device(sources)  # builds the route index, captures
    K.reset_launches()
    st = eng.run_multi_elem_device(sources)
    run = dict(eng.last_run)
    per_step = PER_STEP["elem"]
    assert _counts(per_step) == {n: c * run["issued"] for n, c in per_step.items()}
    assert run["live"] == st.level and run["issued"] == L.BLOCK * run["replays"]
    got = [t.clone() for t in st[:4]]
    eng.loop = "eager"
    want = eng.run_multi_elem_device(sources)
    for a, b in zip(got, want[:4]):
        _eq(a, b)
    assert (st.level, st.changed) == (want.level, bool(want.changed))
    a = eng.run_multi_elem(sources)
    eng.loop = "blocks"
    b = eng.run_multi_elem(sources)
    np.testing.assert_array_equal(a.dist, b.dist)
    np.testing.assert_array_equal(a.parent, b.parent)
    path = P.path_graph(33)  # eccentricity 32 from vertex 0: the fallback
    res = P.RelayEngine(path).run_multi_elem(np.arange(32))
    dist, parent = P.canonical_bfs(path, 0)
    np.testing.assert_array_equal(res.dist[0], dist)
    np.testing.assert_array_equal(res.parent[0], parent)


def test_card_result_path_matches_cpu(card):
    g = P.rmat_graph(11, 6, seed=3)
    sources = np.random.default_rng(4).choice(g.num_vertices, 64, replace=False)
    gpu, cpu = P.RelayEngine(g), P.RelayEngine(g, device="cpu")
    for s, st in zip((0, 17), gpu.run_many_device([0, 17])):
        for a, b in zip(gpu.to_original_device(st, s), cpu.to_original_device(
                cpu.run_many_device([s])[0], s)):
            _eq(a, b)
    a, b = gpu.run_multi_elem(sources), cpu.run_multi_elem(sources)
    np.testing.assert_array_equal(a.dist, b.dist)
    np.testing.assert_array_equal(a.parent, b.parent)
    st = gpu.run_multi_elem_device(sources)
    for i in (0, 33):
        for x, y in zip(gpu.multi_tree_to_original_device(st, i, int(sources[i])),
                        (a.dist[i], a.parent[i])):
            np.testing.assert_array_equal(x.cpu().numpy(), y)


def test_card_capture_failure_raises(card):
    """A superstep that syncs with the host cannot be captured: the loop
    raises rather than fall back to the eager loop."""
    from bfs_tpu_torch.models import loop as L
    from bfs_tpu_torch.ops import control as C

    ctl = C.new_ctl(card)
    C.init_ctl(ctl, 4)

    def step():
        if bool(ctl[C.LIVE]):  # a host read: refused under capture
            K.loop_control(ctl)

    loop = L.BlockLoop((ctl,), step, k=2)
    with pytest.raises(RuntimeError):
        loop.run(True)


@pytest.mark.parametrize("engine", ["push", "pull"])
def test_card_edge_engine_matches_eager_cpu_and_oracle(card, engine):
    """A push or pull search on the captured loop against the eager loop,
    the CPU and the oracle; its accounting (one control step per superstep
    issued); a dead block; the batch and SuperstepRunner on the card."""
    from bfs_tpu_torch.models import loop as L

    g = P.rmat_graph(12, 6, seed=1)
    eng, cpu = P.EdgeEngine(g, engine=engine), P.EdgeEngine(g, engine=engine, device="cpu")
    eng.run(0)  # captures the graph
    for s in (0, 9, 100):
        K.reset_launches()
        got = eng.run(s)
        run = dict(eng.last_run)
        assert _counts(["loop_control"]) == {"loop_control": run["issued"]}
        assert run["live"] == got.num_levels and run["issued"] == L.EDGE_BLOCK * run["replays"]
        eng.loop = "eager"
        for want in (eng.run(s), cpu.run(s)):
            np.testing.assert_array_equal(got.dist, want.dist)
            np.testing.assert_array_equal(got.parent, want.parent)
            assert got.num_levels == want.num_levels
        eng.loop = "blocks"
        dist, parent = P.canonical_bfs(g, s)
        np.testing.assert_array_equal(got.dist, dist)
        np.testing.assert_array_equal(got.parent, parent)
    loop = eng._packed_loop()
    before = [b.clone() for b in loop.buffers]
    loop.dead_replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(before, loop.buffers))
    sources = [0, 9, 100, 9]
    a, b = eng.run_multi(sources), cpu.run_multi(sources)
    np.testing.assert_array_equal(a.dist, b.dist)
    np.testing.assert_array_equal(a.parent, b.parent)
    res = P.SuperstepRunner(g, engine=engine).run(9)
    np.testing.assert_array_equal(res.dist, cpu.run(9).dist)
    path = P.path_graph(100)  # the unpacked re-run through the captured loops
    c = P.bfs(path, 0, engine=engine)
    np.testing.assert_array_equal(c.dist, np.arange(100, dtype=np.int32))
    assert c.num_levels == 100


def test_card_relay_runner_matches_cpu(card, monkeypatch):
    monkeypatch.setenv("BFS_TPU_TORCH_EXPANSION", "gather")  # the runner's engine: K1-K4
    g = P.rmat_graph(11, 6, seed=2)
    gpu, cpu = P.SuperstepRunner(g, engine="relay"), P.SuperstepRunner(g, engine="relay",
                                                                        device="cpu")
    a, b = gpu.init(5), cpu.init(5)
    while bool(b.changed):
        K.reset_launches()
        a, b = gpu.step(a), cpu.step(b)
        assert _counts(["class_rowmin", "packed_update"]) == {"class_rowmin": 1, "packed_update": 1}
        for x, y in zip(gpu.to_original(a, source=5), cpu.to_original(b, source=5)):
            np.testing.assert_array_equal(x, y)
    assert int(a.level) == int(b.level) and not bool(a.changed)


# ------------------------------------------------ the direction loop, verifier --

@pytest.mark.parametrize("mode", ["auto", "push", "pull"])
def test_card_direction_loop_replays_one_body_per_superstep(card, mode):
    """The two-graph direction loop on the card: each body's graph captured
    once; every superstep one replay of the body that USE_PULL named (the
    replays add up to the supersteps issued, their split is the schedule,
    one control step each); results and schedules equal the CPU's, the
    eager loop's and the oracle; a dead replay of either graph changes
    nothing."""
    from bfs_tpu_torch.models import direction as D
    from bfs_tpu_torch.ops import control as C

    g = P.gnm_graph(1 << 12, 3 << 12, seed=5)
    s0 = int(np.argmax(np.bincount(g.src, minlength=g.num_vertices)))
    cfg = D.DirectionConfig(mode=mode)
    eng = D.DirectionEngine.from_graph(g, config=cfg)
    cpu = D.DirectionEngine.from_graph(g, device="cpu", config=cfg)
    eng.run(s0)  # captures the graphs
    loop = eng._loops[(mode, True, None)]
    assert all(b.graph is not None for b in loop.bodies.values())
    assert sorted(loop.bodies) == ([0, 1] if mode == "auto" else [D._BODY[mode]])
    for s in (s0, 9, 100):
        K.reset_launches()
        got, sched = eng.run(s)
        run = dict(eng.last_run)
        assert _counts(["loop_control"]) == {"loop_control": run["issued"]}
        assert run["replays"] == run["issued"] == run["issued_push"] + run["issued_pull"]
        assert (run["issued_push"], run["issued_pull"]) == (sched["push_supersteps"],
                                                            sched["pull_supersteps"])
        assert run["live"] == got.num_levels == len(sched["schedule"])
        assert int(loop.ctl[C.USE_PULL]) in (0, 1)
        want, wsched = cpu.run(s)
        np.testing.assert_array_equal(got.dist, want.dist)
        np.testing.assert_array_equal(got.parent, want.parent)
        assert got.num_levels == want.num_levels and sched == wsched
        eng.loop = "eager"
        want, wsched = eng.run(s)
        eng.loop = "blocks"
        np.testing.assert_array_equal(got.dist, want.dist)
        np.testing.assert_array_equal(got.parent, want.parent)
        assert sched == wsched
        dist, parent = P.canonical_bfs(g, s)
        np.testing.assert_array_equal(got.dist, dist)
        np.testing.assert_array_equal(got.parent, parent)
    before = [b.clone() for b in loop.buffers]
    for body in loop.bodies.values():
        body.dead_replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(before, loop.buffers))
    sources = [s0, 9, 100, 9]
    a, asched = eng.run_multi(sources)
    b, bsched = cpu.run_multi(sources)
    np.testing.assert_array_equal(a.dist, b.dist)
    np.testing.assert_array_equal(a.parent, b.parent)
    assert asched == bsched
    times = []
    eng.run(s0, times=times)
    assert [b for b, _ in times] == [int(x == "pull") for x in eng.run(s0)[1]["schedule"]]
    assert all(ms > 0 for _, ms in times)
    path, psched = D.bfs_direction(P.path_graph(80), 0, config=cfg)  # the unpacked re-run
    np.testing.assert_array_equal(path.dist, np.arange(80, dtype=np.int32))
    assert len(psched["schedule"]) == 80


def test_card_level_curves_match_cpu(card):
    g = P.rmat_graph(11, 6, seed=2)
    for engine in ("pull", "push", "relay"):
        got = P.bfs_level_curve(g, 5, engine=engine)
        assert got == P.bfs_level_curve(g, 5, engine=engine, device="cpu")
    assert (P.bfs_multi_level_curve(g, [5, 9, 5], engine="push")
            == P.bfs_multi_level_curve(g, [5, 9, 5], engine="push", device="cpu"))
    eng = P.RelayEngine(g, sparse_hybrid=False, expansion="gather")  # the recorder in the dense block
    eng.run_level_curve(5)
    K.reset_launches()
    curve = eng.run_level_curve(9)
    run = eng.last_run
    assert _counts(["class_rowmin", "packed_update", "loop_control"]) == {
        "class_rowmin": run["issued"], "packed_update": run["issued"],
        "loop_control": run["issued"]}
    assert curve["reachable"] == int((P.canonical_bfs(g, 9)[0] != P.INF_DIST).sum())


def test_card_device_checker_matches_cpu(card):
    from bfs_tpu_torch.oracle.device import DeviceChecker

    g = P.rmat_graph(11, 6, seed=2)
    dc, cpu = DeviceChecker.from_graph(g), DeviceChecker.from_graph(g, device="cpu")
    assert dc.src.is_cuda
    dist, parent = P.canonical_bfs(g, [3, 40])
    rng = np.random.default_rng(0)
    for trial in range(4):
        d, p = dist.copy(), parent.copy()
        if trial:
            idx = rng.choice(g.num_vertices, 6, replace=False)
            d[idx[:3]] = rng.integers(0, 6, 3)
            p[idx[3:]] = rng.integers(-1, g.num_vertices, 3)
        got = dc.counts(torch.from_numpy(d).cuda(), torch.from_numpy(p).cuda(), [3, 40])
        assert got.is_cuda
        want = cpu.counts(torch.from_numpy(d), torch.from_numpy(p), [3, 40])
        _eq(got, want)
        assert (dc.check(d, p, [3, 40]) == {}) == (P.check(g, d, p, [3, 40]) == [])
    words = dc.packed_reached(torch.from_numpy(dist).cuda())
    assert dc.coverage_mismatch(torch.from_numpy(dist).cuda(), words) == 0
    eng = P.RelayEngine(g)
    st = eng.run_many_device([3])[0]
    assert dc.check(*eng.to_original_device(st, 3), 3) == {}


def test_card_device_checker_host_edges_land_on_the_card(card):
    """Host edge arrays with no device named go to the card; a card result
    given to a CPU checker raises rather than being copied to the host."""
    from bfs_tpu_torch.oracle.device import DeviceChecker

    g = P.rmat_graph(9, 4, seed=1)
    dc = DeviceChecker(g.src, g.dst, g.num_vertices)
    assert dc.src.is_cuda and dc.dst.is_cuda and dc.device.type == "cuda"
    dist, parent = P.canonical_bfs(g, 5)
    assert dc.check(torch.from_numpy(dist).cuda(), torch.from_numpy(parent).cuda(), 5) == {}
    cpu = DeviceChecker(g.src, g.dst, g.num_vertices, device="cpu")
    with pytest.raises(ValueError):
        cpu.check(torch.from_numpy(dist).cuda(), parent, 5)


# ------------------------------------------------ the relay engine's hybrid --

def _hybrid_graph():
    """A G(n, m) whose frontier from its max-degree vertex ramps through the
    thresholds, and the budgets (patched below) small enough that its dense
    middle is over them."""
    g = P.gnm_graph(1 << 12, 3 << 12, seed=5)
    return g, int(np.argmax(np.bincount(g.src, minlength=g.num_vertices)))


@pytest.mark.parametrize("expansion", ["gather", "mxu"])
@pytest.mark.parametrize("mode", ["auto", "push"])
def test_card_relay_switch_loop_replays_one_body_per_superstep(card, monkeypatch, mode, expansion):
    """The hybrid's switch loop on the card: both bodies' graphs captured
    once; every superstep one replay of the body its control block named
    (the replays add up to the supersteps issued, split as the schedule);
    the dense kernels launched once per dense superstep and the control
    step once per superstep; results and schedules equal to the CPU's, the
    eager loop's and the oracle's; a dead replay of either graph changes
    nothing; ``run_many_device`` and the path past the packed cap."""
    from bfs_tpu_torch.ops import control as C
    from bfs_tpu_torch.ops import sparse as S

    monkeypatch.setattr(S, "SPARSE_BV", 512)
    monkeypatch.setattr(S, "SPARSE_BE", 2048)
    g, s0 = _hybrid_graph()
    eng = P.RelayEngine(g, direction=mode, expansion=expansion)
    cpu = P.RelayEngine(g, device="cpu", direction=mode, expansion=expansion)
    eng.run(s0)  # captures both graphs
    loop = eng._switch_loop(eng.packed)
    assert sorted(loop.bodies) == [0, 1] and all(b.graph is not None for b in loop.bodies.values())
    dense = {"mxu_expand": 1} if expansion == "mxu" else {"class_rowmin": 1, "benes_local_pass": 2}
    for s in (s0, 9, 100):
        K.reset_launches()
        got = eng.run(s)
        run = dict(eng.last_run)
        assert run["replays"] == run["issued"] == run["issued_push"] + run["issued_pull"]
        assert run["live"] == got.num_levels
        assert _counts([*dense, "packed_update", "loop_control"]) == {
            **{k: v * run["issued_pull"] for k, v in dense.items()},
            "packed_update": run["issued_pull"], "loop_control": run["issued"]}
        curve = eng.run_level_curve(s)
        sched = curve["direction_schedule"]
        assert (run["issued_push"], run["issued_pull"]) == (sched["push_supersteps"],
                                                            sched["pull_supersteps"])
        assert curve == cpu.run_level_curve(s)
        want = cpu.run(s)
        for dist, parent in ((want.dist, want.parent), P.canonical_bfs(g, s)):
            np.testing.assert_array_equal(got.dist, dist)
            np.testing.assert_array_equal(got.parent, parent)
        eng.loop = "eager"
        eager = eng.run(s)
        eng.loop = "blocks"
        np.testing.assert_array_equal(got.dist, eager.dist)
        np.testing.assert_array_equal(got.parent, eager.parent)
    assert "push" in sched["schedule"] and "pull" in sched["schedule"]
    before = [b.clone() for b in loop.buffers]
    assert int(before[-1][C.LIVE]) == 0
    for body in loop.bodies.values():
        body.dead_replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(before, loop.buffers))
    times = []
    eng.run(s0, times=times)
    assert [b for b, _ in times] == [int(x == "pull") for x in eng.run_level_curve(s0)[
        "direction_schedule"]["schedule"]] and all(ms > 0 for _, ms in times)
    for st, wst in zip(eng.run_many_device([s0, 9, 100]), cpu.run_many_device([s0, 9, 100])):
        _eq(st.dist, wst.dist)
        _eq(st.parent, wst.parent)
        assert (st.level, st.changed) == (wst.level, wst.changed)
    path = P.RelayEngine(P.path_graph(80), direction=mode, expansion=expansion)
    res = path.run(0)  # the unpacked re-run on the slot (or key) flavor
    np.testing.assert_array_equal(res.dist, np.arange(80, dtype=np.int32))
    assert len(path.run_level_curve(0)["direction_schedule"]["schedule"]) == 80


@pytest.mark.parametrize("packed", [True, False])
def test_card_sparse_body_is_captured_and_replays_without_a_host_sync(card, packed):
    """The sparse superstep makes no host sync (run under the sync debug
    mode that raises on one), is captured into a CUDA graph, and its replay
    equals the CPU's superstep on the same carry, gated live and dead."""
    from bfs_tpu_torch.ops import control as C
    from bfs_tpu_torch.ops import sparse as S

    g, s0 = _hybrid_graph()
    # One arm on both devices: the third array of the sparse operands is the
    # arm's (ranks or slots on gather, original ids on the MXU arm).
    eng = P.RelayEngine(g, direction="push", expansion="gather")
    cpu = P.RelayEngine(g, device="cpu", direction="push", expansion="gather")
    st = cpu.init_packed_state(s0) if packed else cpu.init_state(s0)
    for _ in range(2):  # a frontier two levels out
        st, _ = cpu.step_dispatch(st, take_sparse=True)
    vr, n = eng.relay_graph.vr, 1 if packed else 2
    adj, cadj = eng._sparse_tensors_for(packed), cpu._sparse_tensors_for(packed)
    for live in (1, 0):
        ext = tuple(torch.cat([f, f.new_zeros(1)]).cuda() for f in st[:n])
        fwords = st.fwords.cuda()
        ctl = C.new_ctl(card)
        C.init_ctl(ctl, 62)
        ctl[C.LEVEL], ctl[C.LIVE] = st.level, live
        gst = st._replace(**dict(zip(st._fields[:n], (e[:vr] for e in ext))), fwords=fwords,
                          level=None, changed=None)

        def step():
            new = S.sparse_superstep(gst, adj, vr, ctl=ctl, ext=ext)
            fwords.copy_(new.fwords)
            C.raise_flag(ctl, new.changed)

        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step()  # eager, warm: a sync would raise here
        finally:
            torch.cuda.set_sync_debug_mode("default")
        ext0 = tuple(torch.cat([f, f.new_zeros(1)]).cuda() for f in st[:n])
        for e, e0 in zip(ext, ext0):
            e.copy_(e0)
        fwords.copy_(st.fwords)
        ctl[C.FLAG] = 0
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
        graph.replay()
        torch.cuda.synchronize()
        want = S.sparse_superstep(st, cadj, vr) if live else st
        for a, b in zip((*(e[:vr] for e in ext), fwords), (*want[:n], want.fwords)):
            np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())
        assert int(ctl[C.FLAG]) == int(bool(live) and bool(want.changed))


# ------------------------------------------------------- the device builder --

class _SerialTracks:
    """A stand-in for the builder's worker pool: a submitted track runs
    when its result is asked for, on the asking thread, so the two tracks
    of a build never overlap."""

    def submit(self, fn):
        return types.SimpleNamespace(result=fn)


@pytest.mark.parametrize("tracks", ["overlapped", "serialized"])
@pytest.mark.parametrize("route", ["native", "torch"])
def test_card_device_builder_matches_the_host_builder(card, route, tracks, monkeypatch):
    """``build_relay_graph_device`` on the card at R-MAT s12: byte-identical
    to the host builder with the native route; with the torch route every
    non-mask field, and masks equal to the torch router's on the CPU.  It
    runs under the sync debug mode ``error``: every host sync it makes is
    one of the reasons it names.  The mode is process-wide, so only the
    serialized tracks check each thread's syncs with no window the other
    thread opened."""
    from bfs_tpu_torch.graph import relay_device as RD

    if tracks == "serialized":
        monkeypatch.setattr(RD, "_TRACK_POOL", _SerialTracks())
    g = P.rmat_graph(12, 8, seed=3)
    host = P.build_relay_graph(g)
    times = {}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rg = RD.build_relay_graph_device(g, route=route, stage_times=times)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert times["route"] == route
    assert set(times["host_syncs"]) <= {
        "ingest", "degree histograms", "class tables", "stage timing", "route input",
        "masks to the device", "stage ranges", "finalize"}
    skip = () if route == "native" else p_relay.MASK_FIELDS
    assert p_relay.differing_fields(host, rg, skip=skip) == []
    if route == "torch":
        cpu = RD.build_relay_graph_device(g, device="cpu", route="torch")
        assert p_relay.differing_fields(cpu, rg) == []


# ------------------------------------------------------------ the query server --

def _served_exact(g, source, reply):
    d, p = P.canonical_bfs(g, source)
    np.testing.assert_array_equal(reply.dist, d)
    np.testing.assert_array_equal(reply.parent, p)


@pytest.mark.parametrize("engine", ["pull", "relay"])
def test_card_serve_capped_budget_alternation(card, engine):
    """Two graphs under a budget that holds one engine: every query evicts
    the other graph's engine (its tensors and captured loops) and ships its
    own again, and every reply stays oracle-exact."""
    from bfs_tpu_torch.serve import BfsServer, GraphRegistry

    graphs = {"a": P.rmat_graph(10, 8, seed=3), "b": P.rmat_graph(10, 8, seed=4)}
    reg = GraphRegistry(device_budget_bytes=1)
    with BfsServer(reg, engine=engine, max_batch=4, result_cache_size=0) as srv:
        for name, g in graphs.items():
            srv.register(name, g)
        for i in range(6):
            name = "ab"[i % 2]
            reply = srv.query(name, 3 * i).result(300)
            _served_exact(graphs[name], 3 * i, reply)
            assert reply.record.status == "ok"
            assert reg.resident_keys() == [(name, 0, engine)]
        assert reg.evictions == 5
        assert srv.exe_cache.misses == 2 and srv.exe_cache.hits == 4


def test_card_serve_hung_call_then_exact_replies(card, monkeypatch):
    """``delay:serve.batch`` past the watchdog: the tick degrades to the
    oracle; the abandoned attempt launches nothing once the next attempt
    has begun, and the next replies are exact on the card."""
    from bfs_tpu_torch.serve import BfsServer

    g = P.rmat_graph(10, 8, seed=3)
    with BfsServer(watchdog_s=0.5, watchdog_min_s=0.05, max_batch=4) as srv:
        srv.register("g", g)
        _served_exact(g, 1, srv.query("g", 1).result(300))
        K.reset_launches()
        monkeypatch.setenv("BFS_TPU_TORCH_FAULT", "delay:serve.batch:2.0")
        t0 = time.monotonic()
        reply = srv.query("g", 2).result(300)
        monkeypatch.delenv("BFS_TPU_TORCH_FAULT")
        assert reply.record.status == "oracle" and srv.metrics.count("watchdog_timeouts") == 1
        _served_exact(g, 2, reply)
        for s in (3, 4, 5):
            reply = srv.query("g", s).result(300)
            assert reply.record.status == "ok"
            _served_exact(g, s, reply)
        issued = sum(t["issued"] for t in srv.tick_log()[-3:])
        time.sleep(max(0.0, t0 + 2.5 - time.monotonic()))
        assert srv.metrics.count("abandoned_attempts") == 1
        assert K.LAUNCHES["loop_control"] == issued  # nothing from the zombie
        _served_exact(g, 6, srv.query("g", 6).result(300))


def test_card_serve_cold_capture_while_submitters_run(card):
    """Cold ticks (engine shipped, block loops captured on a watchdog
    thread) while four threads keep submitting, with sampled verification
    on: every reply oracle-exact, and the control kernel launched exactly
    once per superstep the ticks issued."""
    from bfs_tpu_torch.serve import BfsServer

    g = P.rmat_graph(10, 8, seed=3)
    sources = list(range(0, 256, 2))
    K.reset_launches()
    for engine in ("pull", "relay"):
        with BfsServer(engine=engine, max_batch=32, tick_s=0.002, verify_sample=2,
                       result_cache_size=0) as srv:
            srv.register("g", g)
            replies = {}

            def submit(part):
                for s in sources[part::4]:
                    replies[s] = srv.query("g", s)
                    time.sleep(0.001)

            threads = [threading.Thread(target=submit, args=(i,)) for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            for s, f in replies.items():
                reply = f.result(300)
                assert reply.record.status == "ok"
                _served_exact(g, s, reply)
            ticks = srv.tick_log()
            counters = srv.metrics.report()["counters"]
            assert counters.get("oracle_served", 0) == 0
            assert counters["integrity_checks"] >= 1
            assert counters.get("integrity_failures", 0) == 0
        if engine == "pull":
            assert K.LAUNCHES["loop_control"] == sum(t["issued"] for t in ticks)
            K.reset_launches()
    assert K.LAUNCHES["loop_control"] > 0 and K.LAUNCHES["packed_update"] > 0


def test_card_serve_verify_fault_quarantines(card, monkeypatch):
    """``raise:serve.verify`` on the card: the executable is quarantined
    (circuit open, runner dropped), the tick re-runs on the oracle, and the
    canary after the cooldown rebuilds the runner and serves exactly."""
    from bfs_tpu_torch.resilience import faults
    from bfs_tpu_torch.serve import BfsServer

    g = P.rmat_graph(10, 8, seed=3)
    with BfsServer(verify_sample=1, breaker_cooldown_s=0.2, max_batch=4) as srv:
        srv.register("g", g)
        _served_exact(g, 0, srv.query("g", 0).result(300))
        monkeypatch.setenv("BFS_TPU_TORCH_FAULT", "raise:serve.verify")
        faults.reset()
        reply = srv.query("g", 1).result(300)
        monkeypatch.delenv("BFS_TPU_TORCH_FAULT")
        faults.reset()
        assert reply.record.status == "oracle"
        _served_exact(g, 1, reply)
        assert srv.metrics.count("integrity_failures") == 1
        assert srv.metrics.count("breaker_opened") == 1 and len(srv.exe_cache) == 0
        time.sleep(0.25)
        reply = srv.query("g", 2).result(300)
        assert reply.record.status == "ok" and reply.record.compile_hit is False
        _served_exact(g, 2, reply)
        assert srv.metrics.count("breaker_closed") == 1


# ------------------------------------------------------ superstep checkpoints --

def _ckpt(path, every, **config):
    from bfs_tpu_torch.resilience.superstep_ckpt import CkptConfig, SuperstepCheckpointer

    return SuperstepCheckpointer(path, config, cfg=CkptConfig("every", every))


@pytest.mark.parametrize("expansion", ["gather", "mxu"])
@pytest.mark.parametrize("hybrid", [False, True])
def test_card_segmented_relay_matches_fused_with_one_capture_per_loop(card, tmp_path, monkeypatch,
                                                                      hybrid, expansion):
    """``run_segmented`` on the card at segments of 1, 2 and 3 equals the
    fused run and the CPU's (result, schedule, occupancy); the segments
    replay the loops the fused runs captured and capture none; a run killed
    at boundary 2 resumes bit for bit, also without a capture."""
    from bfs_tpu_torch.models import loop as L
    from bfs_tpu_torch.resilience import faults
    from bfs_tpu_torch.resilience.faults import FaultInjected

    g = P.rmat_graph(10, 8, seed=3)
    eng = P.RelayEngine(g, device=card, sparse_hybrid=hybrid, expansion=expansion)
    cpu = P.RelayEngine(g, device="cpu", sparse_hybrid=hybrid, expansion=expansion)
    for s in (0, 743):  # 6 and 4 levels: every boundary of a kill at 2 is inside the search
        want, want_curve = cpu.run(s), cpu.run_level_curve(s)
        fused, curve = eng.run(s), eng.run_level_curve(s)
        assert curve == want_curve
        caps = L.captures()
        for k in (1, 2, 3):
            res, got_curve = eng.run_segmented(s, ckpt=_ckpt(tmp_path, k, s=s, k=k), telemetry=True)
            for a in (res, fused):
                np.testing.assert_array_equal(a.dist, want.dist)
                np.testing.assert_array_equal(a.parent, want.parent)
                assert a.num_levels == want.num_levels
            assert got_curve["direction_schedule"] == want_curve["direction_schedule"]
            assert got_curve["occupancy"] == want_curve["occupancy"]
            _same_result(eng.run_segmented(s, ckpt=_ckpt(tmp_path, k, s=s, k=k, t=0)), want)
        monkeypatch.setenv("BFS_TPU_TORCH_FAULT", "raise:superstep:2")
        faults.reset()
        with pytest.raises(FaultInjected):
            eng.run_segmented(s, ckpt=_ckpt(tmp_path, 1, s=s, kill=1), telemetry=True)
        monkeypatch.delenv("BFS_TPU_TORCH_FAULT")
        faults.reset()
        mgr = _ckpt(tmp_path, 1, s=s, kill=1)
        res, got_curve = eng.run_segmented(s, ckpt=mgr, telemetry=True)
        assert mgr.report()["resumed_from_epoch"] == 2
        _same_result(res, want)
        assert got_curve["direction_schedule"] == want_curve["direction_schedule"]
        assert L.captures() == caps


def _same_result(a, b) -> None:
    np.testing.assert_array_equal(a.dist, b.dist)
    np.testing.assert_array_equal(a.parent, b.parent)
    assert a.num_levels == b.num_levels


@pytest.mark.parametrize("engine", ["push", "pull"])
def test_card_segmented_multi_and_serve_runner_match_fused(card, tmp_path, monkeypatch, engine):
    """``run_multi_segmented`` and a ``SegmentedBatchRunner`` on the card
    equal the fused batch and the CPU's; the segments capture nothing."""
    from bfs_tpu_torch.models import loop as L
    from bfs_tpu_torch.resilience.superstep_ckpt import run_multi_segmented
    from bfs_tpu_torch.serve import GraphRegistry, SegmentedBatchRunner, build_batch_runner

    g = P.rmat_graph(10, 8, seed=3)
    sources = np.asarray([0, 5, 9, 743], np.int32)
    want = P.bfs_multi(g, sources, engine=engine, device="cpu")
    eng = P.EdgeEngine(g, engine=engine, device=card)
    _same_result(eng.run_multi(sources), want)
    caps = L.captures()
    for k in (1, 3):
        _same_result(run_multi_segmented(eng, sources, ckpt=_ckpt(tmp_path, k, k=k), engine=engine),
                     want)
        assert eng.last_run["live"] == want.num_levels
    assert L.captures() == caps
    reg = GraphRegistry()
    reg.register("g", g)
    fused = build_batch_runner(reg, "g", engine, 4)
    _same_result(fused(sources), want)
    monkeypatch.setenv("BFS_TPU_TORCH_CKPT", "every:2")
    runner = build_batch_runner(reg, "g", engine, 4)
    assert isinstance(runner, SegmentedBatchRunner)
    caps = L.captures()
    _same_result(runner(sources), want)
    assert L.captures() == caps and runner.ckpt_progress() is None


def _same_sssp(a, b) -> None:
    np.testing.assert_array_equal(a.dist, b.dist)
    np.testing.assert_array_equal(a.parent, b.parent)
    assert (a.rounds, a.packed, a.truncated_fallbacks) == (b.rounds, b.packed, b.truncated_fallbacks)


@pytest.mark.parametrize("packed", [False, True])
def test_card_sssp_matches_the_cpu_and_replays_its_capture(card, packed):
    """SSSP on the card (captured loop, then eager) equals the CPU's plain
    run and the oracle; a second run of the same loop captures nothing and
    launches the control step once per superstep issued."""
    from bfs_tpu_torch.algo import edge_weights_np, sssp
    from bfs_tpu_torch.models import loop as L
    from bfs_tpu_torch.oracle import dijkstra

    g = P.rmat_graph(10, 8, seed=3)
    want = sssp(g, 5, max_weight=31, packed=packed, device="cpu")
    odist, opar = dijkstra(g, edge_weights_np(g.src, g.dst, 31), 5)
    np.testing.assert_array_equal(want.dist, odist)
    np.testing.assert_array_equal(want.parent, opar)
    eng = P.EdgeEngine(g, engine="push", device=card)
    _same_sssp(sssp(eng, 5, max_weight=31, packed=packed), want)
    caps = L.captures()
    K.reset_launches()
    got = sssp(eng, 5, max_weight=31, packed=packed)
    _same_sssp(got, want)
    assert L.captures() == caps
    assert K.LAUNCHES["loop_control"] == got.run["issued"] and got.run["live"] == got.rounds
    eng.loop = "eager"
    _same_sssp(sssp(eng, 5, max_weight=31, packed=packed), want)
    # path_graph(600) at weight 255: the packed clamp fires on the card too.
    path = P.path_graph(600)
    _same_sssp(sssp(path, 0, packed=True, device=card), sssp(path, 0, packed=True, device="cpu"))


def test_card_cc_and_segments_match_the_cpu(card, tmp_path):
    """CC push and pull, and segmented SSSP and CC, on the card equal the
    CPU's runs; segments capture nothing; the device checks are clean."""
    from bfs_tpu_torch.algo import cc, cc_segmented, sssp, sssp_segmented
    from bfs_tpu_torch.models import loop as L
    from bfs_tpu_torch.oracle import cc_device_check, sssp_device_check

    g = P.gnm_graph(3000, 4000, seed=7)
    want = cc(g, device="cpu")
    for engine in ("push", "pull"):
        eng = P.EdgeEngine(g, engine=engine, device=card)
        for _ in range(2):
            got = cc(eng)
            np.testing.assert_array_equal(got.label, want.label)
            assert got.rounds == want.rounds
    push = P.EdgeEngine(g, engine="push", device=card)
    fused = cc(push)
    s_fused = sssp(push, 3, packed=False)
    _same_sssp(s_fused, sssp(g, 3, packed=False, device="cpu"))
    caps = L.captures()
    for k in (1, 3):
        seg = cc_segmented(push, ckpt=_ckpt(tmp_path, k, run=f"cc{k}"))
        np.testing.assert_array_equal(seg.label, fused.label)
        assert seg.rounds == fused.rounds
        _same_sssp(sssp_segmented(push, 3, ckpt=_ckpt(tmp_path, k, run=f"sssp{k}"), packed=False),
                   s_fused)
    assert L.captures() == caps
    assert cc_device_check(push.src, push.dst, fused.label, g.num_vertices) == {}
    assert sssp_device_check(push.src, push.dst, s_fused.dist, s_fused.parent, 3,
                             g.num_vertices, 255) == {}
    bad = s_fused.dist.copy()
    bad[3] = 1
    assert sssp_device_check(push.src, push.dst, bad, s_fused.parent, 3, g.num_vertices, 255)


def test_card_registry_algorithms_replay_on_the_resident_engine(card):
    """``registry_sssp``/``registry_cc`` on the card equal the CPU's; the
    second call of each captures nothing."""
    from bfs_tpu_torch.algo import cc, sssp
    from bfs_tpu_torch.models import loop as L
    from bfs_tpu_torch.serve import GraphRegistry, registry_cc, registry_sssp

    g = P.gnm_graph(300, 2100, seed=5)
    reg = GraphRegistry()
    reg.register("g", g)
    s_want, c_want = sssp(g, 3, device="cpu"), cc(g, device="cpu")
    for call, check in ((lambda: registry_sssp(reg, "g", 3), lambda r: _same_sssp(r, s_want)),
                        (lambda: registry_cc(reg, "g", engine="pull"),
                         lambda r: np.testing.assert_array_equal(r.label, c_want.label))):
        check(call())
        caps = L.captures()
        check(call())
        assert L.captures() == caps
    assert reg.get("g").pins == 0


# ------------------------------------------------- the streamed MXU arm --

def test_card_mxu_expand_superblock_out_matches_plain(card):
    """K6 on each superblock slab of a card-built layout, through ``out=``
    (a view of one candidate grid, cleared once), equals the plain
    per-superblock expansion on the same inputs; the pad tiles
    (``col_local = 128``) are dropped and nothing outside the view is
    written."""
    from bfs_tpu_torch.stream import HostTileStore, SuperblockCache

    g = P.gnm_graph(1 << 15, 1 << 17, seed=11)
    rg = P.build_relay_graph(g)
    at = PT.build_adj_tiles_from_relay(rg, device=card)
    store = HostTileStore(at, pin=True)
    assert store.pinned and store.num_superblocks >= 3
    cache = SuperblockCache(store, budget_bytes=1 << 30)
    keys2d = at.keys2d
    rows, rtp, vtp = at.rows, at.rtp, at.vtp
    rng = np.random.default_rng(2)
    for fr in (0.01, 0.3, 1.0):
        fw = _frontier(rng, rows, fr, card)[: rows // 32]
        grid = torch.full((vtp,), -1, dtype=torch.int32, device=card)
        want = torch.full((vtp,), -1, dtype=torch.int32, device=card)
        K.reset_launches()
        for sb in range(store.num_superblocks):
            slab = cache.get(sb)
            slab.wait()
            got = K.expand_frontier_mxu(fw, (*slab, keys2d), rows=rows, cols=PT.SB_VERTS, rtp=rtp,
                                        vtp=PT.SB_VERTS,
                                        out=grid[sb * PT.SB_VERTS : (sb + 1) * PT.SB_VERTS])
            assert got.data_ptr() == grid[sb * PT.SB_VERTS :].data_ptr()
            RM.expand_superblock_plain(fw, slab, keys2d, sb, want, rows=rows, rtp=rtp)
        torch.cuda.synchronize()
        assert K.LAUNCHES["mxu_expand"] == store.num_superblocks
        _eq(grid, want)
        whole = RM.expand_frontier_mxu_plain(fw, RM.mxu_device_operands(at, card), rows=rows,
                                             cols=at.cols, rtp=rtp, vtp=vtp)
        _eq(grid[: at.cols], whole)
    # one superblock alone leaves every other row of the grid untouched
    grid = torch.full((vtp,), -1, dtype=torch.int32, device=card)
    slab = cache.get(1)
    slab.wait()
    K.expand_frontier_mxu(torch.full((rows // 32,), -1, dtype=torch.int32, device=card),
                          (*slab, keys2d), rows=rows, cols=PT.SB_VERTS, rtp=rtp, vtp=PT.SB_VERTS,
                          out=grid[PT.SB_VERTS : 2 * PT.SB_VERTS])
    torch.cuda.synchronize()
    assert bool((grid[: PT.SB_VERTS] == -1).all()) and bool((grid[2 * PT.SB_VERTS :] == -1).all())
    assert not bool((grid[PT.SB_VERTS : 2 * PT.SB_VERTS] == -1).all())
    with pytest.raises(ValueError, match="out"):
        K.expand_frontier_mxu(fw, (*slab, keys2d), rows=rows, cols=PT.SB_VERTS, rtp=rtp,
                              vtp=PT.SB_VERTS, out=grid[:100])


def test_card_streamed_run_matches_resident_and_cpu(card):
    """A streamed engine on the card (auto schedule) equals the resident MXU
    engine on the card, the CPU's streamed engine (results, schedule and
    every ledger row) and the oracle; its tiles never sit on the card and
    ``mxu_expand`` launches once per demanded superblock."""
    g = P.gnm_graph(1 << 15, 1 << 17, seed=11)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    eng = P.RelayEngine(g, device=card, expansion="mxu", direction="auto", tiles_mode="stream")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    assert eng.adj_tiles is None and eng.stream_store.pinned
    assert held < eng.tiles_nbytes  # the tiles (134 MB of slabs) live on the host
    resident = P.RelayEngine(eng.relay_graph, device=card, expansion="mxu", direction="auto")
    cpu = P.RelayEngine(eng.relay_graph, device="cpu", expansion="mxu", direction="auto",
                        tiles_mode="stream")
    budget = max(eng.stream_store.sb_bytes(s) for s in range(eng.stream_store.num_superblocks))
    for s in (3, 9000):
        K.reset_launches()
        got, curve = eng.run_streamed(s, telemetry=True, cache_budget_bytes=budget)
        launches = dict(K.LAUNCHES)
        rows = eng.stream_report["levels"]
        pulls = [r for r in rows if r["arm"] == "pull"]
        assert pulls and launches["mxu_expand"] == sum(r["demanded"] for r in pulls)
        assert launches["packed_update"] == len(pulls) and launches["loop_control"] == 0
        want, want_curve = cpu.run_streamed(s, telemetry=True, cache_budget_bytes=budget)
        assert eng.stream_report == cpu.stream_report
        assert curve["direction_schedule"] == want_curve["direction_schedule"]
        for other in (want, resident.run(s)):
            _same_result(got, other)
        dist, parent = P.canonical_bfs(g, s)
        np.testing.assert_array_equal(got.dist, dist)
        np.testing.assert_array_equal(got.parent, parent)


def test_card_streamed_one_slab_budget_evicts_under_inflight_uploads(card):
    """A cache of one slab on an all-pull search over eight superblocks:
    every level evicts every slab while the next one's upload runs under
    the current one's ``mxu_expand`` (the lookahead), so a slab's memory
    handed to the next upload before its expansion retired would corrupt
    the candidates.  Results equal the resident run's and the oracle's,
    over repeated runs."""
    g = P.rmat_graph(17, 8, seed=3)
    eng = P.RelayEngine(g, device=card, expansion="mxu", direction="pull", tiles_mode="stream")
    store = eng.stream_store
    assert store.num_superblocks >= 8
    budget = max(store.sb_bytes(s) for s in range(store.num_superblocks))
    resident = P.RelayEngine(eng.relay_graph, device=card, expansion="mxu", direction="pull")
    root = int(np.argmax(np.bincount(g.src, minlength=g.num_vertices)))
    want = resident.run(root)
    dist, parent = P.canonical_bfs(g, root)
    np.testing.assert_array_equal(want.dist, dist)
    for _ in range(3):
        got = eng.run_streamed(root, cache_budget_bytes=budget)
        _same_result(got, want)
        rows = eng.stream_report["levels"]
        assert all(r["arm"] == "pull" for r in rows)
        assert sum(r["evictions"] for r in rows) >= sum(r["demanded"] for r in rows) - len(rows)
        assert max(r["demanded"] for r in rows) >= 4
    np.testing.assert_array_equal(got.parent, parent)


def test_card_label_lookup_matches_the_host_evaluation(card):
    """``label_bounds`` on the card (int16 rows holding the uint16 bits)
    against ``host_label_bounds``, element for element: an index swept on
    the card and a synthetic one of small labels, where most pairs tie
    between landmarks (``best_k`` must be the first minimum, as numpy's
    ``argmin``), with unreachable sentinels and ``u == v`` pairs."""
    from bfs_tpu_torch.serve import labels as PL

    g = P.rmat_graph(10, 8, seed=3)
    swept = PL.build_label_index(g, 32, device=card)
    on_cpu = PL.build_label_index(g, 32, device="cpu")
    for f in ("landmarks", "dist", "parent"):
        np.testing.assert_array_equal(getattr(swept, f), getattr(on_cpu, f))
    rng = np.random.default_rng(7)
    dist = rng.integers(0, 4, size=(64, 5000)).astype(np.uint16)
    dist[rng.random(dist.shape) < 0.05] = PL.LABEL_INF
    dist[:, :50] = PL.LABEL_INF  # 50 vertices no landmark reaches
    ties = PL.LabelIndex(np.arange(64, dtype=np.int32), dist,
                         np.zeros(dist.shape, dtype=np.int32), 5000)
    for idx in (swept, ties):
        oracle = PL.LabelOracle(idx, device=card)
        assert oracle._dist_dev.dtype == torch.int16 and oracle._dist_dev.is_cuda
        assert oracle._dist_dev.untyped_storage().nbytes() == idx.device_bytes
        n = idx.num_vertices
        u = rng.integers(0, n, 8192).astype(np.int32)
        v = rng.integers(0, n, 8192).astype(np.int32)
        v[:64] = u[:64]
        got = oracle.bounds(u, v)
        want = PL.host_label_bounds(idx.dist, u, v)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        cpu = PL.LabelOracle(idx, device="cpu").bounds(u, v)
        for a, b in zip(got, cpu):
            np.testing.assert_array_equal(a, b)


def test_card_label_server_and_fleet(card, tmp_path, monkeypatch):
    """A label server on the card (the sweep on the registry's pull engine,
    lookups on the card's lock) while four threads keep pull ticks running:
    every point query equal to the oracle, the method the certificate's,
    the build clean and counted; then a fleet of two over one store, both
    replicas warm-hitting the sidecar, replica 1 closed: failover, every
    answer exact."""
    from bfs_tpu_torch.serve import BfsServer, FleetRouter, GraphRegistry
    from bfs_tpu_torch.serve import labels as PL

    g = P.rmat_graph(10, 8, seed=3)
    monkeypatch.setenv("BFS_TPU_TORCH_LABELS", "16")
    truth = {}

    def dist_of(u):
        if u not in truth:
            truth[u] = P.canonical_bfs(g, u)[0]
        return truth[u]

    rng = np.random.default_rng(3)
    pairs = rng.integers(0, g.num_vertices, size=(300, 2)).tolist()
    cache = P.LayoutCache(str(tmp_path))
    with BfsServer(GraphRegistry(layout_cache=cache), max_batch=32, result_cache_size=0) as srv:
        srv.register("g", g)
        c = srv.metrics.report()["counters"]
        assert c["label_builds"] == 1 and c["label_build_cache_misses"] == 1
        assert "label_build_errors" not in c and "label_budget_rejects" not in c
        idx = srv._label_oracle("g", 0).index
        stop = threading.Event()
        ticks = []

        def traffic(part):
            s = part
            while not stop.is_set():
                ticks.append((s, srv.query("g", s)))
                s = (s + 4) % g.num_vertices
                time.sleep(0.002)

        threads = [threading.Thread(target=traffic, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        try:
            replies = [srv.query_dist("g", u, v).result(300) for u, v in pairs]
        finally:
            stop.set()
            for t in threads:
                t.join()
        _, tight, best_k, _, _ = PL.host_label_bounds(idx.dist, *np.asarray(pairs).T)
        for (u, v), r, t, k in zip(pairs, replies, tight, best_k):
            assert r.dist == int(dist_of(u)[v])
            assert r.method == ("labels" if t else "exact")
            assert r.landmark == (int(idx.landmarks[k]) if t else None)
        for s, f in ticks[:64]:
            _served_exact(g, s, f.result(300))
        c = srv.metrics.report()["counters"]
        assert c["label_hits"] == int(tight.sum()) and c.get("label_fallbacks", 0) == int((~tight).sum())
    with FleetRouter(replicas=2, layout_cache=cache, max_batch=32) as rt:
        rt.register("g", g)
        for srv in rt.servers:
            c = srv.metrics.report()["counters"]
            assert (c["label_builds"], c["label_build_cache_hits"]) == (1, 1)
        rt.servers[1].close()
        for s in range(0, 64, 2):
            _served_exact(g, s, rt.query("g", s).result(300))
        for u, v in pairs[:32]:
            assert rt.query_dist("g", u, v).result(300).dist == int(dist_of(u)[v])
        assert rt.report()["router"]["router_failovers"] >= 1


def test_card_packed_cap_latch(card):
    """``path_graph(600)`` through a pull batch runner on the card: the
    first tick runs packed, is cut at 62 levels and runs unpacked, which
    latches the runner; the second tick runs the unpacked loop once, its
    control kernel launched once per superstep, with the same rows."""
    from bfs_tpu_torch.serve import GraphRegistry, build_batch_runner

    g = P.path_graph(600)
    reg = GraphRegistry(device=card)
    reg.register("g", g)
    runner = build_batch_runner(reg, "g", "pull", 2)
    sources = np.asarray([0, 599], dtype=np.int32)
    first = runner(sources)
    assert runner.last_run["unpacked_rerun"] and not runner.use_packed
    K.reset_launches()
    second = runner(sources)
    assert not runner.last_run["unpacked_rerun"]
    assert runner.last_run["issued"] == 600 and K.LAUNCHES["loop_control"] == 600
    for res in (first, second):
        for i, s in enumerate(sources.tolist()):
            d, p = P.canonical_bfs(g, s)
            np.testing.assert_array_equal(res.dist[i], d)
            np.testing.assert_array_equal(res.parent[i], p)


# ---------------------------------------------- the lock-step batch (trees) --

def _batched_case(kernel: str, trees: int, card, layout):
    """``(call, outs)`` for one batched kernel on ``trees`` trees of random
    inputs: ``call(batch, ctl)`` runs the wrapper on ``[trees, n]``
    operands (``batch`` False: tree by tree, a 1-D launch each) into the
    returned output tensors; ``outs`` names the plain version's result in
    the same order."""
    rg = layout
    rng = np.random.default_rng(trees)
    if kernel in ("benes_local_pass", "benes_outer_pass"):
        table, n = rg.net_table, rg.net_size
        pre, local, _, tile = K.split_passes(table, n, 64)  # outer stages at this size
        x = _t(_words(rng, trees * n // 32).reshape(trees, n // 32), card)
        masks = _t(rg.net_masks, card)
        if kernel == "benes_local_pass":
            stages = tuple(table[i] for i in local)

            def launch(words, out, ctl):
                return K.benes_local_pass(words, masks, stages, n, tile, out=out, ctl=ctl)
        else:
            stages = tuple(table[i] for i in K.outer_plan(table, pre, n)[0].stages)

            def launch(words, out, ctl):
                return K.benes_outer_pass(words, masks, stages, n, out=out, ctl=ctl)
        want = (R.apply_benes_std(x, masks, stages, n),)
        outs = (torch.empty_like(x),)
        inputs = (x,)
    elif kernel == "class_rowmin":
        l1 = _t(_words(rng, trees * rg.net_size // 32).reshape(trees, -1), card)
        valid = _t(valid_slot_words(rg.src_l1, rg.net_size), card)
        want = (R.rowmin_ranks(l1, valid, rg.in_classes, rg.vr),)
        outs = (torch.empty((trees, rg.vr), dtype=torch.int32, device=card),)
        inputs = (l1,)

        def launch(words, out, ctl):
            return K.rowmin_ranks(words, valid, rg.in_classes, rg.vr, out=out, ctl=ctl)
    elif kernel == "packed_update":
        vr = rg.vr
        lv = rng.integers(0, 6, (trees, vr)).astype(np.uint32)
        packed = (lv << np.uint32(26)) | rng.integers(0, 1 << 10, (trees, vr)).astype(np.uint32)
        packed[rng.random((trees, vr)) < 0.5] = 0xFFFFFFFF
        cand = rng.integers(0, 1 << 10, (trees, vr)).astype(np.uint32)
        cand[rng.random((trees, vr)) < 0.7] = 0xFFFFFFFF
        packed, cand = _t(packed, card), _t(cand, card)
        new = R.apply_relay_candidates_packed(R.PackedRelayState(packed, None, 5, None), cand)
        want = (new.packed, new.fwords)
        outs = (packed.clone(), torch.empty((trees, vr // 32), dtype=torch.int32, device=card))
        inputs = (cand,)

        def launch(c, out, ctl, fw=None):
            raise AssertionError("packed_update launches through call()")
    else:  # mxu_expand
        rows = cols = 20000
        src = rng.integers(0, rows, 400000)
        dst = rng.integers(0, cols, 400000)
        _, ops, kw = _tiles_on(card, src, dst, rows, cols, rng.permutation(rows))
        fw = torch.stack([_frontier(rng, rows, fr, card) for fr in
                          np.linspace(0.05, 0.9, trees)])
        want = (RM.expand_frontier_mxu_plain(fw, ops, **kw),)
        outs = (torch.full((trees, kw["vtp"]), -1, dtype=torch.int32, device=card),)
        inputs = (fw,)

        def launch(words, out, ctl):
            return K.expand_frontier_mxu(words, ops, out=out, ctl=ctl, **kw)

    def call(batch: bool, ctl=None):
        if kernel == "packed_update":
            pk, fwo = outs
            if batch:
                st = R.PackedRelayState(pk, fwo, 5 if ctl is None else None, None)
                got = K.apply_relay_candidates_packed(st, inputs[0], fwords_out=fwo, ctl=ctl)
                return got.packed, got.fwords, got.changed
            flags = []
            for i in range(trees):
                st = R.PackedRelayState(pk[i], fwo[i], 5, None)
                flags.append(K.apply_relay_candidates_packed(st, inputs[0][i],
                                                             fwords_out=fwo[i]).changed)
            return pk, fwo, torch.stack(flags).any()
        if batch:
            got = launch(inputs[0], outs[0], ctl)
            return (got,)
        return (torch.stack([launch(inputs[0][i], outs[0][i], None) for i in range(trees)]),)

    return call, outs, want


@pytest.mark.parametrize("kernel,trees", [
    *((k, t) for k in ("benes_local_pass", "benes_outer_pass", "class_rowmin", "packed_update",
                       "mxu_expand") for t in (1, 3, 16)),
    # The batch kernels of the Beneš passes and the row-min take trees in
    # groups (at most 16 trees a block of the local pass on this layout's
    # tiles, 8 of the outer pass and the row-min): counts that are not a
    # multiple of a group, and more groups than one.
    *((k, t) for k in ("benes_local_pass", "benes_outer_pass", "class_rowmin")
      for t in (2, 5, 17, 64)),
])
def test_card_batched_kernel_matches_plain_and_single_launches(card, layout, kernel, trees):
    """Each kernel of the lock-step superstep on ``[S, n]`` operands: bit
    for bit its plain batched version and S single-tree launches; ONE
    launch per call whatever S is; gated by a live control block the same
    words, and by a dead one nothing written."""
    from bfs_tpu_torch.ops import control as C

    call, outs, want = _batched_case(kernel, trees, card, layout)
    if kernel == "packed_update":
        start = outs[0].clone()
    K.reset_launches()
    got = call(True)
    assert _counts([kernel]) == {kernel: 1}
    for a, b in zip(got, want):
        _eq(a[..., : b.shape[-1]], b)
    if kernel == "packed_update":
        new_packed, new_fwords = got[0].clone(), got[1].clone()
        assert bool(got[2].item()) == bool((new_packed != start).any())
        outs[0].copy_(start)
    else:
        batch_out = got[0].clone()
        if kernel == "mxu_expand":
            outs[0].fill_(-1)
    single = call(False)
    if kernel == "packed_update":
        _eq(single[0], new_packed)
        _eq(single[1], new_fwords)
        outs[0].copy_(start)
    else:
        _eq(single[0][..., : batch_out.shape[-1]], batch_out)
    live = C.new_ctl(card)
    C.init_ctl(live, 62)
    live[C.LEVEL] = 5  # stamps level 6, as the ungated launch at state level 5
    if kernel == "mxu_expand":
        outs[0].fill_(-1)
    got = call(True, live)
    for a, b in zip(got, want):
        _eq(a[..., : b.shape[-1]], b)
    if kernel == "packed_update":
        assert int(live[C.FLAG]) == int(bool((new_packed != start).any()))
        outs[0].copy_(start)
    dead = C.new_ctl(card)
    C.init_ctl(dead, 62)
    dead[C.LEVEL], dead[C.CHANGED], dead[C.LIVE] = 3, 0, 0
    before = [o.clone() for o in outs]
    for o in outs[int(kernel == "packed_update"):]:
        o.fill_(7)
    sentinel = [o.clone() for o in outs]
    call(True, dead)
    torch.cuda.synchronize()
    for o, s in zip(outs, sentinel):
        assert torch.equal(o, s)
    if kernel == "packed_update":
        assert torch.equal(outs[0], before[0]) and int(dead[C.FLAG]) == 0


@pytest.mark.parametrize("trees,tile,group", [
    (5, 1 << 14, 1), (7, 1 << 13, 4), (9, 1 << 13, 3), (17, 1 << 12, 9), (16, 1 << 11, 16),
    (33, 64, 11),
])
def test_card_local_pass_groups(card, trees, tile, group):
    """``benes_local_pass`` on ``[S, n/32]`` words of a random 2^19-element
    network at tiles whose groups differ: the launcher's trees a block (at
    most 16, as many 4-byte-word tiles as leave room for two ring slots,
    the trees split evenly), then bit for bit the plain batched version,
    one launch, in place too, and with a dead control block nothing
    written."""
    from bfs_tpu_torch.ops import control as C
    from bfs_tpu_torch.tools.benes_pass_sweep import network

    gen = torch.Generator(device=card).manual_seed(trees)
    table, masks, n = network(19, gen)
    _, local, _, t = K.split_passes(table, n, tile)
    assert t == tile
    stages = tuple(table[i] for i in local)
    assert K.batch_groups(trees, tile)[0] == group
    x = torch.randint(-(2**31), 2**31, (trees, n // 32), dtype=torch.int32, device=card,
                      generator=gen)
    want = R.apply_benes_std(x, masks, stages, n)
    lib = K.kernels()
    out = torch.empty_like(x)
    K.reset_launches()
    _eq(K.launch_local_pass(lib, x, masks, stages, n, tile, out), want)
    assert _counts(["benes_local_pass"]) == {"benes_local_pass": 1}
    y = x.clone()  # in place
    _eq(K.launch_local_pass(lib, y, masks, stages, n, tile, y), want)
    dead = C.new_ctl(card)
    C.init_ctl(dead, 62)
    dead[C.LEVEL], dead[C.CHANGED], dead[C.LIVE] = 3, 0, 0
    out.fill_(7)
    K.launch_local_pass(lib, x, masks, stages, n, tile, out, dead)
    torch.cuda.synchronize()
    assert bool((out == 7).all())


@pytest.mark.parametrize("expansion", ["gather", "mxu"])
def test_card_run_multi_device_matches_cpu_and_eager(card, expansion):
    """``run_multi_device`` on the card against the CPU engine's state, bit
    for bit, at S = 4 and 16, packed and unpacked; the captured loop against
    the eager loop; launches = the single search's per-superstep count x
    supersteps issued whatever S is; every tree of ``run_multi`` equals
    ``run``; ``path_graph(100)`` through the unpacked re-run."""
    g = P.rmat_graph(12, 6, seed=1)
    eng = P.RelayEngine(g, expansion=expansion, sparse_hybrid=False)
    cpu = P.RelayEngine(g, device="cpu", expansion=expansion, sparse_hybrid=False)
    per_step = dict(PER_STEP[expansion])
    if expansion == "gather":  # at the batch's tile
        rg = eng.relay_graph
        per_step["benes_outer_pass"] = sum(
            len(K.outer_plan(tb, side, n))
            for tb, n in ((rg.vperm_table, rg.vperm_size), (rg.net_table, rg.net_size))
            for side in K.split_passes(tb, n, K.batch_tile_words(n))[0:3:2])
    rng = np.random.default_rng(5)
    for trees in (4, 16):
        sources = rng.integers(0, g.num_vertices, trees).astype(np.int32)
        for packed in (True, False):
            eng.run_multi_device(sources, packed=packed)  # the capture of this size
            K.reset_launches()
            got = eng.run_multi_device(sources, packed=packed)
            run = dict(eng.last_run)
            # The unpacked carry merges with torch ops, as a single search's does.
            want_step = {n: c * (packed or n != "packed_update") for n, c in per_step.items()}
            assert _counts(want_step) == {n: c * run["issued"] for n, c in want_step.items()}
            assert run["live"] == got.level and run["host_reads"] == run["replays"]
            want = cpu.run_multi_device(sources, packed=packed)
            eng.loop = "eager"
            eager = eng.run_multi_device(sources, packed=packed)
            eng.loop = "blocks"
            for other in (want, eager):
                for a, b in zip(got[:3], other[:3]):
                    _eq(a, b)
                assert (got.level, got.changed) == (other.level, other.changed)
        res = eng.run_multi(sources)
        for i, s in enumerate(sources.tolist()):
            one = eng.run(s)
            np.testing.assert_array_equal(res.dist[i], one.dist)
            np.testing.assert_array_equal(res.parent[i], one.parent)
    path = P.path_graph(100)
    peng = P.RelayEngine(path, expansion=expansion, sparse_hybrid=False)
    sources = np.array([0, 50, 99], dtype=np.int32)
    res = peng.run_multi(sources)
    assert peng.last_run["unpacked_rerun"] and res.num_levels == 100
    for i, s in enumerate(sources.tolist()):
        d, p = P.canonical_bfs(path, s)
        np.testing.assert_array_equal(res.dist[i], d)
        np.testing.assert_array_equal(res.parent[i], p)


# ------------------------------------------- the measured arm selection --

def test_card_default_engine_probes_both_arms(card, tmp_path, monkeypatch):
    """``expansion="auto"`` (the default) on the card: the tiles counted and
    built, both arms timed on live kernels with their launches accounted
    for, the faster selected; a second engine on the layout reads the
    verdict back and launches nothing; searches equal the CPU engine's."""
    monkeypatch.setenv("BFS_TPU_TORCH_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("BFS_TPU_TORCH_EXPANSION", raising=False)
    g = P.rmat_graph(10, 32, seed=5)
    rg = P.build_relay_graph(g)
    before = dict(K.LAUNCHES)
    eng = P.RelayEngine(rg)
    launched = {k: n - before[k] for k, n in K.LAUNCHES.items() if n != before[k]}
    probe, rec = eng.phase_probe, eng.expansion_probe
    assert probe["memo"] == "miss" and probe["control_block"] == "live"
    assert probe["device"] == torch.cuda.get_device_name(0) and probe["applier"] == "kernel"
    assert rec["selection_basis"] == "measured" and rec["selected"] == eng.expansion
    assert rec["gather_seconds"] > 0 and rec["mxu_seconds"] > 0
    assert eng.expansion_basis.startswith(f"auto -> {eng.expansion}: measured")
    assert (eng.mxu_operands is not None) == (eng.expansion == "mxu")
    for phase in ("rowmin", "state_update"):
        assert probe[phase]["selected"] == "kernel"
        assert probe[phase]["kernel_seconds"] > 0 and probe[phase]["plain_seconds"] > 0
    want = {}
    for body in probe["bodies"].values():
        for k, n in body["per_step"].items():
            want[k] = want.get(k, 0) + n * body["steps"]
    assert launched == want == probe["launches"]
    for k in ("benes_local_pass", "class_rowmin", "packed_update", "mxu_expand"):
        assert launched[k] > 0, k
    before = dict(K.LAUNCHES)
    again = P.RelayEngine(rg)
    assert again.phase_probe["memo"] == "hit" and again.expansion == eng.expansion
    assert dict(K.LAUNCHES) == before
    cpu = P.RelayEngine(rg, device="cpu")
    for root in (0, 9, 300):
        a, b = eng.run(root), cpu.run(root)
        np.testing.assert_array_equal(a.dist, b.dist)
        np.testing.assert_array_equal(a.parent, b.parent)


def test_card_failing_mxu_arm_fails_the_engine(card, tmp_path, monkeypatch):
    """On the card the probe catches nothing: an MXU arm that raises fails
    the default engine, and no verdict is memoized."""
    from bfs_tpu_torch import profiling as PP

    monkeypatch.setenv("BFS_TPU_TORCH_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("BFS_TPU_TORCH_EXPANSION", raising=False)
    real = PP._dense_arm

    def failing(eng, arm, timer, ctl):
        if arm == "mxu":
            raise RuntimeError("mxu arm fault")
        return real(eng, arm, timer, ctl)

    monkeypatch.setattr(PP, "_dense_arm", failing)
    with pytest.raises(RuntimeError, match="mxu arm fault"):
        P.RelayEngine(P.rmat_graph(10, 32, seed=5))
    assert not os.path.isdir(os.path.join(str(tmp_path), "layout", "probe"))


@pytest.mark.parametrize("expansion", ["gather", "mxu"])
def test_card_phase_ledger(card, expansion):
    from bfs_tpu_torch import profiling as PP

    g = P.rmat_graph(10, 8, seed=3)
    eng = P.RelayEngine(g, expansion=expansion, sparse_hybrid=False)
    led = PP.superstep_phase_ledger(eng, loops=2, repeats=2)
    assert led["applier"] == "kernel" and led["device"] == torch.cuda.get_device_name(0)
    for rec in led["phases"].values():
        assert np.isfinite(rec["seconds"]) and rec["seconds"] > 0
    for phase in ("rowmin", "state_update"):
        rec = led["phases"][phase]
        assert rec["selected"] == "kernel" and set(rec["arms"]) == {"kernel", "plain"}
        assert rec["seconds"] == rec["arms"]["kernel"]
    assert ("expansion" in led["phases"]) == (expansion == "mxu")
    res = eng.run(7)
    d, p = P.canonical_bfs(g, 7)
    np.testing.assert_array_equal(res.dist, d)
    np.testing.assert_array_equal(res.parent, p)


def test_card_auto_over_budget_builds_no_tile(card, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a tile was built")

    from bfs_tpu_torch.cache import layout as CL

    monkeypatch.setattr(CL, "load_or_build_tiles", refuse)
    eng = P.RelayEngine(P.rmat_graph(10, 8, seed=3), tiles_budget_bytes=4096)
    assert eng.expansion == "gather" and eng.adj_tiles is None and eng.phase_probe is None
    assert eng.expansion_basis.startswith("auto -> gather: tiles over budget")


def test_card_sharded_relay_launches_per_shard(card):
    """The mesh engine with 4 shards stacked on the card: each kernel of a
    dense superstep is launched once per shard (4 x the shard's count x
    the dense supersteps issued; ``packed_update`` on every superstep), on
    the pull schedule's block loop and the auto schedule's switch loop, and
    the results equal the oracle's and the CPU mesh's; the lock-step batch
    on a (2, 2) mesh launches its kernels once per shard for all 8 trees;
    every exchange arm gives the same tree."""
    from bfs_tpu_torch.parallel import sharded as SH

    g = P.rmat_graph(12, 8, seed=3)
    srg = P.build_sharded_relay_graph(g, 4, route="torch", device=card)
    mesh = SH.make_mesh(graph=4, devices=[card] * 4)
    cpu_mesh = SH.make_mesh(graph=4, devices=[torch.device("cpu")] * 4)
    d, p = P.canonical_bfs(g, 0)
    eng = SH.ShardedRelayEngine(srg, mesh)
    for direction in ("pull", "auto"):
        for _ in range(2):  # the first call captures, the second replays
            K.reset_launches()
            res = eng.run(0, direction=direction, exchange="auto")
        np.testing.assert_array_equal(res.dist, d)
        np.testing.assert_array_equal(res.parent, p)
        want = SH.bfs_sharded(srg, 0, mesh=cpu_mesh, engine="relay", direction=direction,
                              exchange="auto")
        np.testing.assert_array_equal(res.parent, want.parent)
        run, per = eng.last_run, eng.dense_launches()
        assert run["issued"] == run["issued_push"] + run["issued_pull"]
        for k, c in per.items():
            dense = run["issued"] if k == "packed_update" else run["issued_pull"]
            assert K.LAUNCHES[k] == 4 * c * dense, (direction, k, K.LAUNCHES[k], c, run)
        assert K.LAUNCHES["loop_control"] == run["issued"]
    for arm in ("flat", "bitmap", "delta"):
        got = SH.bfs_sharded(srg, 0, mesh=mesh, engine="relay", direction="pull", exchange=arm)
        np.testing.assert_array_equal(got.parent, p)
    sources = [0, 5, 77, 300, 511, 2, 8, 120]
    mesh22 = SH.make_mesh(graph=2, batch=2, devices=[card] * 4)
    srg2 = P.build_sharded_relay_graph(g, 2, route="torch", device=card)
    eng = SH.ShardedRelayEngine(srg2, mesh22)
    eng.run_multi(sources)
    K.reset_launches()
    multi = eng.run_multi(sources)
    for k, c in eng.dense_launches(len(sources)).items():
        assert K.LAUNCHES[k] == 2 * c * eng.last_run["issued"], (k, K.LAUNCHES[k], c)
    for i, s in enumerate(sources):
        d, p = P.canonical_bfs(g, s)
        np.testing.assert_array_equal(multi.dist[i], d)
        np.testing.assert_array_equal(multi.parent[i], p)


def test_card_sharded_mxu_expand_per_shard_matches_plain(card):
    """The mesh's MXU arm with 4 shards stacked on the card: ``mxu_expand``
    of every shard on a frontier of every level, against
    ``expand_frontier_mxu_plain`` on the same inputs; the searches on
    ``pull`` and ``auto`` equal to the oracle, the CPU mesh and the gather
    arm, with ``mxu_expand`` launched once per shard per dense superstep
    and ``packed_update`` once per shard per superstep; a dead superstep
    of the pull loop changes nothing."""
    from bfs_tpu_torch.parallel import sharded as SH

    g = P.rmat_graph(12, 8, seed=3)
    srg = P.build_sharded_relay_graph(g, 4, route="torch", device=card)
    mesh = SH.make_mesh(graph=4, devices=[card] * 4)
    cpu_mesh = SH.make_mesh(graph=4, devices=[torch.device("cpu")] * 4)
    eng = SH.ShardedRelayEngine(srg, mesh, expansion="mxu")
    assert eng.vperm_masks is None and eng.tiles.tiles.device.type == "cuda"
    rows, cols, rtp, vtp, _ = eng.tiles.geometry
    d, p = P.canonical_bfs(g, 0)
    for level in range(int(d[d != P.INF_DIST].max()) + 1):
        ids = np.asarray(srg.old2new, dtype=np.int64)[np.flatnonzero(d == level)]
        words = np.zeros(eng.gtot // 32, np.uint32)
        np.bitwise_or.at(words, ids >> 5, np.uint32(1) << (ids & 31).astype(np.uint32))
        fw = _t(words, card)
        for s in range(4):
            ops = eng.tiles.shard(s)
            kw = dict(rows=rows, cols=cols, rtp=rtp, vtp=vtp)
            _eq(K.expand_frontier_mxu(fw, ops, **kw), RM.expand_frontier_mxu_plain(fw, ops, **kw))
    for direction in ("pull", "auto"):
        for _ in range(2):  # the first call captures, the second replays
            K.reset_launches()
            res = eng.run(0, direction=direction, exchange="auto")
        np.testing.assert_array_equal(res.dist, d)
        np.testing.assert_array_equal(res.parent, p)
        want = SH.bfs_sharded(srg, 0, mesh=cpu_mesh, engine="relay", direction=direction,
                              exchange="auto", expansion="mxu")
        np.testing.assert_array_equal(res.parent, want.parent)
        run = eng.last_run
        assert K.LAUNCHES["mxu_expand"] == 4 * run["issued_pull"], (direction, run)
        assert K.LAUNCHES["packed_update"] == 4 * run["issued"], (direction, run)
        assert K.LAUNCHES["class_rowmin"] == K.LAUNCHES["benes_local_pass"] == 0
    loop = next(v for k, v in eng._loops.items() if k[3] == "pull")
    before = [b.clone() for b in loop.buffers]
    loop.dead_replay()
    for a, b in zip(before, loop.buffers):
        assert torch.equal(a, b)


def test_card_sharded_segmented_resumes_after_a_lost_shard(card, tmp_path):
    """The mesh's segmented search on the card on both arms: equal to the
    fused search (results, schedule, the exchange's bytes) at every:2;
    stopped at boundary 3, one shard file lost, resumed on a freshly built
    engine from the epoch before."""
    from bfs_tpu_torch.parallel import sharded as SH
    from bfs_tpu_torch.resilience import faults as F
    from bfs_tpu_torch.resilience.faults import FaultInjected, corrupt_file
    from bfs_tpu_torch.resilience.superstep_ckpt import CkptConfig, SuperstepCheckpointer

    g = P.rmat_graph(12, 8, seed=3)
    srg = P.build_sharded_relay_graph(g, 4, route="torch", device=card)
    mesh = SH.make_mesh(graph=4, devices=[card] * 4)
    kw = dict(direction="auto", exchange="auto", telemetry=True)
    for arm in ("gather", "mxu"):
        eng = SH.ShardedRelayEngine(srg, mesh, expansion=arm)
        want, wcurve = eng.run(0, **kw)

        def mgr(tag, k):
            return SuperstepCheckpointer(tmp_path / arm / tag, {"t": 1}, cfg=CkptConfig("every", k),
                                         shards=4)

        res, curve = SH.bfs_sharded_segmented(srg, 0, mesh=mesh, ckpt=mgr("two", 2), expansion=arm,
                                              **kw)
        for got, gcurve in ((res, curve),):
            np.testing.assert_array_equal(got.dist, want.dist)
            np.testing.assert_array_equal(got.parent, want.parent)
            assert gcurve["direction_schedule"] == wcurve["direction_schedule"]
            assert gcurve["exchange"] == wcurve["exchange"]
        os.environ["BFS_TPU_TORCH_FAULT"] = "raise:superstep:3"
        F.reset()
        try:
            with pytest.raises(FaultInjected):
                eng.run_segmented(0, ckpt=mgr("kill", 1), **kw)
        finally:
            os.environ.pop("BFS_TPU_TORCH_FAULT", None)
            F.reset()
        m = mgr("kill", 1)
        assert m.epochs() == [2, 3]
        corrupt_file(m._epoch_path(3, shard=2), mode="truncate")
        res, curve = SH.bfs_sharded_segmented(srg, 0, mesh=mesh, ckpt=m, expansion=arm, **kw)
        assert m.report()["resumed_from_epoch"] == 2
        np.testing.assert_array_equal(res.dist, want.dist)
        np.testing.assert_array_equal(res.parent, want.parent)
        assert curve["exchange"] == wcurve["exchange"]


def test_card_grid_equals_its_cpu_run_with_k4_per_cell(card, tmp_path):
    """The 2-D grid with a 2x2 mesh stacked on the card: on the pull
    schedule's block loop and the auto schedule's switch loop (a first call
    that captures, then a replay), equal to the oracle and to the same grid
    on the CPU (results, direction schedule, both axes' bytes and arms),
    with ``packed_update`` launched 4 x the supersteps issued on the packed
    carry and ``loop_control`` once per superstep; every arm the same tree;
    a dead block changes nothing; the segmented search at every:2 equal to
    the fused one."""
    from bfs_tpu_torch.parallel import grid as G
    from bfs_tpu_torch.resilience.superstep_ckpt import CkptConfig, SuperstepCheckpointer

    g = P.rmat_graph(12, 8, seed=3)
    srg = P.build_sharded_relay_graph(g, 4, route="torch", device=card)
    mesh = G.make_grid_mesh(2, 2, devices=[card] * 4)
    cpu = G.GridEngine(srg, G.make_grid_mesh(2, 2, devices=[torch.device("cpu")] * 4))
    eng = G.GridEngine(srg, mesh)
    assert eng.packed and eng.dflat.device.type == "cuda"
    d, p = P.canonical_bfs(g, 0)
    kw = dict(exchange="auto", telemetry=True)
    for direction in ("pull", "auto"):
        for _ in range(2):  # the first call captures, the second replays
            K.reset_launches()
            res, curve = eng.run(0, direction=direction, **kw)
        np.testing.assert_array_equal(res.dist, d)
        np.testing.assert_array_equal(res.parent, p)
        want, wcurve = cpu.run(0, direction=direction, **kw)
        np.testing.assert_array_equal(res.parent, want.parent)
        assert res.num_levels == want.num_levels
        assert curve["direction_schedule"] == wcurve["direction_schedule"]
        assert curve["exchange"] == wcurve["exchange"]
        run = eng.last_run
        assert run["packed"] and run["replays"] > 0
        assert K.LAUNCHES["packed_update"] == 4 * run["issued"], (direction, run)
        assert K.LAUNCHES["loop_control"] == run["issued"]
    loop = eng._loops[(True, True, "pull", ("auto", 8))]
    before = [b.clone() for b in loop.buffers]
    loop.dead_replay()
    for a, b in zip(before, loop.buffers):
        assert torch.equal(a, b)
    for arm in ("flat", "bitmap", "delta"):
        got = G.bfs_grid(srg, 0, mesh=mesh, direction="pull", exchange=arm)
        np.testing.assert_array_equal(got.parent, p)
    mgr = SuperstepCheckpointer(tmp_path, {"t": 1}, cfg=CkptConfig("every", 2), shards=4)
    seg, scurve = eng.run_segmented(0, ckpt=mgr, direction="auto", **kw)
    np.testing.assert_array_equal(seg.parent, p)
    assert scurve["exchange"] == wcurve["exchange"] and mgr.epochs() == []
