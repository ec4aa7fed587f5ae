"""The card's kernels against their plain PyTorch versions (marker ``cuda``).

This file imports neither jax nor ``bfs_tpu``, so it also runs on a machine
with a card and no jax:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Each test decides inside a fixture whether a card is present and skips
without one.  Comparisons are exact (integer bit arithmetic)."""

import numpy as np
import pytest
import torch

import bfs_tpu_torch as P
from bfs_tpu_torch.graph import benes
from bfs_tpu_torch.graph.relay import valid_slot_words
from bfs_tpu_torch.models import bfs as p_bfs
from bfs_tpu_torch.ops import relay as R
from bfs_tpu_torch.ops import relay_cuda as K
from bfs_tpu_torch.ops import relay_elem as RE

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


def test_card_benes_kernels_match_plain(card, layout):
    rg = layout
    x = _t(_words(np.random.default_rng(6), rg.net_size // 32), card)
    masks = _t(rg.net_masks, card)
    want = R.apply_benes_std(x, masks, rg.net_table, rg.net_size)
    _eq(K.apply_benes(x, masks, rg.net_table, rg.net_size), want)
    K.reset_launches()
    for tile in (64, 256):  # small tiles force outer stages at this size
        pre, local, suf, _ = K.split_passes(rg.net_table, rg.net_size, tile)
        y = x
        for i in pre:
            y = K.benes_outer_stage(y, masks, rg.net_table[i], rg.net_size)
        y = K.benes_local_pass(y, masks, tuple(rg.net_table[i] for i in local), rg.net_size, tile)
        for i in suf:
            y = K.benes_outer_stage(y, masks, rg.net_table[i], rg.net_size)
        _eq(y, want)
    torch.cuda.synchronize()
    assert K.LAUNCHES["benes_local_pass"] == 2 and K.LAUNCHES["benes_outer_stage"] > 0


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


def test_card_bfs_matches_cpu_and_oracle(card):
    g = P.rmat_graph(12, 6, seed=1)
    cpu = P.RelayEngine(g, device="cpu")
    on_card = P.RelayEngine(g)
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
    for name in ("benes_elem_local_pass", "benes_elem_outer_stage", "elem_rowmin_update"):
        assert K.LAUNCHES[name] > 0, name
