"""The port's plain relay ops against their JAX twins and the JAX package's
Pallas kernels (interpret mode).  The card's kernels are held against the
plain versions in ``test_torch_cuda.py``.

All comparisons are exact: everything here is integer bit arithmetic.
Inputs are made with NumPy from a seed and include the sentinel word and
words with bit 31 set."""

import numpy as np
import pytest
import torch

import bfs_tpu_torch as P
from bfs_tpu_torch.graph import relay as p_relay
from bfs_tpu_torch.ops import packed as p_packed
from bfs_tpu_torch.ops import relay as R
from bfs_tpu_torch.ops import relay_cuda as K

import jax.numpy as jnp

from bfs_tpu.graph import benes as j_benes
from bfs_tpu.graph import relay as j_relay
from bfs_tpu.ops import relay as JR
from bfs_tpu.ops import relay_pallas as JP

pytestmark = pytest.mark.skipif(
    not j_benes.native_available(), reason="native benes router unavailable"
)


def _t(words: np.ndarray) -> torch.Tensor:
    """uint32 words -> the port's int32 bit-pattern tensor."""
    return torch.from_numpy(np.ascontiguousarray(words, dtype=np.uint32).view(np.int32))


def _u(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _words(rng, n: int) -> np.ndarray:
    """Random uint32 words with the sentinel, bit 31 and zeros mixed in."""
    w = rng.integers(0, 2**32, n, dtype=np.uint32)
    w[rng.random(n) < 0.1] = 0xFFFFFFFF
    w[rng.random(n) < 0.1] |= np.uint32(1 << 31)
    w[rng.random(n) < 0.2] = 0
    return w


@pytest.fixture(scope="module")
def layout():
    """One R-MAT layout with rank-major AND vertex-major classes, built by
    the reference and converted into the port."""
    g = P.rmat_graph(10, 8, seed=3)
    jg = j_relay.Graph(g.num_vertices, g.src.copy(), g.dst.copy())
    rg = P.from_reference_layout(j_relay.relay_to_arrays(j_relay.build_relay_graph(jg)))
    assert any(c.vertex_major for c in rg.in_classes)
    assert any(JP.rowmin_class_ok(c) for c in rg.in_classes)
    return rg


def test_pack_unpack_match_jax():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, 32 * 40).astype(np.uint8)
    np.testing.assert_array_equal(
        _u(R.pack_std(torch.from_numpy(bits))),
        np.asarray(JR.pack_std(jnp.asarray(bits))),
    )
    words = _words(rng, 40)
    np.testing.assert_array_equal(
        R.unpack_std(_t(words), 32 * 40).numpy(),
        np.asarray(JR.unpack_std(jnp.asarray(words), 32 * 40)),
    )


@pytest.mark.parametrize("net", ["vperm", "net"])
def test_apply_benes_std_matches_jax(layout, net):
    rg = layout
    masks, table, n = (
        (rg.vperm_masks, rg.vperm_table, rg.vperm_size) if net == "vperm"
        else (rg.net_masks, rg.net_table, rg.net_size)
    )
    x = _words(np.random.default_rng(1), n // 32)
    want = np.asarray(JR.apply_benes_std(jnp.asarray(x), jnp.asarray(masks), table, n))
    got = _u(R.apply_benes_std(_t(x), _t(masks), table, n))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tile_rows", [8, 16])
def test_apply_benes_std_matches_pallas_passes(tile_rows):
    """Against K1/K2 (``apply_benes_fused`` in interpret mode), and the
    port's local/outer split against the reference's at the same tile."""
    rng = np.random.default_rng(5)
    n = 1 << 17  # 32 rows of 128 lanes: tile_rows < 32 makes outer passes
    perm = rng.permutation(n).astype(np.int64)
    masks, table = j_relay._compact_and_table(j_benes.route_std(perm), n)
    ps = JP.pass_static(table, n, tile_rows=tile_rows)
    arrays = [jnp.asarray(a) for a in JP.prepare_pass_masks(masks, table, n, tile_rows=tile_rows)]
    x = _words(rng, n // 32)
    want = np.asarray(JP.apply_benes_fused(jnp.asarray(x), arrays, ps, n, interpret=True))
    got = _u(R.apply_benes_std(_t(x), _t(masks), table, n))
    np.testing.assert_array_equal(got, want)
    bits = np.unpackbits(x.view(np.uint8), bitorder="little")
    np.testing.assert_array_equal(
        np.unpackbits(got.view(np.uint8), bitorder="little"), bits[perm]
    )
    pre, local, suf, tile = K.split_passes(table, n, tile_rows * 128)
    assert tile == tile_rows * 128
    assert (pre, local, suf) == tuple(tuple(x) for x in JP.split_passes(table, n, tile_rows)[:3])
    assert pre and suf


def test_split_passes_and_tile_choice():
    for n in (1 << 13, 1 << 18, 1 << 22, 1 << 26, 1 << 28):
        table = tuple(
            p_relay.StageSpec(d=p_relay.benes.stage_distance(n, s), offset=0,
                              nwords=0, compact=False, lo=0, hi=0)
            for s in range(p_relay.benes.num_stages(n))
        )
        pre, local, suf, tile = K.split_passes(table, n)
        nw = n // 32
        assert tile == min(nw, max(K.MIN_TILE_WORDS, min(K.MAX_TILE_WORDS, nw // 128)))
        assert nw % tile == 0 and len(pre) == len(suf)
        assert all(table[i].d >= 32 * tile for i in pre + suf)
        assert all(table[i].d < 32 * tile for i in local)
    with pytest.raises(ValueError):
        K.split_passes(table, n, 3000)


def test_broadcast_l2_matches_jax(layout):
    rg = layout
    assert any(c.vertex_major for c in rg.out_classes)
    y = _words(np.random.default_rng(2), rg.vperm_size // 32)
    want = np.asarray(JR.broadcast_l2(jnp.asarray(y), rg.out_classes, rg.net_size, rg.out_space))
    got = _u(R.broadcast_l2(_t(y), rg.out_classes, rg.net_size, rg.out_space))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("density", [0.02, 0.5])
def test_rowmin_matches_jax_and_pallas(layout, density):
    rg = layout
    rng = np.random.default_rng(int(density * 100))
    bits = (rng.random(rg.net_size) < density).astype(np.uint8)
    l1 = np.packbits(bits.reshape(-1, 32), axis=1, bitorder="little").view(np.uint32).reshape(-1)
    l1[rng.random(l1.shape[0]) < 0.05] = 0xFFFFFFFF
    valid = j_relay.valid_slot_words(rg.src_l1, rg.net_size)
    jl1, jv = jnp.asarray(l1), jnp.asarray(valid)
    ours = _u(R.rowmin_ranks(_t(l1), _t(valid), rg.in_classes, rg.vr))
    np.testing.assert_array_equal(ours, np.asarray(JR.rowmin_ranks(jl1, jv, rg.in_classes, rg.vr)))
    np.testing.assert_array_equal(
        ours, np.asarray(JP.rowmin_ranks_pallas(jl1, jv, rg.in_classes, rg.vr, interpret=True))
    )
    np.testing.assert_array_equal(
        R.rowmin_candidates(_t(l1), _t(valid), rg.in_classes, rg.vr).numpy(),
        np.asarray(JR.rowmin_candidates(jl1, jv, rg.in_classes, rg.vr)),
    )


def _packed_state(rng, vr: int, level: int):
    """A packed carry with reached words of levels <= level (some with bit
    31 set) and sentinels."""
    lv = rng.integers(0, level + 1, vr).astype(np.uint32)
    rank = rng.integers(0, 1 << 10, vr).astype(np.uint32)
    packed = (lv << np.uint32(26)) | rank
    packed[rng.random(vr) < 0.5] = 0xFFFFFFFF
    return packed


@pytest.mark.parametrize("level", [3, 40, 61])
def test_packed_update_matches_jax_and_pallas(level):
    rng = np.random.default_rng(level)
    vr = 32 * 300
    packed = _packed_state(rng, vr, level)
    rank = rng.integers(0, 1 << 10, vr).astype(np.uint32)
    rank[rng.random(vr) < 0.4] = 0xFFFFFFFF
    ours = R.apply_relay_candidates_packed(
        R.PackedRelayState(_t(packed), torch.zeros(vr // 32, dtype=torch.int32), level, None),
        _t(rank),
    )
    jst = JR.PackedRelayState(
        jnp.asarray(packed), jnp.zeros(vr // 32, jnp.uint32), jnp.int32(level), jnp.bool_(True)
    )
    for ref in (
        JR.apply_relay_candidates_packed(jst, jnp.asarray(rank)),
        JP.apply_relay_candidates_packed_pallas(jst, jnp.asarray(rank), interpret=True),
    ):
        np.testing.assert_array_equal(_u(ours.packed), np.asarray(ref.packed))
        np.testing.assert_array_equal(_u(ours.fwords), np.asarray(ref.fwords))
        assert ours.level == int(ref.level)
        assert bool(ours.changed) == bool(ref.changed)


def test_unpacked_update_and_unpack_match_jax(layout):
    rg = layout
    rng = np.random.default_rng(9)
    vr = rg.vr
    dist = np.where(rng.random(vr) < 0.5, np.int32(p_packed.INT32_MAX),
                    rng.integers(0, 4, vr)).astype(np.int32)
    parent = np.where(dist == p_packed.INT32_MAX, -1, rng.integers(0, rg.m1, vr)).astype(np.int32)
    cand = np.where(rng.random(vr) < 0.5, np.int32(p_packed.INT32_MAX),
                    rng.integers(0, rg.m1, vr)).astype(np.int32)
    ours = R.apply_relay_candidates(
        R.RelayState(torch.from_numpy(dist), torch.from_numpy(parent),
                     torch.zeros(vr // 32, dtype=torch.int32), 4, None),
        torch.from_numpy(cand),
    )
    ref = JR.apply_relay_candidates(
        JR.RelayState(jnp.asarray(dist), jnp.asarray(parent),
                      jnp.zeros(vr // 32, jnp.uint32), jnp.int32(4), jnp.bool_(True)),
        jnp.asarray(cand),
    )
    np.testing.assert_array_equal(ours.dist.numpy(), np.asarray(ref.dist))
    np.testing.assert_array_equal(ours.parent.numpy(), np.asarray(ref.parent))
    np.testing.assert_array_equal(_u(ours.fwords), np.asarray(ref.fwords))
    assert bool(ours.changed) == bool(ref.changed) and ours.level == 5

    packed = _packed_state(rng, vr, 30)
    rank_field = rng.integers(0, 2, vr).astype(np.uint32)  # ranks < every width
    packed = np.where(packed == 0xFFFFFFFF, packed, (packed & ~np.uint32(0x3FFFFFF)) | rank_field)
    packed[rg.in_classes[-1].vb:] = 0xFFFFFFFF  # the uncovered tail is never reached
    d, p = R.unpack_relay_packed(_t(packed), rg.in_classes, vr)
    jd, jp = JR.unpack_relay_packed(jnp.asarray(packed), rg.in_classes, vr)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))


def test_wrappers_take_the_plain_version_on_cpu(layout):
    rg = layout
    K.reset_launches()
    x = _t(_words(np.random.default_rng(4), rg.net_size // 32))
    masks = _t(rg.net_masks)
    np.testing.assert_array_equal(
        _u(K.apply_benes(x, masks, rg.net_table, rg.net_size)),
        _u(R.apply_benes_std(x, masks, rg.net_table, rg.net_size)),
    )
    assert all(v == 0 for v in K.LAUNCHES.values())
    meta = torch.empty(rg.net_size // 32, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        K.apply_benes(meta, masks, rg.net_table, rg.net_size)
