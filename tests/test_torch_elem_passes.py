"""The element-major local Beneš pass of the card (``benes_elem_local_pass``,
K5's local mode): its host plan of register phases
(``relay_cuda.elem_local_plan``) and a NumPy model of what the kernel in
``csrc/relay_elem_kernels.cu`` does — a tile per (tile, group) block, each
thread's elements in registers under a window of index bits, the stages of
a window applied in registers with the mask bits read from the stage's slab
as the kernel indexes it, the swizzled shared-memory re-layouts between
windows, and the stages whose slab is all zero skipped — held bit for bit
against the port's plain ``apply_benes_elem`` and ``bfs_tpu``'s
``apply_benes_elem``.  The constants come from the ``.cu`` source.  The
kernel itself is held against the plain version on the card in
``test_torch_cuda.py``.

All comparisons are exact: everything here is integer bit arithmetic."""

import numpy as np
import pytest
import torch

import bfs_tpu_torch as P
from bfs_tpu_torch.graph import relay as p_relay
from bfs_tpu_torch.ops import relay_cuda as K
from bfs_tpu_torch.ops import relay_elem as RE
from bfs_tpu_torch.utils import cuda_build

import jax
import jax.numpy as jnp

from bfs_tpu.graph import benes as j_benes
from bfs_tpu.graph import relay as j_relay
from bfs_tpu.ops import relay_elem as JRE

pytestmark = pytest.mark.skipif(
    not j_benes.native_available(), reason="native benes router unavailable"
)

SOURCE = K.SOURCES["relay_elem_kernels"]
# bfs_tpu's element network as one program (the stage table is static).
_JAX_APPLY = jax.jit(JRE.apply_benes_elem, static_argnums=(2, 3))


def _const(name: str) -> int:
    return cuda_build.constant(SOURCE, name)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


def _u(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _elems(rng, shape) -> np.ndarray:
    x = rng.integers(0, 2**32, shape, dtype=np.uint32)
    x[rng.random(shape) < 0.05] = 0xFFFFFFFF
    x[rng.random(shape) < 0.05] = np.uint32(1 << 31)
    return x


_LAYOUTS = {}


def _layout(scale: int):
    if scale not in _LAYOUTS:
        _LAYOUTS[scale] = P.build_relay_graph(P.rmat_graph(scale, 6, seed=1))
    return _LAYOUTS[scale]


def _random_network(log_n: int, seed: int):
    """Masks and stage table of a routed random permutation of 2^log_n
    elements (stages with d >= 4096 pair-compacted, as every layout
    stores them)."""
    n = 1 << log_n
    perm = np.random.default_rng(seed).permutation(n).astype(np.int64)
    masks, table = j_relay._compact_and_table(j_benes.route_std(perm), n)
    table = tuple(p_relay.StageSpec(*st) for st in table)
    return np.asarray(masks, dtype=np.uint32), table, n


def _swizzle(e):
    return e ^ ((e >> 5) & 31)


def _thread_elems(t, lo: int, reg_bits: int):
    return (t & ((1 << lo) - 1)) | ((t >> lo) << (lo + reg_bits))


def _squeeze(q, b: int):
    """The pair number of lower element ``q`` at distance ``2^b``."""
    return (q & ((1 << b) - 1)) | ((q >> (b + 1)) << b)


def model_elem_local_pass(x, masks, stages, n, tile, reg_bits, slots, seed=0):
    """The blocks of ``benes_elem_local_pass`` on uint32[G, n], all at once
    (axis 0): block b takes tile b // G of group b % G; thread t holds
    2^reg_bits elements E_t | (j << lo) under each phase's window; each
    stage of a phase swaps register pairs (j, j | 2^k) where its slab's bit
    is set, read as the kernel does (word (q_t >> 5) + (Q >> 5), bit
    (q_t & 31) | (Q & 31) of the thread and register parts of the lower
    element's bit index); the tile moves between windows through a
    swizzled buffer.  A slot holds garbage past its slab (what registers
    past a small tile read).  Returns the elements and how many (block,
    stage) pairs were skipped."""
    rng = np.random.default_rng(seed)
    g_count = x.shape[0]
    lg = tile.bit_length() - 1
    regs = 1 << reg_bits
    bits = tuple(st.d.bit_length() - 1 for st in stages)
    plan = K.elem_local_plan(bits, lg, reg_bits, slots)
    assert plan[-1][1] == len(stages)
    threads = max(tile >> reg_bits, 1)
    t = np.arange(threads, dtype=np.int64)[:, None]
    j = np.arange(regs, dtype=np.int64)[None, :]
    slot_words = max(tile >> 5, 4)
    blk = np.arange(n // tile * g_count, dtype=np.int64)
    base, grp = blk // g_count * tile, blk % g_count
    rows = blk[:, None]

    def elems(lo):
        return _thread_elems(t, lo, reg_bits) | (j << lo)

    e = elems(plan[0][0])
    ghost = (e >= tile)[None]
    at = base[:, None, None] + np.where(ghost, 0, e)[0][None]
    xr = np.where(ghost, np.uint32(0), x[grp[:, None, None], at])
    xs = np.zeros((len(blk), max(tile, regs)), np.uint32)
    skipped, s, prev = 0, 0, None
    for lo, end in plan:
        if prev is not None and prev != lo:
            xs[rows[:, :, None], _swizzle(elems(prev))[None]] = xr
            xr = xs[rows[:, :, None], _swizzle(elems(lo))[None]]
        et = _thread_elems(t, lo, reg_bits)
        for s in range(s, end):
            st, b = stages[s], bits[s]
            w0 = base >> 6 if st.compact else base >> 5
            words = max(tile >> 6 if st.compact else tile >> 5, 1)
            live = (w0 < st.hi) & (w0 + words > st.lo)
            skipped += int((~live).sum())  # those slabs are all zero
            slot = rng.integers(0, 2**32, (len(blk), slot_words), dtype=np.uint32)
            slot[:, :words] = masks[st.offset + w0[:, None] + np.arange(words)]
            k = b - lo
            assert 0 <= k < reg_bits
            qt = _squeeze(et, b) if st.compact else et
            for jj in range(regs):
                if jj & (1 << k):
                    continue
                big = jj << lo
                q = _squeeze(big, b) if st.compact else big
                word = slot[rows, ((qt >> 5) + (q >> 5))[:, 0][None]]
                swap = ((word >> ((qt & 31) | (q & 31))[:, 0][None]) & 1).astype(bool)
                swap &= live[:, None]
                low = et | big  # the decomposition has no carries
                full = _squeeze(low, b) if st.compact else low
                real = low < tile
                assert ((((qt >> 5) + (q >> 5)) == (full >> 5)) | ~real).all()
                a, c = xr[:, :, jj].copy(), xr[:, :, jj | (1 << k)].copy()
                xr[:, :, jj] = np.where(swap, c, a)
                xr[:, :, jj | (1 << k)] = np.where(swap, a, c)
        s, prev = end, lo
    e = elems(plan[-1][0])
    keep = e < tile
    out = x.copy()
    out[grp[:, None], base[:, None] + e[keep][None]] = xr[:, keep]
    return out, skipped


def _check(x, masks, stages, n, tile, reg_bits=None, slots=None):
    """The model against the port's plain pass and bfs_tpu's, bit for bit;
    returns the model's skipped count."""
    reg_bits = _const("kElemRegBits") if reg_bits is None else reg_bits
    slots = _const("kElemSlots") if slots is None else slots
    got, skipped = model_elem_local_pass(x, masks, stages, n, tile, reg_bits, slots)
    want = _u(RE.apply_benes_elem(_t(x), _t(masks), stages, n))
    np.testing.assert_array_equal(got, want)
    ref = np.asarray(_JAX_APPLY(jnp.asarray(x), jnp.asarray(masks), stages, n))
    np.testing.assert_array_equal(got, ref)
    return skipped


def test_constants_mirror_the_kernel_source():
    assert K.ELEM_REG_BITS == _const("kElemRegBits")
    assert K.ELEM_SLOTS == _const("kElemSlots")
    assert K.MAX_TILE_ELEMS == 1 << _const("kMaxTileBits")


@pytest.mark.parametrize("reg_bits", [5, 6])
@pytest.mark.parametrize("lg_tile", range(5, 16))
def test_elem_local_plan_covers_the_local_run(lg_tile, reg_bits):
    """Each stage once, in order, inside its phase's window; windows in
    range; no phase longer than the ring; a phase ends only where the next
    stage leaves the window."""
    bits = tuple(range(lg_tile - 1, -1, -1)) + tuple(range(1, lg_tile))
    slots = _const("kElemSlots")
    plan = K.elem_local_plan(bits, lg_tile, reg_bits, slots)
    top = max(lg_tile - reg_bits, 0)
    s = 0
    for lo, end in plan:
        assert 0 <= lo <= top and s < end <= s + slots
        assert all(lo <= b < lo + reg_bits for b in bits[s:end])
        if end < len(bits):
            assert not lo <= bits[end] < lo + reg_bits or end - s == slots
        s = end
    assert s == len(bits)
    if reg_bits == 5 and lg_tile == 15:  # scale 22's net: 29 stages, 4 re-layouts
        assert plan == ((10, 5), (5, 10), (0, 19), (5, 24), (10, 29))
    assert len(plan) <= 5


def test_elem_local_plan_edges():
    assert K.elem_local_plan((), 10) == ((5, 0),)  # a copy
    assert K.elem_local_plan((3, 2, 3), 5) == ((0, 3),)
    assert K.elem_local_plan((2, 1, 0, 1, 2), 6, slots=2) == ((0, 2), (0, 4), (0, 5))
    with pytest.raises(ValueError):
        K.elem_local_plan((10,), 10)


@pytest.mark.parametrize("scale,groups,tile", [
    (10, 1, None), (10, 2, 1 << 12), (10, 3, 1 << 9),
    (12, 1, 1 << 15), (12, 2, None), (12, 3, 1 << 7),
])
def test_model_matches_plain_on_layouts(scale, groups, tile):
    """Both networks of the s10/s12 layouts' tables: the local run at the
    default tile (the whole network when it is smaller) and at smaller
    tiles, which give partial windows and more blocks."""
    rng = np.random.default_rng(scale * 10 + groups)
    rg = _layout(scale)
    skips = 0
    for masks, table, n in ((rg.vperm_masks, rg.vperm_table, rg.vperm_size),
                            (rg.net_masks, rg.net_table, rg.net_size)):
        t = min(tile or K.MAX_TILE_ELEMS, n)
        _, local, _, t = K.split_elem_passes(table, n, t)
        stages = tuple(table[i] for i in local)
        skips += _check(_elems(rng, (groups, n)), masks, stages, n, t)
    if tile == 1 << 7:
        assert skips > 0  # the vperm's zero tail skips stages on some tiles


@pytest.mark.parametrize("log_n,groups,tile,reg_bits,slots", [
    (16, 2, 1 << 15, None, None),  # compact stages (d >= 4096) in registers
    (16, 1, 1 << 13, None, None),
    (13, 3, 1 << 13, None, None),  # one tile: the whole network
    (12, 2, 1 << 12, 6, None),  # 64 registers a thread
    (14, 1, 1 << 14, None, 3),  # short ring: phases cut at 3 stages
    (6, 2, 1 << 5, None, None),  # a tile of 32 elements, one thread
    (6, 1, 1 << 5, 6, None),  # registers past the tile
])
def test_model_matches_plain_on_random_networks(log_n, groups, tile, reg_bits, slots):
    masks, table, n = _random_network(log_n, seed=log_n + groups)
    _, local, _, t = K.split_elem_passes(table, n, tile)
    stages = tuple(table[i] for i in local)
    assert any(st.compact for st in stages) == (t > 4096)
    x = _elems(np.random.default_rng(log_n), (groups, n))
    _check(x, masks, stages, n, t, reg_bits, slots)


def test_wrapper_refuses_what_the_kernel_cannot_run():
    """Checked before any launch: tiles out of [32, 2^15], stages that span
    a tile, compact stages on a tile of 32 (a CUDA-only path; on the CPU the
    plain version runs)."""
    masks, table, n = _random_network(16, seed=1)
    x = torch.zeros((1, n), dtype=torch.int32)
    _, local, _, _ = K.split_elem_passes(table, n, 1 << 15)
    stages = tuple(table[i] for i in local)

    class Lib:  # never reached: every case raises first
        def benes_elem_local_pass(self, *args):
            raise AssertionError("launched")

    for tile in (16, 1 << 16, 3000):
        with pytest.raises(ValueError):
            K.launch_elem_local_pass(Lib(), x, _t(masks), stages, n, tile)
    with pytest.raises(ValueError):
        K.launch_elem_local_pass(Lib(), x, _t(masks), stages, n, 1 << 14)
