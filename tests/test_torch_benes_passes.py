"""The single-source Beneš passes of the card: ``benes_outer_pass``'s host
plan (``relay_cuda.outer_plan``) and the local pass's tiles, and NumPy
models of what the kernels in ``csrc/relay_kernels.cu`` do — the fused
outer pass's walk over units, the local pass's ring of stage-mask slabs and its
in-word sweep — held against the port's plain ``apply_benes_std`` and the
JAX package's ``apply_benes_fused`` (interpret mode).  The kernels
themselves are held against the plain version on the card in
``test_torch_cuda.py``.

All comparisons are exact: everything here is integer bit arithmetic."""

import re

import numpy as np
import pytest
import torch

import bfs_tpu_torch as P
from bfs_tpu_torch.graph import relay as p_relay
from bfs_tpu_torch.ops import relay as R
from bfs_tpu_torch.ops import relay_cuda as K

import jax.numpy as jnp

from bfs_tpu.graph import benes as j_benes
from bfs_tpu.graph import relay as j_relay
from bfs_tpu.ops import relay_pallas as JP

pytestmark = pytest.mark.skipif(
    not j_benes.native_available(), reason="native benes router unavailable"
)

SCALES = (12, 13, 14, 15, 16)


def _cu_constant(name: str) -> int:
    src = open(K.SOURCES["relay_kernels"]).read()
    found = re.search(rf"constexpr (?:int|size_t) {name} = (\d+);", src)
    assert found, f"{name} not found in relay_kernels.cu"
    return int(found.group(1))


def _t(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(words, dtype=np.uint32).view(np.int32))


def _u(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _words(rng, n: int) -> np.ndarray:
    w = rng.integers(0, 2**32, n, dtype=np.uint32)
    w[rng.random(n) < 0.1] = 0xFFFFFFFF
    w[rng.random(n) < 0.2] = 0
    return w


_LAYOUTS = {}


def _layout(scale: int):
    if scale not in _LAYOUTS:
        _LAYOUTS[scale] = P.build_relay_graph(P.rmat_graph(scale, 6, seed=1))
    return _LAYOUTS[scale]


def _networks(scale: int):
    rg = _layout(scale)
    return (
        ("vperm", rg.vperm_masks, rg.vperm_table, rg.vperm_size),
        ("net", rg.net_masks, rg.net_table, rg.net_size),
    )


def _table_for(n: int):
    """A stage table of a size-``n`` network (distances only), as
    ``test_split_passes_and_tile_choice`` builds it."""
    return tuple(
        p_relay.StageSpec(d=p_relay.benes.stage_distance(n, s), offset=0, nwords=0,
                          compact=False, lo=0, hi=0)
        for s in range(p_relay.benes.num_stages(n))
    )


def _unit_words(run: K.OuterRun, nw: int) -> np.ndarray:
    """int64[units, row_words << k]: the word of every slot of every unit
    of ``benes_outer_pass`` (slot i: column i mod R, row i / R)."""
    row, k, b0 = run.row_words, run.k, run.b0
    lg = row.bit_length() - 1
    mid = b0 - lg
    u = np.arange(run.units, dtype=np.int64)
    base = ((u & ((1 << mid) - 1)) << lg) | ((u >> mid) << (b0 + k))
    i = np.arange(row << k, dtype=np.int64)
    return base[:, None] + (i & (row - 1)) + ((i >> lg) << b0)


def _check_plan(table, idx, n):
    """The runs of one side cover its stages once, in order; each fits the
    kernel; each run's units partition the word array."""
    runs = K.outer_plan(table, tuple(idx), n)
    assert tuple(i for r in runs for i in r.stages) == tuple(idx)
    nw = n // 32
    for r in runs:
        assert 1 <= r.k == len(r.stages) <= K.OUTER_MAX_STAGES
        assert r.row_words <= min(1 << r.b0, K.OUTER_MAX_WORDS >> r.k)
        assert r.units * (r.row_words << r.k) == nw
        bits = sorted((table[i].d >> 5).bit_length() - 1 for i in r.stages)
        assert bits == list(range(r.b0, r.b0 + r.k))
        if nw <= 1 << 20:
            words = np.sort(_unit_words(r, nw).ravel())
            np.testing.assert_array_equal(words, np.arange(nw))
    return runs


def model_outer_pass(x: np.ndarray, masks: np.ndarray, table, run: K.OuterRun, n: int):
    """The walk of ``benes_outer_pass`` over units: gather each unit's
    ``R << k`` words by the plan, apply the run's stages in network order
    (pairs at slot distance ``R << j``, the mask at the lower word or at its
    pair-compacted index), scatter back."""
    words = _unit_words(run, n // 32)
    xs = x[words]
    lg = run.row_words.bit_length() - 1
    q = np.arange((run.row_words << run.k) // 2, dtype=np.int64)
    for i in run.stages:
        st = table[i]
        b = (st.d >> 5).bit_length() - 1
        e = lg + b - run.b0
        lo = ((q >> e) << (e + 1)) | (q & ((1 << e) - 1))
        hi = lo + (1 << e)
        w = words[:, lo]
        at = (((w >> (b + 1)) << b) | (w & ((1 << b) - 1))) if st.compact else w
        m = masks[st.offset + at]
        a, c = xs[:, lo], xs[:, hi]
        t = (a ^ c) & m
        xs[:, lo], xs[:, hi] = a ^ t, c ^ t
    out = x.copy()
    out[words] = xs
    return out


def model_local_pass(x, masks, stages, n, tile, slots, max_sweep):
    """The block walk of ``benes_local_pass``: per tile, the slabs of the
    stages with d >= 32 copied into ``slots`` ring slots in the kernel's
    order (the first ``slots`` up front, slab c + slots once stage c is
    done), and each run of stages with d < 32 (at most ``max_sweep``) as
    one sweep: every word reads all of the run's mask words first, then
    applies the run.  A stage is skipped on a tile whose slab lies outside
    its nonzero range ``[lo, hi)``, and the sweep reads no mask word outside
    it.  Returns the words and how many (tile, cross stage) pairs were
    skipped."""
    out = x.copy()
    cross = [s for s, st in enumerate(stages) if st.d >= 32]

    def span(c, base):
        """The c-th cross stage's slab on this tile: stored words [a, b)."""
        st = stages[cross[c]]
        a = base >> 1 if st.compact else base
        return st, a, a + (tile // 2 if st.compact else tile)

    def live(c, base):
        st, a, b = span(c, base)
        return a < st.hi and b > st.lo

    def slab(c, base):
        st, a, b = span(c, base)
        return masks[st.offset + a : st.offset + b].copy()

    def inword(st, base):
        """The tile's mask words of an in-word stage, zero (unread) outside
        the stage's nonzero range."""
        at = np.arange(base, base + tile)
        keep = (at >= st.lo) & (at < st.hi)
        return np.where(keep, masks[st.offset + np.where(keep, at, 0)], np.uint32(0))

    skipped = 0
    for base in range(0, n // 32, tile):
        dead = set(range(len(cross)))
        xs = out[..., base : base + tile].copy()
        ring = [None] * slots
        for c in range(min(slots, len(cross))):
            if live(c, base):
                ring[c % slots] = slab(c, base)
        c, s = 0, 0
        while s < len(stages):
            if stages[s].d < 32:
                run = []
                while s < len(stages) and len(run) < max_sweep and stages[s].d < 32:
                    run.append(stages[s])
                    s += 1
                m = np.stack([inword(st, base) for st in run])
                for j, st in enumerate(run):
                    t = (xs ^ (xs >> np.uint32(st.d))) & m[j]
                    xs ^= t ^ (t << np.uint32(st.d))
                continue
            if live(c, base):  # else all its masks are zero here: skipped
                st, m = stages[s], ring[c % slots]
                dw = st.d >> 5
                p = np.arange(tile // 2)
                w = ((p & ~(dw - 1)) << 1) | (p & (dw - 1))
                a, b = xs[..., w], xs[..., w + dw]
                t = (a ^ b) & m[p if st.compact else w]
                xs[..., w], xs[..., w + dw] = a ^ t, b ^ t
                dead.discard(c)
            if c + slots < len(cross) and live(c + slots, base):
                ring[(c + slots) % slots] = slab(c + slots, base)
            c += 1
            s += 1
        out[..., base : base + tile] = xs
        skipped += len(dead)
    return out, skipped


def test_constants_mirror_the_kernel_source():
    assert K.OUTER_MAX_STAGES == _cu_constant("kMaxOuterStages")
    assert K.OUTER_MAX_WORDS == _cu_constant("kOuterWords")
    # The largest tile, the stage tables, the barriers and two ring slots of
    # one tile each fit one block's shared memory.
    fixed = _cu_constant("kTableSmem") + _cu_constant("kBarBytes") + 4 * K.MAX_TILE_WORDS
    assert fixed + 2 * 4 * K.MAX_TILE_WORDS <= _cu_constant("kSmemLimit")
    assert _cu_constant("kMaxRing") >= 2


@pytest.mark.parametrize("scale", SCALES)
def test_outer_plan_and_tiles_on_layouts(scale):
    for _, _, table, n in _networks(scale):
        pre, local, suf, tile = K.split_passes(table, n)
        assert tile == K.tile_words_for(n)
        assert len(pre) == len(suf)
        assert all(table[i].d >= 32 * tile for i in pre + suf)
        assert all(table[i].d < 32 * tile for i in local)
        runs = _check_plan(table, pre, n) + _check_plan(table, suf, n)
        # One launch per side at these sizes, over the target number of
        # units or as many as rows of OUTER_MIN_ROW_WORDS give.
        assert len(runs) == 2 * bool(pre)
        for r in runs:
            assert r.units >= min(K.OUTER_TARGET_UNITS, (n // 32) // (K.OUTER_MIN_ROW_WORDS << r.k))


@pytest.mark.parametrize("log_n", range(13, 29))
def test_outer_plan_on_stage_tables(log_n):
    n = 1 << log_n
    table = _table_for(n)
    pre, local, suf, tile = K.split_passes(table, n)
    nw = n // 32
    assert tile == min(nw, max(K.MIN_TILE_WORDS, min(K.MAX_TILE_WORDS, nw // 128)))
    pre_runs = _check_plan(table, pre, n)
    suf_runs = _check_plan(table, suf, n)
    assert len(pre_runs) == len(suf_runs) == -(-len(pre) // K.OUTER_MAX_STAGES)
    # Prefix bits descend, suffix bits ascend, as the network orders them.
    assert [table[i].d for i in pre] == sorted((table[i].d for i in pre), reverse=True)
    assert [table[i].d for i in suf] == sorted(table[i].d for i in suf)


def test_outer_geometry_refuses_what_the_kernel_cannot_run():
    n = 1 << 20
    with pytest.raises(ValueError):
        K.outer_geometry((16,), n)  # inside a word
    with pytest.raises(ValueError):
        K.outer_geometry((1 << 12, 1 << 14), n)  # bits not consecutive
    with pytest.raises(ValueError):
        K.outer_geometry((1 << 12, 1 << 12), n)  # a bit twice
    with pytest.raises(ValueError):
        K.outer_geometry(tuple(32 << b for b in range(K.OUTER_MAX_STAGES + 1)), 1 << 30)


@pytest.mark.parametrize("scale,tile", [
    (14, None), (16, None), (16, 64), (16, 8), (14, 4), (16, 2),
])
def test_outer_pass_model_matches_plain(scale, tile):
    """Prefix and suffix through the model's walk over units against the plain
    stages; tile 8 at scale 16 gives 12 outer stages per side, two runs;
    tiles of 4 and 2 words give rows narrower than 8 words."""
    rng = np.random.default_rng(scale)
    for name, masks, table, n in _networks(scale):
        pre, local, suf, t = K.split_passes(table, n, tile)
        if not pre:
            continue
        x = _words(rng, n // 32)
        mt = _t(masks)
        for side in (pre, suf):
            runs = _check_plan(table, side, n)
            got = x
            for r in runs:
                got = model_outer_pass(got, masks, table, r, n)
            want = _u(R.apply_benes_std(_t(x), mt, tuple(table[i] for i in side), n))
            np.testing.assert_array_equal(got, want, err_msg=f"{name} tile {t}")
        if tile == 8:
            assert len(K.outer_plan(table, pre, n)) == 2


@pytest.mark.parametrize("max_words", [1024, 2048, 4096])
def test_outer_geometry_under_other_unit_caps(max_words):
    """``outer_geometry``'s unit cap (the kernel's ``kOuterWords``, which a
    tuning build may change): each side's units stay within it, partition
    the words, and the model's walk over them still equals the plain
    stages."""
    rng = np.random.default_rng(max_words)
    for name, masks, table, n in _networks(16):
        pre, _, suf, _ = K.split_passes(table, n, 8)
        x = _words(rng, n // 32)
        for side in (pre, suf):
            got = x
            for i in range(0, len(side), K.OUTER_MAX_STAGES):
                stages = tuple(side[i : i + K.OUTER_MAX_STAGES])
                run = K.OuterRun(stages, *K.outer_geometry(
                    tuple(table[j].d for j in stages), n, max_words))
                assert run.row_words << run.k <= max_words
                words = np.sort(_unit_words(run, n // 32).ravel())
                np.testing.assert_array_equal(words, np.arange(n // 32))
                got = model_outer_pass(got, masks, table, run, n)
            want = _u(R.apply_benes_std(_t(x), _t(masks), tuple(table[i] for i in side), n))
            np.testing.assert_array_equal(got, want, err_msg=f"{name} cap {max_words}")


@pytest.mark.parametrize("const", ["kMaxOuterStages", "kOuterWords", "kMaxRing", "kMaxSweep",
                                   "kLocalGroup", "kOuterGroup", "kOuterGroupBlocks",
                                   "kBatchTrees", "kRowminGroup", "kRowBatch"])
def test_cuda_build_reads_the_source_constants(const):
    from bfs_tpu_torch.utils import cuda_build

    assert cuda_build.constant(K.SOURCES["relay_kernels"], const) == _cu_constant(const)


@pytest.mark.parametrize("tile_rows", [8, 16])
def test_outer_pass_model_matches_pallas_passes(tile_rows):
    """The whole network — model prefix, plain local run, model suffix —
    against ``apply_benes_fused`` (K1/K2 in interpret mode) at a tile that
    forces outer stages."""
    rng = np.random.default_rng(5)
    n = 1 << 17
    perm = rng.permutation(n).astype(np.int64)
    masks, table = j_relay._compact_and_table(j_benes.route_std(perm), n)
    ps = JP.pass_static(table, n, tile_rows=tile_rows)
    arrays = [jnp.asarray(a) for a in JP.prepare_pass_masks(masks, table, n, tile_rows=tile_rows)]
    x = _words(rng, n // 32)
    want = np.asarray(JP.apply_benes_fused(jnp.asarray(x), arrays, ps, n, interpret=True))
    pre, local, suf, tile = K.split_passes(table, n, tile_rows * 128)
    assert pre and suf
    y = x
    for r in K.outer_plan(table, pre, n):
        y = model_outer_pass(y, masks, table, r, n)
    y = _u(R.apply_benes_std(_t(y), _t(masks), tuple(table[i] for i in local), n))
    for r in K.outer_plan(table, suf, n):
        y = model_outer_pass(y, masks, table, r, n)
    np.testing.assert_array_equal(y, want)


@pytest.mark.parametrize("scale,tile,slots", [
    (12, None, 2), (14, None, 8), (16, None, 1), (16, 64, 2), (16, 8, 3),
])
def test_local_pass_model_matches_plain(scale, tile, slots):
    """The ring of slabs, the sweeps and the skipped stages, per tile,
    against the plain local run (both networks)."""
    rng = np.random.default_rng(100 + scale)
    max_sweep = _cu_constant("kMaxSweep")
    skips = {}
    for name, masks, table, n in _networks(scale):
        pre, local, suf, t = K.split_passes(table, n, tile)
        stages = tuple(table[i] for i in local)
        x = _words(rng, n // 32)
        got, skipped = model_local_pass(x, masks, stages, n, t, slots, max_sweep)
        want = _u(R.apply_benes_std(_t(x), _t(masks), stages, n))
        np.testing.assert_array_equal(got, want, err_msg=f"{name} tile {t}")
        skips[name] = skipped
    # The vperm's dummy out-positions route zeros: at scale 16 (two or more
    # tiles) some of its tiles skip stages.
    if scale == 16:
        assert skips["vperm"] > 0


@pytest.mark.parametrize("scale,trees,group,tile", [
    (12, 3, 4, None), (14, 5, 4, None), (16, 17, 4, 64), (16, 6, 2, 8), (14, 4, 1, None),
])
def test_local_group_model_matches_plain(scale, trees, group, tile):
    """``benes_local_group``'s walk: per tile, each group of at most
    ``group`` trees under one ring of slabs, every slab and every sweep's
    mask words applied to all the group's tiles, against the plain local
    run on ``[S, n/32]`` words (both networks)."""
    rng = np.random.default_rng(300 + scale + trees)
    max_sweep = _cu_constant("kMaxSweep")
    for name, masks, table, n in _networks(scale):
        tile_words = K.batch_tile_words(n) if tile is None else tile
        _, local, _, t = K.split_passes(table, n, tile_words)
        stages = tuple(table[i] for i in local)
        x = _words(rng, trees * (n // 32)).reshape(trees, -1)
        got = np.empty_like(x)
        for t0 in range(0, trees, group):
            got[t0 : t0 + group] = model_local_pass(x[t0 : t0 + group], masks, stages, n, t, 2,
                                                    max_sweep)[0]
        want = _u(R.apply_benes_std(_t(x), _t(masks), stages, n))
        np.testing.assert_array_equal(got, want, err_msg=f"{name} tile {t}")


def _check_batch_split(table, n):
    """The batch's split at :func:`~relay_cuda.batch_tile_words`: prefix,
    local run and suffix partition the table in order; every local stage
    has d < 32 * tile, every outer stage d >= 32 * tile; each side's runs
    are at most OUTER_MAX_STAGES consecutive bits (``_check_plan``)."""
    tile = K.batch_tile_words(n)
    assert tile == min(K.tile_words_for(n), K.BATCH_TILE_WORDS)
    pre, local, suf, t = K.split_passes(table, n, tile)
    assert t == tile and pre + local + suf == tuple(range(len(table)))
    assert all(table[i].d < 32 * tile for i in local)
    assert all(table[i].d >= 32 * tile for i in pre + suf)
    return _check_plan(table, pre, n) + _check_plan(table, suf, n), tile


@pytest.mark.parametrize("log_n", range(13, 29))
def test_batch_split_on_stage_tables(log_n):
    """Up to 2^18-word batch tiles' nets: one outer launch a side while a
    side has at most OUTER_MAX_STAGES stages (the s22 net's 2^26 at a tile
    of 8,192 words: 8 a side), two beyond."""
    n = 1 << log_n
    table = _table_for(n)
    runs, tile = _check_batch_split(table, n)
    side = sum(1 for st in table if st.d >= 32 * tile) // 2
    assert len(runs) == 2 * -(-side // K.OUTER_MAX_STAGES)
    if log_n == 26:
        assert (tile, side, len(runs)) == (8192, 8, 2)


@pytest.mark.parametrize("scale", SCALES)
def test_batch_split_on_layouts(scale):
    for _, _, table, n in _networks(scale):
        _check_batch_split(table, n)


@pytest.mark.parametrize("scale", [12, 16])
def test_inword_sweep_matches_stages_one_at_a_time(scale):
    """The in-word run (16, 8, 4, 2, 1, 2, 4, 8, 16) of each network: each
    word's nine mask words gathered at once and the nine stages applied to
    it in registers, against the same stages applied one at a time."""
    rng = np.random.default_rng(200 + scale)
    for name, masks, table, n in _networks(scale):
        idx = [i for i, st in enumerate(table) if st.d < 32]
        assert [table[i].d for i in idx] == [16, 8, 4, 2, 1, 2, 4, 8, 16]
        assert idx == list(range(idx[0], idx[0] + 9))
        nw = n // 32
        x = _words(rng, nw)
        m = masks[np.array([table[i].offset for i in idx])[:, None] + np.arange(nw)]
        got = x.copy()
        for j, i in enumerate(idx):
            d = np.uint32(table[i].d)
            t = (got ^ (got >> d)) & m[j]
            got ^= t ^ (t << d)
        want = _t(x)
        for i in idx:
            want = R.apply_benes_std(want, _t(masks), (table[i],), n)
        np.testing.assert_array_equal(got, _u(want), err_msg=name)
