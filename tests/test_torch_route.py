"""The multi-source route as one gather, and the row-min work table, against
the JAX reference.

``RelayEngine.route_index`` composes the vperm network, ``broadcast_l2_elem``
and the net network into one int32 index; ``route_gather`` over it must give
what ``bfs_tpu.ops.relay_elem``'s networks and broadcast give, bit for bit.
``rowmin_items`` is the work table of the card's ``class_rowmin``: its
blocks, warps and chunks of rows must cover every (class, column word, row)
exactly once.  ``rowmin_ranks`` (the kernel's plain version) is held
against ``bfs_tpu.ops.relay.rowmin_ranks`` and the Pallas tournament in
interpret mode on synthetic classes as wide as the scale-22 layout's.  The
card's kernels are held against these plain versions in
``test_torch_cuda.py``.

All comparisons are exact (tolerance 0): everything here is integer bit
arithmetic.  Inputs are made with NumPy from a seed; frontier elements set
bit 31 (tree 31 of a group, the sign bit of an int32) on purpose."""

import numpy as np
import pytest
import torch

import bfs_tpu_torch as P
from bfs_tpu_torch.graph import relay as p_relay
from bfs_tpu_torch.ops import relay as R
from bfs_tpu_torch.ops import relay_cuda as K
from bfs_tpu_torch.ops import relay_elem as RE

import jax.numpy as jnp

from bfs_tpu.graph import benes as j_benes
from bfs_tpu.graph import relay as j_relay
from bfs_tpu.graph.csr import Graph as JGraph
from bfs_tpu.ops import relay as JR
from bfs_tpu.ops import relay_elem as JRE
from bfs_tpu.ops import relay_pallas as JP

pytestmark = pytest.mark.skipif(
    not j_benes.native_available(), reason="native benes router unavailable"
)


def _t(a: np.ndarray) -> torch.Tensor:
    """uint32 array -> the port's int32 bit-pattern tensor."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


def _u(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _elems(rng, shape) -> np.ndarray:
    """Random uint32 elements with all-ones, bit-31-only and zero elements
    mixed in."""
    x = rng.integers(0, 2**32, shape, dtype=np.uint32)
    x[rng.random(shape) < 0.05] = 0xFFFFFFFF
    x[rng.random(shape) < 0.05] = np.uint32(1 << 31)
    x[rng.random(shape) < 0.2] = 0
    return x


@pytest.fixture(scope="module", params=["rmat8", "rmat10"])
def layout(request):
    """An R-MAT layout (rank-major and vertex-major classes), built by the
    reference and converted into the port."""
    scale = {"rmat8": 8, "rmat10": 10}[request.param]
    g = P.rmat_graph(scale, 8, seed=3)
    jg = JGraph(g.num_vertices, g.src.copy(), g.dst.copy())
    return P.from_reference_layout(j_relay.relay_to_arrays(j_relay.build_relay_graph(jg)))


# ------------------------------------------------------------------ route --

def _jax_route(rg, frontier: np.ndarray) -> np.ndarray:
    """The reference's route: zero-pad, vperm network, broadcast, net."""
    fw = np.zeros((frontier.shape[0], rg.vperm_size), np.uint32)
    fw[:, : rg.vr] = frontier
    y = JRE.apply_benes_elem(jnp.asarray(fw), jnp.asarray(rg.vperm_masks),
                             rg.vperm_table, rg.vperm_size)
    l2 = JRE.broadcast_l2_elem(y, rg.out_classes, rg.net_size)
    return np.asarray(JRE.apply_benes_elem(l2, jnp.asarray(rg.net_masks),
                                           rg.net_table, rg.net_size))


@pytest.mark.parametrize("groups", [1, 2])
def test_route_index_and_gather_match_jax_route(layout, groups):
    rg = layout
    eng = P.RelayEngine(rg, device="cpu")
    K.reset_launches()
    src = eng.route_index()
    assert src.dtype == torch.int32 and tuple(src.shape) == (rg.net_size,)
    assert int(src.min()) >= -1 and int(src.max()) < rg.vr
    assert (src >= 0).any() and (src == -1).any()
    assert eng.route_index() is src  # built once, kept
    rng = np.random.default_rng(groups)
    frontiers = {
        "random": _elems(rng, (groups, rg.vr)),
        "zeros": np.zeros((groups, rg.vr), np.uint32),
        "ones": np.full((groups, rg.vr), 0xFFFFFFFF, np.uint32),
    }
    assert (frontiers["random"] >> 31).any(axis=1).all()
    for name, f in frontiers.items():
        want = _jax_route(rg, f)
        np.testing.assert_array_equal(_u(RE.route_gather(_t(f), src)), want, name)
        np.testing.assert_array_equal(_u(K.elem_route_gather(_t(f), src)), want, name)
        np.testing.assert_array_equal(_u(eng.routed_elem(_t(f))), want, name)
    # All ones lands exactly on the slots the route feeds.
    np.testing.assert_array_equal(
        _u(RE.route_gather(_t(frontiers["ones"]), src))[0] != 0, (src >= 0).numpy()
    )
    assert all(v == 0 for v in K.LAUNCHES.values())  # CPU tensors: plain versions


@pytest.mark.parametrize("groups", [2, 4])
def test_interleaved_frontier_matches_jax_route(layout, groups):
    """The frontier interleaved as int32[vr, G] (the layout the card's
    gather reads for G = 2 and 4) holds every group's element of a vertex
    side by side, and gathering its columns gives the reference's route."""
    rg = layout
    eng = P.RelayEngine(rg, device="cpu")
    src = eng.route_index()
    f = _elems(np.random.default_rng(10 + groups), (groups, rg.vr))
    ft = K.elem_frontier_interleave(_t(f))
    assert tuple(ft.shape) == (rg.vr, groups) and ft.is_contiguous()
    np.testing.assert_array_equal(_u(ft), f.T)
    np.testing.assert_array_equal(_u(RE.route_gather(ft.t(), src)), _jax_route(rg, f))
    np.testing.assert_array_equal(_u(K.elem_route_gather(_t(f), src, frontier_t=ft)),
                                  _jax_route(rg, f))


def test_superstep_elem_uses_the_route_gather(layout):
    """One engine superstep (gather + row-min/update, plain on the CPU)
    equals the reference's superstep through the networks."""
    rg = layout
    src = np.random.default_rng(5).choice(rg.num_vertices, 64, replace=False)
    _, pt = RE.rank_plane_layout(rg.in_classes)
    st = RE.init_elem_state(rg.vr, rg.old2new[src].reshape(2, 32), pt)
    eng = P.RelayEngine(rg, device="cpu")
    offsets, _ = RE.rank_plane_layout(rg.in_classes)
    valid = j_relay.valid_slot_words(rg.src_l1, rg.net_size)
    want = RE.elem_superstep(
        RE.ElemState(*(t.clone() for t in st[:4]), 0, None),
        vperm_masks=_t(rg.vperm_masks), vperm_table=rg.vperm_table,
        vperm_size=rg.vperm_size, out_classes=rg.out_classes,
        net_masks=_t(rg.net_masks), net_table=rg.net_table, net_size=rg.net_size,
        in_classes=rg.in_classes, valid_words=_t(valid), vr=rg.vr,
        plane_offsets=offsets, pt=pt,
    )
    got = eng.superstep_elem(st)
    for name in ("visited", "frontier", "dist_planes", "rank_planes"):
        np.testing.assert_array_equal(_u(getattr(got, name)), _u(getattr(want, name)), name)
    assert got.level == want.level == 1


# --------------------------------------------------------- row-min table --

def _synthetic_classes(tail: int = 64):
    """Rank-major widths 1, 3, 48 and 1,536 (2,048 vertices each; the
    scale-22 layout's widest rank-major class is 1,536), then vertex-major
    widths 64 and 1,000 (a warp per vertex) and 4,096 and 131,072 (a block
    per vertex, rows not 16-byte aligned), and a sentinel tail:
    ``(classes, vr, slot words)``."""
    widths = np.array([1, 3, 48, 1536, 64, 1000, 4096, 131072])
    counts = np.array([2048, 2048, 2048, 2048, 3, 5, 2, 1])
    classes = tuple(p_relay._build_classes(widths, counts))
    nwords = -(-classes[-1].sb // 128) * 4
    return classes, classes[-1].vb + tail, nwords


def _slot_words(rng, nwords: int, density: float):
    """(l1, valid) uint32 words: l1 bits set with ``density``; valid mostly
    ones with some cleared bits (stray routed bits must not win)."""
    l1 = np.packbits(rng.random(32 * nwords) < density, bitorder="little").view(np.uint32)
    valid = np.packbits(rng.random(32 * nwords) < 0.97, bitorder="little").view(np.uint32)
    return l1, valid


def _coverage(table, total_blocks: int, in_classes, vr: int) -> None:
    """Replay the kernel's block/warp/thread geometry over the table: every
    (rank-major class, column word, row) once, every vertex-major vertex
    and tail vertex once, the vertex space [0, vr) once; the rows of the
    longest chains first."""
    rows = table.tolist()
    depths = [K.rowmin_depth(r) for r in rows]
    assert depths == sorted(depths, reverse=True)
    by_va = {c.va: c for c in in_classes}
    written = np.zeros(vr, np.int64)
    for n, (kind, va, count, sa_word, width, chunks, per, block0) in enumerate(rows):
        nblocks = (rows[n + 1][7] if n + 1 < len(rows) else total_blocks) - block0
        if kind == 2:
            written[va : va + count] += 1
            assert nblocks == -(-count // K.ROWMIN_THREADS)
            continue
        cs = by_va[va]
        assert (count, sa_word, width) == (cs.count, cs.sa // 32, cs.width)
        if kind == 3:
            assert cs.vertex_major and cs.width >= K.CLASS_WIDE_BITS and nblocks == count
            written[va : va + count] += 1
        elif kind == 1:
            assert cs.vertex_major and cs.width < K.CLASS_WIDE_BITS
            p = np.arange(nblocks * K.ROWMIN_WARPS)
            written[va + p[p < count]] += 1
            assert (p >= count).sum() < K.ROWMIN_WARPS
        else:
            assert kind == 0 and not cs.vertex_major
            assert va % 32 == 0 and count % 32 == 0  # the writer's 16-byte quads
            assert chunks & (chunks - 1) == 0 and chunks <= K.CLASS_MAX_CHUNKS
            assert per == -(-width // chunks)  # trailing chunks may be empty
            # No chunk over CLASS_CHUNK_ROWS rows unless the chunks are at
            # their most, and no more chunks than that needs.
            assert per <= K.CLASS_CHUNK_ROWS or chunks == K.CLASS_MAX_CHUNKS
            if chunks > 1:
                assert -(-width // (chunks // 2)) > K.CLASS_CHUNK_ROWS
            cw, words = count // 32, K.ROWMIN_THREADS // chunks  # words a block
            assert words >= 8  # a warp reads whole 32-byte sectors of a row
            hits = np.zeros((width, cw), np.int64)
            for b in range(nblocks):
                for t in range(K.ROWMIN_THREADS):
                    j, chunk = b * words + t % words, t // words
                    if j < cw:
                        hits[chunk * per : (chunk + 1) * per, j] += 1
            assert (hits == 1).all(), f"class va={va}: slots covered {np.unique(hits)}"
            assert nblocks * words - cw < words  # no block without a word
            written[va : va + count] += 1
    assert (written == 1).all()


def _check_items(classes, vr: int) -> None:
    table, blocks, vertex_major, planes = K.rowmin_items(tuple(classes), vr, "cpu")
    assert vertex_major == any(c.vertex_major for c in classes)
    # The kernel stages a rank within a chunk in `planes` bit planes: enough
    # for the longest chunk, and no more.
    per = [r[6] for r in table.tolist() if r[0] == 0]
    assert all(p <= 1 << planes for p in per)
    assert planes == 0 or max(per) > 1 << (planes - 1)
    _coverage(table, blocks, classes, vr)


def test_rowmin_items_cover_every_slot_once_synthetic():
    classes, vr, _ = _synthetic_classes()
    assert {c.width for c in classes if not c.vertex_major} == {1, 3, 48, 1536}
    _check_items(classes, vr)


def test_rowmin_items_cover_every_slot_once_layout(layout):
    _check_items(layout.in_classes, layout.vr)


def test_class_rowmin_threads_mirror_the_source():
    """The work table's block geometry (column words and warps a block)
    is the kernel's: ROWMIN_THREADS threads a block."""
    from bfs_tpu_torch.utils import cuda_build

    assert cuda_build.constant(K.SOURCES["relay_kernels"], "kThreads") == K.ROWMIN_THREADS


@pytest.mark.parametrize("width", [1, 3, 32, 33, 48, 256, 257, 1536, 4096])
def test_rowmin_chunks(width):
    chunks, per = K.rowmin_chunks(width)
    assert chunks in (1, 2, 4, 8) and chunks * per >= width > (chunks - 1) * per
    assert per <= K.ROWMIN_CHUNK_ROWS or chunks == K.ROWMIN_WARPS
    if chunks > 1:
        assert -(-width // (chunks // 2)) > K.ROWMIN_CHUNK_ROWS  # no more chunks than needed


@pytest.mark.parametrize("width", [1, 3, 16, 17, 33, 48, 129, 256, 257, 513, 1536, 4096])
def test_class_rowmin_chunks(width):
    """``class_rowmin``'s split: chunks a power of two up to
    ``CLASS_MAX_CHUNKS``, none over ``CLASS_CHUNK_ROWS`` rows unless the
    chunks are at their most, and no more chunks than that needs."""
    rows, most = K.CLASS_CHUNK_ROWS, K.CLASS_MAX_CHUNKS
    chunks, per = K.rowmin_chunks(width, rows, most)
    assert chunks & (chunks - 1) == 0 and chunks <= most
    assert per == -(-width // chunks)  # trailing chunks may be empty (129 rows in 16)
    assert per <= rows or chunks == most
    if chunks > 1:
        assert -(-width // (chunks // 2)) > rows


@pytest.mark.parametrize("density", [0.0, 1e-4, 0.01, 0.5, 1.0])
def test_rowmin_ranks_wide_classes_match_jax_and_pallas(density):
    classes, vr, nwords = _synthetic_classes()
    l1, valid = _slot_words(np.random.default_rng(int(density * 1e4)), nwords, density)
    ours = _u(R.rowmin_ranks(_t(l1), _t(valid), classes, vr))
    jl1, jv = jnp.asarray(l1), jnp.asarray(valid)
    np.testing.assert_array_equal(ours, np.asarray(JR.rowmin_ranks(jl1, jv, classes, vr)))
    assert any(JP.rowmin_class_ok(c) for c in classes)
    np.testing.assert_array_equal(
        ours, np.asarray(JP.rowmin_ranks_pallas(jl1, jv, classes, vr, interpret=True))
    )
    np.testing.assert_array_equal(_u(K.rowmin_ranks(_t(l1), _t(valid), classes, vr)), ours)
    assert (ours[classes[-1].vb :] == 0xFFFFFFFF).all()
    if density == 0.0:
        assert (ours == 0xFFFFFFFF).all()
    if density == 1.0:  # every vertex's first valid row
        assert (ours[: classes[-1].vb] != 0xFFFFFFFF).any()


def _scanned_words(lw: np.ndarray, cs) -> np.ndarray:
    """The words a row-min stopping at first hits reads in class ``cs`` of
    one tree's slot words ``lw`` (uint32, ANDed with valid), walked row by
    row: per rank-major column word, the rows until each of its 32 bits is
    found (all rows where one never is); per vertex-major vertex, the words
    until its first set word (all where none)."""
    words = lw[cs.sa // 32 : cs.sb // 32]
    if cs.vertex_major:
        hit = words.reshape(cs.count, cs.width // 32) != 0
        return np.where(hit.any(1), hit.argmax(1) + 1, cs.width // 32)
    cw = cs.count // 32
    bits = np.unpackbits(words.reshape(cs.width, cw).view(np.uint8), bitorder="little")
    bits = bits.reshape(cs.width, cw, 32).astype(bool)
    out = np.empty(cw, np.int64)
    for j in range(cw):
        first = np.where(bits[:, j].any(0), bits[:, j].argmax(0), cs.width)
        out[j] = cs.width if (first == cs.width).any() else first.max() + 1
    return out


@pytest.mark.parametrize("trees", [1, 3])
def test_early_exit_words_match_a_row_by_row_walk(trees):
    """``early_exit_words``, read off the plain ranks, equals a walk of the
    slot words themselves, per tree and unit, with the trees' densities
    apart (0, 1e-3, 0.5); ``early_exit_bytes`` adds the valid words up to
    the furthest tree and the outputs, and on empty trees is the full read:
    every slot word of every tree and the valid words once, the ranks
    written."""
    classes, vr, nwords = _synthetic_classes()
    rng = np.random.default_rng(trees)
    densities = [0.0, 1e-3, 0.5][-trees:]
    l1, valid = zip(*(_slot_words(rng, nwords, d) for d in densities))
    valid = valid[0]
    ranks = R.rowmin_ranks(_t(np.stack(l1)), _t(valid), classes, vr)
    got = R.early_exit_words(ranks, classes)
    for s in range(trees):
        for cs in classes:
            np.testing.assert_array_equal(got[cs.va][s], _scanned_words(l1[s] & valid, cs))
    nbytes = R.early_exit_bytes(ranks, classes)
    assert nbytes == sum(4 * int(w.sum()) + 4 * int(w.max(0).sum()) for w in got.values()) \
        + 4 * trees * vr
    empty = R.rowmin_ranks(_t(np.zeros((trees, nwords), np.uint32)), _t(valid), classes, vr)
    class_words = sum((c.sb - c.sa) // 32 for c in classes)
    assert R.early_exit_bytes(empty, classes) == 4 * class_words * (1 + trees) + 4 * trees * vr
    one = classes[0].va
    assert R.early_exit_bytes(ranks, classes, [one]) == 4 * int(got[one].sum()) \
        + 4 * int(got[one].max(0).sum()) + 4 * trees * classes[0].count
