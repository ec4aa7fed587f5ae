"""The row split of the card's ``elem_rowmin_update`` and the sparse path of
``mxu_expand``, checked on the CPU.

``elem_rowmin_items`` is the work table of ``elem_rowmin_update``: its
blocks, warps and chunks of rows must cover every (class, vertex, row)
exactly once, with each vertex's chunks in ascending row order.  A NumPy
model of what the kernel does with it — each chunk walked from ``visited``
on its own, then the chunks combined in row order (a chunk owns the fresh
bits no earlier chunk found) — must equal the port's plain
``rowmin_elem`` and ``bfs_tpu.ops.relay_elem.rowmin_elem`` for every
chunk count, on synthetic classes as wide as the scale-22 layout's.  The
card's kernel is held against the plain version in ``test_torch_cuda.py``.

All comparisons are exact (tolerance 0): everything here is integer bit
arithmetic.  Inputs are made with NumPy from a seed; elements set bit 31
(tree 31 of a group, the sign bit of an int32) on purpose."""

import re

import numpy as np
import pytest
import torch

import bfs_tpu_torch as P
from bfs_tpu_torch.graph import adj_tiles as PT
from bfs_tpu_torch.graph import relay as p_relay
from bfs_tpu_torch.ops import relay as R
from bfs_tpu_torch.ops import relay_cuda as K
from bfs_tpu_torch.ops import relay_elem as RE
from bfs_tpu_torch.ops import relay_mxu as RM

import jax.numpy as jnp

from bfs_tpu.graph import relay as j_relay
from bfs_tpu.graph.csr import Graph as JGraph
from bfs_tpu.ops import relay_elem as JRE

ALL = np.uint32(0xFFFFFFFF)


def _t(a: np.ndarray) -> torch.Tensor:
    """uint32 array -> the port's int32 bit-pattern tensor."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


def _u(a) -> np.ndarray:
    """A torch or JAX int32/uint32 array -> uint32 NumPy array."""
    return (a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)).view(np.uint32)


def _synthetic_classes(tail: int = 40):
    """Rank-major widths 1, 3, 33, 256 and 1,536 (the scale-22 layout's
    widest rank-major class), vertex-major widths 33 (padded to 64), 256
    and 1,536 (a warp per vertex) and 4,096 and 8,192 (a block per
    vertex), and a tail of vertices in no class: ``(classes, vr)``."""
    widths = np.array([1, 3, 33, 256, 1536, 33, 256, 1536, 4096, 8192])
    counts = np.array([100, 64, 70, 300, 1600, 5, 3, 2, 2, 1])
    classes = tuple(p_relay._build_classes(widths, counts))
    assert [c.vertex_major for c in classes] == [False] * 5 + [True] * 5
    return classes, classes[-1].vb + tail


def _inputs(classes, vr: int, density: float, seed: int, groups: int = 2):
    """(l1, valid, visited) uint32 arrays: l1 bits set with ``density``
    plus all-ones and bit-31-only elements; valid mostly ones (stray routed
    bits must not win); visited random with all-visited and unvisited
    vertices mixed in."""
    rng = np.random.default_rng(seed)
    n = -(-classes[-1].sb // 128) * 128
    bits = rng.random((groups, n, 32)) < density
    l1 = np.packbits(bits, axis=-1, bitorder="little").view(np.uint32)[..., 0]
    l1[rng.random((groups, n)) < 0.01] = ALL
    l1[rng.random((groups, n)) < 0.01] = np.uint32(1 << 31)
    valid = np.packbits(rng.random(n) < 0.97, bitorder="little").view(np.uint32)
    visited = rng.integers(0, 2**32, (groups, vr), dtype=np.uint32)
    visited &= rng.integers(0, 2**32, (groups, vr), dtype=np.uint32)
    visited[rng.random((groups, vr)) < 0.2] = 0
    visited[rng.random((groups, vr)) < 0.1] = ALL
    return l1, valid, visited


def _class_rows(l1: np.ndarray, valid: np.ndarray, cs) -> np.ndarray:
    """uint32[G, width, count]: the class's slots, ANDed with valid, row r
    of vertex i at [:, r, i]."""
    g = l1.shape[0]
    sel = np.unpackbits(valid[cs.sa // 32 : cs.sb // 32].view(np.uint8), bitorder="little")
    seg = l1[:, cs.sa : cs.sb] & (np.uint32(0) - sel.astype(np.uint32))
    if not cs.vertex_major:
        return seg.reshape(g, cs.width, cs.count)
    return seg.reshape(g, cs.count, cs.width).transpose(0, 2, 1)


def _model(l1, valid, visited, classes, vr: int, split):
    """What ``elem_rowmin_update`` computes: per class, ``split(cs)``
    gives ``(chunks, rows per chunk)``; each chunk is walked in row order
    from ``visited`` (fresh bits x & ~found take the row's rank, then join
    found; the walk ends once every tree is found), then the chunks are
    combined in row order.  Returns ``(newly uint32[G, vr], {va: planes
    uint32[G, nb, count]})``, the planes masked by newly."""
    g = l1.shape[0]
    newly = np.zeros((g, vr), np.uint32)
    planes = {}
    offsets, _ = RE.rank_plane_layout(classes)
    for cs in classes:
        xv = _class_rows(l1, valid, cs)
        vis = visited[:, cs.va : cs.vb]
        nb = offsets[cs.va][1]
        chunks, per = split(cs)
        owned = np.zeros_like(vis)
        out = np.zeros((g, nb, cs.count), np.uint32)
        for c in range(chunks):
            found = vis.copy()
            pc = np.zeros((g, nb, cs.count), np.uint32)
            for r in range(c * per, min((c + 1) * per, cs.width)):
                if (found == ALL).all():
                    break
                fresh = xv[:, r] & ~found
                for j in range(nb):
                    if (r >> j) & 1:
                        pc[:, j] |= fresh
                found |= fresh
            fresh_c = found & ~vis
            out |= pc & (fresh_c & ~owned)[:, None, :]
            owned |= fresh_c
        newly[:, cs.va : cs.vb] = owned
        planes[cs.va] = out
    return newly, planes


def _masked_planes(rp: np.ndarray, newly: np.ndarray, classes) -> dict:
    """{va: uint32[G, nb, count]} of packed rank planes, masked by newly."""
    offsets, _ = RE.rank_plane_layout(classes)
    g = rp.shape[0]
    out = {}
    for cs in classes:
        off, nb = offsets[cs.va]
        pl = rp[:, off : off + nb * cs.count].reshape(g, nb, cs.count)
        out[cs.va] = pl & newly[:, None, cs.va : cs.vb]
    return out


@pytest.fixture(scope="module", params=[1e-3, 0.05, 0.5])
def case(request):
    """Synthetic classes, inputs at one l1 bit density, and the plain and
    reference row-mins as (newly, masked planes)."""
    classes, vr = _synthetic_classes()
    l1, valid, visited = _inputs(classes, vr, request.param, int(request.param * 1e4))
    offsets, pt = RE.rank_plane_layout(classes)
    found, rp = RE.rowmin_elem(_t(l1), _t(valid), classes, vr, offsets, pt)
    jfound, jrp = JRE.rowmin_elem(jnp.asarray(l1), jnp.asarray(valid), classes, vr, offsets, pt)
    wants = {}
    for name, (f, r) in (("plain", (_u(found), _u(rp))), ("reference", (_u(jfound), _u(jrp)))):
        newly = f & ~visited
        wants[name] = (newly, _masked_planes(r, newly, classes))
    np.testing.assert_array_equal(wants["plain"][0], wants["reference"][0])
    return classes, vr, l1, valid, visited, wants


def _check_model(case, split) -> None:
    classes, vr, l1, valid, visited, wants = case
    newly, planes = _model(l1, valid, visited, classes, vr, split)
    assert newly.any() or not l1.any()
    for name, (want_newly, want_planes) in wants.items():
        np.testing.assert_array_equal(newly, want_newly, name)
        for va, pl in planes.items():
            np.testing.assert_array_equal(pl, want_planes[va], f"{name}: class va={va}")


@pytest.mark.parametrize("chunks", [1, 2, 4, 8])
def test_chunked_walk_matches_plain_and_reference(case, chunks):
    _check_model(case, lambda cs: (chunks, -(-cs.width // chunks)))


def test_table_chunking_matches_plain_and_reference(case):
    """The model under the chunking the kernel's work table gives."""
    classes, vr = case[0], case[1]
    table, _ = K.elem_rowmin_items(classes, vr)
    split = {row[1]: (row[7], row[8]) for row in table.tolist() if row[0] != 2}
    _check_model(case, lambda cs: split[cs.va])


# -------------------------------------------------------------- the table --

def _coverage(table, total_blocks: int, in_classes, vr: int) -> dict:
    """Replay the kernel's block/warp/lane geometry over the table: every
    (class, vertex, row) once, each vertex's chunks in ascending row order
    as the staging order combines them, every vertex of [0, vr) written
    once.  Returns {va: (kind, chunks, rows per chunk)}."""
    rows = table.tolist()
    by_va = {c.va: c for c in in_classes}
    offsets, _ = RE.rank_plane_layout(in_classes)
    written = np.zeros(vr, np.int64)
    warps = K.ROWMIN_WARPS
    seen = {}
    for n, (kind, va, count, sa, width, off, nb, chunks, per, passes, block0) in enumerate(rows):
        nblocks = (rows[n + 1][10] if n + 1 < len(rows) else total_blocks) - block0
        if kind == 2:
            written[va : va + count] += 1
            assert nblocks == -(-count // K.ROWMIN_THREADS)
            continue
        cs = by_va[va]
        assert (count, sa, width) == (cs.count, cs.sa, cs.width)
        assert (off, nb) == offsets[va]
        seen[va] = (kind, chunks, per)
        assert passes == (K.ELEM_NARROW_PASSES if kind == 0 and chunks == 1 else 1)
        hits = np.zeros((width, count), np.int64)
        if kind == 1:
            assert cs.vertex_major and width < K.ROWMIN_WIDE_BITS and chunks == 1
            p = np.arange(nblocks * warps)
            hits[:, p[p < count]] += 1
            assert (p >= count).sum() < warps
        elif kind == 3:
            assert cs.vertex_major and width >= K.ROWMIN_WIDE_BITS
            assert chunks == warps and per % 32 == 0 and nblocks == count
            for w in range(warps):  # warp w's span; combined in warp order
                hits[w * per : (w + 1) * per, :] += 1
        else:
            assert kind == 0 and not cs.vertex_major
            assert warps % chunks == 0 and (chunks, per) == K.rowmin_chunks(width)
            spans = warps // chunks
            for b in range(nblocks):
                for p in range(passes):
                    for w in range(warps):  # the kernel's (span, chunk) of warp w
                        i = ((b * passes + p) * spans + w // chunks) * 32 + np.arange(32)
                        r0 = (w % chunks) * per
                        hits[r0 : r0 + per, i[i < count]] += 1
            # The combine of span s reads staging index (s * chunks + c) * 32
            # + lane for c = 0, 1, ...: warp s * chunks + c, whose rows start
            # at c * per, in ascending order.
            assert [((s * chunks + c) % chunks) * per for s in range(spans)
                    for c in range(chunks)] == [c * per for _ in range(spans) for c in range(chunks)]
            assert nblocks * passes * spans * 32 - count < passes * spans * 32  # no idle block
        assert (hits == 1).all(), f"class va={va}: rows covered {np.unique(hits)}"
        written[va : va + count] += 1
    assert (written == 1).all()
    return seen


def test_elem_rowmin_items_cover_every_row_once_synthetic():
    classes, vr = _synthetic_classes()
    table, blocks = K.elem_rowmin_items(classes, vr)
    seen = _coverage(table, blocks, classes, vr)
    assert [seen[c.va][0] for c in classes] == [0] * 5 + [1] * 3 + [3] * 2
    assert seen[classes[4].va][1:] == (8, 192)  # width 1,536: 8 chunks of 192 rows
    assert table.shape[0] <= K.ELEM_MAX_ITEMS


@pytest.mark.parametrize("scale", [8, 10])
def test_elem_rowmin_items_cover_every_row_once_layout(scale):
    g = P.rmat_graph(scale, 8, seed=3)
    jg = JGraph(g.num_vertices, g.src.copy(), g.dst.copy())
    rg = P.from_reference_layout(j_relay.relay_to_arrays(j_relay.build_relay_graph(jg)))
    table, blocks = K.elem_rowmin_items(tuple(rg.in_classes), rg.vr)
    _coverage(table, blocks, rg.in_classes, rg.vr)


# --------------------------------------------------- mxu_expand's two paths --

def test_elem_table_mirrors_the_kernel_source():
    src = open(K.SOURCES["relay_elem_kernels"]).read()
    assert int(re.search(r"constexpr int kMaxItems = (\d+);", src).group(1)) == K.ELEM_MAX_ITEMS


def test_sparse_threshold_mirrors_the_kernel_source():
    src = open(K.SOURCES["relay_mxu_kernels"]).read()
    assert int(re.search(r"constexpr int kSparseMaxBits = (\d+);", src).group(1)) == K.MXU_SPARSE_MAX_BITS
    assert int(re.search(r"constexpr int kWarps = (\d+);", src).group(1)) == K.MXU_WARPS
    assert int(re.search(r"constexpr int kBlocksPerSm = (\d+);", src).group(1)) == K.MXU_BLOCKS_PER_SM


@pytest.mark.parametrize("fr", [0.0, 0.3, 1.0])
def test_reachable_bits_counts_frontier_rows(fr):
    """``reachable_bits`` against a per-tile count in NumPy: the set bits
    of each live tile's frontier rows."""
    rng = np.random.default_rng(int(fr * 10))
    rows = cols = 3000
    src, dst = rng.integers(0, rows, 20000), rng.integers(0, cols, 20000)
    at = PT.build_adj_tiles_device(
        torch.from_numpy(src), torch.from_numpy(dst), rows=rows, cols=cols,
        keys2d=PT.keys_from_new2old(rng.permutation(rows), rows), device="cpu",
    )
    ops = RM.mxu_device_operands(at, "cpu")
    fbits = rng.random(-(-rows // 32) * 32) < fr
    fw = R.pack_std(torch.from_numpy(fbits))
    got = RM.reachable_bits(fw, ops, rows=rows, rtp=at.rtp, chunk=7).numpy()
    live = RM.live_tiles(fw, ops, rows=rows, rtp=at.rtp).numpy()
    fpad = np.zeros(at.rtp + 128, bool)
    fpad[: fbits.size] = fbits
    tiles = _u(at.tiles)
    want = [
        int(np.unpackbits(tiles[t][fpad[128 * rb : 128 * rb + 128]].view(np.uint8)).sum())
        for t, rb in zip(live, at.row_idx.numpy()[live])
    ]
    np.testing.assert_array_equal(got, np.asarray(want, np.int64))
    assert (got > 0).sum() == live.size or fr < 1.0
    if fr == 0.0:
        assert got.size == 0
