"""Relay layout v4: degree-class dense adjacency + Beneš-routed bit shuffle.

The port's copy of the single-shard host layout build of
``bfs_tpu.graph.relay``; its arrays are byte-identical to the reference's.

  * **src side (broadcast)** — vertices bucketed by OUT-degree class; a
    vertex's frontier bit is replicated to its out-edge slots.
  * **the shuffle** — per-edge bits move from src-grouped (L2) to
    dst-grouped (L1) slot order through a bit-packed Beneš network whose
    masks the native router computes once.
  * **dst side (reduce)** — vertices bucketed by IN-degree class and
    RELABELED so classes are contiguous; within a dst row slots ascend by
    ORIGINAL src id, so the min active slot is the canonical min-parent.

Standard packing everywhere (element ``e`` at word ``e >> 5``, bit
``e & 31``).  Stages with ``d >= COMPACT_MIN_D`` store only the words at
the lower index of each word pair (the others are structurally zero).
"""

from __future__ import annotations

import concurrent.futures
import logging
import os
import time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

from . import benes, native_gen
from .csr import INF_DIST, DeviceGraph, Graph, _sorted_by_dst, unpad_edges

logger = logging.getLogger(__name__)

#: Layout version of the reference this build reproduces.
LAYOUT_VERSION = 4

#: Stages with element distance >= COMPACT_MIN_D are pair-compacted.
COMPACT_MIN_D = 4096


class _phase:
    """Build-stage timer: logs ``layout phase <name> <seconds>`` at DEBUG on
    this module's logger and, given a ``times`` dict, adds the stage's
    seconds under ``name``."""

    def __init__(self, name: str, times: dict | None = None):
        self.name = name
        self.times = times

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.times is not None:
            self.times[self.name] = self.times.get(self.name, 0.0) + dt
        logger.debug("layout phase %-22s %.3fs", self.name, dt)


class StageSpec(NamedTuple):
    """Static per-stage metadata for a stored Beneš network.

    ``d``: element distance; ``offset``: word offset of the stage's masks
    in the flat array; ``nwords``: stored words (n/32 full, n/64 compact);
    ``compact``: pair-compacted storage; ``lo``/``hi``: the nonzero word
    range within the stored words.
    """

    d: int
    offset: int
    nwords: int
    compact: bool
    lo: int
    hi: int


@dataclass(frozen=True)
class ClassSlice:
    """One degree class: vertices/positions [va, vb) own slots [sa, sb).

    Rank-major ``slot = sa + r*count + p`` (count padded to 32);
    vertex-major ``slot = sa + p*width + r`` (width padded to 32), used
    for the few huge-width classes.
    """

    width: int
    va: int
    vb: int  # va + count
    sa: int
    sb: int
    real: int
    vertex_major: bool = False
    real_width: int = -1  # pre-padding width (== width for rank-major)

    @property
    def count(self) -> int:
        return self.vb - self.va


def _class_width(deg: np.ndarray) -> np.ndarray:
    """Degree-class width: degree rounded up to {2^k, 3*2^(k-1)}."""
    x = np.maximum(np.asarray(deg, dtype=np.int64), 1)
    p2 = np.int64(1) << np.int64(
        np.ceil(np.log2(x.astype(np.float64)))
    ).astype(np.int64)
    p2 = np.maximum(p2, 1)
    three_quarter = (p2 // 4) * 3
    return np.where((p2 >= 4) & (x <= three_quarter), three_quarter, p2)


def width_candidates(max_width: int = 1 << 31) -> np.ndarray:
    """Every value `_class_width` can produce, ascending: {2^k, 3*2^(k-1)}.
    ``candidates[searchsorted(candidates, degree)]`` is `_class_width` of
    the degree, in exact integer arithmetic (the device builder's form)."""
    out = [1, 2]
    k = 2
    while (1 << k) <= max_width:
        out.append(3 << (k - 2))
        out.append(1 << k)
        k += 1
    return np.array([c for c in out if c <= max_width], dtype=np.int64)


def ranked_placement(group: np.ndarray, base_by_group: np.ndarray) -> np.ndarray:
    """``pos[i] = base_by_group[group[i]] + rank``, rank being item ``i``'s
    stable rank within its group ordered by original index."""
    n = int(np.asarray(group).shape[0])
    order, rank = _sort_rank(
        np.asarray(group, dtype=np.int32), np.arange(n, dtype=np.int32)
    )
    out = np.empty(n, dtype=np.int64)
    out[order] = base_by_group[np.asarray(group)[order]] + rank
    return out


def _pow2_at_least(n: int) -> int:
    n = max(int(n), 32)
    return 1 << (n - 1).bit_length()


def _round32(x: int) -> int:
    return (int(x) + 31) & ~31


def _build_classes(widths: np.ndarray, counts: np.ndarray) -> list[ClassSlice]:
    """Aligned class slices from per-width real counts.  Vertex-major iff
    width >= max(count, 32); rank-major classes come first."""
    order = np.argsort(widths, kind="stable")
    rank_major = [
        (int(widths[i]), int(counts[i]))
        for i in order
        if not widths[i] >= max(counts[i], 32)
    ]
    vertex_major = [
        (int(widths[i]), int(counts[i]))
        for i in order
        if widths[i] >= max(counts[i], 32)
    ]
    slices: list[ClassSlice] = []
    va = 0
    sa = 0
    for w, c in rank_major:
        cp = _round32(c)
        slices.append(
            ClassSlice(width=w, va=va, vb=va + cp, sa=sa, sb=sa + w * cp,
                       real=c, vertex_major=False, real_width=w)
        )
        va += cp
        sa += w * cp
    for w, c in vertex_major:
        wp = _round32(w)
        slices.append(
            ClassSlice(width=wp, va=va, vb=va + c, sa=sa, sb=sa + wp * c,
                       real=c, vertex_major=True, real_width=w)
        )
        va += c
        sa += wp * c
    return slices


# Host helpers: the native fast path when the library is available, a
# NumPy path with identical output otherwise.

def _gather(table: np.ndarray, idx: np.ndarray) -> np.ndarray:
    if native_gen.native_available() and table.dtype == np.int32:
        return native_gen.gather_i32_native(table, idx)
    return table[idx]


def _scatter(out: np.ndarray, idx: np.ndarray, val: np.ndarray) -> None:
    if native_gen.native_available() and out.dtype == np.int32:
        native_gen.scatter_i32_native(out, idx, val)
        return
    out[idx] = val


def _slot_assign(base, stride, idx, rank) -> np.ndarray:
    if native_gen.native_available():
        return native_gen.slot_assign_native(base, stride, idx, rank)
    return (base[idx] + rank * stride[idx]).astype(np.int32)


def _rank_by_count(key: np.ndarray, nk: int) -> np.ndarray:
    """Stable rank within each key group."""
    if native_gen.native_available():
        return native_gen.rank_by_count_native(key, nk)
    order = np.argsort(key, kind="stable")
    ks = key[order]
    starts = np.flatnonzero(np.concatenate([[True], ks[1:] != ks[:-1]]))
    sor = starts[np.searchsorted(starts, np.arange(ks.shape[0]), side="right") - 1]
    rank = np.empty_like(order)
    rank[order] = (np.arange(ks.shape[0]) - sor).astype(np.int32)
    return rank.astype(np.int32)


def _mark_used(idx: np.ndarray, used: np.ndarray) -> None:
    """used[idx] = 1 on a uint8 array."""
    if native_gen.native_available():
        native_gen.mark_u8_native(idx, used)
        return
    used[np.asarray(idx)] = 1


def seg_csr(srcn, dstn, slotv, nk: int):
    """Sparse-path CSR: a counting sort grouped by ``srcn`` (relabeled src
    ids), ``(indptr int32[nk + 2], adj_dst, adj_slot)``, edges in a stable
    counting order."""
    if native_gen.native_available():
        return native_gen.csr_fill_native(srcn, dstn, slotv, nk)
    order = np.argsort(srcn, kind="stable")
    indptr = np.zeros(nk + 2, dtype=np.int64)
    np.cumsum(np.bincount(srcn, minlength=nk), out=indptr[1 : nk + 1])
    indptr[nk + 1] = indptr[nk]
    return (
        indptr.astype(np.int32),
        np.asarray(dstn)[order].astype(np.int32),
        np.asarray(slotv)[order].astype(np.int32),
    )


def _sort_rank(key_hi: np.ndarray, key_lo: np.ndarray):
    """(order, rank-within-hi-runs) sorted by (key_hi, key_lo)."""
    if native_gen.native_available():
        return native_gen.sort_rank_pairs_native(key_hi, key_lo)
    order = np.lexsort((key_lo, key_hi))
    hs = np.asarray(key_hi)[order]
    n = hs.shape[0]
    if n == 0:
        return order.astype(np.int32), np.zeros(0, np.int32)
    starts = np.flatnonzero(np.concatenate([[True], hs[1:] != hs[:-1]]))
    sor = starts[np.searchsorted(starts, np.arange(n), side="right") - 1]
    return order.astype(np.int32), (np.arange(n) - sor).astype(np.int32)


def _pad_identity(perm: np.ndarray, used: np.ndarray, n: int) -> None:
    """Complete a partial mapping to a bijection, identity-first: output j
    takes input j wherever both are free, the rest in order."""
    if (
        native_gen.native_available()
        and used.dtype == np.uint8
        and perm.dtype == np.int32
    ):
        native_gen.pad_identity_native(perm, used)
        return
    free_out = perm < 0
    unused = used == 0
    idx = np.flatnonzero(free_out & unused)
    perm[idx] = idx
    used[idx] = 1
    free_outputs = np.flatnonzero(perm < 0)
    free_inputs = np.flatnonzero(used == 0)
    if free_outputs.shape[0] != free_inputs.shape[0]:
        raise ValueError("partial permutation is not completable")
    perm[free_outputs] = free_inputs
    used[free_inputs] = 1


def _vertex_tables(classes, num_ids: int):
    """slot(id, r) = base[id] + r * stride[id]: rank-major base = sa + p,
    stride = count; vertex-major base = sa + p*width, stride = 1."""
    base = np.zeros(num_ids, dtype=np.int32)
    stride = np.ones(num_ids, dtype=np.int32)
    for cs in classes:
        p = np.arange(cs.count, dtype=np.int32)
        if cs.vertex_major:
            base[cs.va : cs.vb] = cs.sa + p * cs.width
            stride[cs.va : cs.vb] = 1
        else:
            base[cs.va : cs.vb] = cs.sa + p
            stride[cs.va : cs.vb] = cs.count
    return base, stride


def _compact_and_table(
    masks: np.ndarray, n: int
) -> tuple[np.ndarray, tuple[StageSpec, ...]]:
    """Pair-compact the router's masks and build the stage table (with each
    stage's nonzero word range)."""
    parts = []
    table = []
    offset = 0
    for s in range(masks.shape[0]):
        d = benes.stage_distance(n, s)
        w = masks[s]
        if d >= COMPACT_MIN_D:
            dw = d >> 5
            w = w.reshape(-1, 2, dw)[:, 0, :].reshape(-1)
        blocked = w.shape[0] % 1024 == 0
        nz = np.flatnonzero(w.reshape(-1, 1024).any(axis=1) if blocked else w)
        scale = 1024 if blocked else 1
        lo = int(nz[0]) * scale if nz.size else 0
        hi = int(nz[-1] + 1) * scale if nz.size else 0
        parts.append(w)
        table.append(
            StageSpec(d=d, offset=offset, nwords=int(w.shape[0]),
                      compact=d >= COMPACT_MIN_D, lo=lo, hi=hi)
        )
        offset += int(w.shape[0])
    return np.concatenate(parts), tuple(table)


@dataclass(frozen=True)
class RelayGraph:
    """Static relay layout v4 for one graph (single shard).

    Vertex-indexed engine state lives in the RELABELED id space of size
    ``vr`` (``new2old``/``old2new``; -1 at padding dummies); parent VALUES
    are L1 slot indices mapped to original src ids through ``src_l1``.
    """

    num_vertices: int
    num_edges: int
    vr: int  # padded relabeled vertex space (multiple of 32)
    new2old: np.ndarray  # int32[vr]; -1 at dummies
    old2new: np.ndarray  # int32[V]
    vperm_masks: np.ndarray  # uint32 flat
    vperm_table: tuple[StageSpec, ...]
    vperm_size: int
    out_classes: tuple[ClassSlice, ...]
    out_space: int
    net_masks: np.ndarray  # uint32 flat
    net_table: tuple[StageSpec, ...]
    net_size: int
    m1: int
    m2: int
    in_classes: tuple[ClassSlice, ...]
    src_l1: np.ndarray  # int32[m1]: ORIGINAL src id per L1 slot, INF padding
    # CSR over relabeled src ids (relabeled dst, L1 slot per edge); the
    # sparse superstep of the reference reads it.  Kept so the layout
    # round-trips with the reference's.
    adj_indptr: np.ndarray  # int32[vr + 2]
    adj_dst: np.ndarray  # int32[E]
    adj_slot: np.ndarray  # int32[E]


class LayoutMeta(NamedTuple):
    """Static layout sizes derived from the two degree histograms."""

    in_classes: tuple
    out_classes: tuple
    widths: np.ndarray
    counts: np.ndarray
    owidths: np.ndarray
    ocounts: np.ndarray
    vr: int
    m1: int
    m2: int
    out_vb: int
    n: int
    vp: int


def extract_edges(graph: Graph | DeviceGraph):
    """Host edge arrays shared by both builders: ``(src, dst, v, e)``; a
    DeviceGraph gives its real edges (sentinel padding dropped)."""
    if isinstance(graph, DeviceGraph):
        src, dst = unpad_edges(graph)
    else:
        src, dst = graph.src, graph.dst
    src = np.asarray(src).astype(np.int32)
    dst = np.asarray(dst).astype(np.int32)
    return src, dst, int(graph.num_vertices), int(src.shape[0])


def seg_degrees(src: np.ndarray, dst: np.ndarray, v: int):
    """Per-vertex in/out degree-class widths."""
    if native_gen.native_available():
        indeg = native_gen.bincount_i32_native(dst, v).astype(np.int64)
        outdeg = native_gen.bincount_i32_native(src, v).astype(np.int64)
    else:
        indeg = np.bincount(dst, minlength=v)
        outdeg = np.bincount(src, minlength=v)
    return _class_width(indeg), _class_width(outdeg)


def seg_classes_from_counts(
    widths: np.ndarray, counts: np.ndarray,
    owidths: np.ndarray, ocounts: np.ndarray, v: int,
) -> LayoutMeta:
    """Aligned classes and every derived static size from per-width
    counts: the one home of the sizing formulas, which the host builder
    reaches through `seg_classes` and the device builder through its
    degree histograms."""
    in_classes = _build_classes(widths, counts)
    vr = _round32(in_classes[-1].vb) if in_classes else 32
    m1 = in_classes[-1].sb if in_classes else 0
    out_classes = _build_classes(owidths, ocounts)
    out_vb = out_classes[-1].vb if out_classes else 0
    m2 = out_classes[-1].sb if out_classes else 0
    n = _pow2_at_least(max(m1, m2))
    dummies = out_vb - v
    vp = _pow2_at_least(max(vr + dummies, out_vb, 32 * 128 * 2))
    return LayoutMeta(
        in_classes=tuple(in_classes), out_classes=tuple(out_classes),
        widths=widths, counts=counts, owidths=owidths, ocounts=ocounts,
        vr=vr, m1=m1, m2=m2, out_vb=out_vb, n=n, vp=vp,
    )


def seg_classes(in_w: np.ndarray, out_w: np.ndarray, v: int) -> LayoutMeta:
    """Degree widths -> aligned classes + every derived static size."""
    widths, counts = np.unique(in_w, return_counts=True)
    owidths, ocounts = np.unique(out_w, return_counts=True)
    return seg_classes_from_counts(widths, counts, owidths, ocounts, v)


def _width_class_map(classes):
    """Map REAL (pre-padding) width -> its ClassSlice."""
    return {int(c.real_width): c for c in classes}


def seg_relabel(in_w: np.ndarray, out_w: np.ndarray, meta: LayoutMeta):
    """Class-major, old-id-minor relabeling (dst side) and out-order
    positions (src side)."""
    v = int(in_w.shape[0])
    in_map = _width_class_map(meta.in_classes)
    in_va = np.array([in_map[int(w)].va for w in meta.widths], dtype=np.int64)
    old2new = ranked_placement(
        np.searchsorted(meta.widths, in_w), in_va
    ).astype(np.int32)
    new2old = np.full(meta.vr, -1, dtype=np.int32)
    new2old[old2new] = np.arange(v, dtype=np.int32)
    out_map = _width_class_map(meta.out_classes)
    out_va = np.array([out_map[int(w)].va for w in meta.owidths], dtype=np.int64)
    outpos_of_old = ranked_placement(
        np.searchsorted(meta.owidths, out_w), out_va
    ).astype(np.int32)
    return new2old, old2new, outpos_of_old


def seg_l1_slots(src, dst, old2new, meta: LayoutMeta):
    """L1 slots: edges sorted by (dst_new, src); rank = in-row position
    (rank order == canonical min-parent)."""
    dstn = _gather(old2new, dst)
    order1, rank1 = _sort_rank(dstn, src)
    base1, stride1 = _vertex_tables(meta.in_classes, meta.vr)
    ds = _gather(dstn, order1)
    l1_sorted = _slot_assign(base1, stride1, ds, rank1)
    src_l1 = np.full(meta.m1, INF_DIST, dtype=np.int32)
    _scatter(src_l1, l1_sorted, _gather(src, order1))  # ORIGINAL ids
    l1_by_edge = np.empty(src.shape[0], dtype=np.int32)
    _scatter(l1_by_edge, order1, l1_sorted)
    return src_l1, l1_by_edge, dstn


def seg_l2_slots(src, outpos_of_old, meta: LayoutMeta):
    """L2 slots: edges grouped by src out-position; the within-row rank is
    free, so one counting pass assigns them in edge order."""
    srcpos = _gather(outpos_of_old, src)
    rank2 = _rank_by_count(srcpos, meta.out_classes[-1].vb)
    base2, stride2 = _vertex_tables(meta.out_classes, meta.out_classes[-1].vb)
    return _slot_assign(base2, stride2, srcpos, rank2)


def seg_net_assembly(l1_by_edge, l2_by_edge, meta: LayoutMeta):
    """Big network permutation: L1 slot <- L2 slot, identity-padded."""
    net = np.full(meta.n, -1, dtype=np.int32)
    _scatter(net, l1_by_edge, l2_by_edge)
    used = np.zeros(meta.n, dtype=np.uint8)
    _mark_used(l2_by_edge, used)
    _pad_identity(net, used, meta.n)
    return net


def seg_vperm_assembly(outpos_of_old, old2new, meta: LayoutMeta):
    """Small network permutation: vertex-space words -> out-order words.
    Dummy out positions are wired to the guaranteed-zero input region
    [vr, vp), which the engine re-zeroes every superstep."""
    vperm = np.full(meta.vp, -1, dtype=np.int32)
    real_mask = np.zeros(meta.out_vb, dtype=bool)
    real_mask[outpos_of_old] = True
    vperm[outpos_of_old] = old2new
    dummy_positions = np.flatnonzero(~real_mask)
    vperm[dummy_positions] = meta.vr + np.arange(dummy_positions.shape[0])
    used = np.zeros(meta.vp, dtype=np.uint8)
    _mark_used(vperm[vperm >= 0], used)
    _pad_identity(vperm, used, meta.vp)
    return vperm


def build_relay_graph(
    graph: Graph | DeviceGraph, *, stage_times: dict | None = None
) -> RelayGraph:
    """Build the full relay layout on the host, one stage after another
    (the oracle of :func:`~bfs_tpu_torch.graph.relay_device.build_relay_graph_device`).
    ``stage_times``, if given, gets each stage's wall seconds.  Requires
    the native Beneš router; raises RuntimeError when it is unavailable."""
    if not benes.native_available():
        raise RuntimeError("relay engine requires the native benes router")
    times = stage_times
    src, dst, v, e = extract_edges(graph)

    with _phase("degrees", times):
        in_w, out_w = seg_degrees(src, dst, v)
    with _phase("classes", times):
        meta = seg_classes(in_w, out_w, v)
    with _phase("relabel", times):
        new2old, old2new, outpos_of_old = seg_relabel(in_w, out_w, meta)
    with _phase("l1 slots", times):
        src_l1, l1_by_edge, dstn = seg_l1_slots(src, dst, old2new, meta)
    with _phase("l2 slots", times):
        l2_by_edge = seg_l2_slots(src, outpos_of_old, meta)
    with _phase("net perm assembly", times):
        net = seg_net_assembly(l1_by_edge, l2_by_edge, meta)
    with _phase("net route", times):
        net_masks_full = benes.route_std(net, trusted=True)
    with _phase("net compact", times):
        net_masks, net_table = _compact_and_table(net_masks_full, meta.n)
        del net_masks_full
    with _phase("vperm route", times):
        vperm = seg_vperm_assembly(outpos_of_old, old2new, meta)
        vperm_masks, vperm_table = _compact_and_table(
            benes.route_std(vperm, trusted=True), meta.vp
        )
    with _phase("sparse CSR", times):
        srcn = _gather(old2new, src)
        adj_indptr, adj_dst, adj_slot = seg_csr(srcn, dstn, l1_by_edge, meta.vr)

    return RelayGraph(
        num_vertices=v,
        num_edges=e,
        vr=meta.vr,
        new2old=new2old,
        old2new=old2new,
        vperm_masks=vperm_masks,
        vperm_table=vperm_table,
        vperm_size=meta.vp,
        out_classes=meta.out_classes,
        out_space=meta.out_vb,
        net_masks=net_masks,
        net_table=net_table,
        net_size=meta.n,
        m1=meta.m1,
        m2=meta.m2,
        in_classes=meta.in_classes,
        src_l1=src_l1,
        adj_indptr=adj_indptr.astype(np.int32),
        adj_dst=adj_dst,
        adj_slot=adj_slot,
    )


# Serialization: RelayGraph <-> flat numpy arrays, the same mapping as the
# reference's ``relay_to_arrays``.

def classes_to_rows(classes) -> np.ndarray:
    """Pack ClassSlice tuples into an int64[n, 8] row table."""
    return np.array(
        [
            [c.width, c.va, c.vb, c.sa, c.sb, c.real, int(c.vertex_major),
             c.real_width]
            for c in classes
        ],
        dtype=np.int64,
    ).reshape(-1, 8)


def rows_to_classes(rows: np.ndarray) -> tuple[ClassSlice, ...]:
    return tuple(
        ClassSlice(
            width=int(r[0]), va=int(r[1]), vb=int(r[2]), sa=int(r[3]),
            sb=int(r[4]), real=int(r[5]), vertex_major=bool(r[6]),
            real_width=int(r[7]),
        )
        for r in np.asarray(rows).tolist()
    )


def table_to_rows(table) -> np.ndarray:
    """Pack StageSpec tuples into an int64[n, 6] row table."""
    return np.array(
        [[t.d, t.offset, t.nwords, int(t.compact), t.lo, t.hi] for t in table],
        dtype=np.int64,
    ).reshape(-1, 6)


def rows_to_table(rows: np.ndarray) -> tuple[StageSpec, ...]:
    return tuple(
        StageSpec(
            d=int(r[0]), offset=int(r[1]), nwords=int(r[2]),
            compact=bool(r[3]), lo=int(r[4]), hi=int(r[5]),
        )
        for r in np.asarray(rows).tolist()
    )


LAYOUT_KEYS = (
    "num_vertices", "num_edges", "vr", "new2old", "old2new", "vperm_masks",
    "vperm_table", "vperm_size", "out_classes", "out_space", "net_masks",
    "net_table", "net_size", "m1", "m2", "in_classes", "src_l1",
    "adj_indptr", "adj_dst", "adj_slot",
)


def relay_to_arrays(rg: RelayGraph) -> dict[str, np.ndarray]:
    """Flatten a RelayGraph to name -> ndarray (scalars as 0-d arrays)."""
    return dict(
        num_vertices=np.int64(rg.num_vertices),
        num_edges=np.int64(rg.num_edges),
        vr=np.int64(rg.vr),
        new2old=rg.new2old,
        old2new=rg.old2new,
        vperm_masks=rg.vperm_masks,
        vperm_table=table_to_rows(rg.vperm_table),
        vperm_size=np.int64(rg.vperm_size),
        out_classes=classes_to_rows(rg.out_classes),
        out_space=np.int64(rg.out_space),
        net_masks=rg.net_masks,
        net_table=table_to_rows(rg.net_table),
        net_size=np.int64(rg.net_size),
        m1=np.int64(rg.m1),
        m2=np.int64(rg.m2),
        in_classes=classes_to_rows(rg.in_classes),
        src_l1=rg.src_l1,
        adj_indptr=rg.adj_indptr,
        adj_dst=rg.adj_dst,
        adj_slot=rg.adj_slot,
    )


def relay_from_arrays(z) -> RelayGraph:
    """Inverse of :func:`relay_to_arrays` for any mapping of name -> array."""
    return RelayGraph(
        num_vertices=int(z["num_vertices"]),
        num_edges=int(z["num_edges"]),
        vr=int(z["vr"]),
        new2old=np.asarray(z["new2old"], dtype=np.int32),
        old2new=np.asarray(z["old2new"], dtype=np.int32),
        vperm_masks=np.asarray(z["vperm_masks"], dtype=np.uint32),
        vperm_table=rows_to_table(z["vperm_table"]),
        vperm_size=int(z["vperm_size"]),
        out_classes=rows_to_classes(z["out_classes"]),
        out_space=int(z["out_space"]),
        net_masks=np.asarray(z["net_masks"], dtype=np.uint32),
        net_table=rows_to_table(z["net_table"]),
        net_size=int(z["net_size"]),
        m1=int(z["m1"]),
        m2=int(z["m2"]),
        in_classes=rows_to_classes(z["in_classes"]),
        src_l1=np.asarray(z["src_l1"], dtype=np.int32),
        adj_indptr=np.asarray(z["adj_indptr"], dtype=np.int32),
        adj_dst=np.asarray(z["adj_dst"], dtype=np.int32),
        adj_slot=np.asarray(z["adj_slot"], dtype=np.int32),
    )


#: The fields the Beneš router decides: two routers' layouts may differ in
#: these alone.
MASK_FIELDS = ("net_masks", "vperm_masks", "net_table", "vperm_table")


def differing_fields(want: RelayGraph, got: RelayGraph, skip=()) -> list[str]:
    """The fields of ``got`` whose dtype or bytes differ from ``want``'s,
    ``skip`` left out (``MASK_FIELDS`` for two routers' layouts)."""
    a, b = relay_to_arrays(want), relay_to_arrays(got)
    return [k for k in a if k not in skip and not (
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]))]


def from_reference_layout(arrays: dict[str, np.ndarray]) -> RelayGraph:
    """Take the dict the reference package's ``relay_to_arrays`` produces
    (the layout built by the JAX package) and return the port's
    :class:`RelayGraph` for it — the layout's weight converter."""
    missing = [k for k in LAYOUT_KEYS if k not in arrays]
    if missing:
        raise KeyError(f"reference layout lacks arrays {sorted(missing)}")
    return relay_from_arrays(arrays)


def valid_slot_words(src_l1: np.ndarray, net_size: int) -> np.ndarray:
    """Static valid-slot bitmask (standard packing): uint32[net_size/32],
    bit set iff that L1 slot holds a real edge.  Beneš pad routing may
    deliver stray 1-bits to padded slots; the row-min ANDs them out."""
    m1 = src_l1.shape[0]
    bits = np.zeros(net_size, dtype=bool)
    bits[:m1] = src_l1 != np.int32(INF_DIST)
    return np.packbits(
        bits.reshape(-1, 32), axis=1, bitorder="little"
    ).view(np.uint32).reshape(-1)


# --------------------------------------------------------------------------
# The mesh engine's layout: per-shard relay layouts of one shared shape.
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ShardedRelayGraph:
    """Per-shard relay layouts (v4) with ONE unified class structure: the
    mesh engine's layout (:mod:`bfs_tpu_torch.parallel.sharded`).

    Shard ``s`` owns a block of the globally relabeled vertex space,
    ``[s*block, (s+1)*block)``, and holds the relay pipeline of exactly
    its destinations: its own vperm network, out-degree broadcast, Beneš
    edge network and source tables.  Every shard has the SAME static
    shapes (class slices, network sizes, stage tables; masks stacked on
    axis 0), so one superstep program serves all of them.  Ownership is
    class-balanced: each in-degree class is dealt across the shards in
    equal contiguous chunks, so the shared shapes are about 1/n of the
    single-shard layout's.  The relabeling is shard-major, so the
    concatenated frontier words of the shards ARE the global frontier in
    vperm input order.

    The per-shard adjacency (``adj_*``) is each shard's CSR over GLOBAL
    relabeled sources of the edges into its vertices: (local destination,
    L1 slot) per edge, rows padded to the largest shard's edge count; the
    push body of the direction schedule reads it, with ``outdeg`` (per
    global relabeled id, 0 at dummies) for the direction decision."""

    num_vertices: int
    num_edges: int
    num_shards: int
    block: int  # owned vertex slots per shard (multiple of 32)
    new2old: np.ndarray  # int32[n*block]; -1 at dummies
    old2new: np.ndarray  # int32[V]
    vperm_masks: np.ndarray  # uint32[n, vperm_words]
    vperm_table: tuple[StageSpec, ...]
    vperm_size: int
    out_classes: tuple[ClassSlice, ...]
    out_space: int
    net_masks: np.ndarray  # uint32[n, net_words]
    net_table: tuple[StageSpec, ...]
    net_size: int
    m1: int
    m2: int
    in_classes: tuple[ClassSlice, ...]  # over local [0, block)
    src_l1: np.ndarray  # int32[n, m1]; ORIGINAL src ids, INF padding
    adj_indptr: np.ndarray | None = None  # int32[n, n*block + 2]
    adj_dst: np.ndarray | None = None  # int32[n, emax]; LOCAL dst ids
    adj_slot: np.ndarray | None = None  # int32[n, emax]; L1 slots
    outdeg: np.ndarray | None = None  # int32[n*block]


#: The fields of a :class:`ShardedRelayGraph` in the reference's order.
SHARDED_KEYS = (
    "num_vertices", "num_edges", "num_shards", "block", "new2old", "old2new",
    "vperm_masks", "vperm_table", "vperm_size", "out_classes", "out_space",
    "net_masks", "net_table", "net_size", "m1", "m2", "in_classes", "src_l1",
    "adj_indptr", "adj_dst", "adj_slot", "outdeg",
)


def _merge_tables(tables: list[tuple[StageSpec, ...]]) -> tuple[StageSpec, ...]:
    """The shared stage table of stacked per-shard masks: the same layout
    (one network size, the same offsets), each stage's nonzero range the
    union over the shards."""
    return tuple(
        specs[0]._replace(lo=min(s.lo for s in specs), hi=max(s.hi for s in specs))
        for specs in zip(*tables)
    )


def _unified_classes(widths: np.ndarray, per_shard_counts: np.ndarray):
    """Aligned classes from per-width counts maxed over the shards
    (``per_shard_counts``: [num_widths, n])."""
    return _build_classes(widths, per_shard_counts.max(axis=1))


def _route_shard(perm: np.ndarray, size: int, route: str, device):
    """One shard's network: ``(masks uint32 flat, stage table)``, routed
    by the native router on the host or the torch router on ``device``."""
    if route == "native":
        return _compact_and_table(benes.route_std(perm, trusted=True), size)
    from .relay_device import _compact_program, _stage_table, route_masks_device

    flat, nz = _compact_program(route_masks_device(perm, n=size, device=device), size)
    return flat.cpu().numpy().view(np.uint32), _stage_table(size, nz.cpu().numpy())


def build_sharded_relay_graph(
    graph: Graph | DeviceGraph, num_shards: int, *, route: str | None = None,
    device=None, stage_times: dict | None = None,
) -> ShardedRelayGraph:
    """Build the per-shard relay layouts with a unified static structure.

    Ownership is class-balanced: each in-degree class is dealt across the
    shards in equal contiguous chunks (ascending original id within a
    chunk), so every shard's count per width is within 1 of ``count/n``;
    vertices are relabeled within each shard so classes are contiguous,
    and the global relabeled space is the concatenation of the shard
    blocks.

    ``route`` (``auto|native|torch``, :func:`~bfs_tpu_torch.graph.relay_device.resolve_route`)
    picks the Beneš router of every shard's two networks: ``native`` gives
    the reference's layout byte for byte; ``torch`` routes on ``device``
    (the card unless it names another), and then every field but the masks
    and stage tables is byte-identical.  The shards are built side by side,
    a thread each.  ``stage_times``, if given, gets the wall seconds of the
    shared stages and of ``shards``, and each shard stage's seconds summed
    over the shards."""
    from .relay_device import _resolve_device, resolve_route

    route = resolve_route(route)
    if route == "native" and not benes.native_available():
        raise RuntimeError("route='native' needs the native benes router")
    if num_shards < 1:
        raise ValueError("num_shards must be >= 1")
    dev = _resolve_device(device) if route == "torch" else None
    times = stage_times if stage_times is not None else {}
    times.update(route=route)
    n = num_shards
    with _phase("sort", times):
        src, dst, v, e = extract_edges(graph)
        if not (isinstance(graph, DeviceGraph) and graph.num_shards == 1):  # else sorted already
            src, dst = _sorted_by_dst(src, dst)

    with _phase("classes", times):
        indeg = np.bincount(dst, minlength=v)
        in_w = _class_width(indeg)
        # Class-balanced ownership: each width's vertices, ascending, dealt
        # in n equal contiguous chunks.
        shard_of_old = np.empty(v, dtype=np.int64)
        order_v = np.argsort(in_w, kind="stable")
        widths_all, wcounts = np.unique(in_w, return_counts=True)
        pos = 0
        for cnt in wcounts.tolist():
            shard_of_old[order_v[pos:pos + cnt]] = (np.arange(cnt, dtype=np.int64) * n) // cnt
            pos += cnt
        nwidths = int(widths_all.shape[0])
        in_widx = np.searchsorted(widths_all, in_w).astype(np.int64)
        counts = np.bincount(shard_of_old * nwidths + in_widx,
                             minlength=n * nwidths).reshape(n, nwidths).T
        in_classes = _unified_classes(widths_all, counts)
        block = _round32(in_classes[-1].vb)
        m1 = in_classes[-1].sb
        gtot = n * block

    with _phase("relabel", times):
        # Shard-major, class-major, old-id-minor.
        width_to_class = _width_class_map(in_classes)
        va_by_widx = np.array([width_to_class[int(w)].va for w in widths_all], dtype=np.int64)
        group_base = (np.arange(n, dtype=np.int64)[:, None] * block
                      + va_by_widx[None, :]).reshape(-1)
        old2new = ranked_placement(shard_of_old * nwidths + in_widx, group_base).astype(np.int32)
        new2old = np.full(gtot, -1, dtype=np.int32)
        new2old[old2new] = np.arange(v, dtype=np.int32)
        # The edges grouped by the owner of their destination, dst order
        # kept within a shard: a stable counting placement.
        owner_e = _gather(shard_of_old.astype(np.int32), dst)
        bounds = np.concatenate([[0], np.cumsum(np.bincount(owner_e, minlength=n))]).astype(np.int64)
        at = _gather(bounds[:-1].astype(np.int32), owner_e) + _rank_by_count(owner_e, n)
        src_g, dst_g = np.empty_like(src), np.empty_like(dst)
        _scatter(src_g, at, src)
        _scatter(dst_g, at, dst)
        src, dst = src_g, dst_g
        del owner_e, at, src_g, dst_g

    with _phase("out classes", times):
        out_sparse = []
        owidth_counts: dict[int, int] = {}
        for s in range(n):
            per = np.bincount(src[bounds[s]:bounds[s + 1]], minlength=v)
            uids = np.flatnonzero(per)
            w = _class_width(per[uids])
            out_sparse.append((uids, w))
            for wv, c in zip(*np.unique(w, return_counts=True)):
                owidth_counts[int(wv)] = max(owidth_counts.get(int(wv), 0), int(c))
        owidths = np.array(sorted(owidth_counts), dtype=np.int64)
        ocounts = np.array([owidth_counts[int(w)] for w in owidths], dtype=np.int64)
        out_classes = _build_classes(owidths, ocounts)
        out_vb = out_classes[-1].vb
        m2 = out_classes[-1].sb
        out_width_to_class = _width_class_map(out_classes)
        net_size = _pow2_at_least(max(m1, m2))
        max_dummies = max(int(out_vb - u.shape[0]) for u, _ in out_sparse)
        vp = _pow2_at_least(max(gtot + max_dummies, out_vb, 32 * 128 * 2))
        base1, stride1 = _vertex_tables(in_classes, block)
        base2, stride2 = _vertex_tables(out_classes, out_vb)
        va_by_owidx = np.array([out_width_to_class[int(w)].va for w in owidths], dtype=np.int64)
        ova_bounds = np.array([c.va for c in out_classes], dtype=np.int64)
        owidx_of_cls = np.searchsorted(
            owidths, np.array([c.real_width for c in out_classes], dtype=np.int64))
        owidx_of_pos = owidx_of_cls[np.searchsorted(ova_bounds, np.arange(out_vb), side="right") - 1]

    src_l1 = np.full((n, m1), INF_DIST, dtype=np.int32)

    def one_shard(s: int, stimes: dict):
        """Shard ``s``'s two routed networks and its CSR (``src_l1[s]``
        filled in place)."""
        es, ee = bounds[s], bounds[s + 1]
        with _phase("vperm assembly", stimes):
            uids_s, uw_s = out_sparse[s]
            # Out positions of this shard's sources: ascending original id
            # within each width class.
            owidx_s = np.searchsorted(owidths, uw_s).astype(np.int64)
            outpos_s = ranked_placement(owidx_s, va_by_owidx)
            outpos_of_old = np.full(v, -1, dtype=np.int32)
            outpos_of_old[uids_s] = outpos_s
            vperm = np.full(vp, -1, dtype=np.int32)
            vperm[outpos_s] = old2new[uids_s]
            # Dummy out positions: the tails of the classes present in this
            # shard first, in ascending-width class order with positions
            # ascending within a class; then the absent classes' positions.
            front = vperm[:out_vb]
            present = np.bincount(owidx_s, minlength=owidths.shape[0])[owidx_of_pos] > 0
            tail = np.flatnonzero((front < 0) & present)
            tail = tail[np.argsort(owidx_of_pos[tail], kind="stable")]
            front[tail] = gtot + np.arange(tail.shape[0], dtype=np.int64)
            missing = np.flatnonzero(front < 0)
            vperm[missing] = gtot + tail.shape[0] + np.arange(missing.shape[0])
            used = np.zeros(vp, dtype=np.uint8)
            used[vperm[vperm >= 0]] = 1
            _pad_identity(vperm, used, vp)
        with _phase("vperm route", stimes):
            vperm_routed = _route_shard(vperm, vp, route, dev)
        del vperm, used
        with _phase("slots", stimes):
            # L1 slots by (local dst, src): the in-row rank is the canonical
            # min-parent; L2 slots by (src out-position, local dst).
            s_src, s_dst = src[es:ee], dst[es:ee]
            dstn = _gather(old2new, s_dst) - np.int32(s * block)
            o1, r1 = _sort_rank(dstn, s_src)
            l1_sorted = _slot_assign(base1, stride1, _gather(dstn, o1), r1)
            _scatter(src_l1[s], l1_sorted, _gather(s_src, o1))
            srcpos = _gather(outpos_of_old, s_src)
            o2, r2 = _sort_rank(srcpos, dstn)
            l2_sorted = _slot_assign(base2, stride2, _gather(srcpos, o2), r2)
            l1_by_edge = np.empty(ee - es, dtype=np.int32)
            _scatter(l1_by_edge, o1, l1_sorted)
            l2_by_edge = np.empty(ee - es, dtype=np.int32)
            _scatter(l2_by_edge, o2, l2_sorted)
            del o1, r1, o2, r2, l1_sorted, l2_sorted, srcpos
        with _phase("sparse CSR", stimes):
            # The push body's CSR over GLOBAL relabeled sources: (local
            # dst, L1 slot) per edge, rows in counting order.
            csr = seg_csr(_gather(old2new, s_src), dstn, l1_by_edge, gtot)
        with _phase("net assembly", stimes):
            net = np.full(net_size, -1, dtype=np.int32)
            _scatter(net, l1_by_edge, l2_by_edge)
            used = np.zeros(net_size, dtype=np.uint8)
            _mark_used(l2_by_edge, used)
            _pad_identity(net, used, net_size)
        del l1_by_edge, l2_by_edge, used
        with _phase("net route", stimes):
            return vperm_routed, _route_shard(net, net_size, route, dev), csr

    # The shards side by side, one thread each (the native helpers and the
    # router release the GIL; torch routes queue on the device); each
    # stage's seconds below are summed over the shards.
    shard_times = [{} for _ in range(n)]
    with _phase("shards", times), concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, min(n, os.cpu_count() or 1)),
            thread_name_prefix="sharded-relay-build") as pool:
        done = [f.result() for f in [pool.submit(one_shard, s, shard_times[s]) for s in range(n)]]
    for st in shard_times:
        for k, sec in st.items():
            times[k] = times.get(k, 0.0) + sec
    (vperm_masks, vperm_tables), (net_masks, net_tables) = (
        tuple(zip(*[r[i] for r in done])) for i in (0, 1))
    adj_parts = [r[2] for r in done]

    # One shape for every shard's adjacency rows: each padded to the
    # largest shard's edge count (each indptr bounds its own entries).
    emax = max(1, max(p[1].shape[0] for p in adj_parts))
    adj_dst = np.zeros((n, emax), np.int32)
    adj_slot = np.zeros((n, emax), np.int32)
    for s, (_, d_s, sl_s) in enumerate(adj_parts):
        adj_dst[s, : d_s.shape[0]] = d_s
        adj_slot[s, : sl_s.shape[0]] = sl_s
    outdeg = np.zeros(gtot, np.int32)
    outdeg[old2new] = np.bincount(src, minlength=v).astype(np.int32)
    return ShardedRelayGraph(
        num_vertices=v,
        num_edges=e,
        num_shards=n,
        block=block,
        new2old=new2old,
        old2new=old2new,
        vperm_masks=np.stack(vperm_masks),
        vperm_table=_merge_tables(list(vperm_tables)),
        vperm_size=vp,
        out_classes=tuple(out_classes),
        out_space=out_vb,
        net_masks=np.stack(net_masks),
        net_table=_merge_tables(list(net_tables)),
        net_size=net_size,
        m1=m1,
        m2=m2,
        in_classes=tuple(in_classes),
        src_l1=src_l1,
        adj_indptr=np.stack([p[0] for p in adj_parts]).astype(np.int32),
        adj_dst=adj_dst,
        adj_slot=adj_slot,
        outdeg=outdeg,
    )
