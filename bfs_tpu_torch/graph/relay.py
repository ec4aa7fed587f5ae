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

import logging
import time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

from . import benes, native_gen
from .csr import INF_DIST, DeviceGraph, Graph, unpad_edges

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
