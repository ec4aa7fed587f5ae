"""ELL-packed pull adjacency: the pull engine's layout.

The port of ``bfs_tpu.graph.ell``; the arrays are byte for byte the
reference's, of one shard (:class:`PullGraph`) or of the mesh engine's
vertex blocks (:class:`ShardedPullGraph`).  For every destination vertex the pull superstep
asks "what is the minimum active in-neighbour?" with gathers and row-mins
only:

  * Level 0: in-neighbour lists packed into a dense ``[R0, K]`` matrix of
    source ids (ELL format), one or more rows per vertex, padded with the
    sentinel ``V``.
  * Degree skew is folded by recursion: a vertex's rows are grouped K at a
    time by index matrices ``[R_i, K]`` until exactly one row per vertex
    remains, ``ceil(log_K(max_indegree))`` levels.

Every vertex owns at least one row at every level and rows are
vertex-major, so the last level has one row per vertex in id order.  The
layout is built on the host once per graph; every superstep is then the
same fixed-shape sequence of gathers and row-mins.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .csr import DeviceGraph, Graph, _sorted_by_dst, pad_to_multiple, unpad_edges

#: ELL row width: padding waste is bounded by V*(K-1) slots while the fold
#: depth stays ceil(log_K(max_indegree)).
DEFAULT_K = 32


@dataclass(frozen=True)
class PullGraph:
    """Static pull adjacency.

    ``ell0``: int32[R0p, K] source-vertex ids, sentinel-padded (sentinel =
    ``num_vertices``; slot V of the frontier table is never active), rows
    vertex-major, padded to R0p rows with all-sentinel rows.

    ``folds``: int32[R_ip, K] index matrices.  ``folds[i]`` gathers from
    the previous level's row-mins *extended by one INF slot at its end*
    (index = the previous padded row count), so padding selects INF.
    After the last fold, rows 0..V-1 are the vertices in id order.
    """

    num_vertices: int
    num_edges: int  # real directed edges packed into ell0
    ell0: np.ndarray
    folds: tuple[np.ndarray, ...] = field(default_factory=tuple)

    @property
    def k(self) -> int:
        return int(self.ell0.shape[1])

    @property
    def padded_slots(self) -> int:
        return int(self.ell0.size) + sum(int(f.size) for f in self.folds)


def device_ell(pg: PullGraph, device) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """The pull engine's device operands, TRANSPOSED to ``[K, rows]`` as the
    reference ships them, so that a row-chunk of a level is a slice of its
    minor axis and the row-min reduces over the major one."""

    def ship(mat: np.ndarray) -> torch.Tensor:
        # Transposed where it lands: a host transpose of the [rows, K]
        # matrix walks memory K words apart.
        return torch.from_numpy(np.ascontiguousarray(mat)).to(device).t().contiguous()

    return ship(pg.ell0), tuple(ship(f) for f in pg.folds)


def pull_to_arrays(pg: PullGraph) -> dict[str, np.ndarray]:
    """A PullGraph as name -> ndarray (the reference's layout-cache form);
    the inverse is :func:`pull_from_arrays`."""
    return dict(
        num_vertices=np.int64(pg.num_vertices),
        num_edges=np.int64(pg.num_edges),
        ell0=pg.ell0,
        num_folds=np.int64(len(pg.folds)),
        **{f"fold{i}": f for i, f in enumerate(pg.folds)},
    )


def pull_from_arrays(z) -> PullGraph:
    """A PullGraph from any name -> array mapping (npz, memmaps)."""
    nf = int(z["num_folds"])
    return PullGraph(
        num_vertices=int(z["num_vertices"]),
        num_edges=int(z["num_edges"]),
        ell0=z["ell0"],
        folds=tuple(z[f"fold{i}"] for i in range(nf)),
    )


def _group_rows(counts: np.ndarray, k: int):
    """Pack per-group items (stored contiguously, group-major) into rows of
    width ``k``: every group gets ``max(ceil(count/k), 1)`` rows, numbered
    globally in group order.  Returns ``(row_of_item, col_of_item,
    rows_per_group)``."""
    total = int(counts.sum())
    rows_per_group = np.maximum((counts + k - 1) // k, 1)
    group_start = np.zeros(counts.shape[0] + 1, dtype=np.int64)
    np.cumsum(counts, out=group_start[1:])
    row_offset = np.zeros(counts.shape[0] + 1, dtype=np.int64)
    np.cumsum(rows_per_group, out=row_offset[1:])
    item_group = np.repeat(np.arange(counts.shape[0], dtype=np.int64), counts)
    pos_in_group = np.arange(total, dtype=np.int64) - group_start[item_group]
    row_of_item = row_offset[item_group] + pos_in_group // k
    col_of_item = pos_in_group % k
    return row_of_item, col_of_item, rows_per_group


def build_pull_graph(
    graph: Graph | DeviceGraph, *, k: int = DEFAULT_K, row_multiple: int = 64
) -> PullGraph:
    """Pack a graph's in-adjacency (edges grouped by dst) into ELL levels,
    from a :class:`Graph` or a dst-sorted :class:`DeviceGraph` (whose
    sentinel edges are dropped, and which needs no second sort).
    ``row_multiple`` pads each level's row count."""
    if k < 2:
        raise ValueError("ELL width k must be >= 2")
    if isinstance(graph, DeviceGraph):
        if graph.num_shards != 1:
            raise ValueError("build_pull_graph expects a single-shard DeviceGraph")
        src, dst = unpad_edges(graph)
    else:
        src, dst = _sorted_by_dst(graph.src, graph.dst)
    v = graph.num_vertices
    e = int(src.shape[0])
    sentinel = np.int32(v)

    # ---- level 0: edge sources packed by destination vertex ----
    counts = np.bincount(dst, minlength=v).astype(np.int64) if e else np.zeros(v, np.int64)
    row_of, col_of, rows_per_v = _group_rows(counts, k)
    r0 = int(rows_per_v.sum())
    r0_padded = pad_to_multiple(r0, row_multiple)
    ell0 = np.full((r0_padded, k), sentinel, dtype=np.int32)
    ell0[row_of, col_of] = src

    # ---- fold levels: each vertex's rows grouped K at a time ----
    folds: list[np.ndarray] = []
    level_rows = rows_per_v
    prev_padded = r0_padded
    prev_max = int(level_rows.max()) + 1
    while int(level_rows.max()) > 1:
        if int(level_rows.max()) >= prev_max:  # k >= 2 strictly shrinks rows
            raise RuntimeError("ELL fold recursion failed to converge")
        prev_max = int(level_rows.max())
        row_of, col_of, next_rows = _group_rows(level_rows, k)
        r_next_padded = pad_to_multiple(int(next_rows.sum()), row_multiple)
        # Items are the previous level's real rows in order; the INF slot
        # appended to the previous row-mins sits at index prev_padded.
        fold = np.full((r_next_padded, k), prev_padded, dtype=np.int32)
        fold[row_of, col_of] = np.arange(int(level_rows.sum()), dtype=np.int32)
        folds.append(fold)
        level_rows = next_rows
        prev_padded = r_next_padded

    return PullGraph(num_vertices=v, num_edges=e, ell0=ell0, folds=tuple(folds))


@dataclass(frozen=True)
class ShardedPullGraph:
    """The pull layout partitioned by destination over ``num_shards``
    vertex blocks: shard ``s`` owns vertices ``[s*block, (s+1)*block)`` and
    holds the ELL in-adjacency of exactly those destinations, with GLOBAL
    source ids, so each superstep gathers from the global frontier table
    and produces candidates for its own block only.

    The shards share one shape (stacked on axis 0): ``ell0`` int32[n, R0,
    K] (sentinel ``n*block``, the frontier table's always-inactive slot)
    and ``folds`` int32[n, R_i, K], the :class:`PullGraph` fold recursion
    per shard, padded to a common depth (a shard that converged early gets
    identity folds) and common row counts; a fold's padding indexes the
    INF slot after the previous level's padded rows.  After the last fold,
    rows ``0..block-1`` of shard ``s`` are its vertices in id order."""

    num_vertices: int  # real V (unpadded)
    num_edges: int  # real directed edges across all shards
    num_shards: int
    block: int  # owned vertices per shard, padded; a multiple of 32
    ell0: np.ndarray
    folds: tuple[np.ndarray, ...] = field(default_factory=tuple)

    @property
    def k(self) -> int:
        return int(self.ell0.shape[2])

    @property
    def padded_vertices(self) -> int:
        return self.num_shards * self.block


def _shard_levels(dst_local: np.ndarray, block: int, k: int) -> list:
    """One shard's ELL recursion, as placements: per level ``(rows,
    row_of, col_of, values)`` (``values`` None at level 0, where the
    caller places the edges' global sources), with natural row counts."""
    counts = np.bincount(dst_local, minlength=block).astype(np.int64)
    row_of, col_of, level_rows = _group_rows(counts, k)
    levels = [(int(level_rows.sum()), row_of, col_of, None)]
    while int(level_rows.max()) > 1:
        prev_real = int(level_rows.sum())
        row_of, col_of, level_rows = _group_rows(level_rows, k)
        levels.append((int(level_rows.sum()), row_of, col_of,
                       np.arange(prev_real, dtype=np.int32)))
    return levels


def build_sharded_pull_graph(
    graph: Graph | DeviceGraph,
    num_shards: int,
    *,
    k: int = DEFAULT_K,
    block_multiple: int = 1024,
    row_multiple: int = 64,
) -> ShardedPullGraph:
    """Partition a graph's in-adjacency into per-destination-block ELL
    shards of one stacked shape (:class:`ShardedPullGraph`).  The block is
    ``ceil(V / num_shards)`` rounded up to ``block_multiple`` (a multiple
    of 32, for the packed frontier words).  Each level is written straight
    into its stacked int32 array, its padding holding the value the
    reference resolves its ``-1`` markers to."""
    if k < 2:
        raise ValueError("ELL width k must be >= 2")
    if num_shards < 1:
        raise ValueError("num_shards must be >= 1")
    if block_multiple % 32 != 0:
        raise ValueError("block_multiple must be a multiple of 32")
    if isinstance(graph, DeviceGraph):
        # A single-shard DeviceGraph is dst-sorted already; a multi-shard
        # one per shard only, so its edges are sorted again globally.
        src, dst = unpad_edges(graph)
        if graph.num_shards > 1:
            src, dst = _sorted_by_dst(src, dst)
    else:
        src, dst = _sorted_by_dst(graph.src, graph.dst)
    v, n = graph.num_vertices, num_shards
    e = int(src.shape[0])
    block = pad_to_multiple(max((v + n - 1) // n, 1), block_multiple)

    # Edges are dst-sorted: the shard boundaries are one searchsorted.
    bounds = np.searchsorted(dst, np.arange(n + 1, dtype=np.int64) * block)
    plans = [_shard_levels(dst[bounds[s]:bounds[s + 1]].astype(np.int64) - s * block, block, k)
             for s in range(n)]
    depth = max(len(p) for p in plans)
    identity = (block, np.arange(block, dtype=np.int64), np.zeros(block, dtype=np.int64),
                np.arange(block, dtype=np.int32))
    for p in plans:  # shards that converged early fold each final row to itself
        p.extend([identity] * (depth - len(p)))

    stacked = []
    fill = n * block  # level 0: the always-inactive frontier slot
    for i in range(depth):
        rows = pad_to_multiple(max(p[i][0] for p in plans), row_multiple)
        level = np.full((n, rows, k), fill, dtype=np.int32)
        for s, p in enumerate(plans):
            _, row_of, col_of, values = p[i]
            level[s, row_of, col_of] = src[bounds[s]:bounds[s + 1]] if values is None else values
        stacked.append(level)
        fill = rows  # a fold's padding: the INF slot after these rows
    return ShardedPullGraph(
        num_vertices=v,
        num_edges=e,
        num_shards=n,
        block=block,
        ell0=stacked[0],
        folds=tuple(stacked[1:]),
    )


def device_ell_sharded(spg: ShardedPullGraph, device) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """The sharded twin of :func:`device_ell`: ``[n, R, K]`` ->
    ``[n, K, R]`` on ``device``."""

    def ship(mat: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(mat)).to(device).transpose(1, 2).contiguous()

    return ship(spg.ell0), tuple(ship(f) for f in spg.folds)
