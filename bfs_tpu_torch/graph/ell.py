"""ELL-packed pull adjacency: the pull engine's layout.

The port of ``bfs_tpu.graph.ell`` for one shard; the arrays are byte for
byte the reference's.  For every destination vertex the pull superstep
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
