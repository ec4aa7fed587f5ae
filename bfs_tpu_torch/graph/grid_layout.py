"""Per-cell layouts of the 2-D grid over the sharded relay vertex space
(the port of ``bfs_tpu.graph.grid_layout``).

The classic 2-D decomposition places the adjacency on an ``r x c`` mesh:
cell ``(i, j)`` holds exactly the edges whose SOURCE falls in the row
stripe ``R_i`` and whose DESTINATION falls in the column stripe ``C_j``.
A superstep then needs two collectives, a frontier broadcast along the
column axis (each cell learns the ``R_i`` frontier, V/r bits) and a
candidate min-reduce along the row axis (each mesh column settles its
``C_j`` destinations, V/c candidates): O(V/r + V/c) words a cell where the
1-D mesh moves O(V).

This module is the host side: it derives the per-cell edge layout from a
:class:`~bfs_tpu_torch.graph.relay.ShardedRelayGraph` built at ``n = r*c``
shards, so the grid reuses the 1-D relabeling, blocks, own-word tables and
checkpoint shard files:

  * vertex block ``b`` (the 1-D shard) is owned by cell ``(b // c, b %
    c)``, mesh-row-major, so the row stripe ``R_i`` (blocks ``[i*c,
    (i+1)*c)``) is contiguous in the global relabeled space;
  * the column stripe ``C_j`` is the blocks ``{i'*c + j}``, local
    destination id ``i'*block + local``: the row axis's reduce space;
  * each edge's candidate is its ORIGINAL source id (``src_l1[shard]
    [slot]``, the MXU arm's key), so a min across cells is over one total
    order, the canonical min-parent tie-break of every engine.

The 1-D per-shard adjacency is a CSR over global relabeled sources, so
the edges of cell ``(i, j)`` are ``r`` contiguous slices of the CSRs of the
shards in ``C_j``: no edge is rebuilt, only regrouped.  The arrays equal
the reference's byte for byte.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

#: The no-candidate value of the original-id keys at padding (the
#: reference's uint32 lattice top).  The engine compares keys as int32,
#: where this word reads -1, so it ships INT32_MAX in its place.
GRID_KEY_SENTINEL = np.uint32(0xFFFFFFFF)


@dataclass(frozen=True)
class GridLayout:
    """The per-cell edge layout of an ``r x c`` grid over an ``n``-shard
    ShardedRelayGraph (``n == r*c``).  Arrays are stacked over cells
    (axis 0, cell ``(i, j)`` at ``i*c + j``) and padded to the largest
    cell's edge count."""

    r: int
    c: int
    block: int
    emax: int  # padded edge count of a cell (>= 1)
    #: int32[n, emax]: edge source, LOCAL to the cell's row stripe
    #: (``global - i*c*block``); 0 at padding.
    esrc: np.ndarray
    #: int32[n, emax]: edge destination, LOCAL to the cell's column stripe
    #: (``i'*block + local``); ``r*block`` at padding (out of range).
    edst: np.ndarray
    #: uint32[n, emax]: ORIGINAL source id; GRID_KEY_SENTINEL at padding.
    ekey: np.ndarray
    #: int32[n, c*block + 2]: CSR over the local source space (the push
    #: body's); the last entry repeated, so the frontier list's fill index
    #: ``c*block`` reads degree 0.
    indptr: np.ndarray

    @property
    def num_cells(self) -> int:
        return self.r * self.c


def parse_mesh_spec(spec: str) -> tuple[int, int]:
    """``"rxc"`` -> ``(r, c)``; a bare integer ``"8"`` is ``1x8``.  Raises
    ``ValueError`` on an axis below 1 or a spec that is not one."""
    s = str(spec).strip().lower()
    if "x" in s:
        rs, _, cs = s.partition("x")
        r, c = int(rs), int(cs)
    else:
        r, c = 1, int(s)
    if r < 1 or c < 1:
        raise ValueError(f"mesh spec {spec!r}: both axes must be >= 1")
    return r, c


def build_grid_layout(srg, r: int, c: int) -> GridLayout:
    """The per-cell edge layout from an ``r*c``-shard ShardedRelayGraph,
    on the host.  Edges come out of the 1-D CSRs as contiguous slices and
    are regrouped by local source (stable) within a cell."""
    from ..parallel.sharded import _sharded_adj_keys

    n = r * c
    if srg.num_shards != n:
        raise ValueError(f"grid {r}x{c} needs a {n}-shard ShardedRelayGraph, "
                         f"got {srg.num_shards} shards")
    if srg.adj_dst is None:
        raise ValueError("this ShardedRelayGraph ships no per-shard adjacency; rebuild it with "
                         "build_sharded_relay_graph")
    block = srg.block
    keys_all = _sharded_adj_keys(srg)  # int32[n, emax_1d]: original source ids
    cells_src, cells_dst, cells_key = [], [], []
    for i in range(r):
        lo, hi = i * c * block, (i + 1) * c * block
        for j in range(c):
            srcs, dsts, keys = [], [], []
            for i2 in range(r):
                b = i2 * c + j  # the destination block at stripe position i2
                ip = srg.adj_indptr[b].astype(np.int64)
                e0, e1 = int(ip[lo]), int(ip[hi])
                if e1 <= e0:
                    continue
                counts = np.diff(ip[lo:hi + 1])
                srcs.append(np.repeat(np.arange(c * block, dtype=np.int64), counts).astype(np.int32))
                dsts.append(srg.adj_dst[b, e0:e1] + np.int32(i2 * block))
                keys.append(keys_all[b, e0:e1].astype(np.uint32))
            if srcs:
                es = np.concatenate(srcs)
                order = np.argsort(es, kind="stable")
                cells_src.append(es[order])
                cells_dst.append(np.concatenate(dsts)[order])
                cells_key.append(np.concatenate(keys)[order])
            else:
                cells_src.append(np.zeros(0, np.int32))
                cells_dst.append(np.zeros(0, np.int32))
                cells_key.append(np.zeros(0, np.uint32))
    emax = max(1, max(e.size for e in cells_src))
    esrc = np.zeros((n, emax), np.int32)
    edst = np.full((n, emax), r * block, np.int32)
    ekey = np.full((n, emax), GRID_KEY_SENTINEL, np.uint32)
    indptr = np.zeros((n, c * block + 2), np.int32)
    for cell in range(n):
        es, ed, ek = cells_src[cell], cells_dst[cell], cells_key[cell]
        esrc[cell, : es.size] = es
        edst[cell, : ed.size] = ed
        ekey[cell, : ek.size] = ek
        ip = np.zeros(c * block + 2, np.int64)
        ip[1 : c * block + 1] = np.cumsum(np.bincount(es, minlength=c * block))
        ip[c * block + 1] = ip[c * block]  # repeated: the fill index reads degree 0
        indptr[cell] = ip.astype(np.int32)
    return GridLayout(r=r, c=c, block=block, emax=emax, esrc=esrc, edst=edst, ekey=ekey,
                      indptr=indptr)


def grid_layout_for(srg, r: int, c: int) -> GridLayout:
    """:func:`build_grid_layout` memoized on the (frozen) layout object, as
    the reference keeps it: layout data, built once per shape."""
    key = f"_grid_layout_{r}x{c}"
    cached = getattr(srg, key, None)
    if cached is None:
        cached = build_grid_layout(srg, r, c)
        object.__setattr__(srg, key, cached)
    return cached


def grid_tile_placement(srg, r: int, c: int, builder: str | None = None) -> dict:
    """Which of the per-shard 128x128 adjacency tiles
    (:func:`~bfs_tpu_torch.graph.adj_tiles.build_adj_tiles_sharded`, built
    one shard at a time on the host) each cell of the grid holds: a tile
    of shard ``b`` (column stripe ``C_{b % c}``) lands on cell ``(i, b %
    c)``, ``i`` the row stripe its source tile row falls in.  Returns
    ``{"cells": int64[r, c] tile counts, "total_tiles": int,
    "tile_rows_per_stripe": int}``; each shard's tiles partition exactly
    across its mesh column's ``r`` cells."""
    from .adj_tiles import TILE, iter_adj_tiles_sharded

    counts = np.zeros((r, c), np.int64)
    stripe_rows = c * srg.block  # sources per row stripe
    total = 0
    for b, at in enumerate(iter_adj_tiles_sharded(srg, builder)):
        row_src = at.row_idx[: at.nt].cpu().numpy().astype(np.int64) * TILE
        # A source tile straddles a stripe only when c*block is not a
        # multiple of 128: clamp, as the reference does.
        stripe = np.clip(row_src // stripe_rows, 0, r - 1)
        counts[:, b % c] += np.bincount(stripe, minlength=r)
        total += at.nt
        del at
    return {"cells": counts, "total_tiles": int(total),
            "tile_rows_per_stripe": int(stripe_rows // TILE)}
