"""The MXU expansion arm, plain PyTorch: the port of
``bfs_tpu.ops.relay_mxu``.

A dense superstep expands the frontier as a tiled masked product of the
frontier bitmap against the bit-packed 128x128 adjacency tiles of
:mod:`bfs_tpu_torch.graph.adj_tiles`.  For each destination ``v`` the
expansion emits

    cand[v] = min over frontier sources u with an edge u -> v of orig_id(u)

as uint32 (stored as int32 patterns), ``0xFFFFFFFF`` where no frontier
source reaches ``v``: the canonical min-parent candidate that the packed
``level:6|parent:26`` update (K4, ``relay_cuda.apply_relay_candidates_packed``)
merges as it is, since the parent field of this arm holds original ids.

:func:`expand_frontier_mxu_plain` is the plain version of the card's
kernel ``mxu_expand`` (K6, ``csrc/relay_mxu_kernels.cu``, wrapped as
``relay_cuda.expand_frontier_mxu``) and computes what the reference's XLA
twin ``expand_frontier_mxu_xla`` computes, bit for bit.
:func:`expand_into_plain` min-merges its result into a caller's output,
the plain version of a launch with ``out=``; the streamed arm
(:mod:`bfs_tpu_torch.stream`) expands one column superblock at a time with
it (:func:`expand_superblock_plain`).  Where the tiles live is
:func:`resolve_tiles_mode`.
"""

from __future__ import annotations

import torch

from .. import knobs
from ..graph.adj_tiles import SB_TILES, SB_VERTS, TILE, TILE_WORDS, _popcount32
from .packed import INT32_MAX

__all__ = [
    "EXPANSION_MODES",
    "DEFAULT_TILES_BUDGET_BYTES",
    "resolve_expansion",
    "mxu_device_operands",
    "mxu_static",
    "live_tiles",
    "reachable_bits",
    "expand_frontier_mxu_plain",
    "expand_into_plain",
    "expand_superblock_plain",
    "TILES_MODES",
    "resolve_tiles_mode",
    "stream_cache_budget_bytes",
]

EXPANSION_MODES = ("auto", "gather", "mxu")

#: Tile-storage ceiling for building the layout (the reference's default
#: of 4 GiB): a scale-free tail can degrade toward one 2 KB tile per edge.
DEFAULT_TILES_BUDGET_BYTES = 4 << 30

#: XOR with this maps uint32 order onto int32 order (the sentinel
#: 0xFFFFFFFF becomes INT32_MAX), so mins run on int32 patterns.
_FLIP = -(1 << 31)


def resolve_expansion(mode: str | None = None) -> str:
    """The dense superstep's arm as asked for (an explicit argument wins
    over ``BFS_TPU_TORCH_EXPANSION``, default ``auto``): ``gather``,
    ``mxu``, or ``auto``, which :class:`~bfs_tpu_torch.models.bfs.RelayEngine`
    resolves by its static gates and the measured probe
    (:func:`bfs_tpu_torch.profiling.probe_phase_kernels`).  Raises on an
    unknown mode."""
    if mode is None:
        mode = knobs.get("BFS_TPU_TORCH_EXPANSION")
    if mode not in EXPANSION_MODES:
        raise ValueError(f"unknown expansion {mode!r}; use 'auto', 'gather' or 'mxu'")
    return mode


TILES_MODES = ("resident", "stream", "auto")


def resolve_tiles_mode(mode: str | None = None) -> str:
    """Where the MXU arm's tiles live (an explicit argument wins over
    ``BFS_TPU_TORCH_TILES``): ``resident`` ships the layout to the card
    once (the default); ``stream`` keeps it in a pinned host store and
    pages column superblocks in on demand (:mod:`bfs_tpu_torch.stream`);
    ``auto`` streams exactly when the layout exceeds
    :func:`stream_cache_budget_bytes`.  Raises on an unknown mode."""
    if mode is None:
        mode = knobs.get("BFS_TPU_TORCH_TILES")
    if mode not in TILES_MODES:
        raise ValueError(f"unknown tiles mode {mode!r}; use 'resident', 'stream' or 'auto'")
    return mode


def stream_cache_budget_bytes() -> int:
    """The streamed arm's device cache budget
    (``BFS_TPU_TORCH_STREAM_CACHE_GB``, default 1 GiB): the working set the
    LRU accounts against, not an allocator limit (a slab being expanded
    stays alive past its eviction)."""
    return int(knobs.get("BFS_TPU_TORCH_STREAM_CACHE_GB") * (1 << 30))


def mxu_device_operands(at, device) -> tuple:
    """The layout as the expansion's operand tuple ``(tiles, row_idx,
    col_id, keys2d)``, int32 tensors on ``device`` (shipped once; a layout
    built there is used as it is, not copied)."""
    return tuple(t.to(device) for t in (at.tiles, at.row_idx, at.col_id, at.keys2d))


def mxu_static(at) -> tuple:
    """The expansion's geometry ``(rows, cols, rtp, vtp, ntp)``."""
    return (int(at.rows), int(at.cols), int(at.rtp), int(at.vtp), int(at.ntp))


def _pad_frontier_words(fwords: torch.Tensor, rows: int, rtp: int) -> torch.Tensor:
    """Frontier words padded to the row space plus ONE zero pad block (the
    ``row_idx = rtp // TILE`` padding target reads zeros)."""
    del rows  # the words cover it
    want = rtp // 32 + TILE // 32
    pad = fwords.new_zeros(want - fwords.shape[-1])
    return torch.cat([fwords, pad])


def live_tiles(fwords: torch.Tensor, tile_ops: tuple, *, rows: int, rtp: int) -> torch.Tensor:
    """int64 indices of the tiles whose 128-bit frontier block is nonzero:
    the only tiles that can contribute (the kernel skips the rest before
    reading them)."""
    fblk = _pad_frontier_words(fwords, rows, rtp).reshape(-1, TILE_WORDS)
    return torch.nonzero((fblk != 0).any(dim=1)[tile_ops[1]]).flatten()


def reachable_bits(
    fwords: torch.Tensor, tile_ops: tuple, *, rows: int, rtp: int, chunk: int = 1 << 16,
) -> torch.Tensor:
    """int64 count, per live tile (in :func:`live_tiles` order), of its set
    bits in frontier rows: the count by which the card's kernel sends a
    tile down its sparse path (at most ``relay_cuda.MXU_SPARSE_MAX_BITS``)
    or its tensor-core path."""
    tiles, row_idx = tile_ops[0], tile_ops[1]
    fblk = _pad_frontier_words(fwords, rows, rtp).reshape(-1, TILE_WORDS)
    live = live_tiles(fwords, tile_ops, rows=rows, rtp=rtp)
    lane = torch.arange(TILE, dtype=torch.int32, device=tiles.device)
    parts = [torch.zeros(0, dtype=torch.int64, device=tiles.device)]
    for lo in range(0, live.numel(), chunk):
        ix = live[lo : lo + chunk]
        fbit = (fblk[row_idx[ix].long()][:, lane >> 5] >> (lane & 31)) & 1  # [n, 128] rows u
        parts.append((_popcount32(tiles[ix]).sum(dim=2) * fbit).sum(dim=1))
    return torch.cat(parts)


def expand_frontier_mxu_plain(
    fwords: torch.Tensor, tile_ops: tuple, *, rows: int, cols: int, rtp: int,
    vtp: int, chunk: int = 4096,
) -> torch.Tensor:
    """``cand`` int32[cols] (uint32 patterns, ``-1`` = 0xFFFFFFFF where no
    frontier in-neighbour): the minimum original id over the frontier
    in-neighbours of each destination.

    Only tiles whose 128-bit frontier block is nonzero can contribute (the
    kernel's early-out); they are taken ``chunk`` at a time: frontier row
    mask, contribution bits, the min key per tile column, then
    ``scatter_reduce_(..., "amin")`` over ``col_id``.  Mins run on
    ``key ^ 0x80000000`` so that int32 order is uint32 order; min is exact
    and order-free, so chunking cannot change a bit.  A batch ``fwords``
    ``[S, nfw]`` gives ``[S, cols]``, tree by tree."""
    if fwords.dim() == 2:
        return torch.stack([expand_frontier_mxu_plain(f, tile_ops, rows=rows, cols=cols, rtp=rtp,
                                                      vtp=vtp, chunk=chunk) for f in fwords])
    tiles, row_idx, col_id, keys2d = tile_ops
    dev = tiles.device
    fblk = _pad_frontier_words(fwords, rows, rtp).reshape(-1, TILE_WORDS)
    live = live_tiles(fwords, tile_ops, rows=rows, rtp=rtp)
    lane = torch.arange(TILE, dtype=torch.int32, device=dev)
    shifts = torch.arange(32, dtype=torch.int32, device=dev)
    out = torch.full((vtp + TILE,), INT32_MAX, dtype=torch.int32, device=dev)
    for lo in range(0, live.numel(), chunk):
        ix = live[lo : lo + chunk]
        rb = row_idx[ix].long()
        fbit = ((fblk[rb][:, lane >> 5] >> (lane & 31)) & 1).bool()  # [n, 128] rows u
        contrib = tiles[ix] * fbit[:, :, None]  # [n, 128, 4] words of live rows
        bits = ((contrib[..., None] >> shifts) & 1).bool().reshape(-1, TILE, TILE)
        keys = keys2d[rb] ^ _FLIP  # [n, 128]
        cand = torch.where(bits, keys[:, :, None], INT32_MAX).amin(dim=1)  # [n, 128] cols v
        dst = (col_id[ix].long()[:, None] * TILE + lane).reshape(-1)
        out.scatter_reduce_(0, dst, cand.reshape(-1), "amin")
    return out[:cols] ^ _FLIP


def _umin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned minimum of int32 bit patterns."""
    return torch.minimum(a ^ _FLIP, b ^ _FLIP) ^ _FLIP


def expand_into_plain(
    fwords: torch.Tensor, tile_ops: tuple, out: torch.Tensor, *, rows: int, rtp: int,
    vtp: int,
) -> torch.Tensor:
    """:func:`expand_frontier_mxu_plain` over all ``vtp`` columns, min-merged
    (unsigned) into ``out`` int32[vtp] (a batch: ``[S, vtp]``) in place, as a launch of
    ``mxu_expand`` with ``out=`` does with its atomics.  Returns ``out``.

    A superblock slab's pad tiles (column ``vtp // 128``, row block
    ``rtp // 128``) read the zero frontier pad block, so they are never
    live and add nothing."""
    cand = expand_frontier_mxu_plain(fwords, tile_ops, rows=rows, cols=vtp, rtp=rtp, vtp=vtp)
    return out.copy_(_umin(out, cand))


def expand_superblock_plain(
    fwords: torch.Tensor, slab: tuple, keys2d: torch.Tensor, g: int, grid: torch.Tensor, *,
    rows: int, rtp: int,
) -> torch.Tensor:
    """The streamed arm's expansion of column superblock ``g``: its slab
    ``(tiles, row_idx, col_local)`` (column tiles local to the superblock,
    pad tiles at ``col_local = SB_TILES``) min-merged into rows
    ``[g * 16384, (g + 1) * 16384)`` of the caller's candidate grid
    int32[vtp].  Returns that view.  The plain version of a launch of
    ``mxu_expand`` on the slab with ``out=`` that view."""
    tiles, row_idx, col_local = slab
    view = grid[g * SB_VERTS : (g + 1) * SB_VERTS]
    return expand_into_plain(fwords, (tiles, row_idx, col_local, keys2d), view,
                             rows=rows, rtp=rtp, vtp=SB_TILES * TILE)
