"""Bit-packed tiled adjacency for the MXU expansion arm: the port of
``bfs_tpu.graph.adj_tiles``.

Geometry (all in the relay's relabeled id space, so the frontier words the
level loop already carries feed the tiles directly):

  * a **tile** is a 128 (source rows) x 128 (destination bits) block of the
    adjacency matrix, stored bit-packed as ``uint32[128, 4]``: tile ``t``,
    row ``i``, word ``j``, bit ``b`` is set iff edge
    ``(u = row_idx[t]*128 + i, v = col_id[t]*128 + 32*j + b)`` exists.
    Empty tiles are never stored, so the layout costs 2 KB per nonempty
    128x128 block.
  * tiles are sorted by ``(col_id, row_idx)`` and grouped into **column
    superblocks** of 128 column tiles (16384 destinations);
    ``sb_indptr[g]`` bounds superblock ``g``'s tile span, the unit that
    :mod:`bfs_tpu_torch.stream` pages from the host.
  * ``keys2d[rb, i]`` is the ORIGINAL id of source row ``u = rb*128 + i``
    (``KEY_SENTINEL`` at relabel dummies and padding): the expansion emits
    the minimum key over contributing frontier sources, the canonical
    min-parent.  One extra all-sentinel row block (and one all-zero
    frontier pad block) backs the ``row_idx = rtp // 128`` padding.

Arrays are torch tensors on the device they were built on, uint32 bit
patterns stored as ``int32``.  :func:`build_adj_tiles_host` is the pinned
numpy oracle (byte for byte the reference's host builder);
:func:`build_adj_tiles_device` builds the same bytes with torch ops on any
device, so a layout bound for the card is built there and never exists on
the host.
"""

from __future__ import annotations

import warnings
import weakref
from dataclasses import dataclass

import numpy as np
import torch

#: Tile geometry: 128 source rows x 128 destination bits (4 words per row).
TILE = 128
TILE_WORDS = TILE // 32
#: Column superblock: 128 column tiles, 16384 destinations.
SB_TILES = 128
SB_VERTS = SB_TILES * TILE

#: The tiles bundle's schema version (the reference's).
TILES_VERSION = 1

#: Unreached / min-identity sentinel (``ops.packed.PACKED_SENTINEL``).
KEY_SENTINEL = np.uint32(0xFFFFFFFF)
TILE_BYTES = TILE * TILE_WORDS * 4

#: Tiles per step of :func:`tile_occupancy_hist` (256 MB of int64 words).
_HIST_CHUNK = 1 << 16


def round_up(x: int, m: int) -> int:
    return -(-int(x) // m) * m


@dataclass(frozen=True)
class AdjTiles:
    """CSR-of-tiles adjacency for one expansion target.

    ``rows``/``cols`` are the source/destination id spaces (the relay
    ``vr`` for the single-device layout), ``rtp``/``vtp`` their 128- and
    16384-padded extents, ``nt`` the real tile count; the arrays are
    padded to ``ntp >= 1`` with inert tiles whose ``row_idx`` points at the
    zero frontier pad block and whose ``col_id`` is the dropped overflow
    segment ``vtp // 128``."""

    rows: int
    cols: int
    rtp: int
    vtp: int
    nt: int
    tiles: torch.Tensor  # int32[ntp, TILE, TILE_WORDS]
    row_idx: torch.Tensor  # int32[ntp]; pad = rtp // TILE
    col_id: torch.Tensor  # int32[ntp]; pad = vtp // TILE
    sb_indptr: torch.Tensor  # int32[vtp // SB_VERTS + 1]
    keys2d: torch.Tensor  # int32[rtp // TILE + 1, TILE]

    @property
    def ntp(self) -> int:
        return int(self.tiles.shape[0])

    @property
    def device(self) -> torch.device:
        return self.tiles.device

    @property
    def nbytes(self) -> int:
        return tiles_nbytes(self.nt, self.rows, self.cols)


def keys_from_new2old(new2old: np.ndarray, rows: int) -> torch.Tensor:
    """int32[rtp//TILE + 1, TILE] original-id key table (uint32 patterns):
    ``new2old`` where real, ``KEY_SENTINEL`` at dummies and padding, and
    one extra sentinel pad block (the ``row_idx`` padding target)."""
    rtp = round_up(rows, TILE)
    n2o = np.asarray(new2old)
    keys = np.full(rtp + TILE, KEY_SENTINEL, dtype=np.uint32)
    real = n2o >= 0
    keys[: n2o.shape[0]][real] = n2o[real].astype(np.uint32)
    return torch.from_numpy(keys.view(np.int32).reshape(-1, TILE))


def _finalize(
    rows: int, cols: int, nt: int, tiles, row_idx, col_id,
    keys2d: torch.Tensor, device,
) -> AdjTiles:
    """Shared tail of both builders: pad to ``ntp >= 1`` with an inert tile
    and derive the superblock index, on ``device``."""
    rtp = round_up(rows, TILE)
    vtp = round_up(max(cols, 1), SB_VERTS)
    if tuple(keys2d.shape) != (rtp // TILE + 1, TILE):
        raise ValueError(f"keys2d is {tuple(keys2d.shape)}, not the key table "
                         f"{(rtp // TILE + 1, TILE)} of {rows} rows (keys_from_new2old)")
    i32 = dict(dtype=torch.int32, device=device)
    if nt == 0:
        tiles = torch.zeros((1, TILE, TILE_WORDS), **i32)
        row_idx = torch.tensor([rtp // TILE], **i32)
        col_id = torch.tensor([vtp // TILE], **i32)
    sb = torch.searchsorted(
        (col_id[: max(nt, 0)] // SB_TILES).to(torch.int64).contiguous(),
        torch.arange(vtp // SB_VERTS + 1, dtype=torch.int64, device=device),
    )
    return AdjTiles(
        rows=int(rows), cols=int(cols), rtp=rtp, vtp=vtp, nt=int(nt),
        tiles=tiles.contiguous(), row_idx=row_idx.contiguous(),
        col_id=col_id.contiguous(), sb_indptr=sb.to(torch.int32),
        keys2d=keys2d.to(device=device, dtype=torch.int32).contiguous(),
    )


def _check_budget(nt: int, budget_bytes: int | None) -> None:
    need = int(nt) * TILE_BYTES
    if budget_bytes is not None and need > budget_bytes:
        raise ValueError(
            f"adjacency tile layout needs {need >> 20} MB ({nt} tiles x 2 KB), "
            f"over the {budget_bytes >> 20} MB budget (tiles_budget_bytes) "
            "— a scale-free tail this sparse belongs on the gather arm"
        )


def build_adj_tiles_host(
    src, dst, *, rows: int, cols: int, keys2d: torch.Tensor,
    budget_bytes: int | None = None,
) -> AdjTiles:
    """The pinned oracle builder, in numpy: (src, dst) relay-space edge
    lists (``src < rows``, ``dst < cols``) -> the tiled layout on the CPU.
    Duplicate edges OR onto the same bit.  ``budget_bytes`` rejects a
    layout whose nonempty-tile count exceeds it, before the tile
    allocation."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    cpu = torch.device("cpu")
    if src.shape[0] == 0:
        return _finalize(rows, cols, 0, None, None, None, keys2d, cpu)
    cb = dst >> 7
    rb = src >> 7
    code = cb * (round_up(rows, TILE) // TILE + 1) + rb
    order = np.argsort(code, kind="stable")
    cs = code[order]
    first = np.concatenate([[True], cs[1:] != cs[:-1]])
    tile_of = np.cumsum(first) - 1
    nt = int(tile_of[-1]) + 1
    _check_budget(nt, budget_bytes)
    row_idx = rb[order][first].astype(np.int32)
    col_id = cb[order][first].astype(np.int32)
    tiles = np.zeros(nt * TILE * TILE_WORDS, dtype=np.uint32)
    i = src[order] & (TILE - 1)
    vloc = dst[order] & (TILE - 1)
    flat = tile_of * (TILE * TILE_WORDS) + i * TILE_WORDS + (vloc >> 5)
    np.bitwise_or.at(tiles, flat, np.uint32(1) << (vloc & 31).astype(np.uint32))
    return _finalize(
        rows, cols, nt,
        torch.from_numpy(tiles.view(np.int32).reshape(nt, TILE, TILE_WORDS)),
        torch.from_numpy(row_idx), torch.from_numpy(col_id), keys2d, cpu,
    )


def build_adj_tiles_device(
    src, dst, *, rows: int, cols: int, keys2d: torch.Tensor,
    budget_bytes: int | None = None, device=None,
) -> AdjTiles:
    """The same layout as :func:`build_adj_tiles_host`, byte for byte,
    built with torch ops on ``device`` (default: where ``src`` lies).

    One int64 sort of ``(col tile, row tile, in-tile bit)`` codes, the
    first-of-tile and duplicate-edge flags from neighbouring codes, and a
    sum scatter of the deduplicated bits (unique bits per word, so the sum
    is the OR).  Only ``nt`` is read back to the host.  Temporaries are
    freed as soon as they are used: at R-MAT scale 22 they peak at 1.4 GB
    beside 21 GB of tiles on an H100."""
    if device is None:
        device = src.device if isinstance(src, torch.Tensor) else torch.device("cpu")
    src = torch.as_tensor(src).to(device=device, dtype=torch.int64)
    dst = torch.as_tensor(dst).to(device=device, dtype=torch.int64)
    if src.numel() == 0:
        return _finalize(rows, cols, 0, None, None, None, keys2d, device)
    rbp = round_up(rows, TILE) // TILE + 1
    code = (((dst >> 7) * rbp + (src >> 7)) << 14) | ((src & (TILE - 1)) << 7) | (dst & (TILE - 1))
    del src, dst
    code = torch.sort(code).values
    tile = code >> 14
    first = torch.ones_like(tile, dtype=torch.bool)
    first[1:] = tile[1:] != tile[:-1]
    nt = int(first.sum())
    _check_budget(nt, budget_bytes)
    heads = tile[first]
    row_idx = (heads % rbp).to(torch.int32)
    col_id = (heads // rbp).to(torch.int32)
    del heads
    tile_of = torch.cumsum(first, 0) - 1
    del first, tile
    keep = torch.ones_like(code, dtype=torch.bool)
    keep[1:] = code[1:] != code[:-1]  # the first of each run of duplicate edges
    lb = code[keep] & (TILE * TILE - 1)
    tile_of = tile_of[keep]
    del code, keep
    word = tile_of * (TILE * TILE_WORDS) + (lb >> 7) * TILE_WORDS + ((lb & (TILE - 1)) >> 5)
    del tile_of
    bit = torch.bitwise_left_shift(torch.ones_like(lb), lb & 31)
    bit = torch.where(bit >= 1 << 31, bit - (1 << 32), bit).to(torch.int32)
    del lb
    tiles = torch.zeros(nt * TILE * TILE_WORDS, dtype=torch.int32, device=device)
    tiles.index_add_(0, word, bit)
    del word, bit
    return _finalize(
        rows, cols, nt, tiles.reshape(nt, TILE, TILE_WORDS), row_idx, col_id,
        keys2d, device,
    )


def _relay_edges(rg, device):
    """(src, dst) relabeled edge tensors on ``device`` from the relay
    layout's CSR (rows ascend with the relabeled source)."""
    indptr = torch.from_numpy(np.asarray(rg.adj_indptr[: rg.vr + 1], dtype=np.int64)).to(device)
    src = torch.repeat_interleave(
        torch.arange(rg.vr, dtype=torch.int64, device=device), indptr.diff()
    )
    return src, torch.from_numpy(np.asarray(rg.adj_dst, dtype=np.int64)).to(device)


def count_tiles_from_relay(rg, device="cpu") -> int:
    """Nonempty 128x128 tiles of the single-device layout of
    :func:`build_adj_tiles_from_relay`, counted without building it: one
    sort of the edges' ``(column tile, row tile)`` codes on ``device``.
    What the relay engine's ``auto`` arm holds against its tile budget
    before any tile is built.  Memoized per layout object while it lives
    (:data:`_TILE_COUNTS`)."""
    cached = _TILE_COUNTS.get(id(rg))
    if cached is not None:
        return cached
    src, dst = _relay_edges(rg, torch.device(device))
    nt = 0
    if src.numel():
        code = torch.sort((dst >> 7) * (round_up(rg.vr, TILE) // TILE + 1) + (src >> 7)).values
        del src, dst
        nt = int(1 + (code[1:] != code[:-1]).sum())
    _TILE_COUNTS[id(rg)] = nt
    weakref.finalize(rg, _TILE_COUNTS.pop, id(rg), None)
    return nt


#: ``id(layout) -> nonempty tile count`` of :func:`count_tiles_from_relay`,
#: each entry dropped when its layout is collected.
_TILE_COUNTS: dict[int, int] = {}


def tiles_nbytes(nt: int, rows: int, cols: int) -> int:
    """Bytes of a tile layout of ``nt`` nonempty tiles over ``rows`` x
    ``cols`` (:attr:`AdjTiles.nbytes`), known without building it: the
    arrays of :func:`_finalize`, padded to at least one tile, with the
    superblock index and the key table's pad block."""
    ntp = max(int(nt), 1)
    rtp = round_up(rows, TILE)
    vtp = round_up(max(cols, 1), SB_VERTS)
    return ntp * (TILE_BYTES + 8) + 4 * (vtp // SB_VERTS + 1) + 4 * (rtp + TILE)


def resolve_tiles_builder(builder: str | None = None) -> str:
    """The tile builder: explicit arg > ``BFS_TPU_TORCH_TILES_BUILD`` >
    ``device`` (``host`` is the pinned numpy oracle)."""
    from .. import knobs

    builder = builder or knobs.get("BFS_TPU_TORCH_TILES_BUILD")
    if builder not in ("device", "host"):
        raise ValueError(f"unknown tiles builder {builder!r}; use device|host")
    return builder


def build_adj_tiles_from_relay(
    rg, builder: str | None = None, budget_bytes: int | None = None,
    device="cpu",
) -> AdjTiles:
    """The single-device layout: rows == cols == the relay ``vr``, keys
    ``new2old``.  ``builder`` (:func:`resolve_tiles_builder`) ``device``
    runs the torch builder on ``device``; ``host`` runs the numpy oracle
    on the CPU, the builder for a layout the card cannot hold while it
    builds.

    Unlike the reference, a failure of the device builder is not retried
    on the host oracle: on the card the tiles must end up on the card
    either way (21 GB at R-MAT scale 22), so the host could not rescue an
    out-of-memory, and on the CPU both builders run on the same machine.
    An over-budget layout raises ``ValueError`` before any tile is
    allocated."""
    builder = resolve_tiles_builder(builder)
    keys2d = keys_from_new2old(rg.new2old, rg.vr)
    if builder == "host":
        deg = np.diff(np.asarray(rg.adj_indptr[: rg.vr + 1], dtype=np.int64))
        src = np.repeat(np.arange(rg.vr, dtype=np.int64), deg)
        return build_adj_tiles_host(
            src, np.asarray(rg.adj_dst, dtype=np.int64), rows=rg.vr, cols=rg.vr,
            keys2d=keys2d, budget_bytes=budget_bytes,
        )
    src, dst = _relay_edges(rg, torch.device(device))
    return build_adj_tiles_device(
        src, dst, rows=rg.vr, cols=rg.vr, keys2d=keys2d,
        budget_bytes=budget_bytes, device=device,
    )


def _shard_edges(srg, s: int) -> tuple[np.ndarray, np.ndarray]:
    """(src, dst) host edge lists of shard ``s`` of a sharded relay layout:
    global relabeled sources from its CSR rows, LOCAL destinations."""
    gtot = srg.num_shards * srg.block
    indptr = np.asarray(srg.adj_indptr[s][: gtot + 1], dtype=np.int64)
    src = np.repeat(np.arange(gtot, dtype=np.int64), np.diff(indptr))
    return src, np.asarray(srg.adj_dst[s][: src.shape[0]], dtype=np.int64)


def count_tiles_sharded(srg, device="cpu") -> list[int]:
    """Nonempty tiles of each shard's layout of
    :func:`build_adj_tiles_sharded`, counted without building any: one
    sort of a shard's ``(column tile, row tile)`` codes on ``device`` at a
    time."""
    rbp = round_up(srg.num_shards * srg.block, TILE) // TILE + 1
    counts = []
    for s in range(srg.num_shards):
        src, dst = (torch.from_numpy(a).to(device) for a in _shard_edges(srg, s))
        code = torch.sort((dst >> 7) * rbp + (src >> 7)).values
        del src, dst
        counts.append(int(1 + (code[1:] != code[:-1]).sum()) if code.numel() else 0)
    return counts


def iter_adj_tiles_sharded(
    srg, builder: str | None = None, budget_bytes: int | None = None, device="cpu",
):
    """Shard ``s``'s tile layout for ``s = 0, 1, ...``, one at a time (a
    caller that stacks them frees each before the next is built), as
    :func:`build_adj_tiles_sharded` builds them."""
    builder = resolve_tiles_builder(builder)
    gtot = srg.num_shards * srg.block
    keys2d = keys_from_new2old(srg.new2old, gtot)
    for s in range(srg.num_shards):
        src, dst = _shard_edges(srg, s)
        if builder == "host":
            yield build_adj_tiles_host(src, dst, rows=gtot, cols=srg.block, keys2d=keys2d,
                                       budget_bytes=budget_bytes)
        else:
            yield build_adj_tiles_device(torch.from_numpy(src), torch.from_numpy(dst), rows=gtot,
                                         cols=srg.block, keys2d=keys2d,
                                         budget_bytes=budget_bytes, device=device)


def build_adj_tiles_sharded(
    srg, builder: str | None = None, budget_bytes: int | None = None, device="cpu",
) -> list[AdjTiles]:
    """Per-shard tile layouts of a sharded relay layout (the mesh's MXU
    arm): shard ``s`` tiles the GLOBAL relabeled sources (``rows = n *
    block``, the all-gathered frontier words are the expansion's input)
    against its own destination block (``cols = block``), from its CSR
    ``adj_indptr[s]``/``adj_dst[s]``; keys are the global ``new2old``.
    ``budget_bytes`` applies to each shard.  ``builder`` as in
    :func:`build_adj_tiles_from_relay`, with no retry of a failed device
    build on the host."""
    return list(iter_adj_tiles_sharded(srg, builder, budget_bytes, device))


def num_superblocks(at: AdjTiles) -> int:
    """Column superblocks of a layout: the streaming transfer unit."""
    return int(at.vtp // SB_VERTS)


def sb_span(at: AdjTiles, g: int) -> tuple[int, int]:
    """Tile span ``[lo, hi)`` of column superblock ``g``: real tiles only
    (the pad tiles' ``col_id = vtp // TILE`` sorts past every span, so
    ``sb_indptr[num_superblocks] == nt``)."""
    return int(at.sb_indptr[g]), int(at.sb_indptr[g + 1])


def sb_row_blocks(at: AdjTiles, g: int) -> np.ndarray:
    """Ascending unique frontier row blocks (``row_idx`` values) that
    superblock ``g``'s tiles read: the input of the streamed arm's demand
    set."""
    lo, hi = sb_span(at, g)
    return np.unique(at.row_idx[lo:hi].cpu().numpy())


def _popcount32(words: torch.Tensor) -> torch.Tensor:
    """Set bits per uint32 word (int32 patterns), SWAR in int64."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x + (x >> 8) + (x >> 16) + (x >> 24)) & 0x3F


def tile_occupancy_hist(at: AdjTiles) -> dict:
    """Per-tile set-bit histogram over power-of-two buckets, with the
    reference's keys: a vectorised popcount over chunks of tiles on the
    layout's device."""
    edges = [1, 16, 64, 256, 1024, 4096, TILE * TILE + 1]
    bounds = torch.tensor(edges, dtype=torch.int64, device=at.device)
    counts = torch.zeros(len(edges) + 1, dtype=torch.int64, device=at.device)
    total = 0
    for lo in range(0, max(at.nt, 0), _HIST_CHUNK):
        pops = _popcount32(at.tiles[lo : min(lo + _HIST_CHUNK, at.nt)]).sum(dim=(1, 2))
        total += int(pops.sum())
        counts += torch.bincount(torch.bucketize(pops, bounds, right=True), minlength=len(edges) + 1)
    counts = counts.tolist()
    hist = {f"{lo}-{hi - 1}": counts[i + 1] for i, (lo, hi) in enumerate(zip(edges[:-1], edges[1:]))}
    return {
        "tiles": int(at.nt),
        "tile_bytes": int(at.nt) * TILE_BYTES,
        "edge_bits": total,
        "mean_fill": total / at.nt / (TILE * TILE) if at.nt > 0 else 0.0,
        "buckets": hist,
    }


# ------------------------------------------------------------------------
# The tiles bundle (cache/layout.load_or_build_tiles): the reference's
# schema, uint32 words as the reference stores them, so a bundle written by
# either package loads in the other.
# ------------------------------------------------------------------------

def tiles_to_arrays(at: AdjTiles) -> dict[str, np.ndarray]:
    def host(t: torch.Tensor, dtype=np.int32) -> np.ndarray:
        return t.cpu().numpy().view(dtype)

    return {
        "dims": np.array([TILES_VERSION, at.rows, at.cols, at.rtp, at.vtp, at.nt],
                         dtype=np.int64),
        "tiles": host(at.tiles, np.uint32),
        "row_idx": host(at.row_idx),
        "col_id": host(at.col_id),
        "sb_indptr": host(at.sb_indptr),
        "keys2d": host(at.keys2d, np.uint32),
    }


def _tensor(a, dtype) -> torch.Tensor:
    """A CPU int32 tensor over ``a``'s words without a copy: a bundle's
    large arrays are read-only memmaps, which no code of the port writes
    (torch warns about any non-writable array)."""
    a = np.asarray(a)
    if a.dtype != dtype:
        a = a.astype(dtype)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(a.view(np.int32))


def tiles_from_arrays(z) -> AdjTiles:
    dims = np.asarray(z["dims"])
    if int(dims[0]) != TILES_VERSION:
        raise ValueError(f"adj-tiles schema version {int(dims[0])}")
    return AdjTiles(
        rows=int(dims[1]), cols=int(dims[2]), rtp=int(dims[3]), vtp=int(dims[4]),
        nt=int(dims[5]),
        tiles=_tensor(z["tiles"], np.uint32), row_idx=_tensor(z["row_idx"], np.int32),
        col_id=_tensor(z["col_id"], np.int32), sb_indptr=_tensor(z["sb_indptr"], np.int32),
        keys2d=_tensor(z["keys2d"], np.uint32),
    )
