"""The host tile store: per-superblock operand slabs of the MXU arm's
layout, the port of ``bfs_tpu.stream.store``.

An :class:`~bfs_tpu_torch.graph.adj_tiles.AdjTiles` layout (built on the
card or the host, or loaded from its bundle) is cut once into one slab per
column superblock:

  * ``tiles``     int32[ntp_g, 128, 4]: the superblock's real tiles, padded
                  to a power-of-two count with inert tiles (zero bits,
                  ``row_idx = rtp // 128``, the zero frontier pad block, and
                  ``col_local = SB_TILES``, the dropped overflow column);
  * ``row_idx``   int32[ntp_g]: the frontier row block of each tile;
  * ``col_local`` int32[ntp_g]: the column tile within the superblock.

The padding keeps the reference's slab bytes, so :meth:`sb_bytes`, the
cache's accounting unit, and with it the hit, miss and eviction ledger
equal the reference's under the same budget.  Each slab carries the
reference's blake2b-16 content fingerprint over its padded bytes (uint32
tiles as the reference types them), the cache's key and the check of
verify-on-hit.

On a card the slabs are pinned host tensors, so that their uploads are
asynchronous copies; pinning that fails raises (no pageable fallback).  A
layout on the card is copied straight into the slabs, superblock by
superblock, so no second full host copy is made; the caller then drops the
card's copy.  The fingerprints (tens of GB at scale) are computed on a
thread pool: ``hashlib`` releases the GIL on large buffers.

``keys2d`` (O(V)) stays one resident operand; only the O(E) slabs stream.
"""

from __future__ import annotations

import hashlib
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..graph.adj_tiles import SB_TILES, SB_VERTS, TILE, TILE_WORDS, AdjTiles

__all__ = ["HostTileStore", "superblock_fingerprint"]


def superblock_fingerprint(tiles, row_idx, col_local) -> str:
    """Content key of one padded slab, the reference's: blake2b-16 over the
    dtype- and shape-tagged bytes of the three arrays, ``tiles`` as uint32
    (numpy arrays or CPU tensors of int32 patterns)."""
    h = hashlib.blake2b(digest_size=16)
    for a, dtype in ((tiles, np.uint32), (row_idx, np.int32), (col_local, np.int32)):
        if isinstance(a, torch.Tensor):
            a = a.numpy()
        a = np.ascontiguousarray(a).view(dtype)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(memoryview(a))
    return h.hexdigest()


def _pow2_pad(n: int) -> int:
    """Smallest power of two >= max(n, 1)."""
    p = 1
    while p < max(int(n), 1):
        p <<= 1
    return p


def _index_slab(slab, nt_g: int) -> tuple[str, np.ndarray]:
    """A filled slab's fingerprint and its ascending unique row blocks."""
    return superblock_fingerprint(*slab), np.unique(slab[1][:nt_g].numpy())


class HostTileStore:
    """Immutable per-superblock slabs of one tile layout in host memory
    (pinned with ``pin``).  Read by one host thread; nothing here locks."""

    def __init__(self, at: AdjTiles, *, pin: bool = False):
        self.rows, self.cols, self.rtp, self.vtp, self.nt = (
            int(at.rows), int(at.cols), int(at.rtp), int(at.vtp), int(at.nt))
        self.num_superblocks = int(at.vtp // SB_VERTS)
        self.pinned = bool(pin)
        self.keys2d = at.keys2d.cpu()
        indptr = at.sb_indptr.cpu().numpy().astype(np.int64)
        self._real_tiles = [int(indptr[g + 1] - indptr[g]) for g in range(self.num_superblocks)]
        pad_block = self.rtp // TILE
        on_card = at.tiles.device.type == "cuda"
        self._slabs = []
        pin_s = copy_s = 0.0
        # Each slab is fingerprinted on the pool as soon as it is filled, under
        # the pinning and filling of the next ones.
        with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
            futures = []
            for g, nt_g in enumerate(self._real_tiles):
                t0 = time.perf_counter()
                ntp_g = _pow2_pad(nt_g)
                slab = tuple(torch.empty(shape, dtype=torch.int32, pin_memory=pin)
                             for shape in ((ntp_g, TILE, TILE_WORDS), (ntp_g,), (ntp_g,)))
                t1 = time.perf_counter()
                tiles, row_idx, col_local = slab
                if nt_g:
                    lo, hi = int(indptr[g]), int(indptr[g]) + nt_g
                    tiles[:nt_g].copy_(at.tiles[lo:hi], non_blocking=on_card)
                    row_idx[:nt_g].copy_(at.row_idx[lo:hi], non_blocking=on_card)
                    col_local[:nt_g].copy_(at.col_id[lo:hi] - g * SB_TILES, non_blocking=on_card)
                tiles[nt_g:].zero_()
                row_idx[nt_g:] = pad_block
                col_local[nt_g:] = SB_TILES
                if on_card:
                    torch.cuda.current_stream(at.tiles.device).synchronize()
                pin_s += t1 - t0
                copy_s += time.perf_counter() - t1
                self._slabs.append(slab)
                futures.append(pool.submit(_index_slab, slab, nt_g))
            t2 = time.perf_counter()
            index = [f.result() for f in futures]
        self._fingerprints = [fp for fp, _ in index]
        self._row_blocks = [rb for _, rb in index]
        # The demand set's index: one (superblock, row block) pair per
        # distinct row block a superblock reads.
        self.pair_superblock = np.repeat(
            np.arange(self.num_superblocks, dtype=np.int64),
            [rb.shape[0] for rb in self._row_blocks])
        self.pair_row_block = (np.concatenate(self._row_blocks).astype(np.int64)
                               if self._row_blocks else np.zeros(0, np.int64))
        #: Seconds of the store's build: allocating (pinning) the slabs,
        #: filling them, and waiting for the fingerprints still running after
        #: the last slab was filled.
        self.build_s = {"pin_s": pin_s, "copy_s": copy_s,
                        "fingerprint_s": time.perf_counter() - t2}

    # -- geometry ----------------------------------------------------------------

    def real_tiles(self, g: int) -> int:
        return self._real_tiles[g]

    def pad_tiles(self, g: int) -> int:
        return int(self._slabs[g][0].shape[0])

    def row_blocks(self, g: int) -> np.ndarray:
        """Ascending unique frontier row blocks superblock ``g`` reads."""
        return self._row_blocks[g]

    def fingerprint(self, g: int) -> str:
        return self._fingerprints[g]

    def fetch(self, g: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The padded host slab ``(tiles, row_idx, col_local)``: what the
        cache uploads on a miss."""
        return self._slabs[g]

    def sb_bytes(self, g: int) -> int:
        """Device bytes of superblock ``g``'s padded slab: the cache's
        accounting unit."""
        return sum(t.numel() * t.element_size() for t in self._slabs[g])

    @property
    def nbytes(self) -> int:
        """Host bytes of the slabs and the key table."""
        return (sum(self.sb_bytes(g) for g in range(self.num_superblocks))
                + self.keys2d.numel() * self.keys2d.element_size())

    def report(self) -> dict:
        """The store's shape, with the reference's keys."""
        return {
            "num_superblocks": self.num_superblocks,
            "real_tiles": int(self.nt),
            "host_store_bytes": int(self.nbytes),
            "max_superblock_bytes": max(self.sb_bytes(g) for g in range(self.num_superblocks)),
        }
