"""The streamed arm's demand set and lookahead, the port of
``bfs_tpu.stream.prefetch``.

``mxu_expand`` skips a tile, before reading it, when the tile's 4-word
frontier block is zero.  :func:`demand_set` takes that test out of the
kernel: a superblock is demanded when any of its tiles' row blocks is live
in the frontier, so an undemanded superblock would expand to nothing but
sentinels, the candidate grid's initial value, and skipping its upload
changes no bit.  It runs on the host with numpy over the store's
(superblock, row block) pairs, with no loop over superblocks.

:func:`iter_prefetched` is the reference's one-superblock lookahead: the
next slab's ``cache.get`` (an upload on the cache's copy stream) is issued
before the current slab is handed out, so the copy runs under the current
slab's expansion.
"""

from __future__ import annotations

import numpy as np

from ..graph.adj_tiles import TILE, TILE_WORDS
from .cache import SuperblockCache
from .store import HostTileStore

__all__ = ["frontier_blocks", "demand_set", "iter_prefetched"]


def frontier_blocks(fwords, rtp: int) -> np.ndarray:
    """Frontier words (uint32 or int32 patterns) padded to the row space
    plus one zero pad block, as uint32[rtp // 128 + 1, 4]: row ``b`` is the
    block the kernel reads for a tile with ``row_idx == b``."""
    fw = np.asarray(fwords).reshape(-1).astype(np.uint32, copy=False)
    out = np.zeros(rtp // 32 + TILE // 32, dtype=np.uint32)
    out[: fw.shape[0]] = fw
    return out.reshape(-1, TILE_WORDS)


def demand_set(store: HostTileStore, fwords) -> np.ndarray:
    """Ascending ids (int32) of the superblocks this frontier can touch:
    those with a tile whose frontier row block is nonzero.  A superblock
    without real tiles is never demanded."""
    live = (frontier_blocks(fwords, store.rtp) != 0).any(axis=1)
    hit = store.pair_superblock[live[store.pair_row_block]]
    return np.flatnonzero(np.bincount(hit, minlength=store.num_superblocks)).astype(np.int32)


def iter_prefetched(cache: SuperblockCache, demand):
    """``(g, slab)`` over the demand set, the next slab's upload issued
    before the current one is yielded.  The consumer calls
    ``slab.retire()`` once it has enqueued the slab's expansion; before the
    upload after next, the host waits for the expansion of the slab before
    the current one (``wait_read``), so at most the current slab and the
    next one are in flight beyond the cache: the device's own allocator
    could otherwise fill with slabs still awaiting their expansion while
    the host runs a whole level ahead."""
    it = iter(demand)
    try:
        g = next(it)
    except StopIteration:
        return
    slab, prev = cache.get(int(g)), None
    for nxt in it:
        if prev is not None:
            prev.wait_read()
        nxt_slab = cache.get(int(nxt))  # in flight under g's expansion
        yield int(g), slab
        prev, g, slab = slab, nxt, nxt_slab
    yield int(g), slab
