"""Beyond device memory: the MXU arm's tiles paged per column superblock,
the port of ``bfs_tpu.stream``.

Every resident arm stops where the adjacency and the state together fill
the card.  The tile layout (:mod:`bfs_tpu_torch.graph.adj_tiles`) sorts by
column superblock, ``sb_indptr`` bounds each superblock's span, and the
kernel skips a tile whose frontier block is zero, so the frontier's live
row blocks say which superblocks a superstep can touch:

  * :mod:`.store`    the pinned host store: per-superblock slabs,
                     pow2-padded and fingerprinted, cut from a layout;
  * :mod:`.cache`    the device cache: a byte-budgeted LRU
                     (``BFS_TPU_TORCH_STREAM_CACHE_GB``) filled on a copy
                     stream, corrupt or evicted entries fetched again and
                     counted;
  * :mod:`.prefetch` the demand set (the kernel's early-out on the host)
                     and the one-superblock lookahead;
  * :mod:`.runner`   the streamed superstep loop: ``mxu_expand`` per
                     demanded superblock, results and schedule those of
                     the resident arm bit for bit, resumable from superstep
                     checkpoints.

``RelayEngine(..., expansion="mxu", tiles_mode="stream")`` (or
``BFS_TPU_TORCH_TILES=stream|auto``) routes ``run`` and ``run_segmented``
here: the packed state stays on the card, the adjacency does not.
"""

from .cache import SuperblockCache
from .prefetch import demand_set, iter_prefetched
from .runner import run_streamed
from .store import HostTileStore

__all__ = [
    "HostTileStore",
    "SuperblockCache",
    "demand_set",
    "iter_prefetched",
    "run_streamed",
]
