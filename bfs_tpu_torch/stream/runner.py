"""The streamed superstep loop, the port of ``bfs_tpu.stream.runner``:
adjacency paged from the host store, the state on the card.

It runs the bodies of the engine's own schedule (``RelayEngine._next_body``
picks each superstep's body, the sparse body runs push levels) with the
MXU expansion of a pull level split by column superblock:

    resident:  one ``mxu_expand`` over every tile, keyed ``col_id``
    streamed:  one ``mxu_expand`` per demanded superblock slab, keyed
               ``col_local``, into rows ``[g * 16384, (g + 1) * 16384)``
               of one candidate grid (``out=``)

Superblocks partition the destinations and the minimum is exact and
order-free, so the grid equals the resident expansion's for any demand set
that covers every live tile, which :func:`.prefetch.demand_set` does.  K4
(``packed_update``) or the unpacked merge then applies the grid exactly as
the resident MXU superstep does.

Checkpoints use the engine's segment keys and carry
(``RelayEngine.segment_keys``, ``segment_carry``): a streamed run resumes a
segmented run's epoch and the reverse, a reference epoch (``mu``/``prev``)
resumes through the engine's restore rule, and a killed run resumes with a
cold cache and the same schedule (the cache holds derived content only).

The loop is driven from the host: a pull level needs the frontier words on
the host for its demand set, and slabs change address from level to level,
so nothing is captured in a CUDA graph.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..graph.adj_tiles import SB_VERTS
from ..models import loop as L
from ..obs import telemetry as T
from ..ops import control as C
from ..ops import relay as R
from ..ops import relay_cuda as K
from ..ops import sparse as S
from ..ops.packed import (
    INT32_MAX,
    PACKED_MAX_LEVELS,
    packed_cap,
    packed_dist,
    packed_parent,
    packed_truncated,
)
from .cache import SuperblockCache
from .prefetch import demand_set, iter_prefetched
from .store import HostTileStore

__all__ = ["run_streamed"]


def store_for(eng) -> HostTileStore:
    """The engine's host store: cut at engine init in stream mode, or now
    from its resident layout (``auto`` over the budget at run time)."""
    store = getattr(eng, "_stream_store", None)
    if store is None:
        store = HostTileStore(eng.adj_tiles, pin=eng.device.type == "cuda")
        eng._stream_store = store
    return store


def cache_for(eng, store: HostTileStore, budget_bytes: int | None) -> SuperblockCache:
    """The engine's cache, kept across runs of one budget.  Every cache of
    an engine uploads on the engine's one copy stream: the device blocks
    that the caching allocator keeps per stream then serve a new cache
    too, where a new stream would allocate anew (the allocator then
    frees and synchronises when the card is full)."""
    from ..ops.relay_mxu import stream_cache_budget_bytes

    budget = stream_cache_budget_bytes() if budget_bytes is None else int(budget_bytes)
    cache = getattr(eng, "_stream_cache", None)
    if cache is None or cache.budget_bytes != budget:
        if eng.device.type == "cuda" and eng._stream_copy is None:
            eng._stream_copy = torch.cuda.Stream(eng.device)
        cache = SuperblockCache(store, budget_bytes=budget, device=eng.device,
                                copy_stream=eng._stream_copy)
        eng._stream_cache = cache
    return cache


def keys2d_for(eng) -> torch.Tensor:
    """The key table on the engine's device (O(V), like the state), one
    copy: the resident operands' where the engine holds them (``auto``),
    else shipped once from the host store."""
    if eng.mxu_operands is not None:
        return eng.mxu_operands[3]
    if eng._stream_keys2d is None:
        eng._stream_keys2d = store_for(eng).keys2d.to(eng.device)
    return eng._stream_keys2d


def _counters_delta(after: dict, before: dict) -> dict:
    return {k: int(after[k]) - int(before[k]) for k in after}


class _HostWords:
    """Frontier words to the host: one pinned buffer and one wait on a
    card, a view on the CPU."""

    def __init__(self, fw: torch.Tensor):
        self.buf = torch.empty(fw.shape, dtype=fw.dtype, pin_memory=True) \
            if fw.device.type == "cuda" else None

    def __call__(self, fw: torch.Tensor) -> np.ndarray:
        if self.buf is None:
            return fw.numpy()
        self.buf.copy_(fw, non_blocking=True)
        torch.cuda.current_stream(fw.device).synchronize()
        return self.buf.numpy()


def _pull(eng, store, cache, st, grid, keys2d, host_words):
    """One streamed pull superstep: the demand set from the frontier on the
    host, the grid cleared, ``mxu_expand`` per demanded superblock through
    the cache (the next slab's upload in flight under each launch), then
    the candidates applied as the resident MXU superstep applies them.
    Returns ``(new state, demanded count)``."""
    rows, cols, rtp, _vtp, _ntp = eng.mxu_geometry
    demand = demand_set(store, host_words(st.fwords))
    grid.fill_(-1)
    for g, slab in iter_prefetched(cache, demand):
        slab.wait()
        K.expand_frontier_mxu(
            st.fwords, (*slab, keys2d), rows=rows, cols=SB_VERTS, rtp=rtp, vtp=SB_VERTS,
            out=grid[g * SB_VERTS : (g + 1) * SB_VERTS],
        )
        slab.retire()
    cand = grid[:cols]
    if isinstance(st, R.PackedRelayState):
        return K.apply_relay_candidates_packed(st, cand), int(demand.shape[0])
    return R.apply_relay_candidates(st, torch.where(cand == -1, INT32_MAX, cand)), \
        int(demand.shape[0])


def _run_flavor(eng, store, cache, source: int, ckpt, max_levels: int, packed: bool,
                telemetry: bool):
    """One carry flavor through the streamed loop, an epoch after each
    segment when ``ckpt`` is given: ``(views, LoopStats, ledger rows)``,
    the carry's tensors by epoch key at the end."""
    from ..resilience.superstep_ckpt import restore_arrays

    rg = eng.relay_graph
    vr, mode = rg.vr, eng.direction.mode
    cap = packed_cap(max_levels) if packed else max_levels
    keys = eng.segment_keys(packed, telemetry)
    arrays = None
    if ckpt is not None:
        decision = ("dstate", "use_pull")
        arrays, _ = restore_arrays(
            ckpt, packed, require=tuple(k for k in keys if k not in decision),
            require_any=((decision, ("mu", "prev")),) if eng._auto() else ())
    carry = eng.segment_carry(source, packed=packed, telemetry=telemetry, restore=arrays)
    loop, views = eng._segment_loop(packed, telemetry)
    ctl = loop.ctl
    hybrid = eng._hybrid()
    adj = eng._sparse_tensors_for(packed) if hybrid else None
    level, changed = carry["level"], carry["changed"]
    stats = L.LoopStats(level, changed)
    use_pull = True
    if hybrid and changed and level < cap:
        use_pull = bool(int(ctl[C.USE_PULL]))  # the first (or restored) body
        stats.host_reads += 1
    grid = torch.empty(eng.mxu_geometry[3], dtype=torch.int32, device=eng.device)
    keys2d = keys2d_for(eng)
    host_words = _HostWords(views["fw"])
    state_cls = R.PackedRelayState if packed else R.RelayState
    fields = ("pk",) if packed else ("dist", "parent")
    rows = []
    while changed and level < cap:
        interval = ckpt.interval() if ckpt is not None else cap
        seg_end, seg_start = min(level + interval, cap), level
        t0 = time.perf_counter()
        while changed and level < seg_end:
            L._check_attempt()
            before = cache.counters()
            st = state_cls(*(views[f] for f in fields), views["fw"], level, None)
            if use_pull:
                new, demanded = _pull(eng, store, cache, st, grid, keys2d, host_words)
                row = {"arm": "pull", "demanded": demanded}
                stats.host_reads += 1
            else:
                new = S.sparse_superstep(st, adj, vr)
                row = {"arm": "push", "demanded": 0}
            eng._issued[int(use_pull)] += 1
            for f, t in zip(fields, new[: len(fields)]):
                views[f].copy_(t)  # a no-op where the update ran in place
            views["fw"].copy_(new.fwords)
            level += 1
            if telemetry:
                T.record_frontier_words(views["occ"], views["fw"], level)
                T.record_direction(views["dirs"], level, T.DIR_PULL if use_pull else T.DIR_PUSH)
            if hybrid:
                use = eng._next_body(mode, views.get("dstate"), use_pull, views["fw"], adj)
                both = torch.cat([new.changed.reshape(1).to(torch.int32),
                                  use.reshape(1).to(torch.int32)])
                changed, use_pull = (bool(x) for x in both.tolist())  # the level's read
            else:
                changed = bool(new.changed)
            stats.host_reads += 1
            stats.issued += 1
            stats.live += 1
            row.update(level=level, **_counters_delta(cache.counters(), before))
            rows.append(row)
        seg_s = time.perf_counter() - t0
        if ckpt is not None:
            snap = {}
            if ckpt.enabled:  # a disabled store marks the boundary without the copy
                ctl[C.USE_PULL] = int(use_pull)
                snap = eng._segment_snapshot(views, ctl, keys, level, changed, packed)
            ckpt.save_epoch(level, snap)
            ckpt.note_segment(level - seg_start, seg_s)
    stats.level, stats.changed = level, changed
    return views, stats, rows


def run_streamed(eng, source: int = 0, *, ckpt=None, max_levels: int | None = None,
                 telemetry: bool = False, cache_budget_bytes: int | None = None):
    """Single-source BFS on an MXU :class:`~bfs_tpu_torch.models.bfs.RelayEngine`
    with its tiles paged per superblock from the host store under the
    cache budget (``BFS_TPU_TORCH_STREAM_CACHE_GB``; ``cache_budget_bytes``
    wins): ``dist``/``parent`` and the direction schedule those of the
    resident arm, bit for bit, resumable from ``ckpt``'s epochs.  Returns
    a ``BfsResult``, or ``(BfsResult, curve)`` with ``telemetry``; the
    ledger (per-level arm, demanded superblocks and cache counter deltas)
    lands on ``eng.stream_report``, the loop's counts on ``eng.last_run``.
    A packed run stopped by its 62-level cap runs again unpacked (its
    epochs cleared first)."""
    from ..models.bfs import check_sources

    if eng.expansion != "mxu":
        raise ValueError(
            "streamed traversal needs the mxu expansion arm (RelayEngine(..., expansion='mxu'))")
    rg = eng.relay_graph
    check_sources(rg.num_vertices, source)
    max_levels = int(max_levels) if max_levels is not None else rg.vr
    store = store_for(eng)
    cache = cache_for(eng, store, cache_budget_bytes)
    eng._issued = {0: 0, 1: 0}
    packed = eng.packed
    t0 = time.perf_counter()
    views, stats, rows = _run_flavor(eng, store, cache, source, ckpt, max_levels, packed,
                                     telemetry)
    if packed and packed_truncated(stats.changed, stats.level, max_levels):
        if ckpt is not None:
            ckpt.clear()  # packed epochs cannot feed the unpacked re-run
        packed = False
        views, more, rows = _run_flavor(eng, store, cache, source, ckpt, max_levels, False,
                                        telemetry)
        stats = stats.add(more)
    if ckpt is not None:
        ckpt.clear()
    eng.stream_report = T.stream_report(rows, budget_bytes=cache.budget_bytes,
                                        store=store.report(), cache=cache.report())
    if packed:
        dist, parent = packed_dist(views["pk"]), packed_parent(views["pk"])
    else:
        dist, parent = views["dist"], views["parent"]
    curve = None
    if telemetry:
        fe = T.edge_curve_from_levels(dist, eng.outdeg, dist == INT32_MAX)
        fv, fe, dirs = T.read_telemetry(views["occ"], fe, views["dirs"])
        curve = T.level_curve(fv, fe, cap=min(PACKED_MAX_LEVELS, max_levels) if packed
                              else max_levels)
        cfg = eng.direction
        curve["direction_schedule"] = T.direction_schedule(
            dirs, mode=cfg.mode, alpha=cfg.alpha, beta=cfg.beta)
    t1 = time.perf_counter()
    result = eng._to_result(dist, parent, stats.level, source)
    eng.last_run = {"loop_s": t1 - t0, "result_s": time.perf_counter() - t1,
                    **vars(stats), **eng._issued_counts()}
    return (result, curve) if telemetry else result
