"""The mesh-sharded engine: level-synchronous BFS over partitioned shards,
the shuffle recast as collectives (the port of ``bfs_tpu.parallel.sharded``,
the 1-D mesh).

A ``(batch, graph)`` mesh (:func:`make_mesh`, :class:`~.compat.Mesh`)
partitions the graph over its ``graph`` axis and the sources of a batch
over its ``batch`` axis.  The shards' data is stacked on axis 0 of one
shared shape, all of it on the mesh's one device: plain torch work runs
once over the stacked axis, each kernel is launched once per shard on that
shard's row, and the collectives of :mod:`.compat` merge the shards.  The
three engines of :func:`bfs_sharded` and :func:`bfs_sharded_multi`:

  * ``pull`` (the default) -- vertex-partitioned ELL
    (:class:`~bfs_tpu_torch.graph.ell.ShardedPullGraph`): each shard
    gathers from the global frontier table for its own vertex block, the
    new frontier is exchanged as packed bits (an ``all_gather``);
  * ``push`` -- round-robin edge shards
    (``build_device_graph(num_shards=n)``): per-shard segmented mins
    merged with one ``pmin``, the state replicated;
  * ``relay`` -- per-shard Beneš layouts
    (:class:`~bfs_tpu_torch.graph.relay.ShardedRelayGraph`): each shard runs
    the relay superstep for its own vertices, kernels K1-K3 (``apply_benes``
    and ``rowmin_ranks`` of :mod:`bfs_tpu_torch.ops.relay_cuda`) and the
    packed update K4 once per shard; the new frontier goes through the
    exchange arms of :mod:`.exchange`.  Single searches take the direction
    policy (``pull``, ``push`` and ``auto``; the push body is the per-shard
    sparse gather, plain torch, as the reference's is XLA) and level
    curves with the exchange's bytes; a batch is the lock-step batch, one
    launch of the batch kernels per shard for all its trees.

Every superstep is a step of the port's level loop
(:mod:`bfs_tpu_torch.models.loop`): gated by the control block, captured
in a CUDA graph on a card, one host read per block (per superstep on the
direction schedule's switch loop).  The engine classes
(:class:`ShardedPullEngine`, :class:`ShardedPushEngine`,
:class:`ShardedRelayEngine`) are the stateful API, as ``RelayEngine`` is:
an engine holds its device operands and captured loops, so a caller that
keeps it replays them; :func:`bfs_sharded` and :func:`bfs_sharded_multi`
build an engine for one call and drop it.

Results are bit-identical to the single-chip engines and the oracle: the
relay engine's parents are per-shard L1 slots (ranks on the packed carry),
mapped back to original ids on the device.  ``expansion="auto"`` resolves
to gather on the mesh, as in the reference (the mesh has no probe);
``expansion="mxu"`` is the MXU arm: each shard tiles the global sources
against its own destination block
(:func:`~bfs_tpu_torch.graph.adj_tiles.build_adj_tiles_sharded`), and its
dense body is kernel K6 (``expand_frontier_mxu``) once per shard on the
global frontier words, whose candidates are original ids, then K4 per
shard; no Beneš mask is shipped on that arm.

:func:`bfs_sharded_segmented` (:meth:`ShardedRelayEngine.run_segmented`)
is the resumable search: the same captured loop in bounded segments, one
epoch of per-shard state files after each
(:mod:`bfs_tpu_torch.resilience.superstep_ckpt`), a lost shard file falling
back to the last complete epoch.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..analysis.runtime import explicit_transfer
from ..graph.csr import DeviceGraph, Graph, build_device_graph
from ..graph.ell import ShardedPullGraph, build_sharded_pull_graph, device_ell_sharded
from ..graph.relay import ShardedRelayGraph, _vertex_tables, build_sharded_relay_graph, valid_slot_words
from ..models import loop as L
from ..models.bfs import BfsResult, EdgeEngine, check_sources, to_host
from ..models.multisource import MultiBfsResult
from ..obs import telemetry as T
from ..ops import control as C
from ..ops import relay as R
from ..ops import relay_cuda as K
from ..ops import relay_mxu as RM
from ..ops import sparse as S
from ..ops.packed import (
    INT32_MAX,
    PACKED_MAX_LEVELS,
    U32,
    packed_cap,
    packed_dist,
    packed_parent,
    packed_parent_fits,
    packed_rank_fits,
    packed_truncated,
)
from ..ops.pull import _rowmin_level, _with_inf, unpack_frontier_blocks
from ..ops.relax import shard_push_candidates
from .compat import BATCH_AXIS, GRAPH_AXIS, Mesh, all_gather
from .exchange import ExchangeConfig, bitmap_gather, exchange_report, make_exchange, resolve_exchange

__all__ = [
    "BATCH_AXIS",
    "GRAPH_AXIS",
    "ShardedPullEngine",
    "ShardedPushEngine",
    "ShardedRelayEngine",
    "bfs_sharded",
    "bfs_sharded_multi",
    "bfs_sharded_segmented",
    "make_mesh",
    "sharded_segment_carry",
    "sharded_segment_keys",
]


def make_mesh(graph: int | None = None, batch: int = 1, *,
              devices: Sequence | None = None) -> Mesh:
    """A ``(batch, graph)`` mesh over ``devices`` (the visible cards when
    None, as the reference takes ``jax.devices()``); ``graph=None`` takes
    all the devices the batch axis leaves.  A device may be named more than
    once: ``devices=[torch.device("cpu")] * 8`` stacks 8 shards on the
    CPU, ``[torch.device("cuda")] * 4`` 4 shards on one card.  Raises when
    the mesh needs more entries than it was given."""
    devices = mesh_devices(devices)
    if graph is None:
        graph = len(devices) // batch
    if batch < 1 or graph < 1 or batch * graph > len(devices):
        raise ValueError(f"mesh {batch}x{graph} needs {batch * graph} devices, have {len(devices)}")
    return Mesh([devices[r * graph:(r + 1) * graph] for r in range(batch)])


def mesh_devices(devices: Sequence | None) -> list:
    """``devices`` as a list, or the visible cards when None (raises
    without a card: there is no CPU fallback)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices=[torch.device('cpu')] * n "
                               "to run the plain PyTorch path")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return list(devices)


def _graph_shards(mesh: Mesh) -> int:
    return mesh.shape[GRAPH_AXIS]


def _resolve_mesh(mesh: Mesh | None) -> Mesh:
    return make_mesh() if mesh is None else mesh


def _check_shards(layout, mesh: Mesh) -> int:
    """The mesh's shard count, which ``layout`` must have been built for."""
    n = _graph_shards(mesh)
    if layout.num_shards != n:
        raise ValueError(f"{type(layout).__name__} has {layout.num_shards} shards but mesh axis "
                         f"'{GRAPH_AXIS}' has {n}; rebuild it with num_shards={n}")
    return n


def _sources_tensor(sources, device) -> torch.Tensor:
    with explicit_transfer():  # the sources' intended upload
        return torch.as_tensor(np.asarray(sources, dtype=np.int64)).to(device)


def _source_words(gtot: int, sources: np.ndarray, device) -> torch.Tensor:
    """Global standard-packed frontier words with each tree's source bit:
    ``[gtot/32]`` for one source, ``[S, gtot/32]`` for a batch."""
    src = np.atleast_1d(np.asarray(sources, dtype=np.int64))
    words = np.zeros((src.shape[0], gtot // 32), dtype=np.uint32)
    words[np.arange(src.shape[0]), src >> 5] = np.uint32(1) << (src & 31).astype(np.uint32)
    with explicit_transfer():  # the seeds' intended upload
        out = torch.from_numpy(words.view(np.int32)).to(device)
    return out[0] if np.ndim(sources) == 0 else out


def _block_fill(t: torch.Tensor, block: int, sources, value) -> None:
    """Write ``value`` (a scalar or one value per tree) at each tree's
    source in a shard-stacked ``[n, block]`` or ``[n, S, block]`` array:
    global id ``g`` is shard ``g // block``, slot ``g % block``."""
    src = np.atleast_1d(np.asarray(sources, dtype=np.int64))
    vals = np.array(np.broadcast_to(np.asarray(value, dtype=np.int64), src.shape))
    with explicit_transfer():  # the seeds' intended stores
        shard = torch.as_tensor(src // block).to(t.device)
        slot = torch.as_tensor(src % block).to(t.device)
        v = torch.as_tensor(vals).to(t.device, t.dtype)
        if t.dim() == 2:
            t[shard, slot] = v
        else:
            t[shard, torch.arange(src.shape[0], device=t.device), slot] = v


def _run_stats(stats: L.LoopStats, t0: float, t1: float) -> dict:
    return {"loop_s": t1 - t0, "result_s": time.perf_counter() - t1, **vars(stats)}


# -------------------------------------------------------------------- push --

class ShardedPushEngine(EdgeEngine):
    """Edge shards on the mesh (``engine='push'``; the reference's
    ``_bfs_sharded_fused`` and ``_bfs_sharded_multi_fused``): the
    :class:`~bfs_tpu_torch.models.bfs.EdgeEngine` level loop and carries
    over replicated ``[V+1]`` state (unpacked, as the reference's), whose
    candidates are each shard's segmented min merged with one ``pmin``."""

    def __init__(self, dg: DeviceGraph, mesh: Mesh):
        n = _check_shards(dg, mesh)
        self.mesh = mesh
        self.device = mesh.device
        self.engine = "push"
        self.layout = dg
        self.src = torch.from_numpy(np.ascontiguousarray(dg.src.reshape(n, -1))).to(self.device)
        self.dst = torch.from_numpy(np.ascontiguousarray(dg.dst.reshape(n, -1))).to(
            self.device, torch.int64)
        self.num_vertices = dg.num_vertices
        self.packed = False
        self.loop = "blocks"
        self._loops: dict = {}
        self.last_run: dict = {}

    def candidates(self, state) -> torch.Tensor:
        f = state.frontier
        return shard_push_candidates(f, self.src, self.dst, f.shape[-1], GRAPH_AXIS)


# -------------------------------------------------------------------- pull --

class PullShardState(NamedTuple):
    """The sharded pull carry: ``dist``/``parent`` shard-stacked ``[n,
    (S,) block]``, ``fwords`` the global frontier words ``[(S,) n*block/32]``;
    ``level`` a host int (``None`` in the level loop, where the control
    block holds it) and ``changed`` a device bool."""

    dist: torch.Tensor
    parent: torch.Tensor
    fwords: torch.Tensor
    level: int | None
    changed: torch.Tensor | None


class ShardedPullEngine:
    """Vertex-partitioned pull on the mesh (``engine='pull'``; the
    reference's ``_bfs_sharded_pull_fused`` and its multi twin).

    Shard ``s`` owns vertices ``[s*block, (s+1)*block)``: ``dist`` and
    ``parent`` are shard-stacked ``[n, block]`` (``[n, S, block]`` for a
    batch), the frontier is the global packed words ``[n*block/32]``
    (``[S, ...]``), refreshed each superstep by an ``all_gather`` of every
    shard's new bits (1 bit a vertex, where the push engine merges the
    whole candidate array).  The shards' ELL levels are laid side by side
    on the device (``[K, n*rows]``, each fold's indices offset to its
    shard's rows), so every level is one gather and row-min for all
    shards."""

    def __init__(self, spg: ShardedPullGraph, mesh: Mesh):
        n = _check_shards(spg, mesh)
        self.mesh, self.layout, self.device = mesh, spg, mesh.device
        self.n, self.block = n, spg.block
        self.nw = spg.block // 32
        self.gtot = n * spg.block
        self.num_vertices = spg.num_vertices
        ell0, folds = device_ell_sharded(spg, self.device)
        k = ell0.shape[1]
        self.rows = [ell0.shape[2]] + [f.shape[2] for f in folds]
        self.ell0 = ell0.permute(1, 0, 2).reshape(k, -1)
        self.folds = []
        for f, prev in zip(folds, self.rows):
            off = (torch.arange(n, dtype=torch.int32, device=self.device) * (prev + 1))[:, None, None]
            self.folds.append((f + off).permute(1, 0, 2).reshape(k, -1))
        del ell0, folds
        self.gids = torch.arange(self.gtot, dtype=torch.int32, device=self.device)
        self.loop = "blocks"
        self._loops: dict = {}
        self.last_run: dict = {}

    def _rows(self, tab: torch.Tensor) -> torch.Tensor:
        """Every shard's row-mins for its own block from the frontier table
        ``[..., gtot+1]`` (the INF slot last): ``[..., n, block]``."""
        lead, n = tab.shape[:-1], self.n
        cand = _rowmin_level(tab, self.ell0)
        for fold, prev in zip(self.folds, self.rows):
            ext = _with_inf(cand.reshape(*lead, n, prev))
            cand = _rowmin_level(ext.reshape(*lead, n * (prev + 1)), fold)
        return cand.reshape(*lead, n, self.rows[-1])[..., : self.block]

    def superstep(self, st: PullShardState, ctl: torch.Tensor | None = None) -> PullShardState:
        """One superstep: each shard's candidates, the merge into its
        block, the new frontier all-gathered; gated by ``ctl`` in the level
        loop."""
        dist, parent, fwords = st[:3]
        bits = unpack_frontier_blocks(fwords, self.n, self.nw)
        cand = self._rows(_with_inf(torch.where(bits, self.gids, INT32_MAX)))
        if dist.dim() == 3:  # [S, n, block] -> shard-stacked [n, S, block]
            cand = cand.movedim(-2, 0)
        level, live = C.level_live(ctl, st.level)
        improved = (cand != INT32_MAX) & (dist == INT32_MAX)
        if live is not None:
            improved = improved & live
        dist = torch.where(improved, level + 1, dist).to(torch.int32)
        parent = torch.where(improved, cand, parent)
        words = all_gather(R.pack_std(improved), GRAPH_AXIS, tiled=True, dim=improved.dim() - 2)
        if live is not None:
            words = torch.where(live, words, fwords)
        nxt = st.level if ctl is not None else st.level + 1
        return PullShardState(dist, parent, words, nxt, improved.any())

    def init(self, sources):
        """The carry of a search (``sources`` an int) or a batch (an
        array) at level 0."""
        shape = (self.n, self.block) if np.ndim(sources) == 0 else (
            self.n, len(sources), self.block)
        dist = torch.full(shape, INT32_MAX, dtype=torch.int32, device=self.device)
        parent = torch.full(shape, -1, dtype=torch.int32, device=self.device)
        _block_fill(dist, self.block, sources, 0)
        _block_fill(parent, self.block, sources, sources)
        return dist, parent, _source_words(self.gtot, sources, self.device)

    def _loop(self, trees: int | None) -> L.BlockLoop:
        def make():
            lead = () if trees is None else (trees,)
            fields = tuple(torch.empty(shape, dtype=torch.int32, device=self.device) for shape in (
                (self.n, *lead, self.block), (self.n, *lead, self.block), (*lead, self.gtot // 32)))
            ctl = C.new_ctl(self.device)

            # bfs_tpu_torch: hot captured
            def step():
                new = self.superstep(PullShardState(*fields, None, None), ctl)
                for buf, val in zip(fields, new[:3]):
                    buf.copy_(val)
                C.raise_flag(ctl, new.changed)
                K.loop_control(ctl)

            return (*fields, ctl), step

        return L.cached(self._loops, ("pull", trees), make, k=L.EDGE_BLOCK)

    def _search(self, sources, max_levels: int):
        init = self.init(sources)
        if self.loop == "eager":
            st, stats = L.eager(PullShardState(*init, 0, True), self.superstep, max_levels)
            return st[:2], stats
        loop = self._loop(None if np.ndim(sources) == 0 else len(sources))
        stats = loop.run(L.start(loop.buffers, init, max_levels))
        return loop.buffers[:2], stats

    def run(self, source: int, *, max_levels: int | None = None) -> BfsResult:
        v = self.num_vertices
        check_sources(v, source)
        t0 = time.perf_counter()
        (dist, parent), stats = self._search(int(source), int(max_levels or v))
        t1 = time.perf_counter()
        dist, parent = to_host(dist.reshape(-1)[:v].contiguous(), parent.reshape(-1)[:v].contiguous())
        self.last_run = _run_stats(stats, t0, t1)
        return BfsResult(dist=dist, parent=parent, num_levels=stats.level)

    def run_multi(self, sources, *, max_levels: int | None = None) -> MultiBfsResult:
        v = self.num_vertices
        sources = np.atleast_1d(np.asarray(sources, dtype=np.int32))
        check_sources(v, sources)
        t0 = time.perf_counter()
        (dist, parent), stats = self._search(sources.astype(np.int64), int(max_levels or v))
        t1 = time.perf_counter()

        def flat(t):
            return t.movedim(0, 1).reshape(len(sources), -1)[:, :v].contiguous()

        dist, parent = to_host(flat(dist), flat(parent))
        self.last_run = _run_stats(stats, t0, t1)
        return MultiBfsResult(sources=sources, dist=dist, parent=parent, num_levels=stats.level)


# ------------------------------------------------------------------- relay --

def _own_word_table(srg: ShardedRelayGraph) -> np.ndarray:
    """The compact exchange's real-word table: int32[n, kw] of LOCAL word
    indices (within each shard's ``block/32`` frontier words) holding at
    least one real vertex, each row padded by repeating its last index.
    The unified class structure pads every shard to the max over shards,
    so only these words carry frontier bits."""
    n, block = srg.num_shards, srg.block
    real = (np.asarray(srg.new2old).reshape(n, block) != -1).reshape(n, block // 32, 32).any(axis=2)
    kw = max(int(real.sum(axis=1).max()), 1)
    rows = []
    for s in range(n):
        idx = np.flatnonzero(real[s]).astype(np.int32)
        if idx.size == 0:
            idx = np.zeros(1, np.int32)
        rows.append(np.concatenate([idx, np.full(kw - idx.size, idx[-1], np.int32)]))
    return np.stack(rows)


def _sharded_adj_ranks(srg: ShardedRelayGraph) -> np.ndarray:
    """Per-edge within-row RANKS of the per-shard adjacency (the packed
    carry's payload): ``slot = base + rank * stride`` inverted with the
    shared local vertex tables."""
    base1, stride1 = _vertex_tables(list(srg.in_classes), srg.block)
    d = np.clip(srg.adj_dst, 0, srg.block - 1)
    return ((srg.adj_slot - base1[d]) // np.maximum(stride1[d], 1)).astype(np.int32)


def _sharded_adj_keys(srg: ShardedRelayGraph) -> np.ndarray:
    """Per-edge ORIGINAL source ids of the per-shard adjacency (the MXU
    arm's payload, its candidates' format): ``src_l1[shard][slot]``."""
    slots = np.clip(srg.adj_slot, 0, srg.src_l1.shape[1] - 1)
    shard = np.arange(srg.adj_slot.shape[0])[:, None]
    return np.where(srg.adj_slot >= 0, srg.src_l1[shard, slots], srg.adj_slot).astype(np.int32)


class ShardedTiles(NamedTuple):
    """The mesh's MXU operands, stacked on axis 0 by shard: ``tiles``
    ``[n, ntp, 128, 4]``, ``row_idx``/``col_id`` ``[n, ntp]`` (each shard
    padded to the largest ``ntp`` with inert tiles), ``sb_indptr``, and
    ``keys2d`` (the global key table, one copy a shard); ``geometry`` is
    ``(rows, cols, rtp, vtp, ntp)``, shared by every shard; ``info`` the
    tile counts, bytes and build seconds."""

    tiles: torch.Tensor
    row_idx: torch.Tensor
    col_id: torch.Tensor
    sb_indptr: torch.Tensor
    keys2d: torch.Tensor
    geometry: tuple
    info: dict

    def shard(self, s: int) -> tuple:
        """Shard ``s``'s operand tuple of ``expand_frontier_mxu``."""
        return self.tiles[s], self.row_idx[s], self.col_id[s], self.keys2d[s]


def _sharded_tiles_dev(srg: ShardedRelayGraph, device, budget_bytes: int,
                       builder: str | None = None) -> ShardedTiles:
    """Every shard's tile layout (:func:`~bfs_tpu_torch.graph.adj_tiles.
    build_adj_tiles_sharded`) stacked on ``device``.  The tiles are counted
    first (every shard held against ``budget_bytes`` before any is built),
    the stacked arrays allocated once, and each shard built and copied into
    its row, then freed: the peak is the stack plus one shard."""
    from ..graph import adj_tiles as AT

    t0 = time.perf_counter()
    n, block = srg.num_shards, srg.block
    host = AT.resolve_tiles_builder(builder) == "host"
    counts = AT.count_tiles_sharded(srg, "cpu" if host else device)
    for nt in counts:
        AT._check_budget(nt, budget_bytes)
    ntp = max(max(counts), 1)
    rtp, vtp = AT.round_up(n * block, AT.TILE), AT.round_up(max(block, 1), AT.SB_VERTS)
    i32 = dict(dtype=torch.int32, device=device)
    tiles = torch.empty((n, ntp, AT.TILE, AT.TILE_WORDS), **i32)
    row_idx = torch.full((n, ntp), rtp // AT.TILE, **i32)
    col_id = torch.full((n, ntp), vtp // AT.TILE, **i32)
    sb_indptr = torch.empty((n, vtp // AT.SB_VERTS + 1), **i32)
    keys2d = None
    for s, at in enumerate(AT.iter_adj_tiles_sharded(srg, builder, budget_bytes, device)):
        k = at.ntp
        tiles[s, :k].copy_(at.tiles)
        tiles[s, k:].zero_()
        row_idx[s, :k].copy_(at.row_idx)
        col_id[s, :k].copy_(at.col_id)
        sb_indptr[s].copy_(at.sb_indptr)
        if keys2d is None:
            keys2d = at.keys2d.to(device).unsqueeze(0).repeat(n, 1, 1)
        del at
    live = sum(max(nt, 1) for nt in counts)
    info = {"nt": counts, "ntp": ntp, "tile_bytes": n * ntp * AT.TILE_BYTES,
            "pad_bytes": (n * ntp - live) * AT.TILE_BYTES,
            "build_s": time.perf_counter() - t0}
    return ShardedTiles(tiles, row_idx, col_id, sb_indptr, keys2d,
                        (n * block, block, rtp, vtp, ntp), info)


def _per_shard(n: int, shape: tuple, device, fn) -> torch.Tensor:
    """``fn(s, out_row)`` for each shard, stacked into one ``[n, *shape]``
    int32 tensor: on a card the kernel writes its row in place, on the CPU
    its plain version's result is copied in."""
    out = torch.empty((n, *shape), dtype=torch.int32, device=device)
    for s in range(n):
        row = out[s]
        got = fn(s, row)
        if got.data_ptr() != row.data_ptr():
            row.copy_(got)
    return out


class ShardedRelayEngine:
    """Per-shard relay layouts on the mesh (``engine='relay'``; the
    reference's ``_bfs_sharded_relay_fused``, its segmented twin
    ``_bfs_sharded_relay_segment`` and ``_bfs_sharded_relay_multi_fused``).

    Shard ``s`` owns the block ``[s*block, (s+1)*block)`` of the global
    relabeled space.  The carry is shard-stacked: ``packed`` ``[n, block]``
    (``level:6|rank:26`` words, ``level:6|parent:26`` on the MXU arm) or
    ``dist``/``parent`` (parents per-shard L1 slots, original ids on the
    MXU arm), ``[n, S, block]`` for a batch; the frontier is the global
    words ``[n*block/32]``, the head of the vperm network's input (its
    tail stays zero).  A dense superstep, per shard, on the gather arm:
    the vperm network on the global words (K1, K2: ``apply_benes`` with
    the shard's masks), the broadcast (torch, once for all shards), the
    net network (K1, K2), the row-min against the shard's valid slots
    (K3, ``rowmin_ranks``); on the MXU arm (``expansion="mxu"``) the
    global words against the shard's tiles (K6, ``expand_frontier_mxu``),
    the min original id per owned vertex.  Then the update:
    ``packed_update`` (K4) on the packed carry, its improved bits the
    shard's send words, or the unpacked merge (torch); then the exchange
    (:mod:`.exchange`) and the control step.

    :meth:`run` is one search (with the direction schedule, telemetry and
    the exchange arms), :meth:`run_segmented` the same search in bounded
    segments with an epoch of per-shard state after each, resumable, and
    :meth:`run_multi` the lock-step batch (gather arm only, as the
    reference's).  ``expansion`` (``auto|gather|mxu``, default
    ``BFS_TPU_TORCH_EXPANSION``): ``auto`` is gather, as in the
    reference; ``mxu`` builds every shard's tiles on the mesh's device
    (``tiles_budget_bytes`` per shard, default 4 GiB; over it raises) and
    ships no Beneš mask and no valid-slot words."""

    def __init__(self, srg: ShardedRelayGraph, mesh: Mesh, *, expansion: str | None = None,
                 tiles_budget_bytes: int | None = None):
        n = _check_shards(srg, mesh)
        self.mesh, self.layout, self.device = mesh, srg, mesh.device
        dev = self.device
        self.n, self.block = n, srg.block
        self.nw, self.gtot = srg.block // 32, n * srg.block
        self.expansion, self.packed = _resolve_sharded_expansion(
            expansion, srg, packed_rank_fits(srg.in_classes))
        self.tiles_budget_bytes = (RM.DEFAULT_TILES_BUDGET_BYTES if tiles_budget_bytes is None
                                   else int(tiles_budget_bytes))

        def ship(words) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)).to(dev)

        self.vperm_masks = self.net_masks = self.valid_words = self.src_l1 = None
        self.tiles: ShardedTiles | None = None
        if self.expansion == "mxu":
            self.tiles = _sharded_tiles_dev(srg, dev, self.tiles_budget_bytes)
        else:
            self.vperm_masks = ship(srg.vperm_masks)
            self.net_masks = ship(srg.net_masks)
            self.valid_words = ship(np.stack([valid_slot_words(srg.src_l1[s], srg.net_size)
                                              for s in range(n)]))
            self.src_l1 = torch.from_numpy(np.ascontiguousarray(srg.src_l1, dtype=np.int32)).to(dev)
        self.own = torch.from_numpy(_own_word_table(srg).astype(np.int64)).to(dev)
        self.kw = int(self.own.shape[1])
        self.old2new = torch.from_numpy(np.asarray(srg.old2new, dtype=np.int64)).to(dev)
        self.outdeg = None if srg.outdeg is None else torch.from_numpy(
            np.asarray(srg.outdeg, dtype=np.int32)).to(dev)
        self._adj: dict = {}
        self._loops: dict = {}
        self.last_run: dict = {}

    # -- the superstep's pieces ------------------------------------------------

    def _dense_ranks(self, fin: torch.Tensor, ctl) -> torch.Tensor:
        """Every shard's min active rank per owned vertex (sentinel where
        none) from the vperm input words ``fin`` (``[vp/32]`` or ``[S,
        vp/32]``): ``[n, (S,) block]``."""
        srg, n, dev = self.layout, self.n, self.device
        lead = tuple(fin.shape[:-1])
        y = _per_shard(n, (*lead, srg.vperm_size // 32), dev, lambda s, o: K.apply_benes(
            fin, self.vperm_masks[s], srg.vperm_table, srg.vperm_size, out=o, ctl=ctl))
        l2 = R.broadcast_l2(y, srg.out_classes, srg.net_size, srg.out_space)
        l1 = _per_shard(n, (*lead, srg.net_size // 32), dev, lambda s, o: K.apply_benes(
            l2[s], self.net_masks[s], srg.net_table, srg.net_size, out=o, ctl=ctl))
        return _per_shard(n, (*lead, self.block), dev, lambda s, o: K.rowmin_ranks(
            l1[s], self.valid_words[s], srg.in_classes, self.block, out=o, ctl=ctl))

    def _dense_keys(self, fw: torch.Tensor, ctl) -> torch.Tensor:
        """Every shard's min ORIGINAL id candidate per owned vertex (-1
        where none) from the global frontier words ``fw`` (``[gtot/32]``):
        K6 once per shard against its tiles, ``[n, block]``."""
        rows, cols, rtp, vtp, _ = self.tiles.geometry
        return _per_shard(self.n, (self.block,), self.device, lambda s, o: K.expand_frontier_mxu(
            fw, self.tiles.shard(s), rows=rows, cols=cols, rtp=rtp, vtp=vtp, ctl=ctl))

    def _dense_cand(self, fin: torch.Tensor, ctl, packed: bool) -> torch.Tensor:
        """The dense body's candidates in the carry's format: ranks with the
        sentinel (gather) or original ids with -1 (MXU) on the packed carry;
        L1 slots or original ids with INT32_MAX on the unpacked one."""
        if self.expansion == "mxu":
            cand = self._dense_keys(fin[: self.gtot // 32], ctl)
            return cand if packed else torch.where(cand == -1, INT32_MAX, cand)
        cand = self._dense_ranks(fin, ctl)
        return cand if packed else R.rank_to_slot(cand, self.layout.in_classes, self.block)

    def adjacency(self, packed: bool) -> S.SparseAdjacency:
        """The push body's per-shard operands ``(indptr [n, gtot+2], dst
        [n, emax], third [n, emax], outdeg [gtot])``, the third array
        original ids on the MXU arm, else ranks (packed carry) or L1 slots,
        shipped at first use."""
        srg = self.layout
        if srg.adj_dst is None or self.outdeg is None:
            raise ValueError("direction='push' needs the per-shard adjacency this "
                             "ShardedRelayGraph lacks; rebuild it with build_sharded_relay_graph "
                             "(use 'pull' or 'auto' to run dense only)")
        flavor = "keys" if self.expansion == "mxu" else "ranks" if packed else "slots"
        adj = self._adj.get(flavor)
        if adj is None:
            shared = next(iter(self._adj.values()), None)
            if shared is None:
                indptr = torch.from_numpy(np.asarray(srg.adj_indptr, dtype=np.int32)).to(self.device)
                dst = torch.from_numpy(np.asarray(srg.adj_dst, dtype=np.int32)).to(self.device)
            else:
                indptr, dst = shared.indptr, shared.dst
            third = (_sharded_adj_keys(srg) if flavor == "keys" else _sharded_adj_ranks(srg)
                     if packed else np.asarray(srg.adj_slot, dtype=np.int32))
            adj = self._adj[flavor] = S.SparseAdjacency(
                indptr, dst, torch.from_numpy(third).to(self.device), self.outdeg)
        return adj

    def _push_cand(self, fw: torch.Tensor, adj: S.SparseAdjacency, unreached: torch.Tensor,
                   packed: bool) -> torch.Tensor:
        """The push body's candidates, in the dense body's format (ranks or
        original ids with the sentinel packed, L1 slots or original ids
        with INT32_MAX unpacked), of
        every shard from the global frontier's list: its out-edges into the
        shard's vertices fanned out through the shard's CSR, sorted by
        ``(local dst, payload)``, the first lane of each unreached
        destination (the sieve: a settled vertex gets none)."""
        n, block, gtot = self.n, self.block, self.gtot
        bv = S.sparse_budgets(gtot, gtot)[0]
        be = S.sparse_budgets(gtot, adj.dst.shape[-1])[1]
        flist = S.extract_frontier_list(fw, gtot, bv)
        starts = adj.indptr[:, flist].to(torch.int64)
        cum = torch.cumsum(adj.indptr[:, flist + 1].to(torch.int64) - starts, dim=1)
        j = torch.arange(be, dtype=torch.int64, device=fw.device).expand(n, be).contiguous()
        owner = torch.searchsorted(cum, j, right=True).clamp(0, bv - 1)
        prev = torch.where(owner > 0, cum.gather(1, (owner - 1).clamp_min(0)), 0)
        valid = j < cum[:, -1:]
        eidx = torch.where(valid, starts.gather(1, owner) + (j - prev), 0)
        dst = torch.where(valid, adj.dst.gather(1, eidx).to(torch.int64), block)
        key = torch.sort((dst << 32) | adj.third.gather(1, eidx).to(torch.int64), dim=1).values
        dk, sk = key >> 32, key & U32
        first = torch.cat([torch.ones((n, 1), dtype=torch.bool, device=fw.device),
                           dk[:, 1:] != dk[:, :-1]], dim=1) & (dk < block)
        upd = first & unreached.gather(1, dk.clamp(max=block - 1))
        cand = torch.full((n, block + 1), -1 if packed else INT32_MAX, dtype=torch.int32,
                          device=fw.device)
        return cand.scatter_(1, torch.where(upd, dk, block), sk.to(torch.int32))[:, :block]

    def dense_launches(self, trees: int | None = None) -> dict:
        """The kernel launches of ONE shard's dense superstep (a search,
        or a lock-step batch of ``trees``), as ``apply_benes`` splits each
        network: per network its outer passes and one local pass, then
        ``class_rowmin`` and, on the packed carry, ``packed_update``; on the
        MXU arm ``mxu_expand`` and ``packed_update``.  A superstep launches
        each ``n`` times this."""
        if self.expansion == "mxu":
            return {"mxu_expand": 1, "packed_update": int(self.packed)}
        srg = self.layout
        counts = {"benes_outer_pass": 0, "benes_local_pass": 0, "class_rowmin": 1,
                  "packed_update": int(self.packed)}
        for table, size in ((srg.vperm_table, srg.vperm_size), (srg.net_table, srg.net_size)):
            tile = K.batch_tile_words(size) if trees is not None and trees > 1 else None
            pre, _, suf, _ = K.split_passes(table, size, tile)
            counts["benes_outer_pass"] += (len(K.outer_plan(table, pre, size))
                                           + len(K.outer_plan(table, suf, size)))
            counts["benes_local_pass"] += 1
        return counts

    # -- the loops -------------------------------------------------------------

    def _single_loop(self, packed: bool, telemetry: bool, mode: str, ex_cfg: ExchangeConfig):
        """The loop of one search's carry: ``(fields..., fin, send, [occ,
        dirs, xbytes, xarms], [dstate], ctl)``.  ``mode`` ``pull`` runs the
        dense superstep in blocks of :data:`~bfs_tpu_torch.models.loop.BLOCK`;
        ``auto`` and ``push`` the switch loop of the sparse and dense
        bodies.  Each superstep ends with the exchange, the telemetry, the
        next body and the control step."""
        key = ("single", packed, telemetry, mode, ex_cfg.key())
        if key in self._loops:
            return self._loops[key]
        dev, n = self.device, self.n
        fields = tuple(torch.empty((n, self.block), dtype=torch.int32, device=dev)
                       for _ in range(1 if packed else 2))
        fin = torch.zeros(self._fin_words(), dtype=torch.int32, device=dev)
        fw = fin[: self.gtot // 32]  # the global frontier; the tail stays zero
        send = torch.zeros((n, self.nw), dtype=torch.int32, device=dev)
        tel = ((T.init_level_acc(device=dev), T.init_dir_acc(device=dev),
                T.init_bytes_acc(device=dev), T.init_dir_acc(device=dev)) if telemetry else ())
        switch = mode in ("auto", "push")
        from ..models import direction as D

        dstate = (torch.zeros(D.DECIDE_WORDS, dtype=torch.float32, device=dev),) if switch else ()
        ctl = C.new_ctl(dev)
        adj = self.adjacency(packed) if switch else None
        exchange = make_exchange(ex_cfg, self.kw, self.nw)

        def unreached():
            return fields[0] == -1 if packed else fields[0] == INT32_MAX

        def make_step(body: int):
            # bfs_tpu_torch: hot captured
            def step():
                if body:
                    cand = self._dense_cand(fin, ctl, packed)
                else:
                    cand = self._push_cand(fw, adj, unreached(), packed)
                update_shards(fields, send, cand, ctl)
                words, nbytes, arm = exchange(send, self.own)
                live = ctl[C.LIVE] != 0
                fw.copy_(torch.where(live, words, fw))
                if telemetry:
                    occ, dirs, xb, xa = tel
                    level = ctl[C.LEVEL] + 1
                    T.record_frontier_words(occ, fw, level, live)
                    T.record_direction(dirs, level, (T.DIR_PUSH, T.DIR_PULL)[body], live)
                    T.record_exchange(xb, xa, level, nbytes, arm, live)
                if switch:
                    next_body(dstate[0], fw, adj.outdeg, self.layout, mode, ctl)
                K.loop_control(ctl)

            return step

        buffers = (*fields, fin, send, *tel, *dstate, ctl)
        if switch:
            loop = L.SwitchLoop(buffers, {0: make_step(0), 1: make_step(1)})
        else:
            loop = L.BlockLoop(buffers, make_step(1), name=f"sharded_relay/{packed}")
        self._loops[key] = loop
        return loop

    def _multi_loop(self, packed: bool, trees: int) -> L.BlockLoop:
        """The lock-step batch's loop: carry ``(fields [n, S, block]..., fin
        [S, vp/32], send [n, S, nw], ctl)``; the dense superstep on every
        tree (the batch kernels per shard), the bitmap exchange per tree."""
        def make():
            srg, dev, n = self.layout, self.device, self.n
            fields = tuple(torch.empty((n, trees, self.block), dtype=torch.int32, device=dev)
                           for _ in range(1 if packed else 2))
            fin = torch.zeros((trees, srg.vperm_size // 32), dtype=torch.int32, device=dev)
            fw = fin[:, : self.gtot // 32]
            send = torch.zeros((n, trees, self.nw), dtype=torch.int32, device=dev)
            ctl = C.new_ctl(dev)
            idx = self.own[:, None, :].expand(n, trees, self.kw)

            # bfs_tpu_torch: hot captured
            def step():
                cand = self._dense_cand(fin, ctl, packed)
                update_shards(fields, send, cand, ctl)
                words = bitmap_gather(send.gather(-1, idx), self.own, self.nw)
                fw.copy_(torch.where(ctl[C.LIVE] != 0, words, fw))
                K.loop_control(ctl)

            return (*fields, fin, send, ctl), step

        return L.cached(self._loops, ("multi", packed, trees), make)

    # -- runs ------------------------------------------------------------------

    def _fin_words(self) -> int:
        """Words of the dense body's frontier input: the vperm network's
        input on the gather arm (the global words its head, its tail zero),
        the global words on the MXU arm."""
        return self.gtot // 32 if self.expansion == "mxu" else self.layout.vperm_size // 32

    def _mode(self, cfg) -> str:
        """The schedule a search runs: without the adjacency ``auto`` runs
        dense; ``push`` raises in :meth:`adjacency`."""
        has_adj = self.layout.adj_dst is not None and self.outdeg is not None
        return cfg.mode if has_adj or cfg.mode == "push" else "pull"

    def _start(self, loop, packed: bool, sources, cap: int) -> bool:
        """Start a run in ``loop``'s carry from ``sources`` (relabeled ids:
        an int or an array); returns LIVE."""
        bufs = loop.buffers
        nf = 1 if packed else 2
        fields, fin, send = bufs[:nf], bufs[nf], bufs[nf + 1]
        fields[0].fill_(-1 if packed else INT32_MAX)
        _block_fill(fields[0], self.block, sources, 0)
        if not packed:
            fields[1].fill_(-1)
            _block_fill(fields[1], self.block, sources, sources)
        fin.zero_()
        fin[..., : self.gtot // 32].copy_(_source_words(self.gtot, sources, self.device))
        send.zero_()
        return C.init_ctl(bufs[-1], cap)

    def _begin(self, loop, packed: bool, source_new: int, cap: int, telemetry: bool, mode: str,
               cfg) -> bool:
        """Start one search in a loop of :meth:`_single_loop`: the state,
        the accumulators and, on the switch loop, the first body; returns
        LIVE."""
        live = self._start(loop, packed, source_new, cap)
        nf = 1 if packed else 2
        if telemetry:
            tel = loop.buffers[nf + 2: nf + 6]
            tel[0].copy_(T.init_level_acc(device=self.device))
            for t in tel[1:]:
                t.zero_()
        if mode in ("auto", "push"):
            fw = loop.buffers[nf][: self.gtot // 32]
            loop.ctl[C.USE_PULL] = first_body(loop.buffers[-2], fw, self.adjacency(packed).outdeg,
                                              self.layout, mode, cfg).to(torch.int32)
        return live

    def _run_single(self, source_new: int, cap: int, packed: bool, telemetry: bool, mode: str,
                    ex_cfg: ExchangeConfig, cfg):
        loop = self._single_loop(packed, telemetry, mode, ex_cfg)
        live = self._begin(loop, packed, source_new, cap, telemetry, mode, cfg)
        if mode in ("auto", "push"):
            stats, issued = loop.run(live)
        else:
            stats = loop.run(live)
            issued = {0: 0, 1: stats.issued}
        nf = 1 if packed else 2
        return loop.buffers[:nf], stats, issued, loop.buffers[nf + 2: nf + 6] if telemetry else ()

    def run(self, source: int, *, max_levels: int | None = None, telemetry: bool = False,
            direction: str | None = None, exchange: str | None = None):
        """One search from ``source`` (an original id): a
        :class:`~bfs_tpu_torch.models.bfs.BfsResult`, with ``telemetry``
        ``(result, level curve)`` (the curve holding
        ``direction_schedule`` and ``exchange``).  A packed run cut by the
        62-level cap runs again on the unpacked carry."""
        from ..models.direction import resolve_direction

        srg = self.layout
        check_sources(srg.num_vertices, source)
        cfg = resolve_direction(direction)
        ex_cfg = resolve_exchange(exchange)
        mode = self._mode(cfg)
        max_levels = int(max_levels) if max_levels is not None else srg.num_vertices
        source_new = int(srg.old2new[source])
        t0 = time.perf_counter()
        packed = self.packed
        fields, stats, issued, tel = self._run_single(
            source_new, packed_cap(max_levels) if packed else max_levels, packed, telemetry,
            mode, ex_cfg, cfg)
        if packed and packed_truncated(stats.changed, stats.level, max_levels):
            more_issued = issued
            packed = False
            fields, more, issued, tel = self._run_single(source_new, max_levels, packed, telemetry,
                                                         mode, ex_cfg, cfg)
            stats = stats.add(more)
            issued = {b: issued[b] + more_issued[b] for b in issued}
        return self._result(fields, packed, stats, issued, tel, source, t0, max_levels, cfg, ex_cfg)

    def _result(self, fields, packed: bool, stats, issued: dict, tel, source: int, t0: float,
                max_levels: int, cfg, ex_cfg, **extra):
        """A search's result from its carry's fields: the state decoded
        (:meth:`_decode`) and mapped back (:func:`map_back`), :attr:`last_run`, and with the
        accumulators ``tel`` the level curve."""
        t1 = time.perf_counter()
        dist, parent = to_host(*map_back(*self._decode(fields, packed), source, self.old2new,
                                         self.src_l1))
        self.last_run = {**_run_stats(stats, t0, t1), "issued_push": issued[0],
                         "issued_pull": issued[1], "packed": packed, **extra}
        result = BfsResult(dist=dist, parent=parent, num_levels=stats.level)
        if not tel:
            return result
        fv, dirs, xb, xa = T.read_telemetry(*tel)
        curve = T.level_curve(fv, cap=min(PACKED_MAX_LEVELS, max_levels) if packed else max_levels)
        curve["direction_schedule"] = T.direction_schedule(dirs, mode=cfg.mode, alpha=cfg.alpha,
                                                           beta=cfg.beta)
        curve["exchange"] = exchange_report(xb, xa, ex_cfg, self.kw, self.nw, self.n,
                                            num_levels=result.num_levels)
        return result, curve

    # -- segmented runs (superstep checkpoints) ---------------------------------

    def _segment_views(self, loop, packed: bool, telemetry: bool, mode: str) -> dict:
        """The carry's tensors by epoch key, views of ``loop``'s buffers:
        the state flat in the global shard-major order (``[gtot]``, shard
        ``s`` at ``[s*block, (s+1)*block)``), the global frontier words,
        the accumulators, and on ``auto`` the decision state; the control
        block holds ``level``, ``changed`` and the next body."""
        bufs, nf = loop.buffers, 1 if packed else 2
        views = dict(zip(_state_keys(packed), (f.view(-1) for f in bufs[:nf])))
        views["fw"] = bufs[nf][: self.gtot // 32]
        if telemetry:
            views.update(zip(("occ", "dirs", "xb", "xa"), bufs[nf + 2: nf + 6]))
        if mode == "auto":
            views["dstate"] = bufs[-2]
        return views

    def _segment_carry(self, source: int, packed: bool, telemetry: bool, cfg, ex_cfg,
                       restore: dict | None):
        """:func:`sharded_segment_carry`'s work: ``(loop, views, level,
        changed)``."""
        from ..resilience.superstep_ckpt import epoch_tensor

        srg, mode = self.layout, self._mode(cfg)
        loop = self._single_loop(packed, telemetry, mode, ex_cfg)
        views = self._segment_views(loop, packed, telemetry, mode)
        if restore is None:
            check_sources(srg.num_vertices, source)
            self._begin(loop, packed, int(srg.old2new[source]), 0, telemetry, mode, cfg)
            return loop, views, 0, True
        if telemetry:  # empty accumulators unless the epoch carries them
            views["occ"].copy_(T.init_level_acc(device=self.device))
            for k in ("dirs", "xb", "xa"):
                views[k].zero_()
        loop.buffers[(1 if packed else 2) + 1].zero_()  # the send words
        for key, t in views.items():
            if key in restore:
                t.copy_(epoch_tensor(restore[key], self.device, t.dtype))
        level, changed = int(restore["level"]), bool(restore["changed"])
        use_pull = 0
        if mode in ("auto", "push"):
            use_pull = restored_body(restore, views.get("dstate"), views["fw"],
                                     self.adjacency(packed).outdeg, self.layout, mode, cfg)
        C.resume_ctl(loop.ctl, level, changed, level, use_pull)
        return loop, views, level, changed

    def _segment_snapshot(self, views: dict, ctl: torch.Tensor, keys: list, level: int,
                          changed: bool, packed: bool) -> tuple[dict, list | None]:
        """The carry as an epoch, one copy to the host: ``(meta arrays,
        per-shard state arrays)`` in the reference's dtypes (the occupancy
        and bytes accumulators are int64 here, int32 there; every count fits
        it), or one file's arrays and None on a mesh of one shard."""
        from ..resilience.superstep_ckpt import epoch_arrays

        tensors = {k: views[k] for k in keys if k in views}
        if "use_pull" in keys:
            tensors["ctl"] = ctl
        snap = epoch_arrays(tensors, level=np.int32(level), changed=np.bool_(changed),
                            packed_flag=np.int32(packed))
        if "ctl" in snap:
            snap["use_pull"] = np.int32(snap.pop("ctl")[C.USE_PULL])
        for k in ("occ", "xb"):
            if k in snap:
                snap[k] = snap[k].astype(np.int32)
        if self.n == 1:
            return snap, None
        state = _state_keys(packed)
        shards = [{k: snap[k][s * self.block:(s + 1) * self.block] for k in state}
                  for s in range(self.n)]
        return {k: v for k, v in snap.items() if k not in state}, shards

    def _run_segmented_flavor(self, source: int, ckpt, max_levels: int, packed: bool,
                              telemetry: bool, cfg, ex_cfg):
        """One carry flavor through bounded segments, an epoch after each,
        from the newest valid epoch of that flavor or from the start:
        ``(fields, LoopStats, issued by body, accumulators, copy
        seconds)``."""
        from ..resilience.superstep_ckpt import restore_arrays

        mode = self._mode(cfg)
        cap = packed_cap(max_levels) if packed else max_levels
        keys = sharded_segment_keys(packed, mode == "auto", telemetry)
        state, decision = _state_keys(packed), ("dstate", "use_pull")
        per_shard = self.n > 1
        arrays, shard_arrays = restore_arrays(
            ckpt, packed,
            require=tuple(k for k in keys if k not in decision and not (per_shard and k in state)),
            require_shards=state if per_shard else (),
            require_any=((decision, ("mu", "prev")),) if mode == "auto" else ())
        restore = None if arrays is None else dict(arrays)
        if restore is not None and per_shard:
            # The per-shard state reassembles shard-major into the global view.
            for k in state:
                restore[k] = np.concatenate([sa[k] for sa in shard_arrays])
        loop, views, level, changed = self._segment_carry(source, packed, telemetry, cfg, ex_cfg,
                                                          restore)
        stats, issued, copy_s = L.LoopStats(level, changed), {0: 0, 1: 0}, 0.0
        while changed and level < cap:
            t0 = time.perf_counter()
            seg = loop.segment(min(level + ckpt.interval(), cap), level, changed)
            if isinstance(seg, tuple):  # the switch loop: supersteps by body
                seg, by_body = seg
                for body, k in by_body.items():
                    issued[body] += k
            else:
                issued[1] += seg.issued
            seg_s = time.perf_counter() - t0
            stats = stats.add(seg)
            # A disabled store marks the boundary without the copy to the host.
            meta, shards = {}, None
            if ckpt.enabled:
                t1 = time.perf_counter()
                meta, shards = self._segment_snapshot(views, loop.ctl, keys, seg.level,
                                                      seg.changed, packed)
                copy_s += time.perf_counter() - t1
            ckpt.save_epoch(seg.level, meta, shards)
            ckpt.note_segment(seg.level - level, seg_s)
            level, changed = seg.level, seg.changed
        nf = 1 if packed else 2
        tel = loop.buffers[nf + 2: nf + 6] if telemetry else ()
        return loop.buffers[:nf], stats, issued, tel, copy_s

    def run_segmented(self, source: int, *, ckpt, max_levels: int | None = None,
                      telemetry: bool = False, direction: str | None = None,
                      exchange: str | None = None):
        """One search from ``source`` in bounded segments with an epoch in
        ``ckpt`` (a :class:`~bfs_tpu_torch.resilience.superstep_ckpt.SuperstepCheckpointer`
        built with ``shards`` equal to the mesh's graph axis) after each,
        resuming from its newest complete epoch: the resumable twin of
        :meth:`run`, bit for bit with it (dist, parent, ``num_levels``, the
        direction schedule, the exchange's arms and bytes) for any
        segmentation.  Every segment runs on :meth:`run`'s own captured
        loop, bounded by the segment's end; an epoch is one file per shard
        (its block of the state) and a meta file (the frontier words, the
        decision words and the accumulators), and a lost or damaged shard
        file makes the loader fall back to the last complete epoch, which
        resumes on any engine of the same layout.  A packed run stopped by
        its 62-level cap clears the store and runs again unpacked; the
        epochs are cleared when the run completes.  :attr:`last_run` adds
        ``copy_s``, the host seconds of the carry's copies to the host."""
        from ..models.direction import resolve_direction

        if getattr(ckpt, "shards", 1) != self.n:
            raise ValueError(f"checkpointer built for {getattr(ckpt, 'shards', 1)} shards but the "
                             f"mesh graph axis has {self.n}")
        srg = self.layout
        check_sources(srg.num_vertices, source)
        cfg, ex_cfg = resolve_direction(direction), resolve_exchange(exchange)
        max_levels = int(max_levels) if max_levels is not None else srg.num_vertices
        t0 = time.perf_counter()
        packed = self.packed
        fields, stats, issued, tel, copy_s = self._run_segmented_flavor(
            source, ckpt, max_levels, packed, telemetry, cfg, ex_cfg)
        if packed and packed_truncated(stats.changed, stats.level, max_levels):
            ckpt.clear()  # packed epochs cannot feed the unpacked re-run
            packed = False
            fields, more, more_issued, tel, more_s = self._run_segmented_flavor(
                source, ckpt, max_levels, packed, telemetry, cfg, ex_cfg)
            stats, copy_s = stats.add(more), copy_s + more_s
            issued = {b: issued[b] + more_issued[b] for b in issued}
        ckpt.clear()
        return self._result(fields, packed, stats, issued, tel, source, t0, max_levels, cfg,
                            ex_cfg, copy_s=copy_s)

    def run_multi(self, sources, *, max_levels: int | None = None) -> MultiBfsResult:
        """The lock-step batch of ``sources`` (original ids): every tree
        equals its single search; the loop runs until no tree changes.  On
        the gather arm only, as the reference's batch on the mesh."""
        if self.expansion == "mxu":
            raise ValueError("the lock-step batch on the mesh runs the gather arm, as the "
                             "reference's; build the engine with expansion='gather'")
        srg = self.layout
        sources = np.atleast_1d(np.asarray(sources, dtype=np.int32))
        check_sources(srg.num_vertices, sources)
        max_levels = int(max_levels) if max_levels is not None else srg.num_vertices
        new = np.asarray(srg.old2new, dtype=np.int64)[sources]
        t0 = time.perf_counter()
        packed = self.packed
        loop = self._multi_loop(packed, len(sources))
        stats = loop.run(self._start(loop, packed, new, packed_cap(max_levels) if packed
                                     else max_levels))
        if packed and packed_truncated(stats.changed, stats.level, max_levels):
            packed = False
            loop = self._multi_loop(packed, len(sources))
            stats = stats.add(loop.run(self._start(loop, packed, new, max_levels)))
        t1 = time.perf_counter()
        fields = loop.buffers[: 1 if packed else 2]
        dist, parent = to_host(*map_back(*self._decode(fields, packed), sources, self.old2new,
                                         self.src_l1))
        self.last_run = {**_run_stats(stats, t0, t1), "packed": packed}
        return MultiBfsResult(sources=sources, dist=dist, parent=parent, num_levels=stats.level)

    def _decode(self, fields, packed: bool):
        """Shard-stacked ``(dist, parent)`` from a carry's fields: the
        packed words decoded (ranks to L1 slots per shard on the gather
        arm; the parent field, an original id, on the MXU arm)."""
        if not packed:
            return tuple(fields)
        if self.expansion == "mxu":
            return packed_dist(fields[0]), packed_parent(fields[0])
        return R.unpack_relay_packed(fields[0], self.layout.in_classes, self.block)


def update_shards(fields: tuple, send: torch.Tensor, cand: torch.Tensor, ctl) -> None:
    """The shards' (or the grid's cells') update, gated by ``ctl``, in
    place: on the packed carry ``packed_update`` (K4) once per shard on its
    row (its improved bits into the shard's row of ``send``, the flag
    raised; candidates -1 where none); on the unpacked carry the merge
    (torch, all shards at once; candidates INT32_MAX where none)."""
    if len(fields) == 1:
        for s in range(fields[0].shape[0]):
            K.apply_relay_candidates_packed(R.PackedRelayState(fields[0][s], send[s], None, None),
                                            cand[s], fwords_out=send[s], ctl=ctl)
        return
    dist, parent = fields
    new = R.apply_relay_candidates(R.RelayState(dist, parent, send, None, None), cand, ctl)
    for buf, val in zip((dist, parent, send), new[:3]):
        buf.copy_(val)
    C.raise_flag(ctl, new.changed)


def first_body(dstate, fw: torch.Tensor, outdeg: torch.Tensor, layout, mode: str,
               cfg) -> torch.Tensor:
    """The first superstep's body (True: dense) of a search on the mesh or
    the grid, as the single-chip relay engine decides it, on the global
    frontier words ``fw`` and out-degrees (the exact int64 masses):
    ``push`` takes the sparse body while the frontier fits the budgets,
    ``auto`` starts the decision state ``dstate``."""
    from ..models import direction as D

    gtot, num_edges = layout.num_shards * layout.block, layout.num_edges
    if mode == "push":
        return ~S.take_sparse(fw, outdeg, gtot, num_edges)
    fsize, fedges = D.frontier_masses_words(fw, outdeg, gtot)
    mu0 = outdeg.sum(dtype=torch.int64).to(torch.float32)
    use = D.init_decision(dstate, fsize, fedges, mu0, layout.num_vertices, cfg)
    return use | ~S.within_budgets(fsize, fedges, gtot, num_edges)


def next_body(dstate, fw: torch.Tensor, outdeg: torch.Tensor, layout, mode: str, ctl) -> None:
    """The next superstep's body into USE_PULL from the new global frontier
    ``fw`` (a dead superstep writes nothing)."""
    from ..models import direction as D

    gtot, num_edges = layout.num_shards * layout.block, layout.num_edges
    if mode == "push":
        use = ~S.take_sparse(fw, outdeg, gtot, num_edges)
        ctl[C.USE_PULL] = torch.where(ctl[C.LIVE] != 0, use.to(torch.int32), ctl[C.USE_PULL])
        return
    fsize, fedges = D.frontier_masses_words(fw, outdeg, gtot)
    over = ~S.within_budgets(fsize, fedges, gtot, num_edges)
    D.decide_gated(dstate, ctl, fsize, fedges, force_pull=over)


def restored_body(restore: dict, dstate, fw: torch.Tensor, outdeg: torch.Tensor, layout,
                  mode: str, cfg):
    """The next body of a restored carry on the switch loop: in ``push``
    the frontier's own test; in ``auto`` the epoch's ``use_pull`` or, from
    the reference's ``mu`` and ``prev``, the decision the reference takes
    at the start of its next superstep (``dstate`` restarted from them)."""
    from ..models import direction as D

    gtot, num_edges = layout.num_shards * layout.block, layout.num_edges
    if mode == "push":
        return (~S.take_sparse(fw, outdeg, gtot, num_edges)).to(torch.int32)
    if "use_pull" in restore:
        return int(np.asarray(restore["use_pull"]))
    dstate.zero_()
    dstate[D.ALPHA], dstate[D.BETA] = cfg.alpha, cfg.beta
    dstate[D.NTHRESH] = layout.num_vertices
    dstate[D.MU] = float(np.asarray(restore["mu"]))
    fsize, fedges = D.frontier_masses_words(fw, outdeg, gtot)
    use, dstate[D.MU], dstate[D.FE] = D.decide(dstate, bool(np.asarray(restore["prev"])),
                                               fsize, fedges)
    return (use | ~S.within_budgets(fsize, fedges, gtot, num_edges)).to(torch.int32)


def map_back(dist: torch.Tensor, parent: torch.Tensor, sources, old2new: torch.Tensor,
             src_l1: torch.Tensor | None = None):
    """Shard-stacked relabeled ``(dist, parent)`` (``[n, (S,) block]``) ->
    ORIGINAL ids on the device (the reference's ``_relay_map_back``): with
    ``src_l1`` (the gather arm) a vertex at global id ``g`` is shard ``g //
    block``'s and its parent slot resolves through that shard's row; without
    it (the MXU flavor, the grid) the parents are original ids already and
    only the index space is remapped.  The sources' entries are set to
    themselves."""
    lead, block = dist.shape[1:-1], dist.shape[-1]
    gtot = dist.shape[0] * block
    device = dist.device

    def flat(t):
        return t.movedim(0, -2).reshape(*lead, gtot)

    d, p = flat(dist), flat(parent)
    if src_l1 is not None:
        m1 = src_l1.shape[1]
        shard = torch.arange(gtot, device=device) // block
        at = shard * m1 + p.clamp(0, m1 - 1).to(torch.int64)
        p = torch.where(p >= 0, src_l1.reshape(-1)[at], p)
    d, p = d[..., old2new], p[..., old2new]
    if np.ndim(sources) == 0:
        p[int(sources)].fill_(int(sources))
    else:
        src = _sources_tensor(sources, device)
        with explicit_transfer():  # the sources' self-parents
            p[torch.arange(len(sources), device=device), src] = src.to(torch.int32)
    return d.contiguous(), p.contiguous()


def _state_keys(packed: bool) -> tuple[str, ...]:
    """The epoch keys of the per-shard state."""
    return ("pk",) if packed else ("dist", "parent")


def sharded_segment_keys(packed: bool, auto: bool, telemetry: bool) -> list[str]:
    """The epoch keys of a segmented sharded run's carry: the reference's
    (the state, ``fw``, ``level``, ``changed``, and ``occ``/``dirs``/
    ``xb``/``xa`` with telemetry) and, on the ``auto`` schedule, the port's
    own decision words ``dstate`` and ``use_pull`` where the reference
    keeps ``mu`` and ``prev`` (an epoch of the reference's resumes with
    one decision taken on restore).  The state keys go to the shard files,
    the others to the meta file."""
    keys = [*_state_keys(packed), "fw", "level", "changed"]
    if auto:
        keys += ["dstate", "use_pull"]
    if telemetry:
        keys += ["occ", "dirs", "xb", "xa"]
    return keys


def sharded_segment_carry(eng: ShardedRelayEngine, source: int, *, packed: bool | None = None,
                          telemetry: bool = False, direction: str | None = None,
                          exchange: str | None = None, restore: dict | None = None) -> dict:
    """Start a segmented run of ``eng`` (a :class:`ShardedRelayEngine`) in
    its loop's carry, paused before its first segment: a fresh search from
    ``source``, or the carry of an epoch (``restore``: host arrays by key,
    the per-shard state concatenated shard-major; other keys are ignored).
    Returns the carry's tensors by epoch key with ``level`` and ``changed``
    as host values.  A fresh run on the switch loop takes its first body as
    :meth:`ShardedRelayEngine.run` does; a restored one the body the epoch
    names (:func:`restored_body`)."""
    from ..models.direction import resolve_direction

    packed = eng.packed if packed is None else packed
    _, views, level, changed = eng._segment_carry(source, packed, telemetry,
                                                  resolve_direction(direction),
                                                  resolve_exchange(exchange), restore)
    return {**views, "level": level, "changed": changed}


# -------------------------------------------------------------- entry points --

def _resolve_sharded_expansion(expansion: str | None, srg: ShardedRelayGraph,
                               packed: bool) -> tuple[str, bool]:
    """The mesh's expansion arm and carry flavor, as the reference resolves
    them: ``auto`` and ``gather`` run gather (the mesh has no probe);
    ``mxu`` needs the per-shard adjacency (the tiles are built from it)
    and runs the unpacked carry where ``V`` exceeds the 26-bit packed
    parent field, which holds original ids on this arm.  The port has no
    knob that forces the packed carry, so that case has nothing to
    refuse."""
    if RM.resolve_expansion(expansion) != "mxu":
        return "gather", packed
    if srg.adj_dst is None:
        raise ValueError("expansion='mxu' needs the per-shard adjacency this ShardedRelayGraph "
                         "lacks (the tile builder reads it); rebuild it with "
                         "build_sharded_relay_graph")
    return "mxu", packed and packed_parent_fits(srg.num_vertices)


def _engine(graph, mesh: Mesh, engine: str, block: int = 1024, vertex_block_multiple: int = 1024,
            **relay_kw):
    """The ``engine``'s engine over ``graph`` on ``mesh``: a prebuilt layout
    of its kind is taken as it is (its shard count checked), anything else
    (a Graph, a single-shard DeviceGraph) is built into one; the other
    engines' sharded layouts are refused.  ``relay_kw`` goes to
    :class:`ShardedRelayEngine`."""
    n = _graph_shards(mesh)
    table = {
        "pull": (ShardedPullGraph, ShardedPullEngine,
                 lambda: build_sharded_pull_graph(graph, n, block_multiple=vertex_block_multiple)),
        "push": (DeviceGraph, ShardedPushEngine,
                 lambda: build_device_graph(graph, num_shards=n, block=block)),
        "relay": (ShardedRelayGraph, ShardedRelayEngine,
                  lambda: build_sharded_relay_graph(graph, n, device=mesh.device)),
    }
    if engine not in table:
        raise ValueError(f"unknown engine {engine!r}; use 'relay', 'pull' or 'push'")
    for other in ("pull", "relay"):
        if other != engine and isinstance(graph, table[other][0]):
            raise ValueError(f"a {table[other][0].__name__} only runs on engine='{other}'")
    kind, cls, build = table[engine]
    return cls(graph if isinstance(graph, kind) else build(), mesh, **relay_kw)


def bfs_sharded(
    graph: Graph | DeviceGraph | ShardedPullGraph | ShardedRelayGraph,
    source: int = 0,
    *,
    mesh: Mesh | None = None,
    engine: str = "pull",
    max_levels: int | None = None,
    block: int = 1024,
    vertex_block_multiple: int = 1024,
    telemetry: bool = False,
    direction: str | None = None,
    exchange: str | None = None,
    expansion: str | None = None,
):
    """Single-source BFS sharded over the mesh's ``graph`` axis (on the
    mesh's device; the visible cards when ``mesh`` is None).

    Engines: ``pull`` (the default; vertex-partitioned ELL, the frontier
    exchanged as packed bits), ``push`` (edge shards, candidates merged
    with one ``pmin``: the reference's map/shuffle/reduce), ``relay``
    (per-shard Beneš layouts and kernels).  A prebuilt layout of the
    mesh's shard count skips the build.  Each call builds its engine and
    drops it: hold a :class:`ShardedRelayEngine`, :class:`ShardedPullEngine`
    or :class:`ShardedPushEngine` to replay its captured loops.

    Relay only: ``telemetry`` returns ``(BfsResult, level curve)``, the
    curve with ``direction_schedule`` and ``exchange`` (bytes per level
    and the arm per level, :func:`~.exchange.exchange_report`);
    ``direction`` (``BFS_TPU_TORCH_DIRECTION``) picks the body per
    superstep as the single-chip relay engine does, the same schedule;
    ``exchange`` (``BFS_TPU_TORCH_EXCHANGE``) the frontier exchange arm,
    every arm bit-identical in results; ``expansion``
    (``BFS_TPU_TORCH_EXPANSION``) ``mxu`` runs the MXU arm (each shard's
    tiles built for the call under the default budget of 4 GiB a shard;
    hold a :class:`ShardedRelayEngine` to pass another), ``auto`` and
    ``gather`` the gather arm.  There is no ``applier``: the kernels run on
    a card, their plain versions on the CPU."""
    from ..models.direction import resolve_direction

    mesh = _resolve_mesh(mesh)
    if telemetry and engine != "relay":
        raise ValueError("telemetry is carried by the sharded relay engine only")
    dir_cfg = resolve_direction(direction)
    if engine != "relay":
        return _engine(graph, mesh, engine, block, vertex_block_multiple).run(
            source, max_levels=max_levels)
    resolve_exchange(exchange)  # a bad arm or expansion raises before the layout is built
    RM.resolve_expansion(expansion)
    eng = _engine(graph, mesh, engine, block, vertex_block_multiple, expansion=expansion)
    return eng.run(source, max_levels=max_levels, telemetry=telemetry, direction=dir_cfg.mode,
                   exchange=exchange)


def bfs_sharded_segmented(
    graph: Graph | DeviceGraph | ShardedRelayGraph,
    source: int = 0,
    *,
    mesh: Mesh | None = None,
    ckpt,
    max_levels: int | None = None,
    telemetry: bool = False,
    direction: str | None = None,
    exchange: str | None = None,
    expansion: str | None = None,
):
    """The resumable twin of :func:`bfs_sharded` ``engine='relay'``: one
    search in bounded segments with an epoch of per-shard state in ``ckpt``
    (a :class:`~bfs_tpu_torch.resilience.superstep_ckpt.SuperstepCheckpointer`
    built with ``shards`` equal to the mesh's graph axis, else
    ``ValueError``) after each, resuming from its newest complete epoch;
    bit for bit with the fused search for any segmentation
    (:meth:`ShardedRelayEngine.run_segmented`).  Builds the engine for the
    call and drops it: an epoch resumes on any engine of the same layout."""
    mesh = _resolve_mesh(mesh)
    n = _graph_shards(mesh)
    if getattr(ckpt, "shards", 1) != n:
        raise ValueError(f"checkpointer built for {getattr(ckpt, 'shards', 1)} shards but the "
                         f"mesh graph axis has {n}")
    resolve_exchange(exchange)
    RM.resolve_expansion(expansion)
    eng = _engine(graph, mesh, "relay", expansion=expansion)
    return eng.run_segmented(source, ckpt=ckpt, max_levels=max_levels, telemetry=telemetry,
                             direction=direction, exchange=exchange)


def bfs_sharded_multi(
    graph: Graph | DeviceGraph | ShardedPullGraph | ShardedRelayGraph,
    sources,
    *,
    mesh: Mesh | None = None,
    engine: str = "pull",
    max_levels: int | None = None,
    block: int = 1024,
    vertex_block_multiple: int = 1024,
) -> MultiBfsResult:
    """Batched multi-source BFS: the sources split over the ``batch``
    axis, the graph over ``graph``.  The count of sources must be a
    multiple of the batch axis.  On one device the rows of the batch axis
    run as one lock-step batch of all the sources (the reference's rows
    share the level too: their ``changed`` is a ``pmax`` over both axes).
    ``engine`` as in :func:`bfs_sharded`; every tree equals its single
    search."""
    mesh = _resolve_mesh(mesh)
    sources = np.atleast_1d(np.asarray(sources, dtype=np.int32))
    nb = mesh.shape[BATCH_AXIS]
    if sources.shape[0] % nb != 0:
        raise ValueError(f"{sources.shape[0]} sources not divisible by batch axis {nb}")
    eng = _engine(graph, mesh, engine, block, vertex_block_multiple)
    return eng.run_multi(sources, max_levels=max_levels)
