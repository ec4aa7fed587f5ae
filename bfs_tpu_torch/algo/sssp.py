"""Weighted SSSP as min-plus supersteps with delta-stepping buckets.

The port of ``bfs_tpu.algo.sssp``: the BFS superstep machinery on the
``sssp`` semiring row (:data:`bfs_tpu_torch.algo.substrate.SEMIRINGS`).
Per active edge the contribution is ``dist[src] + w(src, dst)``, the
combine is the same segmented min (:func:`~bfs_tpu_torch.ops.relax.combine_min`)
and the apply keeps the min per destination.  Weights are a hash of the
endpoints (:func:`~bfs_tpu_torch.algo.substrate.edge_weights`), computed on
the device from the resident edge arrays once per edge set and max weight
and kept beside the loops (an :class:`~bfs_tpu_torch.models.bfs.EdgeEngine`'s
``_loops``); they are never shipped from the host.

**Delta-stepping.**  The carry holds a bucket ``threshold`` T, a 0-d int32
device tensor: only dirty vertices with ``dist < T`` relax.  When the
bucket drains with dirty work left, T jumps to ``min(dist[dirty]) + delta``
on the device.  ``delta=inf`` (``BFS_TPU_TORCH_SSSP_DELTA``) is one bucket,
plain frontier Bellman-Ford.  Every delta reaches the same fixpoint; it
only reshapes the superstep schedule.

**The level loop.**  The fused program is a
:class:`~bfs_tpu_torch.models.loop.BlockLoop` over static buffers (the
carry's fields, the control block last), as the push and pull BFS engines
run: each superstep gated by the control block's LIVE word (a dead one
selects the old ``dist``, ``dirty`` and ``threshold`` and raises no flag)
and ended by the control step ``loop_control``; on a card the block is
captured in a CUDA graph once per carry flavour, delta and max weight, and
replayed.  The control block's LEVEL is the reference's ``rounds`` and its
flag the reference's ``changed``: "dirty work remains", not "something
improved", since a bucket-advance round improves nothing and must keep the
loop live.  The round bound goes into the int32 CAP word clamped to
INT32_MAX (:func:`~bfs_tpu_torch.algo.substrate.clamp_cap`).

**Canonical parents.**  Parents are not carried: after the loop one pass
(:func:`_sssp_parents`) takes, per reached vertex, the minimum u among
in-edges with ``dist[u] + w(u, v) == dist[v]``, the same combine, so every
arm gives the same parents as the host Dijkstra oracle.

**Packed arm.**  For ``V < 2^16 - 1`` the carry word is ``dist:16 |
parent:16``, stored as int32 bit patterns (unreached all ones, -1); the
candidates' combine is an unsigned min (the sign bit flipped around
``scatter_reduce_``, as :func:`~bfs_tpu_torch.ops.packed.merge_packed`
does) and the merge is strict on the distance field, so the schedule and
round count equal the unpacked arm's.  Distances clamp at 0xFFFE in
flight; a final distance at the clamp re-runs unpacked, counted in
``truncated_fallbacks``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from ..graph.csr import NO_PARENT, DeviceGraph, Graph, build_device_graph
from ..models import loop as L
from ..ops import control as C
from ..ops import relay_cuda as K
from ..ops.packed import INT32_MAX
from ..ops.relax import combine_min
from .substrate import DEFAULT_MAX_WEIGHT, clamp_cap, drive_segments, edge_weights, resolve_delta

#: Packed-arm capacity: the dist field holds [0, 0xFFFD]; 0xFFFE is the
#: in-flight clamp (the truncation canary), 0xFFFF the unreached sentinel.
PACKED16_DIST_CLAMP = 0xFFFE
PACKED16_UNREACHED = 0xFFFF
#: Parent field capacity: ids in [0, V] with 0xFFFF = no parent, so the
#: packed arm needs V < 0xFFFF.
PACKED16_MAX_V = 0xFFFF

_SIGN = -(1 << 31)  # flips unsigned order onto signed int32 order


def packed16_fits(num_vertices: int) -> bool:
    """True when the dist:16|parent:16 carry can represent this graph."""
    return int(num_vertices) < PACKED16_MAX_V


class SsspState(NamedTuple):
    """Unpacked carry: ``dirty`` marks vertices whose dist improved since
    they last relaxed their out-edges (the delta-stepping work set);
    ``threshold`` is the current bucket's exclusive upper bound.  Inside the
    level loop the control block holds ``rounds`` and ``changed`` and these
    fields pass through."""

    dist: torch.Tensor  # int32[V+1]; INT32_MAX = unreached; slot V inert
    dirty: torch.Tensor  # bool[V+1]
    threshold: torch.Tensor  # int32, 0-d
    rounds: torch.Tensor  # int32, 0-d: supersteps executed
    changed: torch.Tensor  # bool, 0-d: dirty work remains


class PackedSsspState(NamedTuple):
    """Packed twin: ``packed`` holds int32 bit patterns of uint32
    ``dist:16|parent:16`` words (all ones unreached); the rest as in
    :class:`SsspState`."""

    packed: torch.Tensor
    dirty: torch.Tensor
    threshold: torch.Tensor
    rounds: torch.Tensor
    changed: torch.Tensor


def _scalars(delta: int, device):
    return (torch.tensor(int(delta), dtype=torch.int32, device=device),
            torch.zeros((), dtype=torch.int32, device=device),
            torch.ones((), dtype=torch.bool, device=device))


def init_sssp_state(num_vertices: int, source: int, delta: int, device="cpu") -> SsspState:
    n, s = num_vertices + 1, int(source)
    dist = torch.full((n,), INT32_MAX, dtype=torch.int32, device=device)
    dist[s] = 0
    dirty = torch.zeros(n, dtype=torch.bool, device=device)
    dirty[s] = True
    return SsspState(dist, dirty, *_scalars(delta, device))


def init_packed_sssp_state(num_vertices: int, source: int, delta: int,
                           device="cpu") -> PackedSsspState:
    """The source's word is dist 0, parent itself."""
    n, s = num_vertices + 1, int(source)
    packed = torch.full((n,), -1, dtype=torch.int32, device=device)
    packed[s] = s
    dirty = torch.zeros(n, dtype=torch.bool, device=device)
    dirty[s] = True
    return PackedSsspState(packed, dirty, *_scalars(delta, device))


def _d16(packed: torch.Tensor) -> torch.Tensor:
    """The dist field of packed words, int32 in [0, 0xFFFF]."""
    return (packed >> 16) & 0xFFFF


def packed16_dist(packed: torch.Tensor) -> torch.Tensor:
    """int32 distances from packed words (0xFFFF -> INT32_MAX)."""
    d16 = _d16(packed)
    return torch.where(d16 == PACKED16_UNREACHED, INT32_MAX, d16)


def packed16_truncated(packed: torch.Tensor) -> torch.Tensor:
    """Did any final packed distance hit the in-flight clamp (a device
    bool)?  A genuine distance of exactly 0xFFFE also reports truncation
    (conservative: the unpacked re-run is right either way)."""
    return (_d16(packed) == PACKED16_DIST_CLAMP).any()


def _live(ctl: torch.Tensor | None):
    return None if ctl is None else ctl[C.LIVE] != 0


def _advance(frontier, dirty_dist, threshold, delta: int, live):
    """The bucket advance: only when the bucket drained (no frontier) and
    dirty work remains; saturating, so ``delta=inf`` lands on INT32_MAX."""
    min_dirty = dirty_dist.min()
    adv = ~frontier.any() & (min_dirty != INT32_MAX)
    if live is not None:
        adv = adv & live
    return torch.where(adv, min_dirty.clamp(max=INT32_MAX - int(delta)) + int(delta), threshold)


def _tail(state, word_field, dirty, threshold, live):
    """The carry after a superstep: ``rounds`` + 1 and ``changed`` (dirty
    work remains) outside the loop; inside it the fields pass through and
    ``changed`` is false on a dead superstep."""
    changed = dirty.any()
    if live is None:
        return type(state)(word_field, dirty, threshold, state.rounds + 1, changed)
    return type(state)(word_field, dirty, threshold, state.rounds, changed & live)


def _sssp_candidates(dist, frontier, src, dst, w, n: int, axis: str | None):
    """Per destination the min of ``dist[src] + w`` over active in-edges;
    with a mesh ``axis`` each edge shard's (``[n_shards, E/n]`` operands),
    merged with one ``pmin``."""
    if axis is not None:
        from ..parallel.compat import pmin

        return pmin(torch.stack([_sssp_candidates(dist, frontier, s, d, ws, n, None)
                                 for s, d, ws in zip(src, dst, w)]), axis)
    active = frontier.index_select(0, src)
    # The sum wraps where dist is INT32_MAX; those lanes are inactive and
    # masked to the identity before the combine.
    sums = dist.index_select(0, src) + w
    return combine_min(torch.where(active, sums, INT32_MAX), dst, n)


def sssp_superstep(state: SsspState, src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                   delta: int, ctl: torch.Tensor | None = None,
                   axis: str | None = None) -> SsspState:
    """One min-plus superstep: relax the current bucket's dirty vertices,
    then advance the threshold iff the bucket drained with work left.
    ``src`` int32, ``dst`` int64 (the index type of ``scatter_reduce_``),
    ``w`` int32, all ``[E]`` (``[n, E/n]`` edge shards with a mesh
    ``axis``, their candidates merged with one ``pmin``, as the reference's
    ``axis_name``); gated by ``ctl`` in the level loop."""
    n = state.dist.shape[0]
    live = _live(ctl)
    frontier = state.dirty & (state.dist < state.threshold)
    cand = _sssp_candidates(state.dist, frontier, src, dst, w, n, axis)
    improved = cand < state.dist
    if live is not None:
        improved = improved & live
    dist = torch.where(improved, cand, state.dist)
    dirty = (state.dirty & ~frontier) | improved
    if live is not None:
        dirty = torch.where(live, dirty, state.dirty)
    threshold = _advance(frontier, torch.where(dirty, dist, INT32_MAX), state.threshold, delta, live)
    return _tail(state, dist, dirty, threshold, live)


def sssp_superstep_packed(state: PackedSsspState, src: torch.Tensor, dst: torch.Tensor,
                          w: torch.Tensor, delta: int,
                          ctl: torch.Tensor | None = None) -> PackedSsspState:
    """Packed twin: candidates travel as ``dist:16|parent:16`` words through
    one unsigned combine; the merge is strict on the distance field, so the
    schedule equals the unpacked arm's.  ``w`` is at most 0xFFFE."""
    n = state.packed.shape[0]
    live = _live(ctl)
    d16 = _d16(state.packed)
    frontier = state.dirty & (d16 < state.threshold) & (d16 != PACKED16_UNREACHED)
    active = frontier.index_select(0, src)
    sums = (d16.index_select(0, src) + w).clamp_(max=PACKED16_DIST_CLAMP)
    words = (sums << 16) | src
    cand = combine_min(torch.where(active, words, -1) ^ _SIGN, dst, n) ^ _SIGN
    improved = _d16(cand) < d16
    if live is not None:
        improved = improved & live
    packed = torch.where(improved, cand, state.packed)
    dirty = (state.dirty & ~frontier) | improved
    if live is not None:
        dirty = torch.where(live, dirty, state.dirty)
    new_d16 = _d16(packed)
    dirty_dist = torch.where(dirty & (new_d16 != PACKED16_UNREACHED), new_d16, INT32_MAX)
    threshold = _advance(frontier, dirty_dist, state.threshold, delta, live)
    return _tail(state, packed, dirty, threshold, live)


def _sssp_parents(dist: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                 source: int) -> torch.Tensor:
    """Exit-time canonical parents, once after the loop: per reached
    non-source vertex the minimum u over in-edges with ``dist[u] + w(u, v)
    == dist[v]``, by the same combine; NO_PARENT where unreached, the source
    its own parent.  ``dist`` int32 ``[V+1]``."""
    ds = dist.index_select(0, src)
    ok = (ds != INT32_MAX) & (ds + w == dist.index_select(0, dst))
    parent = combine_min(torch.where(ok, src, INT32_MAX), dst, dist.shape[0])
    reached = dist != INT32_MAX
    parent = torch.where(reached & (parent != INT32_MAX), parent, NO_PARENT)
    parent[int(source)] = int(source)
    return parent


# ------------------------------------------------------------ host driver --


@dataclass
class SsspResult:
    """Host-side result in the oracle's shapes: int32[V] ``dist``
    (INT32_MAX = unreached) and canonical int32[V] ``parent``.  ``rounds``
    counts executed supersteps including bucket-advance rounds; ``packed``
    is the carry flavour that produced the result (False after a truncation
    fallback).  ``run`` holds the host seconds and loop counts of the call
    (``loop_s``, ``result_s``, ``host_reads``, ``replays``, ``issued``,
    ``live``), summed over both flavours after a fallback."""

    dist: np.ndarray
    parent: np.ndarray
    rounds: int
    max_weight: int
    delta: int
    packed: bool
    truncated_fallbacks: int = 0
    run: dict = field(default_factory=dict)

    def dist_to(self, v: int) -> int:
        return int(self.dist[v])

    def has_path_to(self, v: int) -> bool:
        return int(self.dist[v]) != int(INT32_MAX)


def _rounds_cap(num_vertices: int, max_weight: int, max_rounds) -> int:
    """Safety bound on supersteps: within a bucket each round extends the
    settled prefix by at least one weight unit, and each advance covers at
    least one dirty vertex, so rounds are at most ``(w_max + 1) * V``.  The
    loop ends on convergence long before it."""
    if max_rounds is not None:
        return int(max_rounds)
    return (int(max_weight) + 1) * (int(num_vertices) + 1)


def edge_operands(graph, device=None, block: int = 1024):
    """``(src int32, dst int64, V, cache, loop)`` of the push form of
    ``graph``: an :class:`~bfs_tpu_torch.models.bfs.EdgeEngine` of
    ``engine='push'`` gives its resident tensors, its ``_loops`` (where the
    weights and the algorithms' loops are kept) and its ``loop`` setting; a
    :class:`Graph` or :class:`DeviceGraph` is padded and shipped to
    ``device`` (the card unless it names the CPU) with a fresh cache."""
    from ..models.bfs import EdgeEngine, resolve_device

    if isinstance(graph, EdgeEngine):
        if getattr(graph, "mesh", None) is not None:
            raise ValueError("a sharded engine: use bfs_tpu_torch.algo.sssp_sharded / cc_sharded")
        if graph.engine != "push":
            raise ValueError(f"an EdgeEngine of {graph.engine!r} given where push is needed")
        return graph.src, graph.dst, graph.num_vertices, graph._loops, graph.loop
    if not isinstance(graph, (Graph, DeviceGraph)):
        raise ValueError(f"needs a Graph, DeviceGraph or push EdgeEngine, got {type(graph).__name__}")
    dev = resolve_device(device)
    dg = graph if isinstance(graph, DeviceGraph) else build_device_graph(graph, block=block)
    src = torch.from_numpy(dg.src).to(dev)
    dst = torch.from_numpy(dg.dst).to(dev, torch.int64)
    return src, dst, dg.num_vertices, {}, "blocks"


def weights(cache: dict, src: torch.Tensor, dst: torch.Tensor, max_weight: int) -> torch.Tensor:
    """The edges' weights at ``max_weight``, computed on their device at
    first use and kept in ``cache``."""
    key = ("weights", int(max_weight))
    w = cache.get(key)
    if w is None:
        w = cache[key] = edge_weights(src, dst, max_weight)
    return w


def _step_weights(cache: dict, src, dst, max_weight: int, packed: bool) -> torch.Tensor:
    """The weights a superstep adds: the packed arm's at most the clamp
    (its sums clamp there anyway, and int32 cannot wrap)."""
    w = weights(cache, src, dst, max_weight)
    if packed and max_weight > PACKED16_DIST_CLAMP:
        w = w.clamp(max=PACKED16_DIST_CLAMP)
    return w


def sssp_loop(cache: dict, src, dst, num_vertices: int, *, packed: bool, delta: int,
              max_weight: int, axis: str | None = None) -> L.BlockLoop:
    """The block loop of one carry flavour, delta and max weight over these
    edges, kept in ``cache``: buffers ``(dist or packed, dirty, threshold,
    ctl)``, each superstep gated by the control block and ended by the
    control step.  ``axis``: the edges are a mesh's shards (unpacked
    carry)."""
    def make():
        dev, n = src.device, num_vertices + 1
        w = _step_weights(cache, src, dst, max_weight, packed)
        fields = (torch.empty(n, dtype=torch.int32, device=dev),
                  torch.empty(n, dtype=torch.bool, device=dev),
                  torch.empty((), dtype=torch.int32, device=dev))
        ctl = C.new_ctl(dev)
        cls, superstep = ((PackedSsspState, sssp_superstep_packed) if packed
                          else (SsspState, sssp_superstep))
        state = cls(*fields, None, None)
        mesh = {} if axis is None else {"axis": axis}  # the sharded arm is unpacked

        def step():
            new = superstep(state, src, dst, w, delta, ctl, **mesh)
            for buf, val in zip(fields, new):
                buf.copy_(val)
            C.raise_flag(ctl, new.changed)
            K.loop_control(ctl)

        return (*fields, ctl), step

    kind = ("sssp", "packed" if packed else "unpacked", int(delta), int(max_weight))
    return L.cached(cache, kind, make, k=L.EDGE_BLOCK)


def _init(packed: bool, v: int, source: int, delta: int, device):
    return (init_packed_sssp_state if packed else init_sssp_state)(v, source, delta, device)


def _search(run_flavor, src, dst, v: int, source: int, *, packed, delta: int,
            max_weight: int, cache: dict, on_fallback=None) -> SsspResult:
    """The flavours of one search: packed when it fits (or ``packed``
    says), re-run unpacked when a final distance hits the 16-bit clamp
    (``on_fallback`` called first); then the canonical parents and both
    arrays to the host.  ``run_flavor(packed)`` runs one flavour and
    returns ``(word field tensor, LoopStats)``."""
    from ..models.bfs import to_host

    use_packed = packed16_fits(v) if packed is None else bool(packed)
    if use_packed and not packed16_fits(v):
        raise ValueError(f"packed16 carry needs V < {PACKED16_MAX_V}, got {v}")
    t0 = time.perf_counter()
    fallbacks, stats = 0, None
    if use_packed:
        words, stats = run_flavor(True)
        if not bool(packed16_truncated(words)):
            dist = packed16_dist(words)
        else:  # clamp hit: the packed dists are not trustworthy
            fallbacks, use_packed = 1, False
            if on_fallback is not None:
                on_fallback()
    if not use_packed:
        dist, more = run_flavor(False)
        stats = more if stats is None else stats.add(more)
    t1 = time.perf_counter()
    parent = _sssp_parents(dist, src, dst, weights(cache, src, dst, max_weight), source)
    dist_h, parent_h = to_host(dist[:v].contiguous(), parent[:v].contiguous())
    run = {"loop_s": t1 - t0, "result_s": time.perf_counter() - t1, **vars(stats)}
    return SsspResult(dist=dist_h, parent=parent_h, rounds=stats.level, max_weight=max_weight,
                      delta=delta, packed=use_packed, truncated_fallbacks=fallbacks, run=run)


def sssp_device(src, dst, num_vertices: int, source: int = 0, *,
                max_weight: int = DEFAULT_MAX_WEIGHT, delta: int | str | None = None,
                max_rounds: int | None = None, packed: bool | None = None,
                cache: dict | None = None, loop: str = "blocks") -> SsspResult:
    """:func:`sssp` on resident, sentinel-padded edge tensors (``src``
    int32, ``dst`` int64; another dtype is converted per call) on their
    device.  ``cache`` keeps the weights and the captured loops across
    calls on the same edges (an :class:`~bfs_tpu_torch.models.bfs.EdgeEngine`'s
    ``_loops``; a fresh dict when None); ``loop="eager"`` runs the plain
    loop (a host read per round).  ``packed=None`` takes the dist:16|parent:16
    carry exactly when it fits and re-runs unpacked when a final distance
    hits the 16-bit clamp."""
    from ..models.bfs import check_sources

    v = int(num_vertices)
    check_sources(v, source)
    source = int(source)
    src = src if src.dtype == torch.int32 else src.to(torch.int32)
    dst = dst if dst.dtype == torch.int64 else dst.to(torch.int64)
    cache = {} if cache is None else cache
    delta_i = resolve_delta(delta)
    cap = clamp_cap(_rounds_cap(v, max_weight, max_rounds))

    def run_flavor(packed: bool):
        init = _init(packed, v, source, delta_i, src.device)
        if loop == "eager":
            w = _step_weights(cache, src, dst, max_weight, packed)
            superstep = sssp_superstep_packed if packed else sssp_superstep
            st, stats = L.eager(init, lambda s: superstep(s, src, dst, w, delta_i), cap)
            return st[0], stats
        bl = sssp_loop(cache, src, dst, v, packed=packed, delta=delta_i, max_weight=max_weight)
        return bl.buffers[0], bl.run(L.start(bl.buffers, init[:3], cap))

    return _search(run_flavor, src, dst, v, source, packed=packed, delta=delta_i,
                   max_weight=max_weight, cache=cache)


def sssp(graph, source: int = 0, *, max_weight: int = DEFAULT_MAX_WEIGHT,
         delta: int | str | None = None, max_rounds: int | None = None,
         packed: bool | None = None, block: int = 1024, device=None) -> SsspResult:
    """Single-source shortest paths on the push layout, on the card unless
    ``device`` names the CPU.  ``graph`` is a :class:`Graph`, a
    :class:`DeviceGraph` or a push :class:`~bfs_tpu_torch.models.bfs.EdgeEngine`
    (whose tensors, loops and ``loop`` setting are used).  Weights are
    ``edge_weights(src, dst, max_weight)``: pass the same ``max_weight`` to
    :func:`bfs_tpu_torch.oracle.sssp.dijkstra` (with
    :func:`~bfs_tpu_torch.algo.substrate.edge_weights_np`) for oracle
    parity."""
    src, dst, v, cache, loop = edge_operands(graph, device, block)
    return sssp_device(src, dst, v, source, max_weight=max_weight, delta=delta,
                       max_rounds=max_rounds, packed=packed, cache=cache, loop=loop)


def sssp_segmented(graph, source: int = 0, *, ckpt, max_weight: int = DEFAULT_MAX_WEIGHT,
                   delta: int | str | None = None, max_rounds: int | None = None,
                   packed: bool | None = None, block: int = 1024, device=None) -> SsspResult:
    """Checkpointed twin of :func:`sssp`: the fused run's own loop cut into
    bounded segments with a durable epoch per boundary
    (:func:`~bfs_tpu_torch.algo.substrate.drive_segments`), bit-identical
    for any segmentation, kill and resume included.  Epochs carry the
    reference's keys and dtypes (``dist`` int32 or ``packed`` uint32,
    ``dirty`` bool, ``threshold``/``rounds`` int32, ``changed`` bool,
    ``packed_flag``), so either package resumes the other's.  Given an
    engine, the loop its fused runs captured serves every segment.  The
    epochs are cleared when the run completes."""
    from ..models.bfs import check_sources
    from ..resilience.superstep_ckpt import epoch_arrays, epoch_tensor

    src, dst, v, cache, _loop = edge_operands(graph, device, block)
    check_sources(v, source)
    source = int(source)
    delta_i = resolve_delta(delta)
    cap = _rounds_cap(v, max_weight, max_rounds)

    def run_flavor(use_packed: bool):
        cls = PackedSsspState if use_packed else SsspState
        bl = sssp_loop(cache, src, dst, v, packed=use_packed, delta=delta_i,
                       max_weight=max_weight)
        fields = dict(zip(cls._fields[:3], bl.buffers[:3]))

        def start(arrays):
            if arrays is None:
                L.start(bl.buffers, _init(use_packed, v, source, delta_i, src.device)[:3], 0)
                return 0, True
            for key, buf in fields.items():  # the 0-d threshold comes back [1]
                buf.copy_(epoch_tensor(arrays[key], src.device, buf.dtype).reshape(buf.shape))
            rounds, changed = int(np.asarray(arrays["rounds"])), bool(np.asarray(arrays["changed"]))
            C.resume_ctl(bl.ctl, rounds, changed, rounds)
            return rounds, changed

        def snapshot(rounds: int, changed: bool) -> dict:
            return epoch_arrays(fields, rounds=np.int32(rounds), changed=np.bool_(changed),
                                packed_flag=np.int32(use_packed))

        stats, _rounds, _changed = drive_segments(ckpt, loop=bl, start=start, snapshot=snapshot,
                                                  fields=cls._fields, packed=use_packed, cap=cap)
        return bl.buffers[0], stats

    # Packed epochs cannot feed the unpacked re-run.
    res = _search(run_flavor, src, dst, v, source, packed=packed, delta=delta_i,
                  max_weight=max_weight, cache=cache, on_fallback=ckpt.clear)
    ckpt.clear()
    return res
