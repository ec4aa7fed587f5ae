"""The push superstep and the carry that the push and pull engines share,
in plain PyTorch.

The port of ``bfs_tpu.ops.relax``: each function computes what its
namesake there computes, on the same inputs, bit for bit.  A superstep is

  * candidates: per destination vertex, the minimum-id active in-neighbour
    (INT32_MAX where none).  Push gathers the frontier over edge sources
    and takes a segmented min over edge destinations
    (``scatter_reduce_(..., "amin")`` on an INT32_MAX-filled tensor, where
    the reference has ``segment_min``); pull (:mod:`.pull`) gathers and
    row-mins over the ELL levels;
  * the merge (:func:`apply_candidates`): only unreached vertices improve,
    at ``level + 1``, and the improved set is the next frontier.

State arrays are ``[V+1]`` (``[S, V+1]`` batched): slot V is the inert
sentinel that padded edges point at.  The packed carry
(:class:`PackedBfsState`) holds ``level:6 | parent:26`` words
(:mod:`.packed`) and runs exactly when ``packed_parent_fits(V)``.

The mesh's push engine (:mod:`bfs_tpu_torch.parallel.sharded`) takes its
candidates from :func:`shard_push_candidates` (the reference's
``axis_name``): each edge shard's candidates, ``src``/``dst`` stacked on
axis 0 (``[n, E/n]``), merged with one ``pmin`` over the mesh axis
(:mod:`bfs_tpu_torch.parallel.compat`); the merge then runs once on the
replicated state, so the ``changed`` of every shard is the same.

Every merge takes an optional control block ``ctl`` (:mod:`.control`):
inside the level loop the level it stamps is ctl's LEVEL word, and a
superstep that is not LIVE selects the old carry in every field, the
frontier included, so a dead superstep changes nothing.  All of it is
device ops without a host read, so a superstep can be captured in a CUDA
graph.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..analysis.runtime import explicit_transfer
from . import control as C
from .packed import INT32_MAX, level_bits, merge_packed, packed_dist, packed_parent

__all__ = [
    "BfsState",
    "PackedBfsState",
    "init_state",
    "init_batched_state",
    "init_packed_state",
    "init_packed_batched_state",
    "apply_candidates",
    "apply_candidates_packed",
    "combine_min",
    "shard_push_candidates",
    "relax_superstep",
    "relax_superstep_packed",
    "relax_superstep_batched",
    "relax_superstep_batched_packed",
    "unpack_bfs_state",
    "frontier_size",
]


class BfsState(NamedTuple):
    """Loop carry: ``dist`` int32 (INT32_MAX unreached), ``parent`` int32
    (-1 unreached, the source itself), ``frontier`` bool, all ``[V+1]`` or
    ``[S, V+1]``; ``level`` an int32 0-d tensor (levels run), ``changed`` a
    bool 0-d tensor (did the last superstep relax anything).  Inside the
    level loop the control block holds level and changed, and the fields
    are passed through."""

    dist: torch.Tensor
    parent: torch.Tensor
    frontier: torch.Tensor
    level: torch.Tensor
    changed: torch.Tensor


class PackedBfsState(NamedTuple):
    """Packed carry: ``packed`` int32 bit patterns of uint32
    ``level:6|parent:26`` words (all ones unreached); the rest as in
    :class:`BfsState`."""

    packed: torch.Tensor
    frontier: torch.Tensor
    level: torch.Tensor
    changed: torch.Tensor


def _scalars(device):
    return (torch.zeros((), dtype=torch.int32, device=device),
            torch.ones((), dtype=torch.bool, device=device))


def _grid(sources, device):
    """Row and column indices of tree s's source, ``(s, sources[s])``."""
    with explicit_transfer():  # the sources' intended upload
        cols = torch.as_tensor([int(x) for x in sources], dtype=torch.int64).to(device)
    return torch.arange(cols.shape[0], device=device), cols


def init_state(num_vertices: int, source: int, device="cpu") -> BfsState:
    """Iteration-0 state: the source at distance 0 on the frontier, its own
    parent; everything else unreached."""
    n, s = num_vertices + 1, int(source)
    dist = torch.full((n,), INT32_MAX, dtype=torch.int32, device=device)
    dist[s].fill_(0)  # device fills: a scalar stored by indexing syncs
    parent = torch.full((n,), -1, dtype=torch.int32, device=device)
    parent[s].fill_(s)
    frontier = torch.zeros(n, dtype=torch.bool, device=device)
    frontier[s].fill_(True)
    return BfsState(dist, parent, frontier, *_scalars(device))


def init_batched_state(num_vertices: int, sources, device="cpu") -> BfsState:
    """Batched state ``[S, V+1]``: tree s seeded at ``sources[s]``; level
    and changed stay scalar (all trees advance in lock-step)."""
    rows, cols = _grid(sources, device)
    shape = (rows.shape[0], num_vertices + 1)
    dist = torch.full(shape, INT32_MAX, dtype=torch.int32, device=device)
    parent = torch.full(shape, -1, dtype=torch.int32, device=device)
    frontier = torch.zeros(shape, dtype=torch.bool, device=device)
    with explicit_transfer():  # the scalar values of the seeds' stores
        dist[rows, cols] = 0
        parent[rows, cols] = cols.to(torch.int32)
        frontier[rows, cols] = True
    return BfsState(dist, parent, frontier, *_scalars(device))


def init_packed_state(num_vertices: int, source: int, device="cpu") -> PackedBfsState:
    """Packed twin of :func:`init_state`: the source's word is
    ``0 << 26 | source``."""
    st = init_state(num_vertices, source, device)
    return PackedBfsState(st.parent, st.frontier, st.level, st.changed)


def init_packed_batched_state(num_vertices: int, sources, device="cpu") -> PackedBfsState:
    """Packed twin of :func:`init_batched_state`."""
    st = init_batched_state(num_vertices, sources, device)
    return PackedBfsState(st.parent, st.frontier, st.level, st.changed)


def _level_live(state, ctl):
    """``(level, live, next level field)``: from the control block inside
    the level loop (live a device bool; the field passed through), else
    the state's level, ``None`` (always live) and ``level + 1``."""
    if ctl is None:
        return state.level, None, state.level + 1
    return ctl[C.LEVEL], ctl[C.LIVE] != 0, state.level


def apply_candidates(state: BfsState, cand_parent: torch.Tensor,
                     ctl: torch.Tensor | None = None) -> BfsState:
    """Merge per-vertex candidate parents (INT32_MAX where none) into the
    carry: an unreached vertex with a candidate takes ``level + 1`` and
    the candidate, and joins the next frontier."""
    level, live, next_level = _level_live(state, ctl)
    improved = (cand_parent != INT32_MAX) & (state.dist == INT32_MAX)
    if live is not None:
        improved = improved & live
    dist = torch.where(improved, level + 1, state.dist)
    parent = torch.where(improved, cand_parent, state.parent)
    frontier = improved if live is None else torch.where(live, improved, state.frontier)
    return BfsState(dist, parent, frontier, next_level, improved.any())


def apply_candidates_packed(state: PackedBfsState, cand_parent: torch.Tensor,
                            ctl: torch.Tensor | None = None) -> PackedBfsState:
    """Packed merge: the candidates become words at ``level + 1`` and merge
    with one unsigned min; the words that changed are the next frontier."""
    level, live, next_level = _level_live(state, ctl)
    cand = torch.where(cand_parent == INT32_MAX, -1, cand_parent | level_bits(level + 1))
    packed = merge_packed(state.packed, cand)
    if live is not None:
        packed = torch.where(live, packed, state.packed)
    improved = packed != state.packed
    frontier = improved if live is None else torch.where(live, improved, state.frontier)
    return PackedBfsState(packed, frontier, next_level, improved.any())


def combine_min(values: torch.Tensor, dst: torch.Tensor, num_segments: int) -> torch.Tensor:
    """One segmented min of per-edge values over edge destinations (the
    dtype's max where a segment has no edge).  ``dst`` is int64, the index
    type of ``scatter_reduce_``; min is order-free, so its atomics are
    exact."""
    out = torch.full((num_segments,), torch.iinfo(values.dtype).max,
                     dtype=values.dtype, device=values.device)
    return out.scatter_reduce_(0, dst, values, "amin")


def _push_candidates(frontier, src, dst, num_segments: int) -> torch.Tensor:
    """Min source id among active in-edges per destination; INT32_MAX where
    none.  ``src`` int32 and ``dst`` int64, ``[E]``."""
    active = frontier.index_select(0, src)
    return combine_min(torch.where(active, src, INT32_MAX), dst, num_segments)


def _batched_push_candidates(frontier, src, dst, num_segments: int) -> torch.Tensor:
    """:func:`_push_candidates` per tree of a ``[S, V+1]`` frontier: one
    ``[E]`` temporary at a time, where the reference materializes
    ``[E, S]``."""
    return torch.stack([_push_candidates(f, src, dst, num_segments) for f in frontier])


def shard_push_candidates(frontier, src, dst, num_segments: int, axis: str | None = None):
    """The push candidates of a single or batched frontier; with a mesh
    ``axis``, of each edge shard of ``src``/``dst`` (``[n, E/n]``), merged
    with one ``pmin`` over it."""
    push = _batched_push_candidates if frontier.dim() == 2 else _push_candidates
    if axis is None:
        return push(frontier, src, dst, num_segments)
    from ..parallel.compat import pmin

    return pmin(torch.stack([push(frontier, s, d, num_segments) for s, d in zip(src, dst)]), axis)


def relax_superstep(state: BfsState, src, dst, ctl=None) -> BfsState:
    """One push superstep over dst-sorted, sentinel-padded edges."""
    cand = _push_candidates(state.frontier, src, dst, state.dist.shape[-1])
    return apply_candidates(state, cand, ctl)


def relax_superstep_packed(state: PackedBfsState, src, dst, ctl=None) -> PackedBfsState:
    """Packed twin of :func:`relax_superstep`."""
    cand = _push_candidates(state.frontier, src, dst, state.packed.shape[-1])
    return apply_candidates_packed(state, cand, ctl)


def relax_superstep_batched(state: BfsState, src, dst, ctl=None) -> BfsState:
    """Batched push superstep over a leading sources axis."""
    cand = _batched_push_candidates(state.frontier, src, dst, state.dist.shape[-1])
    return apply_candidates(state, cand, ctl)


def relax_superstep_batched_packed(state: PackedBfsState, src, dst, ctl=None) -> PackedBfsState:
    """Packed twin of :func:`relax_superstep_batched`."""
    cand = _batched_push_candidates(state.frontier, src, dst, state.packed.shape[-1])
    return apply_candidates_packed(state, cand, ctl)


def unpack_bfs_state(state: PackedBfsState) -> BfsState:
    """The once-per-run unpack at loop exit: packed words back to int32
    dist/parent."""
    return BfsState(packed_dist(state.packed), packed_parent(state.packed),
                    state.frontier, state.level, state.changed)


def frontier_size(state) -> torch.Tensor:
    """Number of frontier vertices (summed over trees when batched)."""
    return state.frontier.sum(dtype=torch.int32)

