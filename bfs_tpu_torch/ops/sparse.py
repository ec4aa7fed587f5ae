"""The relay engine's sparse superstep, plain PyTorch: the push body of its
hybrid schedule.

The port of the sparse half of ``bfs_tpu.models.bfs`` (``SPARSE_BV``,
``sparse_budgets``, ``_extract_frontier_list``, ``_sparse_superstep``,
``_frontier_stats``, ``_take_sparse``, ``_adj_ranks``, ``_adj_keys``,
``_sparse_third``), which is XLA in the reference.  A small frontier's
out-edges are gathered from the layout's CSR (``adj_indptr``, ``adj_dst``)
into fixed shapes, the two budgets, sorted by ``(dst, third)``, and the first
edge of each unreached destination is its update: the canonical min-parent,
because the third array ascends with the original source id within a
destination's row.  The third array is the carry's parent payload: ranks for
the packed gather carry, L1 slots for the unpacked one, original ids
(keys) on the MXU arm.

Every shape is static (``[bv]`` vertices, ``[be]`` edges) and nothing reads
the host, so the superstep can be captured in a CUDA graph.  With a control
block the level is its LEVEL word and a superstep that is not LIVE changes
nothing.  torch has no dropped scatter, so the updates write through one
scratch slot past the end of each state array (the caller's ``ext``
tensors, or fresh copies) and the next frontier's distinct bits are added
into int64 words, then narrowed.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..graph.adj_tiles import _popcount32
from ..graph.relay import _vertex_tables
from . import relay as R
from .control import level_live
from .packed import INT32_MAX, PARENT_BITS, U32, i32, u32

#: The sparse body's budgets: a superstep may take it when the frontier has
#: at most SPARSE_BV vertices and SPARSE_BE out-edges (the reference's).
SPARSE_BV = 32 * 1024
SPARSE_BE = 64 * 1024


class SparseAdjacency(NamedTuple):
    """The sparse body's operands on the device: the layout's CSR over
    relabeled sources (``indptr`` int32[vr+2], ``dst`` int32[E]), the third
    array of one carry flavor (int32[E]) and the out-degrees (int32[vr])."""

    indptr: torch.Tensor
    dst: torch.Tensor
    third: torch.Tensor
    outdeg: torch.Tensor


def sparse_budgets(vr: int, num_adj_entries: int) -> tuple[int, int]:
    """The budgets clamped to the graph: ``(min(SPARSE_BV, vr),
    min(SPARSE_BE, E))``, the static shapes of the sparse superstep."""
    return min(SPARSE_BV, int(vr)), min(SPARSE_BE, int(num_adj_entries))


def adj_ranks(rg) -> np.ndarray:
    """Per-edge rank within the destination's row: the class slot formula
    ``slot = base + rank * stride`` inverted on ``adj_slot``."""
    base, stride = _vertex_tables(list(rg.in_classes), rg.vr)
    d = rg.adj_dst
    return ((rg.adj_slot - base[d]) // np.maximum(stride[d], 1)).astype(np.int32)


def adj_keys(rg) -> np.ndarray:
    """Per-edge ORIGINAL source id (the MXU arm's payload): ``src_l1[adj_slot]``."""
    return np.asarray(rg.src_l1)[np.asarray(rg.adj_slot)].astype(np.int32)


def sparse_third(rg, packed: bool, mxu: bool) -> np.ndarray:
    """The third array of a carry flavor: keys on the MXU arm, ranks for the
    packed gather carry, L1 slots for the unpacked one."""
    if mxu:
        return adj_keys(rg)
    return adj_ranks(rg) if packed else np.asarray(rg.adj_slot, dtype=np.int32)


def extract_frontier_list(fwords: torch.Tensor, vr: int, bv: int) -> torch.Tensor:
    """The set bits of the frontier words ``[..., nw]`` in ascending order,
    padded with ``vr``: int64[..., bv] (one list per row of a leading
    batch).  Word-level select, no ``nonzero`` (which reads the host):
    popcounts and their cumulative sum, the owner word of every output slot
    by ``searchsorted``, then a 5-step binary search for the bit of that
    rank inside the word."""
    nw = fwords.shape[-1]
    cs = torch.cumsum(_popcount32(fwords), -1)  # inclusive
    o = torch.arange(bv, dtype=torch.int64, device=fwords.device)
    o = o.expand(*fwords.shape[:-1], bv).contiguous()
    wc = torch.searchsorted(cs, o, right=True).clamp(0, nw - 1)
    r = o - torch.where(wc > 0, cs.gather(-1, (wc - 1).clamp_min(0)), 0)  # rank inside the word
    x = u32(fwords).gather(-1, wc)
    pos = torch.zeros_like(o)
    for k in (16, 8, 4, 2, 1):
        low = _popcount32(x & ((1 << k) - 1))
        high = r >= low
        r = torch.where(high, r - low, r)
        x = torch.where(high, x >> k, x)
        pos = pos + torch.where(high, k, 0)
    return torch.where(o < cs[..., -1:], wc * 32 + pos, vr)


def _sorted_frontier_edges(fwords: torch.Tensor, adj: SparseAdjacency, vr: int):
    """The frontier's out-edges in ``[be]`` lanes sorted by ``(dst, third)``:
    ``(dst, third, first)``, int64, int64, bool, where ``first`` marks the
    first lane of each real destination (``dst`` is ``vr`` on empty lanes)."""
    bv, be = sparse_budgets(vr, adj.dst.shape[0])
    flist = extract_frontier_list(fwords, vr, bv)
    starts = adj.indptr[flist].to(torch.int64)
    cum = torch.cumsum(adj.indptr[flist + 1].to(torch.int64) - starts, 0)  # 0 at the fill
    j = torch.arange(be, dtype=torch.int64, device=fwords.device)
    owner = torch.searchsorted(cum, j, right=True).clamp(0, bv - 1)
    prev = torch.where(owner > 0, cum[(owner - 1).clamp_min(0)], 0)
    valid = j < cum[-1]
    eidx = torch.where(valid, starts[owner] + (j - prev), 0)
    dst = torch.where(valid, adj.dst[eidx].to(torch.int64), vr)
    # One int64 key sorts lexicographically by (dst, third): both are
    # non-negative int32.
    key = torch.sort((dst << 32) | adj.third[eidx].to(torch.int64)).values
    dk, sk = key >> 32, key & U32
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dk.device), dk[1:] != dk[:-1]])
    return dk, sk, first & (dk < vr)


def sparse_superstep(st, adj: SparseAdjacency, vr: int, ctl: torch.Tensor | None = None,
                     ext: tuple[torch.Tensor, ...] | None = None):
    """One sparse superstep of a packed or unpacked relay carry (what
    ``_sparse_superstep`` computes), bit-exact with the dense superstep on a
    frontier inside the budgets.

    ``ext``: the state arrays with one scratch slot each (``(packed,)`` or
    ``(dist, parent)``, int32[vr+1], of which the state's arrays are the
    first ``vr`` words): written in place, the level loop's carry.  Without
    it they are fresh copies.  With a control block ``ctl`` the level is its
    LEVEL word, nothing changes when the superstep is not LIVE, and the
    returned ``level`` is passed through (the block loop's convention)."""
    packed = isinstance(st, R.PackedRelayState)
    fields = (st.packed,) if packed else (st.dist, st.parent)
    if ext is None:
        ext = tuple(torch.cat([f, f.new_zeros(1)]) for f in fields)
    dk, sk, first = _sorted_frontier_edges(st.fwords, adj, vr)
    at = dk.clamp(max=vr - 1)
    unreached = st.packed[at] == -1 if packed else st.dist[at] == INT32_MAX
    level, live = level_live(ctl, st.level)
    upd = first & unreached
    if live is not None:
        upd = upd & live
    tgt = torch.where(upd, dk, vr)  # vr: the scratch slot
    nw = st.fwords.shape[0]
    words = torch.zeros(nw + 1, dtype=torch.int64, device=dk.device)
    bits = torch.where(upd, torch.ones_like(tgt) << (tgt & 31), 0)
    words.index_add_(0, tgt >> 5, bits)  # distinct bits: + is |
    fwords = i32(words[:nw])
    if live is not None:
        fwords = torch.where(live, fwords, st.fwords)
    new_level = level + 1
    next_level = st.level if ctl is not None else new_level  # the loop keeps it in ctl
    if packed:
        ext[0].index_copy_(0, tgt, i32(sk | ((new_level << PARENT_BITS) & U32)))
        return R.PackedRelayState(ext[0][:vr], fwords, next_level, upd.any())
    ext[0].index_copy_(0, tgt, torch.where(upd, new_level, 0).to(torch.int32))
    ext[1].index_copy_(0, tgt, sk.to(torch.int32))
    return R.RelayState(ext[0][:vr], ext[1][:vr], fwords, next_level, upd.any())


def within_budgets(fsize, fedges, vr: int, num_adj_entries: int) -> torch.Tensor:
    """Does a frontier of ``fsize`` vertices and ``fedges`` out-edges (exact
    integer device scalars) fit the clamped budgets?  The reference compares
    the float32 mass with ``float32(be)``; ``be`` is below 2^24, so the
    exact comparison is the same."""
    bv, be = sparse_budgets(vr, num_adj_entries)
    return (fsize <= bv) & (fedges <= be)


def take_sparse(fwords: torch.Tensor, outdeg: torch.Tensor, vr: int,
                num_adj_entries: int) -> torch.Tensor:
    """THE sparse-path predicate of the ``push`` schedule, a device bool: the
    frontier fits the clamped budgets, with each vertex's degree capped at
    ``be + 1`` (as the reference caps it against uint32 overflow; the sum is
    int64 here, exact, and the cap keeps the predicate the reference's)."""
    _, be = sparse_budgets(vr, num_adj_entries)
    bools = R.unpack_std(fwords, vr) != 0
    fedges = torch.where(bools, outdeg.clamp(max=be + 1), 0).sum(dtype=torch.int64)
    return within_budgets(_popcount32(fwords).sum(), fedges, vr, num_adj_entries)


def frontier_stats(fwords: torch.Tensor, outdeg: torch.Tensor, vr: int):
    """(frontier vertices, frontier out-edges), exact int64 device scalars
    (the reference's int32 edge sum wraps above 2^31)."""
    bools = R.unpack_std(fwords, vr) != 0
    return _popcount32(fwords).sum(), torch.where(bools, outdeg, 0).sum(dtype=torch.int64)
