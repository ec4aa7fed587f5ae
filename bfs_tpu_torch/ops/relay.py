"""Relay superstep v4, plain PyTorch: broadcast -> Beneš bit routing ->
class row-min -> packed state update.

These are the plain versions of the port's kernels
(:mod:`bfs_tpu_torch.ops.relay_cuda`): the CPU path runs them, and the
card's kernels are held against them bit for bit.  Each function computes
what its namesake in ``bfs_tpu.ops.relay`` computes, on the same inputs.

The lock-step batch (:meth:`~bfs_tpu_torch.models.bfs.RelayEngine.run_multi_device`,
the reference's ``vmap`` over a leading sources axis) hands every per-tree
array with a leading axis of S trees: ``[S, n]`` words in place of ``[n]``,
masks, valid words and tables shared.  Each function below takes either;
``changed`` of a batch is any tree's.

Words are uint32 bit patterns stored in ``int32`` tensors, standard
packing (element ``e`` at word ``e >> 5``, bit ``e & 31``).  Shifts,
unsigned mins and compares widen to ``int64 & 0xFFFFFFFF``
(:func:`~bfs_tpu_torch.ops.packed.u32`) and narrow back
(:func:`~bfs_tpu_torch.ops.packed.i32`); XOR, AND, OR and NOT work on the
int32 patterns directly.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..analysis.runtime import explicit_transfer
from ..graph.relay import StageSpec
from .control import level_live
from .packed import (
    INT32_MAX,
    PACKED_SENTINEL,
    PARENT_BITS,
    PARENT_MASK,
    U32,
    i32,
    packed_dist,
    u32,
)

__all__ = [
    "RelayState",
    "PackedRelayState",
    "init_relay_state",
    "init_packed_relay_state",
    "init_relay_batch",
    "pack_std",
    "unpack_std",
    "apply_benes_std",
    "broadcast_l2",
    "rowmin_ranks",
    "early_exit_words",
    "early_exit_bytes",
    "rowmin_candidates",
    "rank_to_slot",
    "apply_relay_candidates",
    "apply_relay_candidates_packed",
    "segment_live",
    "relay_segment_words",
    "slots_to_parent",
    "unpack_relay_packed",
]


class RelayState(NamedTuple):
    """Unpacked carry in the relabeled space of size vr: ``dist`` int32
    (INT32_MAX unreached), ``parent`` int32 L1 slot (-1 unreached),
    ``fwords`` int32[vr/32] frontier words, ``level`` a host int (``None``
    inside the block loop, where the control block holds it), ``changed``
    a device bool/int tensor."""

    dist: torch.Tensor
    parent: torch.Tensor
    fwords: torch.Tensor
    level: int
    changed: torch.Tensor


class PackedRelayState(NamedTuple):
    """Packed carry: ``packed`` int32[vr] of ``level:6|rank:26`` words."""

    packed: torch.Tensor
    fwords: torch.Tensor
    level: int
    changed: torch.Tensor


def _source_fwords(vr: int, source_new: int, device) -> torch.Tensor:
    fwords = torch.zeros(vr // 32, dtype=torch.int32, device=device)
    bit = 1 << (source_new & 31)
    fwords[source_new >> 5].fill_(bit - (1 << 32) if bit >= 1 << 31 else bit)  # a device fill
    return fwords


def init_relay_state(vr: int, source_new: int, device="cpu") -> RelayState:
    source_new = int(source_new)
    dist = torch.full((vr,), INT32_MAX, dtype=torch.int32, device=device)
    dist[source_new].fill_(0)
    parent = torch.full((vr,), -1, dtype=torch.int32, device=device)
    parent[source_new].fill_(source_new)
    return RelayState(
        dist, parent, _source_fwords(vr, source_new, device), 0,
        torch.ones((), dtype=torch.bool, device=device),
    )


def init_packed_relay_state(vr: int, source_new: int, device="cpu") -> PackedRelayState:
    """The source's word is ``level 0 | rank 0``; callers fix the source's
    self-parent up host-side, as on the unpacked path."""
    source_new = int(source_new)
    packed = torch.full((vr,), -1, dtype=torch.int32, device=device)  # sentinel
    packed[source_new].fill_(0)
    return PackedRelayState(
        packed, _source_fwords(vr, source_new, device), 0,
        torch.ones((), dtype=torch.bool, device=device),
    )


def init_relay_batch(vr: int, sources_new, device="cpu", packed: bool = True):
    """The carry of a lock-step batch at iteration 0, one tree per source
    (relabeled ids): :func:`init_packed_relay_state` (``packed``) or
    :func:`init_relay_state` of each source, stacked on a leading axis, as
    the reference's ``vmap`` of them; ``level`` 0, ``changed`` True."""
    src = np.asarray(sources_new, dtype=np.int64).reshape(-1)
    trees = src.shape[0]
    # The batch's inputs placed on the device: an intended upload.
    with explicit_transfer():
        rows = torch.arange(trees, device=device)
        at = torch.from_numpy(src).to(device)
        bits = torch.from_numpy((np.uint32(1) << (src & 31).astype(np.uint32)).view(np.int32))
        fwords = torch.zeros((trees, vr // 32), dtype=torch.int32, device=device)
        fwords[rows, at >> 5] = bits.to(device)
        changed = torch.ones((), dtype=torch.bool, device=device)
        if packed:
            words = torch.full((trees, vr), -1, dtype=torch.int32, device=device)  # sentinel
            words[rows, at] = 0
            return PackedRelayState(words, fwords, 0, changed)
        dist = torch.full((trees, vr), INT32_MAX, dtype=torch.int32, device=device)
        dist[rows, at] = 0
        parent = torch.full((trees, vr), -1, dtype=torch.int32, device=device)
        parent[rows, at] = at.to(torch.int32)
    return RelayState(dist, parent, fwords, 0, changed)


def pack_std(bits: torch.Tensor) -> torch.Tensor:
    """bool/uint8[..., n] -> int32[..., n/32] words, standard packing."""
    b = bits.reshape(*bits.shape[:-1], -1, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    return i32((b << shifts).sum(dim=-1))


def unpack_std(words: torch.Tensor, n: int) -> torch.Tensor:
    """int32[n/32] words -> uint8[n], standard packing."""
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    return ((u32(words)[:, None] >> shifts) & 1).to(torch.uint8).reshape(n)


def apply_benes_std(
    words: torch.Tensor, masks_flat: torch.Tensor,
    table: tuple[StageSpec, ...], n: int,
) -> torch.Tensor:
    """Apply the stages of ``table`` (a whole routed network or any run of
    its stages) to standard-packed words, ``[n/32]`` or ``[S, n/32]``.

    Stage ``d < 32`` swaps bits inside each word:
    ``t = (x ^ (x >> d)) & m; x ^= t ^ (t << d)``.  Stage ``d >= 32`` swaps
    word pairs ``(w, w + d/32)``: ``t = (x[w] ^ x[w+dw]) & m``, the mask
    read at the lower word (full storage) or at its pair-compacted index
    (``d >= 4096``)."""
    x = u32(words)
    lead = tuple(words.shape[:-1])
    for st in table:
        m = u32(masks_flat[st.offset : st.offset + st.nwords])
        d = st.d
        if d < 32:
            t = (x ^ (x >> d)) & m
            x = x ^ t ^ (t << d)
            continue
        dw = d >> 5
        mv = m.reshape(-1, dw) if st.compact else m.reshape(-1, 2, dw)[:, 0, :]
        xr = x.reshape(*lead, -1, 2, dw)
        lo, hi = xr[..., 0, :], xr[..., 1, :]
        t = (lo ^ hi) & mv
        x = torch.stack([lo ^ t, hi ^ t], dim=-2).reshape(*lead, -1)
    return i32(x)


@functools.lru_cache(maxsize=8)
def _broadcast_plan(out_classes: tuple, net_size: int, ywords: int, device: str):
    """Gather plan of :func:`broadcast_l2`: the source word of every L2
    word (``ywords`` names an appended zero word for the unused tail) and,
    for the vertex-major word range, the bit of that word to fill from."""
    nw2 = net_size // 32
    idx = np.full(nw2, ywords, dtype=np.int64)
    vm_lo = vm_hi = 0
    shifts = []
    for cs in out_classes:
        a = cs.sa // 32
        if not cs.vertex_major:
            cw = cs.count // 32
            src = cs.va // 32 + np.arange(cw, dtype=np.int64)
            idx[a : a + cs.width * cw] = np.tile(src, cs.width)
        else:
            if not shifts:
                vm_lo = a
            pos = cs.va + np.arange(cs.count, dtype=np.int64)
            ww = cs.width // 32
            idx[a : a + cs.count * ww] = np.repeat(pos >> 5, ww)
            shifts.append(np.repeat(pos & 31, ww))
            vm_hi = a + cs.count * ww
    shift = np.concatenate(shifts) if shifts else np.zeros(0, np.int64)
    return (
        torch.from_numpy(idx).to(device),
        vm_lo,
        vm_hi,
        torch.from_numpy(shift).to(device),
    )


def broadcast_l2(
    ywords: torch.Tensor, out_classes, net_size: int, out_space: int
) -> torch.Tensor:
    """Vperm-output words (out-position space, ``[n]`` or ``[S, n]``) ->
    L2 slot words.
    Rank-major classes replicate whole words (each rank's 32-slot word IS
    the class's position-bit word); vertex-major classes fill width/32
    words with one position bit (0 or all ones); the tail is zero.

    One gather over a plan built once per layout, then the fill of the
    vertex-major range."""
    del out_space  # the classes carry it
    idx, vm_lo, vm_hi, shift = _broadcast_plan(
        tuple(out_classes), int(net_size), int(ywords.shape[-1]),
        str(ywords.device),
    )
    zero = ywords.new_zeros((*ywords.shape[:-1], 1))
    out = torch.cat([ywords, zero], dim=-1)[..., idx]
    if vm_hi > vm_lo:
        bits = (u32(out[..., vm_lo:vm_hi]) >> shift) & 1
        out[..., vm_lo:vm_hi] = i32(bits * U32)
    return out


def _word_tournament(wv: torch.Tensor):
    """Min-row-index reduce over word rows: wv int32[rows, cw] -> (found
    word row, rank bit-plane rows low..high), rows zero-padded to a power
    of two (zero rows never win)."""
    rows, cw = wv.shape
    p2 = 1 << max((int(rows) - 1).bit_length(), 0)
    if p2 != rows:
        wv = torch.cat([wv, wv.new_zeros((p2 - rows, cw))])
        rows = p2
    f = wv
    planes: list[torch.Tensor] = []
    while rows > 1:
        fr = f.reshape(rows // 2, 2, cw)
        fa, fb = fr[:, 0, :], fr[:, 1, :]
        new_planes = []
        for pl in planes:
            pr = pl.reshape(rows // 2, 2, cw)
            new_planes.append(pr[:, 0, :] | (pr[:, 1, :] & ~fa))
        new_planes.append(fb & ~fa)
        planes = new_planes
        f = fa | fb
        rows //= 2
    return f[0], [pl[0] for pl in planes]


def _ctz32(word: torch.Tensor) -> torch.Tensor:
    """Trailing zeros of nonzero unsigned words (int64 values)."""
    low = word & -word
    out = torch.zeros_like(word)
    for bit, pattern in ((16, 0xFFFF0000), (8, 0xFF00FF00), (4, 0xF0F0F0F0),
                         (2, 0xCCCCCCCC), (1, 0xAAAAAAAA)):
        out = out + ((low & pattern) != 0).to(torch.int64) * bit
    return out


def _class_found_rank(lw: torch.Tensor, cs):
    """(found bool[count], rank int64[count]) for one class from its masked
    slot words: the min active RANK per vertex."""
    if not cs.vertex_major:
        cw = cs.count // 32
        found_w, planes = _word_tournament(lw.reshape(cs.width, cw))
        rank = torch.zeros(cs.count, dtype=torch.int64, device=lw.device)
        for j, pl in enumerate(planes):
            rank = rank | (unpack_std(pl, cs.count).to(torch.int64) << j)
        return unpack_std(found_w, cs.count) != 0, rank
    ww = cs.width // 32
    wv = lw.reshape(cs.count, ww)
    cols = torch.arange(ww, dtype=torch.int64, device=lw.device)
    widx = torch.where(wv != 0, cols[None, :], ww).amin(dim=1)
    word = torch.gather(wv, 1, widx.clamp(max=ww - 1)[:, None])[:, 0]
    rank = widx * 32 + _ctz32(torch.clamp(u32(word), min=1))
    return widx < ww, rank


def _classes_in_order(in_classes):
    covered = 0
    for cs in sorted(in_classes, key=lambda c: c.va):
        assert cs.va == covered, "in_classes must tile the vertex space"
        yield cs
        covered = cs.vb


def rowmin_ranks(
    l1words: torch.Tensor, valid_words: torch.Tensor, in_classes, vr: int
) -> torch.Tensor:
    """Min active RANK per relabeled vertex: uint32 words (int32[vr]),
    PACKED_SENTINEL where none.  Slot words are ANDed with the valid-slot
    words first (Beneš pad routing may deliver stray bits).  A batch
    ``[S, nw]`` gives ``[S, vr]``, tree by tree."""
    if l1words.dim() == 2:
        return torch.stack([rowmin_ranks(w, valid_words, in_classes, vr) for w in l1words])
    parts = []
    covered = 0
    for cs in _classes_in_order(in_classes):
        a, b = cs.sa // 32, cs.sb // 32
        found, rank = _class_found_rank(l1words[a:b] & valid_words[a:b], cs)
        parts.append(torch.where(found, rank, PACKED_SENTINEL))
        covered = cs.vb
    if covered < vr:
        parts.append(
            torch.full((vr - covered,), PACKED_SENTINEL, dtype=torch.int64,
                       device=l1words.device)
        )
    return i32(torch.cat(parts))


def early_exit_words(ranks: torch.Tensor, in_classes) -> dict:
    """{class va: ``int64[S, units]``}: the slot words of each tree and
    unit that a row-min stopping at first hits still reads, from the ranks
    :func:`rowmin_ranks` gives (``[vr]`` or ``[S, vr]``): a rank-major
    column word's rows up to the last of its 32 bits' first hits (all rows
    where a bit is never hit), a vertex-major vertex's words up to its
    first hit (all where none)."""
    r_all = ranks.reshape(-1, ranks.shape[-1]).cpu().numpy().view(np.uint32).astype(np.int64)
    out = {}
    for cs in in_classes:
        r = r_all[:, cs.va : cs.vb]
        none = r == PACKED_SENTINEL
        if cs.vertex_major:
            out[cs.va] = np.where(none, cs.width // 32, r // 32 + 1)
        else:
            r, none = r.reshape(len(r), -1, 32), none.reshape(len(r), -1, 32)
            out[cs.va] = np.where(none.any(-1), cs.width, r.max(-1) + 1)
    return out


def early_exit_bytes(ranks: torch.Tensor, in_classes, vas=None) -> int:
    """The bytes a row-min with an early exit at first hits moves on
    ``ranks`` (``[vr]`` or ``[S, vr]``): each tree's slot words up to its
    first hits and the valid words up to the furthest tree's, read once,
    and the ranks written; of the classes starting at ``vas`` (all where
    None, the tail's outputs too)."""
    words = early_exit_words(ranks, in_classes)
    vas = set(words) if vas is None else set(vas)
    total = sum(4 * int(w.sum()) + 4 * int(w.max(axis=0).sum()) for va, w in words.items()
                if va in vas)
    trees = ranks.numel() // ranks.shape[-1]
    outs = ranks.shape[-1] if vas == set(words) else sum(
        c.count for c in in_classes if c.va in vas)
    return total + 4 * trees * outs


@functools.lru_cache(maxsize=8)
def _slot_tables(in_classes: tuple, vr: int, device: str):
    """Per relabeled vertex: slot = base + rank * stride (the class slot
    formula); stride 0 on the uncovered tail."""
    base = np.zeros(vr, dtype=np.int64)
    stride = np.zeros(vr, dtype=np.int64)
    for cs in in_classes:
        p = np.arange(cs.count, dtype=np.int64)
        if cs.vertex_major:
            base[cs.va : cs.vb] = cs.sa + p * cs.width
            stride[cs.va : cs.vb] = 1
        else:
            base[cs.va : cs.vb] = cs.sa + p
            stride[cs.va : cs.vb] = cs.count
    return torch.from_numpy(base).to(device), torch.from_numpy(stride).to(device)


def rank_to_slot(rank_or_sent: torch.Tensor, in_classes, vr: int) -> torch.Tensor:
    """Ranks (int32 patterns, sentinel where none) -> global L1 slots,
    INT32_MAX where none: rank-major ``sa + r*count + p``, vertex-major
    ``sa + p*width + r``."""
    base, stride = _slot_tables(tuple(in_classes), int(vr), str(rank_or_sent.device))
    r = u32(rank_or_sent)
    return torch.where(
        r == PACKED_SENTINEL, INT32_MAX, base + r * stride
    ).to(torch.int32)


def rowmin_candidates(
    l1words: torch.Tensor, valid_words: torch.Tensor, in_classes, vr: int
) -> torch.Tensor:
    """Min active L1 SLOT per relabeled vertex: int32[vr], INT32_MAX where
    none (the unpacked carry's candidates)."""
    return rank_to_slot(
        rowmin_ranks(l1words, valid_words, in_classes, vr), in_classes, vr
    )


def _next_level(state, ctl):
    """The returned state's ``level``: the host level plus one without a
    control block; inside the block loop the level lives in ``ctl`` and the
    field is passed through."""
    return state.level + 1 if ctl is None else state.level


def apply_relay_candidates(
    state: RelayState, cand: torch.Tensor, ctl: torch.Tensor | None = None
) -> RelayState:
    """Merge candidate slots into the unpacked carry (one search or a batch,
    ``changed`` any tree's): a vertex not yet reached takes level+1 and its
    candidate parent.  With a control block
    ``ctl`` (:mod:`.control`) the level is its LEVEL word and a superstep
    that is not LIVE changes nothing (the frontier words included)."""
    level, live = level_live(ctl, state.level)
    newly = (cand != INT32_MAX) & (state.dist == INT32_MAX)
    if live is not None:
        newly = newly & live
    dist = torch.where(newly, level + 1, state.dist).to(torch.int32)
    parent = torch.where(newly, cand, state.parent)
    fwords = pack_std(newly)
    if live is not None:
        fwords = torch.where(live, fwords, state.fwords)
    return RelayState(dist, parent, fwords, _next_level(state, ctl), newly.any())


def apply_relay_candidates_packed(
    state: PackedRelayState, rank_or_sent: torch.Tensor,
    ctl: torch.Tensor | None = None,
) -> PackedRelayState:
    """Packed state update: one unsigned ``min(packed, rank | level_word)``
    per vertex; the changed words' bits are the next frontier (one search or
    a batch, ``changed`` any tree's).  With a
    control block ``ctl`` the level is its LEVEL word and a superstep that
    is not LIVE changes nothing."""
    level, live = level_live(ctl, state.level)
    cand = u32(rank_or_sent) | (((level + 1) << PARENT_BITS) & U32)
    old = u32(state.packed)
    new = torch.minimum(old, cand)
    if live is not None:
        new = torch.where(live, new, old)
    newly = new != old
    fwords = pack_std(newly)
    if live is not None:
        fwords = torch.where(live, fwords, state.fwords)
    return PackedRelayState(i32(new), fwords, _next_level(state, ctl), newly.any())


def segment_live(state, cap: int, seg_end: int) -> bool:
    """THE segment predicate: the fused loop's ``changed and level < cap``
    with the segment's bound ``level < seg_end`` (a host read of a state
    whose ``level`` is a host int and ``changed`` a device or host bool).
    A segment boundary changes where the loop pauses, never what it
    computes; the level loop's segments put the same bound into the
    control block's CAP (:func:`~bfs_tpu_torch.ops.control.set_cap`)."""
    return bool(state.changed) and state.level < cap and state.level < seg_end


def relay_segment_words(state, step, *, cap: int, seg_end: int):
    """One bounded segment of relay supersteps, the plain segment runner
    of either carry (the reference's ``relay_segment_words`` and its packed
    twin): ``step``, the engine's plain superstep of that carry
    (:meth:`~bfs_tpu_torch.models.bfs.RelayEngine.superstep` or
    ``superstep_packed``), iterated until convergence, the level cap or
    ``seg_end``, whichever comes first.  Segments of any size run back to
    back equal one full loop."""
    while segment_live(state, cap, seg_end):
        state = step(state)
    return state


def slots_to_parent(parent_slots: torch.Tensor, src_l1: torch.Tensor) -> torch.Tensor:
    """Relay parent values (L1 slot indices; -1 unreached) -> ORIGINAL src
    ids: one gather per run, on the device that holds the slots."""
    slots = parent_slots.clamp(0, src_l1.shape[-1] - 1).to(torch.int64)
    return torch.where(parent_slots >= 0, src_l1[slots], parent_slots)


def unpack_relay_packed(packed: torch.Tensor, in_classes, vr: int):
    """Packed words -> ``(dist int32[vr], parent int32[vr])`` with parent
    as the global L1 slot (-1 unreached): the unpacked carry's contract."""
    w = u32(packed)
    rank = i32(w & PARENT_MASK)
    slots = rank_to_slot(rank, in_classes, vr)
    parent = torch.where(w == PACKED_SENTINEL, -1, slots).to(torch.int32)
    return packed_dist(packed), parent
