"""Element-major batched multi-source relay, plain PyTorch: 32 BFS trees per
uint32 element.

The port of ``bfs_tpu.ops.relay_elem``.  The tree axis lives in the bits:
every network element (edge slot or vertex) is one uint32 whose bit ``t``
is tree ``t``'s frontier bit, so one superstep reads each mask word once
for all 32 trees of a group, and ``G`` groups run side by side as the
leading axis.  Per-tree state is bit-sliced: ``visited``/``frontier`` as
``[G, vr]`` elements, the level as ``DIST_PLANES`` bit-planes, the parent
as per-class rank bit-planes (a vertex's parent slot is
``base + rank * stride``, so ``bits(width - 1)`` planes per in-class).

These are the plain versions of the port's elem kernels
(:mod:`bfs_tpu_torch.ops.relay_cuda`): the CPU path runs them and the
card's kernels are held against them bit for bit.  Elements are uint32
bit patterns in ``int32`` tensors.  XOR, AND, OR and NOT work on the
patterns directly; a bit is read as ``(x >> t) & 1``, which the
arithmetic shift leaves exact for every ``t`` in ``[0, 32)`` (bit 31 is
tree 31 of its group, the sign bit).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..graph.relay import StageSpec, _vertex_tables
from .control import level_live
from .packed import INT32_MAX
from .relay import slots_to_parent, unpack_std

__all__ = [
    "DIST_PLANES",
    "MAX_ELEM_LEVELS",
    "ElemState",
    "rank_plane_layout",
    "init_elem_state",
    "apply_benes_elem",
    "broadcast_l2_elem",
    "route_index",
    "route_gather",
    "interleave_frontier",
    "rowmin_elem",
    "apply_elem_found",
    "elem_superstep",
    "decode_trees",
    "extract_results",
]

#: Distance bit-planes: levels must stay below 2^DIST_PLANES.  A search
#: deeper than MAX_ELEM_LEVELS stops unconverged with ``changed`` set, and
#: ``RelayEngine.run_multi_elem`` falls back to the lock-step engine.
DIST_PLANES = 5
MAX_ELEM_LEVELS = (1 << DIST_PLANES) - 1


class ElemState(NamedTuple):
    """Loop carry for G groups of 32 trees in the relabeled vertex space.

    ``visited``/``frontier``: int32[G, vr] (bit t = tree t);
    ``dist_planes``: int32[DIST_PLANES, G, vr], bit b of a vertex's level;
    ``rank_planes``: int32[G, PT], per-class packed parent-rank bits
    (:func:`rank_plane_layout`); ``level`` a host int (``None`` inside the
    block loop, where the control block holds it); ``changed`` a device
    flag (bool or int tensor), or a host bool once a loop has read it."""

    visited: torch.Tensor
    frontier: torch.Tensor
    dist_planes: torch.Tensor
    rank_planes: torch.Tensor
    level: int
    changed: torch.Tensor


def _nbits(width: int) -> int:
    return max(int(width - 1).bit_length(), 0)


def rank_plane_layout(in_classes):
    """Per class (sorted by va) a slice of ``nb * count`` words: returns
    ``({va: (offset, nb)}, total)``.  Width-1 classes have no planes."""
    offsets = {}
    total = 0
    for cs in sorted(in_classes, key=lambda c: c.va):
        nb = _nbits(cs.width)
        offsets[cs.va] = (total, nb)
        total += nb * cs.count
    return offsets, total


def init_elem_state(vr: int, sources_new: np.ndarray, pt: int, device="cpu",
                    out: tuple | None = None) -> ElemState:
    """``sources_new``: int[G, 32] relabeled source ids.  Tree ``t`` of
    group ``g`` adds bit ``t`` at its source, as the reference's
    scatter-add does, on ``device``: two trees on one vertex add two
    distinct bits, so the sum is their OR and never carries (bit 31
    included, in two's complement).  ``out``: existing ``(visited,
    frontier, dist_planes, rank_planes)`` to start in, in place (the block
    loop's buffers: no copy of the planes)."""
    src = torch.as_tensor(np.asarray(sources_new, dtype=np.int64)).to(device)
    g = src.shape[0]
    bits = torch.from_numpy(
        (np.uint32(1) << np.tile(np.arange(32, dtype=np.uint32), g)).view(np.int32)
    ).to(device)
    rows = torch.arange(g, device=device).repeat_interleave(32)
    if out is None:
        out = tuple(
            torch.empty(shape, dtype=torch.int32, device=device)
            for shape in ((g, vr), (g, vr), (DIST_PLANES, g, vr), (g, pt))
        )
    vis, frontier, dist_planes, rank_planes = out
    vis.zero_()
    vis.index_put_((rows, src.reshape(-1)), bits, accumulate=True)
    frontier.copy_(vis)
    dist_planes.zero_()
    rank_planes.zero_()
    return ElemState(
        visited=vis,
        frontier=frontier,
        dist_planes=dist_planes,
        rank_planes=rank_planes,
        level=0,
        changed=torch.ones((), dtype=torch.bool, device=device),
    )


def _select(bits) -> torch.Tensor | int:
    """0/1 values (a tensor, or a host int) -> int32 0 / ~0 select
    patterns."""
    return -bits.to(torch.int32) if isinstance(bits, torch.Tensor) else -int(bits)


def _stage_select(m: torch.Tensor, st: StageSpec, n: int) -> torch.Tensor:
    """Per-lower-pair-element select (0 / ~0) of one stage: compact storage
    holds the lower elements only; full storage also holds zero uppers,
    which the pair reshape drops."""
    if st.compact:
        return _select(unpack_std(m, n // 2))
    return _select(unpack_std(m, n).reshape(-1, 2, st.d)[:, 0, :].reshape(-1))


def apply_benes_elem(
    x: torch.Tensor, masks_flat: torch.Tensor, table: tuple[StageSpec, ...], n: int
) -> torch.Tensor:
    """Routed Beneš network over whole uint32 elements: x int32[G, n].  Each
    stage swaps the element pair ``(e, e + d)`` of every group where the
    stage's mask bit of the lower element is set."""
    g = x.shape[0]
    for st in table:
        m = masks_flat[st.offset : st.offset + st.nwords]
        sel = _stage_select(m, st, n).reshape(1, -1, st.d)
        xr = x.reshape(g, -1, 2, st.d)
        lo, hi = xr[:, :, 0, :], xr[:, :, 1, :]
        t = (lo ^ hi) & sel
        x = torch.stack([lo ^ t, hi ^ t], dim=2).reshape(g, n)
    return x


def broadcast_l2_elem(y: torch.Tensor, out_classes, net_size: int) -> torch.Tensor:
    """Out-position elements int32[G, vperm_size] -> L2 slot elements
    int32[G, net_size]: each out-class's block is copied into its slots of
    one L2 buffer, tiled ``width`` times (rank-major) or each element
    repeated ``width`` times (vertex-major); the tail is zero."""
    g = y.shape[0]
    out = torch.empty((g, net_size), dtype=y.dtype, device=y.device)
    used = 0
    for cs in sorted(out_classes, key=lambda c: c.va):
        blk = y[:, cs.va : cs.vb]
        dst = out[:, used : used + cs.count * cs.width]
        if not cs.vertex_major:
            dst.view(g, cs.width, cs.count).copy_(blk[:, None, :].expand(g, cs.width, cs.count))
        else:
            dst.view(g, cs.count, cs.width).copy_(blk[:, :, None].expand(g, cs.count, cs.width))
        used += cs.count * cs.width
    out[:, used:].zero_()
    return out


def route_index(route, vr: int, device) -> torch.Tensor:
    """The multi-source route (frontier elements int32[G, vr] -> routed L1
    slot elements int32[G, n]) as one gather index: int32[n], slot ``i``
    receives frontier element ``src[i]``, or nothing (0) where ``src[i]``
    is -1.  ``route`` only moves and copies whole elements under masks
    fixed for the graph, so routing ``iota + 1`` (one group; the zero
    padding past ``vr`` stays 0) labels every slot with its source plus
    one."""
    iota = torch.arange(1, vr + 1, dtype=torch.int32, device=device)[None]
    return route(iota)[0] - 1


def route_gather(frontier: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Routed L1 slot elements int32[G, n] from the frontier int32[G, vr]
    through :func:`route_index`'s ``src``: ``where(src >= 0,
    frontier[:, src], 0)``."""
    return torch.where(src >= 0, frontier[:, src.clamp(min=0).long()], 0)


def interleave_frontier(frontier: torch.Tensor) -> torch.Tensor:
    """The frontier int32[G, vr] as int32[vr, G]: a vertex's groups side
    by side, the layout the card's route gather reads."""
    return frontier.t().contiguous()


def _tournament(xv: torch.Tensor):
    """Min-index reduce over the rows of xv int32[G, rows, count] ->
    ``(found [G, count], rank planes low..high)``.  Rows are zero-padded to
    a power of two (zero rows never win); log2(rows) elementwise rounds."""
    g, rows, count = xv.shape
    p2 = 1 << max((rows - 1).bit_length(), 0)
    if p2 != rows:
        xv = torch.cat([xv, xv.new_zeros((g, p2 - rows, count))], dim=1)
        rows = p2
    f = xv
    planes: list[torch.Tensor] = []
    while rows > 1:
        fr = f.reshape(g, rows // 2, 2, count)
        fa, fb = fr[:, :, 0, :], fr[:, :, 1, :]
        new_planes = []
        for pl in planes:
            pr = pl.reshape(g, rows // 2, 2, count)
            new_planes.append(pr[:, :, 0, :] | (pr[:, :, 1, :] & ~fa))
        new_planes.append(fb & ~fa)
        planes = new_planes
        f = fa | fb
        rows //= 2
    return f[:, 0, :], [pl[:, 0, :] for pl in planes]


def _classes_in_order(in_classes):
    return sorted(in_classes, key=lambda c: c.va)


def rowmin_elem(
    l1: torch.Tensor, valid_words: torch.Tensor, in_classes, vr: int,
    plane_offsets, pt: int,
):
    """Per-vertex found mask and packed rank planes from the routed L1
    slots: ``(found int32[G, vr], rank_planes int32[G, PT])``, the planes
    meaningful only where ``found`` is set.  Each class's slots are ANDed
    with its valid-slot select first (Beneš pad routing may deliver stray
    bits)."""
    g = l1.shape[0]
    found_parts = []
    rp = torch.zeros((g, pt), dtype=torch.int32, device=l1.device)
    covered = 0
    for cs in _classes_in_order(in_classes):
        vsel = _select(unpack_std(valid_words[cs.sa // 32 : cs.sb // 32], cs.sb - cs.sa))
        seg = l1[:, cs.sa : cs.sb] & vsel[None, :]
        if not cs.vertex_major:
            xv = seg.reshape(g, cs.width, cs.count)
        else:
            xv = seg.reshape(g, cs.count, cs.width).transpose(1, 2)
        found, planes = _tournament(xv)
        found_parts.append(found)
        off, nb = plane_offsets[cs.va]
        if nb:
            rp[:, off : off + nb * cs.count] = torch.stack(planes[:nb], dim=1).reshape(
                g, nb * cs.count
            )
        covered = cs.vb
    if covered < vr:
        found_parts.append(torch.zeros((g, vr - covered), dtype=torch.int32, device=l1.device))
    return torch.cat(found_parts, dim=1), rp


def apply_elem_found(
    state: ElemState, found: torch.Tensor, rp_new: torch.Tensor, in_classes,
    plane_offsets, ctl: torch.Tensor | None = None,
) -> ElemState:
    """The bit-sliced update of one superstep: ``newly = found & ~visited``
    becomes the frontier and joins ``visited``; it is ORed into dist plane
    ``b`` where bit ``b`` of the new level is set (none at level 32, the
    step past the cap); the new rank bits are adopted for newly reached
    trees only.  The new level is the host ``state.level + 1``, or with a
    control block ``ctl`` (:mod:`.control`) its LEVEL word plus one, and
    then a superstep that is not LIVE changes nothing (the frontier
    included)."""
    level, live = level_live(ctl, state.level)
    newly = found & ~state.visited
    if live is not None:
        newly = newly & _select(live)
    new_level = level + 1
    dist_planes = torch.stack([
        state.dist_planes[b] | (newly & _select((new_level >> b) & 1))
        for b in range(DIST_PLANES)
    ])
    rp_mask_parts = []
    for cs in _classes_in_order(in_classes):
        _, nb = plane_offsets[cs.va]
        if nb:
            rp_mask_parts.append(newly[:, cs.va : cs.vb].repeat(1, nb))
    rp_mask = torch.cat(rp_mask_parts, dim=1) if rp_mask_parts else torch.zeros_like(
        state.rank_planes
    )
    return ElemState(
        visited=state.visited | newly,
        frontier=newly if live is None else torch.where(live, newly, state.frontier),
        dist_planes=dist_planes,
        rank_planes=state.rank_planes | (rp_new & rp_mask),
        level=new_level if ctl is None else state.level,
        changed=(newly != 0).any(),
    )


def elem_superstep(
    state: ElemState,
    *,
    vperm_masks,
    vperm_table,
    vperm_size: int,
    out_classes,
    net_masks,
    net_table,
    net_size: int,
    in_classes,
    valid_words,
    vr: int,
    plane_offsets,
    pt: int,
) -> ElemState:
    """One lock-step superstep for all 32·G trees (the plain path)."""
    g = state.frontier.shape[0]
    fw = torch.zeros((g, vperm_size), dtype=torch.int32, device=state.frontier.device)
    fw[:, :vr] = state.frontier  # dummy out-positions read the zero tail
    y = apply_benes_elem(fw, vperm_masks, vperm_table, vperm_size)
    l2 = broadcast_l2_elem(y, out_classes, net_size)
    l1 = apply_benes_elem(l2, net_masks, net_table, net_size)
    found, rp_new = rowmin_elem(l1, valid_words, in_classes, vr, plane_offsets, pt)
    return apply_elem_found(state, found, rp_new, in_classes, plane_offsets)


#: Trees per chunk of the batch extraction: decoded on the device while the
#: chunk before is copied to the host.
EXTRACT_TREES = 16


def _tree_bits(words: torch.Tensor, t0: int, t1: int) -> torch.Tensor:
    """int32[n] elements -> int32[t1 - t0, n] 0/1 bits, row i = tree t0 + i."""
    shifts = torch.arange(t0, t1, dtype=torch.int32, device=words.device)[:, None]
    return (words[None, :] >> shifts) & 1


def rank_tables(rg, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The rank -> L1 slot tables ``(base, stride)``, int32[vr] on ``device``:
    slot = base + rank * stride.  int32 holds every slot: a slot is below
    ``net_size``, and a layout of 2^31 slots or more is refused here."""
    if rg.net_size > 1 << 31:
        raise ValueError(f"net_size {rg.net_size}: slots past int32")
    return tuple(torch.from_numpy(a).to(device) for a in _vertex_tables(list(rg.in_classes), rg.vr))


def decode_trees(state: ElemState, rg, gi: int, t0: int, t1: int, tables):
    """Trees ``[t0, t1)`` of group ``gi`` in the relabeled space:
    ``(dist, parent_slots)`` int32[t1 - t0, vr], INT32_MAX / -1 where
    unreached; ``tables`` from :func:`rank_tables`.  Torch ops on the
    state's device."""
    base, stride = tables
    vis = _tree_bits(state.visited[gi], t0, t1) == 1
    dv = _tree_bits(state.dist_planes[0, gi], t0, t1)
    for b in range(1, DIST_PLANES):
        dv |= _tree_bits(state.dist_planes[b, gi], t0, t1) << b
    rank = torch.zeros_like(dv)
    offsets, _ = rank_plane_layout(rg.in_classes)
    for cs in rg.in_classes:
        off, nb = offsets[cs.va]
        for j in range(nb):
            seg = state.rank_planes[gi, off + j * cs.count : off + (j + 1) * cs.count]
            rank[:, cs.va : cs.vb] |= _tree_bits(seg, t0, t1) << j
    dist = torch.where(vis, dv, INT32_MAX)
    parent = torch.where(vis, base + rank * stride, -1)
    return dist, parent


def _chunks(s: int):
    """``(group, first tree, last tree + 1, first result row)`` per chunk:
    at most :data:`EXTRACT_TREES` trees of one group."""
    for g0 in range(0, s, 32):
        for t0 in range(0, min(32, s - g0), EXTRACT_TREES):
            yield g0 // 32, t0, min(t0 + EXTRACT_TREES, 32, s - g0), g0 + t0


def extract_results(
    state: ElemState, rg, sources: np.ndarray, old2new: torch.Tensor,
    src_l1: torch.Tensor, tables=None,
):
    """Bit-sliced state -> per-tree ``(dist, parent)`` int32[S, V] numpy
    arrays in ORIGINAL ids, S = 32·G; ``old2new`` (int64[V]), ``src_l1``
    (int32[m1]) and ``tables`` (:func:`rank_tables`, built here when not
    given) are the layout's tables on the state's device.

    Chunks of :data:`EXTRACT_TREES` trees are decoded on the device
    (:func:`decode_trees`, then the original-id gathers into one of two
    device buffers).  On a card the result arrays are numpy views of pinned
    host tensors (PyTorch's caching host allocator), which they keep alive,
    and each chunk's copy into them runs on a second stream while the next
    chunk is decoded (events order the two); on the CPU the chunks are
    written straight into the arrays."""
    dev = state.visited.device
    s, v = int(sources.shape[0]), rg.num_vertices
    tables = rank_tables(rg, dev) if tables is None else tables
    src = torch.from_numpy(sources.astype(np.int64)).to(dev)
    on_card = dev.type == "cuda"
    out = [torch.empty((s, v), dtype=torch.int32, pin_memory=on_card) for _ in range(2)]
    if on_card:
        main, side = torch.cuda.current_stream(), torch.cuda.Stream()
        bufs = torch.empty((2, 2, EXTRACT_TREES, v), dtype=torch.int32, device=dev)
        copied = [None, None]
    for ci, (gi, t0, t1, row) in enumerate(_chunks(s)):
        n = t1 - t0
        rows = slice(row, row + n)
        if on_card:
            slot = ci % 2
            if copied[slot] is not None:
                main.wait_event(copied[slot])  # its last chunk has reached the host
            dst = bufs[slot, :, :n]
        else:
            dst = [o[rows] for o in out]
        dist, parent = decode_trees(state, rg, gi, t0, t1, tables)
        torch.index_select(dist, 1, old2new, out=dst[0])
        torch.index_select(slots_to_parent(parent, src_l1), 1, old2new, out=dst[1])
        t = torch.arange(n, device=dev)
        dst[0][t, src[rows]] = 0
        dst[1][t, src[rows]] = src[rows].to(torch.int32)
        if on_card:
            side.wait_stream(main)
            with torch.cuda.stream(side):
                for o, d in zip(out, dst):
                    o[rows].copy_(d, non_blocking=True)
                copied[slot] = side.record_event()
    if on_card:
        side.synchronize()
    return out[0].numpy(), out[1].numpy()
