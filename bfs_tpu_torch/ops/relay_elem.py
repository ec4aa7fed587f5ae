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
    (:func:`rank_plane_layout`); ``level`` a host int; ``changed`` a
    device flag (bool or int tensor)."""

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


def init_elem_state(vr: int, sources_new: np.ndarray, pt: int, device="cpu") -> ElemState:
    """``sources_new``: int[G, 32] relabeled source ids.  Tree ``t`` of
    group ``g`` adds bit ``t`` at its source, as the reference's
    scatter-add does, on ``device``: two trees on one vertex add two
    distinct bits, so the sum is their OR and never carries (bit 31
    included, in two's complement)."""
    src = torch.as_tensor(np.asarray(sources_new, dtype=np.int64)).to(device)
    g = src.shape[0]
    bits = torch.from_numpy(
        (np.uint32(1) << np.tile(np.arange(32, dtype=np.uint32), g)).view(np.int32)
    ).to(device)
    rows = torch.arange(g, device=device).repeat_interleave(32)
    vis = torch.zeros((g, vr), dtype=torch.int32, device=device)
    vis.index_put_((rows, src.reshape(-1)), bits, accumulate=True)
    return ElemState(
        visited=vis,
        frontier=vis.clone(),
        dist_planes=torch.zeros((DIST_PLANES, g, vr), dtype=torch.int32, device=device),
        rank_planes=torch.zeros((g, pt), dtype=torch.int32, device=device),
        level=0,
        changed=torch.ones((), dtype=torch.bool, device=device),
    )


def _select(bits: torch.Tensor) -> torch.Tensor:
    """0/1 values -> int32 0 / ~0 select patterns."""
    return -bits.to(torch.int32)


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
    plane_offsets,
) -> ElemState:
    """The bit-sliced update of one superstep: ``newly = found & ~visited``
    becomes the frontier and joins ``visited``; it is ORed into dist plane
    ``b`` where bit ``b`` of the new level is set (none at level 32, the
    step past the cap); the new rank bits are adopted for newly reached
    trees only."""
    newly = found & ~state.visited
    new_level = state.level + 1
    dist_planes = torch.stack([
        state.dist_planes[b] | newly if (new_level >> b) & 1 else state.dist_planes[b]
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
        frontier=newly,
        dist_planes=dist_planes,
        rank_planes=state.rank_planes | (rp_new & rp_mask),
        level=new_level,
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


def _tree_bits(words: torch.Tensor) -> torch.Tensor:
    """int32[n] elements -> int32[32, n] 0/1 bits, row t = tree t."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)[:, None]
    return (words[None, :] >> shifts) & 1


def extract_results(
    state: ElemState, rg, sources: np.ndarray, old2new: torch.Tensor,
    src_l1: torch.Tensor,
):
    """Bit-sliced state -> per-tree ``(dist, parent)`` int32[S, V] numpy
    arrays in ORIGINAL ids, S = 32·G.  Runs as torch ops on the state's
    device, one group of 32 trees at a time; ``old2new`` (int64[V]) and
    ``src_l1`` (int32[m1]) are the layout's tables on that device."""
    dev = state.visited.device
    g, vr = state.visited.shape
    s = int(sources.shape[0])
    base, stride = (
        torch.from_numpy(a.astype(np.int64)).to(dev)
        for a in _vertex_tables(list(rg.in_classes), rg.vr)
    )
    offsets, _ = rank_plane_layout(rg.in_classes)
    dist = np.empty((s, rg.num_vertices), dtype=np.int32)
    parent = np.empty((s, rg.num_vertices), dtype=np.int32)
    for gi in range(g):
        rows = slice(32 * gi, min(32 * gi + 32, s))
        n_t = rows.stop - rows.start
        vis = _tree_bits(state.visited[gi]) == 1
        dv = torch.zeros((32, vr), dtype=torch.int32, device=dev)
        for b in range(DIST_PLANES):
            dv |= _tree_bits(state.dist_planes[b, gi]) << b
        rank = torch.zeros((32, vr), dtype=torch.int64, device=dev)
        for cs in rg.in_classes:
            off, nb = offsets[cs.va]
            for j in range(nb):
                seg = state.rank_planes[gi, off + j * cs.count : off + (j + 1) * cs.count]
                rank[:, cs.va : cs.vb] |= _tree_bits(seg).to(torch.int64) << j
        pn = torch.where(vis, base + rank * stride, -1)
        d_orig = torch.where(vis, dv, INT32_MAX)[:, old2new]
        p_orig = slots_to_parent(pn, src_l1)[:, old2new].to(torch.int32)
        src = torch.from_numpy(sources[rows].astype(np.int64)).to(dev)
        t = torch.arange(n_t, device=dev)
        d_orig[t, src] = 0
        p_orig[t, src] = src.to(torch.int32)
        # Straight into the result rows: no host temporary, one host copy.
        torch.from_numpy(dist[rows]).copy_(d_orig[:n_t])
        torch.from_numpy(parent[rows]).copy_(p_orig[:n_t])
    return dist, parent
