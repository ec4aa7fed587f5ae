"""Verification on the device: ``check()`` without copying the result to
the host.

The port of ``bfs_tpu.oracle.device`` (XLA there, plain torch here): the
BFS verdict below and, at the end of the module, the SSSP and CC verdicts
(:func:`sssp_device_check`, :func:`cc_device_check`).  The host :func:`~bfs_tpu_torch.oracle.bfs.check` stays the
ground truth; this evaluates its three invariants as data-parallel
reductions over the edge set on device-resident arrays and returns a
verdict of six int32 counters:

  counts[0] — sources with ``dist != 0``;
  counts[1] — edges whose source is reached but destination is not;
  counts[2] — edges with ``dist[dst] > dist[src] + 1``;
  counts[3] — reached non-source vertices with no parent;
  counts[4] — reached non-source vertices with ``dist != dist[parent]+1``;
  counts[5] — reached non-source vertices whose ``(parent, w)`` tree edge
              is not a graph edge.

All zero exactly when the host ``check()`` finds no violation.  The edge
membership test becomes an edge-side scatter: edge ``(u, w)`` covers ``w``
when ``parent[w] == u``; a reached non-source vertex left uncovered has a
phantom tree edge.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph.adj_tiles import _popcount32
from ..graph.csr import INF_DIST, NO_PARENT, DeviceGraph, Graph
from ..ops.relay import pack_std

#: Names of the verdict's counters, index-aligned.
COUNT_FIELDS = (
    "source_dist_nonzero",
    "edge_dst_unreached",
    "edge_dist_gap",
    "reached_without_parent",
    "tree_dist_mismatch",
    "tree_edge_missing",
)


def _check_counts(srcv, dstv, dist, parent, sources, v: int) -> torch.Tensor:
    """The verdict: int32[6] violation counts (see the module doc).
    ``srcv``/``dstv`` may hold sentinel padding (endpoint == v, inert);
    ``dist``/``parent`` may carry the engines' sentinel slot (cut off)."""
    dev = dist.device
    dist = dist[:v].to(torch.int32)
    parent = parent[:v].to(torch.int32)
    # One appended slot, so clipped sentinel endpoints gather inert values.
    dist_p = torch.cat([dist, torch.full((1,), INF_DIST, dtype=torch.int32, device=dev)])
    par_p = torch.cat([parent, torch.full((1,), NO_PARENT, dtype=torch.int32, device=dev)])
    si = srcv.clamp(max=v).to(torch.int64)
    di = dstv.clamp(max=v).to(torch.int64)
    real = (srcv < v) & (dstv < v)
    ds, dd = dist_p[si], dist_p[di]
    src_idx = sources.clamp(max=v).to(torch.int64)

    def count(mask):
        return mask.sum(dtype=torch.int32)

    # Invariant 1: the sources at distance 0.
    c_src = count(dist_p[src_idx] != 0)
    # Invariant 2: per directed edge, reachability agrees and the distance
    # gap is at most one level (int64: INF + 1 must not wrap).
    reach_s = real & (ds != INF_DIST)
    reach_d = dd != INF_DIST
    c_unreached = count(reach_s & ~reach_d)
    c_gap = count(reach_s & reach_d & (dd.to(torch.int64) > ds.to(torch.int64) + 1))
    # Invariant 3: every reached non-source has a parent one level up,
    # joined to it by a real graph edge.
    srcmask = torch.zeros(v + 1, dtype=torch.bool, device=dev)
    srcmask[src_idx] = True
    non_src = (dist != INF_DIST) & ~srcmask[:v]
    c_noparent = count(non_src & (parent == NO_PARENT))
    hasp = non_src & (parent != NO_PARENT)
    pc = parent.clamp(0, v - 1).to(torch.int64)
    c_treedist = count(hasp & (dist.to(torch.int64) != dist[pc].to(torch.int64) + 1))
    tree_target = torch.where(real & (par_p[di] == srcv), di, v)
    covered = torch.zeros(v + 1, dtype=torch.bool, device=dev)
    covered[tree_target] = True
    c_missing = count(hasp & ~covered[:v])
    return torch.stack([c_src, c_unreached, c_gap, c_noparent, c_treedist, c_missing])


def _packed_reached(dist: torch.Tensor, v: int) -> torch.Tensor:
    """int32[ceil(v/32)] reached-bit words (standard packing) of ``dist``:
    the component signature for coverage comparison."""
    reached = dist[:v] != INF_DIST
    pad = (-v) % 32
    if pad:
        reached = torch.cat([reached, torch.zeros(pad, dtype=torch.bool, device=dist.device)])
    return pack_std(reached)


def _coverage_mismatch(dist: torch.Tensor, ref_words: torch.Tensor, v: int) -> torch.Tensor:
    """Device count of vertices whose reached bit differs from the
    reference component's words."""
    return _popcount32(_packed_reached(dist, v) ^ ref_words).sum().to(torch.int32)


class DeviceChecker:
    """The verifier bound to one graph's edge arrays on a device.

    Ships the flat ``(src, dst)`` edges once and then verifies any number
    of results for 24 bytes each.  Edges that are tensors already (such as
    the push engine's) stay where they are unless ``device`` names another;
    host arrays go to the card unless ``device`` names the CPU, and without
    a card that raises.  Results from any engine work once
    ``dist``/``parent`` are in original ids, as
    :meth:`~bfs_tpu_torch.models.bfs.RelayEngine.to_original_device` gives
    them without leaving the device; a result tensor on another device than
    the checker's raises rather than being copied."""

    def __init__(self, src, dst, num_vertices: int, device=None):
        from ..models.bfs import resolve_device

        if device is None and isinstance(src, torch.Tensor):
            dev = src.device
        else:
            dev = resolve_device(device)
        self.num_vertices = int(num_vertices)
        self.src, self.dst = (
            (x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x)))
            .to(dev).reshape(-1) for x in (src, dst))
        self.device = self.src.device  # with its index: cuda:0, not cuda

    @classmethod
    def from_graph(cls, graph: Graph | DeviceGraph, device=None) -> "DeviceChecker":
        """From a host :class:`Graph` or padded :class:`DeviceGraph` (its
        sentinel edges are inert), on the card unless ``device`` names
        another."""
        return cls(np.asarray(graph.src, dtype=np.int32), np.asarray(graph.dst, dtype=np.int32),
                   graph.num_vertices, device=device)

    @property
    def edge_bytes(self) -> int:
        return (self.src.numel() + self.dst.numel()) * 4

    def _tensor(self, x) -> torch.Tensor:
        """A result on the checker's device: host arrays are copied there;
        a tensor elsewhere raises (verifying it here would move a card's
        result to the host, or a host result to the card, unasked)."""
        if isinstance(x, torch.Tensor):
            if x.device != self.device:
                raise ValueError(f"a result on {x.device} given to a DeviceChecker on "
                                 f"{self.device}; build the checker on the result's device")
            return x
        return torch.as_tensor(np.asarray(x), device=self.device)

    def counts(self, dist, parent, sources) -> torch.Tensor:
        """The device int32[6] violation counters (:data:`COUNT_FIELDS`);
        nothing is copied to the host."""
        src = torch.as_tensor(np.atleast_1d(np.asarray(sources, dtype=np.int32)),
                              device=self.device)
        return _check_counts(self.src, self.dst, self._tensor(dist), self._tensor(parent),
                             src, self.num_vertices)

    def check(self, dist, parent, sources) -> dict[str, int]:
        """Named nonzero violation counts (empty: every invariant holds);
        the only host copy is the 24-byte verdict."""
        host = self.counts(dist, parent, sources).cpu().tolist()
        return {name: int(n) for name, n in zip(COUNT_FIELDS, host) if n}

    def ok(self, dist, parent, sources) -> bool:
        return not self.check(dist, parent, sources)

    def packed_reached(self, dist) -> torch.Tensor:
        """Reached-bit words of ``dist`` on the device: computed once for a
        reference result, compared with every root by
        :meth:`coverage_mismatch`."""
        return _packed_reached(self._tensor(dist), self.num_vertices)

    def coverage_mismatch(self, dist, ref_words) -> int:
        """Vertices whose reachability differs from ``ref_words`` (one
        int32 to the host)."""
        return int(_coverage_mismatch(self._tensor(dist), ref_words, self.num_vertices))


# ------------------------------------------------------- algo verdicts --
# The semiring algorithms' device checks: the same shape as the BFS
# verdict, data-parallel reductions over the edge set with only the count
# vector copied to the host.  The host oracles (oracle/sssp.py,
# oracle/cc.py) stay the ground truth.

#: Names of the SSSP verdict's counters, index-aligned.
SSSP_COUNT_FIELDS = (
    "source_dist_nonzero",
    "edge_dst_unreached",
    "edge_relaxable",
    "reached_without_parent",
    "tree_edge_not_tight",
)

#: Names of the CC verdict's counters, index-aligned.
CC_COUNT_FIELDS = (
    "edge_label_mismatch",
    "label_above_id",
    "root_not_self_labeled",
)


def _algo_device(src, device) -> torch.device:
    """The device of an algorithm check: the edges' own when they are a
    tensor and ``device`` is None; else ``device`` (the card unless it
    names the CPU)."""
    from ..models.bfs import resolve_device

    if device is None and isinstance(src, torch.Tensor):
        return src.device
    return resolve_device(device)


def _on(x, dev: torch.device) -> torch.Tensor:
    """``x`` (a tensor or host array) flat on ``dev``."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    return t.to(dev).reshape(-1)


def _sssp_check_counts(srcv, dstv, dist, parent, source: int, v: int,
                       max_weight: int) -> torch.Tensor:
    """int32[5] SSSP violation counts (:data:`SSSP_COUNT_FIELDS`), int32
    arithmetic as the reference's.  Weights are recomputed from the
    endpoint hash; sentinel-padded edges are inert; ``dist``/``parent`` may
    carry the engines' sentinel slot."""
    from ..algo.substrate import edge_weights

    dev = dist.device
    inf = INF_DIST
    dist = dist[:v].to(torch.int32)
    parent = parent[:v].to(torch.int32)
    dist_p = torch.cat([dist, torch.full((1,), inf, dtype=torch.int32, device=dev)])
    par_p = torch.cat([parent, torch.full((1,), NO_PARENT, dtype=torch.int32, device=dev)])
    si = srcv.clamp(max=v).to(torch.int64)
    di = dstv.clamp(max=v).to(torch.int64)
    real = (srcv < v) & (dstv < v)
    wv = edge_weights(srcv, dstv, max_weight)
    ds, dd = dist_p[si], dist_p[di]

    def count(mask):
        return mask.sum(dtype=torch.int32)

    c_src = count(dist_p[min(int(source), v)].reshape(1) != 0)
    reach_s = real & (ds != inf)
    reach_d = dd != inf
    c_unreached = count(reach_s & ~reach_d)
    # A relaxable edge remaining means the fixpoint was not reached.
    c_relaxable = count(reach_s & reach_d & (dd > ds + wv))
    reached = dist != inf
    non_src = reached & (torch.arange(v, dtype=torch.int32, device=dev) != int(source))
    c_noparent = count(non_src & ((parent < 0) | (parent >= v)))
    hasp = non_src & (parent >= 0) & (parent < v)
    # Tree-edge tightness by an edge-side scatter: edge (u, w) covers w when
    # parent[w] == u and dist[w] == dist[u] + weight(u, w).
    tight = real & (par_p[di] == srcv) & (dd == ds + wv)
    covered = torch.zeros(v + 1, dtype=torch.bool, device=dev)
    covered[torch.where(tight, di, v)] = True
    c_loose = count(hasp & ~covered[:v])
    return torch.stack([c_src, c_unreached, c_relaxable, c_noparent, c_loose])


def _cc_check_counts(srcv, dstv, label, v: int) -> torch.Tensor:
    """int32[3] CC violation counts (:data:`CC_COUNT_FIELDS`)."""
    dev = label.device
    label = label[:v].to(torch.int32)
    label_p = torch.cat([label, torch.full((1,), -1, dtype=torch.int32, device=dev)])
    si = srcv.clamp(max=v).to(torch.int64)
    di = dstv.clamp(max=v).to(torch.int64)
    real = (srcv < v) & (dstv < v)
    c_edge = (real & (label_p[si] != label_p[di])).sum(dtype=torch.int32)
    ids = torch.arange(v, dtype=torch.int32, device=dev)
    c_above = (label > ids).sum(dtype=torch.int32)
    inrange = (label >= 0) & (label < v)
    roots = label_p[torch.where(inrange, label, v).to(torch.int64)]
    c_root = (inrange & (roots != label)).sum(dtype=torch.int32)
    return torch.stack([c_edge, c_above, c_root])


def sssp_device_check(src, dst, dist, parent, source: int, num_vertices: int,
                      max_weight: int, *, device=None) -> dict[str, int]:
    """Named nonzero SSSP violation counts (empty: every invariant holds).
    Runs on the edges' device when they are tensors (else on ``device``,
    the card unless it names the CPU); the only host copy is the count
    vector."""
    dev = _algo_device(src, device)
    counts = _sssp_check_counts(_on(src, dev), _on(dst, dev), _on(dist, dev), _on(parent, dev),
                                int(source), int(num_vertices), int(max_weight))
    return {name: int(n) for name, n in zip(SSSP_COUNT_FIELDS, counts.cpu().tolist()) if n}


def cc_device_check(src, dst, label, num_vertices: int, *, device=None) -> dict[str, int]:
    """Named nonzero CC violation counts (empty: consistent, self-rooted,
    id-dominated labels); the device as :func:`sssp_device_check`."""
    dev = _algo_device(src, device)
    counts = _cc_check_counts(_on(src, dev), _on(dst, dev), _on(label, dev), int(num_vertices))
    return {name: int(n) for name, n in zip(CC_COUNT_FIELDS, counts.cpu().tolist()) if n}
