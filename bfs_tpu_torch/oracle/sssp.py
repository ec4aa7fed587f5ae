"""Sequential SSSP oracle: binary-heap Dijkstra with the canonical
min-parent tie-break.  A copy of ``bfs_tpu.oracle.sssp``.

The correctness anchor for :mod:`bfs_tpu_torch.algo.sssp`, playing the role
algs4's ``BreadthFirstPaths`` plays for BFS: a textbook host
implementation against which the device engines must be EXACT, plus a
:func:`check_sssp` invariant verifier usable on any claimed result.

Parents use the identical canonicalization rule as the device: after the
distances are final, ``parent[v] = min u`` over in-edges with
``dist[u] + w(u, v) == dist[v]`` — computed as a vectorized post-pass
(``np.minimum.at``), NOT as heap pop order, so parents are bit-exact
across the host oracle and every device arm regardless of relaxation
schedule.

Weights are an explicit per-directed-edge array, aligned with
``graph.src``/``graph.dst`` — pass
:func:`bfs_tpu_torch.algo.substrate.edge_weights_np` output for parity with the
device's hash weights.
"""

from __future__ import annotations

import heapq

import numpy as np

from ..graph.csr import Graph, INF_DIST, NO_PARENT

__all__ = ["dijkstra", "check_sssp"]


def dijkstra(graph: Graph, weights: np.ndarray, source: int = 0):
    """Single-source shortest paths.  Returns ``(dist int32[V],
    parent int32[V])``: INF_DIST / NO_PARENT for unreached vertices,
    ``parent[source] == source``, canonical min-parent tie-break.

    ``weights`` must be positive int per directed edge, aligned with
    ``graph.src`` / ``graph.dst``.
    """
    v = graph.num_vertices
    if not (0 <= source < v):
        raise ValueError("source vertex out of range")
    weights = np.asarray(weights)
    if weights.shape != graph.src.shape:
        raise ValueError("weights must align with graph.src/graph.dst")
    if graph.num_edges and int(weights.min(initial=1)) < 1:
        raise ValueError("weights must be >= 1")
    # CSR over (dst, weight) per source vertex.
    order = np.argsort(graph.src, kind="stable")
    s_sorted = graph.src[order]
    d_sorted = graph.dst[order]
    w_sorted = weights[order].astype(np.int64)
    indptr = np.zeros(v + 1, dtype=np.int64)
    np.add.at(indptr, s_sorted + 1, 1)
    indptr = np.cumsum(indptr)

    dist = np.full(v, np.iinfo(np.int64).max, dtype=np.int64)
    done = np.zeros(v, dtype=bool)
    dist[source] = 0
    heap = [(0, source)]
    while heap:
        du, u = heapq.heappop(heap)
        if done[u] or du != dist[u]:
            continue
        done[u] = True
        for i in range(indptr[u], indptr[u + 1]):
            nd = du + w_sorted[i]
            t = d_sorted[i]
            if nd < dist[t]:
                dist[t] = nd
                heapq.heappush(heap, (int(nd), int(t)))

    reached = dist != np.iinfo(np.int64).max
    if reached.any() and int(dist[reached].max()) >= INF_DIST:
        raise OverflowError("shortest distance exceeds int32 range")
    out = np.full(v, INF_DIST, dtype=np.int32)
    out[reached] = dist[reached].astype(np.int32)

    # Canonical parents: the same exit-time rule as the device
    # (algo/sssp.py::_sssp_parents) — min u among optimal predecessors.
    parent = np.full(v, INF_DIST, dtype=np.int64)
    sv, dv = graph.src.astype(np.int64), graph.dst.astype(np.int64)
    ok = (dist[sv] != np.iinfo(np.int64).max) & (
        dist[sv] + weights.astype(np.int64) == dist[dv]
    )
    np.minimum.at(parent, dv[ok], sv[ok])
    parent = np.where(reached & (parent != INF_DIST), parent, NO_PARENT)
    parent = parent.astype(np.int32)
    parent[source] = source
    return out, parent


def check_sssp(
    graph: Graph,
    weights: np.ndarray,
    dist: np.ndarray,
    parent: np.ndarray,
    source: int = 0,
) -> list[str]:
    """SSSP optimality verifier; returns violations (empty = OK).

    The min-plus analog of the BFS ``check()``:
      1. the source has distance 0;
      2. per directed edge (u, v): if u is reached, v is reached and
         ``dist[v] <= dist[u] + w`` (no relaxable edge remains);
      3. every reached non-source v has a parent with
         ``dist[v] == dist[parent] + w(parent, v)`` on a real edge, and
         that parent is the canonical MINIMUM optimal predecessor.
    """
    v = graph.num_vertices
    dist = np.asarray(dist)[:v].astype(np.int64)
    parent = np.asarray(parent)[:v].astype(np.int64)
    weights = np.asarray(weights).astype(np.int64)
    violations: list[str] = []

    if dist[source] != 0:
        violations.append(
            f"distance of source {source} to itself = {dist[source]}, not 0"
        )

    sv, dv = graph.src.astype(np.int64), graph.dst.astype(np.int64)
    reach_s, reach_d = dist[sv] != INF_DIST, dist[dv] != INF_DIST
    for i in np.flatnonzero(reach_s & ~reach_d)[:5]:
        violations.append(
            f"edge {sv[i]}->{dv[i]}: source reachable but destination is not"
        )
    slack = reach_s & reach_d & (dist[dv] > dist[sv] + weights)
    for i in np.flatnonzero(slack)[:5]:
        violations.append(
            f"edge {sv[i]}->{dv[i]}: dist[{dv[i]}]={dist[dv[i]]} > "
            f"dist[{sv[i]}]+w={dist[sv[i]] + weights[i]}"
        )

    reached = np.flatnonzero(dist != INF_DIST)
    non_src = reached[reached != source]
    p = parent[non_src]
    bad = non_src[(p < 0) | (p >= v)]
    for w_ in bad[:5]:
        violations.append(f"reached vertex {w_} has no valid parent")
    good = non_src[(p >= 0) & (p < v)]
    # Canonical parent: recompute min optimal predecessor per vertex.
    canon = np.full(v, INF_DIST, dtype=np.int64)
    ok = (dist[sv] != INF_DIST) & (dist[sv] + weights == dist[dv])
    np.minimum.at(canon, dv[ok], sv[ok])
    mismatch = good[parent[good] != canon[good]]
    for w_ in mismatch[:5]:
        violations.append(
            f"vertex {w_}: parent {parent[w_]} is not the canonical "
            f"min optimal predecessor {canon[w_]}"
        )
    return violations
