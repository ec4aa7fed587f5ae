"""Sequential BFS oracle: the port's host-side correctness anchor.

  * :func:`queue_bfs` — algs4's FIFO-queue BFS, first-discovery parents
    (the sequential runner's oracle).
  * :func:`canonical_bfs` — level-synchronous BFS whose parent choice is
    the canonical *minimum* frontier neighbour, the rule every engine of
    both packages implements, so distances AND parents compare bit for
    bit.
  * :func:`check` — the algs4 ``BreadthFirstPaths.check()`` optimality
    verifier as a function that returns its violations.

Both run on the host in NumPy, independent of the engine under test.
"""

from __future__ import annotations

from collections import deque
from collections.abc import Sequence

import numpy as np

from ..graph.csr import Graph, INF_DIST, NO_PARENT

__all__ = ["canonical_bfs", "check", "queue_bfs"]


def _sources_array(sources: int | Sequence[int], num_vertices: int) -> np.ndarray:
    arr = np.atleast_1d(np.asarray(sources, dtype=np.int64))
    if arr.size == 0:
        raise ValueError("at least one source required")
    if arr.min() < 0 or arr.max() >= num_vertices:
        raise ValueError("source vertex out of range")
    return arr


def _cached(graph: Graph, name: str, make):
    value = getattr(graph, name, None)
    if value is None:
        value = make()
        object.__setattr__(graph, name, value)
    return value


def _edges_by_dst(graph: Graph) -> tuple[np.ndarray, np.ndarray]:
    """Edges sorted by (dst, src), cached on the graph."""

    def make():
        # One sort of packed dst-major keys: the (dst, src) order, in a
        # fraction of a two-key lexsort's time.
        v = np.int64(max(graph.num_vertices, 1))
        keys = np.sort(graph.dst.astype(np.int64) * v + graph.src)
        return (keys % v).astype(np.int32), (keys // v).astype(np.int32)

    return _cached(graph, "_oracle_by_dst", make)


def queue_bfs(graph: Graph, sources: int | Sequence[int] = 0):
    """FIFO-queue BFS: ``(dist int32[V], parent int32[V])`` with algs4's
    first-discovery parents (enqueue order over the sorted adjacency);
    sources are their own parents."""
    v = graph.num_vertices
    srcs = _sources_array(sources, v)
    indptr, indices = graph.csr()
    dist = np.full(v, INF_DIST, dtype=np.int32)
    parent = np.full(v, NO_PARENT, dtype=np.int32)
    q = deque()
    for s in srcs:  # a multi-source search seeds the queue with every source
        if dist[s] != 0:
            dist[s] = 0
            parent[s] = s
            q.append(int(s))
    while q:
        u = q.popleft()
        for w in indices[indptr[u] : indptr[u + 1]]:
            w = int(w)
            if parent[w] == NO_PARENT:
                parent[w] = u
                dist[w] = dist[u] + 1
                q.append(w)
    return dist, parent


def canonical_bfs(graph: Graph, sources: int | Sequence[int] = 0):
    """Level-synchronous BFS with the canonical min-parent tie-break.
    Returns ``(dist int32[V], parent int32[V])``.

    Per level, a vertex reached for the first time takes as parent the
    MINIMUM id among its current-frontier in-neighbours: over the edges
    sorted by (dst, src), that is the first active edge of its run."""
    v = graph.num_vertices
    srcs = _sources_array(sources, v)
    dist = np.full(v, INF_DIST, dtype=np.int32)
    parent = np.full(v, NO_PARENT, dtype=np.int32)
    dist[srcs] = 0
    parent[srcs] = srcs
    # The edges into still-unreached vertices, in (dst, src) order; they are
    # compacted once most of them lead to reached vertices.
    live_s, live_d = _edges_by_dst(graph)
    frontier = np.zeros(v, dtype=bool)
    frontier[srcs] = True
    level = 0
    while frontier.any():
        open_dst = dist[live_d] == INF_DIST
        if 2 * np.count_nonzero(open_dst) < open_dst.shape[0]:
            live_s, live_d = live_s[open_dst], live_d[open_dst]
            idx = np.flatnonzero(frontier[live_s])
        else:
            idx = np.flatnonzero(frontier[live_s] & open_dst)
        dd = live_d[idx]
        first = np.ones(dd.shape[0], dtype=bool)
        first[1:] = dd[1:] != dd[:-1]
        reached = dd[first]
        dist[reached] = level + 1
        parent[reached] = live_s[idx[first]]
        frontier = np.zeros(v, dtype=bool)
        frontier[reached] = True
        level += 1
    return dist, parent


def check(
    graph: Graph,
    dist: np.ndarray,
    parent: np.ndarray,
    sources: int | Sequence[int] = 0,
) -> list[str]:
    """BFS optimality verifier; returns a list of violations (empty = OK).

      1. every source has distance 0;
      2. for every directed edge v->w with v reached: w is reached and
         dist[w] <= dist[v] + 1;
      3. for every reached non-source w: dist[w] == dist[parent[w]] + 1 and
         the tree edge (parent[w], w) exists in the graph.
    """
    dist = np.asarray(dist)[: graph.num_vertices].astype(np.int64)
    parent = np.asarray(parent)[: graph.num_vertices].astype(np.int64)
    srcs = _sources_array(sources, graph.num_vertices)
    violations: list[str] = []

    for s in srcs[dist[srcs] != 0]:
        violations.append(f"distance of source {s} to itself = {dist[s]}, not 0")

    sv, dv = graph.src, graph.dst
    ds, dd = dist[sv], dist[dv]
    reach_s, reach_d = ds != INF_DIST, dd != INF_DIST
    for i in np.flatnonzero(reach_s & ~reach_d)[:5]:
        violations.append(
            f"edge {sv[i]}->{dv[i]}: source reachable but destination is not"
        )
    tri = reach_s & reach_d & (dd > ds + 1)
    for i in np.flatnonzero(tri)[:5]:
        violations.append(
            f"edge {sv[i]}-{dv[i]}: dist[{dv[i]}]={dist[dv[i]]} > "
            f"dist[{sv[i]}]+1={dist[sv[i]] + 1}"
        )

    reached = np.flatnonzero(dist != INF_DIST)
    non_src = reached[~np.isin(reached, srcs)]
    p = parent[non_src]
    if (p == NO_PARENT).any():
        for w in non_src[p == NO_PARENT][:5]:
            violations.append(f"reached vertex {w} has no parent")
        non_src = non_src[p != NO_PARENT]
        p = parent[non_src]
    bad_tree = dist[non_src] != dist[p] + 1
    for idx in np.flatnonzero(bad_tree)[:5]:
        w = non_src[idx]
        violations.append(
            f"tree edge {parent[w]}->{w}: dist[{w}]={dist[w]} != dist[{parent[w]}]+1"
        )
    # Tree-edge membership in one pass over the edges: w's tree edge exists
    # iff some edge into w comes from parent[w].
    has_tree_edge = np.zeros(graph.num_vertices, dtype=bool)
    has_tree_edge[dv[parent[dv] == sv]] = True
    missing = ~has_tree_edge[non_src]
    for idx in np.flatnonzero(missing)[:5]:
        w = non_src[idx]
        violations.append(f"tree edge {parent[w]}->{w} is not a graph edge")
    return violations
