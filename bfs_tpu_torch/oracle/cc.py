"""Sequential connected-components oracle: union-find with min-id labels.
A copy of ``bfs_tpu.oracle.cc``.

The correctness anchor for :mod:`bfs_tpu_torch.algo.cc`: a weighted-union +
path-compression DSU over the edge list, with each component labeled by its
MINIMUM vertex id — the same canonical representative the device's
label-min fixpoint converges to, so labels are comparable bit-for-bit.
"""

from __future__ import annotations

import numpy as np

from ..graph.csr import Graph

__all__ = ["union_find_labels", "check_cc"]


def union_find_labels(graph: Graph) -> np.ndarray:
    """int32[V] component labels: ``label[v]`` is the minimum vertex id
    of v's component (edges treated as undirected unions)."""
    v = graph.num_vertices
    parent = np.arange(v, dtype=np.int64)

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:  # path compression
            parent[x], x = root, parent[x]
        return root

    for u, w in zip(graph.src.tolist(), graph.dst.tolist()):
        ru, rw = find(u), find(w)
        if ru != rw:
            # Union by smaller root id: the root IS the min candidate.
            if ru < rw:
                parent[rw] = ru
            else:
                parent[ru] = rw
    # Final flatten; with union-by-min-id the root is the component min.
    label = np.empty(v, dtype=np.int32)
    for x in range(v):
        label[x] = find(x)
    return label


def check_cc(graph: Graph, label: np.ndarray) -> list[str]:
    """CC label verifier; returns violations (empty = OK).

      1. every edge's endpoints share a label (consistency);
      2. ``label[v] <= v`` (a representative never exceeds its member);
      3. the representative labels itself (``label[label[v]] ==
         label[v]``) — with 1 and 2 this pins min-id canonical labels
         up to cross-component mixups, which the union-find equality
         test in the test suite rules out.
    """
    v = graph.num_vertices
    label = np.asarray(label)[:v].astype(np.int64)
    violations: list[str] = []
    sv, dv = graph.src.astype(np.int64), graph.dst.astype(np.int64)
    mismatch = label[sv] != label[dv]
    for i in np.flatnonzero(mismatch)[:5]:
        violations.append(
            f"edge {sv[i]}-{dv[i]}: labels {label[sv[i]]} != {label[dv[i]]}"
        )
    above = np.flatnonzero(label > np.arange(v))
    for w in above[:5]:
        violations.append(f"vertex {w}: label {label[w]} exceeds its id")
    bad = (label < 0) | (label >= v)
    for w in np.flatnonzero(bad)[:5]:
        violations.append(f"vertex {w}: label {label[w]} out of range")
    ok = ~bad
    roots = label[np.where(ok, label, 0)]
    notself = ok & (roots != label)
    for w in np.flatnonzero(notself)[:5]:
        violations.append(
            f"vertex {w}: representative {label[w]} carries label "
            f"{roots[w]}, not itself"
        )
    return violations
