"""Path reconstruction from parent pointers (algs4 ``pathTo``)."""

from __future__ import annotations

import numpy as np

from .csr import NO_PARENT


def path_to(parent: np.ndarray, v: int, *, source: int | None = None) -> list[int]:
    """Source -> v path by walking parent pointers; [] if v is unreached."""
    parent = np.asarray(parent)
    if v < 0 or v >= parent.shape[0] or parent[v] == NO_PARENT:
        return []
    path = [int(v)]
    while parent[path[-1]] != path[-1]:
        path.append(int(parent[path[-1]]))
        if len(path) > parent.shape[0]:
            raise ValueError("parent pointers contain a cycle")
    path.reverse()
    if source is not None and path[0] != source:
        return []
    return path
