"""Batched multi-source BFS: :class:`MultiBfsResult`, :func:`bfs_multi` and
:func:`collapse_multi_source`.

The port of the relay half of ``bfs_tpu.models.multisource``.  The engine
work lives on :class:`~bfs_tpu_torch.models.bfs.RelayEngine`
(``run_multi_elem``, the element-major batch on the card, and
``run_multi``, the lock-step form).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..graph.csr import INF_DIST, NO_PARENT


@dataclass
class MultiBfsResult:
    """Per-source BFS trees in original ids: ``dist``/``parent`` are
    int32[S, V]; ``num_levels`` is the lock-step superstep count."""

    sources: np.ndarray
    dist: np.ndarray
    parent: np.ndarray
    num_levels: int


def bfs_multi(graph, sources, *, engine: str = "relay", device=None,
              max_levels: int | None = None) -> MultiBfsResult:
    """Batched multi-source BFS on the relay engine (lock-step trees,
    :meth:`RelayEngine.run_multi`); on the card unless ``device`` names the
    CPU.  Each tree equals its single-source search bit for bit."""
    from .bfs import RelayEngine  # bfs.py imports this module

    if engine != "relay":
        raise ValueError(f"unknown engine {engine!r}; this port runs 'relay'")
    sources = np.atleast_1d(np.asarray(sources, dtype=np.int32))
    return RelayEngine(graph, device=device).run_multi(sources, max_levels=max_levels)


def collapse_multi_source(result: MultiBfsResult):
    """Reduce per-source trees to the oracle's multi-source answer:
    ``dist[v] = min_s dist_s[v]``, the parent from the argmin source's tree
    with the min-source tie-break."""
    order = np.argsort(result.sources, kind="stable")
    dist_s = result.dist[order]
    parent_s = result.parent[order]
    srcs = result.sources[order]
    best = np.argmin(dist_s, axis=0)  # first (= min source) among ties
    cols = np.arange(dist_s.shape[1])
    dist = dist_s[best, cols]
    parent = parent_s[best, cols]
    # A multi-source tree roots each source at itself (its own parent).
    is_source = np.isin(np.arange(dist.shape[0]), srcs) & (dist == 0)
    parent = np.where(is_source, np.arange(dist.shape[0]), parent)
    parent = np.where(dist == INF_DIST, NO_PARENT, parent)
    return dist.astype(np.int32), parent.astype(np.int32)
