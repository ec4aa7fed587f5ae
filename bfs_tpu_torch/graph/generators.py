"""Synthetic graph generators: R-MAT (Graph500 style), SNAP-shaped edge
lists, G(n, m), paths and stars.

The same NumPy generators as ``bfs_tpu.graph.generators``, so one seed
gives the same graph in both packages.
"""

from __future__ import annotations

import numpy as np

from .csr import Graph


def rmat_edges(
    scale: int,
    edge_factor: int = 16,
    *,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 1,
    permute_labels: bool = True,
) -> np.ndarray:
    """Vectorised R-MAT edge generator (Graph500 parameters by default):
    ``int64[E, 2]`` undirected endpoints for ``2**scale`` vertices and
    ``edge_factor * 2**scale`` edges, self-loops and duplicates kept."""
    n = 1 << scale
    m = edge_factor * n
    rng = np.random.default_rng(seed)
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for bit in range(scale):
        src_bit = rng.random(m) > ab
        dst_bit = np.where(src_bit, rng.random(m) > c_norm, rng.random(m) > a_norm)
        src |= src_bit.astype(np.int64) << bit
        dst |= dst_bit.astype(np.int64) << bit
    if permute_labels:
        perm = rng.permutation(n)
        src = perm[src]
        dst = perm[dst]
    return np.stack([src, dst], axis=1)


def rmat_graph(scale: int, edge_factor: int = 16, **kwargs) -> Graph:
    edges = rmat_edges(scale, edge_factor, **kwargs)
    return Graph.from_undirected_edges(1 << scale, edges.astype(np.int32))


def rmat_graph_native(scale: int, edge_factor: int = 16, *, seed: int = 1) -> Graph:
    """R-MAT from the native generator (what the repo's benchmark uses when
    it is available): much faster at large scales, different edges."""
    from .native_gen import rmat_edges_native

    u, v = rmat_edges_native(scale, edge_factor, seed=seed)
    return Graph(1 << scale, np.concatenate([u, v]), np.concatenate([v, u]))


def snap_shape_edges(num_vertices: int, num_edges: int, *, seed: int = 0) -> np.ndarray:
    """R-MAT-skewed directed edge list with an arbitrary (non-power-of-two)
    vertex count, the shape of real SNAP social graphs: edges drawn in the
    enclosing power-of-two id space for the heavy-tailed degrees, then
    folded into ``[0, V)``; the label permutation spreads the hubs."""
    scale = max(int(num_vertices - 1).bit_length(), 1)
    per = num_edges // (1 << scale) + 1  # per * 2^scale >= num_edges always
    edges = rmat_edges(scale, per, seed=seed)[:num_edges]
    return edges % num_vertices


def gnm_graph(num_vertices: int, num_edges: int, *, seed: int = 0) -> Graph:
    """Uniform random undirected multigraph with ``num_edges`` edges."""
    rng = np.random.default_rng(seed)
    pairs = rng.integers(0, num_vertices, size=(num_edges, 2), dtype=np.int64)
    return Graph.from_undirected_edges(num_vertices, pairs.astype(np.int32))


def path_graph(num_vertices: int) -> Graph:
    """A simple path 0-1-2-...-(V-1); worst-case diameter for level-sync BFS."""
    u = np.arange(num_vertices - 1, dtype=np.int32)
    return Graph.from_undirected_edges(num_vertices, np.stack([u, u + 1], axis=1))


def star_graph(num_vertices: int, hub: int = 0) -> Graph:
    """A star: ``hub`` joined to every other vertex.  The maximum fan-out in
    one superstep (the direction policy's switch case)."""
    leaves = np.array([v for v in range(num_vertices) if v != hub], dtype=np.int32)
    hubs = np.full(leaves.shape, hub, dtype=np.int32)
    return Graph.from_undirected_edges(num_vertices, np.stack([hubs, leaves], axis=1))
