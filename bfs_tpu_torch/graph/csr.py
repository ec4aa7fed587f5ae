"""Graph containers: flat directed edge arrays (int32) with a lazy CSR
view, and the push engine's padded edge form.

The port's copy of ``bfs_tpu.graph.csr``: a :class:`DeviceGraph` is byte
for byte the reference's ``build_device_graph(graph, num_shards=n)``, one
shard or the round-robin edge shards of the mesh engine
(:mod:`bfs_tpu_torch.parallel.sharded`).  Undirected inputs are stored
bi-directed, both (u, v) and (v, u), as algs4's ``Graph.addEdge`` does.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

INT32_MAX = np.int32(np.iinfo(np.int32).max)
#: Distance of an unreached vertex (Java ``Integer.MAX_VALUE``).
INF_DIST = int(INT32_MAX)
#: Parent of a vertex with no parent yet (the source's parent is itself).
NO_PARENT = -1


@dataclass(frozen=True)
class Graph:
    """A directed multigraph as flat edge arrays (int32), plus lazy CSR.

    ``num_vertices`` is V; ``src``/``dst`` hold E directed edges.
    """

    num_vertices: int
    src: np.ndarray
    dst: np.ndarray

    def __post_init__(self):
        object.__setattr__(self, "src", np.ascontiguousarray(self.src, dtype=np.int32))
        object.__setattr__(self, "dst", np.ascontiguousarray(self.dst, dtype=np.int32))
        if self.src.shape != self.dst.shape or self.src.ndim != 1:
            raise ValueError("src/dst must be 1-D arrays of equal length")
        if self.num_edges and (
            int(min(self.src.min(initial=0), self.dst.min(initial=0))) < 0
            or int(max(self.src.max(initial=0), self.dst.max(initial=0))) >= self.num_vertices
        ):
            raise ValueError("edge endpoint out of range")

    @property
    def num_edges(self) -> int:
        """Directed edge count (an undirected input counts twice)."""
        return int(self.src.shape[0])

    @classmethod
    def from_undirected_edges(cls, num_vertices: int, edges: np.ndarray) -> "Graph":
        """Insert every undirected edge in both directions."""
        edges = np.asarray(edges, dtype=np.int32).reshape(-1, 2)
        src = np.concatenate([edges[:, 0], edges[:, 1]])
        dst = np.concatenate([edges[:, 1], edges[:, 0]])
        return cls(num_vertices, src, dst)

    @classmethod
    def from_directed_edges(cls, num_vertices: int, edges: np.ndarray) -> "Graph":
        edges = np.asarray(edges, dtype=np.int32).reshape(-1, 2)
        return cls(num_vertices, edges[:, 0].copy(), edges[:, 1].copy())

    def csr(self) -> tuple[np.ndarray, np.ndarray]:
        """``(indptr int64[V+1], indices int32[E])`` with each vertex's
        neighbours sorted ascending."""
        if not hasattr(self, "_csr_cache"):
            order = np.lexsort((self.dst, self.src))
            indices = self.dst[order]
            counts = np.bincount(self.src, minlength=self.num_vertices)
            indptr = np.zeros(self.num_vertices + 1, dtype=np.int64)
            np.cumsum(counts, out=indptr[1:])
            object.__setattr__(self, "_csr_cache", (indptr, indices))
        return self._csr_cache

    def degree(self, v: int) -> int:
        indptr, _ = self.csr()
        return int(indptr[v + 1] - indptr[v])

    def adj(self, v: int) -> np.ndarray:
        indptr, indices = self.csr()
        return indices[indptr[v] : indptr[v + 1]]


@dataclass(frozen=True)
class DeviceGraph:
    """The push engine's edge arrays: sorted by ``(dst, src)``, padded to a
    multiple of ``block`` with ``(sentinel, sentinel)`` edges, where
    ``sentinel == V``.  State arrays have V+1 slots and slot V is never on
    the frontier, so padded edges are inert without masks.  With
    ``num_shards > 1`` the arrays are ``[num_shards, padded_edges /
    num_shards]``: the edge shards of the mesh engine, each sorted by
    ``(dst, src)`` on its own."""

    num_vertices: int
    num_edges: int  # real (unpadded) directed edges
    src: np.ndarray  # int32[padded_edges] or int32[num_shards, padded / num_shards]
    dst: np.ndarray
    num_shards: int = 1

    @property
    def padded_edges(self) -> int:
        return int(self.src.size)

    @property
    def sentinel(self) -> int:
        return self.num_vertices


def pad_to_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def _sorted_by_dst(src: np.ndarray, dst: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Edges sorted by (dst, src): the native radix sort for large inputs
    when it builds, else ``np.lexsort``; both are the same stable order."""
    from .native_gen import native_available, sort_edges_by_dst_native

    if src.size > 100_000 and native_available():
        return sort_edges_by_dst_native(src, dst)
    order = np.lexsort((src, dst))
    return src[order], dst[order]


def build_device_graph(graph: "Graph | DeviceGraph", *, num_shards: int = 1,
                       block: int = 1024) -> DeviceGraph:
    """Sort edges by destination and pad with sentinel edges; with
    ``num_shards > 1`` split them into edge shards.  A single-shard
    DeviceGraph given as ``graph`` is sorted already: its edges are split
    again without a sort.

    Each shard holds a multiple of ``block`` edges.  The split is
    round-robin over the dst-sorted edges (edge ``i`` to shard ``i % n``),
    so every shard sees a similar spread of destinations.  Each shard is
    then in ``(dst, src)`` order, as the reference sorts it: a strided
    subsequence of a sorted sequence (the sentinel padding last) is
    sorted."""
    if num_shards < 1:
        raise ValueError("num_shards must be >= 1")
    if isinstance(graph, DeviceGraph):
        if graph.num_shards != 1:
            raise ValueError("build_device_graph takes a Graph or a single-shard DeviceGraph")
        src, dst = unpad_edges(graph)
    else:
        src, dst = _sorted_by_dst(graph.src, graph.dst)
    e = graph.num_edges
    per_shard = pad_to_multiple(max(pad_to_multiple(e, num_shards) // num_shards, 1), block)
    pad = per_shard * num_shards - e
    sentinel = np.full(pad, graph.num_vertices, dtype=np.int32)
    src = np.concatenate([src, sentinel])
    dst = np.concatenate([dst, sentinel])
    if num_shards > 1:
        src = np.ascontiguousarray(src.reshape(per_shard, num_shards).T)
        dst = np.ascontiguousarray(dst.reshape(per_shard, num_shards).T)
    return DeviceGraph(
        num_vertices=graph.num_vertices,
        num_edges=e,
        src=src,
        dst=dst,
        num_shards=num_shards,
    )


def unpad_edges(dg: DeviceGraph) -> tuple[np.ndarray, np.ndarray]:
    """The real ``(src, dst)`` host arrays of a DeviceGraph of any shard
    count, in stored (per-shard dst-sorted) order."""
    src, dst = dg.src.reshape(-1), dg.dst.reshape(-1)
    keep = dst != dg.sentinel
    return src[keep], dst[keep]


def reshard(dg: DeviceGraph, num_shards: int, *, block: int = 1024) -> DeviceGraph:
    """The edges of ``dg`` split again into ``num_shards`` shards."""
    src, dst = unpad_edges(dg)
    return build_device_graph(Graph(dg.num_vertices, src, dst), num_shards=num_shards,
                              block=block)
