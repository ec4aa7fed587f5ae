"""Graph files: the Sedgewick text format (``V\\nE\\nv w\\n...``) and SNAP
edge lists, the port of ``bfs_tpu.graph.io``.

The Sedgewick reader mirrors algs4's ``Graph(In)``: read V, skip the E
line, read E edge lines, insert each edge both ways unless ``directed``.
SNAP edge lists (``#`` comments, then ``u<TAB>v`` lines) are the format of
the LiveJournal and Pokec graphs of the reference's matrix.  Files that
either package writes read back to equal arrays in the other.
"""

from __future__ import annotations

import io as _io
import os

import numpy as np

from .csr import Graph


def read_sedgewick(path: str | os.PathLike, *, directed: bool = False) -> Graph:
    """Read a Sedgewick-format graph file (native parser for large files
    when available; identical results through the Python path)."""
    path = os.fspath(path)
    from .native_gen import native_available, read_sedgewick_native

    if os.path.getsize(path) > 1 << 20 and native_available():
        v, src, dst = read_sedgewick_native(path)
        pairs = np.stack([src, dst], axis=1)
        if directed:
            return Graph.from_directed_edges(v, pairs)
        return Graph.from_undirected_edges(v, pairs)
    with open(path, "r") as f:
        return parse_sedgewick(f.read(), directed=directed)


def parse_sedgewick(text: str, *, directed: bool = False) -> Graph:
    data = np.array(text.split(), dtype=np.int64)
    if data.size < 2:
        raise ValueError("Sedgewick graph needs at least V and E header lines")
    v, e = int(data[0]), int(data[1])
    if v < 0 or e < 0:
        raise ValueError("number of vertices/edges must be nonnegative")
    if data.size < 2 + 2 * e:
        raise ValueError(f"expected {e} edges, file has {(data.size - 2) // 2}")
    pairs = data[2 : 2 + 2 * e].reshape(e, 2).astype(np.int32)
    if directed:
        return Graph.from_directed_edges(v, pairs)
    return Graph.from_undirected_edges(v, pairs)


def write_sedgewick(graph: Graph, path: str | os.PathLike) -> None:
    """Write the undirected Sedgewick form: each bi-directed pair once,
    parallel edges kept (a multigraph round-trips exactly)."""
    mask = graph.src < graph.dst
    pairs = np.stack([graph.src[mask], graph.dst[mask]], axis=1)
    # A self-loop bi-directs to two (v, v) copies: one line a loop.
    loops = graph.src == graph.dst
    if loops.any():
        lv = graph.src[loops]
        if lv.size % 2 != 0:
            raise ValueError("odd self-loop copy count; graph is not bi-directed")
        half = np.sort(lv)[::2]
        loop_pairs = np.stack([half, half], axis=1)
        pairs = np.concatenate([pairs, loop_pairs]) if pairs.size else loop_pairs
    buf = _io.StringIO()
    buf.write(f"{graph.num_vertices}\n{len(pairs)}\n")
    for u, w in pairs:
        buf.write(f"{u} {w}\n")
    with open(path, "w") as f:
        f.write(buf.getvalue())


def read_snap_edge_list(path: str | os.PathLike, *, undirected: bool = True,
                        num_vertices: int | None = None) -> Graph:
    """Read a SNAP edge list (``#`` or ``%`` comment lines, then ``u v``
    pairs).  Vertex ids are used as they are; ``num_vertices`` defaults to
    the largest id + 1.  ``undirected`` inserts each edge both ways.

    Real SNAP graphs run to tens of millions of lines, so the reader is
    NumPy's C tokenizer (``np.loadtxt``), not a Python loop a line."""
    data = np.loadtxt(path, dtype=np.int64, comments=["#", "%"], ndmin=2)
    if data.size and data.shape[1] != 2:
        raise ValueError(f"expected u-v edge lines, got {data.shape[1]} columns")
    pairs = data.reshape(-1, 2)
    v = int(pairs.max()) + 1 if pairs.size else 0
    if num_vertices is not None:
        v = max(v, num_vertices)
    pairs = pairs.astype(np.int32)
    if undirected:
        return Graph.from_undirected_edges(v, pairs)
    return Graph.from_directed_edges(v, pairs)


def write_snap_edge_list(pairs: np.ndarray, path: str | os.PathLike, *,
                         name: str = "synthetic", num_vertices: int | None = None) -> None:
    """Write a directed edge list in SNAP's format: its comment header, then
    tab-separated ``u v`` lines."""
    pairs = np.asarray(pairs)
    header = (
        f"# Directed graph (each unordered pair of nodes is saved once): {name}\n"
        f"# Nodes: {num_vertices if num_vertices is not None else int(pairs.max()) + 1}"
        f" Edges: {pairs.shape[0]}\n"
        "# FromNodeId\tToNodeId\n"
    )
    with open(path, "w") as f:
        f.write(header)
        np.savetxt(f, pairs, fmt="%d", delimiter="\t")
