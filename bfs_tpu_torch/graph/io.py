"""Sedgewick text-format graph ingest (``V\\nE\\nv w\\n...``).

Mirrors algs4's ``Graph(In)``: read V, skip the E line, read E edge lines,
insert each edge both ways unless ``directed``.
"""

from __future__ import annotations

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
