"""Vertex record, Color lattice and the text wire format of the
reference's per-superstep state files (``problemFile_i``).

The port of ``bfs_tpu.graph.vertex``: dumps are byte for byte the
reference's.  ``Color`` keeps the reference's ordinal order (WHITE <
GRAY < BLACK, the reducer's darkest-color merge).  A vertex serializes as
``id|[n1, n2]|[p1, p2]|distance|COLOR``, neighbours sorted, distance
``Integer.MAX_VALUE`` (2**31-1) when unreached; paths are rebuilt from
parent pointers (:func:`path_to`).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np

from .csr import Graph, INF_DIST, NO_PARENT


class Color(enum.IntEnum):
    """Visit lattice; ordinal order matters for the darkest-color merge
    (Color.java:6, BfsSpark.java:103)."""

    WHITE = 0
    GRAY = 1
    BLACK = 2


@dataclass(frozen=True)
class Vertex:
    """Host-side vertex record matching Vertex.java:28-36.

    ``neighbours`` is kept sorted for deterministic serialization (Java's
    HashSet order is hash-dependent; any order parses back identically).
    """

    id: int
    neighbours: tuple[int, ...]
    path: tuple[int, ...]
    distance: int
    color: Color

    @classmethod
    def parse(cls, line: str) -> "Vertex":
        """Parse the bar wire format (Vertex.java:51-64 parity): tolerant of
        spaces after commas and empty bracket lists."""
        parts = line.strip().split("|")
        if len(parts) != 5:
            raise ValueError(f"malformed vertex line (need 5 bar-fields): {line!r}")
        vid = int(parts[0])
        neighbours = _parse_int_list(parts[1])
        path = _parse_int_list(parts[2])
        distance = int(parts[3])
        color = Color[parts[4].strip()]
        return cls(vid, tuple(sorted(neighbours)), tuple(path), distance, color)

    def serialize(self) -> str:
        """Emit ``id|[n1, n2]|[p1, p2]|distance|COLOR`` exactly like Java
        collection ``toString`` joined with bars (Vertex.java:122-125)."""
        return "|".join(
            [
                str(self.id),
                _fmt_int_list(self.neighbours),
                _fmt_int_list(self.path),
                str(self.distance),
                self.color.name,
            ]
        )

    def with_color(self, color: Color) -> "Vertex":
        """Parity with ``setColor`` (Vertex.java:90), immutably."""
        return Vertex(self.id, self.neighbours, self.path, self.distance, color)


def _parse_int_list(text: str) -> list[int]:
    text = text.strip()
    if not (text.startswith("[") and text.endswith("]")):
        raise ValueError(f"expected bracketed list, got {text!r}")
    inner = text[1:-1].strip()
    if not inner:
        return []
    return [int(tok.strip()) for tok in inner.split(",")]


def _fmt_int_list(values) -> str:
    return "[" + ", ".join(str(int(v)) for v in values) + "]"


# ---------------------------------------------------------------------------
# Engine-state <-> Vertex-record conversion (the state-dump capability)
# ---------------------------------------------------------------------------


def colors_from_state(dist: np.ndarray, frontier: np.ndarray) -> np.ndarray:
    """Derive the 3-state color from engine arrays: frontier = GRAY,
    visited-not-frontier = BLACK, unreached = WHITE (Color.java semantics)."""
    dist = np.asarray(dist)
    frontier = np.asarray(frontier)
    colors = np.full(dist.shape, int(Color.WHITE), dtype=np.int8)
    colors[(dist != INF_DIST) & ~frontier] = int(Color.BLACK)
    colors[frontier] = int(Color.GRAY)
    return colors


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


def state_to_vertices(
    graph: Graph,
    dist: np.ndarray,
    parent: np.ndarray,
    frontier: np.ndarray,
    *,
    source: int = 0,
) -> list[Vertex]:
    """Render full engine state as Vertex records, one per vertex.

    Quirk parity: the reference initialises every unreached vertex with the
    *source's* path list ``[source]`` (GraphFileUtil.java:55, a shared-list
    quirk), so unreached vertices serialize with path ``[source]`` here too.
    """
    dist = np.asarray(dist)[: graph.num_vertices]
    parent = np.asarray(parent)[: graph.num_vertices]
    frontier = np.asarray(frontier)[: graph.num_vertices]
    colors = colors_from_state(dist, frontier)
    out = []
    for v in range(graph.num_vertices):
        nbrs = tuple(int(x) for x in np.unique(graph.adj(v)))
        if dist[v] == INF_DIST:
            path = (source,)
        else:
            path = tuple(path_to(parent, v))
        out.append(Vertex(v, nbrs, path, int(dist[v]), Color(int(colors[v]))))
    return out


def serialize_state(graph, dist, parent, frontier, *, source: int = 0) -> str:
    """Newline-joined vertex lines — the ``problemFile_i`` file format
    (GraphFileUtil.java:68, BfsSpark.java:115-116)."""
    return "\n".join(
        v.serialize()
        for v in state_to_vertices(graph, dist, parent, frontier, source=source)
    )


def initial_state_vertices(graph: Graph, source: int = 0) -> list[Vertex]:
    """The iteration-0 file contents (GraphFileUtil.java:50-56): source GRAY
    with path [source], distance 0; all others WHITE, Integer.MAX_VALUE."""
    out = []
    for v in range(graph.num_vertices):
        nbrs = tuple(int(x) for x in np.unique(graph.adj(v)))
        if v == source:
            out.append(Vertex(v, nbrs, (source,), 0, Color.GRAY))
        else:
            out.append(Vertex(v, nbrs, (source,), INF_DIST, Color.WHITE))
    return out


def parse_state(text: str, num_vertices: int):
    """Parse a ``problemFile_i``-style dump back into engine arrays
    ``(dist, parent, frontier)`` — the resume half of checkpoint parity
    (BfsSpark.java:62 re-reads the previous superstep file).

    The parent of a reached vertex is recovered from the second-to-last path
    element (the wire format carries paths, not parents).
    """
    dist = np.full(num_vertices, INF_DIST, dtype=np.int32)
    parent = np.full(num_vertices, NO_PARENT, dtype=np.int32)
    frontier = np.zeros(num_vertices, dtype=bool)
    for line in text.strip().splitlines():
        if not line.strip():
            continue
        vx = Vertex.parse(line)
        dist[vx.id] = vx.distance
        if vx.color != Color.WHITE and vx.path:
            parent[vx.id] = vx.path[-2] if len(vx.path) >= 2 else vx.path[-1]
        frontier[vx.id] = vx.color == Color.GRAY
    return dist, parent, frontier
