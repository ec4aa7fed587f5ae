"""bfs_tpu_torch — the relay BFS engine in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

The port of the JAX package ``bfs_tpu`` (which stays the reference): the
same host layout, byte for byte, and the same ``dist``/``parent``/
``num_levels``, bit for bit.  It imports torch and numpy, never jax and
nothing of ``bfs_tpu``.  Entry points run on the card unless the caller
passes ``device="cpu"``.
"""

from .graph.adj_tiles import AdjTiles
from .graph.csr import INF_DIST, NO_PARENT, Graph
from .graph.generators import gnm_graph, path_graph, rmat_graph
from .graph.io import read_sedgewick
from .graph.relay import RelayGraph, build_relay_graph, from_reference_layout
from .models.bfs import BfsResult, RelayEngine, bfs
from .models.multisource import MultiBfsResult, bfs_multi, collapse_multi_source
from .ops.relay_mxu import resolve_expansion
from .oracle.bfs import canonical_bfs, check

__all__ = [
    "AdjTiles",
    "BfsResult",
    "Graph",
    "INF_DIST",
    "MultiBfsResult",
    "NO_PARENT",
    "RelayEngine",
    "RelayGraph",
    "bfs",
    "bfs_multi",
    "build_relay_graph",
    "canonical_bfs",
    "check",
    "collapse_multi_source",
    "from_reference_layout",
    "gnm_graph",
    "path_graph",
    "read_sedgewick",
    "resolve_expansion",
    "rmat_graph",
]
