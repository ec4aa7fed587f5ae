"""bfs_tpu_torch — the BFS engines in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

The port of the JAX package ``bfs_tpu`` (which stays the reference): the
same host layouts, byte for byte, and the same ``dist``/``parent``/
``num_levels``, bit for bit, on the pull (the default), push and relay
engines, and the direction-optimizing search over push and pull
(:func:`bfs_direction`; its knobs in :mod:`bfs_tpu_torch.knobs`).  It
imports torch and numpy, never jax and nothing of ``bfs_tpu``.  Entry
points run on the card unless the caller passes ``device="cpu"``.  The command-line entry points are
``python -m bfs_tpu_torch.runners.run_parallel`` and
``python -m bfs_tpu_torch.runners.run_sequential``.  A graph's relay
layout is built on the card by :func:`build_relay_graph_device` and kept
on disk as a content-addressed bundle by :func:`load_or_build_relay`
(:class:`LayoutCache`; pull layouts by :func:`load_or_build_pull`).
"""

from .cache.layout import LayoutCache, load_or_build_pull, load_or_build_relay
from .config import ServiceConfiguration
from .graph.adj_tiles import AdjTiles
from .graph.csr import INF_DIST, NO_PARENT, DeviceGraph, Graph, build_device_graph
from .graph.ell import PullGraph, build_pull_graph
from .graph.generators import gnm_graph, path_graph, rmat_graph, snap_shape_edges, star_graph
from .graph.io import parse_sedgewick, read_sedgewick, read_snap_edge_list
from .graph.relay import RelayGraph, build_relay_graph, from_reference_layout
from .graph.relay_device import build_relay_graph_device
from .graph.vertex import Color, Vertex, parse_state, path_to, serialize_state
from .models.bfs import (
    BfsResult,
    EdgeEngine,
    RelayEngine,
    SuperstepRunner,
    bfs,
    bfs_level_curve,
)
from .models.direction import (
    DirectionConfig,
    DirectionEngine,
    bfs_direction,
    bfs_multi_direction,
    resolve_direction,
)
from .models.multisource import (
    MultiBfsResult,
    bfs_multi,
    bfs_multi_device,
    bfs_multi_level_curve,
    collapse_multi_source,
)
from .ops.relay_mxu import resolve_expansion
from .oracle.bfs import canonical_bfs, check, queue_bfs
from .oracle.device import DeviceChecker

__all__ = [
    "AdjTiles",
    "BfsResult",
    "Color",
    "DeviceChecker",
    "DeviceGraph",
    "DirectionConfig",
    "DirectionEngine",
    "EdgeEngine",
    "Graph",
    "INF_DIST",
    "LayoutCache",
    "MultiBfsResult",
    "NO_PARENT",
    "PullGraph",
    "RelayEngine",
    "RelayGraph",
    "ServiceConfiguration",
    "SuperstepRunner",
    "Vertex",
    "bfs",
    "bfs_direction",
    "bfs_level_curve",
    "bfs_multi",
    "bfs_multi_device",
    "bfs_multi_direction",
    "bfs_multi_level_curve",
    "build_device_graph",
    "build_pull_graph",
    "build_relay_graph",
    "build_relay_graph_device",
    "canonical_bfs",
    "check",
    "collapse_multi_source",
    "from_reference_layout",
    "gnm_graph",
    "load_or_build_pull",
    "load_or_build_relay",
    "parse_sedgewick",
    "parse_state",
    "path_graph",
    "path_to",
    "queue_bfs",
    "read_sedgewick",
    "read_snap_edge_list",
    "resolve_direction",
    "resolve_expansion",
    "rmat_graph",
    "serialize_state",
    "snap_shape_edges",
    "star_graph",
]
