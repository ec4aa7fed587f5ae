"""bfs_tpu_torch — the BFS engines in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

The port of the JAX package ``bfs_tpu`` (which stays the reference): the
same host layouts, byte for byte, and the same ``dist``/``parent``/
``num_levels``, bit for bit, on the pull (the default), push and relay
engines, and the direction-optimizing search over push and pull
(:func:`bfs_direction`; its knobs in :mod:`bfs_tpu_torch.knobs`), and the
mesh-sharded engine (:mod:`bfs_tpu_torch.parallel`: :func:`bfs_sharded`,
:func:`bfs_sharded_multi` and the resumable :func:`bfs_sharded_segmented`
on a :func:`make_mesh` of shards stacked on one device, on both expansion
arms) and the 2-D grid (:func:`bfs_grid`, :func:`bfs_grid_segmented` on a
:func:`make_grid_mesh` of cells stacked on one device).  It
imports torch and numpy, never jax and nothing of ``bfs_tpu``.  Entry
points run on the card unless the caller passes ``device="cpu"``.  The command-line entry points are
``python -m bfs_tpu_torch.runners.run_parallel`` and
``python -m bfs_tpu_torch.runners.run_sequential``.  A graph's relay
layout is built on the card by :func:`build_relay_graph_device` and kept
on disk as a content-addressed bundle by :func:`load_or_build_relay`
(:class:`LayoutCache`; pull layouts by :func:`load_or_build_pull`).  The
public names are imported on first use.
"""

import importlib

#: Public name -> the submodule that defines it, imported on first use
#: (PEP 562), so that ``import bfs_tpu_torch.knobs`` or the lint
#: (``python -m bfs_tpu_torch.analysis``) imports no torch.
_EXPORTS = {
    "AdjTiles": ".graph.adj_tiles",
    "BfsResult": ".models.bfs",
    "Color": ".graph.vertex",
    "DeviceChecker": ".oracle.device",
    "DeviceGraph": ".graph.csr",
    "DirectionConfig": ".models.direction",
    "DirectionEngine": ".models.direction",
    "EdgeEngine": ".models.bfs",
    "GridEngine": ".parallel.grid",
    "Graph": ".graph.csr",
    "INF_DIST": ".graph.csr",
    "LayoutCache": ".cache.layout",
    "MultiBfsResult": ".models.multisource",
    "NO_PARENT": ".graph.csr",
    "PullGraph": ".graph.ell",
    "RelayEngine": ".models.bfs",
    "RelayGraph": ".graph.relay",
    "ShardedPullGraph": ".graph.ell",
    "ShardedRelayGraph": ".graph.relay",
    "ServiceConfiguration": ".config",
    "SuperstepRunner": ".models.bfs",
    "Vertex": ".graph.vertex",
    "bfs": ".models.bfs",
    "bfs_direction": ".models.direction",
    "bfs_grid": ".parallel.grid",
    "bfs_grid_segmented": ".parallel.grid",
    "bfs_level_curve": ".models.bfs",
    "bfs_multi": ".models.multisource",
    "bfs_multi_device": ".models.multisource",
    "bfs_multi_direction": ".models.direction",
    "bfs_sharded": ".parallel.sharded",
    "bfs_sharded_multi": ".parallel.sharded",
    "bfs_sharded_segmented": ".parallel.sharded",
    "bfs_multi_level_curve": ".models.multisource",
    "build_device_graph": ".graph.csr",
    "build_pull_graph": ".graph.ell",
    "build_relay_graph": ".graph.relay",
    "build_relay_graph_device": ".graph.relay_device",
    "build_sharded_pull_graph": ".graph.ell",
    "build_sharded_relay_graph": ".graph.relay",
    "canonical_bfs": ".oracle.bfs",
    "cc_sharded": ".algo.sharded",
    "check": ".oracle.bfs",
    "collapse_multi_source": ".models.multisource",
    "from_reference_layout": ".graph.relay",
    "gnm_graph": ".graph.generators",
    "load_or_build_pull": ".cache.layout",
    "load_or_build_relay": ".cache.layout",
    "make_grid_mesh": ".parallel.grid",
    "make_mesh": ".parallel.sharded",
    "parse_sedgewick": ".graph.io",
    "parse_state": ".graph.vertex",
    "path_graph": ".graph.generators",
    "path_to": ".graph.vertex",
    "queue_bfs": ".oracle.bfs",
    "read_sedgewick": ".graph.io",
    "read_snap_edge_list": ".graph.io",
    "resolve_direction": ".models.direction",
    "resolve_expansion": ".ops.relay_mxu",
    "rmat_graph": ".graph.generators",
    "serialize_state": ".graph.vertex",
    "snap_shape_edges": ".graph.generators",
    "sssp_sharded": ".algo.sharded",
    "star_graph": ".graph.generators",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name == "parallel":  # the subpackage, as the reference exports it
        return importlib.import_module(".parallel", __name__)
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module 'bfs_tpu_torch' has no attribute {name!r}")
    value = getattr(importlib.import_module(module, __name__), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
