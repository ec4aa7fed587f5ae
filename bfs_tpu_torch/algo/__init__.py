"""Semiring-parameterized graph algorithms on the level loop: the port of
``bfs_tpu.algo``.

One substrate (:mod:`bfs_tpu_torch.algo.substrate`: the
contribute/combine/identity/state contract, the endpoint-hash weights, the
segmented driver), several algorithms: BFS (the original instance,
:mod:`bfs_tpu_torch.models.bfs`), weighted SSSP as min-plus supersteps with
delta-stepping buckets (:mod:`bfs_tpu_torch.algo.sssp`) and connected
components as label-min propagation (:mod:`bfs_tpu_torch.algo.cc`), each on
the fused and the segmented runs with oracle-exact results, and their
edge-sharded arms on a mesh (:mod:`bfs_tpu_torch.algo.sharded`:
``sssp_sharded``, ``cc_sharded``).
"""

from .cc import CcResult, cc, cc_segmented
from .sharded import cc_sharded, sssp_sharded
from .sssp import SsspResult, sssp, sssp_segmented
from .substrate import (
    DEFAULT_MAX_WEIGHT,
    SEMIRINGS,
    Semiring,
    edge_weights_np,
    resolve_delta,
)

__all__ = [
    "CcResult",
    "DEFAULT_MAX_WEIGHT",
    "SEMIRINGS",
    "Semiring",
    "SsspResult",
    "cc",
    "cc_segmented",
    "cc_sharded",
    "edge_weights_np",
    "resolve_delta",
    "sssp",
    "sssp_segmented",
    "sssp_sharded",
]
