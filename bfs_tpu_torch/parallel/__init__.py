"""The mesh-sharded engine: level-synchronous BFS over partitioned
shards, the shuffle recast as collectives (the port of
``bfs_tpu.parallel``)."""

from .exchange import ExchangeConfig, resolve_exchange  # noqa: F401
from .sharded import (  # noqa: F401
    BATCH_AXIS,
    GRAPH_AXIS,
    bfs_sharded,
    bfs_sharded_multi,
    bfs_sharded_segmented,
    make_mesh,
)
