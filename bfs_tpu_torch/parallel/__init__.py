"""The mesh-sharded engine and the 2-D grid: level-synchronous BFS over
partitioned shards, the shuffle recast as collectives (the port of
``bfs_tpu.parallel``)."""

from .exchange import ExchangeConfig, resolve_exchange  # noqa: F401
from .grid import (  # noqa: F401
    GRID_COL_AXIS,
    GRID_ROW_AXIS,
    GridEngine,
    bfs_grid,
    bfs_grid_segmented,
    make_grid_mesh,
    resolve_grid_mesh,
)
from .sharded import (  # noqa: F401
    BATCH_AXIS,
    GRAPH_AXIS,
    bfs_sharded,
    bfs_sharded_multi,
    bfs_sharded_segmented,
    make_mesh,
)
