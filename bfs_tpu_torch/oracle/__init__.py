"""The oracles: the host BFS (:mod:`.bfs`, the algs4 port and ``check()``),
SSSP (:mod:`.sssp`, Dijkstra) and CC (:mod:`.cc`, union-find) oracles,
their on-device checks (:mod:`.device`) and the C++ BFS oracle
(:mod:`.native`), as ``bfs_tpu.oracle`` exports them."""

from .bfs import canonical_bfs, check, queue_bfs  # noqa: F401
from .cc import check_cc, union_find_labels  # noqa: F401
from .device import (  # noqa: F401
    CC_COUNT_FIELDS,
    COUNT_FIELDS,
    SSSP_COUNT_FIELDS,
    DeviceChecker,
    cc_device_check,
    sssp_device_check,
)
from .native import native_available, native_bfs  # noqa: F401
from .sssp import check_sssp, dijkstra  # noqa: F401
