"""Named locks for the query server's shared state.

:func:`make_lock` is :func:`bfs_tpu_torch.analysis.runtime.make_lock`: a
plain ``threading.Lock`` or ``RLock`` named for the field it guards, or,
under ``BFS_TPU_TORCH_LOCK_ORDER``, a proxy that records the order locks
of each name nest in and reports cycles (``lock_order_report``).
"""

from __future__ import annotations

from ..analysis.runtime import make_lock

__all__ = ["make_lock"]
