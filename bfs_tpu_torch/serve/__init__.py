"""bfs_tpu_torch.serve — long-lived, in-process BFS query serving on one
card: the port of ``bfs_tpu.serve``.

Register a graph once (layouts memoized, engines resident under a device
budget), then stream single-source and multi-source queries through a
micro-batcher that coalesces them into the batched engines and, in steady
state, replays what it captured::

    from bfs_tpu_torch.serve import BfsServer

    server = BfsServer()               # the card; BfsServer(device="cpu")
    server.register("g", graph)
    reply = server.query("g", 0).result()
    reply.dist, reply.parent           # canonical min-parent BFS tree

Components: :class:`GraphRegistry` (epoch-versioned layouts and resident
engines; re-registering a name hot-swaps the graph while in-flight queries
finish on their admission-time snapshot), :class:`ExecutableCache` (batch
runners keyed by graph, epoch, engine, bucket and direction policy),
:class:`BfsServer` (admission queue, micro-batching, deadlines,
transient-failure retry, result LRU, oracle degradation) and
:class:`ServeHealth` (circuit breaker per executable, hung-call watchdog,
sampled integrity checks).  With ``BFS_TPU_TORCH_CKPT`` on, pull and push
batches run checkpointed (:class:`SegmentedBatchRunner`), and a hung call
resumes from its last segment.  :func:`registry_sssp` and :func:`registry_cc`
run weighted SSSP and connected components on a registered graph's resident
engine.  With ``BFS_TPU_TORCH_LABELS=<K>`` the server answers point queries
(``query_dist``, ``query_path``) from a landmark label index built at
register time (:class:`LabelOracle` over a :class:`LabelIndex`), falling back
to the traversal where its certificate does not hold; :class:`FleetRouter`
puts N such servers behind a hash-by-graph router with failover and rolling
epoch swaps over a shared bundle store.
"""

from .algo import registry_cc, registry_sssp
from .executor import (
    AbandonedAttempt,
    BatchRunner,
    ExecutableCache,
    HostRows,
    SegmentedBatchRunner,
    build_batch_runner,
    bucket_for,
    run_oracle_batch,
)
from .health import HungCallError, ServeHealth, run_with_deadline
from .labels import LabelBudgetError, LabelIndex, LabelOracle, build_label_index
from .registry import ENGINES, GraphRegistry, RegisteredGraph
from .router import FleetRouter, NoReplicaAvailable
from .server import (
    DEFAULT_RETRY_POLICY,
    AdmissionError,
    BfsServer,
    CircuitOpenError,
    DistReply,
    QueryTimeout,
    ServeError,
    ServeReply,
    ServerClosed,
)

__all__ = [
    "AbandonedAttempt",
    "AdmissionError",
    "BatchRunner",
    "BfsServer",
    "CircuitOpenError",
    "DEFAULT_RETRY_POLICY",
    "DistReply",
    "ENGINES",
    "ExecutableCache",
    "FleetRouter",
    "GraphRegistry",
    "HostRows",
    "HungCallError",
    "LabelBudgetError",
    "LabelIndex",
    "LabelOracle",
    "NoReplicaAvailable",
    "QueryTimeout",
    "RegisteredGraph",
    "ServeError",
    "ServeHealth",
    "ServeReply",
    "SegmentedBatchRunner",
    "ServerClosed",
    "bucket_for",
    "build_batch_runner",
    "build_label_index",
    "registry_cc",
    "registry_sssp",
    "run_oracle_batch",
    "run_with_deadline",
]
