"""Hash-routed serve fleet: N replicas behind one thin router.  The port of
``bfs_tpu.serve.router``.

One :class:`~bfs_tpu_torch.serve.server.BfsServer` is a single serial
batch loop; read-heavy point-query traffic wants N of them:

* **replicas** — N in-process ``BfsServer`` instances, each with its OWN
  :class:`~bfs_tpu_torch.serve.registry.GraphRegistry` (own residency, own
  health), all sharing ONE content-addressed on-disk
  :class:`~bfs_tpu_torch.cache.layout.LayoutCache` (atomic writes, first
  builder wins).
* **routing** — a deterministic hash of (graph, sources) picks the primary
  replica, so repeated queries land on the same result and executable
  caches; admission (backpressure, deadlines, breakers, watchdog) is the
  replica's own.
* **failover** — a replica that rejects at admission or fails a routed
  query is retried on the next replica of the ring;
  ``BFS_TPU_TORCH_ROUTER_FAILURES`` consecutive failures open a
  router-side breaker for ``BFS_TPU_TORCH_ROUTER_COOLDOWN_S`` (a dead
  replica is routed around for good).  Deadline expiry is the caller's
  budget, never a replica fault: it does not fail over and does not count.
* **epoch rolls** — ``register`` walks the replicas in turn: the first
  pays the (disk-cached) builds, the rest warm-hit the shared bundles.
  During the roll replicas serve mixed epochs; each answer is computed on
  one consistent snapshot.

**On one card.**  The replicas share the card, and all of their device
work goes through the one process-wide
:data:`~bfs_tpu_torch.serve.executor.DEVICE_LOCK`, so their ticks and
lookups run one at a time; each replica's registry holds its own engines
and label rows.  ``device=`` (forwarded to every replica's registry) runs
the fleet on the CPU.
"""

from __future__ import annotations

import hashlib
import logging
import time
from concurrent.futures import Future

import numpy as np

from .. import knobs
from ..utils.locks import make_lock
from ..utils.metrics import ServeMetrics
from .registry import GraphRegistry
from .server import BfsServer, QueryTimeout, ServeError

logger = logging.getLogger(__name__)


class NoReplicaAvailable(ServeError):
    """Every replica is dead, breaker-open, or rejected the query."""


class _ReplicaState:
    __slots__ = ("failures", "open_until", "dead")

    def __init__(self):
        self.failures = 0
        self.open_until = 0.0
        self.dead = False


class FleetRouter:
    """Thin hash-by-graph router over N in-process serve replicas.

    ``replicas=N`` gives each replica a fresh registry over the shared
    ``layout_cache``; ``servers`` injects pre-built ones.  ``**server_kw``
    goes to every constructed :class:`BfsServer` (``device`` to its
    registry as well)."""

    def __init__(self, replicas: int = 2, *, layout_cache=None,
                 metrics: ServeMetrics | None = None, servers: list | None = None,
                 failure_threshold: int | None = None, cooldown_s: float | None = None,
                 **server_kw):
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self._failure_threshold = (failure_threshold if failure_threshold is not None
                                   else knobs.get("BFS_TPU_TORCH_ROUTER_FAILURES"))
        self._cooldown_s = (cooldown_s if cooldown_s is not None
                            else knobs.get("BFS_TPU_TORCH_ROUTER_COOLDOWN_S"))
        if servers is not None:
            self.servers = tuple(servers)  # immutable: death lives in _state
        else:
            if replicas < 1:
                raise ValueError(f"need >= 1 replica (got {replicas})")
            device = server_kw.pop("device", None)
            self.servers = tuple(
                BfsServer(GraphRegistry(layout_cache=layout_cache, device=device), **server_kw)
                for _ in range(int(replicas)))
        self._state = [_ReplicaState() for _ in self.servers]  # guarded-by: _lock
        self._lock = make_lock("router._lock")

    # ----------------------------------------------------------- lifecycle --
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        for srv in self.servers:
            srv.close()

    @property
    def num_replicas(self) -> int:
        return len(self.servers)

    def alive(self) -> list[int]:
        with self._lock:
            return [i for i, st in enumerate(self._state) if not st.dead]

    def kill_replica(self, i: int) -> None:
        """An induced replica failure (chaos, tests): the server closed and
        routed around for good."""
        with self._lock:
            self._state[i].dead = True
        self.metrics.bump("router_replicas_killed")
        self.servers[i].close()

    # ------------------------------------------------------------- rolling --
    def register(self, name: str, graph, **kw) -> list:
        """Fleet-wide register or hot swap, replica after replica: the first
        pays the (sidecar-cached) layout and label builds, later ones
        warm-hit the shared store.  The per-replica epoch records."""
        recs = []
        for i, srv in enumerate(self.servers):
            with self._lock:
                dead = self._state[i].dead
            if dead:
                continue
            recs.append(srv.register(name, graph, **kw))
            self.metrics.bump("router_rolling_registers")
        if not recs:
            raise NoReplicaAvailable("no live replica to register on")
        return recs

    def unregister(self, name: str) -> None:
        for i, srv in enumerate(self.servers):
            with self._lock:
                dead = self._state[i].dead
            if not dead:
                srv.unregister(name)

    # ------------------------------------------------------------- routing --
    def _ring(self, graph: str, sources) -> list[int]:
        """Primary-first replica order of one query: a blake2b of (graph,
        sources), the reference's hash, then the rest of the ring."""
        seed = f"{graph}:{','.join(str(int(s)) for s in np.atleast_1d(sources))}"
        h = int.from_bytes(hashlib.blake2b(seed.encode(), digest_size=8).digest(), "big")
        n = len(self.servers)
        start = h % n
        return [(start + i) % n for i in range(n)]

    def _usable(self, i: int, now: float) -> bool:
        with self._lock:
            st = self._state[i]
            return not st.dead and st.open_until <= now

    def _record_failure(self, i: int, why: str) -> None:
        self.metrics.bump("router_replica_failures")
        with self._lock:
            st = self._state[i]
            st.failures += 1
            opened = st.failures >= self._failure_threshold
            if opened:
                st.failures = 0
                st.open_until = time.monotonic() + self._cooldown_s
        if opened:
            self.metrics.bump("router_breaker_opens")
            logger.warning("router breaker OPEN on replica %d for %.1fs (%s)", i,
                           self._cooldown_s, why)

    def _record_success(self, i: int) -> None:
        with self._lock:
            self._state[i].failures = 0

    def _candidates(self, graph: str, sources) -> list[int]:
        now = time.monotonic()
        ring = self._ring(graph, sources)
        candidates = [i for i in ring if self._usable(i, now)]
        if not candidates:
            # Last resort: a breaker-open replica beats a certain reject (a
            # dead one does not).
            live = set(self.alive())
            candidates = [i for i in ring if i in live]
        if not candidates:
            self.metrics.bump("router_rejected")
            raise NoReplicaAvailable("every replica is dead")
        return candidates

    def submit(self, graph: str, sources, *, mode: str = "single", engine: str | None = None,
               timeout_s: float | None = None) -> Future:
        """Route one query, failing over down the ring: a Future with the
        winning replica's reply.  Raises :class:`NoReplicaAvailable` when
        every replica is unusable or rejected; a malformed request
        (ValueError/KeyError) raises from the primary without failover."""
        self.metrics.bump("router_submits")
        candidates = self._candidates(graph, sources)
        outer: Future = Future()
        kw = dict(mode=mode, engine=engine, timeout_s=timeout_s)
        self._failover_chain(outer, candidates, lambda srv: srv.submit(graph, sources, **kw))
        return outer

    def _failover_chain(self, outer: Future, candidates: list[int], call) -> None:
        """``call(replica)`` down the candidate ring: a replica that rejects
        at admission, or whose future completes with a ServeError (closed
        mid-query, an open circuit with no degraded path), fails over to the
        next.  QueryTimeout propagates unretried."""
        i = candidates[0]
        rest = candidates[1:]
        try:
            inner = call(self.servers[i])
        except QueryTimeout:
            raise  # the caller's budget, not a replica fault
        except ServeError as exc:
            self._record_failure(i, repr(exc))
            if rest:
                self.metrics.bump("router_failovers")
                self._failover_chain(outer, rest, call)
                return
            self.metrics.bump("router_rejected")
            outer.set_exception(NoReplicaAvailable(f"all replicas rejected: {exc!r}"))
            return

        def _done(f: Future):
            exc = f.exception()
            if exc is None:
                self._record_success(i)
                outer.set_result(f.result())
                return
            if isinstance(exc, ServeError) and not isinstance(exc, QueryTimeout):
                self._record_failure(i, repr(exc))
                if rest:
                    self.metrics.bump("router_failovers")
                    try:
                        self._failover_chain(outer, rest, call)
                    except BaseException as retry_exc:
                        # A raise in a done-callback would be swallowed and
                        # leave ``outer`` unresolved.
                        outer.set_exception(retry_exc)
                    return
            outer.set_exception(exc)

        inner.add_done_callback(_done)

    # ------------------------------------------------------- query sugar --
    def query(self, graph: str, source: int, **kw) -> Future:
        return self.submit(graph, [int(source)], mode="single", **kw)

    def query_dist(self, graph: str, u: int, v: int, **kw) -> Future:
        """A point query through the routed replica's label tier (hashed on
        the (u, v) pair), with the failover of :meth:`submit`."""
        self.metrics.bump("router_point_queries")
        candidates = self._candidates(graph, [u, v])
        outer: Future = Future()
        self._failover_chain(outer, candidates, lambda srv: srv.query_dist(graph, u, v, **kw))
        return outer

    # -------------------------------------------------------------- report --
    def report(self) -> dict:
        now = time.monotonic()
        with self._lock:
            states = [{"dead": st.dead, "breaker_open": st.open_until > now,
                       "consecutive_failures": st.failures} for st in self._state]
        return {
            "router": {
                **self.metrics.report()["counters"],
                "replicas": states,
                "failure_threshold": self._failure_threshold,
                "cooldown_s": self._cooldown_s,
            },
            "replicas": [srv.report() for srv in self.servers],
        }
