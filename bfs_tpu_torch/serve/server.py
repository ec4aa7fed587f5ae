"""Micro-batching BFS query server: coalesce, execute once, fan out.  The
port of ``bfs_tpu.serve.server`` on one card.

One batched search over S sources costs barely more than one source, so a
stream of independent queries is served by admitting them into a bounded
queue, coalescing up to ``max_batch`` sources per tick into ONE call of the
batched engine, and fanning the rows back out per request.  The loop is a
single daemon thread; every device call runs on a watchdog thread under the
card's lock (:mod:`~bfs_tpu_torch.serve.executor`), one at a time.

Robustness semantics, as the reference's:

  * **backpressure** — a full admission queue raises :class:`AdmissionError`
    at submit time instead of queueing unboundedly;
  * **deadlines** — a request whose deadline expires before its batch is
    formed completes with :class:`QueryTimeout`; an expired-in-flight
    request still gets its (correct) answer;
  * **cancellation** — ``future.cancel()`` before batch formation works;
  * **retry** — a TRANSIENT device-path failure
    (:mod:`bfs_tpu_torch.resilience.retry`; never a CUDA error, which is
    sticky) is retried with capped exponential backoff and jitter, bounded
    by the batch's earliest request deadline; a permanent failure skips the
    retries;
  * **degradation** — graphs at or under ``oracle_max_vertices`` vertices,
    and any batch whose device path fails permanently (or exhausts its
    retries, or whose circuit is open), are served by the sequential oracle
    (canonical min-parent, bit-exact with the engines) when the host graph
    is available, and counted (``oracle_served``, ``device_errors``,
    ``breaker_short_circuits``, ``watchdog_timeouts``).

Every reply carries a :class:`~bfs_tpu_torch.utils.metrics.QueryRecord`;
:class:`~bfs_tpu_torch.utils.metrics.ServeMetrics` aggregates them.  A
reply's ``dist``/``parent`` own their memory: a kept reply (the result
LRU) keeps its own rows alive and nothing else of its tick.
:meth:`BfsServer.tick_log` lists the last ticks: bucket, real sources,
service and result seconds, and the host bytes their replies hold.

``BfsServer(device=...)`` runs on the card unless ``"cpu"`` (given a
registry, the registry's device); without a card and without ``"cpu"`` it
raises.

**The label tier.**  With ``BFS_TPU_TORCH_LABELS=<K>``, ``register`` also
builds (or loads from the layout store's sidecar) the landmark label index
of the new epoch (:mod:`~bfs_tpu_torch.serve.labels`), sweeping on the
registry's resident pull engine, and ``query_dist``/``query_path`` answer
tight pairs from it at once, without a traversal; other pairs take the
exact path.  The build is best-effort, as the reference's: a failure or a
budget reject is counted (``label_build_errors``, ``label_budget_rejects``)
and the server serves exact-only.  A lookup runs on the card's lock, so it
waits for a running tick.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np

from .. import knobs
from ..graph.csr import INF_DIST
from ..models.bfs import check_sources, resolve_device
from ..models.multisource import MultiBfsResult, collapse_multi_source
from ..obs.spans import span as obs_span
from ..resilience.faults import fault_point
from ..resilience.retry import RetryPolicy, retry_call
from ..utils.locks import make_lock
from ..utils.metrics import QueryRecord, ServeMetrics
from .executor import (
    DEVICE_LOCK,
    BatchRunner,
    ExecutableCache,
    bucket_for,
    build_batch_runner,
    host_rows,
    run_oracle_batch,
)
from .health import HungCallError, ServeHealth
from .registry import ENGINES, GraphRegistry

logger = logging.getLogger(__name__)

#: Default device-path retry shape: short delays (a serving tick is
#: latency-bound) and few attempts.
DEFAULT_RETRY_POLICY = RetryPolicy(max_attempts=3, base_delay_s=0.02, max_delay_s=0.5)

#: Ticks kept by :meth:`BfsServer.tick_log`.
TICK_LOG = 1024


class ServeError(RuntimeError):
    """Base class for serving-layer failures."""


class AdmissionError(ServeError):
    """The bounded admission queue is full — retry later (backpressure)."""


class QueryTimeout(ServeError):
    """The request's deadline expired before its batch was formed."""


class ServerClosed(ServeError):
    """The server was shut down before the request could be served."""


class CircuitOpenError(ServeError):
    """The executable's circuit is open and no degraded path exists (the
    graph was registered layout-only, so there is no host oracle)."""


@dataclass
class ServeReply:
    """One served query.  ``dist``/``parent`` are int32[V] for single-source
    and collapsed multi-source queries, int32[S, V] for ``mode='tree'``."""

    graph: str
    engine: str
    mode: str
    sources: np.ndarray
    dist: np.ndarray
    parent: np.ndarray
    num_levels: int
    record: QueryRecord


def _parent_chain(parent: np.ndarray, u: int, v: int) -> list | None:
    """Path ``[u, ..., v]`` from a single-source parent tree rooted at
    ``u`` (v's parent pointers walked back to the root)."""
    chain = [int(v)]
    cur = int(v)
    limit = int(parent.shape[-1])
    while cur != u:
        cur = int(parent[cur])
        if cur < 0 or len(chain) > limit:
            return None
        chain.append(cur)
    return chain[::-1]


@dataclass
class DistReply:
    """One point-distance query (``query_dist``).  ``method`` is the tier
    that answered: ``'labels'`` (a tight certificate, provably exact),
    ``'exact'`` (the traversal), or ``'labels_verified'`` (a sampled tight
    answer also checked against the traversal before shipping).
    ``landmark`` is the certifying landmark of a ``'labels'`` answer."""

    graph: str
    u: int
    v: int
    dist: int
    method: str
    landmark: int | None = None
    path: list | None = None


@dataclass
class _Request:
    graph: str
    engine: str
    mode: str  # 'single' | 'tree' | 'collapse'
    sources: np.ndarray
    future: Future
    submitted_at: float
    deadline: float | None
    oracle: bool  # tiny-graph degradation decided at admission
    rec: object = None  # pinned RegisteredGraph snapshot (epoch at admission)
    pinned: bool = False  # pin outstanding; released once via _unpin
    cache_key: tuple | None = None
    record: QueryRecord = field(default_factory=QueryRecord)


class BfsServer:
    """In-process BFS query server over a :class:`GraphRegistry`.

    ``tick_s`` is the coalescing window: after the first request of a tick
    arrives the batcher waits up to ``tick_s`` for more before executing
    (0 = greedy drain of whatever is already queued).  Without a
    ``registry`` the server makes one on ``device``.
    """

    def __init__(
        self,
        registry: GraphRegistry | None = None,
        *,
        device=None,
        engine: str = "pull",
        max_batch: int = 32,
        tick_s: float = 0.0,
        queue_depth: int = 256,
        result_cache_size: int = 256,
        exe_cache_size: int = 64,
        oracle_max_vertices: int = 0,
        metrics: ServeMetrics | None = None,
        retry_policy: RetryPolicy | None = None,
        breaker_failures: int = 3,
        breaker_cooldown_s: float = 5.0,
        watchdog_s: float = 60.0,
        watchdog_multiplier: float = 8.0,
        watchdog_min_s: float = 1.0,
        watchdog_compile_floor_s: float = 1200.0,
        verify_sample: int = 0,
    ):
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}; use one of {ENGINES}")
        self.metrics = metrics if metrics is not None else ServeMetrics()
        if registry is None:
            registry = GraphRegistry(metrics=self.metrics, device=device)
        elif device is not None and resolve_device(device) != registry.device:
            raise ValueError(f"device {device!r} differs from the registry's {registry.device}")
        self.registry = registry
        self.device = registry.device
        self.registry.attach_metrics(self.metrics)
        self.default_engine = engine
        self.max_batch = int(max_batch)
        self.tick_s = float(tick_s)
        self.queue_depth = int(queue_depth)
        self.oracle_max_vertices = int(oracle_max_vertices)
        self.retry_policy = retry_policy if retry_policy is not None else DEFAULT_RETRY_POLICY
        self.exe_cache = ExecutableCache(exe_cache_size, metrics=self.metrics)
        # Circuit breaker per executable, hung-call watchdog, sampled
        # integrity checks: one gate for the device path.
        self._health = ServeHealth(
            metrics=self.metrics,
            breaker_failures=breaker_failures,
            breaker_cooldown_s=breaker_cooldown_s,
            watchdog_s=watchdog_s,
            watchdog_multiplier=watchdog_multiplier,
            watchdog_min_s=watchdog_min_s,
            compile_floor_s=watchdog_compile_floor_s,
            verify_sample=verify_sample,
            device=self.device,
        )
        # Per-epoch health state dies with the epoch; close() detaches.
        self.registry.add_retire_listener(self._health.forget_epoch)
        # The label tier: one LabelOracle per (name, epoch) built at
        # register(); the retire listener drops an epoch's oracle with its
        # device state, so a swap never serves stale labels.  Dropped
        # oracles hold device rows, freed on the card's lock (_bury_labels).
        self._labels: dict[tuple, object] = {}  # guarded-by: _lock
        self._label_tick = 0  # guarded-by: _lock (verify sampling)
        self._label_graveyard: list = []  # guarded-by: _lock
        self.registry.add_retire_listener(self._drop_label_epoch)
        # Direction policy resolved ONCE: a malformed knob fails
        # construction loudly instead of degrading every tick.
        from ..models.direction import resolve_direction

        self._direction_key = resolve_direction().key()
        self._lock = make_lock("server._lock")
        self._cond = threading.Condition(self._lock)  # holding _cond == holding _lock
        self._result_cache: OrderedDict[tuple, tuple] = OrderedDict()  # guarded-by: _lock
        self._result_cache_size = int(result_cache_size)
        self._pending: deque[_Request] = deque()  # guarded-by: _lock
        self._paused = False  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock
        self._ticks: deque[dict] = deque(maxlen=TICK_LOG)  # guarded-by: _lock
        self._thread = threading.Thread(target=self._serve_loop, name="bfs-serve", daemon=True)
        self._thread.start()

    # ----------------------------------------------------------- lifecycle --
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout=30)
        with self._cond:
            drained = list(self._pending)
            self._pending.clear()
        for req in drained:
            if req.future.set_running_or_notify_cancel():
                req.future.set_exception(ServerClosed("server closed"))
            self._unpin(req)
        self.registry.remove_retire_listener(self._health.forget_epoch)
        self.registry.remove_retire_listener(self._drop_label_epoch)
        with self._lock:
            self._label_graveyard += self._labels.values()
            self._labels.clear()
        self._bury_labels(wait=True)

    def pause(self) -> None:
        """Hold batch formation (admission continues)."""
        with self._cond:
            self._paused = True

    def resume(self) -> None:
        with self._cond:
            self._paused = False
            self._cond.notify_all()

    # ----------------------------------------------------------- admission --
    def register(self, name: str, graph, **kw):
        """Register — or HOT-SWAP — a graph (:meth:`GraphRegistry.register`):
        queries admitted after this call see the new graph, in-flight ones
        finish on the snapshot they were admitted under.  Executable and
        result caches need no purge: their keys carry the epoch.  With
        ``BFS_TPU_TORCH_LABELS=<K>`` and a host graph, the new epoch's label
        index is built or loaded here too; the old one dies with its
        epoch."""
        rec = self.registry.register(name, graph, **kw)
        self._maybe_build_labels(rec)
        return rec

    def unregister(self, name: str) -> None:
        """Drop a graph AND every cache derived from it (runners and cached
        results are keyed by name)."""
        self.registry.unregister(name)
        self.exe_cache.drop_graph(name)
        with self._lock:
            for key in [k for k in self._result_cache if k[0] == name]:
                del self._result_cache[key]
            for key in [k for k in self._labels if k[0] == name]:
                self._label_graveyard.append(self._labels.pop(key))
        self._bury_labels()

    def query(self, graph: str, source: int, **kw) -> Future:
        """Single-source shortest-path query; reply rows are 1-D."""
        return self.submit(graph, [int(source)], mode="single", **kw)

    def query_multi(self, graph: str, sources, *, collapse: bool = True, **kw) -> Future:
        """Multi-source query: ``collapse=True`` serves the oracle's
        multi-source semantics (``dist[v] = min_s dist_s[v]``), else
        independent per-source trees (``mode='tree'``)."""
        return self.submit(graph, sources, mode="collapse" if collapse else "tree", **kw)

    # ------------------------------------------------------- label tier --
    def _drop_label_epoch(self, name: str, epoch: int) -> None:
        # A retire listener: it fires under the registry's lock, so it
        # touches only this server's state and never calls the registry.
        with self._lock:
            oracle = self._labels.pop((name, epoch), None)
            if oracle is not None:
                self._label_graveyard.append(oracle)
        self._bury_labels()

    def _bury_labels(self, wait: bool = False) -> None:
        """Free dropped oracles' device rows on the card's lock: now when it
        is free (or ``wait``), else at a later call."""
        if not DEVICE_LOCK.acquire(blocking=wait):
            return
        try:
            with self._lock:
                dead, self._label_graveyard = self._label_graveyard, []
            del dead
        finally:
            DEVICE_LOCK.release()

    def _label_oracle(self, name: str, epoch: int):
        with self._lock:
            return self._labels.get((name, epoch))

    def _label_sweep(self, rec):
        """The label build's sweep on the registry's resident pull engine of
        ``rec`` (no second layout beside the one the ticks use); called on
        the card's lock."""
        def sweep(roots):
            return self.registry.acquire_for(rec, "pull").run_multi(roots)

        return sweep

    def _maybe_build_labels(self, rec) -> None:
        """Build or load the label index of a freshly registered epoch.
        Best-effort, as the reference's: a failed build or a budget reject
        logs, bumps a counter, and the server serves exact-only."""
        k = knobs.get("BFS_TPU_TORCH_LABELS")
        if not k:
            return
        if rec.graph is None:
            self.metrics.bump("label_build_skipped")
            return
        from .labels import LabelBudgetError, build_label_oracle

        try:
            oracle, info = build_label_oracle(rec.graph, k, cache=self.registry.layout_cache,
                                              device=self.device, sweep=self._label_sweep(rec))
        except LabelBudgetError as exc:
            logger.warning("label index over budget: %s", exc)
            self.metrics.bump("label_budget_rejects")
            return
        except Exception:
            logger.warning("label index build failed; serving exact-only", exc_info=True)
            self.metrics.bump("label_build_errors")
            return
        with self._lock:
            self._labels[(rec.name, rec.epoch)] = oracle
        if rec.released:  # retired during the build: its listener already ran
            self._drop_label_epoch(rec.name, rec.epoch)
        self.metrics.bump("label_builds")
        self.metrics.bump("label_build_cache_hits" if info.get("cache") == "hit"
                          else "label_build_cache_misses")

    def query_dist(self, graph: str, u: int, v: int, *, want_path: bool = False,
                   **kw) -> Future:
        """Point query ``dist(u, v)``; a Future resolving to
        :class:`DistReply`.

        A tight label answer (provably exact by the certificate) resolves at
        once from the resident index: no traversal, no batch queue.  Other
        pairs, and graphs without labels, take the exact path (:meth:`query`
        from ``u``, every robustness property included).  Every
        ``BFS_TPU_TORCH_LABELS_VERIFY``-th tight answer is also derived on
        the exact path and compared before shipping; a mismatch quarantines
        the index (``label_verify_failures``) and the exact answer ships.
        ``want_path`` adds a shortest path (through the certifying landmark,
        or from the traversal's parent tree)."""
        u, v = int(u), int(v)
        rec = self.registry.get(graph)
        check_sources(rec.num_vertices, np.asarray([u, v], dtype=np.int32))
        oracle = self._label_oracle(graph, rec.epoch)
        if oracle is not None:
            d, tight, best_k = oracle.dist_one(u, v)
            if tight:
                self.metrics.bump("label_hits")
                path = oracle.path(u, v) if want_path else None
                verify_every = knobs.get("BFS_TPU_TORCH_LABELS_VERIFY")
                if verify_every > 0:
                    with self._lock:
                        self._label_tick += 1
                        sample = self._label_tick % verify_every == 0
                    if sample:
                        return self._verify_label_answer(graph, rec.epoch, u, v, d, path, **kw)
                fut: Future = Future()
                fut.set_result(DistReply(graph, u, v, d, "labels",
                                         landmark=int(oracle.index.landmarks[best_k]), path=path))
                return fut
            self.metrics.bump("label_fallbacks")
        else:
            self.metrics.bump("label_misses")
        return self._exact_dist(graph, u, v, want_path, **kw)

    def query_path(self, graph: str, u: int, v: int, **kw) -> Future:
        """Shortest-path point query: ``query_dist(..., want_path=True)``."""
        return self.query_dist(graph, u, v, want_path=True, **kw)

    def _exact_dist(self, graph: str, u: int, v: int, want_path: bool, **kw) -> Future:
        outer: Future = Future()
        inner = self.submit(graph, [u], mode="single", **kw)

        def _done(f: Future):
            try:
                reply = f.result()
            except BaseException as exc:
                outer.set_exception(exc)
                return
            try:
                d = int(reply.dist[v])
                path = _parent_chain(reply.parent, u, v) if want_path and d < INF_DIST else None
                outer.set_result(DistReply(graph, u, v, d, "exact", path=path))
            except BaseException as exc:  # never hang the future
                outer.set_exception(exc)

        inner.add_done_callback(_done)
        return outer

    def _verify_label_answer(self, graph: str, epoch: int, u: int, v: int, label_d: int, path,
                             **kw) -> Future:
        """The sampled cross-check: the answer derived again on the exact
        path and compared before shipping.  A mismatch drops the epoch's
        index (it can never be trusted again) and ships the exact answer."""
        outer: Future = Future()
        inner = self._exact_dist(graph, u, v, False, **kw)

        def _done(f: Future):
            try:
                exact = f.result()
            except BaseException as exc:
                outer.set_exception(exc)
                return
            if exact.dist != label_d:
                self.metrics.bump("label_verify_failures")
                logger.error("label answer mismatch on %s: dist(%d,%d) labels=%d exact=%d; "
                             "quarantining the label index", graph, u, v, label_d, exact.dist)
                self._drop_label_epoch(graph, epoch)
                outer.set_result(exact)
                return
            self.metrics.bump("label_verifies")
            outer.set_result(DistReply(graph, u, v, label_d, "labels_verified", path=path))

        inner.add_done_callback(_done)
        return outer

    def submit(self, graph: str, sources, *, mode: str = "single", engine: str | None = None,
               timeout_s: float | None = None) -> Future:
        """Admit one query; returns a :class:`concurrent.futures.Future`
        resolving to a :class:`ServeReply` (or raising
        :class:`QueryTimeout` / :class:`ServerClosed`).

        Raises :class:`AdmissionError` when the bounded queue is full, and
        ``ValueError``/``KeyError`` for malformed requests."""
        if mode not in ("single", "tree", "collapse"):
            raise ValueError(f"unknown mode {mode!r}")
        engine = engine or self.default_engine
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}; use one of {ENGINES}")
        # Pin the CURRENT epoch at admission: the snapshot the caller
        # observed, kept alive through a hot swap until the reply lands.
        rec = self.registry.pin(graph)
        req: _Request | None = None
        try:
            sources = np.atleast_1d(np.asarray(sources, dtype=np.int32))
            if sources.ndim != 1:
                raise ValueError("sources must be a scalar or 1-D sequence")
            if mode == "single" and sources.shape[0] != 1:
                raise ValueError("mode='single' takes exactly one source")
            check_sources(rec.num_vertices, sources)
            now = time.monotonic()
            future: Future = Future()
            oracle = rec.graph is not None and rec.num_vertices <= self.oracle_max_vertices
            req = _Request(
                graph=graph, engine=engine, mode=mode, sources=sources, future=future,
                submitted_at=now,
                deadline=(now + float(timeout_s)) if timeout_s is not None else None,
                oracle=oracle, rec=rec, pinned=True,
            )
            req.cache_key = (graph, rec.epoch, engine, mode, tuple(sources.tolist()))
            cached = self._result_cache_get(req.cache_key)
            if cached is not None:
                dist, parent, num_levels = cached
                self.metrics.bump("result_cache_hits")
                rec_q = QueryRecord(
                    graph=graph, engine=engine, status="result_cache", epoch=rec.epoch,
                    num_sources=int(sources.shape[0]), result_cache_hit=True,
                )
                self.metrics.record_query(rec_q, ts=time.monotonic())
                future.set_result(ServeReply(graph, engine, mode, sources, dist, parent,
                                             num_levels, rec_q))
                self._unpin(req)
                return future
            self.metrics.bump("result_cache_misses")
            with self._cond:
                if self._closed:
                    raise ServerClosed("server is closed")
                if len(self._pending) >= self.queue_depth:
                    self.metrics.bump("rejected")
                    raise AdmissionError(f"admission queue full ({self.queue_depth} pending)")
                self._pending.append(req)
                self._cond.notify_all()
        except BaseException:
            # Never queued: balance the admission pin before raising.
            if req is not None:
                self._unpin(req)
            else:
                self.registry.unpin(rec)
            raise
        return future

    def _unpin(self, req: _Request) -> None:
        """Release a request's epoch pin exactly once."""
        if req.pinned:
            req.pinned = False
            self.registry.unpin(req.rec)

    # --------------------------------------------------------- result cache --
    def _result_cache_get(self, key):
        with self._lock:
            hit = self._result_cache.get(key)
            if hit is not None:
                self._result_cache.move_to_end(key)
            return hit

    def _result_cache_put(self, key, value) -> None:
        if self._result_cache_size <= 0 or key is None:
            return
        with self._lock:
            self._result_cache[key] = value
            self._result_cache.move_to_end(key)
            while len(self._result_cache) > self._result_cache_size:
                self._result_cache.popitem(last=False)

    # ------------------------------------------------------------- batching --
    def _serve_loop(self) -> None:
        while True:
            with self._cond:
                while not self._closed and (self._paused or not self._pending):
                    self._cond.wait(timeout=0.1)
                if self._closed:
                    return
                first = self._pending.popleft()
            if self.tick_s > 0:
                # Coalescing window: concurrent submitters land in the same
                # batch before the shapes are fixed.
                time.sleep(self.tick_s)
            batch = [first]
            budget = self.max_batch - first.sources.shape[0]
            with self._cond:
                keep: deque[_Request] = deque()
                while self._pending:
                    req = self._pending.popleft()
                    compatible = (
                        req.rec is first.rec  # same graph AND epoch
                        and req.engine == first.engine
                        and req.oracle == first.oracle
                        and req.sources.shape[0] <= budget
                    )
                    if compatible:
                        batch.append(req)
                        budget -= req.sources.shape[0]
                    else:
                        keep.append(req)
                self._pending.extendleft(reversed(keep))
            try:
                with obs_span("serve.batch", graph=batch[0].graph, engine=batch[0].engine,
                              requests=len(batch)):
                    self._execute_batch(batch)
            except Exception as exc:  # the loop must survive
                for req in batch:
                    if not req.future.done():
                        req.future.set_exception(exc)
            finally:
                # Every request of a tick releases its epoch pin here,
                # whatever path it took; _unpin is idempotent.
                for req in batch:
                    self._unpin(req)

    def _execute_batch(self, batch: list[_Request]) -> None:
        formed_at = time.monotonic()
        live: list[_Request] = []
        for req in batch:
            if not req.future.set_running_or_notify_cancel():
                self.metrics.bump("cancelled")
                continue
            if req.deadline is not None and formed_at > req.deadline:
                self._finish_timeout(req, formed_at)
                continue
            live.append(req)
        if not live:
            return
        first = live[0]
        all_sources = np.concatenate([r.sources for r in live])
        n_real = int(all_sources.shape[0])
        padded = bucket_for(n_real)
        # The batch runs against the epoch its requests were ADMITTED under.
        rec = first.rec
        # One circuit per executable; the exe key adds the direction policy.
        circuit_key = (first.graph, rec.epoch, first.engine, padded)
        exe_key = (first.graph, rec.epoch, first.engine, padded, self._direction_key)
        compile_hit: bool | None = None
        status = "ok"
        device_attempted = False
        run_stats: dict = {}
        t0 = time.monotonic()

        def _oracle_tick():
            # The sequential fallback, shared by every degraded path; it runs
            # the real sources only.
            self.metrics.bump("oracle_served")
            return host_rows(run_oracle_batch(rec.graph, all_sources), n_real), "oracle", n_real

        def _take(result):
            # On the card's lock: each real row copied out of the tick's
            # page-locked block, which is freed before the lock is released.
            t = time.perf_counter()
            rows = host_rows(result, n_real)
            run_stats["own_s"] = time.perf_counter() - t
            return rows

        try:
            if first.oracle:
                result, status, padded = _oracle_tick()
            elif not self._health.allow(circuit_key):
                # Circuit open: short-circuit to the degraded path until
                # the cooldown admits a canary.
                self.metrics.bump("breaker_short_circuits")
                if rec.graph is None:
                    raise CircuitOpenError(
                        f"circuit open for {circuit_key} and graph {first.graph!r} was "
                        "registered layout-only — no host oracle to degrade to"
                    )
                result, status, padded = _oracle_tick()
            else:
                sources_padded = np.concatenate(
                    [all_sources, np.full(padded - n_real, all_sources[0], dtype=np.int32)])
                deadlines = [r.deadline for r in live if r.deadline is not None]

                def _device_tick():
                    def _guarded():
                        nonlocal compile_hit
                        runner, compile_hit = self.exe_cache.get(
                            exe_key,
                            lambda: build_batch_runner(
                                self.registry, first.graph, first.engine, padded,
                                epoch=rec.epoch,
                            ),
                        )
                        begin = getattr(runner, "begin", None)
                        ticket = begin() if begin is not None else None
                        # ``raise:serve.batch`` = a permanent device fault;
                        # ``delay:serve.batch:N`` = a wedged call the
                        # watchdog must catch.  The ticket is drawn first,
                        # so a later attempt supersedes this one.
                        fault_point("serve.batch")
                        if ticket is None:  # a plain callable (tests)
                            return _take(runner(sources_padded))
                        rows = runner(sources_padded, ticket=ticket, take=_take)
                        run_stats.update(runner.last_run)
                        return rows

                    # A cold tick (its runner is built in the call, or the
                    # runner's engine is shipped again after an eviction)
                    # is floored at the build budget.
                    runner0 = self.exe_cache.peek(exe_key)
                    cold = runner0 is None or (isinstance(runner0, BatchRunner)
                                               and not self.registry.resident(rec, first.engine))
                    return self._health.run_guarded(
                        circuit_key, _guarded, deadlines,
                        describe=f"device batch ({first.graph}/{first.engine})", cold=cold,
                    )

                retried = {"n": 0}

                def _on_retry(attempt, exc, delay):
                    retried["n"] += 1
                    self.metrics.bump("device_retries")

                device_attempted = True
                # The hung-call resume loop: another attempt only while a
                # runner's checkpointed progress advances (no port runner
                # checkpoints yet, so a hung call re-raises here).
                resume_progress = None
                while True:
                    try:
                        result = retry_call(
                            _device_tick,
                            policy=self.retry_policy,
                            deadline_s=(min(deadlines) - time.monotonic() if deadlines else None),
                            on_retry=_on_retry,
                            describe=f"device batch ({first.graph}/{first.engine})",
                        )
                        break
                    except HungCallError:
                        runner0 = self.exe_cache.peek(exe_key)
                        prog_fn = getattr(runner0, "ckpt_progress", None)
                        progress = prog_fn() if callable(prog_fn) else None
                        past_deadline = bool(deadlines) and time.monotonic() >= min(deadlines)
                        if progress is None or progress == resume_progress or past_deadline:
                            raise
                        resume_progress = progress
                        self.metrics.bump("ckpt_hung_resumes")
                if retried["n"]:
                    self.metrics.bump("device_retry_successes")
                self._health.record_success(circuit_key)
                # Sampled integrity check; a failed verdict quarantines the
                # executable (circuit force-opened, runner dropped, this
                # epoch's cached answers purged) and the batch re-runs on
                # the oracle.
                verdict = self._health.maybe_verify(rec, result, all_sources)
                if verdict is not None:
                    self._health.quarantine(circuit_key, f"integrity verdict {verdict}")
                    self.exe_cache.drop_key(exe_key)
                    with self._lock:
                        for k in [k for k in self._result_cache
                                  if k[0] == first.graph and k[1] == rec.epoch]:
                            del self._result_cache[k]
                    result, status, padded = _oracle_tick()
                    compile_hit = None
        except Exception as exc:
            if device_attempted:
                # One more consecutive strike against this executable.
                self._health.record_failure(circuit_key, repr(exc))
            if rec.graph is None:
                raise
            # Permanent failure or exhausted retries: degrade to the
            # sequential oracle EXACTLY ONCE rather than failing the tick.
            self.metrics.bump("device_errors")
            result, status, padded = _oracle_tick()
            compile_hit = None
        service_s = time.monotonic() - t0
        self.metrics.bump("batches")

        t_fan = time.perf_counter()
        kept = 0
        row = 0
        for req in live:
            s = req.sources.shape[0]
            d_rows, p_rows = result.dist[row:row + s], result.parent[row:row + s]
            row += s
            if req.mode == "collapse":
                dist, parent = collapse_multi_source(MultiBfsResult(
                    req.sources, np.stack(d_rows), np.stack(p_rows), result.num_levels))
            elif req.mode == "single":
                dist, parent = d_rows[0], p_rows[0]
            else:
                dist, parent = np.stack(d_rows), np.stack(p_rows)
            kept += dist.nbytes + parent.nbytes
            done = time.monotonic()
            req.record = QueryRecord(
                graph=req.graph, engine=req.engine, status=status, epoch=rec.epoch,
                num_sources=s, batch_size=padded, supersteps=result.num_levels,
                queue_wait_s=formed_at - req.submitted_at, service_s=service_s,
                total_s=done - req.submitted_at, compile_hit=compile_hit,
            )
            reply = ServeReply(req.graph, req.engine, req.mode, req.sources, dist, parent,
                               result.num_levels, req.record)
            self._result_cache_put(req.cache_key, (dist, parent, result.num_levels))
            self.metrics.record_query(req.record, ts=done)
            req.future.set_result(reply)
        with self._lock:
            self._ticks.append({
                "graph": first.graph, "engine": first.engine, "epoch": rec.epoch,
                "status": status, "bucket": padded, "sources": n_real,
                "requests": len(live), "compile_hit": compile_hit,
                "service_s": service_s,
                # Host seconds of the result: the engine's copy to the host
                # (where it reports one) and the rows copied out of it.
                "result_s": run_stats.get("result_s"), "own_s": run_stats.get("own_s"),
                "loop_s": run_stats.get("loop_s"), "fanout_s": time.perf_counter() - t_fan,
                "kept_bytes": kept,
                # The level loop's counts, where the engine reports them.
                "issued": run_stats.get("issued"), "replays": run_stats.get("replays"),
            })

    def _finish_timeout(self, req: _Request, now: float) -> None:
        req.record = QueryRecord(
            graph=req.graph, engine=req.engine, status="timeout",
            num_sources=int(req.sources.shape[0]),
            queue_wait_s=now - req.submitted_at, total_s=now - req.submitted_at,
        )
        self.metrics.bump("timeouts")
        self.metrics.record_query(req.record, ts=now)
        req.future.set_exception(QueryTimeout(
            f"deadline expired after {req.record.total_s * 1e3:.1f} ms in queue"))

    # -------------------------------------------------------------- reports --
    def tick_log(self) -> list[dict]:
        """The last :data:`TICK_LOG` executed ticks, oldest first."""
        with self._lock:
            return list(self._ticks)

    def report(self) -> dict:
        out = self.metrics.report()
        epochs = {}
        for n in self.registry.names():
            # A concurrent unregister shrinks the snapshot, never raises.
            try:
                epochs[n] = self.registry.epoch(n)
            except KeyError:
                continue
        out["registry"] = {
            "graphs": list(epochs),
            "epochs": epochs,
            "resident_bytes": self.registry.resident_bytes(),
            "resident": [list(k) for k in self.registry.resident_keys()],
            "evictions": self.registry.evictions,
            "evictions_deferred": self.registry.evictions_deferred,
            "budget_bytes": self.registry.device_budget_bytes,
        }
        out["executables_cached"] = len(self.exe_cache)
        with self._lock:
            out["labels"] = {f"{name}@{epoch}": oracle.report()
                             for (name, epoch), oracle in self._labels.items()}
        out["health"] = self._health.report()
        return out
