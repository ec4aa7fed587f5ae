"""Executable cache and batch runners: the port of ``bfs_tpu.serve.executor``.

Steady-state serving must never rebuild what a tick runs.  The cache is
keyed ``(graph, epoch, engine, bucket, direction key)``: the server pads
every tick's sources to a power-of-two bucket (:func:`bucket_for`), so a
handful of shapes cover any traffic mix and after warm-up every tick is a
hit.  The epoch makes a hot graph swap safe: a runner built for one
snapshot never serves another.

**What an executable is in the port.**  The reference's is an AOT-compiled
program that takes the device operands as arguments, so it survives an
eviction and re-upload of its graph.  The port's is a :class:`BatchRunner`:
the engine's batched level loop for one bucket, whose blocks are captured
into a CUDA graph at their first use and replayed after
(:mod:`bfs_tpu_torch.models.loop`).  A captured graph binds the addresses
of the engine's own tensors, its layout and its loop's carry, so it must
not outlive them.  Residency is therefore the engine
(:class:`~bfs_tpu_torch.serve.registry.GraphRegistry` evicts it whole: its
tensors and its captured loops), and a runner holds no engine: it acquires
it from the registry on every call, so after an eviction the next call
ships the layout again and captures anew.  A miss builds the runner (the
engine acquired, its layout shipped); its first call runs the bucket's
first eager superstep and captures the block loop, in the same guarded
call; a hit replays the captured graph.

**Attempts.**  The server's watchdog abandons a wedged attempt's thread
(:func:`~bfs_tpu_torch.serve.health.run_with_deadline`); the thread cannot
be killed, and every run of an engine shares its loop's carry.  Each
attempt therefore draws a ticket from its runner (:meth:`BatchRunner.begin`)
before the ``serve.batch`` fault point, and the runner checks the ticket
when it takes the card and before every block its loops issue
(:func:`bfs_tpu_torch.models.loop.attempt`): once a later attempt on the
same runner has begun, an abandoned one launches nothing more and writes
no buffer (:class:`AbandonedAttempt`, counted as ``abandoned_attempts``).

**One thread on the card at a time.**  All of the server's device work (a
runner's call, an engine's upload and release, the sampled integrity
check) runs under :data:`DEVICE_LOCK`.  A CUDA graph capture forbids other
threads' CUDA calls for its whole length, and the loop's launch counts and
buffers are shared, so the card is held by one attempt at a time; the
host-side work of the server (admission, the result cache, fan-out) never
touches the card.  Host copies of a batch's rows are made inside the lock
(:func:`host_rows`), so no page-locked buffer of a tick outlives its
attempt: each reply owns exactly its own rows.

**The packed-cap latch.**  Pull and push run the packed carry while parent
ids fit it; a batch deeper than its 62-level cap comes back truncated and
is run again unpacked.  The first such tick latches the runner
(``use_packed`` False, as the reference's executor latches its
executable), so every later tick of that ``(graph epoch, bucket)`` runs
the unpacked loop once instead of both.  A graph under the cap never
leaves the packed carry.

**Checkpointed batches.**  With ``BFS_TPU_TORCH_CKPT`` on, pull and push
buckets get a :class:`SegmentedBatchRunner`: the batch runs in bounded
segments, each on the card's lock, with the carry copied to host memory at
every boundary, where the lock is given back, so a hung attempt's retry
resumes from the newest snapshot instead of from the roots.
"""

from __future__ import annotations

import time
import traceback
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np

from ..analysis.runtime import bump_retrace, guarded_region
from ..models import loop as L
from ..models.multisource import MultiBfsResult
from ..utils.locks import make_lock

#: Held by every piece of the server's device work (see the module text).
DEVICE_LOCK = make_lock("serve.device", "rlock")


class ExecutableCache:
    """LRU of batch runners keyed ``(graph, epoch, engine, bucket,
    direction key)``.

    ``get`` returns the cached runner (a hit) or calls ``build`` and records
    a miss.  Hit and miss totals feed the serve report's
    ``compile_hit_rate`` (the reference's name: a miss is a build)."""

    def __init__(self, capacity: int = 64, metrics=None):
        self.capacity = capacity
        self.metrics = metrics  # ServeMetrics is internally locked
        self._lock = make_lock("executor._lock")
        self._cache: OrderedDict[tuple, object] = OrderedDict()  # guarded-by: _lock
        self.hits = 0  # guarded-by: _lock
        self.misses = 0  # guarded-by: _lock

    def get(self, key: tuple, build):
        with self._lock:
            runner = self._cache.get(key)
            if runner is not None:
                self._cache.move_to_end(key)
                self.hits += 1
                if self.metrics is not None:
                    self.metrics.bump("compile_hits")
                return runner, True
        # Built outside the cache-wide lock: a build ships a layout, and
        # readers of the cache must not stall behind it.  The serve loop is
        # one thread, so duplicate builds need servers sharing a cache.
        # Counted as the reference counts a retrace, under the key's engine
        # and bucket.
        bump_retrace(f"serve.executable/{key[2]}/{key[3]}" if len(key) > 3 else
                     f"serve.executable/{key!r}")
        runner = build()
        with self._lock:
            runner = self._cache.setdefault(key, runner)
            self._cache.move_to_end(key)
            self.misses += 1
            if self.metrics is not None:
                self.metrics.bump("compile_misses")
            while len(self._cache) > self.capacity:
                self._cache.popitem(last=False)
        return runner, False

    def put(self, key: tuple, runner) -> None:
        """Install a runner directly (no miss counted): the seam tests use
        to serve an instrumented runner through the real batch path."""
        with self._lock:
            self._cache[key] = runner
            self._cache.move_to_end(key)
            while len(self._cache) > self.capacity:
                self._cache.popitem(last=False)

    def drop_graph(self, name: str) -> None:
        """Drop every cached runner for ``name`` across all epochs."""
        with self._lock:
            for key in [k for k in self._cache if k[0] == name]:
                del self._cache[key]

    def drop_key(self, key: tuple) -> None:
        """Drop one runner: the quarantine path, so the half-open canary
        rebuilds it."""
        with self._lock:
            self._cache.pop(key, None)

    def __contains__(self, key: tuple) -> bool:
        """Presence without touching LRU order or the counters."""
        with self._lock:
            return key in self._cache

    def peek(self, key: tuple):
        """The cached runner (or None) without LRU or counter side effects."""
        with self._lock:
            return self._cache.get(key)

    def __len__(self) -> int:
        with self._lock:
            return len(self._cache)


def bucket_for(n: int) -> int:
    """The power-of-two bucket a tick of ``n`` sources is padded to: at
    most log2(max_batch) + 1 shapes whatever the traffic."""
    n = int(n)
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


@dataclass
class HostRows:
    """A tick's answer on the host: for each real source (padding rows are
    gone) its ``dist`` and ``parent`` row, int32[V], each an array that
    owns its memory, so a reply that keeps a row keeps nothing else of the
    tick alive."""

    sources: np.ndarray
    dist: list
    parent: list
    num_levels: int


def host_rows(result, n: int) -> HostRows:
    """The first ``n`` rows of a batch result as :class:`HostRows`, each
    row copied out of the result's arrays (which on a card are views of
    page-locked buffers, freed once the result is dropped)."""
    if isinstance(result, HostRows):
        return result
    return HostRows(
        sources=np.array(result.sources[:n], dtype=np.int32),
        dist=[np.array(result.dist[i]) for i in range(n)],
        parent=[np.array(result.parent[i]) for i in range(n)],
        num_levels=int(result.num_levels),
    )


class AbandonedAttempt(RuntimeError):
    """A later attempt on the same runner has begun: this one stops before
    it launches anything more."""


class BatchRunner:
    """The batched search of one ``(graph epoch, engine, bucket)``: pull
    and push through ``EdgeEngine.run_multi``, relay through
    ``RelayEngine.run_multi_elem`` when the bucket is a multiple of 32 (32
    trees per uint32 element) and ``run_multi`` below that.

    A call maps a padded int32[bucket] source array to the engine's
    :class:`~bfs_tpu_torch.models.multisource.MultiBfsResult`, or, given
    ``take``, to ``take(result)`` computed before the card is released.
    ``last_run`` holds the last call's host seconds: ``call_s`` (the
    engine's call), the engine's own ``loop_s``/``result_s`` where it
    reports them, and ``take_s``.  ``use_packed`` is the packed-cap latch
    (the module text)."""

    def __init__(self, registry, rec, engine: str, batch: int, metrics=None):
        self.registry = registry
        self.rec = rec
        self.engine = engine
        self.batch = int(batch)
        self.metrics = metrics
        self._lock = make_lock("executor.BatchRunner._lock")
        self._gen = 0  # guarded-by: _lock (the newest attempt's ticket)
        # Replaced whole, under DEVICE_LOCK, by the attempt that ran; read by
        # that attempt's thread after its call.
        self.last_run: dict = {}  # bfs_tpu_torch: ok LCK002
        #: False once a tick's packed run came back cut by the cap.
        self.use_packed = True

    def begin(self) -> int:
        """A ticket for a new attempt; every older ticket is abandoned."""
        with self._lock:
            self._gen += 1
            return self._gen

    def _current(self, ticket: int) -> None:
        with self._lock:
            current = self._gen == ticket
        if not current:
            if self.metrics is not None:
                self.metrics.bump("abandoned_attempts")
            raise AbandonedAttempt(
                f"{self.rec.name}/{self.engine}/{self.batch}: attempt {ticket} "
                "was superseded by a later one")

    def _run(self, eng, sources: np.ndarray) -> MultiBfsResult:
        if self.engine == "relay":
            if sources.shape[0] % 32 == 0:
                # Element-major, 32 trees per uint32 element; past 31
                # levels it falls back to run_multi by itself.
                return eng.run_multi_elem(sources)
            return eng.run_multi(sources)
        result = eng.run_multi(sources, packed=None if self.use_packed else False)
        if eng.last_run.get("unpacked_rerun"):
            self.use_packed = False  # the latch: deeper than the packed cap
        return result

    def __call__(self, sources, *, ticket: int | None = None, take=None):
        sources = np.ascontiguousarray(sources, dtype=np.int32)
        if ticket is None:
            ticket = self.begin()
        eng = result = None
        with DEVICE_LOCK:
            try:
                self._current(ticket)
                # Re-acquired per call: an eviction may have dropped the
                # engine, and its successor is a new engine (new buffers,
                # loops captured anew).  Epoch-pinned: a hot swap between
                # ticks never hands this runner the new graph.
                eng = self.registry.acquire_for(self.rec, self.engine)
                eng.last_run = {}
                t0 = time.perf_counter()
                # The device batch: an implicit host sync in here is a guard
                # violation (BFS_TPU_TORCH_TRANSFER_GUARD); the loop's control
                # reads and the result's copy are explicit transfers.
                # bfs_tpu_torch: hot-start
                with L.attempt(lambda: self._current(ticket)), guarded_region(
                        f"serve.device_batch/{self.rec.name}/{self.engine}"):
                    result = self._run(eng, sources)
                # bfs_tpu_torch: hot-end
                stats = {"call_s": time.perf_counter() - t0, **eng.last_run}
                self._current(ticket)
                t1 = time.perf_counter()
                out = result if take is None else take(result)
                stats["take_s"] = time.perf_counter() - t1
                self.last_run = stats
                return out
            except BaseException as exc:
                # The frames below keep the engine and the tick's buffers:
                # release them here, on the card's lock, not wherever the
                # exception is finally dropped.
                traceback.clear_frames(exc.__traceback__)
                raise
            finally:
                eng = result = None


class SegmentedBatchRunner(BatchRunner):
    """The resumable batch runner of pull and push under
    ``BFS_TPU_TORCH_CKPT``: the batch runs as bounded segments of
    ``interval`` supersteps (:meth:`~bfs_tpu_torch.models.bfs.EdgeEngine.segment`
    on the engine's captured loop), and after each segment the whole carry
    is copied to host arrays held in memory: the runner's progress.  A hung
    attempt (the watchdog's ``HungCallError``) abandons only its thread, so
    the next attempt on the same padded sources (the server's hung-call
    resume loop, which reads :meth:`ckpt_progress`, or the breaker's
    canary) resumes from that snapshot instead of from the roots
    (``ckpt_resumes``; ``ckpt_segments`` counts segments).  Replies equal
    the fused runner's bit for bit.

    Each segment takes :data:`DEVICE_LOCK` on its own and gives it back at
    the boundary: the snapshot replaces the progress, and the
    ``serve.segment`` fault point (a wedged boundary in the chaos drills)
    fires, with the card free for the next attempt.  Before its snapshot
    replaces the progress, an attempt checks its ticket: a superseded one
    raises :class:`AbandonedAttempt` there and leaves the progress to the
    live attempt.  A segment after an eviction copies the carry into the
    new engine's loop."""

    resumable = True

    def __init__(self, registry, rec, engine: str, batch: int, interval: int, metrics=None):
        super().__init__(registry, rec, engine, batch, metrics=metrics)
        self.interval = max(1, int(interval))
        #: ``(sources key, packed flavor, host snapshot, level)`` of the
        #: newest segment.
        self._progress = None  # guarded-by: _lock

    def ckpt_progress(self):
        """The level of the resumable snapshot, or None: what the server's
        hung-call loop checks to decide whether another attempt would make
        progress."""
        with self._lock:
            return None if self._progress is None else self._progress[3]

    def _bump(self, counter: str) -> None:
        if self.metrics is not None:
            self.metrics.bump(counter)

    def _segment(self, ticket: int, sources, packed: bool, state, restore, seg_end: int):
        """One segment on the card's lock: ``(state, snapshot, LoopStats)``,
        the carry started from ``restore`` (host arrays) or fresh when there
        is no ``state`` yet."""
        from ..models.multisource import multi_segment_init, multi_snapshot

        eng = None
        with DEVICE_LOCK:
            try:
                self._current(ticket)
                eng = self.registry.acquire_for(self.rec, self.engine)
                # bfs_tpu_torch: hot-start
                with L.attempt(lambda: self._current(ticket)), guarded_region(
                        f"serve.device_batch/{self.rec.name}/{self.engine}-segmented"):
                    if state is None:
                        state = multi_segment_init(eng, sources, packed, restore=restore)
                    state, stats = eng.segment(state, seg_end)
                # bfs_tpu_torch: hot-end
                return state, multi_snapshot(state, packed), stats
            except BaseException as exc:
                traceback.clear_frames(exc.__traceback__)
                raise
            finally:
                eng = None

    def _run_flavor(self, sources, key: bytes, ticket: int, packed: bool):
        """The batch in one carry flavor, from the progress when it is this
        batch's: ``(state, restored snapshot | None, host level, host
        changed, LoopStats | None)``; ``state`` is None when the progress
        was already at the end."""
        from ..ops.packed import packed_cap
        from ..resilience.faults import fault_point

        v = self.rec.num_vertices
        cap = packed_cap(v) if packed else v
        with self._lock:
            progress = self._progress
        restore = None
        if progress is not None and progress[0] == key and progress[1] == packed:
            restore = progress[2]
            self._bump("ckpt_resumes")
        level = int(restore["level"]) if restore is not None else 0
        changed = bool(restore["changed"]) if restore is not None else True
        state = stats = None
        while changed and level < cap:
            state, snap, seg = self._segment(ticket, sources, packed, state, restore,
                                             min(level + self.interval, cap))
            stats = seg if stats is None else stats.add(seg)
            level, changed = seg.level, seg.changed
            with self._lock:
                current = self._gen == ticket
                if current:
                    self._progress = (key, packed, snap, level)
            if not current:
                self._current(ticket)  # raises, counted
            self._bump("ckpt_segments")
            if changed and level < cap:
                # The boundary the hung-call drills wedge (a delay here is a
                # dispatch stuck mid-traversal); the card is free.
                fault_point("serve.segment")
        return state, restore, level, changed, stats

    def __call__(self, sources, *, ticket: int | None = None, take=None):
        from ..models.bfs import to_host
        from ..models.multisource import multi_segment_finish, multi_segment_init
        from ..ops.packed import packed_parent_fits, packed_truncated

        sources = np.ascontiguousarray(sources, dtype=np.int32)
        if ticket is None:
            ticket = self.begin()
        key = sources.tobytes()
        v = self.rec.num_vertices
        packed = self.use_packed and packed_parent_fits(v)
        t0 = time.perf_counter()
        state, restore, level, changed, stats = self._run_flavor(sources, key, ticket, packed)
        if packed and packed_truncated(changed, level, v):
            # Deeper than the packed cap: run again unpacked (the packed
            # progress cannot feed it), and latch.
            with self._lock:
                if self._gen == ticket:
                    self._progress = None
            packed = self.use_packed = False
            state, restore, level, changed, more = self._run_flavor(sources, key, ticket, False)
            stats = more if stats is None or more is None else stats.add(more)
        call_s = time.perf_counter() - t0
        eng = result = None
        with DEVICE_LOCK:
            try:
                self._current(ticket)
                if state is None:  # the progress was the end of the run
                    eng = self.registry.acquire_for(self.rec, self.engine)
                    state = multi_segment_init(eng, sources, packed, restore=restore)
                st = multi_segment_finish(state, packed)
                dist, parent = to_host(st.dist[:, :v].contiguous(), st.parent[:, :v].contiguous())
                result = MultiBfsResult(sources, dist, parent, level)
                with self._lock:
                    if self._gen == ticket:
                        self._progress = None  # finished: the snapshot is dead weight
                t1 = time.perf_counter()
                out = result if take is None else take(result)
                self.last_run = {"call_s": call_s, "result_s": t1 - t0 - call_s,
                                 "take_s": time.perf_counter() - t1,
                                 **(vars(stats) if stats is not None else {})}
                return out
            except BaseException as exc:
                traceback.clear_frames(exc.__traceback__)
                raise
            finally:
                eng = result = state = st = None


def build_batch_runner(registry, name: str, engine: str, batch: int,
                       epoch: int | None = None) -> BatchRunner:
    """The runner of one ``(graph epoch, engine, bucket)``: the engine is
    acquired now (its layout shipped if it is not resident), and the
    runner pins the epoch (default: the current one), so a runner built
    before a hot swap keeps running its own graph.  With
    ``BFS_TPU_TORCH_CKPT`` on, pull and push get a
    :class:`SegmentedBatchRunner` (interval ``k``); off (the default), the
    fused :class:`BatchRunner`."""
    from ..resilience.superstep_ckpt import resolve_ckpt
    from .registry import ENGINES

    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; use one of {ENGINES}")
    rec = registry.get(name) if epoch is None else registry.get_epoch(name, epoch)
    with DEVICE_LOCK:
        registry.acquire_for(rec, engine)
    ckpt = resolve_ckpt()
    if ckpt.enabled and engine in ("pull", "push"):
        return SegmentedBatchRunner(registry, rec, engine, batch, interval=ckpt.k,
                                    metrics=registry.metrics)
    return BatchRunner(registry, rec, engine, batch, metrics=registry.metrics)


def run_oracle_batch(graph, sources: np.ndarray) -> MultiBfsResult:
    """The sequential degradation path: per-source canonical BFS on the
    host (:func:`~bfs_tpu_torch.oracle.bfs.canonical_bfs`, min-parent
    tie-break), bit-exact with the engines."""
    from ..oracle.bfs import canonical_bfs

    dist_rows, parent_rows = [], []
    for s in np.asarray(sources).tolist():
        d, p = canonical_bfs(graph, int(s))
        dist_rows.append(d)
        parent_rows.append(p)
    dist = np.stack(dist_rows)
    return MultiBfsResult(
        sources=np.asarray(sources, dtype=np.int32),
        dist=dist,
        parent=np.stack(parent_rows),
        num_levels=int(dist[dist != np.iinfo(np.int32).max].max(initial=0)) + 1,
    )
