"""Self-healing serve: breaker, hung-call watchdog, integrity checks.  The
port of ``bfs_tpu.serve.health``.

:class:`ServeHealth` is the one object the server consults on the device
path, composing three defenses:

  * **circuit breaker** — one :class:`~bfs_tpu_torch.resilience.retry.CircuitBreaker`
    circuit per ``(graph, epoch, engine, bucket)`` executable.  After
    ``breaker_failures`` consecutive permanent failures the circuit opens
    and ticks short-circuit to the oracle; after ``breaker_cooldown_s`` the
    next tick is the half-open canary, closing the circuit on success.
    Every transition lands a ``ServeMetrics`` counter, a process-registry
    counter and an instant span marker.
  * **hung-call watchdog** — each device batch call runs under a deadline
    on a disposable daemon thread (:func:`run_with_deadline`).  The budget
    is p99-informed per circuit key (``multiplier × observed p99``, the
    configured default before enough history exists), tightened to the
    batch's earliest request deadline plus a grace; a wedged call raises
    :class:`HungCallError` (permanent), strikes the breaker and the tick
    degrades instead of freezing the server.  A COLD tick (its runner is
    built in the call: the engine shipped, the loop captured) is floored
    at ``compile_floor_s``.  The abandoned thread dies with the process;
    its runner makes sure it launches nothing once a later attempt has
    begun (:mod:`~bfs_tpu_torch.serve.executor`).
  * **sampled integrity checks** — every ``verify_sample``-th executed
    device tick re-verifies one answered root with the port's
    :class:`~bfs_tpu_torch.oracle.device.DeviceChecker` on the server's
    device (the row is shipped back to the card; the verdict is a 24-byte
    read), under the card's lock.  A failed verdict quarantines the
    executable: circuit force-opened, cached runner dropped, the batch
    re-run on the oracle, ``integrity_failures`` counted.
    ``raise:serve.verify`` fault injection counts as a failed verdict.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque

from ..obs.registry import get_registry
from ..obs.spans import instant
from ..resilience.faults import FaultInjected, fault_point
from ..resilience.retry import CircuitBreaker, PermanentError
from ..utils.locks import make_lock
from ..utils.metrics import percentile
from .executor import DEVICE_LOCK


class HungCallError(PermanentError):
    """A device batch call exceeded its watchdog budget.  Permanent by
    class: the call may still be running (the thread cannot be killed),
    and another launch on a wedged card only stacks more hung work — the
    tick degrades and the breaker decides about the next one."""


def run_with_deadline(fn, timeout_s: float, describe: str = "call"):
    """Run ``fn()`` on a disposable daemon thread, waiting ``timeout_s``.

    Returns ``fn``'s result or raises its exception; raises
    :class:`HungCallError` when the deadline passes first.  The worker
    thread is abandoned on timeout (daemon — it dies with the process);
    its eventual result, if any, is discarded.  A fresh thread per call
    keeps a wedged call from poisoning a shared worker."""
    box: dict = {}
    done = threading.Event()

    def _run():
        try:
            box["value"] = fn()
        except BaseException as exc:  # delivered to the waiter below
            box["error"] = exc
        done.set()

    worker = threading.Thread(
        target=_run, name="bfs-serve-watchdog-call", daemon=True
    )
    worker.start()
    if not done.wait(timeout_s):
        raise HungCallError(
            f"{describe}: no result within the {timeout_s:.3f}s watchdog "
            "budget (call abandoned on its worker thread)"
        )
    if "error" in box:
        raise box["error"]
    return box["value"]


class _LatencyWindow:
    """Bounded per-key service-time history feeding the watchdog budget;
    fields guarded by the owning :class:`ServeHealth`'s lock."""

    __slots__ = ("samples",)

    def __init__(self, maxlen: int = 128):
        self.samples: deque = deque(maxlen=maxlen)


class ServeHealth:
    """Per-server health authority: breaker + watchdog + integrity.

    One instance per :class:`~bfs_tpu_torch.serve.BfsServer`; consulted only
    from the serve loop (but internally locked — metrics readers and
    tests may probe concurrently).  ``watchdog_s <= 0`` disables the
    watchdog entirely; ``verify_sample <= 0`` disables integrity
    sampling; the breaker is always on (an open circuit needs
    ``breaker_failures`` PERMANENT failures, which the healthy path never
    produces).
    """

    #: Samples required before the p99 budget replaces the default.
    MIN_SAMPLES = 8

    def __init__(
        self,
        *,
        metrics,
        breaker_failures: int = 3,
        breaker_cooldown_s: float = 5.0,
        watchdog_s: float = 60.0,
        watchdog_multiplier: float = 8.0,
        watchdog_min_s: float = 1.0,
        compile_floor_s: float = 1200.0,
        verify_sample: int = 0,
        device=None,
    ):
        self.metrics = metrics  # ServeMetrics is internally locked
        #: The device the integrity checker ships its edges to (the card
        #: unless "cpu"; resolved when the first checker is built).
        self.device = device
        self.watchdog_s = float(watchdog_s)
        self.watchdog_multiplier = float(watchdog_multiplier)
        self.watchdog_min_s = float(watchdog_min_s)
        # Budget floor for guarded calls that build their runner (the cold
        # tick of a new epoch or bucket, or after an eviction): finite, so a
        # wedged build times out instead of freezing the serve loop.
        self.compile_floor_s = float(compile_floor_s)
        self.verify_sample = int(verify_sample)
        self.breaker = CircuitBreaker(
            failure_threshold=breaker_failures,
            cooldown_s=breaker_cooldown_s,
            on_transition=self._on_transition,
        )
        self._lock = make_lock("health._lock")
        self._latency: dict[tuple, _LatencyWindow] = {}  # guarded-by: _lock
        self._ticks = 0  # guarded-by: _lock (executed device ticks; drives sampling)
        # (name, epoch) -> DeviceChecker; small LRU (epochs churn on swap).
        self._checkers: OrderedDict = OrderedDict()  # guarded-by: _lock

    # ----------------------------------------------------------- breaker --
    def _on_transition(self, key, old: str, new: str, reason: str) -> None:
        counter = {
            "open": "breaker_opened",
            "half_open": "breaker_half_open",
            "closed": "breaker_closed",
        }[new]
        self.metrics.bump(counter)
        get_registry().counter(counter)
        instant(
            "serve.breaker",
            key="/".join(str(p) for p in key),
            transition=f"{old}->{new}", reason=reason,
        )

    def allow(self, key) -> bool:
        """May this tick touch the device path for ``key``?  False =
        short-circuit to the degraded path (circuit open, cooldown not
        elapsed, or another canary already in flight)."""
        return self.breaker.allow(key)

    def record_success(self, key) -> None:
        self.breaker.record_success(key)

    def record_failure(self, key, reason: str = "") -> None:
        self.breaker.record_failure(key, reason)

    def quarantine(self, key, reason: str) -> None:
        """Force-open the circuit for a PROVEN-wrong executable."""
        self.breaker.force_open(key, reason)

    def forget_epoch(self, name: str, epoch: int) -> None:
        """Drop every per-key cell for one retired ``(graph, epoch)``:
        circuit cells, latency windows, the sampled checker.  Wired to
        the registry's retire listeners so a long-lived server doing
        periodic hot swaps — the streaming-graph shape — does not grow
        its health state (and ``report()['health']``) with every swap.
        Keys are ``(graph, epoch, engine, bucket)``; retirement fires
        after the epoch's last pin drops, so no in-flight tick can
        recreate what this prunes."""
        self.breaker.forget(lambda k: k[0] == name and k[1] == epoch)
        with self._lock:
            for k in [
                k for k in self._latency
                if k[0] == name and k[1] == epoch
            ]:
                del self._latency[k]
            self._checkers.pop((name, epoch), None)

    # ---------------------------------------------------------- watchdog --
    def budget_s(self, key) -> float:
        """The p99-informed watchdog budget for one circuit key: the
        configured default until :data:`MIN_SAMPLES` service times exist,
        then ``multiplier × p99`` floored at ``watchdog_min_s`` — tight
        enough to catch a wedge within a few healthy-tick lengths, loose
        enough that the occasional re-run inside a runner (past the packed
        carry's level cap) does not false-positive."""
        with self._lock:
            win = self._latency.get(key)
            samples = list(win.samples) if win is not None else []
        if len(samples) < self.MIN_SAMPLES:
            return self.watchdog_s
        return max(self.watchdog_min_s, self.watchdog_multiplier * percentile(samples, 99))

    def timeout_for(self, key, deadlines, now: float | None = None) -> float | None:
        """The effective watchdog timeout for one batch, or None when the
        watchdog is disabled.  Derived from the batch's earliest request
        deadline plus a grace of ``watchdog_min_s`` (a wedged call never
        outlives the deadline its callers are waiting on by more than the
        grace), bounded above by the per-key p99-informed budget."""
        if self.watchdog_s <= 0:
            return None
        budget = self.budget_s(key)
        if deadlines:
            now = time.monotonic() if now is None else now
            remaining = max(0.0, min(deadlines) - now)
            budget = min(budget, remaining + self.watchdog_min_s)
        return max(self.watchdog_min_s, budget)

    def observe_latency(self, key, seconds: float) -> None:
        with self._lock:
            win = self._latency.get(key)
            if win is None:
                win = self._latency[key] = _LatencyWindow()
            win.samples.append(float(seconds))

    def run_guarded(self, key, fn, deadlines, describe: str = "device batch",
                    cold: bool = False):
        """Run one device batch attempt under the watchdog; successful
        calls feed the latency window the budget derives from.  A timeout
        bumps ``watchdog_timeouts`` and raises :class:`HungCallError`
        (permanent — the caller's breaker bookkeeping sees it like any
        other permanent failure).

        ``cold=True`` marks a call that includes the runner's build (the
        engine shipped, the loop captured): the timeout is floored at
        ``compile_floor_s`` so an honest build is never false-positived,
        while a wedged one still times out — request deadlines do NOT
        tighten a cold tick below the floor."""
        timeout_s = self.timeout_for(key, deadlines)
        if cold and timeout_s is not None:
            timeout_s = max(timeout_s, self.compile_floor_s)
        t0 = time.monotonic()
        if timeout_s is None:
            out = fn()
        else:
            try:
                out = run_with_deadline(fn, timeout_s, describe=describe)
            except HungCallError:
                self.metrics.bump("watchdog_timeouts")
                get_registry().counter("watchdog_timeouts")
                instant(
                    "serve.watchdog",
                    key="/".join(str(p) for p in key),
                    budget_s=round(timeout_s, 3),
                )
                raise
        if not cold:
            # Cold durations include the build: one such sample at the p99
            # point would inflate the warm budget to ~multiplier x build
            # time for the next window of ticks.
            self.observe_latency(key, time.monotonic() - t0)
        return out

    # --------------------------------------------------------- integrity --
    #: Resident DeviceChecker bound: one per actively-sampled graph name
    #: plus transient swap overlap.  Each checker holds its OWN copy of the
    #: epoch's edge arrays on the device (8·E bytes), OUTSIDE the
    #: registry's budget — the cap is what bounds that footprint.
    MAX_CHECKERS = 4

    def _checker(self, rec):
        """Memoized DeviceChecker for one graph epoch.

        The checker's edge-array upload is a second, registry-invisible
        device copy of the graph, so retention is aggressive: inserting a
        CURRENT epoch's checker drops every other epoch of the same name
        (a replaced epoch's checker is only ever needed again for batches
        already in flight across a swap — those rebuild transiently and
        age out), and the LRU is capped at :data:`MAX_CHECKERS` overall."""
        from ..oracle.device import DeviceChecker

        ckey = (rec.name, rec.epoch)
        with self._lock:
            hit = self._checkers.get(ckey)
            if hit is not None:
                self._checkers.move_to_end(ckey)
                return hit
        checker = DeviceChecker.from_graph(rec.graph, device=self.device)
        with self._lock:
            checker = self._checkers.setdefault(ckey, checker)
            self._checkers.move_to_end(ckey)
            if not rec.retired:
                for k in [
                    k for k in self._checkers
                    if k[0] == rec.name and k != ckey
                ]:
                    del self._checkers[k]
            while len(self._checkers) > self.MAX_CHECKERS:
                self._checkers.popitem(last=False)
        return checker

    def maybe_verify(self, rec, result, sources) -> dict | None:
        """Every ``verify_sample``-th executed device tick, re-verify one
        answered root against the BFS-tree invariants on the device.

        Returns None when sampling skipped this tick or the verdict was
        clean; a non-empty verdict dict when the sampled root FAILED —
        the caller quarantines the executable and re-runs the batch on
        the fallback path.  Requires the host graph (edge arrays); a
        layout-only registration is never sampled.  ``result``'s rows are
        host arrays (``dist[row]``, ``parent[row]``).

        Cost per sample: the sampled row's dist and parent are shipped back
        to the device (2 x 4 x V bytes), the verdict is a 24-byte read."""
        if self.verify_sample <= 0 or rec.graph is None:
            return None
        with self._lock:
            self._ticks += 1
            ticks = self._ticks
        if ticks % self.verify_sample:
            return None
        n = int(sources.shape[0])
        row = ticks % n  # rotate through the batch's real rows

        def _run_check():
            fault_point("serve.verify")
            with DEVICE_LOCK:  # a checker's upload and check are device work
                return self._checker(rec).check(
                    result.dist[row], result.parent[row], int(sources[row])
                )

        try:
            if self.watchdog_s > 0:
                # The check is device work (edge upload on a cold checker,
                # the row shipped back, the verdict read): unguarded, a
                # wedge here would freeze the loop.  A cold checker's
                # budget covers its upload (the floor); a hung check lands
                # in the generic handler below as check-couldn't-run.
                with self._lock:
                    warm = (rec.name, rec.epoch) in self._checkers
                budget = (
                    max(self.watchdog_min_s, self.watchdog_s)
                    if warm else self.compile_floor_s
                )
                verdict = run_with_deadline(
                    _run_check, budget,
                    describe=f"integrity check ({rec.name}/{rec.epoch})",
                )
            else:
                verdict = _run_check()
        except FaultInjected:
            # Injected corruption: the chaos schedule's stand-in for a
            # wrong on-device answer — same consequence as a real one.
            verdict = {"injected_fault": 1}
        except Exception as exc:
            # The CHECK failing to run is not evidence the answer is
            # wrong: count it, keep serving, let the next sample try.
            self.metrics.bump("integrity_check_errors")
            get_registry().counter("integrity_check_errors")
            instant("serve.integrity_error", graph=rec.name, error=repr(exc))
            return None
        self.metrics.bump("integrity_checks")
        get_registry().counter("integrity_checks")
        if not verdict:
            return None
        self.metrics.bump("integrity_failures")
        get_registry().counter("integrity_failures")
        instant(
            "serve.integrity_failure",
            graph=rec.name, epoch=rec.epoch,
            source=int(sources[row]), verdict=dict(verdict),
        )
        return verdict

    # ------------------------------------------------------------ report --
    def report(self) -> dict:
        """JSON-ready breaker snapshot + watchdog budget state."""
        with self._lock:
            budgets = {
                "/".join(str(p) for p in key): {
                    "samples": len(win.samples),
                    "p99_s": percentile(win.samples, 99) if win.samples else None,
                }
                for key, win in self._latency.items()
            }
            ticks = self._ticks
        return {
            "breaker": self.breaker.snapshot(),
            "watchdog_budgets": budgets,
            "verify_sample": self.verify_sample,
            "verified_ticks": ticks,
        }
