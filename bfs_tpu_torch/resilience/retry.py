"""Deadline-aware exponential backoff with jitter, error classification
and a keyed circuit breaker: the port of ``bfs_tpu.resilience.retry``.

The device path fails two ways and they must not be treated the same:

  * **transient** — a dropped connection, a timed-out call, a backend that
    reports UNAVAILABLE or ABORTED for a while.  These get a bounded retry
    with backoff before any degradation.
  * **permanent** — shape errors, out of memory, plain bugs, and every
    CUDA error: an error in a CUDA context is sticky (every later call on
    that context fails the same way), so retrying it only repeats it.
    These fall through at once (the query server degrades to the
    sequential oracle exactly once).

:func:`default_classify` encodes that split; :func:`retry_call` is the
retry loop.  Backoff is capped exponential with multiplicative jitter, and
the loop is bounded by an attempt count and an optional wall-clock
deadline.  :class:`CircuitBreaker` handles the failure that persists.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable


class TransientError(RuntimeError):
    """Marker: always classified transient (tests, stubs, wrappers)."""


class PermanentError(RuntimeError):
    """Marker: always classified permanent."""


class RetryError(RuntimeError):
    """All attempts exhausted (or deadline passed); ``__cause__`` is the
    last underlying error and ``attempts`` the number made."""

    def __init__(self, msg: str, attempts: int):
        super().__init__(msg)
        self.attempts = attempts


#: Substrings that mark a failure of the CUDA runtime, matched first
#: (case-insensitively, against ``repr(exc)``): such an error is permanent
#: whatever else its message says ("busy or unavailable").
CUDA_MARKERS = ("cuda error", "cudaerror", "cuda out of memory")

#: Substrings that mark a transient device/transport failure.  Matched
#: case-insensitively against ``repr(exc)`` so gRPC-style status names and
#: plain-prose socket errors both hit.
TRANSIENT_MARKERS = (
    "unavailable",
    "deadline_exceeded",
    "deadline exceeded",
    "aborted",
    "cancelled",
    "connection reset",
    "connection refused",
    "broken pipe",
    "timed out",
    "timeout",
    "temporarily",
    "tunnel",
    "socket closed",
    "transient",
)


def default_classify(exc: BaseException) -> str:
    """``'transient'`` or ``'permanent'`` for one failure.

    Marker classes win; then Python's own transport/timeout exception
    types; then CUDA's failures (``torch.cuda.OutOfMemoryError`` and any
    message of :data:`CUDA_MARKERS`), permanent; then the
    :data:`TRANSIENT_MARKERS` message probe.  Everything unrecognized is
    permanent — an unknown failure repeated is two failures, not a
    recovery strategy."""
    if isinstance(exc, TransientError):
        return "transient"
    if isinstance(exc, PermanentError):
        return "permanent"
    if isinstance(exc, (ConnectionError, TimeoutError, InterruptedError)):
        return "transient"
    if isinstance(exc, MemoryError) or type(exc).__name__ == "OutOfMemoryError":
        return "permanent"
    text = repr(exc).lower()
    if any(m in text for m in CUDA_MARKERS):
        return "permanent"
    if any(m in text for m in TRANSIENT_MARKERS):
        return "transient"
    return "permanent"


@dataclass(frozen=True)
class RetryPolicy:
    """Shape of one retry loop.  ``deadline_s`` is a per-call wall budget
    measured from the first attempt; callers with an external deadline
    (a request in a serving tick) pass the tighter of the two to
    :func:`retry_call` directly."""

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.5  # delay *= uniform(1, 1 + jitter)
    deadline_s: float | None = None
    classify: Callable[[BaseException], str] = field(default=default_classify)

    def delay(self, attempt: int, rng: random.Random) -> float:
        """Backoff before retry ``attempt`` (1-based)."""
        d = min(self.base_delay_s * self.multiplier ** (attempt - 1),
                self.max_delay_s)
        return d * rng.uniform(1.0, 1.0 + self.jitter)


def retry_call(
    fn: Callable,
    *,
    policy: RetryPolicy | None = None,
    deadline_s: float | None = None,
    on_retry: Callable[[int, BaseException, float], None] | None = None,
    describe: str = "",
    _rng: random.Random | None = None,
):
    """Call ``fn()`` with transient-failure retries.

    Permanent failures re-raise immediately and untouched.  Transient
    failures back off and retry until ``policy.max_attempts`` or the
    deadline (the tighter of ``policy.deadline_s`` and ``deadline_s``)
    runs out, then raise :class:`RetryError` from the last failure.
    ``on_retry(attempt, exc, delay)`` fires before each sleep — the hook
    the metrics counters hang off."""
    policy = policy or RetryPolicy()
    rng = _rng or random.Random()
    limits = [d for d in (policy.deadline_s, deadline_s) if d is not None]
    deadline = (time.monotonic() + min(limits)) if limits else None
    last: BaseException | None = None
    for attempt in range(1, max(1, policy.max_attempts) + 1):
        try:
            return fn()
        except BaseException as exc:
            if policy.classify(exc) != "transient":
                raise
            last = exc
            if attempt >= policy.max_attempts:
                break
            delay = policy.delay(attempt, rng)
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                delay = min(delay, remaining)
            if on_retry is not None:
                on_retry(attempt, exc, delay)
            if delay > 0:
                time.sleep(delay)
    what = describe or getattr(fn, "__name__", "call")
    raise RetryError(
        f"{what}: transient failure persisted after {attempt} attempts: "
        f"{last!r}",
        attempt,
    ) from last


# --------------------------------------------------------- circuit breaker --

#: Breaker states.  ``closed`` = traffic flows; ``open`` = short-circuit
#: (callers serve their fallback path without touching the guarded
#: resource); ``half_open`` = the cooldown elapsed and exactly ONE canary
#: call is allowed through to probe recovery.
CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class _Circuit:
    """Per-key breaker cell; all fields guarded by the owning breaker's
    lock (this is a plain struct, not a lock-owning class)."""

    __slots__ = ("state", "failures", "opened_at", "probing", "reason")

    def __init__(self):
        self.state = CLOSED
        self.failures = 0  # consecutive permanent failures while closed
        self.opened_at = 0.0
        self.probing = False  # half-open: the one canary is in flight
        self.reason = ""


class CircuitBreaker:
    """Keyed circuit breaker: the retry layer's complement.

    :func:`retry_call` handles the failure a bounded backoff can outlive;
    the breaker handles the failure that persists — after
    ``failure_threshold`` consecutive permanent failures for a key the
    circuit opens and :meth:`allow` answers False, so the caller serves
    its degraded path instead of burning a full retry loop (and a serving
    tick) on a resource that is known-bad.  After ``cooldown_s`` the next
    :meth:`allow` admits exactly one canary call (``half_open``); its
    success closes the circuit, its failure re-opens it for another
    cooldown.  :meth:`force_open` is the quarantine entry: a caller that
    PROVED the resource wrong (a failed integrity verdict) opens the
    circuit immediately, consecutive-failure count notwithstanding.

    Keys are arbitrary hashables (the serving layer uses
    ``(graph, epoch, engine, bucket)`` — one circuit per executable).  ``on_transition(key, old, new, reason)`` fires OUTSIDE
    the lock for every state change — the metrics/span hook.
    Thread-safe; time comes from ``clock`` (injectable for tests).
    """

    def __init__(
        self,
        *,
        failure_threshold: int = 3,
        cooldown_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
        on_transition: Callable[[tuple, str, str, str], None] | None = None,
    ):
        self.failure_threshold = max(1, int(failure_threshold))  # immutable after init
        self.cooldown_s = float(cooldown_s)  # immutable after init
        self._clock = clock  # immutable after init
        self._on_transition = on_transition  # immutable after init
        self._lock = threading.Lock()
        self._circuits: dict = {}  # guarded-by: _lock

    # bfs_tpu_torch: holds _lock
    def _cell(self, key) -> _Circuit:
        cell = self._circuits.get(key)
        if cell is None:
            cell = self._circuits[key] = _Circuit()
        return cell

    # bfs_tpu_torch: holds _lock
    def _set(self, cell: _Circuit, key, new: str, reason: str) -> list:
        old, cell.state, cell.reason = cell.state, new, reason
        return [(key, old, new, reason)] if old != new else []

    def _emit(self, transitions: list) -> None:
        if self._on_transition is not None:
            for key, old, new, reason in transitions:
                self._on_transition(key, old, new, reason)

    def state(self, key) -> str:
        """Effective state (``open`` reports ``half_open`` once the
        cooldown has elapsed, without mutating — :meth:`allow` is what
        admits the canary)."""
        with self._lock:
            cell = self._circuits.get(key)
            if cell is None:
                return CLOSED
            if (
                cell.state == OPEN
                and self._clock() - cell.opened_at >= self.cooldown_s
            ):
                return HALF_OPEN
            return cell.state

    def allow(self, key) -> bool:
        """True iff the caller may touch the guarded resource now.  In
        half-open, exactly one caller per probe window gets True (the
        canary); everyone else short-circuits until it resolves."""
        transitions: list = []
        with self._lock:
            cell = self._circuits.get(key)
            if cell is None or cell.state == CLOSED:
                return True
            now = self._clock()
            if cell.state == OPEN:
                if now - cell.opened_at < self.cooldown_s:
                    return False
                transitions = self._set(cell, key, HALF_OPEN, "cooldown elapsed")
                cell.probing = True
                allowed = True
            else:  # HALF_OPEN
                allowed = not cell.probing
                cell.probing = True
        self._emit(transitions)
        return allowed

    def record_success(self, key) -> None:
        """A guarded call succeeded: closed resets the failure streak,
        half-open closes the circuit (the canary came back healthy)."""
        with self._lock:
            cell = self._circuits.get(key)
            if cell is None:
                return
            cell.failures = 0
            cell.probing = False
            transitions = (
                self._set(cell, key, CLOSED, "canary succeeded")
                if cell.state != CLOSED
                else []
            )
        self._emit(transitions)

    def record_failure(self, key, reason: str = "") -> None:
        """A guarded call failed permanently: half-open re-opens (the
        canary failed), closed opens after ``failure_threshold``
        consecutive failures."""
        with self._lock:
            cell = self._cell(key)
            cell.probing = False
            cell.failures += 1
            transitions = []
            if cell.state == HALF_OPEN:
                cell.opened_at = self._clock()
                transitions = self._set(cell, key, OPEN, "canary failed")
            elif cell.state == CLOSED and cell.failures >= self.failure_threshold:
                cell.opened_at = self._clock()
                transitions = self._set(
                    cell, key, OPEN,
                    reason or f"{cell.failures} consecutive failures",
                )
        self._emit(transitions)

    def force_open(self, key, reason: str = "quarantined") -> None:
        """Quarantine: open the circuit NOW regardless of the failure
        count (e.g. a failed integrity verdict — one provably wrong
        answer outweighs any streak of plausible ones)."""
        with self._lock:
            cell = self._cell(key)
            cell.probing = False
            cell.opened_at = self._clock()
            transitions = self._set(cell, key, OPEN, reason)
        self._emit(transitions)

    def forget(self, match: Callable[[tuple], bool]) -> int:
        """Drop every circuit whose key satisfies ``match`` and return the
        count.  The retirement hook: per-key cells are created on demand
        and otherwise live forever, so a caller that keys circuits by a
        finite-lifetime resource (the serving layer's graph epochs) must
        prune when the resource dies or the dict — and every
        :meth:`snapshot` serialized from it — grows with each swap."""
        with self._lock:
            dead = [k for k in self._circuits if match(k)]
            for k in dead:
                del self._circuits[k]
        return len(dead)

    def snapshot(self) -> dict:
        """JSON-ready per-key view (state/failures/reason/opened-for
        seconds) for reports and dashboards."""
        with self._lock:
            now = self._clock()
            return {
                "/".join(str(p) for p in (key if isinstance(key, tuple) else (key,))): {
                    "state": cell.state,
                    "failures": cell.failures,
                    "reason": cell.reason,
                    "open_for_s": (
                        round(now - cell.opened_at, 3)
                        if cell.state == OPEN
                        else 0.0
                    ),
                }
                for key, cell in self._circuits.items()
            }
