"""Self-healing serve on the port (``bfs_tpu_torch.serve`` and
``bfs_tpu_torch.resilience``), on the CPU.

The fault grammar and the failure classifier against ``bfs_tpu``'s; CUDA's
failures classified permanent; the retry loop; the circuit breaker, the
hung-call watchdog and sampled integrity checks, unit by unit (fake
clocks) and through the real tick path (runners injected through
``ExecutableCache.put``); epochs, hot swaps and budgeted residency of the
registry; a scaled-down chaos schedule.  Then the port's own hazards: an
attempt abandoned by the watchdog launches nothing once a later attempt on
the same runner has begun; a kept reply holds its own rows and nothing else
of its tick; launch counts of a capture stay with the capturing thread.
Every served reply is checked against the oracle."""

import threading
import time
import types

import numpy as np
import pytest
import torch

import bfs_tpu_torch as P
from bfs_tpu_torch.models import loop as L
from bfs_tpu_torch.models.bfs import EdgeEngine
from bfs_tpu_torch.ops import relay_cuda as K
from bfs_tpu_torch.resilience import faults as F
from bfs_tpu_torch.resilience.retry import (
    CircuitBreaker,
    PermanentError,
    RetryError,
    RetryPolicy,
    TransientError,
    default_classify,
    retry_call,
)
from bfs_tpu_torch.serve import BfsServer, GraphRegistry, HungCallError
from bfs_tpu_torch.serve.executor import DEVICE_LOCK, HostRows, host_rows, run_oracle_batch
from bfs_tpu_torch.serve.health import ServeHealth, run_with_deadline
from bfs_tpu_torch.utils.metrics import ServeMetrics

TIMEOUT = 300


def _tick_key(graph, engine, padded, epoch=0):
    from bfs_tpu_torch.models.direction import resolve_direction

    return (graph, epoch, engine, padded, resolve_direction().key())


@pytest.fixture
def graph():
    return P.gnm_graph(60, 150, seed=7)


def make_server(graph, **kw):
    kw.setdefault("retry_policy", RetryPolicy(max_attempts=2, base_delay_s=0.0, jitter=0.0))
    kw.setdefault("engine", "pull")
    srv = BfsServer(device="cpu", max_batch=4, **kw)
    srv.register("g", graph)
    return srv


def _exact(g, s, reply):
    d, p = P.canonical_bfs(g, s)
    np.testing.assert_array_equal(reply.dist, d)
    np.testing.assert_array_equal(reply.parent, p)


# ------------------------------------------------------------ faults, retry --

FAULT_SPECS = ["", "kill:verify", "raise:repeat:2", "phase:reference", "kill:repeat:0",
               "kill:repeat:0:2", "delay:serve.batch", "delay:serve.batch:2.5",
               "delay:repeat:0", "explode:reference", "kill:", "delay:"]


@pytest.mark.parametrize("spec", FAULT_SPECS)
def test_fault_spec_matches_the_reference(spec):
    from bfs_tpu.resilience.faults import fault_spec as j_fault_spec

    try:
        want = j_fault_spec(spec)
    except ValueError:
        with pytest.raises(ValueError):
            F.fault_spec(spec)
        return
    assert F.fault_spec(spec) == want


def test_fault_knob_rejects_a_bad_action(monkeypatch):
    monkeypatch.setenv("BFS_TPU_TORCH_FAULT", "explode:serve.batch")
    with pytest.raises(ValueError, match="BFS_TPU_TORCH_FAULT"):
        F.fault_point("serve.batch")


def test_fault_point_delay_sleeps_every_arrival(monkeypatch):
    monkeypatch.setenv("BFS_TPU_TORCH_FAULT", "delay:serve.batch:0.05")
    F.reset()
    t0 = time.monotonic()
    F.fault_point("serve.batch")
    F.fault_point("serve.batch")
    assert time.monotonic() - t0 >= 0.1
    t0 = time.monotonic()
    F.fault_point("serve.verify")
    assert time.monotonic() - t0 < 0.05
    F.reset()


def test_fault_point_raise_nth_and_inert(monkeypatch):
    monkeypatch.setenv("BFS_TPU_TORCH_FAULT", "raise:repeat:2")
    F.reset()
    F.fault_point("repeat:0")
    with pytest.raises(F.FaultInjected):
        F.fault_point("repeat:1")
    F.fault_point("repeat:2")  # nth is exact, not at-least
    monkeypatch.delenv("BFS_TPU_TORCH_FAULT")
    F.reset()
    for _ in range(3):
        F.fault_point("repeat:1")


def test_corrupt_file_modes(tmp_path):
    p = tmp_path / "blob.bin"
    p.write_bytes(b"x" * 100)
    F.corrupt_file(str(p), mode="truncate")
    assert p.stat().st_size == 50
    before = p.read_bytes()
    F.corrupt_file(str(p), mode="flip", at=10)
    after = p.read_bytes()
    assert before[10] != after[10] and len(after) == 50
    with pytest.raises(ValueError):
        F.corrupt_file(str(p), mode="shred")


EXCEPTIONS = [
    TransientError("x"), PermanentError("x"), ConnectionResetError(), TimeoutError(),
    RuntimeError("backend UNAVAILABLE: retry"), RuntimeError("tunnel write failed"),
    ValueError("bad shape"), MemoryError(), ArithmeticError("div"),
    RuntimeError("socket closed"), RuntimeError("status 0x7f"),
]


@pytest.mark.parametrize("exc", EXCEPTIONS, ids=repr)
def test_default_classify_matches_the_reference(exc):
    from bfs_tpu.resilience import retry as j_retry

    j_exc = exc
    if isinstance(exc, (TransientError, PermanentError)):
        j_exc = getattr(j_retry, type(exc).__name__)(*exc.args)
    assert default_classify(exc) == j_retry.default_classify(j_exc)


CUDA_FAILURES = [
    torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    # A sticky error whose text carries a transient marker ("unavailable").
    RuntimeError("CUDA error: CUDA-capable device(s) is/are busy or unavailable"),
    RuntimeError("benes_local_pass: CUDA error 700 at launch"),
]


@pytest.mark.parametrize("exc", CUDA_FAILURES, ids=repr)
def test_cuda_failures_are_permanent_and_never_retried(exc):
    assert default_classify(exc) == "permanent"
    calls = {"n": 0}

    def fail():
        calls["n"] += 1
        raise exc

    with pytest.raises(type(exc)):
        retry_call(fail, policy=RetryPolicy(max_attempts=5, base_delay_s=0.0))
    assert calls["n"] == 1


def test_retry_transient_then_success_and_permanent_at_once():
    calls = {"n": 0}
    retried = []

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise TransientError("hiccup")
        return "ok"

    out = retry_call(flaky, policy=RetryPolicy(max_attempts=5, base_delay_s=0.0, jitter=0.0),
                     on_retry=lambda a, e, d: retried.append(a))
    assert out == "ok" and calls["n"] == 3 and retried == [1, 2]
    with pytest.raises(ValueError):
        retry_call(lambda: (_ for _ in ()).throw(ValueError("shape")),
                   policy=RetryPolicy(max_attempts=5, base_delay_s=0.0))


def test_retry_exhaustion_and_deadlines():
    def always():
        raise TransientError("still down")

    with pytest.raises(RetryError) as ei:
        retry_call(always, policy=RetryPolicy(max_attempts=3, base_delay_s=0.0, jitter=0.0))
    assert ei.value.attempts == 3 and isinstance(ei.value.__cause__, TransientError)
    for policy_deadline, call_deadline in ((5.0, 0.1), (0.1, 5.0), (None, 0.12)):
        t0 = time.monotonic()
        with pytest.raises(RetryError) as ei:
            retry_call(always, policy=RetryPolicy(max_attempts=1000, base_delay_s=0.02,
                                                  jitter=0.0, deadline_s=policy_deadline),
                       deadline_s=call_deadline)
        assert time.monotonic() - t0 < 1.0 and ei.value.attempts < 1000


def test_retry_jitter_stays_within_cap():
    import random

    policy = RetryPolicy(max_attempts=8, base_delay_s=0.05, max_delay_s=0.4, multiplier=2.0,
                         jitter=0.5)
    rng = random.Random(123)
    for attempt in range(1, 20):
        base = min(0.05 * 2.0 ** (attempt - 1), 0.4)
        for _ in range(50):
            assert base <= policy.delay(attempt, rng) <= base * 1.5 + 1e-12


# ------------------------------------------------------------------ breaker --


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_breaker_opens_after_threshold_and_cools_down():
    clock = FakeClock()
    transitions = []
    br = CircuitBreaker(failure_threshold=3, cooldown_s=10.0, clock=clock,
                        on_transition=lambda k, old, new, why: transitions.append((old, new)))
    key = ("g", 0, "pull", 4)
    assert br.allow(key) and br.state(key) == "closed"
    br.record_failure(key)
    br.record_failure(key)
    assert br.allow(key)
    br.record_failure(key)
    assert br.state(key) == "open" and not br.allow(key)
    clock.t += 9.9
    assert not br.allow(key)
    clock.t += 0.2
    assert br.state(key) == "half_open"
    assert br.allow(key)
    assert not br.allow(key)  # exactly ONE canary per probe window
    br.record_success(key)
    assert br.state(key) == "closed" and br.allow(key)
    assert transitions == [("closed", "open"), ("open", "half_open"), ("half_open", "closed")]


def test_breaker_canary_failure_reopens_and_force_open():
    clock = FakeClock()
    br = CircuitBreaker(failure_threshold=1, cooldown_s=5.0, clock=clock)
    br.record_failure("k", "boom")
    clock.t += 5.1
    assert br.allow("k")
    br.record_failure("k", "still broken")
    assert br.state("k") == "open" and not br.allow("k")
    clock.t += 5.1
    assert br.allow("k")
    br.record_success("k")
    assert br.state("k") == "closed"
    br2 = CircuitBreaker(failure_threshold=99, cooldown_s=5.0, clock=clock)
    br2.force_open("q", "integrity verdict {'dist_gap': 1}")
    assert br2.state("q") == "open" and not br2.allow("q")
    assert "integrity" in br2.snapshot()["q"]["reason"]


def test_breaker_forget_and_success_streak():
    br = CircuitBreaker(failure_threshold=1, cooldown_s=5.0, clock=FakeClock())
    br.record_failure(("g", 0, "pull", 4))
    br.record_failure(("g", 1, "pull", 4))
    assert br.forget(lambda k: k[1] == 0) == 1
    snap = br.snapshot()
    assert "g/0/pull/4" not in snap and "g/1/pull/4" in snap
    assert br.allow(("g", 0, "pull", 4))
    br2 = CircuitBreaker(failure_threshold=2, cooldown_s=5.0, clock=FakeClock())
    br2.record_failure("k")
    br2.record_success("k")
    br2.record_failure("k")
    assert br2.state("k") == "closed"


def test_breaker_is_thread_safe_under_concurrent_hammering():
    br = CircuitBreaker(failure_threshold=3, cooldown_s=0.0)
    errs = []

    def worker():
        try:
            for _ in range(200):
                if br.allow("k"):
                    br.record_failure("k")
                else:
                    br.record_success("k")
        except Exception as exc:  # pragma: no cover
            errs.append(exc)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs and br.state("k") in ("closed", "open", "half_open")


# ----------------------------------------------------------------- watchdog --


def test_run_with_deadline():
    assert run_with_deadline(lambda: 42, 5.0) == 42
    with pytest.raises(ZeroDivisionError):
        run_with_deadline(lambda: 1 / 0, 5.0)
    t0 = time.monotonic()
    with pytest.raises(HungCallError):
        run_with_deadline(lambda: time.sleep(5.0), 0.1, describe="wedge")
    assert time.monotonic() - t0 < 2.0


def test_watchdog_budget_and_deadline_tightening():
    h = ServeHealth(metrics=ServeMetrics(), watchdog_s=30.0, watchdog_multiplier=4.0,
                    watchdog_min_s=0.5)
    key = ("g", 0, "pull", 4)
    assert h.budget_s(key) == 30.0
    for _ in range(ServeHealth.MIN_SAMPLES):
        h.observe_latency(key, 0.01)
    assert h.budget_s(key) == 0.5
    for _ in range(ServeHealth.MIN_SAMPLES):
        h.observe_latency(key, 1.0)
    assert h.budget_s(key) == pytest.approx(4.0)
    h = ServeHealth(metrics=ServeMetrics(), watchdog_s=30.0, watchdog_min_s=0.5)
    now = time.monotonic()
    assert h.timeout_for(key, [now + 2.0, now + 50.0], now=now) == pytest.approx(2.5, abs=0.01)
    assert h.timeout_for(key, [now - 1.0], now=now) == 0.5
    assert ServeHealth(metrics=ServeMetrics(), watchdog_s=0.0).timeout_for(
        key, [now + 2.0], now=now) is None


def test_cold_ticks_stay_out_of_the_window_and_get_the_floor():
    h = ServeHealth(metrics=ServeMetrics(), watchdog_s=0.05, watchdog_min_s=0.01,
                    compile_floor_s=0.5)
    key = ("g", 0, "pull", 4)
    h.run_guarded(key, lambda: time.sleep(0.05), [], cold=True)
    assert h.report()["watchdog_budgets"] == {}
    deadlines = [time.monotonic() + 0.02]
    with pytest.raises(HungCallError):
        h.run_guarded(key, lambda: time.sleep(0.15) or "x", deadlines)
    assert h.run_guarded(key, lambda: time.sleep(0.15) or "x", deadlines, cold=True) == "x"
    with pytest.raises(HungCallError):
        h.run_guarded(key, lambda: time.sleep(5.0), [], cold=True)
    h.run_guarded(key, lambda: None, [], cold=False)
    assert h.report()["watchdog_budgets"]["g/0/pull/4"]["samples"] == 1


def test_checker_cache_keeps_one_epoch_per_name():
    g = P.gnm_graph(40, 90, seed=11)
    h = ServeHealth(metrics=ServeMetrics(), verify_sample=1, device="cpu")
    rec0 = types.SimpleNamespace(name="g", epoch=0, graph=g, retired=False)
    assert h._checker(rec0).device.type == "cpu"
    assert list(h._checkers) == [("g", 0)]
    rec1 = types.SimpleNamespace(name="g", epoch=1, graph=g, retired=False)
    h._checker(rec1)
    assert list(h._checkers) == [("g", 1)]
    rec0.retired = True
    h._checker(rec0)
    assert set(h._checkers) == {("g", 0), ("g", 1)}


# -------------------------------------- server integration: injected runners --


class Runner:
    """Raises ``exc`` on the calls ``fail(n)`` selects (or sleeps ``wedge``
    seconds on them), else serves the oracle's answer."""

    def __init__(self, graph, fail=lambda n: False, exc=None, wedge=0.0):
        self.graph, self.fail, self.exc, self.wedge = graph, fail, exc, wedge
        self.calls = 0

    def __call__(self, sources):
        self.calls += 1
        if self.fail(self.calls):
            if self.wedge:
                time.sleep(self.wedge)
            else:
                raise self.exc
        return run_oracle_batch(self.graph, sources)


@pytest.mark.parametrize("case", ["transient_retried", "permanent_once", "exhausted",
                                  "retry_disabled"])
def test_retry_semantics_on_the_tick_path(graph, case):
    policy = RetryPolicy(max_attempts=1 if case == "retry_disabled" else 3, base_delay_s=0.0,
                         jitter=0.0)
    runner = {
        "transient_retried": Runner(graph, lambda n: n <= 2, TransientError("hiccup")),
        "permanent_once": Runner(graph, lambda n: True, ValueError("shape mismatch")),
        "exhausted": Runner(graph, lambda n: True, TransientError("down")),
        "retry_disabled": Runner(graph, lambda n: n <= 1, TransientError("hiccup")),
    }[case]
    with make_server(graph, retry_policy=policy) as srv:
        srv.exe_cache.put(_tick_key("g", "pull", 1), runner)
        reply = srv.query("g", 5).result(TIMEOUT)
        _exact(graph, 5, reply)
        retries = srv.report()["retries"]
    calls, status, want = {
        "transient_retried": (3, "ok", (2, 1, 0)),
        "permanent_once": (1, "oracle", (0, 0, 1)),
        "exhausted": (3, "oracle", (2, 0, 1)),
        "retry_disabled": (1, "oracle", (0, 0, 1)),
    }[case]
    assert (runner.calls, reply.record.status) == (calls, status)
    assert (retries["device_retries"], retries["device_retry_successes"],
            retries["device_errors"]) == want


def test_breaker_opens_short_circuits_then_canary_closes(graph):
    with make_server(graph, breaker_failures=2, breaker_cooldown_s=0.5, watchdog_s=0.0) as srv:
        srv.exe_cache.put(_tick_key("g", "pull", 1),
                          Runner(graph, lambda n: n <= 2, PermanentError("poisoned")))
        for s in (0, 1):
            reply = srv.query("g", s).result(TIMEOUT)
            assert reply.record.status == "oracle"
            _exact(graph, s, reply)
        assert srv.metrics.count("breaker_opened") == 1
        assert srv.query("g", 2).result(TIMEOUT).record.status == "oracle"
        assert srv.metrics.count("breaker_short_circuits") >= 1
        time.sleep(0.6)
        reply = srv.query("g", 3).result(TIMEOUT)
        _exact(graph, 3, reply)
        assert reply.record.status == "ok"
        assert srv.metrics.count("breaker_half_open") == 1
        assert srv.metrics.count("breaker_closed") == 1
        assert srv.query("g", 4).result(TIMEOUT).record.status == "ok"
        assert all(c["state"] == "closed" for c in srv.report()["health"]["breaker"].values())


def test_transient_flakes_do_not_trip_the_breaker(graph):
    with make_server(graph, breaker_failures=1, watchdog_s=0.0) as srv:
        srv.exe_cache.put(_tick_key("g", "pull", 1),
                          Runner(graph, lambda n: n % 2, TransientError("hiccup")))
        for s in range(4):
            _exact(graph, s, srv.query("g", s).result(TIMEOUT))
        assert srv.metrics.count("breaker_opened") == 0
        assert srv.metrics.count("device_retries") >= 4


def test_hung_call_times_out_degrades_and_strikes_breaker(graph):
    with make_server(graph, breaker_failures=2, watchdog_s=0.3, watchdog_min_s=0.05) as srv:
        srv.exe_cache.put(_tick_key("g", "pull", 1), Runner(graph, lambda n: n == 1, wedge=5.0))
        t0 = time.monotonic()
        reply = srv.query("g", 0).result(TIMEOUT)
        assert time.monotonic() - t0 < 4.0
        _exact(graph, 0, reply)
        assert reply.record.status == "oracle"
        assert srv.metrics.count("watchdog_timeouts") == 1
        assert srv.metrics.count("device_retries") == 0
        assert srv.query("g", 1).result(TIMEOUT).record.status == "ok"
        assert srv.metrics.count("breaker_opened") == 0


def test_hung_build_times_out_instead_of_freezing_the_server(graph, monkeypatch):
    import bfs_tpu_torch.serve.server as server_mod

    def wedged_build(*a, **kw):
        time.sleep(5.0)
        raise AssertionError("unreachable: the watchdog fires first")

    monkeypatch.setattr(server_mod, "build_batch_runner", wedged_build)
    with make_server(graph, watchdog_s=0.2, watchdog_min_s=0.05,
                     watchdog_compile_floor_s=0.4) as srv:
        t0 = time.monotonic()
        reply = srv.query("g", 0).result(TIMEOUT)
        assert time.monotonic() - t0 < 4.0
        _exact(graph, 0, reply)
        assert reply.record.status == "oracle"
        assert srv.metrics.count("watchdog_timeouts") == 1


def test_sampled_integrity_check_passes_on_healthy_path(graph):
    with make_server(graph, verify_sample=1, watchdog_s=0.0) as srv:
        for s in range(3):
            assert srv.query("g", s).result(TIMEOUT).record.status == "ok"
        assert srv.metrics.count("integrity_checks") == 3
        assert srv.metrics.count("integrity_failures") == 0


def test_hung_integrity_check_degrades_instead_of_freezing(graph, monkeypatch):
    from bfs_tpu_torch.oracle.device import DeviceChecker

    def wedged_check(self, *a, **kw):
        time.sleep(5.0)
        return {}

    monkeypatch.setattr(DeviceChecker, "check", wedged_check)
    with make_server(graph, verify_sample=1, watchdog_s=1.0,
                     watchdog_compile_floor_s=3.0) as srv:
        t0 = time.monotonic()
        reply = srv.query("g", 0).result(TIMEOUT)
        assert time.monotonic() - t0 < 4.5, "serve loop froze in verify"
        assert reply.record.status == "ok"
        assert srv.metrics.count("integrity_check_errors") == 1
        assert srv.metrics.count("integrity_failures") == 0
    # The wedged check holds the card's lock until it returns: the next
    # device work of any server waits for it.
    with DEVICE_LOCK:
        assert time.monotonic() - t0 >= 5.0


def test_integrity_failure_quarantines_and_reruns_on_fallback(graph, monkeypatch):
    with make_server(graph, verify_sample=1, breaker_cooldown_s=0.5, watchdog_s=0.0) as srv:
        assert srv.query("g", 0).result(TIMEOUT).record.status == "ok"
        n_exe = len(srv.exe_cache)
        monkeypatch.setenv("BFS_TPU_TORCH_FAULT", "raise:serve.verify")
        reply = srv.query("g", 1).result(TIMEOUT)
        monkeypatch.delenv("BFS_TPU_TORCH_FAULT")
        _exact(graph, 1, reply)
        assert reply.record.status == "oracle"
        assert srv.metrics.count("integrity_failures") == 1
        assert srv.metrics.count("breaker_opened") == 1
        assert len(srv.exe_cache) == n_exe - 1
        assert srv.query("g", 2).result(TIMEOUT).record.status == "oracle"
        time.sleep(0.6)
        reply = srv.query("g", 3).result(TIMEOUT)
        assert reply.record.status == "ok" and reply.record.compile_hit is False
        assert srv.metrics.count("breaker_closed") == 1
        assert len(srv.exe_cache) == n_exe


# ------------------------------------------------------ the port's hazards --


def test_injected_delay_abandons_the_attempt_and_it_never_launches(graph, monkeypatch):
    """``delay:serve.batch`` wedges the REAL batch call: the watchdog
    degrades the tick, and the abandoned attempt, waking after a later
    attempt on the same runner has begun, runs nothing on the engine."""
    with make_server(graph, watchdog_s=0.5, watchdog_min_s=0.05) as srv:
        _exact(graph, 5, srv.query("g", 5).result(TIMEOUT))  # build outside the fault
        runs = []
        real = EdgeEngine.run_multi

        def spy(self, sources, **kw):
            runs.append(threading.current_thread().name)
            return real(self, sources, **kw)

        monkeypatch.setattr(EdgeEngine, "run_multi", spy)
        monkeypatch.setenv("BFS_TPU_TORCH_FAULT", "delay:serve.batch:3.0")
        t0 = time.monotonic()
        reply = srv.query("g", 0).result(TIMEOUT)
        assert time.monotonic() - t0 < 2.5
        monkeypatch.delenv("BFS_TPU_TORCH_FAULT")
        assert reply.record.status == "oracle"
        _exact(graph, 0, reply)
        assert srv.metrics.count("watchdog_timeouts") == 1
        reply = srv.query("g", 1).result(TIMEOUT)  # a later attempt begins
        assert reply.record.status == "ok"
        _exact(graph, 1, reply)
        time.sleep(max(0.0, t0 + 3.3 - time.monotonic()))  # the zombie has woken
        assert len(runs) == 1, runs
        assert srv.metrics.count("abandoned_attempts") == 1


def test_abandoned_attempt_stops_between_supersteps(monkeypatch):
    """An attempt abandoned in the middle of its level loop issues no
    superstep that starts after a later attempt has begun: the runner's
    check before every block stops it, and the later attempt gets the
    engine (and its shared carry) only then."""
    g = P.path_graph(40)
    events = []
    slow_thread = []
    real_step = EdgeEngine.superstep

    def step(self, state, ctl=None):
        me = threading.current_thread()
        events.append(("step", me, time.monotonic()))
        if slow_thread and me is slow_thread[0]:
            time.sleep(0.1)
        return real_step(self, state, ctl)

    with make_server(g, watchdog_s=1.0, watchdog_min_s=0.05) as srv:
        _exact(g, 0, srv.query("g", 0).result(TIMEOUT))
        runner = srv.exe_cache.peek(_tick_key("g", "pull", 1))
        real_begin = runner.begin

        def begin():
            ticket = real_begin()
            events.append(("begin", threading.current_thread(), time.monotonic()))
            if ticket == 2:  # the attempt that will wedge
                slow_thread.append(threading.current_thread())
            return ticket

        monkeypatch.setattr(runner, "begin", begin)
        monkeypatch.setattr(EdgeEngine, "superstep", step)
        reply = srv.query("g", 1).result(TIMEOUT)  # 40 slow supersteps: abandoned
        assert reply.record.status == "oracle"
        _exact(g, 1, reply)
        reply = srv.query("g", 2).result(TIMEOUT)
        assert reply.record.status == "ok"
        _exact(g, 2, reply)
        zombie = slow_thread[0]
        later_begin = [t for kind, th, t in events if kind == "begin" and th is not zombie][0]
        zombie_steps = [t for kind, th, t in events if kind == "step" and th is zombie]
        assert zombie_steps and max(zombie_steps) < later_begin
        assert srv.metrics.count("abandoned_attempts") == 1


def test_attempt_check_stops_a_loop():
    eng = EdgeEngine(P.path_graph(30), engine="pull", device="cpu")
    seen = {"n": 0}

    def check():
        seen["n"] += 1
        if seen["n"] > 3:
            raise RuntimeError("superseded")

    with L.attempt(check), pytest.raises(RuntimeError, match="superseded"):
        eng.run(0)
    assert seen["n"] == 4
    eng.loop = "eager"
    seen["n"] = 0
    with L.attempt(check), pytest.raises(RuntimeError, match="superseded"):
        eng.run(0)
    assert eng.run(0).num_levels == 30  # no check outside the block


def test_kept_replies_hold_only_their_own_rows(graph):
    v = graph.num_vertices
    block = np.arange(8 * v, dtype=np.int32).reshape(8, v)
    rows = host_rows(P.MultiBfsResult(np.arange(8, dtype=np.int32), block, block + 1, 3), 5)
    assert isinstance(rows, HostRows) and len(rows.dist) == 5  # padding dropped
    assert all(r.base is None and r.nbytes == 4 * v for r in rows.dist + rows.parent)
    with make_server(graph, watchdog_s=0.0) as srv:
        srv.pause()
        futs = [srv.query("g", s) for s in (1, 2)] + [srv.query_multi("g", [4, 5],
                                                                       collapse=False)]
        srv.resume()
        replies = [f.result(TIMEOUT) for f in futs]
        for r in replies:
            for a in (r.dist, r.parent):
                assert a.base is None and a.nbytes == 4 * v * len(r.sources)
        assert srv.tick_log()[-1]["kept_bytes"] == 4 * 2 * 4 * v
        again = srv.query("g", 2).result(TIMEOUT)
        assert again.record.status == "result_cache" and again.dist is replies[1].dist


def test_launch_counts_lose_no_update_under_threads():
    """Serve threads count launches while others read and capture: 16
    threads x 2,000 counts each, with a short switch interval, lose none,
    and a capture on one of them keeps its own out of the global count."""
    import sys

    K.reset_launches()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    records = []

    def work(capture):
        if capture:
            with K.capturing() as rec:
                for _ in range(2000):
                    K.count_launch("packed_update")
            records.append(rec)
        else:
            for _ in range(2000):
                K.count_launch("packed_update")

    try:
        threads = [threading.Thread(target=work, args=(i == 0,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert K.LAUNCHES["packed_update"] == 15 * 2000
        assert records == [{"packed_update": 2000}]
    finally:
        sys.setswitchinterval(interval)
        K.reset_launches()


def test_capture_launch_counts_stay_with_the_capturing_thread():
    K.reset_launches()
    try:
        with K.capturing() as record:
            K.count_launch("loop_control")
            t = threading.Thread(target=K.count_launch, args=("loop_control",))
            t.start()
            t.join(timeout=60)
            assert not t.is_alive()
        assert record == {"loop_control": 1}
        assert K.LAUNCHES["loop_control"] == 1  # the other thread's launch
        K.add_launches(record)
        assert K.LAUNCHES["loop_control"] == 2
    finally:
        K.reset_launches()


# ------------------------------------------------------ epochs and registry --


def test_hot_swap_creates_epoch_and_in_flight_finishes_on_old(graph):
    other = P.gnm_graph(60, 180, seed=8)
    with make_server(graph, watchdog_s=0.0) as srv:
        srv.query("g", 0).result(TIMEOUT)
        srv.pause()
        f_old = [srv.submit("g", [s]) for s in (3, 4)]
        srv.register("g", other)
        f_new = [srv.submit("g", [s]) for s in (3, 4)]
        srv.resume()
        for s, f in zip((3, 4), f_old):
            reply = f.result(TIMEOUT)
            assert reply.record.epoch == 0
            _exact(graph, s, reply)
        for s, f in zip((3, 4), f_new):
            reply = f.result(TIMEOUT)
            assert reply.record.epoch == 1
            _exact(other, s, reply)
        assert srv.metrics.count("epochs_swapped") == 1
        assert srv.metrics.count("epochs_retired") == 1
        with pytest.raises(KeyError):
            srv.registry.get_epoch("g", 0)
        assert srv.registry.epoch("g") == 1
        assert srv.registry.resident_keys() == [("g", 1, "pull")]


def test_result_cache_is_epoch_keyed(graph):
    other = P.gnm_graph(60, 180, seed=8)
    with make_server(graph, watchdog_s=0.0) as srv:
        srv.query("g", 0).result(TIMEOUT)
        srv.query("g", 0).result(TIMEOUT)
        assert srv.metrics.count("result_cache_hits") == 1
        srv.register("g", other)
        _exact(other, 0, srv.query("g", 0).result(TIMEOUT))
        assert srv.metrics.count("result_cache_hits") == 1


def test_swaps_pins_and_retirement(graph):
    reg = GraphRegistry(device="cpu")
    reg.register("g", graph)
    reg.acquire("g", "pull")
    reg.register("g", graph)  # no pins: epoch 0 released at swap time
    assert reg.resident_keys() == [] and reg.epoch("g") == 1
    with pytest.raises(KeyError):
        reg.get_epoch("g", 0)
    rec1 = reg.pin("g")
    reg.acquire("g", "pull")
    reg.register("g", graph)
    assert reg.get_epoch("g", 1) is rec1 and ("g", 1, "pull") in reg.resident_keys()
    reg.unpin(rec1)
    assert reg.resident_keys() == []
    with pytest.raises(KeyError):
        reg.get_epoch("g", 1)


def test_epochs_are_monotonic_and_late_unpin_releases_once(graph):
    retired = []
    reg = GraphRegistry(device="cpu")
    reg.add_retire_listener(lambda n, e: retired.append((n, e)))
    reg.register("g", graph)
    rec0 = reg.pin("g")
    reg.register("g", graph)
    reg.unregister("g")
    assert sorted(retired) == [("g", 0), ("g", 1)]
    assert reg.register("g", graph).epoch == 2
    with pytest.raises(KeyError):
        reg.get_epoch("g", 0)
    reg.acquire("g", "pull")
    reg.unpin(rec0)
    assert sorted(retired) == [("g", 0), ("g", 1)], "released twice"
    assert ("g", 2, "pull") in reg.resident_keys()


def test_retire_listeners_fan_out_and_detach(graph):
    a, b = [], []
    fa, fb = (lambda n, e: a.append(e)), (lambda n, e: b.append(e))
    reg = GraphRegistry(device="cpu")
    reg.add_retire_listener(fa)
    reg.add_retire_listener(fb)
    reg.register("g", graph)
    reg.register("g", graph)
    assert a == [0] and b == [0]
    reg.remove_retire_listener(fa)
    reg.register("g", graph)
    assert a == [0] and b == [0, 1]


def test_retired_epoch_upload_race_does_not_leak_residency(graph):
    reg = GraphRegistry(device="cpu")
    reg.register("g", graph)
    rec0 = reg.pin("g")
    reg.register("g", graph)
    reg.unpin(rec0)
    assert reg.resident_keys() == []
    assert reg.acquire_for(rec0, "pull") is not None
    assert ("g", 0, "pull") not in reg.resident_keys()


def test_epoch_retirement_prunes_health_state(graph):
    with make_server(graph, watchdog_s=0.0) as srv:
        srv.query("g", 0).result(TIMEOUT)
        srv.query("g", 1).result(TIMEOUT)
        rep = srv.report()["health"]
        assert any(k.split("/")[1] == "0" for k in rep["watchdog_budgets"])
        srv.register("g", graph)
        srv.query("g", 2).result(TIMEOUT)
        srv.query("g", 3).result(TIMEOUT)
        rep = srv.report()["health"]
        for section in (rep["watchdog_budgets"], rep["breaker"]):
            assert not any(k.split("/")[1] == "0" for k in section)
        assert any(k.split("/")[1] == "1" for k in rep["watchdog_budgets"])


def test_report_tolerates_concurrent_unregister(graph, monkeypatch):
    with make_server(graph, watchdog_s=0.0) as srv:
        real_names = srv.registry.names
        monkeypatch.setattr(srv.registry, "names", lambda: real_names() + ["gone"])
        rep = srv.report()
        assert rep["registry"]["graphs"] == ["g"] and rep["registry"]["epochs"] == {"g": 0}


def test_budget_eviction_happens_before_the_new_upload(graph, monkeypatch):
    import bfs_tpu_torch.models.bfs as bfs_mod

    other = P.gnm_graph(60, 150, seed=9)
    reg = GraphRegistry(device_budget_bytes=1, device="cpu")
    reg.register("a", graph)
    reg.register("b", other)
    reg.acquire("a", "pull")
    resident_at_upload = []

    class Spy(EdgeEngine):
        def __init__(self, *a, **kw):
            resident_at_upload.append(reg.resident_keys())
            super().__init__(*a, **kw)

    monkeypatch.setattr(bfs_mod, "EdgeEngine", Spy)
    reg.acquire("b", "pull")
    assert resident_at_upload == [[]], "victim still resident while the new engine shipped"


def test_budget_eviction_defers_on_pinned_epochs(graph):
    other = P.gnm_graph(60, 150, seed=9)
    reg = GraphRegistry(device_budget_bytes=1, device="cpu")
    reg.register("a", graph)
    reg.register("b", other)
    rec_a = reg.pin("a")
    reg.acquire("a", "pull")
    reg.acquire("b", "pull")
    assert reg.evictions_deferred == 1
    assert {("a", 0, "pull"), ("b", 0, "pull")} == set(reg.resident_keys())
    reg.unpin(rec_a)
    reg.acquire("b", "pull")
    assert reg.resident_keys() == [("b", 0, "pull")]


def test_register_layouts_and_prebuilt(tiny_graph_torch):
    reg = GraphRegistry(device="cpu")
    rec = reg.register("t", tiny_graph_torch)
    assert rec.num_vertices == 6 and rec.num_edges == 16
    pg1 = reg.layout("t", "pull")
    assert reg.layout("t", "pull") is pg1
    assert isinstance(reg.layout("t", "relay"), P.RelayGraph)
    assert isinstance(reg.layout("t", "push"), P.DeviceGraph)
    with pytest.raises(ValueError):
        reg.layout("t", "bogus")
    with pytest.raises(KeyError):
        reg.get("unknown")
    rec2 = reg.register("t", tiny_graph_torch)
    assert rec2.epoch == 1 and reg.get("t") is rec2 and reg.layout("t", "pull") is not pg1
    pg = P.build_pull_graph(tiny_graph_torch)
    reg.register("p", pg)
    assert reg.layout("p", "pull") is pg
    with pytest.raises(ValueError):
        reg.layout("p", "push")
    with pytest.raises(TypeError):
        reg.register("x", object())


def test_acquire_release_and_lru_eviction():
    reg = GraphRegistry(device="cpu")
    g1, g2, g3 = (P.gnm_graph(100, 250, seed=s) for s in (3, 4, 5))
    for n, g in (("a", g1), ("b", g2), ("c", g3)):
        reg.register(n, g)
        reg.acquire(n, "pull")
    assert reg.acquire("a", "pull") is reg.acquire("a", "pull")  # resident: same engine
    reg.device_budget_bytes = reg.resident_bytes()
    reg.acquire("b", "push")
    assert ("b", 0, "pull") not in reg.resident_keys()
    assert ("a", 0, "pull") in reg.resident_keys() and ("b", 0, "push") in reg.resident_keys()
    reg.release("a")
    assert ("a", 0, "pull") not in reg.resident_keys()
    reg.unregister("c")
    assert not any(k[0] == "c" for k in reg.resident_keys())
    with pytest.raises(KeyError):
        reg.get("c")
    assert reg.evictions == 3


def test_second_registry_hits_disk_cache(tmp_path, tiny_graph_torch, monkeypatch):
    cache_dir = str(tmp_path / "layout")
    m1 = ServeMetrics()
    reg1 = GraphRegistry(layout_cache=cache_dir, metrics=m1, device="cpu")
    reg1.register("g", tiny_graph_torch)
    pg1 = reg1.layout("g", "pull")
    rg1 = reg1.layout("g", "relay")
    assert m1.count("layout_disk_misses") == 2
    import bfs_tpu_torch.graph.ell as ell_mod
    import bfs_tpu_torch.graph.relay_device as rd_mod

    def poisoned(*a, **k):
        raise AssertionError("layout was rebuilt despite a warm disk cache")

    monkeypatch.setattr(ell_mod, "build_pull_graph", poisoned)
    monkeypatch.setattr(rd_mod, "build_relay_graph_device", poisoned)
    m2 = ServeMetrics()
    reg2 = GraphRegistry(layout_cache=cache_dir, metrics=m2, device="cpu")
    reg2.register("g", tiny_graph_torch)
    np.testing.assert_array_equal(reg2.layout("g", "pull").ell0, pg1.ell0)
    np.testing.assert_array_equal(reg2.layout("g", "relay").net_masks, rg1.net_masks)
    assert m2.count("layout_disk_hits") == 2
    assert reg2.layout_info()["cache"] == "hit"
    assert m2.report()["artifact_caches"]["layout_cache_hits"] >= 2


@pytest.fixture
def tiny_graph_torch():
    return P.read_sedgewick("test-sets/tinyCG.txt")


# ------------------------------------------------------------------- chaos --


def test_chaos_schedule(graph, monkeypatch):
    """The self-healing schedule in one process: permanent device faults
    open the breaker, short-circuits serve the oracle, the canary closes
    it, a hung tick degrades, an injected corrupt verdict quarantines, and
    a swap under in-flight load answers each query on its own snapshot.
    Every reply is held against the oracle."""
    other = P.gnm_graph(60, 180, seed=8)
    with make_server(graph, breaker_failures=2, breaker_cooldown_s=0.5, watchdog_s=0.4,
                     watchdog_min_s=0.05, verify_sample=1) as srv:
        _exact(graph, 0, srv.query("g", 0).result(TIMEOUT))
        monkeypatch.setenv("BFS_TPU_TORCH_FAULT", "raise:serve.batch:1")
        F.reset()
        _exact(graph, 1, srv.query("g", 1).result(TIMEOUT))
        F.reset()
        _exact(graph, 2, srv.query("g", 2).result(TIMEOUT))
        monkeypatch.delenv("BFS_TPU_TORCH_FAULT")
        F.reset()
        assert srv.metrics.count("breaker_opened") == 1
        _exact(graph, 3, srv.query("g", 3).result(TIMEOUT))  # short-circuit
        assert srv.metrics.count("breaker_short_circuits") >= 1
        time.sleep(0.6)
        assert srv.query("g", 4).result(TIMEOUT).record.status == "ok"  # canary
        monkeypatch.setenv("BFS_TPU_TORCH_FAULT", "delay:serve.batch:2.0")
        t_hung = time.monotonic()
        _exact(graph, 5, srv.query("g", 5).result(TIMEOUT))
        monkeypatch.setenv("BFS_TPU_TORCH_FAULT", "raise:serve.verify")
        F.reset()
        _exact(graph, 6, srv.query("g", 6).result(TIMEOUT))
        monkeypatch.delenv("BFS_TPU_TORCH_FAULT")
        F.reset()
        assert srv.metrics.count("watchdog_timeouts") == 1
        assert srv.metrics.count("integrity_failures") == 1
        time.sleep(0.6)
        srv.pause()
        f_old = srv.query("g", 7)
        srv.register("g", other)
        f_new = srv.query("g", 7)
        srv.resume()
        _exact(graph, 7, f_old.result(TIMEOUT))
        _exact(other, 7, f_new.result(TIMEOUT))
        time.sleep(max(0.0, t_hung + 2.3 - time.monotonic()))  # the hung attempt woke, stopped
        rep = srv.report()
        assert rep["counters"]["epochs_swapped"] == 1
        assert rep["counters"].get("abandoned_attempts", 0) == 1
