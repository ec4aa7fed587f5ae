"""The runtime sanitizers of ``bfs_tpu_torch.analysis.runtime`` against the
reference's ``bfs_tpu.analysis.runtime``: the lock-order recorder, the
transfer guard (its levels parsed as the reference's; on the CPU the sync
mode cannot be set, so a fake mode store stands in for torch's) and the
retrace counter (a loop's capture, a serve executable's build)."""

import threading

import numpy as np
import pytest

from bfs_tpu import knobs as j_knobs
from bfs_tpu.analysis import runtime as j_rt
from bfs_tpu_torch import knobs
from bfs_tpu_torch.analysis import runtime as rt
from bfs_tpu_torch.utils import locks


@pytest.fixture
def recorder(monkeypatch):
    monkeypatch.setenv("BFS_TPU_TORCH_LOCK_ORDER", "1")
    rt.reset_lock_order()
    yield
    rt.reset_lock_order()


# ------------------------------------------------------------- lock order --

def test_nesting_records_an_edge(recorder):
    a, b = rt.make_lock("t.a"), rt.make_lock("t.b")
    with a:
        with b:
            pass
    rep = rt.lock_order_report()
    assert rep == {"edges": {"t.a->t.b": 1}, "cycles": []}
    rt.assert_lock_order_clean()


def test_ab_ba_is_a_cycle_in_both_packages(recorder, monkeypatch):
    """The same acquisition sequence in each package's recorder gives the
    same report: the AB/BA shape is a cycle, the edges counted alike."""
    monkeypatch.setenv("BFS_TPU_LOCK_ORDER", "1")
    j_rt.reset_lock_order()
    try:
        for mod in (rt, j_rt):
            a, b = mod.make_lock("t.a"), mod.make_lock("t.b")
            with a, b:
                pass

            def other():
                with b, a:
                    pass

            th = threading.Thread(target=other)
            th.start()
            th.join()
        assert rt.lock_order_report() == j_rt.lock_order_report()
        assert rt.lock_order_report()["cycles"] == [["t.a", "t.b", "t.a"]]
        with pytest.raises(rt.LockOrderError, match="t.a -> t.b -> t.a"):
            rt.assert_lock_order_clean()
    finally:
        j_rt.reset_lock_order()


def test_raise_mode_raises_at_the_acquisition(monkeypatch):
    monkeypatch.setenv("BFS_TPU_TORCH_LOCK_ORDER", "raise")
    rt.reset_lock_order()
    a, b = rt.make_lock("t.a"), rt.make_lock("t.b")
    with a, b:
        pass
    with b:
        with pytest.raises(rt.LockOrderError, match="acquired 't.a' while holding 't.b'"):
            a.acquire()
        assert not a.locked()  # refused before it was taken
    rt.reset_lock_order()


def test_rlock_reentry_records_no_self_edge(recorder):
    r, plain = rt.make_lock("t.r", "rlock"), rt.make_lock("t.p")
    with r:
        with r:
            with plain:
                pass
    edges = rt.lock_order_report()["edges"]
    assert "t.r->t.r" not in edges and set(edges) == {"t.r->t.p"}
    assert rt.lock_order_report()["cycles"] == []


def test_condition_over_a_recorded_lock(recorder):
    """The server waits on a Condition over its recorded lock: the wait's
    try-acquire probes record nothing, and notify wakes the waiter."""
    lock = rt.make_lock("t.cond")
    cond = threading.Condition(lock)
    done = []

    def waiter():
        with cond:
            cond.wait_for(lambda: done, timeout=5)

    th = threading.Thread(target=waiter)
    th.start()
    with cond:
        done.append(1)
        cond.notify_all()
    th.join(5)
    assert not th.is_alive()
    assert rt.lock_order_report() == {"edges": {}, "cycles": []}


def test_unset_knob_gives_plain_locks(monkeypatch):
    monkeypatch.delenv("BFS_TPU_TORCH_LOCK_ORDER", raising=False)
    assert type(rt.make_lock("x")) is type(threading.Lock())
    assert type(rt.make_lock("x", "rlock")) is type(threading.RLock())
    assert locks.make_lock is rt.make_lock
    with pytest.raises(ValueError, match="unknown lock kind"):
        rt.make_lock("x", "semaphore")
    monkeypatch.setenv("BFS_TPU_TORCH_LOCK_ORDER", "1")
    assert isinstance(locks.make_lock("x"), rt._OrderedLock)


@pytest.mark.parametrize("raw", ["", "0", "off", "false", "1", "on", "true", "record", "raise",
                                 "RAISE", "maybe"])
def test_lock_order_levels_parse_like_the_reference(raw):
    try:
        want = j_knobs.parse_value("BFS_TPU_LOCK_ORDER", raw)
    except ValueError:
        with pytest.raises(ValueError, match="BFS_TPU_TORCH_LOCK_ORDER"):
            knobs.parse_value("BFS_TPU_TORCH_LOCK_ORDER", raw)
        return
    assert knobs.parse_value("BFS_TPU_TORCH_LOCK_ORDER", raw) == want


# ---------------------------------------------------------- transfer guard --

#: The reference's jax levels and the torch sync-debug modes they map to.
_LEVELS = {None: None, "disallow": "error", "log": "warn", "warn": "warn", "error": "error"}


@pytest.mark.parametrize("raw", ["", "0", "off", "false", "allow", "1", "on", "true",
                                 "disallow", "log", "warn", "error", "never ever"])
def test_guard_levels_parse_like_the_reference(raw):
    try:
        want = j_knobs.parse_value("BFS_TPU_TRANSFER_GUARD", raw)
    except ValueError:
        with pytest.raises(ValueError, match="BFS_TPU_TORCH_TRANSFER_GUARD"):
            knobs.parse_value("BFS_TPU_TORCH_TRANSFER_GUARD", raw)
        return
    assert knobs.parse_value("BFS_TPU_TORCH_TRANSFER_GUARD", raw) == _LEVELS[want]


class _FakeMode:
    """torch's process-wide sync-debug mode, on a machine without a card."""

    def __init__(self):
        self.mode, self.history = 0, []

    def get(self):
        return self.mode

    def set(self, mode):
        self.history.append(mode)
        self.mode = mode


@pytest.fixture
def fake_mode(monkeypatch):
    fake = _FakeMode()
    monkeypatch.setattr(rt, "_sync_mode_api", lambda: (fake.get, fake.set))
    monkeypatch.setenv("BFS_TPU_TORCH_TRANSFER_GUARD", "1")
    return fake


def test_only_a_guard_violation_is_renamed(fake_mode):
    with pytest.raises(RuntimeError) as info:
        with rt.guarded_region("serve.device_batch/g/pull"):
            assert fake_mode.mode == "error"
            raise RuntimeError(rt.SYNC_VIOLATION)
    assert str(info.value) == f"[transfer-guard:serve.device_batch/g/pull] {rt.SYNC_VIOLATION}"
    assert fake_mode.mode == 0  # the previous mode restored

    class Oom(RuntimeError):
        pass

    err = Oom("CUDA out of memory", 7)
    with pytest.raises(Oom) as info:
        with rt.guarded_region("r"):
            raise err
    assert info.value is err and err.args == ("CUDA out of memory", 7)
    with pytest.raises(ValueError, match="^boom$"):
        with rt.guarded_region("r"):
            raise ValueError("boom")
    assert fake_mode.mode == 0


def test_regions_restore_the_mode_they_found(fake_mode, monkeypatch):
    fake_mode.mode = "warn"
    with rt.guarded_region("outer"):
        assert fake_mode.mode == "error"
        monkeypatch.setenv("BFS_TPU_TORCH_TRANSFER_GUARD", "log")
        with rt.guarded_region("inner"):
            assert fake_mode.mode == "warn"
            with rt.explicit_transfer():
                assert fake_mode.mode == 0  # an intended transfer
            assert fake_mode.mode == "warn"
        assert fake_mode.mode == "error"
    assert fake_mode.mode == "warn"
    assert fake_mode.history == ["error", "warn", 0, "warn", "error", "warn"]


def test_guard_off_or_without_a_card_is_a_plain_block(monkeypatch):
    monkeypatch.delenv("BFS_TPU_TORCH_TRANSFER_GUARD", raising=False)
    monkeypatch.setattr(rt, "_sync_mode_api", lambda: pytest.fail("the mode was touched"))
    with rt.guarded_region("off"):
        with rt.explicit_transfer():
            pass
    monkeypatch.undo()
    monkeypatch.setenv("BFS_TPU_TORCH_TRANSFER_GUARD", "1")
    assert rt._sync_mode_api() is None  # this machine has no card
    with rt.guarded_region("no card"):
        pass


def test_hot_region_decorator(fake_mode):
    @rt.hot_region(name="t.hot")
    def hot(x):
        return x, fake_mode.mode

    assert hot(3) == (3, "error")
    assert hot.__bfs_tpu_torch_hot__ == "t.hot"
    assert rt.hot_registry()["t.hot"] is hot.__wrapped__
    assert fake_mode.mode == 0


def test_serve_batch_runs_in_its_guarded_region(fake_mode):
    """A served tick's device work runs in ``serve.device_batch/<graph>/<engine>``."""
    import bfs_tpu_torch as P
    from bfs_tpu_torch.serve import BfsServer
    from bfs_tpu_torch.serve import executor as E

    seen = []
    real = E.BatchRunner._run

    def spy(self, eng, sources):
        seen.append(fake_mode.mode)
        return real(self, eng, sources)

    E.BatchRunner._run = spy
    try:
        g = P.read_sedgewick("test-sets/tinyCG.txt")
        with BfsServer(device="cpu", engine="pull") as srv:
            srv.register("tiny", g)
            reply = srv.query("tiny", 0).result(60)
    finally:
        E.BatchRunner._run = real
    assert reply.dist.tolist() == [0, 1, 1, 2, 2, 1]
    assert seen == ["error"] and fake_mode.mode == 0


# ----------------------------------------------------------------- retraces --

def test_captures_and_executable_builds_are_counted(monkeypatch):
    import torch

    import bfs_tpu_torch as P
    from bfs_tpu_torch.models import loop as L
    from bfs_tpu_torch.serve import BfsServer
    from bfs_tpu_torch.serve.executor import ExecutableCache

    rt.reset_retrace_counts()
    # A capture needs a card: the loop's capture is replaced by a stub.
    monkeypatch.setattr(L, "capture", lambda step, k: (object(), {}))
    loops = {}
    buf = (torch.zeros(4, dtype=torch.int32),)
    loop = L.cached(loops, ("multi_packed", 4), lambda: (buf, lambda: None))
    loop._capture()
    loop._capture()
    assert rt.retrace_report() == {"loop.capture/('multi_packed', 4)/4": 2}
    cache = ExecutableCache(4)
    built = []
    for _ in range(3):
        cache.get(("g", 0, "relay", 8, "auto"), lambda: built.append(1) or object())
    assert built == [1]
    assert rt.retrace_report()["serve.executable/relay/8"] == 1
    warm = rt.retrace_report()
    g = P.read_sedgewick("test-sets/tinyCG.txt")
    with BfsServer(device="cpu", engine="push") as srv:
        srv.register("tiny", g)
        for s in (0, 1, 2):
            srv.query("tiny", s).result(60)
    now = rt.retrace_report()
    assert now["serve.executable/push/1"] == 1  # one build, then hits
    assert "(+1 since warmup)" in rt.format_retrace_report(warm)
    assert "(steady)" in rt.format_retrace_report(warm)
    from bfs_tpu_torch.obs.registry import get_registry

    snap = get_registry().snapshot(retrace_baseline=warm)
    assert snap["retraces"] == now and snap["retrace_drift"] == {"serve.executable/push/1": 1}
    rt.reset_retrace_counts()
    assert rt.format_retrace_report().startswith("retraces: none recorded")


def test_traced_counts_each_call():
    rt.reset_retrace_counts()

    @rt.traced("t.build")
    def build(x):
        return np.int64(x) * 2

    assert [build(i) for i in range(3)] == [0, 2, 4]
    assert rt.retrace_report() == {"t.build": 3}
    rt.reset_retrace_counts()
