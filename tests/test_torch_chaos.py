"""The port's chaos driver (``bfs_tpu_torch.tools.chaos_run``) on the CPU:
the self-healing serve schedule at the reference smoke's size
(``tests/test_chaos_serve.py::test_chaos_serve_smoke``) under the
lock-order recorder, on pull and on relay; one traversal iteration of the
relay and of the sharded config as a subprocess, killed at a superstep
boundary and resumed bit for bit; and the modes that wait for other parts
of the port."""

import os
import random
import subprocess
import sys
import types

import pytest

from bfs_tpu_torch.analysis import runtime as rt
from bfs_tpu_torch.tools import chaos_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("engine", ["pull", "relay"])
def test_chaos_serve_smoke(engine, monkeypatch):
    """The whole schedule (breaker open, half-open and closed, hung ticks
    degraded by the watchdog, the integrity quarantine, an epoch swap with
    in-flight answers on the old snapshot) returns 0, restores the fault
    knob, and leaves a lock-order graph with edges and no cycle."""
    monkeypatch.setenv("BFS_TPU_TORCH_LOCK_ORDER", "1")
    monkeypatch.delenv("BFS_TPU_TORCH_FAULT", raising=False)
    rt.reset_lock_order()
    args = types.SimpleNamespace(scale=7, edge_factor=4, seed=3, serve_engine=engine,
                                 serve_requests=4, serve_cooldown_s=0.3, serve_delay_s=1.5,
                                 serve_tick_timeout=120.0, device="cpu")
    try:
        assert chaos_run.chaos_serve(args, random.Random(3)) == 0
        assert "BFS_TPU_TORCH_FAULT" not in os.environ
        report = rt.lock_order_report()
        assert report["cycles"] == [], report
        assert report["edges"], "no lock nesting recorded: the recorder is not wired"
        # The registry hands epochs to the server under its lock.
        assert any(e.startswith("registry._lock->") for e in report["edges"]), report
    finally:
        rt.reset_lock_order()


def test_chaos_serve_restores_a_set_fault_knob(monkeypatch):
    """A knob set before the run is put back after it, even when the
    schedule fails (a server that cannot be built)."""
    monkeypatch.setenv("BFS_TPU_TORCH_FAULT", "delay:elsewhere:0.1")
    args = types.SimpleNamespace(scale=5, edge_factor=4, seed=3, serve_engine="pull",
                                 serve_requests=1, serve_cooldown_s=0.3, serve_delay_s=1.5,
                                 serve_tick_timeout=10.0, device="meta")
    with pytest.raises(Exception):
        chaos_run.chaos_serve(args, random.Random(3))
    assert os.environ["BFS_TPU_TORCH_FAULT"] == "delay:elsewhere:0.1"


def _run(*argv, timeout=300):
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("BFS_TPU_TORCH_FAULT", None)
    return subprocess.run([sys.executable, "-m", "bfs_tpu_torch.tools.chaos_run", *argv],
                          capture_output=True, text=True, cwd=REPO, env=env, timeout=timeout)


def test_chaos_traversal_relay_resumes_bit_identical():
    """One iteration of the relay config: the first subject is killed at a
    superstep boundary, the next resumes from its epoch, and the result is
    the golden run's bit for bit."""
    proc = _run("--mode", "traversal", "--iterations", "1", "--traversal-configs", "relay",
                "--device", "cpu", "--seed", "1")
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "traversal chaos: 1/1 ok" in proc.stdout
    assert "killed at boundary" in proc.stdout
    assert "resumed from epoch" in proc.stdout and "resumed from epoch None" not in proc.stdout


def test_chaos_traversal_sharded_resumes_bit_identical():
    """One iteration of the sharded config (8 shards stacked on the CPU,
    per-shard epochs): killed at a boundary, resumed from an epoch, equal
    to the golden run, the exchange's arms and bytes included."""
    proc = _run("--mode", "traversal", "--iterations", "1", "--traversal-configs", "sharded",
                "--device", "cpu", "--seed", "1")
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "traversal chaos: 1/1 ok" in proc.stdout
    assert "killed at boundary" in proc.stdout
    assert "resumed from epoch" in proc.stdout and "resumed from epoch None" not in proc.stdout
    assert {"exchange_schedule", "exchange_bytes"} <= set(chaos_run.TRAVERSAL_DETERMINISTIC)


@pytest.mark.parametrize("argv", [
    ("--mode", "bench"),
    ("--mode", "traversal", "--iterations", "1", "--traversal-configs", "grid"),
])
def test_modes_waiting_for_other_parts_exit_2(argv):
    """The bench mode waits for the port's bench and exits 2; the grid
    traversal, which waited for the 2-D grid, now runs: killed at a random
    boundary, resumed from an epoch, both axes' arms and bytes equal to
    the golden run's."""
    proc = _run(*argv, "--device", "cpu", "--seed", "1", timeout=120)
    if "bench" in argv:
        assert proc.returncode == 2, proc.stdout[-2000:] + proc.stderr[-2000:]
        return
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "traversal chaos: 1/1 ok" in proc.stdout
    assert "killed at boundary" in proc.stdout
    assert "resumed from epoch" in proc.stdout and "resumed from epoch None" not in proc.stdout
    assert {"col_schedule", "col_bytes", "row_schedule", "row_bytes"} <= set(
        chaos_run.TRAVERSAL_DETERMINISTIC)
