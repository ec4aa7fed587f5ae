"""The 2-D grid's resumable search (``bfs_tpu_torch.parallel.grid.
bfs_grid_segmented``, ``GridEngine.run_segmented``) on the CPU.

On the reference test's graph (``rmat_graph(7, 4, seed=3)``, source 3):
segmented runs at 1x8, 2x4, 4x2 and 8x1, segments of 1, 2, 3 and longer
than the search, on the ``pull``, ``push`` and ``auto`` schedules, equal to
the fused grid search (dist, parent, ``num_levels``, the direction
schedule, both axes' arms and bytes, the occupancy), to the oracle and to
the port's 1-D mesh; the epoch (the reference's keys and dtypes, one file
per cell and a meta file); a kill at a boundary resumed on the same and on
a freshly built engine; a lost cell file; a grid of one cell; the wrong
shard count; the unpacked re-run past 62 levels; the command line's
``--config grid --mesh 2x4`` killed and resumed.  The reference's own
segmented grid cannot run on some JAX versions (their ``pcast`` raises),
so the yardsticks are the fused search, the 1-D mesh and the oracle.  All
comparisons are exact."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bfs_tpu_torch as P
from bfs_tpu_torch.parallel import grid as PG
from bfs_tpu_torch.parallel import sharded as SH
from bfs_tpu_torch.resilience import faults as F
from bfs_tpu_torch.resilience.faults import FaultInjected, corrupt_file
from bfs_tpu_torch.resilience.superstep_ckpt import CkptConfig, SuperstepCheckpointer

from bfs_tpu.graph import benes as j_benes
from bfs_tpu.parallel import grid as JG

from test_torch_sharded import CPU, REPO, _oracle, _same, mesh

pytestmark = pytest.mark.skipif(
    not j_benes.native_available(), reason="native benes router unavailable"
)

SOURCE = 3
SHAPES = [(1, 8), (2, 4), (4, 2), (8, 1)]
SHAPE_IDS = [f"{r}x{c}" for r, c in SHAPES]
_cache: dict = {}


def _graph():
    if "graph" not in _cache:
        _cache["graph"] = P.rmat_graph(7, 4, seed=3)
    return _cache["graph"]


def _layout():
    if "layout" not in _cache:
        _cache["layout"] = P.build_sharded_relay_graph(_graph(), 8, route="native")
    return _cache["layout"]


def gmesh(r: int, c: int):
    return PG.make_grid_mesh(r, c, devices=[CPU] * (r * c))


def _engine(r: int, c: int) -> PG.GridEngine:
    key = ("engine", r, c)
    if key not in _cache:
        _cache[key] = PG.GridEngine(_layout(), gmesh(r, c))
    return _cache[key]


def _golden(r: int, c: int, direction: str):
    """The port's fused grid search with its level curve."""
    key = ("golden", r, c, direction)
    if key not in _cache:
        _cache[key] = _engine(r, c).run(SOURCE, telemetry=True, direction=direction,
                                        exchange="auto")
    return _cache[key]


def _mgr(path, n: int = 8, k: int = 2, mode: str = "every") -> SuperstepCheckpointer:
    return SuperstepCheckpointer(path, {"t": 1}, cfg=CkptConfig(mode, k), shards=n)


def _same_curve(curve, want) -> None:
    assert curve["direction_schedule"] == want["direction_schedule"]
    for k in ("col_schedule", "col_bytes", "row_schedule", "row_bytes"):
        assert curve["exchange"][k] == want["exchange"][k], k
    for k in ("occupancy", "levels", "reachable", "cap", "exchange"):
        assert curve[k] == want[k], k


@pytest.fixture
def fault(monkeypatch):
    """Set ``BFS_TPU_TORCH_FAULT`` for the block of a ``with``."""
    import contextlib

    @contextlib.contextmanager
    def setting(spec):
        monkeypatch.setenv("BFS_TPU_TORCH_FAULT", spec)
        F.reset()
        try:
            yield
        finally:
            monkeypatch.delenv("BFS_TPU_TORCH_FAULT")
            F.reset()

    return setting


def _interrupt(eng, fault, path, boundary, direction="auto", n=8):
    with fault(f"raise:superstep:{boundary}"):
        with pytest.raises(FaultInjected):
            eng.run_segmented(SOURCE, ckpt=_mgr(path, n, k=1), telemetry=True,
                              direction=direction, exchange="auto")


# --------------------------------------------------------------------- parity --

@pytest.mark.parametrize("direction", ["pull", "auto", "push"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_segmented_matches_fused_oracle_and_1d(shape, direction, tmp_path):
    r, c = shape
    want, want_curve = _golden(r, c, direction)
    _oracle(_graph(), want, SOURCE)
    _same(want, SH.bfs_sharded(_layout(), SOURCE, mesh=mesh(8), engine="relay",
                               direction=direction, exchange="auto"))
    for k in (1, 2, 3, 64):
        mgr = _mgr(tmp_path / f"k{k}", k=k)
        res, curve = PG.bfs_grid_segmented(_layout(), SOURCE, mesh=gmesh(r, c), ckpt=mgr,
                                           telemetry=True, direction=direction, exchange="auto")
        _same(res, want)
        _same_curve(curve, want_curve)
        rep = mgr.report()
        assert rep["segments"] == -(-want.num_levels // k) and rep["shards"] == 8
        assert rep["resumed_from_epoch"] is None and mgr.epochs() == []


def test_segmented_without_telemetry_and_a_disabled_store(tmp_path, fault):
    eng = _engine(2, 4)
    want = eng.run(SOURCE, direction="auto", exchange="auto")
    res = eng.run_segmented(SOURCE, ckpt=_mgr(tmp_path), direction="auto", exchange="auto")
    _same(res, want)
    off = _mgr(tmp_path / "off", mode="off")
    _same(eng.run_segmented(SOURCE, ckpt=off, direction="auto"), want)
    assert off.report()["epochs_written"] == 0 and "copy_s" in eng.last_run
    assert off.report()["segments"] == -(-want.num_levels // off.interval())
    assert not (tmp_path / "off").exists()
    with fault("raise:superstep:1"):  # a disabled store still marks each boundary
        with pytest.raises(FaultInjected):
            eng.run_segmented(SOURCE, ckpt=_mgr(tmp_path / "off2", mode="off"))


def test_epoch_holds_the_reference_keys_and_dtypes(tmp_path, fault):
    """An epoch is one file per cell (its block of the packed state) and a
    meta file of the reference's keys in the reference's dtypes."""
    eng = _engine(2, 4)
    _interrupt(eng, fault, tmp_path, boundary=2)
    mgr = _mgr(tmp_path, k=1)
    assert mgr.epochs() == [1, 2]
    _, arrays, cells = mgr.load_latest()
    keys = PG.grid_segment_keys(True, True, True)
    assert set(keys) - {"pk"} <= set(arrays) and len(cells) == 8
    assert all(set(cell) == {"pk"} and cell["pk"].dtype == np.uint32
               and cell["pk"].shape == (_layout().block,) for cell in cells)
    nw = _layout().block // 32
    want = {"fw": (np.uint32, (8 * nw,)), "rc": (np.uint32, (8 * 2 * nw,)),
            "level": (np.int32, ()), "changed": (np.bool_, ()), "mu": (np.float32, ()),
            "prev": (np.bool_, ()), "occ": (np.int32, (128,)), "dirs": (np.int32, (128,)),
            "xbc": (np.int32, (128,)), "xac": (np.int32, (128,)), "xbr": (np.int32, (128,)),
            "xar": (np.int32, (128,)), "packed_flag": (np.int32, ())}
    for k, (dtype, shape) in want.items():
        assert arrays[k].dtype == dtype and arrays[k].shape == shape, k
    assert int(arrays["level"]) == 2 and bool(arrays["changed"])
    # The cells' reached views: identical within each mesh column.
    rc = arrays["rc"].reshape(2, 4, -1)
    assert np.array_equal(rc[0], rc[1]) and rc.any()
    carry = PG.grid_segment_carry(eng, SOURCE, telemetry=True, direction="auto",
                                  restore={**arrays, "pk": np.concatenate(
                                      [cell["pk"] for cell in cells])})
    assert (carry["level"], carry["changed"]) == (2, True)
    assert torch.equal(carry["rc"], torch.from_numpy(arrays["rc"].view(np.int32)))
    assert float(carry["mu"]) == float(arrays["mu"])
    fresh = PG.grid_segment_carry(eng, SOURCE, telemetry=True, direction="pull")
    assert (fresh["level"], fresh["changed"]) == (0, True)
    assert int(fresh["fw"].ne(0).sum()) == 1 and int(fresh["rc"].ne(0).sum()) == 2


# ------------------------------------------------------ kills and cell loss --

@pytest.mark.parametrize("shape", [(2, 4), (4, 2)], ids=["2x4", "4x2"])
def test_kill_resume_and_a_lost_cell_file(shape, tmp_path, fault):
    """Killed at boundary 3, then one cell's file of the newest epoch is
    lost: the loader falls back to the last complete epoch and the run
    resumes there on a freshly built engine, bit-identical (the
    reference's ``test_grid_kill_resume`` and its shard-loss twin)."""
    r, c = shape
    want, want_curve = _golden(r, c, "auto")
    _interrupt(_engine(r, c), fault, tmp_path, boundary=3)
    mgr = _mgr(tmp_path, k=1)
    eps = mgr.epochs()
    assert eps == [2, 3]
    corrupt_file(mgr._epoch_path(eps[-1], shard=5), mode="truncate")
    res, curve = PG.bfs_grid_segmented(_graph(), SOURCE, mesh=gmesh(r, c), ckpt=mgr,
                                       telemetry=True, direction="auto", exchange="auto")
    rep = mgr.report()
    assert rep["resumed_from_epoch"] == eps[-2] and rep["epochs_corrupt_skipped"] >= 1
    assert rep["fresh_fallbacks"] == 0 and mgr.epochs() == []
    _same(res, want)
    _same_curve(curve, want_curve)


@pytest.mark.parametrize("direction", ["pull", "auto", "push"])
def test_kill_resume_on_the_same_engine(direction, tmp_path, fault):
    """A run killed at boundary 2 resumes from epoch 2 on the same engine;
    only the supersteps after it run in this process."""
    eng = _engine(2, 4)
    want, want_curve = _golden(2, 4, direction)
    _interrupt(eng, fault, tmp_path, boundary=2, direction=direction)
    mgr = _mgr(tmp_path, k=1)
    res, curve = eng.run_segmented(SOURCE, ckpt=mgr, telemetry=True, direction=direction,
                                   exchange="auto")
    assert mgr.report()["resumed_from_epoch"] == 2
    assert eng.last_run["live"] == want.num_levels - 2
    _same(res, want)
    _same_curve(curve, want_curve)


def test_grid_of_one_cell_and_wrong_shard_counts(tmp_path, fault):
    """A 1x1 grid writes one file an epoch and resumes from it; a
    checkpointer of another shard count is refused by the entry point and
    the engine, before anything runs."""
    g = _graph()
    eng = PG.GridEngine(P.build_sharded_relay_graph(g, 1, route="native"), gmesh(1, 1))
    want, want_curve = eng.run(SOURCE, telemetry=True, direction="auto", exchange="auto")
    _oracle(g, want, SOURCE)
    _interrupt(eng, fault, tmp_path, boundary=2, n=1)
    mgr = _mgr(tmp_path, n=1, k=1)
    assert os.path.exists(mgr._epoch_path(2)) and not os.path.exists(mgr._meta_path(2))
    res, curve = eng.run_segmented(SOURCE, ckpt=mgr, telemetry=True, direction="auto",
                                   exchange="auto")
    assert mgr.report()["resumed_from_epoch"] == 2
    _same(res, want)
    _same_curve(curve, want_curve)
    with pytest.raises(ValueError, match="shards"):
        PG.bfs_grid_segmented(g, SOURCE, mesh=gmesh(2, 4), ckpt=_mgr(tmp_path, n=2))
    with pytest.raises(ValueError, match="shards"):
        _engine(2, 4).run_segmented(SOURCE, ckpt=_mgr(tmp_path, n=4))
    with pytest.raises(ValueError, match="shards"):
        _engine(2, 4).run_segmented(SOURCE, ckpt=SuperstepCheckpointer(
            tmp_path, {"t": 1}, cfg=CkptConfig("every", 1)))


def test_epoch_of_the_other_flavor_or_without_telemetry_starts_fresh(tmp_path, fault):
    eng = _engine(2, 4)
    want, _ = _golden(2, 4, "auto")
    with fault("raise:superstep:3"):
        with pytest.raises(FaultInjected):
            eng.run_segmented(SOURCE, ckpt=_mgr(tmp_path, k=1), direction="auto",
                              exchange="auto")
    mgr = _mgr(tmp_path, k=1)
    res, _ = eng.run_segmented(SOURCE, ckpt=mgr, telemetry=True, direction="auto",
                               exchange="auto")
    assert mgr.report()["resumed_from_epoch"] is None and mgr.counters["fresh_fallbacks"] == 1
    _same(res, want)


def test_deep_path_reruns_unpacked_segmented(tmp_path):
    """Past the packed word's 62 levels the segmented run clears the packed
    epochs and runs again unpacked, equal to the fused search."""
    g = P.path_graph(80)
    eng = PG.GridEngine(P.build_sharded_relay_graph(g, 8, route="native"), gmesh(2, 4))
    want, want_curve = eng.run(0, telemetry=True, direction="auto", exchange="auto")
    mgr = _mgr(tmp_path, k=16)
    res, curve = eng.run_segmented(0, ckpt=mgr, telemetry=True, direction="auto",
                                   exchange="auto")
    assert res.num_levels == 80 and not eng.last_run["packed"] and mgr.epochs() == []
    _same(res, want)
    _same_curve(curve, want_curve)
    d, p = P.queue_bfs(g, 0)
    np.testing.assert_array_equal(res.dist, d)


# ----------------------------------------------------------- the command line --

def test_cli_grid_round_trip(tmp_path):
    """``--config grid --mesh 2x4`` killed at boundary 2 and run again in a
    new process: the same hashes, schedule and both axes' arms and bytes
    as a run that was never killed; the reference's runner takes the same
    configs."""
    def run(ckpt_dir, out, fault=None):
        env = dict(os.environ, PYTHONPATH=REPO)
        env.pop("BFS_TPU_TORCH_FAULT", None)
        if fault:
            env["BFS_TPU_TORCH_FAULT"] = fault
        cmd = [sys.executable, "-m", "bfs_tpu_torch.resilience.superstep_ckpt", "--config",
               "grid", "--mesh", "2x4", "--device", "cpu", "--ckpt-dir", str(ckpt_dir),
               "--out", str(out), "--interval", "1"]
        return subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=120)

    golden = run(tmp_path / "g", tmp_path / "g.json")
    assert golden.returncode == 0, golden.stderr
    killed = run(tmp_path / "c", tmp_path / "k.json", fault="kill:superstep:2")
    assert killed.returncode == -9, killed.stderr
    assert not (tmp_path / "k.json").exists()
    resumed = run(tmp_path / "c", tmp_path / "r.json")
    assert resumed.returncode == 0, resumed.stderr
    g, r = (json.loads((tmp_path / f).read_text()) for f in ("g.json", "r.json"))
    for k in ("dist_hash", "parent_hash", "num_levels", "direction_schedule", "col_schedule",
              "col_bytes", "row_schedule", "row_bytes", "exchange_schedule", "exchange_bytes"):
        assert r[k] == g[k], k
    assert r["superstep_ckpt"]["resumed_from_epoch"] == 2 and r["superstep_ckpt"]["shards"] == 8
    assert any(g["row_bytes"]) and "none" not in g["col_schedule"]
    assert JG.grid_segment_keys(True, True, True) == PG.grid_segment_keys(True, True, True)
