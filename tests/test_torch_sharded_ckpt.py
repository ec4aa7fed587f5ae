"""The mesh's resumable search (``bfs_tpu_torch.parallel.sharded.
bfs_sharded_segmented``, ``ShardedRelayEngine.run_segmented``) against the
JAX reference's ``bfs_sharded_segmented`` on the CPU.

On the reference test's graph (``rmat_graph(7, 4, seed=3)``, source 3):
segmented runs at 2 and 8 shards, segments of 1, 2, 3 and longer than the
search, on the gather and MXU arms and the ``pull`` and ``auto`` schedules,
equal to the fused sharded search and to the reference's segmented run
(run with its replication check off, see
``test_torch_sharded.reference_unchecked``): dist, parent, ``num_levels``,
the direction schedule, the exchange's arms and bytes, the occupancy; a
disabled store; a kill with the loss of one shard file, resumed from the
last complete epoch on a freshly built engine; an incomplete epoch; the
wrong shard count; the restore gate.  The epoch format, the reference's
epochs and the command line are in ``test_torch_sharded_epochs.py``.  All
comparisons are exact."""

import os

import pytest

import bfs_tpu_torch as P
from bfs_tpu_torch.parallel import sharded as SH
from bfs_tpu_torch.resilience import faults as F
from bfs_tpu_torch.resilience.faults import FaultInjected, corrupt_file
from bfs_tpu_torch.resilience.superstep_ckpt import CkptConfig, SuperstepCheckpointer

from bfs_tpu.graph import benes as j_benes
from bfs_tpu.graph import relay as JR
from bfs_tpu.parallel import sharded as JS
from bfs_tpu.resilience import superstep_ckpt as JCK

from test_torch_sharded import _jgraph, _oracle, _same, mesh, reference_unchecked

pytestmark = pytest.mark.skipif(
    not j_benes.native_available(), reason="native benes router unavailable"
)

SOURCE = 3
ARMS = ("gather", "mxu")
_cache: dict = {}


def _graph():
    if "graph" not in _cache:
        _cache["graph"] = P.rmat_graph(7, 4, seed=3)
    return _cache["graph"]


def _layout(n: int):
    key = ("layout", n)
    if key not in _cache:
        _cache[key] = P.build_sharded_relay_graph(_graph(), n, route="native")
    return _cache[key]


def _jlayout(n: int):
    key = ("jlayout", n)
    if key not in _cache:
        _cache[key] = JR.build_sharded_relay_graph(_jgraph(_graph()), n)
    return _cache[key]


def _engine(n: int, arm: str) -> SH.ShardedRelayEngine:
    key = ("engine", n, arm)
    if key not in _cache:
        _cache[key] = SH.ShardedRelayEngine(_layout(n), mesh(n), expansion=arm)
    return _cache[key]


def _golden(n: int, arm: str, direction: str):
    """The port's fused search with its level curve."""
    key = ("golden", n, arm, direction)
    if key not in _cache:
        _cache[key] = _engine(n, arm).run(SOURCE, telemetry=True, direction=direction,
                                          exchange="auto")
    return _cache[key]


def _mgr(path, n: int, k: int = 2, mode: str = "every") -> SuperstepCheckpointer:
    return SuperstepCheckpointer(path, {"t": 1}, cfg=CkptConfig(mode, k), shards=n)


def _same_curve(curve, want) -> None:
    assert curve["direction_schedule"] == want["direction_schedule"]
    assert curve["exchange"]["schedule"] == want["exchange"]["schedule"]
    assert curve["exchange"]["bytes_per_level"] == want["exchange"]["bytes_per_level"]
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


def _interrupt(eng, fault, path, n, boundary, direction="auto"):
    with fault(f"raise:superstep:{boundary}"):
        with pytest.raises(FaultInjected):
            eng.run_segmented(SOURCE, ckpt=_mgr(path, n, k=1), telemetry=True,
                              direction=direction, exchange="auto")


# --------------------------------------------------------------------- parity --

@pytest.mark.parametrize("direction", ["pull", "auto"])
@pytest.mark.parametrize("arm", ARMS)
@pytest.mark.parametrize("n", [2, 8])
def test_segmented_matches_fused_and_reference(n, arm, direction, tmp_path):
    g = _graph()
    want, want_curve = _golden(n, arm, direction)
    _oracle(g, want, SOURCE)
    with reference_unchecked():
        jmgr = JCK.SuperstepCheckpointer(tmp_path / "ref", {"t": 1}, cfg=JCK.CkptConfig("every", 2),
                                         shards=n)
        jres, jcurve = JS.bfs_sharded_segmented(
            _jlayout(n), SOURCE, mesh=JS.make_mesh(graph=n), ckpt=jmgr, telemetry=True,
            direction=direction, exchange="auto", expansion=arm)
    _same(want, jres)
    assert want_curve["direction_schedule"]["schedule"] == jcurve["direction_schedule"]["schedule"]
    assert want_curve["exchange"] == jcurve["exchange"]
    eng = _engine(n, arm)
    for k in (1, 2, 3, 64):
        mgr = _mgr(tmp_path / f"k{k}", n, k)
        res, curve = eng.run_segmented(SOURCE, ckpt=mgr, telemetry=True, direction=direction,
                                       exchange="auto")
        _same(res, want)
        _same_curve(curve, want_curve)
        rep = mgr.report()
        assert rep["segments"] == -(-want.num_levels // k) and mgr.epochs() == []
        assert rep["shards"] == n and rep["resumed_from_epoch"] is None
        assert eng.last_run["live"] == want.num_levels and eng.last_run["packed"]


def test_segmented_without_telemetry_and_a_disabled_store(tmp_path, fault):
    """Without telemetry the result alone; a disabled store writes nothing
    and still marks every boundary (a fault there fires)."""
    eng, (want, _) = _engine(2, "gather"), _golden(2, "gather", "auto")
    res = SP = SH.bfs_sharded_segmented(_layout(2), SOURCE, mesh=mesh(2), ckpt=_mgr(tmp_path, 2),
                                        direction="auto", exchange="auto")
    _same(res, want)
    off = _mgr(tmp_path / "off", 2, mode="off")
    _same(eng.run_segmented(SOURCE, ckpt=off, direction="auto", exchange="auto"), SP)
    assert not (tmp_path / "off").exists()
    assert off.report()["segments"] == -(-want.num_levels // off.interval())
    with fault("raise:superstep:1"):
        with pytest.raises(FaultInjected):
            eng.run_segmented(SOURCE, ckpt=_mgr(tmp_path / "off", 2, mode="off"))


# ------------------------------------------------------ kills and shard loss --

@pytest.mark.parametrize("arm", ARMS)
def test_sharded_kill_resume_and_shard_loss(arm, tmp_path, fault):
    """Killed at boundary 3, then one shard's file of the newest epoch is
    lost: the loader falls back to the last complete epoch and the run
    resumes there on a freshly built engine, bit-identical (the
    reference's ``test_sharded_kill_resume_and_shard_loss``)."""
    want, want_curve = _golden(8, arm, "auto")
    _interrupt(_engine(8, arm), fault, tmp_path, 8, boundary=3)
    mgr = _mgr(tmp_path, 8, k=1)
    eps = mgr.epochs()
    assert eps == [2, 3]
    corrupt_file(mgr._epoch_path(eps[-1], shard=5), mode="truncate")
    res, curve = SH.bfs_sharded_segmented(_graph(), SOURCE, mesh=mesh(8), ckpt=mgr, telemetry=True,
                                          direction="auto", exchange="auto", expansion=arm)
    rep = mgr.report()
    assert rep["resumed_from_epoch"] == eps[-2] and rep["epochs_corrupt_skipped"] >= 1
    assert rep["fresh_fallbacks"] == 0 and mgr.epochs() == []
    _same(res, want)
    _same_curve(curve, want_curve)


@pytest.mark.parametrize("direction", ["pull", "auto", "push"])
def test_kill_resume_on_the_same_engine(direction, tmp_path, fault):
    """A run killed at boundary 2 resumes from epoch 2 on the same engine;
    only the supersteps after it run in this process."""
    eng = _engine(2, "mxu")
    want, want_curve = eng.run(SOURCE, telemetry=True, direction=direction, exchange="auto")
    _interrupt(eng, fault, tmp_path, 2, boundary=2, direction=direction)
    mgr = _mgr(tmp_path, 2, k=1)
    res, curve = eng.run_segmented(SOURCE, ckpt=mgr, telemetry=True, direction=direction,
                                   exchange="auto")
    assert mgr.report()["resumed_from_epoch"] == 2
    assert eng.last_run["live"] == want.num_levels - 2
    _same(res, want)
    _same_curve(curve, want_curve)


def test_missing_meta_and_wrong_shard_count(tmp_path, fault):
    """An epoch without its meta file (a kill mid-epoch) is incomplete and
    skipped; a checkpointer of another shard count is refused by the
    one-shot entry point and the engine, before anything runs."""
    want, want_curve = _golden(2, "gather", "auto")
    eng = _engine(2, "gather")
    _interrupt(eng, fault, tmp_path, 2, boundary=3)
    mgr = _mgr(tmp_path, 2, k=1)
    os.remove(mgr._meta_path(3))
    res, curve = eng.run_segmented(SOURCE, ckpt=mgr, telemetry=True, direction="auto",
                                   exchange="auto")
    assert mgr.report()["resumed_from_epoch"] == 2
    _same(res, want)
    _same_curve(curve, want_curve)
    with pytest.raises(ValueError, match="shards"):
        SH.bfs_sharded_segmented(_graph(), SOURCE, mesh=mesh(8), ckpt=_mgr(tmp_path, 2))
    with pytest.raises(ValueError, match="shards"):
        eng.run_segmented(SOURCE, ckpt=_mgr(tmp_path, 8))
    with pytest.raises(ValueError, match="shards"):
        eng.run_segmented(SOURCE, ckpt=SuperstepCheckpointer(tmp_path, {"t": 1},
                                                             cfg=CkptConfig("every", 1)))


def test_epoch_of_the_other_flavor_or_without_telemetry_starts_fresh(tmp_path, fault):
    """The restore gate: an epoch of the packed carry does not feed an
    unpacked run, nor one without the accumulators a telemetry run."""
    eng = _engine(2, "gather")
    want, _ = _golden(2, "gather", "auto")
    with fault("raise:superstep:2"):
        with pytest.raises(FaultInjected):
            eng.run_segmented(SOURCE, ckpt=_mgr(tmp_path, 2, k=1), direction="auto")
    mgr = _mgr(tmp_path, 2, k=1)
    res, _ = eng.run_segmented(SOURCE, ckpt=mgr, telemetry=True, direction="auto", exchange="auto")
    rep = mgr.report()
    assert rep["resumed_from_epoch"] is None and rep["fresh_fallbacks"] == 1
    _same(res, want)
