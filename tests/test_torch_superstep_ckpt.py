"""Superstep checkpoints of the port (``bfs_tpu_torch.resilience.superstep_ckpt``)
against the reference's (``bfs_tpu.resilience.superstep_ckpt``) on the CPU.

On the reference test's own graph (``rmat_graph(8, 4, seed=3)``, source 3)
and on ``path_graph(100)`` (past the packed carry's 62 levels): the knob's
spellings and errors, the Young/Daly interval, the plain segment runner
against one full loop, ``RelayEngine.run_segmented`` against the
reference's ``run_segmented`` and the port's fused run (dist, parent,
``num_levels``, direction schedule, occupancy; dense and the hybrid's
``auto`` and ``push``, both arms, packed and unpacked, segments of 1, 2, 3
and longer than the search), epoch clean-up and a disabled store, kill and
resume, the corruption matrix, per-shard epochs, ``run_multi_segmented`` on
push and pull with resume, epochs written by ``bfs_tpu`` resumed by the
port, the serve tier's ``SegmentedBatchRunner`` with a hung-call drill, and
one SIGKILL round trip through the command-line runner."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bfs_tpu_torch as P
from bfs_tpu_torch import knobs
from bfs_tpu_torch.models import loop as L
from bfs_tpu_torch.ops import relay as R
from bfs_tpu_torch.resilience import config_key
from bfs_tpu_torch.resilience import faults as F
from bfs_tpu_torch.resilience.faults import FaultInjected, corrupt_file
from bfs_tpu_torch.resilience.superstep_ckpt import (
    NOT_PORTED,
    CkptConfig,
    SuperstepCheckpointer,
    _runner_main,
    daly_interval,
    resolve_ckpt,
    restore_arrays,
    run_multi_segmented,
)
from bfs_tpu_torch.utils.metrics import ServeMetrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = 3
SOURCES = [3, 10, 17, 24]
#: (direction mode, sparse_hybrid) of each schedule: the dense superstep in
#: blocks, and the hybrid's two switching modes.
SCHEDULES = {"dense": ("auto", False), "auto": ("auto", True), "push": ("push", True)}
FLAVORS = [(s, arm) for arm in ("gather", "mxu") for s in SCHEDULES]


@pytest.fixture(scope="module")
def graph():
    return P.rmat_graph(8, 4, seed=3)


def _jgraph(g):
    from bfs_tpu.graph.csr import Graph as JGraph

    return JGraph(num_vertices=g.num_vertices, src=np.asarray(g.src), dst=np.asarray(g.dst))


def _engine(g, schedule, arm):
    mode, hybrid = SCHEDULES[schedule]
    return P.RelayEngine(g, device="cpu", sparse_hybrid=hybrid, direction=mode, expansion=arm)


@pytest.fixture(scope="module")
def engines(graph):
    return {fl: _engine(graph, *fl) for fl in FLAVORS}


@pytest.fixture(scope="module")
def golden(engines):
    """The port's fused result and level curve per flavor."""
    return {fl: (eng.run(SOURCE), eng.run_level_curve(SOURCE)) for fl, eng in engines.items()}


@pytest.fixture(scope="module")
def reference(graph):
    """The reference's fused result and its segmented run (every:2, with
    telemetry) per flavor."""
    from bfs_tpu.models.bfs import RelayEngine as JRelay
    from bfs_tpu.resilience import superstep_ckpt as JS

    jg, out = _jgraph(graph), {}
    import tempfile

    for schedule, arm in FLAVORS:
        mode, hybrid = SCHEDULES[schedule]
        jeng = JRelay(jg, sparse_hybrid=hybrid, direction=mode, expansion=arm)
        with tempfile.TemporaryDirectory() as d:
            mgr = JS.SuperstepCheckpointer(d, {"t": 1}, cfg=JS.CkptConfig("every", 2))
            out[(schedule, arm)] = (jeng.run(SOURCE), jeng.run_segmented(SOURCE, ckpt=mgr, telemetry=True))
    return out


def _mgr(path, k=2, config=None, mode="every", **kw):
    return SuperstepCheckpointer(path, config if config is not None else {"t": 1},
                                 cfg=CkptConfig(mode, k), **kw)


def _same(res, want) -> None:
    np.testing.assert_array_equal(res.dist, want.dist)
    np.testing.assert_array_equal(res.parent, want.parent)
    assert res.num_levels == want.num_levels


def _same_curve(curve, want) -> None:
    assert curve["direction_schedule"]["schedule"] == want["direction_schedule"]["schedule"]
    assert curve["direction_schedule"] == want["direction_schedule"]
    assert curve["occupancy"] == want["occupancy"]


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


# ---------------------------------------------------------------- the knobs --

def test_resolve_ckpt_default_off(monkeypatch):
    monkeypatch.delenv("BFS_TPU_TORCH_CKPT", raising=False)
    cfg = resolve_ckpt()
    assert cfg == CkptConfig("off") and not cfg.enabled
    assert knobs.get("BFS_TPU_TORCH_CKPT") == "off"
    assert knobs.get("BFS_TPU_TORCH_CKPT_MTBF_S") == 600.0


@pytest.mark.parametrize("spec", ["every:5", "every", " every:1 ", "auto", "off"])
def test_resolve_ckpt_spellings_match_the_reference(spec, monkeypatch):
    from bfs_tpu.resilience.superstep_ckpt import resolve_ckpt as j_resolve

    cfg, ref = resolve_ckpt(spec), j_resolve(spec)
    assert (cfg.mode, cfg.k, cfg.enabled, cfg.key()) == (ref.mode, ref.k, ref.enabled, ref.key())
    monkeypatch.setenv("BFS_TPU_TORCH_CKPT", spec)
    assert resolve_ckpt() == cfg


@pytest.mark.parametrize("spec", ["always", "every:0", "every:-2", "auto:3", "off:1"])
def test_resolve_ckpt_errors(spec, monkeypatch):
    from bfs_tpu.resilience.superstep_ckpt import resolve_ckpt as j_resolve

    with pytest.raises(ValueError):
        j_resolve(spec)
    with pytest.raises(ValueError):
        resolve_ckpt(spec)
    monkeypatch.setenv("BFS_TPU_TORCH_CKPT", spec)
    with pytest.raises(ValueError, match="BFS_TPU_TORCH_CKPT"):
        knobs.get("BFS_TPU_TORCH_CKPT")
    monkeypatch.setenv("BFS_TPU_TORCH_CKPT_MTBF_S", "-3")
    with pytest.raises(ValueError, match="BFS_TPU_TORCH_CKPT_MTBF_S"):
        knobs.get("BFS_TPU_TORCH_CKPT_MTBF_S")


def test_daly_interval_matches_the_reference():
    from bfs_tpu.resilience.superstep_ckpt import daly_interval as j_daly

    for sup in (1e-9, 1e-4, 0.01, 0.1, 10.0, 1e9):
        for snap in (1e-7, 1e-4, 0.01, 1.0, 10):
            for mtbf in (1, 60, 600, 6000, 1e9):
                assert daly_interval(sup, snap, mtbf) == j_daly(sup, snap, mtbf)
    # Cheaper snapshots (or a flakier environment) checkpoint more often.
    assert daly_interval(0.1, 1e-4, 600) < daly_interval(0.1, 1.0, 600)
    assert daly_interval(0.1, 0.01, 60) < daly_interval(0.1, 0.01, 6000)
    assert daly_interval(10.0, 0.01, 600) <= daly_interval(0.01, 0.01, 600)
    assert daly_interval(1e9, 1e-6, 1) == 1
    assert daly_interval(1e-9, 10, 1e9) == 4096


def test_auto_interval_rederived_from_measurements(tmp_path):
    mgr = _mgr(tmp_path, mode="auto", mtbf_s=600)
    assert mgr.interval() == 8  # before any measurement
    mgr.save_epoch(1, {"x": np.zeros(4, np.int32)})
    mgr.note_segment(1, 0.5)
    assert mgr.interval() == daly_interval(mgr._superstep_s, mgr._snapshot_s, 600)
    mgr.note_segment(2, 0.1)
    assert mgr._superstep_s == pytest.approx(0.5 * (0.5 + 0.05))
    assert mgr.interval() == daly_interval(mgr._superstep_s, mgr._snapshot_s, 600)
    rep = mgr.report()
    assert rep["mode"] == "auto" and rep["segments"] == 2 and rep["epochs_written"] == 1
    assert rep["snapshot_bytes"] == 16
    # every:<k> never moves.
    forced = _mgr(tmp_path / "f", k=3)
    forced.note_segment(3, 0.3)
    assert forced.interval() == 3


def test_config_key_matches_the_reference():
    from bfs_tpu.resilience.journal import config_key as j_key

    for cfg in ({"t": 1}, {"b": [1, 2], "a": "x"}, {"runner": "relay", "scale": 8, "seed": 3}):
        assert config_key(cfg) == j_key(cfg)


# ------------------------------------------------ the plain segment runner --

@pytest.mark.parametrize("packed", [True, False])
def test_plain_segment_runner_matches_one_full_loop(engines, packed):
    """Segments of any size back to back equal one full loop, on the plain
    segment runner and on the eager loop's segments."""
    eng = engines[("dense", "gather")]
    rg = eng.relay_graph
    sn = int(rg.old2new[SOURCE])
    init = R.init_packed_relay_state if packed else R.init_relay_state
    step = eng.superstep_packed if packed else eng.superstep
    run = R.relay_segment_words
    full = run(init(rg.vr, sn), step, cap=rg.vr, seg_end=rg.vr)
    want, stats = L.eager(init(rg.vr, sn), step, rg.vr)
    assert full.level == stats.level
    for k in (1, 2, 3):
        st = init(rg.vr, sn)
        ends = []
        while R.segment_live(st, rg.vr, rg.vr):
            st = run(st, step, cap=rg.vr, seg_end=st.level + k)
            ends.append(st.level)
        assert ends == sorted(set(ends)) and all(b - a <= k for a, b in zip([0] + ends, ends))
        ev, level, live = init(rg.vr, sn), 0, 0
        while True:
            ev, seg = L.eager(ev, step, level + k, level=level)
            level, live = seg.level, live + seg.live
            if not seg.changed or level >= rg.vr:
                break
        assert st.level == level == full.level and live == full.level
        words = 2 if packed else 3
        for a, b, c in zip(st[:words], full[:words], ev[:words]):
            assert torch.equal(a, b) and torch.equal(a, c)


def test_segment_live_is_the_fused_predicate_with_the_bound():
    st = R.PackedRelayState(None, None, 4, torch.tensor(True))
    assert R.segment_live(st, 10, 5)
    assert not R.segment_live(st, 10, 4)
    assert not R.segment_live(st, 4, 9)
    assert not R.segment_live(st._replace(changed=torch.tensor(False)), 10, 9)


# ----------------------------------------------- run_segmented, both packages --

@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("k", [1, 2, 3, 64])
@pytest.mark.parametrize("flavor", FLAVORS, ids=["-".join(f) for f in FLAVORS])
def test_run_segmented_matches_fused_and_reference(engines, golden, reference, tmp_path,
                                                   flavor, k, packed):
    eng = engines[flavor]
    want, want_curve = golden[flavor]
    jwant, (jres, jcurve) = reference[flavor]
    _same(want, jwant)
    _same(jres, jwant)
    eng.packed = packed
    try:
        mgr = _mgr(tmp_path, k=k)
        res, curve = eng.run_segmented(SOURCE, ckpt=mgr, telemetry=True)
    finally:
        eng.packed = True
    _same(res, want)
    _same(res, jres)
    _same_curve(curve, want_curve)
    _same_curve(curve, jcurve)
    rep = mgr.report()
    assert rep["epochs_written"] == rep["segments"] == -(-want.num_levels // k)
    assert mgr.epochs() == []  # a finished traversal clears its epochs
    run = eng.last_run
    assert run["level"] == run["live"] == want.num_levels and not run["changed"]
    assert run["issued_push"] + run["issued_pull"] == run["issued"]
    assert run["issued_push"] == curve["direction_schedule"]["push_supersteps"]
    if flavor[0] != "dense":  # the switch loop: one superstep at a time
        assert run["issued"] == run["live"]


@pytest.mark.parametrize("flavor", [("dense", "gather"), ("auto", "gather"), ("push", "mxu")],
                         ids=["dense-gather", "auto-gather", "push-mxu"])
def test_run_segmented_past_the_packed_cap(flavor, tmp_path):
    """path_graph(100): the packed run stops at its cap, the store is
    cleared and the search runs again unpacked, equal to the fused run and
    the reference's."""
    from bfs_tpu.models.bfs import RelayEngine as JRelay

    g = P.path_graph(100)
    eng = _engine(g, *flavor)
    want, want_curve = eng.run(0), eng.run_level_curve(0)
    mode, hybrid = SCHEDULES[flavor[0]]
    _same(want, JRelay(_jgraph(g), sparse_hybrid=hybrid, direction=mode, expansion=flavor[1]).run(0))
    mgr = _mgr(tmp_path, k=16)
    res, curve = eng.run_segmented(0, ckpt=mgr, telemetry=True)
    _same(res, want)
    _same_curve(curve, want_curve)
    assert res.num_levels == 100 and mgr.epochs() == []
    # 62 packed levels in 4 segments, then 100 unpacked in 7.
    assert mgr.report()["segments"] == 4 + 7
    assert eng.last_run["live"] == 62 + 100


def test_run_segmented_without_telemetry_and_disabled_store(engines, golden, tmp_path):
    for flavor in (("dense", "gather"), ("auto", "gather")):
        eng, (want, _) = engines[flavor], golden[flavor]
        mgr = _mgr(tmp_path / "off", mode="off")
        _same(eng.run_segmented(SOURCE, ckpt=mgr), want)
        assert not (tmp_path / "off").exists()  # nothing touched the disk
        assert mgr.report()["segments"] == -(-want.num_levels // 8)
        mgr = _mgr(tmp_path / "on", k=2)
        _same(eng.run_segmented(SOURCE, ckpt=mgr), want)
        assert mgr.report()["epochs_written"] >= 2 and mgr.epochs() == []


def test_fused_run_after_segments_is_unchanged(engines, golden, tmp_path):
    """The segments leave the loops (CAP in the control block) ready for a
    fused run, and the reverse."""
    for flavor in (("dense", "gather"), ("auto", "mxu")):
        eng, (want, want_curve) = engines[flavor], golden[flavor]
        eng.run_segmented(SOURCE, ckpt=_mgr(tmp_path, k=1), telemetry=True)
        _same(eng.run(SOURCE), want)
        assert eng.run_level_curve(SOURCE) == want_curve
        _same(eng.run_segmented(SOURCE, ckpt=_mgr(tmp_path, k=3)), want)


# ---------------------------------------------------------- kill and resume --

def _interrupt(eng, fault, path, boundary, k=1, config=None, telemetry=True):
    with fault(f"raise:superstep:{boundary}"):
        with pytest.raises(FaultInjected):
            eng.run_segmented(SOURCE, ckpt=_mgr(path, k=k, config=config), telemetry=telemetry)


@pytest.mark.parametrize("flavor", [("dense", "gather"), ("auto", "gather"), ("push", "mxu"),
                                    ("auto", "mxu")],
                         ids=["dense-gather", "auto-gather", "push-mxu", "auto-mxu"])
def test_kill_resume_bit_identical(engines, golden, tmp_path, fault, flavor):
    eng, (want, want_curve) = engines[flavor], golden[flavor]
    _interrupt(eng, fault, tmp_path, boundary=2)
    mgr = _mgr(tmp_path, k=1)
    assert mgr.epochs() == [1, 2]
    res, curve = eng.run_segmented(SOURCE, ckpt=mgr, telemetry=True)
    assert mgr.report()["resumed_from_epoch"] == 2
    _same(res, want)
    _same_curve(curve, want_curve)
    # Only the supersteps after the epoch ran in this process.
    assert eng.last_run["live"] == want.num_levels - 2


@pytest.mark.parametrize("mode", ["truncate", "flip"])
def test_corrupt_newest_epoch_falls_back_to_the_previous(engines, golden, tmp_path, fault, mode):
    eng, (want, want_curve) = engines[("auto", "gather")], golden[("auto", "gather")]
    _interrupt(eng, fault, tmp_path, boundary=3)
    mgr = _mgr(tmp_path, k=1)
    eps = mgr.epochs()
    assert len(eps) == 2  # the retention window
    corrupt_file(mgr._epoch_path(eps[-1]), mode=mode)
    res, curve = eng.run_segmented(SOURCE, ckpt=mgr, telemetry=True)
    rep = mgr.report()
    assert rep["resumed_from_epoch"] == eps[-2] and rep["epochs_corrupt_skipped"] >= 1
    assert rep["fresh_fallbacks"] == 0
    _same(res, want)
    _same_curve(curve, want_curve)


def test_all_epochs_corrupt_fall_back_to_a_fresh_run(engines, golden, tmp_path, fault):
    eng, (want, want_curve) = engines[("dense", "gather")], golden[("dense", "gather")]
    _interrupt(eng, fault, tmp_path, boundary=3)
    mgr = _mgr(tmp_path, k=1)
    for ep in mgr.epochs():
        corrupt_file(mgr._epoch_path(ep), mode="flip")
    res, curve = eng.run_segmented(SOURCE, ckpt=mgr, telemetry=True)
    rep = mgr.report()
    assert rep["resumed_from_epoch"] is None
    assert rep["fresh_fallbacks"] == 1 and rep["epochs_corrupt_skipped"] >= 2
    _same(res, want)
    _same_curve(curve, want_curve)


def test_epoch_missing_carry_keys_falls_back_fresh_and_counts(engines, golden, tmp_path, fault):
    """An epoch of a run without telemetry lacks ``occ``/``dirs``: a resume
    with telemetry starts fresh, counted; one without telemetry resumes."""
    eng, (want, want_curve) = engines[("auto", "gather")], golden[("auto", "gather")]
    _interrupt(eng, fault, tmp_path, boundary=2, telemetry=False)
    mgr = _mgr(tmp_path, k=1)
    res, curve = eng.run_segmented(SOURCE, ckpt=mgr, telemetry=True)
    assert mgr.resumed_from_epoch is None and mgr.report()["fresh_fallbacks"] == 1
    _same(res, want)
    _same_curve(curve, want_curve)
    _interrupt(eng, fault, tmp_path, boundary=2, telemetry=False)
    mgr = _mgr(tmp_path, k=1)
    _same(eng.run_segmented(SOURCE, ckpt=mgr), want)
    assert mgr.report()["resumed_from_epoch"] == 2


def test_epoch_of_the_other_carry_flavor_is_not_resumed(tmp_path):
    mgr = _mgr(tmp_path)
    mgr.save_epoch(2, {"pk": np.zeros(4, np.uint32), "packed_flag": np.int32(1)})
    assert restore_arrays(mgr, False) == (None, None)
    assert mgr.resumed_from_epoch is None and mgr.counters["fresh_fallbacks"] == 1
    arrays, shards = restore_arrays(mgr, True, require=("pk",))
    assert shards is None and mgr.resumed_from_epoch == 2 and set(arrays) == {"pk", "packed_flag"}
    assert restore_arrays(mgr, True, require_any=((("a", "b"), ("pk", "c")),)) == (None, None)
    arrays, _ = restore_arrays(mgr, True, require_any=((("a",), ("pk", "packed_flag")),))
    assert arrays is not None


def test_foreign_config_epoch_is_skipped(engines, golden, tmp_path, fault):
    eng, (want, want_curve) = engines[("auto", "gather")], golden[("auto", "gather")]
    _interrupt(eng, fault, tmp_path, boundary=2, config={"other": "run"})
    other = _mgr(tmp_path, k=1, config={"other": "run"})
    mine = _mgr(tmp_path, k=1, config={"mine": "run"})
    for ep in other.epochs():
        os.rename(other._epoch_path(ep), mine._epoch_path(ep))
    assert mine.load_latest() is None
    assert mine.counters["epochs_corrupt_skipped"] >= 1 and mine.counters["fresh_fallbacks"] == 1
    res, curve = eng.run_segmented(SOURCE, ckpt=_mgr(tmp_path, k=2, config={"mine": "run"}),
                                   telemetry=True)
    _same(res, want)
    _same_curve(curve, want_curve)


def test_superstep_fault_family(monkeypatch, tmp_path):
    assert F.fault_spec("kill:superstep:3") == ("kill", "superstep", 3)
    assert F.fault_spec("raise:superstep") == ("raise", "superstep", 1)
    assert F.fault_spec("raise:superstep:0") == ("raise", "superstep:0", 1)
    monkeypatch.setenv("BFS_TPU_TORCH_FAULT", "raise:superstep:3")
    F.reset()
    F.fault_point("superstep:4")
    F.fault_point("superstep:8")
    F.fault_point("unrelated")
    with pytest.raises(FaultInjected):
        F.fault_point("superstep:12")
    # The boundary is marked by a disabled store too.
    monkeypatch.setenv("BFS_TPU_TORCH_FAULT", "raise:superstep")
    F.reset()
    with pytest.raises(FaultInjected):
        _mgr(tmp_path, mode="off").save_epoch(1, {})
    assert list(tmp_path.iterdir()) == []
    F.reset()


def test_per_shard_epochs_and_shard_loss(tmp_path):
    """The per-shard store (host code the sharded runs call): an epoch is
    complete only with its meta and every shard; a lost shard falls back to
    the last complete epoch, a missing meta is an incomplete epoch, and a
    wrong shard count is skipped."""
    mgr = _mgr(tmp_path, shards=3)

    def shard(s, ep):
        return {"x": np.full(4, 10 * ep + s, np.int32)}

    for ep in (1, 2, 3):
        mgr.save_epoch(ep, {"level": np.int32(ep)}, [shard(s, ep) for s in range(3)])
    assert mgr.epochs() == [2, 3]  # pruned to the retention window
    assert mgr.snapshot_bytes == 3 * 16 + 4
    with pytest.raises(ValueError, match="shard"):
        mgr.save_epoch(4, {}, [shard(0, 4)])
    corrupt_file(mgr._epoch_path(3, shard=1), mode="truncate")
    ep, arrays, shards = mgr.load_latest()
    assert ep == 2 and int(arrays["level"]) == 2
    assert [int(sa["x"][0]) for sa in shards] == [20, 21, 22]
    assert mgr.counters["epochs_corrupt_skipped"] == 1
    os.remove(mgr._meta_path(2))  # the meta is written last: incomplete
    assert mgr.load_latest() is None and mgr.counters["fresh_fallbacks"] == 1
    two = _mgr(tmp_path / "two", shards=2)
    two.save_epoch(1, {}, [shard(0, 1), shard(1, 1)])
    assert _mgr(tmp_path / "two", shards=2).load_latest()[0] == 1
    wrong = _mgr(tmp_path / "two", shards=3)
    wrong.stem = two.stem
    assert wrong.load_latest() is None and wrong.counters["epochs_corrupt_skipped"] == 1
    mgr.clear()
    assert mgr.epochs() == []


# ----------------------------------------------------------- multi-source --

@pytest.mark.parametrize("engine", ["push", "pull"])
def test_multi_segmented_matches_the_reference_and_resumes(graph, tmp_path, fault, engine):
    from bfs_tpu.models.multisource import bfs_multi as j_multi
    from bfs_tpu.resilience import superstep_ckpt as JS

    ref = j_multi(_jgraph(graph), SOURCES, engine=engine)
    jres = JS.run_multi_segmented(_jgraph(graph), SOURCES, engine=engine,
                                  ckpt=JS.SuperstepCheckpointer(tmp_path / "j", {"t": 1},
                                                                cfg=JS.CkptConfig("every", 2)))
    _same(jres, ref)
    eng = P.EdgeEngine(graph, engine=engine, device="cpu")
    _same(eng.run_multi(SOURCES), ref)
    for k in (1, 2, 3, 64):
        mgr = _mgr(tmp_path / f"k{k}", k=k)
        res = run_multi_segmented(eng, SOURCES, ckpt=mgr, engine=engine)
        _same(res, ref)
        assert mgr.report()["segments"] == -(-ref.num_levels // k) and mgr.epochs() == []
        assert eng.last_run["live"] == ref.num_levels
    with fault("raise:superstep:2"):
        with pytest.raises(FaultInjected):
            run_multi_segmented(eng, SOURCES, ckpt=_mgr(tmp_path / "b", k=1), engine=engine)
    mgr = _mgr(tmp_path / "b", k=1)
    _same(run_multi_segmented(eng, SOURCES, ckpt=mgr, engine=engine), ref)
    assert mgr.report()["resumed_from_epoch"] == 2
    assert eng.last_run["live"] == ref.num_levels - 2
    with pytest.raises(ValueError, match="EdgeEngine"):
        run_multi_segmented(eng, SOURCES, ckpt=mgr, engine="push" if engine == "pull" else "pull")


def test_multi_segmented_eager_loop_and_packed_cap(tmp_path):
    g = P.path_graph(100)
    eng = P.EdgeEngine(g, engine="push", device="cpu")
    want = eng.run_multi([0, 50, 99])
    for loop in ("eager", "blocks"):
        eng.loop = loop
        mgr = _mgr(tmp_path / loop, k=16)
        _same(run_multi_segmented(eng, [0, 50, 99], ckpt=mgr, engine="push"), want)
        assert mgr.report()["segments"] == 4 + 7  # 62 packed levels, then 100 unpacked
    eng.loop = "blocks"


# ------------------------------------------------- epochs written by bfs_tpu --

def _reference_interrupt(engine_or_run, path, boundary=2):
    from bfs_tpu.resilience import faults as JF
    from bfs_tpu.resilience.faults import FaultInjected as JFault

    os.environ["BFS_TPU_FAULT"] = f"raise:superstep:{boundary}"
    JF.reset()
    try:
        with pytest.raises(JFault):
            engine_or_run()
    finally:
        os.environ.pop("BFS_TPU_FAULT", None)
        JF.reset()


@pytest.mark.parametrize("schedule", ["dense", "auto", "push"])
def test_reference_relay_epoch_resumes_in_the_port(graph, engines, golden, tmp_path, schedule):
    """An epoch of ``bfs_tpu``'s ``run_segmented`` (killed at boundary 2)
    resumes in the port to the fused result; on ``auto`` the reference's
    ``mu`` and ``prev`` give the next body by one decision on restore."""
    from bfs_tpu.models.bfs import RelayEngine as JRelay
    from bfs_tpu.resilience import superstep_ckpt as JS

    mode, hybrid = SCHEDULES[schedule]
    jeng = JRelay(_jgraph(graph), sparse_hybrid=hybrid, direction=mode)
    jmgr = JS.SuperstepCheckpointer(tmp_path, {"t": 1}, cfg=JS.CkptConfig("every", 1))
    _reference_interrupt(lambda: jeng.run_segmented(SOURCE, ckpt=jmgr, telemetry=True), tmp_path)
    eng, (want, want_curve) = engines[(schedule, "gather")], golden[(schedule, "gather")]
    mgr = _mgr(tmp_path, k=1)
    assert mgr.epochs() == [1, 2]
    res, curve = eng.run_segmented(SOURCE, ckpt=mgr, telemetry=True)
    assert mgr.report()["resumed_from_epoch"] == 2 and mgr.report()["fresh_fallbacks"] == 0
    _same(res, want)
    _same_curve(curve, want_curve)


@pytest.mark.parametrize("engine", ["push", "pull"])
def test_reference_multi_epoch_resumes_in_the_port(graph, tmp_path, engine):
    from bfs_tpu.models.multisource import bfs_multi as j_multi
    from bfs_tpu.resilience import superstep_ckpt as JS

    jg = _jgraph(graph)
    jmgr = JS.SuperstepCheckpointer(tmp_path, {"t": 1}, cfg=JS.CkptConfig("every", 1))
    _reference_interrupt(lambda: JS.run_multi_segmented(jg, SOURCES, ckpt=jmgr, engine=engine),
                         tmp_path)
    mgr = _mgr(tmp_path, k=1)
    res = run_multi_segmented(graph, SOURCES, ckpt=mgr, engine=engine, device="cpu")
    assert mgr.report()["resumed_from_epoch"] == 2
    _same(res, j_multi(jg, SOURCES, engine=engine))


def test_port_epoch_keys_and_dtypes_are_the_references(engines, tmp_path, fault):
    """The port writes the reference's file names, ``meta_*`` keys and
    dtypes (uint32 words), plus its own decision words on ``auto``."""
    eng = engines[("auto", "gather")]
    _interrupt(eng, fault, tmp_path, boundary=1)
    mgr = _mgr(tmp_path, k=1)
    path = mgr._epoch_path(1)
    assert os.path.basename(path) == f"ckpt_{config_key({'t': 1})}.epoch000001.npz"
    with np.load(path) as z:
        got = {k: z[k] for k in z.files}
    assert set(got) == {"pk", "fw", "level", "changed", "dstate", "use_pull", "occ", "dirs",
                        "packed_flag", "meta_config", "meta_superstep", "meta_shards"}
    assert got["pk"].dtype == got["fw"].dtype == np.uint32
    assert int(got["level"]) == 1 and int(got["packed_flag"]) == 1 and int(got["meta_shards"]) == 1
    assert str(got["meta_config"]) == mgr.key and got["dstate"].dtype == np.float32


# -------------------------------------------------------------------- serve --

def test_serve_runner_is_segmented_only_when_enabled(graph, monkeypatch):
    from bfs_tpu.models.multisource import bfs_multi as j_multi
    from bfs_tpu_torch.serve import GraphRegistry, SegmentedBatchRunner, build_batch_runner

    reg = GraphRegistry(device="cpu", metrics=ServeMetrics())
    reg.register("g", graph)
    sources = np.asarray(SOURCES, np.int32)
    ref = j_multi(_jgraph(graph), sources, engine="pull")
    monkeypatch.delenv("BFS_TPU_TORCH_CKPT", raising=False)
    off = build_batch_runner(reg, "g", "pull", 4)
    assert not isinstance(off, SegmentedBatchRunner)
    monkeypatch.setenv("BFS_TPU_TORCH_CKPT", "every:2")
    on = build_batch_runner(reg, "g", "pull", 4)
    assert isinstance(on, SegmentedBatchRunner) and on.resumable and on.interval == 2
    assert not isinstance(build_batch_runner(reg, "g", "relay", 4), SegmentedBatchRunner)
    for engine in ("pull", "push"):
        runner = build_batch_runner(reg, "g", engine, 4)
        res = runner(sources)
        _same(res, ref)
        assert runner.ckpt_progress() is None  # finished: the snapshot is dropped
        assert runner.last_run["live"] == ref.num_levels
    _same(off(sources), ref)
    assert reg.metrics.count("ckpt_segments") == 2 * -(-ref.num_levels // 2)


def test_serve_runner_resumes_from_its_progress_and_across_an_eviction(graph, monkeypatch):
    """A later attempt on the same sources resumes from the snapshot; the
    snapshot restores into a new engine after an eviction; an abandoned
    attempt never replaces the progress."""
    from bfs_tpu_torch.serve import AbandonedAttempt, GraphRegistry, build_batch_runner

    monkeypatch.setenv("BFS_TPU_TORCH_CKPT", "every:2")
    reg = GraphRegistry(device="cpu", metrics=ServeMetrics())
    reg.register("g", graph)
    sources = np.asarray(SOURCES, np.int32)
    runner = build_batch_runner(reg, "g", "push", 4)
    want = P.bfs_multi(graph, sources, engine="push", device="cpu")
    monkeypatch.setenv("BFS_TPU_TORCH_FAULT", "raise:serve.segment:2")
    F.reset()
    with pytest.raises(FaultInjected):
        runner(sources)
    monkeypatch.delenv("BFS_TPU_TORCH_FAULT")
    F.reset()
    assert runner.ckpt_progress() == 4
    reg.release("g")  # the engine is evicted: the next segment ships it again
    stale = runner.begin()
    _same(runner(sources), want)
    assert reg.metrics.count("ckpt_resumes") == 1
    assert runner.last_run["live"] == want.num_levels - 4
    with pytest.raises(AbandonedAttempt):
        runner(sources, ticket=stale)
    assert runner.ckpt_progress() is None


def test_serve_hung_call_resumes_from_checkpoint(monkeypatch):
    """A device tick wedged at every segment boundary (the watchdog's
    ``HungCallError``) resumes from the newest snapshot on each retry: the
    tick completes on the device (status ok) although every attempt but the
    last wedges, each advancing one segment.  Margins for a loaded run: the
    watchdog (1 s) is hundreds of times one segment of this graph, and the
    delay (3 s) three watchdogs."""
    import time

    from bfs_tpu_torch.serve import BfsServer

    monkeypatch.setenv("BFS_TPU_TORCH_CKPT", "every:4")
    g = P.path_graph(12)
    F.reset()
    with BfsServer(device="cpu", engine="pull", max_batch=4, tick_s=0.0, watchdog_s=1.0,
                   watchdog_min_s=0.5, watchdog_compile_floor_s=120.0) as server:
        server.register("g", g)
        assert server.submit("g", [0]).result(timeout=120).record.status == "ok"
        monkeypatch.setenv("BFS_TPU_TORCH_FAULT", "delay:serve.segment:3.0")
        t0 = time.monotonic()
        reply = server.submit("g", [1]).result(timeout=120)
        elapsed = time.monotonic() - t0
        monkeypatch.delenv("BFS_TPU_TORCH_FAULT")
        assert reply.record.status == "ok"
        np.testing.assert_array_equal(reply.dist, P.canonical_bfs(g, 1)[0])
        np.testing.assert_array_equal(reply.parent, P.canonical_bfs(g, 1)[1])
        counters = server.report()["counters"]
        # 11 levels in segments of 4: two wedged boundaries, then the end;
        # every timeout was followed by a resume that made progress.
        assert 1 <= counters.get("watchdog_timeouts", 0) <= 2
        assert counters.get("ckpt_hung_resumes", 0) == counters["watchdog_timeouts"]
        assert counters.get("ckpt_resumes", 0) >= 1
        assert elapsed < 60
    F.reset()


# ------------------------------------------------------- the command line --

def test_cli_rejects_the_configs_it_does_not_port(tmp_path, capsys):
    """Every ``--config`` of the reference's runner is ported (the grid
    last): ``NOT_PORTED`` is empty and the runner's choices are the
    reference's; an unknown config is refused by the parser."""
    import argparse

    from bfs_tpu.resilience import superstep_ckpt as JCK

    def choices(main) -> set:
        seen = {}
        orig = argparse.ArgumentParser.parse_args

        def grab(parser, args=None, namespace=None):
            seen.update({a.dest: set(a.choices) for a in parser._actions if a.choices})
            raise SystemExit(0)

        argparse.ArgumentParser.parse_args = grab
        try:
            with pytest.raises(SystemExit):
                main(["--config", "relay"])
        finally:
            argparse.ArgumentParser.parse_args = orig
        return seen["config"]

    assert NOT_PORTED == {}
    assert choices(_runner_main) == choices(JCK._runner_main)
    with pytest.raises(SystemExit):
        _runner_main(["--config", "bench", "--ckpt-dir", str(tmp_path),
                      "--out", str(tmp_path / "o.json")])
    assert "invalid choice" in capsys.readouterr().err


def test_cli_sigkill_round_trip(tmp_path):
    """One real SIGKILL at boundary 2 through the command-line runner, then
    a resume in a new process: the same hashes and schedule as a run that
    was never killed."""
    def run(ckpt_dir, out, fault=None):
        env = dict(os.environ, PYTHONPATH=REPO)
        env.pop("BFS_TPU_TORCH_FAULT", None)
        if fault:
            env["BFS_TPU_TORCH_FAULT"] = fault
        cmd = [sys.executable, "-m", "bfs_tpu_torch.resilience.superstep_ckpt", "--config",
               "relay", "--device", "cpu", "--ckpt-dir", str(ckpt_dir), "--out", str(out)]
        return subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=120)

    killed = run(tmp_path / "c", tmp_path / "k.json", fault="kill:superstep:2")
    assert killed.returncode == -9, killed.stderr
    assert not (tmp_path / "k.json").exists()
    resumed = run(tmp_path / "c", tmp_path / "r.json")
    assert resumed.returncode == 0, resumed.stderr
    doc = json.loads((tmp_path / "r.json").read_text())
    assert doc["superstep_ckpt"]["resumed_from_epoch"] == 4  # two segments of 2
    eng = P.RelayEngine(P.rmat_graph(8, 4, seed=3), device="cpu", sparse_hybrid=True,
                        direction="auto")
    res, curve = eng.run_segmented(SOURCE, ckpt=_mgr(tmp_path / "g", k=2), telemetry=True)
    from bfs_tpu_torch.resilience.superstep_ckpt import _hash

    assert (doc["dist_hash"], doc["parent_hash"], doc["num_levels"]) == (
        _hash(res.dist), _hash(res.parent), res.num_levels)
    assert doc["direction_schedule"] == curve["direction_schedule"]
    assert os.listdir(tmp_path / "c") == []
