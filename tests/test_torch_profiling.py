"""The port's measured arm selection against the JAX reference: the phase
ledger (``bfs_tpu_torch.profiling`` against ``bfs_tpu.profiling``), the
expansion probe's selection rule, ``RelayEngine``'s static gates of
``expansion="auto"``, a probed engine's results against the reference
``RelayEngine`` on both arms, the verdict memo (``cache/layout.py``) and
the serve registry's engine key.

Mirrors ``tests/test_packed_state.py::test_phase_ledger_state_bytes_halved``
and ``tests/test_expansion_mxu.py``'s knob, memo, probe and gate tests, on
R-MAT scale 7-9 graphs on the CPU, where the kernels' plain versions run:
the probe runs there only under ``BFS_TPU_TORCH_PHASE_PROBE=force``."""

import json
import os

import numpy as np
import pytest

import bfs_tpu_torch as P
from bfs_tpu_torch import profiling as PP
from bfs_tpu_torch.cache import layout as CL
from bfs_tpu_torch.models import bfs as p_bfs
from bfs_tpu_torch.serve import GraphRegistry
from bfs_tpu_torch.serve.registry import device_bytes
from bfs_tpu_torch.utils.metrics import artifact_report

from bfs_tpu import profiling as j_profiling
from bfs_tpu.graph import benes as j_benes
from bfs_tpu.graph.csr import Graph as JGraph
from bfs_tpu.models.bfs import RelayEngine as JRelayEngine

needs_native = pytest.mark.skipif(
    not j_benes.native_available(), reason="native benes router unavailable"
)

TOP_KEYS = {"packed_state", "applier", "loops", "repeats", "device", "phases",
            "sum_of_phases_seconds", "full_superstep_seconds", "telemetry_overhead_ratio",
            "mask_bytes_total", "note"}


def _jgraph(g: P.Graph) -> JGraph:
    return JGraph(g.num_vertices, g.src.copy(), g.dst.copy())


def assert_same(a, b) -> None:
    np.testing.assert_array_equal(a.dist, b.dist)
    np.testing.assert_array_equal(a.parent, b.parent)
    assert a.num_levels == b.num_levels


@pytest.fixture
def store(tmp_path, monkeypatch):
    """A cache root of the test's own, and the probe knob unset."""
    monkeypatch.setenv("BFS_TPU_TORCH_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("BFS_TPU_TORCH_PHASE_PROBE", raising=False)
    monkeypatch.delenv("BFS_TPU_TORCH_EXPANSION", raising=False)
    return tmp_path


def _arms(monkeypatch, seconds: dict) -> list:
    """Pin the probe's dense-superstep seconds per arm (a value that is an
    exception raises from that arm); returns the arms timed, in order."""
    timed = []

    def fake(eng, arm, timer, ctl):
        timed.append(arm)
        if isinstance(seconds[arm], Exception):
            raise seconds[arm]
        return seconds[arm]

    monkeypatch.setattr(PP, "_dense_arm", fake)
    return timed


# ------------------------------------------------------------ the ledger --

@pytest.mark.parametrize("vr", [32, 64, 4096, 4194592, (1 << 26) + 96])
@pytest.mark.parametrize("packed", [True, False])
def test_state_update_bytes_mirror_the_reference(vr, packed):
    assert PP.state_update_bytes(vr, packed) == j_profiling.state_update_bytes(vr, packed)


@pytest.fixture(scope="module")
def ledgers():
    """The reference's ledger of its MXU engine (every phase) and the
    port's ledgers of a gather and an MXU engine on the CPU, one graph."""
    g = P.rmat_graph(7, 8, seed=7)
    ref = j_profiling.superstep_phase_ledger(
        JRelayEngine(_jgraph(g), sparse_hybrid=False, expansion="mxu"), loops=1, repeats=1)
    gather = P.RelayEngine(g, device="cpu", sparse_hybrid=False)
    mxu = P.RelayEngine(g, device="cpu", sparse_hybrid=False, expansion="mxu")
    return g, ref, {
        "gather": (gather, PP.superstep_phase_ledger(gather, loops=1, repeats=1)),
        "mxu": (mxu, PP.superstep_phase_ledger(mxu, loops=1, repeats=1)),
    }


@needs_native
def test_ledger_schema_against_the_reference(ledgers):
    _g, ref, ours = ledgers
    assert set(ref) == TOP_KEYS
    _eng, led = ours["mxu"]
    assert set(led) == TOP_KEYS
    assert list(led["phases"]) == list(ref["phases"])  # the same names, in order
    _eng, led_g = ours["gather"]
    assert set(led_g) == TOP_KEYS
    assert set(led_g["phases"]) == set(ref["phases"]) - {"expansion"}  # no tiles held
    for led in (ours["mxu"][1], led_g):
        assert led["mask_bytes_total"] == ref["mask_bytes_total"]
        assert led["packed_state"] == ref["packed_state"]
        assert (led["applier"], led["device"]) == ("plain", "cpu")
        for phase in ("vperm", "broadcast", "net_apply"):
            for k in ("mask_bytes", "word_bytes_rw"):
                assert led["phases"][phase].get(k) == ref["phases"][phase].get(k), (phase, k)
        for k in ("flavor", "word_bytes_read", "candidate_bytes_written"):
            assert led["phases"]["rowmin"][k] == ref["phases"]["rowmin"][k]
        su, rsu = led["phases"]["state_update"], ref["phases"]["state_update"]
        for layout in ("packed", "unpacked"):
            assert su[layout]["bytes"] == rsu[layout]["bytes"]
        assert su["dist_parent_bytes_ratio"] == rsu["dist_parent_bytes_ratio"] == 2.0
        for phase in led["phases"].values():
            assert np.isfinite(phase["seconds"]) and phase["seconds"] > 0
        assert led["sum_of_phases_seconds"] == pytest.approx(sum(
            led["phases"][p]["seconds"]
            for p in ("vperm", "broadcast", "net_apply", "rowmin", "state_update")))


@needs_native
def test_ledger_reports_the_arm_the_engine_runs(ledgers):
    """Mirror of the reference's: the expansion record has both arms and
    ``seconds`` of the engine's arm; K3 and K4 report the plain arm here."""
    _g, ref, ours = ledgers
    eng, led = ours["mxu"]
    exp = led["phases"]["expansion"]
    assert exp["selected"] == "mxu" == ref["phases"]["expansion"]["selected"]
    assert set(exp["arms"]) == {"gather", "mxu"}
    assert exp["seconds"] == exp["arms"]["mxu"]
    assert exp["tiles"] == eng.adj_tiles.nt == ref["phases"]["expansion"]["tiles"]
    assert exp["selection_basis"] == eng.expansion_basis == "requested"
    for phase in ("rowmin", "state_update"):
        rec = led["phases"][phase]
        assert rec["selected"] == "plain" and set(rec["arms"]) == {"plain"}
        assert rec["seconds"] == rec["arms"]["plain"]


@needs_native
def test_ledger_leaves_the_engine_searching_as_before(ledgers):
    g, _ref, ours = ledgers
    for eng, _led in ours.values():
        for root in (0, 5):
            r = eng.run(root)
            d, p = P.canonical_bfs(g, root)
            np.testing.assert_array_equal(r.dist, d)
            np.testing.assert_array_equal(r.parent, p)


def test_profiling_main_prints_a_ledger(capsys):
    assert PP.main(["--scale", "6", "--edge-factor", "4", "--device", "cpu", "--loops", "1",
                    "--repeats", "1"]) == 0
    led = json.loads(capsys.readouterr().out)
    assert set(led) == TOP_KEYS and led["device"] == "cpu"


def test_profiling_main_needs_a_device_without_a_card(monkeypatch):
    monkeypatch.setattr(p_bfs.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PP.main(["--scale", "6", "--edge-factor", "4"])


# ---------------------------------------------------- the selection rule --

@pytest.mark.parametrize("gather,mxu,want", [
    (2e-3, 1e-3, "mxu"), (1e-3, 2e-3, "gather"), (1e-3, 1e-3, "mxu")])
def test_probe_selects_the_faster_arm(store, monkeypatch, gather, mxu, want):
    timed = _arms(monkeypatch, {"gather": gather, "mxu": mxu})
    eng = P.RelayEngine(P.rmat_graph(7, 8, seed=3), device="cpu", expansion="mxu")
    probe = PP.probe_phase_kernels(eng, loops=1, repeats=1)
    rec = probe["expansion"]
    assert timed == ["gather", "mxu"]
    assert (rec["selected"], rec["selection_basis"]) == (want, "measured")
    assert (rec["gather_seconds"], rec["mxu_seconds"]) == (gather, mxu)
    assert rec["tiles"] == eng.adj_tiles.nt and rec["frontier"].startswith("pinned dense")
    for phase in ("rowmin", "state_update"):
        assert probe[phase]["selected"] == "plain" and probe[phase]["plain_seconds"] > 0
        assert "kernel_seconds" not in probe[phase]
    assert probe["control_block"] == "live" and probe["device"] == "cpu"


def test_a_failing_mxu_arm_selects_gather(store, monkeypatch):
    _arms(monkeypatch, {"gather": 1e-3, "mxu": RuntimeError("tile fault")})
    eng = P.RelayEngine(P.rmat_graph(7, 8, seed=3), device="cpu", expansion="mxu")
    rec = PP.probe_phase_kernels(eng, loops=1, repeats=1)["expansion"]
    assert (rec["selected"], rec["selection_basis"]) == ("gather", "measured (mxu arm failed)")
    assert "tile fault" in rec["arms"]["mxu_error"]
    # an auto engine takes gather, the failure on record in its basis
    monkeypatch.setenv("BFS_TPU_TORCH_PHASE_PROBE", "force")
    auto = P.RelayEngine(P.rmat_graph(7, 8, seed=3), device="cpu")
    assert auto.expansion == "gather" and auto.adj_tiles is None and auto.mxu_operands is None
    assert auto.expansion_basis.startswith("auto -> gather: measured (mxu arm failed)")


def test_a_failing_probe_falls_back_to_gather_on_record(store, monkeypatch):
    monkeypatch.setenv("BFS_TPU_TORCH_PHASE_PROBE", "force")

    def broken(eng, **kw):
        raise RuntimeError("probe broke")

    monkeypatch.setattr(PP, "probe_phase_kernels", broken)
    eng = P.RelayEngine(P.rmat_graph(7, 8, seed=3), device="cpu")
    assert eng.expansion == "gather" and "probe broke" in eng.expansion_basis
    assert not os.path.isdir(os.path.join(str(store), "layout", "probe"))  # nothing memoized


def test_a_failed_arm_is_not_memoized(store, monkeypatch):
    """A verdict that holds a failure is not saved: the next engine over the
    layout probes again."""
    monkeypatch.setenv("BFS_TPU_TORCH_PHASE_PROBE", "force")
    timed = _arms(monkeypatch, {"gather": 1e-3, "mxu": RuntimeError("tile fault")})
    rg = P.build_relay_graph(P.rmat_graph(7, 8, seed=3))
    for _ in range(2):
        eng = P.RelayEngine(rg, device="cpu")
        assert eng.expansion == "gather" and eng.phase_probe["memo"] == "miss"
    assert timed == ["gather", "mxu"] * 2
    assert not os.path.isdir(os.path.join(str(store), "layout", "probe"))


def test_a_failing_arm_raises_on_a_card(store, monkeypatch):
    """On a card no failure is caught: the MXU arm's, or the probe's."""
    import torch

    _arms(monkeypatch, {"gather": 1e-3, "mxu": RuntimeError("tile fault")})
    eng = P.RelayEngine(P.rmat_graph(7, 8, seed=3), device="cpu", expansion="mxu")
    timer = PP._Timer(torch.device("cpu"), 1, 1)
    timer.card = True
    with pytest.raises(RuntimeError, match="tile fault"):
        PP._expansion_arms(eng, timer, PP._live_ctl(eng.device))

    def broken(e):
        raise RuntimeError("probe broke")

    eng.device = torch.device("cuda")
    with pytest.raises(RuntimeError, match="probe broke"):
        eng._probe_memoized(broken)


# ------------------------------------------------------- the static gates --

def test_expansion_knob_and_argument(store, monkeypatch):
    g = P.rmat_graph(7, 8, seed=3)
    monkeypatch.setenv("BFS_TPU_TORCH_EXPANSION", "mxu")
    eng = P.RelayEngine(g, device="cpu")
    assert eng.expansion == "mxu" and eng.adj_tiles is not None
    assert eng.expansion_basis == "forced (BFS_TPU_TORCH_EXPANSION)"
    eng = P.RelayEngine(g, device="cpu", expansion="gather")  # the argument wins
    assert (eng.expansion, eng.expansion_basis, eng.adj_tiles) == ("gather", "requested", None)
    monkeypatch.setenv("BFS_TPU_TORCH_EXPANSION", "gather")
    eng = P.RelayEngine(g, device="cpu")
    assert (eng.expansion, eng.expansion_basis) == ("gather", "forced (BFS_TPU_TORCH_EXPANSION)")
    monkeypatch.setenv("BFS_TPU_TORCH_EXPANSION", "tensor")
    with pytest.raises(ValueError, match="BFS_TPU_TORCH_EXPANSION"):
        P.RelayEngine(g, device="cpu")
    monkeypatch.setenv("BFS_TPU_TORCH_PHASE_PROBE", "always")
    monkeypatch.setenv("BFS_TPU_TORCH_EXPANSION", "auto")
    with pytest.raises(ValueError, match="BFS_TPU_TORCH_PHASE_PROBE"):
        P.RelayEngine(g, device="cpu")


def _no_tiles(monkeypatch):
    """Fail any tile build or load."""
    def refuse(*a, **k):
        raise AssertionError("a tile was built")

    monkeypatch.setattr(CL, "load_or_build_tiles", refuse)


def test_auto_gate_packed_parent_field(store, monkeypatch):
    monkeypatch.setenv("BFS_TPU_TORCH_PHASE_PROBE", "force")
    _no_tiles(monkeypatch)
    monkeypatch.setattr(p_bfs, "packed_parent_fits", lambda v: False)
    eng = P.RelayEngine(P.rmat_graph(7, 8, seed=3), device="cpu")
    assert eng.packed and eng.expansion == "gather" and eng.tile_geometry is None
    assert eng.expansion_basis.startswith("auto -> gather: V exceeds the 26-bit")


def test_auto_gate_cpu_builds_no_tile(store, monkeypatch):
    _no_tiles(monkeypatch)
    g = P.rmat_graph(7, 8, seed=3)
    eng = P.RelayEngine(g, device="cpu")
    assert (eng.expansion, eng.adj_tiles, eng.tile_geometry, eng.phase_probe) == (
        "gather", None, None, None)
    assert eng.expansion_basis.startswith("auto -> gather: cpu device")
    ref = JRelayEngine(_jgraph(g), expansion="auto")  # off a TPU: gather too, no tiles
    assert ref.expansion == "gather" and ref.adj_tiles is None
    assert_same(eng.run(3), ref.run(3))


def test_auto_gate_budget_counts_before_building(store, monkeypatch):
    monkeypatch.setenv("BFS_TPU_TORCH_PHASE_PROBE", "force")
    _no_tiles(monkeypatch)
    g = P.rmat_graph(8, 8, seed=3)
    eng = P.RelayEngine(g, device="cpu", tiles_budget_bytes=4096)
    nt = eng.tile_geometry[0]
    assert eng.expansion == "gather" and eng.adj_tiles is None and eng.phase_probe is None
    assert eng.expansion_basis.startswith(f"auto -> gather: tiles over budget ({nt} tiles")
    # the count and the bytes are the built layout's
    from bfs_tpu_torch.graph import adj_tiles as AT

    at = AT.build_adj_tiles_from_relay(eng.relay_graph)
    assert nt == at.nt and AT.tiles_nbytes(nt, at.rows, at.cols) == at.nbytes
    assert eng.tile_geometry == (at.nt, at.vtp, at.rtp)


@pytest.mark.parametrize("scale,ef", [(7, 0), (7, 8), (9, 4)])
def test_tiles_nbytes_is_the_arrays_bytes(scale, ef):
    """``tiles_nbytes`` (what ``AdjTiles.nbytes`` reports) is the bytes of
    the built layout's arrays, an empty layout's inert tile included; a key
    table of another shape is refused."""
    from bfs_tpu_torch.graph import adj_tiles as AT

    g = P.rmat_graph(scale, max(ef, 1), seed=5)
    if ef == 0:
        g = P.Graph(g.num_vertices, g.src[:0], g.dst[:0])
    at = AT.build_adj_tiles_from_relay(P.build_relay_graph(g))
    arrays = sum(t.numel() * t.element_size()
                 for t in (at.tiles, at.row_idx, at.col_id, at.sb_indptr, at.keys2d))
    assert at.nbytes == AT.tiles_nbytes(at.nt, at.rows, at.cols) == arrays
    assert (at.nt == 0) == (ef == 0) and at.ntp == max(at.nt, 1)
    with pytest.raises(ValueError, match="keys2d"):
        AT.build_adj_tiles_host(np.zeros(1, np.int64), np.zeros(1, np.int64), rows=256,
                                cols=256, keys2d=AT.keys_from_new2old(np.arange(128), 128))


def test_tile_count_memo_lives_with_its_layout():
    import gc

    from bfs_tpu_torch.graph import adj_tiles as AT

    rg = P.build_relay_graph(P.rmat_graph(7, 8, seed=3))
    nt = AT.count_tiles_from_relay(rg)
    assert AT._TILE_COUNTS[id(rg)] == nt == AT.build_adj_tiles_from_relay(rg).nt
    assert AT.count_tiles_from_relay(rg) == nt
    key = id(rg)
    del rg
    gc.collect()
    assert key not in AT._TILE_COUNTS


def test_forced_mxu_over_budget_raises(store):
    with pytest.raises(ValueError, match="budget"):
        P.RelayEngine(P.rmat_graph(8, 8, seed=3), device="cpu", expansion="mxu",
                      tiles_budget_bytes=4096)


# ----------------------------------------------------- the probed engine --

@needs_native
@pytest.mark.parametrize("arm", ["gather", "mxu"])
def test_probed_engine_equals_the_reference(store, monkeypatch, arm):
    """Under ``force`` on the CPU, an ``auto`` engine that the probe sends
    to either arm searches bit for bit as the reference ``RelayEngine``."""
    monkeypatch.setenv("BFS_TPU_TORCH_PHASE_PROBE", "force")
    other = {"gather": "mxu", "mxu": "gather"}[arm]
    _arms(monkeypatch, {arm: 1e-3, other: 2e-3})
    g = P.rmat_graph(9, 8, seed=11)
    eng = P.RelayEngine(g, device="cpu")
    assert eng.expansion == arm and eng.expansion_requested == "auto"
    assert eng.expansion_basis.startswith(f"auto -> {arm}: measured")
    assert eng.phase_probe["memo"] == "miss" and eng.expansion_probe["selected"] == arm
    assert (eng.mxu_operands is not None) == (arm == "mxu")
    ref = JRelayEngine(_jgraph(g))
    for root in (0, 77, int(np.argmax(np.bincount(g.src, minlength=g.num_vertices)))):
        assert_same(eng.run(root), ref.run(root))
    sources = np.array([0, 3, 77, 200], dtype=np.int32)
    got, want = eng.run_multi(sources), ref.run_multi(sources)
    np.testing.assert_array_equal(got.dist, want.dist)
    np.testing.assert_array_equal(got.parent, want.parent)


@needs_native
def test_probed_engine_in_stream_mode_keeps_the_tiles_on_the_host(store, monkeypatch):
    monkeypatch.setenv("BFS_TPU_TORCH_PHASE_PROBE", "force")
    _arms(monkeypatch, {"mxu": 1e-3, "gather": 2e-3})
    g = P.rmat_graph(8, 8, seed=3)
    rg = P.build_relay_graph(g)
    ref = JRelayEngine(_jgraph(g)).run(5)
    for memo in ("miss", "hit"):  # a hit builds the tiles straight into the host store
        eng = P.RelayEngine(rg, device="cpu", tiles_mode="stream")
        assert eng.phase_probe["memo"] == memo
        assert eng.expansion == "mxu" and eng.adj_tiles is None and eng.mxu_operands is None
        assert eng.stream_store is not None
        assert_same(eng.run(5), ref)


# --------------------------------------------------------------- the memo --

def test_probe_verdict_memo_round_trip(store, monkeypatch, tmp_path):
    eng = P.RelayEngine(P.rmat_graph(7, 8, seed=3), device="cpu")
    eng.tile_geometry = (9, 16384, 256)
    key = CL.probe_verdict_key(eng)
    assert key.startswith("probe_") and CL.probe_verdict_key(eng) == key
    assert CL.load_probe_verdict(key) is None
    before = artifact_report()
    CL.save_probe_verdict(key, {"expansion": {"selected": "mxu"}})
    assert CL.load_probe_verdict(key) == {"expansion": {"selected": "mxu"}}
    after = artifact_report()
    for counter in ("phase_probe_memo_writes", "phase_probe_memo_hits"):
        assert after.get(counter, 0) == before.get(counter, 0) + 1
    path = os.path.join(str(store), "layout", "probe", f"{key}.json")
    assert os.path.isfile(path)
    # a file under another key is dropped, and so is a corrupt one
    with open(path) as f:
        doc = json.load(f)
    doc["key"] = "probe_other"
    with open(path, "w") as f:
        json.dump(doc, f)
    assert CL.load_probe_verdict(key) is None and not os.path.exists(path)
    CL.save_probe_verdict(key, {"x": 1})
    with open(path, "w") as f:
        f.write("{broken")
    assert CL.load_probe_verdict(key) is None and not os.path.exists(path)


def test_probe_verdict_key_sensitivity(store, monkeypatch, tmp_path):
    eng = P.RelayEngine(P.rmat_graph(7, 8, seed=3), device="cpu")
    eng.tile_geometry = (9, 16384, 256)
    key = CL.probe_verdict_key(eng)
    # a byte of a source the probe times (an absolute path joins as itself)
    src = tmp_path / "kernel.cu"
    src.write_bytes(b"__global__ void k() {}\n")
    monkeypatch.setattr(CL, "_PROBE_SOURCES", CL._PROBE_SOURCES + (str(src),))
    with_src = CL.probe_verdict_key(eng)
    assert with_src != key
    src.write_bytes(b"__global__ void k() {;}\n")
    assert CL.probe_verdict_key(eng) not in (key, with_src)
    monkeypatch.setattr(CL, "_PROBE_SOURCES", CL._PROBE_SOURCES[:-1])
    assert CL.probe_verdict_key(eng) == key
    # every source of the probe is on the list and exists
    pkg = os.path.dirname(os.path.abspath(P.__file__))
    for rel in CL._PROBE_SOURCES:
        assert os.path.isfile(os.path.join(pkg, rel)), rel
    # the device's name
    from bfs_tpu_torch.utils import timing

    name = timing.device_name
    monkeypatch.setattr(timing, "device_name", lambda device: "NVIDIA H100 80GB HBM3")
    assert CL.probe_verdict_key(eng) != key
    monkeypatch.setattr(timing, "device_name", name)
    assert CL.probe_verdict_key(eng) == key
    # a probe knob
    monkeypatch.setenv("BFS_TPU_TORCH_PHASE_PROBE", "force")
    assert CL.probe_verdict_key(eng) != key
    monkeypatch.delenv("BFS_TPU_TORCH_PHASE_PROBE")
    # the tile geometry, and the carry
    eng.tile_geometry = (10, 16384, 256)
    assert CL.probe_verdict_key(eng) != key
    eng.tile_geometry = (9, 16384, 256)
    eng.packed = not eng.packed
    assert CL.probe_verdict_key(eng) != key


def test_second_engine_hits_the_memo(store, monkeypatch):
    monkeypatch.setenv("BFS_TPU_TORCH_PHASE_PROBE", "force")
    calls = []
    real = PP.probe_phase_kernels

    def counting(eng, **kw):
        calls.append(1)
        return real(eng, loops=1, repeats=1)

    monkeypatch.setattr(PP, "probe_phase_kernels", counting)
    _arms(monkeypatch, {"gather": 2e-3, "mxu": 1e-3})
    g = P.rmat_graph(8, 8, seed=3)
    rg = P.build_relay_graph(g)
    e1 = P.RelayEngine(rg, device="cpu")
    e2 = P.RelayEngine(rg, device="cpu")
    assert len(calls) == 1, "a second engine over the same layout probed again"
    assert (e1.phase_probe["memo"], e2.phase_probe["memo"]) == ("miss", "hit")
    assert e1.expansion == e2.expansion == "mxu"
    assert e2.expansion_basis.endswith("probe memo hit)")
    assert e2.probe_s == 0.0 and e2.adj_tiles.nt == e1.adj_tiles.nt
    assert_same(e1.run(2), e2.run(2))
    # a gather verdict read back builds no tile at all
    _no_tiles(monkeypatch)
    CL.save_probe_verdict(CL.probe_verdict_key(e2), {
        "expansion": {"selected": "gather", "selection_basis": "measured",
                      "gather_seconds": 1e-3, "mxu_seconds": 2e-3}})
    e3 = P.RelayEngine(rg, device="cpu")
    assert (e3.expansion, e3.adj_tiles, e3.phase_probe["memo"]) == ("gather", None, "hit")
    assert len(calls) == 1


# ------------------------------------------------- the serve registry's key --

def test_registry_builds_a_new_engine_when_the_expansion_knob_flips(store, monkeypatch):
    reg = GraphRegistry(device="cpu")
    reg.register("g", P.rmat_graph(8, 8, seed=3))
    gather = reg.acquire("g", "relay")
    assert gather.expansion == "gather" and reg.acquire("g", "relay") is gather
    monkeypatch.setenv("BFS_TPU_TORCH_EXPANSION", "mxu")
    mxu = reg.acquire("g", "relay")
    assert mxu is not gather and mxu.expansion == "mxu"
    # the resident bytes count the tiles of the engine that keeps the MXU arm
    tiles = sum(t.numel() * t.element_size() for t in mxu.mxu_operands[:3])
    assert device_bytes(mxu) >= device_bytes(gather) + tiles
    monkeypatch.delenv("BFS_TPU_TORCH_EXPANSION")
    assert reg.acquire("g", "relay") is gather
