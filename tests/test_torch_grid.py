"""The port's 2-D grid (``bfs_tpu_torch.parallel.grid``,
``bfs_tpu_torch.graph.grid_layout`` and the grid arms of
``bfs_tpu_torch.parallel.exchange``) against the JAX reference on the CPU.

The port stacks the ``r*c`` cells on one device (``devices=[cpu] * 8``).
Held here: the mesh spec, the knob and the mesh; the grid collectives; the
per-cell layout byte for byte at 1x8, 2x4, 4x2 and 8x1 and the tile
placement against the reference's; the host functions
(``grid_row_budget``, ``grid_segment_keys``, ``grid_exchange_report``) on
the same inputs; each axis's arms, words, bytes and code against the
reference's arms under its ``shard_map`` shim (replication check off, see
``test_torch_sharded.reference_unchecked``); ``bfs_grid`` at the four
shapes against the oracle, the port's 1-D mesh (results, direction
schedule, and the column axis's bytes and arms) and the reference's 1-D
mesh; the four arms bit-identical; a nonzero source with a disconnected
remainder; the packed carry's 62-level fallback; the graph shapes of the
reference's suite; ``tools/ledger_compare.py --exact`` on the grid's
per-axis curve; the reference's own ``bfs_grid``, which some JAX versions
cannot run (their ``pcast`` raises), skipped on that error alone.  All
comparisons are exact."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import bfs_tpu_torch as P
from bfs_tpu_torch import knobs
from bfs_tpu_torch.graph import grid_layout as PGL
from bfs_tpu_torch.parallel import compat as PCOMP
from bfs_tpu_torch.parallel import exchange as PX
from bfs_tpu_torch.parallel import grid as PG
from bfs_tpu_torch.parallel import sharded as SH

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

from bfs_tpu.graph import benes as j_benes
from bfs_tpu.graph import grid_layout as JGL
from bfs_tpu.graph import relay as JR
from bfs_tpu.parallel import compat as JCOMP
from bfs_tpu.parallel import exchange as JX
from bfs_tpu.parallel import grid as JG
from bfs_tpu.parallel import sharded as JS

from test_torch_sharded import CPU, _jgraph, _oracle, _same, mesh, reference_unchecked

pytestmark = pytest.mark.skipif(
    not j_benes.native_available(), reason="native benes router unavailable"
)

SOURCE = 3
SHAPES = [(1, 8), (2, 4), (4, 2), (8, 1)]
SHAPE_IDS = [f"{r}x{c}" for r, c in SHAPES]
ARMS = ("flat", "bitmap", "delta", "auto")
_cache: dict = {}


def _gnm():
    if "gnm" not in _cache:
        _cache["gnm"] = P.gnm_graph(250, 1273, seed=1)
    return _cache["gnm"]


def _srg8():
    if "srg8" not in _cache:
        _cache["srg8"] = P.build_sharded_relay_graph(_gnm(), 8, route="native")
    return _cache["srg8"]


def _jsrg8():
    if "jsrg8" not in _cache:
        _cache["jsrg8"] = JR.build_sharded_relay_graph(_jgraph(_gnm()), 8)
    return _cache["jsrg8"]


def gmesh(r: int, c: int) -> PCOMP.Mesh:
    return PG.make_grid_mesh(r, c, devices=[CPU] * (r * c))


def _oracle_queue(g, res, s) -> None:
    d, _ = P.queue_bfs(g, s)
    np.testing.assert_array_equal(res.dist, d)
    _oracle(g, res, s)


def _port_1d(direction: str, exchange: str):
    """The port's 1-D search on the same 8-shard layout, with its curve."""
    key = ("1d", direction, exchange)
    if key not in _cache:
        _cache[key] = SH.bfs_sharded(_srg8(), SOURCE, mesh=mesh(8), engine="relay", telemetry=True,
                                     direction=direction, exchange=exchange)
    return _cache[key]


# ------------------------------------------------------- mesh spec and mesh --

@pytest.mark.parametrize("spec", ["2x4", "1x8", "8", "4X2", " 3x1 ", "0x4", "2x", "grid", "x4"])
def test_parse_mesh_spec_matches_the_reference(spec):
    try:
        want = JGL.parse_mesh_spec(spec)
    except ValueError:
        with pytest.raises(ValueError):
            PGL.parse_mesh_spec(spec)
        return
    assert PGL.parse_mesh_spec(spec) == want


def test_resolve_grid_mesh_with_the_knob(monkeypatch):
    monkeypatch.setenv("BFS_TPU_TORCH_MESH", "2x4")
    assert PG.resolve_grid_mesh() == (2, 4) == JG.resolve_grid_mesh("2x4")
    monkeypatch.delenv("BFS_TPU_TORCH_MESH")
    assert PG.resolve_grid_mesh(devices=[CPU] * 8) == (1, 8)
    assert PG.resolve_grid_mesh("4x2") == (4, 2) == JG.resolve_grid_mesh("4x2")
    monkeypatch.setenv("BFS_TPU_TORCH_MESH", "3by2")
    with pytest.raises(ValueError, match="BFS_TPU_TORCH_MESH"):
        PG.resolve_grid_mesh()
    knob = knobs.KNOBS["BFS_TPU_TORCH_MESH"]
    assert (knob.type, knob.default, knob.canary, knob.affects) == ("spec", "", "3by2", frozenset())
    if not torch.cuda.is_available():
        monkeypatch.delenv("BFS_TPU_TORCH_MESH")
        with pytest.raises(RuntimeError, match="devices="):
            PG.resolve_grid_mesh()


def test_make_grid_mesh():
    with pytest.raises(ValueError, match="devices"):
        PG.make_grid_mesh(4, 4, devices=[CPU] * 8)
    with pytest.raises(ValueError, match="devices"):
        JG.make_grid_mesh(4, 4)
    m = gmesh(2, 4)
    assert m.axis_names == ("row", "col") and m.shape == {"row": 2, "col": 4}
    assert (m.size, m.device) == (8, CPU)
    assert m == gmesh(2, 4) and hash(m) == hash(gmesh(2, 4)) and m != gmesh(4, 2)
    assert m != mesh(8) and m != SH.make_mesh(graph=4, batch=2, devices=[CPU] * 8)
    with pytest.raises(ValueError, match="A12"):
        PG.make_grid_mesh(1, 2, devices=[CPU, torch.device("meta")])
    with pytest.raises(ValueError, match="make_grid_mesh"):
        PG.GridEngine(_srg8(), mesh(8))


def test_grid_collectives_on_stacked_cells():
    rng = np.random.default_rng(0)
    r, c = 2, 3
    x = torch.from_numpy(rng.integers(-50, 50, (r * c, 4, 5)).astype(np.int32))
    cells = x.reshape(r, c, 4, 5)
    assert torch.equal(PCOMP.grid_pmin(x, "row", r, c), cells.amin(0))
    assert torch.equal(PCOMP.grid_pmin(x, "col", r, c), cells.amin(1))
    assert torch.equal(PCOMP.grid_all_gather(x, "col", r, c), cells)
    assert torch.equal(PCOMP.grid_all_gather(x, "row", r, c), cells.permute(1, 0, 2, 3))
    assert torch.equal(PCOMP.grid_all_gather(x, "col", r, c, tiled=True), cells.reshape(r, c * 4, 5))
    assert torch.equal(PCOMP.grid_pmax(x, r, c), x.amax(0))
    assert torch.equal(PCOMP.grid_psum(x, r, c), x.sum(0))
    with pytest.raises(ValueError):
        PCOMP.grid_pmin(x, "graph", r, c)
    with pytest.raises(ValueError):
        PCOMP.grid_pmin(x, "row", 4, 2)


# ------------------------------------------------------------------ layouts --

@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_grid_layout_matches_the_reference(shape):
    r, c = shape
    got = PGL.build_grid_layout(_srg8(), r, c)
    want = JGL.build_grid_layout(_jsrg8(), r, c)
    assert (got.r, got.c, got.block, got.emax, got.num_cells) == (
        want.r, want.c, want.block, want.emax, want.num_cells)
    for k in ("esrc", "edst", "ekey", "indptr"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), k
    assert PGL.grid_layout_for(_srg8(), r, c) is PGL.grid_layout_for(_srg8(), r, c)
    gp = PGL.grid_tile_placement(_srg8(), r, c, builder="host")
    wp = JGL.grid_tile_placement(_jsrg8(), r, c, builder="host")
    assert gp["cells"].dtype == wp["cells"].dtype and np.array_equal(gp["cells"], wp["cells"])
    assert (gp["total_tiles"], gp["tile_rows_per_stripe"]) == (
        wp["total_tiles"], wp["tile_rows_per_stripe"])
    assert int(gp["cells"].sum()) == gp["total_tiles"]


def test_grid_layout_refusals():
    with pytest.raises(ValueError, match="4-shard"):
        PGL.build_grid_layout(_srg8(), 2, 2)
    g = _gnm()
    with pytest.raises(ValueError, match="cells"):
        PG.bfs_grid(P.build_sharded_relay_graph(g, 4, route="native"), 0, mesh=gmesh(2, 4))
    with pytest.raises(ValueError, match="out of range"):
        PG.bfs_grid(_srg8(), g.num_vertices, mesh=gmesh(2, 4))
    with pytest.raises(ValueError):
        PG.bfs_grid(_srg8(), 0, mesh=gmesh(2, 4), exchange="zip")


# ------------------------------------------------------------ host functions --

@pytest.mark.parametrize("mode", ARMS)
def test_row_budget_and_segment_keys_match_the_reference(mode):
    for div in (1, 3, 8):
        for r in (1, 2, 8):
            for kw in (1, 7, 32, 1000):
                assert PX.grid_row_budget(PX.ExchangeConfig(mode, div), r, kw) == \
                    JX.grid_row_budget(JX.ExchangeConfig(mode, div), r, kw)
    for packed in (True, False):
        for auto in (True, False):
            for tel in (True, False):
                assert PG.grid_segment_keys(packed, auto, tel) == \
                    JG.grid_segment_keys(packed, auto, tel)


@pytest.mark.parametrize("seed", range(4))
def test_grid_exchange_report_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    levels = int(rng.integers(0, 20))
    bc, br = np.zeros(128, np.int64), np.zeros(128, np.int64)
    ac, ar = np.zeros(128, np.int32), np.zeros(128, np.int32)
    r, c = [(1, 8), (2, 4), (4, 2), (8, 1)][seed]
    if c > 1:
        ac[1:levels + 1] = rng.integers(1, 4, levels)
        bc[1:levels + 1] = rng.integers(1, 10_000, levels)
    if r > 1:
        ar[1:levels + 1] = rng.integers(1, 4, levels)
        br[1:levels + 1] = rng.integers(1, 10_000, levels)
    for mode in ARMS:
        for num_levels in (None, levels, levels + 200):
            got = PX.grid_exchange_report(bc, ac, br, ar, PX.ExchangeConfig(mode, 8), 40, 12, r, c,
                                          num_levels=num_levels)
            want = JX.grid_exchange_report(bc, ac, br, ar, JX.ExchangeConfig(mode, 8), 40, 12, r,
                                           c, num_levels=num_levels)
            assert got == want


def _reference_axes(mode, r, c, cand, send, own, nw):
    """The reference's row reduce and column broadcast on the cells'
    ``cand[n, r*block]`` (uint32 sentinel) and ``send[n, nw]`` under its
    ``shard_map`` shim over the (row, col) mesh: per cell (reduced
    candidates, row bytes, row arm, stripe words, col bytes, col arm)."""
    kw = own.shape[1]
    cfg = JX.ExchangeConfig(mode, 8)
    both = (JG.GRID_ROW_AXIS, JG.GRID_COL_AXIS)

    def inner(cand_b, send_b, own_all):
        i = jax.lax.axis_index(JG.GRID_ROW_AXIS).astype(jnp.int32)
        j = jax.lax.axis_index(JG.GRID_COL_AXIS).astype(jnp.int32)
        own_row = jax.lax.dynamic_slice(own_all, (i * c, jnp.int32(0)), (c, kw))
        own_cj = jnp.take(own_all.reshape(r, c, kw), j, axis=1)
        row = JX.make_grid_row_reduce(cfg, kw, nw, r, c)
        col = JX.make_grid_col_exchange(cfg, kw, nw, r, c)
        cg, rb, ra = row(cand_b[0], own_cj)
        fw, cb, ca = col(send_b[0], own_all[i * c + j], own_row)
        return (cg[None], jnp.reshape(rb, (1,)), jnp.reshape(ra, (1,)), fw[None],
                jnp.reshape(cb, (1,)), jnp.reshape(ca, (1,)))

    with reference_unchecked():
        fn = JCOMP.shard_map(inner, mesh=JG.make_grid_mesh(r, c),
                             in_specs=(JP(both, None), JP(both, None), JP()),
                             out_specs=(JP(both),) * 6, axis_names=set(both))
        out = jax.jit(fn)(jnp.asarray(cand.view(np.uint32)), jnp.asarray(send.view(np.uint32)),
                          jnp.asarray(own))
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_each_axis_arm_matches_the_reference(shape):
    """On the layout's own-word tables, send words and candidates of a
    given density (bits and candidates only where real vertices are):
    each axis's words, bytes and arm code equal the reference's arm's under
    its shard_map, every arm's words the flat arm's.  The reference's row
    reduce replicates mesh column j's candidates on its r cells, its
    column broadcast mesh row i's stripe on its c cells."""
    r, c = shape
    srg = _srg8()
    own = SH._own_word_table(srg)
    own_t = torch.from_numpy(own.astype(np.int64))
    nw, kw, n, rb = srg.block // 32, own.shape[1], r * c, r * srg.block
    real = np.zeros((n, nw), bool)
    real[np.arange(n)[:, None], own] = True
    stripe_real = np.stack([real[[i2 * c + t % c for i2 in range(r)]] for t in range(n)])
    rng = np.random.default_rng(r)
    for density in (0.0, 0.01, 0.3):
        bits = rng.random((n, nw, 32)) < density
        words = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(2).astype(np.uint32)
        send = np.where(real, words, 0).view(np.int32)
        live = (rng.random((n, r, nw, 32)) < density) & stripe_real[..., None]
        cand = np.where(live, rng.integers(0, 250, live.shape), PX.INT32_MAX)
        cand = cand.reshape(n, rb).astype(np.int32)
        flat_cg = flat_fw = None
        for mode in ARMS:
            cfg = PX.ExchangeConfig(mode, 8)
            cg, rbytes, rarm = PX.make_grid_row_reduce(cfg, kw, nw, r, c)(torch.from_numpy(cand),
                                                                         own_t)
            fw, cbytes, carm = PX.make_grid_col_exchange(cfg, kw, nw, r, c)(
                torch.from_numpy(send), own_t)
            jcand = np.where(cand == PX.INT32_MAX, -1, cand).astype(np.int32)
            wcg, wrb, wra, wfw, wcb, wca = _reference_axes(mode, r, c, jcand, send, own, nw)
            wcg = wcg.view(np.int32)
            wcg = np.where(wcg == -1, PX.INT32_MAX, wcg)
            for t in range(n):
                np.testing.assert_array_equal(cg[t % c].numpy(), wcg[t])
                np.testing.assert_array_equal(
                    fw.view(r, -1)[t // c].numpy(), wfw[t].view(np.int32))
                assert (int(rbytes), int(rarm), int(cbytes), int(carm)) == (
                    int(wrb[t]), int(wra[t]), int(wcb[t]), int(wca[t])), (mode, density, t)
            if flat_cg is None:
                flat_cg, flat_fw = cg, fw
            assert torch.equal(cg, flat_cg) and torch.equal(fw, flat_fw)
            assert torch.equal(fw, torch.from_numpy(send).reshape(-1))


# ----------------------------------------------------------------- searches --

@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_bfs_grid_matches_the_oracle_and_the_1d_mesh(shape):
    """At every shape: the oracle, the port's 1-D mesh on the same layout
    (results, direction schedule and, where the column axis has more than
    one cell, its bytes and arms per level, which are the 1-D exchange's),
    the reference's 1-D mesh; at 1x8 the row axis ships nothing and the
    grid's total bytes are the 1-D's."""
    r, c = shape
    g = _gnm()
    res, curve = PG.bfs_grid(_srg8(), SOURCE, mesh=gmesh(r, c), telemetry=True,
                             direction="auto", exchange="auto")
    _oracle_queue(g, res, SOURCE)
    want, wcurve = _port_1d("auto", "auto")
    _same(res, want)
    assert curve["direction_schedule"] == wcurve["direction_schedule"]
    assert curve["occupancy"] == wcurve["occupancy"]
    ex, wex = curve["exchange"], wcurve["exchange"]
    assert ex["mesh"] == f"{r}x{c}" and ex["supersteps"] == wex["supersteps"]
    assert ex["axes"]["row"]["size"] == r and ex["axes"]["col"]["groups"] == r
    if c > 1:
        assert ex["col_schedule"] == wex["schedule"]
        assert ex["col_bytes"] == wex["bytes_per_level"]
    else:
        assert set(ex["col_schedule"]) == {"none"} and not any(ex["col_bytes"])
    if r == 1:
        assert set(ex["row_schedule"]) == {"none"} and not any(ex["row_bytes"])
        assert ex["total_bytes"] == wex["total_bytes"]
        assert ex["flat_total_bytes"] == wex["flat_total_bytes"]
    else:
        assert any(ex["row_bytes"]) and "none" not in ex["row_schedule"]
    assert ex["total_bytes"] == ex["col_total_bytes"] + ex["row_total_bytes"]
    if "ref1d" not in _cache:
        with reference_unchecked():
            _cache["ref1d"] = JS.bfs_sharded(_jsrg8(), SOURCE, mesh=JS.make_mesh(graph=8),
                                             engine="relay")
    _same(res, _cache["ref1d"])
    plain = PG.bfs_grid(_gnm(), SOURCE, mesh=gmesh(r, c), direction="pull", exchange="bitmap")
    _same(plain, res)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_reference_bfs_grid(shape):
    """The reference's own ``bfs_grid`` (no telemetry) against the port's
    at each shape.  Some JAX versions reject the reference's ``pcast`` of an
    already varying carry; that error alone skips."""
    r, c = shape
    try:
        want = JG.bfs_grid(_jsrg8(), SOURCE, mesh=JG.make_grid_mesh(r, c))
    except ValueError as err:
        if "Unsupported pcast" in str(err):
            pytest.skip(f"the reference's bfs_grid on this JAX: {err}")
        raise
    got = PG.bfs_grid(_srg8(), SOURCE, mesh=gmesh(r, c))
    _same(got, want)


@pytest.mark.parametrize("direction", ["pull", "push", "auto"])
def test_the_four_arms_are_bit_identical(direction):
    """Every arm gives the same results, direction schedule and occupancy
    at 2x4; the column axis's per-level bytes and arms are the 1-D arm's."""
    base = None
    for arm in ARMS:
        res, curve = PG.bfs_grid(_srg8(), SOURCE, mesh=gmesh(2, 4), telemetry=True,
                                 direction=direction, exchange=arm)
        if base is None:
            base = (res, curve)
            _oracle(_gnm(), res, SOURCE)
        _same(res, base[0])
        assert curve["direction_schedule"] == base[1]["direction_schedule"]
        assert curve["occupancy"] == base[1]["occupancy"]
        want = _port_1d(direction, arm)[1]["exchange"]
        assert curve["exchange"]["col_schedule"] == want["schedule"]
        assert curve["exchange"]["col_bytes"] == want["bytes_per_level"]
        if arm != "auto":
            assert set(curve["exchange"]["row_schedule"]) <= {arm, "bitmap"}


def test_nonzero_source_with_a_disconnected_remainder():
    g = P.gnm_graph(200, 220, seed=3)
    for r, c in SHAPES:
        res = PG.bfs_grid(g, 137, mesh=gmesh(r, c), direction="auto", exchange="auto")
        _oracle_queue(g, res, 137)
        assert (res.dist == P.INF_DIST).any()
        _same(res, SH.bfs_sharded(g, 137, mesh=mesh(8), engine="relay", direction="auto"))


def test_packed_fallback_past_62_levels():
    """80 levels overflow the 62-level packed word: the packed run stops at
    its cap and the search runs again unpacked, on every schedule."""
    g = P.path_graph(80)
    for direction in ("pull", "auto", "push"):
        eng = PG.GridEngine(P.build_sharded_relay_graph(g, 8, route="native"), gmesh(2, 4))
        res, curve = eng.run(0, telemetry=True, direction=direction, exchange="delta")
        assert res.num_levels == 80 and eng.packed and not eng.last_run["packed"]
        assert eng.last_run["issued"] >= 62 + 80
        _oracle_queue(g, res, 0)
        assert curve["exchange"]["supersteps"] == 80 and curve["cap"] == 80
        res2 = eng.run(0, max_levels=10, direction=direction)
        assert res2.num_levels == 10 and eng.last_run["packed"]


@pytest.mark.parametrize("name", ["star", "path", "rmat"])
def test_reference_suite_graph_shapes(name):
    g = {"star": lambda: P.star_graph(300), "path": lambda: P.path_graph(61),
         "rmat": lambda: P.rmat_graph(7, 4, seed=5)}[name]()
    for r, c in SHAPES:
        res = PG.bfs_grid(g, 0, mesh=gmesh(r, c), direction="auto", exchange="auto")
        _oracle_queue(g, res, 0)


def test_held_engine_keeps_its_loops_and_a_dead_superstep_changes_nothing():
    """A held GridEngine replays one loop per (carry, schedule, arm) over
    many searches; after a run has converged, a block issued again (every
    superstep dead) changes no buffer."""
    eng = PG.GridEngine(_srg8(), gmesh(2, 4))
    g = _gnm()
    for s in (0, 5, 100, SOURCE):
        _oracle(g, eng.run(s, direction="pull", exchange="auto"), s)
    assert len(eng._loops) == 1
    loop = next(iter(eng._loops.values()))
    before = [b.clone() for b in loop.buffers]
    loop.dead_replay()
    for a, b in zip(before, loop.buffers):
        assert torch.equal(a, b)
    assert eng.last_run["issued_push"] == 0 and eng.last_run["issued_pull"] == eng.last_run["issued"]
    assert eng.operand_bytes > 0


def test_grid_modules_import_no_jax():
    code = ("import sys; import bfs_tpu_torch, bfs_tpu_torch.parallel.grid, "
            "bfs_tpu_torch.graph.grid_layout, bfs_tpu_torch.parallel.exchange; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'bfs_tpu.'))"
            " or m == 'bfs_tpu']; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_ledger_compare_reads_the_grid_curve(tmp_path, capsys):
    """``tools/ledger_compare.py --exact`` diffs the grid curve's per-axis
    columns: two identical grid searches match, a row axis's byte changed
    is a mismatch named ``exchange:row_bytes``."""
    import copy
    import json

    from bfs_tpu_torch.tools import ledger_compare as LC

    _, curve = PG.bfs_grid(_srg8(), SOURCE, mesh=gmesh(2, 4), telemetry=True, direction="auto",
                           exchange="auto")
    _, again = PG.GridEngine(_srg8(), gmesh(2, 4)).run(SOURCE, telemetry=True, direction="auto",
                                                      exchange="auto")

    def doc(name, c):
        path = tmp_path / name
        path.write_text(json.dumps({"metric": "teps", "details": {
            "superstep_phases": {"phases": {"full_superstep": {"seconds": 1e-3}}},
            "exchange": c["exchange"], "direction_schedule": c["direction_schedule"]}}))
        return str(path)

    assert LC.main([doc("b.json", curve), doc("a.json", again), "--exact"]) == 0
    capsys.readouterr()
    bad = copy.deepcopy(again)
    bad["exchange"]["row_bytes"][0] += 4
    assert LC.main([doc("b.json", curve), doc("c.json", bad), "--exact"]) == 2
    assert "exchange:row_bytes" in capsys.readouterr().err
