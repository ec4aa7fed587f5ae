"""The port's load generator (``bfs_tpu_torch.tools.serve_loadgen``) on
the CPU at R-MAT scale 8: classic and fleet mode exit 0 with every reply
checked, a steady hit rate of 1.0 and failovers after the induced failure;
a corrupted reply makes the run exit 1; the mix equals the reference
tool's for one seed; and ``RelayEngine.init_hot_state`` against the
reference's."""

import importlib.util
import json
import os
import types

import numpy as np
import pytest

import bfs_tpu_torch as P
from bfs_tpu_torch.serve import server as SV
from bfs_tpu_torch.tools import serve_loadgen as LG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--scale", "8", "--device", "cpu", "--requests", "60", "--concurrency", "4"]


def _run(capsys, argv) -> tuple[int, dict, str]:
    rc = LG.main(BASE + argv)
    out = capsys.readouterr()
    return rc, json.loads(out.out), out.err


def test_classic_mode_exits_0(capsys):
    rc, out, err = _run(capsys, ["--verify-sample", "2"])
    assert rc == 0, err
    assert out["mode"] == "classic" and out["wrong_answers"] == 0
    assert out["oracle_checked"] == 60 and out["steady_compile_hit_rate"] == 1.0
    assert out["integrity_failures"] == 0
    assert out["server_report"]["counters"].get("integrity_checks", 0) > 0
    assert set(out["ticks_by_bucket"]) <= {f"pull {b}" for b in (1, 2, 4, 8, 16)}
    assert out["metrics_registry"]["serve"]  # the registry's to_json
    assert out["queries_per_sec"] > 0 and out["latency_p99_ms"] >= out["latency_p50_ms"]


def test_fleet_mode_fails_over(capsys, monkeypatch):
    monkeypatch.delenv("BFS_TPU_TORCH_LABELS", raising=False)
    rc, out, err = _run(capsys, ["--replicas", "2", "--landmarks", "4", "--chaos-frac", "0.5"])
    assert rc == 0, err
    assert out["mode"] == "fleet" and out["wrong_answers"] == 0
    assert out["oracle_checked"] == 90 and out["chaos_requests"] == 30
    assert out["router_failovers"] > 0 and out["epoch_swap_seconds"] is not None
    assert out["router_rolling_registers"] == 4  # the register and the swap, 2 replicas each
    assert out["labels"]["label_builds"] > 0
    assert "BFS_TPU_TORCH_LABELS" not in os.environ  # restored


def test_a_corrupted_reply_fails_the_run(capsys, monkeypatch):
    real = SV.host_rows

    def corrupt(result, n):
        rows = real(result, n)
        rows.dist[0] = rows.dist[0].copy()
        rows.dist[0][int(rows.sources[0])] = 1  # a source at distance 1
        return rows

    monkeypatch.setattr(SV, "host_rows", corrupt)
    rc, out, err = _run(capsys, [])
    assert rc == 1 and out["wrong_answers"] > 0
    assert "WRONG:" in err


def test_failures_name_every_gate():
    ok = {"wrong": [], "wrong_answers": 0, "integrity_failures": 0}
    assert LG.failures(ok) == []
    assert LG.failures({**ok, "steady_compile_hit_rate": 0.9})[0].startswith("FAIL: steady")
    assert "integrity" in LG.failures({**ok, "integrity_failures": 1})[0]
    assert "failover" in LG.failures({**ok, "chaos_requests": 3, "router_failovers": 0})[0]
    assert len(LG.failures({**ok, "wrong": ["a"], "wrong_answers": 12})) == 2


def test_oracle_check_holds_each_mode():
    g = P.gnm_graph(60, 150, seed=5)
    truth = LG.Truth(g)
    check = LG.host_check(g)
    srcs = [3, 17, 3]
    trees = [truth(s) for s in srcs]
    tree = types.SimpleNamespace(dist=np.stack([t[0] for t in trees]),
                                 parent=np.stack([t[1] for t in trees]))
    assert LG.oracle_check(truth, check, srcs, "tree", tree) == []
    single = types.SimpleNamespace(dist=trees[1][0], parent=trees[1][1])
    assert LG.oracle_check(truth, check, [17], "single", single) == []
    coll = P.collapse_multi_source(P.MultiBfsResult(np.asarray(srcs, np.int32), tree.dist,
                                                    tree.parent, 0))
    reply = types.SimpleNamespace(dist=coll[0], parent=coll[1])
    assert LG.oracle_check(truth, check, srcs, "collapse", reply) == []
    bad = types.SimpleNamespace(dist=single.dist, parent=single.parent.copy())
    reached = np.flatnonzero((single.dist > 0) & (single.dist < P.INF_DIST))
    bad.parent[reached[0]] = reached[0]
    assert LG.oracle_check(truth, check, [17], "single", bad)
    bad_c = types.SimpleNamespace(dist=reply.dist, parent=reply.parent.copy())
    bad_c.parent[reached[0]] = reached[0]
    assert LG.oracle_check(truth, check, srcs, "collapse", bad_c)  # through check()


def test_mixes_equal_the_reference_tools():
    spec = importlib.util.spec_from_file_location(
        "ref_loadgen", os.path.join(REPO, "tools", "serve_loadgen.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    args = types.SimpleNamespace(source_pool=16, multi_frac=0.3, multi_width=4)
    want = ref.make_queries(np.random.default_rng(9), 500, 80, args)
    rng = np.random.default_rng(9)
    pool = rng.integers(0, 500, size=16)
    assert LG.make_queries(rng, pool, 80, multi_frac=0.3, multi_width=4) == want
    mix = LG.fleet_mix(np.random.default_rng(4), pool, 50, point_frac=0.6)
    assert {k for k, _, _ in mix} == {"point", "full"}
    assert all(a in pool and (k == "full" or b in pool) for k, a, b in mix)


def test_warmup_stages_every_bucket():
    from bfs_tpu_torch.serve import BfsServer

    g = P.gnm_graph(80, 240, seed=2)
    with BfsServer(device="cpu", max_batch=8, tick_s=0.002) as srv:
        srv.register("g", g)
        assert LG.warmup(srv, "g", g.num_vertices, 8) == 15
        assert [t["bucket"] for t in srv.tick_log()] == [1, 2, 4, 8]
    with BfsServer(device="cpu", max_batch=6) as srv:
        srv.register("g", g)
        assert LG.warmup(srv, "g", g.num_vertices, 6) == 13  # 1, 2, 4, then a full 6


@pytest.mark.parametrize("packed", [True, False])
def test_init_hot_state_equals_the_reference(packed):
    from bfs_tpu.graph import csr as JC
    from bfs_tpu.models.bfs import RelayEngine as JRelay

    g = P.rmat_graph(7, 4, seed=1)
    eng = P.RelayEngine(g, device="cpu")
    ref = JRelay(JC.Graph.from_directed_edges(g.num_vertices, np.stack([g.src, g.dst], 1)))
    eng.packed = ref.packed = packed
    got, want = eng.init_hot_state(5), ref.init_hot_state(5)
    kind = eng.init_packed_state(5) if packed else eng.init_state(5)
    assert type(got) is type(kind)
    for name, value in want._asdict().items():
        want_a, got_a = np.asarray(value), np.asarray(getattr(got, name))
        if want_a.ndim:  # uint32 words: int32 of the same bits in the port
            np.testing.assert_array_equal(got_a.view(want_a.dtype), want_a)
        else:  # the level and the changed flag
            assert int(got_a) == int(want_a)
