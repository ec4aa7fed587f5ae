"""The port's metric exports, span journal helpers and observability CLI
against ``bfs_tpu.obs``: ``prometheus_text`` and ``render_curve_ascii``
give the reference's strings for the same input, the registry's and
``ServeMetrics``' ``to_json``, the spans' knob, flush and export, and the
``trace``/``curve`` subcommands write the reference CLI's documents."""

import json

import pytest

from bfs_tpu.obs import registry as JR
from bfs_tpu.obs import telemetry as JT
from bfs_tpu.obs.__main__ import main as ref_obs_main
from bfs_tpu.resilience.journal import RunJournal as RefJournal
from bfs_tpu.utils import metrics as JM
from bfs_tpu_torch.obs import registry as R
from bfs_tpu_torch.obs import spans as S
from bfs_tpu_torch.obs import telemetry as T
from bfs_tpu_torch.obs.__main__ import main as obs_main
from bfs_tpu_torch.resilience.journal import RunJournal
from bfs_tpu_torch.utils import metrics as M

SNAPSHOTS = [
    {},
    {"counters": {"graph_evictions": 3, "watchdog_timeouts": 0}, "ok": True, "off": False},
    {"serve": [{"latency_p99_ms": 12.5, "compile_hit_rate": None, "queries": 40,
                "counters": {"result-cache hits": 7, "x.y/z": 1.5e-9}},
               "a string", True, 2],
     "spans": {"layout.build": {"count": 2, "total_s": 0.25}},
     "nested": {"__odd__": {"": 4, "deep": [[1, 2], {"k": -3}]}},
     "dup": {"a_b": 1}, "dup_a": {"b": 2}},
]


@pytest.mark.parametrize("snap", SNAPSHOTS, ids=["empty", "flat", "nested"])
def test_prometheus_text_equals_the_reference(snap):
    got = R.prometheus_text(snap)
    assert got == JR.prometheus_text(snap)
    lines = got.strip().splitlines()  # an empty snapshot is one empty line
    assert len(lines) % 2 == 0
    for head, sample in zip(lines[::2], lines[1::2]):
        name, value = sample.split(" ")
        assert head == f"# TYPE {name} gauge" and name.startswith("bfs_tpu_")
        float(value)


CURVES = [
    {},
    {"occupancy": [0, 0, 0]},
    {"occupancy": [1, 5, 1234567, 20, 0, 3], "levels": 6, "reachable": 1234596},
    {"occupancy": [1] + [2] * 127, "levels": 200, "truncated": True, "cap": 62,
     "cap_proximity": 1.0},
]


@pytest.mark.parametrize("curve", CURVES, ids=["empty", "zeros", "typical", "truncated"])
@pytest.mark.parametrize("width", [50, 7])
def test_render_curve_ascii_equals_the_reference(curve, width):
    assert T.render_curve_ascii(curve, width=width) == JT.render_curve_ascii(curve, width=width)


def test_registry_exports():
    reg = R.MetricsRegistry()
    reg.counter("graph_evictions", 2)
    metrics = M.ServeMetrics()
    reg.register_serve(metrics)
    metrics.bump("compile_hits", 3)
    doc = json.loads(reg.to_json())
    assert doc["counters"] == {"graph_evictions": 2}
    assert set(doc) == {"counters", "artifact_caches", "retraces", "spans", "serve"}
    assert doc["serve"][0]["compile_hit_rate"] == 1.0
    assert reg.to_prometheus() == R.prometheus_text(reg.snapshot())
    assert "bfs_tpu_counters_graph_evictions 2" in reg.to_prometheus().splitlines()
    assert R.get_registry() is R.get_registry()


def test_serve_metrics_to_json_equals_the_reference():
    port, ref = M.ServeMetrics(), JM.ServeMetrics()
    for i, status in enumerate(("ok", "ok", "result_cache", "timeout", "oracle")):
        for mod, m in ((M, port), (JM, ref)):
            m.record_query(mod.QueryRecord(status=status, batch_size=4 * (i % 2), total_s=0.01 * i,
                                           queue_wait_s=0.001 * i), ts=float(i))
            m.bump("compile_hits" if i % 2 else "compile_misses")
    got, want = json.loads(port.to_json()), json.loads(ref.to_json())
    got.pop("artifact_caches"), want.pop("artifact_caches")  # process counters of each package
    assert got == want
    assert port.to_json() == json.dumps(port.report(), indent=2, sort_keys=True)


def test_spans_knob_flush_and_export(tmp_path, monkeypatch):
    S.drain_events()
    monkeypatch.setenv("BFS_TPU_TORCH_SPANS", "0")
    assert not S.spans_enabled()
    with S.span("off"):
        S.instant("off.marker")
    assert S.snapshot_events() == []
    monkeypatch.setenv("BFS_TPU_TORCH_SPANS", "2")
    with pytest.raises(ValueError, match="BFS_TPU_TORCH_SPANS"):
        S.spans_enabled()
    monkeypatch.delenv("BFS_TPU_TORCH_SPANS")
    assert S.spans_enabled()
    outer = S.span("outer", phase="run")
    outer.__enter__()
    with S.span("inner"):
        pass
    assert S.flush_open_spans("sigterm") == 1  # outer, still open
    assert S.flush_open_spans() == 0
    events = S.snapshot_events()
    assert [e["name"] for e in events] == ["inner", "outer"]
    assert events[1]["args"] == {"phase": "run", "flushed": "sigterm"}
    outer.__exit__(None, None, None)  # already flushed: nothing more
    path = S.export_chrome_trace(str(tmp_path / "t" / "trace.json"))
    assert json.load(open(path)) == S.chrome_trace()
    assert len(S.drain_events()) == 2


def _journal(path: str, mod) -> None:
    S.drain_events()
    jr = mod(path, {"bench": "cli"})
    with S.span("bench.repeat"):
        pass
    S.instant("cache.evict")
    jr.put("spans:0", {"events": S.drain_events()})
    jr.put("level_curve", {"level_curve": {
        "occupancy": [1, 2], "levels": 2, "reachable": 3, "cap": 62, "cap_proximity": 2 / 62,
    }})
    jr.close()


@pytest.mark.parametrize("writer", [RunJournal, RefJournal], ids=["port", "ref"])
def test_obs_cli_trace_and_curve_equal_the_reference(tmp_path, capsys, writer):
    path = str(tmp_path / "run.jsonl")
    _journal(path, writer)
    docs = []
    for main, name in ((obs_main, "port"), (ref_obs_main, "ref")):
        out = str(tmp_path / f"{name}.json")
        assert main(["trace", path, "-o", out]) == 0
        docs.append(json.load(open(out)))
        assert main(["curve", path]) == 0
        docs.append(capsys.readouterr().out.splitlines()[1:])  # after the trace's own line
    assert docs[0] == docs[2] and docs[1] == docs[3]
    assert [e["name"] for e in docs[0]["traceEvents"]] == ["bench.repeat", "cache.evict"]
    # The default output sits beside the journal.
    assert obs_main(["trace", path]) == 0
    assert json.load(open(str(tmp_path / "run.trace.json"))) == docs[0]


def test_obs_cli_curve_headline_and_missing(tmp_path, capsys):
    path = str(tmp_path / "h.jsonl")
    jr = RunJournal(path, {"bench": "h"})
    jr.put("headline", {"headline": {"details": {"level_curve": {"occupancy": [1, 4, 2]}}}})
    jr.close()
    assert obs_main(["curve", path]) == 0
    assert capsys.readouterr().out.strip() == T.render_curve_ascii({"occupancy": [1, 4, 2]})
    empty = str(tmp_path / "e.jsonl")
    RunJournal(empty, {"bench": "e"}).close()
    assert obs_main(["curve", empty]) == 1
    assert obs_main(["trace", empty, "-o", str(tmp_path / "e.json")]) == 0
    assert "no spans journaled" in capsys.readouterr().out


def test_obs_cli_snapshot(capsys):
    R.get_registry().counter("cli_probe")
    assert obs_main(["snapshot"]) == 0
    assert json.loads(capsys.readouterr().out)["counters"]["cli_probe"] >= 1
    assert obs_main(["snapshot", "--prom"]) == 0
    assert "bfs_tpu_counters_cli_probe" in capsys.readouterr().out
