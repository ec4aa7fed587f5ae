"""``bfs_tpu_torch/tools/ledger_compare.py`` against the reference's
``tools/ledger_compare.py``: on the same documents (raw ledgers, headline
lines, sharded, streamed and label captures, a ledger the port's
``superstep_phase_ledger`` wrote) both tools, run as scripts, print the
same table and exit with the same code, with and without ``--exact`` and
at several thresholds; the reference's own edge cases
(``tests/test_ledger_compare.py``) in process; and the tool imports
neither torch nor jax."""

import copy
import json
import os
import subprocess
import sys

import pytest

import bfs_tpu_torch as P
from bfs_tpu_torch import profiling as PP
from bfs_tpu_torch.tools import ledger_compare as LC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_TOOL = os.path.join(REPO, "bfs_tpu_torch", "tools", "ledger_compare.py")
REF_TOOL = os.path.join(REPO, "tools", "ledger_compare.py")


def _raw(phases: dict, **extra) -> dict:
    return {"phases": {k: {"seconds": v, **extra.get(k, {})} for k, v in phases.items()}}


def _headline(ledger: dict, **details) -> dict:
    return {"metric": "teps", "details": {"superstep_phases": ledger, **details}}


def _sharded(search_s=2e-3, total=448, schedule=("bitmap", "delta"), share=112) -> dict:
    return {"details": {
        "sharded_phases": {
            "shards": 2,
            "phases": {
                "full_search": {"seconds": search_s, "bytes_exchanged": total,
                                "col_bytes": [1, 2], "row_bytes": [3, 4]},
                "full_superstep": {"seconds": search_s / 4, "bytes_exchanged": total // 4},
            },
            "per_shard": [{"shard": s, "real_words": 10, "adj_entries": 500 + s,
                           "exchange_bytes_share": share} for s in range(2)],
        },
        "exchange": {"schedule": list(schedule), "total_bytes": total,
                     "col_bytes": [10, 20], "row_bytes": [5], "col_schedule": ["flat", "delta"]},
        "direction_schedule": {"schedule": ["pull", "pull"]},
    }}


def _stream(bytes_streamed=4096, misses=2) -> dict:
    led = _raw({"full_superstep": 3e-3})
    return _headline(led, stream={
        "bytes_streamed": bytes_streamed, "hits": 5, "misses": misses, "evictions": 1,
        "corrupt_refetches": 0,
        "levels": [{"level": 1, "arm": "push", "demanded": 0, "bytes_streamed": 0, "hits": 0,
                    "misses": 0, "evictions": 0},
                   {"level": 2, "arm": "pull", "demanded": 3, "bytes_streamed": bytes_streamed,
                    "hits": 5, "misses": misses, "evictions": 1}]},
        expansion={"arm": "mxu", "per_level": ["sparse", "mxu"]})


def _labels(speedup=3.5, wrong=0) -> dict:
    return {"details": {"labels": {"k": 64, "pairs": 512, "tight_hits": 400, "fallbacks": 112,
                                   "wrong_answers": wrong, "labels_qps": 900.0,
                                   "exact_qps": 250.0, "speedup": speedup}}}


@pytest.fixture(scope="module")
def port_ledger():
    """A ledger of the port's own (an MXU engine: every phase, with arms)."""
    eng = P.RelayEngine(P.rmat_graph(6, 4, seed=7), device="cpu", sparse_hybrid=False,
                        expansion="mxu")
    return PP.superstep_phase_ledger(eng, loops=1, repeats=1)


def _pairs(port_ledger) -> dict:
    base = _raw({"vperm": 1.25e-3, "broadcast": 2e-4, "net_apply": 3.5e-3, "rowmin": 7e-4,
                 "state_update": 1e-4, "full_superstep": 6e-3},
                rowmin={"selected": "kernel"})
    slower = copy.deepcopy(base)
    slower["phases"]["net_apply"]["seconds"] = 5e-3  # +43%
    slower["phases"]["rowmin"]["seconds"] = 7.5e-4  # +7%
    faster = copy.deepcopy(base)
    faster["phases"]["vperm"]["seconds"] = 9e-7
    missing = copy.deepcopy(base)
    del missing["phases"]["rowmin"]
    extra = copy.deepcopy(base)
    extra["phases"]["zeta_phase"] = {"seconds": 1e-5}
    port2 = copy.deepcopy(port_ledger)
    for rec in port2["phases"].values():
        rec["seconds"] *= 1.1
    return {
        "identical": (base, copy.deepcopy(base)),
        "regressed": (base, slower),
        "improved": (slower, faster),
        "missing phase": (base, missing),
        "extra phase": (extra, base),
        "headline vs raw": (_headline(base, direction_schedule={"schedule": ["push", "pull"]}),
                            base),
        "schedules": (_headline(base, direction_schedule={"schedule": ["push", "pull"]}),
                      _headline(base, direction_schedule={"schedule": ["pull", "pull"]})),
        "sharded": (_sharded(total=1600, schedule=("flat", "flat"), share=800), _sharded()),
        "sharded same": (_sharded(), _sharded()),
        "stream": (_stream(), _stream(bytes_streamed=8192, misses=4)),
        "labels": (_labels(), _labels(speedup=0.9, wrong=1)),
        "port vs port": (port_ledger, port2),
        "port vs reference-shaped": (port_ledger, base),
    }


def _write(tmp_path, name: str, doc, lines: bool) -> str:
    path = tmp_path / name
    if lines:  # headline JSON lines: a provisional line, noise, then the final one
        provisional = {"details": {"superstep_phases": {"phases": {}}}}
        path.write_text(json.dumps(provisional) + "\nnot json\n" + json.dumps(doc) + "\n")
    else:
        path.write_text(json.dumps(doc, indent=2))
    return str(path)


def _run(tool: str, args: list) -> tuple:
    r = subprocess.run([sys.executable, tool, *args], capture_output=True, text=True,
                       cwd=REPO, timeout=60)
    return r.returncode, r.stdout, r.stderr


#: The pairs whose verdict a threshold can move.
MOVED = ("regressed", "improved", "sharded", "stream", "labels", "port vs port")


@pytest.mark.parametrize("flags", [[], ["--exact"], ["--threshold", "0.05"],
                                   ["--threshold", "2.0"]])
def test_same_table_and_exit_code_as_the_reference(port_ledger, tmp_path, flags):
    for i, (name, (before, after)) in enumerate(_pairs(port_ledger).items()):
        if flags[:1] == ["--threshold"] and name not in MOVED:
            continue
        lines = i % 2 == 1
        b = _write(tmp_path, f"b{i}.json", before, lines)
        a = _write(tmp_path, f"a{i}.json", after, lines)
        ours, ref = _run(PORT_TOOL, [b, a, *flags]), _run(REF_TOOL, [b, a, *flags])
        assert ours == ref, name


def test_unparseable_documents_fail_in_both(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("not json at all\nstill not json\n")
    good = _write(tmp_path, "g.json", _raw({"vperm": 1e-3}), False)
    noledger = _write(tmp_path, "n.json", {"details": {"other": 1}}, False)
    for pair in ((str(bad), good), (good, noledger)):
        ours, ref = _run(PORT_TOOL, list(pair)), _run(REF_TOOL, list(pair))
        assert ours[0] == ref[0] != 0
        assert (ours[1], ours[2]) == (ref[1], ref[2])


# ----------------------------- the reference's edge cases, in process --

def test_missing_phase_tolerated_without_exact(tmp_path, capsys):
    b = _write(tmp_path, "b.json", _raw({"vperm": 1e-3, "rowmin": 2e-3}), False)
    a = _write(tmp_path, "a.json", _raw({"vperm": 1e-3}), False)
    assert LC.main([b, a]) == 0
    out = capsys.readouterr().out
    assert "rowmin" in out and "—" in out
    assert LC.main([b, a, "--exact"]) == 2
    assert "rowmin" in capsys.readouterr().err


def test_exact_passes_on_identical_ledgers_and_catches_schedules(tmp_path, capsys):
    phases = {"vperm": 1.25e-3, "net_apply": 3.5e-3}
    b = _write(tmp_path, "b.json", _raw(phases), False)
    a = _write(tmp_path, "a.json", _raw(phases), False)
    assert LC.main([b, a, "--exact"]) == 0
    err = capsys.readouterr().err
    assert "exact match" in err and "selected arms" not in err
    b = _write(tmp_path, "b2.json", _headline(_raw(phases),
                                              direction_schedule={"schedule": ["push"]}), True)
    a = _write(tmp_path, "a2.json", _headline(_raw(phases),
                                              direction_schedule={"schedule": ["pull"]}), True)
    assert LC.main([b, a, "--exact"]) == 2
    assert "direction_schedule" in capsys.readouterr().err


def test_threshold_sets_the_regression(tmp_path, capsys):
    b = _write(tmp_path, "b.json", _raw({"net_apply": 1e-3}), False)
    a = _write(tmp_path, "a.json", _raw({"net_apply": 2e-3}), False)
    assert LC.main([b, a]) == 2
    assert "REGRESSION" in capsys.readouterr().err
    assert LC.main([b, a, "--threshold", "2.0"]) == 0


def test_selected_arms_of_the_port_ledger(port_ledger, tmp_path, capsys):
    p = _write(tmp_path, "p.json", port_ledger, False)
    assert LC.main([p, p]) == 0
    err = capsys.readouterr().err
    assert "'rowmin': 'plain'" in err and "'expansion': 'mxu'" in err


def test_the_tool_imports_neither_torch_nor_jax():
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('lc', {PORT_TOOL!r})\n"
        "mod = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod)\n"
        "assert not {'torch', 'jax', 'bfs_tpu', 'bfs_tpu_torch'} & set(sys.modules), "
        "sorted(sys.modules)\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=60)
