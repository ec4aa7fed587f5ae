"""The port's run journal (``bfs_tpu_torch.resilience.journal``) against
``bfs_tpu.resilience.journal``: the reference's journal cases on the
port, the same puts writing the same records and file names in both
packages, journals of either package resumed by the other, ``read_records``
and ``stitch_journal_trace`` equal on one file, ``env_config`` over the
knobs the port has, and ``graph500_run`` skipping a journaled scale."""

import contextlib
import io
import json
import os

import numpy as np
import pytest

from bfs_tpu.obs import spans as JS
from bfs_tpu.resilience import journal as JJ
from bfs_tpu_torch import knobs
from bfs_tpu_torch.obs import spans as S
from bfs_tpu_torch.resilience import journal as J
from bfs_tpu_torch.resilience.faults import corrupt_file

CFG = {"scale": 8, "engine": "push", "repeats": 2}
MASK = np.packbits(np.arange(64) % 3 == 0)


def _lines(path: str) -> list[dict]:
    """The records of a journal file without their wall-clock ``t``."""
    with open(path, "rb") as f:
        return [{k: v for k, v in json.loads(raw).items() if k != "t"} for raw in f]


# ------------------------------------------------ the reference's cases --

def test_journal_put_get_roundtrip(tmp_path):
    jr = J.RunJournal.open_for(str(tmp_path), CFG)
    assert jr.get("reference") is None
    jr.put("reference", {"directed_traversed": 42})
    jr.put("repeat:0", {"seconds": 0.5})
    jr.close()
    jr2 = J.RunJournal.open_for(str(tmp_path), CFG)
    assert jr2.get("reference") == {"directed_traversed": 42}
    assert jr2.get("repeat:0") == {"seconds": 0.5}
    assert set(jr2.resumed_phases) == {"reference", "repeat:0"}
    assert "repeat:0" in jr2 and "repeat:1" not in jr2
    jr2.close()


def test_journal_key_is_config_addressed(tmp_path):
    a = J.RunJournal.open_for(str(tmp_path), CFG)
    b = J.RunJournal.open_for(str(tmp_path), {**CFG, "repeats": 3})
    assert a.path != b.path
    assert J.config_key(CFG) == J.config_key(dict(reversed(list(CFG.items()))))
    assert J.config_key(CFG) == JJ.config_key(CFG)
    a.close(), b.close()


def test_journal_torn_tail_is_trimmed(tmp_path):
    jr = J.RunJournal.open_for(str(tmp_path), CFG)
    jr.put("reference", {"x": 1})
    jr.put("roots", {"roots": [1, 2, 3]})
    jr.close()
    with open(jr.path, "r+b") as f:  # a kill mid-append
        f.truncate(os.path.getsize(jr.path) - 7)
    jr2 = J.RunJournal.open_for(str(tmp_path), CFG)
    assert jr2.get("reference") == {"x": 1}
    assert jr2.get("roots") is None
    jr2.put("roots", {"roots": [4]})
    jr2.close()
    jr3 = J.RunJournal.open_for(str(tmp_path), CFG)
    assert jr3.get("roots") == {"roots": [4]}
    jr3.close()


def test_journal_crc_rejects_tampered_record(tmp_path):
    jr = J.RunJournal.open_for(str(tmp_path), CFG)
    jr.put("reference", {"directed_traversed": 42})
    jr.put("roots", {"roots": [1]})
    jr.close()
    lines = open(jr.path, "rb").read().splitlines(keepends=True)
    lines[1] = lines[1].replace(b"42", b"43")
    with open(jr.path, "wb") as f:
        f.writelines(lines)
    jr2 = J.RunJournal.open_for(str(tmp_path), CFG)
    assert jr2.get("reference") is None  # the record and its tail
    assert jr2.get("roots") is None
    jr2.close()


@pytest.mark.parametrize("damage", [b"[1, 2, 3]\n", b'{"i": 1, "phase": 9, "payload": {}}\n'])
def test_journal_malformed_but_parseable_records_trim_not_crash(tmp_path, damage):
    jr = J.RunJournal.open_for(str(tmp_path), CFG)
    jr.put("reference", {"x": 1})
    jr.put("roots", {"roots": [1]})
    jr.close()
    lines = open(jr.path, "rb").read().splitlines(keepends=True)
    lines[1] = damage
    with open(jr.path, "wb") as f:
        f.writelines(lines)
    jr2 = J.RunJournal.open_for(str(tmp_path), CFG)  # must not raise
    assert jr2.get("reference") is None
    assert jr2.get("roots") is None
    jr2.put("reference", {"x": 2})
    jr2.close()
    assert J.RunJournal.open_for(str(tmp_path), CFG).get("reference") == {"x": 2}


def test_journal_foreign_file_rotates_not_truncates(tmp_path):
    path = str(tmp_path / "mc.jsonl")
    legacy = '{"n_devices": 8, "rc": 0, "ok": true,\n "tail": "relay legs verified\\n"}\n'
    with open(path, "w") as f:
        f.write(legacy)
    jr = J.RunJournal(path, CFG)
    assert jr.invalidated == "foreign/pre-journal file"
    jr.put("reference", {"x": 1})
    jr.close()
    assert open(path + ".stale.0").read() == legacy
    jr2 = J.RunJournal(path, CFG)
    assert jr2.get("reference") == {"x": 1}
    jr2.close()


def test_journal_config_mismatch_rotates_fresh(tmp_path):
    jr = J.RunJournal.open_for(str(tmp_path), CFG)
    jr.put("reference", {"x": 1})
    path = jr.path
    jr.close()
    jr2 = J.RunJournal(path, {**CFG, "engine": "pull"})
    assert jr2.invalidated == "config mismatch"
    assert jr2.get("reference") is None
    assert os.path.exists(path + ".stale.0")
    jr2.close()


def test_journal_restart_rotates(tmp_path):
    jr = J.RunJournal.open_for(str(tmp_path), CFG)
    jr.put("graph", {"content_hash": "aaa"})
    jr.restart("graph-hash mismatch")
    assert jr.get("graph") is None and jr.invalidated == "graph-hash mismatch"
    jr.put("graph", {"content_hash": "bbb"})
    jr.close()
    assert os.path.exists(jr.path + ".stale.0")
    jr2 = J.RunJournal.open_for(str(tmp_path), CFG)
    assert jr2.get("graph") == {"content_hash": "bbb"}
    jr2.close()


def test_journal_refuses_concurrent_writer(tmp_path, monkeypatch):
    pytest.importorskip("fcntl")
    monkeypatch.setattr(J.RunJournal, "LOCK_TIMEOUT_S", 0.2)
    jr = J.RunJournal.open_for(str(tmp_path), CFG)
    with pytest.raises(RuntimeError, match="locked by another"):
        J.RunJournal.open_for(str(tmp_path), CFG)
    # Nor may the reference's journal append to it meanwhile.
    monkeypatch.setattr(JJ.RunJournal, "LOCK_TIMEOUT_S", 0.2)
    with pytest.raises(RuntimeError, match="locked by another"):
        JJ.RunJournal.open_for(str(tmp_path), CFG)
    jr.close()
    J.RunJournal.open_for(str(tmp_path), CFG).close()  # released on close


def test_journal_sidecar_roundtrip_and_truncation(tmp_path):
    jr = J.RunJournal.open_for(str(tmp_path), CFG)
    jr.put("reference", {"n": 64}, arrays={"mask_packed": MASK})
    jr.close()
    jr2 = J.RunJournal.open_for(str(tmp_path), CFG)
    np.testing.assert_array_equal(jr2.load_arrays("reference")["mask_packed"], MASK)
    jr2.close()
    (sidecar,) = [p for p in os.listdir(tmp_path) if p.endswith(".npz")]
    corrupt_file(str(tmp_path / sidecar), mode="truncate")
    jr3 = J.RunJournal.open_for(str(tmp_path), CFG)
    assert jr3.get("reference") is None  # never completed-with-garbage
    jr3.close()


@pytest.mark.parametrize("mode", ["truncate", "flip"])
def test_journal_damaged_sidecar_rotates_whole_journal(tmp_path, mode):
    jr = J.RunJournal.open_for(str(tmp_path), CFG)
    jr.put("reference", {"n": 64}, arrays={"mask_packed": MASK})
    jr.put("repeat:0", {"seconds": 1.25})
    jr.close()
    (sidecar,) = [p for p in os.listdir(tmp_path) if p.endswith(".npz")]
    corrupt_file(str(tmp_path / sidecar), mode=mode)
    jr2 = J.RunJournal.open_for(str(tmp_path), CFG)
    assert jr2.get("reference") is None
    assert jr2.invalidated is not None and "sidecar" in jr2.invalidated
    assert jr2.get("repeat:0") is None
    assert any(p.startswith(os.path.basename(jr2.path)) and ".stale." in p
               for p in os.listdir(tmp_path))
    jr2.put("reference", {"n": 64}, arrays={"mask_packed": MASK})
    assert jr2.get("reference") == {"n": 64}
    jr2.close()


def test_journal_missing_sidecar_only_fails_that_phase(tmp_path):
    jr = J.RunJournal.open_for(str(tmp_path), CFG)
    jr.put("reference", {"n": 64}, arrays={"mask_packed": MASK})
    jr.put("repeat:0", {"seconds": 1.25})
    jr.close()
    (sidecar,) = [p for p in os.listdir(tmp_path) if p.endswith(".npz")]
    os.remove(tmp_path / sidecar)
    jr2 = J.RunJournal.open_for(str(tmp_path), CFG)
    assert jr2.get("reference") is None
    assert jr2.get("repeat:0") == {"seconds": 1.25}
    assert jr2.invalidated is None
    jr2.close()


# ---------------------------------------------------- across the packages --

def _script(mod, root: str) -> str:
    jr = mod.RunJournal.open_for(root, CFG)
    jr.put("reference", {"n": 64, "ok": True}, arrays={"mask_packed": MASK})
    jr.put("repeat:0", {"seconds": 0.5, "levels": [1, 2, 3]})
    jr.put("repeat:0", {"seconds": 0.25})  # a phase recorded again
    jr.put("odd phase/1", None)
    jr.close()
    return jr.path


def test_the_same_puts_write_the_same_records(tmp_path):
    paths = [_script(mod, str(tmp_path / name)) for mod, name in ((J, "port"), (JJ, "ref"))]
    assert os.path.basename(paths[0]) == os.path.basename(paths[1])
    assert _lines(paths[0]) == _lines(paths[1])
    side = [sorted(p for p in os.listdir(os.path.dirname(x)) if p.endswith(".npz")) for x in paths]
    assert side[0] == side[1] and len(side[0]) == 1


@pytest.mark.parametrize("writer,reader", [(JJ, J), (J, JJ)], ids=["ref-to-port", "port-to-ref"])
def test_journals_resume_across_packages(tmp_path, writer, reader):
    path = _script(writer, str(tmp_path))
    jr = reader.RunJournal.open_for(str(tmp_path), CFG)
    assert jr.path == path and jr.invalidated is None
    assert jr.resumed_phases == ["reference", "repeat:0", "odd phase/1"]
    assert jr.get("reference") == {"n": 64, "ok": True}
    assert jr.get("repeat:0") == {"seconds": 0.25}
    np.testing.assert_array_equal(jr.load_arrays("reference")["mask_packed"], MASK)
    jr.put("repeat:1", {"seconds": 0.75})  # appended on by the other package
    jr.close()
    again = writer.RunJournal.open_for(str(tmp_path), CFG)
    assert again.get("repeat:1") == {"seconds": 0.75} and again.invalidated is None
    again.close()


@pytest.mark.parametrize("cut", [0, 7, 200])
def test_read_records_equal_on_one_file(tmp_path, cut):
    path = _script(J, str(tmp_path))
    if cut:
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) - cut)
    got, want = J.read_records(path), JJ.read_records(path)
    assert got == want and (len(got) < 5 if cut else len(got) == 5)
    assert J.read_records(str(tmp_path / "none.jsonl")) == []


def test_stitch_journal_trace_equal_on_one_file(tmp_path):
    S.drain_events()
    path = str(tmp_path / "run.jsonl")
    for gen in range(2):  # two process generations of one journal
        jr = J.RunJournal(path, CFG)
        with S.span("bench.repeat", gen=gen):
            S.instant("cache.evict", gen=gen)
        assert S.journal_spans(jr) == f"spans:{gen}"
        assert S.journal_spans(jr) is None  # nothing left to journal
        jr.close()
    assert S.journal_spans(None) is None
    doc = S.stitch_journal_trace(path)
    assert doc == JS.stitch_journal_trace(path)
    assert [e["name"] for e in doc["traceEvents"]] == ["cache.evict", "bench.repeat"] * 2
    assert [e["args"]["gen"] for e in doc["traceEvents"]] == [0, 0, 1, 1]
    # A journal the reference wrote stitches the same in the port.
    ref_path = str(tmp_path / "ref.jsonl")
    jr = JJ.RunJournal(ref_path, CFG)
    jr.put("spans:0", {"events": doc["traceEvents"]})
    jr.close()
    assert S.stitch_journal_trace(ref_path) == JS.stitch_journal_trace(ref_path)


def test_env_config_mirrors_the_reference(monkeypatch):
    from bfs_tpu import knobs as j_knobs

    for name in (*knobs.journal_map().values(), *j_knobs.journal_map().values()):
        monkeypatch.delenv(name, raising=False)  # the suite's conftest sets some
    port = J.env_config()
    assert set(port) == set(knobs.journal_map())
    assert port == {k: v for k, v in JJ.env_config().items() if k in port}
    for prefix in ("BFS_TPU_", "BFS_TPU_TORCH_"):
        monkeypatch.setenv(prefix + "DIRECTION", "pull")
        monkeypatch.setenv(prefix + "SSSP_DELTA", "")  # empty: the default
    changed = J.env_config()
    assert changed["direction"] == "pull" and changed["sssp_delta"] == port["sssp_delta"]
    assert changed == {k: v for k, v in JJ.env_config().items() if k in port}
    assert J.config_key({"env": changed}) != J.config_key({"env": port})


def test_journal_dir_knob(monkeypatch, tmp_path):
    from bfs_tpu_torch import config

    monkeypatch.delenv("BFS_TPU_TORCH_JOURNAL_DIR", raising=False)
    monkeypatch.setenv("BFS_TPU_TORCH_CACHE_DIR", str(tmp_path))
    assert config.journal_dir() == os.path.join(str(tmp_path), "journal")
    monkeypatch.setenv("BFS_TPU_TORCH_JOURNAL_DIR", str(tmp_path / "j"))
    assert config.journal_dir() == str(tmp_path / "j")


# ------------------------------------------------------------ graph500_run --

def _g500(argv) -> tuple[int, str]:
    from bfs_tpu_torch.tools import graph500_run

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = graph500_run.main(argv)
    return rc, buf.getvalue()


def test_graph500_run_skips_a_journaled_scale(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("BFS_TPU_TORCH_JOURNAL_DIR", str(tmp_path))
    argv = ["--scales", "7", "--roots", "2", "--device", "cpu"]
    S.drain_events()
    rc, first = _g500(argv)
    assert rc == 0 and "SCALE: 7" in first
    (path,) = [str(tmp_path / p) for p in os.listdir(tmp_path)]
    size = os.path.getsize(path)
    assert [r["phase"] for r in J.read_records(path)] == ["_header", "scale:7", "spans:0"]
    names = {e["name"] for e in S.stitch_journal_trace(path)["traceEvents"]}
    assert {"graph500.scale", "graph500.generate", "graph500.construct"} <= names
    capsys.readouterr()
    rc, second = _g500(argv)
    assert rc == 0 and second == first  # the stored document printed again
    assert "journal hit" in capsys.readouterr().err
    assert os.path.getsize(path) == size
    # Another device keys another journal; --no-journal and the knob skip it.
    rc, _ = _g500(argv + ["--no-journal"])
    monkeypatch.setenv("BFS_TPU_TORCH_JOURNAL", "0")
    rc2, _ = _g500(argv)
    assert rc == rc2 == 0 and os.listdir(tmp_path) == [os.path.basename(path)]
