"""``cache/layout.py::verify_tiles_bundle`` against the reference's function
on the same bundles (good, missing, corrupt, drifted, unreadable), and the
port's ``tools/cache_warm.py`` run twice on one cache root: cold, then
every artifact a hit."""

import json
import os
import shutil

import numpy as np
import pytest

import bfs_tpu_torch as P
from bfs_tpu_torch.cache import layout as C
from bfs_tpu_torch.graph.generators import rmat_graph_native
from bfs_tpu_torch.resilience.faults import corrupt_file
from bfs_tpu_torch.tools import cache_warm

from bfs_tpu.cache import layout as j_cache
from bfs_tpu.graph import relay as j_relay
from bfs_tpu.graph.csr import Graph as JGraph


@pytest.fixture(scope="module")
def layouts():
    g = P.rmat_graph(9, 8, seed=5)
    rg = P.build_relay_graph(g)
    jrg = j_relay.build_relay_graph(JGraph(g.num_vertices, g.src.copy(), g.dst.copy()))
    return rg, jrg


def _both(rg, jrg, root) -> tuple[dict, dict]:
    got = C.verify_tiles_bundle(rg, cache=C.LayoutCache(root))
    want = j_cache.verify_tiles_bundle(jrg, cache=j_cache.LayoutCache(root))
    return got, want


def _built(rg, tmp_path) -> str:
    root = str(tmp_path / "layout")
    _, info = C.load_or_build_tiles(rg, cache=C.LayoutCache(root))
    assert info["cache"] == "miss"
    return root


def test_verify_good_and_missing_bundles_match_the_reference(layouts, tmp_path):
    rg, jrg = layouts
    got, want = _both(rg, jrg, str(tmp_path / "empty"))
    assert got == want == {"key": C.tiles_key(rg), "ok": False, "status": "absent"}
    root = _built(rg, tmp_path)
    got, want = _both(rg, jrg, root)
    assert got == want
    assert got["ok"] and got["status"] == "ok" and got["num_tiles"] > 0


def test_verify_corrupt_field_reads_absent(layouts, tmp_path):
    """A flipped byte in one field fails its fingerprint: the bundle is
    dropped and reported absent, by either package."""
    rg, jrg = layouts
    root = _built(rg, tmp_path)
    other = str(tmp_path / "copy")
    shutil.copytree(root, other)
    for r in (root, other):
        path = os.path.join(r, C.tiles_key(rg), "row_idx.npy")
        corrupt_file(path, mode="flip", at=os.path.getsize(path) - 3)
    got = C.verify_tiles_bundle(rg, cache=C.LayoutCache(root))
    want = j_cache.verify_tiles_bundle(jrg, cache=j_cache.LayoutCache(other))
    assert got == want == {"key": C.tiles_key(rg), "ok": False, "status": "absent"}
    assert not os.path.exists(os.path.join(root, C.tiles_key(rg)))


def _resave(rg, root: str, edit) -> None:
    """The bundle saved again under its key with ``edit`` applied to its
    arrays (fingerprints valid: a geometry fault, not a corrupt file)."""
    cache = C.LayoutCache(root)
    doc, arrays = cache.load(C.tiles_key(rg), mmap=False)
    arrays = {k: np.array(v) for k, v in arrays.items()}
    edit(arrays)
    shutil.rmtree(os.path.join(root, C.tiles_key(rg)))
    cache.save(C.tiles_key(rg), arrays, doc["meta"])


@pytest.mark.parametrize("fault,status", [
    ("rows", "rows"),
    ("indptr", "sb_indptr not a monotone span table closing at nt"),
    ("row_idx", "real tile row_idx outside the padded row space"),
    ("col_id", "real tile col_id outside the padded col space"),
])
def test_verify_drifted_bundle_matches_the_reference(layouts, tmp_path, fault, status):
    rg, jrg = layouts

    def edit(a):
        if fault == "rows":
            a["dims"][1] += 1
        elif fault == "indptr":
            a["sb_indptr"][-1] += 1
        elif fault == "row_idx":
            a["row_idx"][0] = a["dims"][3] // 128
        else:
            a["col_id"][0] = a["dims"][4] // 128

    root = _built(rg, tmp_path)
    _resave(rg, root, edit)
    got, want = _both(rg, jrg, root)
    assert got == want
    assert not got["ok"] and status in got["status"]


def test_verify_unreadable_bundle(layouts, tmp_path):
    rg, jrg = layouts
    root = _built(rg, tmp_path)

    def edit(a):
        a["dims"][0] += 1  # a schema version neither package reads

    _resave(rg, root, edit)
    got, want = _both(rg, jrg, root)
    assert (got["ok"], want["ok"]) == (False, False)
    assert got["status"].startswith("unreadable: ") and want["status"].startswith("unreadable: ")
    assert got["key"] == want["key"]


def _lines(capsys) -> tuple[list[str], list[dict]]:
    out = capsys.readouterr().out.splitlines()
    return out, [json.loads(x) for x in out if x.startswith("{")]


def test_cache_warm_cold_then_warm(tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("BFS_TPU_TORCH_CACHE_DIR", raising=False)
    argv = ["--scales", "9", "--edge-factor", "6", "--device", "cpu", "--cache-dir",
            str(tmp_path / "cache"), "--pull", "--tiles", "--labels", "--landmarks", "4",
            "--compile"]
    assert cache_warm.main(argv) == 0
    lines, docs = _lines(capsys)
    assert docs[-2] == {"scale": 9, "artifacts": dict.fromkeys(
        ("relay", "pull", "tiles", "labels"), "built")}
    tiles = next(d for d in docs if "tiles_key" in d)
    assert tiles["verify_ok"] and tiles["num_superblocks"] >= 1 and tiles["real_tiles"] > 0
    assert any("--compile skipped" in x for x in lines)
    assert cache_warm.main(argv) == 0
    lines, docs = _lines(capsys)
    assert docs[-2] == {"scale": 9, "artifacts": dict.fromkeys(
        ("relay", "pull", "tiles", "labels"), "hit")}
    # The counters of this process: four hits on top of the cold run's misses.
    assert docs[-1]["artifact_caches"]["layout_cache_hits"] >= 4
    g = rmat_graph_native(9, 6, seed=1)
    rg, info = C.load_or_build_relay(g, cache=C.LayoutCache(str(tmp_path / "cache" / "layout")),
                                     device="cpu")
    assert info["cache"] == "hit"
    assert C.verify_tiles_bundle(rg, cache=C.LayoutCache(str(tmp_path / "cache" / "layout")))["ok"]


def test_cache_warm_compare_builders(capsys):
    assert cache_warm.main(["--scales", "8", "--device", "cpu", "--compare", "2"]) == 0
    doc = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")][0]
    assert doc["scale"] == 8 and doc["reps"] == 2
    assert doc["host_build_s"]["median"] > 0 and doc["device_build_s"]["median"] > 0
