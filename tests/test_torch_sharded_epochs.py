"""The mesh's resumable search (``bfs_tpu_torch.parallel.sharded.
bfs_sharded_segmented``) against the JAX reference's on the CPU: the
epochs and the command line.

On the reference test's graph (``rmat_graph(7, 4, seed=3)``, source 3):
the epoch files, keys and dtypes against the reference's; an epoch of the
reference's ``bfs_sharded_segmented`` (run with its replication check
off, see ``test_torch_sharded.reference_unchecked``) resumed by the port;
the segment keys and a fresh carry; the packed cap's unpacked re-run and
a mesh of one shard; the command line's ``--config sharded`` killed by
SIGKILL and resumed in a subprocess.  Segmented parity and shard loss are
in ``test_torch_sharded_ckpt.py``.  All comparisons are exact."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import bfs_tpu_torch as P
from bfs_tpu_torch.parallel import sharded as SH
from bfs_tpu_torch.resilience import faults as F
from bfs_tpu_torch.resilience.faults import FaultInjected
from bfs_tpu_torch.resilience.superstep_ckpt import _hash

from bfs_tpu.graph import benes as j_benes
from bfs_tpu.parallel import sharded as JS
from bfs_tpu.resilience import superstep_ckpt as JCK

from test_torch_sharded import _oracle, _same, mesh, reference_unchecked
from test_torch_sharded_ckpt import (  # noqa: F401  (fault: the fixture)
    SOURCE,
    _engine,
    _golden,
    _graph,
    _interrupt,
    _jlayout,
    _layout,
    _mgr,
    _same_curve,
    fault,
)
from test_torch_superstep_ckpt import _reference_interrupt

pytestmark = pytest.mark.skipif(
    not j_benes.native_available(), reason="native benes router unavailable"
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --------------------------------------------------------- the epoch format --

def test_epoch_files_keys_and_dtypes_are_the_references(tmp_path, fault):
    """At boundary 1 the port and the reference write the same files (a
    meta file and one file per shard), with the same keys and dtypes,
    except the decision words on ``auto``: the port's ``dstate`` and
    ``use_pull`` where the reference keeps ``mu`` and ``prev``."""
    n = 2
    _interrupt(_engine(n, "gather"), fault, tmp_path / "port", n, boundary=1)
    with reference_unchecked():
        jmgr = JCK.SuperstepCheckpointer(tmp_path / "ref", {"t": 1}, cfg=JCK.CkptConfig("every", 1),
                                         shards=n)
        _reference_interrupt(lambda: JS.bfs_sharded_segmented(
            _jlayout(n), SOURCE, mesh=JS.make_mesh(graph=n), ckpt=jmgr, telemetry=True, direction="auto",
            exchange="auto"), tmp_path, boundary=1)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "ref")) and len(names) == n + 1
    for name in names:
        with np.load(tmp_path / "port" / name) as z:
            got = {k: z[k] for k in z.files}
        with np.load(tmp_path / "ref" / name) as z:
            want = {k: z[k] for k in z.files}
        if name.endswith(".meta.npz"):
            assert set(got) - set(want) == {"dstate", "use_pull"}
            assert set(want) - set(got) == {"mu", "prev"}
            assert got["dstate"].dtype == np.float32 and got["use_pull"].dtype == np.int32
            np.testing.assert_array_equal(got["fw"], want["fw"])
        else:
            assert set(got) == set(want) and "pk" in got
            np.testing.assert_array_equal(got["pk"], want["pk"])
        for k in set(got) & set(want):
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, (name, k)
            if not k.startswith("meta_"):
                np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("direction", ["pull", "auto"])
def test_reference_epoch_resumes_in_the_port(direction, tmp_path):
    """An epoch of the reference's ``bfs_sharded_segmented`` (killed at
    boundary 2) resumes in the port to the fused result; on ``auto`` the
    reference's ``mu`` and ``prev`` give the next body by one decision on
    restore."""
    n = 2
    with reference_unchecked():
        jmgr = JCK.SuperstepCheckpointer(tmp_path, {"t": 1}, cfg=JCK.CkptConfig("every", 1),
                                         shards=n)
        _reference_interrupt(lambda: JS.bfs_sharded_segmented(
            _jlayout(n), SOURCE, mesh=JS.make_mesh(graph=n), ckpt=jmgr, telemetry=True,
            direction=direction, exchange="auto"), tmp_path, boundary=2)
    mgr = _mgr(tmp_path, n, k=1)
    assert mgr.epochs() == [1, 2]
    res, curve = _engine(n, "gather").run_segmented(SOURCE, ckpt=mgr, telemetry=True,
                                                    direction=direction, exchange="auto")
    rep = mgr.report()
    assert rep["resumed_from_epoch"] == 2 and rep["fresh_fallbacks"] == 0
    want, want_curve = _golden(n, "gather", direction)
    _same(res, want)
    _same_curve(curve, want_curve)


def test_segment_keys_and_carry():
    """The keys of each carry flavor, and a fresh carry at level 0 holding
    the source's bit and state."""
    assert SH.sharded_segment_keys(True, False, False) == ["pk", "fw", "level", "changed"]
    assert SH.sharded_segment_keys(False, True, True) == [
        "dist", "parent", "fw", "level", "changed", "dstate", "use_pull", "occ", "dirs", "xb",
        "xa"]
    eng = _engine(2, "gather")
    carry = SH.sharded_segment_carry(eng, SOURCE, telemetry=True, direction="auto")
    assert carry["level"] == 0 and carry["changed"] is True
    assert {"pk", "fw", "dstate", "occ", "dirs", "xb", "xa"} <= set(carry)
    s = int(_layout(2).old2new[SOURCE])
    assert int(carry["pk"][s]) == 0 and int((carry["pk"] != -1).sum()) == 1
    fw = carry["fw"].numpy().view(np.uint32)
    assert fw[s >> 5] == np.uint32(1) << np.uint32(s & 31) and int((fw != 0).sum()) == 1


# ------------------------------------------------------------ special cases --

def test_deep_path_reruns_unpacked_and_one_shard(tmp_path):
    """Past the packed carry's 62 levels the packed epochs are cleared and
    the run continues unpacked; a mesh of one shard keeps each epoch in one
    file.  Both equal the fused search and the oracle."""
    g = P.path_graph(100)
    for n, arm in ((4, "mxu"), (1, "gather")):
        srg = P.build_sharded_relay_graph(g, n, route="native")
        eng = SH.ShardedRelayEngine(srg, mesh(n), expansion=arm)
        want, want_curve = eng.run(0, telemetry=True, direction="pull", exchange="auto")
        mgr = _mgr(tmp_path / f"{n}", n, k=16)
        res, curve = eng.run_segmented(0, ckpt=mgr, telemetry=True, direction="pull",
                                       exchange="auto")
        assert res.num_levels == 100 and not eng.last_run["packed"]
        assert mgr.report()["segments"] == 4 + 7  # 62 packed levels, then 100 unpacked
        _same(res, want)
        _same_curve(curve, want_curve)
        _oracle(g, res, 0)
    mgr = _mgr(tmp_path / "one", 1, k=1)
    eng = SH.ShardedRelayEngine(P.build_sharded_relay_graph(_graph(), 1, route="native"), mesh(1))
    want, _ = eng.run(SOURCE, telemetry=True, direction="auto", exchange="auto")
    os.environ["BFS_TPU_TORCH_FAULT"] = "raise:superstep:2"
    F.reset()
    try:
        with pytest.raises(FaultInjected):
            eng.run_segmented(SOURCE, ckpt=mgr, telemetry=True, direction="auto", exchange="auto")
    finally:
        os.environ.pop("BFS_TPU_TORCH_FAULT", None)
        F.reset()
    assert all(".shard" not in p for p in os.listdir(tmp_path / "one"))
    mgr = _mgr(tmp_path / "one", 1, k=1)
    _same(eng.run_segmented(SOURCE, ckpt=mgr, telemetry=True, direction="auto",
                            exchange="auto")[0], want)
    assert mgr.report()["resumed_from_epoch"] == 2


# ----------------------------------------------------------- the command line --

def test_cli_sharded_sigkill_round_trip(tmp_path):
    """``--config sharded --shards 2`` killed by SIGKILL at boundary 2, then
    resumed in a new process: the golden run's hashes, schedule and
    exchange, computed here in-process."""
    def run(ckpt_dir, out, fault=None):
        env = dict(os.environ, PYTHONPATH=REPO)
        env.pop("BFS_TPU_TORCH_FAULT", None)
        if fault:
            env["BFS_TPU_TORCH_FAULT"] = fault
        cmd = [sys.executable, "-m", "bfs_tpu_torch.resilience.superstep_ckpt", "--config",
               "sharded", "--shards", "2", "--device", "cpu", "--ckpt-dir", str(ckpt_dir),
               "--out", str(out)]
        return subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=120)

    killed = run(tmp_path / "c", tmp_path / "k.json", fault="kill:superstep:2")
    assert killed.returncode == -9, killed.stderr
    assert not (tmp_path / "k.json").exists()
    assert any(".shard1." in p for p in os.listdir(tmp_path / "c"))
    resumed = run(tmp_path / "c", tmp_path / "r.json")
    assert resumed.returncode == 0, resumed.stderr
    doc = json.loads((tmp_path / "r.json").read_text())
    rep = doc["superstep_ckpt"]
    assert rep["resumed_from_epoch"] == 4 and rep["shards"] == 2  # two segments of 2
    g = P.rmat_graph(8, 4, seed=3)
    res, curve = SH.bfs_sharded(g, 3, mesh=mesh(2), engine="relay", telemetry=True,
                                direction="auto", exchange="auto")
    assert (doc["dist_hash"], doc["parent_hash"], doc["num_levels"]) == (
        _hash(res.dist), _hash(res.parent), res.num_levels)
    assert doc["direction_schedule"] == curve["direction_schedule"]
    assert doc["exchange_schedule"] == curve["exchange"]["schedule"]
    assert doc["exchange_bytes"] == curve["exchange"]["bytes_per_level"]
    assert os.listdir(tmp_path / "c") == []
