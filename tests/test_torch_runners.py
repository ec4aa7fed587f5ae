"""The port's host layer and command-line runners against ``bfs_tpu``'s:
``ServiceConfiguration`` on ``service.properties``, the ``problemFile_i``
dumps of ``run_parallel`` byte for byte, checkpoints written by either
package's runner resumed by the other's, ``run_sequential``'s log, and the
``Stopwatch``, metrics, vertex wire format and checkpoint helpers.  All on
the CPU (``--device cpu``); exact comparisons throughout."""

import dataclasses
import glob
import logging
import os

import numpy as np
import pytest

import bfs_tpu_torch as P
from bfs_tpu_torch import config as PConfig
from bfs_tpu_torch.graph import vertex as PV
from bfs_tpu_torch.runners import run_parallel as PRun
from bfs_tpu_torch.runners import run_sequential as PSeq
from bfs_tpu_torch.utils import checkpoint as PCk
from bfs_tpu_torch.utils import metrics as PM
from bfs_tpu_torch.utils.timing import Stopwatch

from bfs_tpu import config as JConfig
from bfs_tpu.graph import benes as j_benes
from bfs_tpu.graph import vertex as JV
from bfs_tpu.graph.csr import Graph as JGraph
from bfs_tpu.runners import run_parallel as JRun
from bfs_tpu.runners import run_sequential as JSeq
from bfs_tpu.utils import checkpoint as JCk
from bfs_tpu.utils import metrics as JM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROPS = os.path.join(REPO, "service.properties")
FILES = [os.path.join(REPO, "test-sets", n) for n in ("tinyCG.txt", "randomG.txt")]

needs_native = pytest.mark.skipif(
    not j_benes.native_available(), reason="native benes router unavailable"
)


def test_service_configuration_matches_reference(tmp_path):
    assert dataclasses.asdict(PConfig.ServiceConfiguration.load(PROPS)) == \
        dataclasses.asdict(JConfig.ServiceConfiguration.load(PROPS))
    assert dataclasses.asdict(PConfig.ServiceConfiguration()) == \
        dataclasses.asdict(JConfig.ServiceConfiguration())
    text = "# c\n! c\n a = 1 \nproblemFiles=x.txt,  ,y.txt\ndump-supersteps=TRUE\n"
    assert PConfig.parse_properties(text) == JConfig.parse_properties(text)
    path = tmp_path / "s.properties"
    path.write_text(text)
    assert dataclasses.asdict(PConfig.ServiceConfiguration.load(path)) == \
        dataclasses.asdict(JConfig.ServiceConfiguration.load(path))
    for mod in (PConfig, JConfig):
        with pytest.raises(ValueError):
            mod.parse_properties("no equals sign")


def _dumps(directory) -> dict[str, bytes]:
    out = {}
    for path in sorted(glob.glob(os.path.join(directory, "*.txt_*"))):
        if ".ckpt_" not in path:
            with open(path, "rb") as f:
                out[os.path.basename(path)] = f.read()
    return out


def _engines():
    return ["push", "pull", pytest.param("relay", marks=needs_native)]


@pytest.mark.parametrize("engine", _engines())
@pytest.mark.parametrize("path", FILES, ids=["tinyCG", "randomG"])
def test_dumps_match_reference(tmp_path, engine, path):
    ours, ref = tmp_path / "ours", tmp_path / "ref"
    ours.mkdir()
    ref.mkdir()
    m = PRun.run_problem_file(path, engine=engine, device="cpu", dump=True, work_dir=str(ours))
    jm = JRun.run_problem_file(path, engine=engine, dump=True, work_dir=str(ref))
    got, want = _dumps(ours), _dumps(ref)
    assert len(got) == jm.num_levels + 1 and got == want
    assert [(r.level, r.frontier_size) for r in m.supersteps] == \
        [(r.level, r.frontier_size) for r in jm.supersteps]


@pytest.mark.parametrize("engine", ["push", "pull"])
@pytest.mark.parametrize("writer", ["ours", "ref"])
def test_checkpoints_resume_across_packages(tmp_path, engine, writer):
    """One runner writes a checkpoint every superstep; all but the one at
    level 2 are deleted (a run killed after it); the other package's runner
    resumes from it and its remaining dumps equal a full run's."""
    path = FILES[1]
    full = tmp_path / "full"
    full.mkdir()
    JRun.run_problem_file(path, engine=engine, dump=True, work_dir=str(full))
    killed = tmp_path / "killed"
    killed.mkdir()
    write, resume = (PRun, JRun) if writer == "ours" else (JRun, PRun)
    kwargs = {"device": "cpu"} if write is PRun else {}
    write.run_problem_file(path, engine=engine, checkpoint_every=1, work_dir=str(killed),
                           **kwargs)
    ckpts = sorted(glob.glob(os.path.join(killed, "*.ckpt_*.npz")))
    assert len(ckpts) == 5
    for c in ckpts:
        if not c.endswith(".ckpt_2.npz"):
            os.remove(c)
    kwargs = {"device": "cpu"} if resume is PRun else {}
    m = resume.run_problem_file(path, engine=engine, dump=True, work_dir=str(killed),
                                resume=True, **kwargs)
    assert [r.level for r in m.supersteps] == [3, 4, 5]
    got = _dumps(killed)
    want = {k: v for k, v in _dumps(full).items() if int(k.rsplit("_", 1)[1]) > 2}
    assert got.keys() >= want.keys() and {k: got[k] for k in want} == want
    # Both packages load the same arrays and dtypes from it.
    ours = PCk.load_checkpoint(ckpts[1])
    ref = JCk.load_checkpoint(ckpts[1])
    for f in ours._fields:
        a, b = getattr(ours, f).numpy(), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_checkpoint_guards(tmp_path, caplog):
    base = str(tmp_path / "g.txt")
    st = P.SuperstepRunner(P.read_sedgewick(FILES[0]), device="cpu").init(0)
    PCk.save_checkpoint(f"{base}.ckpt_1.npz", st, source=0, engine="push")
    PCk.save_checkpoint(f"{base}.ckpt_2.npz", st, source=3, engine="push")
    with open(f"{base}.ckpt_3.npz", "wb") as f:
        f.write(b"PK\x03\x04 torn")
    with pytest.raises(PCk.CheckpointError):
        PCk.load_checkpoint(f"{base}.ckpt_3.npz")
    found = PCk.load_latest_checkpoint(base, expect={"source": 0, "engine": "push"})
    assert found is not None and found[1] == 1
    assert PCk.latest_checkpoint(base)[1] == 2
    with pytest.raises(ValueError):
        PCk.save_checkpoint(f"{base}.bad", (st.dist, st.parent))  # not a BfsState
    got = PCk.state_from_arrays([0, 1], [0, 0], [False, True], 1)
    want = JCk.state_from_arrays([0, 1], [0, 0], [False, True], 1)
    for f in got._fields:
        assert np.array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))


def test_run_parallel_main(tmp_path):
    props = tmp_path / "s.properties"
    props.write_text(f"problemFiles = {FILES[0]}, {FILES[1]}\nwork-dir = {tmp_path}\n")
    for extra in ([], ["--fused"], ["--engine", "pull"], ["--fused", "--engine", "push"]):
        PRun.main([str(props), "--device", "cpu", *extra])
    PRun.main([str(props), "--device", "cpu", "--dump"])
    assert len(_dumps(tmp_path)) == 4 + 6


def test_run_sequential_matches_reference(caplog, monkeypatch):
    monkeypatch.chdir(REPO)  # service.properties names its files from the checkout
    caplog.set_level(logging.DEBUG)
    for native in (True, False):
        for mod in (PSeq, JSeq):
            caplog.clear()
            for path in FILES:
                mod.run_problem_file(path, source=0, use_native=native, report=True)
            lines = [r.getMessage() for r in caplog.records if "Elapsed" not in r.getMessage()]
            if mod is PSeq:
                ours = lines
        assert ours == lines and len(ours) == 2 + 6 + 250
    PSeq.main([PROPS, "--python"])


def test_stopwatch_and_metrics_match_reference():
    from bfs_tpu.utils.timing import Stopwatch as JStopwatch

    for cls in (Stopwatch, JStopwatch):
        sw = cls.create_started()
        assert sw.running
        with pytest.raises(RuntimeError):
            sw.start()
        sw.stop()
        with pytest.raises(RuntimeError):
            sw.stop()
        assert sw.elapsed_s >= 0 and str(sw).split()[1] in ("s", "ms", "us")
        assert sw.reset().elapsed_s == 0.0
    m, jm = PM.RunMetrics(6, 16), JM.RunMetrics(6, 16)
    for r in ((1, 3, 0.5), (2, 2, 0.25), (3, 0, 0.25)):
        m.record(*r)
        jm.record(*r)
    assert m.to_json() == jm.to_json() and list(m.log_lines()) == list(jm.log_lines())
    assert (m.num_levels, m.vertices_settled, m.teps(num_traversals=2)) == (
        jm.num_levels, jm.vertices_settled, jm.teps(num_traversals=2))
    for vals in ([], [3.0], [5, 1, 4, 2, 3]):
        for q in (0, 50, 99, 100):
            assert PM.percentile(vals, q) == JM.percentile(vals, q)


def test_vertex_wire_format_matches_reference():
    g = P.read_sedgewick(FILES[1])
    jg = JGraph(g.num_vertices, g.src.copy(), g.dst.copy())
    res = P.bfs(g, 11, device="cpu")
    frontier = res.dist == 3
    text = PV.serialize_state(g, res.dist, res.parent, frontier, source=11)
    assert text == JV.serialize_state(jg, res.dist, res.parent, frontier, source=11)
    for a, b in zip(PV.parse_state(text, g.num_vertices), JV.parse_state(text, g.num_vertices)):
        np.testing.assert_array_equal(a, b)
    init = [v.serialize() for v in PV.initial_state_vertices(g, 11)]
    assert init == [v.serialize() for v in JV.initial_state_vertices(jg, 11)]
    line = "3|[2,  4, 5]|[0, 2, 3]|2|GRAY"
    assert PV.Vertex.parse(line).serialize() == JV.Vertex.parse(line).serialize()
    assert PV.Vertex.parse(line).with_color(PV.Color.BLACK).color == PV.Color.BLACK
    for bad in ("1|[]|[]|0", "1|2|[]|0|GRAY"):
        with pytest.raises(ValueError):
            PV.Vertex.parse(bad)
