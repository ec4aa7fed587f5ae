"""The port's block loop (``bfs_tpu_torch.models.loop``) on the CPU against
the JAX reference ``RelayEngine``, bit for bit: ``dist``, ``parent``,
``num_levels`` and ``changed``, at every block size, level bound and
fallback; and the control step with the gated updates' plain versions.

All comparisons are exact (tolerance 0): integer bit arithmetic.  On the
CPU a block runs its supersteps eagerly with the same gates and control
step as the card's captured block (``tests/test_torch_cuda.py`` holds the
capture against the eager loop on a card)."""

import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hs

import bfs_tpu_torch as P
from bfs_tpu_torch.models import loop as L
from bfs_tpu_torch.ops import control as C
from bfs_tpu_torch.ops import relay as R
from bfs_tpu_torch.ops import relay_cuda as K
from bfs_tpu_torch.ops import relay_elem as RE
from bfs_tpu_torch.utils import cuda_build

from bfs_tpu.graph import benes as j_benes
from bfs_tpu.graph.csr import Graph as JGraph
from bfs_tpu.models.bfs import RelayEngine as JRelayEngine

pytestmark = pytest.mark.skipif(
    not j_benes.native_available(), reason="native benes router unavailable"
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "test-sets", "tinyCG.txt")

GRAPHS = {
    "tinyCG": (lambda: P.read_sedgewick(TINY), (0, 3)),
    "path100": (lambda: P.path_graph(100), (0, 50)),  # past the packed cap
    "rmat10": (lambda: P.rmat_graph(10, 6, seed=1), (1, 400)),
    "gnm": (lambda: P.gnm_graph(300, 450, seed=5), (0, 7)),
}
BLOCKS = (1, 2, 3, 8)


def _jgraph(g: P.Graph) -> JGraph:
    return JGraph(g.num_vertices, g.src.copy(), g.dst.copy())


_REF: dict = {}


def _reference(name: str, expansion: str = "gather"):
    """``(graph, reference engine)``, built once per graph and arm."""
    key = (name, expansion)
    if key not in _REF:
        g = GRAPHS[name][0]()
        _REF[key] = g, JRelayEngine(_jgraph(g), expansion=expansion)
    return _REF[key]


def _assert_same_result(got, want):
    np.testing.assert_array_equal(got.dist, want.dist)
    np.testing.assert_array_equal(got.parent, want.parent)
    assert got.num_levels == int(want.num_levels)


def _assert_same_states(got, want):
    """Port states of ``run_many_device`` against the reference's."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.dist.numpy(), np.asarray(b.dist))
        np.testing.assert_array_equal(a.parent.numpy(), np.asarray(b.parent))
        assert a.level == int(b.level)
        assert a.changed == bool(b.changed)


@pytest.mark.parametrize("k", BLOCKS)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_block_loop_matches_reference(monkeypatch, name, k):
    """``run`` and ``run_many_device`` on blocks of ``k`` supersteps; one
    host read per block, ``k`` supersteps issued per read, and as many live
    supersteps as levels."""
    monkeypatch.setattr(L, "BLOCK", k)
    g, ref = _reference(name)
    eng = P.RelayEngine(g, device="cpu", sparse_hybrid=False)  # the dense block loop
    for s in GRAPHS[name][1]:
        got = eng.run(s)
        _assert_same_result(got, ref.run(s))
        run = eng.last_run
        assert run["issued"] == k * run["host_reads"] and run["replays"] == 0
        if got.num_levels <= 62:  # the packed carry alone
            assert run["live"] == run["level"] == got.num_levels
            assert run["host_reads"] == -(-got.num_levels // k)
        else:  # 62 packed levels, then the unpacked re-run
            assert run["live"] == 62 + got.num_levels
            assert run["host_reads"] == -(-62 // k) + -(-got.num_levels // k)
    roots = list(GRAPHS[name][1])
    _assert_same_states(eng.run_many_device(roots), ref.run_many_device(roots))


@pytest.mark.parametrize("max_levels", [1, 2, 5])
@pytest.mark.parametrize("expansion", ["gather", "mxu"])
def test_max_levels_on_both_arms(expansion, max_levels):
    g, ref = _reference("rmat10", expansion)
    eng = P.RelayEngine(g, device="cpu", expansion=expansion)
    for s in GRAPHS["rmat10"][1]:
        got = eng.run(s, max_levels=max_levels)
        _assert_same_result(got, ref.run(s, max_levels=max_levels))
        assert got.num_levels == eng.last_run["level"] <= max_levels
    roots = list(GRAPHS["rmat10"][1])
    _assert_same_states(eng.run_many_device(roots, max_levels=max_levels),
                        ref.run_many_device(roots, max_levels=max_levels))


@pytest.mark.parametrize("length", [62, 63, 100])
def test_packed_cap_edge_and_unpacked_rerun(length):
    """Eccentricity 61 converges in the packed carry's 62 levels; 62 and 99
    stop on its cap with ``changed`` set and re-run unpacked.  On both arms,
    and ``run_many_device`` returns the packed carry's truncated state as
    the reference does."""
    g = P.path_graph(length)
    for expansion in ("gather", "mxu"):
        ref = JRelayEngine(_jgraph(g), expansion=expansion)
        eng = P.RelayEngine(g, device="cpu", expansion=expansion)
        got = eng.run(0)
        _assert_same_result(got, ref.run(0))
        assert got.num_levels == length
        rerun = length > 62
        assert eng.last_run["live"] == (62 if rerun else 0) + length
        _assert_same_states(eng.run_many_device([0, length - 1]),
                            ref.run_many_device([0, length - 1]))


ELEM = {
    "tinyCG32": (lambda: P.read_sedgewick(TINY), np.arange(32) % 6),
    "rmat10_64": (lambda: P.rmat_graph(10, 6, seed=1),
                  np.random.default_rng(3).choice(1024, 64, replace=False)),
    "ecc31": (lambda: P.path_graph(32), np.zeros(32)),  # converges on the step past the cap
    "ecc32": (lambda: P.path_graph(33), np.arange(32)),  # falls back
}


def _elem_reference(name: str):
    """``(graph, sources, reference device state, reference result)``,
    computed once per case."""
    if name not in _REF:
        make, sources = ELEM[name]
        g = make()
        sources = np.asarray(sources, dtype=np.int32)
        ref = JRelayEngine(_jgraph(g))
        _REF[name] = g, sources, ref.run_multi_elem_device(sources), ref.run_multi_elem(sources)
    return _REF[name]


@pytest.mark.parametrize("k", BLOCKS)
@pytest.mark.parametrize("name", list(ELEM))
def test_elem_block_loop_matches_reference(monkeypatch, name, k):
    monkeypatch.setattr(L, "BLOCK", k)
    g, sources, jst, want = _elem_reference(name)
    eng = P.RelayEngine(g, device="cpu")
    st = eng.run_multi_elem_device(sources)
    assert (st.level, st.changed) == (int(jst.level), bool(jst.changed))
    for a, b in zip(st[:4], jst[:4]):
        np.testing.assert_array_equal(a.numpy().view(np.uint32), np.asarray(b))
    run = eng.last_run
    assert run["live"] == st.level and run["host_reads"] == -(-st.level // k)
    assert st.changed == (name == "ecc32")
    if name == "ecc31":
        assert st.level == 32  # the step past the cap proves convergence
    got = eng.run_multi_elem(sources)
    np.testing.assert_array_equal(got.dist, want.dist)
    np.testing.assert_array_equal(got.parent, want.parent)
    assert got.num_levels == int(want.num_levels)


@pytest.mark.parametrize("kind", ["packed", "unpacked", "elem"])
def test_dead_block_changes_nothing(kind):
    """A block issued after its run converged (every superstep dead)
    leaves the carry and the control block bit-identical."""
    g = P.rmat_graph(10, 6, seed=1)
    eng = P.RelayEngine(g, device="cpu", sparse_hybrid=False)
    if kind == "elem":
        eng.run_multi_elem_device(np.arange(32, dtype=np.int32) * 3)
        loop = eng._elem_loop(1)
    else:
        eng.packed = kind == "packed"
        eng.run(400)
        loop = eng._packed_loop() if kind == "packed" else eng._unpacked_loop()
    before = [b.clone() for b in loop.buffers]
    assert before[-1][C.LIVE] == 0
    loop.dead_replay()
    for a, b in zip(before, loop.buffers):
        assert torch.equal(a, b)


def test_eager_loop_is_the_plain_version():
    """The eager loop (a host read per level) gives the block loop's
    results, with one read per level."""
    g = P.rmat_graph(10, 6, seed=1)
    eng = P.RelayEngine(g, device="cpu", sparse_hybrid=False)
    blocks = eng.run(400)
    eng.loop = "eager"
    eager = eng.run(400)
    _assert_same_result(eager, blocks)
    assert eng.last_run["host_reads"] == eng.last_run["issued"] == eager.num_levels
    sources = np.arange(32, dtype=np.int32) * 17
    a = eng.run_multi_elem(sources)
    eng.loop = "blocks"
    b = eng.run_multi_elem(sources)
    np.testing.assert_array_equal(a.dist, b.dist)
    np.testing.assert_array_equal(a.parent, b.parent)
    assert a.num_levels == b.num_levels


# ------------------------------------------------ the control step and gates --

def test_control_words_mirror_the_cuda_header():
    header = cuda_build.csrc("control.cuh")
    for name, word in (("kCtlLevel", C.LEVEL), ("kCtlChanged", C.CHANGED),
                       ("kCtlLive", C.LIVE), ("kCtlCap", C.CAP), ("kCtlFlag", C.FLAG),
                       ("kCtlSteps", C.STEPS)):
        assert cuda_build.constant(header, name) == word
    assert max(C.LEVEL, C.CHANGED, C.LIVE, C.CAP, C.FLAG, C.STEPS) < C.WORDS


def _ctl(level: int, changed: int, live: int, cap: int, steps: int = 0) -> torch.Tensor:
    ctl = C.new_ctl("cpu")
    ctl[C.LEVEL], ctl[C.CHANGED], ctl[C.LIVE], ctl[C.CAP], ctl[C.STEPS] = (
        level, changed, live, cap, steps)
    return ctl


@pytest.mark.parametrize("cap", [0, 1, 5])
def test_control_step_runs_the_reference_condition(cap):
    """``init_ctl`` then the control step after each superstep: live exactly
    while ``changed and level < cap``; a dead step changes no word."""
    ctl = C.new_ctl("cpu")
    assert C.init_ctl(ctl, cap) == (cap > 0)
    flags = [1, 1, 0, 1]
    level = 0
    for f in flags:
        before = ctl.clone()
        live = bool(ctl[C.LIVE])
        C.raise_flag(ctl, torch.tensor(bool(f)) & live)
        C.loop_control(ctl)
        if not live:
            assert torch.equal(ctl, before)
            continue
        level += 1
        assert ctl[C.LEVEL] == level and ctl[C.STEPS] == level
        assert ctl[C.CHANGED] == f and ctl[C.FLAG] == 0
        assert bool(ctl[C.LIVE]) == (bool(f) and level < cap)


def _u32(rng, n):
    w = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    w[rng.random(n) < 0.3] = 0xFFFFFFFF
    return torch.from_numpy(w.view(np.int32))


@settings(max_examples=40, deadline=None)
@given(seed=hs.integers(0, 2**31 - 1), level=hs.integers(0, 61),
       changed=hs.integers(0, 1), live=hs.integers(0, 1))
def test_gated_packed_updates(seed, level, changed, live):
    """The gated plain updates (packed and unpacked) and their CPU wrapper:
    live, each equals the ungated update at the control block's level; not
    live, state, level and changed stay as they were."""
    rng = np.random.default_rng(seed)
    vr = 64
    lv = rng.integers(0, 63, vr).astype(np.uint32)
    packed = torch.from_numpy(((lv << np.uint32(26)) | rng.integers(0, 1 << 20, vr).astype(np.uint32)
                               ).view(np.int32))
    packed[torch.from_numpy(rng.random(vr) < 0.4)] = -1
    rank = _u32(rng, vr)
    fwords = _u32(rng, vr // 32)
    st = R.PackedRelayState(packed, fwords, None, None)
    # A dead superstep's block: not changed, or at its cap.
    changed, cap = (1, 62) if live else (changed, 62 if not changed else level)
    ctl = _ctl(level, changed, live, cap)
    got = R.apply_relay_candidates_packed(st, rank, ctl)
    if live:
        want = R.apply_relay_candidates_packed(st._replace(level=level), rank)
        assert torch.equal(got.packed, want.packed) and torch.equal(got.fwords, want.fwords)
        assert bool(got.changed) == bool(want.changed)
    else:
        assert torch.equal(got.packed, packed) and torch.equal(got.fwords, fwords)
        assert not bool(got.changed)
    # The wrapper on the CPU: in place, the flag raised in the block.
    work = st._replace(packed=packed.clone(), fwords=fwords.clone())
    before = ctl.clone()
    K.apply_relay_candidates_packed(work, rank, fwords_out=work.fwords, ctl=ctl)
    assert torch.equal(work.packed, got.packed) and torch.equal(work.fwords, got.fwords)
    assert ctl[C.FLAG] == int(bool(got.changed))
    K.loop_control(ctl)
    if not live:
        assert torch.equal(ctl, before)

    dist = torch.from_numpy(np.where(rng.random(vr) < 0.5, 2**31 - 1,
                                     rng.integers(0, 9, vr)).astype(np.int32))
    parent = torch.from_numpy(rng.integers(-1, 500, vr).astype(np.int32))
    cand = torch.from_numpy(np.where(rng.random(vr) < 0.5, 2**31 - 1,
                                     rng.integers(0, 500, vr)).astype(np.int32))
    ust = R.RelayState(dist, parent, fwords, None, None)
    got = R.apply_relay_candidates(ust, cand, _ctl(level, changed, live, cap))
    if live:
        want = R.apply_relay_candidates(ust._replace(level=level), cand)
        for a, b in zip(got[:3], want[:3]):
            assert torch.equal(a, b)
    else:
        for a, b in zip(got[:3], (dist, parent, fwords)):
            assert torch.equal(a, b)
        assert not bool(got.changed)


@settings(max_examples=25, deadline=None)
@given(seed=hs.integers(0, 2**31 - 1), level=hs.integers(0, 32), live=hs.integers(0, 1))
def test_gated_elem_update(seed, level, live):
    """``apply_elem_found`` with a control block: live, it equals the
    host-level update (the level's bits as tensor ops, none at 32); not
    live, every plane and the frontier stay as they were."""
    rng = np.random.default_rng(seed)
    rg = P.build_relay_graph(P.rmat_graph(6, 4, seed=seed % 7))
    offsets, pt = RE.rank_plane_layout(rg.in_classes)
    g, vr = 2, rg.vr
    st = RE.ElemState(_u32(rng, g * vr).reshape(g, vr), _u32(rng, g * vr).reshape(g, vr),
                      _u32(rng, RE.DIST_PLANES * g * vr).reshape(RE.DIST_PLANES, g, vr),
                      _u32(rng, g * pt).reshape(g, pt), None, None)
    found, rp = _u32(rng, g * vr).reshape(g, vr), _u32(rng, g * pt).reshape(g, pt)
    got = RE.apply_elem_found(st, found, rp, rg.in_classes, offsets, _ctl(level, 1, live, 32))
    if live:
        want = RE.apply_elem_found(st._replace(level=level), found, rp, rg.in_classes, offsets)
    else:
        want = st
        assert not bool(got.changed)
    for a, b in zip(got[:4], want[:4]):
        assert torch.equal(a, b)
