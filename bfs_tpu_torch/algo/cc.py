"""Connected components as label-min propagation on the level loop.

The port of ``bfs_tpu.algo.cc``: the ``cc`` semiring row
(:data:`bfs_tpu_torch.algo.substrate.SEMIRINGS`).  Every vertex starts
labelled with its own id, active vertices contribute their label along
out-edges, the combine is the same segmented min, and a vertex whose label
improves joins the next frontier.  On the repo's bi-directed graphs the
fixpoint labels every vertex with the minimum id of its component, the
canonical representative of the union-find oracle
(:func:`bfs_tpu_torch.oracle.cc.union_find_labels`).

Rootless: the initial frontier is every vertex but the sentinel slot, and
the run ends when the frontier drains.  Monotone label descent makes any
schedule converge to the same fixpoint, so the push arm and the ELL pull
arm are value-identical.  The pull arm feeds
:func:`~bfs_tpu_torch.ops.pull.pull_candidates` (a value-agnostic gather and
row-min) the table ``where(frontier, label, INF)`` in place of BFS's
frontier-id table.  No packed arm: the label is the whole word.

Both arms run on a :class:`~bfs_tpu_torch.models.loop.BlockLoop` as
:mod:`bfs_tpu_torch.algo.sssp` does: each superstep gated by the control
block (a dead one keeps the label and frontier and raises no flag), ended
by ``loop_control``, captured once per edge set and replayed on a card.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from ..graph.csr import DeviceGraph
from ..graph.ell import PullGraph, build_pull_graph, device_ell
from ..models import loop as L
from ..ops import control as C
from ..ops import relay_cuda as K
from ..ops.packed import INT32_MAX
from ..ops.pull import pull_candidates
from ..ops.relax import combine_min
from .substrate import clamp_cap, drive_segments


class CcState(NamedTuple):
    """Loop carry: ``label`` int32[V+1] (slot V inert, holds V);
    ``frontier`` marks vertices whose label improved last superstep.  Inside
    the level loop the control block holds ``rounds`` and ``changed``."""

    label: torch.Tensor  # int32[V+1]
    frontier: torch.Tensor  # bool[V+1]
    rounds: torch.Tensor  # int32, 0-d
    changed: torch.Tensor  # bool, 0-d


def init_cc_state(num_vertices: int, device="cpu") -> CcState:
    n = num_vertices + 1
    label = torch.arange(n, dtype=torch.int32, device=device)
    frontier = torch.ones(n, dtype=torch.bool, device=device)
    frontier[num_vertices] = False
    return CcState(label, frontier, torch.zeros((), dtype=torch.int32, device=device),
                   torch.ones((), dtype=torch.bool, device=device))


def _apply_labels(state: CcState, cand: torch.Tensor, ctl: torch.Tensor | None = None) -> CcState:
    """Shared apply tail of the push and pull arms: strict label descent,
    improved set = next frontier, termination = nothing improved.  Gated by
    ``ctl`` in the level loop."""
    improved = cand < state.label
    if ctl is None:
        label = torch.where(improved, cand, state.label)
        return CcState(label, improved, state.rounds + 1, improved.any())
    live = ctl[C.LIVE] != 0
    improved = improved & live
    label = torch.where(improved, cand, state.label)
    frontier = torch.where(live, improved, state.frontier)
    return CcState(label, frontier, state.rounds, improved.any())


def _cc_candidates(state: CcState, src, dst, n: int, axis: str | None):
    if axis is not None:
        from ..parallel.compat import pmin

        return pmin(torch.stack([_cc_candidates(state, s, d, n, None)
                                 for s, d in zip(src, dst)]), axis)
    active = state.frontier.index_select(0, src)
    return combine_min(torch.where(active, state.label.index_select(0, src), INT32_MAX), dst, n)


def cc_superstep(state: CcState, src: torch.Tensor, dst: torch.Tensor,
                 ctl: torch.Tensor | None = None, axis: str | None = None) -> CcState:
    """One label-min superstep (push): active vertices send their label
    along out-edges; per destination the minimum wins.  With a mesh
    ``axis`` the edges are ``[n, E/n]`` shards merged with one ``pmin``."""
    n = state.label.shape[0]
    return _apply_labels(state, _cc_candidates(state, src, dst, n, axis), ctl)


def cc_superstep_pull(state: CcState, ell0: torch.Tensor, folds,
                      ctl: torch.Tensor | None = None) -> CcState:
    """Pull twin: gather and row-min over the ELL in-neighbour matrices with
    the label table in place of BFS's frontier-id table."""
    tab = torch.where(state.frontier, state.label, INT32_MAX)
    return _apply_labels(state, pull_candidates(tab, ell0, folds), ctl)


# ------------------------------------------------------------ host driver --


@dataclass
class CcResult:
    """Host-side labels (int32[V], sentinel slot stripped): ``label[v]`` is
    the minimum vertex id of v's component.  ``rounds`` counts executed
    supersteps including the final empty one that detects the fixpoint;
    ``run`` the host seconds and loop counts of the call."""

    label: np.ndarray
    rounds: int
    engine: str
    run: dict = field(default_factory=dict)

    @property
    def num_components(self) -> int:
        return int(np.unique(self.label).size)

    def same_component(self, u: int, v: int) -> bool:
        return int(self.label[u]) == int(self.label[v])


def _resolve_engine(engine: str, graph) -> str:
    """``auto`` picks pull at 8 or more edges per vertex (gather beats
    scatter on dense in-neighbour rows); any choice gives the same labels."""
    if engine != "auto":
        return engine
    v = max(graph.num_vertices, 1)
    return "pull" if graph.num_edges / v >= 8 else "push"


def _superstep_of(engine: str):
    """The superstep of an arm: ``pull``, ``push``, or ``push_sharded`` (a
    mesh's edge shards, :func:`bfs_tpu_torch.algo.sharded.cc_sharded`)."""
    if engine == "pull":
        return cc_superstep_pull
    if engine == "push_sharded":
        from ..parallel.compat import GRAPH_AXIS

        return lambda st, src, dst, ctl=None: cc_superstep(st, src, dst, ctl, axis=GRAPH_AXIS)
    return cc_superstep


def cc_loop(cache: dict, operands: tuple, num_vertices: int, engine: str) -> L.BlockLoop:
    """The block loop of one arm over its operands (``(src, dst)`` for
    push and ``push_sharded``, ``(ell0, folds)`` for pull), kept in
    ``cache``: buffers ``(label, frontier, ctl)``."""
    def make():
        dev = operands[0].device
        n = num_vertices + 1
        fields = (torch.empty(n, dtype=torch.int32, device=dev),
                  torch.empty(n, dtype=torch.bool, device=dev))
        ctl = C.new_ctl(dev)
        state = CcState(*fields, None, None)
        superstep = _superstep_of(engine)

        def step():
            new = superstep(state, *operands, ctl)
            for buf, val in zip(fields, new):
                buf.copy_(val)
            C.raise_flag(ctl, new.changed)
            K.loop_control(ctl)

        return (*fields, ctl), step

    return L.cached(cache, ("cc", engine), make, k=L.EDGE_BLOCK)


def _cc_run(operands: tuple, num_vertices: int, engine: str, max_rounds, cache, loop: str) -> CcResult:
    from ..models.bfs import to_host

    v = int(num_vertices)
    cap = clamp_cap(max_rounds if max_rounds is not None else v + 1)
    cache = {} if cache is None else cache
    t0 = time.perf_counter()
    init = init_cc_state(v, operands[0].device)
    if loop == "eager":
        superstep = _superstep_of(engine)
        st, stats = L.eager(init, lambda s: superstep(s, *operands), cap)
        label = st.label
    else:
        bl = cc_loop(cache, operands, v, engine)
        stats = bl.run(L.start(bl.buffers, init[:2], cap))
        label = bl.buffers[0]
    t1 = time.perf_counter()
    (label_h,) = to_host(label[:v].contiguous())
    run = {"loop_s": t1 - t0, "result_s": time.perf_counter() - t1, **vars(stats)}
    return CcResult(label=label_h, rounds=stats.level, engine=engine, run=run)


def cc_device(src, dst, num_vertices: int, *, max_rounds: int | None = None,
              cache: dict | None = None, loop: str = "blocks") -> CcResult:
    """The push arm on resident sentinel-padded edge tensors (``src`` int32,
    ``dst`` int64; another dtype is converted per call).  ``cache`` keeps
    the captured loop across calls on the same edges (an EdgeEngine's
    ``_loops``); ``loop="eager"`` runs the plain loop."""
    src = src if src.dtype == torch.int32 else src.to(torch.int32)
    dst = dst if dst.dtype == torch.int64 else dst.to(torch.int64)
    return _cc_run((src, dst), num_vertices, "push", max_rounds, cache, loop)


def cc_device_pull(ell0, folds, num_vertices: int, *, max_rounds: int | None = None,
                   cache: dict | None = None, loop: str = "blocks") -> CcResult:
    """The pull arm on resident ELL operands (the transposed ``[K, rows]``
    matrices of :func:`~bfs_tpu_torch.graph.ell.device_ell`); same
    fixpoint."""
    return _cc_run((ell0, tuple(folds)), num_vertices, "pull", max_rounds, cache, loop)


def cc(graph, *, engine: str | None = None, max_rounds: int | None = None,
       block: int = 1024, device=None) -> CcResult:
    """Connected components (``engine`` = push | pull | auto; push when
    None, as the reference's default) on the card unless ``device`` names
    the CPU.  ``graph`` is a :class:`Graph`, a layout (a :class:`DeviceGraph`
    for push, a :class:`PullGraph` for pull) or an
    :class:`~bfs_tpu_torch.models.bfs.EdgeEngine` (its engine is the arm
    unless ``engine`` names the other, which raises; its tensors, loops and
    ``loop`` setting are used).  On a
    bi-directed graph the labels are union-find's min-id representatives; on
    a directed graph this is the min reachable id fixpoint."""
    from ..models.bfs import EdgeEngine, resolve_device
    from .sssp import edge_operands

    if isinstance(graph, EdgeEngine):
        if getattr(graph, "mesh", None) is not None:
            raise ValueError("a sharded engine: use bfs_tpu_torch.algo.cc_sharded")
        if engine not in (None, "auto", graph.engine):
            raise ValueError(f"an EdgeEngine of {graph.engine!r} given for engine={engine!r}")
        if graph.engine == "pull":
            return cc_device_pull(graph.ell0, graph.folds, graph.num_vertices,
                                  max_rounds=max_rounds, cache=graph._loops, loop=graph.loop)
        return cc_device(graph.src, graph.dst, graph.num_vertices, max_rounds=max_rounds,
                         cache=graph._loops, loop=graph.loop)
    engine = _resolve_engine(engine or "push", graph)
    if engine == "pull":
        if isinstance(graph, DeviceGraph):
            raise ValueError("engine='pull' needs a Graph or PullGraph")
        pg = graph if isinstance(graph, PullGraph) else build_pull_graph(graph)
        ell0, folds = device_ell(pg, resolve_device(device))
        return cc_device_pull(ell0, folds, pg.num_vertices, max_rounds=max_rounds)
    if engine == "push":
        if isinstance(graph, PullGraph):
            raise ValueError("engine='push' needs a Graph or DeviceGraph")
        src, dst, v, cache, _loop = edge_operands(graph, device, block)
        return cc_device(src, dst, v, max_rounds=max_rounds, cache=cache)
    raise ValueError(f"unknown engine {engine!r}; use 'push', 'pull' or 'auto'")


def cc_segmented(graph, *, ckpt, max_rounds: int | None = None, block: int = 1024,
                 device=None) -> CcResult:
    """Checkpointed twin of the push arm: the fused run's own loop in
    bounded segments, an epoch per boundary (the reference's keys:
    ``label`` int32, ``frontier`` bool, ``rounds`` int32, ``changed`` bool,
    ``packed_flag``), bit-identical labels for any segmentation.  ``graph``
    as for :func:`cc` on push."""
    from ..models.bfs import to_host
    from ..resilience.superstep_ckpt import epoch_arrays, epoch_tensor
    from .sssp import edge_operands

    src, dst, v, cache, _loop = edge_operands(graph, device, block)
    cap = max_rounds if max_rounds is not None else v + 1
    bl = cc_loop(cache, (src, dst), v, "push")
    fields = dict(zip(("label", "frontier"), bl.buffers[:2]))

    def start(arrays):
        if arrays is None:
            L.start(bl.buffers, init_cc_state(v, src.device)[:2], 0)
            return 0, True
        for key, buf in fields.items():
            buf.copy_(epoch_tensor(arrays[key], src.device, buf.dtype))
        rounds, changed = int(np.asarray(arrays["rounds"])), bool(np.asarray(arrays["changed"]))
        C.resume_ctl(bl.ctl, rounds, changed, rounds)
        return rounds, changed

    def snapshot(rounds: int, changed: bool) -> dict:
        return epoch_arrays(fields, rounds=np.int32(rounds), changed=np.bool_(changed),
                            packed_flag=np.int32(False))

    t0 = time.perf_counter()
    stats, _rounds, _changed = drive_segments(ckpt, loop=bl, start=start, snapshot=snapshot,
                                              fields=CcState._fields, packed=False, cap=cap)
    t1 = time.perf_counter()
    (label_h,) = to_host(bl.buffers[0][:v].contiguous())
    ckpt.clear()
    run = {"loop_s": t1 - t0, "result_s": time.perf_counter() - t1, **vars(stats)}
    return CcResult(label=label_h, rounds=stats.level, engine="push", run=run)
