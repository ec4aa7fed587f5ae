"""Batched multi-source BFS: :class:`MultiBfsResult`, :func:`bfs_multi`,
:func:`bfs_multi_device`, :func:`bfs_multi_level_curve` and
:func:`collapse_multi_source`.

The port of ``bfs_tpu.models.multisource``; its direction variant is
:func:`bfs_tpu_torch.models.direction.bfs_multi_direction`.  The engine
work lives on
:class:`~bfs_tpu_torch.models.bfs.EdgeEngine` (push and pull: one
lock-step loop over ``[S, V+1]`` carries, the reference's
``_bfs_multi_fused`` and ``_bfs_multi_pull_fused``) and
:class:`~bfs_tpu_torch.models.bfs.RelayEngine` (``run_multi_elem``, the
element-major batch on the card, and ``run_multi``, the lock-step form).

Segments of the push and pull batch (the checkpointed runs of
:func:`bfs_tpu_torch.resilience.superstep_ckpt.run_multi_segmented` and
the serve tier's ``SegmentedBatchRunner``): :func:`multi_segment_init`
starts a batch's carry or rebuilds it from an epoch,
:meth:`~bfs_tpu_torch.models.bfs.EdgeEngine.segment` runs one bounded
segment of it on the engine's captured loop, :func:`multi_snapshot` copies
it to the host, and :func:`multi_segment_finish` unpacks it once, at the
true end.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..graph.csr import INF_DIST, NO_PARENT


@dataclass
class MultiBfsResult:
    """Per-source BFS trees in original ids: ``dist``/``parent`` are
    int32[S, V]; ``num_levels`` is the lock-step superstep count."""

    sources: np.ndarray
    dist: np.ndarray
    parent: np.ndarray
    num_levels: int


def multi_segment_init(eng, sources, packed: bool, restore: dict | None = None):
    """A batch's carry paused at its first segment boundary: a fresh
    batched state of ``sources`` on ``eng``'s device, or one rebuilt from an
    epoch's host arrays (``restore``: the state's fields by name, plus
    ``level`` and ``changed``; other keys are ignored).  The state is
    packed or not as ``packed`` says; its ``level`` is a host int and its
    ``changed`` a host bool."""
    from ..ops.relax import (
        BfsState,
        PackedBfsState,
        init_batched_state,
        init_packed_batched_state,
    )
    from ..resilience.superstep_ckpt import epoch_tensor

    cls = PackedBfsState if packed else BfsState
    if restore is not None:
        fields = [epoch_tensor(restore[f], eng.device) for f in cls._fields[:-2]]
        return cls(*fields, int(restore["level"]), bool(restore["changed"]))
    init = init_packed_batched_state if packed else init_batched_state
    sources = np.asarray(sources, dtype=np.int32).tolist()
    return init(eng.num_vertices, sources, eng.device)._replace(level=0, changed=True)


def multi_snapshot(state, packed: bool) -> dict:
    """A batch's carry as an epoch's host arrays: its fields (one copy to
    the host), ``level``, ``changed`` and ``packed_flag``, the keys and
    dtypes of the reference's epochs."""
    from ..resilience.superstep_ckpt import epoch_arrays

    fields = {f: getattr(state, f) for f in state._fields[:-2]}
    return epoch_arrays(fields, level=np.int32(state.level), changed=np.bool_(state.changed),
                        packed_flag=np.int32(packed))


def multi_segment_finish(state, packed: bool):
    """The one unpack at the true end of a segmented run (every epoch keeps
    the raw packed carry): an unpacked state on the device."""
    from ..ops.relax import unpack_bfs_state

    return unpack_bfs_state(state) if packed else state


def bfs_multi_device(graph, sources, *, engine: str = "pull", device=None,
                     max_levels: int | None = None, block: int = 1024,
                     packed: bool | None = None):
    """The device half of :func:`bfs_multi` for pull and push: ``(state,
    V)``, the batched :class:`~bfs_tpu_torch.ops.relax.BfsState` on the
    device.  ``packed=None`` runs the packed carry when parent ids fit;
    a run stopped by its 62-level cap then comes back with ``changed``
    set, which raw callers test themselves."""
    from .bfs import EdgeEngine  # bfs.py imports this module

    eng = EdgeEngine(graph, engine=engine, device=device, block=block)
    return eng.run_multi_device(sources, max_levels=max_levels, packed=packed), eng.num_vertices


def bfs_multi(graph, sources, *, engine: str = "pull", device=None,
              max_levels: int | None = None, block: int = 1024) -> MultiBfsResult:
    """Batched multi-source BFS on one card unless ``device`` names the
    CPU.  Engines as in :func:`~bfs_tpu_torch.models.bfs.bfs`: ``'pull'``
    (default, as in the reference), ``'push'``, or ``'relay'``
    (:meth:`RelayEngine.run_multi`).  Each tree equals its single-source
    search bit for bit; the packed carry is re-run unpacked past its cap."""
    from .bfs import EdgeEngine, RelayEngine  # bfs.py imports this module

    sources = np.atleast_1d(np.asarray(sources, dtype=np.int32))
    if engine == "relay":
        return RelayEngine(graph, device=device).run_multi(sources, max_levels=max_levels)
    eng = EdgeEngine(graph, engine=engine, device=device, block=block)
    return eng.run_multi(sources, max_levels=max_levels)


def bfs_multi_level_curve(graph, sources, *, engine: str = "pull", device=None,
                          max_levels: int | None = None, block: int = 1024) -> dict:
    """The global level curve of a lock-step batch on push or pull
    (occupancy summed over the trees; its total is the sum of the trees'
    reachable counts): one read of the accumulator at exit, the ``[S, V]``
    state stays on the device; past the packed cap from the unpacked
    re-run."""
    from .bfs import EdgeEngine  # bfs.py imports this module
    from .direction import DirectionConfig, DirectionEngine

    if engine not in ("pull", "push"):
        raise ValueError(f"unknown engine {engine!r}; use 'pull' or 'push'")
    sources = np.atleast_1d(np.asarray(sources, dtype=np.int32))
    eng = EdgeEngine(graph, engine=engine, device=device, block=block)
    return DirectionEngine(**{engine: eng}, config=DirectionConfig(mode=engine)).level_curve(
        sources.tolist(), max_levels=max_levels)


def collapse_multi_source(result: MultiBfsResult):
    """Reduce per-source trees to the oracle's multi-source answer:
    ``dist[v] = min_s dist_s[v]``, the parent from the argmin source's tree
    with the min-source tie-break."""
    order = np.argsort(result.sources, kind="stable")
    dist_s = result.dist[order]
    parent_s = result.parent[order]
    srcs = result.sources[order]
    best = np.argmin(dist_s, axis=0)  # first (= min source) among ties
    cols = np.arange(dist_s.shape[1])
    dist = dist_s[best, cols]
    parent = parent_s[best, cols]
    # A multi-source tree roots each source at itself (its own parent).
    is_source = np.isin(np.arange(dist.shape[0]), srcs) & (dist == 0)
    parent = np.where(is_source, np.arange(dist.shape[0]), parent)
    parent = np.where(dist == INF_DIST, NO_PARENT, parent)
    return dist.astype(np.int32), parent.astype(np.int32)
