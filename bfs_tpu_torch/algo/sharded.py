"""SSSP and CC over a mesh's edge shards: the port of ``bfs_tpu.algo.sharded``.

The push engine of the mesh (:class:`~bfs_tpu_torch.parallel.sharded.ShardedPushEngine`)
with the semiring swapped: each shard holds one round-robin edge shard
(``build_device_graph(num_shards=n)``), the per-vertex state is
replicated, the shards' candidates merge with ONE ``pmin`` over the graph
axis (:mod:`bfs_tpu_torch.parallel.compat`), and the state update runs
once.  SSSP's weights are a hash of the endpoints
(:func:`~bfs_tpu_torch.algo.substrate.edge_weights`), so each shard's
weights come from its own edges; the parents are made once at exit on the
flattened edges, as the single-chip run makes them.  Both run on the level
loop of :mod:`bfs_tpu_torch.algo.sssp` and :mod:`bfs_tpu_torch.algo.cc`,
unpacked (as the reference's), and equal the single-chip results bit for
bit (the ``pmin`` merge commutes with the segmented min).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..graph.csr import DeviceGraph, Graph, build_device_graph
from ..models import loop as L
from ..parallel.compat import GRAPH_AXIS
from ..parallel.sharded import make_mesh
from .cc import CcResult, _cc_run
from .sssp import SsspResult, _rounds_cap, _sssp_parents, init_sssp_state, sssp_loop, weights
from .substrate import DEFAULT_MAX_WEIGHT, clamp_cap, resolve_delta


def _shards(graph, num_shards: int | None, mesh, block: int):
    """The mesh (``num_shards`` on the visible cards when None) and the
    edge shards on its device: ``(mesh, src [n, E/n] int32, dst int64, V)``.
    ``graph``: a Graph, a single-shard DeviceGraph (split without a sort),
    or the DeviceGraph of the mesh's shard count itself."""
    if mesh is None:
        mesh = make_mesh(graph=num_shards, batch=1)
    n = mesh.shape[GRAPH_AXIS]
    if isinstance(graph, DeviceGraph) and graph.num_shards == n:
        dg = graph
    else:
        dg = build_device_graph(graph, num_shards=n, block=block)
    dev = mesh.device
    src = torch.from_numpy(np.ascontiguousarray(dg.src.reshape(n, -1))).to(dev)
    dst = torch.from_numpy(np.ascontiguousarray(dg.dst.reshape(n, -1))).to(dev, torch.int64)
    return mesh, src, dst, dg.num_vertices


def sssp_sharded(
    graph: Graph | DeviceGraph,
    source: int = 0,
    *,
    num_shards: int | None = None,
    mesh=None,
    max_weight: int = DEFAULT_MAX_WEIGHT,
    delta: int | str | None = None,
    max_rounds: int | None = None,
    block: int = 1024,
) -> SsspResult:
    """Edge-sharded SSSP (unpacked carry) on the mesh's device;
    ``num_shards`` defaults to the mesh's graph axis.  Bit-identical to
    :func:`bfs_tpu_torch.algo.sssp.sssp`'s unpacked arm."""
    from ..models.bfs import check_sources, to_host

    mesh, src, dst, v = _shards(graph, num_shards, mesh, block)
    check_sources(v, source)
    source = int(source)
    delta_i = resolve_delta(delta)
    cap = clamp_cap(_rounds_cap(v, max_weight, max_rounds))
    cache: dict = {}
    t0 = time.perf_counter()
    bl = sssp_loop(cache, src, dst, v, packed=False, delta=delta_i, max_weight=max_weight,
                   axis=GRAPH_AXIS)
    stats = bl.run(L.start(bl.buffers, init_sssp_state(v, source, delta_i, src.device)[:3], cap))
    t1 = time.perf_counter()
    flat_src, flat_dst = src.reshape(-1), dst.reshape(-1)
    dist = bl.buffers[0]
    w = weights(cache, src, dst, max_weight).reshape(-1)
    parent = _sssp_parents(dist, flat_src, flat_dst, w, source)
    dist_h, parent_h = to_host(dist[:v].contiguous(), parent[:v].contiguous())
    run = {"loop_s": t1 - t0, "result_s": time.perf_counter() - t1, **vars(stats)}
    return SsspResult(dist=dist_h, parent=parent_h, rounds=stats.level, max_weight=max_weight,
                      delta=delta_i, packed=False, run=run)


def cc_sharded(
    graph: Graph | DeviceGraph,
    *,
    num_shards: int | None = None,
    mesh=None,
    max_rounds: int | None = None,
    block: int = 1024,
) -> CcResult:
    """Edge-sharded connected components on the mesh's device; labels
    bit-identical to the single-chip push arm (one label fixpoint)."""
    mesh, src, dst, v = _shards(graph, num_shards, mesh, block)
    n = mesh.shape[GRAPH_AXIS]
    res = _cc_run((src, dst), v, "push_sharded", max_rounds, None, "blocks")
    return dataclasses.replace(res, engine=f"push_sharded_x{n}")
