"""Landmark distance-label tier: the port of ``bfs_tpu.serve.labels``.

A point query ``dist(u, v)`` on the exact path pays a full traversal from
``u``.  At ``register()`` time the server instead sweeps K landmark roots
once through the batched engine and answers point queries from the
resulting **distance labels** in one small batched gather and min:

* **schema** — ``dist: uint16[K, V]`` (0xFFFF = unreachable) is the
  device-resident half; ``parent: int32[K, V]`` and ``landmarks: int32[K]``
  stay on the host for path reconstruction.  Every graph the port builds is
  undirected, so one forward label set serves both query directions.
* **tightness certificate** — ``upper = min_k(d[k,u] + d[k,v])`` and
  ``lower = max_k |d[k,u] - d[k,v]|`` bound the true distance.  When
  ``upper == max(lower, 1)`` (or ``u == v``) the bound is exact and the
  label answer ships; the walk u -> landmark -> v of that length is a
  shortest path, which :meth:`LabelOracle.path` reconstructs.  A landmark
  reaching exactly one of ``u, v`` certifies the pair disconnected.
  Anything else falls back to the exact traversal: labels only ever make
  answers faster, never wrong.
* **content addressing** — the index is a pure function of (graph content,
  K, label code version), cached as a sidecar bundle beside the layout
  bundle (:func:`bfs_tpu_torch.cache.layout.load_or_build_labels`), in the
  reference's format and under the reference's key, and budget-gated
  (``BFS_TPU_TORCH_LABELS_GB``).
* **resilience** — the K-root sweep runs in chunks, each a durable epoch
  of the superstep-checkpoint store under the reference's config, so a
  killed build resumes at the last chunk boundary bit for bit.  Built rows
  are sample-verified with the :class:`~bfs_tpu_torch.oracle.device.DeviceChecker`.

**On the card.**  The rows live on the device as ``int16`` tensors holding
the uint16 bit patterns (``torch.uint16`` has few CUDA kernels, advanced
indexing not among them): the same K x V x 2 bytes, widened in the lookup
with ``.to(torch.int32) & 0xFFFF``.  The lookup (:func:`label_bounds`) is
plain torch, as the reference's is plain XLA.  Every device call of the
tier (the sweep, the row checks, the upload of the rows, each lookup) runs
under the server's device lock
(:data:`~bfs_tpu_torch.serve.executor.DEVICE_LOCK`), since a CUDA graph
captured on another thread forbids concurrent CUDA calls: a lookup waits
for a running tick.
"""

from __future__ import annotations

import hashlib
import logging
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import knobs
from ..graph.csr import INF_DIST, NO_PARENT, Graph
from .executor import DEVICE_LOCK

logger = logging.getLogger(__name__)

#: Bumped on any change to the label math or array schema; part of the
#: sidecar bundle key (the reference's value: bundles cross-load).
LABELS_VERSION = 1

#: uint16 unreachable sentinel inside the label rows.
LABEL_INF = 0xFFFF

#: Landmark roots swept per multi-source chunk (and per checkpoint epoch).
DEFAULT_CHUNK = 64


class LabelBudgetError(ValueError):
    """The label index does not fit ``BFS_TPU_TORCH_LABELS_GB``: the server
    serves exact-only rather than evicting engines."""


@dataclass(frozen=True)
class LabelIndex:
    """One graph's landmark distance labels (host arrays)."""

    landmarks: np.ndarray  # int32[K]
    dist: np.ndarray       # uint16[K, V], LABEL_INF = unreachable
    parent: np.ndarray     # int32[K, V], NO_PARENT = unreached
    num_vertices: int

    @property
    def k(self) -> int:
        return int(self.landmarks.shape[0])

    @property
    def device_bytes(self) -> int:
        """Bytes the resident half (the dist rows) costs on the device."""
        return int(self.dist.nbytes)

    @property
    def nbytes(self) -> int:
        return int(self.dist.nbytes + self.parent.nbytes + self.landmarks.nbytes)


def labels_to_arrays(idx: LabelIndex) -> dict:
    return {
        "dims": np.asarray([LABELS_VERSION, idx.k, idx.num_vertices], dtype=np.int64),
        "landmarks": np.asarray(idx.landmarks, dtype=np.int32),
        "dist": np.asarray(idx.dist, dtype=np.uint16),
        "parent": np.asarray(idx.parent, dtype=np.int32),
    }


def labels_from_arrays(arrays: dict) -> LabelIndex:
    dims = np.asarray(arrays["dims"])
    if int(dims[0]) != LABELS_VERSION:
        raise ValueError(f"label bundle version {int(dims[0])} != {LABELS_VERSION}")
    return LabelIndex(
        landmarks=np.asarray(arrays["landmarks"]),
        dist=np.asarray(arrays["dist"]),
        parent=np.asarray(arrays["parent"]),
        num_vertices=int(dims[2]),
    )


# ------------------------------------------------------------- sampling --

def sample_landmarks(graph: Graph, k: int) -> np.ndarray:
    """K degree-weighted landmark roots, int32 and sorted, deterministic per
    graph content: the generator is seeded from the blake2b of
    :func:`~bfs_tpu_torch.cache.layout.graph_content_hash`, so both packages
    pick the same landmarks for the same graph and the sidecar key needs
    only (graph, K).  Zero-degree vertices are never landmarks; K is
    clamped to the number of usable roots."""
    from ..cache.layout import graph_content_hash

    if k < 1:
        raise ValueError(f"need k >= 1 landmarks (got {k})")
    v = int(graph.num_vertices)
    src = np.asarray(graph.src).reshape(-1)
    src = src[(src >= 0) & (src < v)]  # drop a DeviceGraph's sentinel padding
    deg = np.bincount(src, minlength=v).astype(np.float64)
    usable = np.flatnonzero(deg > 0)
    if usable.size == 0:
        # Edgeless: every pair is u == v or disconnected; any vertex serves.
        return np.zeros((min(k, graph.num_vertices),), dtype=np.int32)
    seed = int.from_bytes(
        hashlib.blake2b(graph_content_hash(graph).encode(), digest_size=8).digest(), "big")
    rng = np.random.default_rng(seed)
    k_eff = min(int(k), int(usable.size))
    p = deg[usable] / deg[usable].sum()
    picked = rng.choice(usable, size=k_eff, replace=False, p=p)
    return np.sort(picked).astype(np.int32)


# ---------------------------------------------------------------- build --

def build_label_index(
    graph: Graph,
    k: int,
    *,
    engine: str = "pull",
    chunk: int = DEFAULT_CHUNK,
    ckpt_dir: str | os.PathLike | None = None,
    verify_rows: int = 2,
    device=None,
    sweep=None,
) -> LabelIndex:
    """Sweep K landmark roots through the batched engine and pack the
    forests into a :class:`LabelIndex`.

    The sweep runs in ``chunk``-root slices, each on the device lock.
    ``sweep(roots)`` returns the slice's
    :class:`~bfs_tpu_torch.models.multisource.MultiBfsResult`; by default
    :func:`~bfs_tpu_torch.models.multisource.bfs_multi` on ``engine`` and
    ``device`` (a fresh engine per slice, as the reference's), and the
    server passes its registry's resident engine.  Either gives the same
    rows, bit for bit.  With superstep checkpointing on
    (``BFS_TPU_TORCH_CKPT``), every finished slice is a durable epoch keyed
    on (graph content, K, engine, chunk), the reference's config: a killed
    build resumes at the last chunk boundary.  ``verify_rows`` sampled
    forests are checked with the :class:`DeviceChecker` before the index is
    returned."""
    from ..cache.layout import graph_content_hash
    from ..resilience.superstep_ckpt import SuperstepCheckpointer

    if sweep is None:
        from ..models.multisource import bfs_multi

        def sweep(roots):
            return bfs_multi(graph, roots, engine=engine, device=device)

    landmarks = sample_landmarks(graph, k)
    kk, v = int(landmarks.shape[0]), int(graph.num_vertices)
    chunk = max(1, int(chunk))
    dist16 = np.full((kk, v), LABEL_INF, dtype=np.uint16)
    parent = np.full((kk, v), NO_PARENT, dtype=np.int32)

    if ckpt_dir is None:
        from ..config import cache_root

        ckpt_dir = os.path.join(cache_root(), "ckpt")
    ckpt = SuperstepCheckpointer(ckpt_dir, {
        "kind": "labels", "graph": graph_content_hash(graph), "k": kk, "engine": engine,
        "chunk": chunk,
    })
    start = 0
    if ckpt.enabled:
        found = ckpt.load_latest()
        if found is not None:
            ep, arrays, _ = found
            dist16[:] = np.asarray(arrays["dist"], dtype=np.uint16)
            parent[:] = np.asarray(arrays["parent"], dtype=np.int32)
            start = int(ep)
            logger.info("label precompute resuming at chunk %d/%d", start, -(-kk // chunk))

    for ci in range(start, -(-kk // chunk)):
        roots = landmarks[ci * chunk:(ci + 1) * chunk]
        with DEVICE_LOCK:
            res = sweep(roots)
        d = np.asarray(res.dist)
        ecc = int(d.max(where=d != INF_DIST, initial=0))
        if ecc >= LABEL_INF:
            raise ValueError(f"graph eccentricity {ecc} exceeds the uint16 label range; "
                             "label tier unavailable")
        rows = slice(ci * chunk, ci * chunk + roots.shape[0])
        dist16[rows] = np.minimum(d, LABEL_INF)  # unreached (INF_DIST) -> LABEL_INF
        parent[rows] = np.asarray(res.parent)
        # Chunk boundary = durable epoch = kill point (the fault boundary
        # fires inside save_epoch after the write, also with checkpoints off).
        ckpt.save_epoch(ci + 1, {"dist": dist16, "parent": parent})
    if ckpt.enabled:
        ckpt.clear()

    idx = LabelIndex(landmarks=landmarks, dist=dist16, parent=parent, num_vertices=v)
    _verify_rows(graph, idx, verify_rows, device)
    return idx


def _verify_rows(graph: Graph, idx: LabelIndex, rows: int, device=None) -> None:
    """Sample-verify built forests with the DeviceChecker, the verdict
    every sampled serve reply goes through; a violation raises (the index
    is never served)."""
    if rows < 1 or idx.k == 0:
        return
    from ..oracle.device import DeviceChecker

    take = np.linspace(0, idx.k - 1, min(int(rows), idx.k)).astype(int)
    with DEVICE_LOCK:
        checker = DeviceChecker.from_graph(graph, device=device)
        for r in np.unique(take):
            d = np.where(idx.dist[r] == LABEL_INF, INF_DIST, idx.dist[r].astype(np.int32))
            bad = checker.check(d, idx.parent[r], np.asarray([idx.landmarks[r]], dtype=np.int32))
            if bad:
                raise ValueError(f"label row for landmark {int(idx.landmarks[r])} failed "
                                 f"device verification: {bad}")
        del checker


# -------------------------------------------------------- device lookup --

def label_bounds(rows: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """One batched label lookup on the rows' device: gather both label
    columns, reduce over the landmark axis.  ``rows`` is int16[K, V] holding
    the uint16 labels' bits; ``u``/``v`` int64[B] on the same device.

    Returns ``(dist, tight, best_k, upper, lower)`` over the pair batch
    (int32, bool, int32, int32, int32): ``tight`` marks answers that are
    provably exact (``u == v``, the sandwich ``upper == max(lower, 1)``, or
    a landmark that sees exactly one endpoint, ``dist == INF_DIST``);
    ``best_k`` is the first landmark reaching ``upper``."""
    du = rows[:, u].to(torch.int32) & LABEL_INF  # [K, B]
    dv = rows[:, v].to(torch.int32) & LABEL_INF
    fu = du != LABEL_INF
    fv = dv != LABEL_INF
    both = fu & fv
    up = torch.where(both, du + dv, INF_DIST)
    upper, best_k = torch.min(up, dim=0)  # the first minimum, as argmin's
    zero = torch.zeros((), dtype=torch.int32, device=rows.device)
    lower = torch.where(both, (du - dv).abs(), zero).amax(dim=0)
    unreach = (fu != fv).any(dim=0)
    same = u == v
    covered = both.any(dim=0)
    tight = same | unreach | (covered & (upper == lower.clamp_min(1)))
    inf = torch.full((), INF_DIST, dtype=torch.int32, device=rows.device)
    dist = torch.where(same, zero, torch.where(unreach, inf, upper))
    return dist, tight, best_k.to(torch.int32), upper, lower


def host_label_bounds(dist16: np.ndarray, u, v):
    """:func:`label_bounds` evaluated in numpy on the host rows (uint16):
    what the device lookup is held against on the card."""
    u = np.atleast_1d(np.asarray(u, dtype=np.int64))
    v = np.atleast_1d(np.asarray(v, dtype=np.int64))
    du = np.asarray(dist16[:, u], dtype=np.int32)
    dv = np.asarray(dist16[:, v], dtype=np.int32)
    fu, fv = du != LABEL_INF, dv != LABEL_INF
    both = fu & fv
    up = np.where(both, du + dv, INF_DIST).astype(np.int32)
    upper = up.min(axis=0)
    best_k = up.argmin(axis=0).astype(np.int32)
    lower = np.where(both, np.abs(du - dv), 0).max(axis=0).astype(np.int32)
    unreach = (fu != fv).any(axis=0)
    same = u == v
    tight = same | unreach | (both.any(axis=0) & (upper == np.maximum(lower, 1)))
    dist = np.where(same, 0, np.where(unreach, INF_DIST, upper)).astype(np.int32)
    return dist, tight, best_k, upper, lower


# ---------------------------------------------------------------- oracle --

class LabelOracle:
    """Device-resident query object over one :class:`LabelIndex`.

    Holds the dist rows on the device (budget-gated; int16 bits of the
    uint16 labels, K x V x 2 bytes) and the parent forest on the host;
    answers batched ``dist``/``path`` point queries with one lookup
    (:func:`label_bounds`) and one copy back per batch, on the device lock.
    ``device``: the card unless ``"cpu"``."""

    def __init__(self, index: LabelIndex, *, budget_bytes: int | None = None, device=None):
        from ..models.bfs import resolve_device

        if budget_bytes is not None and index.device_bytes > budget_bytes:
            raise LabelBudgetError(
                f"label index is {index.device_bytes >> 20} MB on device, over the "
                f"{budget_bytes >> 20} MB budget (BFS_TPU_TORCH_LABELS_GB)")
        self.index = index
        self.device = resolve_device(device)
        bits = np.ascontiguousarray(index.dist, dtype=np.uint16).view(np.int16)
        with DEVICE_LOCK:
            self._dist_dev = torch.from_numpy(bits).to(self.device)
        self.queries = 0  # guarded-by: DEVICE_LOCK
        self.tight_hits = 0  # guarded-by: DEVICE_LOCK

    @property
    def k(self) -> int:
        return self.index.k

    @property
    def device_bytes(self) -> int:
        return self.index.device_bytes

    def bounds(self, u, v):
        """``(dist, tight, best_k, upper, lower)`` as host numpy arrays over
        the pair batch: one upload of the pairs, one copy back."""
        u = np.atleast_1d(np.asarray(u, dtype=np.int32))
        v = np.atleast_1d(np.asarray(v, dtype=np.int32))
        if u.shape != v.shape:
            raise ValueError("u and v batches must have equal shape")
        nv = self.index.num_vertices
        if u.size and (int(min(u.min(), v.min())) < 0 or int(max(u.max(), v.max())) >= nv):
            raise ValueError(f"query vertex outside [0, {nv})")
        pairs = torch.from_numpy(np.stack([u, v]).astype(np.int64))
        with DEVICE_LOCK:
            pairs = pairs.to(self.device)
            out = label_bounds(self._dist_dev, pairs[0], pairs[1])
            host = torch.stack([out[0], out[1].to(torch.int32), *out[2:]]).cpu().numpy()
            self.queries += int(u.size)
            self.tight_hits += int(host[1].sum())
        return host[0], host[1].astype(bool), host[2], host[3], host[4]

    def dist(self, u, v):
        """``(dist, tight, best_k)`` for a pair batch; ``dist`` is exact
        wherever ``tight`` holds and an upper bound elsewhere (callers fall
        back on non-tight pairs)."""
        d, tight, best_k, _, _ = self.bounds(u, v)
        return d, tight, best_k

    def dist_one(self, u: int, v: int):
        d, tight, best_k = self.dist([u], [v])
        return int(d[0]), bool(tight[0]), int(best_k[0])

    def path(self, u: int, v: int):
        """An exact shortest path ``[u, ..., v]`` when the certificate is
        tight and the pair connected, else None (the caller falls back to a
        traversal): the u -> landmark and landmark -> v legs from the host
        parent forest, of length ``d(k,u) + d(k,v) == d(u,v)``."""
        if u == v:
            return [int(u)]
        d, tight, best_k, _, _ = self.bounds([u], [v])
        if not bool(tight[0]) or int(d[0]) >= INF_DIST:
            return None
        row = self.index.parent[int(best_k[0])]
        lm = int(self.index.landmarks[int(best_k[0])])
        a = self._chain(row, int(u), lm)
        b = self._chain(row, int(v), lm)
        if a is None or b is None:
            return None
        return a + b[::-1][1:]

    def _chain(self, parent_row, start: int, landmark: int):
        chain = [start]
        cur = start
        limit = self.index.num_vertices
        while cur != landmark:
            cur = int(parent_row[cur])
            if cur < 0 or len(chain) > limit:
                return None
            chain.append(cur)
        return chain

    def report(self) -> dict:
        return {
            "k": self.k,
            "device_bytes": self.device_bytes,
            # A report does not wait for a tick: each counter is read whole.
            "queries": self.queries,  # bfs_tpu_torch: ok LCK001 read without the card's lock
            "tight_hits": self.tight_hits,  # bfs_tpu_torch: ok LCK001 as above
        }


def labels_budget_bytes() -> int:
    """The resident-label budget in bytes (``BFS_TPU_TORCH_LABELS_GB``)."""
    return int(knobs.get("BFS_TPU_TORCH_LABELS_GB") * (1 << 30))


def build_label_oracle(graph: Graph, k: int, *, cache=None, engine: str = "pull",
                       ckpt_dir: str | os.PathLike | None = None, device=None, sweep=None):
    """``(LabelOracle, info)``, the server's register-time entry point: the
    sidecar-cached index (:func:`~bfs_tpu_torch.cache.layout.load_or_build_labels`)
    in a budget-gated device oracle.  Raises :class:`LabelBudgetError` over
    budget (callers keep serving exact-only)."""
    from ..cache.layout import load_or_build_labels

    t0 = time.perf_counter()
    idx, info = load_or_build_labels(graph, k, cache=cache, engine=engine, ckpt_dir=ckpt_dir,
                                     device=device, sweep=sweep)
    oracle = LabelOracle(idx, budget_bytes=labels_budget_bytes(), device=device)
    info = dict(info)
    info["total_seconds"] = time.perf_counter() - t0
    return oracle, info
