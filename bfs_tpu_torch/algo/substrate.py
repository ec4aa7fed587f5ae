"""The semiring substrate: one superstep machine, many graph algorithms.

The port of ``bfs_tpu.algo.substrate``.  Every level-synchronous engine of
the port is the same three-phase loop

    contribute  — per active edge, a value derived from source state;
    combine     — one segmented min over edge destinations
                  (:func:`bfs_tpu_torch.ops.relax.combine_min`);
    apply       — merge candidates into per-vertex state, the improved
                  set becomes the next frontier, termination is
                  "no work remains".

parameterized by a ``(contribute, combine, identity, state)`` tuple: a
commutative selection semiring.  :data:`SEMIRINGS` is the contract table;
the algorithm modules (:mod:`bfs_tpu_torch.algo.sssp`,
:mod:`bfs_tpu_torch.algo.cc`) run it on the level loop of
:mod:`bfs_tpu_torch.models.loop`, the loop the push and pull BFS engines
run on.

This module also owns the pieces the algorithms share:

  * :func:`edge_weights_np` / :func:`edge_weights` — deterministic per-edge
    weights as a hash of the endpoints, so any layout recomputes its own
    weights from the edge arrays it holds, and the host oracle recomputes
    the identical values from the host edge list.  The torch version widens
    to int64 and masks to 32 bits after every multiply and before every
    shift (torch has no uint32 multiply or logical shift on a card), so it
    equals the numpy one bit for bit;
  * :func:`resolve_delta` — the delta-stepping bucket width;
  * :func:`drive_segments` — the segmented traversal over
    :class:`~bfs_tpu_torch.resilience.superstep_ckpt.SuperstepCheckpointer`:
    bounded segments of the fused run's own captured loop (the control
    block's CAP moved to each segment's end), a durable epoch per boundary,
    the ``superstep:<n>`` fault family and the shared restore gate.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import knobs
from ..ops.packed import INT32_MAX, U32

# --------------------------------------------------------------- contract --


@dataclass(frozen=True)
class Semiring:
    """One row of the semiring contract table.

    ``contribute`` / ``combine`` are documentation strings (the math lives
    in the algorithm modules, through
    :func:`~bfs_tpu_torch.ops.relax.combine_min`), plus the two capability
    bits the engine matrix branches on: ``packable`` (is there a fused-word
    carry?) and ``mxu_eligible`` (can frontier expansion run as the
    bit-packed masked matmul? only boolean-mask contributions can)."""

    name: str
    contribute: str
    combine: str
    identity: int
    state: tuple
    packable: bool
    mxu_eligible: bool


#: name -> contract row.
SEMIRINGS = {
    "bfs": Semiring(
        name="bfs",
        contribute="src if frontier[src]",
        combine="segment_min over dst",
        identity=int(INT32_MAX),
        state=("dist", "parent", "frontier"),
        packable=True,  # level:6|parent:26 (ops/packed.py)
        mxu_eligible=True,  # boolean masks: AND/popcount tiles
    ),
    "sssp": Semiring(
        name="sssp",
        contribute="dist[src] + w(src, dst) if frontier[src]",
        combine="segment_min over dst",
        identity=int(INT32_MAX),
        state=("dist", "dirty", "threshold"),
        packable=True,  # dist:16|parent:16 (algo/sssp.py, V < 2^16-1)
        mxu_eligible=False,  # valued contributions: no popcount encoding
    ),
    "cc": Semiring(
        name="cc",
        contribute="label[src] if frontier[src]",
        combine="segment_min over dst",
        identity=int(INT32_MAX),
        state=("label", "frontier"),
        packable=False,  # label IS the whole word already
        mxu_eligible=False,  # label values, not boolean masks
    ),
}


# ---------------------------------------------------------------- weights --
# 32-bit multiply-xorshift mix (splitmix-style finalizer constants): a pure
# function of (src, dst) with a well-spread low-bit distribution.

_W_C1 = 0x9E3779B1
_W_C2 = 0x85EBCA77
_W_C3 = 0x7FEB352D

#: Default weight range [1, DEFAULT_MAX_WEIGHT] (the byte weights of the
#: Graph500 SSSP reference generator's integer variant).
DEFAULT_MAX_WEIGHT = 255


def edge_weights_np(src, dst, max_weight: int = DEFAULT_MAX_WEIGHT):
    """Host weights: int32 in ``[1, max_weight]`` for each directed edge,
    bit-identical to :func:`edge_weights` (the oracle runs on these)."""
    if max_weight < 1:
        raise ValueError("max_weight must be >= 1")
    s = np.asarray(src).astype(np.uint32)
    d = np.asarray(dst).astype(np.uint32)
    h = s * np.uint32(_W_C1) + d * np.uint32(_W_C2)
    h ^= h >> np.uint32(16)
    h *= np.uint32(_W_C3)
    h ^= h >> np.uint32(15)
    return (np.uint32(1) + h % np.uint32(max_weight)).astype(np.int32)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2^32`` for uint32 values held in int64, without a
    product past 2^48: ``c`` split into 16-bit halves."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & U32


def edge_weights(src: torch.Tensor, dst: torch.Tensor, max_weight: int) -> torch.Tensor:
    """Device weights from the endpoints (int32 ``[E]`` on their device),
    equal to :func:`edge_weights_np` bit for bit: the uint32 arithmetic in
    int64, masked to 32 bits after each multiply and before each shift, and
    ``%`` of the unsigned value."""
    if max_weight < 1:
        raise ValueError("max_weight must be >= 1")
    s = src.to(torch.int64) & U32
    d = dst.to(torch.int64) & U32
    h = (_mul32(s, _W_C1) + _mul32(d, _W_C2)) & U32
    h = h ^ (h >> 16)
    h = _mul32(h, _W_C3)
    h = h ^ (h >> 15)
    return (1 + h % int(max_weight)).to(torch.int32)


# ------------------------------------------------------------ delta knob --


def resolve_delta(delta: int | str | None = None) -> int:
    """The delta-stepping bucket width: the argument, else
    ``BFS_TPU_TORCH_SSSP_DELTA`` (an int, or ``inf`` for one bucket: plain
    frontier Bellman-Ford), else 64.  Returned as the int32 threshold
    increment (``inf`` and non-positive widths map to INT32_MAX: the first
    bucket already spans every finite distance)."""
    if delta is None:
        delta = knobs.get("BFS_TPU_TORCH_SSSP_DELTA")
    if isinstance(delta, str):
        if delta.lower() in ("inf", "infinite", "single"):
            return int(INT32_MAX)
        delta = int(delta)
    if delta <= 0:
        return int(INT32_MAX)
    return min(int(delta), int(INT32_MAX))


# ------------------------------------------------------ segmented driver --


def clamp_cap(cap: int) -> int:
    """A round bound as the control block's int32 CAP word: bounds past
    INT32_MAX (SSSP's safety bound above R-MAT scale 22) are clamped, which
    no run reaches."""
    return min(int(cap), int(INT32_MAX))


def drive_segments(ckpt, *, loop, start, snapshot, fields, packed: bool, cap: int):
    """The segmented traversal every algorithm shares, on ``loop`` (the
    fused run's :class:`~bfs_tpu_torch.models.loop.BlockLoop`).

    ``start(arrays_or_None)`` fills the loop's buffers, fresh or from an
    epoch's host arrays, and starts its control block paused (CAP at the
    current round); it returns ``(rounds, changed)`` as host values.  Each
    segment then moves CAP to ``min(rounds + k, cap)``
    (:meth:`~bfs_tpu_torch.models.loop.BlockLoop.segment`), so the graph
    captured for the first one serves them all.  ``snapshot(rounds,
    changed)`` gives an epoch's arrays (every field of ``fields`` plus
    ``packed_flag``, the reference's keys and dtypes); ``save_epoch`` marks
    the ``superstep:<n>`` fault boundary even with the store disabled.
    Returns ``(LoopStats, rounds, changed)``."""
    from ..models import loop as L
    from ..resilience.superstep_ckpt import restore_arrays

    arrays, _shards = restore_arrays(ckpt, packed, require=tuple(fields))
    rounds, changed = start(arrays)
    cap = clamp_cap(cap)
    stats = L.LoopStats(rounds, changed)
    while changed and rounds < cap:
        t0 = time.perf_counter()
        seg = loop.segment(min(rounds + ckpt.interval(), cap), rounds, changed)
        seg_s = time.perf_counter() - t0
        stats = stats.add(seg)
        snap = snapshot(seg.level, seg.changed) if ckpt.enabled else {}
        ckpt.save_epoch(seg.level, snap)
        ckpt.note_segment(seg.level - rounds, seg_s)
        rounds, changed = seg.level, seg.changed
    return stats, rounds, changed
