"""Superstep telemetry on the device: the level curve and the direction
schedule, recorded in the level loop and read once at its exit.

The port of the level-curve, direction and exchange halves of
``bfs_tpu.obs.telemetry``.  An occupancy accumulator is int64[TEL_SLOTS] in
device memory: slot ``l`` holds the number of vertices that entered the
frontier at level ``l`` (summed over the trees of a batch), so the curve's
sum is the reachable count.  A direction accumulator is int32[TEL_SLOTS]:
slot ``l`` holds the body (:data:`DIR_PUSH` or :data:`DIR_PULL`) of the
superstep that settled level ``l``.  Both are indexed by the level the
superstep settles, a device value (the control block's LEVEL word + 1
inside the level loop), and every recorder takes the superstep's LIVE word:
a dead superstep records nothing.  The recorders update the accumulators in
place with device ops only, so they can be captured in a CUDA graph.

:func:`read_telemetry` is the one host copy of all accumulators at loop
exit; :func:`level_curve` and :func:`direction_schedule` turn the host
arrays into the reference's JSON-ready dicts, and :func:`stream_report`
the streamed arm's per-level rows into its ledger.  The reference splits a
batch's counts into lo16/hi16 int32 halves because its device has no int64
by default; here the accumulator is int64, and the host dict is the same.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph.adj_tiles import _popcount32

#: Accumulator slots: the packed 62-level cap with room for the unpacked
#: re-run; deeper levels clamp into the last slot (the curve then reports
#: ``truncated``; sums stay exact).
TEL_SLOTS = 128

DIR_PUSH = 1  # the push body (edge-list segmented min)
DIR_PULL = 2  # the pull body (ELL gather row-min; the dense relay superstep)

DIR_NAMES = {DIR_PUSH: "push", DIR_PULL: "pull"}


def init_level_acc(num_sources: int = 1, slots: int = TEL_SLOTS, device="cpu") -> torch.Tensor:
    """int64[slots] with slot 0 = the sources (level 0 is seeded by the
    state's init, not produced by a superstep)."""
    acc = torch.zeros(slots, dtype=torch.int64, device=device)
    acc[0] = int(num_sources)
    return acc


def init_dir_acc(slots: int = TEL_SLOTS, device="cpu") -> torch.Tensor:
    """int32[slots] direction accumulator (slot 0 stays 0: no superstep
    settles level 0)."""
    return torch.zeros(slots, dtype=torch.int32, device=device)


def _slot(level) -> torch.Tensor:
    """The accumulator slot of ``level`` (a device tensor or an int) as an
    int64[1] index, clamped into ``[0, TEL_SLOTS)``."""
    return torch.as_tensor(level).to(torch.int64).clamp(0, TEL_SLOTS - 1).reshape(1)


def record_count(acc: torch.Tensor, level, count, live=None) -> torch.Tensor:
    """Add ``count`` (a device scalar) into slot ``level``, in place; with
    ``live`` (a device bool) only when the superstep is live."""
    n = count.to(torch.int64).reshape(1)
    if live is not None:
        n = n * live
    return acc.index_add_(0, _slot(level).to(acc.device), n)


def record_frontier_words(acc: torch.Tensor, fwords: torch.Tensor, level, live=None) -> torch.Tensor:
    """Occupancy of a word-packed frontier (the relay engine's) into slot
    ``level`` (the level the superstep that produced it settled)."""
    return record_count(acc, level, _popcount32(fwords).sum(), live)


def record_frontier_bools(acc: torch.Tensor, frontier: torch.Tensor, level, live=None) -> torch.Tensor:
    """Occupancy of a bool frontier (push and pull; a batch sums over its
    trees: the curve is the global occupancy)."""
    return record_count(acc, level, frontier.sum(dtype=torch.int64), live)


def record_direction(dacc: torch.Tensor, level, code, live=None) -> torch.Tensor:
    """Set slot ``level`` to ``code`` (DIR_PUSH or DIR_PULL, an int or a
    device scalar), in place; with ``live`` only when the superstep is
    live.  Each level is settled by exactly one superstep."""
    idx = _slot(level).to(dacc.device)
    if isinstance(code, torch.Tensor):
        value = code.to(torch.int32).reshape(1)
    else:  # a fill, not a host copy: this may run under capture
        value = torch.full((1,), int(code), dtype=torch.int32, device=dacc.device)
    if live is not None:
        value = torch.where(live, value, dacc.index_select(0, idx))
    return dacc.index_copy_(0, idx, value)


# The mesh engine's exchange (bfs_tpu_torch/parallel/exchange.py) records
# per level the bytes its frontier exchange ships and the arm that shipped
# them, in accumulators of the same slots, read with the others at exit.

def init_bytes_acc(slots: int = TEL_SLOTS, device="cpu") -> torch.Tensor:
    """int64[slots] exchange-bytes accumulator (slot 0 stays 0: the source
    frontier is seeded by the state's init, nothing is shipped)."""
    return torch.zeros(slots, dtype=torch.int64, device=device)


def record_exchange(bacc: torch.Tensor, aacc: torch.Tensor, level, nbytes, arm,
                    live=None) -> None:
    """Record one superstep's exchange at the slot of the level its
    frontier settled, in place: ``nbytes`` added into the bytes
    accumulator, the arm code (``parallel/exchange.py`` ``EX_*``) set in the
    arm accumulator (an int32 accumulator of :func:`init_dir_acc`'s shape);
    each an int or a device scalar, nothing recorded on a dead superstep."""
    if not isinstance(nbytes, torch.Tensor):
        nbytes = torch.full((), int(nbytes), dtype=torch.int64, device=bacc.device)
    record_count(bacc, level, nbytes, live)
    record_direction(aacc, level, arm, live)


def edge_curve_from_levels(dist: torch.Tensor, outdeg: torch.Tensor,
                           unreached: torch.Tensor) -> torch.Tensor:
    """float32[TEL_SLOTS]: out-degree summed by BFS level, the per-level
    frontier out-edge curve, in one pass over the final levels at loop
    exit (each vertex enters the frontier exactly once).  A histogram in
    float64 (exact for integer sums below 2^53; on a card its 128 bins sit
    in shared memory, where an ``index_add_`` would contend on 128 global
    words), then cast.  It reads the largest index on the host, so it
    runs outside a capture."""
    idx = torch.where(unreached, 0, dist).to(torch.int64).clamp(0, TEL_SLOTS - 1)
    w = torch.where(unreached, 0, outdeg).to(torch.float64)
    return torch.bincount(idx, weights=w, minlength=TEL_SLOTS).to(torch.float32)


def read_telemetry(*tensors: torch.Tensor) -> list[np.ndarray]:
    """THE one host read of a run's telemetry: every tensor's bytes in one
    buffer, one copy (through pinned memory on a card), split back into
    host arrays of the tensors' shapes and dtypes."""
    flat = [t.contiguous().reshape(-1) for t in tensors]
    raw = torch.cat([f.view(torch.uint8) for f in flat])
    if raw.device.type == "cuda":
        host = torch.empty(raw.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(raw, non_blocking=True)
        torch.cuda.current_stream().synchronize()
    else:
        host = raw
    buf = host.numpy()
    out, at = [], 0
    for t, f in zip(tensors, flat):
        n = f.numel() * f.element_size()
        dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        out.append(buf[at : at + n].view(dtype).reshape(tuple(t.shape)).copy())
        at += n
    return out


def direction_schedule(dirs, *, mode: str, alpha: float, beta: float) -> dict:
    """JSON-ready schedule from the host direction accumulator: per-level
    push/pull labels, the switch count, and the thresholds that produced
    them."""
    dv = np.asarray(dirs, dtype=np.int64)
    nz = np.flatnonzero(dv)
    levels = int(nz[-1]) + 1 if nz.size else 0
    labels = [DIR_NAMES.get(int(c), "none") for c in dv[1:levels]]
    switches = sum(
        1 for a, b in zip(labels, labels[1:])
        if a != b and "none" not in (a, b)
    )
    return {
        "mode": mode,
        "alpha": float(alpha),
        "beta": float(beta),
        "schedule": labels,  # index i = the superstep that settled level i+1
        "switches": switches,
        "push_supersteps": labels.count("push"),
        "pull_supersteps": labels.count("pull"),
        "truncated": bool(dv[TEL_SLOTS - 1] != 0) if dv.shape[0] >= TEL_SLOTS else False,
    }


def level_curve(fvert, fedges=None, *, cap: int | None = None,
                reference_reached: int | None = None) -> dict:
    """JSON-ready curve from host accumulator arrays: ``occupancy[l]`` =
    vertices settled at level ``l`` (trimmed after the last nonzero),
    ``reachable`` its sum (checked against ``reference_reached`` when
    given), ``cap_proximity`` = levels / cap."""
    fv = np.asarray(fvert).astype(np.int64)
    nz = np.flatnonzero(fv)
    levels = int(nz[-1]) + 1 if nz.size else 0
    out: dict = {
        "occupancy": [int(x) for x in fv[:levels]],
        "levels": levels,
        "reachable": int(fv.sum()),
        "peak_level": int(np.argmax(fv)) if levels else 0,
        "peak_occupancy": int(fv.max()) if levels else 0,
        "truncated": bool(fv[TEL_SLOTS - 1] != 0) if fv.shape[0] >= TEL_SLOTS else False,
    }
    if fedges is not None:
        fe = np.asarray(fedges, dtype=np.float64)
        out["frontier_edges"] = [float(x) for x in fe[:levels]]
    if cap is not None and cap > 0:
        out["cap"] = int(cap)
        out["cap_proximity"] = levels / cap
    if reference_reached is not None:
        out["reference_reached"] = int(reference_reached)
        out["occupancy_sum_matches_reference"] = int(fv.sum()) == int(reference_reached)
    return out


def stream_report(levels: list, *, budget_bytes: int, store: dict, cache: dict) -> dict:
    """JSON-ready ledger of a streamed run (the reference's keys): the
    per-level rows (arm, demanded superblocks, level, and the cache's
    counter deltas over the level), their totals, the host store's shape
    and the cache's lifetime counters.  Totals sum the per-level deltas, so
    a cache kept on the engine across runs still reports this run's
    volume."""
    total_keys = ("bytes_streamed", "hits", "misses", "evictions", "corrupt_refetches")
    totals = {k: int(sum(int(row.get(k, 0)) for row in levels)) for k in total_keys}
    return {
        "budget_bytes": int(budget_bytes),
        **{k: store[k] for k in sorted(store)},
        "levels": [dict(row) for row in levels],
        **totals,
        "cache": dict(cache),
    }


def render_curve_ascii(curve: dict, width: int = 50) -> str:
    """A level curve as a terminal bar chart (``python -m bfs_tpu_torch.obs
    curve``)."""
    occ = curve.get("occupancy", [])
    if not occ:
        return "(empty level curve)"
    peak = max(occ)
    lines = [
        f"level curve: {curve.get('reachable', sum(occ))} reachable over "
        f"{curve.get('levels', len(occ))} levels"
    ]
    for lvl, n in enumerate(occ):
        bar = "#" * max(1 if n else 0, round(width * n / peak)) if peak else ""
        lines.append(f"  L{lvl:>3} {n:>12,d} {bar}")
    if curve.get("truncated"):
        lines.append(f"  (deeper levels clamped into slot {TEL_SLOTS - 1})")
    return "\n".join(lines)
