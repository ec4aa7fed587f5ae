"""The frontier exchange of the mesh engine's relay search and of the 2-D
grid: the port of ``bfs_tpu.parallel.exchange``.

Each superstep hands every shard the global new-frontier words.  Three
arms ship them, behind one knob (:func:`resolve_exchange`):

    BFS_TPU_TORCH_EXCHANGE = auto | bitmap | delta | flat   (default auto)

  * ``flat`` -- every owned word of every shard, padding included
    (``block/32`` words a shard): the oracle the others are held against;
  * ``bitmap`` -- each shard's REAL words only, through the own-word table
    (``bfs_tpu_torch.parallel.sharded._own_word_table``; padding words
    are structurally zero), after the sieve has masked settled vertices out
    of the new bits: ``kw`` words a shard;
  * ``delta`` -- ``(compact index, word)`` pairs of each shard's nonzero
    words, padded to a budget of ``B`` entries (``2B`` words a shard),
    when every shard's count fits it, else the bitmap arm: the choice is
    one vote over the shards (a ``pmax`` of their counts), so every shard
    takes the same arm.  Forced ``delta`` sets ``B = kw`` (always fits);
    ``auto`` sets ``B = ceil(kw / BFS_TPU_TORCH_EXCHANGE_DIV)`` (8), so
    the delta arm is taken only where it ships at least 4x less than flat.

Every arm gives ``(global words, bytes, arm code)``.  The bytes are the
reference's formula, ``4 * n * payload words`` (each shard's part counted
once), recorded per level in the telemetry accumulators
(:mod:`bfs_tpu_torch.obs.telemetry`).  On one card the shards share the
device memory and nothing crosses a wire: the bytes are what a mesh of
cards would ship for the same search, counted, not measured.  Under a
CUDA graph the delta arm cannot branch on the host, so both of its
branches are computed and the vote selects the words, bytes and code;
their words are equal whenever the delta branch fits.

Words are int32 bit patterns of uint32 words, standard packing; the
shards' send words are stacked ``[n, nw]`` (or ``[n, S, nw]`` for a
batch), the global words are ``[n*nw]`` (``[S, n*nw]``).

The 2-D grid (:mod:`.grid`) has two moves a superstep, each armed by the
same policy (the second half of this module): the column axis's frontier
broadcast (:func:`make_grid_col_exchange`, the 1-D arms within each mesh
row) and the row axis's min-reduce of original-id candidates
(:func:`make_grid_row_reduce`: ``flat`` the whole candidate vector,
``bitmap`` the column stripe's real words only, ``delta`` a budgeted list
of live candidates with the ``bitmap`` fallback).  Both delta arms vote
over the whole mesh, so every cell takes one arm per axis a superstep.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import knobs
from ..ops.packed import INT32_MAX
from .compat import (
    GRAPH_AXIS,
    GRID_COL_AXIS,
    GRID_ROW_AXIS,
    all_gather,
    grid_all_gather,
    grid_pmax,
    grid_pmin,
    pmax,
)

#: Arm codes, recorded per level (0: the level was not executed).
EX_FLAT = 1
EX_BITMAP = 2
EX_DELTA = 3

EX_NAMES = {EX_FLAT: "flat", EX_BITMAP: "bitmap", EX_DELTA: "delta"}

EXCHANGE_MODES = ("auto", "bitmap", "delta", "flat")

#: The auto arm's budget divisor: ``B = ceil(kw / div)`` entries, ``2B``
#: words when taken, at least a 4x cut against the flat arm.
DEFAULT_BUDGET_DIV = 8


@dataclass(frozen=True)
class ExchangeConfig:
    """A resolved exchange policy, hashable (it keys loops)."""

    mode: str = "auto"
    budget_div: int = DEFAULT_BUDGET_DIV

    def key(self) -> tuple:
        return (self.mode, int(self.budget_div))

    def delta_budget(self, kw: int) -> int:
        """The word-list budget of a ``kw``-word compact space: ``kw`` when
        forced (the arm ships every superstep), else ``ceil(kw / div)``."""
        if self.mode == "delta":
            return int(kw)
        return max(1, math.ceil(int(kw) / int(self.budget_div)))


def resolve_exchange(mode: str | None = None) -> ExchangeConfig:
    """The policy from the knobs; an explicit ``mode`` wins over
    ``BFS_TPU_TORCH_EXCHANGE``.  An unknown mode or a divisor below 1
    raises ``ValueError``."""
    if mode is None:
        mode = knobs.get("BFS_TPU_TORCH_EXCHANGE")
    if mode not in EXCHANGE_MODES:
        raise ValueError(f"unknown exchange {mode!r}; use 'auto', 'bitmap', 'delta' or 'flat'")
    div = knobs.get("BFS_TPU_TORCH_EXCHANGE_DIV")
    if div < 1:
        raise ValueError(f"BFS_TPU_TORCH_EXCHANGE_DIV must be >= 1 (got {div})")
    return ExchangeConfig(mode=mode, budget_div=div)


def _compact(send: torch.Tensor, own_all: torch.Tensor) -> torch.Tensor:
    """Each shard's real words, ``[n, ..., kw]``: shard s takes its words
    at its own row of the own-word table."""
    idx = own_all.reshape(own_all.shape[0], *([1] * (send.dim() - 2)), own_all.shape[1])
    return send.gather(-1, idx.expand(*send.shape[:-1], own_all.shape[1]))


def bitmap_gather(send: torch.Tensor, own_all: torch.Tensor, nw: int) -> torch.Tensor:
    """THE bitmap wire move (the bitmap arm, the delta arm's fallback and
    the batch's exchange): each shard's compact words ``send[n, ..., kw]``
    all-gathered and scattered back into the global padded word space
    through the own-word table ``own_all[n, kw]`` (int64); the table's pad
    duplicates write identical values.  Returns ``[..., n*nw]``."""
    n = own_all.shape[0]
    gath = all_gather(send, GRAPH_AXIS, dim=send.dim() - 2)  # [..., n, kw]
    base = (torch.arange(n, dtype=torch.int64, device=own_all.device) * nw)[:, None]
    flat_idx = (own_all + base).reshape(-1)
    lead = send.shape[1:-1]
    out = torch.zeros((*lead, n * nw), dtype=send.dtype, device=send.device)
    out[..., flat_idx] = gath.reshape(*lead, -1)
    return out


def exchange_flat(send_words: torch.Tensor):
    """The oracle arm: every owned word of every shard (``send_words[n,
    nw]``)."""
    n, nw = send_words.shape
    return all_gather(send_words, GRAPH_AXIS, tiled=True), 4 * n * nw, EX_FLAT


def exchange_bitmap(send_words: torch.Tensor, own_all: torch.Tensor, nw: int):
    """The sieved compact arm: each shard's real words only."""
    n, kw = own_all.shape
    return bitmap_gather(_compact(send_words, own_all), own_all, nw), 4 * n * kw, EX_BITMAP


def _dedup_mask(own_all: torch.Tensor) -> torch.Tensor:
    """True at the first occurrence of each real word index in each row
    (the table pads by repeating its last index: a repeated word must not
    count twice in the density vote or ship twice)."""
    first = torch.ones((own_all.shape[0], 1), dtype=torch.bool, device=own_all.device)
    return torch.cat([first, own_all[:, 1:] != own_all[:, :-1]], dim=1)


def exchange_delta(send_words: torch.Tensor, own_all: torch.Tensor, nw: int, budget: int):
    """The word-list arm with its density fallback: ``(index, word)`` pairs
    of each shard's nonzero words when every shard has at most ``budget``,
    else the bitmap arm.  Bytes and code are device scalars."""
    n, kw = own_all.shape
    dev = send_words.device
    send = _compact(send_words, own_all)
    live = (send != 0) & _dedup_mask(own_all)
    fits = pmax(live.sum(dim=1, dtype=torch.int32), GRAPH_AXIS) <= budget
    lanes = torch.arange(kw, dtype=torch.int64, device=dev)
    idx = torch.sort(torch.where(live, lanes, kw), dim=1).values[:, :budget]  # [n, B]
    vals = torch.where(idx < kw, send.gather(1, idx.clamp(max=kw - 1)), 0)
    word = own_all.gather(1, idx.clamp(max=kw - 1))
    base = (torch.arange(n, dtype=torch.int64, device=dev) * nw)[:, None]
    flat = torch.where(idx < kw, word + base, n * nw).reshape(-1)  # n*nw: a scratch word
    out = torch.zeros(n * nw + 1, dtype=send.dtype, device=dev)
    out.index_put_((flat,), vals.reshape(-1))
    words = torch.where(fits, out[: n * nw], bitmap_gather(send, own_all, nw))
    nbytes = torch.where(fits, 4 * n * 2 * budget, 4 * n * kw).to(torch.int64)
    arm = torch.where(fits, EX_DELTA, EX_BITMAP).to(torch.int32)
    return words, nbytes, arm


def make_exchange(cfg: ExchangeConfig, kw: int, nw: int):
    """The exchange of one resolved config: ``(send_words[n, nw],
    own_all[n, kw]) -> (global words [n*nw], bytes, arm code)``."""
    if cfg.mode == "flat":
        return lambda w, own: exchange_flat(w)
    if cfg.mode == "bitmap":
        return lambda w, own: exchange_bitmap(w, own, nw)
    budget = cfg.delta_budget(kw)
    return lambda w, own: exchange_delta(w, own, nw, budget)


def exchange_report(bytes_acc, arm_acc, cfg: ExchangeConfig, kw: int, nw: int, num_shards: int,
                    num_levels: int | None = None) -> dict:
    """JSON-ready exchange report from the host accumulators (the
    reference's keys): bytes and arm per level, totals, and the flat arm's
    bytes for the same search (``n * nw * 4`` a superstep run) that the
    reduction is measured against.  ``num_levels`` is the loop's
    superstep count, exact past the accumulator's last slot."""
    bv = np.asarray(bytes_acc, dtype=np.int64)
    av = np.asarray(arm_acc, dtype=np.int64)
    nz = np.flatnonzero(av)
    levels = int(nz[-1]) + 1 if nz.size else 0
    executed = int(num_levels) if num_levels is not None else (levels - 1 if levels else 0)
    schedule = [EX_NAMES.get(int(c), "none") for c in av[1:levels]]
    total = int(bv.sum())
    flat_total = int(executed * num_shards * nw * 4)
    return {
        "arm": cfg.mode,
        "budget_words": int(cfg.delta_budget(kw)),
        "bytes_per_level": [int(x) for x in bv[1:levels]],
        "schedule": schedule,  # index i = the superstep that settled level i+1
        "total_bytes": total,
        "flat_total_bytes": flat_total,
        "reduction_vs_flat": (flat_total / total) if total else None,
        "supersteps": executed,
        "truncated": bool(av[-1] != 0) and executed > levels - 1,
        "delta_supersteps": schedule.count("delta"),
        "bitmap_supersteps": schedule.count("bitmap"),
        "flat_supersteps": schedule.count("flat"),
    }


# ----------------------------------------------------------------- the grid --
#
# The column axis (frontier broadcast): each cell all-gathers its owned
# words along its mesh row's c cells, the row stripe R_i's frontier
# [c*nw words].  The 1-D arms at group size c, the density vote widened to
# both axes, the own-word tables the mesh row's rows of the [n, kw] table.
# The row axis (candidate min-reduce): each mesh column min-reduces the
# original-id candidates (INT32_MAX: none) of its column stripe C_j over
# its r cells.  Bytes keep the 1-D convention (each participant's payload
# once: 4 * group size * payload words a group) times the number of groups
# (r mesh rows for the column axis, c mesh columns for the row axis), the
# machine's total.  A size-1 axis is the identity: 0 bytes, arm 0.

def grid_row_budget(cfg: ExchangeConfig, r: int, kw: int) -> int:
    """The row axis's candidate-list budget: ``r*kw`` entries forced
    (``delta``), ``ceil(r*kw / div)`` otherwise."""
    if cfg.mode == "delta":
        return int(r * kw)
    return max(1, math.ceil(int(r) * int(kw) / int(cfg.budget_div)))


def _first_live(live: torch.Tensor, budget: int, fill: int) -> torch.Tensor:
    """The indices of the first ``budget`` True entries of each row of
    ``live[m, k]``, ascending, padded with ``fill``: ``[m, budget]`` int64.
    Entry ``j`` is the first index whose running count of live entries
    reaches ``j + 1`` (a search in the count; the reference sorts and
    cuts)."""
    m, k = live.shape
    # One scan of the flattened rows, each row's count then relative to its
    # start: the grid's few long rows (4 of 2^21 entries at s22) scan as one
    # device-wide pass.
    flat = torch.cumsum(live.reshape(-1).to(torch.int64), dim=0).view(m, k)
    count = flat - (flat[:, :1] - live[:, :1].to(torch.int64))
    rank = torch.arange(1, budget + 1, dtype=torch.int64, device=live.device)
    idx = torch.searchsorted(count, rank.expand(m, budget).contiguous())
    return torch.where(idx < k, idx, fill)


def _col_scatter(vals: torch.Tensor, word: torch.Tensor, r: int, c: int, nw: int) -> torch.Tensor:
    """Each mesh row's gathered words ``vals[r, c, k]`` written at their
    local word indices ``word[r, c, k]`` (``nw`` or more: dropped) of the
    row stripe, ``[r, c*nw]`` flattened to the global words."""
    base = (torch.arange(c, dtype=torch.int64, device=vals.device) * nw)[None, :, None]
    at = torch.where(word < nw, word + base, c * nw).reshape(r, -1)  # c*nw: a scratch word
    out = torch.zeros((r, c * nw + 1), dtype=vals.dtype, device=vals.device)
    return out.scatter_(1, at, vals.reshape(r, -1))[:, : c * nw].reshape(-1)


def make_grid_col_exchange(cfg: ExchangeConfig, kw: int, nw: int, r: int, c: int):
    """The column axis's frontier broadcast: ``(send[r*c, nw], own[r*c,
    kw]) -> (global words [r*c*nw], machine bytes, arm code)``; mesh row
    ``i``'s stripe is the words ``[i*c*nw, (i+1)*c*nw)``."""
    if c == 1:
        return lambda send, own: (send.reshape(-1), 0, 0)

    def flat(send, own):
        return grid_all_gather(send, GRID_COL_AXIS, r, c, tiled=True).reshape(-1), \
            4 * c * nw * r, EX_FLAT

    def compact(send, own):
        comp = _compact(send, own)
        return _col_scatter(grid_all_gather(comp, GRID_COL_AXIS, r, c),
                            own.reshape(r, c, kw), r, c, nw), comp

    def bitmap(send, own):
        return compact(send, own)[0], 4 * c * kw * r, EX_BITMAP

    if cfg.mode == "flat":
        return flat
    if cfg.mode == "bitmap":
        return bitmap
    budget = cfg.delta_budget(kw)

    def delta(send, own):
        words_b, comp = compact(send, own)
        live = (comp != 0) & _dedup_mask(own)
        fits = grid_pmax(live.sum(dim=1, dtype=torch.int32), r, c) <= budget
        idx = _first_live(live, budget, kw)  # [n, B] compact indices
        vals = torch.where(idx < kw, comp.gather(1, idx.clamp(max=kw - 1)), 0)
        word = torch.where(idx < kw, own.gather(1, idx.clamp(max=kw - 1)), nw)
        words_d = _col_scatter(grid_all_gather(vals, GRID_COL_AXIS, r, c),
                               grid_all_gather(word, GRID_COL_AXIS, r, c), r, c, nw)
        words = torch.where(fits, words_d, words_b)
        nbytes = torch.where(fits, 4 * c * 2 * budget * r, 4 * c * kw * r).to(torch.int64)
        return words, nbytes, torch.where(fits, EX_DELTA, EX_BITMAP).to(torch.int32)

    return delta


def make_grid_row_reduce(cfg: ExchangeConfig, kw: int, nw: int, r: int, c: int):
    """The row axis's candidate min-reduce: ``(cand[r*c, r*block], own[r*c,
    kw]) -> (candg [c, r*block], machine bytes, arm code)``.  ``cand`` holds
    each cell's min original-id candidate (INT32_MAX: none) for its column
    stripe ``C_j`` (stripe position ``i2`` covers block ``i2*c + j`` at
    ``[i2*block, (i2+1)*block)``), already sieved; ``candg[j]`` is mesh
    column ``j``'s min, held once for its r cells."""
    block = nw * 32
    rb = r * block
    if r == 1:
        return lambda cand, own: (cand.reshape(c, rb), 0, 0)

    def flat(cand, own):
        return grid_pmin(cand, GRID_ROW_AXIS, r, c), 4 * r * rb * c, EX_FLAT

    def compact_pmin(cand, own):
        # Column j's stripe tables own[i2*c + j] over i2, the same for its r cells.
        own_cj = own.reshape(r, c, kw).movedim(1, 0)  # [c, r, kw]
        idx = own_cj.repeat(r, 1, 1)[:, :, :, None].expand(r * c, r, kw, 32)
        comp = cand.reshape(r * c, r, nw, 32).gather(2, idx)  # the real words only
        comp = grid_pmin(comp, GRID_ROW_AXIS, r, c)  # [c, r, kw, 32]
        out = torch.full((c, r, nw, 32), INT32_MAX, dtype=cand.dtype, device=cand.device)
        return out.scatter_(2, own_cj[:, :, :, None].expand(c, r, kw, 32), comp).reshape(c, rb)

    def bitmap(cand, own):
        return compact_pmin(cand, own), 4 * r * (r * kw * 32) * c, EX_BITMAP

    if cfg.mode == "flat":
        return flat
    if cfg.mode == "bitmap":
        return bitmap
    budget = grid_row_budget(cfg, r, kw)

    def delta(cand, own):
        live = cand != INT32_MAX
        fits = grid_pmax(live.sum(dim=1, dtype=torch.int32), r, c) <= budget
        idx = _first_live(live, budget, rb)  # [n, B]
        vals = torch.where(idx < rb, cand.gather(1, idx.clamp(max=rb - 1)), INT32_MAX)
        gi = grid_all_gather(idx, GRID_ROW_AXIS, r, c).reshape(c, -1)  # [c, r*B]
        gv = grid_all_gather(vals, GRID_ROW_AXIS, r, c).reshape(c, -1)
        candg = torch.full((c, rb + 1), INT32_MAX, dtype=cand.dtype, device=cand.device)
        candg = candg.scatter_reduce_(1, gi, gv, "amin")[:, :rb]  # rb: a scratch slot
        words = torch.where(fits, candg, compact_pmin(cand, own))
        nbytes = torch.where(fits, 4 * r * 2 * budget * c, 4 * r * (r * kw * 32) * c)
        return words, nbytes.to(torch.int64), torch.where(fits, EX_DELTA, EX_BITMAP).to(torch.int32)

    return delta


def grid_exchange_report(col_bytes, col_arms, row_bytes, row_arms, cfg: ExchangeConfig, kw: int,
                         nw: int, r: int, c: int, num_levels: int | None = None) -> dict:
    """JSON-ready exchange report of a grid search (the reference's keys):
    each axis's bytes and arm per level, their sums, and the 1-D flat
    arm's bytes for the same search (``n * nw * 4`` a superstep run at ``n
    = r*c``).  ``col_bytes``/``row_bytes`` are the per-axis curves
    ``tools/ledger_compare.py --exact`` diffs."""
    n = r * c
    bvc = np.asarray(col_bytes, dtype=np.int64)
    avc = np.asarray(col_arms, dtype=np.int64)
    bvr = np.asarray(row_bytes, dtype=np.int64)
    avr = np.asarray(row_arms, dtype=np.int64)
    nz = np.flatnonzero(avc | avr)
    levels = int(nz[-1]) + 1 if nz.size else 0
    executed = int(num_levels) if num_levels is not None else (levels - 1 if levels else 0)
    if num_levels is not None and executed + 1 < len(avc):
        # A size-1 axis leaves one accumulator all zero: the loop's count
        # sets the per-level window then too.
        levels = max(levels, min(executed + 1, len(avc)))
    col_sched = [EX_NAMES.get(int(x), "none") for x in avc[1:levels]]
    row_sched = [EX_NAMES.get(int(x), "none") for x in avr[1:levels]]
    col_total, row_total = int(bvc.sum()), int(bvr.sum())
    total = col_total + row_total
    flat_total = int(executed * n * nw * 4)
    return {
        "arm": cfg.mode,
        "mesh": f"{r}x{c}",
        "col_budget_words": int(cfg.delta_budget(kw)),
        "row_budget_entries": int(grid_row_budget(cfg, r, kw)),
        "col_bytes": [int(x) for x in bvc[1:levels]],
        "row_bytes": [int(x) for x in bvr[1:levels]],
        "bytes_per_level": [int(a + b) for a, b in zip(bvc[1:levels], bvr[1:levels])],
        "col_schedule": col_sched,
        "row_schedule": row_sched,
        # index i = the superstep that settled level i+1
        "schedule": [f"{a}+{b}" for a, b in zip(col_sched, row_sched)],
        "col_total_bytes": col_total,
        "row_total_bytes": row_total,
        "total_bytes": total,
        "flat_total_bytes": flat_total,
        "reduction_vs_flat": (flat_total / total) if total else None,
        "per_chip_bytes": (total / n) if n else 0.0,
        "supersteps": executed,
        "truncated": bool((avc[-1] | avr[-1]) != 0) and executed > levels - 1,
        "axes": {
            "col": {"size": c, "groups": r, "total_bytes": col_total},
            "row": {"size": r, "groups": c, "total_bytes": row_total},
        },
    }
