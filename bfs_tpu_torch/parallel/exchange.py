"""The frontier exchange of the mesh engine's relay search: the port of
the 1-D half of ``bfs_tpu.parallel.exchange``.

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
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import knobs
from .compat import GRAPH_AXIS, all_gather, pmax

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
