"""The pull superstep: gathers and row-mins over the ELL levels, in plain
PyTorch.

The port of ``bfs_tpu.ops.pull``, bit for bit.  Per destination vertex the
candidate parent is the minimum-id active in-neighbour, as in the push
superstep (:mod:`.relax`), but reduced densely: one gather from the
frontier table per ELL level and a min over each row.  The frontier table
``F[u] = u if u is on the frontier else INF`` folds the activity test and
the parent id into one gathered value.

The ELL matrices are the TRANSPOSED ``[K, rows]`` device operands of
:func:`bfs_tpu_torch.graph.ell.device_ell`.

The mesh engine (:mod:`bfs_tpu_torch.parallel.sharded`) reads the
all-gathered packed frontier of its shards with
:func:`unpack_frontier_blocks`.
"""

from __future__ import annotations

import torch

from .packed import INT32_MAX, u32
from .relax import BfsState, PackedBfsState, apply_candidates, apply_candidates_packed

#: Gather temporary budget in elements (4 bytes each): a level whose
#: ``[..., K, rows]`` gather would exceed it is gathered in row chunks, so
#: the temporary stays near 128 MB, the reference's default budget
#: (``BFS_TPU_PULL_CHUNK_MB``).  Chunk bounds are Python ints fixed by the
#: shapes, so a chunked superstep still has no host read.
CHUNK_ELEMS = (128 << 20) // 4


def _gather_min(tab: torch.Tensor, mat_t: torch.Tensor) -> torch.Tensor:
    """``min_k tab[..., mat_t[k, r]]`` per row r.  A row chunk of
    ``mat_t`` is a strided slice, which the flattening copies; indexing
    with the slice itself reads it in place but converts the int32 index
    to int64 first, which measured slower on the card (``PERF.md``)."""
    k, rows = mat_t.shape
    gathered = tab.index_select(-1, mat_t.reshape(-1))
    return gathered.reshape(*tab.shape[:-1], k, rows).amin(dim=-2)


def _rowmin_level(tab: torch.Tensor, mat_t: torch.Tensor) -> torch.Tensor:
    """Per-row min of gathered table values for one ELL level (``mat_t``
    int32[K, rows]); shape ``[..., rows]``, leading axes of ``tab``
    broadcast.  Gathered in row chunks of at most :data:`CHUNK_ELEMS`
    elements (batch axes count against it)."""
    k, rows = mat_t.shape
    batch = 1
    for d in tab.shape[:-1]:
        batch *= int(d)
    chunk_rows = max(CHUNK_ELEMS // max(k * batch, 1), 1)
    if rows <= chunk_rows:
        return _gather_min(tab, mat_t)
    return torch.cat([_gather_min(tab, mat_t[:, a : a + chunk_rows])
                      for a in range(0, rows, chunk_rows)], dim=-1)


def frontier_table(state) -> torch.Tensor:
    """``F[u] = u`` if u is on the frontier else INF, int32 ``[..., V+1]``;
    either carry (only ``frontier`` is read)."""
    n = state.frontier.shape[-1]
    ids = torch.arange(n, dtype=torch.int32, device=state.frontier.device)
    return torch.where(state.frontier, ids, INT32_MAX)


def _with_inf(cand: torch.Tensor) -> torch.Tensor:
    inf = torch.full((*cand.shape[:-1], 1), INT32_MAX, dtype=torch.int32, device=cand.device)
    return torch.cat([cand, inf], dim=-1)


def pull_candidates(frontier_tab: torch.Tensor, ell0: torch.Tensor, folds) -> torch.Tensor:
    """Min active in-neighbour id per vertex, int32 ``[..., V+1]`` (slot V
    INF); leading axes of ``frontier_tab`` broadcast."""
    num_vertices = frontier_tab.shape[-1] - 1
    cand = _rowmin_level(frontier_tab, ell0)
    for fold in folds:
        cand = _rowmin_level(_with_inf(cand), fold)
    return _with_inf(cand[..., :num_vertices])


def unpack_frontier_blocks(words: torch.Tensor, num_blocks: int, num_words: int) -> torch.Tensor:
    """int32[..., n*B/32] words of an all-gathered frontier (shard blocks
    concatenated, standard packing) -> bool[..., n*B]."""
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = (u32(words)[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], num_blocks * num_words * 32) != 0


def relax_pull_superstep(state: BfsState, ell0, folds, ctl=None) -> BfsState:
    """One pull superstep (single or batched carry)."""
    return apply_candidates(state, pull_candidates(frontier_table(state), ell0, folds), ctl)


def relax_pull_superstep_packed(state: PackedBfsState, ell0, folds, ctl=None) -> PackedBfsState:
    """Packed twin of :func:`relax_pull_superstep`."""
    return apply_candidates_packed(
        state, pull_candidates(frontier_table(state), ell0, folds), ctl)
