"""The packed BFS state word: ``level:6 | parent:26`` in one uint32.

Level is the MAJOR field, so the state update is one unsigned
``min(state, candidate)``: an already-reached vertex (smaller level)
always wins, and among same-level candidates the smaller parent value
(the canonical min-parent) wins.  All-ones (``PACKED_SENTINEL``) is the
unreached value and the lattice top; OR-ing level bits onto it leaves it
intact.  For the relay engine's gather arm the parent field holds the
parent's within-row RANK in the vertex's degree class; for its MXU arm it
holds the parent's ORIGINAL id (:func:`packed_parent` decodes it).

The deepest representable level is 62 (63 is the sentinel's level
field).  A search that reaches that cap is re-run on the unpacked carry
(:func:`packed_truncated`).

In torch the words are stored as ``int32`` bit patterns (the CUDA side
reads them as ``uint32``).  Unsigned shifts, mins and compares either widen
to ``int64 & 0xFFFFFFFF`` (:func:`u32`) or stay in int32 with the sign bit
flipped or masked (:func:`merge_packed`, :func:`packed_dist`), where a
signed view would put the sentinel (-1) below every word.
"""

from __future__ import annotations

import numpy as np
import torch

INT32_MAX = int(np.iinfo(np.int32).max)

LEVEL_BITS = 6
PARENT_BITS = 26
PARENT_MASK = (1 << PARENT_BITS) - 1

#: Unreached sentinel: all ones (as uint32).
PACKED_SENTINEL = 0xFFFFFFFF
PACKED_MAX_LEVELS = (1 << LEVEL_BITS) - 2  # 62

U32 = 0xFFFFFFFF
_SIGN = -(1 << 31)


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their unsigned values as int64."""
    return x.to(torch.int64) & U32


def i32(x: torch.Tensor) -> torch.Tensor:
    """Unsigned values in [0, 2^32) as int64 -> int32 bit patterns."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def packed_parent_fits(num_vertices: int) -> bool:
    """Can a parent VERTEX id (the MXU arm's original-id candidates) fit
    the 26-bit field?"""
    return int(num_vertices) <= (1 << PARENT_BITS)


def packed_rank_fits(in_classes) -> bool:
    """Can every relay parent RANK (< its class width) fit 26 bits?"""
    widths = [int(c.width) for c in in_classes]
    return (max(widths) if widths else 1) <= (1 << PARENT_BITS)


def packed_cap(max_levels: int) -> int:
    """The level bound a packed loop may run to."""
    return min(int(max_levels), PACKED_MAX_LEVELS)


def packed_truncated(changed, level, max_levels: int) -> bool:
    """Did the packed loop stop on its level capacity rather than
    converging or hitting the caller's ``max_levels``?  True means the
    caller must re-run on the unpacked carry."""
    return (
        bool(changed)
        and int(level) >= PACKED_MAX_LEVELS
        and int(max_levels) > PACKED_MAX_LEVELS
    )


def level_word(level: int) -> int:
    """The uint32 level-field bits for ``level``."""
    return (int(level) << PARENT_BITS) & U32


def packed_dist(packed: torch.Tensor) -> torch.Tensor:
    """int32 distances from packed words (INT32_MAX where unreached); int32
    arithmetic throughout (the level field masked after the shift)."""
    level = (packed >> PARENT_BITS) & ((1 << LEVEL_BITS) - 1)
    return torch.where(packed == -1, INT32_MAX, level)


def packed_parent(packed: torch.Tensor) -> torch.Tensor:
    """int32 parent field from packed words (-1 where unreached)."""
    return torch.where(packed == -1, -1, packed & PARENT_MASK)


def level_bits(level: torch.Tensor) -> torch.Tensor:
    """The level field of a device ``level`` (a 0-d int tensor) as an int32
    bit pattern, without a host read."""
    return i32((level.to(torch.int64) << PARENT_BITS) & U32)


def merge_packed(packed: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """THE packed state update: the unsigned ``min(packed, cand)`` of int32
    bit patterns (flipping the sign bit maps unsigned order onto signed)."""
    return torch.where((packed ^ _SIGN) <= (cand ^ _SIGN), packed, cand)

