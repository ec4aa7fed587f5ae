"""The level loop's control block: one small int32 tensor per loop, on the
device that runs the loop.

The counterpart of the ``jax.lax.while_loop`` condition of the reference's
fused programs (``st.changed & (st.level < cap)``, ``bfs_tpu/models/bfs.py``
``_relay_fused_program`` and ``_relay_elem_program``).  Words:

  ======== ==============================================================
  LEVEL    levels run so far (the state's ``level``)
  CHANGED  did the last live superstep change anything (1 at the start)
  LIVE     does the next superstep run: ``changed and level < cap``
  CAP      the loop's level bound (``packed_cap(max_levels)`` or
           ``max_levels``); in device memory, so one captured block
           serves every bound
  FLAG     set by the superstep's update when a vertex changed; read and
           cleared by the control step
  STEPS    live supersteps counted on the device
  USE_PULL the body of the next superstep in the direction loop (1 pull,
           0 push; :mod:`bfs_tpu_torch.models.direction` writes it, the
           host reads it to pick the graph it replays; no kernel reads it)
  ======== ==============================================================

A segmented run (:mod:`bfs_tpu_torch.resilience.superstep_ckpt`) pauses and
resumes the same loops: :func:`resume_ctl` starts a block from a carry's
level, ``changed`` and body, and :func:`set_cap` moves a paused run's CAP
to the next segment's end, so one captured block serves every segment.

Every loop kernel reads LIVE at entry and returns at once when it is 0; the
update kernels read LEVEL for the level they stamp.  The control step
(kernel ``loop_control``, ``csrc/relay_kernels.cu``; :func:`loop_control`
here is its plain version) ends each superstep.  A superstep that is not
live leaves the state, LEVEL and CHANGED as they were.  The indices of the
words a kernel reads mirror the ``kCtl*`` constants of ``csrc/control.cuh``.
"""

from __future__ import annotations

import torch

LEVEL, CHANGED, LIVE, CAP, STEPS, USE_PULL = range(6)
#: FLAG sits in a 128-byte line of its own: the update's blocks store to it
#: while every block of every gated kernel loads LIVE.
FLAG = 32
#: Words of a control block.
WORDS = 64


def new_ctl(device) -> torch.Tensor:
    """A control block on ``device`` (zeros; :func:`init_ctl` starts a run)."""
    return torch.zeros(WORDS, dtype=torch.int32, device=device)


def _put(ctl: torch.Tensor, word: int, value) -> None:
    """``ctl[word] = value`` as a device fill (a device copy for a tensor
    ``value``): a Python scalar stored by indexing is copied from the host,
    a host sync."""
    if isinstance(value, torch.Tensor):
        ctl[word].copy_(value)
    else:
        ctl[word].fill_(int(value))


def init_ctl(ctl: torch.Tensor, cap: int) -> bool:
    """Start a run of at most ``cap`` levels in ``ctl``, in place, with
    device fills only (no copy from the host); returns LIVE."""
    live = int(cap) > 0
    ctl.zero_()
    _put(ctl, CHANGED, 1)
    _put(ctl, CAP, cap)
    _put(ctl, LIVE, live)
    return live


def resume_ctl(ctl: torch.Tensor, level: int, changed: bool, cap: int, use_pull=0) -> bool:
    """Start ``ctl`` from a carry that has run ``level`` levels (its last
    superstep ``changed``) with the next body ``use_pull`` (an int or a
    device scalar), in place, with device fills only; STEPS starts at 0.
    Returns LIVE."""
    live = bool(changed) and int(level) < int(cap)
    ctl.zero_()
    _put(ctl, LEVEL, level)
    _put(ctl, CHANGED, bool(changed))
    _put(ctl, CAP, cap)
    _put(ctl, USE_PULL, use_pull)
    _put(ctl, LIVE, live)
    return live


def set_cap(ctl: torch.Tensor, cap: int, level: int, changed: bool) -> bool:
    """The next segment of a paused run in ``ctl`` (read on the host at
    ``level`` and ``changed``): CAP moved to ``cap``, LIVE set with it and
    STEPS cleared, in place, with device fills; LEVEL, CHANGED and
    USE_PULL stay as the last superstep left them.  Returns LIVE."""
    live = bool(changed) and int(level) < int(cap)
    _put(ctl, CAP, cap)
    _put(ctl, STEPS, 0)
    _put(ctl, LIVE, live)
    return live


def level_live(ctl: torch.Tensor | None, level: int | None):
    """``(level, live)``: device scalars (int64, bool) from ``ctl`` when
    given; else the host ``level`` and ``None`` (always live: the loop
    without a control block)."""
    if ctl is None:
        return int(level), None
    return ctl[LEVEL].to(torch.int64), ctl[LIVE] != 0


def raise_flag(ctl: torch.Tensor, changed: torch.Tensor) -> None:
    """OR a superstep's ``changed`` (a device bool or int) into FLAG."""
    ctl[FLAG] |= (changed != 0).to(torch.int32)


def loop_control(ctl: torch.Tensor) -> torch.Tensor:
    """The control step, plain version, in place: if the superstep was
    live, ``level += 1``, ``changed = flag`` and ``steps += 1``; then the
    flag is cleared and ``live = changed and level < cap``."""
    live = ctl[LIVE] != 0
    ctl[LEVEL] += live.to(torch.int32)
    ctl[STEPS] += live.to(torch.int32)
    ctl[CHANGED] = torch.where(live, (ctl[FLAG] != 0).to(torch.int32), ctl[CHANGED])
    ctl[FLAG] = 0
    ctl[LIVE] = ((ctl[CHANGED] != 0) & (ctl[LEVEL] < ctl[CAP])).to(torch.int32)
    return ctl
