"""The level loop on the device: blocks of gated supersteps.

The counterpart of the ``jax.lax.while_loop`` of the reference's fused
programs (``bfs_tpu/models/bfs.py`` ``_relay_fused_program``,
``_relay_elem_program``), whose condition ``changed & (level < cap)`` XLA
evaluates on the device so the host syncs once per search.

A :class:`BlockLoop` owns one carry kind's static buffers and its control
block (:mod:`bfs_tpu_torch.ops.control`).  A block is :data:`BLOCK`
supersteps, each gated by the control block: every kernel of a superstep
returns at entry when it is not live, and the control step ends it.  On a
card the block is captured once into a ``torch.cuda.CUDAGraph``, after one
eager superstep that fills every cache the superstep keeps (device tables,
kernel attributes), and then replayed; the host reads the control block (a
pinned copy of 32 bytes) once per block and stops when LIVE is 0.  On the
CPU the same block runs eagerly with the same gates and control step.
A capture or a replay that fails raises: nothing falls back to the eager
loop on a card.

Kernel launch counts (``ops/relay_cuda.py::LAUNCHES``) count what reaches
the card: a wrapper called under capture counts its launch into the
capture's own record (:func:`~bfs_tpu_torch.ops.relay_cuda.capturing`, per
thread, so launches other threads count meanwhile stay counted), and each
replay adds the block's captured launches.

A segmented run (:mod:`bfs_tpu_torch.resilience.superstep_ckpt`) drives the
same loops one segment at a time (:meth:`BlockLoop.segment`,
:meth:`SwitchLoop.segment`): the control block's CAP is moved to the
segment's end, so the graph captured for the first segment serves every
later one; :func:`captures` counts the captures of the process, which a
segment must never add to.

A caller that may abandon a run (the query server's watchdog) runs it under
:func:`attempt`: the check it gives is called before every block or
superstep the loops of that thread issue, and raises to stop the run.
"""

from __future__ import annotations

import contextlib
import gc
import threading
from dataclasses import dataclass
from typing import Callable

import torch

from ..analysis.runtime import bump_retrace, explicit_transfer
from ..ops import control as C
from ..ops import relay_cuda as K

#: Supersteps per block, chosen on the card from ``chip_smoke.py``'s table
#: of k = 1, 4, 8, 16 (``PERF.md``): the best or within noise of it on the
#: gather and MXU searches (6-8 levels), and on the 9-level batch it issues
#: 3 dead supersteps where k = 8 issues 7.  Not a knob.
BLOCK = 4

#: Supersteps per block of the push and pull engines (``EdgeEngine``).
#: Their supersteps are plain torch ops, so a dead one runs whole (1.8 ms
#: push, 5.2 ms pull at R-MAT scale 22 on an H100) where a host read costs
#: tens of microseconds: blocks of 1 issue no dead superstep.  Chosen on
#: the card from ``chip_smoke.py``'s table of k = 1, 2, 4 beside the eager
#: loop (``PERF.md``): k = 1 beat k = 4 on every search and batch, and
#: k = 2 on the 64-source batches by 9-10%.  Not a knob.
EDGE_BLOCK = 1

_attempt = threading.local()  # .check: the running attempt's check, or None
_captures = 0  # CUDA graphs captured by every loop of the process


def captures() -> int:
    """CUDA graphs captured so far by the loops of this process."""
    return _captures


@contextlib.contextmanager
def attempt(check: Callable[[], None]):
    """Call ``check()`` before every block (and every eager superstep) that
    a loop issues on this thread inside the block; an exception it raises
    stops the run there, before anything more is launched."""
    outer = getattr(_attempt, "check", None)
    _attempt.check = check
    try:
        yield
    finally:
        _attempt.check = outer


def _check_attempt() -> None:
    check = getattr(_attempt, "check", None)
    if check is not None:
        check()


def capture(step: Callable[[], None], k: int = 1) -> tuple[torch.cuda.CUDAGraph, dict[str, int]]:
    """``(graph, launches)``: ``k`` calls of ``step`` captured into a CUDA
    graph on the current device, and the kernel launches they recorded
    (captured, not launched: a replay adds them,
    :func:`~bfs_tpu_torch.ops.relay_cuda.add_launches`)."""
    graph = torch.cuda.CUDAGraph()
    # Garbage of earlier engines (their graphs, memory pools, pinned
    # buffers) is freed now: freed during the capture, it would make a
    # call that a capture forbids.
    gc.collect()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with K.capturing() as captured, torch.cuda.graph(graph):
            for _ in range(k):
                step()
    finally:
        if collecting:
            gc.enable()
    return graph, captured


@dataclass
class LoopStats:
    """One run of a loop: the final ``level`` and ``changed`` (read from the
    control block at the end), host reads of the control block, graph
    replays, supersteps issued (eager and replayed) and live supersteps
    (counted on the device)."""

    level: int = 0
    changed: bool = True
    host_reads: int = 0
    replays: int = 0
    issued: int = 0
    live: int = 0

    def add(self, other: "LoopStats") -> "LoopStats":
        """The counts of two runs summed; level and changed from ``other``."""
        return LoopStats(
            other.level, other.changed, self.host_reads + other.host_reads,
            self.replays + other.replays, self.issued + other.issued,
            self.live + other.live,
        )


class BlockLoop:
    """Blocks of ``k`` gated supersteps over static buffers.

    ``buffers``: the carry's tensors, the control block last; ``step``: one
    gated superstep on exactly those tensors (the control step included),
    the same Python callable eagerly and under capture."""

    def __init__(self, buffers: tuple[torch.Tensor, ...], step: Callable[[], None],
                 k: int | None = None, name: str = "loop"):
        self.buffers = buffers
        #: The key its captures are counted under (``analysis.runtime``'s
        #: retrace report): the carry kind of :func:`cached`.
        self.name = name
        self.ctl = buffers[-1]
        self.step = step
        self.k = BLOCK if k is None else int(k)
        if self.k < 1:
            raise ValueError(f"a block holds at least one superstep, got {self.k}")
        self.on_card = self.ctl.device.type == "cuda"
        self.graph: torch.cuda.CUDAGraph | None = None
        #: Kernel launches of one captured block, by name.
        self.per_block: dict[str, int] = {}

    # -- one block -----------------------------------------------------------

    def _capture(self) -> None:
        global _captures
        self.graph, self.per_block = capture(self.step, self.k)
        _captures += 1
        bump_retrace(f"loop.capture/{self.name}")

    # bfs_tpu_torch: hot
    def issue(self, stats: LoopStats) -> None:
        """Issue one block on the current stream (no host read): eagerly on
        the CPU; on a card the graph's replay, the first time after one
        eager superstep and the capture."""
        _check_attempt()
        if not self.on_card:
            for _ in range(self.k):
                self.step()
            stats.issued += self.k
            return
        if self.graph is None:
            self.step()  # warm-up: a real, gated superstep of this run
            stats.issued += 1
            self._capture()
        self.graph.replay()
        K.add_launches(self.per_block)
        stats.replays += 1
        stats.issued += self.k

    def dead_replay(self) -> None:
        """Issue the block once more, uncounted (the graph's replay on a
        card, its supersteps eagerly on the CPU): after a run has converged,
        LIVE is 0 and every superstep of it is dead, which times a dead
        superstep and must change nothing."""
        if self.graph is not None:
            self.graph.replay()
            return
        for _ in range(self.k):
            self.step()

    # -- the host's side ------------------------------------------------------

    # bfs_tpu_torch: hot
    def run(self, live: bool) -> LoopStats:
        """Issue blocks until the control block reads not LIVE; ``live`` is
        LIVE as the caller initialised it (no block when it is 0)."""
        stats = LoopStats()
        ctl = [0] * C.WORDS
        ctl[C.CHANGED] = 1
        while live:
            self.issue(stats)
            (ctl,) = read_ctls([self.ctl], stats)
            live = bool(ctl[C.LIVE])
        stats.level, stats.changed, stats.live = ctl[C.LEVEL], bool(ctl[C.CHANGED]), ctl[C.STEPS]
        return stats

    def segment(self, seg_end: int, level: int, changed: bool) -> LoopStats:
        """One segment of a paused run (read at ``level`` and ``changed``):
        blocks until the control block reads not LIVE, with CAP moved to
        ``seg_end`` (:func:`~bfs_tpu_torch.ops.control.set_cap`).  ``live``
        in the stats counts this segment's live supersteps."""
        return self.run(C.set_cap(self.ctl, seg_end, level, changed))

    def load(self, carry: tuple[torch.Tensor, ...]) -> None:
        """Copy a carry of the same shapes into the static buffers (on the
        device, no host read)."""
        for dst, src in zip(self.buffers, carry):
            dst.copy_(src)

    def store(self, carry: tuple[torch.Tensor, ...]) -> None:
        """Copy the static buffers out into ``carry``."""
        for dst, src in zip(carry, self.buffers):
            dst.copy_(src)


class SwitchLoop:
    """One carry with one captured superstep per body over the same static
    buffers: the direction loop.

    ``steps`` maps a body's USE_PULL value (0 push, 1 pull) to one gated
    superstep of that body on exactly ``buffers`` (the control block last),
    which ends by writing the next superstep's body into the control block's
    USE_PULL word and the control step.  The host reads the control block
    after every superstep and issues the body that USE_PULL names: on a card
    the replay of that body's graph, so no superstep carries the other body
    as dead weight; on the CPU the body's superstep, eagerly.  Before its
    first use each body is captured after one DEAD superstep of its own on
    the carry (LIVE cleared for it, the control block restored after), which
    fills the superstep's caches and changes nothing, so every superstep of
    a run is a replay."""

    def __init__(self, buffers: tuple[torch.Tensor, ...], steps: dict[int, Callable[[], None]]):
        self.buffers = buffers
        self.ctl = buffers[-1]
        self.bodies = {body: BlockLoop(buffers, step, k=1, name=f"switch/{body}")
                       for body, step in steps.items()}

    def _prepare(self) -> None:
        for loop in self.bodies.values():
            if loop.on_card and loop.graph is None:
                saved = self.ctl.clone()
                self.ctl[C.LIVE].fill_(0)
                loop.step()
                self.ctl.copy_(saved)
                loop._capture()

    def issue(self, body: int, stats: LoopStats) -> None:
        """Issue one superstep of ``body`` on the current stream (no host
        read): on a card its graph's replay."""
        self._prepare()
        self.bodies[body].issue(stats)

    def load(self, carry: tuple[torch.Tensor, ...]) -> None:
        """Copy a carry of the same shapes into the static buffers."""
        next(iter(self.bodies.values())).load(carry)

    def store(self, carry: tuple[torch.Tensor, ...]) -> None:
        """Copy the static buffers out into ``carry``."""
        next(iter(self.bodies.values())).store(carry)

    def segment(self, seg_end: int, level: int, changed: bool,
                times: list | None = None) -> tuple[LoopStats, dict[int, int]]:
        """One segment of a paused run, as :meth:`BlockLoop.segment`: the
        bodies USE_PULL names until the control block reads not LIVE, CAP
        moved to ``seg_end``."""
        return self.run(C.set_cap(self.ctl, seg_end, level, changed), times)

    # bfs_tpu_torch: hot
    def run(self, live: bool, times: list | None = None) -> tuple[LoopStats, dict[int, int]]:
        """Issue supersteps, each of the body the control block's USE_PULL
        word names, until it reads not LIVE; ``live`` is LIVE as the caller
        initialised it.  With more than one body the first body is read from
        the control block too.  Returns the stats and the supersteps issued
        per body.  ``times`` (a card): a list that gets ``(body, device ms)``
        per superstep, by CUDA events around its replay."""
        self._prepare()  # every capture before the first timed replay
        stats = LoopStats()
        issued = dict.fromkeys(self.bodies, 0)
        ctl = [0] * C.WORDS
        ctl[C.CHANGED] = 1
        body = next(iter(self.bodies))
        if live and len(self.bodies) > 1:
            (ctl,) = read_ctls([self.ctl], stats)
            body = ctl[C.USE_PULL]
        events = []
        while live:
            if times is not None:
                t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                t0.record()
            self.issue(body, stats)
            if times is not None:
                t1.record()
                events.append((body, t0, t1))
            issued[body] += 1
            (ctl,) = read_ctls([self.ctl], stats)
            live, body = bool(ctl[C.LIVE]), ctl[C.USE_PULL]
        if times is not None:
            times.extend((b, a.elapsed_time(z)) for b, a, z in events)
        stats.level, stats.changed, stats.live = ctl[C.LEVEL], bool(ctl[C.CHANGED]), ctl[C.STEPS]
        return stats, issued


def cached(loops: dict, kind, make, k: int | None = None) -> BlockLoop:
    """The :class:`BlockLoop` of one carry kind at blocks of ``k``
    supersteps (the current :data:`BLOCK` when None) in an engine's
    ``loops``, made (buffers and step) by ``make`` at first use."""
    k = BLOCK if k is None else k
    key = (kind, k)
    loop = loops.get(key)
    if loop is None:
        loop = loops[key] = BlockLoop(*make(), k=k, name=f"{kind}/{k}")
    return loop


def start(carry: tuple[torch.Tensor, ...], state, cap: int) -> bool:
    """Start a run in a loop's carry: the tensors of a fresh ``state`` (its
    fields in the carry's order) copied in on the device, the control block
    started with ``cap``; returns LIVE."""
    for dst, src in zip(carry[:-1], state):
        dst.copy_(src)
    return C.init_ctl(carry[-1], cap)


def eager(state, step: Callable, cap: int, level: int = 0):
    """The plain version of the block loop: ``state = step(state)`` while
    the last superstep changed something and fewer than ``cap`` levels ran,
    with a host read of ``changed`` per level.  Returns ``(state,
    LoopStats)``.  A segment of a run that has run ``level`` levels (its
    last superstep changed something) passes ``level`` and the segment's
    end as ``cap``; ``live`` then counts the segment's supersteps."""
    stats = LoopStats(level=int(level))
    changed = True
    while changed and stats.level < cap:
        _check_attempt()
        state = step(state)
        changed = bool(state.changed)  # the one host read per level
        stats.level += 1
        stats.host_reads += 1
        stats.issued += 1
        stats.live += 1
    stats.changed = changed
    return state, stats


def read_ctls(ctls: list[torch.Tensor], stats: LoopStats) -> list[list[int]]:
    """Control blocks on the host in one read: stacked on the device, one
    pinned copy and one wait on a card; a plain read on the CPU."""
    stats.host_reads += 1
    both = torch.stack(ctls)
    if both.device.type != "cuda":
        return both.tolist()
    host = torch.empty(both.shape, dtype=both.dtype, pin_memory=True)
    with explicit_transfer():  # the loop's one intended host read
        host.copy_(both, non_blocking=True)
        torch.cuda.current_stream().synchronize()
    return host.tolist()
