"""Direction-optimizing BFS over the push and pull engines: the Beamer
policy, :class:`DirectionEngine`, :func:`bfs_direction` and
:func:`bfs_multi_direction`.

The port of ``bfs_tpu.models.direction``.  Per superstep the search runs
one of two bodies that compute the same canonical min-parent candidates:

  * **push** (the edge list's segmented min): cheap on sparse frontiers;
  * **pull** (the ELL gather row-min): cheap on the dense middle levels.

The policy (:func:`take_pull`, Beamer's pair with hysteresis): in push, go
pull when ``m_f * alpha > m_u`` (the frontier's out-edge mass against the
unexplored mass); in pull, stay while ``n_f * beta > n`` (the frontier's
occupancy against the vertex count).  A batch makes one global decision:
the masses are summed over its trees and ``n`` is ``V * S``.  The masses
are exact int64 sums on the device, cast to float32 where the predicate
compares them; the unexplored mass ``mu`` is carried in float32, clamped
at 0, as the reference carries it.

Modes (``DirectionConfig.mode``, from ``BFS_TPU_TORCH_DIRECTION`` unless
given): ``auto`` switches per superstep, ``push`` and ``pull`` force one
body (no predicate; occupancy and direction still recorded).

The loop on the card (:class:`~bfs_tpu_torch.models.loop.SwitchLoop`): one
carry, two captured graphs over the same static buffers, each "its body,
then decide, then the control step"; decide writes the next superstep's
body into the control block's USE_PULL word and keeps ``mu`` beside it.
The host reads the control block after every superstep, as the push and
pull engines' blocks of one already do, and replays the graph USE_PULL
names: no superstep carries a dead body.  ``loop = "eager"`` is the plain
version: a host read of ``changed`` and the decision every superstep.
The packed carry runs by default; a search past its 62-level cap is
re-run unpacked with the same schedule (a pure function of the frontier
masses, which both carries produce).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import knobs
from ..graph.csr import DeviceGraph, build_device_graph
from ..graph.ell import PullGraph, build_pull_graph
from ..graph.relay import RelayGraph
from ..obs import telemetry as T
from ..ops import control as C
from ..ops import relay_cuda as K
from ..ops.packed import packed_cap
from ..ops.relax import PackedBfsState
from ..ops.relay import unpack_std
from . import loop as L
from .bfs import BfsResult, EdgeEngine, check_sources, resolve_device
from .multisource import MultiBfsResult

DEFAULT_ALPHA = 14.0
DEFAULT_BETA = 24.0

DIRECTION_MODES = ("push", "pull", "auto")

#: Words of the decision state beside the control block (float32): the
#: unexplored mass, the last frontier's out-edge mass, and the thresholds
#: (device values, so one captured graph serves every configuration).
MU, FE, ALPHA, BETA, NTHRESH = range(5)
DECIDE_WORDS = 5

_BODY = {"push": 0, "pull": 1}  # USE_PULL values
_CODE = {0: T.DIR_PUSH, 1: T.DIR_PULL}


@dataclass(frozen=True)
class DirectionConfig:
    """A resolved direction policy."""

    mode: str = "auto"
    alpha: float = DEFAULT_ALPHA
    beta: float = DEFAULT_BETA

    def key(self) -> tuple:
        return (self.mode, float(self.alpha), float(self.beta))


def resolve_direction(mode: str | None = None) -> DirectionConfig:
    """The policy from the knobs; an explicit ``mode`` wins over
    ``BFS_TPU_TORCH_DIRECTION``.  Raises ``ValueError`` on an unknown mode
    or a threshold that is not positive."""
    if mode is None:
        mode = knobs.get("BFS_TPU_TORCH_DIRECTION")
    if mode not in DIRECTION_MODES:
        raise ValueError(f"unknown direction {mode!r}; use 'push', 'pull' or 'auto'")
    alpha = float(knobs.get("BFS_TPU_TORCH_DIRECTION_ALPHA"))
    beta = float(knobs.get("BFS_TPU_TORCH_DIRECTION_BETA"))
    if alpha <= 0 or beta <= 0:
        raise ValueError(f"direction thresholds must be positive (alpha={alpha}, beta={beta})")
    return DirectionConfig(mode=mode, alpha=alpha, beta=beta)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def take_pull(prev_pull, fsize, fedges, unexplored, num_vertices, alpha, beta) -> torch.Tensor:
    """THE Beamer predicate, a device bool: in push (``prev_pull`` false) go
    pull when ``fedges * alpha > unexplored``; in pull stay while
    ``fsize * beta > num_vertices``.  Every input is cast to float32 first
    (tensors on one device, or numbers)."""
    go_pull = _f32(fedges) * _f32(alpha) > _f32(unexplored)
    stay_pull = _f32(fsize) * _f32(beta) > _f32(num_vertices)
    return torch.where(torch.as_tensor(prev_pull, device=go_pull.device) != 0, stay_pull, go_pull)


def frontier_masses(frontier: torch.Tensor, outdeg: torch.Tensor):
    """(occupancy, out-edge mass) of a bool frontier, exact int64 device
    scalars, summed over every axis (a batch's global masses)."""
    fsize = frontier.sum(dtype=torch.int64)
    fedges = torch.where(frontier, outdeg, 0).sum(dtype=torch.int64)
    return fsize, fedges


def frontier_masses_words(fwords: torch.Tensor, outdeg: torch.Tensor, n: int):
    """Word-packed twin of :func:`frontier_masses`: standard-packed
    frontier words over an ``n``-element id space."""
    return frontier_masses(unpack_std(fwords, n) != 0, outdeg)


def _host_outdeg(num_vertices: int, src: np.ndarray) -> np.ndarray:
    """Out-degree per vertex id from the (possibly padded) edge sources:
    int32[V+1] with an inert sentinel slot."""
    src = np.asarray(src)
    deg = np.bincount(src[src < num_vertices], minlength=num_vertices)
    return np.concatenate([deg, [0]]).astype(np.int32)


def init_decision(dstate: torch.Tensor, fsize, fedges, mu0, n,
                  cfg: DirectionConfig) -> torch.Tensor:
    """Start the decision state of a run, in place, from the masses of its
    initial frontier (the sources: occupancy ``fsize``, out-edge mass
    ``fedges``), the unexplored mass before it ``mu0`` (float32) and the
    vertex count ``n`` of the occupancy test; return the first superstep's
    decision."""
    fe = _f32(fedges)
    mu = _f32(mu0) - fe
    dstate.zero_()
    dstate[ALPHA], dstate[BETA] = cfg.alpha, cfg.beta
    dstate[NTHRESH] = n
    dstate[MU], dstate[FE] = mu, fe
    return take_pull(False, fsize, fe, mu, dstate[NTHRESH], dstate[ALPHA], dstate[BETA])


def decide(dstate: torch.Tensor, prev_pull, fsize, fedges):
    """The next superstep's decision from the masses of the frontier the
    last one made: ``(use_pull, mu, fe)``, device scalars; ``mu`` is the
    unexplored mass less this frontier's, clamped at 0 (float32 rounding
    must not take it below zero, where any frontier would satisfy the pull
    test)."""
    fe = _f32(fedges)
    mu = torch.clamp_min(dstate[MU] - fe, 0.0)
    use = take_pull(prev_pull, fsize, fe, mu, dstate[NTHRESH], dstate[ALPHA], dstate[BETA])
    return use, mu, fe


def decide_gated(dstate: torch.Tensor, ctl: torch.Tensor, fsize, fedges, force_pull=None) -> None:
    """:func:`decide` inside the level loop, in place: the previous decision
    is the control block's USE_PULL word, ``force_pull`` (a device bool, the
    relay engine's budget test) is or'd into the decision, and a superstep
    that is not LIVE leaves USE_PULL and the decision state as they were."""
    live = ctl[C.LIVE] != 0
    use, mu, fe = decide(dstate, ctl[C.USE_PULL], fsize, fedges)
    if force_pull is not None:
        use = use | force_pull
    dstate[MU] = torch.where(live, mu, dstate[MU])
    dstate[FE] = torch.where(live, fe, dstate[FE])
    ctl[C.USE_PULL] = torch.where(live, use.to(torch.int32), ctl[C.USE_PULL])


class DirectionEngine:
    """The push and pull layouts of one graph on the device, with the
    out-degrees (int32[V+1]), and the direction loop over both.

    Build with :meth:`from_graph`; ``DirectionEngine(push=..., pull=...)``
    wraps :class:`~bfs_tpu_torch.models.bfs.EdgeEngine` objects that exist
    (either alone runs that body's forced mode: the level curves).
    :meth:`run` and :meth:`run_multi` return the result and the schedule
    dict; :attr:`last_run` holds the loop's counts, with ``issued_push`` and
    ``issued_pull``, the supersteps issued per body (on a card each is a
    replay of that body's graph).  ``loop = "eager"`` runs the plain loop."""

    def __init__(self, *, push: EdgeEngine | None = None, pull: EdgeEngine | None = None,
                 config: DirectionConfig | None = None):
        self.engines = {b: e for b, e in ((0, push), (1, pull)) if e is not None}
        if not self.engines:
            raise ValueError("a DirectionEngine needs a push or a pull engine")
        first = next(iter(self.engines.values()))
        self.device = first.device
        self.num_vertices = first.num_vertices
        self.config = config if config is not None else resolve_direction()
        self.outdeg = None
        if push is not None:
            self.outdeg = torch.from_numpy(
                _host_outdeg(self.num_vertices, push.layout.src)).to(self.device)
        self.loop = "blocks"
        self._loops: dict = {}
        self.last_run: dict = {}

    @classmethod
    def from_graph(cls, graph, *, pull_graph: PullGraph | None = None, device=None,
                   block: int = 1024, config: DirectionConfig | None = None) -> "DirectionEngine":
        """Both layouts of ``graph`` (a Graph, or a dst-sorted DeviceGraph)
        shipped to ``device``; ``pull_graph`` skips the ELL's build."""
        if isinstance(graph, (PullGraph, RelayGraph)):
            raise ValueError("the direction engine needs a Graph or DeviceGraph: it builds "
                             "both the edge list (push) and the ELL (pull)")
        device = resolve_device(device)
        dg = graph if isinstance(graph, DeviceGraph) else build_device_graph(graph, block=block)
        pg = pull_graph if pull_graph is not None else build_pull_graph(graph)
        return cls(push=EdgeEngine(dg, engine="push", device=device),
                   pull=EdgeEngine(pg, engine="pull", device=device), config=config)

    def _bodies(self, mode: str) -> tuple[int, ...]:
        bodies = (0, 1) if mode == "auto" else (_BODY[mode],)
        missing = [b for b in bodies if b not in self.engines]
        if missing:
            raise ValueError(f"direction {mode!r} needs the "
                             f"{' and '.join(('push', 'pull')[b] for b in missing)} layout")
        return bodies

    @property
    def packed(self) -> bool:
        """Whether a run starts on the packed carry (the engines' choice;
        setting it sets theirs)."""
        return self._lead.packed

    @packed.setter
    def packed(self, value: bool) -> None:
        for eng in self.engines.values():
            eng.packed = value

    @property
    def _lead(self) -> EdgeEngine:
        """The engine whose search path (:meth:`EdgeEngine.fused`, the
        packed-cap re-run, the host result path) runs the direction loop
        over its carry."""
        return next(iter(self.engines.values()))

    # -- the loop on the device ------------------------------------------------

    def _switch_loop(self, mode: str, packed: bool, trees: int | None) -> L.SwitchLoop:
        """The direction loop of one mode and carry kind: carry ``(fields...,
        occupancy, directions, decision state, ctl)``; one step per body:
        the gated superstep, the occupancy and direction of the level it
        settles recorded, in ``auto`` the next decision, then the control
        step."""
        bodies = self._bodies(mode)
        key = (mode, packed, trees)
        loop = self._loops.get(key)
        if loop is not None:
            return loop
        fields, state = self._lead.carry(packed, trees)
        occ, dirs = T.init_level_acc(device=self.device), T.init_dir_acc(device=self.device)
        dstate = torch.zeros(DECIDE_WORDS, dtype=torch.float32, device=self.device)
        ctl = C.new_ctl(self.device)
        frontier = fields[-1]

        def make_step(body: int):
            eng, code = self.engines[body], _CODE[body]

            def step():
                eng.gated_step(state, fields, ctl)
                level, live = ctl[C.LEVEL] + 1, ctl[C.LIVE] != 0
                T.record_frontier_bools(occ, frontier, level, live)
                T.record_direction(dirs, level, code, live)
                if mode == "auto":
                    decide_gated(dstate, ctl, *frontier_masses(frontier, self.outdeg))
                K.loop_control(ctl)

            return step

        loop = L.SwitchLoop((*fields, occ, dirs, dstate, ctl), {b: make_step(b) for b in bodies})
        self._loops[key] = loop
        return loop

    def _drive(self, init, cap: int, trees: int | None, *, mode: str, times: list | None):
        """The direction loop as the ``drive`` hook (see
        :meth:`EdgeEngine.fused`): ``(state, LoopStats)`` from the fresh
        state ``init``; the supersteps issued per body are added to
        ``_issued`` and the run's accumulators and carry kind left in
        ``_tel`` (the last run's: the re-run's past the packed cap)."""
        packed = isinstance(init, PackedBfsState)
        if self.loop == "eager":
            st, stats, occ, dirs = self._eager(init, trees or 1, cap, mode)
        else:
            loop = self._switch_loop(mode, packed, trees)
            *fields, occ, dirs, dstate, ctl = loop.buffers
            live = L.start((*fields, ctl), init, cap)
            occ.copy_(T.init_level_acc(trees or 1, device=self.device))
            dirs.zero_()
            if mode == "auto":
                ctl[C.USE_PULL] = self._init_decision(dstate, fields[-1]).to(torch.int32)
            else:
                ctl[C.USE_PULL] = _BODY[mode]
            stats, issued = loop.run(live, times)
            for body, n in issued.items():
                self._issued[body] += n
            st = type(init)(*fields, None, None)
        self._tel = (occ, dirs, packed)
        return st, stats

    def _init_decision(self, dstate: torch.Tensor, frontier: torch.Tensor) -> torch.Tensor:
        """:func:`init_decision` from a run's initial frontier (the sources):
        the unexplored mass is every out-edge of every tree, the occupancy
        test counts ``V`` per tree."""
        trees = frontier.shape[0] if frontier.dim() == 2 else 1
        mu0 = _f32(self.outdeg.sum(dtype=torch.int64)) * float(trees)
        return init_decision(dstate, *frontier_masses(frontier, self.outdeg), mu0,
                             (frontier.shape[-1] - 1) * trees, self.config)

    def _eager(self, init, trees: int, cap: int, mode: str):
        """The plain version of the direction loop on :func:`loop.eager`:
        each superstep the body of the last decision, the telemetry
        recorded, the next decision taken and read with ``changed`` in the
        level's one host read.  Returns ``(state, stats, occupancy,
        directions)``."""
        occ, dirs = T.init_level_acc(trees, device=self.device), T.init_dir_acc(device=self.device)
        dstate = torch.zeros(DECIDE_WORDS, dtype=torch.float32, device=self.device)
        use_pull = mode == "pull"
        if mode == "auto":
            use_pull = bool(self._init_decision(dstate, init.frontier))

        def step(state):
            nonlocal use_pull
            body = int(use_pull)
            state = self.engines[body].superstep(state)
            T.record_frontier_bools(occ, state.frontier, state.level)
            T.record_direction(dirs, state.level, _CODE[body])
            self._issued[body] += 1
            if mode != "auto":
                return state
            use, dstate[MU], dstate[FE] = decide(dstate, use_pull,
                                                 *frontier_masses(state.frontier, self.outdeg))
            changed, use_pull = (bool(x) for x in torch.stack([state.changed, use]).tolist())
            return state._replace(changed=changed)

        st, stats = L.eager(init, step, cap)
        stats.host_reads += mode == "auto"  # the first decision
        return st, stats, occ, dirs

    def _start(self, times: list | None = None):
        """A run's ``drive`` hook, its per-body counts zeroed."""
        mode = self.config.mode
        self._issued = dict.fromkeys(self._bodies(mode), 0)
        return functools.partial(self._drive, mode=mode, times=times)

    def _host_run(self, sources, max_levels: int | None, times: list | None):
        """``(dist, parent, num_levels, schedule)`` on the host for one
        source (an int) or a batch (a list), with :attr:`last_run` set; the
        direction accumulator comes back in the result's host read."""
        drive = self._start(times)
        dist, parent, (dirs,), run = self._lead._host_run(
            sources, max_levels, drive, extra=lambda: self._tel[1:2])
        cfg = self.config
        schedule = T.direction_schedule(dirs, mode=cfg.mode, alpha=cfg.alpha, beta=cfg.beta)
        self.last_run = {**run, "issued_push": self._issued.get(0, 0),
                         "issued_pull": self._issued.get(1, 0)}
        return dist, parent, run["level"], schedule

    def run(self, source: int = 0, *, max_levels: int | None = None,
            times: list | None = None) -> tuple[BfsResult, dict]:
        """One search: ``(BfsResult, schedule)``.  ``times`` (a card) gets
        ``(body, device ms)`` per superstep."""
        dist, parent, levels, schedule = self._host_run(int(source), max_levels, times)
        return BfsResult(dist, parent, levels), schedule

    def run_multi(self, sources, *, max_levels: int | None = None,
                  times: list | None = None) -> tuple[MultiBfsResult, dict]:
        """A lock-step batch with one decision per superstep for all its
        trees: ``(MultiBfsResult, schedule)``."""
        sources = np.atleast_1d(np.asarray(sources, dtype=np.int32))
        dist, parent, levels, schedule = self._host_run(sources.tolist(), max_levels, times)
        return MultiBfsResult(sources, dist, parent, levels), schedule

    def level_curve(self, sources, *, max_levels: int | None = None,
                    reference_reached: int | None = None) -> dict:
        """The level curve of one search (``sources`` an int) or a batch (a
        list) in the engine's forced mode: one read of the occupancy
        accumulator at exit; the state stays on the device."""
        check_sources(self.num_vertices, sources)
        max_levels = int(max_levels) if max_levels is not None else self.num_vertices
        _, stats, _ = self._lead._search(sources, max_levels, self._start())
        occ, _, packed_run = self._tel
        (fv,) = T.read_telemetry(occ)
        cap = packed_cap(max_levels) if packed_run else max_levels
        self.last_run = vars(stats)
        return T.level_curve(fv, cap=cap, reference_reached=reference_reached)


def bfs_direction(graph, source: int = 0, *, max_levels: int | None = None,
                  config: DirectionConfig | None = None, device=None,
                  block: int = 1024) -> tuple[BfsResult, dict]:
    """Single-source direction-optimizing BFS over the push/pull pair, on
    the card unless ``device`` names the CPU: ``(BfsResult, schedule)``,
    bit-exact against ``bfs(engine='push'|'pull')`` for any schedule."""
    eng = DirectionEngine.from_graph(graph, device=device, block=block, config=config)
    return eng.run(source, max_levels=max_levels)


def bfs_multi_direction(graph, sources, *, max_levels: int | None = None,
                        config: DirectionConfig | None = None, device=None,
                        block: int = 1024) -> tuple[MultiBfsResult, dict]:
    """Batched multi-source direction-optimizing BFS (lock-step trees, one
    global decision per superstep): ``(MultiBfsResult, schedule)``."""
    eng = DirectionEngine.from_graph(graph, device=device, block=block, config=config)
    return eng.run_multi(sources, max_levels=max_levels)
