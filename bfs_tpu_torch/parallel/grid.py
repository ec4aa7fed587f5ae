"""The 2-D grid: BFS on an ``r x c`` ``(row, col)`` mesh (the port of
``bfs_tpu.parallel.grid``).

The 1-D mesh (:mod:`.sharded`) hands every shard the whole new frontier
each superstep, O(V) words however many shards there are.  The grid places
the adjacency on an ``r x c`` mesh instead (:mod:`bfs_tpu_torch.graph.
grid_layout`): cell ``(i, j)`` holds the edges from row stripe ``R_i``
(source blocks ``[i*c, (i+1)*c)``) into column stripe ``C_j`` (destination
blocks ``{i'*c + j}``), and a superstep is

  1. the cell's candidates: a dense masked scatter-min over all its edges
     (the frontier bit of each edge's source gates its ORIGINAL source id),
     or the push body's budgeted frontier-list gather over the cell's CSR,
     chosen by the same direction predicate as every engine, on the
     global masses (exact int64 sums);
  2. the sieve: destinations the cell's view of ``C_j`` has reached drop
     out;
  3. the row axis's armed min-reduce of the candidates
     (:func:`~.exchange.make_grid_row_reduce`): each mesh column settles
     ``C_j``;
  4. the update of the cell's own block: kernel K4 (``packed_update``) once
     per cell on the packed carry, its improved bits into the cell's send
     words, the flag raised (the plain merge on the unpacked carry); then
     the column axis's armed broadcast of the send words
     (:func:`~.exchange.make_grid_col_exchange`): each mesh row reassembles
     ``R_i``.

The reference's update is inline XLA; the 1-D mesh of the port runs K4 per
shard for the same contract, and so does the grid, per cell.  Candidates
are original source ids, so ``dist``/``parent`` equal the 1-D mesh and one
chip bit for bit at any mesh shape, and at ``1 x n`` the grid IS the 1-D
mesh, exchange bytes included (the row reduce is the identity: 0 bytes, arm
"none").  The packed carry is ``level:6 | origid:26`` (gated on
``packed_parent_fits``; past 62 levels the search runs again unpacked).

The cells are stacked on axis 0 of one device, mesh-row-major (cell ``(i,
j)`` at ``i*c + j``, which owns vertex block ``i*c + j``), as the 1-D mesh
stacks its shards; the collectives are :mod:`.compat`'s grid collectives.
Every superstep is a step of the port's level loop
(:mod:`bfs_tpu_torch.models.loop`): captured in a CUDA graph on a card, one
host read per block, the switch loop of the push and dense bodies on the
``auto`` and ``push`` schedules.  :class:`GridEngine` holds the cells'
operands and captured loops; :func:`bfs_grid` and
:func:`bfs_grid_segmented` build one for a call and drop it.  The resumable
search writes per-CELL epochs (``ckpt.shards == r*c`` cell files, the same
files a 1-D run at ``n`` shards cuts, and a meta file with the frontier
words, the reached views, the decision pair and the six accumulators).
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from .. import knobs
from ..graph.grid_layout import GRID_KEY_SENTINEL, GridLayout, grid_layout_for, parse_mesh_spec
from ..graph.relay import ShardedRelayGraph, build_sharded_relay_graph
from ..models import loop as L
from ..models.bfs import BfsResult, check_sources, to_host
from ..obs import telemetry as T
from ..ops import control as C
from ..ops import relay as R
from ..ops import sparse as S
from ..ops.packed import (
    INT32_MAX,
    PACKED_MAX_LEVELS,
    packed_cap,
    packed_dist,
    packed_parent,
    packed_parent_fits,
    packed_truncated,
)
from .compat import GRID_AXES, GRID_COL_AXIS, GRID_ROW_AXIS, Mesh
from .exchange import (
    ExchangeConfig,
    grid_exchange_report,
    make_grid_col_exchange,
    make_grid_row_reduce,
    resolve_exchange,
)
from .sharded import (
    _block_fill,
    _own_word_table,
    _run_stats,
    _source_words,
    first_body,
    map_back,
    mesh_devices,
    next_body,
    restored_body,
    update_shards,
)

__all__ = [
    "GRID_COL_AXIS",
    "GRID_ROW_AXIS",
    "GridEngine",
    "bfs_grid",
    "bfs_grid_segmented",
    "grid_segment_carry",
    "grid_segment_keys",
    "make_grid_mesh",
    "resolve_grid_mesh",
]

#: The grid's decision words past the direction state's own: the
#: reference's ``mu`` and ``prev`` of the last superstep (the unexplored
#: mass its decision saw and the body it ran), what an epoch carries.
_PREV_MU, _PREV_USE = 5, 6


def resolve_grid_mesh(spec: str | None = None, *, devices: Sequence | None = None) -> tuple[int, int]:
    """``(r, c)`` from an explicit spec or ``BFS_TPU_TORCH_MESH``
    (``"rxc"``); with neither, the 1-D degenerate ``1 x len(devices)`` (the
    visible cards when ``devices`` is None)."""
    if spec is None:
        spec = knobs.get("BFS_TPU_TORCH_MESH")
    if not spec:
        return 1, len(mesh_devices(devices))
    return parse_mesh_spec(spec)


def make_grid_mesh(r: int, c: int, *, devices: Sequence | None = None) -> Mesh:
    """The ``(row, col)`` mesh, row-major over ``devices`` (the visible
    cards when None): cell ``(i, j)`` is entry ``i*c + j``, the layout's
    cell index and the checkpoint shard order.  A device may repeat
    (``[torch.device("cuda")] * 4``: a 2x2 grid stacked on one card); a
    mesh over several distinct devices raises (ROADMAP A12 (e))."""
    devices = mesh_devices(devices)
    if r < 1 or c < 1 or r * c > len(devices):
        raise ValueError(f"mesh {r}x{c} needs {r * c} devices, have {len(devices)}")
    return Mesh([devices[i * c:(i + 1) * c] for i in range(r)], axis_names=GRID_AXES)


def _grid_shape(mesh: Mesh) -> tuple[int, int]:
    if tuple(mesh.axis_names) != GRID_AXES:
        raise ValueError(f"a grid runs on a {GRID_AXES} mesh (make_grid_mesh), not "
                         f"{tuple(mesh.axis_names)}")
    return mesh.shape[GRID_ROW_AXIS], mesh.shape[GRID_COL_AXIS]


def grid_segment_keys(packed: bool, auto: bool, telemetry: bool) -> list[str]:
    """The epoch keys of a segmented grid search, the reference's: the
    state (the cell files), ``fw``, ``rc`` (the cells' reached views, exact
    loop state: a resume without them would let settled destinations back
    onto the row axis and change its bytes), ``level``, ``changed``, on
    ``auto`` the decision pair ``mu``/``prev``, and with telemetry the six
    accumulators."""
    keys = (["pk"] if packed else ["dist", "parent"]) + ["fw", "rc", "level", "changed"]
    if auto:
        keys += ["mu", "prev"]
    if telemetry:
        keys += ["occ", "dirs", "xbc", "xac", "xbr", "xar"]
    return keys


def _state_keys(packed: bool) -> tuple[str, ...]:
    return ("pk",) if packed else ("dist", "parent")


class GridEngine:
    """The cells' operands of an ``r x c`` grid on its mesh's device, with
    the captured loops (the stateful API, as ``ShardedRelayEngine``).

    Operands, stacked over cells: ``gsrc`` (each edge's GLOBAL relabeled
    source, int32[n, emax]), ``ekey`` (its original source id, INT32_MAX
    at padding: the scatter-min compares int32, where the reference's
    uint32 sentinel would read -1 and win), ``dflat`` (its destination as
    an index into the cells' candidate rows of ``r*block + 1`` slots, the
    last a scratch slot that takes the padding, int64[n, emax]) and
    ``indptr`` (the cell's CSR over its row stripe, the push body's).  The
    carry: the state ``[n, block]`` (``pk``, or ``dist``/``parent``), the
    global frontier words ``fw`` (mesh row ``i``'s stripe at ``[i*c*nw,
    (i+1)*c*nw)``), the cells' reached views ``rc`` ``[n, r*nw]`` and send
    words ``[n, nw]``, the accumulators, the decision words and the control
    block."""

    def __init__(self, srg: ShardedRelayGraph, mesh: Mesh):
        r, c = _grid_shape(mesh)
        n = r * c
        if srg.num_shards != n:
            raise ValueError(f"ShardedRelayGraph has {srg.num_shards} shards but the {r}x{c} grid "
                             f"has {n} cells; rebuild it with num_shards={n}")
        if srg.outdeg is None:
            raise ValueError("the grid needs the per-shard adjacency and out-degrees this "
                             "ShardedRelayGraph lacks; rebuild it with build_sharded_relay_graph")
        self.mesh, self.layout, self.device = mesh, srg, mesh.device
        self.r, self.c, self.n = r, c, n
        self.block, self.nw = srg.block, srg.block // 32
        self.gtot, self.rb = n * srg.block, r * srg.block
        self.packed = packed_parent_fits(srg.num_vertices)
        grid = grid_layout_for(srg, r, c)
        self.grid: GridLayout = grid
        dev = self.device
        row_base = (np.arange(n) // c * c * self.block).astype(np.int32)[:, None]
        ekey = np.where(grid.ekey == GRID_KEY_SENTINEL, INT32_MAX, grid.ekey).astype(np.int32)
        dflat = grid.edst.astype(np.int64) + (np.arange(n, dtype=np.int64) * (self.rb + 1))[:, None]

        def ship(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        self.gsrc = ship(grid.esrc + row_base)
        self.ekey = ship(ekey)
        self.dflat = ship(dflat)
        self.indptr = ship(grid.indptr)
        self.own = ship(_own_word_table(srg).astype(np.int64))
        self.kw = int(self.own.shape[1])
        self.outdeg = ship(np.asarray(srg.outdeg, dtype=np.int32))
        self.old2new = ship(np.asarray(srg.old2new, dtype=np.int64))
        self._loops: dict = {}
        self.last_run: dict = {}

    @property
    def operand_bytes(self) -> int:
        """Device bytes of the cells' operands."""
        return int(sum(t.numel() * t.element_size() for t in (
            self.gsrc, self.ekey, self.dflat, self.indptr, self.own, self.outdeg, self.old2new)))

    # -- the superstep's pieces ------------------------------------------------

    def _scatter_min(self, dst: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
        """The cells' candidate rows ``[n, r*block]``: the min key per
        destination slot (INT32_MAX where none), ``dst`` indexing the
        rows of ``r*block + 1`` slots laid end to end."""
        cand = torch.full((self.n * (self.rb + 1),), INT32_MAX, dtype=torch.int32,
                          device=self.device)
        cand.scatter_reduce_(0, dst.reshape(-1), keys.reshape(-1), "amin")
        return cand.view(self.n, self.rb + 1)[:, : self.rb]

    def _dense_cand(self, fw: torch.Tensor) -> torch.Tensor:
        """The dense body: every edge whose source is in the frontier
        offers its original source id to its destination."""
        words = fw.index_select(0, (self.gsrc >> 5).reshape(-1)).view(self.n, -1)
        active = ((words >> (self.gsrc & 31)) & 1) != 0
        return self._scatter_min(self.dflat, torch.where(active, self.ekey, INT32_MAX))

    def _push_cand(self, fw: torch.Tensor) -> torch.Tensor:
        """The push body: each cell's out-edges of its row stripe's
        frontier list (budgets clamped to the stripe and the cell), fanned
        out through its CSR, min-scattered.  The direction predicate takes
        this body only when the global frontier fits the global budgets,
        and a cell's share never exceeds the global frontier."""
        n, c = self.n, self.c
        bv = S.sparse_budgets(c * self.block, 1)[0]
        be = S.sparse_budgets(self.gtot, self.grid.emax)[1]
        flist = S.extract_frontier_list(fw.view(self.r, c * self.nw), c * self.block, bv)
        flist = flist.repeat_interleave(c, dim=0)  # cell i*c + j: row stripe i's list
        starts = self.indptr.gather(1, flist).to(torch.int64)
        cum = torch.cumsum(self.indptr.gather(1, flist + 1).to(torch.int64) - starts, dim=1)
        j = torch.arange(be, dtype=torch.int64, device=fw.device).expand(n, be).contiguous()
        owner = torch.searchsorted(cum, j, right=True).clamp(0, bv - 1)
        prev = torch.where(owner > 0, cum.gather(1, (owner - 1).clamp_min(0)), 0)
        valid = j < cum[:, -1:]
        eidx = torch.where(valid, starts.gather(1, owner) + (j - prev), 0)
        scratch = (torch.arange(n, dtype=torch.int64, device=fw.device) * (self.rb + 1)
                   + self.rb)[:, None]
        dst = torch.where(valid, self.dflat.gather(1, eidx), scratch)
        return self._scatter_min(dst, torch.where(valid, self.ekey.gather(1, eidx), INT32_MAX))

    def _reached(self, rc: torch.Tensor) -> torch.Tensor:
        """The cells' reached views ``rc[n, r*nw]`` as bools ``[n, r*block]``."""
        return R.unpack_std(rc.reshape(-1), self.n * self.rb).view(self.n, self.rb) != 0

    # -- the loops -------------------------------------------------------------

    def _loop(self, packed: bool, telemetry: bool, mode: str, ex_cfg: ExchangeConfig):
        """The loop of one search's carry: ``(fields..., fw, rc, send,
        [occ, dirs, xbc, xac, xbr, xar], [dstate], ctl)``.  ``pull`` runs
        the dense superstep in blocks of
        :data:`~bfs_tpu_torch.models.loop.EDGE_BLOCK`; ``auto`` and
        ``push`` the switch loop of the push (0) and dense (1) bodies."""
        key = (packed, telemetry, mode, ex_cfg.key())
        if key in self._loops:
            return self._loops[key]
        from ..models import direction as D
        from ..ops import relay_cuda as K

        dev, n, r, c = self.device, self.n, self.r, self.c
        i32 = dict(dtype=torch.int32, device=dev)
        fields = tuple(torch.empty((n, self.block), **i32) for _ in range(1 if packed else 2))
        fw = torch.zeros(self.gtot // 32, **i32)
        rc = torch.zeros((n, r * self.nw), **i32)
        send = torch.zeros((n, self.nw), **i32)
        tel = ((T.init_level_acc(device=dev), T.init_dir_acc(device=dev),
                T.init_bytes_acc(device=dev), T.init_dir_acc(device=dev),
                T.init_bytes_acc(device=dev), T.init_dir_acc(device=dev)) if telemetry else ())
        switch = mode in ("auto", "push")
        dstate = ((torch.zeros(D.DECIDE_WORDS + 2, dtype=torch.float32, device=dev),)
                  if switch else ())
        ctl = C.new_ctl(dev)
        col = make_grid_col_exchange(ex_cfg, self.kw, self.nw, r, c)
        row = make_grid_row_reduce(ex_cfg, self.kw, self.nw, r, c)

        def make_step(body: int):
            # bfs_tpu_torch: hot captured
            def step():
                cand = self._dense_cand(fw) if body else self._push_cand(fw)
                cand = torch.where(self._reached(rc), INT32_MAX, cand)  # the sieve
                candg, xbr, xar = row(cand, self.own)  # [c, r*block]: C_j's min
                live = ctl[C.LIVE] != 0
                settled = R.pack_std(candg != INT32_MAX).repeat(r, 1)  # cell i*c+j: column j's
                rc.copy_(torch.where(live, rc | settled, rc))
                # Cell (i, j)'s own block is stripe position i of column j's.
                own = candg.view(c, r, self.block).movedim(1, 0).reshape(n, self.block)
                if packed:
                    own = torch.where(own == INT32_MAX, -1, own)  # K4's no-candidate value
                update_shards(fields, send, own, ctl)
                words, xbc, xac = col(send, self.own)
                fw.copy_(torch.where(live, words, fw))
                if telemetry:
                    occ, dirs, bc, ac, br, ar = tel
                    level = ctl[C.LEVEL] + 1
                    T.record_frontier_words(occ, fw, level, live)
                    T.record_direction(dirs, level, (T.DIR_PUSH, T.DIR_PULL)[body], live)
                    T.record_exchange(bc, ac, level, xbc, xac, live)
                    T.record_exchange(br, ar, level, xbr, xar, live)
                if switch:
                    if mode == "auto":  # the reference's (mu, prev) after this superstep
                        ds = dstate[0]
                        ds[_PREV_MU] = torch.where(live, ds[D.MU], ds[_PREV_MU])
                        ds[_PREV_USE] = torch.where(live, ctl[C.USE_PULL].to(torch.float32),
                                                    ds[_PREV_USE])
                    next_body(dstate[0], fw, self.outdeg, self.layout, mode, ctl)
                K.loop_control(ctl)

            return step

        buffers = (*fields, fw, rc, send, *tel, *dstate, ctl)
        if switch:
            loop = L.SwitchLoop(buffers, {0: make_step(0), 1: make_step(1)})
        else:
            # Blocks of EDGE_BLOCK: the superstep is mostly plain torch, which
            # a dead superstep runs whole (only its writes are gated).
            loop = L.BlockLoop(buffers, make_step(1), k=L.EDGE_BLOCK, name=f"grid/{packed}")
        self._loops[key] = loop
        return loop

    def _views(self, loop, packed: bool, telemetry: bool, mode: str) -> dict:
        """The carry's tensors by epoch key, views of ``loop``'s buffers:
        the state flat in the global cell-major order (cell ``s`` at
        ``[s*block, (s+1)*block)``), ``fw``, ``rc`` flat (cell-major, as the
        reference's), ``send``, the accumulators, and the decision words
        (``dstate``, with the reference's ``mu`` and ``prev`` on ``auto``)."""
        bufs, nf = loop.buffers, 1 if packed else 2
        views = dict(zip(_state_keys(packed), (f.view(-1) for f in bufs[:nf])))
        views.update(fw=bufs[nf], rc=bufs[nf + 1].view(-1), send=bufs[nf + 2])
        if telemetry:
            views.update(zip(("occ", "dirs", "xbc", "xac", "xbr", "xar"), bufs[nf + 3: nf + 9]))
        if mode in ("auto", "push"):
            views["dstate"] = bufs[-2]
            if mode == "auto":
                views.update(mu=bufs[-2][_PREV_MU], prev=bufs[-2][_PREV_USE])
        return views

    def _begin(self, loop, packed: bool, source_new: int, cap: int, telemetry: bool, mode: str,
               cfg) -> bool:
        """Start one search in ``loop``'s carry from ``source_new`` (a
        relabeled id): the state, the frontier, the reached views (the
        source's bit in each cell of its mesh column), the accumulators
        and, on the switch loop, the first body; returns LIVE."""
        v = self._views(loop, packed, telemetry, mode)
        block, nw, r, c = self.block, self.nw, self.r, self.c
        state = loop.buffers[: 1 if packed else 2]
        state[0].fill_(-1 if packed else INT32_MAX)
        _block_fill(state[0], block, source_new, 0)
        if not packed:
            state[1].fill_(-1)
            _block_fill(state[1], block, source_new, source_new)
        v["fw"].copy_(_source_words(self.gtot, source_new, self.device))
        sb, at = divmod(source_new, block)
        rc = v["rc"].view(r, c, r * nw)
        rc.zero_()
        bit = int(np.array(1 << (at & 31), dtype=np.uint32).view(np.int32))
        rc[:, sb % c, (sb // c) * nw + (at >> 5)].fill_(bit)
        v["send"].zero_()
        if telemetry:
            v["occ"].copy_(T.init_level_acc(device=self.device))
            for k in ("dirs", "xbc", "xac", "xbr", "xar"):
                v[k].zero_()
        live = C.init_ctl(loop.ctl, cap)
        if mode in ("auto", "push"):
            loop.ctl[C.USE_PULL] = first_body(v["dstate"], v["fw"], self.outdeg, self.layout, mode,
                                              cfg).to(torch.int32)
        return live

    def _issue(self, loop, live: bool, mode: str):
        """Run ``loop`` from LIVE: ``(LoopStats, supersteps issued by
        body)``."""
        if mode in ("auto", "push"):
            return loop.run(live)
        stats = loop.run(live)
        return stats, {0: 0, 1: stats.issued}

    # -- runs ------------------------------------------------------------------

    def run(self, source: int, *, max_levels: int | None = None, telemetry: bool = False,
            direction: str | None = None, exchange: str | None = None):
        """One search from ``source`` (an original id): a
        :class:`~bfs_tpu_torch.models.bfs.BfsResult`, with ``telemetry``
        ``(result, level curve)``, the curve holding ``direction_schedule``
        and ``exchange`` (:func:`~.exchange.grid_exchange_report`: each
        axis's bytes and arm per level).  A packed run cut by the 62-level
        cap runs again on the unpacked carry."""
        from ..models.direction import resolve_direction

        srg = self.layout
        check_sources(srg.num_vertices, source)
        cfg, ex_cfg = resolve_direction(direction), resolve_exchange(exchange)
        mode = cfg.mode
        max_levels = int(max_levels) if max_levels is not None else srg.num_vertices
        source_new = int(srg.old2new[source])
        t0 = time.perf_counter()
        packed = self.packed
        loop = self._loop(packed, telemetry, mode, ex_cfg)
        stats, issued = self._issue(loop, self._begin(
            loop, packed, source_new, packed_cap(max_levels) if packed else max_levels, telemetry,
            mode, cfg), mode)
        if packed and packed_truncated(stats.changed, stats.level, max_levels):
            packed = False
            loop = self._loop(packed, telemetry, mode, ex_cfg)
            more, more_issued = self._issue(loop, self._begin(
                loop, packed, source_new, max_levels, telemetry, mode, cfg), mode)
            stats = stats.add(more)
            issued = {b: issued[b] + more_issued[b] for b in issued}
        return self._result(loop, packed, stats, issued, telemetry, mode, source, t0, max_levels,
                            cfg, ex_cfg)

    def _result(self, loop, packed: bool, stats, issued: dict, telemetry: bool, mode: str,
                source: int, t0: float, max_levels: int, cfg, ex_cfg, **extra):
        """A search's result from its loop's carry: the state decoded and
        mapped back to original ids, :attr:`last_run`, and with telemetry
        the level curve."""
        t1 = time.perf_counter()
        fields = loop.buffers[: 1 if packed else 2]
        dist, parent = (packed_dist(fields[0]), packed_parent(fields[0])) if packed else fields
        dist, parent = to_host(*map_back(dist, parent, source, self.old2new))
        self.last_run = {**_run_stats(stats, t0, t1), "issued_push": issued[0],
                         "issued_pull": issued[1], "packed": packed, **extra}
        result = BfsResult(dist=dist, parent=parent, num_levels=stats.level)
        if not telemetry:
            return result
        v = self._views(loop, packed, telemetry, mode)
        fv, dirs, xbc, xac, xbr, xar = T.read_telemetry(
            *(v[k] for k in ("occ", "dirs", "xbc", "xac", "xbr", "xar")))
        curve = T.level_curve(fv, cap=min(PACKED_MAX_LEVELS, max_levels) if packed else max_levels)
        curve["direction_schedule"] = T.direction_schedule(dirs, mode=cfg.mode, alpha=cfg.alpha,
                                                           beta=cfg.beta)
        curve["exchange"] = grid_exchange_report(xbc, xac, xbr, xar, ex_cfg, self.kw, self.nw,
                                                 self.r, self.c, num_levels=result.num_levels)
        return result, curve

    # -- segmented runs (superstep checkpoints) ---------------------------------

    def _segment_carry(self, source: int, packed: bool, telemetry: bool, cfg, ex_cfg,
                       restore: dict | None):
        """:func:`grid_segment_carry`'s work: ``(loop, views, level,
        changed)``."""
        from ..resilience.superstep_ckpt import epoch_tensor

        srg, mode = self.layout, cfg.mode
        loop = self._loop(packed, telemetry, mode, ex_cfg)
        views = self._views(loop, packed, telemetry, mode)
        if restore is None:
            check_sources(srg.num_vertices, source)
            self._begin(loop, packed, int(srg.old2new[source]), 0, telemetry, mode, cfg)
            return loop, views, 0, True
        views["send"].zero_()
        for key in grid_segment_keys(packed, mode == "auto", telemetry):
            if key in views and key not in ("mu", "prev"):
                views[key].copy_(epoch_tensor(restore[key], self.device, views[key].dtype))
        level, changed = int(restore["level"]), bool(restore["changed"])
        use_pull = 0
        if mode in ("auto", "push"):
            use_pull = restored_body(restore, views["dstate"], views["fw"], self.outdeg, srg, mode,
                                     cfg)
            if mode == "auto":
                views["mu"].fill_(float(np.asarray(restore["mu"])))
                views["prev"].fill_(float(bool(np.asarray(restore["prev"]))))
        C.resume_ctl(loop.ctl, level, changed, level, use_pull)
        return loop, views, level, changed

    def _snapshot(self, views: dict, keys: list, level: int, changed: bool,
                  packed: bool) -> tuple[dict, list | None]:
        """The carry as an epoch, one copy to the host, in the reference's
        dtypes (``occ``/``xbc``/``xbr`` int32, ``prev`` bool): ``(meta
        arrays, per-cell state arrays)``, or one file's arrays and None on a
        grid of one cell."""
        from ..resilience.superstep_ckpt import epoch_arrays

        tensors = {k: views[k] for k in keys if k in views}
        snap = epoch_arrays(tensors, level=np.int32(level), changed=np.bool_(changed),
                            packed_flag=np.int32(packed))
        for k in ("occ", "xbc", "xbr"):
            if k in snap:
                snap[k] = snap[k].astype(np.int32)
        if "prev" in snap:
            snap["prev"] = np.bool_(snap["prev"] != 0)
        if self.n == 1:
            return snap, None
        state = _state_keys(packed)
        cells = [{k: snap[k][s * self.block:(s + 1) * self.block] for k in state}
                 for s in range(self.n)]
        return {k: v for k, v in snap.items() if k not in state}, cells

    def _run_segmented_flavor(self, source: int, ckpt, max_levels: int, packed: bool,
                              telemetry: bool, cfg, ex_cfg):
        """One carry flavor through bounded segments, an epoch after each,
        from the newest valid epoch of that flavor or from the start:
        ``(loop, LoopStats, issued by body, copy seconds)``."""
        from ..resilience.superstep_ckpt import restore_arrays

        mode = cfg.mode
        cap = packed_cap(max_levels) if packed else max_levels
        keys = grid_segment_keys(packed, mode == "auto", telemetry)
        state, per_cell = _state_keys(packed), self.n > 1
        arrays, cell_arrays = restore_arrays(
            ckpt, packed, require=tuple(k for k in keys if not (per_cell and k in state)),
            require_shards=state if per_cell else ())
        restore = None if arrays is None else dict(arrays)
        if restore is not None and per_cell:
            for k in state:  # the cell files reassemble cell-major into the global view
                restore[k] = np.concatenate([ca[k] for ca in cell_arrays])
        loop, views, level, changed = self._segment_carry(source, packed, telemetry, cfg, ex_cfg,
                                                          restore)
        stats, issued, copy_s = L.LoopStats(level, changed), {0: 0, 1: 0}, 0.0
        while changed and level < cap:
            t0 = time.perf_counter()
            seg = loop.segment(min(level + ckpt.interval(), cap), level, changed)
            if isinstance(seg, tuple):  # the switch loop: supersteps by body
                seg, by_body = seg
                for body, k in by_body.items():
                    issued[body] += k
            else:
                issued[1] += seg.issued
            seg_s = time.perf_counter() - t0
            stats = stats.add(seg)
            meta, cells = {}, None
            if ckpt.enabled:  # a disabled store marks the boundary without the copy
                t1 = time.perf_counter()
                meta, cells = self._snapshot(views, keys, seg.level, seg.changed, packed)
                copy_s += time.perf_counter() - t1
            ckpt.save_epoch(seg.level, meta, cells)
            ckpt.note_segment(seg.level - level, seg_s)
            level, changed = seg.level, seg.changed
        return loop, stats, issued, copy_s

    def run_segmented(self, source: int, *, ckpt, max_levels: int | None = None,
                      telemetry: bool = False, direction: str | None = None,
                      exchange: str | None = None):
        """One search from ``source`` in bounded segments with an epoch in
        ``ckpt`` (a :class:`~bfs_tpu_torch.resilience.superstep_ckpt.SuperstepCheckpointer`
        built with ``shards == r*c``) after each, resuming from its newest
        complete epoch: bit for bit with :meth:`run` (dist, parent,
        ``num_levels``, the direction schedule, both axes' arms and bytes)
        for any segmentation.  Every segment runs on :meth:`run`'s own
        captured loop, bounded by the segment's end; a lost or damaged cell
        file makes the loader fall back to the last complete epoch.  A
        packed run stopped by its 62-level cap clears the store and runs
        again unpacked; the epochs are cleared when the run completes.
        :attr:`last_run` adds ``copy_s``, the seconds of the copies to the
        host."""
        from ..models.direction import resolve_direction

        if getattr(ckpt, "shards", 1) != self.n:
            raise ValueError(f"checkpointer built for {getattr(ckpt, 'shards', 1)} shards but the "
                             f"{self.r}x{self.c} grid has {self.n} cells")
        srg = self.layout
        check_sources(srg.num_vertices, source)
        cfg, ex_cfg = resolve_direction(direction), resolve_exchange(exchange)
        max_levels = int(max_levels) if max_levels is not None else srg.num_vertices
        t0 = time.perf_counter()
        packed = self.packed
        loop, stats, issued, copy_s = self._run_segmented_flavor(
            source, ckpt, max_levels, packed, telemetry, cfg, ex_cfg)
        if packed and packed_truncated(stats.changed, stats.level, max_levels):
            ckpt.clear()  # packed epochs cannot feed the unpacked re-run
            packed = False
            loop, more, more_issued, more_s = self._run_segmented_flavor(
                source, ckpt, max_levels, packed, telemetry, cfg, ex_cfg)
            stats, copy_s = stats.add(more), copy_s + more_s
            issued = {b: issued[b] + more_issued[b] for b in issued}
        ckpt.clear()
        return self._result(loop, packed, stats, issued, telemetry, cfg.mode, source, t0,
                            max_levels, cfg, ex_cfg, copy_s=copy_s)


def grid_segment_carry(eng: GridEngine, source: int, *, packed: bool | None = None,
                       telemetry: bool = False, direction: str | None = None,
                       exchange: str | None = None, restore: dict | None = None) -> dict:
    """Start a segmented run of ``eng`` in its loop's carry, paused before
    its first segment: a fresh search from ``source``, or the carry of an
    epoch (``restore``: host arrays by :func:`grid_segment_keys`, the
    per-cell state concatenated cell-major).  Returns the carry's tensors
    by key with ``level`` and ``changed`` as host values."""
    from ..models.direction import resolve_direction

    packed = eng.packed if packed is None else packed
    _, views, level, changed = eng._segment_carry(source, packed, telemetry,
                                                  resolve_direction(direction),
                                                  resolve_exchange(exchange), restore)
    return {**views, "level": level, "changed": changed}


# -------------------------------------------------------------- entry points --

def _grid_engine(graph, mesh: Mesh | None) -> GridEngine:
    """An engine for one call: ``graph`` a Graph or DeviceGraph (its
    ``r*c``-shard relay layout built on the mesh's device) or a prebuilt
    ShardedRelayGraph of that shard count."""
    if mesh is None:
        mesh = make_grid_mesh(*resolve_grid_mesh())
    r, c = _grid_shape(mesh)
    if isinstance(graph, ShardedRelayGraph):
        if graph.num_shards != r * c:
            raise ValueError(f"ShardedRelayGraph has {graph.num_shards} shards but the grid has "
                             f"{r * c} cells; rebuild it with num_shards={r * c}")
        srg = graph
    else:
        srg = build_sharded_relay_graph(graph, r * c, device=mesh.device)
    return GridEngine(srg, mesh)


def bfs_grid(graph, source: int = 0, *, mesh: Mesh | None = None, max_levels: int | None = None,
             telemetry: bool = False, direction: str | None = None, exchange: str | None = None):
    """BFS on the 2-D grid (``BFS_TPU_TORCH_MESH=rxc`` picks the shape when
    ``mesh`` is None; the visible cards): a Graph or a prebuilt ``r*c``-shard
    ShardedRelayGraph; returns a
    :class:`~bfs_tpu_torch.models.bfs.BfsResult` (with ``telemetry``
    ``(result, level curve)``, the curve's ``exchange`` per axis), equal
    bit for bit to the 1-D mesh and the single-chip engines.  Builds a
    :class:`GridEngine` for the call and drops it: hold one to replay its
    captured loops."""
    from ..models.direction import resolve_direction

    resolve_direction(direction)  # a bad mode or arm raises before the layout is built
    resolve_exchange(exchange)
    return _grid_engine(graph, mesh).run(source, max_levels=max_levels, telemetry=telemetry,
                                         direction=direction, exchange=exchange)


def bfs_grid_segmented(graph, source: int = 0, *, mesh: Mesh | None = None, ckpt,
                       max_levels: int | None = None, telemetry: bool = False,
                       direction: str | None = None, exchange: str | None = None):
    """The resumable twin of :func:`bfs_grid`: one search in bounded
    segments with per-cell epochs in ``ckpt`` (built with ``shards ==
    r*c``, else ``ValueError``), resuming from its newest complete epoch
    (:meth:`GridEngine.run_segmented`); bit for bit with the fused search,
    both axes' arm and byte sequences included, for any segmentation."""
    from ..models.direction import resolve_direction

    if mesh is None:
        mesh = make_grid_mesh(*resolve_grid_mesh())
    r, c = _grid_shape(mesh)
    if getattr(ckpt, "shards", 1) != r * c:
        raise ValueError(f"checkpointer built for {getattr(ckpt, 'shards', 1)} shards but the "
                         f"{r}x{c} grid has {r * c} cells")
    resolve_direction(direction)
    resolve_exchange(exchange)
    return _grid_engine(graph, mesh).run_segmented(source, ckpt=ckpt, max_levels=max_levels,
                                                   telemetry=telemetry, direction=direction,
                                                   exchange=exchange)
