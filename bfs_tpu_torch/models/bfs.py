"""BFS on the card: :func:`bfs`, the engines :class:`RelayEngine` and
:class:`EdgeEngine`, :class:`SuperstepRunner` and :func:`bfs_level_curve`.

The port of ``bfs_tpu.models.bfs``.  :func:`bfs` runs the pull engine by
default, as the reference's does; :class:`EdgeEngine` holds the push and
pull layouts, whose supersteps are plain torch ops on the same level loop;
:class:`SuperstepRunner` steps any engine one superstep per call.

The relay engine (``engine="relay"``): the layout is
built on the host once (:func:`~bfs_tpu_torch.graph.relay.build_relay_graph`)
and shipped to the device once; every superstep then runs five phases on
the device:

  1. the vperm Beneš network on the frontier words (zero-padded to the
     network size, the padding zeroed anew every superstep);
  2. ``broadcast_l2`` (torch ops);
  3. the net Beneš network;
  4. the masked min-rank row-min per in-degree class;
  5. the packed ``level:6|rank:26`` min-update, which also emits the next
     frontier words and the ``changed`` flag.

Phases 1, 3, 4 and 5 are the hand-written kernels of
:mod:`bfs_tpu_torch.ops.relay_cuda` on a card and their plain versions on
the CPU.  The level loop runs in blocks of supersteps gated by a control
block in device memory (:mod:`bfs_tpu_torch.models.loop`): on a card a
block is a replayed CUDA graph and the host reads the control block once
per block.  A search that hits the packed carry's 62-level cap is re-run on
the unpacked carry.  Results are mapped to original ids on the device and
reach the host through pinned memory.

Batched multi-source BFS runs on the same layout:
:meth:`RelayEngine.run_multi_elem` packs 32 trees into each uint32 element
(:mod:`bfs_tpu_torch.ops.relay_elem`).  The route from frontier elements to
L1 slot elements (both Beneš networks and the broadcast) is fixed for a
graph, so it is built once per engine as one gather index
(:meth:`RelayEngine.route_index`, by the elem Beneš kernels) and every
superstep is one gather and the fused row-min/update, the kernels of
``csrc/relay_elem_kernels.cu`` on a card.  A batch deeper than the 31
levels its distance planes hold falls back to :meth:`RelayEngine.run_multi`,
the lock-step form.

The lock-step batch (:meth:`RelayEngine.run_multi_device`,
:meth:`RelayEngine.run_multi`; the reference's ``vmap`` over the dense
superstep) carries S trees on a leading axis in one level loop: each
superstep runs the dense superstep above on all S trees at once (each
kernel of the superstep one launch for the batch, the tree index in its
grid), one update raises one flag for the batch and one control step ends
it, so LEVEL is shared and the loop runs until no tree changes.

``RelayEngine(..., expansion="mxu")`` (or ``auto`` where the probe measures
it faster, :mod:`bfs_tpu_torch.profiling`) runs single-source searches (and the
lock-step :meth:`RelayEngine.run_multi`) through the MXU expansion arm
instead: phases 1-4 become one tiled masked product of the frontier
against bit-packed 128x128 adjacency tiles (:mod:`bfs_tpu_torch.graph.adj_tiles`,
:mod:`bfs_tpu_torch.ops.relay_mxu`; kernel ``mxu_expand`` on tensor cores),
whose candidates are ORIGINAL ids that the packed update merges as they
are.  The element-major batch stays on the gather formulation.
``tiles_mode="stream"`` (or ``auto`` over the cache budget) keeps the tiles
in a pinned host store instead and pages column superblocks onto the card
per pull level (:mod:`bfs_tpu_torch.stream`, :meth:`RelayEngine.run_streamed`);
:meth:`RelayEngine.run` and :meth:`RelayEngine.run_segmented` route there.

The relay engine's schedule (``sparse_hybrid=True``, the default, as in the
reference): in the ``auto`` and ``push`` modes of its direction policy each
superstep runs one of two bodies over one carry, the sparse superstep of
:mod:`bfs_tpu_torch.ops.sparse` (``push``: the frontier's out-edges
gathered from the layout's CSR, plain torch, XLA in the reference) or the
dense one above (``pull``).  ``auto`` takes the Beamer rule of
:mod:`bfs_tpu_torch.models.direction` or'd with "the frontier is over the
sparse budgets"; ``push`` takes the sparse body whenever the frontier fits
them.  The loop is a :class:`~bfs_tpu_torch.models.loop.SwitchLoop`: one
captured graph per body, each ending with the next body written into the
control block, which the host reads after every superstep.  ``pull``, and
every mode of an engine built with ``sparse_hybrid=False``, runs the dense
superstep in blocks of :data:`~bfs_tpu_torch.models.loop.BLOCK`.

Level curves (:mod:`bfs_tpu_torch.obs.telemetry`): :func:`bfs_level_curve`
runs push and pull through the direction loop in their forced mode
(:mod:`bfs_tpu_torch.models.direction`); :meth:`RelayEngine.run_level_curve`
carries the occupancy and direction accumulators in the relay loop's
carry, recorded beside the kernels of the captured block.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import knobs
from ..analysis.runtime import explicit_transfer
from ..graph.csr import DeviceGraph, Graph, INF_DIST, build_device_graph
from ..graph.ell import PullGraph, build_pull_graph, device_ell
from ..graph.relay import RelayGraph, build_relay_graph, valid_slot_words
from ..obs import telemetry as T
from ..ops import control as C
from ..ops import relay as R
from ..ops import relay_cuda as K
from ..ops import relay_elem as RE
from ..ops import relay_mxu as RM
from ..ops import sparse as S
from ..ops.packed import (
    INT32_MAX,
    PACKED_MAX_LEVELS,
    level_bits,
    packed_cap,
    packed_dist,
    packed_parent,
    packed_parent_fits,
    packed_rank_fits,
    packed_truncated,
)
from ..ops.pull import frontier_table, pull_candidates
from ..ops.relax import (
    BfsState,
    PackedBfsState,
    _batched_push_candidates,
    _push_candidates,
    apply_candidates,
    apply_candidates_packed,
    frontier_size,
    init_batched_state,
    init_packed_batched_state,
    init_packed_state,
    init_state,
    unpack_bfs_state,
)
from ..ops.relay import slots_to_parent
from ..ops.sparse import SPARSE_BE, SPARSE_BV, sparse_budgets  # noqa: F401  (the reference's names)
from . import loop as L
from .multisource import MultiBfsResult

logger = logging.getLogger(__name__)


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names another device; without a card
    and without an explicit device this raises rather than run on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain PyTorch path"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA device is available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def check_sources(num_vertices: int, sources) -> None:
    """Reject out-of-range sources on the host."""
    arr = np.atleast_1d(np.asarray(sources))
    if arr.size == 0 or arr.min() < 0 or arr.max() >= num_vertices:
        raise ValueError(
            f"source vertices {arr.tolist()} out of range for V={num_vertices}"
        )


@dataclass
class BfsResult:
    """Host-side result: ``dist``/``parent`` int32[V] in original ids.
    ``num_levels`` counts executed supersteps including the final empty
    one that detects termination (3 on tinyCG)."""

    dist: np.ndarray
    parent: np.ndarray
    num_levels: int

    def has_path_to(self, v: int) -> bool:
        return int(self.dist[v]) != INF_DIST

    def dist_to(self, v: int) -> int:
        return int(self.dist[v])

    def path_to(self, v: int) -> list[int]:
        from ..graph.vertex import path_to

        return path_to(self.parent, v)


class RelayEngine:
    """Device-resident relay layout + the level loop (``engine='relay'``).

    ``__init__`` builds the layout (unless given a :class:`RelayGraph`) and
    ships masks and valid-slot words to ``device`` once; :meth:`run` runs
    one source, :meth:`run_multi_elem` and :meth:`run_multi` (on
    :meth:`run_multi_device`, the lock-step loop) a batch.

    ``expansion`` (``auto|gather|mxu``, default ``BFS_TPU_TORCH_EXPANSION``,
    ``auto``, as in the reference) picks the dense superstep's arm: ``mxu``
    builds the adjacency tiles on ``device`` under ``tiles_budget_bytes``
    (default 4 GiB) and raises ``ValueError`` if they exceed it; ``auto``
    takes gather on the CPU, past the 26-bit packed parent field and where
    the counted tiles exceed the budget (none built), and otherwise the
    arm the memoized probe measures faster on the engine's own operands
    (:meth:`_resolve_expansion_static`, :meth:`_resolve_expansion_measured`).
    :attr:`expansion_basis` says how the arm was chosen, :attr:`phase_probe`
    holds the probe's document.
    ``tiles_mode`` (``resident|stream|auto``, default
    ``BFS_TPU_TORCH_TILES``) says where the MXU arm's tiles live: shipped
    to ``device``, or (``stream``, and ``auto`` when they exceed the stream
    cache budget) cut into the host store :attr:`stream_store` with only the
    O(V) key table on the device, searched by :meth:`run_streamed`.
    ``direction`` (``push|pull|auto``, default ``BFS_TPU_TORCH_DIRECTION``)
    is :attr:`direction`, the schedule's policy.  ``sparse_hybrid`` (default
    True, as in the reference) ships the sparse body's adjacency
    (:mod:`bfs_tpu_torch.ops.sparse`) so that ``auto`` and ``push`` run the
    hybrid schedule; without it every superstep is dense and ``push``
    raises, from the argument or the knob.  :meth:`run` and
    :meth:`run_level_curve` run the schedule; :meth:`run_multi`,
    :meth:`run_multi_elem` and :meth:`step` stay dense, as the reference's.
    """

    def __init__(
        self, graph: Graph | RelayGraph, *, device=None, sparse_hybrid: bool = True,
        expansion: str | None = None, tiles_budget_bytes: int | None = None,
        direction: str | None = None, tiles_mode: str | None = None,
    ):
        from .direction import resolve_direction  # direction.py imports this module

        self.device = resolve_device(device)
        #: The direction policy (``BFS_TPU_TORCH_DIRECTION`` unless given).
        self.direction = resolve_direction(direction)
        if self.direction.mode == "push" and not sparse_hybrid:
            raise ValueError(
                "direction='push' needs sparse_hybrid=True (the push body is the sparse "
                "gather superstep); use 'pull' or 'auto'"
            )
        self.sparse_hybrid = bool(sparse_hybrid)
        #: Where the MXU arm's tiles live (frozen; an ``auto`` engine decides
        #: per run, :meth:`_stream_effective`).
        self.tiles_mode = RM.resolve_tiles_mode(tiles_mode)
        rg = graph if isinstance(graph, RelayGraph) else build_relay_graph(graph)
        self.relay_graph = rg
        self.packed = packed_rank_fits(rg.in_classes)
        dev = self.device

        def ship(words: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(
                np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)
            ).to(dev)

        self.vperm_masks = ship(rg.vperm_masks)
        self.net_masks = ship(rg.net_masks)
        self.valid_words = ship(valid_slot_words(rg.src_l1, rg.net_size))
        # Result mapping tables (relabeled -> original ids), on the device.
        self.old2new = torch.from_numpy(rg.old2new.astype(np.int64)).to(dev)
        self.src_l1 = torch.from_numpy(np.asarray(rg.src_l1, dtype=np.int32)).to(dev)
        #: Out-degree per relabeled vertex, int32[vr] (the masses, the edge curve).
        self.outdeg = torch.from_numpy(
            np.diff(rg.adj_indptr[: rg.vr + 1].astype(np.int64)).astype(np.int32)).to(dev)
        #: Host seconds of the last run: the level loop (it ends in a
        #: device read) and the result mapping with its copy to the host;
        #: the loop's counts, with ``issued_push`` and ``issued_pull`` (the
        #: supersteps issued per body) on single-source searches.
        self.last_run: dict = {}
        self.adj_tiles = None
        self.mxu_operands = None
        #: The stream ledger of the last streamed run (:meth:`run_streamed`).
        self.stream_report: dict | None = None
        self._stream_store = None
        self._stream_cache = None
        self._stream_copy = None  # the copy stream of every cache of this engine
        self._stream_keys2d = None
        self._route_index = None
        self._rank_tables = None
        self._sparse: dict = {}
        self._issued = {0: 0, 1: 0}
        #: ``blocks``: the level loop runs in blocks of gated supersteps
        #: (:mod:`~bfs_tpu_torch.models.loop`, captured and replayed on a
        #: card); ``eager``: its plain version, a host read of ``changed``
        #: per level, for comparison.
        self.loop = "blocks"
        self._loops: dict = {}
        self._resolve_expansion(expansion, tiles_budget_bytes)
        if self.sparse_hybrid:
            self._sparse_tensors_for(self.packed)  # the engine's own carry flavor, now

    # -- the expansion arm --------------------------------------------------

    def _resolve_expansion(self, requested: str | None, budget: int | None) -> None:
        """The dense superstep's arm, the reference's two halves: the static
        gates (:meth:`_resolve_expansion_static`), then for an ``auto`` that
        passed them the measured probe (:meth:`_resolve_expansion_measured`)."""
        self._resolve_expansion_static(requested, budget)
        if self.expansion == "auto-probe":
            self._resolve_expansion_measured()

    def _resolve_expansion_static(self, requested: str | None, budget: int | None) -> None:
        """The static gates, in order (:attr:`expansion_basis` names the one
        that decided):

        1. ``gather`` or ``mxu`` asked for (the argument, else
           ``BFS_TPU_TORCH_EXPANSION``) resolves as asked; ``mxu`` builds the
           tiles now (a budget refusal raises) and drops to the unpacked
           carry where ``V`` exceeds the 26-bit packed parent field, which
           holds original ids on this arm;
        2. ``auto`` on a packed carry whose ``V`` exceeds that field: gather;
        3. ``auto`` on the CPU: gather, no tile built (unless
           ``BFS_TPU_TORCH_PHASE_PROBE=force``);
        4. ``auto`` whose tiles would exceed ``tiles_budget_bytes``: gather,
           from the tile count, before any tile is built.

        Otherwise :attr:`expansion` is ``"auto-probe"`` until the measured
        half."""
        req = RM.resolve_expansion(requested)
        rg = self.relay_graph
        self.expansion_requested = req
        self.tiles_budget_bytes = RM.DEFAULT_TILES_BUDGET_BYTES if budget is None else int(budget)
        #: ``(nt, vtp, rtp)`` of the tiles ``auto`` counted (part of the probe
        #: verdict's key), else None.
        self.tile_geometry = None
        #: The probe's document (None when no probe ran) and its expansion record.
        self.phase_probe = None
        self.expansion_probe = None
        #: Host seconds of ``auto``'s steps: the tile count, the tile build
        #: and shipping, the probe (0 when a step did not run).
        self.tile_count_s = self.tiles_build_s = self.probe_s = 0.0
        self.expansion = "gather"
        if req != "auto":
            self.expansion_basis = (
                "requested" if requested is not None else "forced (BFS_TPU_TORCH_EXPANSION)")
            if req == "mxu":
                self.packed = self.packed and packed_parent_fits(rg.num_vertices)
                self._build_tiles()
                self.expansion = "mxu"
            return
        if self.packed and not packed_parent_fits(rg.num_vertices):
            self.expansion_basis = (
                "auto -> gather: V exceeds the 26-bit packed parent field for original-id "
                "candidates")
            return
        if self.device.type != "cuda" and knobs.get("BFS_TPU_TORCH_PHASE_PROBE") != "force":
            self.expansion_basis = (
                "auto -> gather: cpu device, no probe (the kernels run only on a card; "
                "BFS_TPU_TORCH_PHASE_PROBE=force probes the plain arms)")
            return
        from ..graph import adj_tiles as AT

        t0 = time.perf_counter()
        nt = AT.count_tiles_from_relay(rg, self.device)
        need = AT.tiles_nbytes(nt, rg.vr, rg.vr)
        self.tile_geometry = (nt, AT.round_up(max(rg.vr, 1), AT.SB_VERTS), AT.round_up(rg.vr, AT.TILE))
        self.tile_count_s = time.perf_counter() - t0
        if need > self.tiles_budget_bytes:
            self.expansion_basis = (
                f"auto -> gather: tiles over budget ({nt} tiles, {need} bytes > "
                f"tiles_budget_bytes {self.tiles_budget_bytes}), none built")
            return
        self.expansion = "auto-probe"

    def _resolve_expansion_measured(self) -> None:
        """``auto`` past its gates: the memoized probe
        (:meth:`_probe_memoized`; on a miss the tiles are built resident and
        :func:`bfs_tpu_torch.profiling.probe_phase_kernels` times both arms)
        selects the arm.  The MXU arm keeps (or, after a memo hit, builds)
        its tiles, cut into the host store in stream mode; the gather arm
        releases their device copy."""
        from ..profiling import probe_phase_kernels

        def probe(eng):
            eng._build_tiles(resident=True)
            t0 = time.perf_counter()
            try:
                return probe_phase_kernels(eng)
            finally:
                eng.probe_s = time.perf_counter() - t0

        self.phase_probe = self._probe_memoized(probe)
        memo = self.phase_probe.get("memo")
        rec = self.phase_probe.get("expansion")
        if rec is not None and "selected" in rec:
            arm = rec["selected"]
            self.expansion_probe = rec
            times = ", ".join(f"{a} {rec[f'{a}_seconds']:.6g} s" for a in ("gather", "mxu")
                              if f"{a}_seconds" in rec)
            self.expansion_basis = (
                f"auto -> {arm}: {rec['selection_basis']} ({times} a dense superstep; "
                f"probe memo {memo})")
        else:
            arm = "gather"
            why = (rec or {}).get("probe_error") or self.phase_probe.get("probe_error")
            self.expansion_basis = f"auto -> gather: fallback (probe failed: {why})"
        if arm == "mxu":
            self._build_tiles()
            self._place_tiles()
            self.expansion = "mxu"
        else:
            self.adj_tiles = self.mxu_operands = None
            self.expansion = "gather"

    def _probe_memoized(self, probe_fn) -> dict:
        """The probe, memoized beside the layout bundles: a verdict saved
        under :func:`~bfs_tpu_torch.cache.layout.probe_verdict_key` is read
        back (``memo: hit``, nothing timed, no tile built); else
        ``probe_fn(self)`` runs and its verdict is saved (``memo: miss``).
        On a card a probe that raises fails the engine (a kernel there
        launches or raises); elsewhere it gives ``{"probe_error": ...}``.
        A verdict that holds a failure is never saved, so a later engine
        probes again."""
        from ..cache.layout import load_probe_verdict, probe_verdict_key, save_probe_verdict

        key = None
        try:
            key = probe_verdict_key(self)
            cached = load_probe_verdict(key)
            if cached is not None:
                cached["memo"] = "hit"
                return cached
        except Exception as exc:
            logger.warning("probe memo unavailable: %r", exc)
        try:
            probe = probe_fn(self)
        except Exception as exc:
            if self.device.type == "cuda":
                raise
            logger.warning("expansion probe failed: %r", exc)
            return {"probe_error": repr(exc), "memo": "miss"}
        probe["memo"] = "miss"
        exp = probe.get("expansion") or {}
        if "probe_error" in exp or "mxu_error" in exp.get("arms", {}):
            logger.warning("expansion probe verdict not memoized: %s",
                           exp.get("probe_error") or exp["arms"]["mxu_error"])
        elif key is not None:
            try:
                save_probe_verdict(key, probe)
            except Exception as exc:
                logger.warning("probe memo write failed: %r", exc)
        return probe

    def _build_tiles(self, resident: bool = False) -> None:
        """The tiled adjacency through ``load_or_build_tiles`` under
        :attr:`tiles_budget_bytes` (built on the engine's device unless
        ``BFS_TPU_TORCH_TILES_BUILD=host``; once per engine), shipped as
        the expansion's device operands, then placed (:meth:`_place_tiles`)
        unless ``resident`` (the probe times the resident arm)."""
        if self.adj_tiles is not None or self._stream_store is not None:
            return
        from ..cache.layout import load_or_build_tiles

        t0 = time.perf_counter()
        at, self.tiles_info = load_or_build_tiles(self.relay_graph,
                                                  budget_bytes=self.tiles_budget_bytes,
                                                  device=self.device)
        self.mxu_geometry = RM.mxu_static(at)
        #: Bytes of the tile layout (what ``auto`` holds against the budget).
        self.tiles_nbytes = at.nbytes
        self.adj_tiles = at
        if resident or not self._stream_mode():
            self.mxu_operands = RM.mxu_device_operands(at, self.device)
        else:
            self._place_tiles()
        #: Host seconds of the tile build and its shipping (or its host store).
        self.tiles_build_s = time.perf_counter() - t0
        logger.info(
            "mxu tiles: %d tiles, %d bytes, built in %.3f s on %s, %s",
            at.nt, at.nbytes, self.tiles_build_s, self.device,
            "resident" if self.adj_tiles is not None else "host store",
        )

    def _stream_mode(self) -> bool:
        """Do the tiles live in the host store: stream mode, or ``auto``
        over the stream cache budget (at engine init)?"""
        return self.tiles_mode == "stream" or (
            self.tiles_mode == "auto" and self.tiles_nbytes > RM.stream_cache_budget_bytes())

    def _place_tiles(self) -> None:
        """In stream mode the layout is cut into the host store, only
        ``keys2d`` is kept on the device and the layout's device copy is
        released; otherwise it stays resident."""
        if self.adj_tiles is None or not self._stream_mode():
            return
        from ..stream.runner import keys2d_for
        from ..stream.store import HostTileStore

        self._stream_store = HostTileStore(self.adj_tiles, pin=self.device.type == "cuda")
        self.adj_tiles = self.mxu_operands = None
        keys2d_for(self)

    # -- beyond device memory: the streamed arm ------------------------------------

    def _stream_effective(self) -> bool:
        """Do this engine's searches page the tiles from the host store?
        Only the MXU arm streams (a gather engine stays resident whatever
        ``tiles_mode`` says); a stream engine always does; ``auto`` does
        exactly when the layout exceeds the stream cache budget now."""
        if self.expansion != "mxu":
            return False
        if self.adj_tiles is None:
            return True  # the tiles live in the host store only
        return self.tiles_mode == "auto" and self.tiles_nbytes > RM.stream_cache_budget_bytes()

    @property
    def stream_store(self):
        """The host tile store (:class:`~bfs_tpu_torch.stream.HostTileStore`)
        of the streamed arm, cut from the resident layout at first use on an
        ``auto`` engine."""
        from ..stream.runner import store_for

        return store_for(self)

    def run_streamed(self, source: int = 0, *, ckpt=None, max_levels: int | None = None,
                     telemetry: bool = False, cache_budget_bytes: int | None = None):
        """One search with the tiles paged per column superblock from the
        host store through the device cache
        (:func:`bfs_tpu_torch.stream.run_streamed`): the streamed twin of
        :meth:`run_segmented` (with ``ckpt``) and :meth:`run`, bit for bit
        with them; the ledger lands on :attr:`stream_report`.  Raises
        ``ValueError`` on a gather engine."""
        from ..stream.runner import run_streamed

        return run_streamed(self, source, ckpt=ckpt, max_levels=max_levels,
                            telemetry=telemetry, cache_budget_bytes=cache_budget_bytes)

    # -- one superstep ------------------------------------------------------

    def _routed(self, fwords: torch.Tensor, ctl: torch.Tensor | None = None) -> torch.Tensor:
        """Phases 1-3: frontier words -> routed L1 slot words (one search,
        or a batch on a leading axis)."""
        rg = self.relay_graph
        fw = torch.zeros((*fwords.shape[:-1], rg.vperm_size // 32), dtype=torch.int32,
                         device=self.device)
        fw[..., : rg.vr // 32] = fwords  # dummy out-positions read the zero tail
        y = K.apply_benes(fw, self.vperm_masks, rg.vperm_table, rg.vperm_size, ctl=ctl)
        l2 = R.broadcast_l2(y, rg.out_classes, rg.net_size, rg.out_space)
        return K.apply_benes(l2, self.net_masks, rg.net_table, rg.net_size, ctl=ctl)

    def _ranks(self, fwords: torch.Tensor, ctl: torch.Tensor | None = None) -> torch.Tensor:
        rg = self.relay_graph
        return K.rowmin_ranks(
            self._routed(fwords, ctl), self.valid_words, rg.in_classes, rg.vr, ctl=ctl
        )

    def _cand_packed(self, fwords: torch.Tensor, ctl: torch.Tensor | None = None) -> torch.Tensor:
        """The packed carry's candidates: min ranks per vertex (gather arm),
        or min ORIGINAL ids (MXU arm, kernel ``mxu_expand``)."""
        if self.expansion == "mxu":
            if self.mxu_operands is None:
                raise RuntimeError(
                    "a streamed engine keeps its tiles in the host store: search with "
                    "run, run_segmented or run_streamed")
            rows, cols, rtp, vtp, _ = self.mxu_geometry
            return K.expand_frontier_mxu(
                fwords, self.mxu_operands, rows=rows, cols=cols, rtp=rtp, vtp=vtp, ctl=ctl
            )
        return self._ranks(fwords, ctl)

    def _cand_unpacked(self, fwords: torch.Tensor, ctl: torch.Tensor | None = None) -> torch.Tensor:
        """The unpacked carry's candidates, INT32_MAX where none: the
        row-min's ranks as L1 slots through the class slot formula, or on
        the MXU arm the original ids as they are."""
        cand = self._cand_packed(fwords, ctl)
        if self.expansion == "mxu":
            return torch.where(cand == -1, INT32_MAX, cand)
        rg = self.relay_graph
        return R.rank_to_slot(cand, rg.in_classes, rg.vr)

    def superstep_packed(self, st: R.PackedRelayState) -> R.PackedRelayState:
        return K.apply_relay_candidates_packed(st, self._cand_packed(st.fwords))

    def superstep(self, st: R.RelayState) -> R.RelayState:
        """Unpacked carry: the candidates of :meth:`_cand_unpacked`, then the
        unpacked merge (torch ops)."""
        return R.apply_relay_candidates(st, self._cand_unpacked(st.fwords))

    def _gated_dense(self, st, ctl: torch.Tensor) -> None:
        """One dense superstep gated by ``ctl``, in place on a loop's carry
        (``st`` views of its buffers): on the packed carry ``packed_update``
        writes the words and the next frontier; on the unpacked carry the
        merge (torch ops) is copied in and the flag raised."""
        if isinstance(st, R.PackedRelayState):
            K.apply_relay_candidates_packed(st, self._cand_packed(st.fwords, ctl),
                                            fwords_out=st.fwords, ctl=ctl)
            return
        new = R.apply_relay_candidates(st, self._cand_unpacked(st.fwords, ctl), ctl)
        for dst, src in zip(st[:3], new[:3]):
            dst.copy_(src)
        C.raise_flag(ctl, new.changed)

    # -- the sparse body and the schedule (sparse_hybrid) ---------------------

    def _sparse_tensors_for(self, packed: bool) -> S.SparseAdjacency:
        """The sparse body's operands for a carry flavor: the third array is
        the original ids (keys) on the MXU arm, ranks for the packed gather
        carry and L1 slots for the unpacked one (the re-run past the packed
        cap), each built on the host and shipped at its first use; the CSR
        and the out-degrees are shipped once and shared."""
        if not self.sparse_hybrid:
            raise ValueError("the sparse superstep needs an engine built with sparse_hybrid=True")
        flavor = "keys" if self.expansion == "mxu" else ("ranks" if packed else "slots")
        adj = self._sparse.get(flavor)
        if adj is None:
            rg, dev = self.relay_graph, self.device
            shared = next(iter(self._sparse.values()), None)
            if shared is None:
                indptr = torch.from_numpy(np.ascontiguousarray(rg.adj_indptr, np.int32)).to(dev)
                dst = torch.from_numpy(np.ascontiguousarray(rg.adj_dst, np.int32)).to(dev)
            else:
                indptr, dst = shared.indptr, shared.dst
            third = S.sparse_third(rg, packed, self.expansion == "mxu")
            adj = S.SparseAdjacency(indptr, dst, torch.from_numpy(third).to(dev), self.outdeg)
            self._sparse[flavor] = adj
        return adj

    def _hybrid(self) -> bool:
        """Does a search run the hybrid schedule (the switch loop)?"""
        return self.sparse_hybrid and self.direction.mode != "pull"

    def _first_body(self, dstate: torch.Tensor, fwords: torch.Tensor,
                    adj: S.SparseAdjacency) -> torch.Tensor:
        """The first superstep's body from the initial frontier, a device
        bool (True: dense); in ``auto`` the decision state is started: the
        unexplored mass is every out-edge (an exact int64 sum, then float32)
        and the occupancy test counts the real vertices, not ``vr``."""
        from . import direction as D

        vr, n_adj = self.relay_graph.vr, adj.dst.shape[0]
        if self.direction.mode == "push":
            return ~S.take_sparse(fwords, adj.outdeg, vr, n_adj)
        fsize, fedges = D.frontier_masses_words(fwords, adj.outdeg, vr)
        mu0 = adj.outdeg.sum(dtype=torch.int64).to(torch.float32)
        use = D.init_decision(dstate, fsize, fedges, mu0, self.relay_graph.num_vertices,
                              self.direction)
        return use | ~S.within_budgets(fsize, fedges, vr, n_adj)

    def _next_body(self, mode: str, dstate: torch.Tensor, prev, fwords: torch.Tensor,
                   adj: S.SparseAdjacency, ctl: torch.Tensor | None = None):
        """The next superstep's body from the frontier the last one made: in
        ``push`` not :func:`~bfs_tpu_torch.ops.sparse.take_sparse`; in
        ``auto`` the Beamer rule after body ``prev`` (the decision state
        updated) or'd with "over the budgets".  Returned as a device bool
        (True: dense); with a control block ``ctl`` (``prev`` is then its
        USE_PULL word) written into USE_PULL instead, and a superstep that is
        not LIVE writes nothing."""
        from . import direction as D

        vr, n_adj = self.relay_graph.vr, adj.dst.shape[0]
        if mode == "push":
            use = ~S.take_sparse(fwords, adj.outdeg, vr, n_adj)
            if ctl is None:
                return use
            ctl[C.USE_PULL] = torch.where(ctl[C.LIVE] != 0, use.to(torch.int32), ctl[C.USE_PULL])
            return None
        fsize, fedges = D.frontier_masses_words(fwords, adj.outdeg, vr)
        over = ~S.within_budgets(fsize, fedges, vr, n_adj)
        if ctl is not None:
            D.decide_gated(dstate, ctl, fsize, fedges, force_pull=over)
            return None
        use, dstate[D.MU], dstate[D.FE] = D.decide(dstate, prev, fsize, fedges)
        return use | over

    def _switch_loop(self, packed: bool) -> L.SwitchLoop:
        """The hybrid loop of the current mode and a carry kind: carry
        ``(packed | dist, parent, fwords, occupancy, directions, decision
        state, ctl)``, the state arrays views of arrays with one scratch slot
        (the sparse body's dropped writes); one step per body (0 the gated
        sparse superstep, 1 the gated dense one), each followed by the
        occupancy and direction of the level it settles, the next body
        written into USE_PULL, then the control step."""
        from . import direction as D

        mode = self.direction.mode
        key = ("switch", mode, packed)
        if key in self._loops:
            return self._loops[key]
        vr = self.relay_graph.vr
        adj = self._sparse_tensors_for(packed)
        ext = tuple(self._empty(vr + 1) for _ in range(1 if packed else 2))
        fields = tuple(t[:vr] for t in ext)
        fwords, ctl = self._empty(vr // 32), C.new_ctl(self.device)
        occ, dirs = T.init_level_acc(device=self.device), T.init_dir_acc(device=self.device)
        dstate = torch.zeros(D.DECIDE_WORDS, dtype=torch.float32, device=self.device)
        state = (R.PackedRelayState if packed else R.RelayState)(*fields, fwords, None, None)

        def make_step(body: int):
            code = (T.DIR_PUSH, T.DIR_PULL)[body]

            # bfs_tpu_torch: hot captured
            def step():
                if body:
                    self._gated_dense(state, ctl)
                else:
                    new = S.sparse_superstep(state, adj, vr, ctl=ctl, ext=ext)
                    fwords.copy_(new.fwords)
                    C.raise_flag(ctl, new.changed)
                level, live = ctl[C.LEVEL] + 1, ctl[C.LIVE] != 0
                T.record_frontier_words(occ, fwords, level, live)
                T.record_direction(dirs, level, code, live)
                self._next_body(mode, dstate, ctl[C.USE_PULL], fwords, adj, ctl)
                K.loop_control(ctl)

            return step

        loop = L.SwitchLoop((*fields, fwords, occ, dirs, dstate, ctl),
                            {0: make_step(0), 1: make_step(1)})
        self._loops[key] = loop
        return loop

    def _start_switch(self, carry: tuple, init, cap: int, adj: S.SparseAdjacency) -> bool:
        """Start a hybrid run in a carry of :meth:`_switch_loop`'s layout:
        the state, control block and accumulators from ``init``, the first
        body in USE_PULL; returns LIVE."""
        *fields, fwords, occ, dirs, dstate, ctl = carry
        live = L.start((*fields, fwords, ctl), init, cap)
        occ.copy_(T.init_level_acc(device=self.device))
        dirs.zero_()
        ctl[C.USE_PULL] = self._first_body(dstate, fwords, adj).to(torch.int32)
        return live

    def _run_switch(self, init, cap: int, times: list | None):
        """A hybrid run from ``init``: on the switch loop (every superstep one
        replay of its body's graph on a card) or its plain version, the eager
        loop (a host read of ``changed`` and the next body per superstep, and
        one of the first body).  Returns the state's words, the stats and the
        accumulators ``(occupancy, directions)``."""
        packed = isinstance(init, R.PackedRelayState)
        words = 1 if packed else 2
        adj = self._sparse_tensors_for(packed)
        if self.loop != "eager":
            loop = self._switch_loop(packed)
            stats, issued = loop.run(self._start_switch(loop.buffers, init, cap, adj), times)
            for body, n in issued.items():
                self._issued[body] += n
            return loop.buffers[:words], stats, loop.buffers[words + 1 : words + 3]
        from . import direction as D

        mode, vr = self.direction.mode, self.relay_graph.vr
        occ, dirs = T.init_level_acc(device=self.device), T.init_dir_acc(device=self.device)
        dstate = torch.zeros(D.DECIDE_WORDS, dtype=torch.float32, device=self.device)
        use_pull = bool(self._first_body(dstate, init.fwords, adj))
        dense = self.superstep_packed if packed else self.superstep

        def step(st):
            nonlocal use_pull
            body = int(use_pull)
            st = dense(st) if body else S.sparse_superstep(st, adj, vr)
            T.record_frontier_words(occ, st.fwords, st.level)
            T.record_direction(dirs, st.level, (T.DIR_PUSH, T.DIR_PULL)[body])
            self._issued[body] += 1
            use = self._next_body(mode, dstate, use_pull, st.fwords, adj)
            both = torch.cat([st.changed.reshape(1).to(torch.int32), use.reshape(1).to(torch.int32)])
            changed, use_pull = (bool(x) for x in both.tolist())  # the level's one host read
            return st._replace(changed=changed)

        st, stats = L.eager(init, step, cap)
        stats.host_reads += 1  # the first body
        return tuple(st[:words]), stats, (occ, dirs)

    def _issued_counts(self) -> dict:
        return {"issued_push": self._issued[0], "issued_pull": self._issued[1]}

    # -- stepped execution (SuperstepRunner, the bench profile) ----------------

    def init_state(self, source: int) -> R.RelayState:
        """The unpacked carry of a search from ``source`` (an original id)
        at iteration 0, in the relabeled space."""
        rg = self.relay_graph
        check_sources(rg.num_vertices, source)
        return R.init_relay_state(rg.vr, int(rg.old2new[source]), self.device)

    def init_packed_state(self, source: int) -> R.PackedRelayState:
        """The packed carry of a search from ``source`` at iteration 0: what
        the level loop carries, for stepping its bodies."""
        rg = self.relay_graph
        check_sources(rg.num_vertices, source)
        return R.init_packed_relay_state(rg.vr, int(rg.old2new[source]), self.device)

    def init_hot_state(self, source: int):
        """The carry the engine's fused loop holds for a search from
        ``source``: packed when :attr:`packed`, else unpacked (the bench
        times the hot loop apart from it)."""
        if self.packed:
            return self.init_packed_state(source)
        return self.init_state(source)

    def step(self, st: R.RelayState) -> R.RelayState:
        """One eager superstep of the unpacked carry, equal to
        :meth:`superstep`.  While ``level + 1`` fits the packed level field,
        the merge is the packed update (kernel ``packed_update`` on the
        card) on words built from the carry: a reached vertex's word holds
        its distance, below every candidate's level, and an unreached one
        the sentinel; a vertex whose word leaves the sentinel takes its new
        level and its candidate's parent."""
        if not self.packed or st.level + 1 > PACKED_MAX_LEVELS:
            return self.superstep(st)
        rg = self.relay_graph
        unreached = st.dist == INT32_MAX
        words = torch.where(unreached, -1, level_bits(st.dist))
        new = K.apply_relay_candidates_packed(
            R.PackedRelayState(words, st.fwords, st.level, None), self._cand_packed(st.fwords))
        if self.expansion == "mxu":
            dist, parent = packed_dist(new.packed), packed_parent(new.packed)
        else:
            dist, parent = R.unpack_relay_packed(new.packed, rg.in_classes, rg.vr)
        parent = torch.where(unreached & (new.packed != -1), parent, st.parent)
        return R.RelayState(dist, parent, new.fwords, st.level + 1, new.changed)

    def take_sparse(self, state) -> bool:
        """THE sparse-path predicate (:func:`~bfs_tpu_torch.ops.sparse.take_sparse`,
        what the ``push`` schedule decides by) for a state, as a host bool;
        always False without the hybrid."""
        if not self.sparse_hybrid:
            return False
        adj = self._sparse_tensors_for(self.packed)
        return bool(S.take_sparse(state.fwords, adj.outdeg, self.relay_graph.vr, adj.dst.shape[0]))

    def step_dispatch(self, state, take_sparse: bool | None = None):
        """One superstep of a packed or unpacked state on the body the
        ``push`` schedule would take for its frontier: ``(new_state,
        "sparse"|"dense")``.  The decision is :meth:`take_sparse` unless the
        caller passes it (to keep its host read out of a timed window).  The
        dense body of a packed state updates its words in place on a card."""
        if take_sparse is None:
            take_sparse = self.take_sparse(state)
        elif take_sparse and not self.sparse_hybrid:
            raise ValueError("take_sparse=True on an engine built with sparse_hybrid=False")
        packed = isinstance(state, R.PackedRelayState)
        if take_sparse:
            adj = self._sparse_tensors_for(packed)
            return S.sparse_superstep(state, adj, self.relay_graph.vr), "sparse"
        return (self.superstep_packed if packed else self.superstep)(state), "dense"

    def warm_step_bodies(self, state) -> None:
        """Run each superstep body once on a copy of ``state`` (the plans,
        tables and kernel libraries they build at first use), so that a
        timed :meth:`step_dispatch` pays none of it."""
        for sparse in (False, True)[: 1 + self.sparse_hybrid]:
            copy = state._replace(**{f: getattr(state, f).clone()
                                     for f in state._fields[:-2]})
            self.step_dispatch(copy, take_sparse=sparse)

    def _dense_step_operands(self) -> tuple:
        """The dense superstep's device operands on this engine's arm: the
        two networks' masks and the valid-slot words (gather), or the tile
        operands (MXU)."""
        if self.expansion == "mxu":
            return tuple(self.mxu_operands)
        return self.vperm_masks, self.net_masks, self.valid_words

    def frontier_stats(self, state) -> tuple[int, int]:
        """(frontier vertices, frontier out-edges) of a state, host ints."""
        fsize, fedges = S.frontier_stats(state.fwords, self.outdeg, self.relay_graph.vr)
        return int(fsize), int(fedges)

    # -- the level loop -----------------------------------------------------

    def _empty(self, *shape) -> torch.Tensor:
        return torch.empty(shape, dtype=torch.int32, device=self.device)

    def _telemetry(self, fwords: torch.Tensor, telemetry: bool):
        """``(buffers, record)``: with ``telemetry`` the occupancy and
        direction accumulators and a recorder of the level a superstep
        settles (gated by LIVE, so a dead superstep records nothing; every
        superstep is the dense one, DIR_PULL); else nothing."""
        if not telemetry:
            return (), lambda ctl: None
        occ, dirs = T.init_level_acc(device=self.device), T.init_dir_acc(device=self.device)

        def record(ctl):
            level, live = ctl[C.LEVEL] + 1, ctl[C.LIVE] != 0
            T.record_frontier_words(occ, fwords, level, live)
            T.record_direction(dirs, level, T.DIR_PULL, live)

        return (occ, dirs), record

    def _packed_loop(self, telemetry: bool = False, trees: int | None = None) -> L.BlockLoop:
        """Packed carry ``(packed, fwords, ctl)``: the candidates, then the
        gated ``packed_update`` in place (the next frontier into the
        carry's own words), then the control step.  With ``telemetry`` the
        carry is ``(packed, fwords, occupancy, directions, ctl)`` and the
        recorder runs before the control step.  ``trees`` S: the lock-step
        batch's carry ``(packed[S, vr], fwords[S, vr/32], ctl)``, kept under
        ``("multi_packed", S)``."""
        def make():
            vr = self.relay_graph.vr
            lead = () if trees is None else (trees,)
            packed, fwords = self._empty(*lead, vr), self._empty(*lead, vr // 32)
            ctl = C.new_ctl(self.device)
            state = R.PackedRelayState(packed, fwords, None, None)
            tel, record = self._telemetry(fwords, telemetry)

            # bfs_tpu_torch: hot captured
            def step():
                self._gated_dense(state, ctl)
                record(ctl)
                K.loop_control(ctl)

            return (packed, fwords, *tel, ctl), step

        kind = ("packed", telemetry) if trees is None else ("multi_packed", trees)
        return L.cached(self._loops, kind, make)

    def _unpacked_loop(self, telemetry: bool = False, trees: int | None = None) -> L.BlockLoop:
        """Unpacked carry ``(dist, parent, fwords, ctl)``: the candidates,
        then the gated merge (torch ops) copied into the carry, its flag
        raised, then the control step (telemetry as on the packed carry;
        ``trees`` as there, kept under ``("multi_unpacked", S)``)."""
        def make():
            vr = self.relay_graph.vr
            lead = () if trees is None else (trees,)
            dist, parent = self._empty(*lead, vr), self._empty(*lead, vr)
            fwords = self._empty(*lead, vr // 32)
            ctl = C.new_ctl(self.device)
            state = R.RelayState(dist, parent, fwords, None, None)
            tel, record = self._telemetry(fwords, telemetry)

            # bfs_tpu_torch: hot captured
            def step():
                self._gated_dense(state, ctl)
                record(ctl)
                K.loop_control(ctl)

            return (dist, parent, fwords, *tel, ctl), step

        kind = ("unpacked", telemetry) if trees is None else ("multi_unpacked", trees)
        return L.cached(self._loops, kind, make)

    def run(self, source: int = 0, *, max_levels: int | None = None,
            times: list | None = None) -> BfsResult:
        """One search from ``source``.  ``times`` (a card, the hybrid
        schedule): a list that gets ``(body, device ms)`` per superstep, by
        CUDA events around its replay."""
        if self._stream_effective():
            return self.run_streamed(source, max_levels=max_levels)
        rg = self.relay_graph
        check_sources(rg.num_vertices, source)
        max_levels = int(max_levels) if max_levels is not None else rg.vr
        t0 = time.perf_counter()
        dist, parent_slots, stats, _ = self._search(int(rg.old2new[source]), max_levels,
                                                    times=times)
        t1 = time.perf_counter()
        result = self._to_result(dist, parent_slots, stats.level, source)
        self.last_run = {"loop_s": t1 - t0, "result_s": time.perf_counter() - t1,
                         **vars(stats), **self._issued_counts()}
        return result

    def _search(self, source_new: int, max_levels: int, telemetry: bool = False,
                times: list | None = None):
        """(dist, parent, :class:`~bfs_tpu_torch.models.loop.LoopStats`,
        telemetry) in the relabeled space; parents are L1 slots on the
        gather arm and original ids on the MXU arm.  On a level loop the
        tensors are the loop's buffers (or decoded from them): the caller
        reads them before the next search.  The last element is
        ``(occupancy, directions, packed_run)``, the accumulators of the run
        that produced the state, with ``telemetry`` or on the hybrid
        schedule; else None."""
        rg = self.relay_graph
        hybrid = self._hybrid()
        self._issued = {0: 0, 1: 0}
        stats = L.LoopStats()
        if self.packed:
            cap = packed_cap(max_levels)
            init = R.init_packed_relay_state(rg.vr, source_new, self.device)
            (packed,), stats, tel = self._run_loop(init, cap, telemetry, hybrid, times)
            if not packed_truncated(stats.changed, stats.level, max_levels):
                tel = tel and (*tel, True)
                if self.expansion == "mxu":
                    return packed_dist(packed), packed_parent(packed), stats, tel
                dist, parent = R.unpack_relay_packed(packed, rg.in_classes, rg.vr)
                return dist, parent, stats, tel
        # Deeper than the packed level field (or a rank too wide for it):
        # the unpacked carry has no level cap.
        init = R.init_relay_state(rg.vr, source_new, self.device)
        (dist, parent), more, tel = self._run_loop(init, max_levels, telemetry, hybrid, times)
        return dist, parent, stats.add(more), tel and (*tel, False)

    def _run_loop(self, init, cap: int, telemetry: bool, hybrid: bool, times: list | None):
        """One run of a carry from ``init`` to ``cap`` levels: the hybrid
        schedule (:meth:`_run_switch`), or the dense superstep on the eager
        loop (the telemetry recorded after each superstep) or on the block
        loop.  Returns the state's words (``(packed,)`` or ``(dist,
        parent)``), the stats, and the accumulators ``(occupancy,
        directions)`` (or None: a dense run without ``telemetry``); the
        supersteps issued are added by body to ``_issued``."""
        if hybrid:
            return self._run_switch(init, cap, times)
        packed = isinstance(init, R.PackedRelayState)
        words = 1 if packed else 2
        superstep, make_loop = ((self.superstep_packed, self._packed_loop) if packed
                                else (self.superstep, self._unpacked_loop))
        tel = (T.init_level_acc(device=self.device), T.init_dir_acc(device=self.device)) \
            if telemetry else None
        if self.loop == "eager":
            def step(st):
                st = superstep(st)
                if tel:
                    T.record_frontier_words(tel[0], st.fwords, st.level)
                    T.record_direction(tel[1], st.level, T.DIR_PULL)
                return st

            st, stats = L.eager(init, step, cap)
            self._issued[1] += stats.issued
            return tuple(st[:words]), stats, tel
        loop = make_loop(telemetry)
        carry = loop.buffers[: words + 1] + (loop.ctl,)
        if tel:
            for dst, src in zip(loop.buffers[words + 1 : -1], tel):
                dst.copy_(src)
            tel = loop.buffers[words + 1 : -1]
        stats = loop.run(L.start(carry, init, cap))
        self._issued[1] += stats.issued
        return loop.buffers[:words], stats, tel

    # -- segmented runs (superstep checkpoints) ---------------------------------

    def _auto(self) -> bool:
        """Does the carry hold the ``auto`` schedule's decision state?"""
        return self.sparse_hybrid and self.direction.mode == "auto"

    def segment_keys(self, packed: bool, telemetry: bool) -> list[str]:
        """The epoch keys of a segmented run's carry for one flavor: the
        reference's (``pk`` or ``dist``/``parent``, ``fw``, ``level``,
        ``changed``, and ``occ``/``dirs`` with telemetry) and, on the
        ``auto`` schedule, the port's own decision words: ``dstate`` (the
        decision state, float32) and ``use_pull`` (the next superstep's
        body), where the reference keeps ``mu`` and ``prev`` and decides at
        the start of a superstep.  An epoch of the reference's (``mu`` and
        ``prev`` in place of the two) resumes with one decision taken on
        restore (:meth:`segment_carry`)."""
        keys = (["pk"] if packed else ["dist", "parent"]) + ["fw", "level", "changed"]
        if self._auto():
            keys += ["dstate", "use_pull"]
        if telemetry:
            keys += ["occ", "dirs"]
        return keys

    def _segment_loop(self, packed: bool, telemetry: bool):
        """``(loop, views)``: the level loop a segmented run of this flavor
        drives, the fused run's own (the switch loop on the hybrid schedule,
        else the dense block loop), and its carry's tensors by epoch key,
        views of the loop's buffers (the control block holds ``level``,
        ``changed`` and the next body)."""
        words = 1 if packed else 2
        if self._hybrid():
            loop = self._switch_loop(packed)
            fields, fw = loop.buffers[:words], loop.buffers[words]
            occ, dirs, dstate = loop.buffers[words + 1 : words + 4]
            tel = (occ, dirs)
        else:
            loop = (self._packed_loop if packed else self._unpacked_loop)(telemetry)
            fields, fw = loop.buffers[:words], loop.buffers[words]
            tel, dstate = loop.buffers[words + 1 : -1], None
        views = dict(zip(["pk"] if packed else ["dist", "parent"], fields), fw=fw)
        if tel:
            views.update(occ=tel[0], dirs=tel[1])
        if dstate is not None and self._auto():
            views["dstate"] = dstate
        return loop, views

    def segment_carry(self, source: int, *, packed: bool | None = None, telemetry: bool = False,
                      restore: dict | None = None) -> dict:
        """Start a segmented run in its loop's carry, paused before its first
        segment: a fresh search from ``source``, or the carry of an epoch
        (``restore``: host arrays by key; other keys are ignored) copied in.
        Returns the carry's tensors by epoch key (:meth:`_segment_loop`) with
        ``level`` and ``changed`` as host values.

        A fresh hybrid run takes its first body as the fused run does (in
        ``auto`` the decision state is started from every out-edge); a
        restored one takes the body the epoch names, never a first body: in
        ``push`` the frontier's own test, in ``auto`` the epoch's ``dstate``
        and ``use_pull``, or, from the reference's ``mu`` and ``prev``, the
        decision the reference takes at the start of its next superstep."""
        from ..resilience.superstep_ckpt import epoch_tensor

        if packed is None:
            packed = self.packed
        rg, dev = self.relay_graph, self.device
        loop, views = self._segment_loop(packed, telemetry)
        hybrid = self._hybrid()
        adj = self._sparse_tensors_for(packed) if hybrid else None
        if "occ" in views:  # empty accumulators unless the epoch carries them
            views["occ"].copy_(T.init_level_acc(device=dev))
            views["dirs"].zero_()
        if restore is None:
            check_sources(rg.num_vertices, source)
            sn = int(rg.old2new[source])
            init = (R.init_packed_relay_state if packed else R.init_relay_state)(rg.vr, sn, dev)
            if hybrid:
                self._start_switch(loop.buffers, init, 0, adj)
            else:
                L.start((*loop.buffers[: 2 if packed else 3], loop.ctl), init, 0)
            return {**views, "level": 0, "changed": True}
        for key, t in views.items():
            if key in restore:
                t.copy_(epoch_tensor(restore[key], dev, t.dtype))
        level, changed = int(restore["level"]), bool(restore["changed"])
        use_pull = 0
        if hybrid:
            use_pull = self._restored_body(restore, views, adj)
        C.resume_ctl(loop.ctl, level, changed, level, use_pull)
        return {**views, "level": level, "changed": changed}

    def _restored_body(self, restore: dict, views: dict, adj: S.SparseAdjacency):
        """The next body of a restored hybrid carry (an int or a device
        int32 scalar), :meth:`segment_carry`'s rule."""
        from . import direction as D

        if self.direction.mode == "push":
            return self._next_body("push", None, None, views["fw"], adj).to(torch.int32)
        if "dstate" in restore:
            return int(np.asarray(restore["use_pull"]))
        dstate, cfg = views["dstate"], self.direction
        dstate.zero_()
        dstate[D.ALPHA], dstate[D.BETA] = cfg.alpha, cfg.beta
        dstate[D.NTHRESH] = self.relay_graph.num_vertices
        dstate[D.MU] = float(np.asarray(restore["mu"]))
        prev = bool(np.asarray(restore["prev"]))
        return self._next_body("auto", dstate, prev, views["fw"], adj).to(torch.int32)

    def _segment_snapshot(self, views: dict, ctl: torch.Tensor, keys: list, level: int,
                          changed: bool, packed: bool) -> dict:
        """The carry as an epoch's host arrays (one copy to the host)."""
        from ..resilience.superstep_ckpt import epoch_arrays

        tensors = {k: views[k] for k in keys if k in views}
        if "use_pull" in keys:
            tensors["ctl"] = ctl
        snap = epoch_arrays(tensors, level=np.int32(level), changed=np.bool_(changed),
                            packed_flag=np.int32(packed))
        if "ctl" in snap:
            snap["use_pull"] = np.int32(snap.pop("ctl")[C.USE_PULL])
        return snap

    def _run_segmented_flavor(self, source: int, ckpt, max_levels: int, packed: bool,
                              telemetry: bool):
        """One carry flavor through bounded segments, an epoch after each:
        ``(views, LoopStats, copy seconds)``, the carry's tensors at the end
        and the host seconds of its copies to the host."""
        from ..resilience.superstep_ckpt import restore_arrays

        cap = packed_cap(max_levels) if packed else max_levels
        keys = self.segment_keys(packed, telemetry)
        decision = ("dstate", "use_pull")
        arrays, _ = restore_arrays(
            ckpt, packed, require=tuple(k for k in keys if k not in decision),
            require_any=((decision, ("mu", "prev")),) if self._auto() else ())
        carry = self.segment_carry(source, packed=packed, telemetry=telemetry, restore=arrays)
        loop, views = self._segment_loop(packed, telemetry)
        level, changed = carry["level"], carry["changed"]
        stats = L.LoopStats(level, changed)
        copy_s = 0.0
        while changed and level < cap:
            t0 = time.perf_counter()
            seg = loop.segment(min(level + ckpt.interval(), cap), level, changed)
            if isinstance(seg, tuple):  # the switch loop: supersteps by body
                seg, issued = seg
                for body, n in issued.items():
                    self._issued[body] += n
            else:
                self._issued[1] += seg.issued
            seg_s = time.perf_counter() - t0
            stats = stats.add(seg)
            # A disabled store marks the boundary without the copy to the host.
            snap = {}
            if ckpt.enabled:
                t1 = time.perf_counter()
                snap = self._segment_snapshot(views, loop.ctl, keys, seg.level, seg.changed, packed)
                copy_s += time.perf_counter() - t1
            ckpt.save_epoch(seg.level, snap)
            ckpt.note_segment(seg.level - level, seg_s)
            level, changed = seg.level, seg.changed
        return views, stats, copy_s

    def run_segmented(self, source: int = 0, *, ckpt, max_levels: int | None = None,
                      telemetry: bool = False):
        """One search from ``source`` in bounded segments with an epoch in
        ``ckpt`` (a :class:`~bfs_tpu_torch.resilience.superstep_ckpt.SuperstepCheckpointer`)
        after each, resuming from its newest valid epoch: the resumable twin
        of :meth:`run` (and, with ``telemetry``, of :meth:`run_level_curve`),
        bit for bit with it for any segmentation.  Returns a
        :class:`BfsResult`, or ``(BfsResult, curve)`` with ``telemetry``.
        Every segment runs on the fused run's own level loop (captured
        once; ``loop = "eager"`` is not consulted).  A packed run stopped by
        its 62-level cap clears the store and runs again unpacked; the
        epochs are cleared when the run completes.  :attr:`last_run` holds
        the loop's counts over every segment this process ran, and
        ``copy_s``, the host seconds of the carry's copies to the host (the
        epochs' writes are the checkpointer's ``snapshot_seconds``).  A
        streamed engine runs :meth:`run_streamed` on the same epochs."""
        if self._stream_effective():
            return self.run_streamed(source, ckpt=ckpt, max_levels=max_levels,
                                     telemetry=telemetry)
        rg = self.relay_graph
        check_sources(rg.num_vertices, source)
        max_levels = int(max_levels) if max_levels is not None else rg.vr
        self._issued = {0: 0, 1: 0}
        packed = self.packed
        t0 = time.perf_counter()
        views, stats, copy_s = self._run_segmented_flavor(source, ckpt, max_levels, packed,
                                                          telemetry)
        if packed and packed_truncated(stats.changed, stats.level, max_levels):
            ckpt.clear()  # packed epochs cannot feed the unpacked re-run
            packed = False
            views, more, more_s = self._run_segmented_flavor(source, ckpt, max_levels, False,
                                                             telemetry)
            stats, copy_s = stats.add(more), copy_s + more_s
        ckpt.clear()
        # The one unpack, at the true end: every epoch keeps the raw carry.
        if not packed:
            dist, parent = views["dist"], views["parent"]
        elif self.expansion == "mxu":
            dist, parent = packed_dist(views["pk"]), packed_parent(views["pk"])
        else:
            dist, parent = R.unpack_relay_packed(views["pk"], rg.in_classes, rg.vr)
        curve = None
        if telemetry:
            fe = T.edge_curve_from_levels(dist, self.outdeg, dist == INT32_MAX)
            fv, fe, dirs = T.read_telemetry(views["occ"], fe, views["dirs"])
            cap = min(PACKED_MAX_LEVELS, max_levels) if packed else max_levels
            curve = T.level_curve(fv, fe, cap=cap)
            cfg = self.direction
            curve["direction_schedule"] = T.direction_schedule(
                dirs, mode=cfg.mode, alpha=cfg.alpha, beta=cfg.beta)
        t1 = time.perf_counter()
        result = self._to_result(dist, parent, stats.level, source)
        self.last_run = {"loop_s": t1 - t0, "result_s": time.perf_counter() - t1,
                         "copy_s": copy_s, **vars(stats), **self._issued_counts()}
        return (result, curve) if telemetry else result

    def run_level_curve(self, source: int = 0, *, max_levels: int | None = None,
                        reference_reached: int | None = None) -> dict:
        """One search with the telemetry accumulators in the level loop's
        carry (the recorder beside the kernels of each superstep): the
        JSON-ready level curve, per-level frontier occupancy and out-edges
        (derived from the final levels at exit), packed-cap proximity, and
        the direction schedule (``push`` for the sparse body, ``pull`` for
        the dense one).  One host read of the accumulators at exit; the
        state stays on the device.  Deeper than the packed cap, the curve
        and schedule come from the unpacked re-run."""
        rg = self.relay_graph
        check_sources(rg.num_vertices, source)
        max_levels = int(max_levels) if max_levels is not None else rg.vr
        dist, _, stats, (occ, dirs, packed_run) = self._search(
            int(rg.old2new[source]), max_levels, telemetry=True)
        fe = T.edge_curve_from_levels(dist, self.outdeg, dist == INT32_MAX)
        fv, fe, dirs = T.read_telemetry(occ, fe, dirs)
        self.last_run = {**vars(stats), **self._issued_counts()}
        cap = min(PACKED_MAX_LEVELS, max_levels) if packed_run else max_levels
        curve = T.level_curve(fv, fe, cap=cap, reference_reached=reference_reached)
        cfg = self.direction
        curve["direction_schedule"] = T.direction_schedule(
            dirs, mode=cfg.mode, alpha=cfg.alpha, beta=cfg.beta)
        return curve

    def run_many_device(self, sources, *, max_levels: int | None = None) -> list:
        """One search per source on the level loop, chained without a host
        read between them: each round issues, for every source still live,
        one block (dense) or one superstep of the body its own control block
        names (the hybrid schedule), its carry copied into the loop's buffers
        and back on the device, then reads all their control blocks at once.
        Returns the device states, :class:`~bfs_tpu_torch.ops.relay.RelayState`
        in the relabeled space (``parent`` L1 slots, or original ids on the
        MXU arm; ``level`` a host int, ``changed`` a host bool), as the
        reference's ``run_many_device`` returns its finished states; map one
        with :meth:`to_original_device`.

        Runs the packed carry when the engine is packed: a search deeper
        than the packed carry's 62 levels comes back with ``changed`` still
        set (no per-root fallback; :meth:`run` is the single-root path that
        re-runs it).  :attr:`last_run` holds the rounds' counts."""
        rg = self.relay_graph
        sources = np.atleast_1d(np.asarray(sources, dtype=np.int32))
        check_sources(rg.num_vertices, sources)
        max_levels = int(max_levels) if max_levels is not None else rg.vr
        packed, hybrid = self.packed, self._hybrid()
        words = 1 if packed else 2
        cap = packed_cap(max_levels) if packed else max_levels
        init = R.init_packed_relay_state if packed else R.init_relay_state
        stats = L.LoopStats()
        self._issued = {0: 0, 1: 0}
        if hybrid:
            loop, adj = self._switch_loop(packed), self._sparse_tensors_for(packed)

            def start(carry, st):
                self._start_switch(carry, st, cap, adj)

            def issue(ctl_words):
                body = ctl_words[C.USE_PULL]
                loop.issue(body, stats)
                self._issued[body] += 1
        else:
            loop = self._packed_loop() if packed else self._unpacked_loop()

            def start(carry, st):
                L.start(carry, st, cap)

            def issue(ctl_words):
                loop.issue(stats)
                self._issued[1] += loop.k
        carries = []
        for s in sources.tolist():
            carry = tuple(torch.empty_like(b) for b in loop.buffers)
            start(carry, init(rg.vr, int(rg.old2new[s]), self.device))
            carries.append(carry)
        live = list(range(len(carries))) if cap > 0 else []
        # The control words as started (LEVEL 0, CHANGED 1), until read; the
        # hybrid's first bodies are read before the first round.
        ctls = [[int(w == C.CHANGED) for w in range(C.WORDS)] for _ in carries]
        if hybrid and live:
            ctls = L.read_ctls([carry[-1] for carry in carries], stats)
        while live:
            for i in live:
                loop.load(carries[i])
                issue(ctls[i])
                loop.store(carries[i])
            for i, ctl_words in zip(live, L.read_ctls([carries[i][-1] for i in live], stats)):
                ctls[i] = ctl_words
            live = [i for i in live if ctls[i][C.LIVE]]
        self.last_run = {**vars(stats), **self._issued_counts()}
        states = []
        for carry, ctl_words in zip(carries, ctls):
            level, changed = ctl_words[C.LEVEL], bool(ctl_words[C.CHANGED])
            if not packed:
                dist, parent = carry[0], carry[1]
            elif self.expansion == "mxu":
                dist, parent = packed_dist(carry[0]), packed_parent(carry[0])
            else:
                dist, parent = R.unpack_relay_packed(carry[0], rg.in_classes, rg.vr)
            states.append(R.RelayState(dist, parent, carry[words], level, changed))
        return states

    # -- results in original ids ----------------------------------------------

    def _map_original_device(self, dist_new, parent, source: int, flavor: str | None = None):
        """Relabeled-space device ``(dist, parent)`` -> ORIGINAL id space, on
        the device: parents that are L1 slots become their source ids
        (``flavor`` ``gather``; MXU-arm parents are original ids already),
        both are gathered through ``old2new``, and the source's entry is set
        to itself.  ``flavor`` overrides the engine's arm for callers whose
        parents are always slots (the elem trees)."""
        flavor = self.expansion if flavor is None else flavor
        par = parent if flavor == "mxu" else slots_to_parent(parent, self.src_l1)
        dist_o, par_o = dist_new[self.old2new], par[self.old2new]
        par_o[int(source)].fill_(int(source))  # the source's slot entry is not a parent
        return dist_o, par_o

    def to_original_device(self, state, source: int):
        """Device-resident ``(dist, parent)`` int32[V] in ORIGINAL ids for a
        state of :meth:`run_many_device`, with no host transfer: the device
        twin of the mapping in :meth:`run`."""
        return self._map_original_device(state.dist, state.parent, source)

    def _rank_tables_device(self):
        """The rank -> L1 slot tables ``(base, stride)`` on the device, for
        the elem trees' extraction (shipped once, at first use)."""
        if self._rank_tables is None:
            self._rank_tables = RE.rank_tables(self.relay_graph, self.device)
        return self._rank_tables

    def multi_tree_to_original_device(self, state, i: int, source: int):
        """Device-resident ``(dist, parent)`` in ORIGINAL ids for tree ``i``
        of a batched state: the bit-sliced
        :class:`~bfs_tpu_torch.ops.relay_elem.ElemState`, or a state whose
        ``dist``/``parent`` have a leading source axis."""
        if not isinstance(state, RE.ElemState):
            return self._map_original_device(state.dist[i], state.parent[i], source)
        dist, parent = RE.decode_trees(
            state, self.relay_graph, i // 32, i % 32, i % 32 + 1, self._rank_tables_device()
        )
        # Elem parents are always slots, whatever the engine's arm.
        return self._map_original_device(dist[0], parent[0], source, flavor="gather")

    def _to_result(self, dist, parent_slots, level: int, source: int) -> BfsResult:
        """Relabeled state -> original ids on the device, then the host
        through pinned memory (:func:`to_host`)."""
        dist, parent = to_host(*self._map_original_device(dist, parent_slots, source))
        return BfsResult(dist=dist, parent=parent, num_levels=int(level))

    # -- batched multi-source -------------------------------------------------

    def routed_elem(self, frontier: torch.Tensor, benes=K.apply_benes_elem) -> torch.Tensor:
        """Frontier elements int32[G, vr] -> routed L1 slot elements
        int32[G, net_size]: zero-padded to ``vperm_size`` (dummy
        out-positions read the zero tail), the vperm network,
        ``broadcast_l2_elem``, the net network.  ``benes`` runs a network:
        the K5 kernels on a card (the plain version on the CPU), or
        :func:`~bfs_tpu_torch.ops.relay_elem.apply_benes_elem` itself."""
        rg = self.relay_graph
        fw = torch.zeros((frontier.shape[0], rg.vperm_size), dtype=torch.int32, device=self.device)
        fw[:, : rg.vr] = frontier
        y = benes(fw, self.vperm_masks, rg.vperm_table, rg.vperm_size)
        l2 = RE.broadcast_l2_elem(y, rg.out_classes, rg.net_size)
        return benes(l2, self.net_masks, rg.net_table, rg.net_size)

    def route_index(self) -> torch.Tensor:
        """:meth:`routed_elem` as one gather index, int32[net_size]
        (:func:`~bfs_tpu_torch.ops.relay_elem.route_index`), built by the
        K5 kernels at the first call and kept: 4 bytes per slot (268 MB at
        scale 22), which an engine that runs no batch never pays."""
        if self._route_index is None:
            rg = self.relay_graph
            self._route_index = RE.route_index(self.routed_elem, rg.vr, self.device)
        return self._route_index

    def superstep_elem(self, st: RE.ElemState, frontier_out=None, ctl=None) -> RE.ElemState:
        """One element-major superstep for all 32·G trees: the route as one
        gather over :meth:`route_index`, then the fused row-min/update
        (gated by ``ctl`` in the block loop)."""
        rg = self.relay_graph
        l1 = K.elem_route_gather(st.frontier, self.route_index(), ctl=ctl)
        return K.elem_rowmin_update(
            l1, self.valid_words, st, rg.in_classes, rg.vr, frontier_out=frontier_out, ctl=ctl
        )

    def _elem_loop(self, groups: int) -> L.BlockLoop:
        """Elem carry ``(visited, frontier, dist_planes, rank_planes, ctl)``
        for ``groups`` groups (one loop per group count): the gated
        superstep, the next frontier written into the carry's own buffer,
        then the control step."""
        def make():
            rg = self.relay_graph
            _, pt = RE.rank_plane_layout(rg.in_classes)
            carry = (self._empty(groups, rg.vr), self._empty(groups, rg.vr),
                     self._empty(RE.DIST_PLANES, groups, rg.vr), self._empty(groups, pt))
            ctl = C.new_ctl(self.device)
            state = RE.ElemState(*carry, None, None)

            # bfs_tpu_torch: hot captured
            def step():
                self.superstep_elem(state, frontier_out=carry[1], ctl=ctl)
                K.loop_control(ctl)

            return (*carry, ctl), step

        return L.cached(self._loops, ("elem", groups), make)

    def _run_elem(self, sources: np.ndarray, max_levels: int | None) -> RE.ElemState:
        rg = self.relay_graph
        if sources.shape[0] % 32 != 0:
            raise ValueError("element-major batching needs a multiple of 32 sources")
        check_sources(rg.num_vertices, sources)
        if max_levels is None:
            max_levels = RE.MAX_ELEM_LEVELS + 1
        else:
            max_levels = int(max_levels)
            if max_levels > RE.MAX_ELEM_LEVELS:
                raise ValueError(
                    f"element-major mode carries {RE.MAX_ELEM_LEVELS} levels max; "
                    "use run_multi for deeper graphs"
                )
        groups = sources.shape[0] // 32
        sources_new = rg.old2new[sources].reshape(groups, 32)
        _, pt = RE.rank_plane_layout(rg.in_classes)
        if self.loop == "eager":
            st, stats = L.eager(
                RE.init_elem_state(rg.vr, sources_new, pt, self.device), self.superstep_elem,
                max_levels,
            )
        else:
            loop = self._elem_loop(groups)
            RE.init_elem_state(rg.vr, sources_new, pt, self.device, out=loop.buffers[:4])
            stats = loop.run(C.init_ctl(loop.ctl, max_levels))
            st = RE.ElemState(*loop.buffers[:4], stats.level, stats.changed)
        self.last_run = vars(stats)
        return st._replace(level=stats.level, changed=stats.changed)

    def run_multi_elem_device(self, sources, *, max_levels: int | None = None) -> RE.ElemState:
        """Element-major batched BFS; the source count must be a multiple of
        32.  Returns the device :class:`~bfs_tpu_torch.ops.relay_elem.ElemState`
        (``level`` a host int and ``changed`` a host bool, read once from the
        control block at the end).  On the block loop its tensors are the
        engine's loop buffers for that group count: the next batch of as
        many groups overwrites them, so clone what must outlive it.

        The distance planes hold levels up to ``MAX_ELEM_LEVELS`` (31).  The
        default run allows one step past that cap: a step at level 32 that
        changes nothing proves convergence at eccentricity 31 and writes no
        distance; one that changes leaves ``changed`` set, and
        :meth:`run_multi_elem` then discards the state and falls back.
        Callers of this raw path test ``changed`` themselves."""
        return self._run_elem(np.atleast_1d(np.asarray(sources, dtype=np.int32)), max_levels)

    def run_multi_elem(self, sources, *, max_levels: int | None = None) -> MultiBfsResult:
        """Element-major batched BFS with host results in original ids,
        bit-exact with :meth:`run_multi`.  A default run that is still
        changing after the step past the 31-level cap (eccentricity > 31
        from some source) falls back to :meth:`run_multi`, which has no
        depth cap."""
        sources = np.atleast_1d(np.asarray(sources, dtype=np.int32))
        t0 = time.perf_counter()
        st = self._run_elem(sources, max_levels)
        stats = dict(self.last_run)
        t1 = time.perf_counter()
        if max_levels is None and st.changed:
            return self.run_multi(sources)
        dist, parent = RE.extract_results(
            st, self.relay_graph, sources, self.old2new, self.src_l1,
            self._rank_tables_device(),
        )
        self.last_run = {"loop_s": t1 - t0, "result_s": time.perf_counter() - t1, **stats}
        return MultiBfsResult(sources=sources, dist=dist, parent=parent, num_levels=st.level)

    def run_multi_device(self, sources, *, max_levels: int | None = None,
                         packed: bool | None = None) -> R.RelayState:
        """Batched multi-source BFS, all trees lock-step in one level loop
        (the dense superstep over a leading sources axis; one ``LEVEL``,
        ``changed`` any tree's), device-resident: the batched
        :class:`~bfs_tpu_torch.ops.relay.RelayState` in the relabeled space,
        ``dist`` and ``parent`` ``int32[S, vr]`` (``parent`` L1 slots on the
        gather arm, original ids on the MXU arm), ``fwords``
        ``int32[S, vr/32]``, ``level`` a host int and ``changed`` a host
        bool; map tree ``i`` with :meth:`multi_tree_to_original_device`.

        On the packed carry (the default where the layout fits) the loop
        caps at the packed carry's 62 levels: a batch deeper than that comes
        back with ``changed`` set, and :meth:`run_multi` re-runs it
        unpacked.  On the block loop the state's tensors are (or are decoded
        from) the engine's loop buffers for that batch size: the next batch
        of as many trees overwrites them, so clone what must outlive it.
        :attr:`last_run` holds the loop's counts."""
        rg = self.relay_graph
        sources = np.atleast_1d(np.asarray(sources, dtype=np.int32))
        check_sources(rg.num_vertices, sources)
        max_levels = int(max_levels) if max_levels is not None else rg.vr
        packed = self.packed if packed is None else bool(packed)
        cap = packed_cap(max_levels) if packed else max_levels
        init = R.init_relay_batch(rg.vr, rg.old2new[sources], self.device, packed)
        words = 1 if packed else 2
        if self.loop == "eager":
            st, stats = L.eager(init, self.superstep_packed if packed else self.superstep, cap)
        else:
            loop = (self._packed_loop if packed else self._unpacked_loop)(trees=sources.shape[0])
            stats = loop.run(L.start(loop.buffers, init, cap))
            st = type(init)(*loop.buffers[: words + 1], None, None)
        self.last_run = vars(stats)
        if not packed:
            dist, parent = st.dist, st.parent
        elif self.expansion == "mxu":
            dist, parent = packed_dist(st.packed), packed_parent(st.packed)
        else:
            dist, parent = R.unpack_relay_packed(st.packed, rg.in_classes, rg.vr)
        return R.RelayState(dist, parent, st.fwords, stats.level, stats.changed)

    def run_multi(self, sources, *, max_levels: int | None = None) -> MultiBfsResult:
        """Lock-step batched BFS without a depth cap (the reference's
        ``run_multi``): one :meth:`run_multi_device` batch, re-run unpacked
        when the packed carry's cap cut it, then every tree mapped to
        original ids on the device and copied to the host at once.
        ``num_levels`` is the loop's level: the deepest tree's.
        :attr:`last_run` holds ``loop_s``, ``result_s``, the loops' counts
        (both runs' summed) and ``unpacked_rerun``."""
        rg = self.relay_graph
        sources = np.atleast_1d(np.asarray(sources, dtype=np.int32))
        requested = int(max_levels) if max_levels is not None else rg.vr
        t0 = time.perf_counter()
        state = self.run_multi_device(sources, max_levels=max_levels)
        stats = L.LoopStats(**self.last_run)
        rerun = self.packed and packed_truncated(state.changed, state.level, requested)
        if rerun:
            state = self.run_multi_device(sources, max_levels=max_levels, packed=False)
            stats = stats.add(L.LoopStats(**self.last_run))
        t1 = time.perf_counter()
        par = state.parent if self.expansion == "mxu" else slots_to_parent(state.parent,
                                                                            self.src_l1)
        dist, parent = state.dist[:, self.old2new], par[:, self.old2new]
        with explicit_transfer():  # the sources' intended upload
            src = torch.from_numpy(sources.astype(np.int64)).to(self.device)
        # The sources' own entries hold relabeled ids or slots, not parents.
        parent[torch.arange(sources.shape[0], device=self.device), src] = src.to(torch.int32)
        dist, parent = to_host(dist, parent)
        self.last_run = {"loop_s": t1 - t0, "result_s": time.perf_counter() - t1,
                         **vars(stats), "unpacked_rerun": rerun}
        return MultiBfsResult(sources=sources, dist=dist, parent=parent, num_levels=state.level)


def to_host(*tensors: torch.Tensor) -> list[np.ndarray]:
    """Numpy arrays of ``tensors``: on a card each is copied into a pinned
    host tensor (PyTorch's caching host allocator, which reuses the block of
    a result the caller has freed) and the array is a view that keeps it
    alive, one wait for all copies; on the CPU copies (an unpacked run's
    state is the loop's buffers, which the next run overwrites)."""
    if not tensors or tensors[0].device.type != "cuda":
        return [t.numpy().copy() for t in tensors]
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    with explicit_transfer():  # the result's intended copy to the host
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        torch.cuda.current_stream().synchronize()
    return [h.numpy() for h in host]


class EdgeEngine:
    """Device-resident push or pull layout + the level loop
    (``engine='push'|'pull'``).

    ``__init__`` builds the layout unless given one (a
    :class:`~bfs_tpu_torch.graph.csr.DeviceGraph` for push, a
    :class:`~bfs_tpu_torch.graph.ell.PullGraph` or a DeviceGraph for pull)
    and ships it to ``device`` once.  :meth:`run` runs one source,
    :meth:`run_multi` a batch in lock-step; :meth:`fused` is the loop
    itself, the counterpart of the reference's ``_bfs_fused``,
    ``_bfs_pull_fused``, ``_bfs_multi_fused`` and ``_bfs_multi_pull_fused``.
    The packed carry runs when ``packed_parent_fits(V)``; a search that
    stops on its 62-level cap is re-run on the unpacked carry.

    The supersteps are plain torch ops (XLA in the reference, no TPU
    kernel): on a card the level loop captures blocks of
    :data:`~bfs_tpu_torch.models.loop.EDGE_BLOCK` of them, gated by the
    control block, in a CUDA graph, with the control step
    ``loop_control`` ending each; ``loop = "eager"`` is the plain loop.
    """

    def __init__(self, graph, *, engine: str = "pull", device=None, block: int = 1024):
        if engine not in ("push", "pull"):
            raise ValueError(f"unknown engine {engine!r}; use 'push' or 'pull'")
        self.device = resolve_device(device)
        self.engine = engine
        if engine == "pull":
            pg = graph if isinstance(graph, PullGraph) else build_pull_graph(graph)
            self.layout = pg
            self.ell0, self.folds = device_ell(pg, self.device)
        else:
            if isinstance(graph, (PullGraph, RelayGraph)):
                raise ValueError("engine='push' needs a Graph or DeviceGraph")
            dg = graph if isinstance(graph, DeviceGraph) else build_device_graph(graph, block=block)
            self.layout = dg
            self.src = torch.from_numpy(dg.src).to(self.device)
            self.dst = torch.from_numpy(dg.dst).to(self.device, torch.int64)
        self.num_vertices = self.layout.num_vertices
        self.packed = packed_parent_fits(self.num_vertices)
        #: ``blocks`` (captured and replayed on a card) or ``eager``.
        self.loop = "blocks"
        self._loops: dict = {}
        #: Host seconds and loop counts of the last run, as on RelayEngine.
        self.last_run: dict = {}

    def candidates(self, state) -> torch.Tensor:
        """Min active in-neighbour per vertex (INT32_MAX where none),
        ``[..., V+1]``."""
        if self.engine == "pull":
            return pull_candidates(frontier_table(state), self.ell0, self.folds)
        f = state.frontier
        push = _batched_push_candidates if f.dim() == 2 else _push_candidates
        return push(f, self.src, self.dst, f.shape[-1])

    def superstep(self, state, ctl: torch.Tensor | None = None):
        """One superstep of either carry, single or batched (gated by
        ``ctl`` in the block loop)."""
        if isinstance(state, PackedBfsState):
            return apply_candidates_packed(state, self.candidates(state), ctl)
        return apply_candidates(state, self.candidates(state), ctl)

    def carry(self, packed: bool, trees: int | None):
        """Static buffers of one carry kind for a single search (``trees``
        None) or a batch of ``trees``: ``(fields, state)``, the state a view
        of the fields."""
        shape = (self.num_vertices + 1,) if trees is None else (trees, self.num_vertices + 1)

        def buf(dtype):
            return torch.empty(shape, dtype=dtype, device=self.device)

        if packed:
            fields = (buf(torch.int32), buf(torch.bool))
            return fields, PackedBfsState(*fields, None, None)
        fields = (buf(torch.int32), buf(torch.int32), buf(torch.bool))
        return fields, BfsState(*fields, None, None)

    def gated_step(self, state, fields, ctl: torch.Tensor) -> None:
        """One superstep gated by ``ctl`` on a carry's buffers (``state`` a
        view of ``fields``): the new fields copied in, the flag raised."""
        new = self.superstep(state, ctl)
        for dst, src in zip(fields, new):
            dst.copy_(src)
        C.raise_flag(ctl, new.changed)

    def _carry_loop(self, packed: bool, trees: int | None) -> L.BlockLoop:
        """The block loop of one carry kind: the gated superstep, then the
        control step."""

        def make():
            fields, state = self.carry(packed, trees)
            ctl = C.new_ctl(self.device)

            # bfs_tpu_torch: hot captured
            def step():
                self.gated_step(state, fields, ctl)
                K.loop_control(ctl)

            return (*fields, ctl), step

        return L.cached(self._loops, ("packed" if packed else "unpacked", trees), make,
                        k=L.EDGE_BLOCK)

    def _packed_loop(self) -> L.BlockLoop:
        return self._carry_loop(True, None)

    def _drive(self, init, cap: int, trees: int | None):
        """The engine's level loop from the fresh state ``init`` (packed or
        not) for at most ``cap`` levels: ``(state, LoopStats)``, the state
        of ``init``'s kind on the device (on the block loop, the loop's
        buffers)."""
        if self.loop == "eager":
            return L.eager(init, self.superstep, cap)
        loop = self._carry_loop(isinstance(init, PackedBfsState), trees)
        stats = loop.run(L.start(loop.buffers, init, cap))
        return type(init)(*loop.buffers[:-1], None, None), stats

    def segment(self, state, seg_end: int):
        """One bounded segment of a paused run, single or batched:
        ``state`` (packed or not; ``level`` a host int, ``changed`` a host
        bool, as :func:`~bfs_tpu_torch.models.multisource.multi_segment_init`
        makes it) run until it converges or reaches ``seg_end`` levels.
        Returns ``(state, LoopStats)``, the state's ``level`` and
        ``changed`` read at the boundary.  On the block loop the state is
        copied into the loop's buffers unless it is already theirs (the
        state a segment returns), and the control block is resumed at its
        level with CAP at ``seg_end``: the loop's captured graph serves every
        segment.  The returned tensors are the loop's buffers."""
        if self.loop == "eager":
            dev = state.frontier.device
            st = state._replace(level=torch.tensor(state.level, dtype=torch.int32, device=dev),
                                changed=torch.ones((), dtype=torch.bool, device=dev))
            st, stats = L.eager(st, self.superstep, seg_end, level=state.level)
            return st._replace(level=stats.level, changed=stats.changed), stats
        trees = None if state.frontier.dim() == 1 else state.frontier.shape[0]
        loop = self._carry_loop(isinstance(state, PackedBfsState), trees)
        fields = loop.buffers[:-1]
        if any(a is not b for a, b in zip(state, fields)):
            for dst, src in zip(fields, state):
                dst.copy_(src)
        stats = loop.run(C.resume_ctl(loop.ctl, state.level, state.changed, seg_end))
        return type(state)(*fields, stats.level, stats.changed), stats

    def fused(self, sources, max_levels: int, packed: bool, drive=None):
        """The level loop from one source (an int) or a batch (a sequence):
        ``(BfsState, LoopStats)``, the state unpacked, on the device, with
        ``level`` a host int and ``changed`` a host bool.  On the block
        loop an unpacked state's tensors are the loop's buffers: read them
        before the next run.  ``drive(init, cap, trees)`` runs another loop
        over this engine's carry (the direction loop) in place of
        :meth:`_drive`."""
        single = isinstance(sources, (int, np.integer))
        v = self.num_vertices
        if packed:
            init = init_packed_state(v, sources, self.device) if single else \
                init_packed_batched_state(v, sources, self.device)
            cap = packed_cap(max_levels)
        else:
            init = init_state(v, sources, self.device) if single else \
                init_batched_state(v, sources, self.device)
            cap = max_levels
        st, stats = (drive or self._drive)(init, cap, None if single else len(sources))
        if packed:
            st = unpack_bfs_state(st)
        return st._replace(level=stats.level, changed=stats.changed), stats

    def _search(self, sources, max_levels: int, drive=None, packed: bool | None = None):
        """:meth:`fused` on the engine's carry (``packed=False`` forces the
        unpacked one), re-run unpacked past the packed cap: ``(state, stats,
        rerun)``, the stats of both runs summed, ``rerun`` whether the
        packed run was cut by its cap."""
        packed = self.packed if packed is None else packed and self.packed
        st, stats = self.fused(sources, max_levels, packed, drive)
        rerun = packed and packed_truncated(stats.changed, stats.level, max_levels)
        if rerun:
            st, more = self.fused(sources, max_levels, False, drive)
            stats = stats.add(more)
        return st, stats, rerun

    def _host_run(self, sources, max_levels: int | None, drive=None, extra=None,
                  packed: bool | None = None):
        """``(dist, parent, extras, run)`` on the host for one source (an
        int) or a batch (a list): ``extra()`` names device tensors (the
        direction loop's accumulators) copied with the result, in its one
        host read, into ``extras``; ``run`` is the host seconds and loop
        counts (:attr:`last_run`), and ``unpacked_rerun``."""
        v = self.num_vertices
        check_sources(v, sources)
        max_levels = int(max_levels) if max_levels is not None else v
        t0 = time.perf_counter()
        st, stats, rerun = self._search(sources, max_levels, drive, packed)
        t1 = time.perf_counter()
        dist, parent, *extras = to_host(st.dist[..., :v].contiguous(),
                                        st.parent[..., :v].contiguous(),
                                        *(extra() if extra else ()))
        run = {"loop_s": t1 - t0, "result_s": time.perf_counter() - t1, **vars(stats),
               "unpacked_rerun": rerun}
        return dist, parent, extras, run

    def run(self, source: int = 0, *, max_levels: int | None = None) -> BfsResult:
        dist, parent, _, self.last_run = self._host_run(int(source), max_levels)
        return BfsResult(dist, parent, self.last_run["level"])

    def run_multi_device(self, sources, *, max_levels: int | None = None,
                         packed: bool | None = None) -> BfsState:
        """The batched loop's device state ``[S, V+1]`` (unpacked), no host
        transfer beyond the control block; ``packed=None`` takes the
        engine's carry, and a packed run stopped by its cap comes back with
        ``changed`` set (:meth:`run_multi` re-runs it)."""
        sources = np.atleast_1d(np.asarray(sources, dtype=np.int32))
        check_sources(self.num_vertices, sources)
        max_levels = int(max_levels) if max_levels is not None else self.num_vertices
        st, stats = self.fused(sources.tolist(), max_levels, self.packed if packed is None else packed)
        self.last_run = vars(stats)
        return st

    def run_multi(self, sources, *, max_levels: int | None = None,
                  packed: bool | None = None) -> MultiBfsResult:
        """Lock-step batched BFS with host results; every tree equals its
        single-source search.  ``packed=False`` runs the unpacked carry
        from the start (a caller that knows the graph is deeper than the
        packed cap)."""
        sources = np.atleast_1d(np.asarray(sources, dtype=np.int32))
        dist, parent, _, self.last_run = self._host_run(sources.tolist(), max_levels,
                                                        packed=packed)
        return MultiBfsResult(sources, dist, parent, self.last_run["level"])


def bfs(
    graph: Graph | DeviceGraph | PullGraph | RelayGraph,
    source: int = 0,
    *,
    engine: str = "pull",
    device=None,
    max_levels: int | None = None,
    block: int = 1024,
) -> BfsResult:
    """Single-source BFS on the card unless ``device`` names the CPU.

    Engines (same results, bit for bit): ``'pull'`` (default, as in the
    reference), the ELL gather/row-min formulation; ``'push'``, the
    segmented-min formulation; ``'relay'``, the Beneš layout with the
    hand-written kernels, on its hybrid schedule (:class:`RelayEngine`'s
    defaults).  A prebuilt layout skips its build: a
    :class:`PullGraph` runs only on pull, a :class:`RelayGraph` only on
    relay."""
    if engine not in ("pull", "push", "relay"):
        raise ValueError(f"unknown engine {engine!r}; use 'relay', 'pull' or 'push'")
    if isinstance(graph, PullGraph) and engine != "pull":
        raise ValueError("a prebuilt PullGraph only runs on engine='pull'")
    if isinstance(graph, RelayGraph) and engine != "relay":
        raise ValueError("a prebuilt RelayGraph only runs on engine='relay'")
    if engine == "relay":
        return RelayEngine(graph, device=device).run(source, max_levels=max_levels)
    eng = EdgeEngine(graph, engine=engine, device=device, block=block)
    return eng.run(source, max_levels=max_levels)


def bfs_level_curve(
    graph: Graph | DeviceGraph | PullGraph | RelayGraph,
    source: int = 0,
    *,
    engine: str = "pull",
    device=None,
    max_levels: int | None = None,
    block: int = 1024,
    reference_reached: int | None = None,
) -> dict:
    """The level curve (per-level frontier occupancy,
    :mod:`bfs_tpu_torch.obs.telemetry`) of one single-source search: the
    telemetry twin of :func:`bfs`, one read of the accumulators at exit.
    Push and pull run the direction loop in their forced mode; relay runs
    :meth:`RelayEngine.run_level_curve` (which adds per-level out-edges)."""
    from .direction import DirectionConfig, DirectionEngine  # it imports this module

    if engine == "relay" or isinstance(graph, RelayGraph):
        return RelayEngine(graph, device=device).run_level_curve(
            source, max_levels=max_levels, reference_reached=reference_reached)
    if engine not in ("pull", "push"):
        raise ValueError(f"unknown engine {engine!r}; use 'relay', 'pull' or 'push'")
    eng = EdgeEngine(graph, engine=engine, device=device, block=block)
    return DirectionEngine(**{engine: eng}, config=DirectionConfig(mode=engine)).level_curve(
        int(source), max_levels=max_levels, reference_reached=reference_reached)


class SuperstepRunner:
    """Stepped execution, one superstep per call, on any engine: the
    observable path (per-superstep time, frontier sizes, state dumps,
    checkpoints).  ``engine``: ``'push'`` (default, as in the reference),
    ``'pull'`` or ``'relay'``.  Each step runs eagerly on the engine's
    device; the caller reads ``changed`` between steps.

    For relay the state lives in the RELABELED vertex space (the unpacked
    :class:`~bfs_tpu_torch.ops.relay.RelayState`); :meth:`to_original` maps
    any state to original-id host arrays and is the identity for push and
    pull.  Frontier sizes and levels are permutation-invariant."""

    def __init__(self, graph, *, engine: str = "push", device=None, block: int = 1024):
        self.engine = engine
        if engine in ("push", "pull"):
            self._edges = EdgeEngine(graph, engine=engine, device=device, block=block)
            self.device = self._edges.device
            self.num_vertices = self._edges.num_vertices
        elif engine == "relay":
            self._relay = RelayEngine(graph, device=device)
            self.device = self._relay.device
            self.num_vertices = self._relay.relay_graph.num_vertices
        else:
            raise ValueError(f"unknown engine {engine!r}; use 'push', 'pull' or 'relay'")

    def init(self, source: int = 0):
        check_sources(self.num_vertices, source)
        if self.engine == "relay":
            return self._relay.init_state(source)
        return init_state(self.num_vertices, int(source), self.device)

    def step(self, state):
        if self.engine == "relay":
            return self._relay.step(state)
        return self._edges.superstep(state)

    def frontier_size(self, state) -> int:
        if self.engine == "relay":
            return int(R.unpack_std(state.fwords, self._relay.relay_graph.vr).sum())
        return int(frontier_size(state))

    def to_original(self, state, *, source: int | None = None):
        """Host ``(dist, parent, frontier)`` in ORIGINAL vertex ids.
        ``source`` (an original id) is required for relay: the source's
        self-parent is written in relabeled space."""
        if self.engine != "relay":
            v = self.num_vertices
            return tuple(t[:v].cpu().numpy() for t in (state.dist, state.parent, state.frontier))
        if source is None:
            raise ValueError("to_original requires source= for the relay engine")
        eng = self._relay
        dist, parent = eng._map_original_device(state.dist, state.parent, source)
        bits = R.unpack_std(state.fwords, eng.relay_graph.vr)[eng.old2new] != 0
        return tuple(t.cpu().numpy() for t in (dist, parent, bits))

    def run(self, source: int = 0, *, max_levels: int | None = None, observer=None) -> BfsResult:
        """Run to termination; ``observer(level, state)`` is called after
        each superstep."""
        state = self.init(source)
        limit = max_levels if max_levels is not None else self.num_vertices
        while bool(state.changed) and int(state.level) < limit:
            state = self.step(state)
            if observer is not None:
                observer(int(state.level), state)
        dist, parent, _ = self.to_original(state, source=source)
        return BfsResult(dist=dist, parent=parent, num_levels=int(state.level))
