"""Single-source relay BFS on the card: :class:`RelayEngine` and :func:`bfs`.

The port of ``bfs_tpu.models.bfs`` for ``engine="relay"``.  The layout is
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
the CPU.  The level loop is a Python loop that reads ``changed`` once per
level.  A search that hits the packed carry's 62-level cap is re-run on
the unpacked carry.

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

``RelayEngine(..., expansion="mxu")`` runs single-source searches (and the
lock-step :meth:`RelayEngine.run_multi`) through the MXU expansion arm
instead: phases 1-4 become one tiled masked product of the frontier
against bit-packed 128x128 adjacency tiles (:mod:`bfs_tpu_torch.graph.adj_tiles`,
:mod:`bfs_tpu_torch.ops.relay_mxu`; kernel ``mxu_expand`` on tensor cores),
whose candidates are ORIGINAL ids that the packed update merges as they
are.  The element-major batch stays on the gather formulation.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..graph.adj_tiles import build_adj_tiles_from_relay
from ..graph.csr import Graph, INF_DIST
from ..graph.relay import RelayGraph, build_relay_graph, valid_slot_words
from ..ops import relay as R
from ..ops import relay_cuda as K
from ..ops import relay_elem as RE
from ..ops import relay_mxu as RM
from ..ops.packed import (
    packed_cap,
    packed_dist,
    packed_parent,
    packed_parent_fits,
    packed_rank_fits,
    packed_truncated,
)
from ..ops.relay import slots_to_parent
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
    one source, :meth:`run_multi_elem` and :meth:`run_multi` a batch.

    ``expansion`` (``gather|mxu``, default ``gather``: the port has no
    measured probe to choose by yet) picks the dense superstep's arm:
    ``mxu`` builds the adjacency tiles on ``device`` under
    ``tiles_budget_bytes`` (default 4 GiB) and raises ``ValueError`` if
    they exceed it.  :attr:`expansion_basis` says how the arm was chosen.
    """

    def __init__(
        self, graph: Graph | RelayGraph, *, device=None,
        expansion: str | None = None, tiles_budget_bytes: int | None = None,
    ):
        self.device = resolve_device(device)
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
        #: Host seconds of the last run: the level loop (it ends in a
        #: device read) and the result mapping with its copy to the host.
        self.last_run: dict = {}
        self.adj_tiles = None
        self._route_index = None
        self._resolve_expansion(expansion, tiles_budget_bytes)

    # -- the expansion arm --------------------------------------------------

    def _resolve_expansion(self, requested: str | None, budget: int | None) -> None:
        """``mxu`` builds the tiles now (a budget refusal raises) and drops
        to the unpacked carry where ``V`` exceeds the 26-bit packed parent
        field, which holds original ids on this arm."""
        self.expansion = RM.resolve_expansion(requested)
        if requested is None:
            self.expansion_basis = (
                "default: gather (no measured expansion probe in the port yet)"
            )
        else:
            self.expansion_basis = "requested"
        if self.expansion == "mxu":
            self.packed = self.packed and packed_parent_fits(self.relay_graph.num_vertices)
            self._build_tiles(RM.DEFAULT_TILES_BUDGET_BYTES if budget is None else int(budget))

    def _build_tiles(self, budget: int) -> None:
        """Build the tiled adjacency on the engine's device and keep its
        device operands."""
        t0 = time.perf_counter()
        at = build_adj_tiles_from_relay(self.relay_graph, budget_bytes=budget, device=self.device)
        self.mxu_operands = RM.mxu_device_operands(at, self.device)
        self.mxu_geometry = RM.mxu_static(at)
        self.adj_tiles = at
        #: Host seconds of the tile build and shipping.
        self.tiles_build_s = time.perf_counter() - t0
        logger.info(
            "mxu tiles: %d tiles, %d bytes, built in %.3f s on %s",
            at.nt, at.nbytes, self.tiles_build_s, self.device,
        )

    # -- one superstep ------------------------------------------------------

    def _routed(self, fwords: torch.Tensor) -> torch.Tensor:
        """Phases 1-3: frontier words -> routed L1 slot words."""
        rg = self.relay_graph
        fw = torch.zeros(rg.vperm_size // 32, dtype=torch.int32, device=self.device)
        fw[: rg.vr // 32] = fwords  # dummy out-positions read the zero tail
        y = K.apply_benes(fw, self.vperm_masks, rg.vperm_table, rg.vperm_size)
        l2 = R.broadcast_l2(y, rg.out_classes, rg.net_size, rg.out_space)
        return K.apply_benes(l2, self.net_masks, rg.net_table, rg.net_size)

    def _ranks(self, fwords: torch.Tensor) -> torch.Tensor:
        rg = self.relay_graph
        return K.rowmin_ranks(
            self._routed(fwords), self.valid_words, rg.in_classes, rg.vr
        )

    def superstep_packed(self, st: R.PackedRelayState) -> R.PackedRelayState:
        if self.expansion == "mxu":
            return RM.mxu_superstep_packed(st, self.mxu_operands, self.mxu_geometry)
        return K.apply_relay_candidates_packed(st, self._ranks(st.fwords))

    def superstep(self, st: R.RelayState) -> R.RelayState:
        """Unpacked carry: the row-min's ranks become L1 slots through the
        class slot formula, then the unpacked merge (torch ops).  On the MXU
        arm the candidates are original ids and merge as they are."""
        if self.expansion == "mxu":
            return RM.mxu_superstep(st, self.mxu_operands, self.mxu_geometry)
        rg = self.relay_graph
        cand = R.rank_to_slot(self._ranks(st.fwords), rg.in_classes, rg.vr)
        return R.apply_relay_candidates(st, cand)

    # -- the level loop -----------------------------------------------------

    def _loop(self, st, step, cap: int):
        changed = True
        while changed and st.level < cap:
            st = step(st)
            changed = bool(st.changed)  # the one host read per level
        return st, changed

    def run(self, source: int = 0, *, max_levels: int | None = None) -> BfsResult:
        rg = self.relay_graph
        check_sources(rg.num_vertices, source)
        max_levels = int(max_levels) if max_levels is not None else rg.vr
        t0 = time.perf_counter()
        dist, parent_slots, level = self._search(int(rg.old2new[source]), max_levels)
        t1 = time.perf_counter()
        result = self._to_result(dist, parent_slots, level, source)
        self.last_run = {"loop_s": t1 - t0, "result_s": time.perf_counter() - t1}
        return result

    def _search(self, source_new: int, max_levels: int):
        """(dist, parent, levels) in the relabeled space; parents are L1
        slots on the gather arm and original ids on the MXU arm."""
        rg = self.relay_graph
        if self.packed:
            st, changed = self._loop(
                R.init_packed_relay_state(rg.vr, source_new, self.device),
                self.superstep_packed, packed_cap(max_levels),
            )
            if not packed_truncated(changed, st.level, max_levels):
                if self.expansion == "mxu":
                    return packed_dist(st.packed), packed_parent(st.packed), st.level
                dist, parent = R.unpack_relay_packed(st.packed, rg.in_classes, rg.vr)
                return dist, parent, st.level
        # Deeper than the packed level field (or a rank too wide for it):
        # the unpacked carry has no level cap.
        st, _ = self._loop(
            R.init_relay_state(rg.vr, source_new, self.device),
            self.superstep, max_levels,
        )
        return st.dist, st.parent, st.level

    def _to_result(self, dist, parent_slots, level: int, source: int) -> BfsResult:
        """Relabeled state -> original ids (on the device), then the host.
        MXU-arm parents are original ids already: only the index space
        is mapped."""
        dist = dist[self.old2new].cpu().numpy()
        if self.expansion != "mxu":
            parent_slots = slots_to_parent(parent_slots, self.src_l1)
        parent = parent_slots[self.old2new].cpu().numpy()
        parent[source] = source  # the source's slot entry is not a parent
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

    def superstep_elem(self, st: RE.ElemState) -> RE.ElemState:
        """One element-major superstep for all 32·G trees: the route as one
        gather over :meth:`route_index`, then the fused row-min/update."""
        rg = self.relay_graph
        l1 = K.elem_route_gather(st.frontier, self.route_index())
        return K.elem_rowmin_update(l1, self.valid_words, st, rg.in_classes, rg.vr)

    def run_multi_elem_device(self, sources, *, max_levels: int | None = None) -> RE.ElemState:
        """Element-major batched BFS; the source count must be a multiple of
        32.  Returns the device :class:`~bfs_tpu_torch.ops.relay_elem.ElemState`
        (its ``level`` is a host int: the loop has read ``changed`` once per
        level).

        The distance planes hold levels up to ``MAX_ELEM_LEVELS`` (31).  The
        default run allows one step past that cap: a step at level 32 that
        changes nothing proves convergence at eccentricity 31 and writes no
        distance; one that changes leaves ``changed`` set, and
        :meth:`run_multi_elem` then discards the state and falls back.
        Callers of this raw path test ``changed`` themselves."""
        rg = self.relay_graph
        sources = np.atleast_1d(np.asarray(sources, dtype=np.int32))
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
        _, pt = RE.rank_plane_layout(rg.in_classes)
        st = RE.init_elem_state(
            rg.vr, rg.old2new[sources].reshape(groups, 32), pt, self.device
        )
        st, _ = self._loop(st, self.superstep_elem, max_levels)
        return st

    def run_multi_elem(self, sources, *, max_levels: int | None = None) -> MultiBfsResult:
        """Element-major batched BFS with host results in original ids,
        bit-exact with :meth:`run_multi`.  A default run that is still
        changing after the step past the 31-level cap (eccentricity > 31
        from some source) falls back to :meth:`run_multi`, which has no
        depth cap."""
        sources = np.atleast_1d(np.asarray(sources, dtype=np.int32))
        t0 = time.perf_counter()
        st = self.run_multi_elem_device(sources, max_levels=max_levels)
        t1 = time.perf_counter()
        if max_levels is None and bool(st.changed):
            return self.run_multi(sources)
        dist, parent = RE.extract_results(
            st, self.relay_graph, sources, self.old2new, self.src_l1
        )
        self.last_run = {"loop_s": t1 - t0, "result_s": time.perf_counter() - t1}
        return MultiBfsResult(sources=sources, dist=dist, parent=parent, num_levels=st.level)

    def run_multi(self, sources, *, max_levels: int | None = None) -> MultiBfsResult:
        """Lock-step batched BFS without a depth cap: every source runs its
        own search (through the engine's expansion arm) and ``num_levels``
        is the largest, which is the lock-step loop's level (all trees
        advance together until none changes)."""
        rg = self.relay_graph
        sources = np.atleast_1d(np.asarray(sources, dtype=np.int32))
        check_sources(rg.num_vertices, sources)
        max_levels = int(max_levels) if max_levels is not None else rg.vr
        dist = np.empty((sources.shape[0], rg.num_vertices), dtype=np.int32)
        parent = np.empty_like(dist)
        levels = 0
        for i, s in enumerate(sources.tolist()):
            res = self._to_result(*self._search(int(rg.old2new[s]), max_levels), s)
            dist[i], parent[i] = res.dist, res.parent
            levels = max(levels, res.num_levels)
        return MultiBfsResult(sources=sources, dist=dist, parent=parent, num_levels=levels)


def bfs(
    graph: Graph | RelayGraph,
    source: int = 0,
    *,
    engine: str = "relay",
    device=None,
    max_levels: int | None = None,
) -> BfsResult:
    """Single-source BFS on the relay engine; on the card unless ``device``
    names the CPU."""
    if engine != "relay":
        raise ValueError(f"unknown engine {engine!r}; this port runs 'relay'")
    return RelayEngine(graph, device=device).run(source, max_levels=max_levels)
