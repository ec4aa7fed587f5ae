"""Superstep checkpoints: traversals that resume mid-run, the port of
``bfs_tpu.resilience.superstep_ckpt``.

A fused search keeps its carry on the device from the first superstep to
the last, so a process killed at level 40 loses all 40 levels.  A
segmented run cuts the level loop into bounded segments of ``k``
supersteps and snapshots the whole carry at each boundary::

    carry = start(source)                     # or restore(newest epoch)
    while carry.changed and carry.level < cap:
        carry = segment(carry, seg_end=min(level + k, cap))
        snapshot(carry)                       # an atomic .npz epoch
        fault_point(f"superstep:{level}")     # the chaos boundary

On the card a segment is the run's own captured level loop with the
control block's CAP set to the segment's end
(:func:`bfs_tpu_torch.ops.control.set_cap`): one captured graph serves
every segment, and a boundary changes where the loop pauses, never what it
computes.  The direction decision (the next body and the decision words),
the telemetry accumulators and the packed or unpacked state all ride the
carry and so the epoch: a resumed run ends with the fused run's
``dist``/``parent``, ``num_levels``, direction schedule and occupancy, bit
for bit.  With ``BFS_TPU_TORCH_CKPT=off`` (the default) nothing here runs
and every path runs its fused loop.

Interval: ``every:<k>`` forces ``k`` supersteps a segment; ``auto`` sizes it
Young/Daly-style (:func:`daly_interval`, ``T_opt = sqrt(2 * delta *
MTBF)`` with ``BFS_TPU_TORCH_CKPT_MTBF_S`` as the failure-rate prior) from
the measured superstep and snapshot seconds, re-derived after every segment.

Durability: epochs go through
:func:`bfs_tpu_torch.utils.checkpoint.save_npz_atomic` into the caller's
directory, keyed by the run configuration
(``ckpt_<config_key(config)>.epoch<NNNNNN>.npz``, with ``meta_*`` keys and
``packed_flag``: the reference's file format, so either package's store
reads the other's epochs).  Loads go through ``load_npz_strict``: a
truncated or bit-flipped epoch is skipped (counted) for the one before it,
and a run whose epochs are all damaged, or lack a key its carry needs,
starts fresh (counted).  Per-shard epochs (a meta file plus one file per
shard; complete only when all validate) are the sharded runs' store.

Run ``python -m bfs_tpu_torch.resilience.superstep_ckpt --config
relay|multi|stream|sharded|grid --ckpt-dir D --out result.json [--device
cpu] [--shards N] [--mesh rxc]`` for one segmented traversal that a
``BFS_TPU_TORCH_FAULT=kill:superstep:<n>`` kills at its n-th boundary;
running it again with the same ``--ckpt-dir`` resumes.  ``sharded`` is
the mesh's relay search on ``N`` shards (8 by default) stacked on the
device, with per-shard epochs; ``grid`` the 2-D grid's search on an
``rxc`` mesh (2x4 by default), with per-cell epochs.
"""

from __future__ import annotations

import glob
import logging
import math
import os
import time
from dataclasses import dataclass

import numpy as np

from .. import knobs
from .faults import fault_point
from .journal import config_key

logger = logging.getLogger(__name__)

#: The fault family of a segment boundary: boundaries are
#: ``superstep:<level>``, so ``BFS_TPU_TORCH_FAULT=kill:superstep:<n>``
#: kills at the n-th boundary and ``raise:superstep:<n>`` raises there.
TRAVERSAL_BOUNDARY = "superstep"

CKPT_MODES = ("off", "every", "auto")

#: The segment length ``auto`` starts from (before any measurement) and a
#: bare ``every`` takes.
DEFAULT_K0 = 8

#: The Young/Daly failure-rate prior, seconds (the operator's statement of
#: how often the environment kills runs).
DEFAULT_MTBF_S = 600.0


@dataclass(frozen=True)
class CkptConfig:
    """A resolved checkpoint policy (hashable)."""

    mode: str = "off"
    k: int = DEFAULT_K0

    @property
    def enabled(self) -> bool:
        return self.mode != "off"

    def key(self) -> tuple:
        return (self.mode, int(self.k))


def resolve_ckpt(spec: str | None = None) -> CkptConfig:
    """``BFS_TPU_TORCH_CKPT`` (or ``spec``, which wins): ``off`` |
    ``every:<k>`` | ``auto``.  An unknown mode or a non-positive interval
    raises ``ValueError``."""
    if spec is None:
        spec = knobs.get("BFS_TPU_TORCH_CKPT")
    spec = spec.strip()
    mode, _, arg = spec.partition(":")
    if mode not in CKPT_MODES:
        raise ValueError(f"unknown BFS_TPU_TORCH_CKPT {spec!r}; use off | every:<k> | auto")
    if mode == "every":
        k = int(arg) if arg else DEFAULT_K0
        if k < 1:
            raise ValueError(f"BFS_TPU_TORCH_CKPT=every:<k> needs k >= 1 (got {k})")
        return CkptConfig(mode="every", k=k)
    if arg:
        raise ValueError(f"BFS_TPU_TORCH_CKPT {spec!r}: only 'every' takes an argument")
    return CkptConfig(mode=mode)


def daly_interval(superstep_s: float, snapshot_s: float, mtbf_s: float = DEFAULT_MTBF_S) -> int:
    """The Young/Daly interval in supersteps: ``sqrt(2 * delta * M)``
    seconds between checkpoints (``delta`` one snapshot's seconds, ``M`` the
    mean time between failures) over the seconds of one superstep, clamped
    to [1, 4096]."""
    superstep_s = max(float(superstep_s), 1e-9)
    t_opt = math.sqrt(2.0 * max(float(snapshot_s), 1e-6) * float(mtbf_s))
    return max(1, min(4096, int(round(t_opt / superstep_s))))


class SuperstepCheckpointer:
    """The epoch store and the interval policy of one segmented traversal.

    ``config`` is the run's identity (graph, engine, direction, source,
    ...): the file stem is ``ckpt_<config_key(config)>``, so two
    configurations never feed each other's epochs.  ``shards`` > 1 writes
    per-shard epochs (a meta file plus one file per shard).  A disabled
    checkpointer (mode ``off``) touches no disk: its boundaries are still
    marked, so a segmented run without a store can be killed there."""

    def __init__(self, directory: str | os.PathLike, config: dict, *,
                 cfg: CkptConfig | None = None, shards: int = 1, retain: int = 2,
                 mtbf_s: float | None = None):
        self.cfg = cfg if cfg is not None else resolve_ckpt()
        self.directory = os.fspath(directory)
        self.config = dict(config)
        self.key = config_key(self.config)
        self.stem = os.path.join(self.directory, f"ckpt_{self.key}")
        self.shards = int(shards)
        self.retain = max(2, int(retain))
        self.mtbf_s = float(mtbf_s) if mtbf_s is not None else knobs.get("BFS_TPU_TORCH_CKPT_MTBF_S")
        self._k = self.cfg.k if self.cfg.mode == "every" else DEFAULT_K0
        # Running means of the two costs: the interval needs their order of
        # magnitude, not their medians.
        self._superstep_s: float | None = None
        self._snapshot_s: float | None = None
        self.counters = {
            "epochs_written": 0,
            "segments": 0,
            "epochs_corrupt_skipped": 0,
            "fresh_fallbacks": 0,
        }
        self.snapshot_bytes = 0
        self.snapshot_seconds = 0.0
        self.resumed_from_epoch: int | None = None
        if self.cfg.enabled:
            os.makedirs(self.directory, exist_ok=True)

    # -- the interval ---------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self.cfg.enabled

    def interval(self) -> int:
        """The current segment length in supersteps."""
        return self._k

    def note_segment(self, supersteps: int, seg_seconds: float) -> None:
        """One segment's measurement; in ``auto`` the interval is derived
        again from the running means."""
        self.counters["segments"] += 1
        if supersteps > 0 and seg_seconds > 0:
            per = seg_seconds / supersteps
            self._superstep_s = per if self._superstep_s is None else 0.5 * (self._superstep_s + per)
        if self.cfg.mode == "auto" and self._superstep_s is not None and self._snapshot_s is not None:
            self._k = daly_interval(self._superstep_s, self._snapshot_s, self.mtbf_s)

    # -- names ------------------------------------------------------------------

    def _epoch_path(self, superstep: int, shard: int | None = None) -> str:
        base = f"{self.stem}.epoch{int(superstep):06d}"
        return f"{base}.npz" if shard is None else f"{base}.shard{int(shard)}.npz"

    def _meta_path(self, superstep: int) -> str:
        return f"{self.stem}.epoch{int(superstep):06d}.meta.npz"

    def epochs(self) -> list[int]:
        """The supersteps of every epoch with a file on disk, ascending."""
        found = set()
        for path in glob.glob(f"{self.stem}.epoch*.npz"):
            digits = os.path.basename(path).split(".epoch", 1)[1].split(".", 1)[0]
            if digits.isdigit():
                found.add(int(digits))
        return sorted(found)

    # -- writes ---------------------------------------------------------------

    def save_epoch(self, superstep: int, arrays: dict[str, np.ndarray],
                   shard_arrays: list[dict[str, np.ndarray]] | None = None) -> None:
        """Write one durable epoch (each file atomic), prune past the
        retention window, then mark the ``superstep:<n>`` boundary: a kill
        there lands after the epoch is on disk."""
        if not self.cfg.enabled:
            fault_point(f"{TRAVERSAL_BOUNDARY}:{int(superstep)}")
            return
        from ..utils.checkpoint import save_npz_atomic

        t0 = time.perf_counter()
        meta = {f"meta_{k}": np.asarray(v) for k, v in (
            ("config", self.key), ("superstep", int(superstep)), ("shards", self.shards))}
        nbytes = 0
        if shard_arrays is None:
            save_npz_atomic(self._epoch_path(superstep), **arrays, **meta)
        else:
            if len(shard_arrays) != self.shards:
                raise ValueError(f"expected {self.shards} shard payloads, got {len(shard_arrays)}")
            # The meta file last: its presence says every shard landed, so a
            # kill mid-epoch leaves shard files without a meta, which the
            # loader skips as an incomplete epoch.
            for s, sa in enumerate(shard_arrays):
                save_npz_atomic(self._epoch_path(superstep, s), **sa, **meta)
                nbytes += sum(int(np.asarray(a).nbytes) for a in sa.values())
            save_npz_atomic(self._meta_path(superstep), **arrays, **meta)
        nbytes += sum(int(np.asarray(a).nbytes) for a in arrays.values())
        dt = time.perf_counter() - t0
        self.counters["epochs_written"] += 1
        self.snapshot_bytes = nbytes
        self.snapshot_seconds += dt
        self._snapshot_s = dt if self._snapshot_s is None else 0.5 * (self._snapshot_s + dt)
        self._prune()
        fault_point(f"{TRAVERSAL_BOUNDARY}:{int(superstep)}")

    def _epoch_files(self, ep: int) -> list[str]:
        """Every file an epoch may own, by exact name (a bare ``epoch<N>*``
        glob would match epoch 1000000's files for epoch 100000)."""
        return [self._epoch_path(ep), self._meta_path(ep),
                *glob.glob(f"{self.stem}.epoch{int(ep):06d}.shard*.npz")]

    def _prune(self) -> None:
        for ep in self.epochs()[: -self.retain]:
            for path in self._epoch_files(ep):
                try:
                    os.remove(path)
                except OSError:
                    pass

    def clear(self) -> None:
        """Delete every epoch: the traversal finished, and a later run of
        the same configuration must start fresh."""
        for path in glob.glob(f"{self.stem}.epoch*.npz"):
            try:
                os.remove(path)
            except OSError:
                pass

    # -- reads ------------------------------------------------------------------

    def _load_one(self, path: str) -> dict | None:
        from ..utils.checkpoint import CheckpointError, load_npz_strict

        try:
            z = load_npz_strict(path)
        except (CheckpointError, FileNotFoundError, OSError) as exc:
            logger.warning("skipping damaged checkpoint %s (%r)", path, exc)
            self.counters["epochs_corrupt_skipped"] += 1
            return None
        cfg = z.get("meta_config")
        if cfg is None or str(cfg) != self.key:
            logger.warning("skipping %s: written by a different run config", path)
            self.counters["epochs_corrupt_skipped"] += 1
            return None
        return z

    def load_latest(self):
        """``(superstep, arrays, shard_arrays)`` of the newest complete
        valid epoch, or None (a fresh traversal).  Damaged, foreign and
        incomplete epochs are skipped newest first; when every epoch on
        disk is skipped, ``fresh_fallbacks`` counts it."""
        if not self.cfg.enabled:
            return None
        had_any = False
        for ep in reversed(self.epochs()):
            had_any = True
            if self.shards == 1:
                z = self._load_one(self._epoch_path(ep))
                if z is None:
                    continue
                self.resumed_from_epoch = ep
                return ep, {k: v for k, v in z.items() if not k.startswith("meta_")}, None
            meta_path = self._meta_path(ep)
            if not os.path.exists(meta_path):
                # The normal shape of a kill mid-epoch (the meta is written
                # last): an incomplete epoch, not corruption.
                logger.info("skipping incomplete epoch %d (no meta file)", ep)
                continue
            meta = self._load_one(meta_path)
            if meta is None:
                continue
            if int(meta.get("meta_shards", -1)) != self.shards:
                logger.warning("skipping epoch %d: shard count mismatch", ep)
                self.counters["epochs_corrupt_skipped"] += 1
                continue
            shard_arrays = []
            for s in range(self.shards):
                z = self._load_one(self._epoch_path(ep, s))
                if z is None:
                    break  # a lost shard: this epoch is incomplete
                shard_arrays.append({k: v for k, v in z.items() if not k.startswith("meta_")})
            else:
                self.resumed_from_epoch = ep
                return ep, {k: v for k, v in meta.items() if not k.startswith("meta_")}, shard_arrays
        if had_any:
            self.counters["fresh_fallbacks"] += 1
        return None

    # -- report -----------------------------------------------------------------

    def report(self) -> dict:
        """The policy, the measured costs and the fallback counters,
        JSON-ready."""
        return {
            "mode": self.cfg.mode,
            "interval": int(self._k),
            "shards": self.shards,
            "superstep_seconds": self._superstep_s,
            "snapshot_seconds_mean": self._snapshot_s,
            "snapshot_seconds_total": self.snapshot_seconds,
            "snapshot_bytes": int(self.snapshot_bytes),
            "mtbf_s": self.mtbf_s,
            "resumed_from_epoch": self.resumed_from_epoch,
            **self.counters,
        }


def epoch_arrays(tensors: dict, **extra) -> dict[str, np.ndarray]:
    """An epoch's arrays from carry tensors by key: one copy to the host
    (pinned memory and one wait on a card).  Words the reference keeps as
    uint32 (``pk``, ``fw``, the packed ``packed``) are written as uint32, as
    the reference writes them; ``extra`` host values are added as they are."""
    from ..models.bfs import to_host

    names = list(tensors)
    host = to_host(*(tensors[k].contiguous() for k in names))
    out = {k: (h.view(np.uint32) if k in UINT32_KEYS else h) for k, h in zip(names, host)}
    out.update({k: np.asarray(v) for k, v in extra.items()})
    return out


#: Epoch keys whose arrays hold uint32 words (int32 bit patterns here).
UINT32_KEYS = frozenset(("pk", "fw", "packed", "rc"))


def epoch_tensor(a: np.ndarray, device, dtype=None):
    """An epoch's array as a tensor on ``device``: uint32 words as their
    int32 bit patterns, else cast to ``dtype`` when given (the occupancy
    accumulator is int32 in the reference's epochs, int64 here)."""
    import torch

    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    t = torch.from_numpy(a.copy())
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def restore_arrays(ckpt: SuperstepCheckpointer, packed: bool, require: tuple = (),
                   require_shards: tuple = (), require_any: tuple = ()):
    """THE restore gate of every segmented driver: ``(arrays,
    shard_arrays)`` of the newest valid epoch if it is of the carry flavor
    asked for (``packed_flag``) and holds every key of ``require`` (and of
    ``require_shards`` in each shard), and, for each entry of
    ``require_any`` (a tuple of key groups), every key of one of its
    groups; else ``(None, None)``, a fresh traversal, counted in
    ``fresh_fallbacks`` when an epoch was found.  The key checks matter
    because the config key does not say every carry-shaping flag
    (telemetry, the decision words' form).  ``resumed_from_epoch`` is reset
    on entry and set only by a resume that this gate lets through, so the
    report describes the run that produced the result."""
    ckpt.resumed_from_epoch = None
    found = ckpt.load_latest()
    if found is None:
        return None, None
    _ep, arrays, shard_arrays = found
    missing = [k for k in require if k not in arrays]
    for sa in shard_arrays or ():
        missing += [k for k in require_shards if k not in sa]
    for groups in require_any:
        if not any(all(k in arrays for k in group) for group in groups):
            missing.append(" | ".join("+".join(group) for group in groups))
    if int(np.asarray(arrays.get("packed_flag", -1))) != int(packed) or missing:
        if missing:
            logger.warning("checkpoint epoch lacks carry keys %s; fresh traversal", missing)
        ckpt.resumed_from_epoch = None
        ckpt.counters["fresh_fallbacks"] += 1
        return None, None
    return arrays, shard_arrays


# ---------------------------------------------------------------------------
# Host drivers.  The engines' segment machinery lives beside their fused
# loops (models/bfs.py: RelayEngine.run_segmented, EdgeEngine.segment;
# models/multisource.py: multi_segment_init, multi_segment_finish).
# ---------------------------------------------------------------------------

def run_multi_segmented(graph, sources, *, ckpt: SuperstepCheckpointer, engine: str = "push",
                        max_levels: int | None = None, block: int = 1024, device=None):
    """Segmented batched multi-source BFS on push or pull: the resumable
    twin of :func:`bfs_tpu_torch.models.multisource.bfs_multi`, equal to it
    bit for bit for any segmentation.  ``graph`` is a graph or layout (an
    engine is built on ``device``, the card unless it names the CPU) or an
    :class:`~bfs_tpu_torch.models.bfs.EdgeEngine` of that ``engine``.
    Epochs are cleared when the run completes.  Returns a
    :class:`~bfs_tpu_torch.models.multisource.MultiBfsResult`."""
    from ..models.bfs import EdgeEngine, check_sources, to_host
    from ..models.multisource import (
        MultiBfsResult,
        multi_segment_finish,
        multi_segment_init,
        multi_snapshot,
    )
    from ..ops.packed import packed_cap, packed_truncated
    from ..ops.relax import BfsState, PackedBfsState

    if engine not in ("push", "pull"):
        raise ValueError(f"unknown engine {engine!r}; use 'push' or 'pull'")
    if isinstance(graph, EdgeEngine):
        eng = graph
        if eng.engine != engine:
            raise ValueError(f"an EdgeEngine of {eng.engine!r} given for engine={engine!r}")
    else:
        eng = EdgeEngine(graph, engine=engine, device=device, block=block)
    sources = np.atleast_1d(np.asarray(sources, dtype=np.int32))
    v = eng.num_vertices
    check_sources(v, sources)
    limit = int(max_levels) if max_levels is not None else v

    def run_flavor(packed: bool):
        cap = packed_cap(limit) if packed else limit
        cls = PackedBfsState if packed else BfsState
        arrays, _ = restore_arrays(ckpt, packed, require=cls._fields)
        state = multi_segment_init(eng, sources, packed, restore=arrays)
        stats = None
        while state.changed and state.level < cap:
            level = state.level
            t0 = time.perf_counter()
            state, seg = eng.segment(state, min(level + ckpt.interval(), cap))
            seg_s = time.perf_counter() - t0
            stats = seg if stats is None else stats.add(seg)
            # A disabled store marks the boundary without the copy to the host.
            ckpt.save_epoch(state.level, multi_snapshot(state, packed) if ckpt.enabled else {})
            ckpt.note_segment(state.level - level, seg_s)
        return multi_segment_finish(state, packed), stats

    packed = eng.packed
    state, stats = run_flavor(packed)
    if packed and packed_truncated(state.changed, state.level, limit):
        ckpt.clear()  # packed epochs cannot feed the unpacked re-run
        state, more = run_flavor(False)
        stats = more if stats is None or more is None else stats.add(more)
    ckpt.clear()
    eng.last_run = vars(stats) if stats is not None else {}
    dist, parent = to_host(state.dist[:, :v].contiguous(), state.parent[:, :v].contiguous())
    return MultiBfsResult(sources=sources, dist=dist, parent=parent, num_levels=int(state.level))


# ---------------------------------------------------------------------------
# The command-line runner: the subject process of a traversal chaos run.
# ---------------------------------------------------------------------------

#: Configurations of the reference's runner that need modules the port does
#: not have yet, with the roadmap item that brings each (none left).
NOT_PORTED: dict[str, str] = {}


def _hash(a: np.ndarray) -> str:
    import hashlib

    return hashlib.blake2b(np.ascontiguousarray(a).tobytes(), digest_size=16).hexdigest()


def _runner_main(argv=None) -> int:
    import argparse
    import json
    import sys

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True,
                    choices=("relay", "multi", "stream", "sharded", "grid", *NOT_PORTED))
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--scale", type=int, default=8)
    ap.add_argument("--edge-factor", type=int, default=4)
    ap.add_argument("--seed", type=int, default=3)
    # 3, not 0: R-MAT leaves many low ids in tiny components at toy scale,
    # and a 1-level traversal has no interior boundary to kill.
    ap.add_argument("--source", type=int, default=3)
    ap.add_argument("--interval", type=int, default=2,
                    help="forced supersteps per segment (every:<k>)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain path)")
    ap.add_argument("--shards", type=int, default=8,
                    help="sharded config: the mesh's graph axis, its shards stacked on the device")
    ap.add_argument("--mesh", default="2x4",
                    help="grid config: the 'rxc' mesh, its cells stacked on the device")
    args = ap.parse_args(argv)
    if args.config in NOT_PORTED:
        print(f"--config {args.config}: not ported to bfs_tpu_torch yet, see "
              f"{NOT_PORTED[args.config]}", file=sys.stderr)
        return 2

    from ..graph.generators import rmat_graph

    graph = rmat_graph(args.scale, args.edge_factor, seed=args.seed)
    cfg = CkptConfig(mode="every", k=args.interval)
    base_config = {
        "runner": args.config, "scale": args.scale, "edge_factor": args.edge_factor,
        "seed": args.seed, "source": args.source, "interval": args.interval,
    }
    shards = 1
    if args.config == "sharded":
        shards = args.shards
    elif args.config == "grid":
        from ..graph.grid_layout import parse_mesh_spec

        r, c = parse_mesh_spec(args.mesh)
        base_config["mesh"] = f"{r}x{c}"
        shards = r * c
    ckpt = SuperstepCheckpointer(args.ckpt_dir, base_config, cfg=cfg, shards=shards)
    doc: dict = {"config": args.config}
    if args.config == "relay":
        from ..models.bfs import RelayEngine

        eng = RelayEngine(graph, device=args.device, sparse_hybrid=True, direction="auto")
        result, curve = eng.run_segmented(args.source, ckpt=ckpt, telemetry=True)
        doc.update(direction_schedule=curve["direction_schedule"])
    elif args.config == "stream":
        # The streamed MXU arm under a budget of one largest superblock, so
        # even a toy graph evicts.  A kill loses the cache (derived content)
        # but not the carry: the resumed run's results and schedule are the
        # golden run's, its ledger (a cold cache) is not.
        from ..models.bfs import RelayEngine

        eng = RelayEngine(graph, device=args.device, sparse_hybrid=True, direction="auto",
                          expansion="mxu", tiles_mode="stream")
        store = eng.stream_store
        budget = max(store.sb_bytes(g) for g in range(store.num_superblocks))
        result, curve = eng.run_streamed(args.source, ckpt=ckpt, telemetry=True,
                                         cache_budget_bytes=budget)
        doc.update(direction_schedule=curve["direction_schedule"], stream=eng.stream_report)
    elif args.config == "sharded":
        # The mesh's relay search (auto direction, auto exchange) on shards
        # stacked on the device; its epochs are per-shard files, and the
        # exchange's arm and bytes per level are part of what a resume must
        # reproduce.
        from ..models.bfs import resolve_device
        from ..parallel.sharded import bfs_sharded_segmented, make_mesh

        mesh = make_mesh(graph=args.shards, devices=[resolve_device(args.device)] * args.shards)
        result, curve = bfs_sharded_segmented(graph, args.source, mesh=mesh, ckpt=ckpt,
                                              direction="auto", exchange="auto", telemetry=True)
        doc.update(direction_schedule=curve["direction_schedule"],
                   exchange_schedule=curve["exchange"]["schedule"],
                   exchange_bytes=curve["exchange"]["bytes_per_level"])
    elif args.config == "grid":
        # The 2-D grid's search (auto direction, auto exchange) on r x c
        # cells stacked on the device; per-cell epochs, and both axes' arm
        # and bytes per level are part of what a resume must reproduce.
        from ..models.bfs import resolve_device
        from ..parallel.grid import bfs_grid_segmented, make_grid_mesh

        mesh = make_grid_mesh(r, c, devices=[resolve_device(args.device)] * shards)
        result, curve = bfs_grid_segmented(graph, args.source, mesh=mesh, ckpt=ckpt,
                                           direction="auto", exchange="auto", telemetry=True)
        ex = curve["exchange"]
        doc.update(direction_schedule=curve["direction_schedule"],
                   exchange_schedule=ex["schedule"], exchange_bytes=ex["bytes_per_level"],
                   col_schedule=ex["col_schedule"], col_bytes=ex["col_bytes"],
                   row_schedule=ex["row_schedule"], row_bytes=ex["row_bytes"])
    else:  # multi
        v = graph.num_vertices
        sources = [(args.source + 7 * i) % v for i in range(4)]
        result = run_multi_segmented(graph, sources, ckpt=ckpt, engine="push", device=args.device)
    doc.update(dist_hash=_hash(result.dist), parent_hash=_hash(result.parent),
               num_levels=result.num_levels, superstep_ckpt=ckpt.report())
    with open(args.out, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
    print(json.dumps({"ok": True, "config": args.config}), file=sys.stderr)
    return 0


if __name__ == "__main__":  # pragma: no cover - subprocess entry
    raise SystemExit(_runner_main())
