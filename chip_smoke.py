#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``bfs_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the hand-written kernels from ``bfs_tpu_torch/csrc`` (while a
thread makes the host's share of what follows: the s22 graph, the probe
cell's graph and its roots' oracle trees; the s22 roots' oracle trees
are made beside the s22 layout build), holds the
device layout builder against the host builder at R-MAT scale 18 (byte for
byte with the native route), runs the measured arm selection on
its cell (``probe_phase``: R-MAT scale 18 at edge factor 64 on a torch-routed
layout, where the tiles fit the default budget: the default engine,
``expansion="auto"``, counts and builds its tiles and probes both arms, its
launches held to the probe's loops, and a second engine reads the verdict
back and launches nothing; 4 roots and the lock-step batch of 16 on both
arms, oracle-exact and equal to each other), builds the relay layout of a
Graph500-style R-MAT graph (a/b/c = .57/.19/.19, edge factor 6, graph seed
1, scale 22 by default) on the card with ``load_or_build_relay`` into a
fresh bundle store, loads it back from the bundle (a warm hit, memmapped,
byte for byte against the build) and ships every engine from that loaded
layout, builds the same layout again with the torch Beneš router
(``route="torch"``: its two route stages timed beside the native router's,
every non-mask field held against the bundle's, a search on it against the
oracle and the K1-K4 kernels on its masks against their plain versions),
holds every kernel against its plain PyTorch version on the card at the
layout's real shapes (bit-exact), then drives the main path — ``RelayEngine.run`` on the card for 4 roots drawn
from ``--seed`` — and checks every result against the port's host oracle
(``canonical_bfs`` bit for bit, ``check()`` without violations) and that
each superstep made 8 kernel launches (per Beneš network one outer pass per
side and one local pass, then the row-min and the update).  That default
engine resolves ``auto`` to gather by the tile budget from the tile count,
building no tile, and ``superstep_phase_ledger`` times its superstep's
phases after the kernel phase (``ledger_phase``).  The MXU
expansion arm comes next: its device tile builder held byte for byte against
the host oracle at scale 16, the scale-22 tiles built on the card (21 GB,
under a budget raised to 32 GiB), the tensor-core kernel ``mxu_expand`` held
bit-exact against its plain version at the level of the max-degree root's
search with the most live tiles, and ``RelayEngine(expansion="mxu")`` for the
same 4 roots, each result equal to ``canonical_bfs`` and to the gather arm's.
The lock-step batch follows the gather search (``lockstep_phase``):
``RelayEngine.run_multi`` for the 4 roots and for 16 sources (the roots
and 12 drawn with ``--seed + 1``; serve's relay buckets below 32), all
trees in one captured level loop
whose kernels take a tree axis: the first call (the capture) and a timed
call with its peak memory, launches held to the single search's
per-superstep count x supersteps issued, every tree against ``run`` (whose
summed seconds, the old design's S x ``run``, are printed beside), two
trees against the oracle, the eager loop against the captured one, a dead
superstep and a trace; then each batched kernel on the 16 trees at their
densest superstep (``lockstep_kernel_phase``) against its plain version and
16 single launches, one launch per call, timed beside them and its bound
(masks once + 16 x words; ``class_rowmin``'s: the bytes an early exit at
first hits still moves, the full read beside it), the Beneš passes (the
four outer launches and both local passes at the batch's own split, with
the batch's tile and trees a block printed) and ``class_rowmin`` (with
its trees a block) also on the first 4 trees; the MXU arm's batch of 4 after its searches,
equal to the gather batch's trees, and ``mxu_expand`` on the 16 trees'
frontiers; the 64-source batch below in lock-step too; and
``path_graph(100)`` batched through the unpacked re-run on both arms.
The multi-source path follows on the same graph:
``RelayEngine.run_multi_elem_device`` for a batch of 64 sources drawn from
``--seed`` (BASELINE.json config 5; G = 2 groups of 32 trees), whose first
call builds the route index through the element-major Beneš kernels (K5),
then timed (one ``elem_frontier_interleave``, one ``elem_route_gather`` and
one ``elem_rowmin_update`` per superstep, no K5 launch), traced, and every tree checked against the port's
single-source search (and two against the oracle); then the route index
against the one the plain networks build, and every element-major kernel
against its plain version at the layout's real shapes.  The push and pull
engines follow on the same graph: their layouts built on the host (timed),
``EdgeEngine.run`` for the same 4 roots on the captured loop and the eager
loop, each result equal to ``canonical_bfs`` and to the relay engine's,
each superstep's device time (ungated and gated by a live control block)
beside its byte bound, the pull and push batches of the first
``EDGE_BATCH`` of the same 64 sources (every tree equal to the relay
batch's), each search at blocks of 1, 2 and 4 supersteps and on the eager
loop, each batch on the eager loop for its first ``EAGER_BATCH`` sources
(every tree equal to the captured batch's), ``SuperstepRunner`` on push,
pull and relay for the
max-degree root (each step timed by the device-synchronised ``Stopwatch``,
the final state equal to the fused result, the relay runner's K1–K4
launches counted against its steps, and its step's device time beside
K1–K3 with the plain unpacked merge), and
the command-line runners ``run_parallel`` (stepped push, ``--fused`` pull,
stepped relay) and ``run_sequential`` on ``service.properties``.  The
direction policy runs on the same push and pull layouts:
``DirectionEngine.run`` (``bfs_direction``'s engine) for the 4 roots in
``auto`` and the first 2 in ``push`` and ``pull``, on the captured
two-graph loop and the eager loop, each result oracle-exact and equal to
the relay engine's (the captured loop's also under the DeviceChecker), each
schedule equal to the one the host recomputes with numpy from the oracle's
distances, every superstep one replay of one body's graph (the split by
body equal to the schedule); each superstep's device time by body and the
decide step's; then ``run_multi`` (``bfs_multi_direction``) in ``auto`` on
the first ``EDGE_BATCH`` (32) of the 64 sources, equal to the relay batch.
``RelayEngine.run_level_curve`` runs beside the gather search (its occupancy the oracle's level histogram).
Every relay phase above builds its engine with ``sparse_hybrid=False`` (the
dense superstep in blocks of 4).  The relay engine's hybrid schedule comes
next, once the dense engines are freed, on both arms from the same layout:
``RelayEngine(sparse_hybrid=True).run`` (the default engine of
``bfs(engine="relay")``) for the 4 roots in ``auto`` and ``push`` on the
captured switch loop (one graph per body) and the eager loop, each result
oracle-exact, equal to the dense relay search and to pull, clean under the
DeviceChecker, each schedule (``run_level_curve``) equal to the host's
recomputation with the relay's sparse budgets, the replays by body adding up
to the supersteps issued and split as the schedule, K1-K4 (or
``mxu_expand`` and K4) launched once per dense superstep; then the device
time of each superstep by body beside the dense superstep's on the same
level (a run with ``alpha = beta = 1e9``, every superstep dense), the
predicate step alone, a device trace, and ``run_many_device``.
The mesh-sharded engine follows (``sharded_phase``): on a mesh of
``SHARDS`` (4) shards stacked on the card, the torch-routed sharded relay
layouts of 4 and 2 shards and the 4-shard pull layout built side by side
(build seconds and bytes); ``bfs_sharded`` on pull, push and relay
(direction ``pull`` and ``auto``) from the max-degree root and a drawn one,
each equal bit for bit to the single-chip result and clean under the
DeviceChecker (``check()`` on the host for one), with seconds per search
beside the single-chip ones; K1–K4 launched once per shard (4 x the
shard's count x the supersteps issued); the relay search under the four
exchange arms, bit-identical, their bytes and arm per level; the batch
(``bfs_sharded_multi`` on a (2, 2) mesh, 8 of the batch sources, pull and
relay) equal to the batch's trees; ``sssp_sharded`` and ``cc_sharded``
equal to the single-chip results; the resumable search
(``bfs_sharded_segmented`` at ``every:2``, direction and exchange
``auto``, equal to the fused search in results, schedule and the
exchange's bytes; a run stopped at a boundary, one shard file of its
newest epoch truncated, resumed on a freshly built engine from the epoch
before); the 2-D grid on the same 4-shard layout (``sharded_grid_part``:
the 2x2 and 1x4 per-cell layouts built in the phase's pool beside the
first searches; a 2x2 ``GridEngine`` on ``pull`` and ``auto`` from both
roots equal bit for bit to the single-chip result, ``packed_update``
launched 4 x the supersteps issued, cell 0's update at the densest level
against its plain version; 1x4 equal to the 1-D mesh in results and the
exchange's bytes and arms; the segmented 2x2 search at ``every:2`` and
resumed after a lost cell file); the MXU arm on the mesh once every other
engine of the phase is freed (each shard's tiles counted, reckoned against the free memory and
built on the card; a search on ``pull`` and ``auto`` equal to the
single-chip result, ``mxu_expand`` launched 4 x the dense supersteps,
``packed_update`` 4 x every superstep; ``mxu_expand`` of shard 0 and
``packed_update`` on its original-id candidates against their plain
versions); the peak memory and the phase's wall time.  The query server closes the s22 part (``serve_phase``): a
``GraphRegistry`` over the script's bundle store (warm hits for the relay
and pull layouts) and ``BfsServer(engine="pull", max_batch=32,
tick_s=0.002, verify_sample=4)``: 40 single-source queries from 4
submitter threads, collapsed multi-source and tree queries and a
``query_path``; staged ticks of 32 relay sources (``run_multi_elem``, the
first building the route index), 4 relay sources (``run_multi``: K1-K4
on the lock-step loop)
and 8 push sources; a second round of every bucket, all executable-cache
hits; the per-tick service and result seconds and kept host bytes, with
the result cache at 0 and at 256; every reply held bit for bit against the
batch's trees and the roots' oracle results, no degraded tick, and the
launches of each staged tick counted.
Every s22 result of the script also passes the on-device verifier
(``DeviceChecker``), which must flag a corrupted parent and a corrupted
distance.  Small
graphs close the run: tinyCG (the paper's worked example) on the relay and
the default (pull) engine, and a 100-vertex path (deeper than the packed
carry's 62 levels, so it takes the unpacked re-run, on both expansion arms
and on push and pull, and on the hybrid in ``auto`` and ``push`` on both
arms with its level curve and ``run_many_device``; with 32 sources, deeper
than the 31 levels of the elem distance planes, so it takes the lock-step
fallback).

Superstep checkpoints (``bfs_tpu_torch.resilience.superstep_ckpt``) run on
the same s22 cell: ``RelayEngine.run_segmented`` at ``every:2`` into an
epoch store on disk on the dense MXU engine and on the default hybrid
(``auto``, gather) engine, for the max-degree root and one other, timed
beside the fused run, each result, direction schedule and occupancy equal to
the fused run's, no loop captured again, and the launches counted per
superstep issued; on the hybrid a run stopped by ``raise:superstep:2`` is
resumed from its epoch, bit-identical; ``run_multi_segmented`` on push for 8
of the batch's sources at ``every:4`` against ``bfs_multi``; one
``SegmentedBatchRunner`` push tick of 8 at ``every:4`` on the server's
registry; and ``path_graph(100)`` through the packed-to-unpacked re-run.
The launches counted there include the dead supersteps a block of 4 runs
past a segment's end; live supersteps count those this process ran (after
a resume, those after the epoch).

The semiring algorithms (``bfs_tpu_torch.algo``) run on the same push and
pull engines of the s22 graph: connected components on both (twice on the
captured loop, the second capturing nothing, and on the eager loop; the
labels equal each component's minimum id from scipy's
``connected_components``, ``check_cc`` and ``cc_device_check`` clean),
weighted SSSP on push for the max-degree root and one other at the default
delta and the max-degree root at ``delta=inf`` (captured against eager,
``sssp_device_check`` clean on all three, ``check_sssp`` on the max-degree
root at the default delta, both deltas equal), each
superstep's device time beside its byte bound; SSSP and CC segmented into
at most 8 epochs, each also killed at boundary 2 and resumed, bit-identical
with no capture; ``registry_sssp`` and ``registry_cc`` (push and pull) twice
each on the serve phase's registry; at R-MAT scale 15 SSSP packed16 against
unpacked against the heapq ``dijkstra`` and CC against
``union_find_labels``; ``path_graph(600)`` through the truncation fallback;
and ``graph500_run.main`` at scale 16 twice on one run journal (the second
skips the scale), with the ``trace`` of ``python -m bfs_tpu_torch.obs``
stitching the first run's spans.  Every run's control steps are held
to its supersteps issued and added to the ``loop_control`` row.

The streamed MXU arm (``bfs_tpu_torch.stream``) closes the s22 part, once
every resident MXU engine is freed: ``RelayEngine(tiles_mode="stream")``
(its tiles built on the card, cut into pinned host slabs per column
superblock and fingerprinted, the card's copy released; the device memory
it holds beside the resident MXU engine's), ``mxu_expand`` through
``out=`` on superblock slabs against the plain per-superblock expansion,
``run_streamed`` for the max-degree root under a 4 GiB
cache (oracle-exact, equal to the dense MXU arm, the schedule the host's
recomputation, evictions counted, ``mxu_expand`` launched once per
demanded superblock and ``packed_update`` once per pull level), one
all-pull search at the default 1 GiB budget with each level's bytes, its
copy rate beside a timed 1 GiB pinned copy and the share of copy time
hidden under ``mxu_expand`` (CUDA events), ``run_segmented`` at
``every:2`` killed at boundary 2 and resumed with a cold cache
(bit-identical), and each streamed run's device peak against held bytes
+ budget + one largest slab + the candidate grid + a stated margin.

The label tier and the fleet router follow the query server on the same
graph (``labels_phase``, ``fleet_phase``): ``BFS_TPU_TORCH_LABELS=64`` on a
pull server (the cold build: the 64-root sweep on the registry's pull engine
and the sidecar bundle; a warm re-register from it), 256 point queries held
against the batch's trees, the method and landmark against the certificate
and the device bounds against ``host_label_bounds``, paths walked on the host
CSR, sampled verification, a budget reject, and the latency of a label
answer idle and behind a running pull tick of 32, and of an exact answer;
then the load generator's fleet mode (``bfs_tpu_torch.tools.
serve_loadgen.run_fleet``) on ``FleetRouter(replicas=2)`` warm-hitting
that sidecar, 4 threads of
single-source and point queries with a rolling re-register mid-load, a
replica closed directly (failover), and every replica killed.  Between
the server and the label tier, the load generator's classic mode
(``loadgen_phase``) runs on a relay server: buckets 1–32 warmed, then 200
requests from 8 threads, every reply against the batch's trees, a steady
executable-cache hit rate of 1.0, and the relay kernels' launches held to
the supersteps the ticks issued; the metrics registry's Prometheus text
is parsed line by line after the server phase.

The analysis package closes the s22 part (ROADMAP A15's resilience
drivers and A16).  After the gather main path, ``guard_phase`` runs one
search under ``BFS_TPU_TORCH_TRANSFER_GUARD=1`` in a guarded region
(torch's sync-debug mode ``error``; the loop's control reads, the inputs'
upload and the result's copy are explicit transfers) and an ``.item()`` in
``guarded_region("smoke.canary")``, which must raise naming the region; the
server phase serves a warm relay tick of 4 and a pull tick of 32 under the
same guard.  After the streamed arm the chaos driver's three modes start
together (``start_chaos``), each a process of its own
(``bfs_tpu_torch.tools.chaos_run``), with ``cache_warm``'s cold run and,
once it exits, its warm run (``start_cache_warm``), and run beside the
command line and the small-graph checks; ``chaos_phase`` then holds them to
their verdicts: ``serve`` at the reference's full
schedule (scale 9, 12 healthy requests) under
``BFS_TPU_TORCH_LOCK_ORDER=1``, which must exit 0 with a lock-order graph
that has edges and no cycle; one ``traversal`` iteration of ``relay`` and
one of ``sharded`` (8 shards stacked on the card, per-shard epochs), each
killed at a superstep boundary and resumed from an epoch bit for bit; one
``loadgen`` iteration at scale 10.  ``cache_warm_phase`` waits for
``cache_warm --tiles --compile`` at scale 16 cold and warm, where the warm
run's every artifact (relay and tiles bundles, kernel
libraries, the arm probe's verdict) must be a hit, then holds
``verify_tiles_bundle`` ok, and ``absent`` once a field is corrupted.
``registry_phase`` runs every kernel of ``analysis/kernels.py`` at lint
scale against its plain version, and the ``kernels`` line is read from that
registry: the script fails if a registry kernel was not held against its
plain version in the run.

Every search and the batch run on the level loop on the card: blocks of
gated supersteps replayed from a CUDA graph (``bfs_tpu_torch/models/loop.py``).
Each path is also run on the eager loop (a host read per level) and held
against it bit for bit; the script prints per search the host reads,
replays, supersteps issued and live, and the loop and result seconds of
both loops, checks launches = per-superstep count x supersteps issued and
live supersteps = levels, traces both, times a dead superstep, the two
result-copy designs and (relay) blocks of 1, 4, 8 and 16 supersteps, and prints
the loop's targets as met or not met.

Output: progress lines, the card's name and power limit as nvidia-smi gives
them, one ``{"kernels": [...]}`` JSON line, and as the last line
``{"ok": true, "device": {...}}``.  Any failed phase raises and the script
exits non-zero; without a CUDA device it exits non-zero before any phase.
"""

from __future__ import annotations

import argparse
import atexit
import json
import os
import shutil
import sys
import tempfile
import time

T_PROCESS = time.perf_counter()  # the script's start, before torch is imported
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, data-sheet peak
FP16_TENSOR_OPS_PER_S = 989e12  # H100 SXM dense fp16 tensor cores, data-sheet peak
EDGE_FACTOR = 6  # the repo bench's R-MAT family: Graph500 a/b/c, edge factor 6
GRAPH_SEED = 1
ROOTS = 4
BATCH = 64  # BASELINE.json config 5: 64 sources, two groups of 32 trees
SOURCE = "bfs_tpu_torch/csrc/relay_kernels.cu"
ELEM_SOURCE = "bfs_tpu_torch/csrc/relay_elem_kernels.cu"
MXU_SOURCE = "bfs_tpu_torch/csrc/relay_mxu_kernels.cu"
TILES_BUDGET = 32 << 30  # the s22 layout takes 21 GB; the default budget is 4 GiB
ORACLE_SCALE = 16  # the tile builder against the host oracle (82 MB of tiles)
PARITY_SCALE = 18  # the device layout builder against the host builder
REPLACES = {
    "benes_local_pass": "bfs_tpu/ops/relay_pallas.py:455",
    "benes_outer_pass": "bfs_tpu/ops/relay_pallas.py:618",
    "class_rowmin": "bfs_tpu/ops/relay_pallas.py:1059",
    "packed_update": "bfs_tpu/ops/relay_pallas.py:1188",
    # XLA in the reference: the fused loop's condition changed & (level < cap)
    "loop_control": "bfs_tpu/models/bfs.py:637",
}
ELEM_BUILD = ("benes_elem_local_pass", "benes_elem_outer_stage")  # the route index
ELEM_REPLACES = {
    "benes_elem_local_pass": "bfs_tpu/ops/relay_pallas.py:860",
    "benes_elem_outer_stage": "bfs_tpu/ops/relay_pallas.py:860",
    # both K5 networks and the broadcast between them, in the level loop
    "elem_route_gather": "bfs_tpu/ops/relay_pallas.py:860",
    # the same route: the frontier interleaved for the gather (G = 2)
    "elem_frontier_interleave": "bfs_tpu/ops/relay_pallas.py:860",
    # XLA in the reference: rowmin_elem (:186) and the update (:258)
    "elem_rowmin_update": "bfs_tpu/ops/relay_elem.py:186",
}
MXU_REPLACES = {"mxu_expand": "bfs_tpu/ops/relay_mxu.py:373"}
# The registry's batch kernels (the lock-step batch's Beneš passes), held in
# lockstep_kernel_phase; every other registry kernel in the kernel phases.
BATCH_SPECS = ("benes_local_group_kernel", "benes_outer_group_kernel")
# Each launched once per batch superstep at G = 2 on the block loop.
LOOP_KERNELS = ("elem_frontier_interleave", "elem_route_gather", "elem_rowmin_update",
                "loop_control")
# Per superstep of each single-source block loop (the eager loop launches
# the same but the control step).
GATHER_STEP = {"benes_outer_pass": 4, "benes_local_pass": 2, "class_rowmin": 1,
               "packed_update": 1, "loop_control": 1}
MXU_STEP = {"mxu_expand": 1, "packed_update": 1, "loop_control": 1}
# A push or pull superstep is torch ops (XLA in the reference, no TPU
# kernel); of the port's kernels its block loop launches the control step.
EDGE_STEP = {"loop_control": 1}
# Block sizes of the push and pull engines' table (``loop.EDGE_BLOCK``).
EDGE_KS = (1, 2, 4)
# The relay SuperstepRunner's eager step: both networks, the row-min and
# the packed update, no control step.
RELAY_RUNNER_STEP = {k: v for k, v in GATHER_STEP.items() if k != "loop_control"}
# bfs_multi on push and pull runs the first EDGE_BATCH sources of the batch
# (64 until the sharded phase came in: 32 pays for the batches' eager runs).
EDGE_BATCH = 32
# Superstep checkpoints: relay segments of CKPT_EVERY supersteps; the
# segmented push batch and serve tick take CKPT_MULTI sources in segments of
# CKPT_MULTI_EVERY.
CKPT_EVERY = 2
CKPT_MULTI = 8
CKPT_MULTI_EVERY = 4
# The lock-step batch (RelayEngine.run_multi): the gather arm at serve's
# relay buckets of 4 and 16 (below the element-major 32), its kernels on
# the last size's trees; the MXU arm at 4.
LOCKSTEP_S = (4, 16)
LOCKSTEP_MXU_S = (4,)
# The measured arm selection's cell (ROADMAP A7): R-MAT s18 at edge factor
# 64 (Graph500 a/b/c, graph seed 1) on a torch-routed layout, where the
# tiles fit the default 4 GiB budget, so a default engine probes both arms.
SHARDS = 4  # the sharded phase's mesh: 4 shards stacked on the one card
SHARDED_BATCH = 8  # batch sources of bfs_sharded_multi on the (2, 2) mesh
EAGER_BATCH = 8  # sources of the push and pull batches' eager run
EXCHANGE_ARMS = ("flat", "bitmap", "delta", "auto")
PROBE_SCALE = 18
PROBE_EDGE_FACTOR = 64
PROBE_TREES = 16


def log(msg: str) -> None:
    print(msg, flush=True)


def max_abs_err(a, b) -> int:
    """Largest difference of two uint32 word tensors (int32 patterns)."""
    import torch

    from bfs_tpu_torch.ops.packed import u32

    if torch.equal(a, b):
        return 0
    return int((u32(a) - u32(b)).abs().max().item())


def gate_check(name: str, fn, out, want, dead) -> None:
    """``fn(ctl)`` with a live control block writes ``want`` into ``out``;
    with a dead one (``dead``) it writes nothing."""
    import torch

    from bfs_tpu_torch.ops import control as C

    live = C.new_ctl(out.device)
    C.init_ctl(live, 62)
    fn(live)
    err = max_abs_err(out, want)
    if err:
        raise AssertionError(f"{name}: gated (live) launch differs from the ungated one (max err {err})")
    out.fill_(7)
    fn(dead)
    torch.cuda.synchronize()
    if not bool((out == 7).all()):
        raise AssertionError(f"{name}: a dead superstep's launch wrote its output")


def dead_ctl(device):
    """A control block whose superstep is not live (converged at level 3)."""
    from bfs_tpu_torch.ops import control as C

    ctl = C.new_ctl(device)
    C.init_ctl(ctl, 62)
    ctl[C.LEVEL], ctl[C.CHANGED], ctl[C.LIVE] = 3, 0, 0
    return ctl


def device_trace(label: str, fn, wall_s: float, expect: str | None = None) -> float | None:
    """Trace one more call of ``fn`` with ``torch.profiler`` (CUPTI) and
    print the card's busy time in it, its idle share against the traced
    call's own host seconds (the untraced ``wall_s`` of the same work is
    printed beside it: the result copy's time differs between the two
    calls, so against ``wall_s`` the share can fall below zero), and the
    device time per kernel name.  Busy time is the union of the device
    activity intervals (kernels and copies).  ``expect``: a kernel name the
    call launches (inside graph replays on the block loop); if the trace
    holds none of it, one more call is bracketed by CUDA events instead.
    Returns the idle share (None when nothing was recorded)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t_wall = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    if not spans:
        log("device trace: the profiler recorded no device activity; "
            "idle share not measured")
        return None
    busy_us, end, per_name = 0.0, float("-inf"), {}
    for a, b, name in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
        per_name[name] = per_name.get(name, 0.0) + (b - a)
    busy_s = busy_us * 1e-6
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
    idle = 1.0 - busy_s / traced_s
    seen = sum(1 for _, _, n in spans if expect and expect in n)
    log(f"device trace, {label}: {len(spans)} device activities, busy "
        f"{busy_s:.6f} s of the traced {traced_s:.6f} s (untraced {wall_s:.6f} s): "
        f"idle share {idle:.4f}; device ms by name: "
        + ", ".join(f"{n[:40]} {t * 1e-3:.4f}" for n, t in top)
        + (f"; {seen} {expect} launches recorded" if expect else "")
        + f"; the trace took {time.perf_counter() - t_wall:.2f} s of wall time")
    if expect and not seen:
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        log(f"device trace, {label}: the profiler recorded no {expect} launch inside the "
            f"graph replays; CUDA events around one more call span {t0.elapsed_time(t1):.4f} ms")
    return idle


def host_trace(label: str, fn, top: int = 8) -> dict:
    """Trace one call of ``fn`` with ``torch.profiler`` and print the host
    time by event name, the ``top`` largest (self CPU ms and calls): the
    CUDA runtime calls (``cudaHostAlloc``, ``cudaStreamSynchronize``,
    ``cudaMemcpyAsync``, ``cudaGraphLaunch``) and the aten ops, which say
    where a result path's host time goes.  Returns {name: self ms}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    rows = sorted(((e.key, e.self_cpu_time_total * 1e-3, e.count) for e in prof.key_averages()),
                  key=lambda r: -r[1])[:top]
    log(f"host trace, {label}: traced {traced_s:.6f} s; host self ms by event: "
        + ", ".join(f"{k[:40]} {ms:.4f} ({n})" for k, ms, n in rows))
    return {k: ms for k, ms, _ in rows}


def kernel_phase(eng, K, R, card: str) -> dict:
    """Each kernel against its plain version on the card, on the inputs the
    main path gives it at the superstep with the largest frontier; each loop
    kernel also timed gated by a live control block (``gated_ms``), checked
    equal to its ungated launch, and checked to write nothing when the
    superstep is dead; then the control step ``loop_control``."""
    import torch

    from bfs_tpu_torch.ops import control as C
    from bfs_tpu_torch.tools.superstep_phases import largest_superstep, phase_fns
    from bfs_tpu_torch.utils.timing import cold_ms

    rg = eng.relay_graph
    dev = eng.device
    s = largest_superstep(eng)
    log(f"kernel inputs: superstep {s.level + 1}, frontier {s.count} vertices")
    fw, l2 = s.fw, s.l2
    n, table, masks = rg.net_size, rg.net_table, eng.net_masks
    pre, local, suf, tile = K.split_passes(table, n)
    nw = n // 32
    results = {}
    live_ctl = C.new_ctl(dev)
    C.init_ctl(live_ctl, 62)
    dead = dead_ctl(dev)

    def record(name, err, ms, plain_ms, nbytes, shape, kernel=None, share=1, gated_ms=None):
        """``kernel``: the wrapper whose launch count the row reads (default
        ``name``); the row's launches are that count over ``share``."""
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from its plain version (max err {err})")
        results[name] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_bytes=nbytes,
            shape=shape, kernel=kernel or name, share=share, gated_ms=gated_ms,
        )
        gate = "" if gated_ms is None else f", gated by a live control block {gated_ms:.4f} ms"
        log(f"kernel {name}: {shape}; bit-exact; {ms:.4f} ms{gate} "
            f"(plain {plain_ms:.4f} ms, bound {results[name]['bound_ms']:.4f} ms "
            f"from {nbytes} bytes at 3.35 TB/s) on {card}")

    # Whole networks, kernel route vs plain (both networks of the path).
    for name, words, m, tb, size in (
        ("vperm", fw, eng.vperm_masks, rg.vperm_table, rg.vperm_size),
        ("net", l2, masks, table, n),
    ):
        got = K.apply_benes(words, m, tb, size)
        want = R.apply_benes_std(words, m, tb, size)
        err = max_abs_err(got, want)
        if err:
            raise AssertionError(f"{name} network: kernels differ from plain (max err {err})")
        log(f"network {name}: n={size}, {len(tb)} stages, kernels bit-exact vs plain")

    # How much of the local runs' stored masks lies inside each stage's
    # nonzero range [lo, hi): the local pass skips a stage on a tile whose
    # slab lies outside it, as the reference's pass B does.
    for name, tb, size in (("vperm", rg.vperm_table, rg.vperm_size), ("net", table, n)):
        _, loc, _, t = K.split_passes(tb, size)
        words = inside = slabs = live = 0
        for st in (tb[i] for i in loc):
            words += st.nwords
            inside += st.hi - st.lo
            span = t // 2 if st.compact else t
            for a in range(0, st.nwords, span):
                slabs += 1
                live += a < st.hi and a + span > st.lo
        log(f"local run of {name}: {inside / words:.6f} of its {words} stored mask words "
            f"inside the stages' nonzero ranges; {live} of {slabs} tile slabs touch one")

    # benes_outer_pass: the net's outer prefix, one launch.
    runs = K.outer_plan(table, pre, n)
    if len(runs) != 1:
        raise AssertionError(f"net prefix: {len(runs)} outer passes, expected one")
    run = runs[0]
    pstages = tuple(table[i] for i in run.stages)
    out = torch.empty_like(l2)
    got = K.benes_outer_pass(l2, masks, pstages, n, out=out)
    want = R.apply_benes_std(l2, masks, pstages, n)
    err = max_abs_err(got, want)
    ms = cold_ms(lambda: K.benes_outer_pass(l2, masks, pstages, n, out=out), 50)
    gms = cold_ms(lambda: K.benes_outer_pass(l2, masks, pstages, n, out=out, ctl=live_ctl), 50)
    gate_check("benes_outer_pass",
               lambda c: K.benes_outer_pass(l2, masks, pstages, n, out=out, ctl=c), out, want, dead)
    pms = cold_ms(lambda: R.apply_benes_std(l2, masks, pstages, n), 10)
    nbytes = 2 * 4 * nw + 4 * sum(st.nwords for st in pstages)
    record("benes_outer_pass", err, ms, pms, nbytes,
           f"net n={n} prefix, {run.k} stages d={pstages[0].d}..{pstages[-1].d}, "
           f"{run.units} units of {run.row_words} x {1 << run.k} words (one launch per side)",
           gated_ms=gms)
    # benes_local_pass: each network's local run, on its prefix's output;
    # each network launches it once per superstep, so each row takes half
    # of the wrapper's count.
    for name, words, m, tb, size, row in (
        ("vperm", fw, eng.vperm_masks, rg.vperm_table, rg.vperm_size, "benes_local_pass (vperm)"),
        ("net", l2, masks, table, n, "benes_local_pass"),
    ):
        p_, loc, _, t = K.split_passes(tb, size)
        x = R.apply_benes_std(words, m, tuple(tb[i] for i in p_), size)
        stages = tuple(tb[i] for i in loc)
        out = torch.empty_like(x)
        got = K.benes_local_pass(x, m, stages, size, t, out=out)
        want = R.apply_benes_std(x, m, stages, size)
        err = max_abs_err(got, want)
        ms = cold_ms(lambda: K.benes_local_pass(x, m, stages, size, t, out=out), 50)
        gms = cold_ms(lambda: K.benes_local_pass(x, m, stages, size, t, out=out, ctl=live_ctl), 50)
        gate_check(row, lambda c: K.benes_local_pass(x, m, stages, size, t, out=out, ctl=c),
                   out, want, dead)
        pms = cold_ms(lambda: R.apply_benes_std(x, m, stages, size), 5)
        # Bytes: the words read and written once, and the mask words inside
        # each stage's nonzero range (the kernel reads no other).
        nbytes = 2 * 4 * (size // 32) + 4 * sum(st.hi - st.lo for st in stages)
        record(row, err, ms, pms, nbytes,
               f"{name} n={size}, {len(stages)} local stages, tile {t} words, "
               f"{size // 32 // t} blocks; launches: this network's passes",
               kernel="benes_local_pass", share=2, gated_ms=gms)
        del x, out, got, want

    # class_rowmin on the routed L1 words.
    l1 = s.l1
    valid = eng.valid_words
    got = K.rowmin_ranks(l1, valid, rg.in_classes, rg.vr)
    want = R.rowmin_ranks(l1, valid, rg.in_classes, rg.vr)
    err = max_abs_err(got, want)
    ms = cold_ms(lambda: K.rowmin_ranks(l1, valid, rg.in_classes, rg.vr), 50)
    rbuf = torch.empty_like(got)
    gms = cold_ms(lambda: K.rowmin_ranks(l1, valid, rg.in_classes, rg.vr, out=rbuf, ctl=live_ctl), 50)
    gate_check("class_rowmin",
               lambda c: K.rowmin_ranks(l1, valid, rg.in_classes, rg.vr, out=rbuf, ctl=c),
               rbuf, got, dead)
    pms = cold_ms(lambda: R.rowmin_ranks(l1, valid, rg.in_classes, rg.vr), 5)
    # Bound: the bytes that a row-min stopping at first hits still moves on
    # this superstep (from the plain ranks); the full read beside it.
    class_words = sum((c.sb - c.sa) // 32 for c in rg.in_classes)
    full = 2 * 4 * class_words + 4 * rg.vr
    record("class_rowmin", err, ms, pms, R.early_exit_bytes(want, rg.in_classes),
           f"vr={rg.vr}, {len(rg.in_classes)} classes, {class_words} slot words; bound: "
           "the slot and valid words up to the first hits, the ranks", gated_ms=gms)
    results["class_rowmin"]["full_read_bound_ms"] = full / HBM_BYTES_PER_S * 1e3
    log(f"kernel class_rowmin: the full read's bound {full / HBM_BYTES_PER_S * 1e3:.4f} ms "
        f"({full} bytes: every slot word and valid word, the ranks) on {card}")
    del want
    items, blocks = K.rowmin_items(tuple(rg.in_classes), rg.vr, str(dev))[:2]
    log(f"class_rowmin work table: {items.shape[0]} items, {blocks} blocks of "
        f"{K.ROWMIN_THREADS} threads; (kind, width, count, chunks x rows): "
        + ", ".join(f"({k}, {w}, {c}, {ch}x{r})" for k, _, c, _, w, ch, r, _ in items.tolist()))
    cand = got

    # packed_update on that superstep's carry.
    st_in = R.PackedRelayState(s.packed, s.fwords, s.level, None)
    want = R.apply_relay_candidates_packed(st_in, cand)
    got = K.apply_relay_candidates_packed(st_in._replace(packed=s.packed.clone()), cand)
    err = max(max_abs_err(got.packed, want.packed), max_abs_err(got.fwords, want.fwords))
    if bool(got.changed.item()) != bool(want.changed):
        raise AssertionError("packed_update: changed flag differs from the plain version")
    scratch = R.PackedRelayState(s.packed.clone(), s.fwords, s.level, None)
    fout = torch.empty_like(s.fwords)
    ms = cold_ms(lambda: K.apply_relay_candidates_packed(scratch, cand, fwords_out=fout), 50)
    gms = cold_ms(lambda: K.apply_relay_candidates_packed(scratch, cand, fwords_out=fout,
                                                          ctl=live_ctl), 50)
    # Gated at the superstep's own level: live equals the ungated update,
    # and dead writes neither the words nor the frontier nor the flag.
    at = C.new_ctl(dev)
    C.init_ctl(at, 62)
    at[C.LEVEL] = s.level
    for ctl, want_st in ((at, want), (dead, st_in)):
        work = st_in._replace(packed=s.packed.clone())
        fw = torch.full_like(s.fwords, 7)
        K.apply_relay_candidates_packed(work, cand, fwords_out=fw, ctl=ctl)
        same = max_abs_err(work.packed, want_st.packed)
        same_fw = max_abs_err(fw, want.fwords) if ctl is at else int(not bool((fw == 7).all()))
        flag = int(ctl[C.FLAG])
        if same or same_fw or flag != (int(bool(want.changed)) if ctl is at else 0):
            raise AssertionError(f"packed_update: gated launch wrong ({'live' if ctl is at else 'dead'})")
    pms = cold_ms(lambda: R.apply_relay_candidates_packed(st_in, cand), 10)
    nbytes = 3 * 4 * rg.vr + rg.vr // 8 + 4
    record("packed_update", err, ms, pms, nbytes, f"vr={rg.vr}", gated_ms=gms)

    # loop_control: the control step, against its plain version on live,
    # converging, capped and dead blocks.
    cases = []
    for level, changed, live_w, cap, flag in ((0, 1, 1, 62, 1), (4, 1, 1, 62, 0),
                                              (61, 1, 1, 62, 1), (3, 0, 0, 62, 0)):
        c = C.new_ctl(dev)
        c[C.LEVEL], c[C.CHANGED], c[C.LIVE], c[C.CAP], c[C.FLAG] = level, changed, live_w, cap, flag
        cases.append(c)
    err = max(max_abs_err(K.loop_control(c.clone()), C.loop_control(c.clone())) for c in cases)
    work = cases[0].clone()
    ms = cold_ms(lambda: K.loop_control(work), 50)
    pms = cold_ms(lambda: C.loop_control(work), 50)
    record("loop_control", err, ms, pms, 2 * 4 * 6,
           "the six words of one control block; 1 thread")

    # One superstep at this frontier, phase by phase (kernel route).
    phases = phase_fns(eng, s)
    times = {k: cold_ms(f, 10) for k, f in phases.items()}
    log("superstep phases (ms, cold L2): " + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))
    results["phases"] = times
    return results


def loop_phase(label: str, eng, roots, per_step: dict, expect: str, K, L) -> dict:
    """One arm's main path on the block loop (captured and replayed), each
    search timed alone with its loop and result seconds, host reads,
    replays, supersteps issued and live; launches held to the
    per-superstep count times the supersteps issued, live supersteps to
    ``num_levels`` and host reads to the target.  Then the eager loop (a
    host read per level) on the same roots, bit for bit against the
    captured loop's results; both traced; and the cost of a dead superstep
    (a block replayed after convergence, which must change nothing)."""
    import numpy as np
    import torch

    eng.loop = "blocks"
    eng.run(roots[0])  # warm: the capture, caches and allocator
    k = eng._packed_loop().k
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    results, rows = {}, []
    for r in roots:
        t0 = time.perf_counter()
        res = eng.run(r)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        run = dict(eng.last_run)
        target = -(-(res.num_levels + 1) // k) + 1
        if run["live"] != res.num_levels:
            raise AssertionError(f"{label} root {r}: {run['live']} live supersteps, "
                                 f"{res.num_levels} levels")
        if run["host_reads"] > target:
            raise AssertionError(f"{label} root {r}: {run['host_reads']} host reads > {target}")
        # A pageable copy is kept (untimed) and the result itself dropped, as
        # a caller that takes one result at a time drops it: its pinned
        # blocks are then reused (result_designs times both regimes).
        results[r] = type(res)(dist=res.dist.copy(), parent=res.parent.copy(),
                               num_levels=res.num_levels)
        del res
        rows.append(dict(root=r, secs=secs, **run))
        log(f"{label} root {r}, captured loop (k={k}): {secs:.6f} s (level loop "
            f"{run['loop_s']:.6f} s, results {run['result_s']:.6f} s), {run['level']} levels; "
            f"host reads {run['host_reads']} (target <= {target}), replays {run['replays']}, "
            f"supersteps issued {run['issued']}, live {run['live']}")
    launches = {k: K.LAUNCHES[k] for k in per_step}
    issued = sum(row["issued"] for row in rows)
    if launches != {k: v * issued for k, v in per_step.items()}:
        raise AssertionError(f"{label}: launches {launches} in {issued} supersteps issued, "
                             f"expected {per_step} per superstep")
    peak = torch.cuda.max_memory_allocated()

    eng.loop = "eager"
    eng.run(roots[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    eager = []
    for r in roots:
        t0 = time.perf_counter()
        res = eng.run(r)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        run = dict(eng.last_run)
        want = results[r]
        if not (np.array_equal(res.dist, want.dist) and np.array_equal(res.parent, want.parent)
                and res.num_levels == want.num_levels):
            raise AssertionError(f"{label} root {r}: the captured loop differs from the eager loop")
        eager.append(dict(root=r, secs=secs, **run))
        log(f"{label} root {r}, eager loop: {secs:.6f} s (level loop {run['loop_s']:.6f} s, "
            f"results {run['result_s']:.6f} s), host reads {run['host_reads']}; equal to the "
            "captured loop bit for bit")
        del res
    eager_steps = sum(row["issued"] for row in eager)
    eager_launches = {k: K.LAUNCHES[k] for k in per_step}
    want = {k: (0 if k == "loop_control" else v * eager_steps) for k, v in per_step.items()}
    if eager_launches != want:
        raise AssertionError(f"{label} eager: launches {eager_launches}, expected {want}")
    eager_peak = torch.cuda.max_memory_allocated()
    idle = {"captured": [], "eager": []}
    for i, (row, erow) in enumerate(zip(rows, eager)):
        r = row["root"]
        eng.loop = "blocks"
        idle["captured"].append(device_trace(f"{label} root {r}, captured", lambda: eng.run(r),
                                             row["secs"], expect))
        if i == 0:  # the eager loop traced on the first root only
            eng.loop = "eager"
            idle["eager"].append(device_trace(f"{label} root {r}, eager", lambda: eng.run(r),
                                              erow["secs"]))
    eng.loop = "blocks"
    dead = dead_superstep_ms(label, eng._packed_loop())
    mean = {k: float(np.mean([row[k] for row in rows])) for k in ("secs", "loop_s", "result_s")}
    emean = {k: float(np.mean([row[k] for row in eager])) for k in ("secs", "loop_s", "result_s")}
    log(f"{label}: {len(roots)} searches; captured loop mean {mean['secs']:.6f} s/search "
        f"(loop {mean['loop_s']:.6f}, results {mean['result_s']:.6f}), eager loop "
        f"{emean['secs']:.6f} (loop {emean['loop_s']:.6f}, results {emean['result_s']:.6f}); "
        f"peak device memory {peak} bytes captured, {eager_peak} eager; launches {launches} in "
        f"{issued} supersteps issued ({sum(row['live'] for row in rows)} live)")
    return dict(results=results, rows=rows, eager=eager, launches=launches, peak=peak,
                eager_peak=eager_peak, idle=idle, dead_ms=dead, mean=mean, eager_mean=emean)


def dead_superstep_ms(label: str, loop) -> float:
    """Device ms of one dead superstep: the loop's captured block replayed
    after its run converged (LIVE 0), timed by CUDA events, over its k;
    the carry must come out unchanged."""
    import torch

    before = [b.clone() for b in loop.buffers]
    loop.dead_replay()
    pairs = []
    for _ in range(10):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        loop.dead_replay()
        t1.record()
        pairs.append((t0, t1))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(before, loop.buffers)):
        raise AssertionError(f"{label}: a dead block changed the carry or its control block")
    ms = sum(a.elapsed_time(b) for a, b in pairs) / len(pairs) / loop.k
    log(f"{label}: one dead superstep {ms:.6f} ms (a block of {loop.k} replayed after "
        "convergence, CUDA events, mean of 10); the carry unchanged")
    return ms


def block_table(label: str, run, L, eng, reps: int = 3, ks=(1, 4, 8, 16),
                attr: str = "BLOCK", eager: bool = False) -> list:
    """``run()`` (one search per root, or one batch) at blocks of each k in
    ``ks`` supersteps (the loop module's ``attr``, the engine's block
    size), each k captured anew after a warm call, and (``eager``) on the
    eager loop: mean host seconds, loop seconds and host reads.  The loops
    of other k are dropped after."""
    import numpy as np
    import torch

    keep = getattr(L, attr)
    rows = []
    t_wall = time.perf_counter()
    for k in (*ks, *(("eager",) if eager else ())):
        if k == "eager":
            eng.loop = "eager"
        else:
            setattr(L, attr, k)
        run()
        secs, loops, reads = [], [], []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loop_s, host_reads = run()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            loops.append(loop_s)
            reads.append(host_reads)
        rows.append(dict(k=k, secs=float(np.mean(secs)), loop_s=float(np.mean(loops)),
                         host_reads=float(np.mean(reads))))
    eng.loop = "blocks"
    setattr(L, attr, keep)
    eng._loops = {key: v for key, v in eng._loops.items() if key[1] == keep}
    torch.cuda.empty_cache()
    log(f"{label}, block size table (mean of {reps} runs): " + "; ".join(
        f"k={r['k']}: {r['secs']:.6f} s, loop {r['loop_s']:.6f} s, {r['host_reads']:g} host reads"
        for r in rows) + f"; the table took {time.perf_counter() - t_wall:.2f} s of wall time")
    return rows


def result_designs(eng, root: int, reps: int = 5) -> dict:
    """The single search's result copy, two designs on the same device
    arrays (``to_original_device``), in turns: fresh pinned result arrays
    (the engine's ``to_host``: PyTorch's caching host allocator, which
    reuses the block of a freed result) against a reused pinned staging
    buffer copied on into fresh pageable arrays (torch's CPU copy, on
    several threads); each with every result dropped before the next copy
    (a caller that takes one result at a time) and with every result kept.
    Host ms, mean of ``reps`` after one warm call."""
    import numpy as np
    import torch

    from bfs_tpu_torch.models.bfs import to_host

    st = eng.run_many_device([root])[0]
    d, p = eng.to_original_device(st, root)
    stage = [torch.empty(d.shape, dtype=torch.int32, pin_memory=True) for _ in range(2)]

    def staged():
        for h, t in zip(stage, (d, p)):
            h.copy_(t, non_blocking=True)
        torch.cuda.current_stream().synchronize()
        return [torch.empty(h.shape, dtype=h.dtype).copy_(h).numpy() for h in stage]

    want = d.cpu().numpy()
    ms = {}
    for regime in ("dropped", "kept"):
        keep, times = [], {"pinned": [], "staged": []}
        for _ in range(reps + 1):
            for name, fn in (("pinned", lambda: to_host(d, p)), ("staged", staged)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                times[name].append(time.perf_counter() - t0)
                if not np.array_equal(out[0], want):
                    raise AssertionError(f"result copy ({name}) differs")
                if regime == "kept":
                    keep.append(out)
                del out
        ms.update({f"{k} {regime}": float(np.mean(v[1:])) * 1e3 for k, v in times.items()})
        del keep
    log(f"single-search result copy ({2 * d.numel() * 4} bytes), host ms, mean of {reps} after "
        "one warm call: " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
        + " (pinned: fresh pinned result arrays, the engine's; staged: a reused pinned buffer, "
        "then fresh pageable arrays; dropped / kept: earlier results freed / alive)")
    return ms


def tree_count(words) -> int:
    """Set bits of an int32 element tensor: trees at their vertices."""
    return sum(int(((words >> t) & 1).sum()) for t in range(32))


def rows_needed(visited, found, rp, in_classes, offsets):
    """int64[G, vr]: how many of its class's rows, in row order, each
    (group, vertex) must read on these inputs to know every unvisited
    tree's minimum row: none where all 32 trees are visited; else up to
    the largest such minimum (from the plain tournament's rank planes), or
    all ``width`` rows where an unvisited tree is found in none."""
    import torch

    g, vr = visited.shape
    need = torch.zeros((g, vr), dtype=torch.int64, device=visited.device)
    for cs in in_classes:
        off, nb = offsets[cs.va]
        vis = visited[:, cs.va : cs.vb]
        planes = rp[:, off : off + nb * cs.count].reshape(g, nb, cs.count)
        last = torch.zeros((g, cs.count), dtype=torch.int64, device=visited.device)
        for t in range(32):
            rank = torch.zeros_like(last)
            for j in range(nb):
                rank |= ((planes[:, j] >> t) & 1).long() << j
            open_t = ((vis >> t) & 1) == 0
            last = torch.where(open_t, torch.maximum(last, rank + 1), last)
        all_found = (found[:, cs.va : cs.vb] | vis) == -1
        need[:, cs.va : cs.vb] = torch.where(
            vis == -1, 0, torch.where(all_found, last, cs.width)
        )
    return need


def elem_kernel_phase(eng, sources, K, RE, card: str) -> dict:
    """The route index against the one the plain networks build, and each
    element-major kernel against its plain version on the card, on the
    inputs the multi-source path gives it at the superstep with the most
    trees in the frontier (G = 2 groups of 32 trees).  The K5 kernels are
    held on the networks' inputs of that superstep: they now run only in
    the index build, which routes one group."""
    import numpy as np
    import torch

    from bfs_tpu_torch.ops import control as C
    from bfs_tpu_torch.utils.timing import cold_ms

    rg = eng.relay_graph
    dev = eng.device
    groups = len(sources) // 32
    live_ctl = C.new_ctl(dev)
    C.init_ctl(live_ctl, 32)
    dead = dead_ctl(dev)
    _, pt = RE.rank_plane_layout(rg.in_classes)
    st = RE.init_elem_state(rg.vr, rg.old2new[sources].reshape(groups, 32), pt, dev)
    best = None
    while bool(st.changed) and st.level <= RE.MAX_ELEM_LEVELS:
        count = tree_count(st.frontier)
        if best is None or count > best[0]:
            best = (count, RE.ElemState(*(t.clone() for t in st[:4]), st.level, None))
        st = eng.superstep_elem(st)  # updates st in place on the card
    count, st0 = best
    del st
    log(f"elem kernel inputs: superstep {st0.level + 1}, {count} (tree, vertex) "
        f"pairs in the frontier, G={groups}")

    # The route index: the engine's (built by the K5 kernels in the batch's
    # first call), built again by the kernels (timed, as set-up) and by the
    # plain networks on the card; all three equal bit for bit.
    n = rg.net_size
    src = eng.route_index()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = RE.route_index(eng.routed_elem, rg.vr, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = RE.route_index(lambda x: eng.routed_elem(x, benes=RE.apply_benes_elem), rg.vr, dev)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    err = max(max_abs_err(src, plain), max_abs_err(again, plain))
    if err:
        raise AssertionError(f"route index: the K5 kernels' index differs from the plain one (max err {err})")
    lo, hi, fed = int(src.min()), int(src.max()), int((src >= 0).sum())
    if lo < -1 or hi >= rg.vr:
        raise AssertionError(f"route index: values in [{lo}, {hi}], outside [-1, {rg.vr})")
    log(f"route index: int32[{n}], {4 * n} bytes on the card, set-up: built through the K5 "
        f"kernels in {build_s:.4f} s (the plain networks on the card: {plain_s:.4f} s), "
        f"equal bit for bit; {fed} slots fed, values in [{lo}, {hi}]")
    del again, plain

    fw = torch.zeros((groups, rg.vperm_size), dtype=torch.int32, device=dev)
    fw[:, : rg.vr] = st0.frontier
    table, masks = rg.net_table, eng.net_masks
    y = K.apply_benes_elem(fw, eng.vperm_masks, rg.vperm_table, rg.vperm_size)
    l2 = RE.broadcast_l2_elem(y, rg.out_classes, n)
    results = {}

    def record(name, err, ms, plain_ms, nbytes, shape, per_step, library_ms=None,
               gated_ms=None):
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from its plain version (max err {err})")
        results[name] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_bytes=nbytes,
            shape=shape, per_superstep=per_step, library_ms=library_ms, gated_ms=gated_ms,
        )
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        gate = "" if gated_ms is None else f" (gated by a live control block {gated_ms:.4f} ms)"
        log(f"kernel {name}: {shape}; bit-exact; {ms:.4f} ms per launch{gate}, cold L2 "
            f"(plain {plain_ms:.4f} ms, index_select {lib}, bound "
            f"{results[name]['bound_ms']:.4f} ms from {nbytes} bytes at 3.35 TB/s); "
            f"{per_step} launches per superstep; on {card}")

    def perm_index(stages):
        """The element permutation that ``stages`` apply, from the plain
        network on an iota row (untimed): ``out[:, j] = x[:, idx[j]]``, so
        one ``index_select`` computes the same function."""
        iota = torch.arange(n, dtype=torch.int32, device=dev)[None]
        return RE.apply_benes_elem(iota, masks, stages, n)[0].long()

    def library_ms(x, stages, want, reps):
        """Cold-L2 ms of ``index_select`` over ``stages``' permutation,
        checked against ``want``.  Timed here only: the port never calls
        it."""
        idx = perm_index(stages)
        buf = torch.empty_like(x)
        if not torch.equal(torch.index_select(x, 1, idx, out=buf), want):
            raise AssertionError("index_select over the network's permutation differs")
        return cold_ms(lambda: torch.index_select(x, 1, idx, out=buf), reps)

    # Whole networks, kernel route vs plain (both networks of the path).
    splits = {}
    for name, x, m, tb, size in (
        ("vperm", fw, eng.vperm_masks, rg.vperm_table, rg.vperm_size),
        ("net", l2, masks, table, n),
    ):
        err = max_abs_err(K.apply_benes_elem(x, m, tb, size), RE.apply_benes_elem(x, m, tb, size))
        if err:
            raise AssertionError(f"elem {name} network: kernels differ from plain (max err {err})")
        splits[name] = K.split_elem_passes(tb, size)
        pre, local, suf, tile = splits[name]
        log(f"elem network {name}: n={size} x G={groups}, {len(tb)} stages "
            f"({len(pre)} + {len(suf)} outer around {len(local)} local, tile {tile} "
            f"elements), kernels bit-exact vs plain")
    outer_per_step = sum(len(v[0]) + len(v[2]) for v in splits.values())
    elem_bytes = 4 * groups * n

    pre, local, suf, tile = splits["net"]
    if not pre:
        raise AssertionError("network too small to have outer stages; use --scale >= 16")
    st1 = table[pre[0]]
    out = torch.empty_like(l2)
    want = RE.apply_benes_elem(l2, masks, (st1,), n)
    err = max_abs_err(K.benes_elem_outer_stage(l2, masks, st1, n, out=out), want)
    ms = cold_ms(lambda: K.benes_elem_outer_stage(l2, masks, st1, n, out=out), 50)
    pms = cold_ms(lambda: RE.apply_benes_elem(l2, masks, (st1,), n), 5)
    lms = library_ms(l2, (st1,), want, 50)
    record("benes_elem_outer_stage", err, ms, pms, 2 * elem_bytes + 4 * st1.nwords,
           f"net n={n} x G={groups}, d={st1.d}; launched only by the route index build "
           f"(G=1, {outer_per_step} launches)", 0, lms)

    x = l2
    for i in pre:
        x = RE.apply_benes_elem(x, masks, (table[i],), n)
    stages = tuple(table[i] for i in local)
    want = RE.apply_benes_elem(x, masks, stages, n)
    err = max_abs_err(K.benes_elem_local_pass(x, masks, stages, n, tile, out=out), want)
    ms = cold_ms(lambda: K.benes_elem_local_pass(x, masks, stages, n, tile, out=out), 20)
    pms = cold_ms(lambda: RE.apply_benes_elem(x, masks, stages, n), 3)
    lms = library_ms(x, stages, want, 20)
    record("benes_elem_local_pass", err, ms, pms,
           2 * elem_bytes + 4 * sum(t.nwords for t in stages),
           f"net n={n} x G={groups}, {len(stages)} local stages, tile {tile} elements; "
           "launched only by the route index build (G=1, 2 launches)", 0, lms)
    del x, want

    # The whole net network: the kernels' route against one index_select.
    want = K.apply_benes_elem(l2, masks, table, n, out=out)
    ms = cold_ms(lambda: K.apply_benes_elem(l2, masks, table, n, out=out), 10)
    lms = library_ms(l2, table, want, 10)
    results["net_network"] = dict(ms=ms, library_ms=lms)
    log(f"elem net network, all {len(table)} stages: kernels {ms:.4f} ms, one "
        f"index_select over its permutation {lms:.4f} ms (cold L2, on {card})")
    del want, out
    torch.cuda.empty_cache()

    # elem_route_gather: the superstep's route in one launch, against the
    # plain gather and the networks themselves; one index_select over the
    # frontier with a zero column appended is its library yardstick.
    f = st0.frontier
    l1 = K.apply_benes_elem(l2, masks, table, n)  # through the networks
    del l2
    # elem_frontier_interleave: the frontier as [vr, G] for the gather.
    ft = K.elem_frontier_interleave(f)
    err = max_abs_err(ft, RE.interleave_frontier(f))
    ftbuf = torch.empty_like(ft)
    ms = cold_ms(lambda: K.elem_frontier_interleave(f, out=ftbuf), 50)
    gms = cold_ms(lambda: K.elem_frontier_interleave(f, out=ftbuf, ctl=live_ctl), 50)
    gate_check("elem_frontier_interleave",
               lambda c: K.elem_frontier_interleave(f, out=ftbuf, ctl=c), ftbuf, ft, dead)
    pms = cold_ms(lambda: RE.interleave_frontier(f), 50)
    # Bytes: the frontier read and written once; the plain version is one
    # torch call (a transposed copy), so it is the library time too.
    record("elem_frontier_interleave", err, ms, pms, 2 * 4 * groups * rg.vr,
           f"vr={rg.vr} x G={groups}", 1, pms, gms)
    got = K.elem_route_gather(f, src, frontier_t=ft)
    err = max_abs_err(got, RE.route_gather(f, src))
    if not torch.equal(got, l1):
        raise AssertionError("elem_route_gather differs from the route through the networks")
    buf = torch.empty_like(got)
    ms = cold_ms(lambda: K.elem_route_gather(f, src, out=buf, frontier_t=ft), 50)
    gms = cold_ms(lambda: K.elem_route_gather(f, src, out=buf, frontier_t=ft, ctl=live_ctl), 50)
    gate_check("elem_route_gather",
               lambda c: K.elem_route_gather(f, src, out=buf, frontier_t=ft, ctl=c), buf, got, dead)
    both_ms = cold_ms(lambda: K.elem_route_gather(f, src, out=buf), 50)
    pms = cold_ms(lambda: RE.route_gather(f, src), 5)
    fpad = torch.cat([f, f.new_zeros((groups, 1))], dim=1)
    idx = torch.where(src >= 0, src, rg.vr).long()
    if not torch.equal(torch.index_select(fpad, 1, idx, out=buf), got):
        raise AssertionError("index_select over the route index differs")
    lms = cold_ms(lambda: torch.index_select(fpad, 1, idx, out=buf), 50)
    del fpad, idx
    route_ms = cold_ms(lambda: eng.routed_elem(f), 10)
    # Bytes: the index read once, the slots written and the frontier read
    # once per group.
    record("elem_route_gather", err, ms, pms, 4 * n + elem_bytes + 4 * groups * rg.vr,
           f"net n={n} x G={groups} from vr={rg.vr}", 1, lms, gms)
    results["route"] = dict(networks_ms=route_ms, build_s=build_s, plain_build_s=plain_s,
                            interleave_and_gather_ms=both_ms)
    log(f"elem route of one superstep: elem_frontier_interleave + elem_route_gather "
        f"{both_ms:.4f} ms (the gather alone {ms:.4f}) against {route_ms:.4f} ms through the "
        f"networks and the broadcast (K5 kernels; cold L2, on {card})")
    del got, buf, ft, ftbuf
    torch.cuda.empty_cache()

    # elem_rowmin_update on the routed L1 elements of that superstep.
    valid = eng.valid_words
    offsets, _ = RE.rank_plane_layout(rg.in_classes)
    found, rp = RE.rowmin_elem(l1, valid, rg.in_classes, rg.vr, offsets, pt)
    want = RE.apply_elem_found(st0, found, rp, rg.in_classes, offsets)
    need = rows_needed(st0.visited, found, rp, rg.in_classes, offsets)
    del found, rp
    work = RE.ElemState(*(t.clone() for t in st0[:4]), st0.level, None)
    got = K.elem_rowmin_update(l1, valid, work, rg.in_classes, rg.vr)
    err = max(max_abs_err(a, b) for a, b in zip(got[:4], want[:4]))
    if bool(got.changed.item()) != bool(want.changed):
        raise AssertionError("elem_rowmin_update: changed flag differs from the plain version")

    def restore():
        for dst, orig in zip(work[:4], st0[:4]):
            dst.copy_(orig)

    ms = cold_ms(lambda: K.elem_rowmin_update(l1, valid, work, rg.in_classes, rg.vr), 20,
                 prep=restore)
    fbuf = torch.empty_like(st0.frontier)
    gms = cold_ms(lambda: K.elem_rowmin_update(l1, valid, work, rg.in_classes, rg.vr,
                                               frontier_out=fbuf, ctl=live_ctl), 20, prep=restore)
    # Gated at the superstep's own level: live equals the plain update (the
    # frontier written in place of the one routed); dead changes nothing.
    at = C.new_ctl(dev)
    C.init_ctl(at, 32)
    at[C.LEVEL] = st0.level
    for ctl, want_st in ((at, want), (dead, st0)):
        restore()
        fbuf.copy_(st0.frontier)
        K.elem_rowmin_update(l1, valid, work._replace(frontier=fbuf), rg.in_classes, rg.vr,
                             frontier_out=fbuf, ctl=ctl)
        errs = [max_abs_err(a, b) for a, b in zip((work.visited, fbuf, work.dist_planes,
                                                   work.rank_planes), want_st[:4])]
        flag = int(ctl[C.FLAG])
        if any(errs) or flag != (int(bool(want.changed)) if ctl is at else 0):
            raise AssertionError(f"elem_rowmin_update: gated launch wrong ({errs}, flag {flag})")

    def plain():
        f, r = RE.rowmin_elem(l1, valid, rg.in_classes, rg.vr, offsets, pt)
        return RE.apply_elem_found(st0, f, r, rg.in_classes, offsets)

    pms = cold_ms(plain, 3)
    # Bytes the row-min/update must move on these inputs: visited read and
    # frontier written once; the class rows each (group, vertex) needs
    # (rows_needed) and the valid bits of those rows read; visited, the set
    # dist planes and the rank planes of newly reached vertices read and
    # written.
    width = torch.zeros(rg.vr, dtype=torch.int64, device=dev)
    nbits = torch.zeros(rg.vr, dtype=torch.int64, device=dev)
    for cs in rg.in_classes:
        width[cs.va : cs.vb] = cs.width
        nbits[cs.va : cs.vb] = offsets[cs.va][1]
    unfinished = st0.visited != -1
    newly = want.frontier != 0
    lev_bits = bin((st0.level + 1) & ((1 << RE.DIST_PLANES) - 1)).count("1")
    rows = int(need.sum())
    nbytes = (
        2 * 4 * groups * rg.vr
        + 4 * rows
        + int(need.max(dim=0).values.sum()) // 8
        + int((newly * (4 + 8 * lev_bits + 8 * nbits)).sum())
    )
    items, blocks = K.elem_rowmin_items(tuple(rg.in_classes), rg.vr)
    rows_t = [r for r in items.tolist() if r[0] != 2]
    wide = max(rows_t, key=lambda r: r[4])
    rank = max((r for r in rows_t if r[0] == 0), key=lambda r: r[4])
    log(f"elem_rowmin_update work table: {len(rows_t)} class items, {blocks} blocks of "
        f"{K.ROWMIN_THREADS} threads per group; widest class (kind {wide[0]}, width {wide[4]}, "
        f"{wide[2]} vertices): {wide[7]} chunks x {wide[8]} rows; widest rank-major (width "
        f"{rank[4]}, {rank[2]} vertices): {rank[7]} chunks x {rank[8]} rows; (kind, width, "
        "count, chunks x rows): "
        + ", ".join(f"({r[0]}, {r[4]}, {r[2]}, {r[7]}x{r[8]})" for r in rows_t))
    record("elem_rowmin_update", err, ms, pms, nbytes,
           f"vr={rg.vr} x G={groups}, {len(rg.in_classes)} classes, "
           f"{int(unfinished.sum())} unfinished (group, vertex) pairs needing {rows} "
           f"class rows of their {int((unfinished * width).sum())}", 1, gated_ms=gms)
    del l1, want, got, work, st0, need
    torch.cuda.empty_cache()
    return results


def multi_source_phase(eng, g, sources, directed_traversed: int, K, RE, P, L) -> dict:
    """The multi-source main path: ``run_multi_elem_device`` for one batch,
    first on an engine that has run none (its launches counted: the K5
    kernels build the route index in the warm-up superstep, then each
    superstep launches one interleave, one gather, one row-min/update and
    the control step), then timed on the captured loop with its launches
    held to 4 x supersteps issued (no K5 launch), then on the eager loop
    (3 per level) bit for bit against it; both traced; the dead superstep;
    the extraction (two designs); the block size table; and the results
    (``run_multi_elem``) checked tree by tree."""
    import numpy as np
    import torch

    per_step = dict.fromkeys(LOOP_KERNELS, 1)
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    st = eng.run_multi_elem_device(sources)  # builds the route index; captures
    level0, issued0 = st.level, eng.last_run["issued"]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    first = {k: K.LAUNCHES[k] for k in (*ELEM_REPLACES, "loop_control")}
    del st
    for name in ELEM_BUILD:
        if first[name] <= 0:
            raise AssertionError(f"the route index build never launched kernel {name}")
    for name in LOOP_KERNELS:
        if first[name] != issued0:
            raise AssertionError(f"first batch: {name} launched {first[name]} times in {issued0} "
                                 "supersteps issued")
    log(f"multi-source batch, first call (builds the route index, captures the block): "
        f"{first_s:.6f} s, {level0} levels, {issued0} supersteps issued; launches {first}")

    def timed(mode):
        eng.loop = mode
        eng.run_multi_elem_device(sources)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        t0 = time.perf_counter()
        st = eng.run_multi_elem_device(sources)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        return st, secs, dict(eng.last_run), {k: K.LAUNCHES[k] for k in (*ELEM_REPLACES, "loop_control")}, \
            torch.cuda.max_memory_allocated()

    st, secs, run, launches, peak = timed("blocks")
    level = st.level
    if st.changed:
        raise AssertionError("64-source batch did not converge within the elem level cap")
    want = dict.fromkeys(ELEM_BUILD, 0)
    want.update({name: run["issued"] for name in per_step})
    if launches != want or run["live"] != level:
        raise AssertionError(f"timed batch: launches {launches}, expected {want}; "
                             f"{run['live']} live supersteps in {level} levels")
    captured = [t.clone() for t in st[:4]]
    del st
    trees = len(sources)
    log(f"multi-source batch, captured loop (k={L.BLOCK}): {trees} sources, G={trees // 32}: "
        f"{secs:.6f} s per batch, {secs / trees:.6f} s per tree, "
        f"{trees * directed_traversed / 2 / secs:.6g} aggregate undirected TEPS "
        f"({directed_traversed // 2} undirected edges per tree), {level} levels; host reads "
        f"{run['host_reads']}, replays {run['replays']}, supersteps issued {run['issued']}, live "
        f"{run['live']}; peak device memory {peak} bytes; launches {launches}")
    est, esecs, erun, elaunches, epeak = timed("eager")
    want = dict.fromkeys(ELEM_BUILD, 0)
    want.update({name: level for name in LOOP_KERNELS if name != "loop_control"})
    want["loop_control"] = 0
    if elaunches != want or est.level != level:
        raise AssertionError(f"eager batch: launches {elaunches}, expected {want}")
    for a, b in zip(captured, est[:4]):
        if max_abs_err(a, b):
            raise AssertionError("64-source batch: the captured loop's state differs from the eager loop's")
    del est, captured
    log(f"multi-source batch, eager loop: {esecs:.6f} s per batch, host reads "
        f"{erun['host_reads']}, peak device memory {epeak} bytes; state equal to the captured "
        "loop's bit for bit")
    idle = {}
    for mode, wall in (("blocks", secs), ("eager", esecs)):
        eng.loop = mode
        idle[mode] = device_trace(f"64-source batch, {'captured' if mode == 'blocks' else 'eager'}",
                                  lambda: eng.run_multi_elem_device(sources), wall,
                                  "elem_rowmin_update" if mode == "blocks" else None)
    eng.loop = "blocks"
    eng.run_multi_elem_device(sources)
    dead = dead_superstep_ms("64-source batch", eng._elem_loop(trees // 32))

    # run_multi_elem three times with each result dropped before the next
    # call (the caching host allocator reuses its pinned blocks), twice
    # with the results kept, once on the eager loop; then the staged design.
    splits, keep = {"dropped": [], "kept": [], "eager": []}, []
    for regime in ("dropped",) * 3 + ("kept",) * 2 + ("eager",):
        eng.loop = "eager" if regime == "eager" else "blocks"
        res = eng.run_multi_elem(sources)
        splits[regime].append(dict(eng.last_run))
        if res.num_levels != level:
            raise AssertionError("run_multi_elem level count differs from the timed batch")
        if regime != "dropped":
            keep.append(res)
        del res
    eng.loop = "blocks"
    res = keep[0]  # for the tree checks below
    staged_s = [staged_extract(eng, sources, RE, keep) for _ in range(2)]
    del keep[1:]
    log("run_multi_elem (level loop s, extraction s): " + "; ".join(
        f"{regime} " + ", ".join(f"({r['loop_s']:.6f}, {r['result_s']:.6f})" for r in rs)
        for regime, rs in splits.items())
        + " (dropped / kept: earlier results freed / alive; eager: the eager loop); the staged "
        "design (a reused pinned buffer, then fresh pageable arrays), results kept: "
        + ", ".join(f"{x:.6f} s" for x in staged_s))

    def one_batch():
        t0 = time.perf_counter()
        eng.run_multi_elem_device(sources)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, eng.last_run["host_reads"]

    table = block_table("64-source batch, one batch a run", one_batch, L, eng)
    # The lock-step batch of the same sources (what run_multi_elem falls
    # back to past 31 levels): the first call captures its size.
    eng.run_multi(sources)
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    lock = eng.run_multi(sources)
    torch.cuda.synchronize()
    lock_s = time.perf_counter() - t0
    lock_run = dict(eng.last_run)
    lock_launches = {k: K.LAUNCHES[k] for k in GATHER_STEP}
    if (lock_launches != {k: v * lock_run["issued"] for k, v in GATHER_STEP.items()}
            or lock.num_levels != level):
        raise AssertionError(f"64-source lock-step batch: launches {lock_launches} in "
                             f"{lock_run['issued']} supersteps, {lock.num_levels} levels")
    t0 = time.perf_counter()
    for i, s in enumerate(sources.tolist()):
        one = eng.run(s)
        for name, r in (("element-major", res), ("lock-step", lock)):
            if not (np.array_equal(r.dist[i], one.dist) and np.array_equal(r.parent[i], one.parent)):
                raise AssertionError(f"{name} tree {i} (source {s}): differs from the "
                                     "single-source search")
        verify(f"relay batch tree {i}", res.dist[i], res.parent[i], s)
    del lock
    log(f"lock-step batch of the same {trees} sources (run_multi): {lock_s:.6f} s (level loop "
        f"{lock_run['loop_s']:.6f} s, results {lock_run['result_s']:.6f} s), {lock_run['issued']} "
        f"supersteps issued, launches {lock_launches}; all {trees} trees of both batches equal "
        f"the port's single-source RelayEngine.run bit for bit ({time.perf_counter() - t0:.1f} s)")
    # The first tree of the first group and the last of the second (every
    # tree is held against run and the DeviceChecker above).
    for i in (0, trees - 1):
        s = int(sources[i])
        dist, parent = P.canonical_bfs(g, s)
        if not (np.array_equal(res.dist[i], dist) and np.array_equal(res.parent[i], parent)):
            raise AssertionError(f"tree {i} (source {s}): differs from canonical_bfs")
        violations = P.check(g, res.dist[i], res.parent[i], s) if i == 0 else []
        if violations:
            raise AssertionError(f"tree {i}: check() violations {violations[:3]}")
    log(f"trees 0 and {trees - 1}: oracle-exact; check() clean on tree 0")
    return dict(launches={k: first[k] for k in ELEM_REPLACES}, lock_launches=lock_launches,
                lock_s=lock_s, lock_run=lock_run, secs=secs, eager_secs=esecs, levels=level,
                peak=peak,
                eager_peak=epeak, run=run, idle=idle, dead_ms=dead, splits=splits,
                staged_s=staged_s, table=table, result=res)


def staged_extract(eng, sources, RE, keep: list) -> float:
    """Host seconds of the batch extraction by the other design: each chunk
    decoded on the device as the engine decodes it, copied into one reused
    pinned staging buffer, and from there into fresh pageable arrays
    (torch's CPU copy); ``keep`` holds the results alive.  Checked against
    the engine's extraction."""
    import numpy as np
    import torch

    st = eng.run_multi_elem_device(sources)
    rg = eng.relay_graph
    tables = eng._rank_tables_device()
    want = RE.extract_results(st, rg, sources, eng.old2new, eng.src_l1, tables)
    src = torch.from_numpy(sources.astype(np.int64)).to(eng.device)
    stage = torch.empty((2, RE.EXTRACT_TREES, rg.num_vertices), dtype=torch.int32,
                        pin_memory=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = torch.empty((2, len(sources), rg.num_vertices), dtype=torch.int32)
    for gi, a, b, row in RE._chunks(len(sources)):
        n = b - a
        d, p = RE.decode_trees(st, rg, gi, a, b, tables)
        d, p = d[:, eng.old2new], RE.slots_to_parent(p, eng.src_l1)[:, eng.old2new]
        t = torch.arange(n, device=eng.device)
        d[t, src[row:row + n]] = 0
        p[t, src[row:row + n]] = src[row:row + n].to(torch.int32)
        stage[0, :n].copy_(d, non_blocking=True)
        stage[1, :n].copy_(p, non_blocking=True)
        torch.cuda.current_stream().synchronize()
        out[:, row:row + n].copy_(stage[:, :n])
    secs = time.perf_counter() - t0
    keep.append(out)
    if not (np.array_equal(out[0].numpy(), want[0]) and np.array_equal(out[1].numpy(), want[1])):
        raise AssertionError("staged extraction differs from the engine's")
    return secs


def small_multi_checks(P, tiny) -> None:
    """tinyCG with 32 sources, and path(100) with 32 sources, which is
    deeper than the elem distance planes and takes the lock-step
    fallback; every tree against canonical_bfs."""
    import numpy as np

    for name, graph, sources in (
        ("tinyCG", tiny, np.arange(32, dtype=np.int32) % tiny.num_vertices),
        ("path_graph(100)", P.path_graph(100), (np.arange(32, dtype=np.int32) * 37) % 100),
    ):
        eng = P.RelayEngine(graph)
        fell_back = bool(eng.run_multi_elem_device(sources).changed)
        res = eng.run_multi_elem(sources)
        eng.loop = "eager"
        eager = eng.run_multi_elem(sources)
        if not (np.array_equal(res.dist, eager.dist) and np.array_equal(res.parent, eager.parent)
                and res.num_levels == eager.num_levels):
            raise AssertionError(f"{name}: the captured loop differs from the eager loop")
        for i, s in enumerate(sources.tolist()):
            dist, parent = P.canonical_bfs(graph, s)
            if not (np.array_equal(res.dist[i], dist) and np.array_equal(res.parent[i], parent)):
                raise AssertionError(f"{name}: tree {i} (source {s}) differs from canonical_bfs")
        if fell_back != (name != "tinyCG"):
            raise AssertionError(f"{name}: fallback to run_multi {'not ' * (not fell_back)}taken")
        log(f"{name}, 32 sources: {res.num_levels} levels"
            f"{' through the lock-step fallback' if fell_back else ''}, oracle-exact, captured "
            "loop equal to the eager loop")


# ------------------------------------------------ the lock-step batch --

def lockstep_phase(label: str, eng, g, sources, sizes, per_step: dict, expect: str, K, P, L,
                   oracle: dict | None = None) -> dict:
    """``RelayEngine.run_multi`` (the lock-step batch: the S trees in one
    level loop, each kernel of the superstep one launch for the batch) at
    each batch size S in ``sizes`` on the first S of ``sources``: the first
    call (the capture of that size), then a timed call with its peak device
    memory, its launches held to ``per_step`` (a single search's
    per-superstep count) x supersteps issued and its live supersteps to its
    levels; every tree against the single-source ``run`` (their summed
    seconds: the old design's S x ``run``); with ``oracle`` (source ->
    ``canonical_bfs`` result, computed by the main path) the first two
    trees of the largest batch against it, ``check()`` and the
    DeviceChecker; the eager loop bit for bit against
    the captured one; a dead superstep of the batch's loop; a device trace
    of the largest batch."""
    import numpy as np
    import torch

    rows, launched = {}, dict.fromkeys(per_step, 0)
    for S in sizes:
        batch = np.asarray(sources[:S], dtype=np.int32)
        eng.loop = "blocks"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run_multi(batch)  # the capture of this batch size
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        t0 = time.perf_counter()
        res = eng.run_multi(batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        run = dict(eng.last_run)
        peak = torch.cuda.max_memory_allocated()
        launches = {k: K.LAUNCHES[k] for k in per_step}
        want = {k: v * run["issued"] for k, v in per_step.items()}
        if launches != want or run["live"] != res.num_levels or run["unpacked_rerun"]:
            raise AssertionError(f"{label} S={S}: launches {launches} in {run['issued']} "
                                 f"supersteps issued, expected {per_step} per superstep; "
                                 f"{run['live']} live in {res.num_levels} levels")
        for k in per_step:
            launched[k] += launches[k]
        singles_s = 0.0
        for i, s in enumerate(batch.tolist()):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one = eng.run(s)
            singles_s += time.perf_counter() - t0
            if not (np.array_equal(res.dist[i], one.dist)
                    and np.array_equal(res.parent[i], one.parent)):
                raise AssertionError(f"{label} S={S}: tree {i} (source {s}) differs from run")
        eng.loop = "eager"
        eager = eng.run_multi(batch)
        eager_run = dict(eng.last_run)
        eng.loop = "blocks"
        if not (np.array_equal(eager.dist, res.dist) and np.array_equal(eager.parent, res.parent)
                and eager.num_levels == res.num_levels):
            raise AssertionError(f"{label} S={S}: the captured loop differs from the eager loop")
        dead = dead_superstep_ms(f"{label} S={S}", eng._packed_loop(trees=S))
        rows[S] = dict(first_s=first_s, secs=secs, singles_s=singles_s, peak=peak, run=run,
                       launches=launches, eager_s=eager_run["loop_s"] + eager_run["result_s"],
                       dead_ms=dead, result=res, sources=batch)
        log(f"{label} S={S}: first call (capture) {first_s:.6f} s; timed {secs:.6f} s (level "
            f"loop {run['loop_s']:.6f} s, results {run['result_s']:.6f} s), {res.num_levels} "
            f"levels, host reads {run['host_reads']}, replays {run['replays']}, supersteps "
            f"issued {run['issued']}, live {run['live']}; peak device memory {peak} bytes; "
            f"launches {launches} = per superstep {per_step} x {run['issued']}; every tree "
            f"equal to run, whose {S} searches took {singles_s:.6f} s (the old design); eager "
            f"loop {rows[S]['eager_s']:.6f} s, equal bit for bit")
    S = sizes[-1]
    top = rows[S]
    if oracle:
        for i in (0, 1):
            s = int(top["sources"][i])
            dist, parent = oracle[s]
            res = top["result"]
            # check() passed on these canonical trees in the main path.
            if not (np.array_equal(res.dist[i], dist) and np.array_equal(res.parent[i], parent)):
                raise AssertionError(f"{label} S={S}: tree {i} (source {s}) differs from "
                                     "canonical_bfs")
            verify(f"{label} S={S} tree {i}", res.dist[i], res.parent[i], s)
        log(f"{label} S={S}: trees 0 and 1 oracle-exact, the DeviceChecker clean")
    idle = device_trace(f"{label} S={S}, captured", lambda: eng.run_multi(top["sources"]),
                        top["secs"], expect)
    return dict(rows=rows, launches=launched, idle=idle)


def lockstep_kernel_phase(eng, sources, K, R, card: str) -> dict:
    """Each gather kernel of the lock-step superstep on S trees (the
    sources' batch) on the inputs the batch's own main path gives it at its
    superstep with the most frontier vertices: bit for bit against its
    plain batched version and against S single-tree launches, ONE launch
    per call; its time (cold L2) beside the S single launches' and the
    plain version's, and its bound: the masks (or the valid words) read
    once plus S times the words.  The Beneš passes (all four outer launches
    of a superstep and both local passes, at the batch's own split) and the
    row-min also on the first 4 trees, as serve's relay-4 tick runs them;
    the row-min with the trees a block of its batch kernel takes, bound by
    the bytes that an early exit at first hits still moves (the full read
    beside it)."""
    import numpy as np
    import torch

    from bfs_tpu_torch.utils.timing import cold_ms

    rg, dev = eng.relay_graph, eng.device
    S = len(sources)
    st = R.init_relay_batch(rg.vr, rg.old2new[np.asarray(sources)], dev, True)
    best = None
    while bool(st.changed):
        count = sum(int(R.unpack_std(f, rg.vr).sum()) for f in st.fwords)
        if best is None or count > best[0]:
            best = (count, st.packed.clone(), st.fwords.clone(), st.level)
        st = eng.superstep_packed(st)
    count, packed, fwords, level = best
    del st
    log(f"lock-step kernel inputs: {S} trees at superstep {level + 1}, {count} frontier "
        f"vertices in all")
    fw = torch.zeros((S, rg.vperm_size // 32), dtype=torch.int32, device=dev)
    fw[:, : rg.vr // 32] = fwords
    y = K.apply_benes(fw, eng.vperm_masks, rg.vperm_table, rg.vperm_size)
    l2 = R.broadcast_l2(y, rg.out_classes, rg.net_size, rg.out_space)
    l1 = K.apply_benes(l2, eng.net_masks, rg.net_table, rg.net_size)
    valid = eng.valid_words
    cand = K.rowmin_ranks(l1, valid, rg.in_classes, rg.vr)
    results = {}

    def check(name, kernel, trees, batch, singles, plain, nbytes, shape, plain_reps=2):
        """``batch()`` and ``singles()`` return the outputs (a tuple);
        ``plain()`` the plain version's."""
        torch.cuda.synchronize()
        K.reset_launches()
        got = batch()
        torch.cuda.synchronize()
        if K.LAUNCHES[kernel] != 1:
            raise AssertionError(f"{name}: {K.LAUNCHES[kernel]} launches for {trees} trees, "
                                 "expected 1")
        want = plain()
        err = max(max_abs_err(a, b) for a, b in zip(got, want))
        one = singles()
        err1 = max(max_abs_err(a, b) for a, b in zip(got, one))
        if err or err1:
            raise AssertionError(f"{name}: batched kernel differs from its plain version "
                                 f"(max err {err}) or from {trees} single launches ({err1})")
        ms = cold_ms(batch, 10)
        sms = cold_ms(singles, 5)
        pms = cold_ms(plain, plain_reps, warm=0)  # the comparison above warmed it
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        results[name] = dict(max_abs_err=err, ms=ms, singles_ms=sms, plain_ms=pms,
                             bound_ms=bound, bound_bytes=nbytes, shape=shape, trees=trees)
        log(f"lock-step kernel {name}: {shape}; bit-exact against the plain "
            f"version and {trees} single launches; 1 launch; {ms:.4f} ms (cold L2) against "
            f"{sms:.4f} ms for {trees} single launches (plain {pms:.4f} ms); bound {bound:.4f} "
            f"ms from {nbytes} bytes at 3.35 TB/s (shared operands once + {trees} x per-tree "
            f"words) on {card}")

    # The Beneš passes at the batch's split, each on the words the passes
    # before it give (the plain version chains them), at S and at 4 trees.
    for name, words, m, tb, size in (
        ("vperm", fw, eng.vperm_masks, rg.vperm_table, rg.vperm_size),
        ("net", l2, eng.net_masks, rg.net_table, rg.net_size),
    ):
        nw = size // 32
        t = K.batch_tile_words(size)
        pre, loc, suf, _ = K.split_passes(tb, size, t)
        lstages = tuple(tb[i] for i in loc)
        (loc_s, out_s), (loc_4, out_4) = K.batch_groups(S, t), K.batch_groups(4, t)
        log(f"lock-step Beneš passes ({name} n={size}): batch tile {t} words (the single "
            f"search's {K.tile_words_for(size)}); trees a block: local pass {loc_s} at {S} "
            f"trees and {loc_4} at 4, outer pass {out_s} at {S} and {out_4} at 4; "
            f"{len(pre)} + {len(suf)} outer stages, {len(lstages)} local")
        x_loc = R.apply_benes_std(words, m, tuple(tb[i] for i in pre), size)
        x_suf = R.apply_benes_std(x_loc, m, lstages, size)
        for trees in (S, 4):
            out, out1 = torch.empty_like(words[:trees]), torch.empty_like(words[:trees])
            for side, x, idx in (("prefix", words, pre), ("suffix", x_suf, suf)):
                x = x[:trees]
                for run in K.outer_plan(tb, idx, size):
                    ost = tuple(tb[i] for i in run.stages)
                    check(f"benes_outer_pass ({name} {side}), {trees} trees", "benes_outer_pass",
                          trees,
                          lambda: (K.benes_outer_pass(x, m, ost, size, out=out),),
                          lambda: (torch.stack([K.benes_outer_pass(x[i], m, ost, size,
                                                                   out=out1[i])
                                                for i in range(trees)]),),
                          lambda: (R.apply_benes_std(x, m, ost, size),),
                          4 * sum(st.hi - st.lo for st in ost) + trees * 2 * 4 * nw,
                          f"{name} n={size} {side}, {run.k} stages, {run.units} units of "
                          f"{run.row_words} x 2^{run.k} words x {trees} trees")
                    x = R.apply_benes_std(x, m, ost, size)
            x = x_loc[:trees]
            check(f"benes_local_pass ({name}), {trees} trees", "benes_local_pass", trees,
                  lambda: (K.benes_local_pass(x, m, lstages, size, t, out=out),),
                  lambda: (torch.stack([K.benes_local_pass(x[i], m, lstages, size, t,
                                                           out=out1[i])
                                        for i in range(trees)]),),
                  lambda: (R.apply_benes_std(x, m, lstages, size),),
                  4 * sum(st.hi - st.lo for st in lstages) + trees * 2 * 4 * nw,
                  f"{name} n={size}, {len(lstages)} local stages, tile {t} words, {nw // t} "
                  f"tiles x {trees} trees, {K.batch_groups(trees, t)[0]} trees a block",
                  plain_reps=1)
            del out, out1, x
        del x_loc, x_suf
    # The row-min at S and at 4 trees, as serve's relay-4 tick runs it. Its
    # bound: the bytes that an early exit at first hits still moves (each
    # tree's slot words up to its first hits, the valid words up to the
    # furthest tree's, the ranks; from the plain ranks); the full read beside.
    class_words = sum((c.sb - c.sa) // 32 for c in rg.in_classes)
    planes = K.rowmin_items(tuple(rg.in_classes), rg.vr, str(dev)).planes
    for trees in (S, 4):
        x = l1[:trees]
        rbuf, rbuf1 = torch.empty_like(cand[:trees]), torch.empty_like(cand[:trees])
        name = f"class_rowmin, {trees} trees"
        group = K.rowmin_group(trees, planes)
        early = R.early_exit_bytes(R.rowmin_ranks(x, valid, rg.in_classes, rg.vr),
                                   rg.in_classes)
        full = 4 * class_words + trees * (4 * class_words + 4 * rg.vr)
        check(name, "class_rowmin", trees,
              lambda: (K.rowmin_ranks(x, valid, rg.in_classes, rg.vr, out=rbuf),),
              lambda: (torch.stack([K.rowmin_ranks(x[i], valid, rg.in_classes, rg.vr,
                                                   out=rbuf1[i]) for i in range(trees)]),),
              lambda: (R.rowmin_ranks(x, valid, rg.in_classes, rg.vr),),
              early,
              f"vr={rg.vr}, {len(rg.in_classes)} classes x {trees} trees, {group} trees a "
              f"block ({planes} rank planes); bound: the early exit's bytes", plain_reps=1)
        results[name].update(group=group, full_read_bound_ms=full / HBM_BYTES_PER_S * 1e3)
        log(f"lock-step kernel {name}: {group} trees a block; the full read's bound "
            f"{results[name]['full_read_bound_ms']:.4f} ms ({full} bytes: the valid words "
            f"once, every tree's slot words, the ranks) beside the early exit's "
            f"{results[name]['bound_ms']:.4f} ms on {card}")
        del x, rbuf, rbuf1
    scratch, scratch1 = packed.clone(), packed.clone()
    fout, fout1 = torch.empty_like(fwords), torch.empty_like(fwords)

    # Each call updates its scratch words in place; a later call on the
    # updated words moves the same bytes (as kernel_phase times it).
    def batch_update():
        new = K.apply_relay_candidates_packed(R.PackedRelayState(scratch, fwords, level, None),
                                              cand, fwords_out=fout)
        return new.packed, new.fwords, new.changed.to(torch.int32)

    def single_updates():
        new = [K.apply_relay_candidates_packed(
            R.PackedRelayState(scratch1[i], fwords[i], level, None), cand[i],
            fwords_out=fout1[i]) for i in range(S)]
        flags = torch.stack([n.changed.reshape(-1)[0].to(torch.int32) for n in new])
        return (torch.stack([n.packed for n in new]), torch.stack([n.fwords for n in new]),
                flags.amax().reshape(1))

    def plain_update():
        new = R.apply_relay_candidates_packed(R.PackedRelayState(packed, fwords, level, None),
                                              cand)
        return new.packed, new.fwords, new.changed.reshape(1).to(torch.int32)

    check(f"packed_update, {S} trees", "packed_update", S, batch_update, single_updates,
          plain_update,
          S * (3 * 4 * rg.vr + rg.vr // 8) + 4, f"vr={rg.vr} x {S} trees", plain_reps=2)
    return results


def lockstep_mxu_kernel_check(meng, trees: list, K, RM, card: str) -> dict:
    """``mxu_expand`` on S trees in one launch (each live tile read once for
    the batch) at each tree's densest level (``trees``: its frontier words
    there and at level 1): against S single launches bit for bit, timed
    (cold L2) beside them, and against the plain batched expansion on the
    level-1 frontiers (the plain version at the densest levels would take
    tens of seconds a tree)."""
    import torch

    from bfs_tpu_torch.utils.timing import cold_ms

    ops, (rows, cols, rtp, vtp, _) = meng.mxu_operands, meng.mxu_geometry
    kw = dict(rows=rows, cols=cols, rtp=rtp, vtp=vtp)
    dense = torch.stack([d for d, _ in trees])
    sparse = torch.stack([s for _, s in trees])
    S = dense.shape[0]
    live = [int(RM.live_tiles(f, ops, rows=rows, rtp=rtp).numel()) for f in dense]
    union = dense[0].clone()
    for f in dense[1:]:
        union |= f
    shared = int(RM.live_tiles(union, ops, rows=rows, rtp=rtp).numel())
    K.reset_launches()
    got = K.expand_frontier_mxu(dense, ops, **kw)
    torch.cuda.synchronize()
    if K.LAUNCHES["mxu_expand"] != 1:
        raise AssertionError(f"mxu_expand: {K.LAUNCHES['mxu_expand']} launches for {S} trees")
    one = torch.stack([K.expand_frontier_mxu(f, ops, **kw) for f in dense])
    err1 = max_abs_err(got, one)
    err = max_abs_err(K.expand_frontier_mxu(sparse, ops, **kw),
                      RM.expand_frontier_mxu_plain(sparse, ops, **kw))
    if err or err1:
        raise AssertionError(f"mxu_expand, {S} trees: differs from the plain version (max err "
                             f"{err}) or from {S} single launches ({err1})")
    ms = cold_ms(lambda: K.expand_frontier_mxu(dense, ops, **kw), 3)
    sms = cold_ms(lambda: [K.expand_frontier_mxu(f, ops, **kw) for f in dense], 2)
    pms = cold_ms(lambda: RM.expand_frontier_mxu_plain(sparse, ops, **kw), 1, warm=1)
    nbytes = 2048 * shared + 16 * sum(live) + 4 * rows + S * 4 * cols
    nops = 262144 * sum(live)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = nops / FP16_TENSOR_OPS_PER_S * 1e3
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    log(f"lock-step kernel mxu_expand, {S} trees at their densest levels: {sum(live)} live "
        f"tiles in all, {shared} distinct (read once); bit-exact against {S} single launches, "
        f"and against the plain version on the level-1 frontiers; 1 launch; {ms:.4f} ms (cold "
        f"L2) against {sms:.4f} ms for {S} single launches (plain, level 1: {pms:.4f} ms); "
        f"bound {max(bytes_ms, ops_ms):.4f} ms by {bound_by} ({nbytes} bytes at 3.35 TB/s = "
        f"{bytes_ms:.4f} ms: tiles once + frontier blocks, keys, {S} outputs; {nops} "
        f"operations at 989 TFLOP/s dense fp16 = {ops_ms:.4f} ms) on {card}")
    return {"mxu_expand": dict(max_abs_err=err, ms=ms, singles_ms=sms, plain_ms=pms,
                               bound_ms=max(bytes_ms, ops_ms), bound_by=bound_by,
                               live=sum(live), shared=shared)}


def small_lockstep_checks(P, K) -> None:
    """path_graph(100) batched on both arms: the packed carry cut at 62
    levels, then the unpacked re-run, each through a captured loop; every
    tree against the oracle and the eager loop."""
    import numpy as np

    path = P.path_graph(100)
    sources = np.array([0, 37, 99], dtype=np.int32)
    for expansion in ("gather", "mxu"):
        eng = P.RelayEngine(path, expansion=expansion, sparse_hybrid=False)
        res = eng.run_multi(sources)
        run = dict(eng.last_run)
        eng.loop = "eager"
        eager = eng.run_multi(sources)
        if not run["unpacked_rerun"] or res.num_levels != 100 or run["live"] != 62 + 100:
            raise AssertionError(f"path_graph(100) lock-step {expansion}: {run}")
        for i, s in enumerate(sources.tolist()):
            dist, parent = P.canonical_bfs(path, s)
            for name, r in (("the oracle", None), ("the eager loop", eager)):
                d, p = (dist, parent) if r is None else (r.dist[i], r.parent[i])
                if not (np.array_equal(res.dist[i], d) and np.array_equal(res.parent[i], p)):
                    raise AssertionError(f"path_graph(100) lock-step {expansion}: tree {i} "
                                         f"differs from {name}")
        log(f"path_graph(100), lock-step batch of 3 on the {expansion} arm: 62 packed levels, "
            f"then the unpacked re-run to 100 ({run['live']} live supersteps, {run['replays']} "
            "replays); every tree oracle-exact and equal to the eager loop")


# ------------------------------------------------ the layout set-up --

def layout_parity_phase(P, generators) -> dict:
    """The device layout builder on the card against the host builder at
    R-MAT scale 18: byte-identical with the native route.  (The torch
    route is held against the bundle at the cell's scale in
    :func:`router_phase`.)"""
    import torch
    from bfs_tpu_torch.graph.relay import differing_fields

    g = generators.rmat_graph_native(PARITY_SCALE, EDGE_FACTOR, seed=GRAPH_SEED)
    secs, layouts = {}, {}
    for name, build in (
        ("host", lambda t: P.build_relay_graph(g, stage_times=t)),
        ("device", lambda t: P.build_relay_graph_device(g, route="native", stage_times=t)),
    ):
        t0 = time.perf_counter()
        layouts[name] = build({})
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    bad = differing_fields(layouts["host"], layouts["device"])
    if bad:
        raise AssertionError(f"layout s{PARITY_SCALE} (device): {bad} differ from the host "
                             "builder's")
    log(f"layout s{PARITY_SCALE}: V={g.num_vertices} directed E={g.num_edges}; device builder "
        "(native route) byte-identical to the host builder; seconds "
        + ", ".join(f"{k} {v:.3f}" for k, v in secs.items()))
    return secs


def stage_line(times: dict) -> str:
    return ", ".join(f"{k} {v:.3f}" for k, v in times.items() if isinstance(v, float))


def layout_phase(P, g, store: str) -> tuple:
    """The cell's relay layout as a user gets it: ``load_or_build_relay``
    into a fresh bundle store (a cold build by the device builder on the
    card, saved), then again (a warm hit, memmapped), the two byte for
    byte.  Returns the loaded layout and the numbers."""
    import numpy as np
    import torch
    from bfs_tpu_torch.graph.relay import differing_fields

    cache = P.LayoutCache(store)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    built, cold = P.load_or_build_relay(g, cache=cache)
    cold_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    held = torch.cuda.memory_allocated() - base
    stages = cold["build_stages"]
    if (cold["cache"], cold["builder"], stages["device"]) != (
            "miss", "device", f"cuda:{torch.cuda.current_device()}"):
        raise AssertionError(f"layout: expected a cold device build, got {cold}")
    bundle = os.path.join(store, cold["key"])
    bundle_bytes = sum(os.path.getsize(os.path.join(bundle, f)) for f in os.listdir(bundle))
    log(f"layout: cold load_or_build_relay {cold_s:.3f} s (build {cold['build_seconds']:.3f} s, "
        f"bundle save {cold['save_seconds']:.3f} s, {bundle_bytes} bytes); builder "
        f"{cold['builder']} on {stages['device']}, route {stages['route']}; stages "
        f"(s): {stage_line(stages)}; host syncs {stages['host_syncs']}; device memory peak "
        f"{peak} bytes during the build, {held} held after it")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rg, warm = P.load_or_build_relay(g, cache=cache)
    warm_s = time.perf_counter() - t0
    if warm["cache"] != "hit" or warm["builder"] != "device":
        raise AssertionError(f"layout: the second call was not a hit of the device build: {warm}")
    mapped = sorted(k for k, v in vars(rg).items()
                    if isinstance(v, np.ndarray) and isinstance(v.base, np.memmap))
    t0 = time.perf_counter()
    bad = differing_fields(built, rg)
    if bad:
        raise AssertionError(f"layout: bundle fields {bad} differ from the built layout")
    cmp_s = time.perf_counter() - t0
    log(f"layout: warm load_or_build_relay {warm_s:.6f} s (load {warm['load_seconds']:.6f} s; "
        f"memmapped {mapped}); every field byte-identical to the built layout "
        f"(compared in {cmp_s:.2f} s)")
    return rg, dict(cold_s=cold_s, warm_s=warm_s, build_s=cold["build_seconds"],
                    save_s=cold["save_seconds"], bundle_bytes=bundle_bytes, stages=stages,
                    peak=peak)


def router_phase(P, g, rg, stages: dict, root: int, oracle, K, R, card: str) -> dict:
    """Both Beneš routers on the cell's layout: the same layout built again
    with ``route="torch"``, its two route stages' seconds beside the native
    router's from the cold build; every non-mask field held against the
    loaded layout's, the dense engine on it oracle-exact from ``root``, and
    every K1-K4 kernel bit-exact against its plain version on its masks
    (:func:`kernel_phase`; these rows are not the report's)."""
    import numpy as np
    import torch
    from bfs_tpu_torch.graph.relay import MASK_FIELDS, differing_fields

    times: dict = {}
    t0 = time.perf_counter()
    trg = P.build_relay_graph_device(g, route="torch", stage_times=times)
    build_s = time.perf_counter() - t0
    diff = differing_fields(rg, trg)
    bad = [k for k in diff if k not in MASK_FIELDS]
    if bad:
        raise AssertionError(f"routers: the torch-routed layout's {bad} differ from the bundle's")
    same = {name: not any(k.startswith(f"{name}_") for k in diff) for name in ("net", "vperm")}
    eng = P.RelayEngine(trg, device="cuda", sparse_hybrid=False)
    res = eng.run(root)
    if not (np.array_equal(res.dist, oracle[0]) and np.array_equal(res.parent, oracle[1])):
        raise AssertionError(f"routers: the torch-routed layout's search from {root} differs "
                             "from canonical_bfs")
    log("routers: the kernel rows on the torch-routed layout follow (not the report's rows)")
    kernel_phase(eng, K, R, card)
    log("routers: end of the kernel rows on the torch-routed layout; all bit-exact")
    del eng, trg
    torch.cuda.empty_cache()
    out = {name: dict(torch_s=times[f"route_{name}"], native_s=stages[f"route_{name}"],
                      same=same[name]) for name in ("net", "vperm")}
    log(f"routers: the layout built with route='torch' in {build_s:.3f} s (stages (s): "
        f"{stage_line(times)}), every non-mask field equal to the bundle's, the dense search "
        f"from root {root} oracle-exact, every K1-K4 kernel bit-exact on it; "
        + "; ".join(
            f"{name} (n={rg.net_size if name == 'net' else rg.vperm_size}): torch route "
            f"{r['torch_s']:.3f} s, native (in the cold build) {r['native_s']:.3f} s; torch "
            f"masks {'equal to' if r['same'] else 'other than'} the native router's"
            for name, r in out.items()))
    return dict(out, build_s=build_s)


def tiles_oracle_check(P, generators, AT) -> None:
    """The device tile builder on the card against the numpy host oracle,
    byte for byte, on the R-MAT scale-16 relay layout."""
    import torch

    g = generators.rmat_graph_native(ORACLE_SCALE, EDGE_FACTOR, seed=GRAPH_SEED)
    rg = P.build_relay_graph(g)
    t0 = time.perf_counter()
    host = AT.build_adj_tiles_from_relay(rg, builder="host")
    t_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    dev = AT.build_adj_tiles_from_relay(rg, builder="device", device="cuda")
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    for f in ("tiles", "row_idx", "col_id", "keys2d"):
        if not torch.equal(getattr(dev, f).cpu(), getattr(host, f)):
            raise AssertionError(f"tiles s{ORACLE_SCALE}: device builder differs from the host oracle in {f}")
    if (dev.rows, dev.cols, dev.rtp, dev.vtp, dev.nt) != (host.rows, host.cols, host.rtp, host.vtp, host.nt):
        raise AssertionError(f"tiles s{ORACLE_SCALE}: device builder geometry differs from the host oracle")
    log(f"tiles s{ORACLE_SCALE}: vr={rg.vr}, directed E={g.num_edges}, nt={host.nt}, "
        f"{host.nt * AT.TILE_BYTES} tile bytes; device builder byte-identical to the host "
        f"oracle (device {t_dev:.3f} s, host {t_host:.3f} s)")


def mxu_engine(P, AT, rg, scale: int):
    """The MXU engine on the cell's graph: the tiles built on the card, timed, with the
    peak device memory of the build and the occupancy histogram.  Returns the engine and
    the device bytes it holds."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    meng = P.RelayEngine(rg, device="cuda", sparse_hybrid=False, expansion="mxu",
                         tiles_budget_bytes=TILES_BUDGET)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    at = meng.adj_tiles
    peak = torch.cuda.max_memory_allocated() - base
    held = torch.cuda.memory_allocated() - base
    log(f"tiles s{scale}: engine with expansion='mxu' in {secs:.2f} s (tile build and "
        f"shipping {meng.tiles_build_s:.3f} s); nt={at.nt}, ntp={at.ntp}, "
        f"{at.nt * AT.TILE_BYTES} tile bytes, layout {at.nbytes} bytes, "
        f"{at.vtp // AT.SB_VERTS} superblocks; device memory held {held} bytes, "
        f"peak during the build {peak} bytes (builder temporaries {peak - held})")
    t0 = time.perf_counter()
    hist = AT.tile_occupancy_hist(at)
    log(f"tiles s{scale}: occupancy ({time.perf_counter() - t0:.2f} s): {json.dumps(hist)}")
    return meng, held


def mxu_kernel_phase(eng, meng, root0: int, K, R, RM, card: str) -> dict:
    """``mxu_expand`` against its plain version on the card, on the
    frontier of the level of root0's search (the gather arm's) with the
    most live tiles."""
    from bfs_tpu_torch.ops import control as C
    from bfs_tpu_torch.utils.timing import cold_ms

    rg = eng.relay_graph
    ops, geo = meng.mxu_operands, meng.mxu_geometry
    rows, cols, rtp, vtp, ntp = geo
    kw = dict(rows=rows, cols=cols, rtp=rtp, vtp=vtp)
    st = R.init_packed_relay_state(rg.vr, int(rg.old2new[root0]), eng.device)
    frontiers = []
    while bool(st.changed):
        frontiers.append(st.fwords.clone())
        st = eng.superstep_packed(st)
    live = [int(RM.live_tiles(f, ops, rows=rows, rtp=rtp).numel()) for f in frontiers]
    level = max(range(len(live)), key=live.__getitem__)
    fw, t = frontiers[level], live[level]
    log(f"mxu kernel inputs: root {root0}, live tiles per superstep {live} of "
        f"{ntp}; superstep {level + 1} has the most")
    # The kernel's choice of path per live tile, counted here from the tiles
    # and the frontier: reachable bits at most MXU_SPARSE_MAX_BITS go sparse.
    bits = RM.reachable_bits(fw, ops, rows=rows, rtp=rtp)
    sparse = int((bits <= K.MXU_SPARSE_MAX_BITS).sum())
    log(f"mxu paths at superstep {level + 1}: {sparse} live tiles sparse (at most "
        f"{K.MXU_SPARSE_MAX_BITS} reachable bits), {t - sparse} on the tensor cores; "
        f"{int(bits.sum())} reachable bits, at most {int(bits.max())} in a tile")
    del bits
    got = K.expand_frontier_mxu(fw, ops, **kw)
    err = max_abs_err(got, RM.expand_frontier_mxu_plain(fw, ops, **kw))
    if err:
        raise AssertionError(f"mxu_expand: kernel differs from its plain version (max err {err})")
    ms = cold_ms(lambda: K.expand_frontier_mxu(fw, ops, **kw), 10)
    live_ctl = C.new_ctl(fw.device)
    C.init_ctl(live_ctl, 62)
    gms = cold_ms(lambda: K.expand_frontier_mxu(fw, ops, **kw, ctl=live_ctl), 10)
    if max_abs_err(K.expand_frontier_mxu(fw, ops, **kw, ctl=live_ctl), got):
        raise AssertionError("mxu_expand: gated (live) launch differs from the ungated one")
    if not bool((K.expand_frontier_mxu(fw, ops, **kw, ctl=dead_ctl(fw.device)) == -1).all()):
        raise AssertionError("mxu_expand: a dead superstep's launch wrote candidates")
    # One timed call of the plain expansion (2.5 s at s22), after the
    # comparison's call above.
    pms = cold_ms(lambda: RM.expand_frontier_mxu_plain(fw, ops, **kw), 1, warm=0)
    nbytes = 2064 * t + 4 * rows + 4 * cols
    nops = 262144 * t
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = nops / FP16_TENSOR_OPS_PER_S * 1e3
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    shape = (f"{t} live tiles of {ntp}, rows=cols={cols}, superstep {level + 1} "
             f"of root {root0}")
    log(f"kernel mxu_expand: {shape}; bit-exact; {ms:.4f} ms per launch (gated by a live "
        f"control block {gms:.4f} ms), cold L2 "
        f"(plain {pms:.4f} ms, library none, bound {max(bytes_ms, ops_ms):.4f} ms by "
        f"{bound_by}: {nbytes} bytes at 3.35 TB/s = {bytes_ms:.4f} ms, {nops} "
        f"operations at 989 TFLOP/s dense fp16 = {ops_ms:.4f} ms); "
        f"1 launch per superstep; on {card}")
    return {"mxu_expand": dict(
        max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=max(bytes_ms, ops_ms),
        bound_by=bound_by, bound_bytes=nbytes, library_ms=None, shape=shape, gated_ms=gms,
    )}


def mxu_main_path(meng, g, roots, want: dict, directed_traversed: int, K, P, L) -> dict:
    """The MXU arm's main path: ``RelayEngine(expansion="mxu").run`` for
    the 4 roots on the block loop against the eager loop
    (:func:`loop_phase`), each result against ``canonical_bfs`` and the
    gather arm's (``want``, whose trees passed ``check()``), the
    DeviceChecker clean; then its block size table."""
    import numpy as np

    mxu = loop_phase("mxu search", meng, roots, MXU_STEP, "mxu_expand", K, L)
    for r in roots:
        res = mxu["results"][r]
        (dist, parent), gather = want[r]
        for name, (d, p) in (("canonical_bfs", (dist, parent)),
                             ("the gather arm", (gather.dist, gather.parent))):
            if not (np.array_equal(res.dist, d) and np.array_equal(res.parent, p)):
                raise AssertionError(f"mxu root {r}: result differs from {name}")
        if res.num_levels != gather.num_levels:
            raise AssertionError(f"mxu root {r}: {res.num_levels} levels, gather arm {gather.num_levels}")
        verify(f"mxu root {r}", res.dist, res.parent, r)
    mean_s = mxu["mean"]["secs"]
    log(f"mxu path: all {len(roots)} roots equal to canonical_bfs and the gather arm, "
        f"DeviceChecker clean; {directed_traversed / 2 / mean_s:.6g} undirected TEPS (captured "
        "loop mean)")
    mxu["table"] = block_table("mxu search, 4 searches a run", lambda: searches(meng, roots), L, meng,
                               reps=1)
    return mxu


def searches(eng, roots) -> tuple[float, int]:
    """One search per root: summed loop seconds and host reads."""
    loop_s = reads = 0
    for r in roots:
        eng.run(r)
        loop_s += eng.last_run["loop_s"]
        reads += eng.last_run["host_reads"]
    return loop_s, reads


def small_path_check(P, K, expansion: str) -> None:
    """path_graph(100) from vertex 0 on one arm: 62 levels on the packed
    carry, stopped by its cap, then the unpacked re-run to 100; the
    captured loop against the eager loop and the oracle."""
    import numpy as np

    path = P.path_graph(100)
    eng = P.RelayEngine(path, expansion=expansion, sparse_hybrid=False)
    K.reset_launches()
    res = eng.run(0)
    run = dict(eng.last_run)
    launched = dict(K.LAUNCHES)
    eng.loop = "eager"
    eager = eng.run(0)
    dist, parent = P.canonical_bfs(path, 0)
    for name, d, p, levels in (("the oracle", dist, parent, 100),
                               ("the eager loop", eager.dist, eager.parent, eager.num_levels)):
        if not (np.array_equal(res.dist, d) and np.array_equal(res.parent, p)
                and res.num_levels == levels):
            raise AssertionError(f"path_graph(100) {expansion}: the captured loop differs from {name}")
    if run["live"] != 62 + 100 or res.num_levels != 100:
        raise AssertionError(f"path_graph(100) {expansion}: {run['live']} live supersteps")
    expand = "mxu_expand" if expansion == "mxu" else "class_rowmin"
    if launched[expand] != run["issued"]:
        raise AssertionError(f"path_graph(100) {expansion}: {launched[expand]} {expand} launches "
                             f"in {run['issued']} supersteps issued")
    log(f"path_graph(100), {expansion} arm: 62 packed levels then the unpacked re-run to 100, "
        f"through the captured loops (host reads {run['host_reads']}, replays {run['replays']}, "
        f"supersteps issued {run['issued']}, live {run['live']}); oracle-exact, equal to the "
        "eager loop")


def small_mxu_checks(P, tiny, K) -> None:
    """tinyCG and path_graph(100) through the MXU arm; the path takes the
    unpacked re-run through ``mxu_expand``."""
    res = P.RelayEngine(tiny, expansion="mxu").run(0)
    if (res.dist.tolist(), res.parent.tolist(), res.num_levels) != (
        [0, 1, 1, 2, 2, 1], [0, 0, 0, 2, 2, 0], 3
    ):
        raise AssertionError(f"tinyCG mxu: got {res.dist.tolist()} {res.parent.tolist()} {res.num_levels}")
    log("tinyCG through the MXU arm: oracle-exact")
    small_path_check(P, K, "mxu")


# ------------------------------------------------------- push and pull engines --

def edge_layouts(g, P) -> tuple:
    """The push engine's DeviceGraph and the pull engine's PullGraph (from
    the DeviceGraph, so the edges are sorted once), with host seconds."""
    t0 = time.perf_counter()
    dg = P.build_device_graph(g)
    t_dg = time.perf_counter() - t0
    t0 = time.perf_counter()
    pg = P.build_pull_graph(dg)
    t_pg = time.perf_counter() - t0
    log(f"push layout: DeviceGraph built in {t_dg:.3f} s on the host, {dg.padded_edges} padded "
        f"edges; pull layout: PullGraph built in {t_pg:.3f} s from it, ell0 {pg.ell0.shape}, "
        f"folds {[f.shape for f in pg.folds]}, {pg.padded_slots} slots")
    return dg, pg, {"device_graph_s": t_dg, "pull_graph_s": t_pg}


def superstep_bytes(eng) -> int:
    """Bytes a push or pull superstep must move on one tree: the layout read
    once (ELL levels; src and dst int32, as the reference stores them: the
    port keeps dst as int64 for ``scatter_reduce_``, a cost of its
    implementation and not of the function), the frontier table (pull) or
    the candidate array (push) written once, and the packed carry (int32
    words, bool frontier) read and written once."""
    n = eng.num_vertices + 1
    if eng.engine == "pull":
        layout = sum(t.numel() * t.element_size() for t in (eng.ell0, *eng.folds))
    else:
        layout = (eng.src.numel() + eng.dst.numel()) * 4
    return layout + 4 * n + 2 * 5 * n


def superstep_table(label: str, eng, root: int) -> dict:
    """Every superstep of ``root``'s search on the packed carry, stepped
    eagerly: device ms of each (``cold_ms``: L2 flushed, launches hidden
    behind a device sleep, mean of 3) beside the byte bound at 3.35 TB/s,
    and the same superstep gated by a live control block (what the level
    loop runs: the merge also selects by the LIVE word)."""
    from bfs_tpu_torch.ops import control as C
    from bfs_tpu_torch.ops.relax import init_packed_state
    from bfs_tpu_torch.utils.timing import cold_ms

    st = init_packed_state(eng.num_vertices, root, eng.device)
    ctl = C.new_ctl(eng.device)
    C.init_ctl(ctl, eng.num_vertices)
    nbytes = superstep_bytes(eng)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    rows = []
    while True:
        front = int(st.frontier.sum())
        ms = cold_ms(lambda: eng.superstep(st), reps=3, warm=1)
        gated = cold_ms(lambda: eng.superstep(st, ctl), reps=3, warm=1)
        st = eng.superstep(st)
        rows.append(dict(level=len(rows) + 1, frontier=front, ms=ms, gated_ms=gated))
        if not bool(st.changed):
            break
    dense = max(rows, key=lambda r: r["ms"])
    n = len(rows)
    gate = sum(r["gated_ms"] - r["ms"] for r in rows) / n
    log(f"{label} supersteps from root {root} (device ms, cold, mean of 3; gated by a live "
        "control block; frontier at entry): "
        + ", ".join(f"{r['level']}: {r['ms']:.4f} / {r['gated_ms']:.4f} ({r['frontier']})"
                    for r in rows)
        + f"; byte bound {bound:.4f} ms ({nbytes} bytes at 3.35 TB/s); slowest "
        f"{dense['ms']:.4f} ms = {dense['ms'] / bound:.1f}x the bound; the gate adds "
        f"{gate:.4f} ms a superstep (mean)")
    return dict(rows=rows, bound_ms=bound, bytes=nbytes, max_ms=dense["ms"],
                mean_ms=sum(r["ms"] for r in rows) / n, gate_ms=gate)


def edge_search_phase(label: str, eng, roots, want: dict, K, L) -> dict:
    """One engine's fused searches (``loop_phase``: captured against eager,
    traced, the dead superstep), each result equal to ``canonical_bfs``
    and to the relay engine's bit for bit; then its superstep table."""
    import numpy as np

    res = loop_phase(label, eng, roots, EDGE_STEP, "loop_control", K, L)
    for r in roots:
        (dist, parent), relay = want[r]
        got = res["results"][r]
        if not (np.array_equal(got.dist, dist) and np.array_equal(got.parent, parent)):
            raise AssertionError(f"{label} root {r}: result differs from canonical_bfs")
        if not (np.array_equal(got.dist, relay.dist) and np.array_equal(got.parent, relay.parent)
                and got.num_levels == relay.num_levels):
            raise AssertionError(f"{label} root {r}: result differs from the relay engine's")
        verify(f"{label} root {r}", got.dist, got.parent, r)
    log(f"{label}: all {len(roots)} roots oracle-exact, equal to the relay engine's bit for bit, "
        "DeviceChecker clean")
    res["steps"] = superstep_table(label, eng, roots[0])
    res["table"] = block_table(f"{label}, 4 searches a run", lambda: searches(eng, roots), L, eng,
                               reps=1, ks=EDGE_KS, attr="EDGE_BLOCK", eager=True)
    return res


def edge_batch_phase(label: str, eng, sources, relay, K) -> dict:
    """``run_multi`` (what ``bfs_multi`` runs) on the captured loop: the
    first call (captures the batch's block) and a timed one, each tree equal
    to the relay batch's bit for bit (whose trees equal the single-source
    searches, four of them ``canonical_bfs``); then ``run_multi`` on the
    eager loop for the first ``EAGER_BATCH`` sources, each tree equal bit
    for bit to the captured batch's."""
    import numpy as np
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run_multi(sources)
    first_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    res = eng.run_multi(sources)
    secs = time.perf_counter() - t0
    run, peak = dict(eng.last_run), torch.cuda.max_memory_allocated()
    n = len(sources)
    if not (np.array_equal(res.dist, relay.dist[:n]) and np.array_equal(res.parent, relay.parent[:n])):
        raise AssertionError(f"{label}: a tree differs from the relay batch's")
    if n == len(relay.sources) and res.num_levels != relay.num_levels:
        raise AssertionError(f"{label}: {res.num_levels} levels, the relay batch {relay.num_levels}")
    if K.LAUNCHES["loop_control"] != run["issued"] or run["live"] != res.num_levels:
        raise AssertionError(f"{label}: {K.LAUNCHES['loop_control']} control steps, "
                             f"{run['issued']} issued, {run['live']} live, {res.num_levels} levels")
    res_levels = res.num_levels
    for i, s in enumerate(sources.tolist()):
        verify(f"{label} tree {i}", res.dist[i], res.parent[i], s)
    log(f"{label}, {n} sources: first call (captures) {first_s:.6f} s; then {secs:.6f} s per "
        f"batch (level loop {run['loop_s']:.6f} s, results {run['result_s']:.6f} s), "
        f"{secs / n:.6f} s per tree, {res.num_levels} levels; host reads {run['host_reads']}, "
        f"replays {run['replays']}, supersteps issued {run['issued']}, live {run['live']}; "
        f"peak device memory {peak} bytes; every tree equal to the relay batch's")
    # The eager loop (a host read per superstep, nothing captured) on fewer
    # sources than the captured batch: no block size table of the batch
    # since the sharded phase came in (it took 8.2 s (pull) and 4.7 s
    # (push) of the script's 600 s).
    m = min(n, EAGER_BATCH)
    eng.loop = "eager"
    try:
        t0 = time.perf_counter()
        eager = eng.run_multi(sources[:m])
        eager_s = time.perf_counter() - t0
    finally:
        eng.loop = "blocks"
    if not (np.array_equal(eager.dist, res.dist[:m]) and np.array_equal(eager.parent, res.parent[:m])):
        raise AssertionError(f"{label}: an eager tree differs from the captured batch's")
    log(f"{label}, eager loop, the first {m} sources: {eager_s:.6f} s ({eng.last_run['host_reads']} "
        f"host reads, {eager.num_levels} levels); every tree equal bit for bit to the captured "
        "batch's")
    del res, eager
    return dict(first_s=first_s, secs=secs, run=run, peak=peak, trees=n, levels=res_levels,
                eager_s=eager_s, eager_trees=m)


def runner_phase(layouts: dict, root: int, want: dict, K, P) -> tuple[dict, dict]:
    """``SuperstepRunner`` on push, pull and relay from ``root``: each step
    timed by the device-synchronised ``Stopwatch``, the final state in
    original ids equal to the fused result; the relay runner's kernel
    launches held to its per-step count times its steps.  Then, on the
    relay runner's states, what its step's packed route (K4 on words built
    from the unpacked carry, and the decode back) costs beside the plain
    unpacked merge after K1-K3 (``RelayEngine.superstep``)."""
    import numpy as np

    from bfs_tpu_torch.utils.timing import Stopwatch

    (dist, parent), relay = want[root]
    out = {}
    for engine, layout in layouts.items():
        runner = P.SuperstepRunner(layout, engine=engine, device="cuda")
        st = runner.init(root)
        K.reset_launches()
        sw, steps, states = Stopwatch("cuda"), [], []
        while bool(st.changed):
            if engine == "relay":
                states.append(st)
            sw.reset().start()
            st = runner.step(st)
            sw.stop()
            steps.append(sw.elapsed_s)
        got_d, got_p, _ = runner.to_original(st, source=root)
        if not (np.array_equal(got_d, dist) and np.array_equal(got_p, parent)
                and int(st.level) == relay.num_levels):
            raise AssertionError(f"SuperstepRunner({engine}): final state differs from the fused result")
        if engine == "relay":
            want_launches = {k: v * len(steps) for k, v in RELAY_RUNNER_STEP.items()}
            got = {k: K.LAUNCHES[k] for k in want_launches}
            if got != want_launches:
                raise AssertionError(f"relay runner: launches {got} in {len(steps)} steps, "
                                     f"expected {want_launches}")
            merge = relay_step_cost(runner._relay, states)
        log(f"SuperstepRunner({engine}) root {root}: {len(steps)} steps, ms each (Stopwatch, "
            "device-synchronised): " + ", ".join(f"{t * 1e3:.3f}" for t in steps)
            + "; final state equal to the fused result"
            + (f"; launches {got}" if engine == "relay" else ""))
        out[engine] = steps
        del runner, st, states
    return out, merge


def relay_step_cost(eng, states) -> dict:
    """Device ms (``cold_ms``, mean of 3) of ``RelayEngine.step`` (K1-K4,
    the merge through ``packed_update`` on words built from the unpacked
    carry) beside ``RelayEngine.superstep`` (K1-K3, then the unpacked merge
    in torch ops) on each of a search's states; both must agree."""
    import torch

    from bfs_tpu_torch.utils.timing import cold_ms

    rows = []
    for st in states:
        a, b = eng.step(st), eng.superstep(st)
        if not (all(torch.equal(x, y) for x, y in zip((a.dist, a.parent, a.fwords),
                                                     (b.dist, b.parent, b.fwords)))
                and bool(a.changed) == bool(b.changed)):
            raise AssertionError(f"relay runner level {st.level + 1}: step and superstep differ")
        rows.append((cold_ms(lambda: eng.step(st), reps=3, warm=1),
                     cold_ms(lambda: eng.superstep(st), reps=3, warm=1)))
    step_ms, plain_ms = (sum(r[i] for r in rows) / len(rows) for i in (0, 1))
    log("relay runner step (K1-K4 through packed words) against the unpacked merge after K1-K3, "
        "device ms (cold, mean of 3) per level: "
        + ", ".join(f"{i + 1}: {a:.4f} / {b:.4f}" for i, (a, b) in enumerate(rows))
        + f"; mean {step_ms:.4f} / {plain_ms:.4f}, the packed route {step_ms - plain_ms:+.4f} ms "
        "a step; results equal")
    return dict(step_ms=step_ms, plain_ms=plain_ms, rows=rows)


def sharded_phase(P, g, dg, roots, want, single: dict, batch, sssp_want, cc_want, K,
                  card: str, store: str) -> dict:
    """The mesh-sharded engine (``bfs_tpu_torch.parallel``) at s22 on
    ``SHARDS`` shards stacked on the card: the layouts (the torch-routed
    relay layouts of 4 and 2 shards built side by side first, then the
    pull layouts and the edge shards; build seconds and bytes); single
    searches on pull, push and relay (direction pull and auto) from the
    max-degree root and a drawn one (the first calls capture; the timed
    ones run once the host's side work is done), each equal bit for bit
    to the single-chip result the script holds and clean under the
    DeviceChecker (and ``check()`` on the host for one); K1-K4 launched
    once per shard, ``SHARDS`` x the shard's count per superstep x the
    supersteps issued; one dense superstep of shard 0 with each kernel
    held against its plain version (``sharded_kernel_check``); the relay
    search under the four exchange arms, bit-identical, their bytes and arm
    per level; ``bfs_sharded_multi`` on a (2, 2) mesh for ``SHARDED_BATCH``
    of the batch sources on pull and relay, every tree equal to the
    batch's; ``sssp_sharded`` and ``cc_sharded`` equal to the single-chip
    results; the resumable search (``sharded_segmented_part``); the 2-D
    grid on the same layout (``sharded_grid_part``); the MXU arm on the
    mesh (``sharded_mxu_part``), once every other engine of the phase is
    freed.  ``bfs_sharded`` and ``bfs_sharded_multi`` build an
    engine for the call and drop it; the timed replays run on held engines
    (the stateful API).  Seconds per search beside the single-chip ones,
    the peak memory and the phase's wall time.  Four shards on one card
    share its memory: no wire, the exchange's bytes are counted."""
    import concurrent.futures

    import numpy as np
    import torch
    from bfs_tpu_torch.algo import cc_sharded, sssp_sharded
    from bfs_tpu_torch.graph import grid_layout as PGL
    from bfs_tpu_torch.parallel import sharded as SH

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda = torch.device("cuda")
    mesh = SH.make_mesh(graph=SHARDS, devices=[cuda] * SHARDS)
    mesh22 = SH.make_mesh(graph=2, batch=2, devices=[cuda] * 4)

    def timed(fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        return out, time.perf_counter() - t0

    # The two torch-routed relay builds (their routes on the card) and the
    # 4-shard pull build side by side, before any capture; the 2-shard pull
    # build (host only) and one host check() run beside the first calls.
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=4, thread_name_prefix="sharded-phase")
    st4, st2 = {}, {}
    t0 = time.perf_counter()
    f_relay4 = pool.submit(timed, P.build_sharded_relay_graph, dg, SHARDS, route="torch",
                           stage_times=st4)
    f_relay2 = pool.submit(timed, P.build_sharded_relay_graph, dg, 2, route="torch",
                           stage_times=st2)
    f_pull4 = pool.submit(timed, P.build_sharded_pull_graph, dg, SHARDS)
    dg4, dg4_s = timed(P.build_device_graph, dg, num_shards=SHARDS)
    (srg, relay4_s), (srg2, relay2_s), (spg, pull4_s) = (f.result() for f in
                                                         (f_relay4, f_relay2, f_pull4))
    torch.cuda.synchronize()
    layouts_s = time.perf_counter() - t0
    f_pull2 = pool.submit(timed, P.build_sharded_pull_graph, dg, 2)
    # The 2-D grid's per-cell layouts (host) beside the first searches.
    f_grid = [pool.submit(timed, PGL.grid_layout_for, srg, r, c) for r, c in ((2, 2), (1, 4))]

    def nbytes(*arrays) -> int:
        return int(sum(a.nbytes for a in arrays))

    relay_bytes = nbytes(srg.vperm_masks, srg.net_masks, srg.src_l1, srg.adj_indptr, srg.adj_dst,
                         srg.adj_slot, srg.outdeg)
    pull_bytes = nbytes(spg.ell0, *spg.folds)
    log(f"sharded layouts ({SHARDS} shards; {card}): relay (torch route) {relay4_s:.3f} s "
        f"(stages {stage_line(st4)}), {relay_bytes} bytes: block {srg.block}, vperm "
        f"{srg.vperm_size}, net {srg.net_size}, {len(srg.in_classes)} in-classes, adjacency "
        f"rows of {srg.adj_dst.shape[1]}; pull {pull4_s:.3f} s, {pull_bytes} bytes (ell0 "
        f"{spg.ell0.shape}, folds {[f.shape for f in spg.folds]}); edge shards {dg4_s:.3f} s "
        f"({dg4.src.shape}); the 2-shard relay layout {relay2_s:.3f} s beside them; all in "
        f"{layouts_s:.3f} s")

    def same_as_single(label: str, res, r: int) -> None:
        (dist, parent), relay = want[r]
        if not (np.array_equal(res.dist, dist) and np.array_equal(res.parent, parent)):
            raise AssertionError(f"sharded {label} root {r}: result differs from canonical_bfs")
        if res.num_levels != relay.num_levels:
            raise AssertionError(f"sharded {label} root {r}: {res.num_levels} levels, the "
                                 f"single-chip search {relay.num_levels}")
        verify(f"sharded {label} root {r}", res.dist, res.parent, r)

    # ---- single searches: pull and push once through ``bfs_sharded`` (a
    # one-shot engine) from the max-degree root; each held engine's first
    # call (it captures) from that root; then, once the host's side work is
    # done, each root timed (a replay), each result dropped before the next
    # as a caller taking one result at a time drops it.  The relay search
    # goes through ``bfs_sharded`` under every exchange arm below.
    K.reset_launches()
    one_shot = {}
    for engine, layout in (("pull", spg), ("push", dg4)):
        res, one_shot[engine] = timed(SH.bfs_sharded, layout, roots[0], mesh=mesh, engine=engine)
        same_as_single(f"{engine} (bfs_sharded)", res, roots[0])
        del res
    reng = SH.ShardedRelayEngine(srg, mesh)
    engines = {"pull": SH.ShardedPullEngine(spg, mesh), "push": SH.ShardedPushEngine(dg4, mesh),
               "relay": reng}
    cases = (("pull", {}), ("push", {}),
             ("relay pull", {"direction": "pull", "exchange": "auto"}),
             ("relay auto", {"direction": "auto", "exchange": "auto"}))
    rows, f_check = {}, None
    for label, kw in cases:
        eng = engines[label.split()[0]]
        t0 = time.perf_counter()
        res = eng.run(roots[0], **kw)
        rows[label] = dict(first_s=time.perf_counter() - t0)
        same_as_single(label, res, roots[0])
        if label == "relay pull":
            f_check = pool.submit(P.check, g, res.dist, res.parent, roots[0])
        del res
    spg2, pull2_s = f_pull2.result()
    violations = f_check.result()
    if violations:
        raise AssertionError(f"sharded relay pull root {roots[0]}: check() violations {violations[:3]}")
    for label, kw in cases:
        eng = engines[label.split()[0]]
        secs, runs = [], []
        for r in roots[:2]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = eng.run(r, **kw)
            secs.append(time.perf_counter() - t0)
            runs.append(dict(eng.last_run))
            same_as_single(label, res, r)
            del res
        rows[label].update(secs=secs, run=runs[0])
        log(f"sharded {label} search ({SHARDS} shards; {card}): first call (captures) "
            f"{rows[label]['first_s']:.6f} s; then " + "; ".join(
                f"root {r} {t:.6f} s (loop {u['loop_s']:.6f}, results {u['result_s']:.6f}; host "
                f"reads {u['host_reads']}, issued {u['issued']}, live {u['live']})"
                for r, t, u in zip(roots, secs, runs))
            + f"; single-chip mean {single[label]:.6f} s; equal to canonical_bfs and the "
            "single-chip search, DeviceChecker clean"
            + (f"; through bfs_sharded (one-shot engine: build, ship, capture) "
               f"{one_shot[label]:.6f} s" if label in one_shot else ""))
    phase_launches = dict(K.LAUNCHES)
    del engines["pull"], engines["push"]

    # ---- launches of the relay search: once per shard per superstep
    per = reng.dense_launches()
    for label, kw in (("pull", {"direction": "pull"}), ("auto", {"direction": "auto"})):
        K.reset_launches()
        reng.run(roots[0], exchange="auto", **kw)
        run = reng.last_run
        got = {k: K.LAUNCHES[k] for k in (*per, "loop_control")}
        expect = {k: SHARDS * c * (run["issued"] if k == "packed_update" else run["issued_pull"])
                  for k, c in per.items()}
        expect["loop_control"] = run["issued"]
        if got != expect:
            raise AssertionError(f"sharded relay {label}: launches {got}, expected {expect} "
                                 f"({per} a shard, {SHARDS} shards, run {run})")
        for k, n in got.items():
            phase_launches[k] += n
        log(f"sharded relay {label} root {roots[0]} ({card}): launches {got} = {SHARDS} shards x "
            f"{per} a shard's dense superstep x {run['issued_pull']} dense of {run['issued']} supersteps "
            f"issued (packed_update and loop_control on every superstep); the single-chip "
            f"gather superstep launches {GATHER_STEP}")

    # ---- one dense superstep of shard 0, each kernel against its plain
    # version (these launches are not the path's: the next part resets)
    check = sharded_kernel_check(reng, want[roots[0]][0][0], roots[0], K, card)
    # ---- the resumable search on the held engine and one-shot engines
    K.reset_launches()
    segmented = sharded_segmented_part(reng, srg, mesh, roots[0], same_as_single, store, card)
    for k, n in K.LAUNCHES.items():
        phase_launches[k] += n
    del reng, engines, eng

    # ---- the exchange arms: bit-identical, bytes and arm per level
    base, ex = None, {}
    K.reset_launches()
    for arm in EXCHANGE_ARMS:
        t0 = time.perf_counter()
        res, curve = SH.bfs_sharded(srg, roots[0], mesh=mesh, engine="relay", direction="pull",
                                    exchange=arm, telemetry=True)
        secs = time.perf_counter() - t0
        if base is None:
            same_as_single(f"relay exchange {arm}", res, roots[0])
            base = (res, curve)
        elif not (np.array_equal(res.dist, base[0].dist) and np.array_equal(res.parent, base[0].parent)
                  and res.num_levels == base[0].num_levels
                  and curve["occupancy"] == base[1]["occupancy"]):
            raise AssertionError(f"sharded relay exchange {arm}: differs from the flat arm")
        ex[arm] = dict(curve["exchange"], secs=secs)
    for k, n in K.LAUNCHES.items():
        phase_launches[k] += n
    log(f"sharded exchange arms, relay root {roots[0]} ({SHARDS} shards on one card: the bytes a "
        f"mesh would ship, counted; {card}): bit-identical; " + "; ".join(
            f"{arm} {e['secs']:.6f} s, {e['total_bytes']} bytes (flat {e['flat_total_bytes']}), "
            f"per level " + ", ".join(f"{a} {b}" for a, b in zip(e["schedule"], e["bytes_per_level"]))
            for arm, e in ex.items()))

    # ---- the batch on a (2, 2) mesh
    srcs = np.asarray(batch.sources[:SHARDED_BATCH])
    multi = {}
    K.reset_launches()
    for engine, layout, cls in (("pull", spg2, SH.ShardedPullEngine),
                                ("relay", srg2, SH.ShardedRelayEngine)):
        # bfs_sharded_multi (a one-shot engine), then a held engine's first
        # call (it captures) and a replay, every tree against the batch's
        one, one_s = timed(SH.bfs_sharded_multi, layout, srcs, mesh=mesh22, engine=engine)
        beng = cls(layout, mesh22)
        first_s = timed(beng.run_multi, srcs)[1]
        res, secs = timed(beng.run_multi, srcs)
        for label, got in (("bfs_sharded_multi", one), ("held engine", res)):
            if not (np.array_equal(got.dist, batch.dist[:SHARDED_BATCH])
                    and np.array_equal(got.parent, batch.parent[:SHARDED_BATCH])):
                raise AssertionError(f"sharded batch {engine} ({label}): a tree differs from the "
                                     "batch's")
        verify(f"sharded batch {engine} tree 0", res.dist[0], res.parent[0], int(srcs[0]))
        multi[engine] = dict(one_s=one_s, first_s=first_s, secs=secs, run=dict(beng.last_run))
        del one, res, beng
    for k, n in K.LAUNCHES.items():
        phase_launches[k] += n
    log(f"sharded batch (bfs_sharded_multi, (2, 2) mesh, {SHARDED_BATCH} sources; {card}): " + "; ".join(
        f"{e} bfs_sharded_multi (one-shot engine) {m['one_s']:.6f} s; a held engine's first "
        f"call {m['first_s']:.6f} s, then {m['secs']:.6f} s ({m['run']['issued']} supersteps "
        "issued)" for e, m in multi.items())
        + f"; every tree equal to the batch's; the 2-shard pull layout {pull2_s:.3f} s")

    # ---- the algorithms on the edge shards
    K.reset_launches()
    ss, sssp_s = timed(sssp_sharded, dg4, roots[0], mesh=mesh)
    if not (np.array_equal(ss.dist, sssp_want.dist) and np.array_equal(ss.parent, sssp_want.parent)
            and ss.rounds == sssp_want.rounds):
        raise AssertionError("sssp_sharded differs from the single-chip sssp")
    cs, cc_s = timed(cc_sharded, dg4, mesh=mesh)
    if not (np.array_equal(cs.label, cc_want.label) and cs.rounds == cc_want.rounds):
        raise AssertionError("cc_sharded differs from the single-chip cc")
    for k, n in K.LAUNCHES.items():
        phase_launches[k] += n
    peak = torch.cuda.max_memory_allocated()
    del srg2, spg, spg2, dg4
    torch.cuda.empty_cache()
    # ---- the 2-D grid on the same 4-shard layout, before the MXU arm
    grid = sharded_grid_part(srg, f_grid, roots, want, same_as_single, segmented["fcurve"], single,
                             {k: rows[k]["secs"] for k in ("relay pull", "relay auto")}, K, card,
                             store)
    pool.shutdown()
    for k, n in grid["launches"].items():
        phase_launches[k] = phase_launches.get(k, 0) + n
    peak = max(peak, grid["peak"])
    # ---- the MXU arm on the mesh, every other engine of the phase freed
    mxu = sharded_mxu_part(srg, mesh, roots[0], want, same_as_single, K, card)
    for k, n in mxu["launches"].items():
        phase_launches[k] = phase_launches.get(k, 0) + n
    check.update(mxu["check"])
    peak = max(peak, mxu["peak"])
    del srg
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    log(f"sharded phase ({SHARDS} shards stacked on one card, not a multi-card figure; {card}): "
        "s/search " + ", ".join(f"{k} {np.mean(v['secs']):.6f} (single-chip {single[k]:.6f})"
                               for k, v in rows.items())
        + f"; sssp_sharded {sssp_s:.6f} s ({ss.rounds} rounds), cc_sharded {cc_s:.6f} s "
        f"({cs.rounds} rounds), both equal to the single-chip results; check() clean on the "
        f"host; peak device memory {peak} bytes; phase {wall:.1f} s")
    return dict(rows=rows, exchange=ex, multi=multi, launches=phase_launches, peak=peak, wall=wall,
                layouts_s=layouts_s, sssp_s=sssp_s, cc_s=cc_s, check=check, mxu=mxu,
                segmented=segmented, grid=grid)


def sharded_segmented_part(reng, srg, mesh, root: int, same_as_single, store: str,
                           card: str) -> dict:
    """The mesh's resumable search at s22 on the gather arm (``direction``
    and ``exchange`` ``auto``, telemetry on): the fused search on the held
    engine ``reng``; ``bfs_sharded_segmented`` at ``every:CKPT_EVERY`` (a
    one-shot engine) equal to it in dist, parent, levels, the direction
    schedule and the exchange's arm and bytes per level; then a run on the
    held engine at ``every:1`` stopped by ``BFS_TPU_TORCH_FAULT=
    raise:superstep:3``, one shard file of the newest epoch truncated, and
    ``bfs_sharded_segmented`` on a freshly built engine, which must resume
    from the epoch before (a shard file counted corrupt) to the same
    result.  Epoch bytes and write seconds."""
    import numpy as np
    from bfs_tpu_torch.parallel import sharded as SH
    from bfs_tpu_torch.resilience import faults as F
    from bfs_tpu_torch.resilience.faults import FaultInjected, corrupt_file
    from bfs_tpu_torch.resilience.superstep_ckpt import SuperstepCheckpointer

    t_part = time.perf_counter()
    kw = dict(direction="auto", exchange="auto", telemetry=True)

    def mgr(tag: str, every: int):
        return SuperstepCheckpointer(store, {"sharded": SHARDS, "root": root, "run": tag},
                                     cfg=ckpt_config(every), shards=SHARDS)

    t0 = time.perf_counter()
    fused, fcurve = reng.run(root, **kw)
    fused_s = time.perf_counter() - t0
    same_as_single("relay auto (telemetry)", fused, root)

    def same(label: str, res, curve) -> None:
        ex, fx = curve["exchange"], fcurve["exchange"]
        if not (np.array_equal(res.dist, fused.dist) and np.array_equal(res.parent, fused.parent)
                and res.num_levels == fused.num_levels
                and curve["direction_schedule"] == fcurve["direction_schedule"]
                and ex["schedule"] == fx["schedule"]
                and ex["bytes_per_level"] == fx["bytes_per_level"]
                and curve["occupancy"] == fcurve["occupancy"]):
            raise AssertionError(f"sharded segmented ({label}): differs from the fused search")

    m = mgr("every", CKPT_EVERY)
    t0 = time.perf_counter()
    res, curve = SH.bfs_sharded_segmented(srg, root, mesh=mesh, ckpt=m, **kw)
    seg_s = time.perf_counter() - t0
    same(f"every:{CKPT_EVERY}", res, curve)
    rep = m.report()
    if m.epochs() or rep["segments"] != -(-fused.num_levels // CKPT_EVERY):
        raise AssertionError(f"sharded segmented: {rep}, epochs left {m.epochs()}")
    del res
    os.environ["BFS_TPU_TORCH_FAULT"] = "raise:superstep:3"
    F.reset()
    try:
        reng.run_segmented(root, ckpt=mgr("kill", 1), **kw)
        raise AssertionError("sharded segmented: the injected fault did not stop the run")
    except FaultInjected:
        pass
    finally:
        os.environ.pop("BFS_TPU_TORCH_FAULT", None)
        F.reset()
    killed = dict(reng.last_run)
    m2 = mgr("kill", 1)
    epochs = m2.epochs()
    if epochs != [2, 3]:
        raise AssertionError(f"sharded segmented: epochs {epochs} on disk after the kill at 3")
    corrupt_file(m2._epoch_path(epochs[-1], shard=1), mode="truncate")
    t0 = time.perf_counter()
    res, curve = SH.bfs_sharded_segmented(srg, root, mesh=mesh, ckpt=m2, **kw)
    resume_s = time.perf_counter() - t0
    same("resumed after a lost shard file", res, curve)
    rep2 = m2.report()
    if rep2["resumed_from_epoch"] != epochs[-2] or rep2["epochs_corrupt_skipped"] < 1 \
            or rep2["fresh_fallbacks"] or m2.epochs():
        raise AssertionError(f"sharded segmented: the resume after the lost shard file {rep2}")
    wall = time.perf_counter() - t_part
    log(f"sharded segmented search ({SHARDS} shards, relay gather, auto/auto, telemetry; {card}): "
        f"fused {fused_s:.6f} s on the held engine; bfs_sharded_segmented every:{CKPT_EVERY} "
        f"{seg_s:.6f} s (a one-shot engine: ship, capture, {rep['segments']} segments), "
        f"{rep['epochs_written']} epochs of {rep['snapshot_bytes']} bytes ({SHARDS} shard files + "
        f"a meta file), writes {rep['snapshot_seconds_total']:.6f} s (mean "
        f"{rep['snapshot_seconds_mean']:.6f} s); dist, parent, {fused.num_levels} levels, the "
        f"direction schedule {fcurve['direction_schedule']['schedule']} and the exchange "
        f"{list(zip(fcurve['exchange']['schedule'], fcurve['exchange']['bytes_per_level']))} "
        f"equal to the fused search")
    log(f"sharded segmented kill ({card}): every:1 on the held engine stopped by "
        f"raise:superstep:3 (issued {killed.get('issued')}), epochs {epochs} on disk, shard 1 of "
        f"epoch {epochs[-1]} truncated; bfs_sharded_segmented on a freshly built engine resumed "
        f"from epoch {rep2['resumed_from_epoch']} ({rep2['epochs_corrupt_skipped']} corrupt file "
        f"skipped) in {resume_s:.6f} s, bit-identical to the fused search; part {wall:.1f} s")
    return dict(fused_s=fused_s, seg_s=seg_s, resume_s=resume_s, report=rep, resume=rep2,
                wall=wall, fcurve=fcurve)


def sharded_grid_part(srg, layouts, roots, want, same_as_single, fcurve, single: dict,
                      one_d: dict, K, card: str, store: str) -> dict:
    """The 2-D grid (``bfs_tpu_torch.parallel.grid``) at s22 on the
    phase's 4-shard layout ``srg``, its cells stacked on the card, the
    per-cell layouts of 2x2 and 1x4 built in the phase's pool beside the
    first searches (``layouts``: their futures).  A 2x2 ``GridEngine``:
    ``pull`` and ``auto`` from the max-degree root and the first drawn root
    (a first call that captures, then a timed replay), each equal bit for
    bit to the single-chip result, DeviceChecker clean, with
    ``packed_update`` launched 4 x the supersteps issued on the packed carry
    and ``loop_control`` once a superstep; cell 0's update at the densest
    level held bit for bit against its plain version
    (``grid_kernel_check``); a 1x4 grid equal to the 1-D mesh's search on the
    same layout (``fcurve``: its curve, auto/auto) in results, direction
    schedule and the exchange's bytes and arms per level, the row axis
    shipping nothing; the segmented 2x2 search at every:2 equal to the fused
    one, then stopped at boundary 3, one cell file truncated, resumed on a
    freshly built engine bit for bit.  Seconds per search beside the 1-D
    (``one_d``) and single-chip (``single``) ones, both axes' bytes per
    level, the peak memory and the part's wall time."""
    import numpy as np
    import torch
    from bfs_tpu_torch.parallel import grid as G
    from bfs_tpu_torch.resilience import faults as F
    from bfs_tpu_torch.resilience.faults import FaultInjected, corrupt_file
    from bfs_tpu_torch.resilience.superstep_ckpt import SuperstepCheckpointer

    t_part = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda = torch.device("cuda")
    (lay22, lay22_s), (lay14, lay14_s) = (f.result() for f in layouts)
    for name, lay, secs in (("2x2", lay22, lay22_s), ("1x4", lay14, lay14_s)):
        real = [int((lay.edst[k] < lay.r * lay.block).sum()) for k in range(lay.num_cells)]
        log(f"grid layout {name} (host, in the phase's pool; {card}): {secs:.3f} s, emax "
            f"{lay.emax}, edges per cell {real} (sum {sum(real)}), "
            f"{lay.esrc.nbytes + lay.edst.nbytes + lay.ekey.nbytes + lay.indptr.nbytes} bytes "
            f"(esrc, edst, ekey {lay.esrc.nbytes} each, indptr {lay.indptr.nbytes})")
    kw = dict(exchange="auto", telemetry=True)
    t0 = time.perf_counter()
    eng = G.GridEngine(srg, G.make_grid_mesh(2, 2, devices=[cuda] * 4))
    torch.cuda.synchronize()
    ship_s = time.perf_counter() - t0
    log(f"grid 2x2 engine ({card}): operands shipped in {ship_s:.3f} s, {eng.operand_bytes} "
        f"bytes on the card")
    rows, launches, curves = {}, {}, {}
    for direction in ("pull", "auto"):
        label = f"relay {direction}"
        t0 = time.perf_counter()
        res, _ = eng.run(roots[0], direction=direction, **kw)
        first_s = time.perf_counter() - t0
        same_as_single(f"grid 2x2 {direction}", res, roots[0])
        del res
        secs, runs = [], []
        for r in roots[:2]:
            K.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res, curve = eng.run(r, direction=direction, **kw)
            secs.append(time.perf_counter() - t0)
            run = dict(eng.last_run)
            runs.append(run)
            got = {k: K.LAUNCHES[k] for k in ("packed_update", "loop_control")}
            expect = {"packed_update": 4 * run["issued"], "loop_control": run["issued"]}
            other = {k: n for k, n in K.LAUNCHES.items() if n and k not in got}
            if not run["packed"] or got != expect or other:
                raise AssertionError(f"grid 2x2 {direction} root {r}: launches {dict(K.LAUNCHES)}, "
                                     f"expected {expect} on the packed carry (run {run})")
            for k, n in got.items():
                launches[k] = launches.get(k, 0) + n
            same_as_single(f"grid 2x2 {direction}", res, r)
            curves[(direction, r)] = curve
            del res
        rows[direction] = dict(first_s=first_s, secs=secs, run=runs[0])
        ex = curves[(direction, roots[0])]["exchange"]
        log(f"grid 2x2 {direction} search ({card}): first call (captures) {first_s:.6f} s; then "
            + "; ".join(f"root {r} {t:.6f} s (loop {u['loop_s']:.6f}, results {u['result_s']:.6f}; "
                        f"host reads {u['host_reads']}, issued {u['issued']}, "
                        f"{u['issued_pull']} dense, live {u['live']})"
                        for r, t, u in zip(roots, secs, runs))
            + f"; the 1-D mesh (4 shards) {np.mean(one_d[label]):.6f} s, single-chip "
            f"{single[label]:.6f} s; launches packed_update = 4 cells x the supersteps issued, "
            f"loop_control one a superstep; equal to canonical_bfs and the single-chip search, "
            f"DeviceChecker clean; root {roots[0]} bytes per level: col "
            f"{list(zip(ex['col_schedule'], ex['col_bytes']))}, row "
            f"{list(zip(ex['row_schedule'], ex['row_bytes']))} (total {ex['total_bytes']}, the "
            f"1-D flat arm's {ex['flat_total_bytes']}; counted, the cells share one card)")
    check, pieces = grid_kernel_check(eng, want[roots[0]][0], roots[0], K, card)
    peak = torch.cuda.max_memory_allocated()
    fused, gcurve = eng.run(roots[0], direction="auto", **kw)
    del eng
    torch.cuda.empty_cache()

    # ---- 1x4: the 1-D mesh exactly, bytes included
    eng = G.GridEngine(srg, G.make_grid_mesh(1, 4, devices=[cuda] * 4))
    eng.run(roots[0], direction="auto", **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, curve = eng.run(roots[0], direction="auto", **kw)
    s14 = time.perf_counter() - t0
    same_as_single("grid 1x4 auto", res, roots[0])
    ex, fx = curve["exchange"], fcurve["exchange"]
    if not (curve["direction_schedule"] == fcurve["direction_schedule"]
            and ex["col_schedule"] == fx["schedule"] and ex["col_bytes"] == fx["bytes_per_level"]
            and set(ex["row_schedule"]) == {"none"} and not any(ex["row_bytes"])
            and ex["total_bytes"] == fx["total_bytes"]):
        raise AssertionError(f"grid 1x4: differs from the 1-D mesh: {ex} against {fx}")
    peak = max(peak, torch.cuda.max_memory_allocated())
    del eng, res
    torch.cuda.empty_cache()
    log(f"grid 1x4 auto root {roots[0]} ({card}): {s14:.6f} s (a replay); dist, parent, levels, "
        f"the direction schedule and the exchange's arms and bytes per level "
        f"{list(zip(ex['col_schedule'], ex['col_bytes']))} equal to the 1-D mesh's on the same "
        "layout; the row axis ships nothing")

    # ---- the segmented 2x2 search: every:2, then a kill and a lost cell file
    mesh22 = G.make_grid_mesh(2, 2, devices=[cuda] * 4)

    def mgr(tag: str, every: int):
        return SuperstepCheckpointer(store, {"grid": "2x2", "root": roots[0], "run": tag},
                                     cfg=ckpt_config(every), shards=4)

    def same(label: str, res, curve) -> None:
        if not (np.array_equal(res.dist, fused.dist) and np.array_equal(res.parent, fused.parent)
                and res.num_levels == fused.num_levels
                and curve["direction_schedule"] == gcurve["direction_schedule"]
                and curve["exchange"] == gcurve["exchange"]
                and curve["occupancy"] == gcurve["occupancy"]):
            raise AssertionError(f"grid segmented ({label}): differs from the fused search")

    t0 = time.perf_counter()
    m = mgr("every", CKPT_EVERY)
    res, curve = G.bfs_grid_segmented(srg, roots[0], mesh=mesh22, ckpt=m, direction="auto", **kw)
    seg_s = time.perf_counter() - t0
    same(f"every:{CKPT_EVERY}", res, curve)
    rep = m.report()
    if m.epochs() or rep["segments"] != -(-fused.num_levels // CKPT_EVERY):
        raise AssertionError(f"grid segmented: {rep}, epochs left {m.epochs()}")
    del res
    os.environ["BFS_TPU_TORCH_FAULT"] = "raise:superstep:3"
    F.reset()
    try:
        G.bfs_grid_segmented(srg, roots[0], mesh=mesh22, ckpt=mgr("kill", 1), direction="auto",
                             **kw)
        raise AssertionError("grid segmented: the injected fault did not stop the run")
    except FaultInjected:
        pass
    finally:
        os.environ.pop("BFS_TPU_TORCH_FAULT", None)
        F.reset()
    m2 = mgr("kill", 1)
    epochs = m2.epochs()
    if epochs != [2, 3]:
        raise AssertionError(f"grid segmented: epochs {epochs} on disk after the kill at 3")
    corrupt_file(m2._epoch_path(epochs[-1], shard=1), mode="truncate")
    t0 = time.perf_counter()
    res, curve = G.bfs_grid_segmented(srg, roots[0], mesh=mesh22, ckpt=m2, direction="auto", **kw)
    resume_s = time.perf_counter() - t0
    same("resumed after a lost cell file", res, curve)
    rep2 = m2.report()
    if rep2["resumed_from_epoch"] != epochs[-2] or rep2["epochs_corrupt_skipped"] < 1 \
            or rep2["fresh_fallbacks"] or m2.epochs():
        raise AssertionError(f"grid segmented: the resume after the lost cell file {rep2}")
    del res
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_part
    log(f"grid segmented 2x2 (auto/auto, telemetry; {card}): bfs_grid_segmented every:{CKPT_EVERY} "
        f"{seg_s:.6f} s (a one-shot engine: ship, capture, {rep['segments']} segments), "
        f"{rep['epochs_written']} epochs of {rep['snapshot_bytes']} bytes (4 cell files + a meta "
        f"file), writes {rep['snapshot_seconds_total']:.6f} s, equal to the fused search; every:1 "
        f"stopped by raise:superstep:3, epochs {epochs}, cell 1 of epoch {epochs[-1]} truncated, "
        f"resumed on a freshly built engine from epoch {rep2['resumed_from_epoch']} in "
        f"{resume_s:.6f} s, bit-identical")
    log(f"grid part ({card}): s/search 2x2 " + ", ".join(
        f"{d} {np.mean(r['secs']):.6f}" for d, r in rows.items())
        + f", 1x4 auto {s14:.6f}; peak device memory {peak} bytes; part {wall:.1f} s")
    return dict(rows=rows, launches=launches, check=check, pieces=pieces, peak=peak, wall=wall,
                s14=s14,
                seg_s=seg_s, resume_s=resume_s, report=rep, resume=rep2,
                layout_s=(lay22_s, lay14_s), emax=(lay22.emax, lay14.emax))


def grid_kernel_check(eng, oracle, root: int, K, card: str) -> dict:
    """Cell 0's update of the 2x2 grid engine ``eng`` at the densest level
    of the search from ``root`` (``oracle``: its distances and parents,
    original ids): the carry of that level made on the host from the
    distances (the level words of the vertices it has reached, the
    frontier, the cells' reached views), the cells' candidates by the
    engine's own dense body, sieve and flat row reduce, then
    ``packed_update`` (K4) on cell 0's block held bit for bit against its
    plain version, and its new words against the oracle's next level and
    parents."""
    import numpy as np
    import torch
    from bfs_tpu_torch.graph.csr import INF_DIST
    from bfs_tpu_torch.ops import relay as R
    from bfs_tpu_torch.ops.packed import packed_parent
    from bfs_tpu_torch.parallel import exchange as PX
    from bfs_tpu_torch.utils.timing import cold_ms

    t0 = time.perf_counter()
    dist, parent = oracle
    srg, n, r, c, block, nw = eng.layout, eng.n, eng.r, eng.c, eng.block, eng.nw
    counts = np.bincount(dist[dist != INF_DIST])
    level = int(np.argmax(counts))
    old2new = np.asarray(srg.old2new, dtype=np.int64)
    gd = np.full(eng.gtot, INF_DIST, np.int64)
    gd[old2new] = dist
    reached = gd <= level
    fw = np.packbits(gd == level, bitorder="little").view(np.int32)
    rcb = np.packbits(reached, bitorder="little").view(np.uint32).reshape(r, c, nw)
    rc = np.stack([rcb[:, t % c].reshape(-1) for t in range(n)]).view(np.int32)
    cand = eng._dense_cand(torch.from_numpy(fw).to(eng.device))
    cand = torch.where(eng._reached(torch.from_numpy(rc).to(eng.device)), PX.INT32_MAX, cand)
    candg = PX.make_grid_row_reduce(PX.ExchangeConfig("flat"), eng.kw, nw, r, c)(cand, eng.own)[0]
    own0 = candg[0, :block]  # cell (0, 0) owns block 0: stripe position 0 of column 0
    own0 = torch.where(own0 == PX.INT32_MAX, -1, own0)
    # The reached vertices' words hold their level (the parent field is
    # never read: the sieve leaves them no candidate); the rest the sentinel.
    pk = np.where(reached[:block], gd[:block] << 26, 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    pk = torch.from_numpy(pk).to(eng.device)
    plain = R.apply_relay_candidates_packed(R.PackedRelayState(pk.clone(), None, level, None), own0)
    got = K.apply_relay_candidates_packed(R.PackedRelayState(pk.clone(), None, level, None), own0)
    err = max(max_abs_err(got.packed, plain.packed), max_abs_err(got.fwords, plain.fwords),
              int(bool(got.changed.item()) != bool(plain.changed)))
    settled = np.unpackbits(plain.fwords.cpu().numpy().view(np.uint8), bitorder="little")
    settled = settled.astype(bool)
    want = gd[:block] == level + 1
    parents = packed_parent(plain.packed).cpu().numpy()[settled]
    new2old = np.asarray(srg.new2old)[:block][settled]
    if err or not np.array_equal(settled, want) or not np.array_equal(parents, parent[new2old]):
        raise AssertionError(f"grid kernel check: packed_update err {err}; settled "
                             f"{int(settled.sum())} of cell 0's block, the search {int(want.sum())}")
    shape = (f"cell 0 of 2x2, level {level} ({int(counts[level])} frontier vertices, "
             f"{int(want.sum())} of cell 0's block of {block} settled), emax {eng.grid.emax}")
    # Where a dense grid superstep's time goes, each piece alone on this
    # level's inputs (cold L2): the dense body, the sieve, the row reduce on
    # each arm, the column broadcast of the settled words, K4 on each cell.
    fw_t, rc_t = torch.from_numpy(fw).to(eng.device), torch.from_numpy(rc).to(eng.device)
    send = torch.from_numpy(np.packbits(gd == level + 1, bitorder="little").view(np.int32)
                            .reshape(n, nw)).to(eng.device)
    own = candg.view(c, r, block).movedim(1, 0).reshape(n, block)
    own = torch.where(own == PX.INT32_MAX, -1, own)
    work = pk.repeat(n, 1)  # each cell's carry, restored before every timed call
    pieces = {
        "dense body": lambda: eng._dense_cand(fw_t),
        "sieve": lambda: torch.where(eng._reached(rc_t), PX.INT32_MAX, cand),
        **{f"row {arm}": (lambda f=PX.make_grid_row_reduce(PX.ExchangeConfig(arm), eng.kw, nw, r,
                                                           c): f(cand, eng.own))
           for arm in ("flat", "bitmap", "auto")},
        "col auto": lambda: PX.make_grid_col_exchange(PX.ExchangeConfig("auto"), eng.kw, nw, r,
                                                      c)(send, eng.own),
    }
    ms = {k: cold_ms(f, 5, warm=1) for k, f in pieces.items()}
    ms["K4 x 4 cells"] = cold_ms(lambda: [K.apply_relay_candidates_packed(
        R.PackedRelayState(work[t], None, level, None), own[t]) for t in range(n)], 5, warm=1,
        prep=lambda: work.copy_(pk.expand(n, block)))
    edges = int(sum((eng.grid.edst[k] < r * block).sum() for k in range(n)))
    bound = (edges * 16 + 2 * n * (eng.rb + 1) * 4) / 3.35e9  # gsrc, ekey, dflat r; cand r+w
    log(f"grid superstep pieces ({card}; {shape}): " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in ms.items())
        + f"; the dense body's bound {bound:.4f} ms (bytes: {edges} edges' gsrc, ekey and "
        f"dflat read once, the cells' candidate rows written and read)")
    log(f"grid kernel check ({card}): {shape}; packed_update max_abs_err {err} against the plain "
        f"version, bit-exact; its new frontier and parents the oracle's; "
        f"{time.perf_counter() - t0:.2f} s")
    return {"packed_update": (err, shape)}, ms


def sharded_mxu_part(srg, mesh, root: int, want, same_as_single, K, card: str) -> dict:
    """The MXU arm on the mesh at s22: the tiles counted per shard first
    (their stacked bytes reckoned against the card's free memory), then
    ``ShardedRelayEngine(expansion="mxu", tiles_budget_bytes=TILES_BUDGET)``
    builds each shard's tiles on the card (every shard's ``nt``, the
    stack's ``ntp``, the padding bytes, the build seconds, the peak); one
    search from ``root`` on ``pull`` and on ``auto`` (a first call that
    captures, then a timed one), each equal bit for bit to the single-chip
    result, with ``mxu_expand`` launched ``SHARDS`` x the dense supersteps
    issued and ``packed_update`` ``SHARDS`` x every superstep issued; then
    ``sharded_mxu_kernel_check``."""
    import numpy as np
    import torch
    from bfs_tpu_torch.graph import adj_tiles as AT
    from bfs_tpu_torch.parallel import sharded as SH

    t_part = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    counts = AT.count_tiles_sharded(srg, torch.device("cuda"))
    count_s = time.perf_counter() - t0
    need = SHARDS * max(counts) * AT.TILE_BYTES
    free, total = torch.cuda.mem_get_info()
    log(f"sharded mxu tiles, reckoned ({card}): nt a shard {counts} (counted in {count_s:.3f} s), "
        f"{sum(counts)} tiles, {sum(counts) * AT.TILE_BYTES} bytes; the stack pads each shard to "
        f"{max(counts)}: {need} bytes; held {held} bytes, free {free} of {total}")
    t0 = time.perf_counter()
    meng = SH.ShardedRelayEngine(srg, mesh, expansion="mxu", tiles_budget_bytes=TILES_BUDGET)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    info = meng.tiles.info
    log(f"sharded mxu engine ({SHARDS} shards; {card}): built in {build_s:.3f} s (tiles "
        f"{info['build_s']:.3f} s): nt {info['nt']}, ntp {info['ntp']}, {info['tile_bytes']} "
        f"bytes of tiles of which {info['pad_bytes']} padding; geometry (rows, cols, rtp, vtp, "
        f"ntp) {meng.tiles.geometry}; no Beneš mask shipped; peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes")
    rows, launches = {}, {}
    for direction in ("pull", "auto"):
        t0 = time.perf_counter()
        res = meng.run(root, direction=direction, exchange="auto")
        first_s = time.perf_counter() - t0
        same_as_single(f"mxu {direction}", res, root)
        del res
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = meng.run(root, direction=direction, exchange="auto")
        secs = time.perf_counter() - t0
        run = dict(meng.last_run)
        same_as_single(f"mxu {direction}", res, root)
        del res
        got = {k: K.LAUNCHES[k] for k in ("mxu_expand", "packed_update", "loop_control")}
        expect = {"mxu_expand": SHARDS * run["issued_pull"], "packed_update": SHARDS * run["issued"],
                  "loop_control": run["issued"]}
        if got != expect or any(K.LAUNCHES[k] for k in ("benes_outer_pass", "benes_local_pass",
                                                          "class_rowmin")):
            raise AssertionError(f"sharded mxu {direction}: launches {dict(K.LAUNCHES)}, expected "
                                 f"{expect} (run {run})")
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
        rows[direction] = dict(first_s=first_s, secs=secs, run=run)
        log(f"sharded mxu {direction} root {root} ({SHARDS} shards; {card}): first call (captures) "
            f"{first_s:.6f} s, then {secs:.6f} s (loop {run['loop_s']:.6f}, results "
            f"{run['result_s']:.6f}; issued {run['issued']}, {run['issued_pull']} dense, live "
            f"{run['live']}); launches {got} = {SHARDS} shards x the supersteps issued (mxu_expand "
            "on the dense ones); equal to canonical_bfs and the single-chip search")
    check, ms, plain_ms = sharded_mxu_kernel_check(meng, want[root][0], root, K, card)
    peak = torch.cuda.max_memory_allocated()
    del meng
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_part
    log(f"sharded mxu part ({card}): peak device memory {peak} bytes; {wall:.1f} s")
    return dict(rows=rows, launches=launches, check=check, peak=peak, info=info, build_s=build_s,
                counts=counts, wall=wall, ms=ms, plain_ms=plain_ms)


def sharded_mxu_kernel_check(meng, oracle, root: int, K, card: str) -> dict:
    """``mxu_expand`` (K6) of shard 0 of the mesh's MXU engine ``meng`` on
    the card at the densest level of the search from ``root`` (``oracle``:
    its ``(dist, parent)`` in original ids), against
    ``expand_frontier_mxu_plain`` on the same inputs, bit for bit and
    timed (``cold_ms``); then ``packed_update`` (K4) on shard 0's packed
    carry at that level with those original-id candidates against its
    plain version."""
    import numpy as np
    import torch
    from bfs_tpu_torch.graph.csr import INF_DIST
    from bfs_tpu_torch.ops import relay as R
    from bfs_tpu_torch.ops import relay_mxu as RM
    from bfs_tpu_torch.utils.timing import cold_ms

    t0 = time.perf_counter()
    dist, parent = oracle
    srg, block, dev = meng.layout, meng.block, meng.device
    counts = np.bincount(dist[dist != INF_DIST])
    level = int(np.argmax(counts))
    ids = np.asarray(srg.old2new, dtype=np.int64)[np.flatnonzero(dist == level)]
    words = np.zeros(meng.gtot // 32, dtype=np.uint32)
    np.bitwise_or.at(words, ids >> 5, np.uint32(1) << (ids & 31).astype(np.uint32))
    fw = torch.from_numpy(words.view(np.int32)).to(dev)
    rows, cols, rtp, vtp, _ = meng.tiles.geometry
    ops = meng.tiles.shard(0)
    kw = dict(rows=rows, cols=cols, rtp=rtp, vtp=vtp)
    got = K.expand_frontier_mxu(fw, ops, **kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    plain = RM.expand_frontier_mxu_plain(fw, ops, **kw)  # plain torch: timed once, host clock
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t1) * 1e3
    k6_err = max_abs_err(got, plain)
    ms = cold_ms(lambda: K.expand_frontier_mxu(fw, ops, **kw), 5)
    # Shard 0's packed carry at that level: level:6|parent:26 (original ids)
    # where settled, the sentinel elsewhere.
    n2o = np.asarray(srg.new2old[:block], dtype=np.int64)
    real = n2o >= 0
    d = np.where(real, dist[np.maximum(n2o, 0)], INF_DIST)
    p = np.where(real, parent[np.maximum(n2o, 0)], 0)
    settled = real & (d <= level)
    word = np.where(settled, (d.astype(np.int64) << 26) | p, 0xFFFFFFFF).astype(np.uint32)
    packed = torch.from_numpy(word.view(np.int32)).to(dev)
    new = R.apply_relay_candidates_packed(R.PackedRelayState(packed.clone(), None, level, None), plain)
    upd = K.apply_relay_candidates_packed(R.PackedRelayState(packed.clone(), None, level, None), plain)
    k4_err = max(max_abs_err(upd.packed, new.packed), max_abs_err(upd.fwords, new.fwords),
                 int(bool(upd.changed.item()) != bool(new.changed)))
    if k6_err or k4_err:
        raise AssertionError(f"sharded mxu kernel check: mxu_expand {k6_err}, packed_update {k4_err}")
    shape = (f"shard 0 of {meng.n}, level {level} ({ids.size} frontier vertices of {rows} rows): "
             f"{int(ops[0].shape[0])} tiles a shard (ntp), {cols} destinations")
    log(f"sharded mxu kernel check ({card}): {shape}; mxu_expand {ms:.4f} ms, its plain version "
        f"{plain_ms:.4f} ms, max_abs_err {k6_err}; packed_update on original-id candidates "
        f"max_abs_err {k4_err}; bit-exact; {time.perf_counter() - t0:.2f} s")
    return {"mxu_expand": (k6_err, shape), "packed_update (mxu)": (k4_err, shape)}, ms, plain_ms


def sharded_kernel_check(eng, dist, root: int, K, card: str) -> dict:
    """One dense superstep of shard 0 of the sharded relay engine ``eng``
    on the card, at the densest level of the search from ``root``
    (``dist``: its distances, original ids).  The carry of that level is
    made by the plain superstep of every shard (``.relay``'s functions on
    the engine's masks and tables; the new frontier the shards' words
    concatenated, as the flat exchange gathers them), then each kernel of
    shard 0's superstep is held bit for bit against its plain version on
    the same inputs: ``apply_benes`` on the vperm and net networks (K1 and
    K2), ``rowmin_ranks`` (K3) and ``apply_relay_candidates_packed`` (K4).
    Returns per launch key the largest error and the shape."""
    import numpy as np
    import torch
    from bfs_tpu_torch.graph.csr import INF_DIST
    from bfs_tpu_torch.ops import relay as R

    t0 = time.perf_counter()
    srg, n, block, gtot = eng.layout, eng.n, eng.block, eng.gtot
    if not eng.packed:
        raise AssertionError("the sharded relay layout runs the unpacked carry: K4 is not on its path")
    counts = np.bincount(dist[dist != INF_DIST])
    level = int(np.argmax(counts))
    src = int(srg.old2new[root])
    packed = torch.full((n, block), -1, dtype=torch.int32, device=eng.device)
    packed.view(-1)[src] = 0
    words = np.zeros(srg.vperm_size // 32, dtype=np.uint32)
    words[src >> 5] = np.uint32(1) << np.uint32(src & 31)
    fin = torch.from_numpy(words.view(np.int32)).to(eng.device)

    def plain(s: int, lvl: int):
        y = R.apply_benes_std(fin, eng.vperm_masks[s], srg.vperm_table, srg.vperm_size)
        l2 = R.broadcast_l2(y, srg.out_classes, srg.net_size, srg.out_space)
        l1 = R.apply_benes_std(l2, eng.net_masks[s], srg.net_table, srg.net_size)
        ranks = R.rowmin_ranks(l1, eng.valid_words[s], srg.in_classes, block)
        new = R.apply_relay_candidates_packed(R.PackedRelayState(packed[s], None, lvl, None), ranks)
        return y, l2, l1, ranks, new

    for lvl in range(level):
        news = [plain(s, lvl)[-1] for s in range(n)]
        for s, new in enumerate(news):
            packed[s] = new.packed
        fin[: gtot // 32] = torch.cat([new.fwords for new in news])
    frontier = int(np.unpackbits(fin[: gtot // 32].cpu().numpy().view(np.uint8)).sum())
    if frontier != counts[level]:
        raise AssertionError(f"sharded kernel check: the plain supersteps' frontier at level {level} "
                             f"holds {frontier} vertices, the search {counts[level]}")
    y, l2, l1, ranks, new = plain(0, level)
    got = K.apply_relay_candidates_packed(R.PackedRelayState(packed[0].clone(), None, level, None),
                                          ranks)
    net_err = max_abs_err(K.apply_benes(l2, eng.net_masks[0], srg.net_table, srg.net_size), l1)
    errs = {
        "vperm": max_abs_err(K.apply_benes(fin, eng.vperm_masks[0], srg.vperm_table,
                                           srg.vperm_size), y),
        "net": net_err,
        "class_rowmin": max_abs_err(K.rowmin_ranks(l1, eng.valid_words[0], srg.in_classes, block),
                                    ranks),
        "packed_update": max(max_abs_err(got.packed, new.packed), max_abs_err(got.fwords, new.fwords),
                             int(bool(got.changed.item()) != bool(new.changed))),
    }
    if any(errs.values()):
        raise AssertionError(f"sharded kernel check: a kernel differs from its plain version {errs}")
    shape = (f"shard 0 of {n}, level {level} ({frontier} frontier vertices): vperm "
             f"n={srg.vperm_size}, net n={srg.net_size}, block {block}, {len(srg.in_classes)} "
             "in-classes")
    log(f"sharded kernel check ({card}): {shape}; max_abs_err " + ", ".join(
        f"{k} {v}" for k, v in errs.items()) + " against the plain versions, bit-exact; "
        f"{time.perf_counter() - t0:.2f} s")
    both = max(errs["vperm"], errs["net"])
    return {"benes_local_pass": (both, shape), "benes_outer_pass": (both, shape),
            "class_rowmin": (errs["class_rowmin"], shape),
            "packed_update": (errs["packed_update"], shape)}


def cli_phase(K) -> None:
    """The command-line runners in-process on ``service.properties``
    (tinyCG and randomG): ``run_parallel`` stepped (push), ``--fused``
    (pull) and stepped on relay, then ``run_sequential``; each ends with
    ``check()`` and raises on a violation."""
    from bfs_tpu_torch.runners import run_parallel, run_sequential

    here = os.path.dirname(os.path.abspath(__file__))
    props = os.path.join(here, "service.properties")
    cwd = os.getcwd()
    os.chdir(here)  # the properties name their files relative to the checkout
    try:
        for argv in ([props], [props, "--fused"], [props, "--engine", "relay"]):
            K.reset_launches()
            t0 = time.perf_counter()
            run_parallel.main(argv)
            launched = {k: v for k, v in K.LAUNCHES.items() if v}
            if "--fused" in argv and not launched.get("loop_control"):
                raise AssertionError("run_parallel --fused launched no control step")
            if "relay" in argv and not launched.get("packed_update"):
                raise AssertionError("run_parallel --engine relay launched no packed_update")
            log(f"run_parallel {' '.join(argv[1:]) or '(stepped, push)'}: clean, check() clean, "
                f"{time.perf_counter() - t0:.3f} s; launches {launched}")
        run_sequential.main([props])
        log("run_sequential: clean, check() clean")
    finally:
        os.chdir(cwd)


def small_edge_checks(P, K, tiny) -> None:
    """tinyCG on the default engine (pull), and path_graph(100) on push and
    pull: 62 levels on the packed carry, stopped by its cap, then the
    unpacked re-run to 100; the captured loop against the eager loop and
    the oracle."""
    import numpy as np

    res = P.bfs(tiny, 0)
    if (res.dist.tolist(), res.parent.tolist(), res.num_levels) != (
        [0, 1, 1, 2, 2, 1], [0, 0, 0, 2, 2, 0], 3
    ):
        raise AssertionError(f"tinyCG pull: got {res.dist.tolist()} {res.parent.tolist()}")
    log("tinyCG on bfs()'s default engine (pull): oracle-exact")
    path = P.path_graph(100)
    dist, parent = P.canonical_bfs(path, 0)
    for engine in ("push", "pull"):
        eng = P.EdgeEngine(path, engine=engine)
        K.reset_launches()
        res = eng.run(0)
        run = dict(eng.last_run)
        eng.loop = "eager"
        eager = eng.run(0)
        for name, d, p, levels in (("the oracle", dist, parent, 100),
                                   ("the eager loop", eager.dist, eager.parent, eager.num_levels)):
            if not (np.array_equal(res.dist, d) and np.array_equal(res.parent, p)
                    and res.num_levels == levels):
                raise AssertionError(f"path_graph(100) {engine}: the captured loop differs from {name}")
        if run["live"] != 62 + 100 or K.LAUNCHES["loop_control"] != run["issued"]:
            raise AssertionError(f"path_graph(100) {engine}: {run['live']} live supersteps, "
                                 f"{K.LAUNCHES['loop_control']} control steps in {run['issued']} issued")
        log(f"path_graph(100), {engine}: 62 packed levels then the unpacked re-run to 100 "
            f"through the captured loops (host reads {run['host_reads']}, replays "
            f"{run['replays']}, issued {run['issued']}, live {run['live']}); oracle-exact, equal "
            "to the eager loop")


# ------------------------------------------------ the on-device verifier --

#: The s22 graph's DeviceChecker (set in main) and the results it passed.
CHECKER: dict = {}


def verify(label: str, dist, parent, source) -> None:
    """One s22 result (host or device arrays in original ids) through the
    on-device verifier: its verdict must be empty."""
    verdict = CHECKER["dc"].check(dist, parent, source)
    if verdict:
        raise AssertionError(f"{label}: DeviceChecker verdict {verdict}")
    CHECKER["passed"] += 1


def verify_corruptions(g, root: int, dist, parent) -> dict:
    """The verifier must report nonzero counts on one result with a
    corrupted parent (a vertex at level 2 given a parent at level 2) and
    one with a corrupted distance (a vertex at level 2 moved to level 4)."""
    import numpy as np

    w = int(np.flatnonzero(dist == 2)[0])
    bad_parent = parent.copy()
    bad_parent[w] = int(np.flatnonzero(dist == 2)[1])
    bad_dist = dist.copy()
    bad_dist[w] = 4
    verdicts = {"parent": CHECKER["dc"].check(dist, bad_parent, root),
                "dist": CHECKER["dc"].check(bad_dist, parent, root)}
    for name, verdict in verdicts.items():
        if not verdict:
            raise AssertionError(f"DeviceChecker: a corrupted {name} gave an empty verdict")
    log(f"DeviceChecker on corrupted results of root {root} (vertex {w}): parent {verdicts['parent']}, "
        f"dist {verdicts['dist']}")
    return verdicts


# ------------------------------------------------ the direction policy --

def level_sums(outdeg, dists, budgets: tuple[int, int] | None = None) -> dict:
    """What :func:`host_schedule` decides on, from the oracle's distances
    (``dists`` int32[S, V], a row per tree): per level the frontier's
    occupancy and out-edge mass summed over the trees, and with the relay
    hybrid's ``budgets`` ``(bv, be)`` the mass with each out-degree capped
    at ``be + 1``.  One pass per tree, shared by every mode."""
    import numpy as np

    from bfs_tpu_torch.graph.csr import INF_DIST

    trees, v = dists.shape
    ecc = int(dists[dists != INF_DIST].max())
    sums = dict(occ=np.zeros(ecc + 1, np.int64), mass=np.zeros(ecc + 1, np.int64),
                capped=np.zeros(ecc + 1, np.int64), steps=ecc + 1, n=v * trees,
                trees=trees, outdeg_sum=int(outdeg.sum()), budgets=budgets)
    weights = {"mass": outdeg}
    if budgets is not None:
        weights["capped"] = np.minimum(outdeg, budgets[1] + 1)
    for row in dists:
        lv = np.where(row != INF_DIST, row, ecc + 1)  # the last bin: unreached
        sums["occ"] += np.bincount(lv, minlength=ecc + 2)[: ecc + 1]
        for name, w in weights.items():
            sums[name] += np.bincount(lv, weights=w, minlength=ecc + 2)[: ecc + 1].astype(np.int64)
    return sums


ROOT_SUMS: dict = {}


def root_sums(outdeg, want: dict, r: int, budgets: tuple[int, int] | None = None) -> dict:
    """:func:`level_sums` of root ``r``'s oracle tree, computed once a root
    and budgets (the hybrid arms and the streamed arm share them)."""
    key = (r, budgets)
    if key not in ROOT_SUMS:
        ROOT_SUMS[key] = level_sums(outdeg, want[r][0][0][None], budgets)
    return ROOT_SUMS[key]


def host_schedule(sums: dict, mode: str, alpha: float, beta: float) -> list[str]:
    """The schedule the direction loop must take, recomputed with numpy from
    the oracle's per-level sums (:func:`level_sums`): the decisions by the
    same float32 rule (Beamer's pair: go pull when ``m_f * alpha > m_u``,
    stay pull while ``n_f * beta > n``; the unexplored mass carried in
    float32, clamped at 0).  With budgets ``(bv, be)`` it is the relay
    engine's hybrid schedule, whose push body is the sparse superstep: in
    ``auto`` a frontier over the budgets takes pull whatever the rule says;
    in ``push`` a frontier takes push exactly when it fits them, each
    out-degree capped at ``be + 1``."""
    import numpy as np

    f32 = np.float32
    occ, mass, capped, steps = sums["occ"], sums["mass"], sums["capped"], sums["steps"]
    budgets = sums["budgets"]
    bv, be = budgets or (0, 0)
    if mode == "push" and budgets is not None:
        return ["push" if occ[i] <= bv and capped[i] <= be else "pull" for i in range(steps)]
    if mode != "auto":
        return [mode] * steps
    n = f32(sums["n"])
    occ, mass = np.append(occ, 0), np.append(mass, 0)  # the empty frontier after the last level

    def take(prev, i, fe, mu):
        pull = f32(occ[i]) * f32(beta) > n if prev else fe * f32(alpha) > mu
        return pull or (budgets is not None and not (occ[i] <= bv and mass[i] <= be))

    fe = f32(mass[0])
    mu = f32(sums["outdeg_sum"]) * f32(sums["trees"]) - fe
    use, labels = take(False, 0, fe, mu), []
    for i in range(1, steps + 1):
        labels.append("pull" if use else "push")
        fe = f32(mass[i])
        mu = max(mu - fe, f32(0))
        use = take(use, i, fe, mu)
    return labels


def direction_phase(deng, g, roots, want: dict, K, D) -> dict:
    """``DirectionEngine.run`` (what ``bfs_direction`` runs) for the 4 roots
    in ``auto``, ``push`` and ``pull``, on the captured loop and the eager
    loop: each result equal to ``canonical_bfs`` and to the relay engine's,
    clean under the DeviceChecker, each schedule equal to the host's
    recomputation; on the captured loop every superstep one replay of one
    body's graph (replays = supersteps issued = control steps, the split by
    body the schedule's).  Then each superstep's device time by body (CUDA
    events around each replay) for the max-degree root in every mode, and
    the decide step alone."""
    import numpy as np
    import torch

    from bfs_tpu_torch.utils.timing import cold_ms

    cfg = deng.config
    outdeg = np.bincount(g.src, minlength=g.num_vertices).astype(np.int64)
    sums = {r: root_sums(outdeg, want, r) for r in roots}
    out = {"mean": {}, "schedules": {}}
    for mode in ("auto", "push", "pull"):
        deng.config = D.DirectionConfig(mode, cfg.alpha, cfg.beta)
        for loop in ("blocks", "eager"):
            deng.loop = loop
            deng.run(roots[0])  # warm: the capture
            K.reset_launches()
            rows = []
            # The forced modes on the max-degree root and one other.
            for r in (roots if mode == "auto" else roots[:2]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res, sched = deng.run(r)
                secs = time.perf_counter() - t0
                run = dict(deng.last_run)
                (dist, parent), relay = want[r]
                if not (np.array_equal(res.dist, dist) and np.array_equal(res.parent, parent)):
                    raise AssertionError(f"direction {mode} ({loop}) root {r}: differs from canonical_bfs")
                if res.num_levels != relay.num_levels:
                    raise AssertionError(f"direction {mode} ({loop}) root {r}: {res.num_levels} levels, "
                                         f"relay {relay.num_levels}")
                expect = host_schedule(sums[r], mode, cfg.alpha, cfg.beta)
                if sched["schedule"] != expect:
                    raise AssertionError(f"direction {mode} ({loop}) root {r}: schedule "
                                         f"{sched['schedule']}, the host's {expect}")
                split = (run["issued_push"], run["issued_pull"])
                if split != (sched["push_supersteps"], sched["pull_supersteps"]) or \
                        run["issued"] != sum(split) or run["live"] != res.num_levels:
                    raise AssertionError(f"direction {mode} ({loop}) root {r}: issued {run['issued']} "
                                         f"as {split}, schedule {sched}")
                if loop == "blocks" and run["replays"] != run["issued"]:
                    raise AssertionError(f"direction {mode} root {r}: {run['replays']} replays in "
                                         f"{run['issued']} supersteps issued")
                if loop == "blocks":  # the eager loop's equal result is not checked again
                    verify(f"direction {mode} ({loop}) root {r}", res.dist, res.parent, r)
                rows.append(dict(root=r, secs=secs, **run))
                if mode == "auto" and loop == "blocks":
                    out["schedules"][r] = sched["schedule"]
                log(f"direction {mode} root {r}, {'captured' if loop == 'blocks' else 'eager'} loop: "
                    f"{secs:.6f} s (level loop {run['loop_s']:.6f} s, results {run['result_s']:.6f} s), "
                    f"{res.num_levels} levels; host reads {run['host_reads']}, replays "
                    f"{run['replays']} (push {run['issued_push']}, pull {run['issued_pull']}), issued "
                    f"{run['issued']}; schedule {','.join(sched['schedule'])}, equal "
                    "to the host's; oracle-exact, equal to relay"
                    + (", DeviceChecker clean" if loop == "blocks" else ""))
            issued = sum(row["issued"] for row in rows)
            controls = K.LAUNCHES["loop_control"]
            if controls != (issued if loop == "blocks" else 0):
                raise AssertionError(f"direction {mode} ({loop}): {controls} control steps in "
                                     f"{issued} supersteps issued")
            out["mean"][(mode, loop)] = float(np.mean([row["secs"] for row in rows]))
            out.setdefault("split", {})[(mode, loop)] = {
                k: float(np.mean([row[k] for row in rows])) for k in ("secs", "loop_s", "result_s")}
    log("direction, mean over the roots (search s / level loop s / result copy s): " + "; ".join(
        f"{mode} {'captured' if loop == 'blocks' else 'eager'} {v['secs']:.6f} / "
        f"{v['loop_s']:.6f} / {v['result_s']:.6f}" for (mode, loop), v in out["split"].items()))
    deng.loop = "blocks"
    deng.config = D.DirectionConfig("auto", cfg.alpha, cfg.beta)
    kept = deng.run(roots[0])  # a result alive, as in the timed loop
    host_trace(f"direction auto, captured loop, root {roots[1]} (the result copy: "
               "cudaHostAlloc, cudaMemcpyAsync, cudaStreamSynchronize)", lambda: deng.run(roots[1]))
    del kept
    times = {}
    for mode in ("auto", "push", "pull"):
        deng.config = D.DirectionConfig(mode, cfg.alpha, cfg.beta)
        times[mode] = []
        deng.run(roots[0], times=times[mode])
    deng.config = cfg
    names = ("push", "pull")
    per_body = {b: float(np.mean([ms for _, ms in times[b]])) for b in names}
    log(f"direction, root {roots[0]}: device ms of each superstep's replay (CUDA events), auto "
        "(its body) beside the forced push and pull replays at that level: " + "; ".join(
            f"{i + 1}: auto {names[b]} {ms:.4f} | push {times['push'][i][1]:.4f} | pull "
            f"{times['pull'][i][1]:.4f}" for i, (b, ms) in enumerate(times["auto"]))
        + f"; mean superstep push {per_body['push']:.4f} ms, pull {per_body['pull']:.4f} ms")
    buffers = deng._loops[("auto", True, None)].buffers
    frontier, dstate, ctl = buffers[1].clone(), buffers[-2].clone(), buffers[-1].clone()
    decide_ms = cold_ms(
        lambda: D.decide_gated(dstate, ctl, *D.frontier_masses(frontier, deng.outdeg)), 10)
    log(f"direction: the decide step alone {decide_ms:.4f} ms (cold, mean of 10; the masses of a "
        f"{frontier.numel()}-vertex frontier, the predicate, the gated writes)")
    out.update(times=times, per_body=per_body, decide_ms=decide_ms)
    return out


def direction_batch_phase(deng, sources, relay, outdeg, K) -> dict:
    """``DirectionEngine.run_multi`` (what ``bfs_multi_direction`` runs) in
    ``auto`` (the engine's configuration) on the first ``len(sources)``
    sources of the relay batch ``relay``: the first call (captures) and a
    timed one, every tree equal to the relay batch's and clean under the
    DeviceChecker, the schedule equal to the host's recomputation from
    those trees, one replay per superstep."""
    import numpy as np
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    deng.run_multi(sources)
    first_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    res, sched = deng.run_multi(sources)
    secs = time.perf_counter() - t0
    run, peak = dict(deng.last_run), torch.cuda.max_memory_allocated()
    n = len(sources)
    if not (np.array_equal(res.dist, relay.dist[:n]) and np.array_equal(res.parent, relay.parent[:n])
            and (n < len(relay.sources) or res.num_levels == relay.num_levels)):
        raise AssertionError("bfs_multi_direction: a tree differs from the relay batch's")
    cfg = deng.config
    expect = host_schedule(level_sums(outdeg, relay.dist[:n]), "auto", cfg.alpha, cfg.beta)
    if sched["schedule"] != expect:
        raise AssertionError(f"bfs_multi_direction: schedule {sched['schedule']}, the host's {expect}")
    split = (run["issued_push"], run["issued_pull"])
    if split != (sched["push_supersteps"], sched["pull_supersteps"]) or \
            run["replays"] != run["issued"] or run["issued"] != sum(split) or \
            K.LAUNCHES["loop_control"] != run["issued"]:
        raise AssertionError(f"bfs_multi_direction: {run}, schedule {sched}")
    for i, s in enumerate(sources.tolist()):
        verify(f"bfs_multi_direction tree {i}", res.dist[i], res.parent[i], s)
    log(f"bfs_multi_direction (auto), {len(sources)} sources: first call (captures) {first_s:.6f} s; "
        f"then {secs:.6f} s per batch (level loop {run['loop_s']:.6f} s, results "
        f"{run['result_s']:.6f} s), {secs / len(sources):.6f} s per tree, {res.num_levels} levels; "
        f"schedule {sched['schedule']} (equal to the host's); host reads {run['host_reads']}, "
        f"replays {run['replays']} (push {split[0]}, pull {split[1]}); peak device memory {peak} "
        "bytes; every tree equal to the relay batch's, DeviceChecker clean")
    return dict(first_s=first_s, secs=secs, run=run, peak=peak, schedule=sched["schedule"])


def relay_curve_phase(eng, root: int, dist, K) -> dict:
    """``RelayEngine.run_level_curve``: the recorder in the captured relay
    block (K1-K4 and the control step per superstep, as the search
    launches them), its occupancy equal to the oracle's level histogram
    (so its sum is the reachable count), its schedule all ``pull``; timed
    beside ``run`` on the same root."""
    import numpy as np
    import torch

    from bfs_tpu_torch.graph.csr import INF_DIST

    eng.run_level_curve(root)  # warm: the capture
    K.reset_launches()
    curve = eng.run_level_curve(root)
    run = dict(eng.last_run)
    launches = {k: K.LAUNCHES[k] for k in GATHER_STEP}
    if launches != {k: v * run["issued"] for k, v in GATHER_STEP.items()}:
        raise AssertionError(f"run_level_curve: launches {launches} in {run['issued']} issued")
    reached = dist != INF_DIST
    hist = [int(x) for x in np.bincount(dist[reached])]
    sched = curve["direction_schedule"]["schedule"]
    if curve["occupancy"] != hist or curve["reachable"] != int(reached.sum()) or \
            set(sched) != {"pull"} or len(sched) != curve["levels"]:
        raise AssertionError(f"run_level_curve root {root}: {curve}")
    secs = {"curve": [], "run": []}
    for _ in range(3):  # in turns, so both see the same state of the caches
        for name, fn in (("curve", lambda: eng.run_level_curve(root)), ("run", lambda: eng.run(root))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            secs[name].append(time.perf_counter() - t0)
    curve_s, run_s = (float(np.mean(secs[k])) for k in ("curve", "run"))
    log(f"RelayEngine.run_level_curve root {root}: {curve_s:.6f} s (run {run_s:.6f} s on the same "
        f"root; mean of 3 each, in turns); occupancy {curve['occupancy']} sums to the oracle's {int(reached.sum())} reachable; "
        f"frontier out-edges {curve['frontier_edges']}; schedule all pull ({curve['direction_schedule']['mode']}); "
        f"host reads {run['host_reads']}, replays {run['replays']}, issued {run['issued']}; launches "
        f"{launches}")
    return dict(curve_s=curve_s, run_s=run_s, curve=curve)


# ------------------------------------------------- the relay hybrid --

def hybrid_engine(P, rg, expansion: str):
    """``RelayEngine(sparse_hybrid=True)`` (the default) on the cell's
    layout, built after the dense engines are freed (one copy of the masks
    on the card): the sparse body's CSR and third array built and shipped,
    timed."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    heng = P.RelayEngine(rg, device="cuda", direction="auto", expansion=expansion,
                         **({"tiles_budget_bytes": TILES_BUDGET} if expansion == "mxu" else {}))
    torch.cuda.synchronize()
    from bfs_tpu_torch.ops import sparse as S

    log(f"hybrid {expansion}: RelayEngine(sparse_hybrid=True) in {time.perf_counter() - t0:.2f} s "
        f"(masks, the sparse body's CSR and its {'key' if expansion == 'mxu' else 'rank'} "
        f"array shipped{', tiles built' if expansion == 'mxu' else ''}); budgets (vertices, "
        f"edges) {S.sparse_budgets(rg.vr, len(rg.adj_dst))}; config {heng.direction}")
    return heng


def hybrid_phase(heng, g, roots, want: dict, pull: dict, dense_s: float, K, D) -> dict:
    """The relay engine's hybrid schedule on one arm (``RelayEngine.run``
    with ``sparse_hybrid=True``) for the 4 roots in ``auto`` and ``push``,
    on the captured switch loop and the eager loop: each result equal to
    ``canonical_bfs``, to the dense relay search and to pull, clean under
    the DeviceChecker; each schedule (``run_level_curve``) equal to the
    host's recomputation with the relay's budgets; the supersteps issued by
    body adding up to the supersteps issued and split as the schedule; the
    dense kernels launched once per dense superstep and the control step
    once per superstep issued.  Then each superstep's device time by body
    (CUDA events around each replay) in ``auto``, ``push`` and with every
    superstep dense (``alpha = beta = 1e9``), the predicate step alone, a
    device trace, and ``run_many_device`` on the 4 roots."""
    import numpy as np
    import torch

    from bfs_tpu_torch.graph.csr import INF_DIST
    from bfs_tpu_torch.ops import control as C
    from bfs_tpu_torch.ops import sparse as S
    from bfs_tpu_torch.utils.timing import cold_ms

    rg, arm = heng.relay_graph, heng.expansion
    label = f"hybrid {arm}"
    budgets = S.sparse_budgets(rg.vr, len(rg.adj_dst))
    outdeg = np.bincount(g.src, minlength=g.num_vertices).astype(np.int64)
    cfg = heng.direction
    per_step = MXU_STEP if arm == "mxu" else GATHER_STEP
    out = {"mean": {}, "schedules": {}, "split": {}}
    sums = {r: root_sums(outdeg, want, r, budgets) for r in roots}
    for mode in ("auto", "push"):
        heng.direction = D.DirectionConfig(mode, cfg.alpha, cfg.beta)
        expected = {r: host_schedule(sums[r], mode, cfg.alpha, cfg.beta) for r in roots}
        for loop in ("blocks", "eager"):
            heng.loop = loop
            heng.run(roots[0])  # warm: the captures
            K.reset_launches()
            rows = []
            for r in roots:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = heng.run(r)
                secs = time.perf_counter() - t0
                run = dict(heng.last_run)
                (dist, parent), relay = want[r]
                for name, d, p in (("canonical_bfs", dist, parent),
                                   ("the dense relay search", relay.dist, relay.parent),
                                   ("pull", pull[r].dist, pull[r].parent)):
                    if not (np.array_equal(res.dist, d) and np.array_equal(res.parent, p)):
                        raise AssertionError(f"{label} {mode} ({loop}) root {r}: differs from {name}")
                if res.num_levels != relay.num_levels or run["live"] != res.num_levels:
                    raise AssertionError(f"{label} {mode} ({loop}) root {r}: {res.num_levels} levels, "
                                         f"{run['live']} live, dense relay {relay.num_levels}")
                verify(f"{label} {mode} ({loop}) root {r}", res.dist, res.parent, r)
                rows.append(dict(root=r, secs=secs, **run))
                del res
            issued = sum(row["issued"] for row in rows)
            dense = sum(row["issued_pull"] for row in rows)
            launches = {k: K.LAUNCHES[k] for k in per_step}
            expect = {k: v * dense for k, v in per_step.items()}
            expect["loop_control"] = issued if loop == "blocks" else 0
            if launches != expect or issued != sum(row["issued_push"] for row in rows) + dense:
                raise AssertionError(f"{label} {mode} ({loop}): launches {launches} in {issued} "
                                     f"supersteps issued, {dense} dense; expected {expect}")
            if loop == "blocks" and not all(launches.values()):
                raise AssertionError(f"{label} {mode}: a kernel of the path was not launched: "
                                     f"{launches}")
            for row in rows:
                r = row["root"]
                dist = want[r][0][0]
                curve = heng.run_level_curve(r)
                sched = curve["direction_schedule"]
                if sched["schedule"] != expected[r]:
                    raise AssertionError(f"{label} {mode} ({loop}) root {r}: schedule "
                                         f"{sched['schedule']}, the host's {expected[r]}")
                split = (row["issued_push"], row["issued_pull"])
                if split != (sched["push_supersteps"], sched["pull_supersteps"]) or \
                        (loop == "blocks" and row["replays"] != row["issued"]):
                    raise AssertionError(f"{label} {mode} ({loop}) root {r}: {row}, schedule {sched}")
                reached = dist != INF_DIST
                if curve["occupancy"] != [int(x) for x in np.bincount(dist[reached])]:
                    raise AssertionError(f"{label} {mode} root {r}: occupancy {curve['occupancy']}")
                if mode == "auto" and loop == "blocks":
                    out["schedules"][r] = sched["schedule"]
                log(f"{label} {mode} root {r}, {'captured' if loop == 'blocks' else 'eager'} loop: "
                    f"{row['secs']:.6f} s (level loop {row['loop_s']:.6f} s, results "
                    f"{row['result_s']:.6f} s), {row['level']} levels; host reads {row['host_reads']}, "
                    f"replays {row['replays']} (sparse {split[0]}, dense {split[1]}), issued "
                    f"{row['issued']}; schedule {','.join(sched['schedule'])}, equal to the host's; "
                    "oracle-exact, equal to the dense relay and to pull, DeviceChecker clean")
            out["mean"][(mode, loop)] = float(np.mean([row["secs"] for row in rows]))
            out["split"][(mode, loop)] = {k: float(np.mean([row[k] for row in rows]))
                                          for k in ("secs", "loop_s", "result_s", "host_reads")}
            log(f"{label} {mode} ({loop}): launches {launches} in {issued} supersteps issued, "
                f"{dense} dense")
    log(f"{label}, mean over the roots (search s / level loop s / result copy s / host reads): "
        + "; ".join(f"{m} {'captured' if lp == 'blocks' else 'eager'} {v['secs']:.6f} / "
                    f"{v['loop_s']:.6f} / {v['result_s']:.6f} / {v['host_reads']:g}"
                    for (m, lp), v in out["split"].items())
        + f"; the dense search (sparse_hybrid=False, captured blocks of 4) {dense_s:.6f} s")
    heng.loop = "blocks"
    times = {}
    for name, c in (("auto", cfg), ("push", D.DirectionConfig("push", cfg.alpha, cfg.beta)),
                    ("dense", D.DirectionConfig("auto", 1e9, 1e9))):
        heng.direction = c
        times[name] = []
        heng.run(roots[0], times=times[name])
    if {b for b, _ in times["dense"]} != {1} or len(times["dense"]) != len(times["auto"]):
        raise AssertionError(f"{label}: alpha = beta = 1e9 did not run every superstep dense: "
                             f"{times['dense']}")
    names = ("sparse", "dense")
    sparse_levels = [i for i, (b, _) in enumerate(times["push"]) if b == 0]
    sparse_ms = [times["push"][i][1] for i in sparse_levels]
    dense_ms = [times["dense"][i][1] for i in sparse_levels]
    log(f"{label}, root {roots[0]}: device ms of each superstep's replay (CUDA events), by level: "
        + "; ".join(f"{i + 1}: auto {names[a[0]]} {a[1]:.4f} | push {names[p[0]]} {p[1]:.4f} | "
                    f"dense {d[1]:.4f}" for i, (a, p, d) in enumerate(
                        zip(times["auto"], times["push"], times["dense"])))
        + f"; on the {len(sparse_levels)} levels push runs sparse: sparse "
        + ", ".join(f"{x:.4f}" for x in sparse_ms) + " against dense "
        + ", ".join(f"{x:.4f}" for x in dense_ms))
    pred = {}
    for mode in ("auto", "push"):
        heng.direction = D.DirectionConfig(mode, cfg.alpha, cfg.beta)
        loop = heng._switch_loop(heng.packed)
        words = 1 if heng.packed else 2
        fwords, dstate, ctl = (loop.buffers[i].clone() for i in (words, -2, -1))
        adj = heng._sparse_tensors_for(heng.packed)
        pred[mode] = cold_ms(lambda: heng._next_body(mode, dstate, ctl[C.USE_PULL], fwords, adj,
                                                     ctl), 10)
    log(f"{label}: the predicate step alone (cold, mean of 10; the masses of a {rg.vr}-vertex "
        f"frontier, the rule, the gated writes): auto {pred['auto']:.4f} ms, push "
        f"{pred['push']:.4f} ms")
    heng.direction = cfg
    body = sparse_body_table(heng, roots[0], label)
    idle = device_trace(f"{label} auto root {roots[0]}, captured", lambda: heng.run(roots[0]),
                        out["mean"][("auto", "blocks")], "loop_control")
    heng.run_many_device(roots)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states = heng.run_many_device(roots)
    torch.cuda.synchronize()
    many_s = time.perf_counter() - t0
    many = dict(heng.last_run)
    for r, st in zip(roots, states):
        d, p = heng.to_original_device(st, r)
        (dist, parent), _ = want[r]
        if not (np.array_equal(d.cpu().numpy(), dist) and np.array_equal(p.cpu().numpy(), parent)):
            raise AssertionError(f"{label} run_many_device root {r}: differs from canonical_bfs")
        verify(f"{label} run_many_device root {r}", d, p, r)
    if many["issued"] != many["issued_push"] + many["issued_pull"]:
        raise AssertionError(f"{label} run_many_device: {many}")
    log(f"{label} run_many_device, {len(roots)} roots chained: {many_s:.6f} s (no result copy); "
        f"host reads {many['host_reads']}, replays {many['replays']} (sparse {many['issued_push']}, "
        f"dense {many['issued_pull']}); every state oracle-exact, DeviceChecker clean")
    out.update(times=times, sparse_ms=sparse_ms, dense_ms=dense_ms, predicate_ms=pred, idle=idle,
               many_s=many_s, many=many, body=body)
    return out


def sparse_body_table(heng, root: int, label: str) -> list:
    """The bodies alone, stepped eagerly on the packed carry from ``root``
    (``step_dispatch``): on every level where ``push`` takes the sparse
    superstep, its device ms (``cold_ms``: L2 flushed, launches hidden
    behind a device sleep, mean of 3) beside the dense superstep's on the
    same state, and the kernels one sparse superstep launches (a profiler
    trace), the frontier's vertices and out-edges beside them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bfs_tpu_torch.ops import sparse as S
    from bfs_tpu_torch.utils.timing import cold_ms

    vr = heng.relay_graph.vr
    adj = heng._sparse_tensors_for(True)
    st, rows = heng.init_packed_state(root), []
    while bool(st.changed):
        take = heng.take_sparse(st)
        if take:
            fsize, fedges = heng.frontier_stats(st)
            sparse_ms = cold_ms(lambda: S.sparse_superstep(st, adj, vr), reps=3, warm=1)
            copy = st._replace(packed=st.packed.clone(), fwords=st.fwords.clone())
            dense_ms = cold_ms(lambda: heng.superstep_packed(copy), reps=3, warm=1)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                S.sparse_superstep(st, adj, vr)
                torch.cuda.synchronize()
            kernels = sum(1 for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA)
            rows.append(dict(level=st.level + 1, fsize=fsize, fedges=fedges, sparse_ms=sparse_ms,
                             dense_ms=dense_ms, kernels=kernels))
        st, _ = heng.step_dispatch(st, take_sparse=take)
    log(f"{label}, root {root}: the bodies alone on the levels push runs sparse (device ms, cold, "
        "mean of 3; frontier vertices / out-edges; device activities of one sparse superstep): " + "; ".join(
            f"{r['level']}: sparse {r['sparse_ms']:.4f} | dense {r['dense_ms']:.4f} "
            f"({r['fsize']} / {r['fedges']}; {r['kernels']})" for r in rows))
    return rows


SERVE_RELAY_STEP = ("benes_outer_pass", "benes_local_pass", "class_rowmin", "packed_update")
# What the serve phase may not count unless a fault was injected on purpose.
SERVE_DEGRADED = ("oracle_served", "device_errors", "watchdog_timeouts", "breaker_short_circuits")


def serve_phase(P, g, store: str, pg, sources, roots, batch, want, card: str, K, L,
                algo_want=None) -> dict:
    """The query server (``bfs_tpu_torch.serve``) at full width: a
    ``GraphRegistry`` over the script's bundle store (warm hits for the
    relay layout and the pull layout, which is put there first) and a
    ``BfsServer(engine="pull", max_batch=32, tick_s=0.002, verify_sample=4)``
    without a result cache.  Round 1: 40 single-source queries from 4
    submitter threads as they come, 2 collapsed multi-source queries of 4,
    one tree query of 2 and one ``query_path``; then staged ticks (the
    server paused while 4 threads submit): relay 32 (``run_multi_elem``, its
    first call building the route index), relay 4 (``run_multi``) and push
    8.  Round 2 repeats every (engine, bucket) of round 1 as staged ticks
    and must be all executable-cache hits.  Then a second server on the
    same registry with the default result cache (256) runs 2 staged pull
    ticks of 32, whose replies it keeps: result seconds beside round 2's.
    Every reply is held bit for bit against the relay batch's trees and the
    roots' oracle results; no degradation may be counted; launches are
    counted per staged tick.  Then one ``SegmentedBatchRunner`` push tick
    (:func:`ckpt_serve_tick`), and ``registry_sssp`` and ``registry_cc`` on
    the same registry (:func:`algo_registry_phase`) against ``algo_want``
    (the fused SSSP result of ``roots[0]`` and the CC labels)."""
    import threading

    import numpy as np
    import torch
    from bfs_tpu_torch.cache.layout import pull_key
    from bfs_tpu_torch.graph.ell import DEFAULT_K, pull_to_arrays
    from bfs_tpu_torch.serve import BfsServer, GraphRegistry
    from bfs_tpu_torch.utils.metrics import ServeMetrics

    truth = {int(s): (batch.dist[i], batch.parent[i]) for i, s in enumerate(sources)}
    truth.update({int(r): want[r][0] for r in roots})
    cache = P.LayoutCache(store)
    cache.save(pull_key(g, DEFAULT_K, 64), pull_to_arrays(pg),
               {"kind": "pull", "num_vertices": g.num_vertices, "num_edges": g.num_edges})
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    disk = ServeMetrics()
    reg = GraphRegistry(layout_cache=cache, metrics=disk)
    reg.register("g", g)
    layouts = {e: reg.layout("g", e) for e in ("relay", "pull", "push")}
    setup_s = time.perf_counter() - t0
    log(f"serve: registered, layouts in {setup_s:.3f} s (relay bundle "
        f"{reg.layout_info().get('cache')}, relay load {reg.layout_info().get('load_seconds')}; "
        f"pull bundle from the store; push built)")

    def exact(mode, srcs, reply, label):
        if mode == "single":
            got, exp = (reply.dist, reply.parent), truth[srcs[0]]
        elif mode == "tree":
            got, exp = (reply.dist, reply.parent), tuple(np.stack([truth[s][k] for s in srcs])
                                                         for k in (0, 1))
        else:
            exp = P.collapse_multi_source(P.MultiBfsResult(
                np.asarray(srcs, dtype=np.int32), *(np.stack([truth[s][k] for s in srcs])
                                                    for k in (0, 1)), 0))
            got = (reply.dist, reply.parent)
        for a, b in zip(got, exp):
            if not np.array_equal(a, b):
                raise AssertionError(f"serve {label}: reply for {mode} {srcs} differs")

    def staged(srv, engine, srcs, label):
        """One tick: the server paused while 4 threads submit, then released."""
        torch.cuda.synchronize()
        K.reset_launches()
        srv.pause()
        futs = []

        def submit(part):
            for s in srcs[part::4]:
                futs.append((s, srv.query("g", s, engine=engine)))

        threads = [threading.Thread(target=submit, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        srv.resume()
        for s, f in futs:
            exact("single", [s], f.result(600), label)
        torch.cuda.synchronize()
        tick = srv.tick_log()[-1]
        launched = {k: v for k, v in K.LAUNCHES.items() if v}
        if (tick["engine"], tick["sources"], tick["status"]) != (engine, len(srcs), "ok"):
            raise AssertionError(f"serve {label}: not one device tick of {len(srcs)}: {tick}")
        return tick, launched

    def check_launches(label, engine, tick, launched, first_relay32=False):
        issued = tick["issued"]
        if engine == "relay" and tick["bucket"] % 32 == 0:
            loop = {k: launched.get(k, 0) for k in ("elem_route_gather", "elem_rowmin_update",
                                                    "loop_control")}
            if set(loop.values()) != {issued}:
                raise AssertionError(f"serve {label}: loop kernels {loop} in {issued} supersteps")
            built = [launched.get(k, 0) > 0 for k in ELEM_BUILD]
            if all(built) != first_relay32 or any(built) != first_relay32:
                raise AssertionError(f"serve {label}: route index launches {launched}")
        elif engine == "relay":
            steps = launched.get("packed_update", 0)
            want_l = {k: GATHER_STEP[k] * steps for k in (*SERVE_RELAY_STEP, "loop_control")}
            got_l = {k: launched.get(k, 0) for k in want_l}
            if steps <= 0 or got_l != want_l:
                raise AssertionError(f"serve {label}: K1-K4 launches {got_l}, expected {want_l}")
        elif launched != {"loop_control": issued}:
            raise AssertionError(f"serve {label}: launches {launched} in {issued} supersteps")

    def line(tick):
        return (f"{tick['engine']} bucket {tick['bucket']} ({tick['sources']} real, "
                f"{tick['requests']} requests, hit {tick['compile_hit']}): service "
                f"{tick['service_s']:.6f} s, loop {tick['loop_s']}, result {tick['result_s']} "
                f"(engine copy) + {tick['own_s']:.6f} s (rows copied out), replies keep "
                f"{tick['kept_bytes']} bytes")

    srcs = [int(s) for s in sources]
    out = {"ticks": []}
    pool = srcs + [int(r) for r in roots]
    kw = dict(engine="pull", max_batch=32, tick_s=0.002, verify_sample=4)
    with BfsServer(reg, result_cache_size=0, metrics=disk, **kw) as srv:
        # ---- round 1: free-running pull traffic from 4 submitters
        K.reset_launches()
        t0 = time.perf_counter()
        singles = srcs[:36] + [int(r) for r in roots]
        futs = []

        def submitter(part):
            for s in singles[part::4]:
                futs.append(("single", [s], srv.query("g", s)))
                time.sleep(0.001)

        threads = [threading.Thread(target=submitter, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for mode, group in (("collapse", srcs[40:44]), ("collapse", srcs[44:48]),
                            ("tree", srcs[48:50])):
            futs.append((mode, group, srv.query_multi("g", group, collapse=mode == "collapse")))
        u = int(roots[0])
        far = int(np.argmax(np.where(truth[u][0] == P.INF_DIST, -1, truth[u][0])))
        path_fut = srv.query_path("g", u, far)
        for t in threads:
            t.join()
        for mode, group, f in futs:
            exact(mode, group, f.result(600), "round 1")
        path = path_fut.result(600)
        if path.dist != int(truth[u][0][far]) or len(path.path) != path.dist + 1 or any(
                int(truth[u][1][b]) != a for a, b in zip(path.path, path.path[1:])):
            raise AssertionError(f"serve: query_path {u} -> {far} wrong: {path}")
        torch.cuda.synchronize()
        round1_s = time.perf_counter() - t0
        ticks1 = srv.tick_log()
        issued1 = sum(t["issued"] for t in ticks1)
        if K.LAUNCHES["loop_control"] != issued1 or any(
                v for k, v in K.LAUNCHES.items() if k != "loop_control"):
            raise AssertionError(f"serve round 1: launches {dict(K.LAUNCHES)} in {issued1} "
                                 "supersteps")
        rep1 = srv.report()
        log(f"serve round 1 (pull, 4 submitters, tick 2 ms): {len(futs) + 1} queries in "
            f"{round1_s:.3f} s, {len(ticks1)} ticks, p50 {rep1['latency_p50_ms']:.3f} ms, p99 "
            f"{rep1['latency_p99_ms']:.3f} ms, {rep1['queries_per_sec']:.3f} queries/s; every "
            f"reply exact; loop_control {issued1} = supersteps issued; ticks: "
            + "; ".join(line(t) for t in ticks1))
        out["ticks"] += ticks1
        # ---- the staged engine ticks of round 1
        plan = [("relay", srcs[:32], "relay 32"), ("relay", [int(r) for r in roots], "relay 4"),
                ("push", srcs[:8], "push 8")]
        for engine, group, label in plan:
            tick, launched = staged(srv, engine, group, label)
            check_launches(label, engine, tick, launched, first_relay32=label == "relay 32")
            log(f"serve {label}: " + line(tick) + f"; launches {launched}")
            out["ticks"].append(tick)
        buckets = sorted({(t["engine"], t["bucket"]) for t in out["ticks"]})
        # ---- round 2: the same buckets, every one an executable-cache hit
        hits0, misses0 = srv.exe_cache.hits, srv.exe_cache.misses
        round2 = []
        for engine, bucket in buckets:
            group = pool[-bucket:]  # no result cache: any sources are device work
            tick, launched = staged(srv, engine, group, f"round 2 {engine} {bucket}")
            check_launches(f"round 2 {engine} {bucket}", engine, tick, launched)
            round2.append(tick)
        hits, misses = srv.exe_cache.hits - hits0, srv.exe_cache.misses - misses0
        if misses or hits != len(buckets) or not all(t["compile_hit"] for t in round2):
            raise AssertionError(f"serve round 2: {hits} hits, {misses} misses over {buckets}")
        rep = srv.report()
        log(f"serve round 2 (staged, result cache 0): {len(buckets)} ticks {buckets}, "
            f"executable-cache hits {hits} of {hits + misses} (100%); " +
            "; ".join(line(t) for t in round2))
        counters = rep["counters"]
        degraded = {k: counters.get(k, 0) for k in SERVE_DEGRADED}
        if any(degraded.values()):
            raise AssertionError(f"serve: degraded ticks counted {degraded}")
        out.update(report=rep, round2=round2, buckets=buckets, round1_s=round1_s)
        # ---- the transfer guard over two warm ticks, relay 4 and pull 32:
        # each device batch runs in its guarded region under sync-debug mode
        # 'error'; a violation would fail the batch onto the oracle
        os.environ["BFS_TPU_TORCH_TRANSFER_GUARD"] = "1"
        try:
            guarded = []
            for engine, group in (("relay", [int(r) for r in roots]), ("pull", pool[:32])):
                label = f"guarded {engine} {len(group)}"
                try:
                    tick, launched = staged(srv, engine, group, label)
                except AssertionError as exc:
                    raise AssertionError(f"{exc}; health {srv.report()['health']}") from None
                check_launches(label, engine, tick, launched)
                guarded.append(tick)
        finally:
            del os.environ["BFS_TPU_TORCH_TRANSFER_GUARD"]
        log("serve under BFS_TPU_TORCH_TRANSFER_GUARD=1 (each device batch in "
            "serve.device_batch/g/<engine>, sync-debug mode 'error'): no violation; "
            + "; ".join(line(t) for t in guarded) + f" ({card})")
        out["guarded"] = guarded
        log(f"serve report: p50 {rep['latency_p50_ms']:.3f} ms, p99 {rep['latency_p99_ms']:.3f} "
            f"ms, {rep['queries_per_sec']:.3f} queries/s over {rep['served']} queries, "
            f"compile hit rate {rep['compile_hit_rate']:.4f}; integrity checks "
            f"{counters.get('integrity_checks', 0)} clean; {degraded}; resident "
            f"{rep['registry']['resident_bytes']} bytes {rep['registry']['resident']}")
    # ---- kept replies: the default result cache holds every reply
    with BfsServer(reg, **kw) as srv:
        kept = []
        for i, group in enumerate((srcs[:32], srcs[32:64])):
            tick, _ = staged(srv, "pull", group, f"kept {i}")
            kept.append(tick)
        log("serve, result cache 256 (replies kept): " + "; ".join(line(t) for t in kept))
        out["kept"] = kept
        out["kept_report"] = srv.report()
    zero = [t for t in out["round2"] if (t["engine"], t["bucket"]) == ("pull", 32)]
    out["result_s"] = {
        "cache 0": [(t["result_s"] or 0.0) + t["own_s"] for t in zero],
        "cache 256": [(t["result_s"] or 0.0) + t["own_s"] for t in out["kept"]],
    }
    out["segmented"] = ckpt_serve_tick(reg, srcs[:CKPT_MULTI], truth, disk, K, L, card)
    out["algo"] = algo_registry_phase(reg, roots[0], *algo_want, K, L, card)
    out["peak"] = torch.cuda.max_memory_allocated() - base
    out["setup_s"] = setup_s
    log(f"serve: result seconds of a pull bucket-32 tick (engine copy + rows copied out): "
        f"cache 0 {out['result_s']['cache 0']}, cache 256 {out['result_s']['cache 256']}; "
        f"device memory peak {out['peak']} bytes over the phase; layouts {sorted(layouts)}; "
        f"disk {disk.count('layout_disk_hits')} hits, {disk.count('layout_disk_misses')} misses "
        f"({card})")
    if disk.count("layout_disk_hits") != 2 or disk.count("layout_disk_misses"):
        raise AssertionError("serve: the relay and pull layouts were not warm bundle hits")
    del reg, layouts
    torch.cuda.empty_cache()
    return out


# The classic load generator on the relay engine: a steady run of
# LOADGEN_REQUESTS from LOADGEN_THREADS submitters once every bucket is warm.
LOADGEN_REQUESTS = 200
LOADGEN_THREADS = 8


def loadgen_phase(P, g, store: str, sources, batch, seed: int, K, card: str) -> dict:
    """The load generator's classic mode (``bfs_tpu_torch.tools.
    serve_loadgen``) on ``BfsServer(engine="relay", max_batch=32,
    tick_s=0.002, verify_sample=4)`` over a registry warm-loading the
    script's bundle store: :func:`~serve_loadgen.warmup` of buckets 1–32
    (lock-step ``run_multi`` below 32, ``run_multi_elem`` at 32, whose first
    tick builds the route index), then :func:`~serve_loadgen.run_classic`
    of ``LOADGEN_REQUESTS`` drawn from the 64-source batch at concurrency
    ``LOADGEN_THREADS``.  Single and tree replies are held bit for bit
    against the batch's trees, collapsed ones on ``dist`` against the
    trees' minimum and on ``parent`` through the ``DeviceChecker``; the
    steady hit rate must be 1.0, no tick degraded, and the relay kernels'
    launches equal to the supersteps the steady ticks issued."""
    import numpy as np
    import torch
    from bfs_tpu_torch.serve import BfsServer, GraphRegistry
    from bfs_tpu_torch.serve.executor import DEVICE_LOCK
    from bfs_tpu_torch.tools import serve_loadgen as LG
    from bfs_tpu_torch.utils.metrics import ServeMetrics

    truth = LG.Truth(rows={int(s): (batch.dist[i], batch.parent[i])
                           for i, s in enumerate(sources)})

    def device_check(dist, parent, srcs):
        with DEVICE_LOCK:  # the card's calls of other threads wait out a capture
            return CHECKER["dc"].check(dist, parent, srcs)

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    metrics = ServeMetrics()
    reg = GraphRegistry(layout_cache=P.LayoutCache(store), metrics=metrics)
    out = {}
    with BfsServer(reg, engine="relay", max_batch=32, tick_s=0.002, verify_sample=4,
                   metrics=metrics) as srv:
        srv.register("g", g)
        K.reset_launches()
        t0 = time.perf_counter()
        nwarm = LG.warmup(srv, "g", g.num_vertices, 32)
        torch.cuda.synchronize()
        out["warm_s"] = time.perf_counter() - t0
        out["warm_launches"] = {k: v for k, v in K.LAUNCHES.items() if v}
        warm = srv.tick_log()
        if sorted(t["bucket"] for t in warm) != [1, 2, 4, 8, 16, 32] or not all(
                built in out["warm_launches"] for built in ELEM_BUILD):
            raise AssertionError(f"loadgen warm-up: ticks {warm}, launches {out['warm_launches']}")
        if metrics.count("layout_disk_hits") != 1 or metrics.count("layout_disk_misses"):
            raise AssertionError("loadgen: the relay layout was not a warm bundle hit")
        log(f"loadgen warm-up: {nwarm} queries, buckets 1-32 in {out['warm_s']:.3f} s (relay "
            f"layout a warm bundle hit); launches {out['warm_launches']}")
        rng = np.random.default_rng(seed + 23)
        queries = LG.make_queries(rng, sources, LOADGEN_REQUESTS)
        K.reset_launches()
        res = LG.run_classic(srv, "g", queries, truth=truth, check=device_check,
                             concurrency=LOADGEN_THREADS)
        torch.cuda.synchronize()
        launched = {k: v for k, v in K.LAUNCHES.items() if v}
    why = LG.failures(res)
    counters = res["server_report"]["counters"]
    degraded = {k: counters.get(k, 0) for k in SERVE_DEGRADED if counters.get(k, 0)}
    if why or degraded or any(t["status"] != "ok" for t in res["ticks"]):
        raise AssertionError(f"loadgen: {why}, degraded {degraded}")
    lock_steps = sum(t["issued"] for t in res["ticks"] if t["bucket"] % 32)
    elem_steps = sum(t["issued"] for t in res["ticks"] if not t["bucket"] % 32)
    want = {k: GATHER_STEP[k] * lock_steps for k in SERVE_RELAY_STEP}
    want.update(elem_route_gather=elem_steps, elem_rowmin_update=elem_steps,
                loop_control=lock_steps + elem_steps)
    if launched != {k: v for k, v in want.items() if v}:
        raise AssertionError(f"loadgen: launches {launched}, expected {want} for {lock_steps} "
                             f"lock-step and {elem_steps} element-major supersteps")
    kinds = {m: sum(q[1] == m for q in queries) for m in ("single", "collapse", "tree")}
    out.update(res=res, launches=launched, wall_s=time.perf_counter() - t_phase)
    log(f"loadgen classic (relay, max_batch 32, tick 2 ms, verify 1 in 4; R-MAT scale "
        f"{int(np.log2(g.num_vertices))}, {card}): {res['requests']} requests {kinds} from "
        f"{LOADGEN_THREADS} threads, every reply checked, 0 wrong; {res['queries_per_sec']:.3f} "
        f"queries/s, p50 {res['latency_p50_ms']:.3f} ms, p99 {res['latency_p99_ms']:.3f} ms over "
        f"{res['steady_seconds']:.3f} s; steady executable-cache hit rate "
        f"{res['steady_compile_hit_rate']:.4f}; integrity checks "
        f"{counters.get('integrity_checks', 0)}, failures {res['integrity_failures']}; ticks "
        f"{res['ticks_by_bucket']} (service {sum(t['service_s'] for t in res['ticks']):.3f} s "
        f"and fan-out {sum(t['fanout_s'] for t in res['ticks']):.3f} s in all, the checks "
        f"{res['check_seconds']:.3f} s over the threads); launches {launched} = per superstep "
        f"x {lock_steps} lock-step + {elem_steps} element-major supersteps issued; phase "
        f"{out['wall_s']:.3f} s")
    del reg
    torch.cuda.empty_cache()
    return out


def prometheus_check() -> int:
    """The process registry's Prometheus text (``to_prometheus``): every
    sample line ``bfs_tpu_<name> <number>`` behind its ``# TYPE`` line.
    Returns the line count."""
    import re

    from bfs_tpu_torch.obs.registry import get_registry

    lines = get_registry().to_prometheus().splitlines()
    if not lines or len(lines) % 2:
        raise AssertionError(f"prometheus text: {len(lines)} lines")
    for head, sample in zip(lines[::2], lines[1::2]):
        name, _, value = sample.partition(" ")
        if head != f"# TYPE {name} gauge" or not re.fullmatch(r"bfs_tpu_[a-zA-Z0-9_]+", name):
            raise AssertionError(f"prometheus text: {head!r} / {sample!r}")
        float(value)
    log(f"prometheus text of the metrics registry: {len(lines)} lines, {len(lines) // 2} "
        "gauges, every one parsed")
    return len(lines)


# Landmark labels: one DEFAULT_CHUNK of roots; 2^22 x 64 x 2 B = 512 MiB of
# rows on the card at s22, under the default 2 GiB budget.
LABELS_K = 64
LABEL_PAIRS = 256  # point queries held against the batch's trees
LABEL_PATHS = 16
LABEL_VERIFY_PAIRS = 64  # with BFS_TPU_TORCH_LABELS_VERIFY=4
LABEL_IDLE = 64  # tight label answers timed one at a time on an idle card
LOCK_TICKS = 1  # pull ticks of 32, each with LOCK_WAITERS label answers timed behind it
LOCK_WAITERS = 4
LABEL_ROWS_CHECKED = 16  # landmark rows through the DeviceChecker, evenly spaced
EXACT_TIMED = 16  # exact answers timed one at a time (result cache off)
LABELS_SMALL_GB = "0.25"  # under the 512 MiB of rows: a budget reject
FLEET_POINTS = 256
FLEET_FAILOVER = 32


def pcts(secs) -> str:
    """p50 and p99 in milliseconds of a list of seconds."""
    import numpy as np

    ms = np.asarray(secs, dtype=np.float64) * 1e3
    return f"p50 {np.percentile(ms, 50):.3f} ms, p99 {np.percentile(ms, 99):.3f} ms"


def edge_keys(g):
    """The host CSR's edges as sorted int64 keys ``src * V + dst``."""
    import numpy as np

    v = g.num_vertices
    return np.sort(np.asarray(g.src, dtype=np.int64) * v + np.asarray(g.dst, dtype=np.int64))


def is_walk(keys, v: int, path) -> bool:
    import numpy as np

    p = np.asarray(path, dtype=np.int64)
    k = p[:-1] * v + p[1:]
    i = np.minimum(np.searchsorted(keys, k), keys.size - 1)
    return bool(np.all(keys[i] == k))


def label_counters(srv) -> dict:
    return {k: v for k, v in srv.metrics.report()["counters"].items() if k.startswith("label_")}


def labels_phase(P, g, store: str, sources, batch, seed: int, K, card: str) -> dict:
    """The landmark label tier (``serve/labels.py``) at full width, with
    ``BFS_TPU_TORCH_LABELS=64``: a ``BfsServer(engine="pull",
    max_batch=32)`` over the script's bundle store registers the graph
    (the cold build: the 64-root sweep on the registry's pull engine, the
    DeviceChecker rows, the sidecar save) and again (a new epoch, a warm
    sidecar hit).  ``LABEL_ROWS_CHECKED`` landmark rows pass the on-device
    verifier.
    ``LABEL_PAIRS`` point queries (``u`` from the batch's sources, ``v``
    uniform) are held against the batch's trees, their method against the
    certificate, their landmark and the device bounds of all of them against
    ``host_label_bounds``; ``LABEL_PATHS`` paths are walks of real edges of
    the right length; sampled verification at 1 in 4 is clean; then the
    latencies: a tight answer on an idle card, ``LOCK_WAITERS`` threads'
    each behind a running pull tick of 32 (a tree query, so its rows are
    held too), and, on a second
    server whose budget rejects the rows (every answer exact, the result
    cache off), an exact answer.  The lookup's device time and byte bound
    at ``LABEL_PAIRS`` pairs (CUDA events, cold L2)."""
    import threading

    import numpy as np
    import torch
    from bfs_tpu_torch.cache.layout import labels_key
    from bfs_tpu_torch.serve import BfsServer, GraphRegistry
    from bfs_tpu_torch.serve import labels as PL
    from bfs_tpu_torch.serve.executor import DEVICE_LOCK
    from bfs_tpu_torch.utils.timing import cold_ms

    v_n = g.num_vertices
    truth = {int(s): (batch.dist[i], batch.parent[i]) for i, s in enumerate(sources)}
    rng = np.random.default_rng(seed + 19)
    cache = P.LayoutCache(store)
    out = {}
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    os.environ["BFS_TPU_TORCH_LABELS"] = str(LABELS_K)
    try:
        srv = BfsServer(GraphRegistry(layout_cache=cache), engine="pull", max_batch=32)
        with srv:
            # ---- the cold build, then a warm re-register
            K.reset_launches()
            t0 = time.perf_counter()
            rec = srv.register("g", g)
            torch.cuda.synchronize()
            out["cold_s"] = time.perf_counter() - t0
            c = label_counters(srv)
            if (c.get("label_builds"), c.get("label_build_cache_misses"), c.get("label_build_errors", 0),
                    c.get("label_budget_rejects", 0)) != (1, 1, 0, 0):
                raise AssertionError(f"labels: the cold build was not one clean build: {c}")
            with DEVICE_LOCK:
                sweep = dict(srv.registry.acquire_for(rec, "pull").last_run)
            swept = dict(K.LAUNCHES)
            if {k: n for k, n in swept.items() if n} != {"loop_control": sweep["issued"]}:
                raise AssertionError(f"labels: sweep launches {swept} in {sweep['issued']} supersteps")
            launches = swept["loop_control"]
            doc, _ = cache.load(labels_key(g, LABELS_K))
            bundle = os.path.join(store, labels_key(g, LABELS_K))
            out["bundle_bytes"] = sum(os.path.getsize(os.path.join(bundle, f)) for f in os.listdir(bundle))
            out["build_s"] = float(doc["meta"]["build_seconds"])
            idx = srv._label_oracle("g", rec.epoch).index
            if idx.device_bytes != v_n * LABELS_K * 2 or srv.report()["labels"]["g@0"]["k"] != LABELS_K:
                raise AssertionError(f"labels: {idx.device_bytes} device bytes for K = {idx.k}")
            log(f"labels: cold register {out['cold_s']:.3f} s (build {out['build_s']:.3f} s: the "
                f"{LABELS_K}-root sweep on the registry's pull engine, {sweep['issued']} supersteps, "
                f"loop {sweep['loop_s']:.3f} s, results {sweep['result_s']:.3f} s, 2 DeviceChecker "
                f"rows); index {idx.nbytes} bytes, {idx.device_bytes} on the card, bundle "
                f"{out['bundle_bytes']} bytes ({card})")
            t0 = time.perf_counter()
            rows = np.unique(np.linspace(0, idx.k - 1, LABEL_ROWS_CHECKED).astype(int))
            for r in rows:
                d = np.where(idx.dist[r] == PL.LABEL_INF, P.INF_DIST, idx.dist[r].astype(np.int32))
                verify(f"label row {r}", d, idx.parent[r], int(idx.landmarks[r]))
            log(f"labels: {rows.size} of the {idx.k} landmark rows clean under the DeviceChecker in "
                f"{time.perf_counter() - t0:.3f} s")
            t0 = time.perf_counter()
            rec = srv.register("g", g)
            torch.cuda.synchronize()
            out["warm_s"] = time.perf_counter() - t0
            c = label_counters(srv)
            if (c["label_builds"], c.get("label_build_cache_hits")) != (2, 1) or \
                    srv._label_oracle("g", 0) is not None or srv._label_graveyard:
                raise AssertionError(f"labels: the re-register was not a warm hit: {c}")
            oracle = srv._label_oracle("g", rec.epoch)
            idx = oracle.index
            log(f"labels: warm re-register (epoch {rec.epoch}, sidecar hit) {out['warm_s']:.3f} s")
            # ---- point queries against the batch's trees and the host bounds
            K.reset_launches()
            us = rng.choice(np.asarray(sources), LABEL_PAIRS).astype(np.int32)
            vs = rng.integers(0, v_n, LABEL_PAIRS).astype(np.int32)
            t0 = time.perf_counter()
            replies = []
            for w in range(0, LABEL_PAIRS, 128):  # within the admission queue's 256
                futs = [srv.query_dist("g", int(u), int(v)) for u, v in zip(us[w:w + 128],
                                                                           vs[w:w + 128])]
                replies += [f.result(600) for f in futs]
            points_s = time.perf_counter() - t0
            hd, ht, hk, hu, hl = PL.host_label_bounds(idx.dist, us, vs)
            for i, r in enumerate(replies):
                want = int(truth[int(us[i])][0][vs[i]])
                method = "labels" if ht[i] else "exact"
                landmark = int(idx.landmarks[hk[i]]) if ht[i] else None
                if (r.dist, r.method, r.landmark) != (want, method, landmark):
                    raise AssertionError(f"labels: dist({us[i]}, {vs[i]}) reply {r}, want {want} "
                                         f"by {method} via {landmark}")
            got = oracle.bounds(us, vs)
            for name, a, b in zip(("dist", "tight", "best_k", "upper", "lower"), got,
                                  (hd, ht, hk, hu, hl)):
                if a.dtype != b.dtype or not np.array_equal(a, b):
                    raise AssertionError(f"labels: device {name} differs from the host evaluation")
            ticks = srv.tick_log()
            issued = sum(t["issued"] for t in ticks)
            if {k: n for k, n in K.LAUNCHES.items() if n} != ({"loop_control": issued} if issued else {}):
                raise AssertionError(f"labels: point query launches {dict(K.LAUNCHES)}, {issued} issued")
            launches += issued
            out["tight_rate"] = float(ht.mean())
            log(f"labels: {LABEL_PAIRS} point queries in {points_s:.3f} s, every reply equal to the "
                f"batch's trees; tight rate {out['tight_rate']:.4f} ({int(ht.sum())} by labels, "
                f"{int((~ht).sum())} exact, {len(ticks)} ticks, {issued} supersteps); landmarks and "
                f"the device bounds of all {LABEL_PAIRS} pairs equal to the host evaluation")
            # ---- paths: walks of real edges on the host CSR
            keys = edge_keys(g)
            reach = [(int(u), int(v)) for u, v in zip(us, vs) if truth[int(u)][0][v] != P.INF_DIST]
            for u, v in reach[:LABEL_PATHS]:
                r = srv.query_path("g", u, v).result(600)
                if r.dist != int(truth[u][0][v]) or len(r.path) != r.dist + 1 or \
                        (r.path[0], r.path[-1]) != (u, v) or not is_walk(keys, v_n, r.path):
                    raise AssertionError(f"labels: path {u} -> {v} wrong: {r}")
            log(f"labels: {LABEL_PATHS} query_path replies are walks of real edges of length dist")
            # ---- sampled verification at 1 in 4
            os.environ["BFS_TPU_TORCH_LABELS_VERIFY"] = "4"
            try:
                us2 = rng.choice(np.asarray(sources), LABEL_VERIFY_PAIRS)
                vs2 = rng.integers(0, v_n, LABEL_VERIFY_PAIRS)
                for u, v in zip(us2.tolist(), vs2.tolist()):
                    r = srv.query_dist("g", u, v).result(600)
                    if r.dist != int(truth[u][0][v]):
                        raise AssertionError(f"labels: verified reply {r} wrong")
            finally:
                del os.environ["BFS_TPU_TORCH_LABELS_VERIFY"]
            c = label_counters(srv)
            if c.get("label_verifies", 0) < 1 or c.get("label_verify_failures", 0):
                raise AssertionError(f"labels: sampled verification {c}")
            # ---- latency: a tight answer on an idle card, then behind a tick
            tight = [(int(u), int(v)) for u, v, t in zip(us, vs, ht) if t]
            idle = []
            for u, v in (tight * 2)[:LABEL_IDLE]:
                t0 = time.perf_counter()
                srv.query_dist("g", u, v).result(600)
                idle.append(time.perf_counter() - t0)
            behind, tick_s = [], []

            def wait_behind(u, v):
                t0 = time.perf_counter()
                srv.query_dist("g", u, v).result(600)
                behind.append(time.perf_counter() - t0)

            for i in range(LOCK_TICKS):
                group = [int(s) for s in rng.choice(np.asarray(sources), 32, replace=False)]
                fut = srv.query_multi("g", group, collapse=False)  # a new tree query: a tick of 32
                time.sleep(0.05)
                waiters = [threading.Thread(target=wait_behind, args=tight[(i * LOCK_WAITERS + j)
                                                                           % len(tight)])
                           for j in range(LOCK_WAITERS)]
                for t in waiters:
                    t.start()
                for t in waiters:
                    t.join()
                r = fut.result(600)
                for j, s in enumerate(group):
                    if not (np.array_equal(r.dist[j], truth[s][0])
                            and np.array_equal(r.parent[j], truth[s][1])):
                        raise AssertionError(f"labels: tree reply of {s} differs from the batch")
                tick_s.append(srv.tick_log()[-1]["service_s"])
            out.update(idle=idle, behind=behind, tick_s=tick_s)
            log(f"labels: a tight answer on an idle card {pcts(idle)} ({LABEL_IDLE} answers); behind "
                f"a running pull tick of 32 {pcts(behind)} ({len(behind)} answers, {LOCK_WAITERS} "
                f"threads behind each of {LOCK_TICKS} ticks; the ticks' service "
                f"{min(tick_s):.3f}-{max(tick_s):.3f} s)")
            # ---- the lookup alone on the card: LABEL_PAIRS pairs
            pairs = torch.from_numpy(np.stack([us, vs]).astype(np.int64)).to(oracle._dist_dev.device)
            with DEVICE_LOCK:
                out["lookup_ms"] = cold_ms(lambda: PL.label_bounds(oracle._dist_dev, pairs[0], pairs[1]),
                                           reps=20)
            moved = LABELS_K * 2 * LABEL_PAIRS * 2 + 2 * LABEL_PAIRS * 8 + 5 * LABEL_PAIRS * 4
            out["lookup_bound_ms"] = moved / HBM_BYTES_PER_S * 1e3
            out["lookup_bytes"] = moved
            log(f"labels: label_bounds on {LABEL_PAIRS} pairs {out['lookup_ms']:.4f} ms on the card "
                f"(cold L2) against a bound of {out['lookup_bound_ms']:.6f} ms ({moved} bytes: "
                f"2 x {LABELS_K} x {LABEL_PAIRS} uint16 labels, the pairs, 5 outputs)")
            out["counters"] = label_counters(srv)
            out["report"] = srv.report()["labels"]
        srv.registry.unregister("g")  # its engines and rows go before the next server's
        del srv, oracle, idx
        torch.cuda.empty_cache()
        # ---- a budget below the rows: every answer exact (result cache off)
        os.environ["BFS_TPU_TORCH_LABELS_GB"] = LABELS_SMALL_GB
        try:
            with BfsServer(GraphRegistry(layout_cache=cache), engine="pull", max_batch=32,
                           result_cache_size=0) as srv2:
                srv2.register("g", g)
                c = label_counters(srv2)
                if c != {"label_budget_rejects": 1}:
                    raise AssertionError(f"labels: budget reject counters {c}")
                exact = []
                for i, (u, v) in enumerate([(int(us[0]), int(vs[0]))] + list(zip(
                        us[1:EXACT_TIMED + 1].tolist(), vs[1:EXACT_TIMED + 1].tolist()))):
                    t0 = time.perf_counter()
                    r = srv2.query_dist("g", u, v).result(600)
                    if i:  # the first tick ships the engine and captures its loop
                        exact.append(time.perf_counter() - t0)
                    if (r.dist, r.method) != (int(truth[u][0][v]), "exact"):
                        raise AssertionError(f"labels: budget-rejected reply {r}")
                out["exact"] = exact
                log(f"labels: BFS_TPU_TORCH_LABELS_GB={LABELS_SMALL_GB}: 1 budget reject, every answer "
                    f"exact; an exact answer (a single-source pull tick, result cache off) "
                    f"{pcts(exact)} ({EXACT_TIMED} answers)")
        finally:
            del os.environ["BFS_TPU_TORCH_LABELS_GB"]
    finally:
        del os.environ["BFS_TPU_TORCH_LABELS"]
    out["launches"] = launches
    out["peak"] = torch.cuda.max_memory_allocated() - base
    log(f"labels: device memory peak {out['peak']} bytes over the phase; counters "
        f"{out['counters']} ({card})")
    torch.cuda.empty_cache()
    return out


def fleet_phase(P, g, store: str, sources, batch, seed: int, K, card: str) -> dict:
    """The load generator's fleet mode (``serve_loadgen.run_fleet``) on
    ``FleetRouter(replicas=2, engine="pull", max_batch=32)`` over the
    script's bundle store with labels at 64: the rolling register (both
    replicas warm-hit the sidecar ``labels_phase`` left), the batch's 64
    sources as routed single-source queries and ``FLEET_POINTS`` point
    queries in one shuffled mix from 4 threads with a rolling re-register
    at its half, then replica 1 closed directly and ``FLEET_FAILOVER`` more
    requests of the same kinds routed around it, then both replicas
    killed.  Every answer is held against the batch's trees; the control
    kernel's launches against the supersteps the replicas' ticks issued."""
    import numpy as np
    import torch
    from bfs_tpu_torch.serve import FleetRouter, NoReplicaAvailable
    from bfs_tpu_torch.tools import serve_loadgen as LG

    truth = LG.Truth(rows={int(s): (batch.dist[i], batch.parent[i])
                           for i, s in enumerate(sources)})
    srcs = [int(s) for s in sources]
    rng = np.random.default_rng(seed + 20)
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = {}
    os.environ["BFS_TPU_TORCH_LABELS"] = str(LABELS_K)
    try:
        rt = FleetRouter(replicas=2, layout_cache=P.LayoutCache(store), engine="pull", max_batch=32)
        with rt:
            t0 = time.perf_counter()
            rt.register("g", g)
            out["register_s"] = time.perf_counter() - t0
            for i, srv in enumerate(rt.servers):
                c = label_counters(srv)
                if (c.get("label_builds"), c.get("label_build_cache_hits")) != (1, 1) or \
                        c.get("label_build_errors", 0) or c.get("label_budget_rejects", 0):
                    raise AssertionError(f"fleet: replica {i} did not warm-hit the sidecar: {c}")
            log(f"fleet: rolling register on 2 replicas in {out['register_s']:.3f} s, both sidecar hits")
            points = zip(rng.choice(np.asarray(sources), FLEET_POINTS).tolist(),
                         rng.integers(0, g.num_vertices, FLEET_POINTS).tolist())
            mix = [("full", s, -1) for s in srcs] + [("point", a, b) for a, b in points]
            mix = [mix[i] for i in rng.permutation(len(mix))]
            chaos = LG.fleet_mix(rng, sources, FLEET_FAILOVER, point_frac=FLEET_POINTS / len(mix),
                                 num_vertices=g.num_vertices)
            K.reset_launches()
            res = LG.run_fleet(rt, "g", g, mix, truth=truth, concurrency=4, swap_at=len(mix) // 2,
                               chaos_mix=chaos)
            torch.cuda.synchronize()
            issued = sum(t["issued"] for t in res["ticks"])
            why = LG.failures(res)
            if why or res["router_failovers"] < 1:
                raise AssertionError(f"fleet: {why}; failovers {res['router_failovers']}")
            if {k: n for k, n in K.LAUNCHES.items() if n} != {"loop_control": issued}:
                raise AssertionError(f"fleet: launches {dict(K.LAUNCHES)} in {issued} supersteps")
            out.update(res=res, launches=issued)
            busy = sum(t["service_s"] for t in res["ticks"])
            log(f"fleet: {len(mix)} routed queries ({len(srcs)} single-source, {FLEET_POINTS} "
                f"point) from 4 threads, every answer equal to the batch's trees; rolling "
                f"re-register mid-load {res['epoch_swap_seconds']:.3f} s; "
                f"{res['queries_per_sec']:.3f} queries/s, p50 {res['latency_p50_ms']:.3f} ms, "
                f"p99 {res['latency_p99_ms']:.3f} ms over {res['steady_seconds']:.3f} s; "
                f"replica 1 closed: {res['chaos_requests']} more requests, all exact, p99 "
                f"{res['chaos_latency_p99_ms']:.3f} ms, {res['router_failovers']} failovers; "
                f"labels {res['labels']}; {len(res['ticks'])} ticks on 2 replicas, service "
                f"{busy:.3f} s in all, one at a time on the card's lock; loop_control {issued} "
                "= supersteps issued")
            # ---- terminal: every replica dead
            rt.kill_replica(0)
            rt.kill_replica(1)
            try:
                rt.query("g", srcs[0])
            except NoReplicaAvailable:
                pass
            else:
                raise AssertionError("fleet: a query with every replica dead did not raise")
            out["router"] = {k: v for k, v in rt.report()["router"].items() if k.startswith("router_")}
            for srv in rt.servers:
                srv.registry.unregister("g")
    finally:
        del os.environ["BFS_TPU_TORCH_LABELS"]
    out["peak"] = torch.cuda.max_memory_allocated() - base
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"fleet: every replica killed: NoReplicaAvailable; router {out['router']}; device "
        f"memory peak {out['peak']} bytes; phase {out['wall_s']:.3f} s ({card})")
    del rt
    torch.cuda.empty_cache()
    return out


def small_hybrid_checks(P, K) -> None:
    """path_graph(100) from vertex 0 on the hybrid, both arms, ``auto`` and
    ``push``: 62 levels on the packed carry, then the unpacked re-run (the
    slot flavor of the sparse body on the gather arm) to 100; its level
    curve and schedule (the re-run's, 100 levels), ``run_many_device``
    stopping at the packed cap with ``changed`` set, and the eager loop."""
    import numpy as np

    path = P.path_graph(100)
    dist, parent = P.canonical_bfs(path, 0)
    for expansion in ("gather", "mxu"):
        for mode in ("auto", "push"):
            eng = P.RelayEngine(path, expansion=expansion, direction=mode)
            res = eng.run(0)
            run = dict(eng.last_run)
            curve = eng.run_level_curve(0)
            (st,) = eng.run_many_device([0])
            eng.loop = "eager"
            eager = eng.run(0)
            for name, got in (("the captured loop", res), ("the eager loop", eager)):
                if not (np.array_equal(got.dist, dist) and np.array_equal(got.parent, parent)
                        and got.num_levels == 100):
                    raise AssertionError(f"path_graph(100) hybrid {expansion} {mode}: {name} differs "
                                         "from the oracle")
            sched = curve["direction_schedule"]
            if run["live"] != 62 + 100 or run["issued"] != run["issued_push"] + run["issued_pull"] \
                    or curve["levels"] != 100 or len(sched["schedule"]) != 100 \
                    or not (st.changed and st.level == 62):
                raise AssertionError(f"path_graph(100) hybrid {expansion} {mode}: {run}, curve "
                                     f"{curve['levels']} levels, run_many_device level {st.level}")
            log(f"path_graph(100), hybrid {expansion} {mode}: 62 packed levels then the unpacked "
                f"re-run to 100 (host reads {run['host_reads']}, replays {run['replays']}: sparse "
                f"{run['issued_push']}, dense {run['issued_pull']}); schedule of the re-run: "
                f"{sched['push_supersteps']} push, {sched['pull_supersteps']} pull; run_many_device "
                "stops at the packed cap with changed set; oracle-exact, equal to the eager loop")


# ------------------------------------------------------ superstep checkpoints --

def ckpt_config(every: int):
    from bfs_tpu_torch.resilience.superstep_ckpt import CkptConfig

    return CkptConfig("every", every)


def ckpt_relay_phase(label: str, eng, roots, want: dict, per_step: dict, K, L, card: str,
                     store: str, kill: bool = False) -> dict:
    """Superstep checkpoints on one relay engine at full width:
    ``run_segmented`` at ``every:CKPT_EVERY`` into an epoch store on disk for
    each root, timed beside the fused ``run``, with and without telemetry;
    each result equal to the fused run and the oracle, the level curve's
    direction schedule and occupancy equal to ``run_level_curve``'s, the
    epochs cleared at the end, no loop captured again (the fused runs
    captured them), live supersteps equal to the levels, and the launches
    held to the count of the supersteps issued: the dense kernels once per
    dense superstep issued (a block's dead supersteps past a segment's end
    included), the control step once per superstep issued.  With ``kill``,
    a run stopped by ``BFS_TPU_TORCH_FAULT=raise:superstep:2`` is resumed
    from its newest epoch: ``resumed_from_epoch`` reported, the result,
    schedule and occupancy bit-identical, nothing captured again, and only
    the supersteps after the epoch run."""
    import numpy as np
    import torch

    from bfs_tpu_torch.resilience import faults as F
    from bfs_tpu_torch.resilience.faults import FaultInjected
    from bfs_tpu_torch.resilience.superstep_ckpt import SuperstepCheckpointer

    def mgr(r, tag):
        return SuperstepCheckpointer(store, {"label": label, "root": int(r), "run": tag},
                                     cfg=ckpt_config(CKPT_EVERY))

    def same(name, got, r):
        (dist, parent), fused = want[r]
        for what, d, p, n in (("the oracle", dist, parent, fused.num_levels),
                              ("the fused run", fused.dist, fused.parent, fused.num_levels)):
            if not (np.array_equal(got.dist, d) and np.array_equal(got.parent, p)
                    and got.num_levels == n):
                raise AssertionError(f"{label} root {r}: {name} differs from {what}")

    out = {"rows": []}
    for r in roots:
        curve = eng.run_level_curve(r)  # warm: every loop of the path captured
        eng.run(r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused = eng.run(r)
        fused_s = time.perf_counter() - t0
        same("the fused run of this phase", fused, r)
        del fused
        caps = L.captures()
        K.reset_launches()
        m = mgr(r, "timed")
        t0 = time.perf_counter()
        res = eng.run_segmented(r, ckpt=m)
        seg_s = time.perf_counter() - t0
        run, rep = dict(eng.last_run), m.report()
        launched = {k: K.LAUNCHES[k] for k in per_step}
        expect = {k: v * run["issued_pull"] for k, v in per_step.items()}
        expect["loop_control"] = run["issued"]
        if launched != expect or not all(launched.values()):
            raise AssertionError(f"{label} root {r}, segmented: launches {launched} in "
                                 f"{run['issued']} supersteps issued, {run['issued_pull']} dense; "
                                 f"expected {expect}")
        same("the segmented run", res, r)
        verify(f"{label} segmented root {r}", res.dist, res.parent, r)
        m2 = mgr(r, "telemetry")
        res2, curve2 = eng.run_segmented(r, ckpt=m2, telemetry=True)
        same("the segmented run with telemetry", res2, r)
        if curve2["direction_schedule"] != curve["direction_schedule"] or \
                curve2["occupancy"] != curve["occupancy"]:
            raise AssertionError(f"{label} root {r}: the segmented curve {curve2} differs from "
                                 f"run_level_curve's {curve}")
        if L.captures() != caps:
            raise AssertionError(f"{label} root {r}: the segments captured {L.captures() - caps} "
                                 "loops again")
        if run["live"] != res.num_levels or m.epochs() or m2.epochs() or \
                rep["segments"] != -(-res.num_levels // CKPT_EVERY):
            raise AssertionError(f"{label} root {r}: {run}, {rep}, epochs left {m.epochs()}")
        row = dict(root=r, fused_s=fused_s, seg_s=seg_s, run=run, report=rep,
                   schedule=curve["direction_schedule"]["schedule"])
        out["rows"].append(row)
        log(f"{label} root {r}, every:{CKPT_EVERY}: fused {fused_s:.6f} s, segmented {seg_s:.6f} s "
            f"({seg_s / fused_s:.3f}x; level loop {run['loop_s']:.6f} s, of it carry copies to "
            f"the host {run['copy_s']:.6f} s and epoch writes {rep['snapshot_seconds_total']:.6f} s "
            f"(mean {rep['snapshot_seconds_mean']:.6f} s); results {run['result_s']:.6f} s); "
            f"{rep['segments']} segments, {rep['epochs_written']} epochs of "
            f"{rep['snapshot_bytes']} bytes; supersteps issued {run['issued']} (dense "
            f"{run['issued_pull']}), live {run['live']}; host reads {run['host_reads']}; launches "
            f"{launched}; result, schedule and occupancy equal to the fused run, oracle-exact, no "
            f"capture ({card})")
        del res, res2
    if kill:
        r = roots[0]
        caps = L.captures()
        os.environ["BFS_TPU_TORCH_FAULT"] = "raise:superstep:2"
        F.reset()
        try:
            eng.run_segmented(r, ckpt=mgr(r, "kill"), telemetry=True)
            raise AssertionError(f"{label}: the injected fault did not stop the run")
        except FaultInjected:
            pass
        finally:
            os.environ.pop("BFS_TPU_TORCH_FAULT", None)
            F.reset()
        m = mgr(r, "kill")
        epochs = m.epochs()
        t0 = time.perf_counter()
        res, curve2 = eng.run_segmented(r, ckpt=m, telemetry=True)
        resume_s = time.perf_counter() - t0
        run, rep = dict(eng.last_run), m.report()
        same("the resumed run", res, r)
        want_curve = eng.run_level_curve(r)
        if curve2["direction_schedule"] != want_curve["direction_schedule"] or \
                curve2["occupancy"] != want_curve["occupancy"]:
            raise AssertionError(f"{label} root {r}: the resumed curve differs")
        if rep["resumed_from_epoch"] != 2 * CKPT_EVERY or epochs != [CKPT_EVERY, 2 * CKPT_EVERY] \
                or run["live"] != res.num_levels - 2 * CKPT_EVERY or L.captures() != caps:
            raise AssertionError(f"{label} root {r}: resume {rep}, epochs {epochs}, {run}, "
                                 f"captures {L.captures() - caps}")
        out["resume"] = dict(root=r, secs=resume_s, run=run, report=rep)
        log(f"{label} root {r}: killed by raise:superstep:2 with epochs {epochs} on disk, resumed "
            f"from epoch {rep['resumed_from_epoch']} in {resume_s:.6f} s (supersteps issued "
            f"{run['issued']}, live {run['live']} of {res.num_levels}); dist, parent, schedule and "
            f"occupancy bit-identical to the fused run; no loop captured again ({card})")
    return out


def ckpt_multi_phase(eng, sources, relay, K, L, card: str, store: str) -> dict:
    """``run_multi_segmented`` on the push engine for the first
    ``CKPT_MULTI`` sources of the batch at ``every:CKPT_MULTI_EVERY``, timed
    beside the fused ``run_multi`` (which captures the batch's block first):
    every tree equal to the relay batch's (``bfs_multi``'s), the control step
    launched once per superstep issued, live supersteps equal to the
    levels, no capture."""
    import numpy as np
    import torch

    from bfs_tpu_torch.resilience.superstep_ckpt import SuperstepCheckpointer, run_multi_segmented

    eng.run_multi(sources)  # warm: the capture of this batch size
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run_multi(sources)
    fused_s = time.perf_counter() - t0
    caps = L.captures()
    K.reset_launches()
    m = SuperstepCheckpointer(store, {"multi": "push", "sources": [int(s) for s in sources]},
                              cfg=ckpt_config(CKPT_MULTI_EVERY))
    t0 = time.perf_counter()
    res = run_multi_segmented(eng, sources, ckpt=m, engine="push")
    seg_s = time.perf_counter() - t0
    run, rep = dict(eng.last_run), m.report()
    n = len(sources)
    if not (np.array_equal(res.dist, relay.dist[:n]) and np.array_equal(res.parent, relay.parent[:n])):
        raise AssertionError("run_multi_segmented(push): a tree differs from bfs_multi's")
    if K.LAUNCHES["loop_control"] != run["issued"] or run["live"] != res.num_levels \
            or L.captures() != caps or m.epochs():
        raise AssertionError(f"run_multi_segmented(push): {K.LAUNCHES['loop_control']} control "
                             f"steps, {run}, captures {L.captures() - caps}, epochs {m.epochs()}")
    log(f"run_multi_segmented(push), {n} sources, every:{CKPT_MULTI_EVERY}: fused {fused_s:.6f} s, "
        f"segmented {seg_s:.6f} s ({seg_s / fused_s:.3f}x); {rep['segments']} segments, "
        f"{rep['epochs_written']} epochs of {rep['snapshot_bytes']} bytes, epoch writes "
        f"{rep['snapshot_seconds_total']:.6f} s; supersteps issued {run['issued']}, live "
        f"{run['live']}; every tree equal to bfs_multi's, no capture ({card})")
    return dict(fused_s=fused_s, seg_s=seg_s, run=run, report=rep)


def ckpt_serve_tick(reg, srcs, truth: dict, metrics, K, L, card: str) -> dict:
    """One ``SegmentedBatchRunner`` push tick of ``len(srcs)`` sources under
    ``BFS_TPU_TORCH_CKPT=every:CKPT_MULTI_EVERY`` on the server's registry,
    after the fused runner's tick of the same sources: every row exact,
    ``ckpt_segments`` counted, the control step launched once per superstep
    issued, no capture."""
    import numpy as np
    import torch

    from bfs_tpu_torch.serve import BatchRunner, SegmentedBatchRunner, build_batch_runner

    sources = np.asarray(srcs, dtype=np.int32)
    fused = build_batch_runner(reg, "g", "push", len(srcs))
    os.environ["BFS_TPU_TORCH_CKPT"] = f"every:{CKPT_MULTI_EVERY}"
    try:
        runner = build_batch_runner(reg, "g", "push", len(srcs))
    finally:
        os.environ.pop("BFS_TPU_TORCH_CKPT", None)
    if type(fused) is not BatchRunner or not isinstance(runner, SegmentedBatchRunner):
        raise AssertionError(f"serve: runners {type(fused)} and {type(runner)}")
    fused(sources)  # warm: the bucket's capture
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fused(sources)
    fused_s = time.perf_counter() - t0
    caps, seg0 = L.captures(), metrics.count("ckpt_segments")
    K.reset_launches()
    t0 = time.perf_counter()
    res = runner(sources)
    secs = time.perf_counter() - t0
    run, segments = dict(runner.last_run), metrics.count("ckpt_segments") - seg0
    for i, s in enumerate(srcs):
        if not (np.array_equal(res.dist[i], truth[s][0]) and np.array_equal(res.parent[i], truth[s][1])):
            raise AssertionError(f"serve segmented push tick: row {i} (source {s}) differs")
    if segments <= 0 or K.LAUNCHES["loop_control"] != run["issued"] or L.captures() != caps \
            or runner.ckpt_progress() is not None:
        raise AssertionError(f"serve segmented push tick: {segments} segments, {run}, launches "
                             f"{dict(K.LAUNCHES)}, captures {L.captures() - caps}")
    log(f"serve: SegmentedBatchRunner push tick of {len(srcs)} at every:{CKPT_MULTI_EVERY}: "
        f"{secs:.6f} s (segments {run['call_s']:.6f} s, results {run['result_s']:.6f} s) against "
        f"the fused runner's {fused_s:.6f} s; ckpt_segments {segments}; supersteps issued "
        f"{run['issued']}, live {run['live']}; every row exact, no capture ({card})")
    return dict(secs=secs, fused_s=fused_s, segments=segments, run=run)


def small_ckpt_checks(P, L, store: str) -> None:
    """path_graph(100) segmented at every:16 on the default relay engine
    (hybrid ``auto``, the arm its probe selects) and the dense one: 62 packed levels in 4
    segments, the store cleared, then the unpacked re-run to 100 in 7; the
    result, schedule and occupancy equal to the fused run's, no capture."""
    import numpy as np

    from bfs_tpu_torch.resilience.superstep_ckpt import SuperstepCheckpointer

    path = P.path_graph(100)
    dist, parent = P.canonical_bfs(path, 0)
    for hybrid in (True, False):
        eng = P.RelayEngine(path, sparse_hybrid=hybrid)
        curve = eng.run_level_curve(0)
        eng.run(0)
        caps = L.captures()
        m = SuperstepCheckpointer(store, {"path": 100, "hybrid": hybrid}, cfg=ckpt_config(16))
        res, curve2 = eng.run_segmented(0, ckpt=m, telemetry=True)
        run, rep = eng.last_run, m.report()
        if not (np.array_equal(res.dist, dist) and np.array_equal(res.parent, parent)
                and res.num_levels == 100) or curve2["direction_schedule"] != \
                curve["direction_schedule"] or curve2["occupancy"] != curve["occupancy"] or \
                rep["segments"] != 4 + 7 or run["live"] != 62 + 100 or L.captures() != caps:
            raise AssertionError(f"path_graph(100) segmented (hybrid {hybrid}): {run}, {rep}")
        log(f"path_graph(100) segmented at every:16, {'hybrid auto' if hybrid else 'dense'} "
            f"{eng.expansion}: 62 packed levels in 4 segments, then the unpacked re-run to 100 in 7 "
            f"(supersteps issued {run['issued']}, live {run['live']}); oracle-exact, schedule and "
            "occupancy equal to the fused run's, no capture")


# ------------------------------------------------ the semiring algorithms --

# SSSP at this R-MAT scale runs packed (V = 32,768 < 0xFFFF) beside unpacked
# and against the heapq Dijkstra; the s22 cell runs unpacked.
ALGO_SMALL_SCALE = 15
# Segmented runs take ceil(rounds / ALGO_EPOCHS) supersteps a segment, so
# each writes at most ALGO_EPOCHS epochs; the killed run stops at boundary
# ALGO_KILL and is resumed.
ALGO_EPOCHS = 8
ALGO_KILL = 2
GRAPH500_ARGS = ["--scales", "16", "--roots", "4"]


def algo_bytes(eng, kind: str) -> int:
    """Bytes a superstep of ``kind`` (``sssp`` or ``cc``) must move on
    ``eng``'s layout: the layout read once (src and dst as int32, as the
    reference stores them; the ELL levels on pull), the SSSP weights (int32)
    once, and the carry read and written once (dist or label int32, dirty or
    frontier bool)."""
    n = eng.num_vertices + 1
    if eng.engine == "pull":
        layout = sum(t.numel() * t.element_size() for t in (eng.ell0, *eng.folds))
    else:
        layout = (eng.src.numel() + eng.dst.numel()) * 4
    weights = 4 * eng.src.numel() if kind == "sssp" else 0
    return layout + weights + 2 * 4 * n + 2 * n


def algo_step_ms(step, state, steps: int) -> float:
    """Device ms of one superstep (``cold_ms``: L2 flushed, launches hidden
    behind a device sleep, mean of 3) on the state ``steps`` supersteps into
    the run."""
    from bfs_tpu_torch.utils.timing import cold_ms

    for _ in range(steps):
        state = step(state)
    return cold_ms(lambda: step(state), reps=3, warm=1)


def cc_truth(g):
    """Each vertex's component minimum id from
    ``scipy.sparse.csgraph.connected_components`` (the host oracle at s22,
    where the Python union-find is too slow), on the edges in (dst, src)
    order that the host oracle's searches keep on the graph (a CSR of the
    reversed edges: the same components); a component's minimum id is its
    first vertex."""
    import numpy as np
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components

    from bfs_tpu_torch.oracle.bfs import _edges_by_dst

    n = g.num_vertices
    src, dst = _edges_by_dst(g)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(dst, minlength=n), out=indptr[1:])
    adj = csr_matrix((np.ones(src.size, dtype=np.int8), src, indptr), shape=(n, n))
    k, comp = connected_components(adj, directed=False)
    _, first = np.unique(comp, return_index=True)
    return first[comp].astype(np.int32), int(k)


def algo_captured(label: str, call, K, L, captures: int | None = None,
                  resumed_at: int = 0) -> tuple:
    """One algorithm run on the captured loop: ``call()`` timed, its control
    steps held to the supersteps issued and its live supersteps to the rounds
    (those after ``resumed_at`` for a resumed run); with ``captures`` the
    number of graphs it must capture.  Returns ``(result, seconds,
    loop_control launches)``."""
    import torch

    caps = L.captures()
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = call()
    secs = time.perf_counter() - t0
    run, launched, added = res.run, K.LAUNCHES["loop_control"], L.captures() - caps
    if launched != run["issued"] or run["live"] != res.rounds - resumed_at:
        raise AssertionError(f"{label}: {launched} control steps, {run['issued']} issued, "
                             f"{run['live']} live, {res.rounds} rounds")
    if captures is not None and added != captures:
        raise AssertionError(f"{label}: {added} graphs captured, {captures} expected")
    return res, secs, launched


def algo_sssp_phase(eng, g, roots, K, L, card: str) -> dict:
    """Weighted SSSP on the s22 push engine (unpacked: V > 0xFFFF): the
    max-degree root and one other at the default delta, the max-degree root
    at ``delta=inf``.  Each twice on the captured loop (the first run of a
    delta captures its loop, the second root's and every timed run capture
    nothing) and on the eager loop, equal bit for bit with the same
    rounds; ``check_sssp`` (the complete host certificate, canonical parents
    included) clean at the default delta, the ``delta=inf`` result equal to
    it bit for bit; ``sssp_device_check`` clean on all three.  Then one
    superstep's device time beside its byte bound."""
    import numpy as np

    from bfs_tpu_torch.algo import edge_weights_np, sssp
    from bfs_tpu_torch.algo.sssp import init_sssp_state, sssp_superstep, weights
    from bfs_tpu_torch.algo.substrate import DEFAULT_MAX_WEIGHT, resolve_delta
    from bfs_tpu_torch.graph.csr import INF_DIST
    from bfs_tpu_torch.oracle import check_sssp, sssp_device_check

    t0 = time.perf_counter()
    w_host = edge_weights_np(g.src, g.dst)
    weights_s = time.perf_counter() - t0
    v = eng.num_vertices
    results, rows, launches = {}, [], 0
    for i, (r, delta) in enumerate(((roots[0], None), (roots[1], None), (roots[0], "inf"))):
        eng.loop = "blocks"
        label = f"sssp root {r} delta {delta or 'default'}"
        # The first run of each delta captures its loop (the second root's
        # finds it); the timed run replays.
        _, first_s, launched = algo_captured(label, lambda: sssp(eng, r, delta=delta), K, L,
                                             captures=0 if i == 1 else 1)
        res, secs, more = algo_captured(label, lambda: sssp(eng, r, delta=delta), K, L,
                                        captures=0)
        launches += launched + more
        eng.loop = "eager"
        t0 = time.perf_counter()
        eager = sssp(eng, r, delta=delta)
        eager_s = time.perf_counter() - t0
        eng.loop = "blocks"
        if not (np.array_equal(res.dist, eager.dist) and np.array_equal(res.parent, eager.parent)
                and res.rounds == eager.rounds):
            raise AssertionError(f"{label}: the captured loop differs from the eager loop")
        t0 = time.perf_counter()
        if delta == "inf":  # the host certificate holds for the default delta's equal result
            a = results[(r, None)]
            if not (np.array_equal(a.dist, res.dist) and np.array_equal(a.parent, res.parent)):
                raise AssertionError(f"sssp root {r}: delta 64 and inf differ")
            violations = []
        elif i == 0:  # the host certificate (about 8 s) on the max-degree root only
            violations = check_sssp(g, w_host, res.dist, res.parent, r)
        else:
            violations = []
        host_s = time.perf_counter() - t0
        if violations:
            raise AssertionError(f"{label}: check_sssp {violations[:3]}")
        verdict = sssp_device_check(eng.src, eng.dst, res.dist, res.parent, r, v,
                                    DEFAULT_MAX_WEIGHT)
        if verdict:
            raise AssertionError(f"{label}: sssp_device_check {verdict}")
        results[(r, delta)] = res
        run = res.run
        rows.append(dict(root=r, delta=res.delta, secs=secs, eager_s=eager_s, rounds=res.rounds,
                         issued=run["issued"], replays=run["replays"], loop_s=run["loop_s"],
                         result_s=run["result_s"], reached=int((res.dist != INF_DIST).sum())))
        log(f"{label} (unpacked): first call {first_s:.6f} s, then {secs:.6f} s (loop {run['loop_s']:.6f} s, "
            f"results and parents {run['result_s']:.6f} s), {res.rounds} rounds, supersteps "
            f"issued {run['issued']}, replays {run['replays']}, host reads {run['host_reads']}; "
            f"eager {eager_s:.6f} s, equal bit for bit; {rows[-1]['reached']} reached, max dist "
            f"{int(res.dist[res.dist != INF_DIST].max())}; "
            + ("equal to the default delta" if delta else "check_sssp clean" if i == 0
               else "no host certificate") + f" ({host_s:.2f} s), sssp_device_check clean")
    a, b = results[(roots[0], None)], results[(roots[0], "inf")]
    if not (np.array_equal(a.dist, b.dist) and np.array_equal(a.parent, b.parent)):
        raise AssertionError(f"sssp root {roots[0]}: delta 64 and inf differ")
    delta = resolve_delta(None)
    w = weights(eng._loops, eng.src, eng.dst, DEFAULT_MAX_WEIGHT)
    state = init_sssp_state(v, roots[0], delta, eng.device)
    step_ms = algo_step_ms(lambda s: sssp_superstep(s, eng.src, eng.dst, w, delta), state,
                           a.rounds // 2)
    nbytes = algo_bytes(eng, "sssp")
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"sssp superstep (delta {delta}, state after {a.rounds // 2} rounds): "
        f"{step_ms:.4f} ms device (cold, mean of 3) against a byte bound of {bound:.4f} ms "
        f"({nbytes} bytes at 3.35 TB/s): {step_ms / bound:.1f}x; loop mean "
        f"{np.mean([r['loop_s'] / r['issued'] for r in rows]) * 1e3:.4f} ms a superstep issued; "
        f"host weights {weights_s:.2f} s; delta 64 and inf equal for root {roots[0]} "
        f"({a.rounds} and {b.rounds} rounds) ({card})")
    return dict(results=results, rows=rows, launches=launches, step_ms=step_ms, bound_ms=bound)


def algo_cc_phase(eng, g, truth, K, L, card: str) -> dict:
    """Connected components on one s22 engine (push or pull): twice on the
    captured loop (the second captures nothing) and on the eager loop, equal
    bit for bit; the labels equal each component's minimum id (``truth``),
    ``check_cc`` and ``cc_device_check`` clean; then the first superstep's
    device time (every vertex on the frontier) beside its byte bound."""
    import numpy as np

    from bfs_tpu_torch.algo import cc
    from bfs_tpu_torch.algo.cc import cc_superstep, cc_superstep_pull, init_cc_state
    from bfs_tpu_torch.oracle import cc_device_check, check_cc

    label = f"cc {eng.engine}"
    eng.loop = "blocks"
    res, first_s, launches = algo_captured(label, lambda: cc(eng), K, L)
    res, secs, more = algo_captured(label, lambda: cc(eng), K, L, captures=0)
    launches += more
    eng.loop = "eager"
    t0 = time.perf_counter()
    eager = cc(eng)
    eager_s = time.perf_counter() - t0
    eng.loop = "blocks"
    if not (np.array_equal(res.label, eager.label) and res.rounds == eager.rounds):
        raise AssertionError(f"{label}: the captured loop differs from the eager loop")
    if not np.array_equal(res.label, truth):
        raise AssertionError(f"{label}: labels differ from the components' minimum ids")
    violations = check_cc(g, res.label)
    if violations:
        raise AssertionError(f"{label}: check_cc {violations[:3]}")
    dc = CHECKER["dc"]
    verdict = cc_device_check(dc.src, dc.dst, res.label, g.num_vertices)
    if verdict:
        raise AssertionError(f"{label}: cc_device_check {verdict}")
    state = init_cc_state(eng.num_vertices, eng.device)
    if eng.engine == "pull":
        step = lambda s: cc_superstep_pull(s, eng.ell0, eng.folds)  # noqa: E731
    else:
        step = lambda s: cc_superstep(s, eng.src, eng.dst)  # noqa: E731
    step_ms = algo_step_ms(step, state, 0)
    nbytes = algo_bytes(eng, "cc")
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    run = res.run
    log(f"{label}: first call {first_s:.6f} s (captures), then {secs:.6f} s (loop "
        f"{run['loop_s']:.6f} s, results {run['result_s']:.6f} s), {res.rounds} rounds, supersteps "
        f"issued {run['issued']}, replays {run['replays']}, {res.num_components} components; eager "
        f"{eager_s:.6f} s, equal bit for bit; labels equal the components' minimum ids, check_cc "
        f"and cc_device_check clean; first superstep {step_ms:.4f} ms device against a byte bound "
        f"of {bound:.4f} ms ({nbytes} bytes): {step_ms / bound:.1f}x ({card})")
    return dict(result=res, secs=secs, first_s=first_s, eager_s=eager_s, launches=launches,
                step_ms=step_ms, bound_ms=bound)


def algo_ckpt_phase(eng, root: int, sssp_fused, cc_fused, store: str, K, L, card: str) -> dict:
    """Segmented SSSP (``root``, default delta) and CC on the s22 push
    engine, at ceil(rounds / ALGO_EPOCHS) supersteps a segment into an epoch
    store on disk: each run bit-identical to the fused one, the control step
    once per superstep issued, no graph captured (the fused runs captured
    them); then each killed at boundary ALGO_KILL by
    ``BFS_TPU_TORCH_FAULT=raise:superstep:<n>`` and resumed from its epoch,
    bit-identical."""
    import numpy as np

    from bfs_tpu_torch.algo import cc_segmented, sssp_segmented
    from bfs_tpu_torch.resilience import faults as F
    from bfs_tpu_torch.resilience.faults import FaultInjected
    from bfs_tpu_torch.resilience.superstep_ckpt import SuperstepCheckpointer

    def same(a, b) -> bool:
        if hasattr(a, "label"):
            return np.array_equal(a.label, b.label) and a.rounds == b.rounds
        return (np.array_equal(a.dist, b.dist) and np.array_equal(a.parent, b.parent)
                and a.rounds == b.rounds)

    out, launches = {}, 0
    for name, fused, run in (("sssp", sssp_fused, lambda m: sssp_segmented(eng, root, ckpt=m)),
                             ("cc", cc_fused, lambda m: cc_segmented(eng, ckpt=m))):
        every = max(1, -(-fused.rounds // ALGO_EPOCHS))
        cfg = ckpt_config(every)
        caps = L.captures()
        m = SuperstepCheckpointer(store, {"algo": name, "root": root, "run": "whole"}, cfg=cfg)
        res, secs, launched = algo_captured(f"segmented {name}", lambda: run(m), K, L, captures=0)
        launches += launched
        rep = m.report()
        if not same(res, fused) or rep["epochs_written"] > ALGO_EPOCHS or m.epochs():
            raise AssertionError(f"segmented {name}: differs from the fused run or {rep}")
        key = {"algo": name, "root": root, "run": "killed"}
        os.environ["BFS_TPU_TORCH_FAULT"] = f"raise:superstep:{ALGO_KILL}"
        F.reset()
        try:
            run(SuperstepCheckpointer(store, key, cfg=cfg))
            raise AssertionError(f"segmented {name}: the fault at boundary {ALGO_KILL} did not fire")
        except FaultInjected:
            pass
        finally:
            os.environ.pop("BFS_TPU_TORCH_FAULT", None)
            F.reset()
        m2 = SuperstepCheckpointer(store, key, cfg=cfg)
        resumed, rsecs, launched = algo_captured(f"resumed {name}", lambda: run(m2), K, L,
                                                 captures=0, resumed_at=ALGO_KILL * every)
        launches += launched
        rrep = m2.report()
        if not same(resumed, fused) or rrep["resumed_from_epoch"] != ALGO_KILL * every:
            raise AssertionError(f"resumed {name}: differs from the fused run or {rrep}")
        if L.captures() != caps:
            raise AssertionError(f"segmented {name}: {L.captures() - caps} graphs captured")
        out[name] = dict(every=every, secs=secs, fused_s=fused.run["loop_s"] + fused.run["result_s"],
                         report=rep, resumed_s=rsecs, resumed=rrep)
        log(f"segmented {name} at every:{every}: {secs:.6f} s against the fused "
            f"{out[name]['fused_s']:.6f} s, {rep['epochs_written']} epochs of "
            f"{rep['snapshot_bytes']} bytes ({rep['snapshot_seconds_total']:.6f} s of writes), "
            f"supersteps issued {res.run['issued']}; killed at boundary {ALGO_KILL} and resumed from "
            f"epoch {rrep['resumed_from_epoch']} in {rsecs:.6f} s ({resumed.run['live']} supersteps "
            f"run); both bit-identical to the fused run, no graph captured ({card})")
    out["launches"] = launches
    return out


def algo_registry_phase(reg, root: int, sssp_want, cc_want, K, L, card: str) -> dict:
    """``registry_sssp`` (``root``, default delta) and ``registry_cc`` (push
    and pull) on the serve phase's registry, each twice: every reply equal to
    the s22 fused result; the second call a resident hit that captures
    nothing."""
    import numpy as np

    from bfs_tpu_torch.serve import registry_cc, registry_sssp

    rows, launches = [], 0
    calls = (("registry_sssp", "push", lambda: registry_sssp(reg, "g", root)),
             ("registry_cc push", "push", lambda: registry_cc(reg, "g")),
             ("registry_cc pull", "pull", lambda: registry_cc(reg, "g", engine="pull")))
    for name, engine, call in calls:
        for i in range(2):
            resident = reg.resident(reg.get("g"), engine)
            res, secs, launched = algo_captured(name, call, K, L, captures=0 if i else None)
            launches += launched
            if hasattr(res, "label"):
                ok = np.array_equal(res.label, cc_want.label) and res.rounds == cc_want.rounds
            else:
                ok = (np.array_equal(res.dist, sssp_want.dist)
                      and np.array_equal(res.parent, sssp_want.parent)
                      and res.rounds == sssp_want.rounds)
            if not ok:
                raise AssertionError(f"{name} call {i + 1}: differs from the fused run")
            if i and not resident:
                raise AssertionError(f"{name}: the second call was not a resident hit")
            rows.append(dict(name=name, call=i + 1, secs=secs, resident=resident))
        log(f"serve: {name} twice: {rows[-2]['secs']:.6f} s, then {rows[-1]['secs']:.6f} s "
            f"(resident {engine} engine, no capture); both equal to the fused run ({card})")
    return dict(rows=rows, launches=launches)


def algo_small_checks(P, generators, K, L, store: str) -> dict:
    """SSSP at R-MAT scale ALGO_SMALL_SCALE on the card: packed16 against
    unpacked, bit-identical with the same rounds, both equal to the heapq
    ``dijkstra``; CC push against ``union_find_labels``; ``path_graph(600)``
    at weight 255 through the truncation fallback; then
    ``graph500_run.main`` at a small scale with its journal
    (:func:`graph500_journal_check`)."""
    import numpy as np

    from bfs_tpu_torch.algo import cc, edge_weights_np, sssp
    from bfs_tpu_torch.oracle import dijkstra, union_find_labels
    from bfs_tpu_torch.tools import graph500_run

    g = generators.rmat_graph_native(ALGO_SMALL_SCALE, EDGE_FACTOR, seed=GRAPH_SEED)
    eng = P.EdgeEngine(g, engine="push")
    root = int(np.argmax(np.bincount(g.src, minlength=g.num_vertices)))
    packed = sssp(eng, root, packed=True)
    unpacked = sssp(eng, root, packed=False)
    t0 = time.perf_counter()
    odist, opar = dijkstra(g, edge_weights_np(g.src, g.dst), root)
    dijkstra_s = time.perf_counter() - t0
    if not (packed.packed and not packed.truncated_fallbacks and packed.rounds == unpacked.rounds):
        raise AssertionError(f"sssp s{ALGO_SMALL_SCALE}: packed {packed.packed}, rounds "
                             f"{packed.rounds} and {unpacked.rounds}")
    for res in (packed, unpacked):
        if not (np.array_equal(res.dist, odist) and np.array_equal(res.parent, opar)):
            raise AssertionError(f"sssp s{ALGO_SMALL_SCALE} (packed {res.packed}): differs "
                                 "from dijkstra")
    labels = cc(eng)
    if not np.array_equal(labels.label, union_find_labels(g)):
        raise AssertionError(f"cc s{ALGO_SMALL_SCALE}: differs from union_find_labels")
    path = P.path_graph(600)
    trunc = sssp(path, 0, packed=True)
    pdist, ppar = dijkstra(path, edge_weights_np(path.src, path.dst), 0)
    if not (trunc.truncated_fallbacks == 1 and not trunc.packed
            and np.array_equal(trunc.dist, pdist) and np.array_equal(trunc.parent, ppar)):
        raise AssertionError(f"path_graph(600): fallback {trunc.truncated_fallbacks}, packed "
                             f"{trunc.packed}, or differs from dijkstra")
    log(f"sssp R-MAT scale {ALGO_SMALL_SCALE} (V={g.num_vertices}) root {root}: packed16 "
        f"{packed.run['loop_s']:.6f} s and unpacked {unpacked.run['loop_s']:.6f} s loops, "
        f"{packed.rounds} rounds each, bit-identical, equal to dijkstra ({dijkstra_s:.2f} s); cc "
        f"push {labels.rounds} rounds equal to union_find_labels; path_graph(600) at weight 255: "
        f"the clamp fired, re-run unpacked ({trunc.rounds} rounds), equal to dijkstra")
    del eng
    return dict(rounds=packed.rounds, **graph500_journal_check(graph500_run, store))


def graph500_journal_check(graph500_run, store: str) -> dict:
    """``graph500_run.main`` twice on a journal directory under ``store``
    (``BFS_TPU_TORCH_JOURNAL_DIR``): the first run journals its scale and
    its spans, the second skips every scale (it prints the same blocks,
    and the journal file does not change); then the ``trace`` command of
    ``python -m bfs_tpu_torch.obs`` (its ``main``, in this process) on the
    journal, whose trace must hold the first run's spans."""
    import contextlib
    import io

    from bfs_tpu_torch.obs import __main__ as obs_cli
    from bfs_tpu_torch.obs import spans
    from bfs_tpu_torch.resilience.journal import read_records

    jdir = os.path.join(store, "journal")
    os.environ["BFS_TPU_TORCH_JOURNAL_DIR"] = jdir
    try:
        spans.drain_events()  # the journal holds this run's spans alone
        runs = []
        for _ in range(2):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = graph500_run.main(GRAPH500_ARGS)
            runs.append((rc, time.perf_counter() - t0, buf.getvalue()))
            if rc != 0:
                raise AssertionError(f"graph500_run.main({GRAPH500_ARGS}) exited {rc}")
            if len(runs) == 1:
                (path,) = [os.path.join(jdir, f) for f in os.listdir(jdir)]
                size = os.path.getsize(path)
    finally:
        del os.environ["BFS_TPU_TORCH_JOURNAL_DIR"]
    recs = read_records(path)
    phases = [r["phase"] for r in recs]
    first = [e for r in recs if r["phase"].startswith("spans:") for e in r["payload"]["events"]]
    scales = GRAPH500_ARGS[GRAPH500_ARGS.index("--scales") + 1].split(",")
    want = [p for i, sc in enumerate(scales) for p in (f"scale:{sc}", f"spans:{i}")]
    if runs[1][2] != runs[0][2] or os.path.getsize(path) != size or phases[1:] != want or not first:
        raise AssertionError(f"graph500_run journal: phases {phases}, second run's output equal "
                             f"{runs[1][2] == runs[0][2]}, file {size} -> {os.path.getsize(path)}")
    out = os.path.join(store, "graph500.trace.json")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = obs_cli.main(["trace", path, "-o", out])
    if rc != 0:
        raise AssertionError(f"python -m bfs_tpu_torch.obs trace exited {rc}: {buf.getvalue()}")
    with open(out) as f:
        trace = json.load(f)["traceEvents"]
    if trace != first or {e["pid"] for e in trace} != {os.getpid()} or not {
            "graph500.scale", "graph500.generate", "graph500.construct"} <= {e["name"] for e in trace}:
        raise AssertionError(f"obs trace: {len(trace)} events, names {sorted({e['name'] for e in trace})}")
    log(f"graph500_run {' '.join(GRAPH500_ARGS)} with its journal: exit 0 in {runs[0][1]:.2f} s "
        f"(the device checks on every root, the oracles on the first), journal {phases}; again: "
        f"every scale skipped, the same blocks printed, the journal unchanged, {runs[1][1]:.2f} s; "
        f"obs trace: {len(trace)} spans of the first run ({buf.getvalue().splitlines()[0]})")
    return dict(graph500_s=runs[0][1], graph500_skip_s=runs[1][1])


# ------------------------------------------------ beyond device memory --

STREAM_BUDGET = 4 << 30  # the stream phase's cache: the s22 tiles (21 GB) far exceed it
STREAM_PEAK_MARGIN = 256 << 20  # the sparse body's and the result path's temporaries
H2D_BOUND_BYTES = 1 << 30  # the pinned copy that bounds the streamed rate


def pinned_copy_gbs(device, reps: int = 5) -> float:
    """The card's host-to-device rate: the best of ``reps`` timed copies of
    ``H2D_BOUND_BYTES`` from pinned host memory (CUDA events), in GB/s."""
    import torch

    host = torch.empty(H2D_BOUND_BYTES, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(H2D_BOUND_BYTES, dtype=torch.uint8, device=device)
    dev.copy_(host, non_blocking=True)
    best = None
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        dev.copy_(host, non_blocking=True)
        b.record()
        b.synchronize()
        ms = a.elapsed_time(b)
        best = ms if best is None else min(best, ms)
    del host, dev
    return H2D_BOUND_BYTES / (best / 1e3) / 1e9


def frontier_of(eng, dist, level: int):
    """The relay frontier words of the vertices at ``level`` of an oracle
    result (original ids), on the engine's device."""
    import numpy as np
    import torch

    from bfs_tpu_torch.ops import relay as R

    rg = eng.relay_graph
    bits = np.zeros(rg.vr, dtype=bool)
    bits[np.asarray(rg.old2new)[np.flatnonzero(dist == level)]] = True
    return R.pack_std(torch.from_numpy(bits)).to(eng.device)


def stream_kernel_check(seng, dist, K, RM, AT, card: str) -> dict:
    """``mxu_expand`` through ``out=`` on superblock slabs against the plain
    per-superblock expansion on the card, at the oracle level with the most
    vertices: the largest slab and the first, each uploaded by the cache;
    then one largest-slab launch timed (cold L2) beside the plain version."""
    import numpy as np
    import torch

    from bfs_tpu_torch.stream import SuperblockCache
    from bfs_tpu_torch.stream.runner import keys2d_for
    from bfs_tpu_torch.utils.timing import cold_ms

    store = seng.stream_store
    rows, _cols, rtp, vtp, _ = seng.mxu_geometry
    level = int(np.argmax(np.bincount(dist[dist != np.iinfo(np.int32).max])))
    fw = frontier_of(seng, dist, level)
    big = max(range(store.num_superblocks), key=store.sb_bytes)
    cache = SuperblockCache(store, budget_bytes=2 * store.sb_bytes(big), device=seng.device)
    keys2d = keys2d_for(seng)
    kw = dict(rows=rows, cols=AT.SB_VERTS, rtp=rtp, vtp=AT.SB_VERTS)
    err = 0
    for sb in dict.fromkeys((big, 0)):
        slab = cache.get(sb)
        slab.wait()
        grid = torch.full((vtp,), -1, dtype=torch.int32, device=seng.device)
        want = torch.full((vtp,), -1, dtype=torch.int32, device=seng.device)
        K.expand_frontier_mxu(fw, (*slab, keys2d), **kw,
                              out=grid[sb * AT.SB_VERTS : (sb + 1) * AT.SB_VERTS])
        RM.expand_superblock_plain(fw, slab, keys2d, sb, want, rows=rows, rtp=rtp)
        err = max(err, max_abs_err(grid, want))
    if err:
        raise AssertionError(f"mxu_expand through out=: differs from the plain per-superblock "
                             f"expansion (max err {err})")
    slab = cache.get(big)
    view = grid[big * AT.SB_VERTS : (big + 1) * AT.SB_VERTS]
    ms = cold_ms(lambda: K.expand_frontier_mxu(fw, (*slab, keys2d), **kw, out=view), 10,
                 prep=lambda: view.fill_(-1))
    pms = cold_ms(lambda: RM.expand_superblock_plain(fw, slab, keys2d, big, grid, rows=rows,
                                                     rtp=rtp), 2, warm=1)
    live = int(RM.live_tiles(fw, (slab[0], slab[1], slab[2], keys2d), rows=rows,
                             rtp=rtp).numel())
    log(f"stream kernel: mxu_expand through out= on superblocks {sorted({big, 0})} (largest "
        f"{store.real_tiles(big)} real of {store.pad_tiles(big)} tiles) at level {level}: "
        f"bit-exact against the plain per-superblock expansion; the largest slab "
        f"{ms:.4f} ms per launch ({live} live tiles, plain {pms:.4f} ms), cold L2; {card}")
    return {"superblock": big, "level": level, "ms": ms, "plain_ms": pms, "live": live}


def stream_phase(P, rg, g, roots, want: dict, dense: dict, resident_held: int, K, RM, AT, D,
                 card: str, ckpt_store: str) -> dict:
    """The streamed MXU arm at R-MAT s22: ``RelayEngine(tiles_mode="stream")``
    built after every resident MXU engine is freed (its tiles built on the
    card, cut into pinned host slabs, the card's copy released; the device
    memory it holds beside the resident engine's, ``resident_held``); K6
    through ``out=`` against the plain per-superblock expansion; the
    max-degree root and one drawn root by ``run_streamed`` under a
    ``STREAM_BUDGET`` cache (oracle-exact, equal to the dense MXU arm's
    results ``dense``, the schedule the host's recomputation, evictions, and
    ``mxu_expand`` launched once per demanded superblock, ``packed_update``
    once per pull level); one all-pull search at the default 1 GiB budget
    with each level's bytes, its copy rate beside a timed pinned copy (the
    best before and after the search: the host link varies), and the share
    of copy time hidden under K6 (CUDA events); ``run_segmented`` of the
    drawn root (whose pull levels come after boundary 2) at
    ``every:CKPT_EVERY`` killed at boundary 2 and resumed with a fresh
    cache, bit-identical; each streamed run's device peak (taken around
    the run alone) against held + budget + one largest slab + the grid +
    ``STREAM_PEAK_MARGIN``."""
    import numpy as np
    import torch

    from bfs_tpu_torch.ops import sparse as S
    from bfs_tpu_torch.resilience import faults as F
    from bfs_tpu_torch.resilience.faults import FaultInjected
    from bfs_tpu_torch.resilience.superstep_ckpt import SuperstepCheckpointer
    from bfs_tpu_torch.stream.runner import cache_for

    out = {}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    seng = P.RelayEngine(rg, device="cuda", expansion="mxu", direction="auto",
                         tiles_mode="stream", tiles_budget_bytes=TILES_BUDGET)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    held = torch.cuda.memory_allocated() - base
    init_peak = torch.cuda.max_memory_allocated() - base
    store = seng.stream_store
    srep = store.report()
    real = sum(store.real_tiles(sb) * (AT.TILE_BYTES + 8) for sb in range(store.num_superblocks))
    slabs = srep["host_store_bytes"] - store.keys2d.numel() * 4
    tile_bytes = store.nt * AT.TILE_BYTES
    if seng.adj_tiles is not None or not store.pinned:
        raise AssertionError("stream engine: the tiles must live in the pinned host store only")
    if held > resident_held - tile_bytes + (1 << 30):
        raise AssertionError(f"stream engine holds {held} bytes on the card, the resident MXU "
                             f"engine {resident_held}: not lower by about the {tile_bytes} tile "
                             "bytes")
    log(f"stream engine: RelayEngine(tiles_mode='stream') in {init_s:.2f} s: tile "
        f"build {seng.tiles_info['build_seconds']:.3f} s on the card, host store "
        f"{store.build_s['pin_s']:.3f} s pinning, {store.build_s['copy_s']:.3f} s filling from "
        f"the card, then {store.build_s['fingerprint_s']:.3f} s for the fingerprints still "
        f"running (a pool of {os.cpu_count()}); {srep['num_superblocks']} "
        f"superblocks, {store.nt} real tiles ({tile_bytes} bytes), host_store_bytes "
        f"{srep['host_store_bytes']} (padding {1 - real / slabs:.4f} of the slab bytes), largest "
        f"slab {srep['max_superblock_bytes']}; device memory held {held} bytes against the "
        f"resident MXU engine's {resident_held} ({resident_held - held} less), init peak "
        f"{init_peak} ({card})")
    out.update(init_s=init_s, held=held, store=srep, build_s=dict(store.build_s),
               pad_share=1 - real / slabs, tiles_build_s=seng.tiles_info["build_seconds"])
    out["kernel"] = stream_kernel_check(seng, want[roots[0]][0][0], K, RM, AT, card)

    # ---- the max-degree root and one drawn root, budget STREAM_BUDGET
    torch.cuda.synchronize()
    after_init = torch.cuda.memory_allocated()
    peaks, reserved = [], []

    def streamed(call):
        """One streamed run with the device peak taken around it alone (the
        checks after it allocate their own temporaries), and how far the
        allocator's reserved memory grew in it (its cache of free blocks
        included)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_reserved()
        try:
            return call()
        finally:
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_allocated())
            reserved.append(torch.cuda.max_memory_reserved() - start)
    budgets = S.sparse_budgets(rg.vr, len(rg.adj_dst))
    outdeg = np.bincount(g.src, minlength=g.num_vertices).astype(np.int64)
    cfg = seng.direction
    totals = {"mxu_expand": 0, "packed_update": 0}
    out["rows"], fused = [], {}

    def same(label, got, r):
        (dist, parent), _ = want[r]
        ref = dense[r]
        for what, d, p in (("the oracle", dist, parent), ("the dense MXU arm", ref.dist,
                                                            ref.parent)):
            if not (np.array_equal(got.dist, d) and np.array_equal(got.parent, p)):
                raise AssertionError(f"{label} root {r}: differs from {what}")
        if got.num_levels != ref.num_levels:
            raise AssertionError(f"{label} root {r}: {got.num_levels} levels, dense MXU "
                                 f"{ref.num_levels}")
        verify(f"{label} root {r}", got.dist, got.parent, r)

    def launched(rows_, some: bool = True):
        pulls = [row for row in rows_ if row["arm"] == "pull"]
        got = {k: K.LAUNCHES[k] for k in totals}
        expect = {"mxu_expand": sum(row["demanded"] for row in pulls), "packed_update": len(pulls)}
        if got != expect or (some and not all(got.values())):
            raise AssertionError(f"stream: launches {got}, expected {expect} from the ledger")
        for k in totals:
            totals[k] += got[k]
        return got

    for r in roots[:1]:  # the max-degree root (a second root cut for time)
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, curve = streamed(lambda: seng.run_streamed(r, telemetry=True,
                                                        cache_budget_bytes=STREAM_BUDGET))
        secs = time.perf_counter() - t0
        ledger = seng.stream_report
        got = launched(ledger["levels"])
        same("stream auto", res, r)
        expected = host_schedule(root_sums(outdeg, want, r, budgets), "auto", cfg.alpha,
                                 cfg.beta)
        if curve["direction_schedule"]["schedule"] != expected:
            raise AssertionError(f"stream root {r}: schedule {curve['direction_schedule']} differs "
                                 f"from the host's {expected}")
        if ledger["evictions"] <= 0:
            raise AssertionError(f"stream root {r}: no eviction under {STREAM_BUDGET} bytes")
        out["rows"].append(dict(root=r, secs=secs, run=dict(seng.last_run), ledger=ledger))
        fused[r] = (res, curve)
        log(f"stream root {r} (auto, cache {STREAM_BUDGET} bytes): {secs:.6f} s, schedule "
            f"{expected}; per level (arm, demanded, misses, evictions, bytes) "
            + ", ".join(f"{row['arm']} {row['demanded']} {row['misses']} {row['evictions']} "
                        f"{row['bytes_streamed']}" for row in ledger["levels"])
            + f"; {ledger['bytes_streamed']} bytes streamed, {ledger['hits']} hits; launches "
            f"{got}; oracle-exact, equal to the dense MXU arm ({card})")

    # ---- one all-pull search at the default budget: rates and overlap
    h2d_before = pinned_copy_gbs(seng.device)
    seng.direction = D.DirectionConfig("pull", cfg.alpha, cfg.beta)
    r = roots[0]
    cache = cache_for(seng, store, None)
    uploads, k6 = [], []
    real_k6, real_upload = K.expand_frontier_mxu, cache._upload

    def timed_upload(g, nbytes):
        # timed events on the copy stream around the cache's own upload
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record(cache._copy_stream)
        slab = real_upload(g, nbytes)
        b.record(cache._copy_stream)
        uploads.append((g, nbytes, a, b))
        return slab

    def timed_k6(*args, **kwargs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        ret = real_k6(*args, **kwargs)
        b.record()
        k6.append((a, b))
        return ret

    if cache._copy_stream is None:
        raise AssertionError("the stream engine's cache has no copy stream")
    K.reset_launches()
    K.expand_frontier_mxu = timed_k6
    cache._upload = timed_upload
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = streamed(lambda: seng.run_streamed(r))
        secs = time.perf_counter() - t0
    finally:
        K.expand_frontier_mxu = real_k6
        del cache._upload  # the class's own again
        seng.direction = cfg
    h2d = max(h2d_before, pinned_copy_gbs(seng.device))
    ledger = seng.stream_report
    got = launched(ledger["levels"])
    same("stream pull", res, r)
    ref_ev = uploads[0][2] if uploads else k6[0][0]
    spans = [(ref_ev.elapsed_time(a), ref_ev.elapsed_time(b)) for _, _, a, b in uploads]
    kspans = [(ref_ev.elapsed_time(a), ref_ev.elapsed_time(b)) for a, b in k6]
    levels, ui, ki = [], 0, 0
    for row in ledger["levels"]:
        cu, kk = spans[ui : ui + row["misses"]], kspans[ki : ki + row["demanded"]]
        ui, ki = ui + row["misses"], ki + row["demanded"]
        copy_ms = sum(e - s for s, e in cu)
        hidden = sum(max(0.0, min(e, ke) - max(s, ks)) for s, e in cu for ks, ke in kk)
        span_ms = (max(e for _, e in cu + kk) - min(s for s, _ in cu + kk)) if cu + kk else 0.0
        levels.append(dict(level=row["level"], demanded=row["demanded"],
                           bytes=row["bytes_streamed"], copy_ms=copy_ms,
                           k6_ms=sum(e - s for s, e in kk), span_ms=span_ms,
                           gbs=row["bytes_streamed"] / copy_ms / 1e6 if copy_ms else 0.0,
                           hidden=hidden / copy_ms if copy_ms else 0.0))
    out["pull"] = dict(root=r, secs=secs, h2d_gbs=h2d, levels=levels, ledger=ledger)
    log(f"stream root {r} (pull, cache {cache.budget_bytes} bytes): {secs:.6f} s; pinned copy "
        f"bound {h2d:.3f} GB/s ({H2D_BOUND_BYTES} bytes, the best of 5 copies before and 5 "
        f"after the search: {h2d_before:.3f} before); per level (demanded, bytes, "
        "copy ms, GB/s, K6 ms, level span ms, copy share hidden under K6) "
        + ", ".join(f"{x['level']}: {x['demanded']} {x['bytes']} {x['copy_ms']:.3f} "
                    f"{x['gbs']:.3f} {x['k6_ms']:.3f} {x['span_ms']:.3f} {x['hidden']:.4f}"
                    for x in levels)
        + f"; launches {got}; oracle-exact, equal to the dense MXU arm ({card})")

    # ---- run_segmented at every:CKPT_EVERY, killed at boundary 2, resumed cold
    r = roots[0]
    fused, fused_curve = fused[r]

    def mgr():
        return SuperstepCheckpointer(ckpt_store, {"label": "stream", "root": int(r)},
                                     cfg=ckpt_config(CKPT_EVERY))

    os.environ["BFS_TPU_TORCH_FAULT"] = "raise:superstep:2"
    F.reset()
    try:
        streamed(lambda: seng.run_segmented(r, ckpt=mgr(), telemetry=True))
        raise AssertionError("stream: the injected fault did not stop the run")
    except FaultInjected:
        pass
    finally:
        os.environ.pop("BFS_TPU_TORCH_FAULT", None)
        F.reset()
    seng._stream_cache = None  # a fresh, cold cache
    m = mgr()
    epochs = m.epochs()
    K.reset_launches()
    t0 = time.perf_counter()
    res, curve = streamed(lambda: seng.run_segmented(r, ckpt=m, telemetry=True))
    resume_s = time.perf_counter() - t0
    launched(seng.stream_report["levels"], some=False)  # the levels after the epoch may be push
    rep = m.report()
    if not (np.array_equal(res.dist, fused.dist) and np.array_equal(res.parent, fused.parent)
            and res.num_levels == fused.num_levels) or \
            curve["direction_schedule"] != fused_curve["direction_schedule"] or \
            curve["occupancy"] != fused_curve["occupancy"]:
        raise AssertionError("stream: the resumed run differs from the fused streamed run")
    if rep["resumed_from_epoch"] != 2 * CKPT_EVERY or epochs != [CKPT_EVERY, 2 * CKPT_EVERY] \
            or m.epochs():
        raise AssertionError(f"stream: resume {rep}, epochs {epochs}, left {m.epochs()}")
    out["resume"] = dict(root=r, secs=resume_s, report=rep, ledger=seng.stream_report)
    log(f"stream root {r}: run_segmented every:{CKPT_EVERY} killed by raise:superstep:2 with "
        f"epochs {epochs}, resumed with a cold cache from epoch {rep['resumed_from_epoch']} in "
        f"{resume_s:.6f} s ({seng.stream_report['misses']} misses, "
        f"{seng.stream_report['bytes_streamed']} bytes); dist, parent, schedule and occupancy "
        f"bit-identical to the fused streamed run ({card})")

    # ---- the device peak over the streamed runs
    peak = max(peaks)
    bound = after_init + STREAM_BUDGET + srep["max_superblock_bytes"] + 4 * seng.mxu_geometry[3] \
        + STREAM_PEAK_MARGIN
    if peak > bound:
        raise AssertionError(f"stream: device peak {peak} bytes over its bound {bound}")
    out.update(peak=peak - after_init, bound=bound - after_init, launches=totals,
               reserved=reserved)
    log(f"stream device peak over the streamed runs, each taken around the run alone: "
        + ", ".join(str(p - after_init) for p in peaks)
        + f" bytes over the {after_init - base} held, the largest within held + budget {STREAM_BUDGET} + largest slab "
        f"{srep['max_superblock_bytes']} + grid {4 * seng.mxu_geometry[3]} + margin "
        f"{STREAM_PEAK_MARGIN} = {bound - after_init}; the allocator's reserved memory grew "
        f"by " + ", ".join(str(x) for x in reserved) + f" bytes in them ({card})")
    del seng, cache
    torch.cuda.empty_cache()
    return out


def launches_since(before: dict, K) -> dict:
    """Kernel launches counted since the copy ``before`` of ``K.LAUNCHES``."""
    return {k: n - before.get(k, 0) for k, n in K.LAUNCHES.items() if n != before.get(k, 0)}


def probe_launches(probe: dict) -> dict:
    """What a probe's loops launch: per timed body, its launches of one
    call x the calls made."""
    want: dict = {}
    for body in probe["bodies"].values():
        for k, n in body["per_step"].items():
            want[k] = want.get(k, 0) + n * body["steps"]
    return want


def probe_host(P, generators, seed: int) -> dict:
    """The probe cell's host side, which needs no card (run beside the
    kernel build): its graph, the max-out-degree root and 3 roots drawn
    with ``seed`` from its component, their ``canonical_bfs`` trees, each
    clean under ``check()``."""
    import numpy as np

    t0 = time.perf_counter()
    g = generators.rmat_graph_native(PROBE_SCALE, PROBE_EDGE_FACTOR, seed=GRAPH_SEED)
    gen_s = time.perf_counter() - t0
    root0 = int(np.argmax(np.bincount(g.src, minlength=g.num_vertices)))
    oracle = {root0: P.canonical_bfs(g, root0)}
    comp = np.flatnonzero(oracle[root0][0] != P.INF_DIST)
    roots = [root0] + [int(r) for r in np.random.default_rng(seed).choice(
        comp, ROOTS - 1, replace=False)]
    for r in roots[1:]:
        oracle[r] = P.canonical_bfs(g, r)
    for r in roots:
        violations = P.check(g, *oracle[r], r)
        if violations:
            raise AssertionError(f"probe: root {r}: check() violations {violations[:3]}")
    return dict(g=g, gen_s=gen_s, comp=comp, roots=roots, oracle=oracle)


def probe_phase(P, host: dict, K, seed: int, card: str) -> dict:
    """The measured arm selection on its cell (R-MAT s18, edge factor 64, a
    torch-routed layout; ``host`` from :func:`probe_host`): the default
    engine (``expansion="auto"``) counts its tiles, builds them and probes
    both arms (memo miss), its launches held to the probe's loop counts; a
    second engine on the same layout reads the verdict back (memo hit) and
    launches nothing; the max-out-degree root and 3 roots drawn with
    ``seed`` on the selected arm and on the other, forced, bit for bit with
    each other and ``canonical_bfs`` (whose trees are ``check()`` clean);
    the lock-step batch of 16 on each arm, loop and results apart."""
    import numpy as np
    import torch

    from bfs_tpu_torch import knobs
    from bfs_tpu_torch.cache import layout as CL

    g, gen_s, comp, roots, oracle = (host[k] for k in ("g", "gen_s", "comp", "roots", "oracle"))
    t0 = time.perf_counter()
    rg = P.build_relay_graph_device(g, route="torch")
    torch.cuda.synchronize()
    layout_s = time.perf_counter() - t0
    edges = int(rg.adj_indptr[rg.vr])
    before = dict(K.LAUNCHES)
    t0 = time.perf_counter()
    eng = P.RelayEngine(rg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    launched = launches_since(before, K)
    probe, rec = eng.phase_probe, eng.expansion_probe
    if (probe is None or probe.get("memo") != "miss" or rec is None
            or rec.get("selection_basis") != "measured" or eng.expansion_requested != "auto"):
        raise AssertionError(f"probe: the default engine did not measure both arms: "
                             f"{eng.expansion_basis}; {probe}")
    verdict = os.path.join(CL._probe_dir(), f"{CL.probe_verdict_key(eng)}.json")
    if not (verdict.startswith(knobs.raw("BFS_TPU_TORCH_CACHE_DIR") + os.sep)
            and os.path.isfile(verdict)):
        raise AssertionError(f"probe: the verdict was not saved in the run's cache root: {verdict}")
    want = probe_launches(probe)
    if launched != want or launched != probe["launches"] or probe["control_block"] != "live":
        raise AssertionError(f"probe: launches {launched}, its loops account for {want}")
    for k in ("benes_local_pass", "benes_outer_pass", "class_rowmin", "packed_update",
              "mxu_expand"):
        if not launched.get(k):
            raise AssertionError(f"probe: {k} never launched")
    nt, tiles_bytes = eng.tile_geometry[0], eng.tiles_nbytes
    gather_s, mxu_s = rec["gather_seconds"], rec["mxu_seconds"]
    log(f"probe cell: R-MAT s{PROBE_SCALE} ef {PROBE_EDGE_FACTOR} seed {GRAPH_SEED} (native "
        f"generator {gen_s:.2f} s): V={g.num_vertices} directed E={g.num_edges}; torch-routed "
        f"layout in {layout_s:.2f} s, vr={rg.vr} net_size={rg.net_size}, {edges} relabeled "
        f"edges; {nt} tiles, {tiles_bytes} bytes ({edges / nt:.4f} edges a tile) against "
        f"the {eng.tiles_budget_bytes}-byte budget ({card})")
    log(f"probe: default engine in {init_s:.3f} s (tile count {eng.tile_count_s:.3f} s, tiles "
        f"{eng.tiles_build_s:.3f} s, probe {eng.probe_s:.3f} s); dense superstep on a pinned "
        f"dense frontier: gather {gather_s:.6g} s, mxu {mxu_s:.6g} s; selected {eng.expansion}, "
        f"basis '{eng.expansion_basis}', memo {probe['memo']}; K3 kernel "
        f"{probe['rowmin']['kernel_seconds']:.6g} s against plain "
        f"{probe['rowmin']['plain_seconds']:.6g} s, K4 kernel "
        f"{probe['state_update']['kernel_seconds']:.6g} s against plain "
        f"{probe['state_update']['plain_seconds']:.6g} s; launches {launched} = the probe's "
        f"loops (launches of one call x calls, {len(probe['bodies'])} bodies), control block "
        f"live ({card})")
    before = dict(K.LAUNCHES)
    t0 = time.perf_counter()
    eng2 = P.RelayEngine(rg, device="cuda")
    torch.cuda.synchronize()
    init2_s = time.perf_counter() - t0
    launched2 = launches_since(before, K)
    if eng2.phase_probe.get("memo") != "hit" or launched2 or eng2.expansion != eng.expansion:
        raise AssertionError(f"probe: the second engine: memo {eng2.phase_probe.get('memo')}, "
                             f"launches {launched2}, arm {eng2.expansion}")
    log(f"probe: second engine on the layout in {init2_s:.3f} s: memo hit, no kernel launched, "
        f"arm {eng2.expansion}")
    del eng2
    torch.cuda.empty_cache()
    selected = eng.expansion
    other = "mxu" if selected == "gather" else "gather"
    engines = {selected: eng, other: P.RelayEngine(rg, device="cuda", expansion=other)}
    secs = {}
    for arm, e in engines.items():
        for r in roots:
            e.run(r)  # the captures
        times = []
        for r in roots:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = e.run(r)
            times.append(time.perf_counter() - t0)
            dist, parent = oracle[r]
            if not (np.array_equal(res.dist, dist) and np.array_equal(res.parent, parent)):
                raise AssertionError(f"probe {arm}: root {r} differs from canonical_bfs")
        secs[arm] = times
    log(f"probe: {len(roots)} roots {roots} on both arms (default hybrid engines), oracle-exact "
        "and equal to each other, check() clean; s/search " + "; ".join(
            f"{arm}{' (selected)' if arm == selected else ''} " + ", ".join(f"{t:.6f}" for t in ts)
            + f" (mean {np.mean(ts):.6f})" for arm, ts in secs.items()) + f" ({card})")
    rest = np.setdiff1d(comp, roots)
    sources = np.asarray([*roots, *np.random.default_rng(seed + 1).choice(
        rest, PROBE_TREES - len(roots), replace=False)], dtype=np.int32)
    lock = {}
    for arm, e in engines.items():
        e.run_multi(sources)  # the capture of this batch size
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = e.run_multi(sources)
        wall = time.perf_counter() - t0
        lock[arm] = dict(secs=wall, loop_s=e.last_run["loop_s"], result_s=e.last_run["result_s"],
                         levels=res.num_levels, issued=e.last_run["issued"], result=res)
    a, b = lock[selected]["result"], lock[other]["result"]
    if not (np.array_equal(a.dist, b.dist) and np.array_equal(a.parent, b.parent)):
        raise AssertionError("probe: the lock-step batches of the two arms differ")
    for i, r in enumerate(roots):
        if not (np.array_equal(a.dist[i], oracle[r][0]) and np.array_equal(a.parent[i], oracle[r][1])):
            raise AssertionError(f"probe: lock-step tree {i} (root {r}) differs from canonical_bfs")
    mean = {arm: float(np.mean(ts)) for arm, ts in secs.items()}
    log(f"probe: lock-step batch of {PROBE_TREES} (run_multi, the roots then {PROBE_TREES - 4} "
        f"drawn with seed {seed + 1}), trees equal across the arms, the roots' oracle-exact: "
        + "; ".join(f"{arm} {r['secs']:.6f} s (loop {r['loop_s']:.6f}, results "
                    f"{r['result_s']:.6f}; {r['issued']} supersteps issued, {r['levels']} levels)"
                    for arm, r in lock.items())
        + f"; break-even edges a tile (edges a tile x mxu / gather): dense superstep "
        f"{edges / nt * mxu_s / gather_s:.4f}, batch of {PROBE_TREES} loop "
        f"{edges / nt * lock['mxu']['loop_s'] / lock['gather']['loop_s']:.4f} ({card})")
    for r in lock.values():
        del r["result"]
    del engines, eng, a, b
    torch.cuda.empty_cache()
    return dict(edges=edges, tiles=nt, tiles_bytes=tiles_bytes, gather_s=gather_s,
                mxu_s=mxu_s, selected=selected, init_s=init_s, init2_s=init2_s,
                launches=launched, secs=mean, lock=lock, layout_s=layout_s)


def ledger_phase(eng, card: str) -> dict:
    """``superstep_phase_ledger`` on the s22 gather engine: each phase's
    seconds and bytes, their sum against the whole dense superstep."""
    import math

    from bfs_tpu_torch.profiling import superstep_phase_ledger

    t0 = time.perf_counter()
    led = superstep_phase_ledger(eng)
    wall = time.perf_counter() - t0
    bad = [p for p, r in led["phases"].items() if not (math.isfinite(r["seconds"]) and r["seconds"] > 0)]
    if bad or led["applier"] != "kernel" or "expansion" in led["phases"]:
        raise AssertionError(f"ledger: phases {bad} not timed, applier {led['applier']}, "
                             f"phases {sorted(led['phases'])}")
    rows = []
    for name, r in led["phases"].items():
        extra = [f"{k} {r[k]}" for k in ("mask_bytes", "word_bytes_rw", "word_bytes_read",
                                         "candidate_bytes_written") if k in r]
        if "arms" in r:
            extra.append("arms " + ", ".join(f"{a} {v:.6g} s" for a, v in r["arms"].items()))
        if name == "state_update":
            extra.append(f"bytes packed {r['packed']['bytes']['total']}, unpacked "
                         f"{r['unpacked']['bytes']['total']} ({r['unpacked']['seconds']:.6g} s)")
        rows.append(f"{name} {r['seconds'] * 1e3:.4f} ms"
                    + (f" ({', '.join(extra)})" if extra else ""))
    log(f"phase ledger (s22 gather engine, K = {led['loops']}, {wall:.2f} s): " + "; ".join(rows)
        + f"; sum of phases {led['sum_of_phases_seconds'] * 1e3:.4f} ms against full superstep "
        f"{led['full_superstep_seconds'] * 1e3:.4f} ms; telemetry overhead ratio "
        f"{led['telemetry_overhead_ratio']:.4f}; mask bytes {led['mask_bytes_total']} ({card})")
    return led


# The analysis phases: the transfer guard's canary region; the chaos
# driver's serve schedule at the reference's full size
# (tests/test_chaos_serve.py::test_chaos_serve_full_schedule: scale 9, 12
# healthy requests) under the lock-order recorder, one traversal iteration
# of the relay config and one load-generator iteration at the CLI's scale;
# cache_warm at scale 16 (its tiles fit the default budget, so the default
# engine's arm probe runs and is memoized).
CHAOS_SCALE = 9
TRAVERSAL_CONFIGS = ("relay", "sharded")  # the chaos traversal's configs, 8 shards on the card
CHAOS_REQUESTS = 12
CHAOS_LOADGEN_SCALE = 10
CACHE_WARM_SCALE = 16


def guard_phase(eng, root: int, want, RT, card: str) -> dict:
    """Under ``BFS_TPU_TORCH_TRANSFER_GUARD=1`` one s22 gather search in a
    guarded region (its control reads and result copy are explicit
    transfers; any other host sync raises), held against ``want`` (the
    oracle's arrays); then an ``.item()`` in ``guarded_region("smoke.canary")``
    must raise, naming the region.  The served ticks under the guard run in
    ``serve_phase``."""
    import numpy as np
    import torch

    os.environ["BFS_TPU_TORCH_TRANSFER_GUARD"] = "1"
    try:
        t0 = time.perf_counter()
        with RT.guarded_region("smoke.gather_search"):
            res = eng.run(root)
        secs = time.perf_counter() - t0
        if not (np.array_equal(res.dist, want[0]) and np.array_equal(res.parent, want[1])):
            raise AssertionError("guard: the guarded search differs from canonical_bfs")
        try:
            with RT.guarded_region("smoke.canary"):
                torch.ones(3, device=eng.device).sum().item()
        except RuntimeError as exc:
            canary = str(exc)
        else:
            raise AssertionError("guard: .item() in guarded_region('smoke.canary') did not raise")
        if not canary.startswith("[transfer-guard:smoke.canary] "):
            raise AssertionError(f"guard: the canary's error does not name its region: {canary}")
    finally:
        del os.environ["BFS_TPU_TORCH_TRANSFER_GUARD"]
    log(f"guard: the s22 gather search from root {root} under sync-debug mode 'error' in "
        f"{secs:.6f} s, no violation, oracle-exact; the canary raised '{canary}' ({card})")
    return {"search_s": secs, "canary": canary}


def run_tool(argv: list, env: dict | None = None):
    """``python -m <argv>`` from the checkout's root: a started process, its
    output into a temporary file (read by :func:`finish_tool`)."""
    import subprocess

    root = os.path.dirname(os.path.abspath(__file__))
    full = dict(os.environ, **(env or {}))
    full["PYTHONPATH"] = root + (os.pathsep + full["PYTHONPATH"] if full.get("PYTHONPATH") else "")
    out = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen([sys.executable, "-m", *argv], cwd=root, env=full, text=True,
                            stdout=out, stderr=subprocess.STDOUT)
    proc.log_file = out
    return proc


def finish_tool(label: str, proc, timeout: float = 300.0) -> tuple[str, float]:
    """Wait for ``proc``; its output, or an AssertionError with its tail."""
    import subprocess

    t0 = time.perf_counter()
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise
    proc.log_file.seek(0)
    out = proc.log_file.read()
    proc.log_file.close()
    if proc.returncode != 0:
        raise AssertionError(f"{label}: exit {proc.returncode}\n{out[-4000:]}")
    return out, time.perf_counter() - t0


def json_lines(out: str) -> list:
    return [json.loads(x) for x in out.splitlines() if x.startswith("{")]


def start_chaos(cache_root: str) -> tuple[dict, float]:
    """The chaos driver's three modes on the card, started together, each a
    process of its own: ``serve`` at the reference's full schedule under
    ``BFS_TPU_TORCH_LOCK_ORDER=1``, ``traversal`` (one iteration of each
    config of :data:`TRAVERSAL_CONFIGS`, a process each) and ``loadgen``
    (one iteration)."""
    chaos = ("bfs_tpu_torch.tools.chaos_run", "--seed", "1")
    procs = {
        "serve": run_tool([*chaos, "--mode", "serve", "--scale", str(CHAOS_SCALE),
                           "--serve-requests", str(CHAOS_REQUESTS)],
                          {"BFS_TPU_TORCH_LOCK_ORDER": "1"}),
        **{f"traversal {cfg}": run_tool([*chaos, "--mode", "traversal", "--iterations", "1",
                                         "--traversal-configs", cfg])
           for cfg in TRAVERSAL_CONFIGS},
        "loadgen": run_tool([*chaos, "--mode", "loadgen", "--iterations", "1", "--scale",
                             str(CHAOS_LOADGEN_SCALE), "--device", "cuda", "--cache-dir",
                             os.path.join(cache_root, "chaos_loadgen")]),
    }
    return procs, time.perf_counter()


def chaos_phase(procs: dict, t0: float, card: str) -> dict:
    """Wait for :func:`start_chaos`'s runs and hold each to its verdict:
    ``serve`` exits 0 with a lock-order graph that has edges and no cycle;
    ``traversal`` was killed at a superstep boundary and resumed from an
    epoch bit for bit on each of its configs; ``loadgen`` was killed, then
    ran whole and passed its oracle gate."""
    out, secs = {}, {}
    for name, proc in procs.items():
        out[name], _ = finish_tool(f"chaos {name}", proc)
        secs[name] = time.perf_counter() - t0
    if "serve chaos: ok" not in out["serve"]:
        raise AssertionError(f"chaos serve: not ok\n{out['serve'][-3000:]}")
    order = next((d["lock_order"] for d in json_lines(out["serve"]) if "lock_order" in d), None)
    if order is None or not order["edges"] or order["cycles"]:
        raise AssertionError(f"chaos serve: lock order {order}")
    resumed = {}
    for cfg in TRAVERSAL_CONFIGS:
        text = out[f"traversal {cfg}"]
        done = [x for x in text.splitlines() if "resumed from epoch" in x]
        if "traversal chaos: 1/1 ok" not in text or "killed at boundary" not in text or \
                not done or "resumed from epoch None" in done[-1]:
            raise AssertionError(f"chaos traversal {cfg}: not ok\n{text[-3000:]}")
        resumed[cfg] = done[-1].split("] ", 2)[-1]
    if "loadgen chaos: 1/1 ok" not in out["loadgen"]:
        raise AssertionError(f"chaos loadgen: not ok\n{out['loadgen'][-3000:]}")
    log(f"chaos serve (scale {CHAOS_SCALE}, {CHAOS_REQUESTS} healthy requests, the full fault "
        f"and swap schedule, every reply oracle-checked): ok; lock order under "
        f"BFS_TPU_TORCH_LOCK_ORDER=1: {len(order['edges'])} edges, no cycle: "
        f"{json.dumps(order['edges'], sort_keys=True)} ({card})")
    log("chaos traversal: " + "; ".join(f"{cfg}: {r}" for cfg, r in resumed.items())
        + f"; chaos loadgen (scale {CHAOS_LOADGEN_SCALE}): killed, then a whole run passed its "
        f"oracle gate; seconds from the start: " + ", ".join(
            f"{k} {v:.1f}" for k, v in secs.items()))
    return {"secs": secs, "lock_order": order}


def cache_warm_argv(cache_root: str) -> list:
    return ["bfs_tpu_torch.tools.cache_warm", "--scales", str(CACHE_WARM_SCALE), "--tiles",
            "--compile", "--cache-dir", os.path.join(cache_root, "cache_warm")]


def start_cache_warm(cache_root: str):
    """``cache_warm``'s cold run, and its warm run started on a thread as
    soon as the cold one exits (both beside the script's own work); the
    thread's ``result()`` is ``(warm process, its wall seconds)``."""
    import concurrent.futures

    cold = run_tool(cache_warm_argv(cache_root))

    def warm():
        cold.wait()
        t0 = time.perf_counter()
        proc = run_tool(cache_warm_argv(cache_root))
        proc.wait()
        return proc, time.perf_counter() - t0

    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1, thread_name_prefix="cache-warm")
    f_warm = pool.submit(warm)
    pool.shutdown(wait=False)
    return cold, f_warm


def cache_warm_phase(P, cache_root: str, cold_proc, f_warm, card: str) -> dict:
    """``cache_warm --tiles --compile`` at scale 16 on a cache root of its own,
    cold (``cold_proc``) then warm (``f_warm``), each a process of its own
    (:func:`start_cache_warm`): the warm run must find every artifact (the
    relay and tiles bundles, the kernel libraries, the arm probe's verdict)
    a hit; then ``verify_tiles_bundle`` reports the bundle ok, and
    ``absent`` once one of its fields is corrupted."""
    from bfs_tpu_torch.cache import layout as CL
    from bfs_tpu_torch.graph.generators import rmat_graph_native
    from bfs_tpu_torch.resilience.faults import corrupt_file

    root = os.path.join(cache_root, "cache_warm")
    runs = {}
    for name in ("cold", "warm"):
        proc, own_s = (cold_proc, None) if name == "cold" else f_warm.result()
        out, secs = finish_tool(f"cache_warm {name}", proc)
        secs = secs if own_s is None else own_s
        docs = json_lines(out)
        runs[name] = {"secs": secs, "artifacts": docs[-2]["artifacts"],
                      "counters": docs[-1]["artifact_caches"],
                      "lines": [x for x in out.splitlines() if x.startswith(f"s{CACHE_WARM_SCALE}:")]}
    cold, warm = runs["cold"]["artifacts"], runs["warm"]["artifacts"]
    if set(warm) != {"relay", "tiles", "kernels", "probe"} or set(warm.values()) != {"hit"}:
        raise AssertionError(f"cache_warm: the warm run built something: {warm}")
    if (cold["relay"], cold["tiles"], cold["probe"]) != ("built",) * 3:
        raise AssertionError(f"cache_warm: the cold run found a warm cache: {cold}")
    g = rmat_graph_native(CACHE_WARM_SCALE, 6, seed=1)
    cache = CL.LayoutCache(os.path.join(root, "layout"))
    rg, info = CL.load_or_build_relay(g, cache=cache, device="cuda")
    ok = CL.verify_tiles_bundle(rg, cache=cache)
    field = os.path.join(cache.root, CL.tiles_key(rg), "col_id.npy")
    corrupt_file(field, mode="flip", at=os.path.getsize(field) - 5)
    bad = CL.verify_tiles_bundle(rg, cache=cache)
    if info["cache"] != "hit" or not ok["ok"] or (bad["ok"], bad["status"]) != (False, "absent"):
        raise AssertionError(f"cache_warm: verify_tiles_bundle {ok} then {bad} ({info['cache']})")
    for name, r in runs.items():
        log(f"cache_warm {name} (R-MAT s{CACHE_WARM_SCALE}, --tiles --compile): {r['secs']:.1f} s, "
            f"artifacts {r['artifacts']}, counters {r['counters']}; " + "; ".join(r["lines"]))
    log(f"cache_warm: verify_tiles_bundle ok ({ok['num_tiles']} tiles, "
        f"{ok['num_superblocks']} superblocks), then '{bad['status']}' with col_id corrupted "
        f"({card})")
    return {"runs": runs, "verify": ok}


def registry_phase(KREG, card: str) -> dict:
    """Every kernel of the registry (``analysis/kernels.py``) at lint scale
    on the card against its plain version, bit for bit, each launched."""
    t0 = time.perf_counter()
    if KREG.registry_findings(os.path.dirname(os.path.abspath(__file__))):
        raise AssertionError("kernel registry: the pin failed")
    findings, rows = KREG.run_on_card("cuda")
    if findings or set(rows) != set(KREG.KERNEL_SPECS) or any(
            r["launches"] < 1 for r in rows.values()):
        raise AssertionError(f"kernel registry: {[f.render() for f in findings]} {rows}")
    log(f"kernel registry: {len(rows)} kernels at lint scale (R-MAT s{KREG.LINT_SCALE}) "
        f"bit-exact against their plain versions, each launched, in "
        f"{time.perf_counter() - t0:.2f} s ({card})")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--seed", type=int, default=0, help="root selection seed")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    root_dir = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root_dir)
    # Every persistent cache of the run (probe verdicts, label checkpoints,
    # journals) under a root of its own, removed at exit: a second run in
    # the same checkout starts from nothing, as the first did.
    os.makedirs(os.path.join(root_dir, ".bench_cache"), exist_ok=True)
    cache_dir = tempfile.mkdtemp(prefix="chip_smoke_cache_", dir=os.path.join(root_dir, ".bench_cache"))
    atexit.register(shutil.rmtree, cache_dir, True)
    os.environ["BFS_TPU_TORCH_CACHE_DIR"] = cache_dir
    import bfs_tpu_torch as P
    from bfs_tpu_torch.analysis import kernels as KREG
    from bfs_tpu_torch.analysis import runtime as RT
    from bfs_tpu_torch.graph import adj_tiles as AT
    from bfs_tpu_torch.graph import generators
    from bfs_tpu_torch.models import loop as L
    from bfs_tpu_torch.ops import relay as R
    from bfs_tpu_torch.ops import relay_cuda as K
    from bfs_tpu_torch.ops import relay_elem as RE
    from bfs_tpu_torch.ops import relay_mxu as RM
    from bfs_tpu_torch.utils import cuda_build
    from bfs_tpu_torch.utils.timing import card_line

    marks = [("start", T_PROCESS)]

    def mark(name: str) -> None:
        """The end of a phase: its wall seconds go into the closing breakdown."""
        marks.append((name, time.perf_counter()))
    mark("start-up (imports, CUDA)")
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device {torch.cuda.get_device_name(0)}")

    # ---- host work that needs no card runs beside the build on a thread of
    # its own: the cell's s22 graph, then the probe cell's graph, its roots'
    # canonical_bfs trees and their check()
    import concurrent.futures

    prep = concurrent.futures.ThreadPoolExecutor(max_workers=1, thread_name_prefix="smoke-host")

    def s22_graph():
        t0 = time.perf_counter()
        # The native generator only (it raises if it cannot be built): the
        # numpy one draws other edges, so the measured graph would silently
        # change.
        graph = generators.rmat_graph_native(args.scale, EDGE_FACTOR, seed=GRAPH_SEED)
        return graph, time.perf_counter() - t0

    f_graph = prep.submit(s22_graph)
    f_probe = prep.submit(probe_host, P, generators, args.seed)
    # ---- build: one nvcc per source, all started together ----------------
    t0 = time.perf_counter()
    K.build_all()
    log(f"build: all {len(K.SOURCES)} kernel libraries in {time.perf_counter() - t0:.2f} s")
    # Every object alive now (modules, the kernel libraries) lives to the end:
    # the collections before each CUDA graph capture skip them.
    import gc

    gc.freeze()
    for name in K.SOURCES:
        info = cuda_build.BUILD_INFO[name]
        log(f"build: {name}.cu (nvcc {info['seconds']:.2f} s)")
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}", file=sys.stderr)

    mark("build")
    g, t_gen = f_graph.result()
    probe_pre = f_probe.result()
    mark("host preparation (the wait left)")
    # ---- layout: the device builder against the host builder at s18, then
    # the cell's layout built on the card into a fresh bundle store and
    # loaded back (memmapped); the engine ships from the loaded layout
    layout_parity = layout_parity_phase(P, generators)
    mark("layout parity s18")
    # ---- the measured arm selection on its cell: the default engine's
    # probe (memo miss, then hit), both arms' searches and batches
    probe = probe_phase(P, probe_pre, K, args.seed, card)
    del probe_pre
    mark(f"probe cell s{PROBE_SCALE} ef {PROBE_EDGE_FACTOR}")
    log(f"graph: R-MAT scale {args.scale} ef {EDGE_FACTOR} seed {GRAPH_SEED} "
        f"(native generator, {t_gen:.1f} s): V={g.num_vertices} directed E={g.num_edges}")
    store = tempfile.mkdtemp(prefix="chip_smoke_layout_", dir=os.path.join(root_dir, ".bench_cache"))
    atexit.register(shutil.rmtree, store, True)
    # The superstep checkpoints' epoch store.
    ckpt_store = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=os.path.join(root_dir, ".bench_cache"))
    atexit.register(shutil.rmtree, ckpt_store, True)
    # The roots' canonical_bfs trees on the host beside the layout build
    # (host work too, on its own threads): the max-degree root's, then 3
    # roots drawn with --seed from its component.
    deg = np.bincount(g.src, minlength=g.num_vertices)
    root0 = int(np.argmax(deg))

    def root_oracles():
        first = P.canonical_bfs(g, root0)
        comp = np.flatnonzero(first[0] != P.INF_DIST)
        rng = np.random.default_rng(args.seed)
        drawn = [root0] + [int(r) for r in rng.choice(comp, ROOTS - 1, replace=False)]
        return comp, rng, drawn, {root0: first, **{r: P.canonical_bfs(g, r) for r in drawn[1:]}}

    f_oracles = prep.submit(root_oracles)
    rg, setup = layout_phase(P, g, store)
    mask_bytes = rg.net_masks.nbytes + rg.vperm_masks.nbytes
    log(f"layout: vr={rg.vr} net_size={rg.net_size} "
        f"vperm_size={rg.vperm_size} stages net={len(rg.net_table)} "
        f"vperm={len(rg.vperm_table)} mask bytes={mask_bytes} "
        f"in_classes={len(rg.in_classes)} out_classes={len(rg.out_classes)}")
    mark("graph, layout build and load")
    # ``rng`` goes on to draw the batch's sources after the roots.
    comp, rng, roots, oracles = f_oracles.result()
    prep.shutdown()
    oracle0 = oracles[root0]
    mark("root oracles (the wait left)")
    routers = router_phase(P, g, rg, setup["stages"], root0, oracle0, K, R, card)
    mark("routers")
    t0 = time.perf_counter()
    eng = P.RelayEngine(rg, device="cuda", sparse_hybrid=False)
    torch.cuda.synchronize()
    log(f"engine: layout shipped in {time.perf_counter() - t0:.2f} s")
    # The default arm (auto) at s22: gather by the tile budget, no tile built.
    if (eng.expansion, eng.adj_tiles, eng.mxu_operands, eng.phase_probe, eng.tiles_build_s) != (
            "gather", None, None, None, 0.0) or not eng.expansion_basis.startswith(
            "auto -> gather: tiles over budget"):
        raise AssertionError(f"s22 default engine: {eng.expansion} ({eng.expansion_basis})")
    log(f"engine: expansion auto -> {eng.expansion} by the budget in {eng.tile_count_s:.3f} s "
        f"(the tile count; no tile built): '{eng.expansion_basis}' ({card})")
    CHECKER.update(dc=P.DeviceChecker.from_graph(g), passed=0)

    mark("engine")
    # ---- kernels against their plain versions -----------------------------
    kres = kernel_phase(eng, K, R, card)
    mark("kernel phase")
    ledger = ledger_phase(eng, card)
    mark("phase ledger")

    # ---- main path: the gather arm on the captured block loop, against
    # the eager loop; then the oracle, the result copy's two designs and
    # the block size table
    d0 = oracle0[0]
    directed_traversed = int(np.count_nonzero(d0[g.src] != P.INF_DIST))
    gather = loop_phase("gather search", eng, roots, GATHER_STEP, "packed_update", K, L)
    # The oracle's and the search's host arrays are kept for the MXU arm's
    # comparison.
    want = {}
    for r in roots:
        res = gather["results"][r]
        dist, parent = oracles[r]
        if not (np.array_equal(res.dist, dist) and np.array_equal(res.parent, parent)):
            raise AssertionError(f"root {r}: result differs from canonical_bfs")
        # The host check() on the max-degree root; every root is
        # canonical_bfs's tree and clean under the DeviceChecker.
        violations = P.check(g, res.dist, res.parent, r) if r == root0 else []
        if violations:
            raise AssertionError(f"root {r}: check() violations {violations[:3]}")
        verify(f"gather root {r}", res.dist, res.parent, r)
        want[r] = ((dist, parent), res)
    launches = {k: gather["launches"][k] for k in REPLACES}
    mean_s = gather["mean"]["secs"]
    log(f"main path: all {len(roots)} roots oracle-exact and DeviceChecker-clean, check() clean "
        f"on root {root0}; captured loop mean "
        f"{mean_s:.6f} s/search, {directed_traversed / 2 / mean_s:.6g} undirected TEPS "
        f"({directed_traversed // 2} undirected edges in the component); launches {launches}")
    designs = result_designs(eng, root0)
    curve = relay_curve_phase(eng, root0, want[root0][0][0], K)
    corrupted = verify_corruptions(g, root0, *want[root0][0])
    gather["table"] = block_table("gather search, 4 searches a run", lambda: searches(eng, roots), L,
                                  eng, reps=1)
    mark("gather main path")
    # ---- the transfer guard: the s22 search in a guarded region, the canary
    guard = guard_phase(eng, root0, oracle0, RT, card)
    mark("transfer guard")
    # ---- the lock-step batch on the gather arm, then each of its kernels on
    # the 16 trees against its plain version and 16 single launches
    # The 4 roots first (their oracle results are at hand), then sources drawn
    # with --seed + 1 from the rest of the component.
    lock_sources = np.asarray([*roots, *np.random.default_rng(args.seed + 1).choice(
        np.setdiff1d(comp, roots), max(LOCKSTEP_S) - len(roots), replace=False)], dtype=np.int32)
    lockstep = {"gather": lockstep_phase("gather lock-step", eng, g, lock_sources, LOCKSTEP_S,
                                         GATHER_STEP, "packed_update", K, P, L,
                                         oracle={r: want[r][0] for r in roots})}
    for k, n in lockstep["gather"]["launches"].items():
        launches[k] += n
    lock_kernels = lockstep_kernel_phase(eng, lock_sources, K, R, card)
    mark("lock-step gather")

    # ---- MXU arm: tiles, K6 against its plain version, the 4 searches ---
    tiles_oracle_check(P, generators, AT)
    torch.cuda.empty_cache()
    meng, mxu_held = mxu_engine(P, AT, rg, args.scale)
    kres.update(mxu_kernel_phase(eng, meng, root0, K, R, RM, card))
    mxu = mxu_main_path(meng, g, roots, want, directed_traversed, K, P, L)
    launches.update({k: mxu["launches"][k] for k in MXU_REPLACES})
    mark("mxu arm")
    # ---- the lock-step batch on the MXU arm (its trees equal the gather
    # batch's), then mxu_expand on the gather batch's 16 trees
    lockstep["mxu"] = lockstep_phase("mxu lock-step", meng, g, lock_sources, LOCKSTEP_MXU_S,
                                     MXU_STEP, "mxu_expand", K, P, L)
    top = lockstep["gather"]["rows"][max(LOCKSTEP_S)]["result"]
    for S, row in lockstep["mxu"]["rows"].items():
        if not (np.array_equal(row["result"].dist, top.dist[:S])
                and np.array_equal(row["result"].parent, top.parent[:S])):
            raise AssertionError(f"mxu lock-step S={S}: trees differ from the gather arm's batch")
    for k, n in lockstep["mxu"]["launches"].items():
        launches[k] += n
    trees = []
    for d in top.dist:
        densest = int(np.argmax(np.bincount(d[d != P.INF_DIST])))
        trees.append((frontier_of(meng, d, densest), frontier_of(meng, d, 1)))
    lock_kernels.update(lockstep_mxu_kernel_check(meng, trees, K, RM, card))
    del trees, top
    mark("lock-step mxu")
    # ---- superstep checkpoints on the dense MXU engine
    ckpt_roots = roots[:2]  # the max-degree root and one other
    ckpt = {"mxu dense": ckpt_relay_phase("checkpoints, mxu dense", meng, ckpt_roots, want,
                                          MXU_STEP, K, L, card, ckpt_store)}
    mark("checkpoints, mxu dense")
    del meng
    torch.cuda.empty_cache()

    # ---- multi-source: the batch (its first call builds the route index),
    # then the route index and the elem kernels against their plain versions
    sources = np.asarray(rng.choice(comp, BATCH, replace=False), dtype=np.int32)
    torch.cuda.empty_cache()
    multi = multi_source_phase(eng, g, sources, directed_traversed, K, RE, P, L)
    launches.update(multi["launches"])
    for k, n in multi["lock_launches"].items():
        launches[k] += n
    kres.update(elem_kernel_phase(eng, sources, K, RE, card))
    mark("multi-source")
    del eng  # the hybrid engines below ship the layout again
    torch.cuda.empty_cache()

    # ---- the push and pull engines: layouts, the fused searches (captured
    # against eager), their supersteps against the byte bound, the batches,
    # the stepped runners on all three engines and the command-line runners
    dg, pg, edge_build = edge_layouts(g, P)
    edge = {}
    # The semiring algorithms ride the same two engines; CC's host oracle.
    t0 = time.perf_counter()
    cc_labels, ncomp = cc_truth(g)
    log(f"cc oracle: scipy connected_components, {ncomp} components, minimum ids in "
        f"{time.perf_counter() - t0:.2f} s")
    algo = {}
    for engine, layout in (("pull", pg), ("push", dg)):
        t0 = time.perf_counter()
        eeng = P.EdgeEngine(layout, engine=engine)
        torch.cuda.synchronize()
        log(f"{engine} engine: layout shipped in {time.perf_counter() - t0:.2f} s")
        edge[engine] = edge_search_phase(f"{engine} search", eeng, roots, want, K, L)
        batch = sources[:EDGE_BATCH]
        edge[engine]["batch"] = edge_batch_phase(f"bfs_multi({engine})", eeng, batch,
                                                 multi["result"], K)
        if engine == "push":
            ckpt["multi push"] = ckpt_multi_phase(eeng, sources[:CKPT_MULTI], multi["result"], K,
                                                  L, card, ckpt_store)
        mark(f"{engine} engine")
        # ---- the semiring algorithms on the same engine: CC on both, SSSP
        # and the segmented runs on push
        algo[f"cc {engine}"] = algo_cc_phase(eeng, g, cc_labels, K, L, card)
        if engine == "push":
            algo["sssp"] = algo_sssp_phase(eeng, g, roots, K, L, card)
            algo["ckpt"] = algo_ckpt_phase(eeng, roots[0], algo["sssp"]["results"][(roots[0], None)],
                                           algo["cc push"]["result"], ckpt_store, K, L, card)
        del eeng
        torch.cuda.empty_cache()
        mark(f"algorithms, {engine}")
    # ---- the direction policy over push and pull, on the same layouts
    from bfs_tpu_torch.models import direction as D

    t0 = time.perf_counter()
    deng = P.DirectionEngine.from_graph(dg, pull_graph=pg, config=P.resolve_direction("auto"))
    torch.cuda.synchronize()
    log(f"direction engine: both layouts shipped in {time.perf_counter() - t0:.2f} s; "
        f"config {deng.config}")
    direction = direction_phase(deng, g, roots, want, K, D)
    direction["batch"] = direction_batch_phase(
        deng, sources[:EDGE_BATCH], multi["result"], np.bincount(g.src, minlength=g.num_vertices), K)
    del deng
    torch.cuda.empty_cache()
    mark("direction policy")
    # ---- the relay engine's hybrid schedule (sparse_hybrid=True) on both
    # arms, from the same layout, one engine at a time
    hybrid = {}
    for arm, dense_s in (("gather", gather["mean"]["secs"]), ("mxu", mxu["mean"]["secs"])):
        heng = hybrid_engine(P, rg, arm)
        hybrid[arm] = hybrid_phase(heng, g, roots, want, edge["pull"]["results"], dense_s, K, D)
        mark(f"hybrid {arm}")
        if arm == "gather":
            # ---- superstep checkpoints on the default engine: kill and resume
            ckpt["hybrid gather"] = ckpt_relay_phase(
                "checkpoints, hybrid gather auto", heng, ckpt_roots, want, GATHER_STEP, K, L, card,
                ckpt_store, kill=True)
            mark("checkpoints, hybrid gather")
        del heng
        torch.cuda.empty_cache()
    runners, relay_merge = runner_phase({"push": dg, "pull": pg, "relay": rg}, root0, want, K, P)
    mark("runners")
    # ---- the mesh-sharded engine: 4 shards stacked on the card, every
    # search, batch and algorithm against the single-chip results above
    sharded = sharded_phase(
        P, g, dg, roots, want,
        {"pull": edge["pull"]["mean"]["secs"], "push": edge["push"]["mean"]["secs"],
         "relay pull": gather["mean"]["secs"],
         "relay auto": hybrid["gather"]["mean"][("auto", "blocks")]},
        multi["result"], algo["sssp"]["results"][(roots[0], None)], algo["cc push"]["result"],
        K, card, ckpt_store)
    for k, n in sharded["launches"].items():
        if n:
            launches[k] = launches.get(k, 0) + n
    mark("sharded")
    # ---- the query server on the same graph: every reply against the
    # relay batch's trees and the roots' oracle results
    serve = serve_phase(P, g, store, pg, sources, roots, multi["result"], want, card, K, L,
                        algo_want=(algo["sssp"]["results"][(roots[0], None)],
                                   algo["cc push"]["result"]))
    algo["registry"] = serve["algo"]
    ckpt["serve"] = serve["segmented"]
    prom_lines = prometheus_check()
    mark("serve")
    # ---- the load generator's classic mode on the relay engine, every
    # bucket warm, its replies against the batch's trees
    loadgen = loadgen_phase(P, g, store, sources, multi["result"], args.seed, K, card)
    for part in (loadgen["warm_launches"], loadgen["launches"]):
        for k, n in part.items():
            launches[k] += n
    mark("load generator")
    # ---- the landmark label tier, then the fleet router, on the same
    # graph: every reply against the batch's trees
    labels = labels_phase(P, g, store, sources, multi["result"], args.seed, K, card)
    mark("labels")
    fleet = fleet_phase(P, g, store, sources, multi["result"], args.seed, K, card)
    mark("fleet")
    launches["loop_control"] += labels["launches"] + fleet["launches"]
    # ---- beyond device memory: the streamed MXU arm, every resident MXU
    # engine freed
    torch.cuda.empty_cache()
    stream = stream_phase(P, rg, g, roots, want, mxu["results"], mxu_held, K, RM, AT, D, card,
                          ckpt_store)
    for k, n in stream["launches"].items():
        launches[k] += n
    del want
    mark("stream")
    # ---- the resilience drivers, each a process of its own, started now:
    # the chaos modes and cache_warm's cold and warm runs run beside the
    # command line and the small-graph checks below, none of them timed
    cold_warm, f_warm = start_cache_warm(cache_dir)
    chaos_procs, chaos_t0 = start_chaos(cache_dir)
    cli_phase(K)
    mark("command line")

    # ---- small graphs ---------------------------------------------------
    tiny = P.read_sedgewick(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                         "test-sets", "tinyCG.txt"))
    res = P.bfs(tiny, 0, engine="relay")
    if (res.dist.tolist(), res.parent.tolist(), res.num_levels) != (
        [0, 1, 1, 2, 2, 1], [0, 0, 0, 2, 2, 0], 3
    ):
        raise AssertionError(f"tinyCG: got {res.dist.tolist()} {res.parent.tolist()} {res.num_levels}")
    log("tinyCG on the relay engine: dist [0,1,1,2,2,1], parents [0,0,0,2,2,0], 3 supersteps")
    small_path_check(P, K, "gather")
    small_edge_checks(P, K, tiny)
    small_mxu_checks(P, tiny, K)
    small_hybrid_checks(P, K)
    small_ckpt_checks(P, L, ckpt_store)
    small_multi_checks(P, tiny)
    small_lockstep_checks(P, K)
    mark("small graphs")
    algo["small"] = algo_small_checks(P, generators, K, L, ckpt_store)
    mark("algorithms, small graphs and graph500_run")
    # ---- the chaos runs' verdicts, cache_warm's warm run, and every
    # registry kernel at lint scale against its plain version
    chaos = chaos_phase(chaos_procs, chaos_t0, card)
    mark("chaos driver (the wait left)")
    warmed = cache_warm_phase(P, cache_dir, cold_warm, f_warm, card)
    mark("cache_warm")
    registry = registry_phase(KREG, card)
    mark("kernel registry")
    del rg
    shutil.rmtree(store)  # the bundle: memmapped pages stay valid until unmapped
    mark("bundle store removed")

    # ---- report ---------------------------------------------------------
    # The default relay engine's probe (main path since auto is the default).
    for k, n in probe["launches"].items():
        launches[k] += n
    # The control step ends every superstep of the algorithms' loops too.
    launches["loop_control"] += sum(algo[k]["launches"] for k in
                                    ("sssp", "cc pull", "cc push", "ckpt", "registry"))
    # The kernels line, read from the kernel registry (analysis/kernels.py):
    # per spec its rows, each a held comparison with its plain version.  A
    # single-search kernel's rows are its kres entries (``kernel``, default
    # the entry's name; a row shared by ``share`` entries takes that part of
    # the launch key's count, which holds the batch kernels' launches too); a
    # batch kernel's rows are the lock-step kernel phase's (16 and 4 trees),
    # with the gather lock-step batch's launches of its key.
    kernels, unheld = [], []
    for spec in KREG.KERNEL_SPECS.values():
        if spec.name in BATCH_SPECS:
            picked = [(name, r, lockstep["gather"]["launches"][spec.launch_key])
                      for name, r in lock_kernels.items()
                      if name.startswith(spec.launch_key + " (")]
        else:
            picked = [(row, r, launches[spec.launch_key] // r.get("share", 1))
                      for row, r in kres.items() if r.get("kernel", row) == spec.launch_key]
        if not picked or spec.name not in registry:
            unheld.append(spec.name)
        kernels += [
            dict(name=row, route="cuda", source=spec.source, replaces=spec.replaces,
                 launches=n, max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                 bound_ms=r["bound_ms"], bound_by=r.get("bound_by", "bytes"),
                 library_ms=r.get("library_ms"), gated_ms=r.get("gated_ms"),
                 kernel=spec.name, reference=spec.k,
                 phase=("lock-step kernel phase: " if spec.name in BATCH_SPECS
                        else "kernel phase: ") + r["shape"],
                 **({} if spec.name in BATCH_SPECS or spec.launch_key not in sharded["check"] else
                    dict(sharded_max_abs_err=sharded["check"][spec.launch_key][0],
                         sharded_shape=sharded["check"][spec.launch_key][1])),
                 **({} if spec.name in BATCH_SPECS or spec.launch_key not in sharded["grid"]["check"]
                    else dict(grid_max_abs_err=sharded["grid"]["check"][spec.launch_key][0],
                              grid_shape=sharded["grid"]["check"][spec.launch_key][1])))
            for row, r, n in picked]
    if unheld:
        raise AssertionError(f"registry kernels never held against their plain versions in "
                             f"this run: {unheld}")
    # The loop's targets, read off this run (reported, not enforced).
    extraction = multi["splits"]["dropped"][-1]["result_s"]
    targets = [
        ("gather-search level loop <= 3 ms", gather["mean"]["loop_s"] * 1e3, 3.0),
        ("single-search result path <= 4 ms (earlier results freed)",
         gather["mean"]["result_s"] * 1e3, 4.0),
        ("single-search result copy <= 4 ms (earlier results kept)", designs["pinned kept"], 4.0),
        ("64-source extraction <= 0.3 s (earlier results freed)", extraction, 0.3),
        ("64-source extraction <= 0.3 s (earlier results kept)",
         multi["splits"]["kept"][-1]["result_s"], 0.3),
        ("batch idle share below the eager loop's", multi["idle"]["blocks"] or 1.0,
         multi["idle"]["eager"] or 0.0),
    ]
    log("targets: " + "; ".join(f"{name}: {got:.6f} against {limit:.6f}, "
                                f"{'met' if got < limit else 'not met'}"
                                for name, got, limit in targets)
        + "; host reads per search within the target: met (asserted)")
    log("dead superstep ms: " + ", ".join(
        f"{name} {d:.6f}" for name, d in (("gather", gather["dead_ms"]), ("mxu", mxu["dead_ms"]),
                                          ("64-source batch", multi["dead_ms"]))))
    log("push and pull engines (plain torch supersteps, XLA in the reference; no kernel row): "
        + "; ".join(
            f"{e}: search {edge[e]['mean']['secs']:.6f} s (loop {edge[e]['mean']['loop_s']:.6f}, "
            f"results {edge[e]['mean']['result_s']:.6f}; eager {edge[e]['eager_mean']['secs']:.6f}), "
            f"superstep mean {edge[e]['steps']['mean_ms']:.4f} ms, slowest "
            f"{edge[e]['steps']['max_ms']:.4f} ms against a bound of {edge[e]['steps']['bound_ms']:.4f} ms, "
            f"the live gate {edge[e]['steps']['gate_ms']:.4f} ms, "
            f"dead superstep {edge[e]['dead_ms']:.6f} ms, peak {edge[e]['peak']} bytes; batch of "
            f"{edge[e]['batch']['trees']} {edge[e]['batch']['secs']:.6f} s (eager, the first "
            f"{edge[e]['batch']['eager_trees']}: {edge[e]['batch']['eager_s']:.6f} s)"
            for e in ("pull", "push"))
        + f"; relay gather search {gather['mean']['secs']:.6f} s in the same run; layouts built in "
        f"{edge_build['device_graph_s']:.3f} s (DeviceGraph) and {edge_build['pull_graph_s']:.3f} s "
        f"(PullGraph); SuperstepRunner ms per run "
        + ", ".join(f"{e} {sum(v) * 1e3:.3f} ({len(v)} steps)" for e, v in runners.items())
        + f"; relay runner step {relay_merge['step_ms']:.4f} ms against {relay_merge['plain_ms']:.4f} "
        "ms for K1-K3 and the unpacked merge (device, mean)")
    log("direction policy (push/pull, plain torch bodies): mean s/search on the captured loop "
        + ", ".join(f"{m} {direction['mean'][(m, 'blocks')]:.6f}" for m in ("auto", "push", "pull"))
        + "; eager " + ", ".join(f"{m} {direction['mean'][(m, 'eager')]:.6f}"
                                 for m in ("auto", "push", "pull"))
        + f"; auto schedules {direction['schedules']}; superstep push "
        f"{direction['per_body']['push']:.4f} ms, pull {direction['per_body']['pull']:.4f} ms, "
        f"decide {direction['decide_ms']:.4f} ms; bfs_multi_direction {direction['batch']['secs']:.6f} s "
        f"(schedule {direction['batch']['schedule']}); run_level_curve {curve['curve_s']:.6f} s "
        f"against run {curve['run_s']:.6f} s; DeviceChecker: {CHECKER['passed']} results clean, "
        f"corruptions flagged {corrupted}")
    log("relay hybrid (sparse_hybrid=True; sparse body plain torch, XLA in the reference): mean "
        "s/search on the captured loop " + "; ".join(
            f"{arm}: auto {h['mean'][('auto', 'blocks')]:.6f}, push "
            f"{h['mean'][('push', 'blocks')]:.6f} (eager {h['mean'][('auto', 'eager')]:.6f}, "
            f"{h['mean'][('push', 'eager')]:.6f}), dense {dense_s:.6f}; sparse supersteps "
            + ", ".join(f"{x:.4f}" for x in h["sparse_ms"])
            + " ms against dense " + ", ".join(f"{x:.4f}" for x in h["dense_ms"])
            + f" ms on the same levels; predicate auto {h['predicate_ms']['auto']:.4f} ms, push "
            f"{h['predicate_ms']['push']:.4f} ms; run_many_device {h['many_s']:.6f} s"
            for arm, h, dense_s in (("gather", hybrid["gather"], gather["mean"]["secs"]),
                                    ("mxu", hybrid["mxu"], mxu["mean"]["secs"])))
        + f"; auto schedules (gather) {hybrid['gather']['schedules']}")
    log(f"layout set-up (R-MAT scale {args.scale}): cold load_or_build_relay {setup['cold_s']:.3f} s "
        f"(device build {setup['build_s']:.3f} s, bundle save {setup['save_s']:.3f} s, "
        f"{setup['bundle_bytes']} bytes), warm load {setup['warm_s']:.6f} s; net route native "
        f"{routers['net']['native_s']:.3f} s against torch {routers['net']['torch_s']:.3f} s, vperm "
        f"native {routers['vperm']['native_s']:.3f} s against torch {routers['vperm']['torch_s']:.3f} "
        f"s; scale {PARITY_SCALE} builds " + ", ".join(f"{k} {v:.3f} s" for k, v in layout_parity.items()))
    srep = serve["report"]
    log(f"query server (pull default, max_batch 32, tick 2 ms, verify 1 in 4; R-MAT scale "
        f"{args.scale}): p50 {srep['latency_p50_ms']:.3f} ms, p99 {srep['latency_p99_ms']:.3f} ms, "
        f"{srep['queries_per_sec']:.3f} queries/s over {srep['served']} queries; round 2 "
        f"{len(serve['buckets'])} ticks, all executable-cache hits; result seconds of a pull "
        f"bucket-32 tick: cache 0 {serve['result_s']['cache 0']}, cache 256 "
        f"{serve['result_s']['cache 256']}; round 1 {serve['round1_s']:.3f} s")
    log(f"label tier (K = {LABELS_K}, pull, max_batch 32; R-MAT scale {args.scale}, {card}): cold "
        f"register {labels['cold_s']:.3f} s (build {labels['build_s']:.3f} s, bundle "
        f"{labels['bundle_bytes']} bytes), warm {labels['warm_s']:.3f} s; tight rate "
        f"{labels['tight_rate']:.4f}; a label answer idle {pcts(labels['idle'])}, behind a pull "
        f"tick of 32 {pcts(labels['behind'])}; an exact answer {pcts(labels['exact'])}; "
        f"label_bounds {labels['lookup_ms']:.4f} ms against {labels['lookup_bound_ms']:.6f} ms; "
        f"fleet of 2 (load generator): {fleet['res']['queries_per_sec']:.3f} queries/s, p50 "
        f"{fleet['res']['latency_p50_ms']:.3f} ms, p99 {fleet['res']['latency_p99_ms']:.3f} ms, "
        f"phase {fleet['wall_s']:.3f} s, router {fleet['router']}")
    lgr = loadgen["res"]
    log(f"load generator, classic (relay, max_batch 32; R-MAT scale {args.scale}, {card}): "
        f"{lgr['queries_per_sec']:.3f} queries/s, p50 {lgr['latency_p50_ms']:.3f} ms, p99 "
        f"{lgr['latency_p99_ms']:.3f} ms over {lgr['requests']} requests, steady hit rate "
        f"{lgr['steady_compile_hit_rate']:.4f}, ticks "
        f"{ {k: v['ticks'] for k, v in lgr['ticks_by_bucket'].items()} }; warm-up "
        f"{loadgen['warm_s']:.3f} s; prometheus text {prom_lines} lines")
    log(f"superstep checkpoints (R-MAT scale {args.scale}, {card}): relay every:{CKPT_EVERY}, "
        "fused / segmented s, epoch bytes, epoch writes s, carry copies s: " + "; ".join(
            f"{name} root {row['root']} {row['fused_s']:.6f} / {row['seg_s']:.6f}, "
            f"{row['report']['snapshot_bytes']}, {row['report']['snapshot_seconds_total']:.6f}, "
            f"{row['run']['copy_s']:.6f}"
            for name in ("mxu dense", "hybrid gather") for row in ckpt[name]["rows"])
        + f"; resumed from epoch {ckpt['hybrid gather']['resume']['report']['resumed_from_epoch']} "
        f"in {ckpt['hybrid gather']['resume']['secs']:.6f} s; push batch of {CKPT_MULTI} at "
        f"every:{CKPT_MULTI_EVERY} {ckpt['multi push']['fused_s']:.6f} / "
        f"{ckpt['multi push']['seg_s']:.6f} ({ckpt['multi push']['report']['snapshot_bytes']} "
        f"bytes an epoch); serve push tick of {CKPT_MULTI} {ckpt['serve']['fused_s']:.6f} / "
        f"{ckpt['serve']['secs']:.6f} ({ckpt['serve']['segments']} segments)")
    asp, ack = algo["sssp"], algo["ckpt"]
    log(f"semiring algorithms (R-MAT scale {args.scale}, {card}): sssp "
        + "; ".join(f"root {r['root']} delta {r['delta']} {r['secs']:.6f} s, {r['rounds']} rounds, "
                    f"{r['issued']} issued" for r in asp["rows"])
        + f"; superstep {asp['step_ms']:.4f} ms against a bound of {asp['bound_ms']:.4f} ms; cc "
        + "; ".join(f"{e} {algo['cc ' + e]['secs']:.6f} s, {algo['cc ' + e]['result'].rounds} "
                    f"rounds, first superstep {algo['cc ' + e]['step_ms']:.4f} ms against "
                    f"{algo['cc ' + e]['bound_ms']:.4f} ms" for e in ("push", "pull"))
        + "; segmented " + ", ".join(f"{k} every:{ack[k]['every']} {ack[k]['secs']:.6f} s "
                                     f"(fused {ack[k]['fused_s']:.6f} s)" for k in ("sssp", "cc"))
        + "; registry " + ", ".join(f"{r['name']} #{r['call']} {r['secs']:.6f} s"
                                    for r in algo["registry"]["rows"])
        + f"; graph500_run {algo['small']['graph500_s']:.2f} s")
    st_pull = stream["pull"]
    log(f"streamed MXU arm (R-MAT scale {args.scale}, {card}): host store "
        f"{stream['store']['host_store_bytes']} bytes over {stream['store']['num_superblocks']} "
        f"superblocks (padding {stream['pad_share']:.4f}), built in {stream['init_s']:.2f} s "
        f"(tiles {stream['tiles_build_s']:.3f}, pinning {stream['build_s']['pin_s']:.3f}, copy "
        f"{stream['build_s']['copy_s']:.3f}, fingerprints {stream['build_s']['fingerprint_s']:.3f}); "
        f"device memory held {stream['held']} bytes; auto searches "
        + ", ".join(f"root {row['root']} {row['secs']:.6f} s ({row['ledger']['bytes_streamed']} "
                    f"bytes)" for row in stream["rows"])
        + f"; all-pull {st_pull['secs']:.6f} s at up to "
        f"{max((x['gbs'] for x in st_pull['levels']), default=0.0):.3f} GB/s against a pinned "
        f"copy's {st_pull['h2d_gbs']:.3f} GB/s; resumed run {stream['resume']['secs']:.6f} s; "
        f"device peak {stream['peak']} bytes within {stream['bound']}")
    relay4 = [t for t in serve["ticks"] + serve["round2"]
              if (t["engine"], t["bucket"]) == ("relay", 4)]
    log(f"lock-step batch (RelayEngine.run_multi; R-MAT scale {args.scale}, {card}): " + "; ".join(
        f"{arm} S={S} {r['secs']:.6f} s (loop {r['run']['loop_s']:.6f}, results "
        f"{r['run']['result_s']:.6f}; first call {r['first_s']:.6f}) against {S} x run "
        f"{r['singles_s']:.6f} s, dead superstep {r['dead_ms']:.6f} ms, peak {r['peak']} bytes"
        for arm in ("gather", "mxu") for S, r in lockstep[arm]["rows"].items())
        + f"; 64 sources {multi['lock_s']:.6f} s against the element-major batch's "
        f"{multi['secs']:.6f} s; serve relay-4 ticks (service s) "
        + ", ".join(f"{t['service_s']:.6f} (hit {t['compile_hit']})" for t in relay4)
        + "; kernels (16 trees unless named), ms (cold L2) / as many single launches / "
        "bound: " + ", ".join(f"{name} {r['ms']:.4f} / {r['singles_ms']:.4f} / "
                              f"{r['bound_ms']:.4f}" for name, r in lock_kernels.items()))
    log(f"measured arm selection (R-MAT s{PROBE_SCALE} ef {PROBE_EDGE_FACTOR}, {card}): "
        f"{probe['tiles']} tiles ({probe['edges'] / probe['tiles']:.4f} edges a tile); probe "
        f"gather {probe['gather_s']:.6g} s, mxu {probe['mxu_s']:.6g} s a dense superstep, "
        f"selected {probe['selected']}; default engine {probe['init_s']:.3f} s, memo hit "
        f"{probe['init2_s']:.3f} s; mean s/search " + ", ".join(
            f"{a} {t:.6f}" for a, t in probe["secs"].items()) + f"; batch of {PROBE_TREES} "
        + ", ".join(f"{a} {r['secs']:.6f} s (loop {r['loop_s']:.6f})"
                    for a, r in probe["lock"].items())
        + f"; s22 phase ledger: sum {ledger['sum_of_phases_seconds'] * 1e3:.4f} ms, full "
        f"superstep {ledger['full_superstep_seconds'] * 1e3:.4f} ms")
    log("phases, wall s: " + ", ".join(f"{name} {t - t0:.1f}" for (_, t0), (name, t)
                                        in zip(marks, marks[1:])))
    log(f"total {time.perf_counter() - T_PROCESS:.1f} s since the script started")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
