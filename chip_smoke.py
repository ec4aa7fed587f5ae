#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``bfs_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the hand-written kernels from ``bfs_tpu_torch/csrc``, builds the
relay layout of a Graph500-style R-MAT graph (a/b/c = .57/.19/.19, edge
factor 6, graph seed 1, scale 22 by default), holds every kernel against its
plain PyTorch version on the card at the layout's real shapes (bit-exact),
then drives the main path — ``RelayEngine.run`` on the card for 4 roots drawn
from ``--seed`` — and checks every result against the port's host oracle
(``canonical_bfs`` bit for bit, ``check()`` without violations).  Two small
graphs follow: tinyCG (the paper's worked example) and a 100-vertex path
(deeper than the packed carry's 62 levels, so it takes the unpacked re-run).

Output: progress lines, the card's name and power limit as nvidia-smi gives
them, one ``{"kernels": [...]}`` JSON line, and as the last line
``{"ok": true, "device": {...}}``.  Any failed phase raises and the script
exits non-zero; without a CUDA device it exits non-zero before any phase.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, data-sheet peak
EDGE_FACTOR = 6  # the repo bench's R-MAT family: Graph500 a/b/c, edge factor 6
GRAPH_SEED = 1
ROOTS = 4
SOURCE = "bfs_tpu_torch/csrc/relay_kernels.cu"
REPLACES = {
    "benes_local_pass": "bfs_tpu/ops/relay_pallas.py:455",
    "benes_outer_stage": "bfs_tpu/ops/relay_pallas.py:618",
    "class_rowmin": "bfs_tpu/ops/relay_pallas.py:1059",
    "packed_update": "bfs_tpu/ops/relay_pallas.py:1188",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0].strip()


_FLUSH = []


def cuda_ms(fn, reps: int, warm: int = 2) -> float:
    """Mean milliseconds per call on the card: CUDA events around each of
    ``reps`` calls (after ``warm`` warm-up calls), each call preceded by a
    256 MB write that evicts the 50 MB L2, so every call starts cold as the
    main path's mask reads do."""
    import torch

    if not _FLUSH:
        _FLUSH.append(torch.empty(64 << 20, dtype=torch.int32, device="cuda"))
    for _ in range(warm):
        fn()
    pairs = []
    for _ in range(reps):
        _FLUSH[0].zero_()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        pairs.append((t0, t1))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def max_abs_err(a, b) -> int:
    """Largest difference of two uint32 word tensors (int32 patterns)."""
    from bfs_tpu_torch.ops.packed import u32

    return int((u32(a) - u32(b)).abs().max().item()) if a.numel() else 0


def device_trace(eng, root: int, wall_s: float) -> None:
    """Trace one more search of ``root`` with ``torch.profiler`` (CUPTI) and
    print the card's busy time per search, its idle share against
    ``wall_s`` (the untraced host seconds of that search), and the device
    time per kernel name.  Busy time is the union of the device activity
    intervals (kernels and copies)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.run(root)
        torch.cuda.synchronize()
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    if not spans:
        log("device trace: the profiler recorded no device activity; "
            "idle share not measured")
        return
    busy_us, end, per_name = 0.0, float("-inf"), {}
    for a, b, name in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
        per_name[name] = per_name.get(name, 0.0) + (b - a)
    busy_s = busy_us * 1e-6
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"device trace, root {root}: {len(spans)} device activities, busy "
        f"{busy_s:.6f} s of the untraced {wall_s:.6f} s search: idle share "
        f"{1.0 - busy_s / wall_s:.4f}; device ms by name: "
        + ", ".join(f"{n[:40]} {t * 1e-3:.4f}" for n, t in top))


def kernel_phase(eng, K, R, card: str) -> dict:
    """Each kernel against its plain version on the card, on the inputs the
    main path gives it at the superstep with the largest frontier."""
    import numpy as np
    import torch

    rg = eng.relay_graph
    dev = eng.device
    # Inputs: walk the main path (kernels) from the max-out-degree vertex
    # and keep the carry of the superstep with the largest frontier.
    outdeg = np.diff(rg.adj_indptr[: rg.vr + 1])
    st = R.init_packed_relay_state(rg.vr, int(np.argmax(outdeg)), dev)
    best = None
    while bool(st.changed):
        count = int(R.unpack_std(st.fwords, rg.vr).sum())
        if best is None or count > best[0]:
            best = (count, st.packed.clone(), st.fwords.clone(), st.level)
        st = eng.superstep_packed(st)
    count, packed0, fwords0, level0 = best
    log(f"kernel inputs: superstep {level0 + 1}, frontier {count} vertices")

    fw = torch.zeros(rg.vperm_size // 32, dtype=torch.int32, device=dev)
    fw[: rg.vr // 32] = fwords0
    y = K.apply_benes(fw, eng.vperm_masks, rg.vperm_table, rg.vperm_size)
    l2 = R.broadcast_l2(y, rg.out_classes, rg.net_size, rg.out_space)
    n, table, masks = rg.net_size, rg.net_table, eng.net_masks
    pre, local, suf, tile = K.split_passes(table, n)
    nw = n // 32
    results = {}

    def record(name, err, ms, plain_ms, nbytes, shape):
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from its plain version (max err {err})")
        results[name] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_bytes=nbytes,
            shape=shape,
        )
        log(f"kernel {name}: {shape}; bit-exact; {ms:.4f} ms "
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

    # benes_outer_stage: the net's first outer stage.
    if not pre:
        raise AssertionError("network too small to have outer stages; use --scale >= 16")
    st0 = table[pre[0]]
    out = torch.empty_like(l2)
    got = K.benes_outer_stage(l2, masks, st0, n, out=out)
    err = max_abs_err(got, R.apply_benes_std(l2, masks, (st0,), n))
    ms = cuda_ms(lambda: K.benes_outer_stage(l2, masks, st0, n, out=out), 50)
    pms = cuda_ms(lambda: R.apply_benes_std(l2, masks, (st0,), n), 10)
    nbytes = 2 * 4 * nw + 4 * st0.nwords
    record("benes_outer_stage", err, ms, pms, nbytes,
           f"net n={n} d={st0.d} ({len(pre) + len(suf)} outer stages per apply)")
    # benes_local_pass: the net's local run, on the prefix's output.
    x = l2
    for i in pre:
        x = R.apply_benes_std(x, masks, (table[i],), n)
    stages = tuple(table[i] for i in local)
    out = torch.empty_like(x)
    got = K.benes_local_pass(x, masks, stages, n, tile, out=out)
    err = max_abs_err(got, R.apply_benes_std(x, masks, stages, n))
    ms = cuda_ms(lambda: K.benes_local_pass(x, masks, stages, n, tile, out=out), 50)
    pms = cuda_ms(lambda: R.apply_benes_std(x, masks, stages, n), 5)
    nbytes = 2 * 4 * nw + 4 * sum(s.nwords for s in stages)
    record("benes_local_pass", err, ms, pms, nbytes,
           f"net n={n}, {len(stages)} local stages, tile {tile} words")

    # class_rowmin on the routed L1 words.
    l1 = K.apply_benes(l2, masks, table, n)
    valid = eng.valid_words
    got = K.rowmin_ranks(l1, valid, rg.in_classes, rg.vr)
    err = max_abs_err(got, R.rowmin_ranks(l1, valid, rg.in_classes, rg.vr))
    ms = cuda_ms(lambda: K.rowmin_ranks(l1, valid, rg.in_classes, rg.vr), 50)
    pms = cuda_ms(lambda: R.rowmin_ranks(l1, valid, rg.in_classes, rg.vr), 5)
    class_words = sum((c.sb - c.sa) // 32 for c in rg.in_classes)
    nbytes = 2 * 4 * class_words + 4 * rg.vr
    record("class_rowmin", err, ms, pms, nbytes,
           f"vr={rg.vr}, {len(rg.in_classes)} classes, {class_words} slot words")
    cand = got

    # packed_update on that superstep's carry.
    st_in = R.PackedRelayState(packed0, fwords0, level0, None)
    want = R.apply_relay_candidates_packed(st_in, cand)
    got = K.apply_relay_candidates_packed(st_in._replace(packed=packed0.clone()), cand)
    err = max(max_abs_err(got.packed, want.packed), max_abs_err(got.fwords, want.fwords))
    if bool(got.changed.item()) != bool(want.changed):
        raise AssertionError("packed_update: changed flag differs from the plain version")
    scratch = R.PackedRelayState(packed0.clone(), fwords0, level0, None)
    fout = torch.empty_like(fwords0)
    ms = cuda_ms(lambda: K.apply_relay_candidates_packed(scratch, cand, fwords_out=fout), 50)
    pms = cuda_ms(lambda: R.apply_relay_candidates_packed(st_in, cand), 10)
    nbytes = 3 * 4 * rg.vr + rg.vr // 8 + 4
    record("packed_update", err, ms, pms, nbytes, f"vr={rg.vr}")

    # One superstep at this frontier, phase by phase (kernel route).
    phases = {
        "vperm_benes": lambda: K.apply_benes(fw, eng.vperm_masks, rg.vperm_table, rg.vperm_size),
        "broadcast_l2": lambda: R.broadcast_l2(y, rg.out_classes, rg.net_size, rg.out_space),
        "net_benes": lambda: K.apply_benes(l2, masks, table, n),
        "class_rowmin": lambda: K.rowmin_ranks(l1, valid, rg.in_classes, rg.vr),
        "packed_update": lambda: K.apply_relay_candidates_packed(scratch, cand, fwords_out=fout),
        "superstep": lambda: eng.superstep_packed(scratch._replace(fwords=fwords0)),
    }
    times = {k: cuda_ms(f, 10) for k, f in phases.items()}
    log("superstep phases (ms, cold L2): " + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))
    results["phases"] = times
    return results


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
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import bfs_tpu_torch as P
    from bfs_tpu_torch.graph import generators
    from bfs_tpu_torch.ops import relay as R
    from bfs_tpu_torch.ops import relay_cuda as K
    from bfs_tpu_torch.utils import cuda_build

    t_all = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device {torch.cuda.get_device_name(0)}")

    # ---- build ----------------------------------------------------------
    t0 = time.perf_counter()
    K.kernels()
    info = cuda_build.BUILD_INFO["relay_kernels"]
    log(f"build: relay_kernels.cu in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {info['seconds']:.2f} s)")
    for line in info["ptxas"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", file=sys.stderr)

    # ---- layout ---------------------------------------------------------
    t0 = time.perf_counter()
    # The native generator only (it raises if it cannot be built): the numpy
    # one draws other edges, so the measured graph would silently change.
    g = generators.rmat_graph_native(args.scale, EDGE_FACTOR, seed=GRAPH_SEED)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    rg = P.build_relay_graph(g)
    t_layout = time.perf_counter() - t0
    mask_bytes = rg.net_masks.nbytes + rg.vperm_masks.nbytes
    log(f"graph: R-MAT scale {args.scale} ef {EDGE_FACTOR} seed {GRAPH_SEED} "
        f"(native generator, {t_gen:.1f} s): V={g.num_vertices} directed E={g.num_edges}")
    log(f"layout: {t_layout:.1f} s; vr={rg.vr} net_size={rg.net_size} "
        f"vperm_size={rg.vperm_size} stages net={len(rg.net_table)} "
        f"vperm={len(rg.vperm_table)} mask bytes={mask_bytes} "
        f"in_classes={len(rg.in_classes)} out_classes={len(rg.out_classes)}")
    t0 = time.perf_counter()
    eng = P.RelayEngine(rg, device="cuda")
    torch.cuda.synchronize()
    log(f"engine: layout shipped in {time.perf_counter() - t0:.2f} s")

    # ---- kernels against their plain versions -----------------------------
    kres = kernel_phase(eng, K, R, card)

    # ---- main path ------------------------------------------------------
    deg = np.bincount(g.src, minlength=g.num_vertices)
    root0 = int(np.argmax(deg))
    d0, _ = P.canonical_bfs(g, root0)
    comp = np.flatnonzero(d0 != P.INF_DIST)
    rng = np.random.default_rng(args.seed)
    roots = [root0] + [int(r) for r in rng.choice(comp, ROOTS - 1, replace=False)]
    directed_traversed = int(np.count_nonzero(d0[g.src] != P.INF_DIST))
    eng.run(root0)  # warm: caches and allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    # Each search is timed alone and then checked (untimed) and dropped, so
    # its host result arrays are released as a caller that consumes them
    # would release them.
    secs = []
    for r in roots:
        t0 = time.perf_counter()
        res = eng.run(r)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        secs.append(s)
        split = dict(eng.last_run)
        dist, parent = P.canonical_bfs(g, r)
        if not (np.array_equal(res.dist, dist) and np.array_equal(res.parent, parent)):
            raise AssertionError(f"root {r}: result differs from canonical_bfs")
        violations = P.check(g, res.dist, res.parent, r)
        if violations:
            raise AssertionError(f"root {r}: check() violations {violations[:3]}")
        log(f"search root {r}: {s:.4f} s (level loop {split['loop_s']:.4f} s, "
            f"result mapping + copy {split['result_s']:.4f} s), {res.num_levels} levels, "
            f"{directed_traversed / 2 / s:.4g} TEPS; oracle-exact, check() clean")
        del res, dist, parent
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"main path never launched kernel {name}")
    mean_s = float(np.mean(secs))
    for r, s in zip(roots, secs):
        device_trace(eng, r, s)
    log(f"main path: {len(roots)} searches, mean {mean_s:.4f} s/search, "
        f"{directed_traversed / 2 / mean_s:.6g} undirected TEPS "
        f"({directed_traversed // 2} undirected edges in the component); "
        f"peak device memory {peak} bytes; launches {launches}")

    # ---- small graphs ---------------------------------------------------
    tiny = P.read_sedgewick(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                         "test-sets", "tinyCG.txt"))
    res = P.bfs(tiny, 0)
    if (res.dist.tolist(), res.parent.tolist(), res.num_levels) != (
        [0, 1, 1, 2, 2, 1], [0, 0, 0, 2, 2, 0], 3
    ):
        raise AssertionError(f"tinyCG: got {res.dist.tolist()} {res.parent.tolist()} {res.num_levels}")
    log("tinyCG: dist [0,1,1,2,2,1], parents [0,0,0,2,2,0], 3 supersteps")
    path = P.path_graph(100)
    res = P.bfs(path, 0)
    dist, parent = P.canonical_bfs(path, 0)
    if not (np.array_equal(res.dist, dist) and np.array_equal(res.parent, parent)
            and res.num_levels == 100):
        raise AssertionError("path_graph(100): unpacked re-run differs from the oracle")
    log("path_graph(100): 100 levels through the unpacked re-run, oracle-exact")

    # ---- report ---------------------------------------------------------
    kernels = [
        dict(name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
             launches=launches[name], max_abs_err=kres[name]["max_abs_err"],
             ms=kres[name]["ms"], plain_ms=kres[name]["plain_ms"],
             bound_ms=kres[name]["bound_ms"], bound_by="bytes", library_ms=None,
             phase="kernel phase: " + kres[name]["shape"])
        for name in REPLACES
    ]
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
