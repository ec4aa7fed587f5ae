"""Graph500-style harness: the BFS and SSSP kernels over several roots and
scales, the port of the reference's ``tools/graph500_run.py``.

R-MAT graphs at Graph500 parameters (A=0.57, B=C=0.19, edge factor 16),
NBFS sampled search keys with nonzero degree, both traversal kernels timed
per root (``bfs(engine="push")`` and :func:`~bfs_tpu_torch.algo.sssp.sssp`,
on the card unless ``--device`` names the CPU), and the official output
statistics block per kernel: ``min/firstquartile/median/thirdquartile/max/
mean/stddev`` over time and traversed-edge counts plus the TEPS block with
its harmonic mean and stddev (the Graph500 v3 reference's
``output_results`` keys, ``bfs``/``sssp`` prefixed).

Deviations from the Graph500 spec, as in the reference: SSSP weights are the
repo's deterministic endpoint-hash integers in [1, max_weight]
(:func:`~bfs_tpu_torch.algo.substrate.edge_weights_np`), not uniform [0,1)
reals; validation is the repo's oracle gate (the device checks on every
root, host Dijkstra and the canonical BFS on the first), not the spec's
five-clause validator.

A run keeps a :class:`~bfs_tpu_torch.resilience.journal.RunJournal` under
:func:`~bfs_tpu_torch.config.journal_dir` (``BFS_TPU_TORCH_JOURNAL_DIR``),
keyed by its arguments, the device and the journal knobs: a scale the
journal already completed is not run again, and its stored document is
printed again.  The spans of each scale it runs go into the journal too
(``python -m bfs_tpu_torch.obs trace <journal>`` stitches them).
``--no-journal`` or ``BFS_TPU_TORCH_JOURNAL=0`` runs every scale afresh.
``--capture`` appends the bench JSONL metric lines (``{"metric", "value",
"unit", "vs_baseline", "details"}``).

Usage::

    python -m bfs_tpu_torch.tools.graph500_run --scales 8,10 --roots 8 \
        --capture graph500.jsonl [--device cpu] [--no-journal]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from ..obs.spans import span

#: Official stat order for the time/nedge blocks.
_QSTATS = ("min", "firstquartile", "median", "thirdquartile", "max")
#: The official order of a kernel's statistics block (a journaled document
#: comes back with its keys sorted).
_STAT_ORDER = (
    *(f"{q}_{m}" for m in ("time", "nedge") for q in (*_QSTATS, "mean", "stddev")),
    *(f"{q}_TEPS" for q in (*_QSTATS, "harmonic_mean", "harmonic_stddev")),
)


def _quartiles(x: np.ndarray) -> dict:
    q1, q2, q3 = np.percentile(x, [25, 50, 75])
    return {
        "min": float(np.min(x)),
        "firstquartile": float(q1),
        "median": float(q2),
        "thirdquartile": float(q3),
        "max": float(np.max(x)),
    }


def kernel_stats(times: np.ndarray, nedges: np.ndarray) -> dict:
    """The official per-kernel statistics block: quartile/mean/stddev over
    time and nedge, quartiles over per-root TEPS, and the HARMONIC mean /
    stddev of TEPS (the Graph500 aggregate: TEPS is a rate, so the mean
    of 1/TEPS is what adds; stddev via the jackknife form the reference
    uses, stddev(1/x) / (mean(1/x)^2 * sqrt(n-1)))."""
    times = np.asarray(times, dtype=np.float64)
    nedges = np.asarray(nedges, dtype=np.float64)
    teps = nedges / times
    inv = 1.0 / teps
    n = teps.size
    hmean = 1.0 / np.mean(inv)
    if n > 1:
        hstd = float(
            np.std(inv, ddof=1) / (np.mean(inv) ** 2 * np.sqrt(n - 1))
        )
    else:
        hstd = 0.0
    out = {}
    for key, val in _quartiles(times).items():
        out[f"{key}_time"] = val
    out["mean_time"] = float(np.mean(times))
    out["stddev_time"] = float(np.std(times, ddof=1)) if n > 1 else 0.0
    for key, val in _quartiles(nedges).items():
        out[f"{key}_nedge"] = val
    out["mean_nedge"] = float(np.mean(nedges))
    out["stddev_nedge"] = float(np.std(nedges, ddof=1)) if n > 1 else 0.0
    for key, val in _quartiles(teps).items():
        out[f"{key}_TEPS"] = val
    out["harmonic_mean_TEPS"] = float(hmean)
    out["harmonic_stddev_TEPS"] = hstd
    return out


def format_output(scale: int, edgefactor: int, nbfs: int, gen_s: float,
                  con_s: float, blocks: dict) -> str:
    """The official Graph500 output format: header keys then one
    ``<kernel>  <stat>: <value>`` line per statistic, kernels prefixed
    ``bfs``/``sssp`` as in the v3 reference."""
    lines = [
        f"SCALE: {scale}",
        f"edgefactor: {edgefactor}",
        f"NBFS: {nbfs}",
        f"graph_generation: {gen_s:.6g}",
        "num_mpi_processes: 1",
        f"construction_time: {con_s:.6g}",
    ]
    for kernel, stats in blocks.items():
        lines.append(f"{kernel} validation: PASSED")
        for key in sorted(stats, key=_STAT_ORDER.index):
            lines.append(f"{kernel}  {key}: {stats[key]:.6g}")
    return "\n".join(lines) + "\n"


def sample_roots(graph, nbfs: int, seed: int) -> np.ndarray:
    """NBFS distinct search keys with degree >= 1 (the spec's key
    sampling); deterministic in ``seed``."""
    deg = np.zeros(graph.num_vertices, dtype=np.int64)
    np.add.at(deg, graph.src, 1)
    candidates = np.flatnonzero(deg > 0)
    if candidates.size == 0:
        raise ValueError("graph has no edges to traverse")
    rng = np.random.default_rng(seed)
    take = min(nbfs, candidates.size)
    return rng.choice(candidates, size=take, replace=False).astype(np.int64)


def traversed_edges(graph, dist: np.ndarray) -> int:
    """Undirected edge count of the traversed component: directed edges
    whose source is reached, halved (the bi-directed store counts each
    input edge twice) — the spec's traversed-edge convention."""
    from ..graph.csr import INF_DIST

    reached = np.asarray(dist) != INF_DIST
    return max(int(reached[graph.src].sum()) // 2, 1)


def run_scale(scale: int, *, edgefactor: int, nbfs: int, seed: int, max_weight: int,
              device=None, jr=None) -> dict:
    """Generate, construct, run BFS and SSSP over the sampled roots and
    return the result document, or the document ``jr`` (a RunJournal)
    already holds for this scale.  The device checks run on every root,
    the host oracles on the first; a failed check exits non-zero."""
    phase = f"scale:{scale}"
    if jr is not None:
        done = jr.get(phase)
        if done is not None:
            print(f"[graph500] scale {scale}: journal hit, skipping re-run", file=sys.stderr)
            return done
    with span("graph500.scale", scale=scale):
        doc = _run_scale(scale, edgefactor=edgefactor, nbfs=nbfs, seed=seed,
                         max_weight=max_weight, device=device)
    if jr is not None:
        jr.put(phase, doc)
    return doc


def _run_scale(scale: int, *, edgefactor: int, nbfs: int, seed: int, max_weight: int,
               device) -> dict:
    from ..algo import edge_weights_np, sssp
    from ..graph.csr import Graph, build_device_graph
    from ..graph.generators import rmat_edges
    from ..models.bfs import bfs, resolve_device
    from ..oracle import DeviceChecker, canonical_bfs, dijkstra, sssp_device_check

    dev = resolve_device(device)
    t0 = time.perf_counter()
    with span("graph500.generate", scale=scale):
        edges = rmat_edges(scale, edgefactor, seed=seed)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with span("graph500.construct", scale=scale):
        graph = Graph.from_undirected_edges(1 << scale, edges.astype(np.int32))
        dg = build_device_graph(graph)
    con_s = time.perf_counter() - t0
    roots = sample_roots(graph, nbfs, seed)
    weights = edge_weights_np(graph.src, graph.dst, max_weight)
    checker = DeviceChecker.from_graph(dg, device=dev)

    bfs_times, bfs_nedges = [], []
    sssp_times, sssp_nedges = [], []
    for i, root in enumerate(roots.tolist()):
        t0 = time.perf_counter()
        bres = bfs(graph, root, engine="push", device=dev)
        bfs_times.append(time.perf_counter() - t0)
        bfs_nedges.append(traversed_edges(graph, bres.dist))
        t0 = time.perf_counter()
        sres = sssp(graph, root, max_weight=max_weight, device=dev)
        sssp_times.append(time.perf_counter() - t0)
        sssp_nedges.append(traversed_edges(graph, sres.dist))
        # Validation: the device checks on every root, the host oracles on
        # the first (the expensive exact gate once per scale).
        viol = checker.check(bres.dist, bres.parent, root)
        if viol:
            raise SystemExit(f"BFS device check failed at root {root}: {viol}")
        viol = sssp_device_check(checker.src, checker.dst, sres.dist, sres.parent,
                                 root, graph.num_vertices, max_weight)
        if viol:
            raise SystemExit(f"SSSP device check failed at root {root}: {viol}")
        if i == 0:
            odist, _ = canonical_bfs(graph, root)
            if not np.array_equal(bres.dist, odist):
                raise SystemExit(f"BFS oracle mismatch at root {root}")
            odist, opar = dijkstra(graph, weights, root)
            if not (np.array_equal(sres.dist, odist) and np.array_equal(sres.parent, opar)):
                raise SystemExit(f"SSSP oracle mismatch at root {root}")

    return {
        "scale": scale,
        "edgefactor": edgefactor,
        "nbfs": len(roots),
        "graph_generation": gen_s,
        "construction_time": con_s,
        "roots": [int(r) for r in roots],
        "max_weight": max_weight,
        "bfs": kernel_stats(np.array(bfs_times), np.array(bfs_nedges)),
        "sssp": kernel_stats(np.array(sssp_times), np.array(sssp_nedges)),
    }


def capture_lines(doc: dict) -> list[dict]:
    """Bench-ledger JSONL lines for one scale's result document."""
    s = doc["scale"]
    out = []
    for kernel in ("bfs", "sssp"):
        stats = doc[kernel]
        out.append({
            "metric": f"graph500_s{s}_{kernel}_harmonic_TEPS",
            "value": stats["harmonic_mean_TEPS"],
            "unit": "TEPS",
            "vs_baseline": None,
            "details": {
                "scale": s,
                "edgefactor": doc["edgefactor"],
                "nbfs": doc["nbfs"],
                "kernel": kernel,
                "max_weight": doc["max_weight"],
                "harmonic_stddev_TEPS": stats["harmonic_stddev_TEPS"],
                "median_time": stats["median_time"],
                "median_nedge": stats["median_nedge"],
                "construction_time": doc["construction_time"],
                "validation": "PASSED",
            },
        })
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scales", default="8,10",
                    help="comma-separated R-MAT scales (default 8,10)")
    ap.add_argument("--edgefactor", type=int, default=16)
    ap.add_argument("--roots", type=int, default=8,
                    help="NBFS search keys per scale (default 8)")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--max-weight", type=int, default=255,
                    help="SSSP hash-weight range [1, max-weight]")
    ap.add_argument("--out", default=None,
                    help="also write the official output blocks here")
    ap.add_argument("--capture", default=None,
                    help="append bench-ledger JSONL metric lines here")
    ap.add_argument("--no-journal", action="store_true",
                    help="skip the run journal (fresh run, no resume)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)

    from .. import knobs
    from ..models.bfs import resolve_device
    from ..obs.spans import journal_spans

    scales = [int(s) for s in str(args.scales).split(",") if s.strip()]
    device = resolve_device(args.device)
    jr = None
    if not args.no_journal and knobs.get("BFS_TPU_TORCH_JOURNAL"):
        from ..config import journal_dir
        from ..resilience.journal import RunJournal, env_config

        # The package and the device key the journal too: a document
        # measured elsewhere is never printed as this run's.
        cfg = {
            "tool": "graph500_run", "package": "bfs_tpu_torch", "device": device.type,
            "scales": scales, "edgefactor": args.edgefactor, "roots": args.roots,
            "seed": args.seed, "max_weight": args.max_weight, "env": env_config(),
        }
        jr = RunJournal.open_for(journal_dir(), cfg)
    blocks_text = []
    lines = []
    for scale in scales:
        hit = jr is not None and jr.get(f"scale:{scale}") is not None
        doc = run_scale(
            scale, edgefactor=args.edgefactor, nbfs=args.roots,
            seed=args.seed, max_weight=args.max_weight, device=device, jr=jr,
        )
        if not hit:  # the spans of the scale just run, kept if the run dies later
            journal_spans(jr)
        text = format_output(
            doc["scale"], doc["edgefactor"], doc["nbfs"],
            doc["graph_generation"], doc["construction_time"],
            {"bfs": doc["bfs"], "sssp": doc["sssp"]},
        )
        blocks_text.append(text)
        lines.extend(capture_lines(doc))
        sys.stdout.write(text)
        sys.stdout.flush()
    if jr is not None:
        jr.close()
    if args.out:
        with open(args.out, "w") as fh:
            fh.write("\n".join(blocks_text))
    if args.capture:
        with open(args.capture, "a") as fh:
            for line in lines:
                fh.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
