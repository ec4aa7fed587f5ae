"""Serving entry point: a long-lived BFS query server on the card.  The port of
``bfs_tpu.runners.run_serve``.

Builds or reads a graph ONCE, keeps its layouts and engines resident in a
:class:`~bfs_tpu_torch.serve.BfsServer`, and answers a stream of queries:

  * **demo** (default) — submit ``--queries`` random single- and
    multi-source queries through the micro-batcher and print the serve
    report (p50/p99, batch sizes, cache hit rates); ``--check`` holds every
    reply against the oracle (``queue_bfs`` distances, ``check()``) and
    exits 1 on any wrong one;
  * **--repl** — read queries from stdin, one per line (``3`` for
    single-source 3; ``3,17,42`` for collapsed multi-source), answer with
    reachable-vertex count, eccentricity and superstep count.

It runs on the card unless ``--device cpu`` is given.

Usage:
    python -m bfs_tpu_torch.runners.run_serve [--rmat SCALE | --gnm V E |
        --graph FILE] [--engine pull|push|relay] [--max-batch B]
        [--tick-ms T] [--queries N] [--repl] [--check] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np

from ..graph.csr import INF_DIST
from ..utils.logging import get_logger

logger = get_logger(__name__)


def build_graph(args):
    if args.graph:
        from ..graph.io import read_sedgewick

        return read_sedgewick(args.graph), args.graph
    if args.gnm:
        from ..graph.generators import gnm_graph

        v, e = args.gnm
        return gnm_graph(v, e, seed=args.seed), f"gnm_{v}_{e}"
    from ..graph.generators import rmat_graph

    return (rmat_graph(args.rmat, args.edge_factor, seed=args.seed),
            f"rmat_s{args.rmat}_ef{args.edge_factor}")


def make_server(args, metrics=None):
    from ..serve import DEFAULT_RETRY_POLICY, BfsServer, GraphRegistry

    registry = GraphRegistry(
        device_budget_bytes=args.budget_mb * (1 << 20) if args.budget_mb else None,
        metrics=metrics,
        # Persistent layout bundles ("" disables).
        layout_cache=args.cache_dir or None,
        device=args.device,
    )
    return BfsServer(
        registry,
        engine=args.engine,
        max_batch=args.max_batch,
        tick_s=args.tick_ms / 1e3,
        queue_depth=args.queue_depth,
        oracle_max_vertices=args.oracle_max_vertices,
        metrics=metrics,
        # Only the attempt count is tunable here; the delays stay short
        # (backoff sleeps block the one scheduler thread).
        retry_policy=dataclasses.replace(DEFAULT_RETRY_POLICY,
                                         max_attempts=max(1, args.retries)),
        breaker_failures=args.breaker_failures,
        breaker_cooldown_s=args.breaker_cooldown_s,
        watchdog_s=args.watchdog_s,
        verify_sample=args.verify_sample,
    )


def _describe(reply) -> str:
    dist = reply.dist if reply.dist.ndim == 1 else reply.dist.min(axis=0)
    reached = int((dist != INF_DIST).sum())
    ecc = int(dist[dist != INF_DIST].max(initial=0))
    return (
        f"sources={reply.sources.tolist()} reached={reached} "
        f"eccentricity={ecc} supersteps={reply.num_levels} "
        f"status={reply.record.status} batch={reply.record.batch_size} "
        f"latency={reply.record.total_s * 1e3:.1f}ms"
    )


def repl(server, name: str, num_vertices: int) -> None:
    print(f"serving {name!r} (V={num_vertices}); enter a source id or a "
          "comma-separated source list, Ctrl-D to quit", flush=True)
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            sources = [int(tok) for tok in line.replace(",", " ").split()]
            fut = (server.query(name, sources[0]) if len(sources) == 1
                   else server.query_multi(name, sources))
            print(_describe(fut.result(timeout=600)), flush=True)
        except Exception as exc:
            print(f"error: {exc}", file=sys.stderr, flush=True)


def demo(server, name: str, graph, args) -> dict:
    rng = np.random.default_rng(args.seed)
    v = graph.num_vertices
    futures = []
    for _ in range(args.queries):
        if rng.random() < args.multi_frac:
            width = int(rng.integers(2, max(args.multi_width, 3)))
            srcs = rng.integers(0, v, size=width).tolist()
            futures.append((server.query_multi(name, srcs), srcs))
        else:
            s = int(rng.integers(0, v))
            futures.append((server.query(name, s), [s]))
    checked = wrong = 0
    for fut, srcs in futures:
        reply = fut.result(timeout=600)
        if args.check:
            from ..oracle.bfs import check, queue_bfs

            # Single and collapsed replies are both 1-D multi-source trees.
            od, _ = queue_bfs(graph, srcs)
            ok = np.array_equal(reply.dist, od) and check(graph, reply.dist, reply.parent,
                                                          srcs) == []
            checked += 1
            wrong += 0 if ok else 1
    report = server.report()
    report["checked"] = checked
    report["wrong"] = wrong
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--graph", help="Sedgewick-format problem file")
    src.add_argument("--rmat", type=int, default=10, help="R-MAT scale")
    src.add_argument("--gnm", type=int, nargs=2, metavar=("V", "E"))
    ap.add_argument("--edge-factor", type=int, default=8)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--engine", default="pull", choices=("pull", "push", "relay"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain path)")
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--tick-ms", type=float, default=2.0)
    ap.add_argument("--queue-depth", type=int, default=1024)
    ap.add_argument("--budget-mb", type=int, default=0,
                    help="device budget of resident engines in MiB (0 = unlimited)")
    ap.add_argument("--oracle-max-vertices", type=int, default=0,
                    help="serve graphs at/under this size sequentially")
    ap.add_argument("--retries", type=int, default=3,
                    help="max device-path attempts per batch before oracle "
                    "degradation (transient failures only; 1 = no retry)")
    ap.add_argument("--breaker-failures", type=int, default=3,
                    help="consecutive permanent failures per executable before "
                    "its circuit opens and ticks short-circuit to the oracle")
    ap.add_argument("--breaker-cooldown-s", type=float, default=5.0,
                    help="seconds an open circuit waits before admitting the "
                    "half-open canary batch")
    ap.add_argument("--watchdog-s", type=float, default=60.0,
                    help="hung-call watchdog default budget in seconds "
                    "(p99-informed per executable once history exists; 0 disables)")
    ap.add_argument("--verify-sample", type=int, default=0,
                    help="re-verify one answered root on the device every Kth "
                    "executed tick (a failed verdict quarantines the "
                    "executable; 0 disables)")
    ap.add_argument("--queries", type=int, default=64, help="demo query count")
    ap.add_argument("--multi-frac", type=float, default=0.25)
    ap.add_argument("--multi-width", type=int, default=4)
    ap.add_argument("--check", action="store_true",
                    help="oracle-check every demo reply; exit 1 on a wrong one")
    ap.add_argument("--repl", action="store_true", help="interactive mode")
    from ..config import layout_cache_dir

    ap.add_argument("--cache-dir", default=layout_cache_dir(),
                    help="persistent layout-bundle dir ('' disables)")
    args = ap.parse_args(argv)

    graph, name = build_graph(args)
    logger.info("Registering %s: V=%d, E=%d (directed), engine=%s",
                name, graph.num_vertices, graph.num_edges, args.engine)
    with make_server(args) as server:
        t0 = time.perf_counter()
        server.register(name, graph)
        server.query(name, 0).result(timeout=600)  # warm layout + first bucket
        li = server.registry.layout_info()
        if li:  # only relay builds a relay layout
            logger.info("Graph registered and warm in %.2f s on %s (layout %s, "
                        "builder=%s, build %.2f s)", time.perf_counter() - t0,
                        server.device, li.get("cache", "memo"), li.get("builder", "host"),
                        float(li.get("build_seconds", -1.0)))
        else:
            logger.info("Graph registered and warm in %.2f s on %s",
                        time.perf_counter() - t0, server.device)
        if args.repl:
            repl(server, name, graph.num_vertices)
            report = server.report()
        else:
            report = demo(server, name, graph, args)
        print(json.dumps(report, indent=2, sort_keys=True, default=str))
    return 1 if report.get("wrong") else 0


if __name__ == "__main__":
    raise SystemExit(main())
