"""Load generator for the query server: the port of the reference's
``tools/serve_loadgen.py``, in both of its modes.

**Classic mode.** Concurrent submitter threads replay a mix of
single-source queries and collapsed and per-tree multi-source queries,
drawn from a limited source pool so that repeats reach the result cache as
hot keys do, against one in-process :class:`~bfs_tpu_torch.serve.BfsServer`.
:func:`warmup` first runs one tick of exactly b singles for every
power-of-two bucket b up to ``max_batch`` (the server paused while they
are staged), so the steady run must hit the executable cache on every
tick.

**Fleet mode** (``--replicas N``). A :class:`~bfs_tpu_torch.serve.FleetRouter`
of N replicas takes a point-query-heavy mix through the landmark label
tier (``query_dist``), a rolling re-register after ``--swap-at`` of the
requests, and with N >= 2 one replica closed and ``--chaos-frac`` more
requests that must fail over.

Every reply is checked (:func:`oracle_check`): single and per-tree replies
bit for bit against the reference trees (``canonical_bfs`` on the host, or
rows the caller supplies), a collapsed reply's distances against the
trees' elementwise minimum and its parents through ``check()``.  The
report gives queries/s, p50/p99, the steady executable-cache hit rate and
the metrics registry's ``to_json``.  The tool exits 1 on a wrong or lost
answer, a steady hit rate under 1.0, any ``integrity_failures``, or no
failover after an induced failure.  It runs on the card unless
``--device cpu`` is given.

The parts are separate so that a caller holding a graph, a server or a
router and reference rows already can drive them: :func:`make_queries`,
:func:`warmup`, :func:`oracle_check`, :func:`run_classic`,
:func:`fleet_mix`, :func:`run_fleet` and :func:`failures`.

Usage::

    python -m bfs_tpu_torch.tools.serve_loadgen --scale 10 --requests 200 \\
        --concurrency 8 [--device cpu]
    python -m bfs_tpu_torch.tools.serve_loadgen --scale 10 --replicas 2 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np

from ..utils.metrics import percentile


class Truth:
    """Reference trees by source: ``truth(s)`` is ``(dist, parent)``, from
    ``rows`` (source -> trees the caller holds) or else ``canonical_bfs``
    of ``graph`` on the host, computed once a source."""

    def __init__(self, graph=None, rows: dict | None = None):
        self.graph = graph
        self._rows = dict(rows or {})  # guarded-by: _lock
        self._lock = threading.Lock()

    def __call__(self, s: int):
        s = int(s)
        with self._lock:
            row = self._rows.get(s)
        if row is None:
            from ..oracle.bfs import canonical_bfs

            row = canonical_bfs(self.graph, s)
            with self._lock:
                self._rows[s] = row
        return row


def host_check(graph):
    """``check()`` of ``graph`` as :func:`oracle_check` takes it."""
    from ..oracle.bfs import check

    return lambda dist, parent, sources: check(graph, dist, parent, sources)


def make_queries(rng, pool, n: int, *, multi_frac: float = 0.25,
                 multi_width: int = 4) -> list:
    """The classic mix: ``(sources, mode)`` of singles, collapsed multis and
    per-tree multis (half each) of 2 to ``multi_width`` sources from
    ``pool``."""
    pool = np.asarray(pool)
    queries = []
    for _ in range(n):
        if rng.random() < multi_frac:
            width = int(rng.integers(2, multi_width + 1))
            srcs = [int(s) for s in rng.choice(pool, size=width)]
            queries.append((srcs, "collapse" if rng.random() < 0.5 else "tree"))
        else:
            queries.append(([int(rng.choice(pool))], "single"))
    return queries


def oracle_check(truth, check, srcs, mode: str, reply) -> list[str]:
    """The violations of one reply (empty: it is right).  ``truth(s)`` gives
    a source's reference ``(dist, parent)``; ``check(dist, parent,
    sources)`` returns the violations of a multi-source tree."""
    if mode == "collapse":
        want = np.min(np.stack([truth(s)[0] for s in srcs]), axis=0)
        errs = [] if np.array_equal(reply.dist, want) else [f"dist mismatch for sources {srcs}"]
        bad = check(reply.dist, reply.parent, srcs)
        return errs + ([f"check() for sources {srcs}: {bad}"] if bad else [])
    dist, parent = reply.dist, reply.parent
    if mode == "single":
        dist, parent = dist[None], parent[None]
    errs = []
    for i, s in enumerate(srcs):
        want_d, want_p = truth(s)
        if not (np.array_equal(dist[i], want_d) and np.array_equal(parent[i], want_p)):
            errs.append(f"{mode} reply for source {s} differs from its reference tree")
    return errs


def warmup(server, name: str, v: int, max_batch: int) -> int:
    """One tick of exactly b singles for every power-of-two bucket b up to
    ``max_batch`` (staged while the server is paused); returns the
    queries sent."""
    total = 0
    b = 1
    while True:
        stage = min(b, max_batch)  # a full tick covers the top bucket
        server.pause()
        # Sources distinct across rounds: a repeat would hit the result
        # cache, never reach the device and leave its bucket cold.
        futs = [server.query(name, (total + s) % v) for s in range(stage)]
        server.resume()
        for f in futs:
            f.result(timeout=600)
        total += stage
        if b >= max_batch:
            return total
        b *= 2


def _drive(n: int, concurrency: int, one, wrong: list, lock) -> float:
    """Requests 0..n-1 through ``one(i)`` from ``concurrency`` threads;
    an exception is a lost answer.  Returns the wall seconds."""
    cursor = [0]

    def worker():
        while True:
            with lock:
                if cursor[0] >= n:
                    return
                i = cursor[0]
                cursor[0] += 1
            try:
                one(i)
            except Exception as exc:  # an unanswered query fails the run
                with lock:
                    wrong.append(f"request {i} failed: {exc!r}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker) for _ in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return time.perf_counter() - t0


def run_classic(server, name: str, queries: list, *, truth, check, concurrency: int = 8,
                timeout_s: float = 120.0, verify: bool = True) -> dict:
    """The steady run of ``queries`` against a warm ``server``: each reply
    checked (unless ``verify`` is off), the executable-cache hits and
    misses, the ticks it ran and the integrity failures counted over this
    run alone."""
    from ..serve import AdmissionError

    wrong: list[str] = []
    latencies: list[float] = []
    check_s = [0.0]
    lock = threading.Lock()
    pre = dict(server.metrics.report()["counters"])
    ticks0 = len(server.tick_log())

    def one(i: int) -> None:
        srcs, mode = queries[i]
        t = time.perf_counter()
        while True:
            try:
                fut = server.submit(name, srcs, mode=mode, timeout_s=timeout_s)
                break
            except AdmissionError:
                time.sleep(0.005)  # backpressure: try again
        reply = fut.result(timeout=timeout_s + 60)
        lat = time.perf_counter() - t
        errs = oracle_check(truth, check, srcs, mode, reply) if verify else []
        with lock:
            latencies.append(lat)
            wrong.extend(errs)
            check_s[0] += time.perf_counter() - t - lat

    steady_s = _drive(len(queries), concurrency, one, wrong, lock)
    report = server.report()
    post = report["counters"]
    ticks = server.tick_log()[ticks0:]
    delta = {k: post.get(k, 0) - pre.get(k, 0)
             for k in ("compile_hits", "compile_misses", "integrity_failures")}
    seen = delta["compile_hits"] + delta["compile_misses"]
    return {
        "mode": "classic",
        "requests": len(queries),
        "concurrency": concurrency,
        "oracle_checked": len(queries) if verify else 0,
        "wrong_answers": len(wrong),
        "wrong": wrong[:10],
        "steady_seconds": steady_s,
        "queries_per_sec": len(queries) / steady_s if steady_s > 0 else 0.0,
        "latency_p50_ms": percentile(latencies, 50) * 1e3,
        "latency_p99_ms": percentile(latencies, 99) * 1e3,
        "steady_compile_hit_rate": delta["compile_hits"] / seen if seen else 1.0,
        "integrity_failures": delta["integrity_failures"],
        "check_seconds": check_s[0],
        "ticks": ticks,
        "ticks_by_bucket": _by_bucket(ticks),
        "server_report": report,
    }


def _by_bucket(ticks: list) -> dict:
    """Per engine and bucket: the ticks and their summed service seconds
    (the batch on the card and its rows copied out) and fan-out seconds
    (each request's reply made and cached)."""
    out: dict[str, dict] = {}
    for t in ticks:
        row = out.setdefault(f"{t['engine']} {t['bucket']}",
                             {"ticks": 0, "service_s": 0.0, "fanout_s": 0.0})
        row["ticks"] += 1
        row["service_s"] += t["service_s"]
        row["fanout_s"] += t["fanout_s"]
    return dict(sorted(out.items()))


def fleet_mix(rng, pool, n: int, *, point_frac: float = 0.6,
              num_vertices: int | None = None) -> list:
    """The fleet mix: ``("point", u, v)`` with a fraction ``point_frac``,
    else ``("full", s, -1)``; sources from ``pool``, point targets from
    ``pool`` too or, given ``num_vertices``, from every vertex."""
    pool = np.asarray(pool)
    mix = []
    for _ in range(n):
        if rng.random() < point_frac:
            b = rng.integers(0, num_vertices) if num_vertices else rng.choice(pool)
            mix.append(("point", int(rng.choice(pool)), int(b)))
        else:
            mix.append(("full", int(rng.choice(pool)), -1))
    return mix


def run_fleet(rt, name: str, graph, mix: list, *, truth, concurrency: int = 8,
              swap_at: int = -1, chaos_mix: list = (), timeout_s: float = 120.0,
              verify: bool = True) -> dict:
    """``mix`` through a registered router ``rt``: request ``swap_at``
    first re-registers ``graph`` on every replica (a rolling epoch swap
    under load); then, with ``chaos_mix``, the last replica is closed and
    ``chaos_mix`` sent through the failover path (untimed for
    queries/s).  Every answer is checked against ``truth``."""
    wrong: list[str] = []
    lock = threading.Lock()
    events = {"swapped_s": None}

    def one(batch: list, sink: list, with_swap: bool, i: int) -> None:
        if with_swap and i == swap_at:
            t = time.perf_counter()
            rt.register(name, graph)
            events["swapped_s"] = time.perf_counter() - t
        kind, a, b = batch[i]
        t = time.perf_counter()
        if kind == "point":
            reply = rt.query_dist(name, a, b).result(timeout=timeout_s + 60)
            lat = time.perf_counter() - t
            want = int(truth(a)[0][b])
            errs = [] if not verify or int(reply.dist) == want else [
                f"dist({a},{b}) = {reply.dist} ({reply.method}), reference {want}"]
        else:
            reply = rt.query(name, a).result(timeout=timeout_s + 60)
            lat = time.perf_counter() - t
            errs = oracle_check(truth, None, [a], "single", reply) if verify else []
        with lock:
            sink.append(lat)
            wrong.extend(errs)

    latencies: list[float] = []
    steady_s = _drive(len(mix), concurrency, lambda i: one(mix, latencies, True, i), wrong, lock)
    chaos_lat: list[float] = []
    chaos_s = None
    if chaos_mix:
        # The server closed directly (not kill_replica): a submit there now
        # raises at admission, which is the failover path to show.
        rt.servers[-1].close()
        chaos_s = _drive(len(chaos_mix), concurrency,
                         lambda i: one(chaos_mix, chaos_lat, False, i), wrong, lock)
    report = rt.report()
    router = report["router"]
    label_counters = {
        k: sum(rep["counters"].get(k, 0) for rep in report["replicas"])
        for k in ("label_hits", "label_fallbacks", "label_misses", "label_builds",
                  "label_build_cache_hits")
    }
    return {
        "mode": "fleet",
        "replicas": rt.num_replicas,
        "requests": len(mix),
        "concurrency": concurrency,
        "oracle_checked": len(mix) + len(chaos_mix) if verify else 0,
        "wrong_answers": len(wrong),
        "wrong": wrong[:10],
        "steady_seconds": steady_s,
        "queries_per_sec": len(mix) / steady_s if steady_s > 0 else 0.0,
        "latency_p50_ms": percentile(latencies, 50) * 1e3,
        "latency_p99_ms": percentile(latencies, 99) * 1e3,
        "epoch_swap_seconds": events["swapped_s"],
        "chaos_requests": len(chaos_mix),
        "chaos_seconds": chaos_s,
        "chaos_latency_p99_ms": percentile(chaos_lat, 99) * 1e3 if chaos_lat else None,
        "router_failovers": router.get("router_failovers", 0),
        "router_breaker_opens": router.get("router_breaker_opens", 0),
        "router_rolling_registers": router.get("router_rolling_registers", 0),
        "labels": label_counters,
        "integrity_failures": sum(rep["counters"].get("integrity_failures", 0)
                                  for rep in report["replicas"]),
        "ticks": [t for srv in rt.servers for t in srv.tick_log()],
        "router_report": router,
    }


def failures(out: dict) -> list[str]:
    """Why a run fails (empty: it passed): a wrong or lost answer, a steady
    hit rate under 1.0, an integrity failure, or no failover after an
    induced failure."""
    why = [f"WRONG: {msg}" for msg in out["wrong"]]
    if out["wrong_answers"] > len(out["wrong"]):
        why.append(f"WRONG: {out['wrong_answers'] - len(out['wrong'])} more")
    if out.get("steady_compile_hit_rate", 1.0) < 1.0:
        why.append(f"FAIL: steady executable-cache hit rate "
                   f"{out['steady_compile_hit_rate']:.3f} < 1.0")
    if out["integrity_failures"]:
        why.append(f"FAIL: {out['integrity_failures']} sampled integrity failure(s)")
    if out.get("chaos_requests") and not out["router_failovers"]:
        why.append("FAIL: the induced replica failure produced no router failover")
    return why


def _report(out: dict) -> None:
    """The run's JSON report on stdout, with the metrics registry's."""
    from ..obs.registry import get_registry

    from ..analysis.runtime import format_retrace_report

    warm = out.get("retrace_warm")
    out = {k: v for k, v in out.items() if k not in ("wrong", "ticks", "retrace_warm")}
    out["metrics_registry"] = json.loads(get_registry().to_json(retrace_baseline=warm))
    print(json.dumps(out, indent=2, sort_keys=True, default=str))
    print(format_retrace_report(warm), file=sys.stderr, flush=True)


def _graph(args):
    from ..graph.generators import rmat_graph

    t0 = time.perf_counter()
    graph = rmat_graph(args.scale, args.edge_factor, seed=args.seed)
    print(f"graph: R-MAT scale {args.scale} ef {args.edge_factor} (V={graph.num_vertices}, "
          f"E={graph.num_edges} directed) built in {time.perf_counter() - t0:.1f}s",
          file=sys.stderr, flush=True)
    return graph


def classic_main(args) -> dict:
    from ..analysis.runtime import retrace_report
    from ..serve import BfsServer, GraphRegistry

    rng = np.random.default_rng(args.seed)
    graph = _graph(args)
    v = graph.num_vertices
    name = f"rmat{args.scale}"
    registry = GraphRegistry(
        device_budget_bytes=args.budget_mb * (1 << 20) if args.budget_mb else None,
        layout_cache=args.cache_dir or None, device=args.device)
    with BfsServer(registry, engine=args.engine, max_batch=args.max_batch,
                   tick_s=args.tick_ms / 1e3, queue_depth=args.queue_depth,
                   breaker_failures=args.breaker_failures,
                   breaker_cooldown_s=args.breaker_cooldown_s, watchdog_s=args.watchdog_s,
                   verify_sample=args.verify_sample) as server:
        t0 = time.perf_counter()
        server.register(name, graph)
        server.query(name, 0).result(timeout=600)  # the layout and first bucket
        print(f"register+layout: {time.perf_counter() - t0:.2f}s", file=sys.stderr, flush=True)
        t0 = time.perf_counter()
        nwarm = warmup(server, name, v, args.max_batch)
        print(f"warmup: {nwarm} queries, {server.report()['executables_cached']} batch shapes "
              f"in {time.perf_counter() - t0:.1f}s", file=sys.stderr, flush=True)
        # The steady phase's baseline: a capture or build after it drifts.
        retrace_warm = retrace_report()
        pool = rng.integers(0, v, size=max(args.source_pool, 4))
        queries = make_queries(rng, pool, args.requests, multi_frac=args.multi_frac,
                               multi_width=args.multi_width)
        out = run_classic(server, name, queries, truth=Truth(graph), check=host_check(graph),
                          concurrency=args.concurrency, timeout_s=args.timeout_s,
                          verify=not args.no_check)
        out["retrace_warm"] = retrace_warm
        return out


def fleet_main(args) -> dict:
    from ..serve import FleetRouter

    rng = np.random.default_rng(args.seed)
    graph = _graph(args)
    v = graph.num_vertices
    name = f"rmat{args.scale}"
    pool = rng.integers(0, v, size=max(args.source_pool, 4))
    mix = fleet_mix(rng, pool, args.requests, point_frac=args.point_frac)
    chaos_n = int(args.requests * args.chaos_frac) if args.replicas >= 2 else 0
    chaos = fleet_mix(rng, pool, chaos_n, point_frac=args.point_frac)
    prior = os.environ.get("BFS_TPU_TORCH_LABELS")  # bfs_tpu_torch: ok KNB001 saved to restore it below
    if args.landmarks > 0:
        os.environ["BFS_TPU_TORCH_LABELS"] = str(args.landmarks)
    try:
        with FleetRouter(replicas=args.replicas, layout_cache=args.cache_dir or None,
                         engine=args.engine, max_batch=args.max_batch,
                         tick_s=args.tick_ms / 1e3, queue_depth=args.queue_depth,
                         watchdog_s=args.watchdog_s, device=args.device) as rt:
            t0 = time.perf_counter()
            rt.register(name, graph)
            # Every replica warmed directly (the router would warm only the
            # one a name hashes to): the buckets and the label lookup.
            for srv in rt.servers:
                warmup(srv, name, v, args.max_batch)
                srv.query_dist(name, 0, min(1, v - 1)).result(timeout=600)
            print(f"fleet: {args.replicas} replicas registered and warm in "
                  f"{time.perf_counter() - t0:.2f}s (labels K={args.landmarks})",
                  file=sys.stderr, flush=True)
            swap_at = int(args.requests * args.swap_at) if args.swap_at >= 0 else -1
            return run_fleet(rt, name, graph, mix, truth=Truth(graph),
                             concurrency=args.concurrency, swap_at=swap_at, chaos_mix=chaos,
                             timeout_s=args.timeout_s, verify=not args.no_check)
    finally:
        if prior is None:
            os.environ.pop("BFS_TPU_TORCH_LABELS", None)
        else:
            os.environ["BFS_TPU_TORCH_LABELS"] = prior


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=10, help="R-MAT scale")
    ap.add_argument("--edge-factor", type=int, default=8)
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument("--multi-frac", type=float, default=0.25)
    ap.add_argument("--multi-width", type=int, default=4)
    ap.add_argument("--source-pool", type=int, default=64,
                    help="distinct sources in the mix (repeats hit the result cache)")
    ap.add_argument("--engine", default="pull", choices=("pull", "push", "relay"))
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--tick-ms", type=float, default=2.0)
    ap.add_argument("--timeout-s", type=float, default=120.0)
    ap.add_argument("--queue-depth", type=int, default=4096)
    ap.add_argument("--budget-mb", type=int, default=0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain path)")
    ap.add_argument("--breaker-failures", type=int, default=3,
                    help="consecutive permanent failures of an executable before its "
                    "circuit opens")
    ap.add_argument("--breaker-cooldown-s", type=float, default=5.0,
                    help="open-circuit cooldown before the half-open canary")
    ap.add_argument("--watchdog-s", type=float, default=60.0,
                    help="hung-call watchdog default budget (0 disables)")
    ap.add_argument("--verify-sample", type=int, default=0,
                    help="on-device integrity check every Kth tick (0 disables); the run "
                    "fails on any integrity_failures")
    ap.add_argument("--cache-dir", default="",
                    help="persistent layout-bundle dir (default off)")
    ap.add_argument("--replicas", type=int, default=0,
                    help="fleet mode: a FleetRouter of N replicas (0 = classic mode)")
    ap.add_argument("--point-frac", type=float, default=0.6,
                    help="fleet mode: the share of dist(u, v) point queries")
    ap.add_argument("--landmarks", type=int, default=16,
                    help="fleet mode: landmarks of the label tier (sets "
                    "BFS_TPU_TORCH_LABELS; 0 = exact only)")
    ap.add_argument("--swap-at", type=float, default=0.5,
                    help="fleet mode: re-register the graph after this share of the "
                    "requests (< 0 disables)")
    ap.add_argument("--chaos-frac", type=float, default=0.2,
                    help="fleet mode, >= 2 replicas: close one replica and send this "
                    "share more of requests through the failover path (0 disables)")
    args = ap.parse_args(argv)

    out = fleet_main(args) if args.replicas >= 1 else classic_main(args)
    _report(out)
    why = failures(out)
    for msg in why:
        print(msg, file=sys.stderr)
    return 1 if why else 0


if __name__ == "__main__":
    raise SystemExit(main())
