"""Pre-build the port's persistent artifacts so a later run is warm from its
first second: the port of the reference's ``tools/cache_warm.py``.

For every scale (R-MAT from the native generator, ``graph/native_gen.py``)
it builds or loads, in order:

  1. the relay layout bundle (content-addressed, memmap-loadable:
     :mod:`bfs_tpu_torch.cache.layout`) and, with ``--pull``, the ELL pull
     bundle;
  2. with ``--tiles``, the tiles sidecar bundle, then checks it with
     :func:`~bfs_tpu_torch.cache.layout.verify_tiles_bundle` and prints the
     streamed host store's shape (``HostTileStore(...).report()``);
  3. with ``--labels``, the landmark label bundle, checked with
     ``verify_labels_bundle``;
  4. with ``--compile`` (a card), the port's counterpart of the reference's
     executable cache: every kernel library built by nvcc
     (``utils/cuda_build.py``), and a default relay engine, whose arm
     probe is memoized under ``cache/layout.py::probe_verdict_key``.

Each step prints whether it was a hit or was built, and its seconds; the
last line is the artifact-cache counters (``artifact_report()``).  The
reference's graph npz cache comes with the port's bench.  ``--compare N``
times N interleaved uncached builds per builder instead of warming.

    python -m bfs_tpu_torch.tools.cache_warm --scales 22 --tiles --compile
    python -m bfs_tpu_torch.tools.cache_warm --scales 10 --device cpu --cache-dir /tmp/c
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time


def _compare_builders(graph, scale: int, reps: int, device) -> None:
    """``reps`` interleaved uncached builds per builder, their medians as a
    JSON line (the first of a pair runs a little slower, so the order
    alternates)."""
    from ..graph.relay import build_relay_graph
    from ..graph.relay_device import build_relay_graph_device

    build_relay_graph(graph)  # warm both paths once
    stages: dict = {}
    build_relay_graph_device(graph, device=device, stage_times=stages)
    host_s, dev_s, deltas = [], [], []
    for i in range(reps):
        pair = {}
        for builder in (("host", "device") if i % 2 == 0 else ("device", "host")):
            t0 = time.perf_counter()
            if builder == "host":
                build_relay_graph(graph)
            else:
                build_relay_graph_device(graph, device=device)
            pair[builder] = time.perf_counter() - t0
        host_s.append(pair["host"])
        dev_s.append(pair["device"])
        deltas.append(pair["host"] - pair["device"])
    print(json.dumps({
        "scale": scale, "reps": reps,
        "host_build_s": {"median": statistics.median(host_s), "min": min(host_s)},
        "device_build_s": {"median": statistics.median(dev_s), "min": min(dev_s)},
        "paired_delta_s_median": statistics.median(deltas),
        "device_wins": sum(1 for d in deltas if d > 0),
        "device_stage_seconds": {k: v for k, v in stages.items() if isinstance(v, (int, float))},
    }), flush=True)


def _status(info: dict) -> str:
    return "hit" if info.get("cache") == "hit" else "built"


def _compile(rg, scale: int, device, statuses: dict) -> None:
    """Every kernel library, then a default engine (its arm probe memoized)."""
    from ..models.bfs import RelayEngine
    from ..ops import relay_cuda as K
    from ..utils import cuda_build

    t0 = time.perf_counter()
    K.build_all()
    built = {n: cuda_build.BUILD_INFO[n]["seconds"] for n in K.SOURCES}
    statuses["kernels"] = "built" if any(s > 0 for s in built.values()) else "hit"
    print(f"s{scale}: kernel libraries ready in {time.perf_counter() - t0:.1f}s ("
          + ", ".join(f"{n} {'nvcc %.1fs' % s if s > 0 else 'reused'}" for n, s in built.items())
          + ")", flush=True)
    t0 = time.perf_counter()
    eng = RelayEngine(rg, device=device)
    probe = eng.phase_probe
    statuses["probe"] = "none" if probe is None else ("hit" if probe.get("memo") == "hit"
                                                      else "built")
    print(f"s{scale}: default engine in {time.perf_counter() - t0:.1f}s: expansion "
          f"{eng.expansion} ({eng.expansion_basis}); probe memo "
          f"{None if probe is None else probe.get('memo')}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scales", default="22", help="comma-separated R-MAT scales")
    ap.add_argument("--edge-factor", type=int, default=6)
    ap.add_argument("--seed", type=int, default=1, help="graph seed")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain path)")
    ap.add_argument("--cache-dir", default=None,
                    help="artifact cache root (sets BFS_TPU_TORCH_CACHE_DIR for this run)")
    ap.add_argument("--pull", action="store_true", help="also warm the ELL pull bundle")
    ap.add_argument("--tiles", action="store_true",
                    help="also build or load the tiles sidecar bundle, verify it and print "
                    "the streamed host store's shape")
    ap.add_argument("--labels", action="store_true",
                    help="also build or load the landmark label bundle and verify it")
    ap.add_argument("--landmarks", type=int, metavar="K", default=0,
                    help="landmarks for --labels (default: BFS_TPU_TORCH_LABELS, else 32)")
    ap.add_argument("--compile", action="store_true",
                    help="also build every kernel library and a default engine (its arm "
                    "probe memoized); a card only")
    ap.add_argument("--builder", choices=("auto", "device", "host"), default="auto",
                    help="relay layout builder of a cold build (default: "
                    "BFS_TPU_TORCH_LAYOUT_BUILD, i.e. device)")
    ap.add_argument("--compare", type=int, metavar="N", default=0,
                    help="instead of warming, time N interleaved uncached builds per builder")
    args = ap.parse_args(argv)

    if args.cache_dir:
        os.environ["BFS_TPU_TORCH_CACHE_DIR"] = os.path.abspath(args.cache_dir)
    from .. import knobs
    from ..cache.layout import (
        LayoutCache,
        load_or_build_labels,
        load_or_build_pull,
        load_or_build_relay,
        load_or_build_tiles,
        verify_labels_bundle,
        verify_tiles_bundle,
    )
    from ..graph.generators import rmat_graph_native
    from ..models.bfs import resolve_device
    from ..utils.metrics import artifact_report

    device = resolve_device(args.device)
    builder = None if args.builder == "auto" else args.builder
    scales = sorted({int(s) for s in args.scales.split(",") if s.strip()}, reverse=True)
    cache = LayoutCache()
    print(f"caches: {json.dumps({'layout': cache.root, 'device': str(device)})}", flush=True)
    rc = 0
    for scale in scales:
        t0 = time.perf_counter()
        graph = rmat_graph_native(scale, args.edge_factor, seed=args.seed)
        print(f"s{scale}: graph ready in {time.perf_counter() - t0:.1f}s "
              f"(V={graph.num_vertices} E={graph.num_edges})", flush=True)
        if args.compare:
            _compare_builders(graph, scale, args.compare, device)
            continue
        statuses: dict = {}
        t0 = time.perf_counter()
        rg, info = load_or_build_relay(graph, cache=cache, builder=builder, device=device)
        statuses["relay"] = _status(info)
        print(f"s{scale}: relay layout ready in {time.perf_counter() - t0:.1f}s "
              f"(cache={info['cache']}, cold build was {info.get('build_seconds', -1.0):.1f}s, "
              f"builder={info.get('builder')})", flush=True)
        if args.pull:
            t0 = time.perf_counter()
            _, pinfo = load_or_build_pull(graph, cache=cache)
            statuses["pull"] = _status(pinfo)
            print(f"s{scale}: pull layout ready in {time.perf_counter() - t0:.1f}s "
                  f"(cache={pinfo['cache']})", flush=True)
        if args.tiles:
            from ..stream.store import HostTileStore

            t0 = time.perf_counter()
            at, tinfo = load_or_build_tiles(rg, cache=cache, device=device)
            statuses["tiles"] = _status(tinfo)
            verdict = verify_tiles_bundle(rg, cache=cache)
            store_report = HostTileStore(at).report()
            print(f"s{scale}: tiles sidecar ready in {time.perf_counter() - t0:.1f}s "
                  f"(cache={tinfo['cache']}, verify="
                  f"{'ok' if verdict['ok'] else verdict['status']})", flush=True)
            print(json.dumps({"scale": scale, "tiles_key": verdict["key"],
                              "verify_ok": verdict["ok"], **store_report}), flush=True)
            if not verdict["ok"]:
                rc = 1
        if args.labels:
            k = args.landmarks or knobs.get("BFS_TPU_TORCH_LABELS") or 32
            t0 = time.perf_counter()
            idx, linfo = load_or_build_labels(graph, k, cache=cache, device=device)
            statuses["labels"] = _status(linfo)
            lverdict = verify_labels_bundle(graph, k, cache=cache)
            print(f"s{scale}: label sidecar ready in {time.perf_counter() - t0:.1f}s (K={idx.k}, "
                  f"index={idx.nbytes} bytes, cold build was "
                  f"{linfo.get('build_seconds', -1.0):.1f}s, cache={linfo['cache']}, verify="
                  f"{'ok' if lverdict['ok'] else lverdict['status']})", flush=True)
            print(json.dumps({"scale": scale, "labels_key": lverdict["key"],
                              "verify_ok": lverdict["ok"], "k": idx.k,
                              "index_bytes": idx.nbytes,
                              "build_seconds": linfo.get("build_seconds", -1.0)}), flush=True)
            if not lverdict["ok"]:
                rc = 1
        if args.compile:
            if device.type != "cuda":
                print(f"s{scale}: --compile skipped (device {device}: the kernels are built "
                      "by nvcc for a card)", flush=True)
            else:
                _compile(rg, scale, device, statuses)
        print(json.dumps({"scale": scale, "artifacts": statuses}), flush=True)
    print(json.dumps({"artifact_caches": artifact_report()}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
