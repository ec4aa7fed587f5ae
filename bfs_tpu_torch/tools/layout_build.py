"""The relay layout's set-up on the card: the host builder against the
device builder, stage by stage, and the bundle's save and warm load.

Run from the root of a checkout on a machine with a card::

    python3 -m bfs_tpu_torch.tools.layout_build [--scale 22]

Builds ``chip_smoke.py``'s graph (R-MAT, edge factor 6, graph seed 1) and
its relay layout in turns: the device builder (torch programs on the card,
native route), the host builder, the device builder again, then the device
builder with the torch route.  Each build's wall seconds and stage split
(``stage_times``), the host and device layouts held byte for byte, the
torch-routed layout held field for field but the masks; then
``load_or_build_relay`` into a fresh bundle store under ``.bench_cache/``
(cold: build and save) and again (warm: load), the store deleted at the
end.  Prints one line per build, the card's name and power limit, and one
JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import torch

from .. import LayoutCache, build_relay_graph, build_relay_graph_device, load_or_build_relay
from ..graph import generators
from ..graph.relay import MASK_FIELDS, differing_fields
from ..utils.native_loader import REPO_ROOT
from ..utils.timing import card_line

EDGE_FACTOR = 6
GRAPH_SEED = 1


def _timed_build(build):
    """``(layout, seconds, stage_times, device peak bytes)`` of one build."""
    times: dict = {}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rg = build(times)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return rg, secs, times, torch.cuda.max_memory_allocated() - base


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=22)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("layout_build: no CUDA device")
    g = generators.rmat_graph_native(args.scale, EDGE_FACTOR, seed=GRAPH_SEED)
    builds = (
        ("device", lambda t: build_relay_graph_device(g, route="native", stage_times=t)),
        ("host", lambda t: build_relay_graph(g, stage_times=t)),
        ("device", lambda t: build_relay_graph_device(g, route="native", stage_times=t)),
        ("device, torch route", lambda t: build_relay_graph_device(g, route="torch",
                                                                  stage_times=t)),
    )
    rows, layouts = [], {}
    for name, build in builds:
        rg, secs, times, peak = _timed_build(build)
        layouts.setdefault(name, rg)
        del rg
        stages = {k: v for k, v in times.items() if isinstance(v, float)}
        rows.append(dict(builder=name, seconds=secs, peak_bytes=peak, stages=stages))
        print(f"{name}: {secs:.3f} s, device peak {peak} bytes; stages (s): "
              + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()), flush=True)
    host = layouts["host"]
    for name, skip in (("device", ()), ("device, torch route", MASK_FIELDS)):
        bad = differing_fields(host, layouts[name], skip=skip)
        if bad:
            raise AssertionError(f"{name}: {bad} differ from the host builder's")
    same = not differing_fields(host, layouts["device, torch route"])
    print(f"device layout byte-identical to the host's; torch-routed masks "
          f"{'equal to' if same else 'other than'} the native router's", flush=True)
    del layouts

    cache_dir = os.path.join(REPO_ROOT, ".bench_cache")
    os.makedirs(cache_dir, exist_ok=True)
    store = tempfile.mkdtemp(prefix="layout_build_", dir=cache_dir)
    try:
        cache = LayoutCache(store)
        t0 = time.perf_counter()
        _, cold = load_or_build_relay(g, cache=cache)
        cold_s = time.perf_counter() - t0
        bundle = os.path.join(store, cold["key"])
        nbytes = sum(os.path.getsize(os.path.join(bundle, f)) for f in os.listdir(bundle))
        t0 = time.perf_counter()
        _, warm = load_or_build_relay(g, cache=cache)
        warm_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(store, ignore_errors=True)
    assert (cold["cache"], warm["cache"]) == ("miss", "hit"), (cold, warm)
    bundle_row = dict(cold_s=cold_s, build_s=cold["build_seconds"],
                      save_s=cold["save_seconds"], warm_s=warm_s, bundle_bytes=nbytes)
    print(f"bundle: cold {cold_s:.3f} s (build {cold['build_seconds']:.3f}, save "
          f"{cold['save_seconds']:.3f}, {nbytes} bytes), warm load {warm_s:.6f} s", flush=True)
    card = card_line()
    print(card, flush=True)
    print(json.dumps({"scale": args.scale, "card": card, "builds": rows,
                      "torch_route_masks_equal": same, "bundle": bundle_row}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
