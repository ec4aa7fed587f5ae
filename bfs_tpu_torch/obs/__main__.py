"""``python -m bfs_tpu_torch.obs``: the observability CLI over run
artifacts, the port of ``bfs_tpu.obs.__main__``.

Subcommands:

``trace <journal.jsonl> [-o out.json]``
    Stitch every process generation's journaled span records into one
    Chrome trace JSON that Perfetto loads (default output: the journal
    path with ``.trace.json``).  Works on finished and interrupted
    journals.

``curve <journal.jsonl>``
    Print the journaled level curve (the ``level_curve`` phase record, or
    the ``headline`` record's ``details.level_curve``) as an ASCII bar
    chart.

``snapshot [--prom]``
    Print this process's :class:`~bfs_tpu_torch.obs.registry.MetricsRegistry`
    snapshot as JSON (default) or Prometheus exposition text.

Usage::

    python -m bfs_tpu_torch.obs trace .bench_cache/journal/<key>.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _trace(args) -> int:
    from .spans import stitch_journal_trace

    doc = stitch_journal_trace(args.journal)
    events = doc["traceEvents"]
    out = args.output or (os.path.splitext(args.journal)[0] + ".trace.json")
    with open(out, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    names = sorted({e.get("name", "?") for e in events})
    gens = len({e.get("pid") for e in events})
    print(f"wrote {out}: {len(events)} events, {gens} process generation(s), "
          f"{len(names)} span names")
    for n in names:
        print(f"  {n}")
    if not events:
        print("  (no spans journaled — was the run made with BFS_TPU_TORCH_SPANS=0?)")
    return 0


def _find_curve(records) -> dict | None:
    curve = None
    for rec in records:
        payload = rec.get("payload") or {}
        if rec["phase"] == "level_curve" and isinstance(payload, dict):
            curve = payload.get("level_curve", curve)
        if rec["phase"] == "headline":
            details = (payload.get("headline") or {}).get("details") or {}
            if isinstance(details.get("level_curve"), dict):
                curve = details["level_curve"]
    return curve if isinstance(curve, dict) else None


def _curve(args) -> int:
    from ..resilience.journal import read_records
    from .telemetry import render_curve_ascii

    curve = _find_curve(read_records(args.journal))
    if curve is None:
        print("no level_curve record in this journal", file=sys.stderr)
        return 1
    print(render_curve_ascii(curve))
    if "cap_proximity" in curve:
        print(f"cap proximity: {curve['levels']}/{curve.get('cap')} levels "
              f"({curve['cap_proximity']:.2f})")
    return 0


def _snapshot(args) -> int:
    from .registry import get_registry

    reg = get_registry()
    print(reg.to_prometheus() if args.prom else reg.to_json())
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m bfs_tpu_torch.obs",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("trace", help="stitch a journal's spans into a Perfetto trace")
    p.add_argument("journal")
    p.add_argument("-o", "--output", default="")
    p.set_defaults(fn=_trace)
    p = sub.add_parser("curve", help="print a journal's level curve")
    p.add_argument("journal")
    p.set_defaults(fn=_curve)
    p = sub.add_parser("snapshot", help="print this process's metrics snapshot")
    p.add_argument("--prom", action="store_true", help="Prometheus text format")
    p.set_defaults(fn=_snapshot)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
