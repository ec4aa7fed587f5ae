"""Diff two superstep phase ledgers: the port of ``tools/ledger_compare.py``.

Run from the root of a checkout::

    python -m bfs_tpu_torch.tools.ledger_compare BEFORE AFTER [--threshold 0.25] [--exact]

Each side is a raw ledger JSON (``python -m bfs_tpu_torch.profiling`` or
``python -m bfs_tpu.profiling``) or headline JSON lines with the ledger at
``details.superstep_phases`` (the last parseable line wins), of either
package: phases are compared by name.  Prints a phase-by-phase delta table
(markdown) and exits 2 when any phase regressed by more than
``--threshold`` (default 25%).  ``--exact`` demands bit-identical phase
seconds and an identical ``direction_schedule`` instead (a resumed run's
ledger against the run it resumed).  Sharded captures
(``details.sharded_phases``, ``details.exchange``), the expansion-arm
record, the streamed ledger (``details.stream``) and the label tier's
record (``details.labels``) are tabulated and compared as the reference
tool does, so both tools print the same table and exit with the same code
on the same documents.

Imports neither torch nor jax.
"""

from __future__ import annotations

import argparse
import json
import sys

#: Phases in ledger order (unknown extras are appended as found).
PHASE_ORDER = ["vperm", "broadcast", "net_apply", "rowmin", "state_update",
               "expansion", "full_superstep", "full_superstep_telemetry"]

#: Per-axis exchange columns of a 2D-grid capture (details.exchange).
AXIS_KEYS = ("col_bytes", "row_bytes", "col_schedule", "row_schedule")

#: Streaming-run totals of a ``details.stream`` ledger, in table
#: order.  Like the per-axis columns, the phase is compared only
#: when BOTH captures carry it — a streamed capture still diffs against
#: its pre-stream golden.
STREAM_KEYS = (
    "bytes_streamed", "hits", "misses", "evictions", "corrupt_refetches",
)

#: Label-tier record of a ``details.labels`` capture (the reference
#: bench's labels mode), in table order.  The first five are deterministic
#: per (graph, K, pairs) and pinned under ``--exact``; the qps/speedup
#: tail is wall-clock and only tabulated.  Compared only when BOTH
#: captures carry the record — pre-label goldens simply lack it.
LABELS_PINNED = ("k", "pairs", "tight_hits", "fallbacks", "wrong_answers")
LABELS_KEYS = LABELS_PINNED + ("labels_qps", "exact_qps", "speedup")


def load_doc(path: str) -> dict:
    """Headline line(s) or raw ledger file -> the containing doc.  Bench
    output may hold several JSON lines (provisional + final): the LAST
    parseable line wins, matching how captures are read everywhere else."""
    with open(path) as f:
        text = f.read()
    try:
        # Whole-file document (the indent-2 profiling CLI output).
        return json.loads(text)
    except ValueError:
        pass
    doc = None
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            doc = json.loads(line)
        except ValueError:
            continue
    if doc is None:
        raise SystemExit(f"{path}: no parseable JSON line")
    return doc


def extract(doc: dict, path: str):
    """(phases {name: seconds}, full ledger dict, direction_schedule|None,
    bytes {name: exchange bytes}, per_shard rows, exchange arm schedule,
    expansion-arm record, per-axis exchange columns).

    Understands BOTH capture shapes: single-chip headlines
    (``details.superstep_phases``) and sharded MULTICHIP headlines
    (``details.sharded_phases`` — per-shard rows + the exchange-bytes
    column riding each phase record, plus ``details.exchange.schedule``,
    the per-level arm record).  The last element is the EXPANSION-arm
    record: ``details.expansion``'s selected arm + per-level
    arm schedule, diffed under ``--exact`` like the direction and
    exchange schedules.  A ninth element carries the ``details.stream``
    ledger — per-level bytes-streamed / hit / miss / evict
    rows plus run totals — ``None`` on captures that never streamed."""
    ledger = doc
    details = doc.get("details")
    if isinstance(details, dict):
        ledger = details.get("superstep_phases")
        if not isinstance(ledger, dict):
            ledger = details.get("sharded_phases")
    labels = None
    if isinstance(details, dict) and isinstance(details.get("labels"),
                                                dict):
        labels = details["labels"]
    if not isinstance(ledger, dict) or "phases" not in ledger:
        if labels is not None:
            # A BENCH_LABELS capture has no superstep ledger — the labels
            # record IS its ledger.
            ledger = {"phases": {}}
        else:
            raise SystemExit(
                f"{path}: no superstep phase ledger found (need a bench "
                "headline with details.superstep_phases or "
                "details.sharded_phases or details.labels, or a raw "
                "ledger JSON)"
            )
    phases = {
        name: float(rec["seconds"])
        for name, rec in ledger["phases"].items()
        if isinstance(rec, dict) and "seconds" in rec
    }
    xbytes = {
        name: int(rec["bytes_exchanged"])
        for name, rec in ledger["phases"].items()
        if isinstance(rec, dict) and "bytes_exchanged" in rec
    }
    per_shard = ledger.get("per_shard")
    sched = None
    xsched = None
    if isinstance(details, dict):
        ds = details.get("direction_schedule")
        if isinstance(ds, dict):
            sched = ds.get("schedule")
        ex = details.get("exchange")
        if isinstance(ex, dict):
            xsched = ex.get("schedule")
    esched = None
    if isinstance(details, dict):
        exp = details.get("expansion")
        if isinstance(exp, dict):
            esched = {
                "arm": exp.get("arm"),
                "per_level": exp.get("per_level"),
            }
    # Per-AXIS wire columns: grid captures split the
    # per-level exchange curve into a column-axis and a row-axis share
    # plus one arm schedule each.  Old 1D captures simply lack the keys
    # — the dict stays empty and every per-axis comparison is skipped,
    # so a grid capture still diffs against its pre-grid golden.
    axes = {}
    if isinstance(details, dict) and isinstance(details.get("exchange"),
                                                dict):
        ex = details["exchange"]
        axes = {
            k: ex[k] for k in AXIS_KEYS if ex.get(k) is not None
        }
    stream = None
    if isinstance(details, dict) and isinstance(details.get("stream"),
                                                dict):
        stream = details["stream"]
    return (phases, ledger, sched, xbytes, per_shard, xsched, esched,
            axes, stream, labels)


def fmt_s(s: float) -> str:
    if s >= 1e-3:
        return f"{s * 1e3:.3f} ms"
    return f"{s * 1e6:.1f} µs"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("before")
    ap.add_argument("after")
    ap.add_argument(
        "--threshold", type=float, default=0.25,
        help="max tolerated per-phase regression (fraction; default 0.25)",
    )
    ap.add_argument(
        "--exact", action="store_true",
        help="require bit-identical phase seconds + direction schedule "
        "(the resumed-vs-golden invariant)",
    )
    args = ap.parse_args(argv)

    pb, lb, sb, xb, shb, xsb, esb, axb, strb, labb = extract(
        load_doc(args.before), args.before
    )
    pa, la, sa, xa, sha, xsa, esa, axa, stra, laba = extract(
        load_doc(args.after), args.after
    )

    names = [p for p in PHASE_ORDER if p in pb or p in pa]
    names += [p for p in sorted(set(pb) | set(pa)) if p not in names]

    has_bytes = bool(xb or xa)
    rows = []
    regressed, mismatched = [], []
    for name in names:
        b, a = pb.get(name), pa.get(name)
        if b is None or a is None:
            rows.append((name, b, a, None))
            if args.exact:
                mismatched.append(name)
            continue
        delta = (a - b) / b if b > 0 else 0.0
        rows.append((name, b, a, delta))
        if args.exact and a != b:
            mismatched.append(name)
        elif not args.exact and delta > args.threshold:
            regressed.append((name, delta))

    if has_bytes:
        print("| phase | before | after | delta | exchange bytes |")
        print("|---|---|---|---|---|")
    else:
        print("| phase | before | after | delta |")
        print("|---|---|---|---|")
    for name, b, a, delta in rows:
        bs = fmt_s(b) if b is not None else "—"
        as_ = fmt_s(a) if a is not None else "—"
        ds = f"{delta * 100:+.1f}%" if delta is not None else "—"
        if has_bytes:
            bb, ba = xb.get(name), xa.get(name)
            xs = (
                f"{bb if bb is not None else '—'} -> "
                f"{ba if ba is not None else '—'}"
            )
            print(f"| {name} | {bs} | {as_} | {ds} | {xs} |")
            # Wire bytes are deterministic per (config, arm): more bytes
            # after than before is a regression of exactly the thing a
            # compressed exchange claims (flat -> auto must shrink).
            if bb is not None and ba is not None:
                if args.exact and bb != ba:
                    mismatched.append(f"{name}:bytes")
                elif (
                    not args.exact and bb > 0
                    and (ba - bb) / bb > args.threshold
                ):
                    regressed.append((f"{name}:bytes", (ba - bb) / bb))
            if args.exact:
                # Grid phase rows split bytes per axis; compare each
                # column only when BOTH captures carry it.
                rb = lb.get("phases", {}).get(name)
                ra = la.get("phases", {}).get(name)
                for axk in ("col_bytes", "row_bytes"):
                    if (
                        isinstance(rb, dict) and isinstance(ra, dict)
                        and axk in rb and axk in ra
                        and rb[axk] != ra[axk]
                    ):
                        mismatched.append(f"{name}:{axk}")
        else:
            print(f"| {name} | {bs} | {as_} | {ds} |")

    if shb or sha:
        print()
        print("| shard | real_words | adj_entries | exchange bytes |")
        print("|---|---|---|---|")
        for row_b, row_a in zip(shb or [], sha or []):
            s = row_b.get("shard", row_a.get("shard"))
            rw = f"{row_b.get('real_words')} -> {row_a.get('real_words')}"
            ae = f"{row_b.get('adj_entries')} -> {row_a.get('adj_entries')}"
            eb = (
                f"{row_b.get('exchange_bytes_share')} -> "
                f"{row_a.get('exchange_bytes_share')}"
            )
            print(f"| {s} | {rw} | {ae} | {eb} |")
        if args.exact and (shb or []) != (sha or []):
            mismatched.append("per_shard")

    if axb or axa:
        # Per-axis per-level table (grid captures).  zip to the longer
        # curve so a level present on one side only renders as '—'.
        nlev = max(
            len(axb.get("col_bytes") or []), len(axa.get("col_bytes") or [])
        )
        print()
        print("| level | col bytes | row bytes | col arm | row arm |")
        print("|---|---|---|---|---|")

        def _cell(side, key, i):
            v = side.get(key)
            return v[i] if v is not None and i < len(v) else "—"

        for i in range(nlev):
            cols = " | ".join(
                f"{_cell(axb, k, i)} -> {_cell(axa, k, i)}"
                for k in AXIS_KEYS
            )
            print(f"| {i + 1} | {cols} |")
        if args.exact:
            for k in AXIS_KEYS:
                if (
                    axb.get(k) is not None and axa.get(k) is not None
                    and list(axb[k]) != list(axa[k])
                ):
                    mismatched.append(f"exchange:{k}")

    if strb or stra:
        # Streamed-run ledger: totals row + the per-level
        # bytes/hit/miss/evict curve.  zip to the longer level list so a
        # level present on one side only renders as '—'; the phase is
        # PINNED under --exact only when both captures carry it (an old
        # pre-stream golden simply lacks details.stream).
        def _tot(side, key):
            return side.get(key, "—") if side else "—"

        print()
        print("| stream | " + " | ".join(STREAM_KEYS) + " |")
        print("|---|" + "---|" * len(STREAM_KEYS))
        print(
            "| totals | "
            + " | ".join(
                f"{_tot(strb, k)} -> {_tot(stra, k)}" for k in STREAM_KEYS
            )
            + " |"
        )
        lev_b = (strb or {}).get("levels") or []
        lev_a = (stra or {}).get("levels") or []
        print()
        print("| level | arm | demanded | bytes streamed | hits | misses "
              "| evictions |")
        print("|---|---|---|---|---|---|---|")

        def _row(rows, i, key):
            return rows[i].get(key, "—") if i < len(rows) else "—"

        for i in range(max(len(lev_b), len(lev_a))):
            cols = " | ".join(
                f"{_row(lev_b, i, k)} -> {_row(lev_a, i, k)}"
                for k in ("arm", "demanded", "bytes_streamed", "hits",
                          "misses", "evictions")
            )
            lvl = _row(lev_b, i, "level")
            if lvl == "—":
                lvl = _row(lev_a, i, "level")
            print(f"| {lvl} | {cols} |")
        if args.exact and strb and stra:
            for k in STREAM_KEYS:
                if strb.get(k) != stra.get(k):
                    mismatched.append(f"stream:{k}")
            if lev_b != lev_a:
                mismatched.append("stream:levels")

    if labb or laba:
        # Label-tier record: one totals row.  The counter
        # half (k/pairs/hits/fallbacks/wrong) is deterministic per
        # (graph, K, pair batch) and pinned under --exact; the qps half
        # is wall clock and only tabulated.  A capture answering ANY
        # query wrongly, or whose label tier is not strictly faster than
        # the exact arm, fails the diff outright — that is the claim a
        # label tier makes.
        def _lv(side, key):
            return side.get(key, "—") if side else "—"

        print()
        print("| labels | " + " | ".join(LABELS_KEYS) + " |")
        print("|---|" + "---|" * len(LABELS_KEYS))
        print(
            "| totals | "
            + " | ".join(
                f"{_lv(labb, k)} -> {_lv(laba, k)}" for k in LABELS_KEYS
            )
            + " |"
        )
        if args.exact and labb and laba:
            for k in LABELS_PINNED:
                if labb.get(k) != laba.get(k):
                    mismatched.append(f"labels:{k}")
        for side_name, side in (("before", labb), ("after", laba)):
            if not side:
                continue
            if int(side.get("wrong_answers", 0)) != 0:
                regressed.append((f"labels:{side_name}:wrong_answers", 1.0))
            if float(side.get("speedup", 0.0)) <= 1.0:
                regressed.append((
                    f"labels:{side_name}:speedup",
                    float(side.get("speedup", 0.0)) - 1.0,
                ))

    if args.exact and xsb != xsa:
        mismatched.append("exchange_schedule")
    if args.exact and esb != esa:
        # The expansion-arm record (selected arm + per-level arm
        # schedule): a resumed run flipping gather<->mxu, or replaying a
        # different per-level arm sequence, recomputed what it should
        # have restored.
        mismatched.append("expansion_arm_schedule")

    for side, led in (("before", lb), ("after", la)):
        sel = {
            p: led["phases"][p].get("selected")
            for p in ("rowmin", "state_update", "expansion")
            if p in led.get("phases", {})
            and isinstance(led["phases"][p], dict)
            and led["phases"][p].get("selected")
        }
        if sel:
            print(f"\n{side}: selected arms {sel}", file=sys.stderr)

    if args.exact:
        if sb != sa:
            mismatched.append("direction_schedule")
        if mismatched:
            print(
                f"\nEXACT MISMATCH: {mismatched} (resumed ledger must "
                "replay the golden one bit-identically)",
                file=sys.stderr,
            )
            return 2
        print("\nexact match (phases + direction schedule)", file=sys.stderr)
        return 0
    if regressed:
        print(
            "\nREGRESSION over threshold "
            f"{args.threshold * 100:.0f}%: "
            + ", ".join(f"{n} {d * 100:+.1f}%" for n, d in regressed),
            file=sys.stderr,
        )
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
