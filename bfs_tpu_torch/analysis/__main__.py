"""CLI of the port's linter: ``python -m bfs_tpu_torch.analysis [paths]``.

The default target is the port's shipped code, ``bfs_tpu_torch/`` and
``chip_smoke.py`` (tests are left out: their fixtures trip rules on
purpose).  Passes:

* default -- the AST rules (TRC, RCD005, LCK, OBS, PRG); stdlib only.
* ``--knobs`` -- the knob rung (KNB000-KNB005, :mod:`.knobs`).
* ``--kernels`` -- the kernel registry (KRN000 on any machine; with a
  card, each kernel at lint scale against its plain version, KRN001).
* ``--all`` -- all three, one exit code.

Exit codes: 0 when no error is left outside the committed baseline
(``baseline.txt``; warnings never fail); 1 on a new error or, on a run of
the default target, a stale baseline entry (an accepted finding that is
gone must be pruned); 2 on misuse.  ``--changed`` lints only the files of
the default target that ``git diff --name-only HEAD`` names.
``--write-baseline`` rewrites the baseline from the current errors,
keeping the reason of every entry that stays (new ones get
``TODO: justify``).  ``--no-baseline`` shows everything.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

from . import RULES, Baseline, analyze_paths, default_baseline_path, repo_root


def _family(rule: str) -> str:
    if rule.startswith("KNB"):
        return "knobs"
    if rule.startswith("KRN"):
        return "kernels"
    return "ast"


def default_paths(root: str) -> list[str]:
    return [p for p in (os.path.join(root, "bfs_tpu_torch"), os.path.join(root, "chip_smoke.py"))
            if os.path.exists(p)]


def _changed_files(root: str) -> list[str]:
    """Files of the default target touched against HEAD (staged or not)."""
    try:
        out = subprocess.run(["git", "diff", "--name-only", "HEAD"], capture_output=True,
                             text=True, cwd=root, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return []
    if out.returncode != 0:
        return []
    picked = []
    for line in out.stdout.splitlines():
        rel = line.strip()
        if rel.endswith(".py") and (rel.startswith("bfs_tpu_torch/") or rel == "chip_smoke.py"):
            p = os.path.join(root, rel)
            if os.path.exists(p):
                picked.append(p)
    return picked


def _kernel_findings(root: str) -> list:
    from .kernels import registry_findings, run_on_card

    findings = registry_findings(root)
    import torch

    if torch.cuda.is_available():
        card, rows = run_on_card("cuda")
        findings += card
        print(f"kernels: {len(rows)} kernels at lint scale on "
              f"{torch.cuda.get_device_name(0)}: "
              + ", ".join(f"{n} err {r['max_abs_err']} launches {r['launches']}"
                          for n, r in sorted(rows.items())), file=sys.stderr)
    else:
        print("kernels: no card; the registry pin only (the lint-scale parity runs on a card)",
              file=sys.stderr)
    return findings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m bfs_tpu_torch.analysis",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*", help="files or directories (default: the port)")
    ap.add_argument("--changed", action="store_true",
                    help="lint only the default target's files changed against HEAD")
    ap.add_argument("--knobs", action="store_true", help="run the knob rung only")
    ap.add_argument("--kernels", action="store_true", help="run the kernel registry only")
    ap.add_argument("--all", action="store_true", help="the AST pass, the knob rung and the "
                                                       "kernel registry")
    ap.add_argument("--baseline", default=None, help="baseline file (default: the package's)")
    ap.add_argument("--no-baseline", action="store_true", help="report every finding")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline from the current errors")
    ap.add_argument("--rules", action="store_true", help="print the rule catalog")
    try:
        args = ap.parse_args(argv)
    except SystemExit as exc:
        return 2 if exc.code else 0
    if args.rules:
        for rule, (sev, desc) in sorted(RULES.items()):
            print(f"{rule}  [{sev}]  {desc}")
        return 0
    root = repo_root()
    if args.changed and args.paths:
        print("--changed takes no paths", file=sys.stderr)
        return 2
    missing = [p for p in args.paths if not os.path.exists(p)]
    if missing:
        print(f"no such path: {', '.join(missing)}", file=sys.stderr)
        return 2
    run_ast = args.all or not (args.knobs or args.kernels)
    run_knobs = args.all or args.knobs
    run_kernels = args.all or args.kernels
    default_target = not args.paths and not args.changed

    findings = []
    if run_ast:
        if args.changed:
            paths = _changed_files(root)
        else:
            paths = [os.path.abspath(p) for p in args.paths] or default_paths(root)
        findings += analyze_paths(paths, root)
    if run_knobs:
        from .knobs import analyze_knobs

        findings += analyze_knobs(root=root)[0]
    if run_kernels:
        findings += _kernel_findings(root)

    baseline_path = args.baseline or default_baseline_path()
    errors = [f for f in findings if f.severity == "error"]
    if args.write_baseline:
        old = Baseline.load(baseline_path)
        lines = Baseline.render(errors).splitlines()
        out = []
        for line in lines:
            parts = line.split(None, 2)
            if not line.startswith("#") and len(parts) == 3 and parts[1] in old.entries:
                reason = old.entries[parts[1]][1]
                where = parts[2].split("]", 1)[0] + "]"
                line = f"{parts[0]}  {parts[1]}  {where} {reason.split('] ', 1)[-1]}"
            out.append(line)
        with open(baseline_path, "w", encoding="utf-8") as f:
            f.write("\n".join(out) + "\n")
        print(f"wrote {len(errors)} baseline entries to {baseline_path}")
        return 0
    baseline = Baseline() if args.no_baseline else Baseline.load(baseline_path)
    new = [f for f in findings if not baseline.accepts(f)]
    for f in new:
        print(f.render())
    failed = any(f.severity == "error" for f in new)
    ran = {"ast"} if run_ast and default_target else set()
    ran |= {"knobs"} if run_knobs else set()
    ran |= {"kernels"} if run_kernels else set()
    stale = [fp for fp in baseline.stale() if _family(baseline.entries[fp][0]) in ran]
    for fp in stale:
        rule, why = baseline.entries[fp]
        print(f"stale baseline entry {rule} {fp} {why}: the finding is gone; prune it")
    accepted = len(findings) - len(new)
    print(f"{len(findings)} finding(s): {accepted} accepted by the baseline, {len(new)} new "
          f"({sum(f.severity == 'error' for f in new)} error(s)), {len(stale)} stale baseline "
          "entr(ies)", file=sys.stderr)
    return 1 if failed or stale else 0


if __name__ == "__main__":
    raise SystemExit(main())
