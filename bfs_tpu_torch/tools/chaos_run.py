"""Chaos driver: fault the serving path on a scripted schedule, or kill a
subject process at random, and prove every answer, and every resumed run,
converges to the golden one.  The port of the reference's
``tools/chaos_run.py``.

**serve** (the default here): one in-process
:class:`~bfs_tpu_torch.serve.BfsServer` driven through the reference's
self-healing schedule.  Permanent device faults (``raise:serve.batch``)
until the breaker opens, then a cooldown canary that closes it; hung calls
(``delay:serve.batch:<s>``) the watchdog must turn into degraded ticks,
not a frozen server; a failed integrity verdict (``raise:serve.verify``)
that must quarantine the executable; and an epoch swap under load whose
in-flight queries are answered on their admission epoch.  Every reply is
held against the oracle of the graph its epoch pinned.  The mode exits
non-zero on a wrong answer, a frozen tick (a reply not resolved within
``--serve-tick-timeout``) or a missing breaker, watchdog, integrity or
epoch transition in the final metrics, and restores
``BFS_TPU_TORCH_FAULT`` on every path.  Run it under
``BFS_TPU_TORCH_LOCK_ORDER=1`` to record the order the serve locks nest in
(``analysis.runtime.lock_order_report``).

**loadgen**: SIGKILL ``python -m bfs_tpu_torch.tools.serve_loadgen`` after
a random delay, then run it to completion; its own oracle gate decides.

**traversal**: SIGKILL ``python -m bfs_tpu_torch.resilience.superstep_ckpt``
at a random superstep boundary (``BFS_TPU_TORCH_FAULT=kill:superstep:<n>``)
and run it again on the same checkpoint directory until it completes; the
result must equal an unkilled golden run bit for bit (the dist and parent
hashes, the direction schedule and, on ``sharded`` and ``grid``, the
exchange's arm and bytes per level, on ``grid`` of each axis) and must
have resumed from an epoch.  Configs ``relay``, ``multi``, ``stream``,
``sharded`` (the mesh's relay search on 8 shards stacked on the device,
per-shard epochs) and ``grid`` (the 2-D grid on a ``--mesh`` of 2x4 cells
stacked on the device, per-cell epochs).

**bench** is the reference's default mode: it chaoses the bench's journal
phases, and the port has no bench yet, so it exits 2.

Every subject takes ``--device`` (the card unless ``cpu``).

    python -m bfs_tpu_torch.tools.chaos_run --mode serve --scale 9 --serve-requests 12
    python -m bfs_tpu_torch.tools.chaos_run --mode loadgen --iterations 1 --scale 10
    python -m bfs_tpu_torch.tools.chaos_run --mode traversal --iterations 1 \\
        --traversal-configs relay --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import random
import signal
import subprocess
import sys
import tempfile
import time

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FAULT = "BFS_TPU_TORCH_FAULT"


def log(msg: str) -> None:
    print(f"[chaos] {msg}", flush=True)


def _subject_env() -> dict:
    env = dict(os.environ)
    env.pop(FAULT, None)
    env["PYTHONPATH"] = REPO_ROOT + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH")
                                     else "")
    return env


def chaos_bench(args, rng: random.Random) -> int:
    log("--mode bench chaoses the bench's journal phases (the reference's BENCH_PHASES); "
        "the port has no bench yet (ROADMAP A15's first step): use --mode serve, loadgen or "
        "traversal")
    return 2


# --------------------------------------------------------------------------
# loadgen
# --------------------------------------------------------------------------

def chaos_loadgen(args, rng: random.Random) -> int:
    cmd = [sys.executable, "-m", "bfs_tpu_torch.tools.serve_loadgen", "--scale", str(args.scale),
           "--requests", str(args.requests), "--cache-dir", args.cache_dir]
    if args.device:
        cmd += ["--device", args.device]
    env = _subject_env()
    failures = 0
    for it in range(args.iterations):
        delay = rng.uniform(1.0, args.loadgen_kill_max_s)
        proc = subprocess.Popen(cmd, env=env, cwd=REPO_ROOT, stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
        try:
            proc.wait(timeout=delay)
            log(f"iter {it}: loadgen finished before the {delay:.1f}s kill")
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            log(f"iter {it}: loadgen SIGKILLed at {delay:.1f}s")
        # The next whole run must pass its own oracle gate despite what the
        # dead client left in the shared artifact store.
        proc2 = subprocess.run(cmd, env=env, cwd=REPO_ROOT, capture_output=True, text=True,
                               timeout=args.timeout)
        if proc2.returncode != 0:
            log(f"iter {it}: FAIL, post-kill loadgen rc={proc2.returncode}")
            sys.stderr.write(proc2.stderr[-4000:])
            failures += 1
        else:
            log(f"iter {it}: post-kill loadgen ok")
    log(f"loadgen chaos: {args.iterations - failures}/{args.iterations} ok")
    return 1 if failures else 0


# --------------------------------------------------------------------------
# serve
# --------------------------------------------------------------------------

#: Counters the schedule must move, with their least values: three breaker
#: openings (device faults, hung calls, the quarantine), one canary per
#: recovery, and one of each degradation and epoch transition.
SERVE_TRANSITIONS = (
    ("breaker_opened", 3),
    ("breaker_half_open", 3),
    ("breaker_closed", 3),
    ("breaker_short_circuits", 1),
    ("watchdog_timeouts", 1),
    ("integrity_failures", 1),
    ("epochs_swapped", 1),
    ("epochs_retired", 1),
    ("oracle_served", 1),
)


def chaos_serve(args, rng: random.Random) -> int:
    """The in-process self-healing schedule (the module text).  In this
    process so the schedule can pause and resume the batcher, swap epochs
    under load and reset the faults' arrival counts; the faults still
    travel through the ``BFS_TPU_TORCH_FAULT`` boundary a deployment
    uses."""
    import numpy as np

    from ..graph.generators import rmat_graph
    from ..oracle.bfs import check, queue_bfs
    from ..resilience import faults
    from ..serve import BfsServer

    failures: list[str] = []
    seed = args.seed if args.seed is not None else 1
    graph_a = rmat_graph(args.scale, args.edge_factor, seed=seed)
    graph_b = rmat_graph(args.scale, args.edge_factor, seed=seed + 1)
    v = graph_a.num_vertices
    name = "chaos"
    oracle: dict = {}
    counter = [0]
    prior = os.environ.get(FAULT)  # restored on every path

    def expect(gid, graph, s):
        if (gid, s) not in oracle:
            oracle[(gid, s)] = queue_bfs(graph, s)[0]
        return oracle[(gid, s)]

    def next_source() -> int:
        # A new source per query (7 is coprime with the power-of-two vertex
        # count): a repeat would hit the result cache and run no tick.
        counter[0] += 1
        return (3 + 7 * counter[0]) % v

    def set_fault(spec: str | None) -> None:
        faults.reset()  # kill and raise fire on the nth arrival: a fresh count
        if spec is None:
            os.environ.pop(FAULT, None)
        else:
            os.environ[FAULT] = spec

    def settle(staged, phase: str):
        """Resolve one staged (future, expected) pair; a frozen or failed
        tick and a wrong answer are recorded, never raised."""
        fut, s, gid, graph, want_status, want_epoch = staged
        t0 = time.monotonic()
        try:
            reply = fut.result(timeout=args.serve_tick_timeout)
        except Exception as exc:
            failures.append(f"{phase}: FROZEN or failed tick for source {s}: {exc!r}")
            return None
        wall = time.monotonic() - t0
        if not np.array_equal(reply.dist, expect(gid, graph, s)) or check(
                graph, reply.dist, reply.parent, [s]):
            failures.append(f"{phase}: WRONG answer for source {s} against graph {gid!r} "
                            f"(status={reply.record.status}, epoch={reply.record.epoch})")
        if want_status is not None and reply.record.status != want_status:
            failures.append(f"{phase}: source {s} served status {reply.record.status!r}, the "
                            f"schedule wanted {want_status!r}")
        if want_epoch is not None and reply.record.epoch != want_epoch:
            failures.append(f"{phase}: source {s} answered from epoch {reply.record.epoch}, "
                            f"admitted under epoch {want_epoch}")
        log(f"{phase}: source={s} status={reply.record.status} epoch={reply.record.epoch} "
            f"wait={wall * 1e3:.0f}ms")
        return reply

    report = None
    try:
        with BfsServer(engine=args.serve_engine, device=args.device, max_batch=4, tick_s=0.0,
                       breaker_failures=2, breaker_cooldown_s=args.serve_cooldown_s,
                       watchdog_s=30.0, watchdog_min_s=0.2, verify_sample=1) as server:
            server.register(name, graph_a)

            def ask(phase, *, gid="a", graph=graph_a, timeout_s=None, want_status=None,
                    want_epoch=None):
                s = next_source()
                fut = server.submit(name, [s], timeout_s=timeout_s)
                return settle((fut, s, gid, graph, want_status, want_epoch), phase)

            def recover(phase):
                set_fault(None)
                time.sleep(args.serve_cooldown_s + 0.1)
                ask(phase, want_status="ok")  # the half-open canary closes it

            # 1. Healthy load: every answer served by the card, exact.
            for _ in range(args.serve_requests):
                ask("healthy", want_status="ok")
            # 2. Permanent device faults until the breaker opens; every
            # faulted tick still answers exactly (the oracle).
            for _ in range(3):
                set_fault("raise:serve.batch")
                ask("device-fault", want_status="oracle")
            states = [cell["state"] for cell in server.report()["health"]["breaker"].values()]
            if "open" not in states:
                failures.append(f"device-fault: no open circuit in the report ({states})")
            recover("recovery")
            # 3. Hung calls: every device attempt wedges; the deadline-tight
            # watchdog turns each into a degraded tick, and two of them open
            # the breaker again.
            set_fault(f"delay:serve.batch:{args.serve_delay_s}")
            for _ in range(2):
                ask("hung-call", timeout_s=0.5, want_status="oracle")
            recover("recovery-2")
            # 4. A corrupt answer: the failed verdict quarantines the
            # executable and the batch runs again on the oracle.
            set_fault("raise:serve.verify")
            ask("integrity", want_status="oracle")
            recover("recovery-3")
            # 5. An epoch swap under load: queries staged before it answer on
            # graph A (their admission epoch), queries after it on graph B.
            old_epoch = server.registry.epoch(name)
            server.pause()
            staged = []
            for _ in range(3):
                s = next_source()
                staged.append((server.submit(name, [s]), s, "a", graph_a, None, old_epoch))
            server.register(name, graph_b)  # the hot swap
            for _ in range(3):
                s = next_source()
                staged.append((server.submit(name, [s]), s, "b", graph_b, None, old_epoch + 1))
            server.resume()
            for item in staged:
                settle(item, "epoch-swap")
            if not any(not np.array_equal(expect("a", graph_a, s), expect("b", graph_b, s))
                       for (_, s, gid, *_rest) in staged if gid == "a"):
                failures.append("epoch-swap: graphs A and B agree on every staged source; the "
                                "snapshot check proved nothing")
            report = server.report()
    finally:
        set_fault(None)
        if prior is not None:
            os.environ[FAULT] = prior

    if report is None:
        for f in failures:
            log(f"FAIL: {f}")
        log("serve chaos: FAIL (the schedule did not finish)")
        return 1
    c = report["counters"]
    for key, least in SERVE_TRANSITIONS:
        if c.get(key, 0) < least:
            failures.append(f"snapshot: counter {key}={c.get(key, 0)} < {least}")
    log("serve chaos metrics snapshot:")
    log(json.dumps({"counters": c, "health": report["health"], "registry": report["registry"]},
                   indent=2, sort_keys=True, default=str))
    for f in failures:
        log(f"FAIL: {f}")
    log(f"serve chaos: {'FAIL' if failures else 'ok'} ({len(failures)} violation(s))")
    return 1 if failures else 0


# --------------------------------------------------------------------------
# traversal
# --------------------------------------------------------------------------

#: The runner's configs: relay = the single-source relay engine (sparse
#: hybrid, auto direction); multi = the batched push run; stream = the
#: streamed MXU arm under a one-superblock cache; sharded = the mesh's relay
#: search on 8 shards (auto direction, auto exchange); grid = the 2-D grid
#: on the --mesh (auto direction, auto exchange, per-cell epochs).
TRAVERSAL_CONFIGS = ("relay", "multi", "sharded", "grid", "stream")

#: Fields a resumed run must reproduce bit for bit (a field a config does
#: not write is absent on both sides): on sharded and grid also the
#: exchange's arm and bytes per level, on grid each axis's.
TRAVERSAL_DETERMINISTIC = ("dist_hash", "parent_hash", "num_levels", "direction_schedule",
                           "exchange_schedule", "exchange_bytes",
                           "col_schedule", "col_bytes", "row_schedule", "row_bytes")


def run_traversal(args, cfg: str, ckpt_dir: str, out: str, fault: str | None = None):
    env = _subject_env()
    if fault is not None:
        env[FAULT] = fault
    cmd = [sys.executable, "-m", "bfs_tpu_torch.resilience.superstep_ckpt", "--config", cfg,
           "--ckpt-dir", ckpt_dir, "--out", out, "--scale", str(args.scale),
           "--edge-factor", str(args.edge_factor),
           "--seed", str(args.seed if args.seed is not None else 3),
           "--interval", str(args.ckpt_interval)]
    if args.device:
        cmd += ["--device", args.device]
    if cfg == "grid":
        cmd += ["--mesh", args.mesh]
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=REPO_ROOT,
                          timeout=args.timeout)
    doc = None
    if proc.returncode == 0 and os.path.exists(out):
        with open(out, encoding="utf-8") as fh:
            doc = json.load(fh)
    return proc, doc


def chaos_traversal(args, rng: random.Random) -> int:
    """For each config an unkilled golden run, then per iteration a run
    SIGKILLed at a random segment boundary, run again on the same
    checkpoint directory until it completes, and held against the golden
    run: the deterministic fields bit for bit, and a resume from an epoch
    (a silent fresh restart would pass the value check too)."""
    failures = 0
    configs = [c for c in args.traversal_configs.split(",") if c]
    for cfg in configs:
        with tempfile.TemporaryDirectory(prefix=f"chaos_tg_{cfg}_") as gd:
            log(f"[{cfg}] golden run (uninterrupted)...")
            proc, golden = run_traversal(args, cfg, gd, os.path.join(gd, "golden.json"))
            if golden is None:
                log(f"[{cfg}] golden run failed rc={proc.returncode}")
                sys.stderr.write(proc.stderr[-4000:])
                return 2
            segments = int(golden["superstep_ckpt"]["segments"])
            log(f"[{cfg}] golden: levels={golden['num_levels']} segments={segments}")
        for it in range(args.iterations):
            with tempfile.TemporaryDirectory(prefix=f"chaos_t_{cfg}_") as cd:
                rout = os.path.join(cd, "resumed.json")
                kills = 0
                while True:
                    n = rng.randint(1, max(1, segments))
                    fault = f"kill:superstep:{n}" if kills < args.max_kills_per_iteration else None
                    proc, doc = run_traversal(args, cfg, cd, rout, fault=fault)
                    if proc.returncode == 0:
                        break
                    if proc.returncode != -signal.SIGKILL:
                        log(f"[{cfg}] iter {it}: unexpected rc={proc.returncode} "
                            f"(fault={fault})")
                        sys.stderr.write(proc.stderr[-4000:])
                        return 2
                    kills += 1
                    log(f"[{cfg}] iter {it}: killed at boundary {n} (kill #{kills}); "
                        "resuming...")
                bad = []
                if doc is None:
                    bad.append("the completed run wrote no result document")
                else:
                    for k in TRAVERSAL_DETERMINISTIC:
                        if doc.get(k) != golden.get(k):
                            bad.append(f"{k}: resumed {doc.get(k)!r} != golden {golden.get(k)!r}")
                    if kills and doc["superstep_ckpt"]["resumed_from_epoch"] is None:
                        bad.append("the killed run's successor never resumed from a "
                                   "checkpoint epoch (a silent fresh restart)")
                if bad:
                    log(f"[{cfg}] iter {it}: FAIL after {kills} kill(s):")
                    for b in bad:
                        log(f"  - {b}")
                    failures += 1
                else:
                    resumed = doc["superstep_ckpt"]["resumed_from_epoch"]
                    log(f"[{cfg}] iter {it}: ok after {kills} kill(s), resumed from epoch "
                        f"{resumed}: dist, parent and schedule bit-identical")
    total = len(configs) * args.iterations
    log(f"traversal chaos: {total - failures}/{total} ok")
    return 1 if failures else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="serve", choices=("bench", "loadgen", "serve", "traversal"),
                    help="serve by default (the reference's default, bench, needs the port's "
                    "bench)")
    ap.add_argument("--iterations", type=int, default=5)
    ap.add_argument("--seed", type=int, default=None,
                    help="the kill schedule's RNG seed (default: the time)")
    ap.add_argument("--max-kills-per-iteration", type=int, default=3)
    ap.add_argument("--timeout", type=float, default=600.0, help="a subprocess's wall bound")
    ap.add_argument("--device", default=None,
                    help="torch device of every subject (default: the card; 'cpu' runs the "
                    "plain path)")
    ap.add_argument("--scale", type=int, default=8)
    ap.add_argument("--edge-factor", type=int, default=4)
    ap.add_argument("--cache-dir", default=os.path.join(tempfile.gettempdir(), "chaos_cache"),
                    help="the artifact cache every loadgen run shares")
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--loadgen-kill-max-s", type=float, default=20.0)
    ap.add_argument("--traversal-configs", default=",".join(TRAVERSAL_CONFIGS),
                    help="comma list of the superstep_ckpt runner's configs (relay, multi, "
                    "sharded, grid, stream)")
    ap.add_argument("--mesh", default="2x4",
                    help="traversal mode: the grid config's 'rxc' mesh")
    ap.add_argument("--ckpt-interval", type=int, default=2,
                    help="traversal mode: supersteps per checkpoint segment (every:<k>)")
    ap.add_argument("--serve-engine", default="pull", choices=("pull", "push", "relay"))
    ap.add_argument("--serve-requests", type=int, default=10,
                    help="queries of the healthy phase before the faults")
    ap.add_argument("--serve-cooldown-s", type=float, default=0.5,
                    help="breaker cooldown before each half-open canary")
    ap.add_argument("--serve-delay-s", type=float, default=2.0,
                    help="the injected hung call's sleep (above the deadline-tight watchdog's "
                    "budget)")
    ap.add_argument("--serve-tick-timeout", type=float, default=120.0,
                    help="a reply not resolved within this bound is a FROZEN tick")
    args = ap.parse_args(argv)

    seed = args.seed if args.seed is not None else int(time.time())
    log(f"kill-schedule seed: {seed}")
    rng = random.Random(seed)
    rc = {"bench": chaos_bench, "loadgen": chaos_loadgen, "serve": chaos_serve,
          "traversal": chaos_traversal}[args.mode](args, rng)
    # This process's own counters: its subjects print theirs in their logs.
    from ..analysis.runtime import format_retrace_report, lock_order_report
    from ..obs.registry import get_registry

    log("driver metrics snapshot:")
    log(get_registry().to_json())
    log(format_retrace_report())
    order = lock_order_report()
    if order["edges"]:
        log(f"lock order: {len(order['edges'])} edge(s), {len(order['cycles'])} cycle(s)")
        print(json.dumps({"lock_order": order}), flush=True)
    if order["cycles"]:
        log("FAIL: a lock-order cycle: two threads can deadlock")
        rc = rc or 1
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
