"""Parallel BFS runner: the port of ``bfs_tpu.runners.run_parallel``.

For each problem file of the configuration: read the graph, run the
stepped engine with per-superstep timing (compute only: ingest, layout
build and set-up excluded), optional per-superstep text dumps
(``problemFile_i``) and ``.npz`` checkpoints, and a TEPS summary; or, with
``--fused``, one :func:`~bfs_tpu_torch.models.bfs.bfs` call.  Every run
ends with the ``check()`` invariants and raises on any violation.  It runs
on the card unless ``--device cpu`` is given.

Usage:
    python -m bfs_tpu_torch.runners.run_parallel [service.properties] [--fused]
        [--engine push|pull|relay] [--device cpu] [--dump] [--source S] [--resume]
        [--sharded [--mesh-graph N] [--mesh-batch B]]

The stepped mode defaults to ``push`` and ``--fused`` to ``pull``, as in
the reference.  ``--sharded`` (which implies ``--fused``) runs
:func:`~bfs_tpu_torch.parallel.sharded.bfs_sharded` on a ``(B, N)`` mesh:
the flags override the ``mesh-batch`` and ``mesh-graph`` keys of the
configuration, where ``mesh-graph = 0`` takes every visible card.  With
``--device`` the mesh's ``B * N`` shards are stacked on that one device.  ``--resume`` restarts a stepped push or pull run from its
newest valid ``.ckpt_<level>.npz`` (either package's runner writes them).
"""

from __future__ import annotations

import argparse
import os

from ..config import ServiceConfiguration
from ..graph.io import read_sedgewick
from ..graph.vertex import initial_state_vertices, serialize_state
from ..models.bfs import SuperstepRunner, bfs
from ..parallel.sharded import bfs_sharded
from ..oracle.bfs import check
from ..utils.checkpoint import load_latest_checkpoint, save_checkpoint
from ..utils.logging import get_logger
from ..utils.metrics import RunMetrics
from ..utils.timing import Stopwatch

logger = get_logger(__name__)


def _check(graph, dist, parent, source: int, path: str) -> None:
    violations = check(graph, dist, parent, source)
    if violations:
        for v in violations[:10]:
            logger.error("invariant violation: %s", v)
        raise AssertionError(f"BFS invariants violated on {path}")


def run_problem_file(
    path: str,
    *,
    source: int = 0,
    engine: str = "push",
    device=None,
    dump: bool = False,
    checkpoint_every: int = 0,
    work_dir: str = ".",
    resume: bool = False,
) -> RunMetrics:
    """Stepped run over one problem file with full observability."""
    logger.info("Processing problem file: %s (engine=%s)", path, engine)
    graph = read_sedgewick(path)
    metrics = RunMetrics(num_vertices=graph.num_vertices, num_edges=graph.num_edges)
    runner = SuperstepRunner(graph, engine=engine, device=device)
    if (checkpoint_every or resume) and engine == "relay":
        raise ValueError("checkpoints hold the push/pull carry; use --engine push or pull")
    base = os.path.join(work_dir, os.path.basename(path))

    if dump:
        with open(f"{base}_0", "w") as f:
            f.write("\n".join(v.serialize() for v in initial_state_vertices(graph, source)))

    state = runner.init(source)
    resumed_at = None
    if resume:
        found = load_latest_checkpoint(
            base, expect={"source": source, "engine": engine}, device=runner.device
        )
        if found is not None:
            state, resumed_at, ckpt_path = found
            logger.info("Resuming from %s (superstep %d)", ckpt_path, resumed_at)
            if not bool(state.changed):
                logger.info("checkpoint state already converged; nothing to re-run")
        else:
            logger.info("No valid checkpoint under %s.ckpt_*; fresh run", base)
    sw = Stopwatch(runner.device)
    while bool(state.changed):
        sw.reset().start()
        state = runner.step(state)
        sw.stop()
        level = int(state.level)
        metrics.record(level, runner.frontier_size(state), sw.elapsed_s)
        if dump:
            dist, parent, frontier = runner.to_original(state, source=source)
            with open(f"{base}_{level}", "w") as f:
                f.write(serialize_state(graph, dist, parent, frontier, source=source))
        if checkpoint_every and level % checkpoint_every == 0:
            save_checkpoint(f"{base}.ckpt_{level}.npz", state, source=source, engine=engine)

    for line in metrics.log_lines():
        logger.info("%s", line)
    if resumed_at is not None:
        # The metrics cover only the tail after the resume: a full-run TEPS
        # over them would be inflated by what the earlier process paid for.
        logger.info(
            "Total %s: resumed at superstep %d; segment of %d supersteps, "
            "%.3f ms (segment-only timings, not a full-run TEPS)",
            os.path.basename(path), resumed_at, metrics.num_levels,
            metrics.total_seconds * 1e3,
        )
    else:
        logger.info(
            "Total %s: %d supersteps, %.3f ms, %.2f MTEPS",
            os.path.basename(path), metrics.num_levels, metrics.total_seconds * 1e3,
            metrics.teps() / 1e6,
        )
    dist, parent, _ = runner.to_original(state, source=source)
    _check(graph, dist, parent, source, path)
    return metrics


def run_fused(path: str, *, source: int = 0, engine: str = "pull", device=None):
    """One fused search over one problem file, timed with the layout build
    and the loop's capture, then checked."""
    graph = read_sedgewick(path)
    sw = Stopwatch.create_started(device)
    result = bfs(graph, source, engine=engine, device=device)
    sw.stop()
    logger.info("%s: %d supersteps in %s (fused, includes layout build and capture)",
                path, result.num_levels, sw)
    _check(graph, result.dist, result.parent, source, path)
    return result


def run_sharded(path: str, *, source: int = 0, engine: str = "pull", device=None,
                mesh_graph: int | None = None, mesh_batch: int = 1):
    """One search of the mesh-sharded engine over one problem file, timed
    with the layout build and the loop's capture, then checked."""
    from ..parallel.sharded import make_mesh

    devices = None
    if device is not None:
        devices = [device] * (mesh_batch * (mesh_graph or 1))
    mesh = make_mesh(graph=mesh_graph or None, batch=mesh_batch, devices=devices)
    graph = read_sedgewick(path)
    sw = Stopwatch.create_started(device)
    result = bfs_sharded(graph, source, mesh=mesh, engine=engine)
    sw.stop()
    logger.info("%s: %d supersteps in %s (sharded %s on %s, includes layout build and capture)",
                path, result.num_levels, sw, engine, mesh)
    _check(graph, result.dist, result.parent, source, path)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config", nargs="?", default="service.properties")
    ap.add_argument("--fused", action="store_true",
                    help="one level loop per file, no per-superstep observability")
    ap.add_argument(
        "--engine", default=None, choices=("push", "pull", "relay"),
        help="superstep layout; default: 'pull' for --fused (bfs()'s default),"
        " 'push' for the stepped mode",
    )
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="default: the card")
    ap.add_argument("--sharded", action="store_true", help="use the mesh-sharded engine")
    ap.add_argument("--mesh-graph", type=int, default=None)
    ap.add_argument("--mesh-batch", type=int, default=None)
    ap.add_argument("--dump", action="store_true")
    ap.add_argument("--source", type=int, default=None)
    ap.add_argument(
        "--resume", action="store_true",
        help="resume a stepped run from its newest valid checkpoint "
        "(requires checkpoint-every > 0 in the config to have written any)",
    )
    args = ap.parse_args(argv)
    cfg = (
        ServiceConfiguration.load(args.config)
        if os.path.exists(args.config)
        else ServiceConfiguration()
    )
    logger.info("Application name: %s", cfg.app_name)
    source = args.source if args.source is not None else cfg.source
    # The flags override the configuration's mesh keys; 0 = every device.
    mesh_graph = args.mesh_graph if args.mesh_graph is not None else cfg.mesh_graph
    mesh_batch = args.mesh_batch if args.mesh_batch is not None else cfg.mesh_batch
    if args.sharded and not args.fused:
        logger.info("--sharded implies the fused engine; enabling --fused")
        args.fused = True
    for path in cfg.problem_files or ():
        if args.sharded:
            run_sharded(path, source=source, engine=args.engine or "pull", device=args.device,
                        mesh_graph=mesh_graph, mesh_batch=mesh_batch)
        elif args.fused:
            run_fused(path, source=source, engine=args.engine or "pull", device=args.device)
        else:
            run_problem_file(
                path,
                source=source,
                engine=args.engine or "push",
                device=args.device,
                dump=args.dump or cfg.dump_supersteps,
                checkpoint_every=cfg.checkpoint_every,
                work_dir=cfg.work_dir,
                resume=args.resume,
            )


if __name__ == "__main__":
    main()
