"""Sequential oracle runner: the port of ``bfs_tpu.runners.run_sequential``.

For each problem file of the configuration: build the graph (untimed), run
the sequential BFS oracle under a stopwatch (the C++ oracle when it
builds, else the NumPy one), optionally log the per-vertex report
``s to v (d): path`` / ``(not connected)`` at debug level, and verify the
``check()`` invariants.

Usage:
    python -m bfs_tpu_torch.runners.run_sequential [service.properties]
        [--native|--python] [--report] [--source S]
"""

from __future__ import annotations

import argparse
import os

from ..config import ServiceConfiguration
from ..graph.csr import INF_DIST
from ..graph.io import read_sedgewick
from ..graph.vertex import path_to
from ..oracle.bfs import check, queue_bfs
from ..oracle.native import native_available, native_bfs
from ..utils.logging import get_logger
from ..utils.timing import Stopwatch

logger = get_logger(__name__)


def run_problem_file(path: str, *, source: int = 0, use_native: bool | None = None,
                     report: bool = False) -> float:
    """Returns the BFS wall time in seconds (construction excluded)."""
    logger.info("Processing problem file: %s", path)
    graph = read_sedgewick(path)
    if use_native is None:
        use_native = native_available()
    sw = Stopwatch.create_started()
    if use_native:
        dist, parent, _ = native_bfs(graph, source, policy="queue")
    else:
        dist, parent = queue_bfs(graph, source)
    sw.stop()
    logger.info("Elapsed time ==> %s (%s oracle)", sw, "native" if use_native else "python")
    if report:
        for v in range(graph.num_vertices):
            if dist[v] != INF_DIST:
                p = "-".join(str(x) for x in path_to(parent, v))
                logger.debug("%d to %d (%d): %s", source, v, int(dist[v]), p)
            else:
                logger.debug("%d to %d (-): (not connected)", source, v)
    violations = check(graph, dist, parent, source)
    if violations:
        raise AssertionError(f"oracle invariants violated on {path}: {violations[:3]}")
    return sw.elapsed_s


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config", nargs="?", default="service.properties")
    ap.add_argument("--native", action="store_true")
    ap.add_argument("--python", action="store_true")
    ap.add_argument("--report", action="store_true")
    ap.add_argument("--source", type=int, default=None)
    args = ap.parse_args(argv)
    cfg = (
        ServiceConfiguration.load(args.config)
        if os.path.exists(args.config)
        else ServiceConfiguration()
    )
    logger.info("Application name: %s", cfg.app_name)
    use_native = True if args.native else (False if args.python else None)
    source = args.source if args.source is not None else cfg.source
    for path in cfg.problem_files or ():
        run_problem_file(path, source=source, use_native=use_native, report=args.report)


if __name__ == "__main__":
    main()
