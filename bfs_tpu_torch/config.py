"""The ``service.properties`` layer (:func:`parse_properties`,
:class:`ServiceConfiguration`) and the artifact-cache directories
(:func:`cache_root`, :func:`layout_cache_dir`, :func:`journal_dir`): the
port of ``bfs_tpu.config``'s properties and cache halves.

A ``key=value`` file loaded once: the app name, the comma-separated
problem files (``problemFiles``), the source, the superstep dumps and the
checkpoint interval.  ``mesh-batch`` and ``mesh-graph`` are read as the
reference reads them; the port's runners run on one card and ignore them.
A missing or malformed file raises.

Persistent caches live under one root: ``BFS_TPU_TORCH_CACHE_DIR``, else
``<repo>/.bench_cache`` (listed in ``.gitignore``), the reference's
default root, so both packages share their byte-identical layout bundles.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from . import knobs

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cache_root() -> str:
    """Root directory of the persistent artifact caches."""
    return knobs.get("BFS_TPU_TORCH_CACHE_DIR") or os.path.join(_REPO_ROOT, ".bench_cache")


def layout_cache_dir() -> str:
    """The layout-bundle store (:mod:`bfs_tpu_torch.cache.layout`)."""
    return os.path.join(cache_root(), "layout")


def journal_dir() -> str:
    """The run-journal directory (:mod:`bfs_tpu_torch.resilience.journal`):
    ``BFS_TPU_TORCH_JOURNAL_DIR`` when set, else ``<cache root>/journal``,
    beside the artifacts a resumed run must stay consistent with."""
    return knobs.get("BFS_TPU_TORCH_JOURNAL_DIR") or os.path.join(cache_root(), "journal")


def parse_properties(text: str) -> dict[str, str]:
    """Java-properties subset: ``k=v`` lines, ``#``/``!`` comments,
    whitespace-trimmed keys and values."""
    out: dict[str, str] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#") or line.startswith("!"):
            continue
        if "=" not in line:
            raise ValueError(f"malformed properties line: {raw!r}")
        k, _, v = line.partition("=")
        out[k.strip()] = v.strip()
    return out


@dataclass(frozen=True)
class ServiceConfiguration:
    app_name: str = "BFS with MapReduce, TPU edition"
    problem_files: tuple[str, ...] = ()
    source: int = 0
    mesh_batch: int = 1
    mesh_graph: int = 0  # 0 = use all devices
    dump_supersteps: bool = False
    checkpoint_every: int = 0
    work_dir: str = "."

    @classmethod
    def load(cls, path: str | os.PathLike) -> "ServiceConfiguration":
        with open(path, "r") as f:
            props = parse_properties(f.read())
        files = tuple(
            p.strip() for p in props.get("problemFiles", "").split(",") if p.strip()
        )
        return cls(
            app_name=props.get("app-name", cls.app_name),
            problem_files=files,
            source=int(props.get("source", "0")),
            mesh_batch=int(props.get("mesh-batch", "1")),
            mesh_graph=int(props.get("mesh-graph", "0")),
            dump_supersteps=props.get("dump-supersteps", "false").lower() == "true",
            checkpoint_every=int(props.get("checkpoint-every", "0")),
            work_dir=props.get("work-dir", os.path.dirname(os.fspath(path)) or "."),
        )
