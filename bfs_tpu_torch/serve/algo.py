"""Registry-resident semiring algorithms: the port of ``bfs_tpu.serve.algo``.

:func:`registry_sssp` and :func:`registry_cc` pin the graph's current epoch
(so a hot swap or an eviction cannot retire its engine mid-traversal),
acquire the epoch's resident :class:`~bfs_tpu_torch.models.bfs.EdgeEngine`
(push for SSSP; push or pull for CC) through
:meth:`GraphRegistry.acquire_for`, and run the algorithm on its tensors: no
upload per call, and the registry's budget governs the algorithms as it
governs BFS.  All of it runs under the server's device lock
(:data:`~bfs_tpu_torch.serve.executor.DEVICE_LOCK`), since a capture on one
thread must not meet launches from another.

The engine keeps what the algorithms build in its ``_loops``: the SSSP
weights (computed on the card from the resident endpoints at first use, per
max weight) and each algorithm's captured loop (keyed by algorithm, carry
flavour, delta and max weight), so a second call on a resident engine
replays without a capture.  :func:`~bfs_tpu_torch.serve.registry.device_bytes`
counts them at the engine's next acquire.
"""

from __future__ import annotations

from ..algo.cc import CcResult, cc_device, cc_device_pull
from ..algo.sssp import SsspResult, sssp_device
from .executor import DEVICE_LOCK
from .registry import GraphRegistry

__all__ = ["registry_sssp", "registry_cc"]


def registry_sssp(registry: GraphRegistry, name: str, source: int = 0, **kwargs) -> SsspResult:
    """Weighted SSSP on a registered graph's resident push engine.
    ``kwargs`` pass through to :func:`bfs_tpu_torch.algo.sssp.sssp_device`
    (``max_weight``, ``delta``, ``max_rounds``, ``packed``)."""
    rec = registry.pin(name)
    try:
        with DEVICE_LOCK:
            eng = registry.acquire_for(rec, "push")
            return sssp_device(eng.src, eng.dst, eng.num_vertices, source,
                               cache=eng._loops, **kwargs)
    finally:
        registry.unpin(rec)


def registry_cc(registry: GraphRegistry, name: str, *, engine: str = "push",
                max_rounds: int | None = None) -> CcResult:
    """Connected components on a registered graph's resident engine
    (``engine`` = push | pull; both reach the same labels)."""
    if engine not in ("push", "pull"):
        raise ValueError(f"unknown engine {engine!r}; registry CC runs 'push' or 'pull'")
    rec = registry.pin(name)
    try:
        with DEVICE_LOCK:
            eng = registry.acquire_for(rec, engine)
            if engine == "pull":
                return cc_device_pull(eng.ell0, eng.folds, eng.num_vertices,
                                      max_rounds=max_rounds, cache=eng._loops)
            return cc_device(eng.src, eng.dst, eng.num_vertices, max_rounds=max_rounds,
                             cache=eng._loops)
    finally:
        registry.unpin(rec)
