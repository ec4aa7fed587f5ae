"""Resilience: phase-boundary fault injection (:mod:`.faults`),
transient-failure retry with a circuit breaker (:mod:`.retry`), run
configuration keys (:mod:`.journal`) and superstep checkpoints
(:mod:`.superstep_ckpt`, imported directly: segmented runs that resume
mid-traversal), the port of ``bfs_tpu.resilience``."""

from .faults import FaultInjected, corrupt_file, fault_point, fault_spec
from .journal import config_key
from .retry import (
    CircuitBreaker,
    PermanentError,
    RetryError,
    RetryPolicy,
    TransientError,
    default_classify,
    retry_call,
)

__all__ = [
    "CircuitBreaker",
    "FaultInjected",
    "PermanentError",
    "RetryError",
    "RetryPolicy",
    "TransientError",
    "config_key",
    "corrupt_file",
    "default_classify",
    "fault_point",
    "fault_spec",
    "retry_call",
]
