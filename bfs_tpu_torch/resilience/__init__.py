"""Resilience: phase-boundary fault injection (:mod:`.faults`) and
transient-failure retry with a circuit breaker (:mod:`.retry`), the two
modules of ``bfs_tpu.resilience`` that the query server runs on."""

from .faults import FaultInjected, corrupt_file, fault_point, fault_spec
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
    "corrupt_file",
    "default_classify",
    "fault_point",
    "fault_spec",
    "retry_call",
]
