"""Timing: the reference's :class:`Stopwatch` (the runners' per-superstep
clock), and the card timing helpers shared by ``chip_smoke.py`` and the
tools.

Nothing here runs at import time; every function but the Stopwatch needs
a CUDA device.
"""

from __future__ import annotations

import subprocess
import time

import torch

#: Device sleep before each timed call: about 4 ms at the H100's clocks,
#: longer than the host takes to launch a superstep's kernels (26-54 us of
#: host time per wrapper call, 28 launches per superstep at most).
SLEEP_CYCLES = 8_000_000
_FLUSH: list[torch.Tensor] = []


class Stopwatch:
    """``start``/``stop`` accumulate; ``elapsed_s`` is the total in seconds
    (Guava ``Stopwatch`` as the reference's runners use it).  With a CUDA
    ``device``, ``stop`` first waits for the device, so a span around a
    superstep holds the device's time and not only its launch."""

    def __init__(self, device=None):
        self._acc = 0.0
        self._started_at: float | None = None
        self._cuda = device is not None and torch.device(device).type == "cuda"

    @classmethod
    def create_started(cls, device=None) -> "Stopwatch":
        return cls(device).start()

    def start(self) -> "Stopwatch":
        if self._started_at is not None:
            raise RuntimeError("stopwatch already running")
        self._started_at = time.perf_counter()
        return self

    def stop(self) -> "Stopwatch":
        if self._started_at is None:
            raise RuntimeError("stopwatch not running")
        if self._cuda:
            torch.cuda.synchronize()
        self._acc += time.perf_counter() - self._started_at
        self._started_at = None
        return self

    def reset(self) -> "Stopwatch":
        self._acc = 0.0
        self._started_at = None
        return self

    @property
    def running(self) -> bool:
        return self._started_at is not None

    @property
    def elapsed_s(self) -> float:
        extra = time.perf_counter() - self._started_at if self.running else 0.0
        return self._acc + extra

    def __str__(self) -> str:  # Guava's human form, "342.8 ms"
        s = self.elapsed_s
        if s >= 1.0:
            return f"{s:.3f} s"
        if s >= 1e-3:
            return f"{s * 1e3:.3f} ms"
        return f"{s * 1e6:.1f} us"


def device_name(device) -> str:
    """The card's name (``torch.cuda.get_device_name``) for a CUDA device,
    else the device type (``cpu``)."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def card_line() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
    them (the first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0].strip()


def cold_ms(fn, reps: int, warm: int = 2, prep=None, sleep: bool = True) -> float:
    """Mean milliseconds per call of ``fn`` on the card: CUDA events around
    each of ``reps`` calls (after ``warm`` warm-up calls), each call
    preceded by a 256 MB write that evicts the 50 MB L2, so every call
    starts cold as the main path's mask reads do, and (``sleep``) by
    :data:`SLEEP_CYCLES` of device sleep, so the host's time to launch the
    call's kernels passes while the device sleeps and the events span
    device time only.  Without the sleep, where the write ends before the
    host has launched the call's kernels, the span holds the difference.
    ``prep`` (untimed) runs before each call, to restore inputs that the
    call updates in place."""
    if not _FLUSH:
        _FLUSH.append(torch.empty(64 << 20, dtype=torch.int32, device="cuda"))
    for _ in range(warm):
        if prep:
            prep()
        fn()
    pairs = []
    for _ in range(reps):
        if prep:
            prep()
        _FLUSH[0].zero_()
        if sleep:
            torch.cuda._sleep(SLEEP_CYCLES)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        pairs.append((t0, t1))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def host_us(fn, reps: int = 200) -> float:
    """Host microseconds per call of ``fn`` (the time to launch its
    kernels; the device may still be running them)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6
