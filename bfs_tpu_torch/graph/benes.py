"""Beneš routing networks: compile a static permutation to butterfly masks.

Conventions shared with the native router (``native/benes.cpp``) and the
appliers in :mod:`bfs_tpu_torch.ops.relay`:

  * stage ``s`` of a size-``N=2^k`` network has pair distance
    ``N >> (s+1)`` for ``s < k`` and ``N >> (2k-1-s)`` after;
  * a stage swaps ``x[i] <-> x[i+d]`` iff mask bit ``i`` is set, mask bits
    stored only at the lower index of each pair;
  * standard packing: mask element ``e`` at word ``e >> 5``, bit ``e & 31``;
  * the network computes ``y[j] = x[perm[j]]``.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..utils.native_loader import BUILD_DIR, NativeLib, native_source


def _register(lib: ctypes.CDLL) -> None:
    lib.benes_route_i32_v2.restype = ctypes.c_int32
    lib.benes_route_i32_v2.argtypes = [
        ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
        ctypes.c_int32,
    ]


_LIB = NativeLib(
    src=native_source("benes.cpp"),
    so=os.path.join(BUILD_DIR, "libbenes.so"),
    register=_register,
)


def native_available() -> bool:
    return _LIB.available()


def num_stages(n: int) -> int:
    return 2 * (int(n).bit_length() - 1) - 1


def stage_distance(n: int, s: int) -> int:
    k = int(n).bit_length() - 1
    return n >> (s + 1) if s < k else n >> (2 * k - 1 - s)


def route_std(perm: np.ndarray, *, trusted: bool = False) -> np.ndarray:
    """Beneš masks in standard packing, ``uint32[num_stages, n/32]``, for
    ``y[j] = x[perm[j]]``.  ``len(perm)`` must be a power of two in
    [32, 2^30]."""
    lib = _LIB.load()
    if lib is None:
        raise RuntimeError("native benes router unavailable")
    perm = np.ascontiguousarray(perm, dtype=np.int32)
    n = int(perm.shape[0])
    if n < 32 or n & (n - 1):
        raise ValueError(f"network size {n} is not a power of two >= 32")
    words = n // 32
    masks = np.zeros(num_stages(n) * words, dtype=np.uint32)
    rc = lib.benes_route_i32_v2(n, perm, masks, int(trusted))
    if rc == -2:
        raise MemoryError(
            f"native router could not allocate its ~{20 * n >> 20} MiB "
            "working set"
        )
    if rc != 0:
        raise ValueError("perm is not a bijection")
    return masks.reshape(num_stages(n), words)
