"""ctypes bindings for the C++ oracle (``native/oracle_bfs.cpp``): the
port of ``bfs_tpu.oracle.native``.

The source is built on demand with g++ into ``bfs_tpu_torch/_build/``
(:mod:`bfs_tpu_torch.utils.native_loader`).  Callers guard with
:func:`native_available` and take the NumPy oracle otherwise.
"""

from __future__ import annotations

import ctypes
import os
from collections.abc import Sequence

import numpy as np

from ..graph.csr import Graph
from ..utils.native_loader import BUILD_DIR, NativeLib, native_source

_I32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_I64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


def _register(lib: ctypes.CDLL) -> None:
    lib.bfs_csr.restype = ctypes.c_int32
    lib.bfs_csr.argtypes = [
        ctypes.c_int64, _I64, _I32, ctypes.c_int32, _I32, ctypes.c_int32,
        _I32, _I32,
    ]
    lib.bfs_check.restype = ctypes.c_int32
    lib.bfs_check.argtypes = [
        ctypes.c_int64, _I64, _I32, ctypes.c_int32, _I32, _I32, _I32,
    ]


_LIB = NativeLib(
    src=native_source("oracle_bfs.cpp"),
    so=os.path.join(BUILD_DIR, "liboracle_bfs.so"),
    register=_register,
)


def native_available() -> bool:
    return _LIB.available()


def _csr(graph: Graph):
    indptr, indices = graph.csr()
    return (np.ascontiguousarray(indptr, dtype=np.int64),
            np.ascontiguousarray(indices, dtype=np.int32))


def native_bfs(graph: Graph, sources: int | Sequence[int] = 0, *, policy: str = "queue"):
    """Run the C++ oracle: ``policy='queue'`` gives algs4's first-discovery
    parents, ``'canonical'`` the min-parent rule of the engines.  Returns
    ``(dist, parent, num_levels)``; raises if the library is unavailable."""
    lib = _LIB.load()
    if lib is None:
        raise RuntimeError("native oracle unavailable (compiler or load failure)")
    srcs = np.ascontiguousarray(np.atleast_1d(np.asarray(sources, dtype=np.int32)))
    dist = np.empty(graph.num_vertices, dtype=np.int32)
    parent = np.empty(graph.num_vertices, dtype=np.int32)
    pol = {"queue": 0, "canonical": 1}[policy]
    levels = lib.bfs_csr(graph.num_vertices, *_csr(graph), np.int32(srcs.size), srcs, pol,
                         dist, parent)
    if levels < 0:
        raise ValueError("native oracle rejected input")
    return dist, parent, int(levels)


def native_check(graph: Graph, dist, parent, sources=0) -> int:
    """Invariant bitmask from the native verifier; 0 = OK."""
    lib = _LIB.load()
    if lib is None:
        raise RuntimeError("native oracle unavailable")
    srcs = np.ascontiguousarray(np.atleast_1d(np.asarray(sources, dtype=np.int32)))
    return int(lib.bfs_check(
        graph.num_vertices, *_csr(graph), np.int32(srcs.size), srcs,
        np.ascontiguousarray(dist, dtype=np.int32),
        np.ascontiguousarray(parent, dtype=np.int32),
    ))
