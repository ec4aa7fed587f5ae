"""ctypes bindings for the native data loader (``native/graph_gen.cpp``).

The subset the port's layout build and graph ingest use: native R-MAT,
the counting/radix helpers of the relay layout build, the (dst, src) edge
sort of the push and pull layouts, and the Sedgewick parser.  Every entry
point has a NumPy twin in :mod:`.relay`, :mod:`.csr`, :mod:`.generators`
or :mod:`.io`; callers guard with
:func:`native_available`, and both paths give the same bytes.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..utils.native_loader import BUILD_DIR, NativeLib, native_source

_I32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_I64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_U8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def _register(lib: ctypes.CDLL) -> None:
    lib.rmat_edges.restype = None
    lib.rmat_edges.argtypes = [
        ctypes.c_int32, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_uint64, ctypes.c_int32, _I32, _I32,
    ]
    lib.sort_rank_pairs.restype = None
    lib.sort_rank_pairs.argtypes = [ctypes.c_int64, _I32, _I32, _I32, _I32]
    lib.gather_i32.restype = None
    lib.gather_i32.argtypes = [ctypes.c_int64, _I32, _I32, _I32]
    lib.scatter_i32.restype = None
    lib.scatter_i32.argtypes = [ctypes.c_int64, _I32, _I32, _I32]
    lib.slot_assign_i32.restype = None
    lib.slot_assign_i32.argtypes = [ctypes.c_int64, _I32, _I32, _I32, _I32, _I32]
    lib.rank_by_count.restype = None
    lib.rank_by_count.argtypes = [ctypes.c_int64, _I32, ctypes.c_int64, _I32]
    lib.bincount_i32.restype = None
    lib.bincount_i32.argtypes = [ctypes.c_int64, _I32, ctypes.c_int64, _I32]
    lib.csr_fill.restype = None
    lib.csr_fill.argtypes = [
        ctypes.c_int64, ctypes.c_int64, _I32, _I32, _I32, _I32, _I32, _I32,
    ]
    lib.mark_u8.restype = None
    lib.mark_u8.argtypes = [ctypes.c_int64, _I32, _U8]
    lib.pad_identity_i32.restype = None
    lib.pad_identity_i32.argtypes = [ctypes.c_int64, _I32, _U8]
    lib.sort_edges_by_dst.restype = None
    lib.sort_edges_by_dst.argtypes = [ctypes.c_int64, _I32, _I32]
    lib.sedgewick_header.restype = ctypes.c_int64
    lib.sedgewick_header.argtypes = [ctypes.c_char_p, _I64, _I64]
    lib.sedgewick_edges.restype = ctypes.c_int64
    lib.sedgewick_edges.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, _I32, _I32,
    ]


_LIB = NativeLib(
    src=native_source("graph_gen.cpp"),
    so=os.path.join(BUILD_DIR, "libgraph_gen.so"),
    register=_register,
)


def native_available() -> bool:
    return _LIB.available()


def _lib() -> ctypes.CDLL:
    lib = _LIB.load()
    if lib is None:
        raise RuntimeError("native graph_gen unavailable")
    return lib


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def rmat_edges_native(
    scale: int,
    edge_factor: int = 16,
    *,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 1,
    permute_labels: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Native R-MAT: ``(src, dst)`` int32 arrays of the undirected endpoint
    pairs.  Its counter-based generator gives a different (statistically
    equivalent) graph than the NumPy one for the same seed."""
    m = edge_factor << scale
    src = np.empty(m, dtype=np.int32)
    dst = np.empty(m, dtype=np.int32)
    _lib().rmat_edges(scale, m, a, b, c, seed, int(permute_labels), src, dst)
    return src, dst


def sort_rank_pairs_native(key_hi, key_lo) -> tuple[np.ndarray, np.ndarray]:
    """Stable sort by ``(key_hi, key_lo)``: ``(order, rank within key_hi)``."""
    key_hi, key_lo = _i32(key_hi), _i32(key_lo)
    n = key_hi.shape[0]
    order = np.empty(n, dtype=np.int32)
    rank = np.empty(n, dtype=np.int32)
    _lib().sort_rank_pairs(n, key_hi, key_lo, order, rank)
    return order, rank


def gather_i32_native(table, idx) -> np.ndarray:
    table, idx = _i32(table), _i32(idx)
    out = np.empty(idx.shape[0], dtype=np.int32)
    _lib().gather_i32(idx.shape[0], table, idx, out)
    return out


def scatter_i32_native(out: np.ndarray, idx, val) -> None:
    idx, val = _i32(idx), _i32(val)
    assert out.dtype == np.int32 and out.flags.c_contiguous
    _lib().scatter_i32(idx.shape[0], idx, val, out)


def slot_assign_native(base, stride, idx, rank) -> np.ndarray:
    base, stride, idx, rank = _i32(base), _i32(stride), _i32(idx), _i32(rank)
    out = np.empty(idx.shape[0], dtype=np.int32)
    _lib().slot_assign_i32(idx.shape[0], base, stride, idx, rank, out)
    return out


def rank_by_count_native(key, nk: int) -> np.ndarray:
    """rank[i] = number of earlier records with the same key."""
    key = _i32(key)
    out = np.empty(key.shape[0], dtype=np.int32)
    _lib().rank_by_count(key.shape[0], key, int(nk), out)
    return out


def bincount_i32_native(key, nk: int) -> np.ndarray:
    key = _i32(key)
    out = np.empty(int(nk), dtype=np.int32)
    _lib().bincount_i32(key.shape[0], key, int(nk), out)
    return out


def csr_fill_native(srcn, dstn, slotv, nk: int):
    """Counting-sort CSR: ``(indptr int32[nk+2], adj_dst, adj_slot)``
    grouped by ``srcn`` with arbitrary within-row order."""
    srcn, dstn, slotv = _i32(srcn), _i32(dstn), _i32(slotv)
    n = srcn.shape[0]
    indptr = np.empty(int(nk) + 2, dtype=np.int32)
    adj_dst = np.empty(n, dtype=np.int32)
    adj_slot = np.empty(n, dtype=np.int32)
    _lib().csr_fill(n, int(nk), srcn, dstn, slotv, indptr, adj_dst, adj_slot)
    return indptr, adj_dst, adj_slot


def mark_u8_native(idx, used: np.ndarray) -> None:
    idx = _i32(idx)
    assert used.dtype == np.uint8 and used.flags.c_contiguous
    _lib().mark_u8(idx.shape[0], idx, used)


def pad_identity_native(perm: np.ndarray, used: np.ndarray) -> None:
    """In-place identity-first bijection completion (``used`` updated)."""
    assert perm.dtype == np.int32 and perm.flags.c_contiguous
    assert used.dtype == np.uint8 and used.flags.c_contiguous
    _lib().pad_identity_i32(perm.shape[0], perm, used)


def sort_edges_by_dst_native(src, dst) -> tuple[np.ndarray, np.ndarray]:
    """Stable sort of the (src, dst) pair arrays by (dst, src), in place on
    contiguous int32 copies; returns the sorted arrays."""
    src, dst = _i32(src).copy(), _i32(dst).copy()
    _lib().sort_edges_by_dst(src.shape[0], src, dst)
    return src, dst


def read_sedgewick_native(path: str) -> tuple[int, np.ndarray, np.ndarray]:
    """Parse a Sedgewick graph file: ``(V, src, dst)`` of the undirected
    pairs (the caller bi-directs)."""
    lib = _lib()
    v = np.zeros(1, dtype=np.int64)
    e = np.zeros(1, dtype=np.int64)
    if lib.sedgewick_header(path.encode(), v, e) != 0:
        raise ValueError(f"malformed Sedgewick header in {path!r}")
    num_v, num_e = int(v[0]), int(e[0])
    src = np.empty(num_e, dtype=np.int32)
    dst = np.empty(num_e, dtype=np.int32)
    if lib.sedgewick_edges(path.encode(), num_v, num_e, src, dst) != num_e:
        raise ValueError(f"malformed Sedgewick edge list in {path!r}")
    return num_v, src, dst
