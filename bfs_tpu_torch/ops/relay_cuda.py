"""Kernel wrappers of the relay superstep: the port's counterpart of
``bfs_tpu.ops.relay_pallas``.

Every wrapper takes the plain PyTorch version (:mod:`.relay`,
:mod:`.relay_elem`, :mod:`.relay_mxu`) for a tensor on the CPU and launches
its hand-written CUDA kernel (``csrc/relay_kernels.cu``,
``csrc/relay_elem_kernels.cu``, ``csrc/relay_mxu_kernels.cu``) for a tensor
on a card; any other device raises, and a CUDA tensor never
reaches the plain version.  Each kernel has a launch count in
:data:`LAUNCHES`, raised by one (:func:`count_launch`) where the wrapper
launches it and nowhere else; a launch made while the calling thread
captures a CUDA graph (:func:`capturing`) goes into that capture's record
instead, since its kernels reach the card only when the graph is replayed.

  ======================  ================================================
  kernel                  replaces (bfs_tpu/ops/relay_pallas.py)
  ======================  ================================================
  benes_local_pass        _run_local_tile_major (K1), _run_pass local modes
  benes_outer_pass        _run_pass outer passes A/C (K2)
  class_rowmin            _class_tournament_call / rowmin_ranks_pallas (K3)
  packed_update           apply_relay_candidates_packed_pallas (K4)
  benes_elem_local_pass   _run_elem_pass local mode (K5)
  benes_elem_outer_stage  _run_elem_pass outer mode (K5)
  elem_route_gather       both _run_elem_pass networks (K5) and the XLA
                          broadcast between them, inside the level loop;
                          the two K5 kernels build its index
  elem_frontier_interleave  the same route: the frontier as [vr, G] for
                          the gather's one-sector reads (G = 2 or 4)
  elem_rowmin_update      the XLA row-min and update of elem_superstep
                          (bfs_tpu/ops/relay_elem.py)
  mxu_expand              expand_frontier_mxu (K6, bfs_tpu/ops/relay_mxu.py)
  loop_control            the while-loop condition of the reference's fused
                          programs (XLA; bfs_tpu/models/bfs.py)
  ======================  ================================================

The wrappers of the kernels that run inside the level loop take an
optional control block ``ctl`` (:mod:`.control`): the kernel then returns at
entry when the superstep is not live, and the two update kernels read the
level they stamp from it and raise its flag.  Without one the kernel is
always live, as outside the block loop.

The tree axis: the wrappers of the lock-step batch's kernels
(:func:`apply_benes` and its passes, :func:`rowmin_ranks`,
:func:`apply_relay_candidates_packed`, :func:`expand_frontier_mxu`) take
their per-tree word arrays as ``[n]`` (one search) or ``[S, n]`` (S trees,
:meth:`~bfs_tpu_torch.models.bfs.RelayEngine.run_multi_device`), with the
masks, valid words, tiles and tables shared, and launch ONE kernel for
all S trees (the tree index a grid axis), counted once whatever S is.  The
plain versions take the same shapes.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from typing import NamedTuple

import numpy as np
import torch

from ..graph.relay import StageSpec
from ..utils import cuda_build
from . import relay as R
from . import relay_elem as RE
from . import relay_mxu as RM
from . import control as C
from .packed import level_word

LAUNCHES = {
    "benes_local_pass": 0,
    "benes_outer_pass": 0,
    "class_rowmin": 0,
    "packed_update": 0,
    "benes_elem_local_pass": 0,
    "benes_elem_outer_stage": 0,
    "elem_route_gather": 0,
    "elem_frontier_interleave": 0,
    "elem_rowmin_update": 0,
    "mxu_expand": 0,
    "loop_control": 0,
}

#: Shared-memory tile of the local pass, in words: a power of two in
#: [MIN_TILE_WORDS, MAX_TILE_WORDS] (8 KB to 64 KB), chosen so a network
#: spreads over about 128 blocks; a smaller network is one tile.  At the
#: largest tile a block holds the tile and two ring slots of stage masks of
#: one tile each (192 KB of the 227 KB of shared memory).
MIN_TILE_WORDS = 1 << 11
MAX_TILE_WORDS = 1 << 14
TARGET_BLOCKS = 128
#: ``benes_outer_pass``'s geometry (csrc/relay_kernels.cu): outer stages one
#: launch applies at most (kMaxOuterStages) and words at most
#: (kOuterWords) in one unit of work.  A unit's rows start at OUTER_ROW_WORDS
#: words (128 B) and halve, down to OUTER_MIN_ROW_WORDS (one 32 B sector),
#: while there are fewer than OUTER_TARGET_UNITS units.
OUTER_MAX_STAGES = 8
OUTER_MAX_WORDS = 2048
OUTER_ROW_WORDS = 32
OUTER_MIN_ROW_WORDS = 8
OUTER_TARGET_UNITS = 256
#: The lock-step batch's local-pass tile, in words, at most (32 KB): a
#: block of the batch's local pass (``benes_local_group``) takes one tile
#: for a group of trees, as many tiles as leave room for two ring slots
#: (four at this tile); the launcher picks the group (:func:`batch_groups`).
#: Chosen with ``tools/benes_pass_sweep.py --only batch``; PERF.md records
#: the sweep.
BATCH_TILE_WORDS = 1 << 13
#: Shared-memory tile of the elem local pass, in elements (128 KB); a
#: smaller network is one tile.
MAX_TILE_ELEMS = 1 << 15
#: ``benes_elem_local_pass``'s geometry (csrc/relay_elem_kernels.cu): a
#: thread holds 2^ELEM_REG_BITS elements in registers (kElemRegBits), and a
#: ring of ELEM_SLOTS shared-memory slots holds stage mask slabs
#: (kElemSlots), so a register phase takes at most that many stages.
ELEM_REG_BITS = 5
ELEM_SLOTS = 16


_launch_lock = threading.Lock()  # guards LAUNCHES: serve threads launch too
_capture = threading.local()  # .record: the launches of this thread's capture


def reset_launches() -> None:
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def count_launch(name: str) -> None:
    """One launch of kernel ``name`` by its wrapper: into :data:`LAUNCHES`,
    or into the record of the capture this thread is in."""
    record = getattr(_capture, "record", None)
    if record is not None:
        record[name] = record.get(name, 0) + 1
        return
    with _launch_lock:
        LAUNCHES[name] += 1


def add_launches(counts: dict[str, int]) -> None:
    """The launches of a replayed graph, by kernel."""
    with _launch_lock:
        for name, n in counts.items():
            LAUNCHES[name] += n


@contextlib.contextmanager
def capturing():
    """Launches counted on this thread inside the block go into the dict
    it yields, not into :data:`LAUNCHES` (a CUDA graph being captured);
    other threads count as usual."""
    outer = getattr(_capture, "record", None)
    record: dict[str, int] = {}
    _capture.record = record
    try:
        yield record
    finally:
        _capture.record = outer


_VP = ctypes.c_void_p
_LL = ctypes.c_longlong
_INT = ctypes.c_int


def _register(lib: ctypes.CDLL) -> None:
    lib.benes_local_pass.restype = _INT
    lib.benes_local_pass.argtypes = [
        _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _INT, _LL, _INT, _INT, _LL, _VP, _VP,
    ]
    lib.benes_outer_pass.restype = _INT
    lib.benes_outer_pass.argtypes = [
        _VP, _VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT, _LL, _INT, _LL, _VP, _VP,
    ]
    lib.local_pass_group.restype = _INT
    lib.local_pass_group.argtypes = [_INT, _INT]
    lib.outer_pass_group.restype = _INT
    lib.outer_pass_group.argtypes = [_INT]
    lib.class_rowmin.restype = _INT
    lib.class_rowmin.argtypes = [_VP, _VP, _VP, _VP, _INT, _LL, _INT, _INT, _LL, _LL, _VP, _VP]
    lib.rowmin_group.restype = _INT
    lib.rowmin_group.argtypes = [_INT, _INT]
    lib.packed_update.restype = _INT
    lib.packed_update.argtypes = [
        _VP, _VP, _VP, _VP, _VP, _LL, _INT, _LL, _LL, _LL, ctypes.c_uint, _VP, _VP,
    ]
    lib.loop_control.restype = _INT
    lib.loop_control.argtypes = [_VP, _VP]


def _register_elem(lib: ctypes.CDLL) -> None:
    lib.benes_elem_local_pass.restype = _INT
    lib.benes_elem_local_pass.argtypes = [
        _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _INT, _VP, _VP, _INT, _INT, _LL, _INT, _VP,
    ]
    lib.benes_elem_outer_stage.restype = _INT
    lib.benes_elem_outer_stage.argtypes = [_VP, _VP, _VP, _INT, _LL, _LL, _INT, _VP]
    lib.elem_route_gather.restype = _INT
    lib.elem_route_gather.argtypes = [_VP, _VP, _VP, _LL, _LL, _INT, _INT, _VP, _VP]
    lib.elem_frontier_interleave.restype = _INT
    lib.elem_frontier_interleave.argtypes = [_VP, _VP, _LL, _INT, _VP, _VP]
    lib.elem_rowmin_update.restype = _INT
    lib.elem_rowmin_update.argtypes = [
        _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _INT, _LL, _INT, _LL, _LL, _LL,
        ctypes.c_uint, _VP, _VP,
    ]


def _register_mxu(lib: ctypes.CDLL) -> None:
    lib.mxu_expand.restype = _INT
    lib.mxu_expand.argtypes = [
        _VP, _VP, _VP, _VP, _VP, _LL, _VP, _LL, _INT, _INT, _LL, _LL, _INT, _VP, _VP,
    ]


SOURCES = {
    "relay_kernels": cuda_build.csrc("relay_kernels.cu"),
    "relay_elem_kernels": cuda_build.csrc("relay_elem_kernels.cu"),
    "relay_mxu_kernels": cuda_build.csrc("relay_mxu_kernels.cu"),
}


def kernels() -> ctypes.CDLL:
    """Build (at first use) and load the relay kernels."""
    return cuda_build.load("relay_kernels", SOURCES["relay_kernels"], _register)


def elem_kernels() -> ctypes.CDLL:
    """Build (at first use) and load the element-major relay kernels."""
    return cuda_build.load(
        "relay_elem_kernels", SOURCES["relay_elem_kernels"], _register_elem
    )


def mxu_kernels() -> ctypes.CDLL:
    """Build (at first use) and load the MXU expansion kernel."""
    return cuda_build.load(
        "relay_mxu_kernels", SOURCES["relay_mxu_kernels"], _register_mxu
    )


def build_all() -> None:
    """Build every kernel library at once (one nvcc each, started
    together), then load them."""
    cuda_build.build(SOURCES)
    kernels()
    elem_kernels()
    mxu_kernels()


def _on_card(*tensors: torch.Tensor) -> bool:
    """False for CPU tensors (plain version), True for CUDA tensors (the
    kernel); raises on a mix or on any other device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"relay kernels take CPU or CUDA tensors, got {sorted(kinds)}")


def _check_words(name: str, t: torch.Tensor, numel: int | None = None) -> None:
    if t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous int32 tensor")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{name}: expected {numel} words, got {t.numel()}")


def _check_aligned(name: str, t: torch.Tensor) -> None:
    """For 16-byte loads and stores: a 16-byte aligned start and rows (the
    last axis) of a multiple of 4 words."""
    if t.data_ptr() % 16 or t.shape[-1] % 4:
        raise ValueError(f"{name}: expected a 16-byte aligned tensor of a multiple of 4 words")


#: Trees one launch takes at most (``packed_update`` puts them in grid rows).
MAX_TREES = 65535


def _trees(name: str, t: torch.Tensor, n: int) -> int:
    """The tree count of a per-tree word array: 1 for ``int32[n]`` (one
    search), S for ``int32[S, n]`` (contiguous, so tree i starts at word
    ``i * n``); raises on any other shape."""
    _check_words(name, t)
    if t.dim() == 1 and t.shape[0] == n:
        return 1
    if t.dim() == 2 and t.shape[1] == n and 1 <= t.shape[0] <= MAX_TREES:
        return int(t.shape[0])
    raise ValueError(f"{name}: expected int32[{n}] or int32[trees, {n}], got {tuple(t.shape)}")


def _like(name: str, t: torch.Tensor, *shape: int) -> None:
    """A contiguous int32 array of exactly ``shape``."""
    _check_words(name, t)
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected int32{list(shape)}, got {tuple(t.shape)}")


def _rows(name: str, t: torch.Tensor, *shape: int) -> int:
    """An int32 array of exactly ``shape`` with contiguous rows, which may
    be views of wider rows (the MXU arm's batched candidates, ``[S, vtp]``
    cut to ``[S, cols]``): its row stride in words."""
    wide = t.dim() == 2 and t.stride(0) < t.shape[1] and t.shape[0] > 1
    if t.dtype != torch.int32 or tuple(t.shape) != shape or t.stride(-1) != 1 or wide:
        raise ValueError(f"{name}: expected int32{list(shape)} with contiguous rows, got "
                         f"{t.dtype} {tuple(t.shape)} strides {t.stride()}")
    return t.stride(0) if t.dim() == 2 else t.shape[0]


def _call(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _ptr(t: torch.Tensor, word_offset: int = 0) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() + 4 * word_offset)


def _ctl(ctl: torch.Tensor | None) -> ctypes.c_void_p:
    """The control block's pointer (null without one: always live)."""
    if ctl is None:
        return ctypes.c_void_p(None)
    if ctl.dtype != torch.int32 or not ctl.is_contiguous() or ctl.numel() != C.WORDS:
        raise ValueError(f"ctl: expected a contiguous int32[{C.WORDS}] control block")
    return _ptr(ctl)


# ------------------------------------------------------------------ Beneš --

def tile_words_for(n: int) -> int:
    """The local pass's tile (words) for a size-``n`` network."""
    nw = n // 32
    t = 1 << max(nw // TARGET_BLOCKS, 1).bit_length() - 1
    return min(max(t, MIN_TILE_WORDS), MAX_TILE_WORDS, nw)


def batch_tile_words(n: int) -> int:
    """The local pass's tile (words) for a lock-step batch (``[S, n/32]``
    words, S > 1) on a size-``n`` network: the single search's, at most
    :data:`BATCH_TILE_WORDS`."""
    return min(tile_words_for(n), BATCH_TILE_WORDS)


def batch_groups(trees: int, tile_words: int, lib=None) -> tuple[int, int]:
    """Trees one block of ``lib``'s (the built ``relay_kernels.cu``'s)
    local pass on tiles of ``tile_words`` and outer pass takes on a batch of
    ``trees``, as its launchers choose them: ``(local, outer)``."""
    lib = kernels() if lib is None else lib
    return lib.local_pass_group(trees, tile_words), lib.outer_pass_group(trees)


def _split(table: tuple[StageSpec, ...], limit: int):
    """``(prefix, local, suffix)`` stage indices: the local run is every
    stage with ``d < limit`` (consecutive, in the middle of the network)."""
    local = [i for i, st in enumerate(table) if st.d < limit]
    assert local, "no local stages"
    lo, hi = local[0], local[-1] + 1
    assert local == list(range(lo, hi)), "local stages must be consecutive"
    return tuple(range(lo)), tuple(range(lo, hi)), tuple(range(hi, len(table)))


@functools.lru_cache(maxsize=16)
def split_passes(table: tuple[StageSpec, ...], n: int, tile_words: int | None = None):
    """``(prefix outer stages, local run, suffix outer stages, tile)``: the
    local run is every stage with ``d < 32 * tile`` (consecutive, in the
    middle of the network), the rest are outer stages.  The reference's
    ``split_passes`` with the card's shared-memory tile in place of its
    VMEM tile rows."""
    tile = tile_words_for(n) if tile_words is None else int(tile_words)
    nw = n // 32
    if tile <= 0 or tile & (tile - 1) or nw % tile:
        raise ValueError(f"tile of {tile} words does not divide the {nw}-word network")
    return (*_split(table, 32 * tile), tile)


@functools.lru_cache(maxsize=16)
def split_elem_passes(table: tuple[StageSpec, ...], n: int, tile: int | None = None):
    """The elem network's ``(prefix, local, suffix, tile)``: the local run is
    every stage with ``d < tile`` elements.  The counterpart of the
    reference's ``elem_pass_static`` with the card's element tile
    (:data:`MAX_TILE_ELEMS`, or the whole network when it is smaller) in
    place of ``TILE_ROWS_E`` rows of 128 lanes."""
    tile = min(MAX_TILE_ELEMS, n) if tile is None else int(tile)
    if tile <= 0 or tile & (tile - 1) or n % tile:
        raise ValueError(f"tile of {tile} elements does not divide the {n}-element network")
    return (*_split(table, tile), tile)


@functools.lru_cache(maxsize=16)
def _local_args(stages: tuple[StageSpec, ...]):
    """Host arrays of the local run's stage table (kept alive by the cache):
    offsets, distances, compact flags, and each stage's nonzero stored
    words ``[lo, hi)``."""
    offsets = np.array([st.offset for st in stages], dtype=np.int64)
    dists = np.array([st.d for st in stages], dtype=np.int32)
    compact = np.array([int(st.compact) for st in stages], dtype=np.int32)
    lo = np.array([st.lo for st in stages], dtype=np.int32)
    hi = np.array([st.hi for st in stages], dtype=np.int32)
    return offsets, dists, compact, lo, hi


def benes_local_pass(
    x_in: torch.Tensor, masks: torch.Tensor, stages: tuple[StageSpec, ...],
    n: int, tile_words: int, out: torch.Tensor | None = None,
    ctl: torch.Tensor | None = None,
) -> torch.Tensor:
    """Apply a consecutive run of stages with ``d < 32 * tile_words`` (one
    shared-memory tile per block; a stage is skipped on a tile outside its
    nonzero range ``StageSpec.lo/hi``) to ``x_in``, ``[n/32]`` or
    ``[S, n/32]`` (one launch for the S trees).  ``out`` may alias ``x_in``."""
    if not _on_card(x_in, masks):
        return R.apply_benes_std(x_in, masks, stages, n)
    return launch_local_pass(kernels(), x_in, masks, stages, n, tile_words, out, ctl)


def launch_local_pass(lib, x_in, masks, stages, n, tile_words, out=None,
                      ctl=None) -> torch.Tensor:
    """:func:`benes_local_pass` on the card, through ``lib`` (the built
    ``relay_kernels.cu``, or a copy of it with other constants)."""
    nw = n // 32
    trees = _trees("x_in", x_in, nw)
    _check_words("masks", masks)
    if any(st.d >= 32 * tile_words for st in stages):
        raise ValueError("a local stage spans more than one tile")
    out = torch.empty_like(x_in) if out is None else out
    _like("out", out, *x_in.shape)
    offsets, dists, compact, lo, hi = _local_args(tuple(stages))
    rc = lib.benes_local_pass(
        _ptr(x_in), _ptr(out), _ptr(masks),
        offsets.ctypes.data_as(_VP), dists.ctypes.data_as(_VP),
        compact.ctypes.data_as(_VP), lo.ctypes.data_as(_VP), hi.ctypes.data_as(_VP),
        len(stages), nw, tile_words, trees, nw, _ctl(ctl), _stream(),
    )
    count_launch("benes_local_pass")
    _call(rc, "benes_local_pass")
    return out


class OuterRun(NamedTuple):
    """One ``benes_outer_pass`` launch: table indices of its stages (in
    network order), their word-distance bits ``[b0, b0 + k)``, the words of
    a unit's rows and the number of units (a block each)."""

    stages: tuple[int, ...]
    b0: int
    k: int
    row_words: int
    units: int


def outer_geometry(
    dists: tuple[int, ...], n: int, max_words: int = OUTER_MAX_WORDS,
) -> tuple[int, int, int, int]:
    """``(b0, k, row_words, units)`` of one fused outer pass over stages of
    element distances ``dists``: word distances ``2^b`` for the ``k``
    consecutive bits ``b`` in ``[b0, b0 + k)``, each once.  A unit holds
    ``row_words << k`` words, at most ``max_words`` (the kernel's
    ``kOuterWords``): ``2^k`` rows of ``row_words`` consecutive words (at
    most ``2^b0``), one per combination of those bits; the units partition
    the words."""
    nw = n // 32
    if any(d < 32 or d & (d - 1) for d in dists):
        raise ValueError(f"outer stages pair whole words at power-of-two distances, got {dists}")
    bits = sorted((d >> 5).bit_length() - 1 for d in dists)
    b0, k = bits[0], len(bits)
    if bits != list(range(b0, b0 + k)):
        raise ValueError(f"an outer pass takes consecutive distinct word-distance bits, got {bits}")
    if k > OUTER_MAX_STAGES or (1 << (b0 + k)) > nw:
        raise ValueError(f"{k} outer stages from bit {b0} do not fit one pass of {nw} words")
    row = min(OUTER_ROW_WORDS, 1 << b0, max_words >> k)
    while nw // (row << k) < OUTER_TARGET_UNITS and row > OUTER_MIN_ROW_WORDS:
        row //= 2
    return b0, k, row, nw // (row << k)


@functools.lru_cache(maxsize=32)
def outer_plan(table: tuple[StageSpec, ...], stages: tuple[int, ...], n: int):
    """The ``benes_outer_pass`` launches of one side's outer stages
    (``stages``: table indices in network order, the prefix or the suffix
    of :func:`split_passes`): runs of at most :data:`OUTER_MAX_STAGES`
    consecutive stages, one :class:`OuterRun` each."""
    runs = []
    for i in range(0, len(stages), OUTER_MAX_STAGES):
        run = tuple(stages[i : i + OUTER_MAX_STAGES])
        runs.append(OuterRun(run, *outer_geometry(tuple(table[j].d for j in run), n)))
    return tuple(runs)


@functools.lru_cache(maxsize=32)
def _outer_args(stages: tuple[StageSpec, ...], b0: int):
    """Host arrays of one outer pass's stage table (kept alive by the cache)."""
    offsets = np.array([st.offset for st in stages], dtype=np.int64)
    bits = np.array([(st.d >> 5).bit_length() - 1 - b0 for st in stages], dtype=np.int32)
    compact = np.array([int(st.compact) for st in stages], dtype=np.int32)
    return offsets, bits, compact


def benes_outer_pass(
    x_in: torch.Tensor, masks: torch.Tensor, stages: tuple[StageSpec, ...],
    n: int, out: torch.Tensor | None = None, ctl: torch.Tensor | None = None,
) -> torch.Tensor:
    """Apply a run of outer stages of one side of a network (word distances
    ``2^b`` for consecutive bits ``b``, each once, at most
    :data:`OUTER_MAX_STAGES`) in one launch, to ``[n/32]`` or ``[S, n/32]``
    words.  ``out`` may alias ``x_in``."""
    if not _on_card(x_in, masks):
        return R.apply_benes_std(x_in, masks, stages, n)
    return launch_outer_pass(kernels(), x_in, masks, stages, n, out, ctl=ctl)


def launch_outer_pass(lib, x_in, masks, stages, n, out=None,
                      max_words: int = OUTER_MAX_WORDS, ctl=None) -> torch.Tensor:
    """:func:`benes_outer_pass` on the card, through ``lib`` (the built
    ``relay_kernels.cu``, or a copy of it with other constants, whose
    ``kOuterWords`` is ``max_words``)."""
    nw = n // 32
    trees = _trees("x_in", x_in, nw)
    _check_words("masks", masks)
    b0, k, row, _ = outer_geometry(tuple(st.d for st in stages), n, max_words)
    out = torch.empty_like(x_in) if out is None else out
    _like("out", out, *x_in.shape)
    offsets, bits, compact = _outer_args(tuple(stages), b0)
    rc = lib.benes_outer_pass(
        _ptr(x_in), _ptr(out), _ptr(masks), offsets.ctypes.data_as(_VP),
        bits.ctypes.data_as(_VP), compact.ctypes.data_as(_VP), len(stages), b0, k,
        row.bit_length() - 1, nw, trees, nw, _ctl(ctl), _stream(),
    )
    count_launch("benes_outer_pass")
    _call(rc, "benes_outer_pass")
    return out


def apply_benes(
    words: torch.Tensor, masks: torch.Tensor, table: tuple[StageSpec, ...],
    n: int, out: torch.Tensor | None = None, ctl: torch.Tensor | None = None,
) -> torch.Tensor:
    """The whole routed network on ``[n/32]`` or ``[S, n/32]`` words: the
    outer prefix (one fused pass per run of :func:`outer_plan`), one local
    pass, the outer suffix, each one launch for all S trees (the plain
    version on the CPU).  A batch of S > 1 trees splits the network at its
    own tile (:func:`batch_tile_words`)."""
    if not _on_card(words, masks):
        return R.apply_benes_std(words, masks, table, n)
    batch = words.dim() == 2 and words.shape[0] > 1
    pre, local, suf, tile = split_passes(table, n, batch_tile_words(n) if batch else None)
    out = torch.empty_like(words) if out is None else out
    src = words
    for run in outer_plan(table, pre, n):
        benes_outer_pass(src, masks, tuple(table[i] for i in run.stages), n, out=out, ctl=ctl)
        src = out
    benes_local_pass(src, masks, tuple(table[i] for i in local), n, tile, out=out, ctl=ctl)
    for run in outer_plan(table, suf, n):
        benes_outer_pass(out, masks, tuple(table[i] for i in run.stages), n, out=out, ctl=ctl)
    return out


# ---------------------------------------------------------------- row-min --

ROWMIN_THREADS = 256
ROWMIN_WARPS = ROWMIN_THREADS // 32
#: ``elem_rowmin_update``'s table: a rank-major class's rows are halved into
#: more chunks (at most one per warp of a block) while a chunk holds more
#: rows than this.
ROWMIN_CHUNK_ROWS = 32
#: ``elem_rowmin_update``'s table: vertex-major classes at least this many
#: bits wide take a block per vertex; narrower ones a warp per vertex.
ROWMIN_WIDE_BITS = 4096
#: ``class_rowmin``'s table: a rank-major class's rows are halved into more
#: chunks while a chunk holds more rows than CLASS_CHUNK_ROWS, up to
#: CLASS_MAX_CHUNKS chunks (a block then covers ROWMIN_THREADS / 32 = 8
#: column words: whole 32-byte sectors); vertex-major classes at least
#: CLASS_WIDE_BITS wide take a block per vertex, narrower ones a warp.
#: Chosen with ``tools/rowmin_sweep.py``; PERF.md records the sweep.
CLASS_CHUNK_ROWS = 16
CLASS_MAX_CHUNKS = 32
CLASS_WIDE_BITS = 32768


def rowmin_chunks(width: int, rows: int | None = None, most: int = ROWMIN_WARPS
                  ) -> tuple[int, int]:
    """``(chunks, rows per chunk)`` of a rank-major class: chunks a power of
    two up to ``most``, doubled while a chunk would hold more than ``rows``
    rows (:data:`ROWMIN_CHUNK_ROWS` by default)."""
    rows = ROWMIN_CHUNK_ROWS if rows is None else rows
    chunks = 1
    while chunks < most and -(-width // chunks) > rows:
        chunks *= 2
    return chunks, -(-width // chunks)


def rowmin_depth(row) -> int:
    """Steps of the longest dependent chain in a block of a work table row:
    the rows of a rank-major chunk, the 128-word steps of a warp's or the
    1,024-word steps of a block's vertex-major row, none for the tail."""
    kind, width, rows = row[0], row[4], row[6]
    return {0: rows, 1: -(-width // 4096), 3: -(-width // 32768)}.get(kind, 0)


class RowminTable(NamedTuple):
    """``class_rowmin``'s work table on its device, and what its launcher
    needs to know of it."""

    table: torch.Tensor  # int64 rows of (kind, va, count, sa/32, width, chunks, rows, block0)
    blocks: int  # table blocks in all
    vertex_major: bool  # any vertex-major row (16-byte loads)
    planes: int  # rank planes of the longest rank-major chunk: bits of a rank within it


@functools.lru_cache(maxsize=8)
def rowmin_items(in_classes: tuple, vr: int, device: str) -> RowminTable:
    """Device work table of :func:`rowmin_ranks`: int64 rows of (kind, va,
    count, sa/32, width, chunks, rows per chunk, first block) — kind 0
    rank-major (a block covers ``ROWMIN_THREADS / chunks`` column words
    with all their chunks of rows, a thread per word and chunk), 1
    vertex-major (a warp per vertex), 3 vertex-major at least
    :data:`CLASS_WIDE_BITS` wide (a block per vertex), 2 the sentinel tail
    — the rows of the longest chains (:func:`rowmin_depth`) first, so that
    their blocks start first; with the total block count, whether any row
    is vertex-major, and the rank planes (bits of a rank within a chunk)
    of its longest rank-major chunk, which the kernel stages a tree's ranks
    in."""
    rows = []
    covered = 0
    for cs in sorted(in_classes, key=lambda c: c.va):
        assert cs.va == covered, "in_classes must tile the vertex space"
        chunks, per = 1, cs.width
        if cs.vertex_major and cs.width >= CLASS_WIDE_BITS:
            kind, blocks = 3, cs.count
        elif cs.vertex_major:
            kind, blocks = 1, -(-cs.count // ROWMIN_WARPS)
        else:
            # The kernel writes a rank-major class's ranks as 16-byte quads
            # from va on, and reads its column words 32 vertices a word.
            assert cs.va % 32 == 0 and cs.count % 32 == 0, \
                f"rank-major class at va={cs.va} (count {cs.count}) not aligned to 32 vertices"
            chunks, per = rowmin_chunks(cs.width, CLASS_CHUNK_ROWS, CLASS_MAX_CHUNKS)
            kind, blocks = 0, -(-(cs.count // 32) // (ROWMIN_THREADS // chunks))
        if blocks:
            rows.append(((kind, cs.va, cs.count, cs.sa // 32, cs.width, chunks, per), blocks))
        covered = cs.vb
    if covered < vr:
        rows.append(((2, covered, vr - covered, 0, 0, 1, 0), -(-(vr - covered) // ROWMIN_THREADS)))
    rows.sort(key=lambda r: -rowmin_depth(r[0]))  # stable: classes in order within a depth
    table, block = [], 0
    for row, blocks in rows:
        table.append((*row, block))
        block += blocks
    planes = max([(r[6] - 1).bit_length() for r in table if r[0] == 0] or [0])
    return RowminTable(torch.tensor(table, dtype=torch.int64).reshape(-1, 8).to(device), block,
                       any(r[0] in (1, 3) for r in table), planes)


def rowmin_group(trees: int, planes: int, lib=None) -> int:
    """Trees one block of ``lib``'s (the built ``relay_kernels.cu``'s)
    ``class_rowmin`` takes on a batch of ``trees`` whose table needs
    ``planes`` rank planes, as its launcher chooses them."""
    lib = kernels() if lib is None else lib
    return lib.rowmin_group(trees, planes)


def rowmin_ranks(
    l1words: torch.Tensor, valid_words: torch.Tensor, in_classes, vr: int,
    out: torch.Tensor | None = None, ctl: torch.Tensor | None = None,
) -> torch.Tensor:
    """Min active rank per relabeled vertex (sentinel where none), of
    ``[nw]`` or ``[S, nw]`` slot words against the shared ``valid_words``
    (``int32[vr]`` or ``int32[S, vr]`` out): kernel ``class_rowmin`` on the
    card (one launch for the S trees; a block takes a work item for a group
    of :func:`rowmin_group` trees), :func:`.relay.rowmin_ranks` on the
    CPU."""
    if not _on_card(l1words, valid_words):
        return R.rowmin_ranks(l1words, valid_words, in_classes, vr)
    _check_words("valid_words", valid_words)
    nw = valid_words.numel()
    trees = _trees("l1words", l1words, nw)
    table, blocks, vertex_major, planes = rowmin_items(tuple(in_classes), int(vr),
                                                       str(l1words.device))
    if vertex_major:  # 16-byte loads, up to a 4-word boundary
        _check_aligned("l1words", l1words)
        _check_aligned("valid_words", valid_words)
    if out is None:
        out = torch.empty((*l1words.shape[:-1], vr), dtype=torch.int32, device=l1words.device)
    _like("out", out, *l1words.shape[:-1], vr)
    if blocks == 0:
        return out
    rc = kernels().class_rowmin(
        _ptr(l1words), _ptr(valid_words), _ptr(out), _VP(table.data_ptr()),
        table.shape[0], blocks, planes, trees, nw, vr, _ctl(ctl), _stream(),
    )
    count_launch("class_rowmin")
    _call(rc, "class_rowmin")
    return out


# ----------------------------------------------------------- state update --

def apply_relay_candidates_packed(
    state: R.PackedRelayState, rank_or_sent: torch.Tensor,
    fwords_out: torch.Tensor | None = None, ctl: torch.Tensor | None = None,
) -> R.PackedRelayState:
    """Packed state update (kernel ``packed_update`` on the card, updating
    ``state.packed`` in place; :func:`.relay.apply_relay_candidates_packed`
    on the CPU), of one search (``int32[vr]`` words and candidates,
    ``int32[vr/32]`` frontier words) or of S trees (``[S, vr]`` and
    ``[S, vr/32]``, one launch).  The returned ``changed`` is a device
    int32[1] flag, raised when any tree changed.  The candidates' rows may
    be views of wider rows (the MXU arm's ``[S, vtp]`` output cut to
    ``[S, vr]``).

    With a control block ``ctl`` (the block loop) the level is its LEVEL
    word, a superstep that is not LIVE changes nothing, the update raises
    the block's flag (``changed`` is returned as ``None``), and on both
    devices ``state.packed`` and ``fwords_out`` are written in place."""
    if not _on_card(state.packed, rank_or_sent):
        new = R.apply_relay_candidates_packed(state, rank_or_sent, ctl)
        if ctl is None:
            return new
        state.packed.copy_(new.packed)
        fwords = new.fwords if fwords_out is None else fwords_out.copy_(
            torch.where(ctl[C.LIVE] != 0, new.fwords, fwords_out))  # dead: not written
        C.raise_flag(ctl, new.changed)
        return new._replace(packed=state.packed, fwords=fwords, changed=None)
    vr = state.packed.shape[-1]
    trees = _trees("packed", state.packed, vr)
    cstride = _rows("rank_or_sent", rank_or_sent, *state.packed.shape)
    dev = state.packed.device
    fwords = (
        torch.empty((*state.packed.shape[:-1], vr // 32), dtype=torch.int32, device=dev)
        if fwords_out is None else fwords_out
    )
    _like("fwords_out", fwords, *state.packed.shape[:-1], vr // 32)
    if ctl is None:
        changed, level = torch.empty(1, dtype=torch.int32, device=dev), state.level + 1
        bits = level_word(level)
    else:  # the level and the flag live in the control block
        changed, level, bits = None, state.level, 0
    rc = kernels().packed_update(
        _ptr(state.packed), _ptr(rank_or_sent), _ptr(state.packed),
        _ptr(fwords), ctypes.c_void_p(None) if changed is None else _ptr(changed), vr,
        trees, vr, cstride, vr // 32, bits, _ctl(ctl), _stream(),
    )
    count_launch("packed_update")
    _call(rc, "packed_update")
    return R.PackedRelayState(state.packed, fwords, level, changed)


def loop_control(ctl: torch.Tensor) -> torch.Tensor:
    """The control step that ends each superstep of the block loop (kernel
    ``loop_control`` on the card, :func:`.control.loop_control` on the
    CPU), in place on ``ctl``."""
    if not _on_card(ctl):
        return C.loop_control(ctl)
    rc = kernels().loop_control(_ctl(ctl), _stream())
    count_launch("loop_control")
    _call(rc, "loop_control")
    return ctl


# ------------------------------------------------------- element-major (K5) --

def _check_elems(name: str, t: torch.Tensor, n: int, groups: int | None = None) -> int:
    """A contiguous int32[G, n] element array; returns G."""
    if t.dtype != torch.int32 or not t.is_contiguous() or t.dim() != 2 or t.shape[1] != n:
        raise ValueError(f"{name}: expected a contiguous int32[G, {n}] tensor")
    if groups is not None and t.shape[0] != groups:
        raise ValueError(f"{name}: expected {groups} groups, got {t.shape[0]}")
    return int(t.shape[0])


@functools.lru_cache(maxsize=64)
def elem_local_plan(bits: tuple[int, ...], lg_tile: int, reg_bits: int = ELEM_REG_BITS,
                    slots: int = ELEM_SLOTS) -> tuple[tuple[int, int], ...]:
    """``benes_elem_local_pass``'s register phases of a run of stages
    (``bits``: log2 of each stage's distance, in order) on tiles of
    ``2^lg_tile`` elements: ``(lo, end)`` per phase, whose stages
    ``[previous end, end)`` all have bits in the window ``[lo, lo +
    reg_bits)`` that a thread's registers span.  Each phase is the longest
    run of at most ``slots`` stages that one window covers (the lowest such
    window on a tie); windows lie in ``[0, max(lg_tile - reg_bits, 0)]``.
    A run of no stages is one empty phase (a copy)."""
    top = max(lg_tile - reg_bits, 0)
    if any(not 0 <= b < lg_tile for b in bits):
        raise ValueError(f"stage bits {bits} outside a tile of 2^{lg_tile} elements")
    phases, i = [], 0
    while i < len(bits):
        best = (0, 0)
        for lo in range(top + 1):
            k = 0
            while i + k < len(bits) and k < slots and lo <= bits[i + k] < lo + reg_bits:
                k += 1
            if k > best[1]:
                best = (lo, k)
        i += best[1]
        phases.append((best[0], i))
    return tuple(phases) or ((top, 0),)


def benes_elem_local_pass(
    x_in: torch.Tensor, masks: torch.Tensor, stages: tuple[StageSpec, ...],
    n: int, tile: int, out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Apply a consecutive run of stages with ``d < tile`` to int32[G, n]
    elements (a block per tile and group; the stages in registers, in the
    phases of :func:`elem_local_plan`).  ``out`` may alias ``x_in``."""
    if not _on_card(x_in, masks):
        return RE.apply_benes_elem(x_in, masks, stages, n)
    return launch_elem_local_pass(elem_kernels(), x_in, masks, stages, n, tile, out)


def launch_elem_local_pass(lib, x_in, masks, stages, n, tile, out=None,
                           reg_bits: int = ELEM_REG_BITS,
                           slots: int = ELEM_SLOTS) -> torch.Tensor:
    """:func:`benes_elem_local_pass` on the card, through ``lib`` (the built
    ``relay_elem_kernels.cu``, or a copy of it whose ``kElemRegBits`` and
    ``kElemSlots`` are ``reg_bits`` and ``slots``)."""
    groups = _check_elems("x_in", x_in, n)
    _check_words("masks", masks)
    if tile < 32 or tile > MAX_TILE_ELEMS or tile & (tile - 1) or n % tile:
        raise ValueError(f"tile of {tile} elements: a power of two in [32, {MAX_TILE_ELEMS}] "
                         f"dividing {n}")
    if any(st.d >= tile for st in stages):
        raise ValueError("a local stage spans more than one tile")
    if any(st.compact for st in stages) and tile < 64:
        raise ValueError("pair-compacted stages need a tile of at least 64 elements")
    out = torch.empty_like(x_in) if out is None else out
    _check_elems("out", out, n, groups)
    offsets, _, compact, lo, hi = _local_args(tuple(stages))
    bits = tuple(st.d.bit_length() - 1 for st in stages)
    lg_tile = tile.bit_length() - 1
    plan = elem_local_plan(bits, lg_tile, reg_bits, slots)
    phase_lo, phase_end = _plan_args(plan)
    rc = lib.benes_elem_local_pass(
        _ptr(x_in), _ptr(out), _ptr(masks),
        offsets.ctypes.data_as(_VP), _int_array(bits).ctypes.data_as(_VP),
        compact.ctypes.data_as(_VP), lo.ctypes.data_as(_VP), hi.ctypes.data_as(_VP),
        len(stages), phase_lo.ctypes.data_as(_VP), phase_end.ctypes.data_as(_VP),
        len(plan), groups, n, lg_tile, _stream(),
    )
    count_launch("benes_elem_local_pass")
    _call(rc, "benes_elem_local_pass")
    return out


@functools.lru_cache(maxsize=64)
def _int_array(values: tuple[int, ...]) -> np.ndarray:
    """A host int32 array of ``values``, kept alive by the cache."""
    return np.array(values, dtype=np.int32)


def _plan_args(plan: tuple[tuple[int, int], ...]):
    return _int_array(tuple(lo for lo, _ in plan)), _int_array(tuple(e for _, e in plan))


def benes_elem_outer_stage(
    x_in: torch.Tensor, masks: torch.Tensor, st: StageSpec, n: int,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Apply one stage to int32[G, n] elements, all groups in one launch.
    ``out`` may alias ``x_in``."""
    if not _on_card(x_in, masks):
        return RE.apply_benes_elem(x_in, masks, (st,), n)
    groups = _check_elems("x_in", x_in, n)
    _check_words("masks", masks)
    out = torch.empty_like(x_in) if out is None else out
    _check_elems("out", out, n, groups)
    rc = elem_kernels().benes_elem_outer_stage(
        _ptr(x_in), _ptr(out), _ptr(masks, st.offset), groups, n, st.d,
        int(st.compact), _stream(),
    )
    count_launch("benes_elem_outer_stage")
    _call(rc, "benes_elem_outer_stage")
    return out


def apply_benes_elem(
    x: torch.Tensor, masks: torch.Tensor, table: tuple[StageSpec, ...],
    n: int, out: torch.Tensor | None = None,
) -> torch.Tensor:
    """The whole routed network on int32[G, n] elements: outer prefix
    stages, one local pass, outer suffix stages (the plain version on the
    CPU).  ``out`` may alias ``x``."""
    if not _on_card(x, masks):
        return RE.apply_benes_elem(x, masks, table, n)
    pre, local, suf, tile = split_elem_passes(table, n)
    out = torch.empty_like(x) if out is None else out
    src = x
    for i in pre:
        benes_elem_outer_stage(src, masks, table[i], n, out=out)
        src = out
    benes_elem_local_pass(src, masks, tuple(table[i] for i in local), n, tile, out=out)
    for i in suf:
        benes_elem_outer_stage(out, masks, table[i], n, out=out)
    return out


#: Group counts whose frontier the gather reads interleaved, int32[vr, G]:
#: one 8- or 16-byte load per slot for all its groups.
INTERLEAVED_GROUPS = (2, 4)


def elem_frontier_interleave(frontier: torch.Tensor, out: torch.Tensor | None = None,
                             lib=None, ctl: torch.Tensor | None = None) -> torch.Tensor:
    """The frontier int32[G, vr] as int32[vr, G] (G = 2 or 4): kernel
    ``elem_frontier_interleave`` on the card (through ``lib``, default the
    built ``relay_elem_kernels.cu``), :func:`.relay_elem.interleave_frontier`
    on the CPU."""
    if not _on_card(frontier):
        return RE.interleave_frontier(frontier)
    groups = _check_elems("frontier", frontier, frontier.shape[-1])
    if groups not in INTERLEAVED_GROUPS:
        raise ValueError(f"interleaving takes {INTERLEAVED_GROUPS} groups, got {groups}")
    vr = int(frontier.shape[1])
    out = torch.empty((vr, groups), dtype=torch.int32, device=frontier.device) if out is None else out
    if (out.dtype != torch.int32 or not out.is_contiguous() or tuple(out.shape) != (vr, groups)
            or out.data_ptr() % 16):
        raise ValueError(f"out: expected a 16-byte aligned contiguous int32[{vr}, {groups}] tensor")
    rc = (lib or elem_kernels()).elem_frontier_interleave(
        _ptr(frontier), _ptr(out), vr, groups, _ctl(ctl), _stream())
    count_launch("elem_frontier_interleave")
    _call(rc, "elem_frontier_interleave")
    return out


def elem_route_gather(
    frontier: torch.Tensor, src: torch.Tensor, out: torch.Tensor | None = None,
    frontier_t: torch.Tensor | None = None, ctl: torch.Tensor | None = None,
) -> torch.Tensor:
    """Routed L1 slot elements int32[G, n] of one elem superstep from the
    frontier int32[G, vr], through the composed route index ``src``
    (int32[n], -1 where a slot receives nothing;
    ``RelayEngine.route_index``): kernel ``elem_route_gather`` on the card
    (for G in :data:`INTERLEAVED_GROUPS` from ``frontier_t``, the frontier
    interleaved, made by ``elem_frontier_interleave`` when not given),
    :func:`.relay_elem.route_gather` on the CPU."""
    if not _on_card(frontier, src):
        return RE.route_gather(frontier, src)
    return launch_route_gather(elem_kernels(), frontier, src, out, frontier_t, ctl)


def launch_route_gather(lib, frontier, src, out=None, frontier_t=None,
                        ctl=None) -> torch.Tensor:
    """:func:`elem_route_gather` on the card, through ``lib`` (the built
    ``relay_elem_kernels.cu``, or a copy of it with other constants)."""
    groups = _check_elems("frontier", frontier, frontier.shape[-1])
    _check_words("src", src)
    _check_aligned("src", src)
    n = src.numel()
    out = torch.empty((groups, n), dtype=torch.int32, device=src.device) if out is None else out
    _check_elems("out", out, n, groups)
    _check_aligned("out", out)
    interleaved = groups in INTERLEAVED_GROUPS
    f = frontier
    if interleaved and frontier_t is None:
        f = elem_frontier_interleave(frontier, lib=lib, ctl=ctl)
    elif interleaved:
        f = frontier_t
        if (f.dtype != torch.int32 or not f.is_contiguous()
                or tuple(f.shape) != (frontier.shape[1], groups) or f.data_ptr() % 16):
            raise ValueError("frontier_t: expected the frontier as a 16-byte aligned "
                             f"contiguous int32[{frontier.shape[1]}, {groups}] tensor")
    rc = lib.elem_route_gather(
        _ptr(f), _ptr(src), _ptr(out), frontier.shape[1], n, groups, int(interleaved),
        _ctl(ctl), _stream(),
    )
    count_launch("elem_route_gather")
    _call(rc, "elem_route_gather")
    return out


#: ``elem_rowmin_update``'s work table travels in the kernel's parameters
#: (csrc/relay_elem_kernels.cu kMaxItems).
ELEM_MAX_ITEMS = 56
#: Passes a block of a one-chunk rank-major class makes, over 256
#: vertices each.
ELEM_NARROW_PASSES = 4


@functools.lru_cache(maxsize=8)
def elem_rowmin_items(in_classes: tuple, vr: int):
    """Work table of :func:`elem_rowmin_update`: int64 rows of (kind, va,
    count, sa, width, rank-plane offset, nb, chunks, rows per chunk,
    passes, first block) — kind 0 rank-major (a block makes ``passes``
    passes, each over ``ROWMIN_WARPS / chunks`` spans of 32 vertices, a
    warp per span and chunk of rows, as :func:`rowmin_chunks` splits
    them; one-chunk classes take :data:`ELEM_NARROW_PASSES` passes), 1
    vertex-major (a warp per vertex), 3 vertex-major at least
    :data:`ROWMIN_WIDE_BITS` rows wide (a block per vertex, a warp per chunk
    of rows, a multiple of 32), 2 the tail — on the host (the kernel takes
    it as parameters), and the block count per group."""
    offsets, _ = RE.rank_plane_layout(in_classes)
    rows = []
    block = 0
    covered = 0
    for cs in sorted(in_classes, key=lambda c: c.va):
        assert cs.va == covered, "in_classes must tile the vertex space"
        off, nb = offsets[cs.va]
        chunks, per, passes = 1, cs.width, 1
        if cs.vertex_major and cs.width >= ROWMIN_WIDE_BITS:
            chunks, per = ROWMIN_WARPS, -(-cs.width // (32 * ROWMIN_WARPS)) * 32
            kind, blocks = 3, cs.count
        elif cs.vertex_major:
            kind, blocks = 1, -(-cs.count // ROWMIN_WARPS)
        else:
            chunks, per = rowmin_chunks(cs.width)
            passes = ELEM_NARROW_PASSES if chunks == 1 else 1
            spans = -(-cs.count // 32)
            kind, blocks = 0, -(-spans // (ROWMIN_WARPS // chunks * passes))
        if blocks:
            rows.append((kind, cs.va, cs.count, cs.sa, cs.width, off, nb, chunks, per, passes,
                         block))
            block += blocks
        covered = cs.vb
    if covered < vr:
        rows.append((2, covered, vr - covered, 0, 0, 0, 0, 1, 0, 1, block))
        block += -(-(vr - covered) // ROWMIN_THREADS)
    return torch.tensor(rows, dtype=torch.int64).reshape(-1, 11), block


def elem_rowmin_update(
    l1: torch.Tensor, valid_words: torch.Tensor, state: RE.ElemState,
    in_classes, vr: int, frontier_out: torch.Tensor | None = None,
    ctl: torch.Tensor | None = None,
) -> RE.ElemState:
    """Row-min and bit-sliced update of one elem superstep.  On both devices
    ``state.visited``, ``state.dist_planes`` and ``state.rank_planes`` are
    updated IN PLACE and returned with the new frontier (written into
    ``frontier_out`` when given: the kernel does not read the frontier, so
    that may be ``state.frontier``).  On the card the kernel
    ``elem_rowmin_update`` does it and ``changed`` is a device int32[1]
    flag; on the CPU :func:`.relay_elem.rowmin_elem` then
    :func:`.relay_elem.apply_elem_found`, copied into the given tensors.
    With a control block ``ctl`` the level is its LEVEL word plus one, a
    superstep that is not LIVE changes nothing, and the update raises the
    block's flag (``changed`` is returned as ``None``)."""
    plane_offsets, pt = RE.rank_plane_layout(in_classes)
    if not _on_card(l1, valid_words, state.visited):
        found, rp = RE.rowmin_elem(l1, valid_words, in_classes, vr, plane_offsets, pt)
        new = RE.apply_elem_found(state, found, rp, in_classes, plane_offsets, ctl)
        state.visited.copy_(new.visited)
        state.dist_planes.copy_(new.dist_planes)
        state.rank_planes.copy_(new.rank_planes)
        frontier = new.frontier
        if frontier_out is not None:
            if ctl is not None:  # dead: not written
                frontier = torch.where(ctl[C.LIVE] != 0, frontier, frontier_out)
            frontier = frontier_out.copy_(frontier)
        changed = new.changed
        if ctl is not None:
            C.raise_flag(ctl, changed)
            changed = None
        return new._replace(
            visited=state.visited, frontier=frontier, dist_planes=state.dist_planes,
            rank_planes=state.rank_planes, changed=changed,
        )
    n = l1.shape[-1]
    groups = _check_elems("l1", l1, n)
    _check_aligned("l1", l1)  # 16-byte loads of vertex-major rows
    _check_words("valid_words", valid_words, n // 32)
    _check_elems("visited", state.visited, vr, groups)
    _check_elems("rank_planes", state.rank_planes, pt, groups)
    _check_words("dist_planes", state.dist_planes, RE.DIST_PLANES * groups * vr)
    table, blocks = elem_rowmin_items(tuple(in_classes), int(vr))
    if table.shape[0] > ELEM_MAX_ITEMS:
        raise ValueError(f"elem_rowmin_update: {table.shape[0]} work items exceed {ELEM_MAX_ITEMS}")
    frontier = torch.empty_like(state.visited) if frontier_out is None else frontier_out
    _check_elems("frontier_out", frontier, vr, groups)
    if ctl is None:
        changed, level = torch.empty(1, dtype=torch.int32, device=l1.device), state.level + 1
    else:  # the level and the flag live in the control block
        changed, level = None, state.level
    rc = elem_kernels().elem_rowmin_update(
        _ptr(l1), _ptr(valid_words), _ptr(state.visited), _ptr(frontier),
        _ptr(state.dist_planes), _ptr(state.rank_planes),
        ctypes.c_void_p(None) if changed is None else _ptr(changed),
        _VP(table.data_ptr()), table.shape[0], blocks, groups, n, vr, pt,
        0 if ctl is not None else level, _ctl(ctl), _stream(),
    )
    count_launch("elem_rowmin_update")
    _call(rc, "elem_rowmin_update")
    return RE.ElemState(
        state.visited, frontier, state.dist_planes, state.rank_planes, level, changed,
    )


# ------------------------------------------------------------ MXU arm (K6) --

#: ``mxu_expand``'s geometry (csrc/relay_mxu_kernels.cu): warps per block
#: (kWarps), blocks resident per SM (kBlocksPerSm: the grid is exactly
#: that many per SM, each warp walking batches of 32 tiles), and the most
#: reachable (frontier row, destination) bits a tile may hold and still
#: take the sparse path (kSparseMaxBits) rather than the tensor cores.
MXU_WARPS = 8
MXU_BLOCKS_PER_SM = 3
MXU_SPARSE_MAX_BITS = 256


def expand_frontier_mxu(
    fwords: torch.Tensor, tile_ops: tuple, *, rows: int, cols: int, rtp: int,
    vtp: int, ctl: torch.Tensor | None = None, out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Min original-id candidate per destination, int32[cols] (uint32
    patterns, -1 where none): kernel ``mxu_expand`` on the card, into an
    output cleared to 0xFFFFFFFF here;
    :func:`.relay_mxu.expand_frontier_mxu_plain` on the CPU.  ``fwords``
    ``[S, nfw]`` expands S trees' frontiers against the shared tiles in one
    launch (each live tile read once for the batch), into ``[S, cols]``.

    ``out`` (int32[vtp], a caller's view, e.g. one superblock's rows of the
    streamed arm's candidate grid with ``vtp = 16384``): the candidates are
    min-merged into it (the kernel's atomics;
    :func:`.relay_mxu.expand_into_plain` on the CPU) and it is neither
    allocated nor cleared here; ``out[:cols]`` is returned.  A slab's pad
    tiles (column ``vtp // 128``) add nothing: the kernel drops columns
    ``>= vtp // 128``, and on the CPU they read the zero frontier pad
    block."""
    tiles, row_idx, col_id, keys2d = tile_ops
    if out is not None:
        _trees("out", out, vtp)
    if not _on_card(fwords, tiles, row_idx, col_id, keys2d, *(() if out is None else (out,))):
        if out is not None:
            if ctl is not None and int(ctl[C.LIVE]) == 0:
                return out[..., :cols]  # a dead superstep writes nothing
            return RM.expand_into_plain(fwords, tile_ops, out, rows=rows, rtp=rtp,
                                        vtp=vtp)[..., :cols]
        return RM.expand_frontier_mxu_plain(
            fwords, tile_ops, rows=rows, cols=cols, rtp=rtp, vtp=vtp
        )
    ntp = int(tiles.shape[0])
    nfw = int(fwords.shape[-1])
    trees = _trees("fwords", fwords, nfw)
    if nfw > rtp // 32:
        raise ValueError(f"fwords: {nfw} words exceed the {rtp}-row space")
    _check_words("tiles", tiles, ntp * 128 * 4)
    if tiles.dim() != 3 or tuple(tiles.shape[1:]) != (128, 4) or tiles.data_ptr() % 16:
        raise ValueError("tiles: expected a 16-byte aligned int32[ntp, 128, 4] tensor")
    _check_words("row_idx", row_idx, ntp)
    _check_words("col_id", col_id, ntp)
    _check_words("keys2d", keys2d, rtp + 128)
    if keys2d.data_ptr() % 16:
        raise ValueError("keys2d: expected a 16-byte aligned tensor")
    dev = fwords.device
    if out is None:
        out = torch.full((*fwords.shape[:-1], vtp), -1, dtype=torch.int32, device=dev)
    _like("out", out, *fwords.shape[:-1], vtp)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = min(-(-ntp // (32 * MXU_WARPS)), sms * MXU_BLOCKS_PER_SM)
    rc = mxu_kernels().mxu_expand(
        _ptr(tiles), _ptr(row_idx), _ptr(col_id), _ptr(keys2d), _ptr(fwords),
        nfw, _ptr(out), ntp, vtp // 128, trees, nfw, vtp, blocks, _ctl(ctl), _stream(),
    )
    count_launch("mxu_expand")
    _call(rc, "mxu_expand")
    return out[..., :cols]
