"""Superstep checkpoints of the push/pull carry: the port of
``bfs_tpu.utils.checkpoint``.

A checkpoint is an ``.npz`` of the :class:`~bfs_tpu_torch.ops.relax.BfsState`
carry with the reference's keys and dtypes (``dist``, ``parent``,
``frontier``, ``level``, ``changed``, and ``meta_<k>`` for each metadata
value), so a checkpoint written by either package's runner resumes in the
other's.  Writes go to a same-directory temp file that is fsynced and then
renamed into place, so a kill mid-write never leaves a torn file under the
final name; loads reject a truncated or corrupt archive with
:class:`CheckpointError`.
"""

from __future__ import annotations

import glob
import logging
import os
import zipfile

import numpy as np
import torch

from ..graph.csr import INF_DIST
from ..ops.relax import BfsState

logger = logging.getLogger(__name__)


class CheckpointError(RuntimeError):
    """A checkpoint file is truncated or corrupt: delete it and resume from
    an earlier one (or from scratch)."""


def save_npz_atomic(path: str | os.PathLike, **arrays) -> str:
    """``np.savez`` to ``<path>.tmp.<pid>``, fsync, then ``os.replace`` into
    place.  Returns the final path (``.npz`` appended if missing)."""
    path = os.fspath(path)
    if not path.endswith(".npz"):
        path += ".npz"
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except FileNotFoundError:
            pass
        raise
    return path


def load_npz_strict(path: str | os.PathLike) -> dict[str, np.ndarray]:
    """An ``.npz`` as a dict; :class:`CheckpointError` on a truncated or
    corrupt archive, ``FileNotFoundError`` when there is none."""
    path = os.fspath(path)
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    try:
        with np.load(path, allow_pickle=False) as z:
            return {k: np.asarray(z[k]) for k in z.files}
    except (zipfile.BadZipFile, ValueError, KeyError, EOFError, OSError) as exc:
        raise CheckpointError(
            f"checkpoint {path!r} is truncated or corrupt ({exc!r}); "
            "delete it and resume from an earlier checkpoint"
        ) from exc


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_checkpoint(path: str | os.PathLike, state: BfsState, **meta) -> str:
    """Atomic dump of the carry; ``meta`` values (source, engine, ...) are
    stored as ``meta_<k>`` so a resume can refuse a checkpoint of another
    run configuration (:func:`load_latest_checkpoint`)."""
    if not isinstance(state, BfsState):
        raise ValueError("checkpoints hold the push/pull carry (BfsState)")
    return save_npz_atomic(
        path,
        dist=_host(state.dist),
        parent=_host(state.parent),
        frontier=_host(state.frontier),
        level=_host(state.level).astype(np.int32),
        changed=_host(state.changed).astype(np.bool_),
        **{f"meta_{k}": np.asarray(v) for k, v in meta.items()},
    )


def _state_from_npz(z: dict, path: str, device) -> BfsState:
    try:
        fields = [z[k] for k in BfsState._fields]
    except KeyError as exc:
        raise CheckpointError(
            f"checkpoint {path!r} is missing field {exc}; not a BfsState dump"
        ) from exc
    return BfsState(*(torch.from_numpy(np.array(a)).to(device) for a in fields))


def load_checkpoint(path: str | os.PathLike, *, device="cpu") -> BfsState:
    """The carry of a checkpoint, on ``device``."""
    return _state_from_npz(load_npz_strict(path), os.fspath(path), device)


def _checkpoint_candidates(base: str) -> list[tuple[int, str]]:
    """``[(level, path)]`` of every ``{base}.ckpt_<level>.npz``, newest
    first."""
    out = []
    for path in glob.glob(f"{glob.escape(base)}.ckpt_*.npz"):
        stem = path[len(base) + len(".ckpt_"):-len(".npz")]
        if stem.isdigit():
            out.append((int(stem), path))
    return sorted(out, reverse=True)


def latest_checkpoint(base: str | os.PathLike) -> tuple[str, int] | None:
    """``(path, level)`` of the newest valid ``{base}.ckpt_<level>.npz``,
    skipping damaged ones."""
    found = load_latest_checkpoint(base)
    return (found[2], found[1]) if found is not None else None


def load_latest_checkpoint(base: str | os.PathLike, expect: dict | None = None,
                           *, device="cpu") -> tuple[BfsState, int, str] | None:
    """``(state, level, path)`` from the newest valid checkpoint, in one
    read.  Damaged dumps are skipped with a warning, and so is one whose
    ``meta_<k>`` differs from ``expect[k]`` (written by another run
    configuration); a checkpoint without the field is accepted."""
    for level, path in _checkpoint_candidates(os.fspath(base)):
        try:
            z = load_npz_strict(path)
        except CheckpointError as exc:
            logger.warning("skipping %s", exc)
            continue
        mismatch = None
        for k, v in (expect or {}).items():
            stored = z.get(f"meta_{k}")
            if stored is not None and stored.item() != v:
                mismatch = f"{k}={stored.item()!r} (this run: {v!r})"
                break
        if mismatch is not None:
            logger.warning("skipping %s: written by a different run config — %s", path, mismatch)
            continue
        try:
            return _state_from_npz(z, path, device), level, path
        except CheckpointError as exc:
            logger.warning("skipping %s", exc)
    return None


def state_from_arrays(dist, parent, frontier, level: int, *, device="cpu") -> BfsState:
    """A resumable carry from host arrays sized [V] or [V+1]; the sentinel
    slot is appended if missing (a state parsed from a text dump)."""
    dist = np.asarray(dist, dtype=np.int32)
    parent = np.asarray(parent, dtype=np.int32)
    frontier = np.asarray(frontier, dtype=bool)

    def pad(a, fill):
        return np.concatenate([a, np.asarray([fill], dtype=a.dtype)])

    if dist.ndim == 1:
        dist, parent, frontier = pad(dist, INF_DIST), pad(parent, -1), pad(frontier, False)
    arrays = (dist, parent, frontier, np.int32(level), np.bool_(frontier.any()))
    return BfsState(*(torch.from_numpy(np.array(a)).to(device) for a in arrays))
