"""The mesh and its collectives: the port's counterpart of the reference's
``shard_map`` shim (``bfs_tpu.parallel.compat``).

The reference is a single controller: one process holds a ``(batch,
graph)`` mesh of devices and runs ``shard_map`` programs whose collectives
(``pmin``, ``pmax``, ``psum``, ``all_gather``, ``axis_index``) run over
the named mesh axes.  The port is a single controller over SHARD-STACKED
tensors: every per-shard array of a sharded layout keeps the shards on
axis 0 with one shared shape (as the reference stacks them before
``shard_map`` splits them), plain torch work runs once over that axis,
kernels are launched once per shard on its row, and a collective is a
reduction or a reshape of the stacked axis.  A replicated value is held
once.

A device may repeat in the mesh: four shards on one card are the
counterpart of the tests' four virtual CPU devices.  A mesh whose shards
sit on several distinct devices raises: that is ROADMAP A12's step (e),
where these functions become the cross-device collectives.
"""

from __future__ import annotations

import numpy as np
import torch

GRAPH_AXIS = "graph"
BATCH_AXIS = "batch"
AXES = (BATCH_AXIS, GRAPH_AXIS)


def _normal(dev) -> torch.device:
    """``dev`` as a torch.device with the card's index filled in."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device() if torch.cuda.is_available() else 0)
    return dev


class Mesh:
    """A ``(batch, graph)`` array of devices, all one device.

    ``shape`` maps each axis name to its extent (``mesh.shape["graph"]``
    is the shard count), as a jax ``Mesh`` does; ``device`` is the one
    device every shard of the mesh lives on.  Two meshes are equal when
    their shapes and device are."""

    def __init__(self, devices):
        rows = [list(r) for r in devices]
        arr = np.empty((len(rows), len(rows[0]) if rows else 0), dtype=object)
        for i, row in enumerate(rows):
            for j, dev in enumerate(row):
                arr[i, j] = _normal(dev)
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        distinct = sorted({str(d) for d in arr.reshape(-1)})
        if len(distinct) > 1:
            raise ValueError(
                f"the mesh's shards sit on {len(distinct)} devices ({', '.join(distinct)}): a "
                "mesh over several cards is ROADMAP A12's step (e), not ported yet; stack the "
                "shards on one device (devices=[dev] * n)")
        self.devices = arr
        self.device = arr[0, 0]
        self.axis_names = AXES
        self.shape = {BATCH_AXIS: arr.shape[0], GRAPH_AXIS: arr.shape[1]}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def _key(self):
        return (self.shape[BATCH_AXIS], self.shape[GRAPH_AXIS], str(self.device))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return (f"Mesh(batch={self.shape[BATCH_AXIS]}, graph={self.shape[GRAPH_AXIS]}, "
                f"device={self.device})")


def _axis(axis: str) -> None:
    if axis not in AXES:
        raise ValueError(f"unknown mesh axis {axis!r}; use {AXES}")


def pmin(x: torch.Tensor, axis: str) -> torch.Tensor:
    """``lax.pmin`` over ``axis``: the elementwise min of the shards'
    values ``x[n, ...]`` stacked on axis 0, the replicated ``[...]``."""
    _axis(axis)
    return x.amin(dim=0)


def pmax(x: torch.Tensor, axis: str) -> torch.Tensor:
    """``lax.pmax`` over ``axis``: ``[n, ...]`` -> ``[...]``."""
    _axis(axis)
    return x.amax(dim=0)


def psum(x: torch.Tensor, axis: str) -> torch.Tensor:
    """``lax.psum`` over ``axis``: ``[n, ...]`` -> ``[...]``."""
    _axis(axis)
    return x.sum(dim=0)


def all_gather(x: torch.Tensor, axis: str, *, tiled: bool = False, dim: int = 0) -> torch.Tensor:
    """``lax.all_gather`` over ``axis`` of the shards' ``x[n, *shape]``:
    the replicated array with the shard axis at position ``dim`` of
    ``shape``; ``tiled`` concatenates along that position instead."""
    _axis(axis)
    out = x.movedim(0, dim)
    if not tiled:
        return out
    return out.reshape(*out.shape[:dim], out.shape[dim] * out.shape[dim + 1], *out.shape[dim + 2:])


def axis_index(n: int, axis: str, device) -> torch.Tensor:
    """``lax.axis_index`` of every shard: int64[n], shard s's is s."""
    _axis(axis)
    return torch.arange(n, dtype=torch.int64, device=device)
