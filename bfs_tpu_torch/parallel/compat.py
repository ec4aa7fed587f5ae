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

The 2-D grid (:mod:`.grid`) runs on a ``(row, col)`` mesh
(:data:`GRID_AXES`) whose ``r*c`` cells are stacked on axis 0 mesh-row-major
(cell ``(i, j)`` at ``i*c + j``, as the reference's ``make_grid_mesh``
orders its devices).  Its collectives (:func:`grid_pmin`,
:func:`grid_all_gather`) run over one axis of that stack: along ``row``
within each mesh column, along ``col`` within each mesh row;
:func:`grid_pmax` and :func:`grid_psum` over both.  A value replicated over
a group is held once per group.

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
GRID_ROW_AXIS = "row"
GRID_COL_AXIS = "col"
GRID_AXES = (GRID_ROW_AXIS, GRID_COL_AXIS)


def _normal(dev) -> torch.device:
    """``dev`` as a torch.device with the card's index filled in."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device() if torch.cuda.is_available() else 0)
    return dev


class Mesh:
    """A 2-D array of devices, all one device: ``(batch, graph)`` by
    default, ``(row, col)`` for the grid (``axis_names=GRID_AXES``).

    ``shape`` maps each axis name to its extent (``mesh.shape["graph"]``
    is the shard count), as a jax ``Mesh`` does; ``device`` is the one
    device every shard of the mesh lives on.  Two meshes are equal when
    their axes, shapes and device are."""

    def __init__(self, devices, axis_names: tuple[str, str] = AXES):
        if tuple(axis_names) not in (AXES, GRID_AXES):
            raise ValueError(f"unknown mesh axes {axis_names!r}; use {AXES} or {GRID_AXES}")
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
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, arr.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def _key(self):
        return (self.axis_names, *self.shape.values(), str(self.device))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        axes = ", ".join(f"{k}={v}" for k, v in self.shape.items())
        return f"Mesh({axes}, device={self.device})"


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


# ------------------------------------------------------------ the grid mesh --

def _grid_groups(x: torch.Tensor, axis: str, r: int, c: int) -> torch.Tensor:
    """The stacked cells ``x[r*c, ...]`` arranged by ``axis``'s groups:
    ``[c, r, ...]`` along ``row`` (each mesh column's r cells),
    ``[r, c, ...]`` along ``col`` (each mesh row's c cells)."""
    if axis not in GRID_AXES:
        raise ValueError(f"unknown grid axis {axis!r}; use {GRID_AXES}")
    if x.shape[0] != r * c:
        raise ValueError(f"{x.shape[0]} cells stacked for an {r}x{c} grid")
    cells = x.reshape(r, c, *x.shape[1:])
    return cells.movedim(1, 0) if axis == GRID_ROW_AXIS else cells


def grid_pmin(x: torch.Tensor, axis: str, r: int, c: int) -> torch.Tensor:
    """``lax.pmin`` over one axis of the grid: the cells' ``x[r*c, ...]``
    -> each group's min, ``[c, ...]`` along ``row``, ``[r, ...]`` along
    ``col``."""
    return _grid_groups(x, axis, r, c).amin(dim=1)


def grid_all_gather(x: torch.Tensor, axis: str, r: int, c: int, *,
                    tiled: bool = False) -> torch.Tensor:
    """``lax.all_gather`` over one axis of the grid: each group's members'
    values in member order, ``[c, r, ...]`` along ``row``, ``[r, c, ...]``
    along ``col``; ``tiled`` concatenates the members along the first value
    axis (``[groups, members * shape[0], ...]``)."""
    out = _grid_groups(x, axis, r, c)
    if not tiled:
        return out
    return out.reshape(out.shape[0], out.shape[1] * out.shape[2], *out.shape[3:])


def grid_pmax(x: torch.Tensor, r: int, c: int) -> torch.Tensor:
    """``lax.pmax`` over both grid axes: the whole machine's max,
    ``[...]``."""
    return _grid_groups(x, GRID_ROW_AXIS, r, c).amax(dim=(0, 1))


def grid_psum(x: torch.Tensor, r: int, c: int) -> torch.Tensor:
    """``lax.psum`` over both grid axes: ``[...]``."""
    return _grid_groups(x, GRID_ROW_AXIS, r, c).sum(dim=(0, 1))
