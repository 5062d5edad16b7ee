"""The port's device mesh: a named (data, feat) grid of ``torch.device``s.

Counterpart of ``spark_rapids_ml_tpu/parallel/mesh.py``. The JAX package
runs one single-controller SPMD program over a ``jax.sharding.Mesh``; the
port keeps that model with explicit shard programs:

- a :class:`Mesh` is a [data, feat] grid of devices. A device may stand in
  several cells (several shards on one card, or on the CPU): the port's
  counterpart of JAX's virtual CPU devices;
- a :class:`Sharding` splits a [rows, n] tensor into the grid's blocks
  (``shard``) and joins them back (``join``): rows over ``data``, and
  columns over ``feat`` where the spec says so. Rows are zero-padded to a
  multiple of the data axis, as the JAX package's ingest pads;
- a :class:`Sharded` holds the blocks of the cells this process owns. A
  block whose spec has no feat axis lives once per data index, in the
  cell (i, 0): its feat replicas would compute the same thing, so the
  shard programs run once per data shard for such an input;
- ``parallel/backend.py`` holds the collectives that combine the shards'
  results in a fixed shard order, in this process or across processes.

A mesh made by ``backend.process_mesh`` spans the processes of a
``torch.distributed`` group (the barrier path): it is [world, 1], and this
process owns the one cell (rank, 0).

Axis conventions, as in the JAX package: ``"data"`` shards rows (the
reference's partition axis), ``"feat"`` shards features (the capability the
reference lacks: its n×n buffers must fit one device,
RapidsRowMatrix.scala:50-52).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
FEAT_AXIS = "feat"


class Mesh:
    """A named (data, feat) grid of devices. ``rank`` is set on a process
    mesh (``backend.process_mesh``), which owns only its row of cells."""

    axis_names = (DATA_AXIS, FEAT_AXIS)

    def __init__(self, devices: Sequence[Sequence[torch.device]], *, rank: int | None = None):
        grid = [[torch.device(d) for d in row] for row in devices]
        if not grid or not grid[0] or any(len(row) != len(grid[0]) for row in grid):
            raise ValueError("a mesh needs a non-empty rectangular grid of devices")
        self.grid = grid
        self.shape = {DATA_AXIS: len(grid), FEAT_AXIS: len(grid[0])}
        self.size = len(grid) * len(grid[0])
        self.rank = rank

    @property
    def distributed(self) -> bool:
        return self.rank is not None

    @property
    def devices(self) -> np.ndarray:
        out = np.empty((self.shape[DATA_AXIS], self.shape[FEAT_AXIS]), dtype=object)
        for i, row in enumerate(self.grid):
            for j, d in enumerate(row):
                out[i, j] = d
        return out

    def device(self, i: int, j: int = 0) -> torch.device:
        return self.grid[i][j]

    def data_indices(self) -> list[int]:
        """The data shards this process owns, in shard order."""
        return [self.rank] if self.distributed else list(range(self.shape[DATA_AXIS]))

    @property
    def first_device(self) -> torch.device:
        """Where a replicated result is kept: the first owned cell's device."""
        return self.grid[self.data_indices()[0]][0]

    def __repr__(self) -> str:
        kind = f", rank={self.rank}" if self.distributed else ""
        return f"Mesh({self.shape}{kind})"


def center_columns_shard(blocks: list[torch.Tensor], mesh: Mesh) -> list[torch.Tensor]:
    """Mean-centering over the ``data`` axis of one feature block's row
    shards (one per owned data index): one psum for the column sums, one for
    the global row count, subtract. Shared by the TSQR and sketched fits."""
    from spark_rapids_ml_tpu_torch.parallel import backend as B

    s = B.psum(mesh, [b.sum(dim=0) for b in blocks])
    c = B.psum(mesh, [torch.tensor(float(b.shape[0]), dtype=b.dtype, device=b.device)
                      for b in blocks])
    return [b - (si / ci)[None, :] for b, si, ci in zip(blocks, s, c)]


def _default_devices() -> list[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "create_mesh() found no CUDA card: pass devices=[...] (e.g. "
            "[torch.device('cpu')] * 8 for a CPU mesh)"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def create_mesh(data: int | None = None, feat: int = 1, *, devices=None) -> Mesh:
    """A (data, feat) mesh over ``devices`` (default: every card). With
    ``data=None`` the data axis takes every device the feat axis leaves.
    Feat is the inner axis, as in the JAX package."""
    devices = [torch.device(d) for d in (devices if devices is not None else _default_devices())]
    if data is None:
        if len(devices) % feat:
            raise ValueError(f"{len(devices)} devices not divisible by feat={feat}")
        data = len(devices) // feat
    count = data * feat
    if count > len(devices):
        raise ValueError(f"mesh {data}x{feat} needs {count} devices, have {len(devices)}")
    return Mesh([devices[i * feat:(i + 1) * feat] for i in range(data)])


@dataclass(repr=False)
class Sharded:
    """The blocks of a sharded tensor that this process owns, keyed by grid
    cell. ``shape`` is the global (padded) shape, ``rows`` its true rows."""

    sharding: "Sharding"
    blocks: dict[tuple[int, int], torch.Tensor]
    shape: tuple[int, ...]
    rows: int

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    def block(self, i: int, j: int = 0) -> torch.Tensor:
        return self.blocks[(i, j)]

    def data_blocks(self) -> list[torch.Tensor]:
        """The owned data shards' blocks of feat column 0, in shard order."""
        return [self.blocks[(i, 0)] for i in self.mesh.data_indices()]

    @property
    def dtype(self) -> torch.dtype:
        return next(iter(self.blocks.values())).dtype

    def join(self) -> torch.Tensor:
        return self.sharding.join(self)

    def __repr__(self) -> str:
        # shapes only: printing the blocks would copy them from the card
        return f"Sharded({self.shape}, {self.dtype}, spec={self.sharding.spec}, {self.mesh})"


@dataclass(frozen=True)
class Sharding:
    """Rows over ``spec[0]`` and columns over ``spec[1]`` (an axis name or
    None); ``()`` is replicated."""

    mesh: Mesh
    spec: tuple = field(default=(DATA_AXIS, None))

    def _parts(self) -> tuple[int, int]:
        rows_axis = self.spec[0] if len(self.spec) > 0 else None
        cols_axis = self.spec[1] if len(self.spec) > 1 else None
        return (self.mesh.shape[rows_axis] if rows_axis else 1,
                self.mesh.shape[cols_axis] if cols_axis else 1)

    def shard(self, x: Any) -> Sharded:
        """Split ``x`` ([rows] or [rows, n]; a tensor or an ndarray) into
        the owned cells' blocks, rows zero-padded to a multiple of the data
        shards. On a process mesh ``x`` is this process's own block."""
        if isinstance(x, Sharded):
            if x.sharding == self:
                return x
            x = x.join()
        x = torch.as_tensor(x)
        rows = x.shape[0]
        n_rows, n_cols = self._parts()
        if self.mesh.distributed:
            dev = self.mesh.first_device
            blocks = {(self.mesh.rank, 0): x.to(dev)}
            return Sharded(self, blocks, (rows * self.mesh.shape[DATA_AXIS],) + tuple(x.shape[1:]),
                           rows)
        pad = -rows % n_rows
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        if n_cols > 1 and x.shape[1] % n_cols:
            raise ValueError(f"{x.shape[1]} columns do not split over feat={n_cols}")
        r = x.shape[0] // n_rows
        c = x.shape[1] // n_cols if n_cols > 1 else None
        blocks = {}
        for i in range(self.mesh.shape[DATA_AXIS]):
            ri = i if n_rows > 1 else 0
            for j in range(n_cols):
                blk = x[ri * r:(ri + 1) * r]
                if c is not None:
                    blk = blk[:, j * c:(j + 1) * c]
                blocks[(i, j)] = blk.to(self.mesh.device(i, j)).contiguous()
            if n_rows == 1:
                break  # replicated rows: one copy, in the first cell
        return Sharded(self, blocks, tuple(x.shape), rows)

    def join(self, xs: Sharded) -> torch.Tensor:
        """The global (padded) tensor on the mesh's first device."""
        n_rows, n_cols = self._parts()
        dev = self.mesh.first_device
        if n_rows == 1:
            return xs.blocks[(0, 0)].to(dev)
        row_blocks = []
        for i in range(n_rows):
            cols = [xs.blocks[(i, j)].to(dev) for j in range(n_cols)]
            row_blocks.append(torch.cat(cols, dim=1) if n_cols > 1 else cols[0])
        return torch.cat(row_blocks)


def data_sharding(mesh: Mesh, *, feature_sharded: bool = False) -> Sharding:
    """Input sharding of a [rows, n] matrix on the mesh."""
    return Sharding(mesh, (DATA_AXIS, FEAT_AXIS) if feature_sharded else (DATA_AXIS, None))


def vector_sharding(mesh: Mesh) -> Sharding:
    """A [rows] vector (weights, labels) sharded like the matrix's rows."""
    return Sharding(mesh, (DATA_AXIS,))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def shard(x: Any, mesh: Mesh, *, feature_sharded: bool = False) -> Sharded:
    """``x`` on the mesh's data sharding (a no-op for a tensor already so)."""
    return data_sharding(mesh, feature_sharded=feature_sharded).shard(x)


def create_hybrid_mesh(feat: int = 1, *, slice_groups=None, devices=None) -> Mesh:
    """A (data, feat) mesh with ``feat`` inside one group of devices that
    share a fast interconnect. ``slice_groups`` partitions device indices
    into equal groups (outer list = groups); each group's devices fill
    contiguous rows of the data axis, so every feat-axis collective stays in
    a group and only the data-axis psum crosses groups. With no groups (one
    host: the cards of one NVLink domain) it is the flat ``create_mesh``."""
    devices = [torch.device(d) for d in (devices if devices is not None else _default_devices())]
    if slice_groups is None:
        return create_mesh(feat=feat, devices=devices)
    groups = [list(g) for g in slice_groups]
    sizes = {len(g) for g in groups}
    if len(sizes) != 1 or 0 in sizes:
        raise ValueError("slice_groups must be equal-size and non-empty")
    seen = [i for g in groups for i in g]
    if sorted(seen) != list(range(len(seen))):
        raise ValueError("slice_groups must partition device indices 0..n-1 exactly")
    if len(seen) > len(devices):
        raise ValueError(
            f"slice_groups name {len(seen)} devices but there are {len(devices)}"
        )
    per_slice = sizes.pop()
    if per_slice % feat:
        raise ValueError(f"feat={feat} must divide devices-per-slice={per_slice}")
    return Mesh([
        [devices[i] for i in g[r * feat:(r + 1) * feat]]
        for g in groups
        for r in range(per_slice // feat)
    ])


def factor_mesh(n_devices: int) -> tuple[int, int]:
    """A (data, feat) factorization: feat is the largest power of two ≤ √n
    that divides n, so both axes are exercised whenever possible."""
    feat = 1
    while feat * 2 <= int(math.isqrt(n_devices)) and n_devices % (feat * 2) == 0:
        feat *= 2
    return n_devices // feat, feat
