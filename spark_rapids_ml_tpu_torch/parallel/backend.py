"""Process-group bring-up and the mesh collectives.

Counterpart of ``spark_rapids_ml_tpu/parallel/backend.py``. In the JAX
package XLA inserts the collectives of one SPMD program; here each is an
explicit function over the shards' values, in a fixed shard order:

- ``psum``: the shards' partials summed in shard order (shard 0's first)
  on shard 0's device, the result copied to every participating device.
  The order is fixed, so the port's runs are bit-equal to each other;
  against JAX, whose order is XLA's, they agree to a tolerance;
- ``pmin``/``pmax``: the same walk with the elementwise min/max;
- ``all_gather``: every shard's value, in shard order;
- ``ppermute``: a block moved to another cell's device (the ring's step).

On a mesh of this process (``parallel/mesh.py``) the shards are all here.
On a process mesh (``process_mesh``, the barrier path) each process owns one
data shard and the collectives first gather every rank's value through
``torch.distributed``, then reduce in rank order: every rank computes the
same bits, and they equal the in-process mesh's:

- gloo for CPU tensors: its ``all_gather``;
- gloo for CUDA tensors, where several ranks share one card (NCCL refuses
  two ranks on one card): gloo has only ``all_reduce`` and ``broadcast``
  for CUDA tensors, so the gather is one ``broadcast`` from each rank in
  turn;
- NCCL where each rank owns its own card: its ``all_gather``.

``initialize`` joins the group (``torch.distributed.init_process_group``
with an explicit address, world size and rank: nothing tells a process of
a cluster), and ``mapreduce_data_axis``, ``allreduce``, ``allgather``,
``broadcast_host`` and ``host_reduce`` are the JAX facade's functions.
"""

from __future__ import annotations

import datetime
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

from spark_rapids_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    Sharded,
    Sharding,
    vector_sharding,
)
from spark_rapids_ml_tpu_torch.parallel.tree_aggregate import tree_reduce


def initialize(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    *,
    store=None,
    device: torch.device | str = "cpu",
    backend: str | None = None,
    timeout_s: float = 300.0,
) -> None:
    """Join the process group once per process: at ``init_method``
    (``tcp://host:port`` or ``file://path``) or through a ``store`` already
    made (a ``TCPStore`` on port 0 has no port to race for). With neither (a
    single process) it does nothing. ``backend`` defaults to
    ``pick_backend(device, world_size)``."""
    if dist.is_initialized() or (init_method is None and store is None):
        return
    dist.init_process_group(
        backend or pick_backend(device, world_size or 1),
        init_method=init_method,
        store=store,
        world_size=world_size if world_size is not None else -1,
        rank=rank if rank is not None else -1,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def pick_backend(device: torch.device | str, world_size: int) -> str:
    """NCCL when every rank can own its own card, gloo otherwise (the CPU,
    or several ranks on one card)."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def process_info() -> dict:
    group = dist.is_initialized()
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return {
        "process_index": dist.get_rank() if group else 0,
        "process_count": dist.get_world_size() if group else 1,
        "local_devices": local,
        "backend": dist.get_backend() if group else None,
    }


def process_mesh(device: torch.device | str) -> Mesh:
    """The [world, 1] mesh of the joined group: this process owns the cell
    (rank, 0) on ``device``."""
    device = torch.device(device)
    world = dist.get_world_size()
    return Mesh([[device]] * world, rank=dist.get_rank())


# -- primitives over one value per owned shard --------------------------------


def all_gather(mesh: Mesh, local: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Every data shard's value in shard order, from the owned shards'
    ``local`` values (all of them on a mesh of this process)."""
    local = list(local)
    if not mesh.distributed:
        return local
    # made contiguous first: a collective moves raw memory, and a QR's R
    # (for one) is column-major
    t = local[0].contiguous()
    if dist.get_backend() == "gloo" and t.is_cuda:
        return _gather_by_broadcast(t, mesh.rank)
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return out


def _gather_by_broadcast(t: torch.Tensor, rank: int) -> list[torch.Tensor]:
    """Every rank's ``t`` by one ``broadcast`` from each rank in turn: the
    gather of gloo, which has only ``all_reduce`` and ``broadcast`` for CUDA
    tensors."""
    t = t.contiguous()
    out = []
    for src in range(dist.get_world_size()):
        buf = t if src == rank else torch.empty_like(t)
        dist.broadcast(buf, src=src)
        out.append(buf)
    return out


_OPS: dict[str, Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = {
    "sum": torch.add,
    "min": torch.minimum,
    "max": torch.maximum,
}


def preduce(mesh: Mesh, local: Sequence[torch.Tensor], op: str = "sum") -> list[torch.Tensor]:
    """The shards' values combined in shard order on the first shard's
    device; one result per owned shard, on its device."""
    values = all_gather(mesh, local)
    total = values[0]
    combine = _OPS[op]
    for v in values[1:]:
        total = combine(total, v.to(total.device))
    return [total.to(t.device) for t in local]


def psum(mesh: Mesh, local: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    return preduce(mesh, local, "sum")


def ppermute(blocks: Sequence[torch.Tensor], perm: Sequence[tuple[int, int]],
             devices: Sequence[torch.device]) -> list[torch.Tensor]:
    """``out[dst] = blocks[src]`` on ``devices[dst]`` for each (src, dst)."""
    out: list[Any] = [None] * len(blocks)
    for src, dst in perm:
        out[dst] = blocks[src].to(devices[dst])
    return out


# -- pytrees of statistics: NamedTuples, tuples, lists and dicts of leaves -----


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for part in tree for leaf in tree_leaves(part)]
    return [tree]


def tree_map(fn, tree):
    """``tree`` with ``fn`` applied to each leaf (a NamedTuple keeps its
    type)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        parts = [tree_map(fn, p) for p in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") else type(tree)(parts)
    return fn(tree)


def psum_tree(mesh: Mesh, trees: Sequence[Any]):
    """``psum`` leaf by leaf over one pytree per owned data shard; the
    replicated total on the mesh's first device."""
    per_shard = [tree_leaves(t) for t in trees]
    dev = mesh.first_device
    totals = iter([psum(mesh, [leaves[i] for leaves in per_shard])[0].to(dev)
                   for i in range(len(per_shard[0]))])
    return tree_map(lambda _: next(totals), trees[0])


# -- the JAX facade ------------------------------------------------------------


MATRIX_SPEC = (DATA_AXIS, None)
VECTOR_SPEC = (DATA_AXIS,)
REPLICATED_SPEC = ()


def mapreduce_data_axis(kernel, mesh: Mesh, *, replicated_args: int = 0, in_specs=None):
    """Run a partition-stats kernel on each data shard and psum its monoid
    output (any pytree of summable statistics): the one place the
    scaffolding lives. ``kernel(x_shard, *operands)`` gets the shard's
    blocks of the sharded operands and the replicated ones on the shard's
    device. ``in_specs`` names each operand's spec: ``MATRIX_SPEC`` ([rows,
    n] over data), ``VECTOR_SPEC`` ([rows] over data) or
    ``REPLICATED_SPEC``; the default is one matrix and ``replicated_args``
    replicated operands."""
    if in_specs is None:
        in_specs = (MATRIX_SPEC,) + (REPLICATED_SPEC,) * replicated_args

    def run(*args):
        shards = []
        for a, spec in zip(args, in_specs):
            if spec == REPLICATED_SPEC:
                shards.append(None)
            else:
                shards.append(Sharding(mesh, spec).shard(a))
        outs = []
        for i in mesh.data_indices():
            dev = mesh.device(i)
            ops = [s.block(i) if s is not None else torch.as_tensor(a).to(dev)
                   for a, s in zip(args, shards)]
            outs.append(kernel(*ops))
        return psum_tree(mesh, outs)

    return run


def allreduce(x: Sharded, mesh: Mesh, axis: str = DATA_AXIS) -> torch.Tensor:
    """Sum a [stacked, ...] value whose leading dim is sharded over the data
    axis: each shard sums its slices, one psum the rest. The replicated
    total on the mesh's first device."""
    if axis != DATA_AXIS:
        raise ValueError(f"stacked values shard over {DATA_AXIS!r}, not {axis!r}")
    x = vector_sharding(mesh).shard(x)
    return psum(mesh, [b.sum(dim=0) for b in x.data_blocks()])[0].to(mesh.first_device)


def allgather(x: Any, mesh: Mesh, axis: str = DATA_AXIS) -> torch.Tensor:
    """The data shards of ``x`` (a value whose leading dim shards over the
    data axis), joined in shard order on the mesh's first device."""
    if axis != DATA_AXIS:
        raise ValueError(f"stacked values shard over {DATA_AXIS!r}, not {axis!r}")
    x = vector_sharding(mesh).shard(x)
    dev = mesh.first_device
    return torch.cat([v.to(dev) for v in all_gather(mesh, x.data_blocks())])


def broadcast_host(value, root: int = 0):
    """``value`` from rank ``root`` to every rank (a single process keeps
    its own)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=root)
    return box[0]


def host_reduce(partials: Sequence, combine) -> object:
    """Reduction outside any mesh program: a balanced tree over host values
    (reference parity: RapidsRowMatrix.scala:139)."""
    return tree_reduce(list(partials), combine)
