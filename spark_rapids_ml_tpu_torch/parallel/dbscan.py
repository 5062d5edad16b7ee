"""Mesh-sharded DBSCAN: the min-label recursion as a shard program.

Counterpart of ``spark_rapids_ml_tpu/parallel/dbscan.py``. Rows are
sharded over the ``data`` axis; each shard owns the propagation state of
its rows and runs the blocked eps-neighbourhood passes of
``ops/dbscan.py`` against the whole corpus, which one ``all_gather`` of X
brings to every shard at entry. Each sweep gathers the [rows] label vector
after the shards' updates and makes one ``psum`` of the changed flag: the
host reads that reduced flag for the stop test, so every rank of a process
mesh leaves the loop on the same sweep. The JAX package runs the sweeps as
a ``lax.while_loop``; the arithmetic of a sweep is the one-device kernel's
(``ops.dbscan.dbscan_labels``), so the labels are equal to it.
"""

from __future__ import annotations

from typing import Any

import torch

from spark_rapids_ml_tpu_torch.ops import dbscan as DB
from spark_rapids_ml_tpu_torch.parallel import backend as B
from spark_rapids_ml_tpu_torch.parallel.mesh import Mesh

_XWV = (B.MATRIX_SPEC, B.VECTOR_SPEC, B.VECTOR_SPEC)


def _gathered(mesh: Mesh, blocks: list[torch.Tensor]) -> dict[torch.device, torch.Tensor]:
    """The shards' ``blocks`` joined in shard order, once on each device
    that an owned shard lives on."""
    parts = B.all_gather(mesh, blocks)
    out: dict[torch.device, torch.Tensor] = {}
    for b in blocks:
        if b.device not in out:
            out[b.device] = torch.cat([p.to(b.device) for p in parts])
    return out


def make_sharded_dbscan(mesh: Mesh, *, block_rows: int = DB.DEFAULT_BLOCK_ROWS):
    """``run(x, w, valid, eps_sq, min_pts) -> labels``: ``x`` [rows, n],
    ``w`` [rows] (sample weights) and ``valid`` [rows] (the pad mask, 0 on
    pad rows) data-sharded; [rows] int32 labels out on the mesh's first
    device, equal to the one-device ``ops.dbscan.dbscan_labels``."""

    def run(x: Any, w: Any, valid: Any, eps_sq: float, min_pts: float) -> torch.Tensor:
        valid = torch.as_tensor(valid).to(torch.float32)
        local = B.shard_operands(mesh, (x, w, valid), _XWV)
        shards = mesh.data_indices()
        shard_rows = local[0][0].shape[0]
        blk = min(block_rows, shard_rows)
        mine_valid = [vl > 0 for _, _, vl in local]
        gx = _gathered(mesh, [xl for xl, _, _ in local])
        rows = next(iter(gx.values())).shape[0]
        sentinel = rows
        gw = _gathered(mesh, [torch.where(mv, wl, torch.zeros_like(wl))
                              for (_, wl, _), mv in zip(local, mine_valid)])
        local_core = [
            (DB._blocked_rowpass(xl, gx[xl.device], DB.make_count_fn(eps_sq), (0.0, xl.dtype),
                                 block_rows=blk, corpus={"w": gw[xl.device]}) >= min_pts) & mv
            for (xl, _, _), mv in zip(local, mine_valid)
        ]
        # gathered as int32: gloo has no collective for bool tensors
        core = {dev: c > 0 for dev, c in
                _gathered(mesh, [c.to(torch.int32) for c in local_core]).items()}
        min_fn = DB.make_min_fn(eps_sq, sentinel)
        bases = [shard * shard_rows for shard in shards]

        def donated_min(labels: dict) -> list[torch.Tensor]:
            """Each owned shard's rows: the smallest core-neighbour label over
            the whole corpus."""
            return [DB._blocked_rowpass(xl, gx[xl.device], min_fn, (sentinel, torch.int32),
                                        block_rows=blk,
                                        corpus={"core": core[xl.device],
                                                "labels": labels[xl.device]})
                    for xl, _, _ in local]

        labels = {dev: torch.where(c, torch.arange(rows, dtype=torch.int32, device=dev),
                                   sentinel).to(torch.int32)
                  for dev, c in core.items()}
        while True:
            donated = donated_min(labels)
            new_mine = []
            for (xl, _, _), base, don in zip(local, bases, donated):
                mine = labels[xl.device][base:base + shard_rows]
                my_core = core[xl.device][base:base + shard_rows]
                new_mine.append(torch.where(my_core, torch.minimum(mine, don), mine))
            new = _gathered(mesh, new_mine)
            for dev, c in core.items():  # pointer jumping on the replicated vector
                for _ in range(2):
                    new[dev] = torch.where(c, new[dev][torch.clamp(new[dev], 0, rows - 1).long()],
                                           new[dev])
            changed = B.psum(mesh, [torch.any(new[xl.device] != labels[xl.device]).to(torch.int32)
                                    for xl, _, _ in local])[0]
            labels = new
            if not int(changed) > 0:
                break

        out_mine = []
        for (xl, _, _), base, don, mv in zip(local, bases, donated_min(labels), mine_valid):
            mine = labels[xl.device][base:base + shard_rows]
            my_core = core[xl.device][base:base + shard_rows]
            out = torch.where(my_core, mine, torch.where(don < sentinel, don, -1))
            out_mine.append(torch.where(mv, out, -1).to(torch.int32))
        return _gathered(mesh, out_mine)[out_mine[0].device].to(mesh.first_device)

    return run
