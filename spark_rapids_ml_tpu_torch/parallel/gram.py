"""Sharded Gram and moment statistics over the port's device mesh.

Counterpart of ``spark_rapids_ml_tpu/parallel/gram.py``. The whole fit pass
is one shard program over the mesh (``parallel/mesh.py``), its cross-shard
reduction a ``psum`` in fixed shard order (``parallel/backend.py``):

- data-parallel: each data shard's statistics, then one psum over the
  ``data`` axis. At ``"high"`` a shard's Gram is one ``fused_gram_moments``
  launch, at ``"default"`` one launch of its one-product instance
  (``ops.linalg.gram_stats``);
- feature-sharded (``ring_gram``): when an [n, n] buffer per device is the
  wall, columns shard over ``feat`` too and the Gram is built by a ring:
  at each of F steps a cell multiplies its resident column block by the
  visiting one and passes the visitor to its neighbour (``ppermute``). The
  JAX block products are ``jnp.matmul``, so here they are ``torch.matmul``
  at the tier's arithmetic;
- the streamed fold (``sharded_gram_fold`` and its moment and linear
  siblings): the carry is the stacked per-shard partials, each shard adding
  its piece of a chunk into its own slice with no collective (at
  ``"high"``, one ``symmetric_gram_moments`` launch per shard per chunk),
  and one allreduce at ``finalize_chunk_fold``.

``_count_collectives`` books each collective's logical payload in the JAX
package's series (``collective.count`` and ``collective.bytes`` by kind,
and a ``collective.dispatch`` instant on the timeline).
"""

from __future__ import annotations

from typing import Any

import torch

from spark_rapids_ml_tpu_torch.ops import linalg as L
from spark_rapids_ml_tpu_torch.ops import scaler as S
from spark_rapids_ml_tpu_torch.parallel import backend as B
from spark_rapids_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    FEAT_AXIS,
    Mesh,
    Sharded,
    data_sharding,
    shard,
    vector_sharding,
)
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY
from spark_rapids_ml_tpu_torch.telemetry.timeline import TIMELINE


def _count_collectives(kind: str, n_ops: float, payload_bytes: float) -> None:
    """Book ``n_ops`` collectives of ``payload_bytes`` each (the logical
    payload, not the wire schedule) into the registry and the timeline."""
    REGISTRY.counter_inc("collective.count", n_ops, kind=kind)
    REGISTRY.counter_inc("collective.bytes", n_ops * payload_bytes, kind=kind)
    TIMELINE.record_instant(
        "collective.dispatch", kind=kind, n_ops=n_ops, payload_bytes=int(n_ops * payload_bytes),
    )


def sharded_gram_stats(x: Any, mesh: Mesh, *, precision: str = "highest",
                       exact_diagonal: bool = True) -> L.GramStats:
    """Data-parallel GramStats: each data shard's statistics, one psum. The
    count is the shards' rows, pad rows included (callers that pad set the
    true count). The result lies on the mesh's first device.
    ``exact_diagonal``: ``ops.linalg``'s rule at ``"default"``."""
    x = shard(x, mesh)
    n = x.shape[1]
    _count_collectives("psum", 1, (n * n + n + 1) * 4)
    return B.psum_tree(mesh, [L.gram_stats(b, precision=precision, exact_diagonal=exact_diagonal)
                              for b in x.data_blocks()])


def sharded_moment_stats(x: Any, mesh: Mesh) -> S.MomentStats:
    """Data-parallel StandardScaler moments: local sums, one psum."""
    x = shard(x, mesh)
    _count_collectives("psum", 1, (2 * x.shape[1] + 1) * 4)
    return B.psum_tree(mesh, [S.moment_stats(b) for b in x.data_blocks()])


def block_product(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a·b at a precision tier's arithmetic: f32 (``"highest"``), the
    split's three bf16 products (``"high"``) or one bf16 pass
    (``"default"``), TF32 off."""
    L._check_precision(precision)
    if precision == "high":
        return L._split_product(a, b)
    return L.policy_matmul(a, b, policy="bf16_f32acc" if precision == "default" else "f32")


def ring_gram(x: Any, mesh: Mesh, *, precision: str = "highest"
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Feature-sharded Gram by a ring over the ``feat`` axis: ``(gram [n,
    n], col_sum [n], count)`` on the mesh's first device. Cell (i, j) owns
    column block X_ij and builds block-row j of its row shard's Gram: at step
    t it multiplies X_ijᵀ by the visiting block of origin (j + t) mod F, then
    passes the visitor on. The block-rows are psum'd over ``data``."""
    if mesh.distributed:
        raise NotImplementedError("ring_gram runs on a mesh of this process")
    x = shard(x, mesh, feature_sharded=True)
    n_feat, n_data = mesh.shape[FEAT_AXIS], mesh.shape[DATA_AXIS]
    rows_local = x.shape[0] // n_data
    c = x.shape[1] // n_feat
    _count_collectives("ppermute", n_feat, rows_local * c * 4)
    _count_collectives("psum", 3, (c * (c * n_feat) + c + 1) * 4)
    perm = [(k, (k - 1) % n_feat) for k in range(n_feat)]
    block_rows = []  # per data shard: F block-rows [c, n]
    for i in range(n_data):
        devs = [mesh.device(i, j) for j in range(n_feat)]
        xl = [x.block(i, j) for j in range(n_feat)]
        out = [torch.zeros((c, c * n_feat), dtype=x.dtype, device=d) for d in devs]
        buf = list(xl)
        for t in range(n_feat):
            for j in range(n_feat):
                src = (j + t) % n_feat
                out[j][:, src * c:(src + 1) * c] = block_product(xl[j].T, buf[j], precision)
            buf = B.ppermute(buf, perm, devs)
        block_rows.append(out)
    rows_out = [B.psum(mesh, [block_rows[i][j] for i in range(n_data)])[0] for j in range(n_feat)]
    col_sums = [B.psum(mesh, [x.block(i, j).sum(dim=0) for i in range(n_data)])[0]
                for j in range(n_feat)]
    dev = mesh.first_device
    count = torch.tensor(float(x.shape[0]), dtype=x.dtype, device=dev)
    gram = torch.cat([r.to(dev) for r in rows_out])
    return gram, torch.cat([s.to(dev) for s in col_sums]), count


def distributed_pca_fit(
    x: Any,
    k: int,
    mesh: Mesh,
    *,
    mean_centering: bool = False,
    feature_sharded: bool = False,
    solver: str = "full",
    precision: str = "highest",
) -> tuple[torch.Tensor, torch.Tensor]:
    """The distributed fit: the sharded Gram pass, then the n×n
    decomposition (any solver of ``ops.linalg.pca_fit_from_cov``) on the
    replicated covariance."""
    if feature_sharded:
        stats = L.GramStats(*ring_gram(x, mesh, precision=precision))
    else:
        stats = sharded_gram_stats(x, mesh, precision=precision)
    cov = L.covariance_from_stats(stats, mean_centering=mean_centering)
    return L.pca_fit_from_cov(cov, k, solver=solver)


def make_distributed_fit(mesh: Mesh, k: int, *, mean_centering: bool = False,
                         feature_sharded: bool = False, solver: str = "full",
                         precision: str = "highest"):
    """``distributed_pca_fit`` with the mesh and options bound: the returned
    function shards its input (a tensor, an ndarray or a ``Sharded``) onto
    the mesh and returns the replicated (pc, explained variance)."""

    def fit(x):
        return distributed_pca_fit(
            x, k, mesh, mean_centering=mean_centering, feature_sharded=feature_sharded,
            solver=solver, precision=precision,
        )

    return fit


def sharded_range_stats(x: Any, w: Any, mesh: Mesh) -> S.RangeStats:
    """Data-parallel per-feature count/min/max/max|x|: masked local
    reductions (``w`` is the pad mask, 0 on pad rows), then psum of the
    count and pmin/pmax of the rest."""
    x, w = shard(x, mesh), vector_sharding(mesh).shard(w)
    _count_collectives("preduce", 4, x.shape[1] * 4)
    parts = [S.range_stats(xb, valid=wb > 0) for xb, wb in zip(x.data_blocks(), w.data_blocks())]
    reduce = lambda field, op: B.preduce(mesh, [getattr(p, field) for p in parts], op)[0]  # noqa: E731
    dev = mesh.first_device
    return S.RangeStats(
        count=reduce("count", "sum").to(dev),
        min=reduce("min", "min").to(dev),
        max=reduce("max", "max").to(dev),
        max_abs=reduce("max_abs", "max").to(dev),
    )


def sharded_histogram(x: Any, w: Any, mins, maxs, *, bins: int, mesh: Mesh) -> torch.Tensor:
    """Data-parallel fixed-bin histograms [n, bins]: one per shard, pad rows
    (weight 0) routed out, then a psum."""
    x, w = shard(x, mesh), vector_sharding(mesh).shard(w)
    _count_collectives("psum", 1, x.shape[1] * bins * 4)
    parts = []
    for xb, wb in zip(x.data_blocks(), w.data_blocks()):
        lo = torch.as_tensor(mins, dtype=xb.dtype).to(xb.device)
        hi = torch.as_tensor(maxs, dtype=xb.dtype).to(xb.device)
        valid = (wb > 0)[:, None].expand(xb.shape)
        parts.append(S.histogram_stats(xb, xb.shape[0], lo, hi, bins=bins, valid=valid))
    return B.psum(mesh, parts)[0].to(mesh.first_device)


# -- streamed-fit chunk folds: per-shard partials, one allreduce at finalize --


def chunk_put(mesh: Mesh):
    """The streamed fold's chunk placement: a chunk's true rows ([c, n] or
    [c]) split into the data shards' contiguous pieces (sizes differ by at
    most one row: no pad, so unit weights stay unit), each [c, n] piece on
    its shard's device. A [c] piece stays where it lies: the fold's unit
    weights are on the host, where the kernel path reads them without a
    device sync (``ops.linalg.gram_stats_weighted``), and the statistics
    move a vector to the rows' device as they need it. Pass as ``put_fn``
    to ``spark.ingest.stream_fold``."""

    def put(a: torch.Tensor) -> Sharded:
        a = torch.as_tensor(a)
        matrix = a.ndim == 2
        sharding = data_sharding(mesh) if matrix else vector_sharding(mesh)
        pieces = torch.tensor_split(a, mesh.shape[DATA_AXIS])
        blocks = {(i, 0): pieces[i].to(mesh.device(i)) if matrix else pieces[i]
                  for i in mesh.data_indices()}
        return Sharded(sharding, blocks, tuple(a.shape), a.shape[0])

    return put


def stream_chunk_rows_for_mesh(mesh: Mesh, *, n: int | None = None, rows: int | None = None,
                               dtype=None) -> int:
    """The streamed chunk rows rounded up to a multiple of the data shards.
    With the fit's shape the tuning cache is consulted first (a lookup only:
    a mesh fit never searches) and a winner's chunk rows replace
    ``TPU_ML_STREAM_CHUNK_ROWS``."""
    from spark_rapids_ml_tpu_torch.spark.ingest import stream_chunk_rows

    ndev = mesh.shape[DATA_AXIS]
    base = stream_chunk_rows()
    if n is not None:
        from spark_rapids_ml_tpu_torch import autotune

        tuned = autotune.resolve(
            "stream.fold_step", n=n, rows=rows, dtype="float32" if dtype is None else str(dtype),
            device=autotune.cache.device_kind(mesh.first_device),
        )
        if tuned is not None and tuned.chunk_rows:
            base = int(tuned.chunk_rows)
    return -(-base // ndev) * ndev


def init_chunk_carry(example, mesh: Mesh):
    """The zero stacked-partials carry: each leaf of ``example`` (tensors,
    or anything with ``shape`` and ``dtype``: a ``device="meta"`` tensor
    costs nothing) becomes a [ndev, *shape] value sharded over ``data``,
    whose slice i lives on data shard i's device."""
    ndev = mesh.shape[DATA_AXIS]
    sharding = vector_sharding(mesh)

    def make(leaf) -> Sharded:
        blocks = {(i, 0): torch.zeros((1,) + tuple(leaf.shape), dtype=leaf.dtype,
                                      device=mesh.device(i))
                  for i in mesh.data_indices()}
        return Sharded(sharding, blocks, (ndev,) + tuple(leaf.shape), ndev)

    return B.tree_map(make, example)


def finalize_chunk_fold(carry, mesh: Mesh):
    """The stacked partials' replicated total: the one cross-shard
    reduction of a streamed fit. The carry is not changed, so a transient
    fault at the ``collective`` site retries in place."""
    from spark_rapids_ml_tpu_torch.resilience import faults, sites
    from spark_rapids_ml_tpu_torch.resilience import retry as R

    leaves = B.tree_leaves(carry)
    _count_collectives(
        "allreduce", len(leaves),
        sum(4 * torch.Size(leaf.shape[1:]).numel() for leaf in leaves) / max(len(leaves), 1),
    )

    def run():
        faults.inject(sites.COLLECTIVE)
        return B.tree_map(lambda leaf: B.allreduce(leaf, mesh, DATA_AXIS), carry)

    return R.call_with_retry(run, site=sites.COLLECTIVE, retry_on=frozenset({R.ErrorClass.TRANSIENT}))


def _fold_shards(carry, mesh: Mesh, kernel, *operands):
    """Add each data shard's ``kernel(*its blocks)`` into its slice of the
    carry, in place; no collective."""
    ops = [o if isinstance(o, Sharded) else chunk_put(mesh)(o) for o in operands]
    for i in mesh.data_indices():
        local = kernel(*(o.block(i) for o in ops))
        for acc, part in zip(B.tree_leaves(carry), B.tree_leaves(local)):
            acc.block(i)[0].add_(part.to(acc.block(i).device))
    return carry


def sharded_gram_fold(carry, x, w, mesh: Mesh, *, precision: str = "highest",
                      policy: str | None = None, exact_diagonal: bool = True):
    """One streamed GramStats fold: each data shard's weighted statistics of
    its piece of the chunk into its carry slice, in place (``x``/``w`` from
    ``chunk_put``). At ``"high"`` with unit weights a shard's piece is one
    ``symmetric_gram_moments`` launch. ``policy=None`` is
    ``TPU_ML_PRECISION_POLICY``."""
    from spark_rapids_ml_tpu_torch.autotune.policy import FOLD_POLICIES, resolve_policy

    policy = resolve_policy(policy, allowed=FOLD_POLICIES)
    return _fold_shards(
        carry, mesh,
        lambda xl, wl: L.gram_stats_weighted(xl, wl, precision=precision, policy=policy,
                                             exact_diagonal=exact_diagonal),
        x, w,
    )


def sharded_moment_fold(carry, x, w, mesh: Mesh):
    """One streamed MomentStats fold over a sharded chunk, in place."""
    return _fold_shards(carry, mesh, S.moment_stats_weighted, x, w)


def sharded_linear_fold(carry, x, y, w, mesh: Mesh, *, policy: str | None = None):
    """One streamed LinearStats fold over a sharded labeled chunk, in place
    (``w`` is the instance weight or pad mask). The port's linear statistics
    are f32 products (``ops.linear.linear_stats`` has no tier), so the JAX
    fold's ``precision`` has no counterpart here."""
    from spark_rapids_ml_tpu_torch.autotune.policy import FOLD_POLICIES, resolve_policy
    from spark_rapids_ml_tpu_torch.ops import linear as LIN

    policy = resolve_policy(policy, allowed=FOLD_POLICIES)
    return _fold_shards(
        carry, mesh,
        lambda xl, yl, wl: LIN.linear_stats(xl, yl, wl, policy=policy),
        x, y, w,
    )
