"""IVF-Flat approximate k-NN on torch tensors: the packed index and its
search.

Counterpart of ``spark_rapids_ml_tpu/ops/ivf.py``:

- the packing (``IvfBuckets``, ``bucket_cap``, ``build_ivf_buckets``) is
  host numpy, copied as it is: a dense padded [nlist, cap, n] tensor whose
  ``cap`` is a percentile of the cluster sizes (``TPU_ML_ANN_CAP_PERCENTILE``,
  default 99), and an exact spill list, padded to a power of two, for the
  members past the cap;
- the search (``ivf_search``) runs in three steps: a coarse pass (one
  [q, nlist] product, then the ``nprobe`` nearest centroids); a probe scan
  per 128-query block and per probe (a [block, cap, n] gather, a batched
  product for ``einsum('qn,qcn->qc')``, ‖x‖² of the gathered slab, the
  ``ids >= 0`` mask and ``ops.neighbors.merge_topk``); and the spill list as
  one reused [q, spill] product, merged in column blocks. Every shape is
  fixed by the arguments and nothing waits for the host, so a call can be
  captured in a CUDA graph (the ``"ann"`` servable does).

The products follow the precision policy: ``f32`` (TF32 off),
``bf16_f32acc`` (operands rounded to bf16, exact products summed in f32) and
``int8_dist`` (symmetric per-tensor int8; see ``_int8_bucket_dot``). Norms
stay f32.

Ties: ``lax.top_k`` puts the lower position first among equal values. The
coarse pass here is a stable sort and the merges are ``merge_topk``'s
stable sort, so probe order and ids follow the JAX package's rule. The last
query block is padded with zero rows probing cluster 0, as the JAX package
pads it, so that under ``int8_dist`` its gathered slab, and so its scale,
is the same.

With ``nprobe == nlist`` every cluster and the spill list are scanned, and
the result is exact k-NN.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.autotune.policy import PrecisionPolicy
from spark_rapids_ml_tpu_torch.ops.linalg import (
    DEFAULT_POLICY,
    _require_f32_matmul,
    int8_matmul,
    int8_quantized_matmul,
    policy_matmul,
    quantize_int8,
)
from spark_rapids_ml_tpu_torch.ops.neighbors import merge_topk
from spark_rapids_ml_tpu_torch.utils.config import (
    ANN_CAP_PERCENTILE_VAR,
    DEFAULT_ANN_CAP_PERCENTILE,
    lenient_float,
)

_INT8_DIST = PrecisionPolicy.INT8_DIST.value
_BF16_F32ACC = PrecisionPolicy.BF16_F32ACC.value

#: query rows per probe-scan block, the JAX package's tile
_SCAN_BLOCK_ROWS = 128

#: spill columns merged at a time, so one [q, block] score tile exists
_SPILL_BLOCK = 8192

#: widest feature slice whose int8 dot products an f32 product sums exactly:
#: every partial sum is at most n·127² in magnitude, an integer below 2²⁴
#: while n ≤ 1040
_INT8_EXACT_WIDTH = 1040


class IvfBuckets(NamedTuple):
    """One packed IVF index: dense per-cluster buckets + exact spill list.

    ``bucket_ids``/``spill_ids`` hold 0-based global item positions with
    −1 on padding slots. ``spill_items`` is [spill_pad, n] (zero rows when
    no cluster overflowed its cap) and is scanned by every query.
    """

    bucket_items: np.ndarray  # [nlist, cap, n]
    bucket_ids: np.ndarray    # [nlist, cap] int32, −1 = pad
    cap: int
    spill_items: np.ndarray   # [spill_pad, n]
    spill_ids: np.ndarray     # [spill_pad] int32, −1 = pad


def default_cap_percentile() -> float:
    """``TPU_ML_ANN_CAP_PERCENTILE``, read leniently."""
    return lenient_float(ANN_CAP_PERCENTILE_VAR, DEFAULT_ANN_CAP_PERCENTILE)


def bucket_cap(counts: np.ndarray, cap_percentile: float) -> int:
    """The dense-bucket capacity for observed cluster sizes: the
    ``cap_percentile``-th percentile (ceil), floored at 1. 100 degenerates
    to the pad-to-largest-cluster packing (empty spill)."""
    if not 0.0 < cap_percentile <= 100.0:
        raise ValueError(
            f"cap_percentile={cap_percentile} must be in (0, 100]"
        )
    if cap_percentile >= 100.0:
        return max(1, int(counts.max()))
    return max(1, int(np.ceil(np.percentile(counts, cap_percentile))))


def spill_pad_rows(spill_rows: int) -> int:
    """Rows of the spill list for ``spill_rows`` spilled members: the next
    power of two (0 for none)."""
    return 0 if spill_rows == 0 else 1 << (int(spill_rows) - 1).bit_length()


def build_ivf_buckets(
    items: np.ndarray, labels: np.ndarray, nlist: int,
    *, cap_percentile: float | None = None,
) -> IvfBuckets:
    """Host-side packing of an assigned corpus into :class:`IvfBuckets`.

    Every item is stored: the first ``cap`` members of each cluster (in
    stable corpus order) fill the dense [nlist, cap, n] tensor; overflow
    beyond the cap goes to the spill list, padded to a power of two.
    """
    if cap_percentile is None:
        cap_percentile = default_cap_percentile()
    counts = np.bincount(labels, minlength=nlist)
    cap = bucket_cap(counts, cap_percentile)
    n = items.shape[1]
    bucket_items = np.zeros((nlist, cap, n), dtype=items.dtype)
    bucket_ids = np.full((nlist, cap), -1, dtype=np.int32)
    # sort by label, position = rank within cluster
    order = np.argsort(labels, kind="stable")
    sorted_labels = labels[order]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(len(order)) - starts[sorted_labels]
    dense = pos < cap
    bucket_items[sorted_labels[dense], pos[dense]] = items[order[dense]]
    bucket_ids[sorted_labels[dense], pos[dense]] = order[dense]
    spill = order[~dense]
    spill_pad = spill_pad_rows(spill.size)
    spill_items = np.zeros((spill_pad, n), dtype=items.dtype)
    spill_ids = np.full(spill_pad, -1, dtype=np.int32)
    spill_items[: spill.size] = items[spill]
    spill_ids[: spill.size] = spill
    return IvfBuckets(bucket_items, bucket_ids, cap, spill_items, spill_ids)


def _policy_cross(a: torch.Tensor, b_t: torch.Tensor, policy: str) -> torch.Tensor:
    """[q, m] cross term ``a @ b_t`` under the precision policy."""
    if policy == _INT8_DIST:
        return int8_quantized_matmul(a, b_t)
    return policy_matmul(a, b_t, policy=policy)


def _int8_bucket_dot(qq: torch.Tensor, qx: torch.Tensor) -> torch.Tensor:
    """[b, cap] int32 ``einsum('qn,qcn->qc')`` of int8 queries [b, n] and
    an int8 slab [b, cap, n].

    ``torch._int_mm`` is 2-D only, so the batched product runs in f32 on the
    int8 values (TF32 off): each product is at most 127² and every partial
    sum of a slice of at most ``_INT8_EXACT_WIDTH`` = 1040 features at most
    1040·127² < 2²⁴, an integer f32 holds exactly, whatever the order of
    the sums. So each slice's f32 result is its int32 sum bit for bit, and
    the slices add in int32."""
    n = qq.shape[1]
    acc = None
    for lo in range(0, n, _INT8_EXACT_WIDTH):
        hi = lo + _INT8_EXACT_WIDTH
        part = torch.bmm(
            qx[:, :, lo:hi].to(torch.float32), qq[:, lo:hi, None].to(torch.float32)
        )[:, :, 0].to(torch.int32)
        acc = part if acc is None else acc + part
    return acc


def _policy_bucket_cross(queries: torch.Tensor, xj: torch.Tensor, policy: str) -> torch.Tensor:
    """[b, cap] batched cross term ``einsum('qn,qcn->qc')`` under the
    precision policy, the probe-step analog of :func:`_policy_cross`."""
    if policy == _INT8_DIST:
        qq, sq = quantize_int8(queries)
        qx, sx = quantize_int8(xj)
        return _int8_bucket_dot(qq, qx).to(queries.dtype) * (sq * sx)
    if policy == _BF16_F32ACC:
        queries = queries.to(torch.bfloat16).to(queries.dtype)
        xj = xj.to(torch.bfloat16).to(xj.dtype)
    return torch.bmm(xj, queries[:, :, None])[:, :, 0]


def ivf_search(
    queries: torch.Tensor,       # [q, n]
    centroids: torch.Tensor,     # [nlist, n]
    bucket_items: torch.Tensor,  # [nlist, cap, n]
    bucket_ids: torch.Tensor,    # [nlist, cap] int32, −1 = pad
    k: int,
    nprobe: int,
    *,
    spill_items: torch.Tensor | None = None,  # [spill_pad, n]
    spill_ids: torch.Tensor | None = None,    # [spill_pad] int32, −1 = pad
    policy: str = DEFAULT_POLICY,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(scores [q, k] descending −‖·‖², global ids [q, k] int32) over the
    ``nprobe`` nearest clusters per query, plus the whole spill list.
    Unfilled slots score −inf with id −1."""
    _require_f32_matmul()
    q, n = queries.shape
    nlist = bucket_ids.shape[0]
    nprobe = min(nprobe, nlist)
    device, dtype = queries.device, queries.dtype

    # coarse pass: one [q, nlist] product picks the probe set
    q_sq = torch.sum(queries * queries, dim=1, keepdim=True)
    c_sq = torch.sum(centroids * centroids, dim=1)[None, :]
    cd = q_sq + c_sq - 2.0 * _policy_cross(queries, centroids.T, policy)
    probe = torch.sort(-cd, dim=1, descending=True, stable=True)[1][:, :nprobe]

    # probe scan, blocked over queries; the last block padded as the JAX
    # package pads it (zero rows probing cluster 0)
    block = min(_SCAN_BLOCK_ROWS, q)
    n_blocks = -(-q // block)
    pad = n_blocks * block - q
    if pad:
        queries_p = torch.cat([queries, queries.new_zeros((pad, n))])
        probe = torch.cat([probe, probe.new_zeros((pad, nprobe))])
        q_sq_p = torch.cat([q_sq, q_sq.new_zeros((pad, 1))])
    else:
        queries_p, q_sq_p = queries, q_sq
    best = torch.full((n_blocks * block, k), float("-inf"), dtype=dtype, device=device)
    bidx = torch.full((n_blocks * block, k), -1, dtype=torch.int32, device=device)
    # made on the device: a host scalar's copy would break a graph capture
    neg_inf = torch.full((), float("-inf"), dtype=dtype, device=device)
    for lo in range(0, n_blocks * block, block):
        qg = queries_p[lo:lo + block]
        q_sqg = q_sq_p[lo:lo + block]
        b_best, b_idx = best[lo:lo + block], bidx[lo:lo + block]
        for j in range(nprobe):
            cluster = probe[lo:lo + block, j]
            xj = bucket_items.index_select(0, cluster)  # [block, cap, n] gather
            ids = bucket_ids.index_select(0, cluster)   # [block, cap]
            cross = _policy_bucket_cross(qg, xj, policy)
            x_sq = torch.sum(xj * xj, dim=2)
            scores = -(q_sqg + x_sq - 2.0 * cross)
            scores = torch.where(ids >= 0, scores, neg_inf)
            b_best, b_idx = merge_topk(b_best, b_idx, scores, ids, k)
        best[lo:lo + block] = b_best
        bidx[lo:lo + block] = b_idx
    best, bidx = best[:q], bidx[:q]

    # exact spill tail: the [q, spill] product a column block at a time,
    # each block merged in order (a stable merge of the blocks in order is
    # the merge of the whole); int8 quantizes the whole list once, as the
    # JAX package's one product does
    if spill_items is not None and spill_items.shape[0] > 0:
        if policy == _INT8_DIST:
            qq, sq = quantize_int8(queries)
            qs, ss = quantize_int8(spill_items)
        for lo in range(0, spill_items.shape[0], _SPILL_BLOCK):
            s_items = spill_items[lo:lo + _SPILL_BLOCK]
            s_ids = spill_ids[lo:lo + _SPILL_BLOCK]
            s_sq = torch.sum(s_items * s_items, dim=1)[None, :]
            if policy == _INT8_DIST:
                cross = int8_matmul(qq, qs[lo:lo + _SPILL_BLOCK].T).to(dtype) * (sq * ss)
            else:
                cross = policy_matmul(queries, s_items.T, policy=policy)
            scores = -(q_sq + s_sq - 2.0 * cross)
            scores = torch.where(s_ids[None, :] >= 0, scores, neg_inf)
            best, bidx = merge_topk(best, bidx, scores, s_ids[None, :].expand(q, -1), k)
    return best, bidx
