"""Input makers of the benchmark: every row is made on the device from the
run's seed, partition by partition, and copied into one pageable host
array, the container a user hands to ``fit``. The same seed gives the same
bits on the same device. Both the system and the reference read that one
array.

Frozen copies of the smoke script's makers (its ``partition_edges``,
``kmeans_centres`` and ``kmeans_partition``), so that a change there
changes no cell.
"""

from __future__ import annotations

import numpy as np
import torch


def partition_edges(rows: int, partitions: int) -> np.ndarray:
    """Row edges of ``np.array_split(x, partitions)``, the fit's split."""
    sizes = [rows // partitions + (i < rows % partitions) for i in range(partitions)]
    return np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def blob_centres(n: int, centres: int, seed: int, device: torch.device) -> torch.Tensor:
    """[centres, n] f32 on ``device``: the centres ``blobs`` draws its rows
    around."""
    return torch.randn((centres, n), generator=_generator(device, seed), device=device)


def blobs(rows: int, n: int, centres: int, partitions: int, noise: float, seed: int,
          device: torch.device) -> np.ndarray:
    """[rows, n] f32: a uniform choice of ``centres`` seeded N(0, 1) centres
    (``blob_centres``) per row plus N(0, noise²) per coordinate."""
    c = blob_centres(n, centres, seed, device)
    edges = partition_edges(rows, partitions)
    x = np.empty((rows, n), dtype=np.float32)
    for p in range(partitions):
        lo, hi = int(edges[p]), int(edges[p + 1])
        gen = _generator(device, seed + 1 + p)
        labels = torch.randint(0, centres, (hi - lo,), generator=gen, device=device)
        part = c[labels]
        part += noise * torch.randn(part.shape, generator=gen, device=device)
        torch.from_numpy(x[lo:hi]).copy_(part)
        del labels, part
    return x


MAKERS = {"blobs": blobs}


def make(spec: dict, seed: int, device: torch.device) -> np.ndarray:
    """The rows a configuration's ``data`` entry describes:
    ``{"maker": name, **its keyword arguments}``."""
    args = {key: value for key, value in spec.items() if key != "maker"}
    return MAKERS[spec["maker"]](seed=seed, device=device, **args)
