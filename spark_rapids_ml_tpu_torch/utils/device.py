"""Which device the port's entry points run on, the copy of host rows to
it, and the row block of the blocked distance passes there.

Loose counterpart of ``spark_rapids_ml_tpu/utils/devicepolicy.py``: the
estimators run on the card unless the caller names the CPU. There is no
fallback: asking for CUDA where there is none raises.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """``torch.device`` for ``device`` (default ``"cuda"``); raises if CUDA is
    asked for and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def _host_f32(mat: np.ndarray) -> np.ndarray:
    host = np.ascontiguousarray(mat, dtype=np.float32)
    if not host.flags.writeable:  # torch tensors may not alias read-only memory
        host = host.copy()
    return host


def to_device(mat: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host matrix → contiguous f32 tensor on ``device``; a copy to a card
    books its bytes as ``h2d.bytes{path=resident}`` (``FitReport.h2d_bytes``)."""
    host = _host_f32(mat)
    if device.type != "cpu":
        REGISTRY.counter_inc("h2d.bytes", host.nbytes, path="resident")
    return torch.from_numpy(host).to(device)


def to_device_padded(mat: np.ndarray, rows: int, device: torch.device) -> torch.Tensor:
    """``to_device`` of [m, n] into a zeroed [rows, n] tensor (rows ≥ m): the
    padding is made on ``device``, so no padded host copy exists."""
    host = _host_f32(mat)
    out = torch.zeros((rows, host.shape[1]), dtype=torch.float32, device=device)
    out[: host.shape[0]].copy_(torch.from_numpy(host))
    if device.type != "cpu":
        REGISTRY.counter_inc("h2d.bytes", host.nbytes, path="resident")
    return out


def to_device_augmented(mat: np.ndarray, device: torch.device) -> torch.Tensor:
    """``to_device`` of [m, n] into an [m, n + 1] tensor whose last column is
    ones (the intercept column of the Newton fits), made on ``device``, so
    no augmented host copy exists."""
    host = _host_f32(mat)
    out = torch.empty((host.shape[0], host.shape[1] + 1), dtype=torch.float32, device=device)
    out[:, : host.shape[1]].copy_(torch.from_numpy(host))
    out[:, host.shape[1]] = 1.0
    if device.type != "cpu":
        REGISTRY.counter_inc("h2d.bytes", host.nbytes, path="resident")
    return out


#: Bytes of one f32 tile of a blocked distance pass on the card (a KMeans
#: [block, k] tile, a DBSCAN [block, block] tile). At 256 MiB the few tiles
#: that live at once (distances, one-hot) stay near 1 GB beside the 25.8 GB
#: of BASELINE config 5's data on an 80 GB H100, and at k = 1000 a block of
#: 65,536 rows makes an eighth of the launches of the 8,192-row default (a
#: config-5 Lloyd pass: 1.40 s against 2.03 s on an H100 80GB HBM3 at 700 W,
#: ``chip_smoke.py`` phase 12).
CARD_TILE_BYTES = 256 << 20


def block_rows_for(device: torch.device, default: int, cols: int | None = None) -> int:
    """Rows per block of a blocked distance pass on ``device``: ``default``
    on the CPU (the JAX package's blocks); on the card the largest power of
    two whose f32 [block, cols] tile (a square [block, block] tile when
    ``cols`` is None) fits ``CARD_TILE_BYTES``, and at least ``default``."""
    if device.type == "cpu":
        return default
    elems = CARD_TILE_BYTES // 4
    if cols is None:
        rows = 1 << ((elems.bit_length() - 1) // 2)
    else:
        rows = 1 << max(0, (elems // max(cols, 1)).bit_length() - 1)
    return max(default, rows)
