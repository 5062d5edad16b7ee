"""Which device the port's entry points run on, and the copy of host rows
to it.

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


def to_device(mat: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host matrix → contiguous f32 tensor on ``device``; a copy to a card
    books its bytes as ``h2d.bytes{path=resident}`` (``FitReport.h2d_bytes``)."""
    host = np.ascontiguousarray(mat, dtype=np.float32)
    if not host.flags.writeable:  # torch tensors may not alias read-only memory
        host = host.copy()
    if device.type != "cpu":
        REGISTRY.counter_inc("h2d.bytes", host.nbytes, path="resident")
    return torch.from_numpy(host).to(device)
