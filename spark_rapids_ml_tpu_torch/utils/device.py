"""Which device the port's entry points run on.

Loose counterpart of ``spark_rapids_ml_tpu/utils/devicepolicy.py``: the
estimators run on the card unless the caller names the CPU. There is no
fallback: asking for CUDA where there is none raises.
"""

from __future__ import annotations

import torch


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
