"""Trace ranges of the port.

``trace_range`` is the analog of the reference's ``NvtxRange`` and of the
JAX package's ``telemetry.trace_range``: on the card it opens an NVTX range,
which profilers show on the timeline; on the CPU it does nothing.
"""

from __future__ import annotations

import contextlib

import torch


def trace_range(name: str, device: torch.device):
    """Context manager: an NVTX range named ``name`` when ``device`` is a
    CUDA device."""
    if device.type == "cuda":
        return torch.cuda.nvtx.range(name)
    return contextlib.nullcontext()
