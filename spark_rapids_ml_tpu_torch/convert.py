"""Carry a fitted PCA model from the JAX package into the port.

``pca_model_from_arrays`` takes the dict that
``spark_rapids_ml_tpu.models.pca.PCAModel._saveData()`` returns (numpy
``pc`` and ``explainedVariance``, and ``mean``/``std`` for a model fitted
with standardize=True) and builds the port's ``PCAModel`` from it. Nothing
of the JAX package is imported: the dict holds plain numpy arrays.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.models.pca import PCAModel


def pca_model_from_arrays(
    data: Mapping[str, np.ndarray],
    device: str | torch.device = "cuda",
) -> PCAModel:
    """A port ``PCAModel`` holding the given components (and scaling)."""
    missing = {"pc", "explainedVariance"} - set(data)
    if missing:
        raise KeyError(f"model arrays lack {sorted(missing)}")
    if ("mean" in data) != ("std" in data):
        raise KeyError("model arrays must hold both 'mean' and 'std', or neither")
    return PCAModel(
        pc=np.asarray(data["pc"]),
        explainedVariance=np.asarray(data["explainedVariance"]),
        mean=data.get("mean"),
        std=data.get("std"),
        device=device,
    )
