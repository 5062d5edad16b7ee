"""Drop-in UMAP namespace mirroring ``spark_rapids_ml.umap``.

Counterpart of ``spark_rapids_ml_tpu/umap.py``.
"""

from spark_rapids_ml_tpu_torch.models.umap import UMAP, UMAPModel  # noqa: F401

__all__ = ["UMAP", "UMAPModel"]
