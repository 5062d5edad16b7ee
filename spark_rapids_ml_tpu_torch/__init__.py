"""PyTorch/CUDA port of spark-rapids-ml-tpu.

A second package beside the JAX one, held against it function by function.
It imports torch and nothing of JAX or of the JAX package. Its entry points
run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; without a card the default raises.

It ports the PCA fit, resident or streamed above the cutover and with or
without the fused standardize, and the transform, with the split-bf16
Gram + moments kernels written by hand for Hopper (``csrc/gram_moments.cu``).
"""

from spark_rapids_ml_tpu_torch.models.pca import PCA, PCAModel

__version__ = "0.1.0"

__all__ = ["PCA", "PCAModel", "__version__"]
