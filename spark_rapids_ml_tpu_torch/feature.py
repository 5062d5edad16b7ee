"""The drop-in feature namespace of the port.

Counterpart of ``spark_rapids_ml_tpu/feature.py``, with the same names:
``pyspark.ml.feature``'s naming over the port's modules, so that
``from pyspark.ml.feature import PCA, StandardScaler, StringIndexer``
becomes a one-line import swap. PCA and TruncatedSVD, the scalers, the
imputer, the discretizer and bucketizer, the variance selector and the
stateless stages run on the card (``device="cuda"`` by default); the
column stages (VectorAssembler, StringIndexer, OneHotEncoder,
IndexToString) and the text stages (Tokenizer, HashingTF, IDF) are host
work and take no device. PCA and StandardScaler fits stream above
``TPU_ML_STREAM_FIT_MAX_RESIDENT_BYTES`` (``spark/ingest.py::stream_fold``).
"""

from spark_rapids_ml_tpu_torch.models.pca import PCA, PCAModel  # noqa: F401
from spark_rapids_ml_tpu_torch.models.scaler import (  # noqa: F401
    Binarizer,
    DCT,
    ElementwiseProduct,
    Imputer,
    ImputerModel,
    MaxAbsScaler,
    MaxAbsScalerModel,
    MinMaxScaler,
    MinMaxScalerModel,
    Normalizer,
    PolynomialExpansion,
    RobustScaler,
    VectorSlicer,
    RobustScalerModel,
    StandardScaler,
    StandardScalerModel,
)
from spark_rapids_ml_tpu_torch.models.feature_eng import (  # noqa: F401
    IndexToString,
    OneHotEncoder,
    OneHotEncoderModel,
    StringIndexer,
    StringIndexerModel,
    VectorAssembler,
)
from spark_rapids_ml_tpu_torch.models.text import (  # noqa: F401
    HashingTF,
    IDF,
    IDFModel,
    Tokenizer,
)
from spark_rapids_ml_tpu_torch.models.discretizer import (  # noqa: F401
    Bucketizer,
    QuantileDiscretizer,
    QuantileDiscretizerModel,
)
from spark_rapids_ml_tpu_torch.models.selector import (  # noqa: F401
    VarianceThresholdSelector,
    VarianceThresholdSelectorModel,
)
from spark_rapids_ml_tpu_torch.models.truncated_svd import (  # noqa: F401
    TruncatedSVD,
    TruncatedSVDModel,
)

__all__ = [
    "PCA",
    "PCAModel",
    "VectorAssembler",
    "StringIndexer",
    "StringIndexerModel",
    "OneHotEncoder",
    "OneHotEncoderModel",
    "IndexToString",
    "Tokenizer",
    "HashingTF",
    "IDF",
    "IDFModel",
    "StandardScaler",
    "StandardScalerModel",
    "Normalizer",
    "MinMaxScaler",
    "MinMaxScalerModel",
    "MaxAbsScaler",
    "MaxAbsScalerModel",
    "Binarizer",
    "DCT",
    "ElementwiseProduct",
    "PolynomialExpansion",
    "VectorSlicer",
    "Bucketizer",
    "QuantileDiscretizer",
    "QuantileDiscretizerModel",
    "RobustScaler",
    "RobustScalerModel",
    "Imputer",
    "ImputerModel",
    "VarianceThresholdSelector",
    "VarianceThresholdSelectorModel",
    "TruncatedSVD",
    "TruncatedSVDModel",
]
