"""Mesh-sharded NaiveBayes statistics: the NBStats monoid over the mesh.

Counterpart of ``spark_rapids_ml_tpu/parallel/naive_bayes.py``: one
``mapreduce_data_axis`` program a pass. Each data shard computes its rows'
one-hot product statistics (``ops/naive_bayes.py``) and one psum in shard
order combines them; the closed forms stay on the host (O(C·F)).
"""

from __future__ import annotations

from typing import Any

import torch

from spark_rapids_ml_tpu_torch.ops import naive_bayes as NB
from spark_rapids_ml_tpu_torch.parallel import backend as B
from spark_rapids_ml_tpu_torch.parallel.mesh import Mesh


def sharded_nb_stats(x: Any, y: Any, w: Any, n_classes: int, mesh: Mesh) -> NB.NBStats:
    """NBStats over data-sharded (x, y, w), replicated out; ``w`` carries
    instance weights on true rows and 0 on pad rows."""
    return B.mapreduce_data_axis(
        lambda xl, yl, wl: NB.nb_stats(xl, yl, wl, n_classes), mesh,
        in_specs=(B.MATRIX_SPEC, B.VECTOR_SPEC, B.VECTOR_SPEC),
    )(x, y, w)


def sharded_nb_centered_sq(x: Any, y: Any, w: Any, mu: Any, n_classes: int,
                           mesh: Mesh) -> torch.Tensor:
    """The gaussian second pass, Σw·(x − μ_class)², over the mesh: μ
    replicated, the rows sharded."""
    return B.mapreduce_data_axis(
        lambda xl, yl, wl, m: NB.nb_centered_sq(xl, yl, wl, m, n_classes), mesh,
        in_specs=(B.MATRIX_SPEC, B.VECTOR_SPEC, B.VECTOR_SPEC, B.REPLICATED_SPEC),
    )(x, y, w, mu)
