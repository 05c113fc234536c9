"""PyTorch / CUDA port of egobox_tpu: dense kriging, the sparse GP (FITC /
VFE), the mixture of GP experts (dense or sparse experts), the Egor
optimizer, the user-facing ``Gpx`` / ``SparseGpx`` API with its sampling
functions, the ``gpqa`` quality report (``python -m egobox_torch.gpqa``),
and the distributed GP over the ranks of a ``torch.distributed`` group,
one rank per card (``egobox_torch.parallel``, imported and exported as
egobox_tpu exports its ``parallel``).

The port mirrors egobox_tpu's module layout and function names; egobox_tpu
stays the reference it is tested against. This package imports neither jax
nor egobox_tpu, and it imports on a host without nvcc or a GPU: the CUDA
kernels under ``csrc/`` are compiled at their first launch.
"""

from . import config
from .config import default_dtype
from .types import (
    ConstraintStrategy,
    CorrelationSpec,
    ExpectedOptimum,
    GpFileFormat,
    HotStartMode,
    InfillOptimizer,
    InfillStrategy,
    OptimResult,
    QInfillStrategy,
    Recombination,
    RegressionSpec,
    RunInfo,
    Sampling,
    SparseMethod,
    XSpec,
    XType,
)
from . import doe, ego, gp, moe, optim, parallel
from .api import GpMix, Gpx, SparseGpMix, SparseGpx, lhs, sampling
from .ego import Egor, EgorBatch, GpConfig

__all__ = [
    "ConstraintStrategy",
    "CorrelationSpec",
    "Egor",
    "EgorBatch",
    "ExpectedOptimum",
    "GpConfig",
    "GpFileFormat",
    "GpMix",
    "Gpx",
    "HotStartMode",
    "InfillOptimizer",
    "InfillStrategy",
    "OptimResult",
    "QInfillStrategy",
    "Recombination",
    "RegressionSpec",
    "RunInfo",
    "Sampling",
    "SparseGpMix",
    "SparseGpx",
    "SparseMethod",
    "XSpec",
    "XType",
    "config",
    "default_dtype",
    "doe",
    "ego",
    "gp",
    "lhs",
    "moe",
    "optim",
    "parallel",
    "sampling",
]
