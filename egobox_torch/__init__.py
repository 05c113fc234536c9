"""PyTorch / CUDA port of egobox_tpu's dense kriging path.

The port mirrors egobox_tpu's module layout and function names; egobox_tpu
stays the reference it is tested against. This package imports neither jax
nor egobox_tpu, and it imports on a host without nvcc or a GPU: the CUDA
kernels under ``csrc/`` are compiled at their first launch.
"""

from . import config
from .config import default_dtype

__all__ = ["config", "default_dtype"]
