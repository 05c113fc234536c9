"""Full-factorial design (port of egobox_tpu/doe/full_factorial.py; ref:
crates/doe/src/full_factorial.rs:43-81).

Level allocation is a tiny data-dependent host loop (configuration-level
work); the grid fill is vectorized in numpy and the result goes to
``device`` (default: the GPU; ``"cpu"`` for the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import default_dtype, resolve_device
from .lhs import scale_to_xlimits


def full_factorial_normalized(ns: int, nx: int, dtype=None,
                              device=None) -> torch.Tensor:
    """The first ns points of the smallest full-factorial grid in [0, 1]^nx
    with at least ns points, levels allocated as evenly as possible."""
    device = resolve_device(device)
    dtype = dtype or default_dtype(device)
    num_list = np.ones(nx, dtype=np.int64)
    weights = np.full(nx, 1.0 / nx)
    while int(np.prod(num_list)) < ns:
        w = num_list / num_list.sum()
        ind = int(np.argmax(weights - w))
        num_list[ind] += 1

    nrows = int(np.prod(num_list))
    doe = np.zeros((nrows, nx))
    level_repeat = nrows
    range_repeat = 1
    for j in range(nx):
        n = int(num_list[j])
        level_repeat //= n
        levels = np.arange(n) / (n - 1) if n > 1 else np.arange(n).astype(float)
        chunk = np.repeat(levels, level_repeat)
        doe[:, j] = np.tile(chunk, range_repeat)
        range_repeat *= n
    return torch.as_tensor(doe[:ns], dtype=dtype, device=device)


class FullFactorial:
    """Object API mirroring egobox_doe::FullFactorial."""

    def __init__(self, xlimits, device=None):
        device = resolve_device(device)
        self.xlimits = torch.as_tensor(xlimits, dtype=default_dtype(device),
                                       device=device)
        if self.xlimits.ndim != 2 or self.xlimits.shape[1] != 2:
            raise ValueError("xlimits must have shape (nx, 2)")

    def normalized_sample(self, ns: int) -> torch.Tensor:
        return full_factorial_normalized(ns, self.xlimits.shape[0],
                                         self.xlimits.dtype,
                                         self.xlimits.device)

    def sample(self, ns: int) -> torch.Tensor:
        return scale_to_xlimits(self.normalized_sample(ns), self.xlimits)
