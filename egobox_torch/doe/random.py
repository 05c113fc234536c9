"""Uniform random design (port of egobox_tpu/doe/random.py; ref:
crates/doe/src/random.rs:62-72).

Draws come from an explicit CPU ``torch.Generator`` and move to ``device``
afterwards, so a seed gives the same design on every device (not JAX's
bits: the same distribution).
"""

from __future__ import annotations

import torch

from ..config import default_dtype, resolve_device
from .lhs import scale_to_xlimits


def random_normalized(generator: torch.Generator, ns: int, nx: int,
                      dtype=None, device=None) -> torch.Tensor:
    """ns points uniform in [0, 1]^nx."""
    device = resolve_device(device)
    dtype = dtype or default_dtype(device)
    return torch.rand((ns, nx), generator=generator,
                      dtype=dtype).to(device)


class Random:
    """Object API mirroring egobox_doe::Random."""

    def __init__(self, xlimits, seed=None, device=None):
        device = resolve_device(device)
        self.xlimits = torch.as_tensor(xlimits, dtype=default_dtype(device),
                                       device=device)
        if self.xlimits.ndim != 2 or self.xlimits.shape[1] != 2:
            raise ValueError("xlimits must have shape (nx, 2)")
        self.generator = torch.Generator().manual_seed(
            0 if seed is None else seed)

    def normalized_sample(self, ns: int) -> torch.Tensor:
        return random_normalized(self.generator, ns, self.xlimits.shape[0],
                                 self.xlimits.dtype, self.xlimits.device)

    def sample(self, ns: int) -> torch.Tensor:
        return scale_to_xlimits(self.normalized_sample(ns), self.xlimits)
