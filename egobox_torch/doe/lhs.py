"""Latin hypercube sampling (port of the classic, centered and maximin kinds
of egobox_tpu/doe/lhs.py).

Draws come from an explicit CPU ``torch.Generator`` and are moved to
``device`` afterwards (default: the GPU; ``"cpu"`` for the CPU), so a seed
gives the same design on every device.
torch's streams never reproduce JAX's threefry bits: the designs have the
same distribution as egobox_tpu's, not the same values.
"""

from __future__ import annotations

import torch

from ..config import default_dtype, resolve_device
from .utils import min_pdist_sq


def _column_perms(ns: int, nx: int, generator) -> torch.Tensor:
    """(ns, nx) index matrix: an independent permutation per column."""
    return torch.stack(
        [torch.randperm(ns, generator=generator) for _ in range(nx)], dim=1
    )


def classic_lhs(ns: int, nx: int, generator: torch.Generator, dtype=None,
                device=None) -> torch.Tensor:
    """One point uniformly inside each of ns strata, independently permuted
    per column (ref: lhs.rs:236-257)."""
    device = resolve_device(device)
    dtype = dtype or default_dtype(device)
    u = torch.rand((ns, nx), generator=generator, dtype=dtype)
    strata = (torch.arange(ns, dtype=dtype) / ns)[:, None]
    pts = strata + u / ns
    return torch.gather(pts, 0, _column_perms(ns, nx, generator)).to(device)


def centered_lhs(ns: int, nx: int, generator: torch.Generator, dtype=None,
                 device=None) -> torch.Tensor:
    """Stratum centers, independently permuted per column
    (ref: lhs.rs:259-274)."""
    device = resolve_device(device)
    dtype = dtype or default_dtype(device)
    centers = (torch.arange(ns, dtype=dtype) + 0.5) / ns
    return centers[_column_perms(ns, nx, generator)].to(device)


def maximin_lhs(ns: int, nx: int, generator: torch.Generator,
                centered: bool = False, n_draws: int = 5, dtype=None,
                device=None) -> torch.Tensor:
    """Best of ``n_draws`` random LHS by min pairwise distance
    (ref: lhs.rs:276-297)."""
    build = centered_lhs if centered else classic_lhs
    device = resolve_device(device)
    draws = [build(ns, nx, generator, dtype, device) for _ in range(n_draws)]
    scores = torch.stack([min_pdist_sq(d) for d in draws])
    return draws[int(torch.argmax(scores))]


def scale_to_xlimits(samples: torch.Tensor, xlimits: torch.Tensor):
    """Affine map [0,1]^nx -> xlimits (nx, 2) (ref: doe/src/traits.rs)."""
    lo = xlimits[:, 0]
    hi = xlimits[:, 1]
    return samples * (hi - lo) + lo
