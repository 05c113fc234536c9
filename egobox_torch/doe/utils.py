"""Pairwise distance helpers (port of egobox_tpu/doe/utils.py)."""

from __future__ import annotations

import torch


def cdist_sq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared L2 cross-distances (na, nb), by the ||a-b||^2 expansion."""
    a2 = torch.sum(a * a, dim=1)[:, None]
    b2 = torch.sum(b * b, dim=1)[None, :]
    return torch.clamp(a2 + b2 - 2.0 * (a @ b.T), min=0.0)


def cdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """L2 cross-distances (na, nb)."""
    return torch.sqrt(cdist_sq(a, b))


def pdist_sq(x: torch.Tensor) -> torch.Tensor:
    """Condensed squared pairwise distances, row-major upper-triangle order
    (scipy.spatial.distance.pdist order)."""
    n = x.shape[0]
    iu = torch.triu_indices(n, n, offset=1, device=x.device)
    return cdist_sq(x, x)[iu[0], iu[1]]


def pdist(x: torch.Tensor) -> torch.Tensor:
    """Condensed pairwise L2 distances."""
    return torch.sqrt(pdist_sq(x))


def min_pdist_sq(x: torch.Tensor) -> torch.Tensor:
    """Minimum pairwise squared distance (scalar)."""
    n = x.shape[0]
    sq = cdist_sq(x, x)
    sq = sq + torch.diag(torch.full((n,), float("inf"), dtype=sq.dtype,
                                    device=sq.device))
    return torch.min(sq)
