"""Trend (regression) bases: constant, linear, quadratic
(port of egobox_tpu/gp/trends.py)."""

from __future__ import annotations

import torch

TREND_NAMES = ("constant", "linear", "quadratic")


def trend_basis(name: str, x: torch.Tensor) -> torch.Tensor:
    """Regression basis F(x) for x (..., n, nx) -> (..., n, p).

    - constant:  [1]                       (ref: mean_models.rs:37-53)
    - linear:    [1, x_1..x_nx]            (ref: mean_models.rs:63-82)
    - quadratic: [1, x, {x_i x_j, j >= i}] (ref: mean_models.rs:92-128)
    """
    nx = x.shape[-1]
    ones = torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    if name == "constant":
        return ones
    if name == "linear":
        return torch.cat([ones, x], dim=-1)
    if name == "quadratic":
        parts = [ones, x]
        for k in range(nx):
            parts.append(x[..., k:] * x[..., k:k + 1])
        return torch.cat(parts, dim=-1)
    raise ValueError(f"unknown trend: {name}")


def n_basis(name: str, nx: int) -> int:
    if name == "constant":
        return 1
    if name == "linear":
        return 1 + nx
    if name == "quadratic":
        return 1 + nx + nx * (nx + 1) // 2
    raise ValueError(f"unknown trend: {name}")


def trend_jacobian(name: str, x1: torch.Tensor) -> torch.Tensor:
    """Jacobian of the basis at one point x1 (nx,) -> (p, nx)."""
    return torch.func.jacfwd(lambda v: trend_basis(name, v[None, :])[0])(x1)
