"""Gaussian-process model and its prediction paths
(port of egobox_tpu/gp/gp.py).

The trained model is a dataclass of tensors; every prediction is a plain
function of (model, x) on the model's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .kernels import corr_cross
from .trends import trend_basis


@dataclass(frozen=True)
class GpModel:
    """Trained GP (ref struct: gp/src/algorithm.rs:174-192).

    ``mask`` marks active training rows; padded rows are exact no-ops in
    every code path (zero gamma entries, identity Cholesky block)."""

    x_norm: torch.Tensor  # (n, nx) normalized training inputs
    x_mean: torch.Tensor  # (nx,)
    x_std: torch.Tensor  # (nx,)
    y_mean: torch.Tensor  # (1,)
    y_std: torch.Tensor  # (1,)
    theta: torch.Tensor  # (dim,)
    w_star: Optional[torch.Tensor]  # (nx, ncomp) KPLS weights or None
    beta: torch.Tensor  # (p, 1)
    gamma: torch.Tensor  # (n, 1)
    r_chol: torch.Tensor  # (n, n)
    ft: torch.Tensor  # (n, p)
    ft_qr_r: torch.Tensor  # (p, p)
    sigma2: torch.Tensor  # scalar (denormalized process variance)
    likelihood: torch.Tensor  # scalar reduced likelihood at the optimum
    mask: torch.Tensor  # (n,) active-row mask
    corr: str
    trend: str


def _xnorm(model: GpModel, x: torch.Tensor) -> torch.Tensor:
    return (x - model.x_mean) / model.x_std


def _corr_to_train(model: GpModel, xnorm: torch.Tensor) -> torch.Tensor:
    r = corr_cross(model.corr, xnorm, model.x_norm, model.theta,
                   model.w_star)
    return r * model.mask.to(r.dtype)[None, :]


def _mean(model: GpModel, xnorm: torch.Tensor, r: torch.Tensor):
    y = trend_basis(model.trend, xnorm) @ model.beta + r @ model.gamma
    return (y * model.y_std + model.y_mean)[:, 0]


def predict(model: GpModel, x: torch.Tensor) -> torch.Tensor:
    """Posterior mean at x (n, nx) -> (n,) (ref: algorithm.rs:253-263)."""
    xnorm = _xnorm(model, x)
    return _mean(model, xnorm, _corr_to_train(model, xnorm))


def _rt_u(model: GpModel, xnorm: torch.Tensor, r: torch.Tensor):
    """rt = L^-1 r^T ; u = Rqr^-T (Ft^T rt - F^T) (ref: algorithm.rs:330-369)."""
    rt = torch.linalg.solve_triangular(model.r_chol, r.T, upper=False)
    f = trend_basis(model.trend, xnorm)
    rhs = model.ft.T @ rt - f.T  # (p, m)
    u = torch.linalg.solve_triangular(model.ft_qr_r.T, rhs, upper=False)
    return rt, u


def _mse(model: GpModel, rt, u):
    mse = model.sigma2 * (
        1.0 - torch.sum(rt**2, dim=0) + torch.sum(u**2, dim=0)
    )
    return torch.clamp(mse, min=0.0)


def predict_var(model: GpModel, x: torch.Tensor) -> torch.Tensor:
    """Posterior variance at x -> (n,), clipped >= 0
    (ref: algorithm.rs:267-307)."""
    xnorm = _xnorm(model, x)
    r = _corr_to_train(model, xnorm)
    return _mse(model, *_rt_u(model, xnorm, r))


def predict_valvar(model: GpModel, x: torch.Tensor):
    """(mean, variance) sharing the correlation work."""
    xnorm = _xnorm(model, x)
    r = _corr_to_train(model, xnorm)
    return _mean(model, xnorm, r), _mse(model, *_rt_u(model, xnorm, r))
