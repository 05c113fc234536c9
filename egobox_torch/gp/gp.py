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
from .likelihood import GpInnerParams
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

    # convenience accessors mirroring the reference API
    @property
    def n_train(self) -> torch.Tensor:
        """The number of active training rows."""
        return torch.sum(self.mask)

    @property
    def dims(self):
        """(input dimension, output dimension)."""
        return (self.x_norm.shape[-1], 1)


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


def _rowwise_grad(fn, x: torch.Tensor) -> torch.Tensor:
    """d fn(x)_i / d x_i for a function whose row i depends on x_i alone
    (every prediction path here): one backward pass of the sum gives every
    row's gradient, the per-row ``jax.grad`` under ``vmap`` of
    egobox_tpu. Inputs that require grad keep the Gram on the plain formula
    (gp/kernels.py), as egobox_tpu differentiates its own formula."""
    with torch.enable_grad():
        xg = x.detach().clone().requires_grad_(True)
        (g,) = torch.autograd.grad(fn(xg).sum(), xg)
    return g


def predict_gradients(model: GpModel, x: torch.Tensor) -> torch.Tensor:
    """d mean / dx per row -> (n, nx), exact by autograd (ref: the
    hand-written jacobians of algorithm.rs:510-550, test oracles here)."""
    return _rowwise_grad(lambda xx: predict(model, xx), x)


def predict_kth_derivatives(model: GpModel, x: torch.Tensor,
                            kx: int) -> torch.Tensor:
    """d mean / dx_kx per row -> (n,) (ref: algorithm.rs:443-506; exact for
    every kernel through the full gradient)."""
    return predict_gradients(model, x)[:, kx]


def predict_var_gradients(model: GpModel, x: torch.Tensor) -> torch.Tensor:
    """d var / dx per row -> (n, nx) (ref: algorithm.rs:554-617)."""
    return _rowwise_grad(lambda xx: predict_var(model, xx), x)


def predict_valvar_gradients(model: GpModel, x: torch.Tensor):
    """(d mean / dx, d var / dx) (ref: algorithm.rs:712-726)."""
    return predict_gradients(model, x), predict_var_gradients(model, x)


def posterior_cov(model: GpModel, x: torch.Tensor) -> torch.Tensor:
    """Posterior covariance at x (m, nx) -> (m, m), denormalized
    (ref: algorithm.rs:310-326)."""
    xnorm = _xnorm(model, x)
    r = _corr_to_train(model, xnorm)
    rt, u = _rt_u(model, xnorm, r)
    k = corr_cross(model.corr, xnorm, xnorm, model.theta, model.w_star)
    return model.sigma2 * (k - rt.T @ rt + u.T @ u)


def sample(model: GpModel, x: torch.Tensor, n_traj: int,
           generator: Optional[torch.Generator] = None, method: str = "eig",
           normals: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Conditioned trajectories at x (m, nx) -> (m, n_traj)
    (ref: algorithm.rs:383-410, 1153-1194): mean + C z with C C^T the
    posterior covariance (its symmetric square root for ``"eig"``, its
    jittered Cholesky factor for ``"chol"``). The standard normals z
    (m, n_traj) are ``normals`` when given (a test hands in egobox_tpu's),
    else drawn from ``generator`` on the CPU."""
    cov = posterior_cov(model, x)
    m = cov.shape[0]
    if method == "chol":
        eye = torch.eye(m, dtype=cov.dtype, device=cov.device)
        c = torch.linalg.cholesky(cov + 1e-9 * model.sigma2 * eye)
    elif method == "eig":
        evals, evecs = torch.linalg.eigh(cov)
        evals = torch.clamp(evals, min=1e-9)
        c = evecs @ (torch.sqrt(evals)[:, None] * evecs.T)
    else:
        raise ValueError(f"sample: unknown method {method!r}")
    if normals is None:
        normals = torch.randn((m, n_traj), generator=generator,
                              dtype=torch.float64)
    z = normals.to(dtype=cov.dtype, device=cov.device)
    return predict(model, x)[:, None] + c @ z


def inner_params(model: GpModel) -> GpInnerParams:
    """The GLS byproducts of the model."""
    return GpInnerParams(sigma2=model.sigma2, beta=model.beta,
                         gamma=model.gamma, r_chol=model.r_chol, ft=model.ft,
                         ft_qr_r=model.ft_qr_r)
