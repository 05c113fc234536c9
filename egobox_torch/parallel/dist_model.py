"""Distributed GP model: the realization on the row blocks and the serving
path against the row-block factor (port of
egobox_tpu/parallel/dist_model.py).

- ``DistGpModel``: the trained GP whose O(n^2) state (``l_feed``, this
  rank's rows of the block-cyclic Cholesky; ``ft_feed`` = L^-1 F;
  ``x_norm_feed``; ``gamma_feed``) stays on its rank. Only O(n) / O(p^2)
  replicated values are shared.
- ``realize_dist_model``: one extra backward solve
  (dist_chol.solve_upperT_blockcyclic) turns the fit's factorization
  residuals into gamma = R^-1 (y - F beta); nothing is gathered.
- ``dist_predict`` / ``dist_predict_var`` / ``dist_predict_valvar``: the
  mean needs one (q, n / D) cross-correlation GEMM + all_reduce per rank;
  the variance one distributed forward solve L rt = r against the factor.
  The formulas of gp/gp.py predict / predict_var (themselves mirroring
  crates/gp/src/algorithm.rs:253-380).

Every function is called by every rank of the model's mesh with the same
(replicated) query points and returns the same (replicated) result.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..gp.kernels import corr_cross
from ..gp.trends import trend_basis
from . import _comm
from .dist_chol import (
    pick_panel_size,
    solve_lower_blockcyclic,
    solve_upperT_blockcyclic,
)
from .dist_fit import _feed_rows, _normalize, dist_likelihood_parts


@dataclasses.dataclass
class DistGpModel:
    """Trained GP whose (n, *) state is held in row blocks, one per rank,
    in block-cyclic feed layout (dist_chol.block_cyclic_perm); the
    ``*_feed`` fields are this rank's rows. Replicated fields are O(n) at
    most.

    ========================  =========================================
    supported                 predict / predict_var / predict_valvar,
                              posterior_cov + sample (q x q replicated),
                              likelihood, sigma2, theta, beta,
                              n_train / dims
    NOT supported             save/load (``save`` raises), use as an
                              Egor / MoE surrogate, gpqa recorder dumps,
                              predict_kth_derivatives
    ========================  =========================================

    To persist or feed downstream consumers, refit without ``mesh=`` (or
    pass ``mesh_materialize=True`` to ``fit_gp``): that returns a plain
    ``GpModel`` at the same theta."""

    x_norm_feed: torch.Tensor  # (n / D, nx) this rank's feed rows
    x_mean: torch.Tensor  # (nx,)
    x_std: torch.Tensor  # (nx,)
    y_mean: torch.Tensor  # (1,)
    y_std: torch.Tensor  # (1,)
    theta: torch.Tensor  # (dim,)
    w_star: Optional[torch.Tensor]  # (nx, ncomp) KPLS rotations or None
    beta: torch.Tensor  # (p, 1)
    gamma_feed: torch.Tensor  # (n / D, 1)
    l_feed: torch.Tensor  # (n / D, n) rows of the Cholesky factor
    ft_feed: torch.Tensor  # (n / D, p) rows of the whitened basis L^-1 F
    gram_chol: torch.Tensor  # (p, p) lower chol of Ft^T Ft
    sigma2: torch.Tensor  # scalar denormalized process variance
    likelihood: torch.Tensor  # scalar reduced likelihood at theta
    mesh: object
    bp: int
    corr: str
    trend: str

    def predict(self, x):
        return dist_predict(self, x)

    def predict_var(self, x):
        return dist_predict_var(self, x)

    def predict_valvar(self, x):
        return dist_predict_valvar(self, x)

    def posterior_cov(self, x):
        return dist_posterior_cov(self, x)

    def sample(self, x, n_traj: int, generator=None, method: str = "eig",
               normals=None):
        return dist_sample(self, x, n_traj, generator, method=method,
                           normals=normals)

    def save(self, path):
        raise NotImplementedError(
            "DistGpModel holds its (n, n) state in row blocks over the "
            "ranks of a mesh and cannot be serialized; refit with "
            "fit_gp(..., mesh_materialize=True) (or without mesh=) to get "
            "a persistable GpModel at the same theta"
        )

    @property
    def n_train(self) -> int:
        return self.x_norm_feed.shape[0] * self.mesh.size

    @property
    def dims(self):
        return (self.x_norm_feed.shape[1], 1)


def realize_dist_model(
    mesh,
    x,
    y,
    theta,
    *,
    corr: str = "squared_exponential",
    trend: str = "constant",
    nugget: Optional[float] = None,
    bp: Optional[int] = None,
    kpls_dim: Optional[int] = None,
) -> DistGpModel:
    """Realize the trained model at ``theta`` on the row blocks: one
    distributed likelihood pass (Gram row blocks, block-cyclic Cholesky,
    forward solves; dist_fit.dist_likelihood_parts) and one distributed
    backward solve for gamma. ``x`` and ``y`` are replicated; the
    normalization is the single-device fit's (ddof=1)."""
    from .sharding import replicated

    x = torch.atleast_2d(replicated(mesh, x))
    dtype = x.dtype
    y = replicated(mesh, y).to(dtype)
    if y.ndim == 1:
        y = y[:, None]
    n = x.shape[0]
    if n % mesh.size != 0:
        raise ValueError(f"n={n} must be divisible by mesh size {mesh.size}")
    if bp is None:
        bp = pick_panel_size(n, mesh.size)
    if nugget is None:
        nugget = 100.0 * torch.finfo(dtype).eps

    w_star = None
    if kpls_dim is not None:
        from ..gp.kpls import pls_rotations

        w_star = pls_rotations(x, y, kpls_dim)
    x_norm, y_norm, (x_mean, x_std, y_mean, y_std) = _normalize(x, y)

    theta = replicated(mesh, theta).to(dtype)
    rlf, (l_feed, _resid, s2n, ft_feed, c, beta, rho_feed) = (
        dist_likelihood_parts(
            mesh, x_norm, y_norm, theta, corr=corr, trend=trend,
            nugget=float(nugget), bp=bp, w_star=w_star, want_model=True,
        )
    )
    gamma_feed = solve_upperT_blockcyclic(mesh, l_feed, rho_feed, bp)
    return DistGpModel(
        x_norm_feed=x_norm[_feed_rows(mesh, n, bp, x.device)],
        x_mean=x_mean, x_std=x_std, y_mean=y_mean, y_std=y_std,
        theta=theta, w_star=w_star, beta=beta, gamma_feed=gamma_feed,
        l_feed=l_feed, ft_feed=ft_feed, gram_chol=c,
        sigma2=s2n * (y_std[0] ** 2), likelihood=rlf,
        mesh=mesh, bp=bp, corr=corr, trend=trend,
    )


def _query(model: DistGpModel, x):
    """Normalized query points (replicated) and their trend basis."""
    x = torch.atleast_2d(torch.as_tensor(x).to(
        device=model.x_mean.device, dtype=model.x_mean.dtype))
    xq = (x - model.x_mean) / model.x_std
    return xq, trend_basis(model.trend, xq)


def _cross_corr_feed(model: DistGpModel, xq_norm: torch.Tensor):
    """r(x_train, x_query) on this rank's training rows (feed layout):
    (n / D, q)."""
    return corr_cross(model.corr, model.x_norm_feed, xq_norm, model.theta,
                      model.w_star)


def dist_predict(model: DistGpModel, x) -> torch.Tensor:
    """Posterior mean at x (q, nx) -> (q,): one (q, n / D) Gram and GEMM
    per rank and an all_reduce; no (n, n) or (n, q) gather (gp/gp.py
    predict, ref algorithm.rs:253-263)."""
    xq, f = _query(model, x)
    r = corr_cross(model.corr, xq, model.x_norm_feed, model.theta,
                   model.w_star)  # (q, n / D)
    y = f @ model.beta + _comm.all_reduce(model.mesh, r @ model.gamma_feed)
    return (y * model.y_std + model.y_mean)[:, 0]


def _rt_sums(model: DistGpModel, rt_feed: torch.Tensor):
    """(sum_rows rt^2, Ft^T rt): row sums, invariant under the row order,
    reduced over the ranks in one all_reduce."""
    q = rt_feed.shape[1]
    s = _comm.all_reduce(model.mesh, torch.cat([
        torch.sum(rt_feed**2, dim=0)[None, :], model.ft_feed.T @ rt_feed]))
    return s[0], s[1:].reshape(-1, q)


def dist_predict_var(model: DistGpModel, x) -> torch.Tensor:
    """Posterior variance at x -> (q,), clipped >= 0: one distributed
    forward solve L rt = r against the factor, then replicated O(p^2 q)
    algebra (gp/gp.py predict_var, ref algorithm.rs:267-307; the u-term
    through the Gram's Cholesky instead of the QR factor, the same
    quadratic form)."""
    return dist_predict_valvar(model, x)[1]


def dist_predict_valvar(model: DistGpModel, x):
    """(mean, variance) sharing the row-block cross-correlation
    (gp/gp.py predict_valvar)."""
    xq, f = _query(model, x)
    r_feed = _cross_corr_feed(model, xq)  # (n / D, q)
    y = f @ model.beta + _comm.all_reduce(model.mesh,
                                          r_feed.T @ model.gamma_feed)
    mean = (y * model.y_std + model.y_mean)[:, 0]

    rt_feed = solve_lower_blockcyclic(model.mesh, model.l_feed, r_feed,
                                      model.bp)
    rt2, ftrt = _rt_sums(model, rt_feed)
    u = torch.linalg.solve_triangular(model.gram_chol, ftrt - f.T,
                                      upper=False)
    mse = model.sigma2 * (1.0 - rt2 + torch.sum(u**2, dim=0))
    return mean, torch.clamp(mse, min=0.0)


def _rt_gram(model: DistGpModel, rt_feed: torch.Tensor):
    """(rt^T rt (q, q), Ft^T rt (p, q)): the full Gram this time (the
    variance needs only its diagonal), in one all_reduce."""
    q = rt_feed.shape[1]
    s = _comm.all_reduce(model.mesh, torch.cat(
        [rt_feed.T @ rt_feed, model.ft_feed.T @ rt_feed]))
    return s[:q], s[q:]


def dist_posterior_cov(model: DistGpModel, x) -> torch.Tensor:
    """Posterior covariance at x (q, nx) -> (q, q), replicated (gp/gp.py
    posterior_cov, ref algorithm.rs:310-326): one distributed forward
    solve against the factor; O(q^2) is reduced, never O(n^2)."""
    xq, f = _query(model, x)
    r_feed = _cross_corr_feed(model, xq)
    rt_feed = solve_lower_blockcyclic(model.mesh, model.l_feed, r_feed,
                                      model.bp)
    rtg, ftrt = _rt_gram(model, rt_feed)
    u = torch.linalg.solve_triangular(model.gram_chol, ftrt - f.T,
                                      upper=False)
    k = corr_cross(model.corr, xq, xq, model.theta, model.w_star)
    return model.sigma2 * (k - rtg + u.T @ u)


def dist_sample(model: DistGpModel, x, n_traj: int,
                generator: Optional[torch.Generator] = None,
                method: str = "eig",
                normals: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Conditioned trajectories at x -> (q, n_traj), as gp/gp.py sample
    (ref algorithm.rs:383-410): the covariance root of the replicated
    (q, q) posterior covariance; only the cross-correlation solve is
    distributed. The standard normals (q, n_traj) are ``normals`` when
    given, else drawn from ``generator`` on the CPU: every rank must
    draw the same ones (the same seed)."""
    cov = dist_posterior_cov(model, x)
    q = cov.shape[0]
    if method == "chol":
        eye = torch.eye(q, dtype=cov.dtype, device=cov.device)
        c = torch.linalg.cholesky(cov + 1e-9 * model.sigma2 * eye)
    elif method == "eig":
        evals, evecs = torch.linalg.eigh(cov)
        evals = torch.clamp(evals, min=1e-9)
        c = evecs @ (torch.sqrt(evals)[:, None] * evecs.T)
    else:
        raise ValueError(f"dist_sample: unknown method {method!r}")
    if normals is None:
        normals = torch.randn((q, n_traj), generator=generator,
                              dtype=torch.float64)
    z = torch.as_tensor(normals).to(dtype=cov.dtype, device=cov.device)
    return dist_predict(model, x)[:, None] + c @ z
