"""Distributed GP MLE: likelihood value AND analytic adjoint on the row
blocks (port of egobox_tpu/parallel/dist_fit.py).

- ``dist_likelihood_parts``: the exact reduced likelihood with the
  block-cyclic distributed Cholesky and forward solves, returning the
  factorization residuals the gradient needs (the distributed twin of
  gp/likelihood.py ``make_neg_rlf_residual_api``);
- ``dist_grad_theta``: the analytic concentrated-likelihood adjoint
      dphi/dtheta = sum_ij [(R^-1 - gamma gamma^T / s2) o R]_ij dlog r_ij
  evaluated on the row blocks: C's rows follow L's feed layout, R^-1's rows
  come from the distributed triangular inverse, the trace contraction is
  reduced once, explicitly. ``grad_probes > 0`` (squared exponential) takes
  the distributed Hutchinson estimator instead: no inverse, O(n (d+2) p)
  extra memory;
- ``make_neg_rlf_distributed``: the fun_and_res / grad_from_res pair in
  log10-theta space for optim/lbfgsb.py ``minimize_lbfgsb``;
- ``fit_theta_distributed``: subsample warm start (one-device multistart
  on an m-point subsample) + distributed full-data polish.

Every rank runs the same L-BFGS on the same (all_reduced) values, so its
host-side decisions agree without a collective of their own. ``x`` and
``y`` are replicated; everything named ``*_feed`` is this rank's block of
feed rows. Restrictions (enforced): full mask, n divisible by mesh size x
panel size. KPLS is supported: the PLS rotations are computed once on the
replicated data and passed to every row block.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..gp import likelihood as _lik
from ..gp.kernels import _l1_dphi, corr_cross
from ..gp.trends import trend_basis
from ..ops.chol_kernel import cholesky_nan
from . import _comm
from .dist_chol import (
    _local_indices,
    block_cyclic_perm,
    cholesky_blockcyclic,
    pick_panel_size,
    rinv_rows_feed,
    solve_lower_blockcyclic,
    solve_upperT_blockcyclic,
    tri_inverse_feed,
)


def _feed_rows(mesh, n: int, bp: int, device) -> torch.Tensor:
    """This rank's global rows in feed order (its block of feedperm)."""
    _, gidx = _local_indices(n, mesh.size, bp, mesh.rank)
    return torch.as_tensor(gidx, device=device)


def _normalize(x, y):
    """(x_norm, y_norm, (x_mean, x_std, y_mean, y_std)) with ddof=1, as
    the single-device fit on a full mask (gp/fit.py fit_gp_core)."""
    def stats(v):
        mean, std = v.mean(dim=0), v.std(dim=0, correction=1)
        return mean, torch.where(std <= 0, torch.ones_like(std), std)

    x_mean, x_std = stats(x)
    y_mean, y_std = stats(y)
    return ((x - x_mean) / x_std, (y - y_mean) / y_std,
            (x_mean, x_std, y_mean, y_std))


def _gram_feed(mesh, bp, corr, nugget, x_feed, x_rep, theta, w_star):
    """This rank's rows of the regularized Gram in feed layout,
    R[feedperm, :]: the row block through ``corr_cross`` (K1 for large
    float32 L1-family blocks on CUDA), an exact unit diagonal and the
    Gershgorin-scaled jitter of likelihood._build_r, the row-sum max
    reduced with MAX."""
    n = x_rep.shape[0]
    r = corr_cross(corr, x_feed, x_rep, theta, w_star)
    diag = (torch.arange(r.shape[0], device=r.device),
            _feed_rows(mesh, n, bp, r.device))
    r[diag] = 1.0
    row_max = _comm.all_reduce(
        mesh, torch.amax(torch.linalg.vector_norm(r, ord=1, dim=1)), "max")
    r[diag] += nugget * torch.clamp(row_max, min=1.0)
    return r


def _diag_log10_sum(mesh, bp, l_feed):
    """sum_i log10 L_ii from L in feed layout (each diagonal entry at
    (local row, its global row))."""
    n = l_feed.shape[1]
    d = l_feed[torch.arange(l_feed.shape[0], device=l_feed.device),
               _feed_rows(mesh, n, bp, l_feed.device)]
    return _comm.all_reduce(mesh, torch.sum(torch.log10(d)))


def dist_likelihood_parts(
    mesh,
    x_norm: torch.Tensor,  # (n, nx) normalized, replicated
    y_norm: torch.Tensor,  # (n, 1) normalized, replicated
    theta: torch.Tensor,
    *,
    corr: str = "squared_exponential",
    trend: str = "constant",
    nugget: float,
    bp: Optional[int] = None,
    w_star: Optional[torch.Tensor] = None,
    want_model: bool = False,
):
    """Distributed reduced likelihood + gradient residuals.

    Returns ``(rlf, aux)`` with aux = (l_feed, resid, sigma2_norm): l_feed
    this rank's rows of L in block-cyclic feed layout, resid the
    natural-order GLS residual y_norm - F beta (replicated (n, 1)),
    sigma2_norm the normalized process variance. Failure semantics of the
    single-device reduced_likelihood: a non-PD Gram or an ill-conditioned
    Ft gives rlf = -inf on every rank (fit_gp's nugget escalation relies
    on it).

    ``want_model=True`` extends aux with what the model realization needs
    (parallel/dist_model.py): ft_feed = L^-1 F (feed rows), gram_chol =
    chol(Ft^T Ft) (replicated (p, p) lower), beta (p, 1), and rho_feed =
    yt - Ft beta (feed rows), whose backward solve L^T gamma = rho gives
    gamma."""
    n = x_norm.shape[0]
    if bp is None:
        bp = pick_panel_size(n, mesh.size)
    rows = _feed_rows(mesh, n, bp, x_norm.device)

    r_feed = _gram_feed(mesh, bp, corr, nugget, x_norm[rows], x_norm, theta,
                        w_star)
    l_feed = cholesky_blockcyclic(mesh, r_feed, bp)
    del r_feed

    fx = trend_basis(trend, x_norm)  # natural order, replicated
    rhs_feed = torch.cat([fx, y_norm], dim=1)[rows]  # (n / D, p + 1)
    sol = solve_lower_blockcyclic(mesh, l_feed, rhs_feed, bp)
    ft, yt = sol[:, :-1], sol[:, -1:]  # feed rows: the GLS inner products
    # below are sums over rows, whatever their order

    gram = _comm.all_reduce(mesh, ft.T @ ft)  # (p, p)
    c = cholesky_nan(gram)
    dq = torch.abs(torch.diagonal(c))
    cond_ok = (torch.amin(dq) / torch.clamp(torch.amax(dq), min=1e-300)
               ) > 1e-10

    fty = _comm.all_reduce(mesh, ft.T @ yt)
    beta = torch.linalg.solve_triangular(
        c.T, torch.linalg.solve_triangular(c, fty, upper=False), upper=True)
    rho = yt - ft @ beta
    sigma2_norm = _comm.all_reduce(mesh, torch.sum(rho**2)) / n

    logdet = 2.0 * _diag_log10_sum(mesh, bp, l_feed) / n
    rlf = -n * (torch.log10(sigma2_norm) + logdet)
    rlf = torch.where(torch.isfinite(rlf) & cond_ok, rlf,
                      torch.full_like(rlf, -float("inf")))

    resid = y_norm - fx @ beta  # natural order, replicated
    if want_model:
        return rlf, (l_feed, resid, sigma2_norm, ft, c, beta, rho)
    return rlf, (l_feed, resid, sigma2_norm)


def _dist_sqexp_dphi_stoch(
    mesh,
    x_norm: torch.Tensor,
    theta: torch.Tensor,
    l_feed: torch.Tensor,
    resid: torch.Tensor,
    sigma2_norm: torch.Tensor,
    *,
    bp: int,
    probes: int,
    w_star: Optional[torch.Tensor] = None,
):
    """Distributed Hutchinson trace contraction, the multi-rank twin of
    gp/likelihood.py ``_sqexp_dphi_stoch``: no inverse. gamma and W =
    R^-1 Z come from the two block-cyclic triangular solves, every
    (R o D_k) v product expands into R-matvecs on the row-block factor
    (R_feed = L L^T: t = all_reduce(L_loc^T u_loc), ru = L_loc t), and
    the row contractions are reduced in one all_reduce. Extra memory
    O(n (d+2) p) against two more (n, n) feed buffers of the exact
    adjoint. The probes are the single-device path's fixed ones
    (likelihood._rademacher_probes), and every contraction is invariant
    under a permutation of rows: the same estimate as _sqexp_dphi_stoch
    up to rounding."""
    n, nx = x_norm.shape
    rows = _feed_rows(mesh, n, bp, x_norm.device)
    z = _lik._rademacher_probes(n, probes, x_norm.dtype, x_norm.device)
    z_loc, x_loc = z[rows], x_norm[rows]

    # [gamma | W] = R^-1 [resid | Z] via the block-cyclic solve pair
    rhs = torch.cat([resid[rows], z_loc], dim=1)
    sol = solve_upperT_blockcyclic(
        mesh, l_feed, solve_lower_blockcyclic(mesh, l_feed, rhs, bp), bp)
    g_loc = sol[:, 0]  # gamma rows (feed)
    w_loc = sol[:, 1:]  # R^-1 Z rows (feed)
    n_loc = x_loc.shape[0]
    x2 = x_loc * x_loc
    v3 = (x_loc[:, :, None] * z_loc[:, None, :]).reshape(n_loc, nx * probes)
    v4 = x_loc * g_loc[:, None]
    u = torch.cat([z_loc, w_loc, v3, v4, g_loc[:, None]], dim=1)
    # R u = L (L^T u): the columns of l_feed are in global (natural)
    # order, so L^T u is a sum over the row blocks
    t_all = _comm.all_reduce(mesh, l_feed.T @ u)  # (n, p')
    ru = l_feed @ t_all  # (n_loc, p')
    a = ru[:, :probes]  # (R Z) rows
    b = ru[:, probes:2 * probes]  # (R W) rows
    gmat = ru[:, 2 * probes:(2 + nx) * probes].reshape(n_loc, nx, probes)
    rv4 = ru[:, (2 + nx) * probes:(2 + nx) * probes + nx]
    rg = ru[:, -1]  # (R gamma) rows
    h = torch.sum(w_loc * a + z_loc * b, dim=1)  # (n_loc,)
    m3 = torch.sum(w_loc[:, None, :] * gmat, dim=2)  # (n_loc, nx)
    sums = _comm.all_reduce(mesh, torch.cat([
        x2.T @ h,  # term12
        torch.sum(x_loc * m3, dim=0),  # term3
        torch.sum(v4 * rv4, dim=0),  # q
        x2.T @ (g_loc * rg),
    ]))
    term12, term3, q, xg = sums.reshape(4, nx)
    t_est = (term12 - 2.0 * term3) / probes
    # exact rank-1 gamma term: gamma^T (R o D_k) gamma
    ug = 2.0 * xg - 2.0 * q
    s = t_est - ug / torch.clamp(sigma2_norm, min=1e-300)
    if w_star is None:
        return -theta * s
    return -theta * ((w_star**2).T @ s)


def dist_grad_theta(
    mesh,
    x_norm: torch.Tensor,
    theta: torch.Tensor,
    l_feed: torch.Tensor,
    resid: torch.Tensor,
    sigma2_norm: torch.Tensor,
    *,
    corr: str = "squared_exponential",
    bp: Optional[int] = None,
    w_star: Optional[torch.Tensor] = None,
    grad_probes: int = 0,
):
    """dphi/dtheta of phi(theta) = sum_ij C_ij log r_ij with
    C = (R^-1 - gamma gamma^T / s2) o R, on the row blocks (the
    distributed gp/likelihood.py ``_grad_trace_core``). The diagonal of C
    multiplies dlog r_ii = 0 for every kernel, so the contraction takes
    the raw cross-correlation rows (no jitter rebuild). Each rank
    contracts its own rows and the sum is reduced exactly once
    (egobox_tpu's shard_map AD does that reduction implicitly; a second
    one would multiply the gradient by the mesh size).

    ``grad_probes > 0`` routes squared-exponential fits to the
    O(n^2 d p / D) Hutchinson estimator (_dist_sqexp_dphi_stoch) instead
    of the exact adjoint's explicit R^-1; the same kill-switch as the
    single-device path: EGOBOX_NO_STOCH_GRAD=1."""
    n = x_norm.shape[0]
    if bp is None:
        bp = pick_panel_size(n, mesh.size)
    if (
        grad_probes
        and corr == "squared_exponential"
        and os.environ.get("EGOBOX_NO_STOCH_GRAD") != "1"
    ):
        return _dist_sqexp_dphi_stoch(
            mesh, x_norm, theta, l_feed, resid, sigma2_norm,
            bp=bp, probes=grad_probes, w_star=w_star,
        )
    rows = _feed_rows(mesh, n, bp, x_norm.device)
    x_loc = x_norm[rows]

    c = rinv_rows_feed(mesh, tri_inverse_feed(mesh, l_feed, bp), bp)
    gamma_loc = c @ resid  # (n_loc, 1): R^-1 (y - F beta), feed rows
    n_loc = c.shape[0]
    g_feed = _comm.gather_rows(mesh, gamma_loc[:, 0], n, mesh.rank * n_loc)
    gamma_nat = torch.empty_like(g_feed)
    gamma_nat[torch.as_tensor(block_cyclic_perm(n, mesh.size, bp),
                              device=g_feed.device)] = g_feed
    # C = (R^-1 - gamma gamma^T / s2) o R, in place on the R^-1 rows
    c.sub_(gamma_loc * (gamma_nat[None, :]
                        / torch.clamp(sigma2_norm, min=1e-300)))
    c.mul_(corr_cross(corr, x_loc, x_norm, theta, w_star))

    if corr == "squared_exponential":
        # the closed-form contraction (likelihood._sqexp_dphi) on the row
        # blocks: S_k = sum_ij C_ij (x_ik - x_jk)^2 from three
        # matmul-shaped sums; row-indexed factors take the feed rows,
        # column-indexed ones the natural (replicated) arrays
        s = _comm.all_reduce(
            mesh,
            torch.sum(c, dim=1) @ (x_loc * x_loc)
            + torch.sum(c, dim=0) @ (x_norm * x_norm)
            - 2.0 * torch.sum(x_loc * (c @ x_norm), dim=0),
        )
        if w_star is None:
            return -theta * s
        return -theta * ((w_star**2).T @ s)
    return _comm.all_reduce(
        mesh, _l1_dphi(corr, c, x_loc, x_norm, theta, w_star))


def make_neg_rlf_distributed(
    mesh,
    x,
    y,
    *,
    corr: str = "squared_exponential",
    trend: str = "constant",
    nugget: Optional[float] = None,
    bp: Optional[int] = None,
    kpls_dim: Optional[int] = None,
    grad_probes: int = 0,
):
    """fun_and_res / grad_from_res pair in log10-theta space for
    minimize_lbfgsb, the distributed twin of
    gp/likelihood.py ``make_neg_rlf_residual_api``. ``x`` and ``y`` are
    replicated; the normalization (ddof=1, as fit_gp_core on a full mask)
    happens here once. ``grad_probes``: see dist_grad_theta.
    ``kpls_dim``: fit in the KPLS-reduced theta space, the PLS rotations
    computed once on the replicated raw data, as the single-device fit
    does."""
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
    nugget = float(nugget)

    w_star = None
    if kpls_dim is not None:
        from ..gp.kpls import pls_rotations

        w_star = pls_rotations(x, y, kpls_dim)
    x_norm, y_norm, _ = _normalize(x, y)

    def fun_and_res(t_log10):
        theta = 10.0**t_log10
        rlf, (l_feed, resid, s2) = dist_likelihood_parts(
            mesh, x_norm, y_norm, theta,
            corr=corr, trend=trend, nugget=nugget, bp=bp, w_star=w_star,
        )
        return -rlf, (theta, l_feed, resid, s2)

    def grad_from_res(t_log10, res):
        theta, l_feed, resid, s2 = res
        dphi = dist_grad_theta(
            mesh, x_norm, theta, l_feed, resid, s2, corr=corr, bp=bp,
            w_star=w_star, grad_probes=grad_probes,
        )
        # d(-rlf)/dt through theta = 10^t: the ln10 factors cancel
        # (cf. make_neg_rlf_residual_api.grad_from_res)
        grad = dphi * theta
        return torch.where(torch.isfinite(grad), grad, torch.zeros_like(grad))

    return fun_and_res, grad_from_res


def fit_theta_distributed(
    mesh,
    x,
    y,
    *,
    corr: str = "squared_exponential",
    trend: str = "constant",
    theta0=None,
    theta_bounds=None,
    max_iters: int = 50,
    nugget: Optional[float] = None,
    bp: Optional[int] = None,
    subsample_warmstart: Optional[int] = None,
    polish_iters: int = 5,
    seed: int = 42,
    kpls_dim: Optional[int] = None,
    grad_probes: int = 0,
):
    """Distributed full-data MLE for theta: an optional warm start, the
    one-device multistart ``fit_gp`` on an m-point subsample (the
    permutation from ``np.random.default_rng(seed)``, as egobox_tpu's),
    run by rank 0 and broadcast, then an L-BFGS polish whose likelihood
    AND gradient run on the row blocks. Returns (theta, the L-BFGS
    result), theta replicated (dim,). ``grad_probes``: see
    dist_grad_theta (the memory-light stochastic-trace gradient)."""
    import numpy as np

    from ..gp.fit import GP_DEFAULT_THETA_BOUNDS, GP_DEFAULT_THETA_INIT, fit_gp
    from ..optim.lbfgsb import minimize_lbfgsb
    from .sharding import replicated

    x = torch.atleast_2d(replicated(mesh, x))
    dtype, device = x.dtype, x.device
    y = replicated(mesh, y).to(dtype)
    if y.ndim == 1:
        y = y[:, None]
    n, nx = x.shape
    dim = kpls_dim if kpls_dim is not None else nx

    tb = torch.as_tensor(
        theta_bounds if theta_bounds is not None else GP_DEFAULT_THETA_BOUNDS,
        dtype=dtype).to(device)
    if tb.ndim == 1:
        tb = torch.broadcast_to(tb[None, :], (dim, 2))
    lo10, up10 = torch.log10(tb[:, 0]), torch.log10(tb[:, 1])

    if theta0 is None and subsample_warmstart and n > subsample_warmstart:
        theta0 = torch.empty((dim,), dtype=dtype, device=device)
        if mesh.rank == 0:
            rng = np.random.default_rng(seed)
            idx = torch.as_tensor(rng.permutation(n)[:subsample_warmstart],
                                  device=device)
            m0 = fit_gp(
                x[idx], y[idx], corr=corr, trend=trend,
                theta_bounds=theta_bounds, nugget=nugget, seed=seed,
                kpls_dim=kpls_dim,
            )
            theta0 = torch.clamp(m0.theta, tb[:, 0], tb[:, 1])
        theta0 = _comm.broadcast(mesh, theta0, 0)
        max_iters = polish_iters
    elif theta0 is None:
        theta0 = torch.full((dim,), GP_DEFAULT_THETA_INIT, dtype=dtype,
                            device=device)
    theta0 = torch.broadcast_to(
        torch.as_tensor(theta0, dtype=dtype).to(device), (dim,))

    fun_and_res, grad_from_res = make_neg_rlf_distributed(
        mesh, x, y, corr=corr, trend=trend, nugget=nugget, bp=bp,
        kpls_dim=kpls_dim, grad_probes=grad_probes,
    )
    res = minimize_lbfgsb(
        None, torch.log10(theta0), lo10, up10, max_iters=max_iters,
        fun_and_res=fun_and_res, grad_from_res=grad_from_res,
    )
    return 10.0**res.x, res
