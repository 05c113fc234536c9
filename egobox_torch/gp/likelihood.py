"""Concentrated (reduced) GP log-likelihood, GLS inner parameters and the
analytic likelihood adjoint (port of egobox_tpu/gp/likelihood.py).

- R is assembled from the kernel Gram (unit diagonal + Gershgorin-scaled
  nugget), optionally masked so a padded design computes the exact
  likelihood of its active rows;
- a failed factorization (non-PD R, ill-conditioned Ft) gives a -inf
  likelihood, never an exception, so a multistart simply discards that
  theta (ref: algorithm.rs:893-896);
- the gradient never differentiates through the n x n Cholesky: it is the
  closed-form trace contraction evaluated from the kept factorization;
- ``theta`` is one vector (dim,) or a stack (b, dim): the lanes and
  line-search trials of a multistart on a small design go through one
  evaluation, every (n, n) quantity carrying the leading axis. A stack may
  come with a mask, and with its own data per theta: ``y_norm`` (b, n, 1)
  and ``y_std`` (b,) (the outputs x lanes of one EGO iteration share the
  design, not the data), ``x_norm`` (b, n, nx) and ``mask`` (b, n) (the
  problems of a batch have designs of their own).
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple, Optional

import torch

from ..doe import threefry
from ..ops.chol_kernel import PRECISIONS, cholesky_nan, panel_cholesky
from .kernels import (_STACK_BUDGET, _l1_dphi, _log_corr_terms, _takes_k1,
                      corr_cross, corr_gram_row_sums)
from .trends import trend_basis

_LN10 = 2.302585092994046

#: matrices at or below this order always take the library Cholesky
_CHOL_NATIVE_MAX = 4096

#: seed of the fixed Rademacher probes of the stochastic sqexp gradient
_PROBE_SEED = 0xE60B0


def _cholesky(r: torch.Tensor) -> torch.Tensor:
    """Cholesky dispatch for the likelihood hot path.

    ``EGOBOX_CHOL`` is read at every call (egobox_tpu reads it when a
    function is traced):

    - unset / ``native``: ``torch.linalg.cholesky_ex``;
    - ``pallas:<block>:<prec>`` (e.g. ``pallas:256:highest``): the blocked
      Cholesky whose panels run the K2 kernel (ops/chol_kernel.py), trailing
      GEMMs at ``prec``.

    Matrices with n <= 4096 always take the native path; above, a stack
    of matrices goes through the K2 driver one matrix after the other.
    egobox_tpu's ``blk:`` variant is not ported and raises. A non-PD R
    gives NaN.
    """
    spec = os.environ.get("EGOBOX_CHOL", "native")
    parts = spec.split(":")
    if spec != "native" and not (
        len(parts) == 3 and parts[0] == "pallas" and parts[1].isdigit()
        and parts[2] in PRECISIONS
    ):
        raise ValueError(
            f"EGOBOX_CHOL={spec!r}: egobox_torch supports 'native' and "
            "'pallas:<block>:<highest|high|default>'"
        )
    if spec == "native" or r.shape[-1] <= _CHOL_NATIVE_MAX:
        return cholesky_nan(r)
    if r.ndim > 2:
        n = r.shape[-1]
        return torch.stack([_cholesky(m) for m in r.reshape(-1, n, n)]
                           ).reshape(r.shape)
    return panel_cholesky(r, block=int(parts[1]), precision=parts[2])


class GpInnerParams(NamedTuple):
    """GLS byproducts reused by predict (ref: algorithm.rs:47-60)."""

    sigma2: torch.Tensor  # process variance, denormalized (scalar)
    beta: torch.Tensor  # (p, 1) GLS trend coefficients
    gamma: torch.Tensor  # (n, 1) correlation weights
    r_chol: torch.Tensor  # (n, n) lower Cholesky of R
    ft: torch.Tensor  # (n, p) L^-1 F
    ft_qr_r: torch.Tensor  # (p, p) R factor of qr(ft)


def _lead(v: torch.Tensor, lead) -> torch.Tensor:
    """A scalar-like ``v`` as a 0-d tensor; one value per theta of a stack
    shaped ``lead``."""
    return v.reshape(()) if v.numel() == 1 else v.reshape(lead)


def _gram_stack(corr, x_norm, thetas, w_star):
    """R(x, x) for every row of ``thetas`` (b, dim): (b, n, n), on one
    design x_norm (n, nx) or one per theta (b, n, nx). sqexp takes the
    matmul expansion; the L1 family launches K1 theta by theta where
    ``_takes_k1`` says so (large float32 designs on the GPU) and broadcasts
    the log-space formula over chunks of the stack elsewhere; KPLS weights
    go theta by theta through ``corr_cross``."""
    b = thetas.shape[0]
    n, nx = x_norm.shape[-2:]
    per_theta = x_norm.ndim == 3
    if corr == "squared_exponential":
        if w_star is None:
            c = thetas**2
        else:
            c = torch.sum((thetas[:, None, :] * w_star) ** 2, dim=2)
        a = (x_norm if per_theta else x_norm[None]) * torch.sqrt(c)[:, None, :]
        a2 = torch.sum(a * a, dim=2)
        sq = torch.clamp(a2[:, :, None] + a2[:, None, :] - 2.0 * (a @ a.mT),
                         min=0.0)
        return torch.exp(-0.5 * sq)
    x_of = (lambda i: x_norm[i]) if per_theta else (lambda i: x_norm)
    if w_star is not None or _takes_k1(corr, x_of(0), x_of(0), thetas[0],
                                       None):
        return torch.stack([
            corr_cross(corr, x_of(i), x_of(i), thetas[i], w_star)
            for i in range(b)])
    step = max(1, _STACK_BUDGET // max(1, n * n * nx))
    if not per_theta:
        dabs = torch.abs(x_norm[:, None, :] - x_norm[None, :, :])[None]
    out = []
    for s in range(0, b, step):
        if per_theta:
            xs = x_norm[s:s + step]
            dabs = torch.abs(xs[:, :, None, :] - xs[:, None, :, :])
        out.append(torch.exp(_log_corr_terms(
            corr, dabs, thetas[s:s + step, None, None, :], True)))
    return torch.cat(out)


def _build_r(corr, x_norm, theta, w_star, nugget, mask):
    """Assemble the regularized correlation matrix R, (n, n) for one theta
    and (b, n, n) for a stack of them.

    The jitter is ``nugget`` times the largest Gershgorin row sum of R
    (not differentiated): it keeps chol(R) well-posed for any theta while
    leaving well-conditioned fits (row sums ~ 1) untouched. With a mask
    ((n,), or (b, n) for a stack) the padded block is the identity. The
    diagonal is written in place on the fresh Gram tensor. For one theta
    and no mask the row sums come with the Gram (from the K1 kernel where
    it builds it)."""
    if theta.ndim == 2:
        r = _gram_stack(corr, x_norm, theta, w_star)
        if mask is not None:
            m = mask.to(r.dtype)
            r.mul_(m[..., :, None] * m[..., None, :])
        torch.diagonal(r, dim1=-2, dim2=-1).fill_(1.0)  # exact unit diagonal
        sums = torch.sum(torch.abs(r), dim=-1)
    elif mask is None:
        r, sums = corr_gram_row_sums(corr, x_norm, theta, w_star)
    else:
        r = corr_cross(corr, x_norm, x_norm, theta, w_star)
        m = mask.to(r.dtype)
        r.mul_(m[:, None] * m[None, :])
        r.diagonal().fill_(1.0)  # exact unit diagonal
        sums = torch.sum(torch.abs(r), dim=1)
    row_max = torch.amax(sums, dim=-1, keepdim=True).detach()
    torch.diagonal(r, dim1=-2, dim2=-1).add_(
        nugget * torch.clamp(row_max, min=1.0))
    return r


def _solve_lower(l_fac, b):
    return torch.linalg.solve_triangular(l_fac, b, upper=False)


def _solve_upper(u_fac, b):
    return torch.linalg.solve_triangular(u_fac, b, upper=True)


def reduced_likelihood(
    corr: str,
    trend: str,
    x_norm: torch.Tensor,
    y_norm: torch.Tensor,
    y_std: torch.Tensor,
    theta: torch.Tensor,
    w_star: Optional[torch.Tensor],
    nugget: float,
    mask: Optional[torch.Tensor] = None,
):
    """Return (reduced_likelihood, GpInnerParams).

    ``x_norm`` (n, nx), ``y_norm`` (n, 1) are normalized training data;
    ``mask`` (n,) bool marks active rows (None = all active). The likelihood
    is the reference's ``-n (log10 sigma2 + log10 det(R)^{2/n})``. With
    ``theta`` of shape (b, dim) the likelihood is (b,) and every field of
    the inner parameters carries the leading axis; ``y_norm`` (b, n, 1),
    ``y_std`` (b,), ``x_norm`` (b, n, nx) and ``mask`` (b, n) may then give
    each theta its own data.
    """
    # no local name for R: the callee frees it after the factorization
    return likelihood_from_r(
        _build_r(corr, x_norm, theta, w_star, nugget, mask), trend, x_norm,
        y_norm, y_std, mask)


def likelihood_from_r(r: torch.Tensor, trend: str, x_norm: torch.Tensor,
                      y_norm: torch.Tensor, y_std: torch.Tensor,
                      mask: Optional[torch.Tensor] = None):
    """``reduced_likelihood`` from its regularized correlation matrix ``r``
    (``_build_r``'s; consumed): the factorization, the GLS and the
    likelihood."""
    n = x_norm.shape[-2]
    dtype = x_norm.dtype
    lead = r.shape[:-2]

    fx = trend_basis(trend, x_norm)
    if mask is not None:
        m = mask.to(dtype)
        fx = fx * m[..., None]
        y_norm = y_norm * m[..., None]
        n_obs = torch.sum(m, dim=-1)
    else:
        n_obs = float(n)

    l_chol = _cholesky(r)
    del r
    ft = _solve_lower(l_chol, fx.expand(lead + fx.shape[-2:]))
    # GLS normal equations via the (p, p) Gram of Ft: the R factor of
    # qr(Ft) up to signs
    c = cholesky_nan(ft.mT @ ft)  # lower; R_qr = c.mT

    # ill-conditioning guard via the R-factor diagonal (ref SVD cond
    # check, algorithm.rs:1009-1027)
    dq = torch.abs(torch.diagonal(c, dim1=-2, dim2=-1))
    cond_ok = (torch.amin(dq, dim=-1)
               / torch.clamp(torch.amax(dq, dim=-1), min=1e-300)) > 1e-10

    yt = _solve_lower(l_chol, y_norm.expand(lead + y_norm.shape[-2:]))
    fty = ft.mT @ yt
    beta = _solve_upper(c.mT, _solve_lower(c, fty))
    rho = yt - ft @ beta
    gamma = _solve_upper(l_chol.mT, rho)

    # det(R) = prod diag(L)^2; padded diagonal entries are 1 -> log 0
    logdet = 2.0 * torch.sum(
        torch.log10(torch.diagonal(l_chol, dim1=-2, dim2=-1)), dim=-1) / n_obs
    sigma2_norm = torch.sum(rho**2, dim=(-2, -1)) / n_obs
    rlf = -n_obs * (torch.log10(sigma2_norm) + logdet)
    rlf = torch.where(torch.isfinite(rlf) & cond_ok, rlf,
                      torch.full_like(rlf, -float("inf")))

    inner = GpInnerParams(
        sigma2=sigma2_norm * (_lead(y_std, lead) ** 2),
        beta=beta,
        gamma=gamma,
        r_chol=l_chol,
        ft=ft,
        ft_qr_r=c.mT,
    )
    return rlf, inner


def _sqexp_dphi(c, x_norm, theta, w_star):
    """Closed-form trace contraction for the squared-exponential kernel:
    phi(theta) = sum C o log r = -1/2 sum_k c_k(theta) S_k with
    S_k = sum_ij C_ij (x_ik - x_jk)^2, as three matmul-shaped reductions
    (c (..., n, n), theta (..., dim), x_norm (n, nx) or (..., n, nx))."""
    u = torch.sum(c, dim=-1)  # C 1
    v = torch.sum(c, dim=-2)  # 1^T C
    x2 = x_norm * x_norm
    w = c @ x_norm
    if x_norm.ndim == 2:
        s = u @ x2 + v @ x2 - 2.0 * torch.sum(x_norm * w, dim=-2)
    else:
        s = ((u[..., None, :] @ x2)[..., 0, :]
             + (v[..., None, :] @ x2)[..., 0, :]
             - 2.0 * torch.sum(x_norm * w, dim=-2))  # (..., nx)
    if w_star is None:
        return -theta * s
    # c_k = sum_l theta_l^2 w_kl^2 -> dphi/dtheta_l = -theta_l sum_k w_kl^2 S_k
    return -theta * (s @ (w_star**2))


@functools.lru_cache(maxsize=4)
def _rademacher_probes(n: int, probes: int, dtype, device) -> torch.Tensor:
    """The fixed (n, probes) Rademacher probes of the stochastic gradient:
    egobox_tpu's, ``jax.random.rademacher(key(0xE60B0), (n, probes))``
    (doe/threefry.py; its float32 draw for float32 data, its float64 draw
    for float64), so every gradient evaluation of a fit sees the same
    estimate as egobox_tpu's. Kept for the next call (read only)."""
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    z = threefry.rademacher(threefry.key(_PROBE_SEED), (n, probes), np_dtype)
    return torch.from_numpy(z).to(device)


def _sqexp_dphi_stoch(x_norm, w_star, theta, l_chol, gamma, sigma2_norm,
                      probes):
    """Hutchinson estimate of the squared-exponential trace contraction
    s_k = sum_ij C_ij D_k,ij with C = (R^-1 - gamma gamma^T / sigma2) o R
    and D_k,ij = (x_ik - x_jk)^2, without forming R^-1:

        t_k = tr(R^-1 (R o D_k)) ~= (1/p) sum_z z^T R^-1 (R o D_k) z

    where every (R o D_k) v expands into R-matvecs through
    D_k,ij = x2_ik + x2_jk - 2 x_ik x_jk, and each R-matvec rides the kept
    factor R = L L^T: O(n^2 d p) instead of O(n^3). The rank-1 gamma term
    is exact. Probes are fixed (``_rademacher_probes``)."""
    n, nx = x_norm.shape
    z = _rademacher_probes(n, probes, x_norm.dtype, x_norm.device)
    g = gamma[:, 0]
    w = _solve_upper(l_chol.T, _solve_lower(l_chol, z))  # R^-1 Z
    x2 = x_norm * x_norm
    v3 = (x_norm[:, :, None] * z[:, None, :]).reshape(n, nx * probes)
    v4 = x_norm * g[:, None]
    u = torch.cat([z, w, v3, v4, g[:, None]], dim=1)
    ru = l_chol @ (l_chol.T @ u)
    a = ru[:, :probes]  # R Z
    b = ru[:, probes:2 * probes]  # R W
    gmat = ru[:, 2 * probes:(2 + nx) * probes].reshape(n, nx, probes)
    rv4 = ru[:, (2 + nx) * probes:(2 + nx) * probes + nx]  # R (x_k o g)
    rg = ru[:, -1]  # R g
    h = torch.sum(w * a + z * b, dim=1)
    term12 = x2.T @ h  # (nx,)
    m3 = torch.sum(w[:, None, :] * gmat, dim=2)  # (n, nx)
    term3 = torch.sum(x_norm * m3, dim=0)
    t = (term12 - 2.0 * term3) / probes
    q = torch.sum(v4 * rv4, dim=0)
    ug = 2.0 * (x2.T @ (g * rg)) - 2.0 * q
    s = t - ug / torch.clamp(sigma2_norm, min=1e-300)
    if w_star is None:
        return -theta * s
    return -theta * ((w_star**2).T @ s)


def _grad_trace_core(corr, x_norm, w_star, nugget, mask, theta, l_chol,
                     gamma, sigma2_norm, stoch_probes=0):
    """d(n ln s2 + ln det R)/dtheta from the factorization residuals
    (theta, L, gamma, sigma2), as the sum over C o d log r / d theta with
    C = (R^-1 - gamma gamma^T / s2) o R.

    ``stoch_probes > 0`` routes the squared-exponential kernel to the
    Hutchinson estimate (kill-switch EGOBOX_NO_STOCH_GRAD=1; one theta
    only); everything else takes the exact R^-1 = L^-T L^-1, for one theta
    or a stack (theta (b, dim), L (b, n, n), gamma (b, n, 1), sigma2
    (b,))."""
    if (
        stoch_probes
        and theta.ndim == 1
        and corr == "squared_exponential"
        and os.environ.get("EGOBOX_NO_STOCH_GRAD") != "1"
    ):
        return _sqexp_dphi_stoch(
            x_norm, w_star, theta, l_chol, gamma, sigma2_norm, stoch_probes
        )
    n = x_norm.shape[-2]
    eye = torch.eye(n, dtype=x_norm.dtype, device=x_norm.device)
    li = _solve_lower(l_chol, eye.expand(l_chol.shape))
    del eye
    c = li.mT @ li  # R^-1
    del li
    c.sub_(gamma @ gamma.mT
           / torch.clamp(sigma2_norm, min=1e-300)[..., None, None])
    c.mul_(_build_r(corr, x_norm, theta, w_star, nugget, mask))
    if mask is not None:
        m = mask.to(x_norm.dtype)
        c.mul_(m[..., :, None] * m[..., None, :])
    if corr == "squared_exponential":
        return _sqexp_dphi(c, x_norm, theta, w_star)
    return _l1_dphi(corr, c, x_norm, x_norm, theta, w_star)


class _NegRlf(torch.autograd.Function):
    """-rlf(theta) with the analytic adjoint: forward keeps (theta, L,
    gamma, sigma2_norm), backward is the trace contraction; autograd never
    sees the Cholesky. theta (dim,) -> a scalar, theta (b, dim) -> (b,)."""

    @staticmethod
    def forward(ctx, theta, problem):
        rlf, inner = reduced_likelihood(
            problem["corr"], problem["trend"], problem["x_norm"],
            problem["y_norm"], problem["y_std"], theta, problem["w_star"],
            problem["nugget"], problem["mask"],
        )
        sigma2_norm = inner.sigma2 / (
            _lead(problem["y_std"], theta.shape[:-1]) ** 2)
        ctx.problem = problem
        ctx.save_for_backward(theta, inner.r_chol, inner.gamma, sigma2_norm)
        return -rlf

    @staticmethod
    def backward(ctx, g):
        theta, l_chol, gamma, sigma2_norm = ctx.saved_tensors
        p = ctx.problem
        dphi = _grad_trace_core(
            p["corr"], p["x_norm"], p["w_star"], p["nugget"], p["mask"],
            theta, l_chol, gamma, sigma2_norm, p["stoch_probes"],
        )
        grad = g[..., None] * dphi / _LN10
        return torch.where(torch.isfinite(grad), grad,
                           torch.zeros_like(grad)), None


def make_neg_reduced_likelihood(
    corr: str,
    trend: str,
    x_norm: torch.Tensor,
    y_norm: torch.Tensor,
    y_std: torch.Tensor,
    w_star: Optional[torch.Tensor],
    nugget: float,
    mask: Optional[torch.Tensor] = None,
    stoch_probes: int = 0,
):
    """Negative reduced likelihood f(theta), differentiable by autograd
    through its analytic adjoint (envelope theorem over the GLS beta and
    sigma^2):

        d/dtheta [ n ln s2 + ln det R ]
            = sum_ij [ (R^-1 - a a^T / s2) o R ]_ij  d log r_ij / d theta

    with a = R^-1 (y - F beta) (== gamma). ``f`` takes one theta (dim,) or
    any stack (..., dim) -> (...): the lanes of a lockstep multistart and
    all their line-search trials in one evaluation (the stochastic gradient
    is one-theta only).

    Data per lane: with ``y_norm`` (L, n, 1) and ``y_std`` (L,) (and then
    optionally ``x_norm`` (L, n, nx), ``mask`` (L, n)), ``f`` takes a stack
    (L, ..., dim) whose leading axis is the lanes: every theta of lane l
    (its line-search trials) is evaluated on lane l's data."""
    problem = dict(corr=corr, trend=trend, x_norm=x_norm, y_norm=y_norm,
                   y_std=y_std, w_star=w_star, nugget=nugget, mask=mask,
                   stoch_probes=stoch_probes)
    per_lane = y_norm.ndim == 3

    def lane_problem(trials):
        """The per-lane data repeated for ``trials`` thetas per lane."""
        def rep(v, per_lane_ndim):
            if v is None or v.ndim < per_lane_ndim:
                return v  # shared by every lane
            return v[:, None].expand(
                (v.shape[0], trials) + v.shape[1:]).reshape(
                    (-1,) + v.shape[1:])
        return dict(problem, y_norm=rep(y_norm, 3), x_norm=rep(x_norm, 3),
                    mask=rep(mask, 2), y_std=rep(y_std.reshape(-1, 1), 2))

    def neg_rlf(theta):
        if theta.ndim <= 2:
            return _NegRlf.apply(theta, problem)
        lead = theta.shape[:-1]
        prob = problem
        if per_lane:
            prob = lane_problem(int(torch.Size(lead[1:]).numel()))
        out = _NegRlf.apply(theta.reshape(-1, theta.shape[-1]), prob)
        return out.reshape(lead)

    return neg_rlf


def make_neg_rlf_residual_api(
    corr: str,
    trend: str,
    x_norm: torch.Tensor,
    y_norm: torch.Tensor,
    y_std: torch.Tensor,
    w_star: Optional[torch.Tensor],
    nugget: float,
    mask: Optional[torch.Tensor] = None,
    stoch_probes: int = 0,
):
    """Residual-reuse objective in log10(theta) for the L-BFGS:

    - ``fun_and_res(t_log10) -> (f, (theta, rlf, inner))``: the forward,
      keeping the factorization;
    - ``grad_from_res(t_log10, res) -> g``: the analytic adjoint from those
      residuals, with no forward recomputation."""

    def fun_and_res(t_log10):
        theta = 10.0**t_log10
        rlf, inner = reduced_likelihood(
            corr, trend, x_norm, y_norm, y_std, theta, w_star, nugget, mask
        )
        return -rlf, (theta, rlf, inner)

    def grad_from_res(t_log10, res):
        theta, _rlf, inner = res
        sigma2_norm = inner.sigma2 / (y_std.reshape(()) ** 2)
        dphi = _grad_trace_core(
            corr, x_norm, w_star, nugget, mask, theta, inner.r_chol,
            inner.gamma, sigma2_norm, stoch_probes,
        )
        # d(-rlf)/dtheta = dphi/ln10; through theta = 10^t the ln10
        # cancels: d(-rlf)/dt = dphi * theta
        grad = dphi * theta
        return torch.where(torch.isfinite(grad), grad,
                           torch.zeros_like(grad))

    return fun_and_res, grad_from_res
