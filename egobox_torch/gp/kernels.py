"""Correlation kernels: squared-exponential, absolute-exponential,
Matern 3/2, Matern 5/2, all PLS-weighted (port of egobox_tpu/gp/kernels.py).

Every kernel is a sum over input dims of a per-dim log-space term
(ref: crates/gp/src/correlation_models.rs). ``weights`` is the (nx, ncomp)
KPLS projection; ``weights=None`` means identity, theta then has length nx.

Formulas (d_j = x_j - x'_j, thw = theta-weighted scale):
- sqexp  : prod_{j,l} exp(-0.5 (theta_l w_jl d_j)^2)
- absexp : prod_{j,l} exp(-theta_l |w_jl| |d_j|)
- matern32: prod_{j,l} (1+s3 thw|d_j|) exp(-s3 thw|d_j|), s3=sqrt(3)
- matern52: prod_{j,l} (1+s5 thw|d_j|+5/3 thw^2 d_j^2) exp(-s5 thw|d_j|)

Large float32 L1-family Grams on CUDA go to the K1 kernel
(ops/corr_kernel.py), by the rule of egobox_tpu's kernels.py:146-158 with
``is_cuda`` in place of the TPU check.
"""

from __future__ import annotations

import math

import torch

from ..ops import corr_kernel

KERNEL_NAMES = (
    "squared_exponential",
    "absolute_exponential",
    "matern32",
    "matern52",
)

#: (theta lower-influence, upper-influence) factors for dim-aware theta
#: bounds (ref: correlation_models.rs theta_influence_factors)
THETA_INFLUENCE_FACTORS = {
    "squared_exponential": (0.29, 1.96),
    "absolute_exponential": (0.15, 3.76),
    "matern32": (0.21, 2.74),
    "matern52": (0.23, 2.44),
}

_SQRT3 = corr_kernel._SQRT3
_SQRT5 = corr_kernel._SQRT5

#: element budget of one (rows, n2, nx[, ncomp]) broadcast block; larger
#: problems stream row blocks, and float32 CUDA Grams above it take K1
_DENSE_BUDGET = 8_000_000
#: element budget of one block of the L1-family Gram and adjoint of a theta
#: stack: (thetas, n, n, nx) forward, (thetas, rows, n, nx) in the adjoint
_STACK_BUDGET = 32_000_000


def _theta_w(name: str, theta, weights):
    """Per-(dim, comp) length-scale matrix, or per-dim vector when weights
    is None."""
    if weights is None:
        return theta  # (nx,)
    if name == "squared_exponential":
        return theta[None, :] * weights  # sign kept, squared later
    return theta[None, :] * torch.abs(weights)  # (nx, ncomp)


def _log_corr_terms(name: str, dabs, thw, weights_is_none: bool):
    """log r contribution summed over dims (and comps), dabs (..., nx)."""
    if name == "squared_exponential":
        c = thw**2 if weights_is_none else torch.sum(thw**2, dim=1)
        return -0.5 * torch.sum(dabs**2 * c, dim=-1)
    if name == "absolute_exponential":
        c = thw if weights_is_none else torch.sum(thw, dim=1)
        return -torch.sum(dabs * c, dim=-1)
    if name not in ("matern32", "matern52"):
        raise ValueError(f"unknown kernel: {name}")
    if weights_is_none:
        u, dims = dabs * thw, (-1,)
    else:
        u, dims = dabs[..., :, None] * thw, (-2, -1)
    if name == "matern32":
        t = torch.log1p(_SQRT3 * u) - _SQRT3 * u
    else:
        t = torch.log1p(_SQRT5 * u + (5.0 / 3.0) * u * u) - _SQRT5 * u
    return torch.sum(t, dim=dims)


def corr_value(name: str, d, theta, weights=None):
    """Correlation r for differences ``d`` of shape (..., nx) -> (...)."""
    thw = _theta_w(name, theta, weights)
    return torch.exp(_log_corr_terms(name, torch.abs(d), thw,
                                     weights is None))


def _sqexp_cross_fast(x1, x2, theta, weights):
    """Weighted squared distances via the matmul expansion."""
    if weights is None:
        c = theta**2
    else:
        c = torch.sum((theta[None, :] * weights) ** 2, dim=1)
    s = torch.sqrt(c)
    a = x1 * s
    b = x2 * s
    a2 = torch.sum(a * a, dim=1)[:, None]
    b2 = torch.sum(b * b, dim=1)[None, :]
    sq = torch.clamp(a2 + b2 - 2.0 * (a @ b.T), min=0.0)
    return torch.exp(-0.5 * sq)


def _row_blocks(fn, x1, x2, per_pair: int):
    """fn(x1 rows, x2) over row blocks of x1 bounded by _DENSE_BUDGET."""
    rows = max(1, _DENSE_BUDGET // max(1, x2.shape[0] * per_pair))
    if rows >= x1.shape[0]:
        return fn(x1, x2)
    return torch.cat([fn(x1[s:s + rows], x2)
                      for s in range(0, x1.shape[0], rows)], dim=0)


def log_corr_cross(name: str, x1, x2, theta, weights=None):
    """log r(x1, x2) of shape (n1, n2): the pre-exp log-kernel matrix."""
    thw = _theta_w(name, theta, weights)
    wnone = weights is None

    def block(xb, x2):
        dabs = torch.abs(xb[:, None, :] - x2[None, :, :])
        return _log_corr_terms(name, dabs, thw, wnone)

    return _row_blocks(block, x1, x2, x1.shape[1])


def _takes_k1(name: str, x1, x2, theta, weights) -> bool:
    """The K1 dispatch rule: large float32 L1-family Grams on CUDA with
    identity weights whose points autograd does not record. A Gram whose
    ``x1`` or ``x2`` requires grad (an infill criterion or a prediction
    differentiated with respect to its trial points) takes the
    differentiable plain formula; a Gram whose ``theta`` requires grad
    launches K1 through ``K1Gram``, whose backward gives the gradient with
    respect to theta."""
    return (
        name != "squared_exponential"
        and weights is None
        and x1.dtype == torch.float32
        and x1.shape[0] * x2.shape[0] * x1.shape[1] > _DENSE_BUDGET
        and x1.is_cuda
        and not corr_kernel.needs_grad(x1, x2)
    )


def _dlog_term(name: str, u: torch.Tensor) -> torch.Tensor:
    """d/du of the per-dim log-kernel term of the L1 family."""
    if name == "absolute_exponential":
        return torch.full_like(u, -1.0)
    if name == "matern32":
        return -3.0 * u / (1.0 + _SQRT3 * u)
    if name == "matern52":
        a = 1.0 + _SQRT5 * u
        return -(5.0 / 3.0) * u * a / (a + (5.0 / 3.0) * u * u)
    raise ValueError(f"unknown kernel: {name}")


def _l1_dphi(name, c, x1, x2, theta, w_star):
    """sum_ij C_ij d log r(x1_i, x2_j) / d theta for absexp / Matern, in
    closed form per row block of x1: no (n1, n2, nx) tensor is ever held.
    ``c`` (..., n1, n2) and ``theta`` (..., dim) share their leading axis,
    and so do ``x1`` / ``x2`` when they are (..., n, nx) (one design per
    theta, identity weights). The likelihood's adjoint passes one design as
    both; ``K1Gram``'s backward a cross pair.

    With u_jl = |d_j| theta_l |w_jl| (u_j = |d_j| theta_j without KPLS),
    d log r / d theta_l = sum_j term'(u_jl) |d_j| |w_jl|."""
    n1 = x1.shape[-2]
    n2, nx = x2.shape[-2:]
    per_pair = nx * (1 if w_star is None else w_star.shape[1])
    if theta.ndim == 1:
        rows = max(1, _DENSE_BUDGET // max(1, n2 * per_pair))
    else:
        rows = max(1, _STACK_BUDGET // max(1, theta.shape[0] * n2 * per_pair))
    if w_star is None:
        thw = theta[..., None, None, :]  # over (rows, n2, nx)
    else:
        # over (rows, n2, nx, ncomp)
        thw = (theta[..., None, :] * torch.abs(w_star))[..., None, None, :, :]
    out = torch.zeros_like(theta)
    for s in range(0, n1, rows):
        dabs = torch.abs(x1[..., s:s + rows, None, :]
                         - x2[..., None, :, :])
        cb = c[..., s:s + rows, :]
        if w_star is None:
            t = _dlog_term(name, dabs * thw) * dabs
            out = out + torch.einsum("...ij,...ijk->...k", cb, t)
        else:
            dabs = dabs[..., None]
            t = _dlog_term(name, dabs * thw) * dabs
            out = out + torch.einsum("...ij,...ijkl,kl->...l", cb, t,
                                     torch.abs(w_star))
    return out


class K1Gram(torch.autograd.Function):
    """r(x1, x2) built by K1, differentiable with respect to theta.

    The forward is ``corr_cross_tile`` (the kernel on CUDA tensors, its
    plain version on CPU ones); the backward is the closed-form contraction
    dL/dtheta = sum_ij G_ij r_ij d log r_ij / d theta of ``_l1_dphi``, in
    plain torch over row blocks, as egobox_tpu differentiates its own plain
    formula there. The sparse GP's likelihood differentiates through its
    (M, n) cross Gram by autograd (its Cholesky is only M x M), so the
    Gram needs this backward. The dense likelihood never differentiates a
    Gram: its analytic adjoint (gp/likelihood.py ``_NegRlf``) contracts
    the kept factorization with the same per-dimension terms, which would
    cost an n x n Cholesky's backward by autograd. The two share
    ``_l1_dphi``. ``x1`` and ``x2`` must not require grad."""

    @staticmethod
    def forward(ctx, name, x1, x2, theta):
        r = corr_kernel.corr_cross_tile(name, x1, x2, theta)
        ctx.name = name
        ctx.save_for_backward(x1, x2, theta, r)
        return r

    @staticmethod
    def backward(ctx, g):
        x1, x2, theta, r = ctx.saved_tensors
        return None, None, None, _l1_dphi(ctx.name, g * r, x1, x2, theta,
                                          None)


def corr_cross(name: str, x1, x2, theta, weights=None):
    """Cross-correlation (Gram) matrix r(x1, x2) of shape (n1, n2).

    sqexp takes the matmul path; large float32 L1-family Grams on CUDA
    launch K1 (through ``K1Gram`` when theta requires grad) unless x1 or
    x2 requires grad; the rest streams row blocks through the
    (differentiable) log-space formula.
    """
    if name == "squared_exponential":
        return _sqexp_cross_fast(x1, x2, theta, weights)
    if _takes_k1(name, x1, x2, theta, weights):
        x1, x2, theta = x1.contiguous(), x2.contiguous(), theta.contiguous()
        if corr_kernel.needs_grad(theta):
            return K1Gram.apply(name, x1, x2, theta)
        return corr_kernel.corr_cross_tile(name, x1, x2, theta)
    return torch.exp(log_corr_cross(name, x1, x2, theta, weights))


def corr_gram_row_sums(name: str, x, theta, weights=None):
    """R(x, x) with an exact unit diagonal and its row sums
    ``sum_j |R[i, j]|``. Where K1 builds the Gram the sums come from the
    kernel, which saves two more passes over R; elsewhere they are summed
    from R."""
    if _takes_k1(name, x, x, theta, weights) and not corr_kernel.needs_grad(
            theta):
        xc = x.contiguous()
        # K1's diagonal is exactly 1: every term of r(x_i, x_i) is 0
        return corr_kernel.corr_cross_tile(name, xc, xc, theta.contiguous(),
                                           row_sums=True)
    r = corr_cross(name, x, x, theta, weights)
    r.diagonal().fill_(1.0)  # in place: r is a fresh tensor
    return r, torch.sum(torch.abs(r), dim=1)


def corr_gram(name: str, x, theta, weights=None, nugget=0.0):
    """Symmetric Gram R(x, x): unit diagonal plus nugget
    (ref: algorithm.rs:997-1002)."""
    r = corr_cross(name, x, x, theta, weights)
    r.diagonal().fill_(1.0 + nugget)  # in place: r is a fresh tensor
    return r


#: ThetaTuning::DEFAULT_BOUNDS in the reference (gp/src/parameters.rs)
DEFAULT_THETA_BOUNDS = (1e-2, 1e1)


def theta_bounds_heuristic(names, nx: int):
    """Dim-aware theta bounds for nx >= 10 (Appriou 2023; port of
    special_bounds, ref: ego/src/utils/bounds.rs:33-85)."""
    if isinstance(names, str):
        names = [names]
    theta_inf, theta_sup = DEFAULT_THETA_BOUNDS
    for name in names:
        f0, f1 = THETA_INFLUENCE_FACTORS[name]
        theta_inf = min(theta_inf, f0)
        theta_sup = max(theta_sup, f1)

    if nx < 10:
        return DEFAULT_THETA_BOUNDS

    d = float(nx)
    s = 1.0 / math.sqrt(12.0)  # std of a uniform design on [0, 1]^d
    k = 9.0 / 5.0  # uniform distribution kurtosis
    interval = 1.96 * math.sqrt(2.0 * (k + 1.0) * d)
    rmin = math.sqrt(max(2.0 * d - interval, 1e-12))
    rmax = math.sqrt(2.0 * d + interval)
    lmin = s * rmin * theta_inf
    lmax = s * rmax * theta_sup
    return (1.0 / lmax, 1.0 / lmin)
