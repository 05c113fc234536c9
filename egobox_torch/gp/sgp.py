"""Sparse Gaussian process (FITC / VFE) with inducing points
(port of egobox_tpu/gp/sgp.py; ref: crates/gp/src/sparse_algorithm.rs).

- The joint (theta, sigma2[, noise]) MLE runs in log10 space as one stack
  of lockstep L-BFGS lanes (optim/lbfgsb.py), where egobox_tpu vmaps
  ``minimize_lbfgsb`` over its inits. Gradients come from autograd through
  the likelihood: its heavy matrices are only (M, n) and (M, M), so
  differentiating through the small Cholesky is cheap, unlike the dense
  fit.
- The sparse GP's algebra (parameters, Choleskys, solves, likelihood,
  Woodbury data) is float64 on every device: in float32 the Cholesky of
  sigma2 K(Z, Z) + nugget I fails where the n=50 000, M=512 fit finds its
  optimum (PERF.md §6). The Grams are computed in the type of the points:
  a caller's float32 data keeps float32 points (the model's ``z`` too),
  and ``gp.kernels.corr_cross`` then sends a large L1-family Gram on the
  card to K1 (through ``K1Gram`` when theta requires grad); float64 data
  keeps float64 points and Grams. A float32 Gram carries rounding of about
  eps32 relative to sigma2, which K(Z, Z)^-1 amplifies into K(X, Z)'s
  projection: so with float32 points the nugget is relative to sigma2
  (``_common_uv``); with float64 points it is absolute, as in egobox_tpu.
- The likelihoods mirror fitc() (:695-765) and vfe() (:769-830); prediction
  uses the stored Woodbury vector and inverse, O(n M) (:237-257).
- A likelihood takes one parameter set or a stack of them (theta
  (..., dim), sigma2 and noise (...)), with the data shared or with
  leading axes that broadcast against the stack: the lanes of one fit and
  their line-search trials, and the folds of ``moe.metrics.sgp_fit_predict``.
- Every random draw of a fit (the inducing rows, the warm start's
  subsample, the LHS seeds) comes from one ``SgpDraws`` built by
  ``_sgp_draws(seed)``; tests replace that function to hand in JAX's draws.

No x / y normalization: sigma2 and noise are in output units, as in the
reference.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import as_tensor
from ..ops.chol_kernel import cholesky_nan
from ..optim.lbfgsb import minimize_lbfgsb
from .fit import FitDraws, fit_gp
from .gp import _rowwise_grad
from .kernels import corr_cross
from .kpls import pls_rotations

#: SGP defaults (ref: sparse_parameters.rs)
SGP_THETA_BOUNDS = (1e-2, 1e2)
SGP_NOISE_INIT = 1e-2
SGP_NOISE_BOUNDS_EPS_FACTOR = 100.0
SGP_NOISE_UPPER = 1e10


class WoodburyData(NamedTuple):
    vec: torch.Tensor  # (M, 1)
    inv: torch.Tensor  # (M, M)


@dataclass(frozen=True)
class SgpModel:
    """Trained sparse GP (ref struct: sparse_algorithm.rs:145-169)."""

    theta: torch.Tensor  # (dim,)
    sigma2: torch.Tensor  # scalar process variance
    noise: torch.Tensor  # scalar noise variance
    w_star: Optional[torch.Tensor]  # (nx, kpls_dim) or None
    z: torch.Tensor  # (M, nx) inducing points
    w_vec: torch.Tensor  # (M, 1)
    w_inv: torch.Tensor  # (M, M)
    likelihood: torch.Tensor
    corr: str
    method: str


class SgpDraws(FitDraws):
    """The random draws of one sparse fit, from one CPU generator: the
    inducing rows and the warm start's subsample (``permutation``), then
    the LHS seeds (``lhs_seeds``), in that order."""

    def fold_lhs_seeds(self, n_folds: int, n_start: int, dim: int, dtype,
                       device) -> torch.Tensor:
        """(n_folds, n_start, dim) LHS seeds, one set per fold."""
        return torch.stack([self.lhs_seeds(n_start, dim, dtype, device)
                            for _ in range(n_folds)])


def _sgp_draws(seed: int) -> SgpDraws:
    return SgpDraws(seed)


def _synced_clock(device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _points_dtype(x) -> torch.dtype:
    """The type of a fit's points (and so of its Grams): float32 when the
    caller's ``x`` is float32 (numpy or tensor), else float64."""
    if isinstance(x, torch.Tensor):
        f32 = x.dtype == torch.float32
    else:
        f32 = isinstance(x, np.ndarray) and x.dtype == np.float32
    return torch.float32 if f32 else torch.float64


def _default_nugget(points_dtype) -> float:
    """The nugget of a fit by default: 1000 eps, absolute, for float64
    points (egobox_tpu's); 100 eps32 relative to sigma2 for float32 points.
    On the n=50 000, M=512 Matern 5/2 fit a relative 1e-7 or 1e-6 still
    loses lanes at theta ~0.1 to an indefinite K(Z, Z), 1e-5 keeps every
    lane and ends within 1e-3 of the float64 fit's optimum, 1000 eps32
    moves the optimum by 5e-3 (PERF.md §6)."""
    if points_dtype == torch.float32:
        return 100.0 * torch.finfo(torch.float32).eps
    return 1000.0 * torch.finfo(points_dtype).eps


def _k(corr, a, b, w_star, theta, sigma2):
    """sigma2-scaled kernel (ref: compute_k, sparse_algorithm.rs). The Gram
    is ``corr_cross`` in the points' type (float32 points: K1 where its
    rule takes the Gram), the result in sigma2's. With a stack theta
    (..., dim) the points ``a`` / ``b`` may carry leading axes that
    broadcast against it; one Gram per parameter set."""
    pt = a.dtype
    th = theta.to(pt)
    ws = None if w_star is None else w_star.to(pt)
    if theta.ndim == 1:
        return sigma2 * corr_cross(corr, a, b, th, ws).to(sigma2.dtype)
    lead = theta.shape[:-1]
    a_l = a.expand(lead + a.shape[-2:])
    b_l = a_l if b is a else b.expand(lead + b.shape[-2:])
    grams = torch.stack([corr_cross(corr, a_l[i], b_l[i], th[i], ws)
                         for i in np.ndindex(*lead)])
    return sigma2[..., None, None] * grams.reshape(
        lead + grams.shape[-2:]).to(sigma2.dtype)


def _eye_like(t, m):
    return torch.eye(m, dtype=t.dtype, device=t.device)


def _common_uv(corr, theta, sigma2, x, z, w_star, nugget):
    """U = chol(K(Z, Z) + nugget I), U^-1 and V = U^-1 K(Z, X). With
    float32 points the nugget is relative to sigma2: the Grams' rounding
    (about eps32 sigma2 per entry) would otherwise make K(Z, Z) indefinite
    near its optimum (theta ~0.1 at n=50 000, M=512), or, divided by an
    eigenvalue near an absolute nugget, put spurious optima in the corners
    of the box (noise 1e-14, theta 1e-2; PERF.md §6)."""
    nz = z.shape[-2]
    kmm = _k(corr, z, z, w_star, theta, sigma2)
    eye = _eye_like(kmm, nz)
    if z.dtype == torch.float32:
        nugget = nugget * sigma2[..., None, None]
    kmm = kmm + nugget * eye
    kmn = _k(corr, z, x, w_star, theta, sigma2)
    u = cholesky_nan(kmm)
    ui = torch.linalg.solve_triangular(u, eye.expand(u.shape), upper=False)
    v = ui @ kmn  # (..., M, n)
    return u, ui, v, kmn


def _solve_eye(l_fac):
    eye = _eye_like(l_fac, l_fac.shape[-1])
    return torch.linalg.solve_triangular(l_fac, eye.expand(l_fac.shape),
                                         upper=False)


def _logdiag(l_fac):
    return torch.sum(torch.log(torch.diagonal(l_fac, dim1=-2, dim2=-1)),
                     dim=-1)


def fitc_likelihood(corr, theta, sigma2, noise, x, y, z, w_star, nugget):
    """(ref: fitc, sparse_algorithm.rs:695-765). Returns (lkh,
    WoodburyData)."""
    _, ui, v, _ = _common_uv(corr, theta, sigma2, x, z, w_star, nugget)

    nu = sigma2[..., None] - torch.sum(v * v, dim=-2) + noise[..., None]
    beta = 1.0 / nu  # (..., n)

    eye = _eye_like(v, v.shape[-2])
    a_mat = eye + (v * beta[..., None, :]) @ v.mT
    l_fac = cholesky_nan(a_mat)
    li = _solve_eye(l_fac)

    a = y * beta[..., :, None]  # (..., n, 1)
    b = (li @ v) @ a  # (..., M, 1)

    term1 = torch.sum(torch.log(nu), dim=-1)
    term2 = 2.0 * _logdiag(l_fac)
    term3 = (a.mT @ y)[..., 0, 0]
    term4 = -torch.sum(b * b, dim=(-2, -1))
    lkh = -0.5 * (term1 + term2 + term3 + term4)

    li_ui = li @ ui
    w = WoodburyData(
        vec=li_ui.mT @ b,
        inv=ui.mT @ ui - li_ui.mT @ li_ui,
    )
    return lkh, w


def vfe_likelihood(corr, theta, sigma2, noise, x, y, z, w_star, nugget):
    """(ref: vfe, sparse_algorithm.rs:769-830)."""
    n = x.shape[-2]
    _, ui, v, _ = _common_uv(corr, theta, sigma2, x, z, w_star, nugget)

    beta = 1.0 / torch.clamp(noise, min=nugget)
    a_mat = (v @ v.mT) * beta[..., None, None]
    eye = _eye_like(v, v.shape[-2])
    b_mat = eye + a_mat
    l_fac = cholesky_nan(b_mat)
    li = _solve_eye(l_fac)

    b = (li @ v) @ y * beta[..., None, None]  # (..., M, 1)

    term1 = -n * torch.log(beta)
    term2 = 2.0 * _logdiag(l_fac)
    term3 = beta * torch.sum(y * y, dim=(-2, -1))
    term4 = -(b.mT @ b)[..., 0, 0]
    term5 = n * beta * sigma2
    term6 = -torch.sum(torch.diagonal(a_mat, dim1=-2, dim2=-1), dim=-1)
    lkh = -0.5 * (term1 + term2 + term3 + term4 + term5 + term6)

    li_ui = li @ ui
    bi = eye + li.mT @ li
    w = WoodburyData(
        vec=li_ui.mT @ b,
        inv=ui.mT @ (bi @ ui),
    )
    return lkh, w


_LIKELIHOODS = {"FITC": fitc_likelihood, "VFE": vfe_likelihood}


def _x2d(model: SgpModel, x) -> torch.Tensor:
    x = torch.as_tensor(x, dtype=model.z.dtype).to(model.z.device)
    return x.reshape(1, -1) if x.ndim < 2 else x


def sgp_predict(model: SgpModel, x) -> torch.Tensor:
    """mean = k(x, Z) w_vec (ref: sparse_algorithm.rs:237-241)."""
    kx = _k(model.corr, _x2d(model, x), model.z, model.w_star, model.theta,
            model.sigma2)
    return (kx @ model.w_vec)[:, 0]


def sgp_predict_var(model: SgpModel, x) -> torch.Tensor:
    """var = sigma2 - diag(k^T W_inv k), clipped at 1e-15, + noise
    (ref: sparse_algorithm.rs:245-257)."""
    kx = _k(model.corr, model.z, _x2d(model, x), model.w_star, model.theta,
            model.sigma2)  # (M, n)
    var = model.sigma2 - torch.sum((model.w_inv.T @ kx) * kx, dim=0)
    return torch.clamp(var, min=1e-15) + model.noise


def sgp_predict_valvar(model: SgpModel, x):
    return sgp_predict(model, x), sgp_predict_var(model, x)


def sgp_sample(model: SgpModel, x, n_traj: int,
               generator: Optional[torch.Generator] = None,
               method: str = "eig",
               normals: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Trajectories at x -> (m, n_traj): the posterior mean plus noise with
    the PRIOR covariance sigma2 K(x, x), as the reference's SGP sample
    (ref: sparse_algorithm.rs:338-361 uses compute_k(x, x); the shared
    sampler algorithm.rs:1153-1194, eigenvalues below 1e-9 dropped). The
    standard normals (m, n_traj) are ``normals`` when given (a test hands
    in egobox_tpu's), else drawn from ``generator`` on the CPU."""
    x = _x2d(model, x)
    m = x.shape[0]
    cov = _k(model.corr, x, x, model.w_star, model.theta, model.sigma2)
    if method == "chol":
        c = torch.linalg.cholesky(cov + 1e-9 * model.sigma2 * _eye_like(
            cov, m))
    elif method == "eig":
        evals, evecs = torch.linalg.eigh(cov)
        evals = torch.where(evals < 1e-9, torch.zeros_like(evals), evals)
        c = evecs @ (torch.sqrt(evals)[:, None] * evecs.T)
    else:
        raise ValueError(f"sgp_sample: unknown method {method!r}")
    if normals is None:
        normals = torch.randn((m, n_traj), generator=generator,
                              dtype=torch.float64)
    z = normals.to(dtype=cov.dtype, device=cov.device)
    return sgp_predict(model, x)[:, None] + c @ z


def sgp_predict_gradients(model: SgpModel, x) -> torch.Tensor:
    """d mean / dx per row -> (n, nx), by autograd."""
    return _rowwise_grad(lambda xx: sgp_predict(model, xx), _x2d(model, x))


def sgp_predict_var_gradients(model: SgpModel, x) -> torch.Tensor:
    """d var / dx per row -> (n, nx), by autograd."""
    return _rowwise_grad(lambda xx: sgp_predict_var(model, xx),
                         _x2d(model, x))


def _param_box(y, theta0, bounds_lo, bounds_up, noise0, noise_bounds,
               estimate_noise, theta0_alt, seeds):
    """The log10 box of p = [theta..., sigma2, noise?] for data ``y``, and
    the inits: the default p0, the ``theta0_alt`` lane, then the LHS
    ``seeds`` (in [0, 1]) mapped onto the narrowed sub-box. Returns
    (inits (k, P), lo (P,), up (P,))."""
    dtype, dev = y.dtype, y.device
    dim = theta0.shape[0]
    y_var = torch.var(y, correction=1)
    sigma2_0 = torch.clamp(y_var, min=1e-12)

    def one(v):
        return torch.log10(torch.as_tensor(v, dtype=dtype).to(dev)
                           ).reshape(1)

    # sigma2 bounds (1e-12, 9 var(y)) per sparse_algorithm.rs:499-589
    lo_list = [torch.log10(bounds_lo), one(1e-12)]
    up_list = [torch.log10(bounds_up),
               torch.log10(9.0 * torch.clamp(y_var, min=1e-10)).reshape(1)]
    p0_list = [torch.log10(theta0), torch.log10(sigma2_0).reshape(1)]
    if estimate_noise:
        lo_list.append(one(noise_bounds[0]))
        up_list.append(one(noise_bounds[1]))
        p0_list.append(torch.log10(noise0).reshape(1))
    lo = torch.cat(lo_list)
    up = torch.cat(up_list)
    p0 = torch.clamp(torch.cat(p0_list), lo, up)
    # theta0_alt: a second full-strength init lane (the subsample warm
    # start keeps the default init alongside the warm one: a dense-subfit
    # theta in a bad basin of the joint SGP objective must not evict the
    # init that works)
    p0s = [p0]
    if theta0_alt is not None:
        p0s.append(torch.clamp(
            torch.cat([torch.log10(theta0_alt)] + p0_list[1:]), lo, up))
    inits = torch.stack(p0s)
    if seeds is None:
        return inits, lo, up
    # The LHS seeds sample a plausible sub-box, not the full bounds: at
    # large n most of the raw (sigma2, noise) box drains into the
    # all-noise basin. Seeds keep theta's full range but pin sigma2 to
    # [1e-2, 9] var(y) and noise to [1e-6, 1e-1] var(y); the L-BFGS
    # still optimizes over the full bounds.
    slo, sup = lo.clone(), up.clone()
    v_log = torch.log10(torch.clamp(y_var, min=1e-10))
    slo[dim] = torch.maximum(slo[dim], v_log - 2.0)
    if estimate_noise:
        slo[dim + 1] = torch.clamp(v_log - 6.0, slo[dim + 1], up[dim + 1])
        sup[dim + 1] = torch.clamp(v_log - 1.0, slo[dim + 1], up[dim + 1])
    seeds = slo[None, :] + seeds * (sup - slo)[None, :]
    return torch.cat([inits, seeds], dim=0), lo, up


def _unpack(p, dim, estimate_noise, noise0):
    theta = 10.0 ** p[..., :dim]
    sigma2 = 10.0 ** p[..., dim]
    if estimate_noise:
        noise = 10.0 ** p[..., dim + 1]
    else:
        noise = noise0.reshape(()).expand(sigma2.shape)
    return theta, sigma2, noise


def _solve_lanes(lik, corr, x, y, z, w_star, nugget, dim, estimate_noise,
                 noise0, inits, lo, up, max_iters, ls_batch, info=None):
    """Every init of every group as one stack of lockstep L-BFGS lanes on
    the negative likelihood. ``inits`` (G, S, P) with ``lo`` / ``up``
    (G, P): G groups of S inits each; the data (``x`` (n, nx), ``y``
    (n, 1), ``z`` (M, nx)) is shared, or carries a leading group axis G.
    Returns the best parameters of each group (G, P): its first lowest
    objective, as argmin over egobox_tpu's vmapped lanes. ``info`` (a dict)
    collects the lanes, each lane's iterations and the parameter sets the
    objective evaluated (one likelihood, and one Gram, each)."""
    g, s, n_p = inits.shape

    def lead(v, k):
        """Group data broadcast against a (G, S[, T]) stack."""
        return v if v.ndim == 2 else v.reshape(
            (g,) + (1,) * k + v.shape[1:])

    def neg_lkh(p):
        shape = p.shape[:-1]  # (G*S,) or (G*S, T)
        if info is not None:
            info["evaluations"] = info.get("evaluations", 0) + shape.numel()
        pg = p.reshape((g, s) + shape[1:] + (n_p,))
        k = pg.ndim - 2
        theta, sigma2, noise = _unpack(pg, dim, estimate_noise, noise0)
        lkh, _ = lik(corr, theta, sigma2, noise, lead(x, k), lead(y, k),
                     lead(z, k), w_star, nugget)
        out = torch.where(torch.isfinite(lkh), -lkh,
                          torch.full_like(lkh, float("inf")))
        return out.reshape(shape)

    res = minimize_lbfgsb(
        neg_lkh, inits.reshape(g * s, n_p),
        lo[:, None].expand(g, s, n_p).reshape(g * s, n_p),
        up[:, None].expand(g, s, n_p).reshape(g * s, n_p),
        max_iters=max_iters, ls_batch=ls_batch, final_grad=False)
    if info is not None:
        info.update(lanes=g * s, iterations=res.n_iters.tolist())
    best = torch.argmin(res.fun.reshape(g, s), dim=1)
    return res.x.reshape(g, s, n_p)[torch.arange(g, device=best.device),
                                    best]


def fit_sgp_core(
    x, y, z, theta0, bounds_lo, bounds_up, noise0, noise_bounds,
    draws: SgpDraws,
    *,
    corr: str = "squared_exponential",
    method: str = "FITC",
    kpls_dim: Optional[int] = None,
    n_start: int = 10,
    max_iters: int = 50,
    estimate_noise: bool = True,
    nugget: float = 1e-10,
    ls_batch: int = 0,
    theta0_alt=None,
    info: Optional[dict] = None,
) -> SgpModel:
    """The multistart MLE of one sparse GP on (x (n, nx), y (n, 1)) with
    inducing points z (M, nx): the default init, ``theta0_alt`` and
    ``n_start`` LHS seeds as one stack of lockstep lanes, then the
    likelihood and Woodbury data at the best lane's parameters. ``info``
    as ``_solve_lanes`` fills it."""
    lik = _LIKELIHOODS[method]
    w_star = None
    if kpls_dim is not None:
        w_star = pls_rotations(x.to(y.dtype), y, kpls_dim)
    n_p = theta0.shape[0] + 1 + int(estimate_noise)
    seeds = (draws.lhs_seeds(n_start, n_p, y.dtype, y.device)
             if n_start > 0 else None)
    inits, lo, up = _param_box(y, theta0, bounds_lo, bounds_up, noise0,
                               noise_bounds, estimate_noise, theta0_alt,
                               seeds)
    dim = theta0.shape[0]
    p = _solve_lanes(lik, corr, x, y, z, w_star, nugget, dim,
                     estimate_noise, noise0, inits[None], lo[None],
                     up[None], max_iters, ls_batch, info)[0]
    theta, sigma2, noise = _unpack(p, dim, estimate_noise, noise0)
    lkh, w = lik(corr, theta, sigma2, noise, x, y, z, w_star, nugget)
    return SgpModel(theta=theta, sigma2=sigma2, noise=noise, w_star=w_star,
                    z=z, w_vec=w.vec, w_inv=w.inv, likelihood=lkh,
                    corr=corr, method=method)


def fit_sgp(
    x,
    y,
    *,
    corr: str = "squared_exponential",
    method: str = "FITC",
    n_inducing: int = 10,
    z=None,
    theta_init=None,
    theta_bounds=None,
    theta_fixed: bool = False,
    noise=None,
    noise_bounds=None,
    estimate_noise: bool = True,
    kpls_dim: Optional[int] = None,
    n_start: int = 10,
    max_iters: int = 50,
    seed: int = 0,
    nugget: Optional[float] = None,
    subsample_warmstart: Optional[int] = None,
    ls_batch: int = 0,
    device=None,
    info: Optional[dict] = None,
) -> SgpModel:
    """User-facing sparse-GP fit (ref: SgpParams + fit,
    sparse_algorithm.rs:416-648).

    ``x`` (n, nx), ``y`` (n,) or (n, 1): tensors keep their device, numpy
    input goes to ``device`` (default: the GPU, and a host without one
    raises; ``device="cpu"`` runs on the CPU). The fit's algebra is
    float64; its points and Grams keep float32 data in float32 (on the
    card K1 then builds the large L1-family Grams) and take anything else
    in float64 (see the module's docstring). The nugget (default 1000 eps)
    and the noise bounds (default 100 eps ... 1e10) take eps of the
    points' type; with float32 points the nugget is relative to sigma2
    and 100 eps32 by default (``_default_nugget``).
    ``z`` gives located inducing points; otherwise ``n_inducing`` rows of
    the training set are picked at random (make_inducings, :833-847).
    ``noise`` is the fixed value (``estimate_noise=False``) or the initial
    guess; ``theta_fixed`` collapses the theta box onto ``theta_init``.

    ``subsample_warmstart=k`` (no reference counterpart): theta starts from
    a budgeted dense-GP MLE on a k-row random subsample (``fit_gp`` with 3
    starts, 20 iterations, an 8-trial line search), divided by the
    subsample's x_std (the dense theta is in normalized units and enters
    every kernel linearly against the distance); the default theta stays
    alongside as a second lane, and the noise starts at 1e-1 var(y)
    (descending into the optimum from above is safe, an init well below
    the underfit kernel's residual scale overshoots into the all-noise
    plateau). Not supported with ``kpls_dim``: the subsample's PLS basis
    differs from the full data's.

    ``info`` (a dict) collects the warm start's seconds ("warm_start_s",
    the device synchronized), the lanes, each lane's iterations and the
    parameter sets evaluated."""
    x = as_tensor(x, dtype=_points_dtype(x), device=device)
    if x.ndim < 2:
        x = x.reshape(1, -1)
    dtype, dev = torch.float64, x.device
    y = as_tensor(y, dtype=dtype, device=dev).to(dev)
    if y.ndim == 1:
        y = y[:, None]
    n, nx = x.shape
    dim = kpls_dim if kpls_dim is not None else nx
    if kpls_dim is not None and kpls_dim > nx:
        raise ValueError(f"kpls_dim {kpls_dim} must be <= input dim {nx}")

    def param(v):
        return as_tensor(v, dtype=dtype, device=dev).to(dev)

    draws = _sgp_draws(seed)
    if z is None:
        z = x[draws.permutation(n, dev)[:n_inducing]]
    else:
        z = param(z).to(x.dtype)
        z = z.reshape(1, -1) if z.ndim < 2 else z

    tb = param(theta_bounds if theta_bounds is not None
               else SGP_THETA_BOUNDS)
    if tb.ndim == 1:
        tb = torch.broadcast_to(tb[None, :], (dim, 2))

    theta0_alt = None
    if subsample_warmstart and theta_init is None and not theta_fixed:
        if kpls_dim is not None:
            raise ValueError(
                "subsample_warmstart does not support kpls_dim (the "
                "subsample's PLS rotation basis differs from the full "
                "data's)"
            )
        ns = min(int(subsample_warmstart), n)
        sub = draws.permutation(n, dev)[:ns]
        t0 = _synced_clock(dev)
        msub = fit_gp(x[sub].to(dtype), y[sub], corr=corr, seed=seed,
                      n_start=3, max_iters=20, ls_batch=8)
        if info is not None:
            info["warm_start_s"] = _synced_clock(dev) - t0
        theta_init = torch.clamp(msub.theta / msub.x_std, tb[:, 0],
                                 tb[:, 1])
        theta0_alt = torch.full((dim,), 0.1, dtype=dtype, device=dev)
        if noise is None:
            noise = 1e-1 * torch.var(y, correction=1)

    theta0 = torch.broadcast_to(
        param(theta_init if theta_init is not None else 0.1), (dim,))
    if theta_fixed:
        # ThetaTuning::Fixed: only sigma2 / noise are optimized
        # (ref: sparse_algorithm.rs:472)
        tb = torch.stack([theta0, theta0], dim=1)

    eps = torch.finfo(x.dtype).eps
    noise0 = param(noise if noise is not None else SGP_NOISE_INIT)
    nb = noise_bounds if noise_bounds is not None else (
        SGP_NOISE_BOUNDS_EPS_FACTOR * eps, SGP_NOISE_UPPER)
    if nugget is None:
        nugget = _default_nugget(x.dtype)

    return fit_sgp_core(
        x, y, z, theta0, tb[:, 0].contiguous(), tb[:, 1].contiguous(),
        noise0, nb, draws, corr=corr, method=method, kpls_dim=kpls_dim,
        n_start=n_start, max_iters=max_iters,
        estimate_noise=estimate_noise, nugget=nugget, ls_batch=ls_batch,
        theta0_alt=theta0_alt, info=info,
    )
