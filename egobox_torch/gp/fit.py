"""GP hyperparameter fit: multistart MLE on log10(theta)
(port of egobox_tpu/gp/fit.py).

- the (n_start + 1) restarts (user init + maximin-LHS seeds over the log10
  bounds, ref optimization.rs:26-71) each run the bounded L-BFGS on the
  likelihood with its analytic adjoint; egobox_tpu advances them as one
  vmapped program, and so does the port (lockstep lanes on a stack of
  thetas) up to ``_LANES_MAX_POINTS`` points and ``_LANES_BYTES`` of
  stacked factorizations; above, and on the residual-reuse and masked
  paths, lane after lane;
- ThetaTuning Fixed/Full/Partial maps to ``theta_fixed`` and an ``active``
  mask whose inactive bounds collapse to the init value;
- ``mask`` fits the active rows of a padded design exactly;
- ``subsample_warmstart`` runs the multi-fidelity recipe: multistart fits on
  ``sub_draws`` random subsamples, then a polish of every candidate on the
  full data, best final likelihood wins.

Every random draw of a fit (the subsample permutations and the maximin-LHS
restart seeds) comes from one ``FitDraws`` built by ``_fit_draws(seed)``;
tests replace that function to hand in JAX's draws.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import as_tensor
from ..doe.lhs import maximin_lhs
from ..optim.lbfgsb import minimize_lbfgsb, minimize_tr
from .gp import GpModel
from .kpls import pls_rotations
from .likelihood import (
    make_neg_reduced_likelihood,
    make_neg_rlf_residual_api,
    reduced_likelihood,
)

GP_DEFAULT_N_START = 10
GP_DEFAULT_THETA_INIT = 0.1
GP_DEFAULT_THETA_BOUNDS = (1e-2, 1e1)
#: the restarts of a fit run as lockstep lanes while one evaluation of all
#: lanes and line-search trials stays below this many bytes, counted as 4
#: live (lanes x trials, n, n) arrays (R, its factor, the factor's inverse
#: and R^-1 at the peak of the adjoint; tools/prof_fit_lanes.py measures
#: 0.72, 1.41 and 2.46 GiB where this counts 0.64, 1.44 and 2.56 GB)
_LANES_BYTES = 8 * 2**30
#: and while the design has at most this many points. On an H100
#: (tools/prof_fit_lanes.py, matern52, d=10, float32) a 5-lane refit with 8
#: trials is 3-6x faster in lockstep up to n = 1 000, 2.2x at 1 500 and 1.2x
#: at 2 000, where the 2-lane, 4-iteration subfit of the n = 10 000 recipe
#: is 2.3x slower (the library's batched Cholesky of a few large matrices)
_LANES_MAX_POINTS = 1500


class GpFitError(RuntimeError):
    """Unrecoverable GP fit: likelihood non-finite after nugget escalation
    (mirrors the reference's LikelihoodComputationError,
    gp/src/algorithm.rs:1009-1027)."""


class FitDraws:
    """The random draws of one fit, from one CPU ``torch.Generator`` seeded
    with ``seed`` (moved to the fit's device afterwards)."""

    def __init__(self, seed: int):
        self.generator = torch.Generator().manual_seed(seed)

    def permutation(self, n: int, device) -> torch.Tensor:
        return torch.randperm(n, generator=self.generator).to(device)

    def lhs_seeds(self, n_start: int, dim: int, dtype, device):
        """(n_start, dim) maximin LHS in [0, 1]^dim (best of 5 draws)."""
        return maximin_lhs(n_start, dim, self.generator, False, 5, dtype,
                           device)


def _fit_draws(seed: int) -> FitDraws:
    return FitDraws(seed)


def _masked_norm(v, m, n_obs):
    mean = torch.sum(v * m[:, None], dim=0) / n_obs
    var = torch.sum(((v - mean) ** 2) * m[:, None], dim=0) / torch.clamp(
        n_obs - 1.0, min=1.0
    )
    std = torch.sqrt(var)
    return mean, torch.where(std <= 0, torch.ones_like(std), std)


def _model_from_inner(x_norm, x_mean, x_std, y_mean, y_std, theta, w_star,
                      inner, rlf, mask, corr, trend) -> GpModel:
    return GpModel(
        x_norm=x_norm, x_mean=x_mean, x_std=x_std, y_mean=y_mean,
        y_std=y_std, theta=theta, w_star=w_star, beta=inner.beta,
        gamma=inner.gamma, r_chol=inner.r_chol, ft=inner.ft,
        ft_qr_r=inner.ft_qr_r, sigma2=inner.sigma2, likelihood=rlf,
        mask=mask, corr=corr, trend=trend,
    )


def fit_gp_core(
    x: torch.Tensor,  # (n, nx)
    y: torch.Tensor,  # (n, 1)
    mask: torch.Tensor,  # (n,) bool
    theta0: torch.Tensor,  # (dim,) or a (k, dim) init stack
    bounds_lo: torch.Tensor,  # (dim,)
    bounds_up: torch.Tensor,  # (dim,)
    active: torch.Tensor,  # (dim,) bool
    draws: FitDraws,
    *,
    corr: str = "squared_exponential",
    trend: str = "constant",
    kpls_dim: Optional[int] = None,
    n_start: int = GP_DEFAULT_N_START,
    max_iters: int = 50,
    fixed: bool = False,
    nugget: float = 0.0,
    ls_batch: int = 0,
    residual_api: bool = False,
    grad_probes: int = 0,
    tr: bool = False,
) -> GpModel:
    """One multistart MLE on a (possibly padded) design; the restarts are
    the init (or init stack) plus ``n_start`` maximin-LHS seeds.

    The restarts are solved at once, as lanes of the lockstep L-BFGS on a
    stack of thetas (one evaluation takes every lane and every line-search
    trial; the same iterates as lane after lane), when the objective is the
    plain one (no residual reuse, no stochastic gradient), the design is
    unmasked and within ``_LANES_MAX_POINTS`` points and ``_LANES_BYTES``
    of stacked factorizations. Small designs are bound by launches, which
    this divides by the number of lanes and trials."""
    dtype = x.dtype
    m = mask.to(dtype)
    n_obs = torch.sum(m)

    x_mean, x_std = _masked_norm(x, m, n_obs)
    y_mean, y_std = _masked_norm(y, m, n_obs)
    # padded rows pinned to zero in normalized space
    x_norm = ((x - x_mean) / x_std) * m[:, None]
    y_norm = ((y - y_mean) / y_std) * m[:, None]

    w_star = None
    if kpls_dim is not None:
        w_star = pls_rotations(x * m[:, None], y * m[:, None], kpls_dim)

    def model_at(theta, rlf, inner):
        return _model_from_inner(x_norm, x_mean, x_std, y_mean, y_std,
                                 theta, w_star, inner, rlf, mask, corr,
                                 trend)

    if fixed:
        theta_opt = theta0
    else:
        dim = theta0.shape[-1]
        lo = torch.log10(bounds_lo)
        up = torch.log10(bounds_up)
        t0 = torch.log10(theta0)
        # inactive components: collapse the box so projection pins them
        lo = torch.where(active, lo, t0)
        up = torch.where(active, up, t0)
        if theta0.ndim == 2:
            if n_start > 0:
                raise ValueError(
                    "fit_gp_core: a (k, dim) theta0 init stack requires "
                    "n_start=0 (LHS seeding and multi-init are exclusive)"
                )
            inits = t0
        elif n_start > 0:
            seeds = draws.lhs_seeds(n_start, dim, dtype, x.device)
            seeds = lo[None, :] + seeds * (up - lo)[None, :]
            inits = torch.cat([t0[None, :], seeds], dim=0)
        else:
            inits = t0[None, :]
        lo_l = torch.broadcast_to(lo, inits.shape)
        up_l = torch.broadcast_to(up, inits.shape)

        n = x.shape[0]
        stacked = inits.shape[0] * max(ls_batch, 1) * n * n * x.element_size()
        if (not residual_api and not grad_probes
                and n <= _LANES_MAX_POINTS and 4 * stacked <= _LANES_BYTES
                and bool(torch.all(mask))):
            neg_rlf_theta = make_neg_reduced_likelihood(
                corr, trend, x_norm, y_norm, y_std, w_star, nugget)
            lanes = minimize_lbfgsb(
                lambda tt: neg_rlf_theta(10.0**tt), inits, lo_l, up_l,
                max_iters=max_iters, ls_batch=ls_batch, final_grad=False,
            )
            # the first lowest objective wins, as below
            theta_opt = 10.0 ** lanes.x[torch.argmin(lanes.fun)]
            rlf, inner = reduced_likelihood(
                corr, trend, x_norm, y_norm, y_std, theta_opt, w_star,
                nugget, mask)
            return model_at(theta_opt, rlf, inner)

        if residual_api:
            # value-only trials; the accepted trial's factorization feeds
            # the adjoint and becomes the final model state
            fun_and_res, grad_from_res = make_neg_rlf_residual_api(
                corr, trend, x_norm, y_norm, y_std, w_star, nugget, mask,
                stoch_probes=grad_probes,
            )
            if tr:
                def solve(t, lo, up):
                    return minimize_tr(
                        t, lo, up, fun_and_res=fun_and_res,
                        grad_from_res=grad_from_res, max_iters=max_iters,
                        final_grad=False,
                    )
            else:
                def solve(t, lo, up):
                    return minimize_lbfgsb(
                        None, t, lo, up, max_iters=max_iters,
                        ls_batch=ls_batch, fun_and_res=fun_and_res,
                        grad_from_res=grad_from_res, final_grad=False,
                    )
        else:
            neg_rlf_theta = make_neg_reduced_likelihood(
                corr, trend, x_norm, y_norm, y_std, w_star, nugget, mask,
                stoch_probes=grad_probes,
            )

            def solve(t, lo, up):
                return minimize_lbfgsb(
                    lambda tt: neg_rlf_theta(10.0**tt), t, lo, up,
                    max_iters=max_iters, ls_batch=ls_batch,
                    final_grad=False,
                )

        # lanes one after the other; the first lowest objective wins, as
        # argmin does over the vmapped lanes
        best = None
        for i in range(inits.shape[0]):
            lane = solve(inits[i], lo_l[i], up_l[i])
            if best is None or float(lane.fun) < float(best.fun):
                best = lane
        theta_opt = 10.0**best.x
        if residual_api:
            _, rlf, inner = best.res
            return model_at(theta_opt, rlf, inner)

    rlf, inner = reduced_likelihood(
        corr, trend, x_norm, y_norm, y_std, theta_opt, w_star, nugget, mask
    )
    return model_at(theta_opt, rlf, inner)


def _fit_mf_fused(
    x: torch.Tensor,
    y: torch.Tensor,
    theta0: torch.Tensor,
    bounds_lo: torch.Tensor,
    bounds_up: torch.Tensor,
    active: torch.Tensor,
    draws: FitDraws,
    *,
    corr: str,
    trend: str,
    kpls_dim: Optional[int],
    n_start: int,
    max_iters: int,
    sub_m: int,
    polish_iters: int,
    nugget: float,
    residual: bool,
    grad_probes: int,
    polish_tr: bool = False,
    sub_draws: int = 1,
) -> GpModel:
    """The multi-fidelity recipe: ``sub_draws`` random ``sub_m``-point
    subsamples each get a multistart fit; every candidate theta is then
    polished on the full data (``polish_iters`` iterations, trust-region
    when ``polish_tr``) and the best final likelihood wins."""
    n = x.shape[0]
    sub_mask = torch.ones((sub_m,), dtype=torch.bool, device=x.device)

    def subfit():
        idx = draws.permutation(n, x.device)[:sub_m]
        m0 = fit_gp_core(
            x[idx], y[idx], sub_mask, theta0, bounds_lo, bounds_up, active,
            draws, corr=corr, trend=trend, kpls_dim=kpls_dim,
            n_start=n_start, max_iters=max_iters, fixed=False,
            nugget=nugget,
        )
        return torch.clamp(m0.theta, bounds_lo, bounds_up)

    if sub_draws == 1:
        theta_w = subfit()
    else:
        theta_w = torch.stack([subfit() for _ in range(sub_draws)])

    full_mask = torch.ones((n,), dtype=torch.bool, device=x.device)
    return fit_gp_core(
        x, y, full_mask, theta_w, bounds_lo, bounds_up, active, draws,
        corr=corr, trend=trend, kpls_dim=kpls_dim, n_start=0,
        max_iters=polish_iters, fixed=False, nugget=nugget,
        residual_api=residual or polish_tr, grad_probes=grad_probes,
        tr=polish_tr,
    )


def fit_gp(
    x,
    y,
    *,
    corr: str = "squared_exponential",
    trend: str = "constant",
    theta_init=None,
    theta_bounds=None,
    n_start: int = GP_DEFAULT_N_START,
    max_iters: int = 50,
    kpls_dim: Optional[int] = None,
    nugget: Optional[float] = None,
    seed: int = 42,
    mask=None,
    theta_fixed: bool = False,
    active=None,
    subsample_warmstart: Optional[int] = None,
    polish_iters: int = 3,
    rank_warmstart: Optional[int] = None,
    mesh=None,
    grad_probes: int = 0,
    polish_residual: Optional[bool] = None,
    polish_tr: bool = False,
    sub_draws: int = 1,
    subsample_warmstart2: Optional[int] = None,
    ls_batch: int = 0,
    device=None,
) -> GpModel:
    """User-facing fit (ref: GpParams + Fit, gp/src/algorithm.rs:785-980).

    ``x`` (n, nx), ``y`` (n,) or (n, 1); tensors keep their device and
    type, numpy input goes to ``device`` (default: the GPU, and a host
    without one raises; ``device="cpu"`` runs on the CPU) in its default
    type (float64 on the CPU, float32 on CUDA). ``theta_init``/``theta_bounds`` accept
    scalars or per-dim arrays; dim = kpls_dim or nx.

    ``subsample_warmstart=m`` (with ``sub_draws``, ``polish_iters``,
    ``polish_tr``): the multi-fidelity recipe of ``_fit_mf_fused``.
    ``grad_probes=p``: squared-exponential fits estimate the gradient's
    trace term with p fixed Rademacher probes. ``polish_residual``: route
    the polish through the residual-reuse L-BFGS.

    A non-finite likelihood is retried with a 100x larger nugget, twice;
    then ``GpFitError`` is raised. ``ls_batch > 1`` takes the speculative
    line search (optim/lbfgsb.py). ``mesh``, ``rank_warmstart`` and
    ``subsample_warmstart2`` are not ported and raise.
    """
    for name, value in (("mesh", mesh), ("rank_warmstart", rank_warmstart),
                        ("subsample_warmstart2", subsample_warmstart2)):
        if value:
            raise NotImplementedError(
                f"egobox_torch: fit_gp({name}=...) is not ported"
            )
    x = as_tensor(x, device=device)
    dtype, device = x.dtype, x.device
    y = as_tensor(y, dtype=dtype, device=device).to(device)
    if y.ndim == 1:
        y = y[:, None]
    if y.shape[1] != 1:
        raise ValueError(
            "multi-output training not supported (one output expected, "
            f"got {y.shape[1]}) — mirror of the reference Gpx behavior"
        )
    n, nx = x.shape
    dim = kpls_dim if kpls_dim is not None else nx
    if kpls_dim is not None and kpls_dim > nx:
        raise ValueError(f"kpls_dim {kpls_dim} must be <= input dim {nx}")

    def param(v):
        return as_tensor(v, dtype=dtype, device=device).to(device)

    theta0 = torch.broadcast_to(
        param(theta_init if theta_init is not None
              else GP_DEFAULT_THETA_INIT), (dim,)
    ).clone()
    tb = param(theta_bounds if theta_bounds is not None
               else GP_DEFAULT_THETA_BOUNDS)
    if tb.ndim == 1:
        tb = torch.broadcast_to(tb[None, :], (dim, 2))
    bounds_lo = tb[:, 0].contiguous()
    bounds_up = tb[:, 1].contiguous()

    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=device)
    else:
        mask = as_tensor(mask, dtype=torch.bool, device=device).to(device)
    active_mask = torch.zeros((dim,), dtype=torch.bool, device=device)
    if active is None:
        active_mask[:] = True
    else:
        active_mask[torch.as_tensor(active, device=device)] = True

    if nugget is None:
        nugget = 100.0 * torch.finfo(dtype).eps

    use_mf_recipe = bool(
        subsample_warmstart
        and not theta_fixed
        and n > subsample_warmstart
        and bool(torch.all(mask))
    )
    polish_residual = bool(polish_residual)

    for _ in range(3):
        draws = _fit_draws(seed)
        if use_mf_recipe:
            model = _fit_mf_fused(
                x, y, theta0, bounds_lo, bounds_up, active_mask, draws,
                corr=corr, trend=trend, kpls_dim=kpls_dim,
                n_start=n_start, max_iters=max_iters,
                sub_m=int(subsample_warmstart), polish_iters=polish_iters,
                nugget=nugget, residual=polish_residual,
                grad_probes=grad_probes, polish_tr=polish_tr,
                sub_draws=int(sub_draws),
            )
        else:
            # polish_tr applies to a polish phase only
            in_polish = bool(
                polish_tr and subsample_warmstart and n_start == 0
            )
            model = fit_gp_core(
                x, y, mask, theta0, bounds_lo, bounds_up, active_mask,
                draws, corr=corr, trend=trend, kpls_dim=kpls_dim,
                n_start=n_start, max_iters=max_iters, fixed=theta_fixed,
                nugget=nugget, ls_batch=ls_batch,
                residual_api=polish_residual or in_polish,
                grad_probes=grad_probes, tr=in_polish,
            )
        if bool(torch.isfinite(model.likelihood)):
            return model
        nugget *= 100.0
    raise GpFitError(
        "GP fit failed: reduced likelihood is non-finite after 3 "
        f"nugget escalations (final nugget={nugget:.3g}, n={int(n)}, "
        f"corr={corr}, trend={trend}). The training design is likely "
        "degenerate (duplicated or collinear points)."
    )
