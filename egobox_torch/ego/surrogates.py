"""Surrogate training and batched prediction for the EGO solver
(port of egobox_tpu/ego/surrogates.py).

The surrogate container is one ``GpModel`` whose tensors carry a leading
axis over the 1 + n_cstr outputs (objective first), the meaning of
egobox_tpu's batched ``GpModel`` pytree: the outputs share the design, so
every field stacks. ``predict_valvar_single`` / ``predict_valvar_cloud``
evaluate all outputs at all points of a batch in one set of launches; the
infill optimizer hands them its lanes x line-search trials as one batch.

The fits of all outputs run as one lockstep stack of outputs x restarts
(``gp.fit.fit_gp_outputs``, in chunks the design's size sets), on the
unpadded design: ``mask`` is all ones, which fits exactly what egobox_tpu's
padded and masked fit computes. KPLS fits go output by output.

The clustered surrogates are the other container: a tuple of one
``moe.MoeModel`` per output (``surrogate_valvar_single`` /
``surrogate_valvar_cloud`` take either).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from ..gp import fit as gp_fit
from ..gp.fit import GP_DEFAULT_THETA_BOUNDS, GP_DEFAULT_THETA_INIT
from ..gp.gp import GpModel
from ..gp.kernels import _DENSE_BUDGET, _log_corr_terms, _takes_k1, corr_cross
from ..gp.trends import trend_basis
from ..moe.moe import moe_predict_valvar_single

@dataclass(frozen=True)
class GpSpec:
    """Static GP configuration for surrogate training (subset of the
    reference GpConfig, ego/src/solver/egor_config.rs)."""

    corr: str = "squared_exponential"
    trend: str = "constant"
    kpls_dim: Optional[int] = None
    n_start: int = 10
    max_iters: int = 50
    #: jitter factor on R's diagonal; None takes 100 machine epsilons of
    #: the design's type (egobox_tpu fixes 100 x 2.2e-16, which is nothing
    #: in the float32 the GPU computes in: its float32 Cholesky fails once
    #: the design clusters near an optimum; tests/test_torch_f32_ego.py)
    nugget: Optional[float] = None
    #: speculative line-search width of the EGO-loop fits
    #: (optim/lbfgsb.py ls_batch); 0/1 = classic sequential backtracking
    ls_batch: int = 8


def stack_models(models: Sequence[GpModel]) -> GpModel:
    """One ``GpModel`` with a leading output axis from per-output models of
    one design, kernel and trend."""
    first = models[0]
    out = {}
    for f in dataclasses.fields(GpModel):
        vals = [getattr(m, f.name) for m in models]
        if f.name in ("corr", "trend"):
            if any(v != vals[0] for v in vals):
                raise ValueError(f"stack_models: {f.name} differs: {vals}")
            out[f.name] = vals[0]
        elif vals[0] is None:
            out[f.name] = None
        else:
            out[f.name] = torch.stack(vals)
    if first.x_norm.ndim != 2:
        raise ValueError("stack_models: expected unbatched models")
    return GpModel(**out)


def train_gp_surrogates(
    x: torch.Tensor,  # (n, nx)
    y_all: torch.Tensor,  # (n, m) objective + constraints columns
    mask: Optional[torch.Tensor],  # (n,) bool or None (all active)
    spec: GpSpec,
    theta0s: Optional[torch.Tensor] = None,  # (m, dim) warm-start inits
    optimize_theta: bool = True,
    theta_bounds=None,
    seed: int = 42,
    active_theta: Optional[torch.Tensor] = None,  # (dim,) bool
    n_start: Optional[int] = None,  # override spec.n_start (warm refits)
    fit_draws=None,  # seed -> FitDraws (default: gp.fit._fit_draws)
) -> GpModel:
    """Fit one GP per column of ``y_all``; returns the stacked container.

    ``optimize_theta=False`` reuses ``theta0s`` as fixed hyperparameters,
    the reference's q_optmod thinning (solver_impl.rs:643-645).
    ``active_theta`` restricts the optimization to a subset of theta
    components. The restart seeds come from one ``fit_draws(seed)``: all
    outputs see the same seeds, as under egobox_tpu's vmap over outputs
    with one key.

    A fit whose likelihood is not finite (in float32, a Gram the jitter
    does not make positive definite for any restart) is repeated, that
    output alone, with a 100 times larger nugget, twice at most, as
    ``fit_gp`` does; the last model is kept then, as egobox_tpu keeps its
    only one."""
    n, nx = x.shape
    m = y_all.shape[1]
    dtype, device = x.dtype, x.device
    dim = spec.kpls_dim if spec.kpls_dim is not None else nx

    if theta0s is None:
        theta0s = torch.full((m, dim), GP_DEFAULT_THETA_INIT, dtype=dtype,
                             device=device)
    tb = theta_bounds if theta_bounds is not None else GP_DEFAULT_THETA_BOUNDS
    tb = torch.as_tensor(tb, dtype=dtype, device=device)
    if tb.ndim == 1:
        tb = torch.broadcast_to(tb[None, :], (dim, 2))
    lo, up = tb[:, 0].contiguous(), tb[:, 1].contiguous()
    # clip warm-started inits into the bounds
    theta0s = torch.clamp(theta0s.to(dtype=dtype, device=device), lo, up)

    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=device)
    if active_theta is None:
        active_theta = torch.ones((dim,), dtype=torch.bool, device=device)
    if fit_draws is None:
        fit_draws = gp_fit._fit_draws
    nugget0 = spec.nugget
    if nugget0 is None:
        nugget0 = 100.0 * torch.finfo(dtype).eps

    ns = spec.n_start if n_start is None else n_start
    fit_kw = dict(corr=spec.corr, trend=spec.trend, max_iters=spec.max_iters,
                  fixed=not optimize_theta, ls_batch=spec.ls_batch)
    if spec.kpls_dim is not None:
        # KPLS weights depend on each output's data: output by output
        def fit(cols, nugget):
            return stack_models([
                gp_fit.fit_gp_core(
                    x, y_all[:, j:j + 1], mask, theta0s[j], lo, up,
                    active_theta, fit_draws(seed), kpls_dim=spec.kpls_dim,
                    n_start=ns, nugget=nugget, **fit_kw)
                for j in cols])
    else:
        # the outputs x restarts as one stack; every output sees the same
        # seeds
        seeds = (fit_draws(seed).lhs_seeds(ns, dim, dtype, device)
                 if optimize_theta and ns > 0 else None)

        def fit(cols, nugget):
            return gp_fit.fit_gp_outputs(
                x, y_all[:, cols], mask, theta0s[cols], lo, up, active_theta,
                seeds, n_start=0 if seeds is None else ns, nugget=nugget,
                **fit_kw)

    cols = list(range(m))
    models = fit(cols, nugget0)
    outs = [gp_fit.output_model(models, j) for j in cols]
    nugget = nugget0
    for _ in range(2):
        bad = [j for j, ok in zip(cols, torch.isfinite(models.likelihood)
                                  .tolist()) if not ok]
        if not bad:
            break
        nugget *= 100.0
        cols = bad
        models = fit(cols, nugget)
        for i, j in enumerate(cols):
            outs[j] = gp_fit.output_model(models, i)
    return stack_models(outs)


def _mixtures_valvar(models, x: torch.Tensor):
    """(means, vars), each (m, ...), of a tuple of mixtures at x (..., nx)."""
    pairs = [moe_predict_valvar_single(mo, x) for mo in models]
    return (torch.stack([p[0] for p in pairs]),
            torch.stack([p[1] for p in pairs]))


def surrogate_valvar_single(models, x: torch.Tensor):
    """Posterior (means, vars) at one point, or one point per lane, for
    either container: the stacked ``GpModel`` or a tuple of mixtures."""
    if isinstance(models, tuple):
        return _mixtures_valvar(models, x)
    return predict_valvar_single(models, x)


def surrogate_valvar_cloud(models, x: torch.Tensor):
    """Posterior (means, vars) over a cloud: (m, p) pairs."""
    if isinstance(models, tuple):
        return _mixtures_valvar(models, x)
    return predict_valvar_cloud(models, x)


def _corr_to_train(models: GpModel, xnorm: torch.Tensor) -> torch.Tensor:
    """r(x, X_train) for every output: xnorm (m, p, nx) -> (m, p, n)."""
    m = xnorm.shape[0]
    name = models.corr
    if models.w_star is not None or _takes_k1(
        name, xnorm[0], models.x_norm[0], models.theta[0], None
    ):
        # KPLS weights, and the Grams K1 builds (large, float32, on the
        # GPU, no gradient asked), go output by output
        r = torch.stack([
            corr_cross(name, xnorm[i], models.x_norm[i], models.theta[i],
                       None if models.w_star is None else models.w_star[i])
            for i in range(m)
        ])
    elif name == "squared_exponential":
        # the matmul expansion of gp.kernels._sqexp_cross_fast, batched
        a = xnorm * models.theta[:, None, :]
        b = models.x_norm * models.theta[:, None, :]
        a2 = torch.sum(a * a, dim=2)[:, :, None]
        b2 = torch.sum(b * b, dim=2)[:, None, :]
        sq = torch.clamp(a2 + b2 - 2.0 * (a @ b.mT), min=0.0)
        r = torch.exp(-0.5 * sq)
    else:
        thw = models.theta[:, None, None, :]
        n, nx = models.x_norm.shape[1:]
        rows = max(1, _DENSE_BUDGET // max(1, m * n * nx))
        blocks = []
        for s in range(0, xnorm.shape[1], rows):
            dabs = torch.abs(xnorm[:, s:s + rows, None, :]
                             - models.x_norm[:, None, :, :])
            blocks.append(torch.exp(_log_corr_terms(name, dabs, thw, True)))
        r = blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=1)
    return r * models.mask.to(r.dtype)[:, None, :]


def _predict_valvar(models: GpModel, x: torch.Tensor):
    """x (p, nx), or one batch per output (m, p, nx) -> (means, variances),
    each (m, p): ``gp.predict_valvar`` of every output at once (triangular
    solves and products broadcast over the output axis)."""
    m = models.x_norm.shape[0]
    p, nx = x.shape[-2:]
    xs = x if x.ndim == 3 else x[None, :, :]
    xnorm = (xs - models.x_mean[:, None, :]) / models.x_std[:, None, :]
    r = _corr_to_train(models, xnorm)  # (m, p, n)
    f = trend_basis(models.trend, xnorm.reshape(m * p, nx)).reshape(m, p, -1)
    y = f @ models.beta + r @ models.gamma  # (m, p, 1)
    mean = (y * models.y_std[:, None, :] + models.y_mean[:, None, :])[..., 0]
    rt = torch.linalg.solve_triangular(models.r_chol, r.mT, upper=False)
    rhs = models.ft.mT @ rt - f.mT  # (m, q, p)
    u = torch.linalg.solve_triangular(models.ft_qr_r.mT, rhs, upper=False)
    mse = models.sigma2[:, None] * (
        1.0 - torch.sum(rt**2, dim=1) + torch.sum(u**2, dim=1)
    )
    return mean, torch.clamp(mse, min=0.0)


def predict_valvar_single(models: GpModel, x: torch.Tensor):
    """Posterior (means, variances) of every output at one point x (nx,)
    -> ((m,), (m,)), or at a batch of points x (..., nx) -> ((m, ...),
    (m, ...)): the lanes and line-search trials of the infill optimizer."""
    lead = x.shape[:-1]
    means, vrs = _predict_valvar(models, x.reshape(-1, x.shape[-1]))
    m = means.shape[0]
    return means.reshape((m,) + lead), vrs.reshape((m,) + lead)


def predict_valvar_cloud(models: GpModel, x: torch.Tensor):
    """Posterior (means, variances) of every output over a cloud
    x (p, nx) -> ((m, p), (m, p))."""
    return _predict_valvar(models, x)
