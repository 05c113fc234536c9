"""GP hyperparameter fit: multistart MLE on log10(theta)
(port of egobox_tpu/gp/fit.py).

- the (n_start + 1) restarts (user init + maximin-LHS seeds over the log10
  bounds, ref optimization.rs:26-71) each run the bounded L-BFGS on the
  likelihood with its analytic adjoint; egobox_tpu advances them as one
  vmapped program, and so does the port (lockstep lanes on a stack of
  thetas) up to ``_LANES_MAX_POINTS`` points and ``_LANES_BYTES`` of
  stacked factorizations; above, and on the residual-reuse path, lane
  after lane;
- ``fit_gp_outputs`` fits the columns of a multi-output design at once: the
  outputs x restarts are one lockstep stack, as egobox_tpu's
  ``jax.vmap(fit_one)`` over outputs is one program;
- ThetaTuning Fixed/Full/Partial maps to ``theta_fixed`` and an ``active``
  mask whose inactive bounds collapse to the init value;
- ``mask`` fits the active rows of a padded design exactly;
- ``subsample_warmstart`` runs the multi-fidelity recipe: multistart fits on
  ``sub_draws`` random subsamples (and one of ``subsample_warmstart2``
  points), then a polish of every candidate on the full data, best final
  likelihood wins; with ``rank_warmstart`` the optima of one subsample's
  multistart are ranked on a larger subsample first (``_warmstart_theta``)
  and the winner alone is polished.

Every random draw of a fit (the subsample permutations and the maximin-LHS
restart seeds) comes from one draws object: for the subsample recipes
(``subsample_warmstart``, with or without ``rank_warmstart``) the
``ThreefryDraws`` of ``_recipe_draws``, egobox_tpu's own key stream
(doe/threefry.py), so that ``fit_gp(seed=s)`` draws the subsamples and
seeds egobox_tpu draws; for the plain multistart a ``FitDraws`` built by
``_fit_draws(seed)``. Tests replace either function to hand in draws.

Why two streams: the subsample recipes are bench.py's shipped fit, whose
1.0 % quality gate holds at egobox_tpu's own draws (fit seed 42) and misses
at about a third of other draws, so the port draws those. The plain
multistart, and through it the mixture's, the EGO loop's and the sparse
fit's restart seeds, keeps the torch stream its float64 goldens on the card
were met with; moving it to threefry changes every landing and is left to
be weighed with the port's benchmark. (The distributed fit's warm-start
permutation is numpy's ``default_rng(seed)``, as egobox_tpu's is.)
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import torch

from ..config import as_tensor
from ..doe import threefry
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


class ThreefryDraws:
    """The draws of a subsample recipe from egobox_tpu's key stream: each
    subsample's permutation and its fit's maximin-LHS seeds from a pair of
    threefry keys, taken pair after pair (the interface of ``FitDraws``)."""

    def __init__(self, perm_keys, lhs_keys):
        self.perm_keys, self.lhs_keys = list(perm_keys), list(lhs_keys)

    def permutation(self, n: int, device) -> torch.Tensor:
        return torch.from_numpy(threefry.permutation(
            self.perm_keys.pop(0), n)).to(device)

    def lhs_seeds(self, n_start: int, dim: int, dtype, device):
        np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        return torch.from_numpy(threefry.maximin_lhs(
            self.lhs_keys.pop(0), n_start, dim, np_dtype)).to(device)


def _recipe_draws(seed: int, sub_draws: int = 1,
                  sub_m2: bool = False) -> ThreefryDraws:
    """egobox_tpu's keys of ``fit_gp(seed=...)``'s subsample recipes
    (gp/fit.py ``_fit_mf_fused``; the ranked warm start takes the one-draw
    stream): key(seed) split into the subsample key and the fit key; with
    several draws the subsample key split into a permutation key and a
    fit key per draw, and the second-fidelity pair from its fold with 7."""
    ksub, kfit = threefry.split(threefry.key(seed))
    if sub_draws == 1 and not sub_m2:
        return ThreefryDraws([ksub], [kfit])
    dkeys = threefry.split(ksub, 2 * sub_draws)
    perm_keys, lhs_keys = list(dkeys[:sub_draws]), list(dkeys[sub_draws:])
    if sub_m2:
        k2d, k2f = threefry.split(threefry.fold_in(ksub, 7))
        perm_keys.append(k2d)
        lhs_keys.append(k2f)
    return ThreefryDraws(perm_keys, lhs_keys)


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
    graph_safe: bool = False,
) -> GpModel:
    """One multistart MLE on a (possibly padded) design; the restarts are
    the init (or init stack) plus ``n_start`` maximin-LHS seeds.

    The plain objective (no residual reuse, no stochastic gradient) is the
    one-output case of ``fit_gp_outputs``: the restarts run as lockstep
    lanes on a stack of thetas, in chunks the design's size sets. The
    residual-reuse and stochastic-gradient objectives take one theta: their
    restarts run lane after lane. ``graph_safe``: the form without host
    reads (optim/lbfgsb.py), for a CUDA graph."""
    if theta0.ndim == 2 and n_start > 0 and not fixed:
        raise ValueError(
            "fit_gp_core: a (k, dim) theta0 init stack requires "
            "n_start=0 (LHS seeding and multi-init are exclusive)"
        )
    if graph_safe and (residual_api or grad_probes):
        raise ValueError("fit_gp_core: graph_safe takes the plain "
                         "objective (no residual reuse, no probes)")
    dtype = x.dtype
    m = mask.to(dtype)
    w_star = None
    if kpls_dim is not None:
        w_star = pls_rotations(x * m[:, None], y * m[:, None], kpls_dim)

    if fixed or not (residual_api or grad_probes):
        seeds = None
        if not fixed and theta0.ndim == 1 and n_start > 0:
            seeds = draws.lhs_seeds(n_start, theta0.shape[-1], dtype,
                                    x.device)
        return output_model(fit_gp_outputs(
            x, y, mask, theta0[None], bounds_lo, bounds_up, active, seeds,
            w_star=w_star, corr=corr, trend=trend,
            n_start=0 if seeds is None else n_start, max_iters=max_iters,
            fixed=fixed, nugget=nugget, ls_batch=ls_batch,
            graph_safe=graph_safe), 0)

    n_obs = torch.sum(m)
    x_mean, x_std = _masked_norm(x, m, n_obs)
    y_mean, y_std = _masked_norm(y, m, n_obs)
    # padded rows pinned to zero in normalized space
    x_norm = ((x - x_mean) / x_std) * m[:, None]
    y_norm = ((y - y_mean) / y_std) * m[:, None]
    lo = torch.log10(bounds_lo)
    up = torch.log10(bounds_up)
    t0 = torch.log10(theta0)
    # inactive components: collapse the box so projection pins them
    lo = torch.where(active, lo, t0)
    up = torch.where(active, up, t0)
    if theta0.ndim == 2:
        inits = t0
    elif n_start > 0:
        seeds = draws.lhs_seeds(n_start, theta0.shape[-1], dtype, x.device)
        seeds = lo[None, :] + seeds * (up - lo)[None, :]
        inits = torch.cat([t0[None, :], seeds], dim=0)
    else:
        inits = t0[None, :]
    lo_l = torch.broadcast_to(lo, inits.shape)
    up_l = torch.broadcast_to(up, inits.shape)

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
                max_iters=max_iters, ls_batch=ls_batch, final_grad=False,
            )

    # lanes one after the other; the first lowest objective wins, as
    # argmin does over the lockstep lanes
    best = None
    for i in range(inits.shape[0]):
        lane = solve(inits[i], lo_l[i], up_l[i])
        if best is None or float(lane.fun) < float(best.fun):
            best = lane
    theta_opt = 10.0**best.x
    if residual_api:
        _, rlf, inner = best.res
    else:
        rlf, inner = reduced_likelihood(
            corr, trend, x_norm, y_norm, y_std, theta_opt, w_star, nugget,
            mask)
    return _model_from_inner(x_norm, x_mean, x_std, y_mean, y_std,
                             theta_opt, w_star, inner, rlf, mask, corr,
                             trend)


def lanes_per_chunk(n: int, ls_batch: int, element_size: int) -> int:
    """How many restarts of a fit on n points advance as one lockstep
    stack (one evaluation takes all their line-search trials): from shapes
    alone. Up to ``_LANES_MAX_POINTS`` points, as many as keep 4 stacked
    (lanes x trials, n, n) arrays within ``_LANES_BYTES``; above, one."""
    if n > _LANES_MAX_POINTS:
        return 1
    lane = 4 * max(ls_batch, 1) * n * n * element_size
    return max(1, _LANES_BYTES // lane)


def _lane_optima(corr, trend, x_lanes, y_lanes, std_lanes, mask_lanes,
                 inits, lo_l, up_l, *, w_star, nugget, shared: bool,
                 max_iters: int, ls_batch: int, graph_safe: bool = False):
    """The bounded L-BFGS of every lane of a stack of restarts on the
    likelihood: ``inits`` / ``lo_l`` / ``up_l`` (L, dim) in log10(theta),
    ``y_lanes`` (L, n, 1) and ``std_lanes`` (L,) per lane, ``x_lanes`` /
    ``mask_lanes`` one design for every lane (``shared``) or one per lane.
    The stack advances in chunks of ``lanes_per_chunk`` lanes, one lockstep
    L-BFGS after the other. Returns each lane's end point and objective,
    (L, dim) and (L,)."""
    n = y_lanes.shape[-2]
    chunk = lanes_per_chunk(n, ls_batch, y_lanes.element_size())
    xs, funs = [], []
    for s in range(0, inits.shape[0], chunk):
        if chunk == 1 and not graph_safe:
            # one restart: the one-theta objective and L-BFGS, as lane
            # after lane has always run
            neg_rlf_theta = make_neg_reduced_likelihood(
                corr, trend, x_lanes if shared else x_lanes[s],
                y_lanes[s], std_lanes[s:s + 1], w_star, nugget,
                mask_lanes if shared else mask_lanes[s])
            lane = minimize_lbfgsb(
                lambda tt: neg_rlf_theta(10.0**tt), inits[s], lo_l[s],
                up_l[s], max_iters=max_iters, ls_batch=ls_batch,
                final_grad=False,
            )
            xs.append(lane.x[None])
            funs.append(lane.fun.reshape(1))
            continue
        sl = slice(s, s + chunk)
        neg_rlf_theta = make_neg_reduced_likelihood(
            corr, trend, x_lanes if shared else x_lanes[sl],
            y_lanes[sl], std_lanes[sl], w_star, nugget,
            mask_lanes if shared else mask_lanes[sl])
        lanes = minimize_lbfgsb(
            lambda tt: neg_rlf_theta(10.0**tt), inits[sl], lo_l[sl],
            up_l[sl], max_iters=max_iters, ls_batch=ls_batch,
            final_grad=False, graph_safe=graph_safe,
        )
        xs.append(lanes.x)
        funs.append(lanes.fun)
    xs = xs[0] if len(xs) == 1 else torch.cat(xs)
    funs = funs[0] if len(funs) == 1 else torch.cat(funs)
    return xs, funs


def output_model(models: GpModel, j: int) -> GpModel:
    """Output ``j`` of a stacked container, as ``fit_gp_core`` returns it."""
    return dataclasses.replace(models, **{
        f.name: getattr(models, f.name)[j]
        for f in dataclasses.fields(models)
        if isinstance(getattr(models, f.name), torch.Tensor)})


def fit_gp_outputs(
    x: torch.Tensor,  # (n, nx), or (P, n, nx)
    ys: torch.Tensor,  # (n, m), or (P, n, m)
    mask: torch.Tensor,  # (n,) bool, or (P, n)
    theta0s: torch.Tensor,  # (m, dim) or (m, k, dim), or (P, m, dim)
    bounds_lo: torch.Tensor,  # (dim,)
    bounds_up: torch.Tensor,  # (dim,)
    active: torch.Tensor,  # (dim,) bool
    seeds: Optional[torch.Tensor],  # (n_start, dim) LHS in [0, 1], or (P, ..)
    *,
    w_star: Optional[torch.Tensor] = None,  # (nx, kpls_dim), one output
    corr: str = "squared_exponential",
    trend: str = "constant",
    n_start: int = GP_DEFAULT_N_START,
    max_iters: int = 50,
    fixed: bool = False,
    nugget: float = 0.0,
    ls_batch: int = 0,
    graph_safe: bool = False,
) -> GpModel:
    """A multistart MLE of every column of ``ys`` on one (padded) design,
    the m outputs x restarts as one lockstep stack of thetas (egobox_tpu's
    ``jax.vmap(fit_one)`` over outputs, ego/fused_step.py:85-92). Every
    output's restarts are its init (or its (k, dim) init stack, with
    ``n_start=0``) and the same ``seeds`` (one key for all outputs there
    too); the first lowest objective of an output's restarts wins. Returns
    the stacked container of ego/surrogates.py: every field carries a
    leading output axis.

    The stack advances in chunks of ``lanes_per_chunk`` lanes, one
    lockstep L-BFGS after the other (a chunk count fixed by the shapes, so
    the form without host reads stays one program): the whole stack on a
    small design, one restart at a time above ``_LANES_MAX_POINTS`` points
    (with host reads allowed, on one theta, as lane after lane runs).

    With a leading problem axis P (EgorBatch), every problem has its own
    design, data and seeds, the P x m x (1 + n_start) restarts are one
    stack, and the container's leading axis is the P x m outputs, problem
    after problem. ``w_star`` (KPLS weights) takes one output of one
    problem."""
    single = x.ndim == 2
    if single:
        x, ys, mask, theta0s = x[None], ys[None], mask[None], theta0s[None]
        seeds = None if seeds is None else seeds[None]
    dtype = x.dtype
    n_prob, n, nx = x.shape
    m_out = ys.shape[2]
    n_lead = n_prob * m_out
    if w_star is not None and n_lead != 1:
        raise ValueError("fit_gp_outputs: KPLS weights take one output")
    mk = mask.to(dtype)
    n_obs = torch.sum(mk, dim=-1)[:, None]

    def norm(v):
        mean = torch.sum(v * mk[..., None], dim=-2) / n_obs
        var = torch.sum(((v - mean[:, None]) ** 2) * mk[..., None],
                        dim=-2) / torch.clamp(n_obs - 1.0, min=1.0)
        std = torch.sqrt(var)
        return mean, torch.where(std <= 0, torch.ones_like(std), std)

    x_mean, x_std = norm(x)  # (P, nx)
    y_mean, y_std = norm(ys)  # (P, m)
    # padded rows pinned to zero in normalized space
    x_norm = ((x - x_mean[:, None]) / x_std[:, None]) * mk[..., None]
    # (P * m, n, 1): output after output, problem after problem
    y_norm = (((ys - y_mean[:, None]) / y_std[:, None]) * mk[..., None]
              ).transpose(1, 2).reshape(n_lead, n, 1)
    y_std = y_std.reshape(n_lead)

    def per_lane(v, lanes):
        """The design of each problem for its ``lanes`` lanes (a single
        problem's design is shared as it is)."""
        if single:
            return v[0]
        return v[:, None].expand((n_prob, lanes) + v.shape[1:]).reshape(
            (n_prob * lanes,) + v.shape[1:])

    if fixed:
        theta_opt = theta0s.reshape(n_lead, -1)
    else:
        dim = theta0s.shape[-1]
        t0 = torch.log10(theta0s)
        if t0.ndim == 3:
            t0 = t0[:, :, None, :]  # (P, m, 1, dim): one init per output
        # inactive components: collapse the box so projection pins them
        lo = torch.where(active, torch.log10(bounds_lo), t0)
        up = torch.where(active, torch.log10(bounds_up), t0)
        inits = t0
        if n_start > 0:
            sd = lo + seeds[:, None] * (up - lo)
            inits = torch.cat([inits, sd], dim=2)
        k = inits.shape[2]
        shape = (n_lead * k, dim)
        lo_l = torch.broadcast_to(lo, inits.shape).reshape(shape)
        up_l = torch.broadcast_to(up, inits.shape).reshape(shape)
        inits = inits.reshape(shape)
        y_lanes = y_norm[:, None].expand((n_lead, k) + y_norm.shape[1:]
                                         ).reshape((-1,) + y_norm.shape[1:])
        std_lanes = y_std[:, None].expand(n_lead, k).reshape(-1)
        x_lanes = per_lane(x_norm, m_out * k)
        mask_lanes = per_lane(mask, m_out * k)
        xs, funs = _lane_optima(
            corr, trend, x_lanes, y_lanes, std_lanes, mask_lanes, inits,
            lo_l, up_l, w_star=w_star, nugget=nugget, shared=single,
            max_iters=max_iters, ls_batch=ls_batch, graph_safe=graph_safe)
        best = torch.argmin(funs.reshape(n_lead, k), dim=1)
        xs = xs.reshape(n_lead, k, dim)
        theta_opt = 10.0 ** xs[torch.arange(n_lead, device=x.device), best]

    rlf, inner = reduced_likelihood(
        corr, trend, per_lane(x_norm, m_out), y_norm, y_std, theta_opt,
        w_star, nugget, per_lane(mask, m_out))

    def per_output(v):
        return v[:, None].expand((n_prob, m_out) + v.shape[1:]).reshape(
            (n_lead,) + v.shape[1:])

    return GpModel(
        x_norm=per_output(x_norm), x_mean=per_output(x_mean),
        x_std=per_output(x_std), y_mean=y_mean.reshape(n_lead, 1),
        y_std=y_std[:, None], theta=theta_opt,
        w_star=None if w_star is None else w_star[None], beta=inner.beta,
        gamma=inner.gamma, r_chol=inner.r_chol, ft=inner.ft,
        ft_qr_r=inner.ft_qr_r, sigma2=inner.sigma2, likelihood=rlf,
        mask=per_output(mask), corr=corr, trend=trend,
    )


def _warmstart_theta(
    x_sub: torch.Tensor,  # (m, nx) fit subsample
    y_sub: torch.Tensor,  # (m, 1)
    x_rank: torch.Tensor,  # (r, nx) ranking subsample (r >= m)
    y_rank: torch.Tensor,  # (r, 1)
    theta0: torch.Tensor,
    bounds_lo: torch.Tensor,
    bounds_up: torch.Tensor,
    draws: FitDraws,
    *,
    corr: str,
    trend: str,
    kpls_dim: Optional[int],
    n_start: int,
    max_iters: int,
    nugget: float,
    ls_batch: int = 0,
) -> torch.Tensor:
    """Multi-fidelity warm start with candidate ranking: the multistart MLE
    on the m-point subsample (theta0 and ``n_start`` maximin-LHS seeds as
    one stack of lockstep lanes, in the chunks the subsample's size sets),
    then every lane's optimum re-ranked by its exact reduced likelihood on
    the larger r-point subsample (one stack of Grams), the winner returned.
    The subsample likelihood misranks theta basins; ranking on more data
    before the full-data polish commits to one fixes that, for (1 +
    n_start) O(r^3) forwards. Nothing is read on the host."""
    dim = theta0.shape[0]

    def norm(x, y):
        x_mean, x_std = torch.mean(x, dim=0), torch.std(x, dim=0)
        x_std = torch.where(x_std <= 0, torch.ones_like(x_std), x_std)
        y_mean, y_std = torch.mean(y, dim=0), torch.std(y, dim=0)
        y_std = torch.where(y_std <= 0, torch.ones_like(y_std), y_std)
        return (x - x_mean) / x_std, (y - y_mean) / y_std, y_std

    xs_norm, ys_norm, ys_std = norm(x_sub, y_sub)
    xr_norm, yr_norm, yr_std = norm(x_rank, y_rank)

    w_sub = w_rank = None
    if kpls_dim is not None:
        w_sub = pls_rotations(x_sub, y_sub, kpls_dim)
        w_rank = pls_rotations(x_rank, y_rank, kpls_dim)

    lo = torch.log10(bounds_lo)
    up = torch.log10(bounds_up)
    t0 = torch.log10(theta0)
    seeds = draws.lhs_seeds(n_start, dim, x_sub.dtype, x_sub.device)
    inits = torch.cat([t0[None, :], lo[None, :] + seeds * (up - lo)[None, :]])
    k = inits.shape[0]
    t_opt, _ = _lane_optima(
        corr, trend, xs_norm, ys_norm[None].expand((k,) + ys_norm.shape),
        ys_std.expand(k), None, inits, lo.expand(k, dim), up.expand(k, dim),
        w_star=w_sub, nugget=nugget, shared=True, max_iters=max_iters,
        ls_batch=ls_batch)
    thetas = 10.0**t_opt  # (1 + n_start, dim)

    rlfs, _ = reduced_likelihood(
        corr, trend, xr_norm, yr_norm[None].expand((k,) + yr_norm.shape),
        yr_std.expand(k), thetas, w_rank, nugget)
    rlfs = torch.where(torch.isfinite(rlfs), rlfs,
                       torch.full_like(rlfs, -torch.inf))
    return thetas.index_select(0, torch.argmax(rlfs).reshape(1))[0]


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
    sub_m2: int = 0,
) -> GpModel:
    """The multi-fidelity recipe: ``sub_draws`` random ``sub_m``-point
    subsamples, and with ``sub_m2`` one more draw of ``sub_m2`` points (a
    second fidelity), each get a multistart fit; every candidate theta is
    then polished on the full data (``polish_iters`` iterations,
    trust-region when ``polish_tr``) and the best final likelihood wins.
    The draws are taken subsample after subsample: its permutation, then
    its fit's restart seeds, the ``sub_m2`` draw last."""
    n = x.shape[0]

    def subfit(m):
        idx = draws.permutation(n, x.device)[:m]
        m0 = fit_gp_core(
            x[idx], y[idx], torch.ones((m,), dtype=torch.bool,
                                       device=x.device),
            theta0, bounds_lo, bounds_up, active,
            draws, corr=corr, trend=trend, kpls_dim=kpls_dim,
            n_start=n_start, max_iters=max_iters, fixed=False,
            nugget=nugget,
        )
        return torch.clamp(m0.theta, bounds_lo, bounds_up)

    if sub_draws == 1 and not sub_m2:
        theta_w = subfit(sub_m)
    else:
        cands = [subfit(sub_m) for _ in range(sub_draws)]
        if sub_m2:
            cands.append(subfit(sub_m2))
        theta_w = torch.stack(cands)

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
    dist_bp: Optional[int] = None,
    mesh_materialize: bool = False,
    grad_probes: int = 0,
    polish_residual: Optional[bool] = None,
    polish_tr: bool = False,
    sub_draws: int = 1,
    subsample_warmstart2: Optional[int] = None,
    ls_batch: int = 0,
    device=None,
):
    """User-facing fit (ref: GpParams + Fit, gp/src/algorithm.rs:785-980).

    ``x`` (n, nx), ``y`` (n,) or (n, 1); tensors keep their device and
    type, numpy input goes to ``device`` (default: the GPU, and a host
    without one raises; ``device="cpu"`` runs on the CPU) in its default
    type (float64 on the CPU, float32 on CUDA). ``theta_init``/``theta_bounds`` accept
    scalars or per-dim arrays; dim = kpls_dim or nx.

    ``subsample_warmstart=m`` (with ``sub_draws``, ``subsample_warmstart2``,
    ``polish_iters``, ``polish_tr``): the multi-fidelity recipe of
    ``_fit_mf_fused``; ``subsample_warmstart2=m2`` adds one draw of m2
    points to the candidates. ``rank_warmstart=r`` (with
    ``subsample_warmstart``) takes ``_warmstart_theta`` instead: the
    multistart on one m-point subsample (at least 3 seeds and 8
    iterations), its optima ranked on an r-point subsample (r = max(r, m),
    at most n), the winner polished on the full data (the residual route,
    unless ``polish_residual`` says otherwise); ``sub_draws`` and
    ``subsample_warmstart2`` are then ignored with a warning, as egobox_tpu
    ignores them there. ``grad_probes=p``: squared-exponential fits
    estimate the gradient's trace term with p fixed Rademacher probes.
    ``polish_residual``: route the polish through the residual-reuse
    L-BFGS.

    A non-finite likelihood is retried with a 100x larger nugget, twice;
    then ``GpFitError`` is raised. ``ls_batch > 1`` takes the speculative
    line search (optim/lbfgsb.py).

    ``mesh``: an ``egobox_torch.parallel`` ``Mesh``; every rank of it
    calls ``fit_gp`` with the same data. The theta MLE (likelihood value
    AND analytic gradient) runs on the row blocks (parallel/dist_fit.py:
    block-cyclic Cholesky, row-block trace contraction; with
    ``subsample_warmstart`` its warm start is the one-device multistart
    on that many points, then ``polish_iters`` iterations on the whole
    design), so no rank holds the (n, n) factorization. Requires a full
    mask and n divisible by the mesh size (KPLS is supported);
    ``dist_bp`` sets the Cholesky panel size. The result is a
    ``DistGpModel`` (parallel/dist_model.py) whose factor, gamma and
    whitened trend basis stay in row blocks, realized with up to 3 nugget
    escalations (x100) before ``GpFitError``; predict / predict_var run
    distributed too. ``mesh_materialize=True`` returns instead a plain
    ``GpModel`` at the distributed theta (only sensible when (n, n) fits
    one device). Numpy input goes to the mesh's device.
    """
    if mesh is not None:
        from ..parallel.sharding import Mesh

        if not isinstance(mesh, Mesh):
            raise TypeError("fit_gp: mesh must be an egobox_torch.parallel "
                            f"Mesh, got {type(mesh).__name__}")
        if device is None:
            device = mesh.device
    x = as_tensor(x, device=device)
    if mesh is not None and x.device != mesh.device:
        raise ValueError(f"fit_gp: x is on {x.device}, the mesh's rank "
                         f"computes on {mesh.device}")
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

    if mesh is not None:
        if not bool(torch.all(mask)):
            raise ValueError(
                "fit_gp(mesh=...) requires a full mask (no padding)")
        if not theta_fixed:
            from ..parallel.dist_fit import fit_theta_distributed

            theta_dist, _ = fit_theta_distributed(
                mesh, x, y, corr=corr, trend=trend,
                theta0=None if theta_init is None and subsample_warmstart
                else theta0,
                theta_bounds=torch.stack([bounds_lo, bounds_up], dim=1),
                max_iters=max_iters, nugget=nugget, bp=dist_bp,
                subsample_warmstart=subsample_warmstart,
                polish_iters=polish_iters, seed=seed, kpls_dim=kpls_dim,
                grad_probes=grad_probes,
            )
            theta0 = torch.clamp(theta_dist, bounds_lo, bounds_up)
            theta_fixed = True
        if not mesh_materialize:
            from ..parallel.dist_model import realize_dist_model

            for _ in range(3):
                dmodel = realize_dist_model(
                    mesh, x, y, theta0, corr=corr, trend=trend,
                    nugget=nugget, bp=dist_bp, kpls_dim=kpls_dim,
                )
                if bool(torch.isfinite(dmodel.likelihood)):
                    return dmodel
                nugget *= 100.0
            raise GpFitError(
                "distributed GP fit failed: likelihood non-finite after 3 "
                f"nugget escalations (final nugget={nugget:.3g})"
            )

    use_mf_recipe = bool(
        subsample_warmstart
        and not theta_fixed
        and n > subsample_warmstart
        and bool(torch.all(mask))
    )
    auto_polish_residual = polish_residual
    polish_residual = False
    if use_mf_recipe and rank_warmstart:
        if sub_draws > 1 or subsample_warmstart2:
            warnings.warn(
                "fit_gp: sub_draws/subsample_warmstart2 are only honored "
                "by the fused recipe, not with rank_warmstart: one "
                "subsample draw", stacklevel=2,
            )
        # the subsample likelihood misranks theta basins: rank every
        # restart on a larger subset before the polish commits to a basin
        draws = _recipe_draws(seed)
        perm = draws.permutation(n, device)
        idx = perm[:subsample_warmstart]
        ridx = perm[:min(n, max(rank_warmstart, subsample_warmstart))]
        theta_warm = _warmstart_theta(
            x[idx], y[idx], x[ridx], y[ridx], theta0, bounds_lo, bounds_up,
            draws, corr=corr, trend=trend, kpls_dim=kpls_dim,
            n_start=max(n_start, 3), max_iters=max(max_iters, 8),
            nugget=nugget,
        )
        theta0 = torch.clamp(theta_warm, bounds_lo, bounds_up)
        polish_residual = True
        use_mf_recipe = False
        n_start = 0
        max_iters = polish_iters
    if auto_polish_residual is not None:
        polish_residual = bool(auto_polish_residual)

    for _ in range(3):
        if use_mf_recipe:
            draws = _recipe_draws(seed, int(sub_draws),
                                  bool(subsample_warmstart2))
            model = _fit_mf_fused(
                x, y, theta0, bounds_lo, bounds_up, active_mask, draws,
                corr=corr, trend=trend, kpls_dim=kpls_dim,
                n_start=n_start, max_iters=max_iters,
                sub_m=int(subsample_warmstart), polish_iters=polish_iters,
                nugget=nugget, residual=polish_residual,
                grad_probes=grad_probes, polish_tr=polish_tr,
                sub_draws=int(sub_draws),
                sub_m2=int(subsample_warmstart2 or 0),
            )
        else:
            # polish_tr applies to a polish phase only
            in_polish = bool(
                polish_tr and subsample_warmstart and n_start == 0
            )
            model = fit_gp_core(
                x, y, mask, theta0, bounds_lo, bounds_up, active_mask,
                _fit_draws(seed), corr=corr, trend=trend, kpls_dim=kpls_dim,
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
