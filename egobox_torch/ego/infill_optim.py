"""Infill-criterion optimization: one multistart over lockstep lanes
(port of egobox_tpu/ego/infill_optim.py).

Replacement for crates/ego/src/solver/solver_infill_optim.rs: the reference
fans n_start SLSQP/COBYLA local solves over threads, egobox_tpu runs every
start under ``vmap``; here every start is one lane of the lockstep bounded
L-BFGS (optim/lbfgsb.py), and one evaluation of the objective takes the
surrogate posterior of all outputs at all lanes x line-search trials in one
set of launches.

Constraint semantics follow solver_computations.rs:196-257: surrogate
constraints enter either as hard optimizer constraints on the scaled mean
(MC) or mean + 3 sigma (UTB, CSTR_DOUBT=3), or, with cstr_infill, folded
into the criterion as (log-)probability of feasibility
(solver_computations.rs:398-475).

Shapes: a batch of points is ``x (..., nx)``; the posterior is
``(m, ...)`` with the output axis first; per-constraint quantities keep the
constraint axis first, ``(n_hard, ...)``, and per-lane multipliers are
``(n_hard, k)``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..optim.lbfgsb import minimize_lbfgsb
from .criteria import ei, log_ei, log_pof, pof, wb2, wb2s_scale
from .surrogates import surrogate_valvar_cloud, surrogate_valvar_single

CSTR_DOUBT = 3.0

#: speculative line-search width of the infill L-BFGS: the trial steps of
#: all lanes are one batched posterior evaluation (optim/lbfgsb.py ls_batch)
LS_BATCH = 8

#: constrained-infill iteration budget: ``n_outer`` augmented-Lagrangian
#: rounds x ``inner_iters`` L-BFGS iterations each (the unconstrained path
#: always runs ``2 * inner_iters``)
INFILL_INNER_ITERS = 40
INFILL_N_OUTER = 4


def _criterion(crit: str, mean, var, fmin, scale_wb2, sigma_weight=1.0):
    if crit == "EI":
        return ei(mean, var, fmin, sigma_weight)
    if crit == "LogEI":
        return log_ei(mean, var, fmin, sigma_weight)
    if crit == "WB2":
        return wb2(mean, var, fmin, 1.0, sigma_weight)
    if crit == "WB2S":
        return wb2(mean, var, fmin, scale_wb2, sigma_weight)
    raise ValueError(f"unknown infill criterion: {crit}")


def _col(v, like: torch.Tensor) -> torch.Tensor:
    """A per-constraint vector (c,) shaped (c, 1, ...) to broadcast against
    ``like`` (c, ...)."""
    v = torch.as_tensor(v, dtype=like.dtype, device=like.device)
    return v.reshape(v.shape + (1,) * (like.ndim - 1))


def _infill_obj_terms(crit, means, vrs, fmin, scale_infill, scale_wb2,
                      cstr_tols, cstr_infill, sigma_weight=1.0,
                      feasibility=True, feas_flag=None):
    """Negative (scaled) criterion, optionally folded with PoF
    (ref: eval_infill_obj_with_cstrs, solver_computations.rs:398-475), for
    a posterior ``means``/``vrs`` of shape (m, ...) -> (...).

    ``feasibility=False`` (no feasible point found yet, env flag
    EGOR_USE_MAX_PROBA_OF_FEASIBILITY) neutralizes the criterion so the
    optimizer maximizes the probability of feasibility instead
    (solver_computations.rs:409-417).

    ``feas_flag`` (bool tensor scalar) is the runtime version of the same
    switch: both branches are computed and selected with ``torch.where``.
    Requires feasibility=True."""
    neutral = 0.0 if crit == "LogEI" else -1.0
    has_cstr = means.shape[0] > 1
    if has_cstr:
        tols = _col(cstr_tols, means[1:])
    if feas_flag is not None:
        c = _criterion(crit, means[0], vrs[0], fmin, scale_wb2,
                       sigma_weight)
        obj_f = -c / scale_infill
        obj_i = torch.full_like(obj_f, neutral)
        if has_cstr:
            if crit == "LogEI":
                pofs = torch.sum(log_pof(means[1:], vrs[1:], tols), dim=0)
                if cstr_infill:
                    obj_f = obj_f - pofs
                obj_i = obj_i - pofs
            else:
                pofs = torch.prod(pof(means[1:], vrs[1:], tols), dim=0)
                if cstr_infill:
                    obj_f = obj_f * pofs
                obj_i = obj_i * pofs
        return torch.where(feas_flag, obj_f, obj_i)
    fold = (cstr_infill or not feasibility) and has_cstr
    if feasibility:
        c = _criterion(crit, means[0], vrs[0], fmin, scale_wb2,
                       sigma_weight)
        obj = -c / scale_infill
    else:
        obj = torch.full_like(means[0], neutral)
    if fold:
        if crit == "LogEI":
            obj = obj - torch.sum(log_pof(means[1:], vrs[1:], tols), dim=0)
        else:
            obj = obj * torch.prod(pof(means[1:], vrs[1:], tols), dim=0)
    return obj


def _eval_fcstrs(fcstr_fns, x: torch.Tensor) -> torch.Tensor:
    """User function constraints at a batch of points x (..., nx) ->
    (n_fcstr, ...). Each function maps one (nx,) tensor to one value; it is
    mapped over the flattened batch with ``torch.vmap``."""
    lead = x.shape[:-1]
    flat = x.reshape(-1, x.shape[-1])
    rows = []
    for fn in fcstr_fns:
        g = torch.vmap(lambda xi: torch.as_tensor(
            fn(xi), dtype=x.dtype, device=x.device).reshape(()))(flat)
        rows.append(g.reshape(lead))
    return torch.stack(rows)


def optimize_infill(
    models,  # stacked GpModel, leading axis 1 + n_cstr
    starts: torch.Tensor,  # (k, nx)
    lo: torch.Tensor,
    hi: torch.Tensor,
    fmin,
    scale_infill,
    scale_wb2,
    scale_cstr,  # (n_cstr,)
    cstr_tols,  # (n_cstr,)
    sigma_weight=1.0,
    fcstr_tols=None,  # (n_fcstr,) tolerances of the fcstr_fns
    scale_fcstr=None,  # (n_fcstr,) cloud-derived scales
    feas_flag=None,  # bool tensor scalar: runtime feasibility switch
    *,
    crit: str = "LogEI",
    cstr_strategy: str = "MC",
    n_cstr: int = 0,
    cstr_infill: bool = False,
    inner_iters: int = INFILL_INNER_ITERS,
    n_outer: int = INFILL_N_OUTER,
    feasibility: bool = True,
    optimizer: str = "COBYLA",
    fcstr_fns: tuple = (),
    graph_safe: bool = False,
    valvar=surrogate_valvar_single,
    problems: Optional[int] = None,
):
    """Returns (x_best (nx,), infill_obj_best, per-start (xs, fs, vs)).

    ``optimizer`` selects the constrained local method, mirroring the
    reference's InfillOptimizer enum (optimizers/optimizer.rs:12-224):

    - "COBYLA": augmented-Lagrangian L-BFGS (multiplier estimates across
      n_outer rounds), the role of the reference's default derivative-free
      trust-region method;
    - "SLSQP": smoothed-L1 exact-penalty L-BFGS with a penalty
      continuation at the same total iteration budget, the gradient-based
      SQP role (the constraints arrive pre-scaled to O(1)).

    Every start is one lockstep lane; the rounds carry ``(x, lam, mu)`` per
    lane. Unconstrained problems share one plain bounded L-BFGS path.

    ``fcstr_fns``: user function constraints g(x) <= fcstr_tol written in
    torch operations (one (nx,) tensor in, one value out), entering every
    local solve as hard constraints: the equivalent of the reference's
    CstrFn threading through COBYLA/SLSQP (optimizers/optimizer.rs:122-223,
    solver_impl.rs:716-741). ``fcstr_tols`` is accepted for signature
    parity: the optimizer targets g <= 0 unshifted, the tolerance is the
    acceptance slack of the feasibility checks.

    ``feas_flag`` (bool tensor scalar): when False the criterion is
    neutralized (maximize PoF) and the surrogate hard constraints are
    deactivated, matching the static feasibility=False structure. Requires
    feasibility=True.

    ``graph_safe``: every local solve in the L-BFGS form without host reads
    (fixed trip counts, optim/lbfgsb.py); the rounds and the penalty
    continuation are fixed counts already, so the whole multistart then
    reads nothing on the host and can be captured in a CUDA graph.

    ``problems`` (an int): the starts are ``problems`` groups of equal size,
    problem after problem, each lane on its own problem's surrogates
    (``valvar(models, x)`` maps the lanes to their posterior, output axis
    first); ``fmin``, ``scale_infill``, ``scale_wb2`` and ``feas_flag`` are
    then one value per lane (k,), ``scale_cstr`` (n_cstr, k), ``lo`` / ``hi``
    (k, nx), and the result is one best x (problems, nx) and value
    (problems,) per problem (EgorBatch, ego/fused_step.py).
    """
    n_fcstr = len(fcstr_fns)
    if feas_flag is not None and not feasibility:
        raise ValueError(
            "feas_flag requires the static feasibility=True structure"
        )
    starts = starts.detach()
    k = starts.shape[0]
    dtype, device = starts.dtype, starts.device

    surr_hard = (n_cstr > 0) and not cstr_infill and feasibility
    hard_cstr = surr_hard or n_fcstr > 0

    def per_lane(v, x):
        """A per-lane parameter (k,) against the batch x (see ``lanes``);
        anything else as it is."""
        if problems is not None and isinstance(v, torch.Tensor):
            return lanes(v, x)
        return v

    def obj_and_viol(x):
        """(criterion (...), scaled violations (n_hard, ...)) from one
        posterior evaluation at x (..., nx).

        The optimizer targets g <= 0 unshifted; cstr_tol is the acceptance
        slack applied at feasibility checks, not a boundary shift (ref:
        optimizers/optimizer.rs:108 passes cstr_tol/scale to nlopt as the
        allowed violation on fc(x) <= 0)."""
        means, vrs = valvar(models, x)
        flag = per_lane(feas_flag, x)
        f = _infill_obj_terms(
            crit, means, vrs, per_lane(fmin, x), per_lane(scale_infill, x),
            per_lane(scale_wb2, x), cstr_tols, cstr_infill, sigma_weight,
            feasibility, flag,
        )
        parts = []
        if surr_hard:
            g = means[1:]
            if cstr_strategy == "UTB":
                g = g + CSTR_DOUBT * torch.sqrt(torch.clamp(vrs[1:], min=0.0))
            if problems is not None:
                gs = g / (scale_cstr[..., None] if x.ndim == 3
                          else scale_cstr)
            else:
                gs = g / _col(scale_cstr, g)
            if feas_flag is not None:
                gs = torch.where(flag, gs, -torch.ones_like(gs))
            parts.append(gs)
        if n_fcstr:
            gfc = _eval_fcstrs(fcstr_fns, x)
            parts.append(gfc / _col(scale_fcstr, gfc))
        if parts:
            v = torch.cat(parts, dim=0)
        else:
            v = torch.zeros((0,) + x.shape[:-1], dtype=dtype, device=device)
        return f, v

    def lanes(p, x):
        """A per-lane tensor (..., k) against the batch x: the line search
        hands in (k, ls_batch, nx), everything else (k, nx)."""
        return p[..., None] if x.ndim == 3 else p

    if not hard_cstr:
        res = minimize_lbfgsb(
            lambda x: obj_and_viol(x)[0], starts, lo, hi,
            max_iters=inner_iters * 2, ls_batch=LS_BATCH,
            graph_safe=graph_safe,
        )
        xs, fs = res.x, res.fun
        vs = torch.zeros((k,), dtype=dtype, device=device)
        return _pick_best(xs, fs, vs, problems)

    n_hard = (n_cstr if surr_hard else 0) + n_fcstr
    x = starts
    if optimizer == "SLSQP":
        eps = 1e-8
        # penalty continuation (multiplier-free, distinct from the AL path)
        for mu in (10.0, 100.0, 1000.0):

            def penalized(xx, mu=mu):
                f, g = obj_and_viol(xx)
                h = torch.clamp(g, min=0.0)
                # smoothed L1 hinge: exact-penalty behavior with a
                # differentiable kink for a sane L-BFGS line search
                return f + mu * torch.sum(
                    torch.sqrt(h * h + eps * eps) - eps, dim=0)

            x = minimize_lbfgsb(
                penalized, x, lo, hi,
                max_iters=inner_iters * n_outer // 3, ls_batch=LS_BATCH,
                graph_safe=graph_safe,
            ).x
    else:
        lam = torch.zeros((n_hard, k), dtype=dtype, device=device)
        mu = 10.0
        for _ in range(n_outer):

            def penalized(xx, lam=lam, mu=mu):
                f, g = obj_and_viol(xx)
                return f + torch.sum(
                    0.5 * mu * torch.clamp(g + lanes(lam, xx) / mu,
                                           min=0.0) ** 2, dim=0)

            x = minimize_lbfgsb(
                penalized, x, lo, hi, max_iters=inner_iters,
                ls_batch=LS_BATCH, graph_safe=graph_safe,
            ).x
            with torch.no_grad():
                _, g = obj_and_viol(x)
            lam = torch.clamp(lam + mu * g, min=0.0)
            mu = mu * 5.0
    with torch.no_grad():
        fs, g = obj_and_viol(x)
    vs = torch.sum(torch.clamp(g, min=0.0), dim=0)
    return _pick_best(x, fs, vs, problems)


def _pick_best(xs, fs, vs, problems=None):
    """Best feasible start, else least-violating (shared by both
    constrained optimizers), per problem when the starts are ``problems``
    groups."""
    fs = torch.where(torch.isfinite(fs), fs, torch.full_like(fs, torch.inf))
    if problems is not None:
        xp = xs.reshape(problems, -1, xs.shape[-1])
        fp, vp = fs.reshape(problems, -1), vs.reshape(problems, -1)
        feas = vp <= 1e-6
        score = torch.where(feas, fp, torch.full_like(fp, torch.inf))
        best = torch.where(feas.any(dim=1), torch.argmin(score, dim=1),
                           torch.argmin(vp, dim=1))
        rows = torch.arange(problems, device=xs.device)
        return xp[rows, best], fp[rows, best], (xs, fs, vs)
    feas = vs <= 1e-6
    score = torch.where(feas, fs, torch.full_like(fs, torch.inf))
    best = torch.where(feas.any(), torch.argmin(score),
                       torch.argmin(vs)).reshape(1)
    # index_select: indexing with a 0-d tensor may read it on the host
    return (xs.index_select(0, best)[0], fs.index_select(0, best)[0],
            (xs, fs, vs))


@torch.no_grad()
def compute_scaling(
    models,
    cloud: torch.Tensor,  # (p, nx)
    fmin,
    cstr_tols,
    sigma_weight=1.0,
    *,
    crit: str = "LogEI",
    n_cstr: int = 0,
    cstr_infill: bool = False,
):
    """Scaling factors over an LHS cloud
    (ref: compute_scaling, solver_computations.rs:132-193).
    Returns (scale_infill_obj, scale_cstr (n_cstr,), scale_wb2)."""
    dtype, device = cloud.dtype, cloud.device
    means, vrs = surrogate_valvar_cloud(models, cloud)  # (m, p)

    if crit == "WB2S":
        scale_wb2 = wb2s_scale(means[0], vrs[0], fmin, sigma_weight)
    else:
        scale_wb2 = torch.ones((), dtype=dtype, device=device)

    # infill objective sign (minimized)
    crit_vals = -_criterion(crit, means[0], vrs[0], fmin, scale_wb2,
                            sigma_weight)
    if cstr_infill and n_cstr > 0:
        tols = _col(cstr_tols, means[1:])
        if crit == "LogEI":
            crit_vals = crit_vals - torch.sum(
                log_pof(means[1:], vrs[1:], tols), dim=0)
        else:
            crit_vals = crit_vals * torch.prod(
                pof(means[1:], vrs[1:], tols), dim=0)

    vals = torch.where(torch.isfinite(crit_vals), torch.abs(crit_vals),
                       torch.ones_like(crit_vals))
    scale = torch.max(vals)
    eps100 = 100.0 * torch.finfo(dtype).eps
    scale_infill = torch.where(scale < eps100, torch.ones_like(scale), scale)

    if n_cstr > 0:
        cm = torch.where(torch.isfinite(means[1:]), torch.abs(means[1:]),
                         torch.zeros_like(means[1:]))
        scale_cstr = torch.clamp(torch.max(cm, dim=1).values, min=eps100)
    else:
        scale_cstr = torch.zeros((0,), dtype=dtype, device=device)
    return scale_infill, scale_cstr, scale_wb2


@torch.no_grad()
def virtual_point(models, xk, y_best_row, *, strategy: str = "KB"):
    """qEI virtual outputs at xk (ref: compute_virtual_point,
    solver_computations.rs:261-292). Returns a (1 + n_cstr,) row."""
    means, vrs = surrogate_valvar_single(models, xk)
    if strategy == "CLMIN":
        return y_best_row
    conf = {"KB": 0.0, "KBLB": -3.0, "KBUB": 3.0}[strategy]
    obj = means[0] + conf * torch.sqrt(torch.clamp(vrs[0], min=0.0))
    return torch.cat([obj[None], means[1:]])


@torch.no_grad()
def eval_infill_and_cstrs(
    models, x, fmin, scale_infill, scale_wb2, cstr_tols,
    *, crit: str = "LogEI", cstr_infill: bool = False,
    feasibility: bool = True,
):
    """Single-point infill objective + raw constraint means (the probe of
    a host-side polish that folds user function constraints in)."""
    means, vrs = surrogate_valvar_single(models, x)
    obj = _infill_obj_terms(
        crit, means, vrs, fmin, scale_infill, scale_wb2, cstr_tols,
        cstr_infill, 1.0, feasibility,
    )
    return obj, means[1:]
