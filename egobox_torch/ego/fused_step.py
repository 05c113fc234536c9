"""The fused EGO iteration: surrogate fit, scaling cloud and multistart
infill as one program with no host read (port of egobox_tpu/ego/
fused_step.py).

egobox_tpu jits the device side of ``select_next_points`` (ref:
solver_impl.rs:562-807) into one XLA program with one host fetch per
iteration. Here the same body is written so that it reads nothing on the
host: every outer loop has a count fixed by its arguments (optim/lbfgsb.py
``graph_safe``), every random draw of the iteration (the fit's restart
seeds, the scaling cloud, the infill starts, the picker's scores and fill)
is an input, and the m outputs x restarts of the fit are one lockstep stack
(gp/fit.py ``fit_gp_outputs``). On the GPU the solver captures it in a CUDA
graph per signature and replays it (ego/graphs.py, up to its size limit);
on the CPU it runs eagerly.

- ``fused_select_point``: one proposal, packed as [x (nx), -criterion];
- ``fused_select_points_q``: q_points > 1, the virtual-point loop (KB /
  KBLB / KBUB / CLMIN imputation, solver_computations.rs:261-292) that
  appends each virtual row to the padded design and refits, the seeds of
  every step after the first from the picker on the augmented design;
- ``fused_select_point_batch``: B independent problems, one iteration each
  (EgorBatch);
- ``fused_select_point_moe``: the clustered iteration, the experts of
  every output and cluster one stack of masked lanes, the mixture infill
  over the tuple of ``MoeModel``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..gp.fit import fit_gp_core, fit_gp_outputs, output_model
from ..moe.gaussian_mixture import predict_cluster
from ..moe.moe import MoeModel
from .infill_optim import _eval_fcstrs, compute_scaling, optimize_infill
from .start_points import middle_picker_starts_traced
from .surrogates import (predict_valvar_cloud, stack_models,
                         surrogate_valvar_single)

_QEI_CONF = {"KB": 0.0, "KBLB": -3.0, "KBUB": 3.0, "CLMIN": 0.0}


class _GivenSeeds:
    """The fit's restart seeds, drawn before the program runs."""

    def __init__(self, seeds):
        self.seeds = seeds

    def lhs_seeds(self, n_start, dim, dtype, device):
        return self.seeds


def _select_core(
    xp, yp, mask, theta0s, theta_lo, theta_up, fit_seeds, cloud, starts,
    lo, hi, fmin, cstr_tols, fcstr_tols=None, feas_flag=None, *,
    corr, trend, kpls_dim, gp_n_start, gp_max_iters, fixed, nugget, crit,
    cstr_strategy, n_cstr, cstr_infill, feasibility, optimizer, ls_batch,
    fcstr_fns, graph_safe,
):
    """Fit the surrogates, scale over the cloud, run the multistart infill.
    Returns (xk, fk, models). The keyword arguments are the statics of the
    program (egobox_tpu's ``_FUSED_STATICS``; one captured graph per
    combination); ``graph_safe`` says that the body may not read the
    host."""
    dim = theta0s.shape[1]
    active = torch.ones((dim,), dtype=torch.bool, device=xp.device)
    theta0s = torch.clamp(theta0s, theta_lo[None, :], theta_up[None, :])
    fit_kw = dict(corr=corr, trend=trend, n_start=gp_n_start,
                  max_iters=gp_max_iters, fixed=fixed, nugget=nugget,
                  ls_batch=ls_batch, graph_safe=graph_safe)
    if kpls_dim is None:
        models = fit_gp_outputs(xp, yp, mask, theta0s, theta_lo, theta_up,
                                active, fit_seeds, **fit_kw)
    else:
        # KPLS weights depend on each output's data: output by output
        models = stack_models([
            fit_gp_core(xp, yp[:, j:j + 1], mask, theta0s[j], theta_lo,
                        theta_up, active, _GivenSeeds(fit_seeds),
                        kpls_dim=kpls_dim, **fit_kw)
            for j in range(yp.shape[1])])

    xk, fk = _scale_and_infill(
        models, cloud, starts, lo, hi, fmin, cstr_tols, fcstr_tols,
        feas_flag, crit=crit, cstr_strategy=cstr_strategy, n_cstr=n_cstr,
        cstr_infill=cstr_infill, feasibility=feasibility,
        optimizer=optimizer, fcstr_fns=fcstr_fns, graph_safe=graph_safe)
    return xk, fk, models


def _scale_and_infill(models, cloud, starts, lo, hi, fmin, cstr_tols,
                      fcstr_tols, feas_flag, *, crit, cstr_strategy, n_cstr,
                      cstr_infill, feasibility, optimizer, fcstr_fns,
                      graph_safe):
    """The scales over the cloud, then the multistart infill on either
    surrogate container. Returns (xk, fk)."""
    # scaling over the cloud (ref: solver_computations.rs:132-193)
    scale_infill, scale_cstr, scale_wb2 = compute_scaling(
        models, cloud, fmin, cstr_tols,
        crit=crit, n_cstr=n_cstr, cstr_infill=cstr_infill,
    )
    scale_fcstr = None
    if fcstr_fns:
        # max |g| over the cloud (ref: solver_computations.rs:181-189)
        with torch.no_grad():
            gcloud = _eval_fcstrs(fcstr_fns, cloud)
        scale_fcstr = torch.clamp(
            torch.max(torch.abs(gcloud), dim=1).values, min=1e-12)

    xk, fk, _ = optimize_infill(
        models, starts, lo, hi, fmin, scale_infill, scale_wb2, scale_cstr,
        cstr_tols, 1.0, fcstr_tols, scale_fcstr, feas_flag,
        crit=crit, cstr_strategy=cstr_strategy, n_cstr=n_cstr,
        cstr_infill=cstr_infill, feasibility=feasibility,
        optimizer=optimizer, fcstr_fns=fcstr_fns, graph_safe=graph_safe,
    )
    return xk, fk


def _cluster_masks(xp, mask, gmxs, k: int):
    """The rows each expert fits on, (m, k, nb): the active rows of the
    padded design the output's mixture assigns to the cluster, or all the
    active rows for a cluster of fewer than 3 (as ``train_moe_on_clusters``
    falls back). One-hot masks and ``torch.where``: no host read."""
    cl = torch.arange(k, device=xp.device)
    assigns = torch.stack([predict_cluster(g, xp) for g in gmxs])  # (m, nb)
    masks = mask[None, None, :] & (assigns[:, None, :] == cl[None, :, None])
    cnt = torch.sum(masks, dim=2, keepdim=True)
    return torch.where(cnt < 3, mask[None, None, :], masks)


def fused_select_point_moe(
    xp: torch.Tensor,  # (nb, nx) padded DoE
    yp: torch.Tensor,  # (nb, m)
    mask: torch.Tensor,  # (nb,)
    gmxs: tuple,  # one GaussianMixture of k clusters per output
    theta0s: torch.Tensor,  # (m, k, dim) per-expert warm-start inits
    theta_lo: torch.Tensor,
    theta_up: torch.Tensor,
    fit_seeds: Optional[torch.Tensor],  # (gp_n_start, dim) LHS in [0, 1]
    cloud: torch.Tensor,  # (n_cloud, nx) in the box
    starts: torch.Tensor,  # (k_starts, nx)
    lo: torch.Tensor,
    hi: torch.Tensor,
    fmin: torch.Tensor,
    cstr_tols: torch.Tensor,
    fcstr_tols: Optional[torch.Tensor] = None,
    feas_flag: Optional[torch.Tensor] = None,
    *,
    k_clusters: int,
    smooth: bool,
    corr, trend, kpls_dim, gp_n_start, gp_max_iters, fixed, nugget, crit,
    cstr_strategy, n_cstr, cstr_infill, feasibility, optimizer, ls_batch,
    fcstr_fns, graph_safe,
):
    """The clustered EGO iteration in one program (egobox_tpu's
    ``fused_select_point_moe``; ref: make_clustered_surrogate,
    solver_impl.rs:121-296). Given the standing clustering (``gmxs``, made
    on the host path), every step of the iteration runs on the device:

    - the padded rows assigned to clusters, and a cluster of fewer than 3
      active rows widened to every active row (``_cluster_masks``);
    - the m x k experts fitted as one lockstep stack of masked lanes, every
      lane with the same restart seeds (egobox_tpu: one key);
    - the scaling cloud and the multistart infill over the tuple of
      ``MoeModel``.

    One regression and one correlation model, one k for every output. As
    in egobox_tpu the GMM and the heaviside factor stay as they are between
    reclusterings (the reference searches the factor again at every
    smooth retrain).

    Returns (packed [x (nx), -criterion], the tuple of MoeModel,
    theta_last (m, k, dim))."""
    nb, nx = xp.shape
    m = yp.shape[1]
    k = k_clusters
    dim = theta0s.shape[2]
    p = m * k
    active = torch.ones((dim,), dtype=torch.bool, device=xp.device)
    theta0s = torch.clamp(theta0s, theta_lo, theta_up)
    masks = _cluster_masks(xp, mask, gmxs, k).reshape(p, nb)
    ys = yp.T[:, None, :].expand(m, k, nb).reshape(p, nb, 1)
    fit_kw = dict(corr=corr, trend=trend, n_start=gp_n_start,
                  max_iters=gp_max_iters, fixed=fixed, nugget=nugget,
                  ls_batch=ls_batch, graph_safe=graph_safe)
    if kpls_dim is None:
        experts = fit_gp_outputs(
            xp.expand(p, nb, nx), ys, masks, theta0s.reshape(p, 1, dim),
            theta_lo, theta_up, active,
            None if fit_seeds is None else fit_seeds.expand(
                (p,) + fit_seeds.shape), **fit_kw)
    else:
        # KPLS weights depend on each lane's rows: lane by lane
        experts = stack_models([
            fit_gp_core(xp, ys[i], masks[i], theta0s.reshape(p, dim)[i],
                        theta_lo, theta_up, active, _GivenSeeds(fit_seeds),
                        kpls_dim=kpls_dim, **fit_kw)
            for i in range(p)])
    models = tuple(
        MoeModel(experts=tuple(output_model(experts, j * k + c)
                               for c in range(k)),
                 gmx=gmxs[j], smooth=smooth)
        for j in range(m))
    xk, fk = _scale_and_infill(
        models, cloud, starts, lo, hi, fmin, cstr_tols, fcstr_tols,
        feas_flag, crit=crit, cstr_strategy=cstr_strategy, n_cstr=n_cstr,
        cstr_infill=cstr_infill, feasibility=feasibility,
        optimizer=optimizer, fcstr_fns=fcstr_fns, graph_safe=graph_safe)
    packed = torch.cat([xk, fk[None].to(xp.dtype)])
    return packed, models, experts.theta.reshape(m, k, dim)


def fused_select_point(
    xp: torch.Tensor,  # (nb, nx) padded DoE
    yp: torch.Tensor,  # (nb, m) padded outputs (objective + constraints)
    mask: torch.Tensor,  # (nb,) active rows
    theta0s: torch.Tensor,  # (m, dim) warm-start inits
    theta_lo: torch.Tensor,  # (dim,)
    theta_up: torch.Tensor,  # (dim,)
    fit_seeds: Optional[torch.Tensor],  # (gp_n_start, dim) LHS in [0, 1]
    cloud: torch.Tensor,  # (n_cloud, nx) maximin LHS in the box
    starts: torch.Tensor,  # (k, nx) infill multistart seeds
    lo: torch.Tensor,  # (nx,) optimization box
    hi: torch.Tensor,
    fmin: torch.Tensor,  # 0-d: current best objective
    cstr_tols: torch.Tensor,  # (n_cstr,)
    fcstr_tols: Optional[torch.Tensor] = None,  # (n_fcstr,)
    feas_flag: Optional[torch.Tensor] = None,  # 0-d bool
    **statics,
):
    """One fused iteration. Returns (packed, models): ``packed = [x_next
    (nx), -infill_value]``, the one tensor the host fetches; ``models`` the
    stacked surrogates (they stay on the device as the next warm start).

    The draws egobox_tpu makes in-program from ``fit_key`` and
    ``cloud_key`` are the inputs ``fit_seeds`` (``maximin_lhs(fit_key,
    gp_n_start, dim)``) and ``cloud`` (``lhs_normalized(cloud_key, n_cloud,
    nx, MAXIMIN)`` scaled into [lo, hi])."""
    xk, fk, models = _select_core(
        xp, yp, mask, theta0s, theta_lo, theta_up, fit_seeds, cloud, starts,
        lo, hi, fmin, cstr_tols, fcstr_tols, feas_flag, **statics)
    packed = torch.cat([xk, fk[None].to(xp.dtype)])
    return packed, models


def _virtual_row(models, xk, y_best_row, qei: str):
    """The imputed outputs of a proposal (compute_virtual_point)."""
    if qei == "CLMIN":
        return y_best_row
    with torch.no_grad():
        means, vrs = surrogate_valvar_single(models, xk)
    obj = means[0] + _QEI_CONF[qei] * torch.sqrt(torch.clamp(vrs[0], min=0.0))
    return torch.cat([obj[None], means[1:]])


def _append_row(xb, yb, mb, xk, yk, ok=None):
    """Write (xk, yk) into the first inactive row of the padded buffers
    (the active rows are a prefix), where ``ok``; no host read."""
    idx = torch.sum(mb.to(torch.int64))
    hot = torch.arange(mb.shape[0], device=mb.device) == idx
    if ok is not None:
        hot = hot & ok
    xb = torch.where(hot[:, None], xk[None, :].to(xb.dtype), xb)
    yb = torch.where(hot[:, None], yk[None, :].to(yb.dtype), yb)
    return xb, yb, mb | hot, hot


def fused_select_points_q(
    xp: torch.Tensor,  # (nb, nx) padded DoE
    yp: torch.Tensor,  # (nb, m)
    mask: torch.Tensor,  # (nb,)
    theta0s: torch.Tensor,  # (m, dim)
    theta_lo: torch.Tensor,
    theta_up: torch.Tensor,
    fit_seeds: Optional[torch.Tensor],  # (q, gp_n_start, dim)
    clouds: torch.Tensor,  # (q, n_cloud, nx), in the box
    starts0: torch.Tensor,  # (k, nx): step 0's seeds (the host picker)
    pick_scores: torch.Tensor,  # (q, nb + q - 1) uniform draws
    pick_fills: torch.Tensor,  # (q, k, nx) maximin LHS in [0, 1]
    lo: torch.Tensor,
    hi: torch.Tensor,
    fmin: torch.Tensor,
    cstr_tols: torch.Tensor,
    y_best_row: torch.Tensor,  # (m,) current best output row (CLMIN liar)
    fcstr_tols: Optional[torch.Tensor] = None,
    seed_lo: Optional[torch.Tensor] = None,  # (nx,) seed box; None = box
    seed_hi: Optional[torch.Tensor] = None,
    *,
    q_points: int,
    qei: str,  # KB | KBLB | KBUB | CLMIN
    use_middle: bool = True,
    **statics,
):
    """q-point batch proposal in one program (egobox_tpu's
    ``fused_select_points_q``): step j fits on the design augmented with
    the j virtual rows, optimizes the criterion and imputes the proposal's
    outputs with ``qei``; fmin stays fixed across the steps.

    Step 0 takes ``starts0``; step j >= 1 draws its seeds from the
    augmented design with the traceable picker (its scores and fill are
    row j of ``pick_scores`` / ``pick_fills``), or, with
    ``use_middle=False`` (TREGO local steps, the kill-switch), takes row j
    of ``pick_fills`` scaled into the seed box. Row j of ``fit_seeds`` and
    ``clouds`` are step j's (egobox_tpu folds j into its keys).

    Returns (packed (q, nx + 1 + m), theta_last (m, dim)): row j is [x_j,
    f_j, y_virtual_j]."""
    dtype = xp.dtype
    nx = xp.shape[1]
    m = yp.shape[1]
    q = q_points
    n_start_k = starts0.shape[0]
    if seed_lo is None:
        seed_lo, seed_hi = lo, hi
    # q - 1 extra rows for the virtual points (the padded buffer may be
    # full at a bucket boundary)
    xb = torch.cat([xp, torch.zeros((q - 1, nx), dtype=dtype,
                                    device=xp.device)])
    yb = torch.cat([yp, torch.zeros((q - 1, m), dtype=dtype,
                                    device=xp.device)])
    mb = torch.cat([mask, torch.zeros((q - 1,), dtype=torch.bool,
                                      device=xp.device)])
    n_sub_max = max(xb.shape[0] // 10, 2)
    th = theta0s
    rows = []
    for j in range(q):
        if j == 0:
            starts = starts0
        else:
            if use_middle:
                starts = middle_picker_starts_traced(
                    xb, mb, seed_lo, seed_hi, n_start_k, n_sub_max,
                    pick_scores[j], pick_fills[j])
            else:
                starts = (seed_lo[None, :]
                          + pick_fills[j] * (seed_hi - seed_lo)[None, :])
            starts = torch.clamp(starts, lo[None, :], hi[None, :])
        xk, fk, models = _select_core(
            xb, yb, mb, th, theta_lo, theta_up,
            None if fit_seeds is None else fit_seeds[j], clouds[j], starts,
            lo, hi, fmin, cstr_tols, fcstr_tols, **statics)
        yk = _virtual_row(models, xk, y_best_row, qei)
        xb, yb, mb, _ = _append_row(xb, yb, mb, xk, yk)
        th = models.theta
        rows.append(torch.cat([xk, fk[None].to(dtype), yk.to(dtype)]))
    return torch.stack(rows), th


def _problem_valvar(models, x, n_prob: int):
    """The posterior of lanes grouped by problem: ``models`` stacks the
    P x m outputs problem after problem, ``x`` (P k, [T,] nx) the lanes
    problem after problem. Returns (means, variances), each (m, P k[, T]),
    every lane evaluated on its own problem's surrogates."""
    m = models.x_norm.shape[0] // n_prob
    lead = x.shape[:-1]
    nx = x.shape[-1]
    xs = x.reshape(n_prob, -1, nx)
    xo = xs[:, None].expand((n_prob, m) + xs.shape[1:]).reshape(
        (n_prob * m,) + xs.shape[1:])
    means, vrs = predict_valvar_cloud(models, xo)  # (P m, k T)

    def back(v):
        return v.reshape(n_prob, m, -1).transpose(0, 1).reshape((m,) + lead)

    return back(means), back(vrs)


def _rows(models, start: int, stop: int):
    """The outputs [start, stop) of a stacked container."""
    return dataclasses.replace(models, **{
        f.name: getattr(models, f.name)[start:stop]
        for f in dataclasses.fields(models)
        if isinstance(getattr(models, f.name), torch.Tensor)})


def fused_select_point_batch(
    xp, yp, mask, theta0s, theta_lo, theta_up, fit_seeds, clouds, starts,
    lo, hi, fmin, cstr_tols, feas_flags=None, **statics,
):
    """``fused_select_point`` over a leading problem axis: B independent
    EGO iterations in one program (egobox_tpu vmaps the single-problem
    program). The B x m x restarts of the fits are one lockstep stack and
    the B x k infill starts one set of lanes, each on its own problem's
    surrogates, so the program has the launches of one problem. Batched:
    xp (B, nb, nx), yp (B, nb, m), mask (B, nb), theta0s (B, m, dim),
    fit_seeds (B, gp_n_start, dim), clouds (B, n_cloud, nx) in each box,
    starts (B, k, nx), lo / hi (B, nx), fmin (B,), optional feas_flags
    (B,). Shared: theta bounds, cstr_tols. Identity KPLS weights, no
    function constraints.

    Returns (packed (B, nx + 1), theta (B, m, dim))."""
    n_prob, _, nx = xp.shape
    m = yp.shape[2]
    k = starts.shape[1]
    dim = theta0s.shape[2]
    active = torch.ones((dim,), dtype=torch.bool, device=xp.device)
    theta0s = torch.clamp(theta0s, theta_lo, theta_up)
    models = fit_gp_outputs(
        xp, yp, mask, theta0s, theta_lo, theta_up, active, fit_seeds,
        corr=statics["corr"], trend=statics["trend"],
        n_start=statics["gp_n_start"], max_iters=statics["gp_max_iters"],
        fixed=statics["fixed"], nugget=statics["nugget"],
        ls_batch=statics["ls_batch"], graph_safe=statics["graph_safe"])
    scales = [
        compute_scaling(_rows(models, b * m, (b + 1) * m), clouds[b], fmin[b],
                        cstr_tols, crit=statics["crit"],
                        n_cstr=statics["n_cstr"],
                        cstr_infill=statics["cstr_infill"])
        for b in range(n_prob)]

    def lanes(v):
        """One value per problem (last axis) -> one per lane."""
        return v[..., :, None].expand(v.shape + (k,)).reshape(
            v.shape[:-1] + (n_prob * k,))

    scale_infill = lanes(torch.stack([sc[0] for sc in scales]))
    scale_cstr = lanes(torch.stack([sc[1] for sc in scales], dim=1))
    scale_wb2 = lanes(torch.stack([sc[2] for sc in scales]))
    xk, fk, _ = optimize_infill(
        models, starts.reshape(n_prob * k, nx),
        lanes(lo.T).T, lanes(hi.T).T, lanes(fmin), scale_infill, scale_wb2,
        scale_cstr, cstr_tols, 1.0, None, None,
        None if feas_flags is None else lanes(feas_flags),
        crit=statics["crit"], cstr_strategy=statics["cstr_strategy"],
        n_cstr=statics["n_cstr"], cstr_infill=statics["cstr_infill"],
        feasibility=statics["feasibility"], optimizer=statics["optimizer"],
        graph_safe=statics["graph_safe"],
        valvar=lambda mo, x: _problem_valvar(mo, x, n_prob),
        problems=n_prob,
    )
    packed = torch.cat([xk, fk[:, None].to(xp.dtype)], dim=1)
    return packed, models.theta.reshape(n_prob, m, dim)
