"""The traced whole run: EGO iterations with the objective evaluated on the
device, one host fetch per chunk (port of egobox_tpu/ego/fused_run.py).

When the user's objective is written in torch operations, nothing forces a
host visit per iteration: one step draws its multistart seeds from the
current design with the traceable picker, fits the surrogates, optimizes
the infill criterion, evaluates the objective, imputes non-finite values,
applies the L1 de-dup / retry rule and appends to the padded buffers, all
on the device. ``run_traced`` runs chunks of such steps; the host fetches
each chunk's rows once and replays the appends into its numpy state. On
the GPU a step is a CUDA graph captured once per signature (bucket size,
whether the step refits its thetas, the statics) and replayed k times per
chunk (ego/graphs.py); the carried state (buffers, thetas, retry counter,
TREGO scheduler) lives in device tensors between steps and chunks.

Divergences from the host loop, as in egobox_tpu (all opt-in through
``Egor(traced_run=True)``): the seeds come from the traceable picker; a
duplicate proposal skips the append and the next step retries with fresh
draws, and ``MAX_POINT_ADDITION_RETRY`` consecutive duplicates freeze the
run; the de-dup threshold is 100 eps of the compute type; per-iteration
observers and recorders are not written (Egor takes the host loop when
they are asked for); q_points > 1 evaluates all q proposals on the device,
each de-duplicated against the live buffer.

Every draw of a chunk (fit seeds, clouds, the picker's scores and fill,
TREGO's local fill) is made on the host before the chunk runs.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..config import egor_dtype
from .config import MAX_POINT_ADDITION_RETRY as MAX_RETRIES
from .fused_step import _append_row, _select_core, _virtual_row
from .start_points import middle_picker_starts_traced


def _row(buf, i):
    """Row ``i`` (a 0-d device tensor) of ``buf``, read on the device."""
    return buf.index_select(0, i.reshape(1))[0]


def _violations(yb, cb, mask, all_tols, n_cstr):
    """Objective and violation sum per row, +inf on inactive rows; None
    for the violations when there is no constraint."""
    inf = torch.full_like(yb[:, 0], torch.inf)
    obj = torch.where(mask, yb[:, 0], inf)
    c = torch.cat([yb[:, 1:1 + n_cstr], cb], dim=1)
    if c.shape[1] == 0:
        return obj, None
    over = torch.clamp(c - all_tols[None, :], min=0.0)
    return obj, torch.where(mask, torch.sum(over, dim=1), inf)


def _best_x(xbuf, ybuf, cbuf, mask, all_tols, n_cstr):
    """x of the (min violation sum, then min objective) row: the TREGO
    trust region's center (find_result.find_best_result_index's order)."""
    obj, viol = _violations(ybuf, cbuf, mask, all_tols, n_cstr)
    if viol is not None:
        obj = torch.where(viol == torch.min(viol), obj,
                          torch.full_like(obj, torch.inf))
    return _row(xbuf, torch.argmin(obj))


def _best_fmin(ybuf, cbuf, mask, all_tols, n_cstr):
    """fmin under the constraint-tolerance order (find_result.rs:76-142),
    and whether any active row is feasible."""
    obj, viol = _violations(ybuf, cbuf, mask, all_tols, n_cstr)
    if viol is None:
        return torch.min(obj), torch.any(mask)
    inf = torch.full_like(obj, torch.inf)
    vmin = torch.min(viol)
    fmin = torch.min(torch.where(viol == vmin, obj, inf))
    return fmin, torch.any(mask & (viol == 0.0))


def _best_row(ybuf, mask):
    """The row of the least objective among the active rows: the CLMIN
    liar (the unconstrained argmin, as the reference imputes it)."""
    obj = torch.where(mask, ybuf[:, 0], torch.full_like(ybuf[:, 0],
                                                         torch.inf))
    return _row(ybuf, torch.argmin(obj))


def _impute_row(yk, ybuf, mask):
    """Non-finite entries of a new row become the column's worst active
    value + 3 sigma (solver.impute_failed_values on the device)."""
    m = mask.to(ybuf.dtype)[:, None]
    cnt = torch.clamp(torch.sum(m, dim=0), min=1.0)
    mean = torch.sum(ybuf * m, dim=0) / cnt
    var = torch.sum((ybuf - mean[None, :]) ** 2 * m, dim=0) / cnt
    colmax = torch.max(torch.where(mask[:, None], ybuf,
                                   torch.full_like(ybuf, -torch.inf)),
                       dim=0).values
    penalty = colmax + 3.0 * torch.clamp(torch.sqrt(var), min=1.0)
    return torch.where(torch.isfinite(yk), yk, penalty)


def traced_step(
    xb, yb, cb, mb, theta, retries, done, sigma, in_local, prev_fmin, it,
    fit_seeds, clouds, pick_scores, pick_fills, local_fills,
    theta_lo, theta_up, lo, hi, cstr_tols, fcstr_tols, target, t_gamma,
    t_beta, t_d0, t_d1, *, fobj, n_start, use_middle, use_feasibility_first,
    n_cstr, q_points, qei, trego, n_local_steps, fcstr_fns, **statics,
):
    """One EGO iteration of the traced run (the body of egobox_tpu's
    ``fused_run_chunk`` scan). The carry (``xb`` ... ``prev_fmin``) comes in
    as tensors and goes out as the first element of the result; ``it`` is
    the global iteration index (0-d), the draws carry a leading axis over
    the q virtual steps. Returns (carry, rows (q, nx + m + n_fcstr + 2)):
    each row is [x, y, c, appended, done]."""
    dtype = xb.dtype
    nb, nx = xb.shape
    m = yb.shape[1]
    q = q_points
    n_sub_max = max(nb // 10, 2)
    dedup_tol = 100.0 * torch.finfo(dtype).eps
    all_tols = torch.cat([cstr_tols, fcstr_tols])
    fmin, feas = _best_fmin(yb, cb, mb, all_tols, n_cstr)
    feas_flag = feas if use_feasibility_first else None
    y_best = _best_row(yb, mb)
    if trego:
        # the scheduler (trego.py trego_step): the success test against the
        # best before the previous iteration's append
        last_success = fmin < prev_fmin - sigma**2
        prev_step_ego = ~in_local
        sigma = torch.where(
            it == 0, sigma,
            torch.where(~prev_step_ego,
                        torch.where(last_success, sigma * t_gamma,
                                    sigma * t_beta),
                        torch.where(last_success, sigma * t_gamma, sigma)))
        is_global = ((last_success & prev_step_ego)
                     | (it % (1 + n_local_steps) == 0))
        xbest = _best_x(xb, yb, cb, mb, all_tols, n_cstr)
        loc_lo = torch.maximum(lo, xbest - t_d0)
        loc_hi = torch.minimum(hi, xbest + t_d1)

    xv, yv, mv, thv = xb, yb, mb, theta
    xq = []
    for t in range(q):
        if use_middle:
            starts = middle_picker_starts_traced(
                xv, mv, lo, hi, n_start, n_sub_max, pick_scores[t],
                pick_fills[t])
        else:
            starts = lo[None, :] + pick_fills[t] * (hi - lo)[None, :]
        if trego:
            # local steps seed inside the trust region; the criterion box
            # stays [lo, hi]
            local = loc_lo[None, :] + local_fills[t] * (loc_hi
                                                         - loc_lo)[None, :]
            starts = torch.where(is_global, starts, local)
        starts = torch.clamp(starts, lo[None, :], hi[None, :])
        xk, fk, models = _select_core(
            xv, yv, mv, thv, theta_lo, theta_up,
            None if fit_seeds is None else fit_seeds[t], clouds[t], starts,
            lo, hi, fmin, cstr_tols, fcstr_tols if fcstr_fns else None,
            feas_flag, n_cstr=n_cstr, fcstr_fns=fcstr_fns,
            feasibility=True, **statics)
        if q > 1:
            yk = _virtual_row(models, xk, y_best, qei)
            xv, yv, mv, _ = _append_row(xv, yv, mv, xk, yk)
        thv = models.theta
        xq.append(xk.detach())

    rows = []
    any_ok = torch.zeros((), dtype=torch.bool, device=xb.device)
    for xk in xq:
        # the true evaluations, de-duplicated against the live buffers
        with torch.no_grad():
            yk = torch.as_tensor(fobj(xk[None, :])).to(dtype).reshape(m)
            if fcstr_fns:
                ck = torch.stack([torch.as_tensor(f(xk)).to(dtype).reshape(())
                                  for f in fcstr_fns])
            else:
                ck = torch.zeros((0,), dtype=dtype, device=xb.device)
        yk = _impute_row(yk, yb, mb)
        d = torch.sum(torch.abs(xb - xk[None, :]), dim=1)
        ok = ~done & ~torch.any(mb & (d < dedup_tol))
        xb, yb, mb_new, hot = _append_row(xb, yb, mb, xk, yk, ok)
        cb = torch.where(hot[:, None], ck[None, :], cb)
        mb = mb_new
        any_ok = any_ok | ok
        rows.append(torch.cat([xk, yk, ck, ok.to(dtype)[None]]))
    retries = torch.where(any_ok, torch.full_like(retries, MAX_RETRIES),
                          torch.where(done, retries, retries - 1))
    fmin2, _ = _best_fmin(yb, cb, mb, all_tols, n_cstr)
    done = done | (retries <= 0) | (fmin2 < target)
    rows = torch.cat([torch.stack(rows),
                      done.to(dtype).expand(q)[:, None]], dim=1)
    if trego:
        in_local = ~is_global
        prev_fmin = fmin  # the next step's success baseline
    carry = (xb, yb, cb, mb, thv.detach(), retries, done, sigma, in_local,
             prev_fmin)
    return carry, rows


_CARRY = ("xb", "yb", "cb", "mb", "theta", "retries", "done", "sigma",
          "in_local", "prev_fmin")


def run_traced(solver, state, fobj, max_iters: int,
               chunk_iters: int | None = None, fcstrs=()):
    """Run the EGO loop with the objective on the device, in chunks of
    ``chunk_iters`` (default: the shape bucket) iterations: per chunk the
    design is padded into device buffers with room for the chunk's points,
    every draw of the chunk is made, the steps run with no host read, and
    the host fetches the chunk's rows once and replays the appends.
    ``state`` is updated as ``solver.ego_step`` would (x / y / c_data,
    best_index, feasibility, iter, the retry counter, TREGO's sigma);
    ``fobj`` maps an (n, nx) tensor to (n, 1 + n_cstr).

    The cold fit (iteration 0) runs alone in a first chunk at the full
    ``n_start`` width; later chunks re-seed ``warm_refit_n_start`` lanes, the
    boundary of the host loop's ``_gp_n_start``.

    Returns the state. ``solver.last_times`` then holds the seconds of
    every chunk and its iteration count."""
    from .find_result import find_best_result_index, is_feasible
    from .solver import _CRIT_NAME, _CSTR_NAME, _OPT_NAME, _QEI_NAME, _bucket

    cfg = solver.config
    remaining_iters = int(max_iters) - int(state.iter)
    chunk = int(chunk_iters or cfg.shape_bucket)
    m = state.y_data.shape[1]
    nx = solver.nx
    q = int(cfg.q_points)
    n_cstr = cfg.n_cstr
    n_fc = len(fcstrs)
    dev = solver.device
    ten = solver._tensor
    use_middle = not os.environ.get(
        "EGOR_DO_NOT_USE_MIDDLEPICKER_MULTISTARTER")
    use_feas = bool(os.environ.get("EGOR_USE_MAX_PROBA_OF_FEASIBILITY"))
    trego_on = bool(cfg.trego.activated)
    crit = _CRIT_NAME[cfg.infill_strategy]
    cstrat = _CSTR_NAME[cfg.cstr_strategy]
    qei = _QEI_NAME[cfg.q_infill_strategy]
    n_cloud = min(100 * nx, 1000)
    wrns = cfg.warm_refit_n_start
    base_ns = solver.spec.n_start
    warm_refit_on = wrns is not None and base_ns > 0

    # one type for the whole run: that of its largest design
    solver._iter_dtype = egor_dtype(
        dev, state.x_data.shape[0] + max(remaining_iters, 0) * q)
    theta, t_lo, t_up = solver._theta_setup(state, m)
    consts = dict(
        theta_lo=t_lo, theta_up=t_up,
        lo=ten(solver.xlimits[:, 0]), hi=ten(solver.xlimits[:, 1]),
        cstr_tols=ten(state.cstr_tol[:n_cstr]),
        fcstr_tols=ten(state.cstr_tol[n_cstr:n_cstr + n_fc]),
        target=ten(cfg.target), t_gamma=ten(cfg.trego.gamma),
        t_beta=ten(cfg.trego.beta), t_d0=ten(np.full(nx, cfg.trego.d[0])),
        t_d1=ten(np.full(nx, cfg.trego.d[1])),
    )
    pb = state.prev_best_index
    sched = dict(
        retries=_to(torch.tensor(state.no_point_added_retries), dev),
        done=_to(torch.tensor(False), dev),
        sigma=ten(state.sigma),
        in_local=_to(torch.tensor(bool(state.in_local_phase)), dev),
        prev_fmin=ten(float(state.y_data[pb, 0]) if pb is not None
                      else np.inf),
    )
    times = []
    remaining = remaining_iters
    while remaining > 0:
        t_chunk = time.perf_counter()
        if warm_refit_on and int(state.iter) < 1:
            k, gp_ns = 1, base_ns  # the cold fit, in its own chunk
        elif warm_refit_on:
            k, gp_ns = min(chunk, remaining), min(base_ns, int(wrns))
        else:
            k, gp_ns = min(chunk, remaining), base_ns
        n = state.x_data.shape[0]
        nb = _bucket(n + k * q, cfg.shape_bucket)
        xp, yp, mask = solver._pad(state.x_data, state.y_data, k * q)
        cp = np.zeros((nb, n_fc))
        cp[:n] = state.c_data
        carry = dict(xb=xp, yb=yp, cb=ten(cp), mb=mask, theta=theta,
                     **sched)
        nugget = solver.spec.nugget
        if nugget is None:
            nugget = 100.0 * torch.finfo(solver.dtype).eps
        statics = dict(
            fobj=fobj, n_start=cfg.n_start, use_middle=use_middle,
            use_feasibility_first=use_feas, n_cstr=n_cstr, q_points=q,
            qei=qei, trego=trego_on,
            n_local_steps=int(cfg.trego.n_local_steps),
            fcstr_fns=tuple(fcstrs), corr=solver.spec.corr,
            trend=solver.spec.trend, kpls_dim=solver.spec.kpls_dim,
            gp_n_start=gp_ns, gp_max_iters=solver.spec.max_iters,
            nugget=nugget, crit=crit, cstr_strategy=cstrat,
            cstr_infill=cfg.cstr_infill,
            optimizer=_OPT_NAME[cfg.infill_optimizer],
            ls_batch=solver.spec.ls_batch,
        )
        dim = theta.shape[1]
        rows = []
        for j in range(k):
            it = int(state.iter) + j
            do_fit = it % int(cfg.q_optmod) == 0
            fit_seeds = None
            if gp_ns > 0:
                fd = solver.draws.fit_draws(int(state.rng.integers(0, 2**31)))
                fit_seeds = ten(np.stack([
                    fd.lhs_seeds(gp_ns, dim, torch.float64, "cpu").numpy()
                    for _ in range(q)]))
            picks = [solver.draws.picker(nb, cfg.n_start, nx)
                     for _ in range(q)]
            draws = dict(
                it=_to(torch.tensor(it), dev),
                fit_seeds=fit_seeds,
                clouds=ten(np.stack([
                    solver.draws.lhs(n_cloud, solver.xlimits)
                    for _ in range(q)])),
                pick_scores=ten(np.stack([p[0] for p in picks])),
                pick_fills=ten(np.stack([p[1] for p in picks])),
                local_fills=ten(np.stack([
                    solver.draws.unit_lhs(cfg.n_start, nx)
                    for _ in range(q)])) if trego_on else None,
            )
            key = ("traced", nb, m, solver.dtype, do_fit,
                   tuple(sorted(statics.items())))
            out = solver.graphs.run(
                key, lambda **kw: _step(kw, not do_fit, statics),
                {**carry, **draws, **consts}, xp.shape)
            carry = dict(zip(_CARRY, out[0]))
            rows.append(out[1])
        theta = carry["theta"]
        sched = {k2: carry[k2] for k2 in _CARRY[5:]}
        # the chunk's one host fetch: its rows and the scheduler state
        packed = torch.cat([torch.stack(rows).reshape(-1),
                            carry["sigma"].reshape(1).to(solver.dtype),
                            carry["in_local"].reshape(1).to(solver.dtype)])
        arr = packed.double().cpu().numpy()
        width = nx + m + n_fc + 2
        flat = arr[:k * q * width].reshape(k * q, width)
        if trego_on:
            state.sigma = float(arr[-2])
            state.in_local_phase = bool(arr[-1] > 0.5)
        appended = flat[:, nx + m + n_fc] > 0.5
        done_flags = flat[:, nx + m + n_fc + 1] > 0.5
        state.x_data = np.vstack([state.x_data, flat[appended, :nx]])
        state.y_data = np.vstack([state.y_data, flat[appended, nx:nx + m]])
        state.c_data = np.vstack([state.c_data,
                                  flat[appended, nx + m:nx + m + n_fc]])
        state.prev_added = state.added
        state.added += int(appended.sum())
        state.iter += k
        remaining -= k
        times.append({"chunk": time.perf_counter() - t_chunk,
                      "iterations": k, "graph": solver.graphs.stats.last})
        if done_flags.any():
            # the device froze the run (retries exhausted, target reached)
            state.no_point_added_retries = 0
            break
        # the retry counter resets on every iteration that appended a
        # point: MAX_RETRIES minus the trailing all-duplicate streak
        trailing = 0
        for flag in appended.reshape(k, q).any(axis=1)[::-1]:
            if flag:
                break
            trailing += 1
        state.no_point_added_retries = MAX_RETRIES - trailing

    state.theta_inits = theta
    best = find_best_result_index(state.y_data, state.c_data, state.cstr_tol)
    state.prev_best_index = state.best_index
    state.best_index = best
    state.feasibility = state.feasibility or is_feasible(
        state.y_data[best], state.c_data[best], state.cstr_tol)
    solver.last_times = {"chunks": times}
    return state


def _to(t, dev):
    """A host tensor on ``dev`` without waiting for the device."""
    return t.to(dev, non_blocking=True)


def _step(kw, fixed, statics):
    args = [kw.pop(name) for name in _CARRY]
    return traced_step(*args, fixed=fixed, **kw, **statics)
