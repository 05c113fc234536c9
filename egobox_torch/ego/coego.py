"""CoEGO: cooperative EGO for high-dimensional problems (nx > ~100)
(port of egobox_tpu/ego/coego.py).

Behavioral parity with crates/ego/src/solver/coego.rs: each iteration
randomly partitions the components into n_coop groups
(get_random_activity, coego.rs:55-84) and optimizes the infill criterion
group-by-group while the inactive components stay pinned to the current
context vector (set_active_x/get_active_x, coego.rs:26-44). Each candidate
context update can be validated against the current best through surrogate
trust bounds (is_objective_improved/predict_point, coego.rs:143-214), gated
like the reference's COEGO_IMPROVEMENT_CHECK const (coego.rs:21, default
off) but overridable via EGOR_COEGO_IMPROVEMENT_CHECK=1.

Partial optimization runs the same lockstep multistart as the full path:
the inactive dimensions are pinned by collapsing their box to the context
value (lo == hi), so the bounded L-BFGS's projection freezes them. Partial
theta tuning (coego.rs:98-126) is the solver's training path with the
``active_theta`` mask of the fit. The groups and the context live on the
host in numpy; the surrogates and the optimization on the solver's device.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .find_result import find_best_result_index_from

#: trust-bound width for the challenger check (ref: coego.rs:22 CSTR_DOUBT)
CSTR_DOUBT = 3.0

#: reference default: challenger check disabled (ref: coego.rs:21
#: COEGO_IMPROVEMENT_CHECK = false, "not sure improvement check is required")
COEGO_IMPROVEMENT_CHECK = False


def improvement_check_enabled() -> bool:
    if os.environ.get("EGOR_COEGO_IMPROVEMENT_CHECK"):
        return True
    return COEGO_IMPROVEMENT_CHECK


def get_random_activity(rng: np.random.Generator, nx: int,
                        n_coop: int) -> List[np.ndarray]:
    """Random partition of [0, nx) into ~n_coop groups
    (ref: get_random_activity, coego.rs:55-84; the reference pads ragged
    rows with out-of-range markers, the groups here stay ragged). The same
    numpy calls as egobox_tpu: equal ``rng`` states give equal groups."""
    g_nb = min(n_coop, nx)
    idx = rng.permutation(nx)
    return [np.sort(g) for g in np.array_split(idx, g_nb)]


def activity_theta_mask(group: np.ndarray, dim: int) -> np.ndarray:
    """Boolean theta-active mask for one group, indices clipped to the
    theta dimension (ref: strip, coego.rs:128-137)."""
    mask = np.zeros(dim, dtype=bool)
    mask[group[group < dim]] = True
    return mask


def _on_models(models, x) -> torch.Tensor:
    """``x`` on the surrogates' device, in their type."""
    ref = models[0].experts[0] if isinstance(models, tuple) else models
    return torch.as_tensor(np.asarray(x, dtype=float)).to(
        dtype=ref.theta.dtype, device=ref.theta.device)


def predict_point(models, x: np.ndarray) -> np.ndarray:
    """Optimistic surrogate values at x: objective lower trust bound,
    constraints upper trust bound (ref: predict_point, coego.rs:192-214).
    One posterior evaluation on the surrogates' device, one host read."""
    from .surrogates import surrogate_valvar_single

    with torch.no_grad():
        means, vrs = surrogate_valvar_single(models, _on_models(models, x))
        packed = torch.stack([means, vrs]).double().cpu().numpy()
    means = packed[0].copy()
    sig = np.sqrt(np.maximum(packed[1], 0.0))
    means[0] -= CSTR_DOUBT * sig[0]
    means[1:] += CSTR_DOUBT * sig[1:]
    return means


def is_objective_improved(
    current_best: Tuple[np.ndarray, np.ndarray, np.ndarray],
    xcoop: np.ndarray,
    models,
    cstr_tols: np.ndarray,
    eval_fcstrs: Optional[Callable[[np.ndarray], np.ndarray]] = None,
):
    """Trust-bound challenger check: does the cooperative candidate beat the
    current best under the surrogates? (ref: is_objective_improved,
    coego.rs:143-190). Returns (is_better, new_best_triple)."""
    xb, yb, cb = current_best
    y_pred = predict_point(models, xcoop)
    y_data = np.stack([np.asarray(yb, dtype=float), y_pred])
    if eval_fcstrs is not None and len(cb):
        c_new = np.asarray(eval_fcstrs(xcoop), dtype=float).reshape(-1)
    else:
        c_new = np.zeros_like(np.asarray(cb, dtype=float))
    c_data = np.stack([np.asarray(cb, dtype=float), c_new])
    best_index = find_best_result_index_from(0, 1, y_data, c_data,
                                             np.asarray(cstr_tols))
    if best_index == 0:
        return False, current_best
    return True, (np.asarray(xcoop, dtype=float).copy(), y_pred, c_new)


def coego_optimize_infill(
    solver,
    models,
    current_best: Tuple[np.ndarray, np.ndarray, np.ndarray],
    activity: List[np.ndarray],
    starts_fn,
    lo: np.ndarray,
    hi: np.ndarray,
    optimize_kwargs: dict,
    cstr_tols: Optional[np.ndarray] = None,
    fcstrs: Sequence[Callable] = (),
):
    """Sequential per-group partial infill optimization with a context
    vector (ref: solver_infill_optim.rs:140-270 partial loop). The context
    advances after every group; with the improvement check enabled a
    candidate that regresses the trust-bound best is rejected
    (coego.rs:143-190). Each group is one ``optimize_infill`` on the
    solver's device (the box and the starts uploaded, the optimum read
    back). Returns (x_opt, infill_obj)."""
    from .infill_optim import optimize_infill

    xbest, ybest, cbest = current_best
    cur = (
        np.asarray(xbest, dtype=float).copy(),
        np.asarray(ybest, dtype=float).copy(),
        np.asarray(cbest, dtype=float).copy(),
    )
    check = improvement_check_enabled() and cstr_tols is not None

    def eval_fc(x):
        return solver._eval_fcstrs(fcstrs, x[None, :])[0]

    best_x = cur[0]
    best_f = np.inf
    for i, group in enumerate(activity):
        ctx = cur[0]
        pin_lo = ctx.copy()
        pin_hi = ctx.copy()
        pin_lo[group] = lo[group]
        pin_hi[group] = hi[group]

        starts = np.asarray(starts_fn())
        # pin the inactive components of every start to the context vector
        mask = np.zeros(ctx.shape[0], dtype=bool)
        mask[group] = True
        starts = np.where(mask[None, :], starts, ctx[None, :])

        xk, fk, _ = optimize_infill(
            models,
            solver._tensor(starts),
            solver._tensor(pin_lo),
            solver._tensor(pin_hi),
            **optimize_kwargs,
        )
        packed = torch.cat([xk, fk.reshape(1)]).double().cpu().numpy()
        fk = float(packed[-1])
        if not np.isfinite(fk):
            continue
        xopt_coop = packed[:-1]

        if check:
            is_better, new_cur = is_objective_improved(
                cur, xopt_coop, models, cstr_tols,
                eval_fc if fcstrs else None,
            )
            if is_better or i == 0:
                # on i==0 the challenger becomes the proposal but the
                # trust-bound best (the context) only advances if better
                # (ref: solver_infill_optim.rs:243-262)
                best_x, best_f = xopt_coop, fk
                cur = new_cur
        else:
            best_x, best_f = xopt_coop, fk
            cur = (xopt_coop, cur[1], cur[2])
    return best_x, best_f
