"""TREGO: trust-region EGO scheduler and local step (port of
egobox_tpu/ego/trego.py; numpy over the solver).

Behavioral parity with crates/ego/src/solver/trego.rs and the scheduler in
egor_solver.rs:454-529: a global EGO step alternates with n_local_steps
local steps; success test is y_best < y_prev_best - sigma^2; sigma is scaled
by gamma (10/9) on success and beta (0.9) on a failed local step. The local
step seeds the (same) infill optimization with LHS points drawn in
the box [xbest - d0, xbest + d1] ∩ xlimits.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from .find_result import find_best_result_index_from, is_feasible
from .solver import EgorSolver, NoMorePointToAddError
from .state import EgorState


def _local_area(solver: EgorSolver, xbest: np.ndarray) -> np.ndarray:
    d0, d1 = solver.config.trego.d
    lo = np.maximum(solver.xlimits[:, 0], xbest - d0)
    hi = np.minimum(solver.xlimits[:, 1], xbest + d1)
    return np.stack([lo, hi], axis=1)


def trego_local_step(
    solver: EgorSolver,
    state: EgorState,
    fobj: Callable,
    fcstrs: Sequence[Callable] = (),
) -> EgorState:
    """One local infill step: multistart seeds are drawn inside the trust
    region but the criterion is optimized within the FULL xlimits, matching
    the reference (trego.rs:53-76 LocalLhsMultiStarter samples local_area;
    optimize_infill_criterion runs over self.xlimits)."""
    xbest = state.x_data[state.best_index]
    area = _local_area(solver, xbest)
    x_dat, _, _ = solver.select_next_points(
        state, fcstrs, init=False, seed_xlimits=area
    )
    keep = [
        i
        for i in range(x_dat.shape[0])
        if solver._is_new(state.x_data, x_dat[i])
    ]
    if keep:
        x_new = x_dat[keep]
        y_new = np.atleast_2d(np.asarray(fobj(x_new), dtype=float))
        c_new = solver._eval_fcstrs(fcstrs, x_new)
        offset = state.x_data.shape[0]
        state.x_data = np.vstack([state.x_data, x_new])
        state.y_data = np.vstack([state.y_data, y_new])
        state.c_data = np.vstack([state.c_data, c_new])
        state.prev_added = state.added
        state.added += x_new.shape[0]
        best = find_best_result_index_from(
            state.best_index, offset, state.y_data, state.c_data,
            state.cstr_tol,
        )
        state.prev_best_index = state.best_index
        state.best_index = best
        state.feasibility = state.feasibility or is_feasible(
            state.y_data[best], state.c_data[best], state.cstr_tol
        )
    state.iter += 1
    return state


def trego_step(
    solver: EgorSolver,
    state: EgorState,
    fobj: Callable,
    fcstrs: Sequence[Callable] = (),
) -> EgorState:
    """One TREGO iteration: scheduler + global/local step
    (ref: egor_solver.rs trego_iteration)."""
    cfg = solver.config.trego
    y = state.y_data
    best = state.best_index
    prev_best = (
        state.prev_best_index if state.prev_best_index is not None else best
    )
    rho = state.sigma**2
    last_success = y[best, 0] < y[prev_best, 0] - rho

    prev_step_ego = not state.in_local_phase
    if state.iter != 0:
        if not prev_step_ego:
            state.sigma *= cfg.gamma if last_success else cfg.beta
        elif last_success:
            state.sigma *= cfg.gamma

    is_global = (last_success and prev_step_ego) or (
        state.iter % (1 + cfg.n_local_steps) == 0
    )

    if is_global:
        state = solver.ego_step(state, fobj, fcstrs)
        state.in_local_phase = False
    else:
        state = trego_local_step(solver, state, fobj, fcstrs)
        state.in_local_phase = True
    return state
