"""EgorSolver: the EGO iteration engine (port of egobox_tpu/ego/solver.py).

The outer ask/eval/tell loop stays in Python (it calls the user's
objective); the DoE and the bookkeeping live in numpy; every phase of an
iteration (surrogate training for objective and constraints, the
scaling-cloud evaluation and the constrained multistart infill
optimization) runs on the solver's device.

Two paths, chosen as egobox_tpu chooses them (``_fast_path_ok``):

- the fused iteration (the default on the single-cluster GP path): the
  design is padded to ``shape_bucket`` rows with a mask, every draw is made
  on the host first, and the whole iteration is one program with no host
  read (ego/fused_step.py). On the GPU it is a CUDA graph captured once
  per signature and replayed, for designs of up to ``GRAPH_MAX_ROWS`` padded
  rows (ego/graphs.py); the host fetches one packed row per iteration;
- the unfused iteration (``EGOBOX_NO_FUSED_STEP=1``, and whatever the gate
  refuses): phase after phase on the unpadded design.

Clustered surrogates (``n_clusters != 1``, or several regression or
correlation models) take egobox_tpu's two paths as well: a host iteration
whenever the clustering is (re)made, and the fused clustered iteration
(ego/fused_step.py ``fused_select_point_moe``, a CUDA graph on the GPU)
while it stands (``_fast_path_moe_ok``; ``EGOBOX_NO_FUSED_MOE=1`` selects
the host path).

CoEGO (``coego_n_coop > 1``, ego/coego.py) and the sigma-weight portfolio
(``EGOR_USE_GP_VAR_PORTFOLIO``, ego/portfolio.py) run on the host path, as
in egobox_tpu. So do function constraints that are host callbacks (a numpy
function, a python float out): on the host path no function constraint
enters the infill optimizer; the proposal is polished afterwards by the
native derivative-free solver (``_fcstr_polish``, egobox_torch/native),
whose every evaluation is one posterior evaluation on the solver's device.
Constraints written in torch operations enter the fused iterations' own
optimizer instead (``_fcstrs_traceable``; ``EGOBOX_NO_FCSTR_TRACE=1``
sends them to the host path and the polish).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..config import egor_dtype, resolve_device
from ..doe.lhs import LhsKind, lhs_normalized
from ..gp import fit as gp_fit
from ..gp.kernels import theta_bounds_heuristic
from ..moe.moe import expert_params, train_moe, train_moe_on_clusters
from ..types import (
    ConstraintStrategy,
    InfillOptimizer,
    InfillStrategy,
    QInfillStrategy,
    Recombination,
)
from .config import MAX_POINT_ADDITION_RETRY, EgorConfig
from .find_result import (
    find_best_result_index,
    find_best_result_index_from,
    is_feasible,
)
from .fused_step import (
    fused_select_point,
    fused_select_point_moe,
    fused_select_points_q,
)
from .graphs import GraphCache
from .infill_optim import compute_scaling, optimize_infill, virtual_point
from .recorders import record_gp_models
from .start_points import middle_picker_starts
from .state import EgorState
from .surrogates import GpSpec, train_gp_surrogates

logger = logging.getLogger("egobox_torch.ego")

_CRIT_NAME = {
    InfillStrategy.EI: "EI",
    InfillStrategy.WB2: "WB2",
    InfillStrategy.WB2S: "WB2S",
    InfillStrategy.LOG_EI: "LogEI",
}
_CSTR_NAME = {
    ConstraintStrategy.MC: "MC",
    ConstraintStrategy.UTB: "UTB",
}
_QEI_NAME = {
    QInfillStrategy.KB: "KB",
    QInfillStrategy.KBLB: "KBLB",
    QInfillStrategy.KBUB: "KBUB",
    QInfillStrategy.CLMIN: "CLMIN",
}
_OPT_NAME = {
    InfillOptimizer.COBYLA: "COBYLA",
    InfillOptimizer.SLSQP: "SLSQP",
}


class NoMorePointToAddError(RuntimeError):
    """Raised when point-addition retries are exhausted: the solver is
    considered converged (ref: solver_impl.rs:505-515)."""


class SolverDraws:
    """Every random draw of the EGO loop that does not come from
    ``state.rng``: the initial DoE, the scaling cloud, the LHS completion of
    the multistart seeds and the restart seeds of the fits. One CPU
    ``torch.Generator`` seeded with the solver's seed serves the first
    three; a fit's draws come from ``FitDraws(seed)`` with the seed the
    solver drew from ``state.rng``. Tests replace ``solver.draws`` to hand
    in egobox_tpu's draws."""

    def __init__(self, seed: int):
        self.generator = torch.Generator().manual_seed(seed)

    def lhs(self, n: int, xlimits: np.ndarray,
            kind: LhsKind = LhsKind.MAXIMIN) -> np.ndarray:
        """(n, nx) LHS points of ``kind`` inside ``xlimits`` (nx, 2)."""
        pts = lhs_normalized(self.generator, n, xlimits.shape[0], kind,
                             torch.float64, "cpu").numpy()
        return pts * (xlimits[:, 1] - xlimits[:, 0]) + xlimits[:, 0]

    def fit_draws(self, seed: int):
        return gp_fit._fit_draws(seed)

    def unit_lhs(self, n: int, nx: int) -> np.ndarray:
        """(n, nx) maximin LHS in [0, 1]^nx."""
        return lhs_normalized(self.generator, n, nx, LhsKind.MAXIMIN,
                              torch.float64, "cpu").numpy()

    def picker(self, nb: int, n_start: int, nx: int):
        """The two draws of the traceable picker
        (start_points.middle_picker_starts_traced): (nb,) uniform scores and
        an (n_start, nx) maximin LHS in [0, 1]^nx."""
        scores = torch.rand((nb,), generator=self.generator,
                            dtype=torch.float64).numpy()
        return scores, self.unit_lhs(n_start, nx)


def _bucket(n: int, b: int) -> int:
    return max(b, ((n + b - 1) // b) * b)


def impute_failed_values(y_new: np.ndarray, y_ref: np.ndarray) -> np.ndarray:
    """Replace non-finite entries of ``y_new`` (rows, cols) with a
    worst-observed penalty per column derived from the finite values of
    ``y_ref`` (max + 3 sigma; a fixed 1e6 when the column has no finite
    reference at all). Applied to new points and to the initial DoE: a
    NaN/inf anywhere in the history would otherwise poison the GP
    normalization."""
    bad = ~np.isfinite(y_new)
    if not bad.any():
        return y_new
    logger.warning("imputing %d failed objective value(s)",
                   int(bad.sum()))
    y_new = y_new.copy()
    for j in range(y_new.shape[1]):
        col_ref = y_ref[:, j]
        finite = col_ref[np.isfinite(col_ref)]
        if finite.size:
            penalty = finite.max() + 3.0 * max(finite.std(), 1.0)
        else:
            penalty = 1e6
        y_new[bad[:, j], j] = penalty
    return y_new


class EgorSolver:
    """Continuous-space EGO solver. Mixed-integer handling wraps this via
    egobox_torch.ego.mixint (like the reference's MixintGpMixture
    decorators).

    ``device``: where the surrogates and the infill optimization run
    (default: the GPU, and a host without one raises; ``"cpu"`` for the
    CPU). ``dtype`` fixes the type they compute in; by default it follows
    ``config.egor_dtype`` (float64 on the CPU, and on CUDA for designs
    below 4 096 points). With ``dtype=torch.float32`` on CUDA the K1 kernel
    builds the large L1-family Grams of the refit and the scaling cloud."""

    def __init__(self, config: EgorConfig, xlimits: np.ndarray, device=None,
                 dtype=None):
        self.config = config.check()
        self.device = resolve_device(device)
        self._dtype = dtype
        self.xlimits = np.asarray(xlimits, dtype=float)
        self.nx = self.xlimits.shape[0]
        gpc = config.gp_config
        dim = gpc.kpls_dim if gpc.kpls_dim is not None else self.nx
        corr = gpc.corr_names[0]
        trend = gpc.regr_names[0]
        self.spec = GpSpec(
            corr=corr,
            trend=trend,
            kpls_dim=gpc.kpls_dim,
            n_start=gpc.n_start,
            max_iters=gpc.max_eval,
        )
        # dim-aware theta bounds for high-dim problems
        # (ref: ego/src/utils/bounds.rs via egor_solver)
        if gpc.theta_bounds is not None:
            self.theta_bounds = np.asarray(gpc.theta_bounds, dtype=float)
        elif dim >= 10:
            lo, up = theta_bounds_heuristic(corr, dim)
            self.theta_bounds = np.array([float(lo), float(up)])
        else:
            self.theta_bounds = np.array([1e-2, 1e1])
        self.theta_init = (
            np.asarray(gpc.theta_init, dtype=float)
            if gpc.theta_init is not None
            else None
        )
        self.draws = SolverDraws(
            config.seed if config.seed is not None else 0
        )
        self._iter_dtype = egor_dtype(self.device, 0)
        #: optional discrete-casting hook installed by the mixint layer
        #: (ref: MixintGpMixture input casting, gpmix/mixint.rs:295-746)
        self.cast_fn = None
        #: the surrogates of the last training and the seconds the last
        #: ``select_next_points`` spent per phase (fit, cloud, infill)
        self.last_models = None
        self.last_times = {}
        self._fcstr_probe_cache = {}
        #: the captured graphs of the fused iteration and the traced run
        self.graphs = GraphCache()

    def _cast(self, x: np.ndarray) -> np.ndarray:
        return self.cast_fn(x) if self.cast_fn is not None else x

    @property
    def dtype(self) -> torch.dtype:
        """The type of the current iteration's tensors (set by
        ``select_next_points`` from the design's size unless fixed)."""
        return self._dtype or self._iter_dtype

    def _tensor(self, a) -> torch.Tensor:
        """``a`` on the solver's device in its type. A host array goes by an
        asynchronous copy: the host waits for nothing on the device."""
        if not isinstance(a, torch.Tensor):
            a = np.asarray(a)
            if not a.flags.writeable:
                a = a.copy()
            a = torch.as_tensor(a)
        return a.to(dtype=self.dtype).to(self.device, non_blocking=True)

    def _pad(self, x: np.ndarray, y: np.ndarray, extra: int = 0):
        """The design padded to the shape bucket (of n + ``extra`` rows),
        with the mask of its active rows, on the solver's device."""
        n = x.shape[0]
        nb = _bucket(n + extra, self.config.shape_bucket)
        xp = np.zeros((nb, x.shape[1]))
        xp[:n] = x
        yp = np.zeros((nb, y.shape[1]))
        yp[:n] = y
        mask = np.zeros(nb, dtype=bool)
        mask[:n] = True
        return (self._tensor(xp), self._tensor(yp),
                torch.as_tensor(mask).to(self.device, non_blocking=True))

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def _lhs(self, n: int, kind=LhsKind.MAXIMIN) -> np.ndarray:
        return self.draws.lhs(n, self.xlimits, kind)

    def _lhs_in(self, n: int, xlimits: np.ndarray) -> np.ndarray:
        """Maximin-LHS seeds in ``xlimits``."""
        return self.draws.lhs(n, np.asarray(xlimits, dtype=float),
                              LhsKind.MAXIMIN)

    def default_n_doe(self) -> int:
        n = self.config.n_doe
        return n if n > 0 else max(self.nx + 1, 5)

    # ------------------------------------------------------------------
    # initialization (ref: egor_solver.rs:181-348)
    # ------------------------------------------------------------------

    def init_state(
        self,
        fobj: Callable[[np.ndarray], np.ndarray],
        fcstrs: Sequence[Callable] = (),
        doe: Optional[np.ndarray] = None,
        y_doe: Optional[np.ndarray] = None,
    ) -> EgorState:
        cfg = self.config
        if doe is None:
            doe = (
                np.asarray(cfg.doe, dtype=float)
                if cfg.doe is not None
                else self._cast(
                    self._lhs(self.default_n_doe(), LhsKind.OPTIMIZED)
                )
            )
        x_data = np.atleast_2d(np.asarray(doe, dtype=float))
        if y_doe is not None:
            y_data = np.atleast_2d(np.asarray(y_doe, dtype=float))
        else:
            y_data = np.atleast_2d(np.asarray(fobj(x_data), dtype=float))
        if y_data.shape[1] != 1 + cfg.n_cstr:
            raise ValueError(
                f"objective returned {y_data.shape[1]} columns, expected "
                f"1 + n_cstr = {1 + cfg.n_cstr}"
            )
        # failed evaluations in the initial DoE poison the GP normalization
        # exactly like later ones: impute them against the DoE itself
        y_data = impute_failed_values(y_data, y_data)
        c_data = self._eval_fcstrs(fcstrs, x_data)
        cstr_tol = cfg.resolved_cstr_tol(len(fcstrs))

        best = find_best_result_index(y_data, c_data, cstr_tol)
        state = EgorState(
            x_data=x_data,
            y_data=y_data,
            c_data=c_data,
            cstr_tol=cstr_tol,
            best_index=best,
            feasibility=is_feasible(y_data[best], c_data[best], cstr_tol),
            added=x_data.shape[0],
            no_point_added_retries=MAX_POINT_ADDITION_RETRY,
            sigma=cfg.trego.sigma0,
            rng=np.random.default_rng(cfg.seed),
        )
        return state

    def _eval_fcstrs(self, fcstrs, x: np.ndarray) -> np.ndarray:
        """Function constraints on the host, one (nx,) float64 CPU tensor
        per point (the form ``_fcstrs_traceable`` asks of them)."""
        if not fcstrs:
            return np.zeros((x.shape[0], 0))
        out = np.zeros((x.shape[0], len(fcstrs)))
        for i, xi in enumerate(x):
            xt = torch.as_tensor(np.asarray(xi, dtype=float))
            for j, c in enumerate(fcstrs):
                out[i, j] = float(c(xt))
        return out

    # ------------------------------------------------------------------
    # surrogate training (ref: make_clustered_surrogate,
    # solver_impl.rs:121-296, single-cluster GP path)
    # ------------------------------------------------------------------

    def _train(self, state: EgorState, xt: np.ndarray, yt: np.ndarray,
               optimize_theta: bool):
        gpc = self.config.gp_config
        multi_combo = (
            len(gpc.regr_names) > 1 or len(gpc.corr_names) > 1
        )
        if gpc.n_clusters != 1 or multi_combo:
            models = self._train_moe(state, xt, yt, optimize_theta)
        else:
            models = self._train_gp_batched(state, xt, yt, optimize_theta)
        record_gp_models(self.config.outdir, state.iter, models)
        self.last_models = models
        return models

    def have_to_recluster(self, state: EgorState) -> bool:
        """Automatic clusterings are made again every 10 added points
        (ref: solver_impl.rs:110-113); a fixed count clusters once."""
        if self.config.gp_config.n_clusters > 0:
            return False
        return (
            state.clusterings is None
            or state.added // 10 > state.prev_added // 10
        )

    def _train_moe(self, state: EgorState, xt: np.ndarray, yt: np.ndarray,
                   optimize_theta: bool = True):
        """One mixture per output (ref: make_clustered_surrogate,
        solver_impl.rs:121-296): clustered anew when ``have_to_recluster``
        (or when there is no clustering yet), else the experts retrained on
        the standing clustering. With ``optimize_theta`` False (q_optmod
        skip iterations) the experts are refit at the previous (trend,
        corr, theta) (ref: solver_impl.rs:643-645). Returns the tuple of
        ``MoeModel`` the infill takes."""
        gpc = self.config.gp_config
        m = yt.shape[1]
        recluster = self.have_to_recluster(state)
        mixes = []
        clusterings = [] if recluster or state.clusterings is None else None
        reuse = (
            not optimize_theta
            and clusterings is None
            and state.moe_params is not None
            and len(state.moe_params) == m
        )
        kw = dict(regr_names=gpc.regr_names, corr_names=gpc.corr_names,
                  kpls_dim=gpc.kpls_dim, n_start=gpc.n_start,
                  theta_init=self.theta_init, theta_bounds=self.theta_bounds,
                  device=self.device, dtype=self.dtype)
        for k in range(m):
            seed = int(state.rng.integers(0, 2**31))
            if clusterings is not None:
                mix = train_moe(xt, yt[:, k], n_clusters=gpc.n_clusters,
                                recombination=gpc.recombination, seed=seed,
                                **kw)
                clusterings.append((mix.gmx, mix.recombination))
            else:
                gmx, recomb = state.clusterings[k]
                fixed = state.moe_params[k] if reuse else None
                if fixed is not None and len(fixed) != gmx.n_clusters:
                    fixed = None
                mix = train_moe_on_clusters(xt, yt[:, k], gmx, recomb,
                                            seed=seed, fixed_params=fixed,
                                            **kw)
            mixes.append(mix)
        if clusterings is not None:
            state.clusterings = clusterings
        state.moe_params = [expert_params(mix) for mix in mixes]
        return tuple(mix.to_model() for mix in mixes)

    def _gp_n_start(self, state: EgorState) -> int:
        """Effective MLE multistart width of this iteration's refit.

        The cold fit (iter 0) keeps the full ``n_start`` width; every later
        refit re-seeds only ``warm_refit_n_start`` lanes. As in egobox_tpu
        the test is ``state.iter``, not whether thetas were carried: a
        resumed state without ``theta_inits`` at iter >= 1 refits from the
        default init at the narrow width. None (or n_start <= 0, the
        fixed-theta convention) disables."""
        w = self.config.warm_refit_n_start
        ns = self.spec.n_start
        if w is None or ns <= 0 or int(state.iter) < 1:
            return ns
        return min(ns, int(w))

    def _train_gp_batched(self, state: EgorState, xt: np.ndarray,
                          yt: np.ndarray, optimize_theta: bool):
        dim = (
            self.spec.kpls_dim
            if self.spec.kpls_dim is not None
            else self.nx
        )
        m = yt.shape[1]
        theta0s = state.theta_inits
        if theta0s is None or tuple(theta0s.shape) != (m, dim):
            if self.theta_init is not None:
                theta0s = np.broadcast_to(
                    self.theta_init, (m, dim)
                ).copy()
            else:
                theta0s = np.full((m, dim), 0.1)
        if (
            self.config.coego_n_coop > 1
            and self.config.coego_partial_theta_tuning
            and optimize_theta
            and state.activity is not None
        ):
            # CoEGO partial theta tuning: one fit per activity group, only
            # the group's theta components free, the inits carried from
            # group to group (ref: solver_impl.rs:162-247 + coego.rs:98-126)
            from .coego import activity_theta_mask

            models = None
            for group in state.activity:
                models = train_gp_surrogates(
                    self._tensor(xt), self._tensor(yt), None, self.spec,
                    theta0s=self._tensor(theta0s),
                    optimize_theta=True,
                    theta_bounds=self._tensor(self.theta_bounds),
                    seed=int(state.rng.integers(0, 2**31)),
                    active_theta=torch.as_tensor(
                        activity_theta_mask(group, dim), device=self.device),
                    n_start=self._gp_n_start(state),
                    fit_draws=self.draws.fit_draws,
                )
                theta0s = models.theta.double().cpu().numpy()
            state.theta_inits = theta0s
            return models
        models = train_gp_surrogates(
            self._tensor(xt), self._tensor(yt), None, self.spec,
            theta0s=self._tensor(theta0s),
            optimize_theta=optimize_theta,
            theta_bounds=self._tensor(self.theta_bounds),
            seed=int(state.rng.integers(0, 2**31)),
            n_start=self._gp_n_start(state),
            fit_draws=self.draws.fit_draws,
        )
        state.theta_inits = models.theta.double().cpu().numpy()
        return models

    # ------------------------------------------------------------------
    # point selection (ref: select_next_points, solver_impl.rs:562-807)
    # ------------------------------------------------------------------

    def _multistart_seeds(self, state: EgorState, xt: np.ndarray,
                          xlimits: np.ndarray,
                          seed_xlimits: Optional[np.ndarray]) -> np.ndarray:
        """Multistart seeds: middle-picker + LHS completion for global
        steps; pure local LHS inside a TREGO trust region
        (ref: trego.rs LocalLhsMultiStarter). The env kill-switch matches
        EGOR_DO_NOT_USE_MIDDLEPICKER_MULTISTARTER (ref: utils/mod.rs)."""
        cfg = self.config
        use_middle = not os.environ.get(
            "EGOR_DO_NOT_USE_MIDDLEPICKER_MULTISTARTER"
        )
        seed_box = seed_xlimits if seed_xlimits is not None else xlimits
        if seed_box is self.xlimits and use_middle:
            starts = middle_picker_starts(
                state.rng, xt, seed_box, cfg.n_start,
                lambda n: self._lhs_in(n, seed_box),
            )
        else:
            starts = self._lhs_in(cfg.n_start, seed_box)
        return np.clip(starts, xlimits[:, 0], xlimits[:, 1])

    def _fcstrs_traceable(self, fcstrs) -> bool:
        """True when every user function constraint maps one (nx,) tensor
        to a tensor of one value (probed once per function on the middle of
        the box): those enter the fused iterations' optimizer as hard
        constraints. Anything host-bound (numpy conversions, a python float
        out) takes the host path and its derivative-free polish
        (``_fcstr_polish``). Kill-switch: EGOBOX_NO_FCSTR_TRACE."""
        if os.environ.get("EGOBOX_NO_FCSTR_TRACE"):
            return False
        key = tuple(fcstrs)
        hit = self._fcstr_probe_cache.get(key)
        if hit is not None:
            return hit
        probe = self._tensor(self.xlimits.mean(axis=1))
        ok = True
        for f in fcstrs:
            try:
                out = f(probe)
                if not isinstance(out, torch.Tensor) or out.numel() != 1:
                    ok = False
                    break
            except (TypeError, ValueError, RuntimeError, AttributeError,
                    IndexError):
                # e.g. numpy refusing a tensor that requires grad or lives
                # on the GPU: a host-bound function
                ok = False
                break
        if len(self._fcstr_probe_cache) >= 32:
            self._fcstr_probe_cache.clear()
        self._fcstr_probe_cache[key] = ok
        return ok

    def _fast_path_ok(self, fcstrs) -> bool:
        """egobox_tpu's gate of the fused iteration: the single-cluster GP
        path with one regression and one correlation model, no CoEGO, no
        portfolio, function constraints written in torch operations, and
        q_points == 1 unless the GP recorder is on. ``EGOBOX_NO_FUSED_STEP``
        selects the unfused path."""
        gpc = self.config.gp_config
        multi_combo = (
            len(gpc.regr_names) > 1 or len(gpc.corr_names) > 1
        )
        q_ok = self.config.q_points == 1 or not os.environ.get(
            "EGOR_USE_GP_RECORDER"
        )
        return (
            q_ok
            and (not fcstrs or self._fcstrs_traceable(fcstrs))
            and gpc.n_clusters == 1
            and not multi_combo
            and self.config.coego_n_coop <= 1
            and not os.environ.get("EGOR_USE_GP_VAR_PORTFOLIO")
            and not os.environ.get("EGOBOX_NO_FUSED_STEP")
        )

    def _fast_path_moe_ok(self, state: EgorState, fcstrs) -> bool:
        """egobox_tpu's gate of the fused clustered iteration: clustered
        surrogates with one regression and one correlation model (no CV
        selection), a clustering that stands for this iteration (the
        clustering itself is made on the host path), one (k,
        recombination) for every output, and the other conditions of the
        fused path. ``EGOBOX_NO_FUSED_MOE`` (or ``EGOBOX_NO_FUSED_STEP``)
        selects the host path."""
        gpc = self.config.gp_config
        multi_combo = (
            len(gpc.regr_names) > 1 or len(gpc.corr_names) > 1
        )
        if multi_combo or gpc.n_clusters == 1:
            return False
        if (
            os.environ.get("EGOBOX_NO_FUSED_STEP")
            or os.environ.get("EGOBOX_NO_FUSED_MOE")
            or os.environ.get("EGOR_USE_GP_VAR_PORTFOLIO")
        ):
            return False
        if self.config.q_points != 1 or self.config.coego_n_coop > 1:
            return False
        if fcstrs and not self._fcstrs_traceable(fcstrs):
            return False
        if state.clusterings is None or self.have_to_recluster(state):
            return False
        if len(state.clusterings) != state.y_data.shape[1]:
            return False
        ks = {g.n_clusters for g, _ in state.clusterings}
        recombs = {r for _, r in state.clusterings}
        return len(ks) == 1 and len(recombs) == 1

    def _theta_setup(self, state: EgorState, m: int):
        """Warm-start inits (m, dim) and the theta bounds, as tensors on the
        solver's device; the inits are clipped inside the fused program."""
        dim = self.spec.kpls_dim if self.spec.kpls_dim is not None else self.nx
        theta0s = state.theta_inits
        if theta0s is None or tuple(theta0s.shape) != (m, dim):
            base = (self.theta_init if self.theta_init is not None
                    else np.full((dim,), 0.1))
            theta0s = np.broadcast_to(np.asarray(base), (m, dim)).copy()
        tb = np.asarray(self.theta_bounds, dtype=float)
        if tb.ndim == 1:
            tb = np.broadcast_to(tb[None, :], (dim, 2))
        return (self._tensor(theta0s), self._tensor(tb[:, 0]),
                self._tensor(tb[:, 1]))

    def _fused_statics(self, state: EgorState, crit, cstrat, fcstrs,
                       optimize_theta: bool) -> dict:
        cfg = self.config
        nugget = self.spec.nugget
        if nugget is None:
            nugget = 100.0 * torch.finfo(self.dtype).eps
        feasibility = state.feasibility or not os.environ.get(
            "EGOR_USE_MAX_PROBA_OF_FEASIBILITY"
        )
        return dict(
            corr=self.spec.corr, trend=self.spec.trend,
            kpls_dim=self.spec.kpls_dim,
            gp_n_start=self._gp_n_start(state),
            gp_max_iters=self.spec.max_iters, fixed=not optimize_theta,
            nugget=nugget, ls_batch=self.spec.ls_batch,
            crit=crit, cstr_strategy=cstrat, n_cstr=cfg.n_cstr,
            cstr_infill=cfg.cstr_infill, feasibility=feasibility,
            optimizer=_OPT_NAME[cfg.infill_optimizer],
            fcstr_fns=tuple(fcstrs),
        )

    def _box_inputs(self, state: EgorState, xlimits: np.ndarray,
                    fmin: float, n_fcstr: int) -> dict:
        """The fused programs' box, best value and constraint tolerances,
        on the solver's device."""
        n_cstr = self.config.n_cstr
        return dict(
            lo=self._tensor(xlimits[:, 0]), hi=self._tensor(xlimits[:, 1]),
            fmin=self._tensor(fmin),
            cstr_tols=self._tensor(state.cstr_tol[:n_cstr]),
            fcstr_tols=(self._tensor(state.cstr_tol[n_cstr:n_cstr + n_fcstr])
                        if n_fcstr else None))

    def _select_next_point_fused(
        self,
        state: EgorState,
        fmin: float,
        xlimits: np.ndarray,
        seed_xlimits: Optional[np.ndarray],
        crit: str,
        cstrat: str,
        fcstrs: Sequence[Callable] = (),
        qei: str = "KB",
    ):
        """The whole iteration as one program, one host fetch
        (egobox_tpu's ``_select_next_point_fused``). It takes the draws in
        the order of the unfused path (fit seed from ``state.rng``, scaling
        cloud, multistart seeds), so the two paths see the same numbers.
        For q_points > 1, step 0's seeds come from the host picker and every
        later virtual step's from the traceable picker on the augmented
        design."""
        cfg = self.config
        t0 = time.perf_counter()
        xt, yt = state.x_data, state.y_data
        m = yt.shape[1]
        q = cfg.q_points
        xp, yp, mask = self._pad(xt, yt)
        theta0s, t_lo, t_up = self._theta_setup(state, m)
        optimize_theta = (state.iter % cfg.q_optmod) == 0
        statics = self._fused_statics(state, crit, cstrat, fcstrs,
                                      optimize_theta)
        dim = theta0s.shape[1]
        fit_seed = int(state.rng.integers(0, 2**31))
        n_cloud = min(100 * self.nx, 1000)
        fit_draws = self.draws.fit_draws(fit_seed)
        seeds = ([fit_draws.lhs_seeds(statics["gp_n_start"], dim,
                                      torch.float64, "cpu")
                  for _ in range(q)] if statics["gp_n_start"] > 0 else None)
        clouds = [self.draws.lhs(n_cloud, xlimits, LhsKind.MAXIMIN)
                  for _ in range(q)]
        starts = self._multistart_seeds(state, xt, xlimits, seed_xlimits)
        inputs = dict(xp=xp, yp=yp, mask=mask, theta0s=theta0s,
                      theta_lo=t_lo, theta_up=t_up,
                      **self._box_inputs(state, xlimits, fmin, len(fcstrs)))
        key = (xp.shape, m, self.dtype, q, tuple(sorted(statics.items())))
        if q == 1:
            inputs.update(
                fit_seeds=None if seeds is None else self._tensor(seeds[0]),
                cloud=self._tensor(clouds[0]), starts=self._tensor(starts))
            packed, models = self.graphs.run(
                key, lambda **kw: fused_select_point(**kw, **statics),
                inputs, xp.shape)
            state.theta_inits = models.theta  # stays on the device
            self.last_models = models
            record_gp_models(cfg.outdir, state.iter, models)
            arr = packed.double().cpu().numpy()  # the one host fetch
            self.last_times = {"select": time.perf_counter() - t0,
                               "graph": self.graphs.stats.last}
            return arr[None, :self.nx], np.zeros((1, m)), float(-arr[self.nx])

        use_middle = (
            seed_xlimits is None
            and xlimits is self.xlimits
            and not os.environ.get(
                "EGOR_DO_NOT_USE_MIDDLEPICKER_MULTISTARTER")
        )
        nbuf = xp.shape[0] + q - 1
        picks = [self.draws.picker(nbuf, cfg.n_start, self.nx)
                 for _ in range(q)]
        i_min = int(np.argmin(state.y_data[:, 0]))
        seed_box = seed_xlimits if seed_xlimits is not None else xlimits
        inputs.update(
            fit_seeds=None if seeds is None else self._tensor(np.stack(seeds)),
            clouds=self._tensor(np.stack(clouds)),
            starts0=self._tensor(starts),
            pick_scores=self._tensor(np.stack([p[0] for p in picks])),
            pick_fills=self._tensor(np.stack([p[1] for p in picks])),
            y_best_row=self._tensor(state.y_data[i_min]),
            seed_lo=self._tensor(seed_box[:, 0]),
            seed_hi=self._tensor(seed_box[:, 1]),
        )
        key = key + (qei, use_middle)
        packed, theta_last = self.graphs.run(
            key, lambda **kw: fused_select_points_q(
                **kw, q_points=q, qei=qei, use_middle=use_middle, **statics),
            inputs, xp.shape)
        state.theta_inits = theta_last  # stays on the device
        arr = packed.double().cpu().numpy()  # the one host fetch
        self.last_times = {"select": time.perf_counter() - t0,
                           "graph": self.graphs.stats.last}
        return (arr[:, :self.nx], arr[:, self.nx + 1:],
                float(-arr[0, self.nx]))

    def _select_next_point_fused_moe(
        self,
        state: EgorState,
        fmin: float,
        xlimits: np.ndarray,
        seed_xlimits: Optional[np.ndarray],
        crit: str,
        cstrat: str,
        fcstrs: Sequence[Callable] = (),
    ):
        """The clustered iteration as one program, one host fetch
        (egobox_tpu's ``_select_next_point_fused_moe``): the experts of every
        output and cluster fitted as one stack of masked lanes, the mixture
        infill in the same program. The standing clustering rides in as
        tensor inputs (the GMM, its weights and the heaviside factor), so a
        new clustering replays the same graph on new values; k and the
        recombination are in the graph's signature. The draws are taken in
        egobox_tpu's order: the fit seed from ``state.rng``, the scaling
        cloud, the multistart seeds."""
        cfg = self.config
        t0 = time.perf_counter()
        xt, yt = state.x_data, state.y_data
        m = yt.shape[1]
        xp, yp, mask = self._pad(xt, yt)
        gmxs = tuple(g.to(self.device, self.dtype)
                     for g, _ in state.clusterings)
        k = gmxs[0].n_clusters
        smooth = state.clusterings[0][1] is Recombination.SMOOTH
        _, t_lo, t_up = self._theta_setup(state, m)
        dim = t_lo.shape[0]
        theta0s = state.moe_theta_inits
        if theta0s is None or tuple(theta0s.shape) != (m, k, dim):
            base = (self.theta_init if self.theta_init is not None
                    else np.full((dim,), 0.1))
            theta0s = np.broadcast_to(np.asarray(base), (m, k, dim)).copy()
        optimize_theta = (state.iter % cfg.q_optmod) == 0
        statics = self._fused_statics(state, crit, cstrat, fcstrs,
                                      optimize_theta)
        # egobox_tpu's clustered iteration refits at the full width
        statics["gp_n_start"] = self.spec.n_start
        fit_draws = self.draws.fit_draws(int(state.rng.integers(0, 2**31)))
        seeds = (fit_draws.lhs_seeds(self.spec.n_start, dim, torch.float64,
                                     "cpu")
                 if optimize_theta and self.spec.n_start > 0 else None)
        cloud = self.draws.lhs(min(100 * self.nx, 1000), xlimits,
                               LhsKind.MAXIMIN)
        starts = self._multistart_seeds(state, xt, xlimits, seed_xlimits)
        inputs = dict(
            xp=xp, yp=yp, mask=mask, gmxs=gmxs,
            theta0s=self._tensor(theta0s), theta_lo=t_lo, theta_up=t_up,
            fit_seeds=None if seeds is None else self._tensor(seeds),
            cloud=self._tensor(cloud), starts=self._tensor(starts),
            **self._box_inputs(state, xlimits, fmin, len(fcstrs)))
        key = ("moe", xp.shape, m, k, smooth, self.dtype,
               tuple(sorted(statics.items())))
        packed, models, theta_last = self.graphs.run(
            key, lambda **kw: fused_select_point_moe(
                **kw, k_clusters=k, smooth=smooth, **statics),
            inputs, xp.shape)
        state.moe_theta_inits = theta_last  # stays on the device
        # the host-side expert parameters no longer match the carried
        # thetas: a q_optmod skip on the host path must not reuse them
        state.moe_params = None
        self.last_models = models
        record_gp_models(cfg.outdir, state.iter, models)
        arr = packed.double().cpu().numpy()  # the one host fetch
        self.last_times = {"select": time.perf_counter() - t0,
                           "graph": self.graphs.stats.last}
        return arr[None, :self.nx], np.zeros((1, m)), float(-arr[self.nx])

    def select_next_points(
        self,
        state: EgorState,
        fcstrs: Sequence[Callable] = (),
        init: bool = False,
        xlimits: Optional[np.ndarray] = None,
        seed_xlimits: Optional[np.ndarray] = None,
    ):
        """``seed_xlimits`` restricts only the multistart seed region (the
        TREGO trust region, ref: trego.rs:34-76 LocalLhsMultiStarter) while
        the criterion is still optimized within ``xlimits``; ``xlimits``
        overrides the optimization box itself (mixint subspaces)."""
        cfg = self.config
        xlimits = self.xlimits if xlimits is None else xlimits
        crit = _CRIT_NAME[cfg.infill_strategy]
        cstrat = _CSTR_NAME[cfg.cstr_strategy]
        qei = _QEI_NAME[cfg.q_infill_strategy]
        n_cstr = cfg.n_cstr
        fcstrs = tuple(fcstrs)
        self._iter_dtype = egor_dtype(
            self.device, state.x_data.shape[0] + cfg.q_points - 1)

        if self._fast_path_ok(fcstrs):
            fmin = float(state.y_data[state.best_index, 0])
            return self._select_next_point_fused(
                state, fmin, xlimits, seed_xlimits, crit, cstrat, fcstrs,
                qei)
        if self._fast_path_moe_ok(state, fcstrs):
            fmin = float(state.y_data[state.best_index, 0])
            return self._select_next_point_fused_moe(
                state, fmin, xlimits, seed_xlimits, crit, cstrat, fcstrs)

        surrogate_tols = self._tensor(state.cstr_tol[:n_cstr])

        x_dat: List[np.ndarray] = []
        y_dat: List[np.ndarray] = []
        infill_value = -np.inf

        fmin = float(state.y_data[state.best_index, 0])
        lo = self._tensor(xlimits[:, 0])
        hi = self._tensor(xlimits[:, 1])
        times = {"fit": 0.0, "cloud": 0.0, "infill": 0.0}
        if fcstrs:
            times.update(polish=0.0, polish_evals=0)

        def clock():
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return time.perf_counter()

        if cfg.coego_n_coop > 1:
            # resample the cooperative activity once per iteration so both
            # the partial theta tuning and the partial infill optimization
            # see the same groups (ref: egor_solver.rs:372-377)
            from .coego import get_random_activity

            state.activity = get_random_activity(
                state.rng, self.nx, cfg.coego_n_coop
            )

        for i in range(cfg.q_points):
            if x_dat:
                xt = np.vstack([state.x_data] + x_dat)
                yt = np.vstack([state.y_data] + y_dat)
            else:
                xt, yt = state.x_data, state.y_data

            optimize_theta = (
                (state.iter * cfg.q_points + i) % cfg.q_optmod == 0
            )
            t0 = clock()
            models = self._train(state, xt, yt, optimize_theta)
            t1 = clock()

            # scaling cloud (ref: solver_computations.rs:132-193)
            npts = min(100 * self.nx, 1000)
            cloud = self._tensor(self._lhs(npts, LhsKind.MAXIMIN))
            scale_infill, scale_cstr, scale_wb2 = compute_scaling(
                models, cloud, fmin, surrogate_tols,
                crit=crit, n_cstr=n_cstr, cstr_infill=cfg.cstr_infill,
            )
            t2 = clock()

            starts = self._tensor(
                self._multistart_seeds(state, xt, xlimits, seed_xlimits)
            )

            # feasibility-first search when no feasible point exists yet
            # (env-gated like the reference:
            # EGOR_USE_MAX_PROBA_OF_FEASIBILITY, utils/mod.rs:22-48)
            feasibility = state.feasibility or not os.environ.get(
                "EGOR_USE_MAX_PROBA_OF_FEASIBILITY"
            )
            # no function constraint enters the optimizer here: they join
            # through the polish below, as on egobox_tpu's host path
            crit_kwargs = dict(
                fmin=fmin, scale_infill=scale_infill, scale_wb2=scale_wb2,
                scale_cstr=scale_cstr, cstr_tols=surrogate_tols,
                crit=crit, cstr_strategy=cstrat, n_cstr=n_cstr,
                cstr_infill=cfg.cstr_infill, feasibility=feasibility,
                optimizer=_OPT_NAME[cfg.infill_optimizer],
            )
            if (
                os.environ.get("EGOR_USE_GP_VAR_PORTFOLIO")
                and cfg.q_points == 1
            ):
                # sigma-weight portfolio: re-optimize the criterion with 13
                # log-spaced weights on the GP std, DBSCAN-cluster the
                # proposals, evaluate one representative per cluster
                # (ref: solver_impl.rs:585-610, utils/portfolio.rs)
                from .portfolio import SIGMA_WEIGHTS, select_from_portfolio

                props = []
                for sw in SIGMA_WEIGHTS:
                    s_inf, s_cstr, s_wb2 = compute_scaling(
                        models, cloud, fmin, surrogate_tols, sw,
                        crit=crit, n_cstr=n_cstr,
                        cstr_infill=cfg.cstr_infill,
                    )
                    xk_w, _, _ = optimize_infill(
                        models, starts, lo, hi, fmin, s_inf, s_wb2,
                        s_cstr, surrogate_tols, sw,
                        crit=crit, cstr_strategy=cstrat, n_cstr=n_cstr,
                        cstr_infill=cfg.cstr_infill,
                        feasibility=feasibility,
                        optimizer=_OPT_NAME[cfg.infill_optimizer],
                    )
                    props.append(xk_w)
                props = torch.stack(props).double().cpu().numpy()
                keep_idx = select_from_portfolio(props)
                i_min = int(np.argmin(state.y_data[:, 0]))
                y_best = self._tensor(state.y_data[i_min])
                for ki in keep_idx:
                    yk_i = virtual_point(models, self._tensor(props[ki]),
                                         y_best, strategy=qei)
                    x_dat.append(props[ki][None, :])
                    y_dat.append(yk_i.double().cpu().numpy()[None, :])
                infill_value = np.nan
                times["infill"] += clock() - t2
                times["fit"] += t1 - t0
                times["cloud"] += t2 - t1
                break  # portfolio replaces the q_points loop

            if cfg.coego_n_coop > 1:
                # cooperative partial optimization for high dimensions
                # (ref: coego.rs; the per-iteration activity was sampled
                # above, before surrogate training)
                from .coego import coego_optimize_infill

                starts_np = starts.double().cpu().numpy()
                xb, yb, cb = state.best()
                xk_np, fk = coego_optimize_infill(
                    self, models, (xb, yb, cb), state.activity,
                    lambda: starts_np, xlimits[:, 0], xlimits[:, 1],
                    crit_kwargs,
                    cstr_tols=state.cstr_tol,
                    fcstrs=fcstrs,
                )
                infill_value = float(-fk)
            else:
                xk, fk, _ = optimize_infill(
                    models, starts, lo, hi, **crit_kwargs
                )
                packed = torch.cat([xk, fk.reshape(1)]).double().cpu()
                xk_np = packed[:-1].numpy()
                infill_value = float(-packed[-1])
            t3 = clock()

            if fcstrs:
                # user function constraints join the optimization through
                # a native derivative-free polish around the optimum
                # (ref: cstr_funcs threading, solver_impl.rs:716-741;
                # scaling solver_computations.rs:181-189)
                stats = {}
                xk_np = self._fcstr_polish(xk_np, models, fcstrs, cloud,
                                           crit_kwargs, xlimits, stats)
                times["polish"] += clock() - t3
                times["polish_evals"] += stats["evals"]

            i_min = int(np.argmin(state.y_data[:, 0]))
            yk = virtual_point(
                models, self._tensor(xk_np),
                self._tensor(state.y_data[i_min]), strategy=qei,
            )
            x_dat.append(np.asarray(xk_np, dtype=float)[None, :])
            y_dat.append(yk.double().cpu().numpy()[None, :])
            t4 = clock()
            times["fit"] += t1 - t0
            times["cloud"] += t2 - t1
            times["infill"] += t4 - t2

        self.last_times = times
        return np.vstack(x_dat), np.vstack(y_dat), infill_value

    # ------------------------------------------------------------------
    # one EGO iteration (ref: ego_step, solver_impl.rs:398-555)
    # ------------------------------------------------------------------

    def ego_step(
        self,
        state: EgorState,
        fobj: Callable[[np.ndarray], np.ndarray],
        fcstrs: Sequence[Callable] = (),
        xlimits: Optional[np.ndarray] = None,
    ) -> EgorState:
        t_start = time.perf_counter()
        while True:
            x_dat, _, infill_value = self.select_next_points(
                state, fcstrs, init=(state.iter == 0), xlimits=xlimits
            )
            x_dat = self._cast(x_dat)
            keep = [
                i
                for i in range(x_dat.shape[0])
                if self._is_new(state.x_data, x_dat[i])
            ]
            if keep:
                break
            state.no_point_added_retries -= 1
            if state.no_point_added_retries <= 0:
                raise NoMorePointToAddError(
                    "max retries without adding a point: converged"
                )

        x_new = x_dat[keep]
        y_new = np.atleast_2d(np.asarray(fobj(x_new), dtype=float))
        y_new = self._impute_failures(state, y_new)
        c_new = self._eval_fcstrs(fcstrs, x_new)

        offset = state.x_data.shape[0]
        state.x_data = np.vstack([state.x_data, x_new])
        state.y_data = np.vstack([state.y_data, y_new])
        state.c_data = np.vstack([state.c_data, c_new])

        state.prev_added = state.added
        state.added += x_new.shape[0]
        state.no_point_added_retries = MAX_POINT_ADDITION_RETRY

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
        logger.info(
            "iter %d: +%d point(s), total %d, best y=%.6g, infill=%.4g "
            "(%.2fs)",
            state.iter, x_new.shape[0], state.x_data.shape[0],
            state.y_data[best, 0], infill_value,
            time.perf_counter() - t_start,
        )
        return state

    def _fcstr_polish(self, xk: np.ndarray, models, fcstrs, cloud,
                      crit_kwargs: dict, xlimits: np.ndarray,
                      stats: Optional[dict] = None) -> np.ndarray:
        """Native derivative-free local polish honoring user function
        constraints g_i(x) <= cstr_tol (host callbacks cannot enter the
        device optimizer). Surrogate constraints stay active via their
        scaled means (ref: InfillOptProblem, solver_infill_optim.rs).

        Each Nelder-Mead evaluation is one posterior evaluation on the
        solver's device and one host read of the packed (objective,
        constraint means); the penalized function asks for the objective
        and every surrogate constraint at the same point, which reuse that
        one read (the values are the same). ``stats`` (a dict) receives the
        evaluations made (``evals``), which is also the polish's count of
        host reads."""
        from ..native import minimize_dfo_constrained
        from .infill_optim import eval_infill_and_cstrs

        n_cstr = crit_kwargs["n_cstr"]
        scale_cstr_np = crit_kwargs["scale_cstr"].double().cpu().numpy()

        # scale for the function constraints: max |g| over the scaling
        # cloud (ref: solver_computations.rs:181-189)
        cloud_np = cloud.double().cpu().numpy()
        cloud_np = cloud_np[:: max(1, cloud_np.shape[0] // 100)]
        fvals = self._eval_fcstrs(fcstrs, cloud_np)
        scale_fc = np.maximum(np.max(np.abs(fvals), axis=0), 1e-12)

        last = {"x": None, "vals": None, "evals": 0}

        def obj_and_cstrs(x):
            """(objective, surrogate constraint means) at x, as numpy; the
            last point's values are kept."""
            if last["x"] is not None and np.array_equal(last["x"], x):
                return last["vals"]
            o, m = eval_infill_and_cstrs(
                models, self._tensor(x), crit_kwargs["fmin"],
                crit_kwargs["scale_infill"], crit_kwargs["scale_wb2"],
                crit_kwargs["cstr_tols"],
                crit=crit_kwargs["crit"],
                cstr_infill=crit_kwargs["cstr_infill"],
                feasibility=crit_kwargs["feasibility"],
            )
            vals = torch.cat([o.reshape(1), m.reshape(-1)]).double().cpu()
            last.update(x=np.array(x), vals=vals.numpy(),
                        evals=last["evals"] + 1)
            return last["vals"]

        def fun(x):
            return float(obj_and_cstrs(x)[0])

        cstr_list = []
        for i in range(n_cstr):
            def surr_c(x, _i=i):
                # target g <= 0 unshifted; tol is acceptance slack only
                # (ref: optimizers/optimizer.rs:108, see infill_optim)
                return float(obj_and_cstrs(x)[1 + _i]) / scale_cstr_np[_i]

            cstr_list.append(surr_c)
        for j, fc in enumerate(fcstrs):
            def user_c(x, _fc=fc, _s=scale_fc[j]):
                return float(_fc(torch.as_tensor(x))) / _s

            cstr_list.append(user_c)

        x_pol, _ = minimize_dfo_constrained(
            fun, cstr_list, np.asarray(xk, dtype=float), xlimits[:, 0],
            xlimits[:, 1], max_eval=400, n_penalty_rounds=3,
        )
        if stats is not None:
            stats["evals"] = last["evals"]
        return x_pol

    @staticmethod
    def _impute_failures(state: EgorState, y_new: np.ndarray) -> np.ndarray:
        """Failed objective evaluations (NaN/inf) would poison the GP
        normalization; impute them with a worst-observed penalty per column
        so the surrogate learns to avoid the region."""
        return impute_failed_values(y_new, state.y_data)

    @staticmethod
    def _is_new(x_data: np.ndarray, x: np.ndarray) -> bool:
        """L1 de-dup rule (ref: utils/misc.rs:44-53)."""
        d = np.sum(np.abs(x_data - x[None, :]), axis=1)
        return bool(np.all(d >= 100.0 * np.finfo(float).eps))

    # ------------------------------------------------------------------
    # ask-and-tell (ref: EgorService suggest, solver_impl.rs:56-101)
    # ------------------------------------------------------------------

    def suggest(self, x_doe: np.ndarray, y_doe: np.ndarray,
                fcstrs: Sequence[Callable] = ()) -> np.ndarray:
        cfg = self.config
        x_doe = np.atleast_2d(np.asarray(x_doe, dtype=float))
        y_doe = np.atleast_2d(np.asarray(y_doe, dtype=float))
        c_data = self._eval_fcstrs(fcstrs, x_doe)
        cstr_tol = cfg.resolved_cstr_tol(len(fcstrs))
        best = find_best_result_index(y_doe, c_data, cstr_tol)
        state = EgorState(
            x_data=x_doe,
            y_data=y_doe,
            c_data=c_data,
            cstr_tol=cstr_tol,
            best_index=best,
            rng=np.random.default_rng(cfg.seed),
        )
        x_dat, _, _ = self.select_next_points(state, fcstrs, init=True)
        return self._cast(x_dat)
