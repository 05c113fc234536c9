"""Egor: the user-facing Bayesian optimizer (port of
egobox_tpu/ego/egor.py).

API parity with the egobox Python class (ref: python/src/egor.rs:156-425 and
crates/ego/src/egor.rs:142-330): ``Egor(xspecs, ...).minimize(fun, ...)``,
ask-and-tell ``suggest``, ``get_result(_index)``. The objective ``fun`` maps
an (n, nx) numpy batch to an (n, 1 + n_cstr) batch of [obj, cstr...] columns.
Data goes in and comes out as numpy; the surrogates and the infill
optimization run on ``device`` (default: the GPU, and a host without one
raises; ``device="cpu"`` runs on the CPU) in ``dtype`` (default:
``config.egor_dtype``).

``traced_run=True`` (or ``EGOBOX_TRACED_RUN=1``; ``=0`` refuses it) runs
the whole loop on the device when ``fun`` is written in torch operations
(an (n, nx) tensor in, an (n, 1 + n_cstr) tensor out): ego/fused_run.py.
Any other objective takes the host loop, as in egobox_tpu.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..types import (
    ConstraintStrategy,
    CorrelationSpec,
    InfillOptimizer,
    InfillStrategy,
    OptimResult,
    QInfillStrategy,
    RegressionSpec,
)
from .config import EgorConfig, GpConfig, TregoConfig
from .find_result import find_best_result_index
from .mixint import MixintContext, parse_xspecs
from .recorders import RunRecorder, run_recorder_enabled
from .solver import EgorSolver, NoMorePointToAddError
from .state import EgorState
from .trego import trego_step

EGOR_DOE_FILE = "egor_doe.npy"
EGOR_INITIAL_DOE_FILE = "egor_initial_doe.npy"
EGOR_HISTORY_FILE = "egor_history.npy"
EGOR_CONFIG_FILE = "egor_config.json"
EGOR_CHECKPOINT_FILE = "egor_checkpoint.json"


class Egor:
    """Efficient global optimizer (ref: python/src/egor.rs:156-231)."""

    def __init__(
        self,
        xspecs,
        gp_config: Optional[GpConfig] = None,
        n_cstr: int = 0,
        cstr_tol: Optional[Sequence[float]] = None,
        n_start: int = 20,
        n_doe: int = 0,
        doe: Optional[np.ndarray] = None,
        regr_spec: RegressionSpec = RegressionSpec.CONSTANT,
        corr_spec: CorrelationSpec = CorrelationSpec.SQUARED_EXPONENTIAL,
        infill_strategy: InfillStrategy = InfillStrategy.LOG_EI,
        cstr_infill: bool = False,
        cstr_strategy: ConstraintStrategy = ConstraintStrategy.MC,
        q_points: int = 1,
        q_infill_strategy: QInfillStrategy = QInfillStrategy.KB,
        infill_optimizer: InfillOptimizer = InfillOptimizer.COBYLA,
        kpls_dim: Optional[int] = None,
        trego: bool = False,
        coego_n_coop: int = 0,
        n_clusters: int = 1,
        q_optmod: int = 1,
        warm_refit_n_start: Optional[int] = 4,
        target: float = -np.inf,
        outdir: Optional[str] = None,
        warm_start: bool = False,
        hot_start: Optional[int] = None,
        seed: Optional[int] = None,
        traced_run: bool = False,
        device=None,
        dtype=None,
    ):
        self.traced_run = traced_run
        self.xspecs = parse_xspecs(xspecs)
        self.mixint = MixintContext(self.xspecs)
        if gp_config is None:
            gp_config = GpConfig(
                regr_spec=regr_spec,
                corr_spec=corr_spec,
                kpls_dim=kpls_dim,
                n_clusters=n_clusters,
            )
        self.config = EgorConfig(
            n_start=n_start,
            n_doe=n_doe,
            doe=doe,
            n_cstr=n_cstr,
            cstr_tol=None if cstr_tol is None else np.asarray(cstr_tol),
            cstr_infill=cstr_infill,
            cstr_strategy=cstr_strategy,
            infill_strategy=infill_strategy,
            q_points=q_points,
            q_infill_strategy=q_infill_strategy,
            q_optmod=q_optmod,
            warm_refit_n_start=warm_refit_n_start,
            infill_optimizer=infill_optimizer,
            gp_config=gp_config,
            target=target,
            outdir=outdir,
            warm_start=warm_start,
            hot_start=hot_start,
            seed=seed,
            trego=TregoConfig(activated=trego),
            coego_n_coop=coego_n_coop,
        )
        self.solver = EgorSolver(
            self.config, self.mixint.continuous_xlimits(), device=device,
            dtype=dtype,
        )
        #: seconds of every iteration of the last ``minimize``: the whole
        #: step, and the solver's split into fit, cloud and infill
        self.iteration_times = []

    # ------------------------------------------------------------------

    def _wrap_fun(self, fun: Callable) -> Callable:
        """Evaluate the user's objective in the folded/discrete space while
        the solver works in continuous-relaxed space
        (ref: solver_computations.rs:478-529)."""

        def wrapped(x_cont: np.ndarray) -> np.ndarray:
            x_user = self.mixint.to_discrete_space(x_cont)
            return np.asarray(fun(x_user), dtype=float)

        return wrapped

    def _wrap_cstr(self, c: Callable) -> Callable:
        if not self.mixint.is_discrete:
            # continuous space: pass the user's callable through unchanged
            # so constraints written in torch operations can enter the
            # optimizer (solver._fcstrs_traceable)
            return c

        def wrapped(x_cont: np.ndarray) -> float:
            x_user = self.mixint.to_discrete_space(
                np.atleast_2d(x_cont)
            )[0]
            return float(c(x_user))

        return wrapped

    def minimize(
        self,
        fun: Callable,
        fcstrs: Sequence[Callable] = (),
        max_iters: int = 20,
        run_info=None,
    ) -> OptimResult:
        cfg = self.config
        solver = self.solver
        wcstrs = [self._wrap_cstr(c) for c in fcstrs]
        outdir = cfg.outdir
        traced = self._use_traced_run(fun, wcstrs, outdir)
        if traced:
            # the initial DoE goes through the same torch objective
            def wfun(x):
                xt = torch.as_tensor(x, dtype=solver.dtype,
                                     device=solver.device)
                with torch.no_grad():
                    return fun(xt).double().cpu().numpy()
        else:
            wfun = self._wrap_fun(fun)

        if outdir:
            os.makedirs(outdir, exist_ok=True)
            self._dump_config(outdir, max_iters)

        state, start_iter = self._init_or_resume(
            wfun, wcstrs, outdir, max_iters
        )
        if cfg.hot_start is not None and cfg.hot_start > 0:
            max_iters += int(cfg.hot_start)

        self.iteration_times = []
        if traced:
            from .fused_run import run_traced

            state = run_traced(solver, state, fun, max_iters, fcstrs=wcstrs)
            self.iteration_times = solver.last_times["chunks"]
            return self._result(state)

        recorder = None
        if run_recorder_enabled():
            # structured benchmark-format run log
            # (ref: utils/run_recorder.rs, hooks egor.rs:299-318)
            # run_info carries (fname, num) metadata into the run log
            # (ref: egor.rs:299-318 test_function / replication_number)
            recorder = RunRecorder(
                problem_metadata={
                    "dim": self.solver.nx,
                    "n_cstr": cfg.n_cstr,
                    "xlimits": self.solver.xlimits.tolist(),
                    "test_function": "" if run_info is None
                    else str(getattr(run_info, "fname", run_info)),
                    "replication_number": 0 if run_info is None
                    else int(getattr(run_info, "num", 0)),
                },
                algorithm_parameters={
                    "max_iters": max_iters,
                    "n_start": cfg.n_start,
                    "infill_strategy": cfg.infill_strategy.value,
                    "q_points": cfg.q_points,
                    "trego": cfg.trego.activated,
                    "seed": cfg.seed,
                },
            )

        history = []
        for it in range(start_iter, max_iters):
            t_iter = time.perf_counter()
            try:
                if cfg.trego.activated:
                    state = trego_step(solver, state, wfun, wcstrs)
                else:
                    state = solver.ego_step(state, wfun, wcstrs)
            except NoMorePointToAddError:
                break
            self.iteration_times.append(
                dict(solver.last_times,
                     total=time.perf_counter() - t_iter))
            xb, yb, _ = state.best()
            history.append(np.concatenate([[yb[0]], xb]))
            if recorder is not None:
                recorder.record_iteration(
                    it, state.x_data[-1:], state.y_data[-1:], xb, yb
                )
            if outdir:
                self._observe(outdir, state, history)
            if yb[0] < cfg.target:
                break

        if recorder is not None and outdir:
            recorder.save(outdir)
        return self._result(state)

    def _use_traced_run(self, fun, fcstrs, outdir) -> bool:
        """The gate of the whole-run mode (ego/fused_run.py): asked for
        (``traced_run=True`` or ``EGOBOX_TRACED_RUN=1``, and not
        ``EGOBOX_TRACED_RUN=0``), a continuous problem on the fused path
        with no per-iteration host needs (observers, recorders), function
        constraints in torch operations, and an objective that maps a
        (1, nx) tensor on the solver's device to a (1, 1 + n_cstr) tensor
        (probed once, at the middle of the box). A numpy objective, a host
        callback, takes the host loop."""
        env = os.environ.get("EGOBOX_TRACED_RUN")
        if not ((self.traced_run or env == "1") and env != "0"):
            return False
        solver = self.solver
        if fcstrs and not solver._fcstrs_traceable(tuple(fcstrs)):
            return False
        if (
            outdir
            or self.mixint.is_discrete
            or run_recorder_enabled()
            or os.environ.get("EGOR_USE_GP_RECORDER")
            or not solver._fast_path_ok(())
        ):
            return False
        probe = torch.as_tensor(solver.xlimits.mean(axis=1)[None, :],
                                dtype=solver.dtype, device=solver.device)
        try:
            with torch.no_grad():
                out = fun(probe)
        except (TypeError, ValueError, RuntimeError, AttributeError,
                IndexError):
            # e.g. numpy refusing a GPU tensor: a host callback
            return False
        return (isinstance(out, torch.Tensor)
                and tuple(out.shape) == (1, 1 + self.config.n_cstr))

    def _init_or_resume(self, wfun, wcstrs, outdir, max_iters):
        cfg = self.config
        # hot start: full state checkpoint (ref: utils/hot_start.rs:82-141)
        if cfg.hot_start is not None and outdir:
            ckpt = os.path.join(outdir, EGOR_CHECKPOINT_FILE)
            if os.path.exists(ckpt):
                with open(ckpt) as f:
                    state = EgorState.from_dict(json.load(f))
                return state, state.iter
        # warm start: reload evaluated DoE, falling back to the initial-DoE
        # snapshot when only that exists — the reference reads BOTH files
        # (ref: egor_solver.rs:192-224 egor_doe.npy then
        # egor_initial_doe.npy)
        doe = None
        y_doe = None
        if cfg.warm_start and outdir:
            for fname in (EGOR_DOE_FILE, EGOR_INITIAL_DOE_FILE):
                doe_path = os.path.join(outdir, fname)
                if os.path.exists(doe_path):
                    data = np.load(doe_path)
                    nx = self.solver.nx
                    doe = data[:, :nx]
                    y_doe = data[:, nx : nx + 1 + cfg.n_cstr]
                    break
        state = self.solver.init_state(wfun, wcstrs, doe=doe, y_doe=y_doe)
        if outdir:
            np.save(
                os.path.join(outdir, EGOR_INITIAL_DOE_FILE),
                np.hstack([state.x_data, state.y_data]),
            )
        return state, 0

    def _observe(self, outdir, state: EgorState, history):
        """Optimization observer (ref: egor.rs:336-394)."""
        np.save(
            os.path.join(outdir, EGOR_DOE_FILE),
            np.hstack([state.x_data, state.y_data]),
        )
        np.save(
            os.path.join(outdir, EGOR_HISTORY_FILE), np.asarray(history)
        )
        if self.config.hot_start is not None:
            with open(
                os.path.join(outdir, EGOR_CHECKPOINT_FILE), "w"
            ) as f:
                json.dump(state.to_dict(), f)

    def _dump_config(self, outdir, max_iters):
        """Serialize the ENTIRE config (ref: egor.rs:234-239 dumps the full
        EgorConfig) so a run is reproducible from its artifacts alone."""
        cfg = self.config
        gpc = cfg.gp_config
        payload = {
            "max_iters": max_iters,
            "n_cstr": cfg.n_cstr,
            "cstr_tol": None if cfg.cstr_tol is None
            else np.asarray(cfg.cstr_tol, dtype=float).tolist(),
            "cstr_infill": cfg.cstr_infill,
            "cstr_strategy": cfg.cstr_strategy.value,
            "n_start": cfg.n_start,
            "n_doe": cfg.n_doe,
            "infill_strategy": cfg.infill_strategy.value,
            "infill_optimizer": cfg.infill_optimizer.value,
            "q_points": cfg.q_points,
            "q_infill_strategy": cfg.q_infill_strategy.value,
            "q_optmod": cfg.q_optmod,
            "target": None if not np.isfinite(cfg.target)
            else float(cfg.target),
            "warm_start": cfg.warm_start,
            "hot_start": cfg.hot_start,
            "seed": cfg.seed,
            "coego_n_coop": cfg.coego_n_coop,
            "coego_partial_theta_tuning": cfg.coego_partial_theta_tuning,
            "shape_bucket": cfg.shape_bucket,
            "trego": {
                "activated": cfg.trego.activated,
                "n_local_steps": cfg.trego.n_local_steps,
                "d": list(cfg.trego.d),
                "beta": cfg.trego.beta,
                "gamma": cfg.trego.gamma,
                "sigma0": cfg.trego.sigma0,
            },
            "gp_config": {
                "regr_spec": gpc.regr_spec.value,
                "corr_spec": gpc.corr_spec.value,
                "kpls_dim": gpc.kpls_dim,
                "n_clusters": gpc.n_clusters,
                "recombination": gpc.recombination.value,
                "theta_init": None if gpc.theta_init is None
                else np.asarray(gpc.theta_init, dtype=float).tolist(),
                "theta_bounds": None if gpc.theta_bounds is None
                else np.asarray(gpc.theta_bounds, dtype=float).tolist(),
                "n_start": gpc.n_start,
                "max_eval": gpc.max_eval,
            },
            "xspecs": [
                {"xtype": s.xtype.value,
                 "xlimits": np.asarray(s.xlimits, dtype=float).tolist(),
                 "tags": list(getattr(s, "tags", []) or [])}
                for s in self.xspecs
            ],
        }
        with open(os.path.join(outdir, EGOR_CONFIG_FILE), "w") as f:
            json.dump(payload, f, indent=2)

    def _result(self, state: EgorState) -> OptimResult:
        xb, yb, _ = state.best()
        x_doe = self.mixint.to_discrete_space(state.x_data)
        return OptimResult(
            x_opt=self.mixint.to_discrete_space(xb[None, :])[0],
            y_opt=yb,
            x_doe=x_doe,
            y_doe=state.y_data,
        )

    # ------------------------------------------------------------------
    # ask-and-tell (ref: python/src/egor.rs:348-367)
    # ------------------------------------------------------------------

    def suggest(self, x_doe, y_doe) -> np.ndarray:
        x_cont = self.mixint.to_continuous_space(
            np.atleast_2d(np.asarray(x_doe, dtype=float))
        )
        x_next = self.solver.suggest(x_cont, y_doe)
        return self.mixint.to_discrete_space(x_next)

    def get_result_index(self, y_doe) -> int:
        y = np.atleast_2d(np.asarray(y_doe, dtype=float))
        return find_best_result_index(
            y, np.zeros((y.shape[0], 0)),
            self.config.resolved_cstr_tol(0),
        )

    def get_result(self, x_doe, y_doe) -> OptimResult:
        x = np.atleast_2d(np.asarray(x_doe, dtype=float))
        y = np.atleast_2d(np.asarray(y_doe, dtype=float))
        idx = self.get_result_index(y)
        return OptimResult(
            x_opt=x[idx], y_opt=y[idx], x_doe=x, y_doe=y
        )
