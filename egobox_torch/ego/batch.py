"""EgorBatch: B independent EGO optimizations advancing in lockstep (port of
egobox_tpu/ego/batch.py).

The fused iteration (ego/fused_step.py ``fused_select_point_batch``) takes
a leading problem axis: the B problems' fits are one lockstep stack and
their infill starts one set of lanes, so a portfolio of optimizations costs
the launches of one, and on the GPU one CUDA-graph replay per iteration
(ego/graphs.py) with one host fetch of the B proposals.

Scope, as egobox_tpu's: single-cluster GP surrogates, EI / LogEI / WB2 /
WB2S infill, surrogate constraints (MC / UTB or cstr_infill), q_points = 1,
continuous or mixed-integer variables (one XSpec list shared by every
problem). Problems share nx, n_cstr and the iteration budget; xlimits may
differ per problem. ``EGOR_USE_MAX_PROBA_OF_FEASIBILITY`` gives every
problem its own feasibility-first switch. ``mesh`` (an
``egobox_torch.parallel`` ``Mesh``) splits the problem axis over its
ranks: every rank keeps the whole host state and draws every problem's
draws as the run without a mesh does, runs the fused program on its
contiguous block of the problems, and the proposals are gathered; only
rank 0 calls the objective, and broadcasts its values.

Divergence from the single-problem solver, as in egobox_tpu: the picker's
LHS completion takes the first rows of one n_start-point maximin pool per
problem rather than a fresh LHS of the missing size.
"""

from __future__ import annotations

import os
import time
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from ..config import egor_dtype, resolve_device
from ..doe.lhs import LhsKind
from ..gp.kernels import theta_bounds_heuristic
from ..types import (
    ConstraintStrategy,
    InfillOptimizer,
    InfillStrategy,
    OptimResult,
)
from .config import MAX_POINT_ADDITION_RETRY, EgorConfig, GpConfig
from .find_result import find_best_result_index, is_feasible
from .fused_step import fused_select_point_batch
from .graphs import GraphCache
from .solver import (
    _CRIT_NAME,
    _CSTR_NAME,
    _OPT_NAME,
    SolverDraws,
    _bucket,
    impute_failed_values,
)
from .start_points import middle_picker_starts
from .surrogates import GpSpec

#: the inputs of the fused batch program with a leading lane axis
_LANE_INPUTS = ("xp", "yp", "mask", "theta0s", "fit_seeds", "clouds",
                "starts", "lo", "hi", "fmin", "feas_flags")


class EgorBatch:
    """Batched Egor over B independent problems.

    ``fobj`` is either a batched callable mapping (B, nx) -> (B, 1 + n_cstr)
    (one point per problem per call) or a list of B per-problem callables,
    each mapping (n, nx) -> (n, 1 + n_cstr); numpy in, numpy out. The
    surrogates and the infill run on ``device`` (default: the GPU, and a
    host without one raises; ``"cpu"`` for the CPU) in ``dtype`` (default:
    ``config.egor_dtype``). With a ``mesh`` every rank of it builds the
    solver and calls ``minimize``; B must be divisible by the mesh size,
    the device defaults to the mesh's, and the objective runs on rank 0
    only (its values are broadcast).
    """

    def __init__(
        self,
        fobj: Union[Callable, Sequence[Callable]],
        xlimits,  # (nx, 2) shared, (B, nx, 2), or a list of XSpec
        n_problems: Optional[int] = None,
        n_cstr: int = 0,
        cstr_tol: Optional[Sequence[float]] = None,
        n_start: int = 20,
        n_doe: int = 0,
        infill_strategy: InfillStrategy = InfillStrategy.LOG_EI,
        cstr_strategy: ConstraintStrategy = ConstraintStrategy.MC,
        cstr_infill: bool = False,
        infill_optimizer: InfillOptimizer = InfillOptimizer.COBYLA,
        gp_config: Optional[GpConfig] = None,
        seed: Optional[int] = None,
        mesh=None,
        device=None,
        dtype=None,
    ):
        from ..types import XSpec
        from .mixint import MixintContext, parse_xspecs

        if mesh is not None:
            from ..parallel.sharding import Mesh

            if not isinstance(mesh, Mesh):
                raise TypeError("EgorBatch: mesh must be an "
                                "egobox_torch.parallel Mesh, got "
                                f"{type(mesh).__name__}")
            if device is None:
                device = mesh.device
        self._mesh = mesh
        self.device = resolve_device(device)
        self._dtype = dtype
        self._iter_dtype = egor_dtype(self.device, 0)
        # mixed-integer portfolios: one XSpec list for every problem
        self.mixint = None
        if (not isinstance(xlimits, np.ndarray)
                and any(isinstance(s, XSpec) for s in xlimits)):
            self.mixint = MixintContext(parse_xspecs(xlimits))
            xlimits = self.mixint.continuous_xlimits()

        if callable(fobj):
            if n_problems is None:
                xl = np.asarray(xlimits, dtype=float)
                if xl.ndim != 3:
                    raise ValueError(
                        "n_problems is required with a batched fobj and "
                        "shared xlimits"
                    )
                n_problems = xl.shape[0]
            self._fobjs = None
            self._fobj_batched = fobj
        else:
            self._fobjs = list(fobj)
            self._fobj_batched = None
            n_problems = len(self._fobjs)
        self.n_problems = n_problems
        if mesh is not None and n_problems % mesh.size != 0:
            raise ValueError(
                f"EgorBatch: {n_problems} problems must be divisible by the "
                f"{mesh.size}-rank mesh")

        xl = np.asarray(xlimits, dtype=float)
        if xl.ndim == 2:
            xl = np.broadcast_to(xl, (n_problems,) + xl.shape).copy()
        if xl.shape[0] != n_problems:
            raise ValueError("xlimits batch size != n_problems")
        self.xlimits = xl  # (B, nx, 2)
        self.nx = xl.shape[1]

        self.config = EgorConfig(
            n_cstr=n_cstr,
            cstr_tol=None if cstr_tol is None else np.asarray(cstr_tol),
            n_start=n_start,
            n_doe=n_doe,
            infill_strategy=infill_strategy,
            cstr_strategy=cstr_strategy,
            cstr_infill=cstr_infill,
            infill_optimizer=infill_optimizer,
            gp_config=gp_config or GpConfig(),
            seed=seed,
        ).check()
        gpc = self.config.gp_config
        if gpc.n_clusters != 1 or len(gpc.regr_names) > 1 or len(
            gpc.corr_names
        ) > 1:
            raise ValueError(
                "EgorBatch supports the single-cluster GP surrogate path"
            )
        if gpc.kpls_dim is not None:
            raise ValueError("EgorBatch takes identity KPLS weights only")
        dim = self.nx
        corr = gpc.corr_names[0]
        if gpc.theta_bounds is not None:
            self.theta_bounds = np.asarray(gpc.theta_bounds, dtype=float)
        elif dim >= 10:
            lo, up = theta_bounds_heuristic(corr, dim)
            self.theta_bounds = np.array([float(lo), float(up)])
        else:
            self.theta_bounds = np.array([1e-2, 1e1])
        self._dim = dim
        self._seed = seed if seed is not None else 0
        #: every draw that is not a problem's own (initial DoEs, scaling
        #: clouds, seed pools); tests may replace it
        self.draws = SolverDraws(self._seed)
        self._rngs = [
            np.random.default_rng(self._seed + 1000 * b)
            for b in range(n_problems)
        ]
        # per-problem convergence (retry-then-converge,
        # solver_impl.rs:505-515): converged slots stop proposing
        self._max_retries = MAX_POINT_ADDITION_RETRY
        self.converged = np.zeros(n_problems, dtype=bool)
        self._retries = np.full(n_problems, self._max_retries)
        # lane compaction: once problems converge, the program runs over a
        # power-of-two sub-batch of the live ones (EGOBOX_NO_BATCH_COMPACTION
        # turns it off)
        self._compactions = 0
        self.graphs = GraphCache()
        #: seconds of every iteration of the last ``minimize``
        self.iteration_times = []

    @property
    def dtype(self) -> torch.dtype:
        return self._dtype or self._iter_dtype

    def _tensor(self, a) -> torch.Tensor:
        a = np.asarray(a)
        if not a.flags.writeable:
            a = a.copy()
        return torch.as_tensor(a, dtype=self.dtype).to(self.device,
                                                       non_blocking=True)

    def _cast(self, x: np.ndarray) -> np.ndarray:
        """Snap continuous-relaxed proposals onto valid discrete values
        (identity for continuous portfolios)."""
        if self.mixint is None:
            return x
        return self.mixint.cast_continuous(np.atleast_2d(x))

    def _to_user(self, x: np.ndarray) -> np.ndarray:
        if self.mixint is None:
            return x
        return self.mixint.to_discrete_space(np.atleast_2d(x))

    # ------------------------------------------------------------------

    def _from_rank0(self, fn, shape) -> np.ndarray:
        """``fn()`` (float values of ``shape``); with a mesh, rank 0 calls
        it and broadcasts the values, so the objective runs once."""
        if self._mesh is None:
            return fn()
        from ..parallel import _comm

        buf = torch.empty(shape, dtype=torch.float64,
                          device=self._mesh.device)
        if self._mesh.rank == 0:
            buf = torch.as_tensor(
                np.asarray(fn(), dtype=float).reshape(shape)).to(buf.device)
        return _comm.broadcast(self._mesh, buf, 0).cpu().numpy()

    def _call(self, x: np.ndarray) -> np.ndarray:
        xu = self._to_user(x)
        if self._fobj_batched is not None:
            y = np.asarray(self._fobj_batched(xu), dtype=float)
            return y.reshape(self.n_problems, 1 + self.config.n_cstr)
        rows = [
            np.asarray(f(xu[b][None, :]), dtype=float).reshape(-1)
            for b, f in enumerate(self._fobjs)
        ]
        return np.stack(rows)

    def _eval(self, x: np.ndarray) -> np.ndarray:
        """x (B, nx) continuous layout -> y (B, 1 + n_cstr); the objective
        sees the folded / discrete space."""
        return self._from_rank0(
            lambda: self._call(x), (self.n_problems, 1 + self.config.n_cstr))

    def _eval_doe(self, x: np.ndarray) -> np.ndarray:
        """x (B, n, nx) -> y (B, n, 1 + n_cstr)."""
        def call():
            if self._fobj_batched is not None:
                return np.stack([self._call(x[:, i])
                                 for i in range(x.shape[1])], axis=1)
            return np.stack([
                np.atleast_2d(np.asarray(f(self._to_user(x[b])),
                                         dtype=float))
                for b, f in enumerate(self._fobjs)
            ])

        return self._from_rank0(
            call, (self.n_problems, x.shape[1], 1 + self.config.n_cstr))

    def _run_program(self, key, statics, inputs):
        """The fused program on ``inputs`` (leading lane axis); with a
        mesh on this rank's contiguous block of the lanes, the outputs
        gathered. The lanes are padded up to a multiple of the mesh size
        (at least one per rank) with copies of the first lane, whose
        outputs are dropped: the draws stay those of the run without a
        mesh."""
        def program(**kw):
            return fused_select_point_batch(**kw, **statics)

        mesh = self._mesh
        if mesh is None:
            return self.graphs.run(key, program, inputs, inputs["xp"].shape)
        from ..parallel import _comm

        lanes = inputs["xp"].shape[0]
        width = -(-max(lanes, mesh.size) // mesh.size) * mesh.size
        blk = width // mesh.size
        start = mesh.rank * blk
        local = {}
        for name, v in inputs.items():
            if name in _LANE_INPUTS and v is not None:
                if width > lanes:
                    v = torch.cat([v, v[:1].expand(
                        (width - lanes,) + tuple(v.shape[1:]))])
                v = v[start:start + blk].contiguous()
            local[name] = v
        packed, theta = self.graphs.run(key, program, local,
                                        local["xp"].shape)
        return (_comm.gather_rows(mesh, packed, width, start)[:lanes],
                _comm.gather_rows(mesh, theta, width, start)[:lanes])

    def default_n_doe(self) -> int:
        n = self.config.n_doe
        return n if n > 0 else max(self.nx + 1, 5)

    def _init_doe(self) -> np.ndarray:
        n = self.default_n_doe()
        return np.stack([
            self.draws.lhs(n, self.xlimits[b], LhsKind.OPTIMIZED)
            for b in range(self.n_problems)
        ])  # (B, n, nx)

    def _pad(self, x: np.ndarray, y: np.ndarray, n_active):
        """Pad to the shape bucket; ``n_active`` (B,) marks each problem's
        live prefix (converged problems stop growing theirs)."""
        B, n = x.shape[:2]
        nb = _bucket(n, self.config.shape_bucket)
        xp = np.zeros((B, nb, x.shape[2]))
        xp[:, :n] = x
        yp = np.zeros((B, nb, y.shape[2]))
        yp[:, :n] = y
        mask = np.zeros((B, nb), dtype=bool)
        for b in range(B):
            mask[b, :int(n_active[b])] = True
        return (self._tensor(xp), self._tensor(yp),
                torch.as_tensor(mask).to(self.device, non_blocking=True))

    # ------------------------------------------------------------------

    def _propose(self, x_data: np.ndarray, y_data: np.ndarray, theta0s,
                 n_active=None, optimize_theta: bool = True,
                 lanes: Optional[np.ndarray] = None,
                 real: Optional[np.ndarray] = None):
        """One batched selection step: (B, n, .) histories -> (B, nx) next
        points (de-duplicated) and the fitted thetas (on the device, the
        next warm start). ``lanes`` maps a compacted sub-batch to the
        problems; ``real`` marks its genuine rows (padding rows repeat a
        live problem and take no host-side side effect)."""
        cfg = self.config
        gpc = cfg.gp_config
        if lanes is None:
            lanes = np.arange(self.n_problems)
        if real is None:
            real = np.ones(len(lanes), dtype=bool)
        B = len(lanes)
        cstr_tol = cfg.resolved_cstr_tol(0)
        n = x_data.shape[1]
        self._iter_dtype = egor_dtype(self.device, n)

        tb = np.asarray(self.theta_bounds, dtype=float)
        if tb.ndim == 1:
            tb = np.broadcast_to(tb[None, :], (self._dim, 2))
        t_lo, t_up = self._tensor(tb[:, 0]), self._tensor(tb[:, 1])
        xlimits = self.xlimits[lanes]
        if n_active is None:
            n_active = np.full(B, n)
        xp, yp, mask = self._pad(x_data, y_data, n_active)

        best_idx = [
            find_best_result_index(
                y_data[b, :int(n_active[b])],
                np.zeros((int(n_active[b]), 0)), cstr_tol)
            for b in range(B)
        ]
        fmin = np.array([y_data[b, best_idx[b], 0] for b in range(B)])
        feas_flags = None
        if cfg.n_cstr > 0 and os.environ.get(
                "EGOR_USE_MAX_PROBA_OF_FEASIBILITY"):
            feas_flags = torch.as_tensor([
                is_feasible(y_data[b, best_idx[b], :1],
                            y_data[b, best_idx[b], 1:], cstr_tol[:cfg.n_cstr])
                for b in range(B)
            ]).to(self.device, non_blocking=True)

        pool = np.stack([self.draws.lhs(cfg.n_start, xlimits[i])
                         for i in range(B)])  # (B, n_start, nx)
        pad_rng = np.random.default_rng(0)  # padding rows: throwaway draws
        starts = np.stack([
            np.clip(
                middle_picker_starts(
                    self._rngs[lanes[i]] if real[i] else pad_rng,
                    x_data[i, :int(n_active[i])], xlimits[i], cfg.n_start,
                    lambda k, _i=i: pool[_i][:k]),
                xlimits[i, :, 0], xlimits[i, :, 1])
            for i in range(B)
        ])
        fit_seeds = None
        if gpc.n_start > 0:
            fit_seeds = np.stack([
                self.draws.fit_draws(
                    int(self._rngs[lanes[i]].integers(0, 2**31))
                    if real[i] else 0
                ).lhs_seeds(gpc.n_start, self._dim, torch.float64,
                            "cpu").numpy()
                for i in range(B)
            ])
        n_cloud = min(100 * self.nx, 1000)
        clouds = np.stack([self.draws.lhs(n_cloud, xlimits[i])
                           for i in range(B)])

        statics = dict(
            corr=gpc.corr_names[0], trend=gpc.regr_names[0],
            gp_n_start=gpc.n_start, gp_max_iters=gpc.max_eval,
            fixed=not optimize_theta,
            nugget=100.0 * torch.finfo(self.dtype).eps,
            crit=_CRIT_NAME[cfg.infill_strategy],
            cstr_strategy=_CSTR_NAME[cfg.cstr_strategy], n_cstr=cfg.n_cstr,
            cstr_infill=cfg.cstr_infill, feasibility=True,
            optimizer=_OPT_NAME[cfg.infill_optimizer],
            ls_batch=GpSpec().ls_batch,
        )
        inputs = dict(
            xp=xp, yp=yp, mask=mask,
            theta0s=theta0s.to(dtype=self.dtype).to(self.device,
                                                    non_blocking=True),
            theta_lo=t_lo, theta_up=t_up,
            fit_seeds=None if fit_seeds is None else self._tensor(fit_seeds),
            clouds=self._tensor(clouds), starts=self._tensor(starts),
            lo=self._tensor(xlimits[:, :, 0]),
            hi=self._tensor(xlimits[:, :, 1]), fmin=self._tensor(fmin),
            cstr_tols=self._tensor(cstr_tol[:cfg.n_cstr]),
            feas_flags=feas_flags,
        )
        key = ("batch", xp.shape, yp.shape[2], self.dtype,
               feas_flags is not None, tuple(sorted(statics.items())))
        packed, theta = self._run_program(key, statics, inputs)
        arr = packed.double().cpu().numpy()  # the one host fetch
        x_new = self._cast(np.array(arr[:, :self.nx]))

        # de-dup with retry-then-converge (ref retry loop,
        # solver_impl.rs:505-515): a duplicate or non-finite proposal
        # retries with a random point; after MAX_POINT_ADDITION_RETRY
        # failures in a row the problem is converged
        for i in range(B):
            b = int(lanes[i])
            if not real[i] or self.converged[b]:
                continue
            na = int(n_active[i])
            d = np.sum(np.abs(x_data[i, :na] - x_new[i][None, :]), axis=1)
            if not np.all(np.isfinite(x_new[i])) or np.any(
                    d < 100.0 * np.finfo(float).eps):
                self._retries[b] -= 1
                if self._retries[b] <= 0:
                    self.converged[b] = True
                    continue
                u = self._rngs[b].uniform(size=self.nx)
                x_new[i] = self._cast(
                    (xlimits[i, :, 0]
                     + u * (xlimits[i, :, 1] - xlimits[i, :, 0]))[None, :]
                )[0]
            else:
                self._retries[b] = self._max_retries
        return x_new, theta

    def suggest(self, x_doe: np.ndarray, y_doe: np.ndarray) -> np.ndarray:
        """Batched ask-and-tell: given each problem's history ``x_doe`` (B,
        n, nx) and ``y_doe`` (B, n, 1 + n_cstr), the next point per problem
        (B, nx)."""
        x = np.asarray(x_doe, dtype=float)
        y = np.asarray(y_doe, dtype=float)
        if x.ndim != 3 or x.shape[0] != self.n_problems:
            raise ValueError(
                f"x_doe must be (B={self.n_problems}, n, nx), got {x.shape}"
            )
        m = 1 + self.config.n_cstr
        y = y.reshape(self.n_problems, x.shape[1], m)
        theta0s = torch.full((self.n_problems, m, self._dim), 0.1,
                             dtype=torch.float64)
        x_new, _ = self._propose(x, y, theta0s)
        return x_new

    def minimize(self, max_iters: int = 20) -> List[OptimResult]:
        cfg = self.config
        B = self.n_problems
        m = 1 + cfg.n_cstr
        cstr_tol = cfg.resolved_cstr_tol(0)

        x_data = self._cast_doe(self._init_doe())  # (B, n, nx)
        y_data = self._eval_doe(x_data)  # (B, n, m)
        # failed initial evaluations are imputed per problem (the
        # single-problem solver's penalty rule)
        for b in range(B):
            y_data[b] = impute_failed_values(y_data[b], y_data[b])
        theta0s = torch.full((B, m, self._dim), 0.1, dtype=torch.float64)
        n_active = np.full(B, x_data.shape[1])

        compact_ok = not os.environ.get("EGOBOX_NO_BATCH_COMPACTION")
        self.iteration_times = []
        for it in range(max_iters):
            if self.converged.all():
                break
            t0 = time.perf_counter()
            optimize_theta = it % cfg.q_optmod == 0
            live = np.nonzero(~self.converged)[0]
            n_live = len(live)
            # lane compaction over a power-of-two sub-batch of live problems
            # (padding rows repeat live[0] and are dropped)
            bc = 1 << (n_live - 1).bit_length()
            if compact_ok and bc < B:
                self._compactions += 1
                gidx = np.concatenate(
                    [live, np.full(bc - n_live, live[0], dtype=int)])
                x_sub, th_sub = self._propose(
                    np.ascontiguousarray(x_data[gidx]),
                    np.ascontiguousarray(y_data[gidx]),
                    theta0s[torch.as_tensor(gidx)], n_active[gidx],
                    optimize_theta=optimize_theta, lanes=gidx,
                    real=np.arange(bc) < n_live,
                )
                x_new = np.zeros((B, x_data.shape[2]))
                x_new[live] = x_sub[:n_live]
                theta0s = theta0s.to(th_sub.device, th_sub.dtype).clone()
                theta0s[torch.as_tensor(live, device=th_sub.device)] = (
                    th_sub[:n_live])
            else:
                x_new, theta0s = self._propose(
                    x_data, y_data, theta0s, n_active,
                    optimize_theta=optimize_theta)
            # converged problems carry their best forward (a frozen
            # placeholder, masked out of the fits) instead of evaluating
            frozen = {}
            for b in np.nonzero(self.converged)[0]:
                i = find_best_result_index(
                    y_data[b, :int(n_active[b])],
                    np.zeros((int(n_active[b]), 0)), cstr_tol)
                x_new[b] = x_data[b, i]
                frozen[b] = y_data[b, i]
            y_new = self._eval(x_new)
            for b, yb in frozen.items():
                y_new[b] = yb
            if not np.all(np.isfinite(y_new)):
                for b in range(B):
                    y_new[b:b + 1] = impute_failed_values(
                        y_new[b:b + 1], y_data[b])
            x_data = np.concatenate([x_data, x_new[:, None]], axis=1)
            y_data = np.concatenate([y_data, y_new[:, None]], axis=1)
            n_active = np.where(self.converged, n_active, x_data.shape[1])
            self.iteration_times.append(
                {"total": time.perf_counter() - t0,
                 "graph": self.graphs.stats.last})

        results = []
        for b in range(B):
            na = int(n_active[b])
            i = find_best_result_index(
                y_data[b, :na], np.zeros((na, 0)), cstr_tol)
            results.append(OptimResult(
                x_opt=self._to_user(x_data[b, i][None, :])[0],
                y_opt=y_data[b, i],
                x_doe=self._to_user(x_data[b, :na]),
                y_doe=y_data[b, :na],
            ))
        return results

    def _cast_doe(self, x: np.ndarray) -> np.ndarray:
        if self.mixint is None:
            return x
        return np.stack([self._cast(x[b]) for b in range(x.shape[0])])
