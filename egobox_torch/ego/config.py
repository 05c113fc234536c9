"""Egor configuration (port of egobox_tpu/ego/config.py; ref:
crates/ego/src/solver/egor_config.rs:176-467 and python/src/egor.rs:156-231
for the Python-facing defaults)."""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from ..types import (
    ConstraintStrategy,
    CorrelationSpec,
    InfillOptimizer,
    InfillStrategy,
    QInfillStrategy,
    Recombination,
    RegressionSpec,
    correlation_spec_names,
    regression_spec_names,
)

#: max retries when every proposed point is a duplicate
#: (ref: egor_state.rs:19)
MAX_POINT_ADDITION_RETRY = 3

#: default constraint tolerance (ref: egor_solver.rs:143)
DEFAULT_CSTR_TOL = 1e-4


def _default_bucket() -> int:
    """Pad-to-bucket quantum of the growing DoE (EGOBOX_SHAPE_BUCKET, as in
    egobox_tpu)."""
    return int(os.environ.get("EGOBOX_SHAPE_BUCKET", "8"))


@dataclass
class GpConfig:
    """Surrogate config shared by Egor and GpMix
    (ref: python/src/gp_config.rs:9-122; defaults egor_config.rs:13-15)."""

    regr_spec: RegressionSpec = RegressionSpec.CONSTANT
    corr_spec: CorrelationSpec = CorrelationSpec.SQUARED_EXPONENTIAL
    kpls_dim: Optional[int] = None
    n_clusters: int = 1  # >0 fixed, 0 auto, <0 automax(-n)
    # default HARD matches the Python-facing reference default
    # (python/src/gp_config.rs:70-81 GpConfig::default -> Recombination::Hard)
    recombination: Recombination = Recombination.HARD
    theta_init: Optional[Sequence[float]] = None
    theta_bounds: Optional[Sequence[Sequence[float]]] = None
    n_start: int = 10
    max_eval: int = 50

    @property
    def regr_names(self):
        return regression_spec_names(self.regr_spec)

    @property
    def corr_names(self):
        return correlation_spec_names(self.corr_spec)


@dataclass
class TregoConfig:
    """Trust-region EGO (ref: egor_config.rs:120-141)."""

    activated: bool = False
    n_local_steps: int = 4
    d: tuple = (1e-6, 1.0)
    beta: float = 0.9
    gamma: float = 10.0 / 9.0
    sigma0: float = 1e-1


@dataclass
class EgorConfig:
    """(ref: egor_config.rs:176-467)"""

    max_iters: int = 20
    n_start: int = 20  # infill multistart count (egor_config.rs:173)
    n_doe: int = 0  # 0 -> max(nx + 1, 5)
    doe: Optional[np.ndarray] = None
    n_cstr: int = 0
    cstr_tol: Optional[np.ndarray] = None
    cstr_infill: bool = False
    cstr_strategy: ConstraintStrategy = ConstraintStrategy.MC
    infill_strategy: InfillStrategy = InfillStrategy.LOG_EI
    q_points: int = 1
    q_infill_strategy: QInfillStrategy = QInfillStrategy.KB
    q_optmod: int = 1
    infill_optimizer: InfillOptimizer = InfillOptimizer.COBYLA
    gp_config: GpConfig = field(default_factory=GpConfig)
    target: float = -np.inf
    outdir: Optional[str] = None
    warm_start: bool = False
    hot_start: Optional[int] = None  # None=off, 0=on, n>0 extends iters
    seed: Optional[int] = None
    trego: TregoConfig = field(default_factory=TregoConfig)
    coego_n_coop: int = 0  # 0 = disabled
    #: CoEGO per-group partial theta tuning (ref: coego.rs:98-126). The
    #: reference needs it because derivative-free COBYLA cannot optimize
    #: >100 theta components; the gradient-based L-BFGS tunes the full
    #: theta jointly, so the default is joint tuning. CoEGO is not ported.
    coego_partial_theta_tuning: bool = False
    #: the fused iteration and the traced run pad the DoE to multiples of
    #: this (with a mask) so that one captured CUDA graph serves every
    #: design size of a bucket, as egobox_tpu re-uses one compiled program;
    #: the unfused path fits the design unpadded
    shape_bucket: int = field(default_factory=_default_bucket)
    #: warm-refit multistart width: from the second iteration on, the
    #: per-iteration surrogate MLE re-seeds only this many LHS lanes on top
    #: of the carried warm-start thetas (the carry makes full-width
    #: re-seeding redundant). The reference re-seeds the full n_start every
    #: refit (ref: egor_config.rs:13-15 + gp fit multistart); set None for
    #: that reference-exact behavior. 0 is refused: it would drop every
    #: LHS lane of the refit and leave the carried theta alone.
    warm_refit_n_start: Optional[int] = 4

    def resolved_cstr_tol(self, n_fcstr: int = 0) -> np.ndarray:
        n = self.n_cstr + n_fcstr
        if self.cstr_tol is None:
            return np.full(n, DEFAULT_CSTR_TOL)
        tol = np.asarray(self.cstr_tol, dtype=float).ravel()
        if tol.shape[0] != n:
            raise ValueError(
                f"cstr_tol has {tol.shape[0]} entries, expected {n}"
            )
        return tol

    def check(self):
        """(ref: egor_config.rs:444-466)"""
        if self.coego_n_coop and self.gp_config.kpls_dim:
            raise ValueError("CoEGO and KPLS cannot be used together")
        if self.q_points < 1:
            raise ValueError("q_points must be >= 1")
        w = self.warm_refit_n_start
        if w is not None and int(w) < 1:
            raise ValueError(
                "warm_refit_n_start must be >= 1 (or None to re-seed the "
                f"full n_start every refit), got {w}"
            )
        return self
