"""Public enums/specs mirroring the egobox Python API surface.

The port's own copy of egobox_tpu/types.py (ref: python/src/types.rs,
crates/moe/src/types.rs, crates/ego/src/types.rs; API parity only).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional, Sequence


class RegressionSpec(enum.IntFlag):
    """Bitflag of allowed trend (mean) models (ref: moe/src/types.rs:52-63)."""

    CONSTANT = 1
    LINEAR = 2
    QUADRATIC = 4
    ALL = 7


class CorrelationSpec(enum.IntFlag):
    """Bitflag of allowed correlation kernels (ref: moe/src/types.rs:77-91)."""

    SQUARED_EXPONENTIAL = 1
    ABSOLUTE_EXPONENTIAL = 2
    MATERN32 = 4
    MATERN52 = 8
    ALL = 15


#: trend model names in bit order
REGRESSION_NAMES = {
    RegressionSpec.CONSTANT: "constant",
    RegressionSpec.LINEAR: "linear",
    RegressionSpec.QUADRATIC: "quadratic",
}

#: kernel names in bit order
CORRELATION_NAMES = {
    CorrelationSpec.SQUARED_EXPONENTIAL: "squared_exponential",
    CorrelationSpec.ABSOLUTE_EXPONENTIAL: "absolute_exponential",
    CorrelationSpec.MATERN32: "matern32",
    CorrelationSpec.MATERN52: "matern52",
}


class InfillStrategy(enum.Enum):
    """Infill criterion (ref: python/src/types.rs InfillStrategy)."""

    EI = "EI"
    WB2 = "WB2"
    WB2S = "WB2S"
    LOG_EI = "LogEI"


class ConstraintStrategy(enum.Enum):
    """Surrogate-constraint handling: mean or upper-trust-bound
    (ref: ego/src/solver/solver_computations.rs:196-257)."""

    MC = "MeanConstraint"
    UTB = "UpperTrustBound"


class QInfillStrategy(enum.Enum):
    """qEI virtual-point strategy (ref: ego/src/types.rs:59-68)."""

    KB = "KrigingBeliever"
    KBLB = "KrigingBelieverLowerBound"
    KBUB = "KrigingBelieverUpperBound"
    CLMIN = "ConstantLiarMinimum"


class InfillOptimizer(enum.Enum):
    """Local optimizer used for constrained infill maximization
    (ref: ego/src/optimizers/optimizer.rs:12-224). Both are jitted vmapped
    multistart methods: COBYLA maps to the augmented-Lagrangian L-BFGS
    (plus the native derivative-free simplex polish when user function
    constraints are present), SLSQP to a smoothed-L1 exact-penalty L-BFGS
    (the gradient-based SQP role)."""

    COBYLA = "Cobyla"
    SLSQP = "Slsqp"


class Sampling(enum.Enum):
    """Sampling method selector (ref: python/src/sampling.rs:11-30)."""

    LHS = "Lhs"
    FULL_FACTORIAL = "FullFactorial"
    RANDOM = "Random"
    LHS_CLASSIC = "LhsClassic"
    LHS_CENTERED = "LhsCentered"
    LHS_MAXIMIN = "LhsMaximin"
    LHS_CENTERED_MAXIMIN = "LhsCenteredMaximin"


class Recombination(enum.Enum):
    """Mixture-of-experts recombination mode (ref: moe/src/types.rs:20-28)."""

    HARD = "hard"
    SMOOTH = "smooth"


class SparseMethod(enum.Enum):
    """Sparse GP approximation (ref: gp/src/sparse_parameters.rs).

    Canonical members are FITC/VFE (the reference pyclass renames to
    SCREAMING_SNAKE_CASE, python/src/types.rs:152); Fitc/Vfe are aliases
    matching the stubgen names in egobox.pyi:827-830.
    """

    FITC = "Fitc"
    VFE = "Vfe"
    Fitc = "Fitc"  # alias
    Vfe = "Vfe"  # alias


class GpFileFormat(enum.Enum):
    """Model persistence format (ref: moe/src/types.rs:220-226)."""

    JSON = "json"
    BINARY = "binary"


class XType(enum.Enum):
    """Design variable type (ref: ego/src/types.rs:130-139)."""

    FLOAT = "Float"
    INT = "Int"
    ORD = "Ord"
    ENUM = "Enum"


@dataclass
class XSpec:
    """One design variable spec (ref: python/src/types.rs XSpec).

    - FLOAT: xlimits = [lower, upper]
    - INT:   xlimits = [lower, upper] (integer bounds)
    - ORD:   xlimits = list of ordered allowed values
    - ENUM:  xlimits = [n_levels] or tags = list of level names
    """

    xtype: XType
    xlimits: Sequence[float] = field(default_factory=list)
    tags: Sequence[str] = field(default_factory=list)

    @property
    def n_levels(self) -> int:
        if self.xtype is not XType.ENUM:
            raise ValueError("n_levels only defined for ENUM variables")
        if self.tags:
            return len(self.tags)
        return int(self.xlimits[0])


@dataclass
class OptimResult:
    """Result of an Egor run (ref: python/src/types.rs OptimResult)."""

    x_opt: "object"
    y_opt: "object"
    x_doe: "object"
    y_doe: "object"


@dataclass
class ExpectedOptimum:
    """Known optimum used as early-stop target
    (ref: egobox.pyi:198-202 — fields val/tol)."""

    val: float
    tol: float = 1e-6


@dataclass
class RunInfo:
    """Run metadata recorded by the run recorder
    (ref: crates/ego/src/egor.rs:131-137, egobox.pyi:578-587):
    ``fname`` is the objective-function name, ``num`` a replication number.
    """

    fname: str = ""
    num: int = 0


class HotStartMode(enum.Enum):
    """Checkpoint reload behavior (ref: ego/src/utils/hot_start.rs)."""

    DISABLED = "disabled"
    ENABLED = "enabled"
    EXTENDED_ITERS = "extended_iters"


def regression_spec_names(spec: RegressionSpec) -> List[str]:
    return [name for bit, name in REGRESSION_NAMES.items() if spec & bit]


def correlation_spec_names(spec: CorrelationSpec) -> List[str]:
    return [name for bit, name in CORRELATION_NAMES.items() if spec & bit]
