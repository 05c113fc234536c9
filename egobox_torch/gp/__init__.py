"""Dense Gaussian-process regression (kriging): kernels, trends, KPLS,
likelihood, fit and predict."""

from .fit import GpFitError, fit_gp, fit_gp_core
from .gp import GpModel, predict, predict_valvar, predict_var
from .kernels import (
    KERNEL_NAMES,
    THETA_INFLUENCE_FACTORS,
    corr_cross,
    corr_gram,
    corr_value,
    log_corr_cross,
    theta_bounds_heuristic,
)
from .kpls import pls_rotations
from .likelihood import (
    GpInnerParams,
    make_neg_reduced_likelihood,
    make_neg_rlf_residual_api,
    reduced_likelihood,
)
from .trends import TREND_NAMES, n_basis, trend_basis

__all__ = [
    "GpFitError",
    "GpInnerParams",
    "GpModel",
    "KERNEL_NAMES",
    "THETA_INFLUENCE_FACTORS",
    "TREND_NAMES",
    "corr_cross",
    "corr_gram",
    "corr_value",
    "fit_gp",
    "fit_gp_core",
    "log_corr_cross",
    "make_neg_reduced_likelihood",
    "make_neg_rlf_residual_api",
    "n_basis",
    "pls_rotations",
    "predict",
    "predict_valvar",
    "predict_var",
    "reduced_likelihood",
    "theta_bounds_heuristic",
    "trend_basis",
]
