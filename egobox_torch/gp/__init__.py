"""Dense Gaussian-process regression (kriging): kernels, trends, KPLS,
likelihood, fit and predict."""

from .fit import GpFitError, fit_gp, fit_gp_core
from .gp import (
    GpModel,
    inner_params,
    posterior_cov,
    predict,
    predict_gradients,
    predict_kth_derivatives,
    predict_valvar,
    predict_valvar_gradients,
    predict_var,
    predict_var_gradients,
    sample,
)
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
    "inner_params",
    "log_corr_cross",
    "make_neg_reduced_likelihood",
    "make_neg_rlf_residual_api",
    "n_basis",
    "pls_rotations",
    "posterior_cov",
    "predict",
    "predict_gradients",
    "predict_kth_derivatives",
    "predict_valvar",
    "predict_valvar_gradients",
    "predict_var",
    "predict_var_gradients",
    "reduced_likelihood",
    "sample",
    "theta_bounds_heuristic",
    "trend_basis",
]
