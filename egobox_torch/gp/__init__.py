"""Gaussian-process regression: dense kriging (kernels, trends, KPLS,
likelihood, fit and predict) and the sparse GP (FITC / VFE)."""

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
from .sgp import (
    SGP_NOISE_BOUNDS_EPS_FACTOR,
    SGP_NOISE_INIT,
    SGP_NOISE_UPPER,
    SGP_THETA_BOUNDS,
    SgpModel,
    WoodburyData,
    fit_sgp,
    fit_sgp_core,
    fitc_likelihood,
    sgp_predict,
    sgp_predict_gradients,
    sgp_predict_valvar,
    sgp_predict_var,
    sgp_predict_var_gradients,
    sgp_sample,
    vfe_likelihood,
)
from .likelihood import (
    GpInnerParams,
    make_neg_reduced_likelihood,
    make_neg_rlf_residual_api,
    reduced_likelihood,
)
from .trends import TREND_NAMES, n_basis, trend_basis, trend_jacobian


def kriging(x, y, **kwargs):
    """Kriging convenience fit: constant trend and squared-exponential
    kernel (ref alias: gp/src/algorithm.rs:200-207 ``Kriging<F>``)."""
    kwargs.setdefault("corr", "squared_exponential")
    kwargs.setdefault("trend", "constant")
    return fit_gp(x, y, **kwargs)


def sparse_kriging(x, y, **kwargs):
    """SparseKriging convenience fit: squared-exponential sparse GP
    (ref alias: gp/src/sparse_algorithm.rs:172-179)."""
    kwargs.setdefault("corr", "squared_exponential")
    return fit_sgp(x, y, **kwargs)


__all__ = [
    "GpFitError",
    "GpInnerParams",
    "GpModel",
    "KERNEL_NAMES",
    "SGP_NOISE_BOUNDS_EPS_FACTOR",
    "SGP_NOISE_INIT",
    "SGP_NOISE_UPPER",
    "SGP_THETA_BOUNDS",
    "SgpModel",
    "THETA_INFLUENCE_FACTORS",
    "TREND_NAMES",
    "WoodburyData",
    "corr_cross",
    "corr_gram",
    "corr_value",
    "fit_gp",
    "fit_gp_core",
    "fit_sgp",
    "fit_sgp_core",
    "fitc_likelihood",
    "inner_params",
    "kriging",
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
    "sgp_predict",
    "sgp_predict_gradients",
    "sgp_predict_valvar",
    "sgp_predict_var",
    "sgp_predict_var_gradients",
    "sgp_sample",
    "sparse_kriging",
    "theta_bounds_heuristic",
    "trend_basis",
    "trend_jacobian",
    "vfe_likelihood",
]
