"""Mixture of GP experts: GMM clustering, CV expert selection, hard and
smooth recombination (port of egobox_tpu/moe)."""

from .clustering import find_best_number_of_clusters
from .gaussian_mixture import (
    GaussianMixture,
    from_gmm_x_marginal,
    predict_cluster,
    predict_probas,
    predict_probas_derivatives,
)
from .gmm import GmmParams, fit_gmm, gmm_log_prob
from .metrics import (
    gp_fit_predict,
    iae_alpha_score,
    iae_alpha_with_plot,
    pva_score,
    q2_score,
    sgp_fit_predict,
)
from .moe import (
    GpMixture,
    MoeModel,
    expert_params,
    find_best_expert,
    moe_predict_valvar_batch,
    moe_predict_valvar_single,
    optimize_heaviside_factor,
    train_moe,
    train_moe_on_clusters,
)

__all__ = [
    "GaussianMixture",
    "GmmParams",
    "GpMixture",
    "MoeModel",
    "expert_params",
    "find_best_expert",
    "find_best_number_of_clusters",
    "fit_gmm",
    "from_gmm_x_marginal",
    "gmm_log_prob",
    "gp_fit_predict",
    "iae_alpha_score",
    "iae_alpha_with_plot",
    "moe_predict_valvar_batch",
    "moe_predict_valvar_single",
    "optimize_heaviside_factor",
    "predict_cluster",
    "predict_probas",
    "predict_probas_derivatives",
    "pva_score",
    "q2_score",
    "sgp_fit_predict",
    "train_moe",
    "train_moe_on_clusters",
]
