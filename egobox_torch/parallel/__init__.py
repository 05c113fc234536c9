"""The distributed GP over a mesh of ranks on torch.distributed (port of
egobox_tpu/parallel): the block-cyclic Cholesky and solves, the
distributed likelihood, its adjoint and the fit, the row-block model and
its serving path, and the sharded multistart. SPMD: every rank of the
mesh calls the same functions (``sharding.Mesh``), one rank per card
(``launch.run_ranks(backend="nccl")`` starts them on one host; a
torchrun-style launch and ``make_mesh()`` do the same)."""

from .dist_chol import (
    block_cyclic_perm,
    cholesky_blockcyclic,
    cholesky_rowsharded,
    pick_panel_size,
    reduced_likelihood_distributed,
    solve_lower_blockcyclic,
    solve_lower_rowsharded,
)
from .dist_chol import solve_upperT_blockcyclic
from .dist_fit import (
    dist_grad_theta,
    dist_likelihood_parts,
    fit_theta_distributed,
    make_neg_rlf_distributed,
)
from .dist_model import (
    DistGpModel,
    dist_posterior_cov,
    dist_predict,
    dist_predict_valvar,
    dist_predict_var,
    dist_sample,
    realize_dist_model,
)
from .sharding import (
    Mesh,
    corr_cross_multichip,
    fit_gp_multichip,
    make_mesh,
    multistart_neg_rlf_minimize,
    reduced_likelihood_rowsharded,
    replicated,
    shard_rows,
    shard_starts,
)

__all__ = [
    "DistGpModel",
    "dist_posterior_cov",
    "dist_sample",
    "dist_predict",
    "dist_predict_valvar",
    "dist_predict_var",
    "realize_dist_model",
    "solve_upperT_blockcyclic",
    "block_cyclic_perm",
    "cholesky_blockcyclic",
    "cholesky_rowsharded",
    "dist_grad_theta",
    "dist_likelihood_parts",
    "fit_theta_distributed",
    "make_neg_rlf_distributed",
    "pick_panel_size",
    "solve_lower_blockcyclic",
    "corr_cross_multichip",
    "fit_gp_multichip",
    "shard_rows",
    "make_mesh",
    "multistart_neg_rlf_minimize",
    "reduced_likelihood_distributed",
    "reduced_likelihood_rowsharded",
    "replicated",
    "shard_starts",
    "solve_lower_rowsharded",
]
