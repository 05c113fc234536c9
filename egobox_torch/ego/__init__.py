"""Egor: efficient global (Bayesian) optimization (port of egobox_tpu/ego).

Ported: the host loop of ``Egor.minimize`` / ``Egor.suggest`` with its
criteria, the lockstep multistart infill optimizer, TREGO and mixed-integer
folding. The fused, traced and batched loops, CoEGO, the portfolio and
clustered surrogates are not.
"""

from .config import EgorConfig, GpConfig, TregoConfig
from .criteria import ei, log_ei, log_ei_helper, log_pof, pof, wb2, wb2s_scale
from .egor import Egor
from .find_result import (
    find_best_result_index,
    find_best_result_index_from,
    is_feasible,
)
from .infill_optim import compute_scaling, optimize_infill, virtual_point
from .mixint import MixintContext, parse_xspecs
from .solver import EgorSolver, NoMorePointToAddError
from .state import EgorState
from .surrogates import GpSpec, train_gp_surrogates

__all__ = [
    "Egor",
    "EgorConfig",
    "EgorSolver",
    "EgorState",
    "GpConfig",
    "GpSpec",
    "MixintContext",
    "NoMorePointToAddError",
    "TregoConfig",
    "compute_scaling",
    "ei",
    "find_best_result_index",
    "find_best_result_index_from",
    "is_feasible",
    "log_ei",
    "log_ei_helper",
    "log_pof",
    "optimize_infill",
    "parse_xspecs",
    "pof",
    "train_gp_surrogates",
    "virtual_point",
    "wb2",
    "wb2s_scale",
]
