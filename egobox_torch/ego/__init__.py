"""Egor: efficient global (Bayesian) optimization (port of egobox_tpu/ego).

Ported: ``Egor.minimize`` / ``Egor.suggest`` on the fused iteration (the
default: one program per iteration, a CUDA graph on the GPU) and on the
unfused host loop (``EGOBOX_NO_FUSED_STEP=1``), the traced whole run
(``Egor(traced_run=True)``), ``EgorBatch``, the criteria, the lockstep
multistart infill optimizer, TREGO, mixed-integer folding and clustered
(mixture-of-experts) surrogates, on the host path and as the fused
clustered iteration; on the host path CoEGO (``ego.coego``), the
sigma-weight portfolio (``ego.portfolio``) and function constraints that
are host callbacks (polished by ``egobox_torch.native``);
``EgorBatch(mesh=)`` splits its problems over the ranks of an
``egobox_torch.parallel`` mesh.
"""

from .batch import EgorBatch
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
    "EgorBatch",
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
