"""Env-gated run/GP recorders (observability).

Behavioral parity with the reference's recorders
(crates/ego/src/utils/{run_recorder.rs,gp_recorder.rs}, env flags in
utils/mod.rs:22-48):

- ``EGOR_USE_RUN_RECORDER``: write a structured JSON run log
  ``EgorRunData { problem_metadata, algorithm_parameters,
  search_iterations }`` to <outdir>/egor_run.json.
- ``EGOR_USE_GP_RECORDER``: dump the per-iteration surrogate models to
  <outdir>/egor_gp_models.bin (pickle — the bincode equivalent); iteration 0
  goes to egor_initial_gp_models.bin like the reference
  (solver_impl.rs:658-674).
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Optional

RUN_RECORDER_ENV = "EGOR_USE_RUN_RECORDER"
GP_RECORDER_ENV = "EGOR_USE_GP_RECORDER"
RUN_FILE = "egor_run.json"
GP_FILE = "egor_gp_models.bin"
INITIAL_GP_FILE = "egor_initial_gp_models.bin"


def run_recorder_enabled() -> bool:
    return bool(os.environ.get(RUN_RECORDER_ENV))


def gp_recorder_enabled() -> bool:
    return bool(os.environ.get(GP_RECORDER_ENV))


class RunRecorder:
    """Accumulates the structured run log
    (ref: run_recorder.rs:9-120 EgorRunData)."""

    def __init__(self, problem_metadata: dict, algorithm_parameters: dict):
        self.data = {
            "problem_metadata": problem_metadata,
            "algorithm_parameters": algorithm_parameters,
            "search_iterations": [],
        }

    def record_iteration(self, it: int, x, y, best_x, best_y):
        import numpy as np

        self.data["search_iterations"].append({
            "iteration": it,
            "samples": np.atleast_2d(np.asarray(x)).tolist(),
            "objectives": np.atleast_2d(np.asarray(y)).tolist(),
            "best_x": np.asarray(best_x).tolist(),
            "best_y": np.asarray(best_y).tolist(),
        })

    def save(self, outdir: str):
        os.makedirs(outdir, exist_ok=True)
        with open(os.path.join(outdir, RUN_FILE), "w") as f:
            json.dump(self.data, f, indent=2)


def record_gp_models(outdir: Optional[str], it: int, models) -> None:
    """Dump per-iteration surrogate models (ref: gp_recorder.rs:9-19)."""
    if not gp_recorder_enabled():
        return
    outdir = outdir or "./"
    os.makedirs(outdir, exist_ok=True)
    fname = INITIAL_GP_FILE if it == 0 else GP_FILE
    with open(os.path.join(outdir, fname), "wb") as f:
        pickle.dump(models, f)
