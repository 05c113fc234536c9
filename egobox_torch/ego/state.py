"""Egor optimizer state (ref: crates/ego/src/solver/egor_state.rs:25-105).

Host-side container (port of egobox_tpu/ego/state.py): the DoE grows each
iteration, so the state lives in numpy and goes to the solver's device per
phase. Everything is plain data so it JSON-serializes for hot-start
checkpointing; the payload is the one egobox_tpu's ``to_dict`` writes, so a
checkpoint of either package resumes in the other. Clustered (MoE)
surrogates are not ported: a payload that carries ``clusterings`` or
``moe_params`` raises.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class EgorState:
    x_data: np.ndarray  # (n, nx)
    y_data: np.ndarray  # (n, 1 + n_cstr)
    c_data: np.ndarray  # (n, n_fcstr)
    cstr_tol: np.ndarray  # (n_cstr + n_fcstr,)
    best_index: int = 0
    prev_best_index: Optional[int] = None
    feasibility: bool = False
    theta_inits: Optional[np.ndarray] = None  # (1+n_cstr, dim)
    added: int = 0
    prev_added: int = 0
    no_point_added_retries: int = 3
    iter: int = 0
    # TREGO scheduler state (ref: egor_state.rs sigma / trego fields)
    sigma: float = 1e-1
    in_local_phase: bool = False
    local_steps_left: int = 0
    prev_best_y: Optional[float] = None
    # CoEGO activity groups: list of per-group component-index arrays
    # (ref: egor_state.rs activity)
    activity: Optional[list] = None
    # per-output (gmx, recombination) clusterings for the MoE surrogate
    # path, checkpointed so hot-start resumes with the identical clustering
    # (ref: egor_state.rs:25-105 clusterings field)
    clusterings: Optional[list] = None
    # per-output per-expert (trend, corr, theta) of the last MoE training,
    # reused as Fixed hyperparameters on q_optmod skip iterations
    # (ref: solver_impl.rs:643-645)
    moe_params: Optional[list] = None
    rng: np.random.Generator = field(
        default_factory=lambda: np.random.default_rng(42)
    )

    @property
    def n_points(self) -> int:
        return self.x_data.shape[0]

    def best(self):
        return (
            self.x_data[self.best_index],
            self.y_data[self.best_index],
            self.c_data[self.best_index]
            if self.c_data.size
            else np.zeros(0),
        )

    def to_dict(self) -> dict:
        """JSON-serializable snapshot for hot-start checkpoints
        (ref: utils/hot_start.rs)."""
        return {
            "x_data": self.x_data.tolist(),
            "y_data": self.y_data.tolist(),
            "c_data": self.c_data.tolist(),
            "cstr_tol": self.cstr_tol.tolist(),
            "best_index": int(self.best_index),
            "prev_best_index": self.prev_best_index,
            "feasibility": bool(self.feasibility),
            "theta_inits": None
            if self.theta_inits is None
            else self.theta_inits.tolist(),
            "added": int(self.added),
            "prev_added": int(self.prev_added),
            "no_point_added_retries": int(self.no_point_added_retries),
            "iter": int(self.iter),
            "sigma": float(self.sigma),
            "in_local_phase": bool(self.in_local_phase),
            "local_steps_left": int(self.local_steps_left),
            "prev_best_y": self.prev_best_y,
            "activity": None
            if self.activity is None
            else [np.asarray(g).tolist() for g in self.activity],
            "clusterings": _no_moe("clusterings", self.clusterings),
            "moe_params": _no_moe("moe_params", self.moe_params),
            "rng_state": self.rng.bit_generator.state,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "EgorState":
        rng = np.random.default_rng()
        rng.bit_generator.state = d["rng_state"]
        return cls(
            x_data=np.asarray(d["x_data"], dtype=float),
            y_data=np.asarray(d["y_data"], dtype=float),
            c_data=np.asarray(d["c_data"], dtype=float).reshape(
                len(d["x_data"]), -1
            ),
            cstr_tol=np.asarray(d["cstr_tol"], dtype=float),
            best_index=d["best_index"],
            prev_best_index=d["prev_best_index"],
            feasibility=d["feasibility"],
            theta_inits=None
            if d["theta_inits"] is None
            else np.asarray(d["theta_inits"], dtype=float),
            added=d["added"],
            prev_added=d["prev_added"],
            no_point_added_retries=d["no_point_added_retries"],
            iter=d["iter"],
            sigma=d["sigma"],
            in_local_phase=d["in_local_phase"],
            local_steps_left=d["local_steps_left"],
            prev_best_y=d["prev_best_y"],
            activity=None
            if d.get("activity") is None
            else [np.asarray(g, dtype=int) for g in d["activity"]],
            clusterings=_no_moe("clusterings", d.get("clusterings")),
            moe_params=_no_moe("moe_params", d.get("moe_params")),
            rng=rng,
        )


def _no_moe(name: str, value):
    if value is not None:
        raise NotImplementedError(
            f"egobox_torch: EgorState.{name} belongs to the clustered (MoE) "
            "surrogates, which are not ported (ROADMAP Queue 1: MoE "
            "surrogates in Egor)"
        )
    return None
