"""Egor optimizer state (ref: crates/ego/src/solver/egor_state.rs:25-105).

Host-side container (port of egobox_tpu/ego/state.py): the DoE grows each
iteration, so the state lives in numpy and goes to the solver's device per
phase. Everything is plain data so it JSON-serializes for hot-start
checkpointing; the payload is the one egobox_tpu's ``to_dict`` writes, so a
checkpoint of either package resumes in the other, the clustered
surrogates' ``clusterings`` and ``moe_params`` included.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch


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
    # (m, k, dim) per-expert theta warm starts carried on the device by the
    # fused clustered iteration (ego/fused_step.fused_select_point_moe);
    # not checkpointed: a hot start refits from scratch
    moe_theta_inits: Optional[object] = None
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
            "clusterings": _clusterings_to_json(self.clusterings),
            "moe_params": self.moe_params,
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
            clusterings=_clusterings_from_json(d.get("clusterings")),
            moe_params=_moe_params_from_json(d.get("moe_params")),
            rng=rng,
        )


def _clusterings_to_json(clusterings) -> Optional[list]:
    """Per-output (GaussianMixture, Recombination) pairs as plain data
    (ref: egor_state.rs:25-105 serde on clusterings)."""
    if clusterings is None:
        return None
    out = []
    for gmx, recomb in clusterings:
        out.append({
            "weights": gmx.weights.tolist(),
            "means": gmx.means.tolist(),
            "covariances": gmx.covariances.tolist(),
            "precisions_chol": gmx.precisions_chol.tolist(),
            "heaviside_factor": float(gmx.heaviside_factor),
            "recombination": recomb.value,
        })
    return out


def _clusterings_from_json(payload) -> Optional[list]:
    """The clusterings as float64 CPU tensors; the solver moves them to its
    device and type."""
    if payload is None:
        return None
    from ..moe.gaussian_mixture import GaussianMixture
    from ..types import Recombination

    def t(v):
        return torch.tensor(v, dtype=torch.float64)

    return [(GaussianMixture(
        weights=t(g["weights"]), means=t(g["means"]),
        covariances=t(g["covariances"]),
        precisions_chol=t(g["precisions_chol"]),
        heaviside_factor=t(g["heaviside_factor"]),
    ), Recombination(g["recombination"])) for g in payload]


def _moe_params_from_json(payload) -> Optional[list]:
    """JSON turns tuples into lists: back to the (trend, corr, theta)
    triples ``train_moe_on_clusters`` takes."""
    if payload is None:
        return None
    return [
        [None if p is None else (p[0], p[1], p[2]) for p in per_output]
        for per_output in payload
    ]
