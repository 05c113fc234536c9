"""Sigma-weight portfolio point selection (env-gated,
EGOR_USE_GP_VAR_PORTFOLIO; port of egobox_tpu/ego/portfolio.py, a copy:
plain numpy on the host).

Behavioral parity with crates/ego/src/utils/portfolio.rs and the portfolio
loop of select_next_points (solver_impl.rs:585-610): the infill criterion is
re-optimized with 13 log-spaced weights on the GP standard deviation
(distrusting the variance estimate), the resulting proposals are DBSCAN-
clustered in x (min_pts=2, tolerance sqrt(nx)) and one representative per
cluster is returned as the evaluation batch.
"""

from __future__ import annotations

from typing import List

import numpy as np

#: logspace(0.1, 100, 13) with 1.0 moved in front (ref: solver_impl.rs:588)
SIGMA_WEIGHTS = (
    1.0, 0.1, 0.1778279410038923, 0.31622776601683794, 0.5623413251903491,
    1.7782794100389228, 3.1622776601683795, 5.623413251903491, 10.0,
    17.78279410038923, 31.622776601683793, 56.23413251903491, 100.0,
)


def logspace(start: float, end: float, num: int) -> np.ndarray:
    """(ref: portfolio.rs:12-23)"""
    return np.logspace(np.log10(start), np.log10(end), num)


def dbscan_labels(x: np.ndarray, eps: float, min_pts: int = 2) -> List:
    """Minimal DBSCAN; returns per-point labels (None = noise)
    (role of linfa_clustering::Dbscan in portfolio.rs:25-43)."""
    n = x.shape[0]
    d = np.linalg.norm(x[:, None, :] - x[None, :, :], axis=-1)
    neigh = [np.where(d[i] <= eps)[0] for i in range(n)]
    labels: List = [None] * n
    visited = np.zeros(n, dtype=bool)
    cluster = 0
    for i in range(n):
        if visited[i]:
            continue
        visited[i] = True
        if len(neigh[i]) < min_pts:
            continue  # noise (may be claimed by a cluster later)
        labels[i] = cluster
        seeds = list(neigh[i])
        k = 0
        while k < len(seeds):
            j = seeds[k]
            k += 1
            if labels[j] is None:
                labels[j] = cluster
            if not visited[j]:
                visited[j] = True
                if len(neigh[j]) >= min_pts:
                    seeds.extend(
                        jj for jj in neigh[j] if jj not in seeds
                    )
        cluster += 1
    return labels


def select_from_portfolio(x_props: np.ndarray) -> np.ndarray:
    """Cluster portfolio proposals in x and keep one representative per
    cluster (ref: select_from_portfolio, portfolio.rs:45-97). Returns the
    selected row indices; falls back to [0] when everything is noise."""
    nx = x_props.shape[1]
    labels = dbscan_labels(x_props, eps=float(np.sqrt(nx)), min_pts=2)
    reps = {}
    for i, lab in enumerate(labels):
        if lab is None:
            continue
        reps.setdefault(lab, i)
    if not reps:
        return np.array([0])
    return np.array(sorted(reps.values()))
