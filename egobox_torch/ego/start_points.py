"""Multistart seed selection for infill optimization (port of
egobox_tpu/ego/start_points.py).

Ports the behavior of crates/ego/src/utils/start_points.rs (midpoints between
training points that are farther from every other point) and the
MiddlePickerMultiStarter (solver_computations.rs:56-124). The greedy midpoint
scan is O(n^2) on a handful of points and inherently sequential: it stays on
the host (numpy); the LHS completion comes from the solver's draws.
"""

from __future__ import annotations

import numpy as np


def start_points(x: np.ndarray, xl: np.ndarray, xu: np.ndarray,
                 n_max: int | None = None) -> np.ndarray:
    """Midpoints of training-point pairs, closest pairs first, keeping a
    midpoint only if no other training point or already-kept midpoint is
    closer to it than its parents (ref: start_points.rs:7-85)."""
    x = np.asarray(x, dtype=float)
    n, d = x.shape
    xrange = np.asarray(xu, dtype=float) - np.asarray(xl, dtype=float)
    xrange = np.where(xrange == 0, 1.0, xrange)

    pairs = []
    for i in range(1, n):
        for j in range(i):
            dist = np.linalg.norm((x[i] - x[j]) / xrange)
            pairs.append((i, j, dist))
    pairs.sort(key=lambda t: t[2])

    xstart: list[np.ndarray] = []
    for i, j, _ in pairs:
        xij = (x[i] + x[j]) / 2.0
        d_ij = np.linalg.norm((x[i] - xij) / xrange)
        good = True
        for k in range(n):
            if k in (i, j):
                continue
            if np.linalg.norm((x[k] - xij) / xrange) < d_ij:
                good = False
                break
        if good:
            for xk in xstart:
                if np.linalg.norm((xk - xij) / xrange) < d_ij:
                    good = False
                    break
        if good:
            xstart.append(xij)
        if n_max is not None and len(xstart) >= n_max:
            break

    if not xstart:
        return np.zeros((0, d))
    return np.stack(xstart)


def middle_picker_starts(rng: np.random.Generator, x_train: np.ndarray,
                         xlimits: np.ndarray, n_start: int,
                         lhs_fill) -> np.ndarray:
    """MiddlePicker multistart: midpoints of a random subset of training
    points, completed with maximin LHS (ref: solver_computations.rs:62-114).

    ``lhs_fill(n)`` must return (n, nx) maximin-LHS points in xlimits.
    """
    nt = x_train.shape[0]
    n_sub = max(nt // 10, 2)
    idx = rng.permutation(nt)[:n_sub]
    mids = start_points(
        x_train[idx], xlimits[:, 0], xlimits[:, 1], n_max=n_start
    )
    missing = n_start - mids.shape[0]
    if missing <= 0:
        return mids[:n_start]
    fill = np.asarray(lhs_fill(max(missing, 3)))[:missing]
    if mids.shape[0] == 0:
        return fill
    return np.concatenate([mids, fill], axis=0)
