"""Best-point selection under constraint tolerance ordering.

Host-side numpy port of crates/ego/src/utils/find_result.rs: points are
ordered by (sum of constraint violations above tolerance, then objective).
This is bookkeeping over the DoE (tiny), not compute — it stays on host.
"""

from __future__ import annotations

import numpy as np


def cstr_sum(y_row: np.ndarray, cstr_tol: np.ndarray) -> float:
    """Sum of violations above tolerance; y_row = [obj, c1..cn, fc1..fcm]
    (ref: find_result.rs:10-17)."""
    c = y_row[1:]
    viol = c - cstr_tol
    return float(np.sum(np.where(c > cstr_tol, np.abs(viol), 0.0)))


def _key(row: np.ndarray, cstr_tol: np.ndarray):
    if row.shape[0] > 1:
        return (cstr_sum(row, cstr_tol), float(row[0]))
    return (0.0, float(row[0]))


def find_best_result_index(y_data: np.ndarray, c_data: np.ndarray,
                           cstr_tol: np.ndarray) -> int:
    """(ref: find_result.rs:76-142)"""
    all_data = np.concatenate([y_data, c_data], axis=1)
    keys = [_key(all_data[i], cstr_tol) for i in range(all_data.shape[0])]
    return int(min(range(len(keys)), key=lambda i: keys[i]))


def find_best_result_index_from(current_index: int, offset_index: int,
                                y_data: np.ndarray, c_data: np.ndarray,
                                cstr_tol: np.ndarray) -> int:
    """Compare the current best against the newly-added tail rows
    (ref: find_result.rs:48-69)."""
    all_data = np.concatenate([y_data, c_data], axis=1)
    best = current_index
    best_key = _key(all_data[current_index], cstr_tol)
    for i in range(offset_index, all_data.shape[0]):
        k = _key(all_data[i], cstr_tol)
        if k < best_key:
            best, best_key = i, k
    return best


def is_feasible(y_row: np.ndarray, c_row: np.ndarray,
                cstr_tol: np.ndarray) -> bool:
    """(ref: find_result.rs:146-158)"""
    yc = np.concatenate([np.atleast_1d(y_row), np.atleast_1d(c_row)])
    if yc.shape[0] > 1:
        return cstr_sum(yc, cstr_tol) == 0.0
    return True
