"""Automatic choice of the number of clusters
(port of egobox_tpu/moe/clustering.py).

After find_best_number_of_clusters (crates/moe/src/clustering.rs:59-386):
for k = 1..max, fit the mixture on each of 5 folds and score the held-out
RMSE of its hard and smooth predictions; keep the best median error, and
stop after 3 degradations in a row. Returns (k, Recombination).

egobox_tpu skips a fold on any exception; the port skips it only on the
numerical failures of a fit (``moe.FIT_FAILURES``), so that a kernel's
build or launch failure propagates instead of choosing another k.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ..types import Recombination


def find_best_number_of_clusters(
    x: np.ndarray,
    y: np.ndarray,
    max_k: int,
    regr_names: Sequence[str],
    corr_names: Sequence[str],
    kpls_dim=None,
    seed: int = 42,
    n_folds: int = 5,
    device=None,
    dtype=None,
) -> Tuple[int, Recombination]:
    from .moe import FIT_FAILURES, GpMixture, train_moe

    x = np.atleast_2d(np.asarray(x, dtype=float))
    y = np.asarray(y, dtype=float).reshape(x.shape[0])
    n = x.shape[0]
    max_k = max(1, min(max_k, n // 5))
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)

    best = (1, Recombination.SMOOTH)
    best_err = np.inf
    degradations = 0

    for k in range(1, max_k + 1):
        errs_hard, errs_smooth = [], []
        for f in range(min(n_folds, n)):
            test = idx[f::n_folds]
            train = np.setdiff1d(idx, test)
            if train.size < 5 * k:
                continue
            try:
                mix = train_moe(
                    x[train], y[train], n_clusters=k,
                    recombination=Recombination.SMOOTH,
                    regr_names=regr_names, corr_names=corr_names,
                    kpls_dim=kpls_dim, n_start=5, seed=seed, device=device,
                    dtype=dtype,
                )
            except FIT_FAILURES:
                continue
            ps = mix.predict(x[test]).double().cpu().numpy()
            errs_smooth.append(np.sqrt(np.mean((ps - y[test]) ** 2)))
            mix_hard = GpMixture(mix.experts, mix.gmx, Recombination.HARD)
            ph = mix_hard.predict(x[test]).double().cpu().numpy()
            errs_hard.append(np.sqrt(np.mean((ph - y[test]) ** 2)))

        if not errs_smooth:
            break
        med_s = float(np.median(errs_smooth))
        med_h = float(np.median(errs_hard))
        err_k, recomb_k = (
            (med_s, Recombination.SMOOTH)
            if med_s <= med_h
            else (med_h, Recombination.HARD)
        )
        if err_k < best_err:
            best_err = err_k
            best = (k, recomb_k)
            degradations = 0
        else:
            degradations += 1
            if degradations >= 3:
                break

    return best
