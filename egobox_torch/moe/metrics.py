"""Quality metrics of a GP: Q2, PVA, IAE_alpha
(port of egobox_tpu/moe/metrics.py).

Cross-validated scores after crates/moe/src/metrics.rs (and
gp/src/metrics.rs). The dense-GP hook ``gp_fit_predict`` fits the k folds
as one lockstep stack of masked lanes, and the sparse-GP hook
``sgp_fit_predict`` every fold's inits as one stack of lanes with a design
per fold (egobox_tpu: one vmapped program each; the reference refits
sequentially).

- Q2        = 1 - PRESS / TSS (1 is perfect)
- PVA       = |ln( mean (y - yhat)^2 / var_hat )| (0 is perfect)
- IAE_alpha = mean over 20 alphas of |empirical CI coverage - (1 - alpha)|
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from ..gp import fit as gp_fit
from ..gp.fit import (
    GP_DEFAULT_THETA_BOUNDS,
    GP_DEFAULT_THETA_INIT,
    fit_gp_core,
    fit_gp_outputs,
    output_model,
)
from ..gp.gp import predict_valvar
from ..gp.sgp import (
    _LIKELIHOODS,
    SGP_NOISE_BOUNDS_EPS_FACTOR,
    SGP_NOISE_INIT,
    SGP_NOISE_UPPER,
    SGP_THETA_BOUNDS,
    SgpModel,
    _default_nugget,
    _param_box,
    _sgp_draws,
    _solve_lanes,
    _unpack,
    sgp_predict_valvar,
)
from .moe import _placement


def _norm_ppf(q) -> np.ndarray:
    """Inverse standard normal CDF (statrs Normal::inverse_cdf in the
    reference), by erfinv as egobox_tpu computes it."""
    q = torch.as_tensor(np.asarray(q, dtype=float))
    return (math.sqrt(2.0) * torch.erfinv(2.0 * q - 1.0)).numpy()


def _cv_masks(n: int, kfold: int) -> np.ndarray:
    masks = np.ones((kfold, n), dtype=bool)
    idx = np.arange(n)
    for f in range(kfold):
        masks[f, idx[f::kfold]] = False
    return masks


def _cv_pred_valvar(x: np.ndarray, y: np.ndarray, fit_predict, kfold: int,
                    seed: int = 0):
    """k-fold CV: per fold (y_true, pred, var) on the held-out rows.

    Two hook protocols: batched (``fit_predict.batched`` truthy),
    ``fit_predict(x, y, masks (k, n)) -> (preds (k, n), vars (k, n))``, all
    the fold fits at once (``gp_fit_predict``); and per fold,
    ``fit_predict(x, y, mask, x_test) -> (pred, var)``."""
    n = x.shape[0]
    kfold = min(kfold, n)
    masks = _cv_masks(n, kfold)
    if getattr(fit_predict, "batched", False):
        preds, vrs = fit_predict(x, y, masks)
        preds = np.asarray(preds)
        vrs = np.asarray(vrs)
        return [
            (y[~masks[f]], preds[f][~masks[f]], vrs[f][~masks[f]])
            for f in range(kfold)
        ]
    outs = []
    for f in range(kfold):
        test = ~masks[f]
        pred, var = fit_predict(x, y, masks[f], x[test])
        outs.append((y[test], np.asarray(pred), np.asarray(var)))
    return outs


def _xy(x, y):
    return (np.atleast_2d(np.asarray(x, dtype=float)),
            np.asarray(y, dtype=float).ravel())


def q2_score(x, y, fit_predict, kfold: Optional[int] = None,
             seed: int = 0) -> float:
    """(ref: metrics.rs q2_k_score / q2_score; leave-one-out when kfold is
    None)"""
    x, y = _xy(x, y)
    kfold = kfold if kfold is not None else x.shape[0]
    y_mean = y.mean()
    outs = _cv_pred_valvar(x, y, fit_predict, kfold, seed)
    press = sum(float(np.sum((yt - p) ** 2)) for yt, p, _ in outs)
    tss = sum(float(np.sum((yt - y_mean) ** 2)) for yt, _, _ in outs)
    return 1.0 - press / tss


def pva_score(x, y, fit_predict, kfold: Optional[int] = None,
              seed: int = 0) -> float:
    """(ref: metrics.rs pva_k_score)"""
    x, y = _xy(x, y)
    kfold = kfold if kfold is not None else x.shape[0]
    outs = _cv_pred_valvar(x, y, fit_predict, kfold, seed)
    varss = 0.0
    n = 0
    for yt, p, v in outs:
        varss += float(np.sum((yt - p) ** 2 / np.maximum(v, 1e-300)))
        n += yt.shape[0]
    return abs(float(np.log(varss / n)))


def _coverage(yt, p, v, q):
    sigma = np.sqrt(np.maximum(v, 0.0))
    offset = sigma[:, None] * q[None, :]  # (n_test, n_alpha)
    inside = (yt[:, None] >= p[:, None] - offset) & (
        yt[:, None] <= p[:, None] + offset)
    return inside.mean(axis=0)  # (n_alpha,)


def iae_alpha_score(x, y, fit_predict, kfold: Optional[int] = None,
                    seed: int = 0, n_alpha: int = 20) -> float:
    """(ref: metrics.rs iae_alpha_k_score / iae_alpha:146-195)"""
    x, y = _xy(x, y)
    kfold = kfold if kfold is not None else x.shape[0]
    alphas = np.linspace(0.02, 0.98, n_alpha)
    q = _norm_ppf(1.0 - alphas / 2.0)
    outs = _cv_pred_valvar(x, y, fit_predict, kfold, seed)
    return float(np.mean([
        np.mean(np.abs(_coverage(yt, p, v, q) - (1.0 - alphas)))
        for yt, p, v in outs]))


def iae_alpha_with_plot(x, y, fit_predict, kfold: Optional[int] = None,
                        seed: int = 0, n_alpha: int = 20):
    """IAE_alpha and the per-alpha empirical coverages, the data of the
    gpqa table (ref: GpMetric::IAEAlphaWithPlot, gpqa/src/main.rs:41-60).
    Returns (score, alphas, coverages)."""
    x, y = _xy(x, y)
    kfold = kfold if kfold is not None else x.shape[0]
    alphas = np.linspace(0.02, 0.98, n_alpha)
    q = _norm_ppf(1.0 - alphas / 2.0)
    outs = _cv_pred_valvar(x, y, fit_predict, kfold, seed)
    coverage = _coverage(*(np.concatenate([o[i] for o in outs])
                           for i in range(3)), q)
    score = iae_alpha_score(x, y, fit_predict, kfold, seed, n_alpha)
    return score, alphas, coverage


def gp_fit_predict(corr: str = "squared_exponential",
                   trend: str = "constant", n_start: int = 5,
                   kpls_dim=None, seed: int = 42, max_iters: int = 20,
                   device=None, dtype=None) -> Callable:
    """Batched fit_predict hook of a plain GP (the Gpx metrics): the k fold
    fits as one lockstep stack of masked lanes, each predicting the whole
    design (the caller keeps each fold's held-out rows). Every fold takes
    the restart seeds of ``seed``."""

    def fp(x, y, masks):
        dev, dt = _placement(x, device, dtype)
        xt = torch.as_tensor(np.asarray(x, dtype=float), dtype=dt).to(dev)
        yt = torch.as_tensor(np.ravel(np.asarray(y, dtype=float)),
                             dtype=dt).to(dev)
        mk = torch.as_tensor(np.asarray(masks, dtype=bool)).to(dev)
        k, n = mk.shape
        dim = kpls_dim if kpls_dim is not None else xt.shape[1]

        def full(v):
            return torch.full((dim,), v, dtype=dt, device=dev)

        theta0 = full(GP_DEFAULT_THETA_INIT)
        lo, up = full(GP_DEFAULT_THETA_BOUNDS[0]), full(
            GP_DEFAULT_THETA_BOUNDS[1])
        active = torch.ones((dim,), dtype=torch.bool, device=dev)
        nugget = 100.0 * torch.finfo(dt).eps
        kw = dict(corr=corr, trend=trend, n_start=n_start,
                  max_iters=max_iters, nugget=nugget)
        if kpls_dim is None:
            seeds = (gp_fit._fit_draws(seed).lhs_seeds(n_start, dim, dt, dev)
                     if n_start > 0 else None)
            models = fit_gp_outputs(
                xt.expand(k, n, xt.shape[1]), yt[None, :, None].expand(
                    k, n, 1), mk, theta0.expand(k, 1, dim), lo, up, active,
                None if seeds is None else seeds.expand((k,) + seeds.shape),
                **kw)
            folds = [output_model(models, f) for f in range(k)]
        else:
            # KPLS weights depend on each fold's rows: fold by fold
            folds = [fit_gp_core(xt, yt[:, None], mk[f], theta0, lo, up,
                                 active, gp_fit._fit_draws(seed),
                                 kpls_dim=kpls_dim, **kw)
                     for f in range(k)]
        outs = [predict_valvar(m, xt) for m in folds]
        preds = torch.stack([p for p, _ in outs]).double().cpu().numpy()
        vrs = torch.stack([v for _, v in outs]).double().cpu().numpy()
        return preds, vrs

    fp.batched = True
    return fp


def sgp_fit_predict(corr: str = "squared_exponential",
                    method: str = "FITC", n_inducing: int = 10,
                    n_start: int = 5, max_iters: int = 25, seed: int = 0,
                    device=None, dtype=None) -> Callable:
    """Batched fit_predict hook of a sparse GP: the k fold refits as one
    stack of lockstep lanes (egobox_tpu vmaps them; the reference refits
    sequentially, moe/src/metrics.rs). The sparse fit has no masked path,
    so each fold's training rows are gathered into a (k, n_tr, d) stack
    with n_tr the smallest fold's size (a fold loses at most one training
    point), and each fold's data rides its lanes as a leading axis. The
    inducing points of each fold are drawn from its training rows with
    ``np.random.default_rng(seed)``, as egobox_tpu draws them; the LHS
    seeds, one set per fold, from ``gp.sgp._sgp_draws(seed)``. As in
    ``fit_sgp``, the algebra is float64 and the points take ``dtype``
    (default float64; float32 points are float32 Grams, K1's on the card,
    with the nugget relative to sigma2)."""

    def hook(x, y, masks):
        dev, dt = _placement(x, device, dtype or torch.float64)
        xt = torch.as_tensor(np.atleast_2d(np.asarray(x, dtype=float)),
                             dtype=dt).to(dev)
        yt = torch.as_tensor(np.ravel(np.asarray(y, dtype=float)),
                             dtype=torch.float64).to(dev)
        masks = np.asarray(masks, dtype=bool)
        k = masks.shape[0]
        d = xt.shape[1]
        n_tr = int(masks.sum(axis=1).min())
        idx = torch.as_tensor(np.stack([np.nonzero(m)[0][:n_tr]
                                        for m in masks])).to(dev)
        xtr = xt[idx]  # (k, n_tr, d)
        ytr = yt[idx][..., None]  # (k, n_tr, 1)
        m = min(n_inducing, n_tr)
        rng = np.random.default_rng(seed)
        zidx = torch.as_tensor(np.stack([rng.permutation(n_tr)[:m]
                                         for _ in range(k)])).to(dev)
        z = xtr[torch.arange(k, device=dev)[:, None], zidx]  # (k, m, d)

        def full(v):
            return torch.full((d,), v, dtype=torch.float64, device=dev)

        eps = torch.finfo(dt).eps
        noise0 = torch.tensor(SGP_NOISE_INIT, dtype=torch.float64,
                              device=dev)
        nb = (SGP_NOISE_BOUNDS_EPS_FACTOR * eps, SGP_NOISE_UPPER)
        seeds = (_sgp_draws(seed).fold_lhs_seeds(k, n_start, d + 2,
                                                 torch.float64, dev)
                 if n_start > 0 else [None] * k)
        boxes = [_param_box(ytr[f], full(0.1), full(SGP_THETA_BOUNDS[0]),
                            full(SGP_THETA_BOUNDS[1]), noise0, nb, True,
                            None, seeds[f]) for f in range(k)]
        inits, lo, up = (torch.stack(v) for v in zip(*boxes))
        nugget = _default_nugget(dt)
        lik = _LIKELIHOODS[method]
        p = _solve_lanes(lik, corr, xtr, ytr, z, None, nugget, d, True,
                         noise0, inits, lo, up, max_iters, 0)
        theta, sigma2, noise = _unpack(p, d, True, noise0)
        _, w = lik(corr, theta, sigma2, noise, xtr, ytr, z, None, nugget)
        outs = [sgp_predict_valvar(SgpModel(
            theta=theta[f], sigma2=sigma2[f], noise=noise[f], w_star=None,
            z=z[f], w_vec=w.vec[f], w_inv=w.inv[f], likelihood=None,
            corr=corr, method=method), xt) for f in range(k)]
        preds = torch.stack([p for p, _ in outs]).double().cpu().numpy()
        vrs = torch.stack([v for _, v in outs]).double().cpu().numpy()
        return preds, vrs

    hook.batched = True
    return hook
