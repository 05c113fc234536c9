"""GpMixture: a mixture of GP experts (port of egobox_tpu/moe/moe.py).

After crates/moe/src/algorithm.rs:

- clustering: a joint (x, y) GMM (moe/gmm.py, its restarts one batch);
  the hard assignment splits the data (sort_by_cluster,
  moe/src/clustering.rs:33-56);
- expert selection per cluster (find_best_expert, algorithm.rs:209-347):
  5-fold CV over the allowed trend x kernel grid, the five fold fits of a
  combo one lockstep stack of masked lanes (gp/fit.py ``fit_gp_outputs``
  with a problem axis; egobox_tpu vmaps them);
- smooth recombination: the heaviside factor searched over
  linspace(0.1, 2.1, 20) on a 1-in-5 holdout (algorithm.rs:349-378), then a
  retrain on all the data;
- prediction: smooth sum_k p_k mu_k (variance with p_k^2 weights), hard the
  expert of the argmax cluster (algorithm.rs:411-423, 662-685, 879-935);
- experts are dense kriging (``GpModel``) or, with ``gp_type="sparse"``,
  FITC / VFE sparse GPs (``SgpModel``, gp/sgp.py); every prediction path
  dispatches on the expert's type (``_e_predict`` and its siblings).

Data comes in as numpy (or tensors) and is kept on the host as float64 for
the bookkeeping (folds, assignments, pads); the fits and predictions run on
``device`` (default: the GPU; ``"cpu"`` on the CPU) in ``dtype`` (default:
that device's type). Every random draw comes from a replaceable source:
the fits' restart seeds from ``gp.fit._fit_draws(seed)``, the GMM's
seeding from ``moe.gmm._gmm_draws(seed)``, the CV folds from
``np.random.default_rng(seed)`` as in egobox_tpu.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import default_dtype, resolve_device
from ..gp import fit as gp_fit
from ..gp.fit import (
    GP_DEFAULT_THETA_BOUNDS,
    GpFitError,
    fit_gp,
    fit_gp_core,
    fit_gp_outputs,
    output_model,
)
from ..gp.gp import (
    predict as gp_predict,
    predict_gradients as gp_predict_gradients,
    predict_valvar as gp_predict_valvar,
    predict_var as gp_predict_var,
    predict_var_gradients as gp_predict_var_gradients,
    sample as gp_sample,
)
from ..gp.sgp import (
    SgpModel,
    fit_sgp,
    sgp_predict,
    sgp_predict_gradients,
    sgp_predict_valvar,
    sgp_predict_var,
    sgp_predict_var_gradients,
)
from ..types import Recombination
from .gaussian_mixture import (
    GaussianMixture,
    from_gmm_x_marginal,
    predict_cluster,
    predict_probas,
    predict_probas_derivatives,
)
from .gmm import fit_gmm, gmm_log_prob

#: the numerical failures a fit may meet on a candidate's data: they make a
#: combo (or a cluster count) lose; anything else propagates
FIT_FAILURES = (GpFitError, torch.linalg.LinAlgError)


def _e_predict(e, x):
    return sgp_predict(e, x) if isinstance(e, SgpModel) else gp_predict(e, x)


def _e_valvar(e, x):
    if isinstance(e, SgpModel):
        return sgp_predict_valvar(e, x)
    return gp_predict_valvar(e, x)


def _e_var(e, x):
    if isinstance(e, SgpModel):
        return sgp_predict_var(e, x)
    return gp_predict_var(e, x)


def _e_grad(e, x):
    if isinstance(e, SgpModel):
        return sgp_predict_gradients(e, x)
    return gp_predict_gradients(e, x)


def _e_vargrad(e, x):
    if isinstance(e, SgpModel):
        return sgp_predict_var_gradients(e, x)
    return gp_predict_var_gradients(e, x)


def _placement(x, device, dtype):
    """(device, dtype) of the fits: a tensor's own, else ``device`` (the
    GPU by default) in ``dtype`` or that device's type."""
    if isinstance(x, torch.Tensor):
        return x.device, dtype or x.dtype
    device = resolve_device(device)
    return device, dtype or default_dtype(device)


def _host(a) -> np.ndarray:
    """A float64 host copy of an array or tensor."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.array(a, dtype=float)


def _fit_bucket() -> int:
    return int(os.environ.get("EGOBOX_SHAPE_BUCKET", "8"))


def _pad_xy(x: np.ndarray, y: np.ndarray):
    """(x, y) padded with masked rows to the shape bucket (read from
    ``EGOBOX_SHAPE_BUCKET``, default 8), as egobox_tpu pads to reuse its
    compiled programs; the masked fit is exact. Returns (x_pad, y_pad,
    valid)."""
    n = x.shape[0]
    b = _fit_bucket()
    nb = max(b, -(-n // b) * b)
    valid = np.zeros(nb, dtype=bool)
    valid[:n] = True
    if nb == n:
        return x, y, valid
    xp = np.zeros((nb, x.shape[1]), dtype=x.dtype)
    xp[:n] = x
    yp = np.zeros(nb, dtype=y.dtype)
    yp[:n] = y
    return xp, yp, valid


class _Clock:
    """Seconds per named step into ``times`` (nothing when it is None),
    the device synchronized at each mark."""

    def __init__(self, times: Optional[dict], device):
        self.times, self.device = times, device
        self.t = self._now() if times is not None else 0.0

    def _now(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def mark(self, name: str):
        if self.times is not None:
            t = self._now()
            self.times[name] = self.times.get(name, 0.0) + t - self.t
            self.t = t

    def restart(self):
        if self.times is not None:
            self.t = self._now()


def _cv_folds_error(x, y, masks, valid, theta0, lo, up, *, corr, trend,
                    kpls_dim, n_start, max_iters, seed):
    """Per-fold held-out MSE (n_folds,) of one combo: the fold fits run as
    one lockstep stack of masked lanes (egobox_tpu's vmap over folds), the
    error on the valid rows a fold holds out. Every fold takes the restart
    seeds of ``seed``, as egobox_tpu gives every fold one key."""
    n_folds, nb = masks.shape
    dim = theta0.shape[0]
    active = torch.ones((dim,), dtype=torch.bool, device=x.device)
    nugget = 100.0 * torch.finfo(x.dtype).eps
    seeds = (gp_fit._fit_draws(seed).lhs_seeds(n_start, dim, x.dtype,
                                               x.device)
             if n_start > 0 else None)
    if kpls_dim is None:
        models = fit_gp_outputs(
            x.expand(n_folds, nb, x.shape[1]),
            y[None, :, None].expand(n_folds, nb, 1), masks,
            theta0.expand(n_folds, 1, dim), lo, up, active,
            None if seeds is None else seeds.expand(
                (n_folds,) + seeds.shape),
            corr=corr, trend=trend, n_start=n_start, max_iters=max_iters,
            nugget=nugget)
        folds = [output_model(models, f) for f in range(n_folds)]
    else:
        # KPLS weights depend on each fold's rows: fold by fold
        folds = [fit_gp_core(x, y[:, None], masks[f], theta0, lo, up, active,
                             gp_fit._fit_draws(seed), corr=corr, trend=trend,
                             kpls_dim=kpls_dim, n_start=n_start,
                             max_iters=max_iters, nugget=nugget)
                 for f in range(n_folds)]
    preds = torch.stack([gp_predict(m, x) for m in folds])  # (folds, nb)
    w = ((~masks) & valid).to(x.dtype)
    return torch.sum((preds - y) ** 2 * w, dim=1) / torch.clamp(
        torch.sum(w, dim=1), min=1.0)


def _cv_error(x: np.ndarray, y: np.ndarray, corr: str, trend: str,
              kpls_dim, n_start: int, seed: int, n_folds: int = 5,
              device=None, dtype=None) -> float:
    """k-fold CV RMSE of one (trend, corr) combo (ref: expertise_macros.rs:
    14-130, sequential per combo there). A fit failing on the candidate's
    data (``FIT_FAILURES``) scores inf; any other error propagates."""
    device, dtype = _placement(x, device, dtype)
    x, y = _host(x), _host(y).reshape(-1)
    n = x.shape[0]
    n_folds = min(n_folds, n)
    idx = np.arange(n)
    rng = np.random.default_rng(seed)
    rng.shuffle(idx)
    xp, yp, valid = _pad_xy(x, y)
    masks = np.zeros((n_folds, xp.shape[0]), dtype=bool)
    masks[:, :n] = True
    for f in range(n_folds):
        masks[f, idx[f::n_folds]] = False

    def t(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt).to(device)

    dim = kpls_dim if kpls_dim is not None else x.shape[1]
    try:
        errs = _cv_folds_error(
            t(xp), t(yp), t(masks, torch.bool), t(valid, torch.bool),
            torch.full((dim,), 0.1, dtype=dtype, device=device),
            torch.full((dim,), GP_DEFAULT_THETA_BOUNDS[0], dtype=dtype,
                       device=device),
            torch.full((dim,), GP_DEFAULT_THETA_BOUNDS[1], dtype=dtype,
                       device=device),
            corr=corr, trend=trend, kpls_dim=kpls_dim,
            n_start=min(n_start, 5), max_iters=20, seed=seed)
    except FIT_FAILURES:
        return np.inf
    errs = errs.double().cpu().numpy()
    errs = np.where(np.isfinite(errs), errs, np.inf)
    return float(np.sqrt(np.mean(errs)))


def _min_points(trend: str, dim: int) -> int:
    """(ref: check_number_of_points, algorithm.rs:381-405)"""
    if trend == "quadratic":
        return (dim + 1) * (dim + 2) // 2
    if trend == "linear":
        return dim + 1
    return 1


def _sgp_cv_error(x: np.ndarray, y: np.ndarray, corr: str, n_inducing: int,
                  sparse_method: str, n_start: int, seed: int,
                  n_folds: int = 5, device=None, dtype=None) -> float:
    """k-fold CV RMSE of a sparse-GP expert candidate, fold after fold (the
    reference generates it by its declare_sgp_surrogate! macros). A fit
    failing on the candidate's data (``FIT_FAILURES``) scores inf for its
    fold; any other error propagates."""
    n = x.shape[0]
    n_folds = min(n_folds, max(n // 10, 2))
    idx = np.arange(n)
    rng = np.random.default_rng(seed)
    rng.shuffle(idx)

    def t(a):
        return torch.as_tensor(a, dtype=dtype).to(device)

    errs = []
    for f in range(n_folds):
        test = idx[f::n_folds]
        train = np.setdiff1d(idx, test)
        try:
            m = fit_sgp(
                t(x[train]), t(y[train]), corr=corr, method=sparse_method,
                n_inducing=min(n_inducing, train.size),
                n_start=min(n_start, 3), max_iters=20, seed=seed,
            )
            pred = sgp_predict(m, t(x[test])).double().cpu().numpy()
            errs.append(np.mean((pred - y[test]) ** 2))
        except FIT_FAILURES:
            errs.append(np.inf)
    return float(np.sqrt(np.mean(errs)))


def find_best_expert(
    x,
    y,
    regr_names: Sequence[str],
    corr_names: Sequence[str],
    kpls_dim=None,
    n_start: int = 10,
    seed: int = 42,
    theta_init=None,
    theta_bounds=None,
    gp_type: str = "full",
    n_inducing: int = 10,
    sparse_method: str = "FITC",
    device=None,
    dtype=None,
    times: Optional[dict] = None,
):
    """CV-select the (trend, kernel) combo and fit it on all the data
    (ref: find_best_expert, algorithm.rs:209-347). ``gp_type="sparse"``
    selects sparse-GP experts with ``n_inducing`` points and
    ``sparse_method`` (constant trend only, like the reference's
    declare_sgp_surrogate registry, surrogates.rs:266-422): a CV over the
    kernels, then ``fit_sgp``. ``times`` (a dict) collects the seconds of
    the CV ("cv") and of the fit ("fit"). Sparse experts take float64
    points unless ``dtype`` says otherwise; their algebra is float64
    (gp/sgp.py)."""
    if gp_type == "sparse":
        dtype = dtype or torch.float64
    device, dtype = _placement(x, device, dtype)
    x, y = _host(x), _host(y).reshape(-1)
    n, nx = x.shape
    dim = kpls_dim if kpls_dim is not None else nx
    clock = _Clock(times, device)

    if gp_type == "sparse":
        if len(corr_names) == 1:
            corr = corr_names[0]
        else:
            errors = {
                c: _sgp_cv_error(x, y, c, n_inducing, sparse_method, n_start,
                                 seed, device=device, dtype=dtype)
                for c in corr_names
            }
            corr = min(errors, key=errors.get)
        clock.mark("cv")
        model = fit_sgp(
            torch.as_tensor(x, dtype=dtype).to(device),
            torch.as_tensor(y, dtype=dtype).to(device), corr=corr,
            method=sparse_method, n_inducing=min(n_inducing, n),
            kpls_dim=kpls_dim, n_start=n_start, seed=seed,
            theta_init=theta_init, theta_bounds=theta_bounds,
        )
        clock.mark("fit")
        return model

    allowed = [
        (t, c)
        for t in regr_names
        if n >= _min_points(t, dim) + 1
        for c in corr_names
    ]
    if not allowed:
        allowed = [("constant", corr_names[0])]

    if len(allowed) == 1:
        trend, corr = allowed[0]
    else:
        errors = {
            (t, c): _cv_error(x, y, c, t, kpls_dim, n_start, seed,
                              device=device, dtype=dtype)
            for t, c in allowed
        }
        trend, corr = min(errors, key=errors.get)
    clock.mark("cv")

    xp, yp, valid = _pad_xy(x, y)
    model = fit_gp(
        torch.as_tensor(xp, dtype=dtype).to(device),
        torch.as_tensor(yp, dtype=dtype).to(device), corr=corr, trend=trend,
        kpls_dim=kpls_dim, n_start=n_start, seed=seed,
        theta_init=theta_init, theta_bounds=theta_bounds,
        mask=torch.as_tensor(valid).to(device),
    )
    clock.mark("fit")
    return model


@dataclass(frozen=True)
class MoeModel:
    """A trained mixture as the EGO loop carries it: the experts, the
    mixture that weighs them, and the recombination (its capture signature
    on the card)."""

    experts: tuple  # Tuple[GpModel | SgpModel, ...]
    gmx: GaussianMixture
    smooth: bool = True


def moe_predict_valvar_batch(model: MoeModel, x: torch.Tensor):
    """(means, variances) of one mixture over x (p, nx) -> ((p,), (p,)):
    smooth mean = sum p_k mu_k, variance = sum p_k^2 var_k
    (ref: algorithm.rs:662-685); hard: the argmax cluster's expert."""
    mvs = [_e_valvar(e, x) for e in model.experts]
    means = torch.stack([m for m, _ in mvs])  # (k, p)
    vrs = torch.stack([v for _, v in mvs])
    if len(model.experts) == 1:
        return means[0], vrs[0]
    probas = predict_probas(model.gmx, x)  # (p, k)
    if model.smooth:
        return (torch.sum(probas.T * means, dim=0),
                torch.sum(probas.T**2 * vrs, dim=0))
    c = torch.argmax(probas, dim=1)[None, :]
    return (torch.gather(means, 0, c)[0], torch.gather(vrs, 0, c)[0])


def moe_predict_valvar_single(model: MoeModel, x: torch.Tensor):
    """(mean, variance) of one mixture at one point x (nx,) (0-d pair), or
    at a batch of points x (..., nx) -> ((...), (...))."""
    lead = x.shape[:-1]
    mean, var = moe_predict_valvar_batch(model, x.reshape(-1, x.shape[-1]))
    return mean.reshape(lead), var.reshape(lead)


@dataclass
class GpMixture:
    """A trained mixture (ref struct: moe/src/algorithm.rs:430-443).
    Inputs are numpy or tensors; results are tensors on the experts'
    device."""

    experts: List  # GpModel or SgpModel
    gmx: GaussianMixture
    recombination: Recombination = Recombination.SMOOTH

    def to_model(self) -> MoeModel:
        return MoeModel(experts=tuple(self.experts), gmx=self.gmx,
                        smooth=self.recombination is Recombination.SMOOTH)

    @property
    def n_clusters(self) -> int:
        return len(self.experts)

    def _x(self, x) -> torch.Tensor:
        ref = self.experts[0].theta
        x = torch.as_tensor(x, dtype=ref.dtype).to(ref.device)
        return x.reshape(1, -1) if x.ndim < 2 else x

    def _hard(self) -> bool:
        return self.recombination is Recombination.HARD

    def predict(self, x) -> torch.Tensor:
        x = self._x(x)
        if self.n_clusters == 1:
            return _e_predict(self.experts[0], x)
        means = torch.stack([_e_predict(e, x) for e in self.experts])
        if self._hard():
            # (ref: predict_hard, algorithm.rs:879-935)
            cl = predict_cluster(self.gmx, x)[None, :]
            return torch.gather(means, 0, cl)[0]
        # (ref: predict_smooth, algorithm.rs:662-685)
        return torch.sum(predict_probas(self.gmx, x).T * means, dim=0)

    def predict_var(self, x) -> torch.Tensor:
        x = self._x(x)
        if self.n_clusters == 1:
            return _e_var(self.experts[0], x)
        vrs = torch.stack([_e_valvar(e, x)[1] for e in self.experts])
        if self._hard():
            return torch.gather(vrs, 0, predict_cluster(self.gmx, x)[None])[0]
        # squared responsibilities (ref: algorithm.rs:670-685)
        return torch.sum(predict_probas(self.gmx, x).T ** 2 * vrs, dim=0)

    def predict_valvar(self, x):
        return self.predict(x), self.predict_var(x)

    def predict_gradients(self, x) -> torch.Tensor:
        x = self._x(x)
        if self.n_clusters == 1:
            return _e_grad(self.experts[0], x)
        grads = torch.stack([_e_grad(e, x)
                             for e in self.experts])  # (k, n, nx)
        rows = torch.arange(x.shape[0], device=x.device)
        if self._hard():
            return grads[predict_cluster(self.gmx, x), rows]
        # product rule: d(sum p_k y_k) = sum (dp_k y_k + p_k dy_k)
        # (ref: algorithm.rs:691-783)
        probas = predict_probas(self.gmx, x)  # (n, k)
        dprobas = predict_probas_derivatives(self.gmx, x)  # (n, k, nx)
        means = torch.stack([_e_predict(e, x) for e in self.experts])
        return (torch.einsum("nkd,kn->nd", dprobas, means)
                + torch.einsum("nk,knd->nd", probas, grads))

    def predict_var_gradients(self, x) -> torch.Tensor:
        x = self._x(x)
        if self.n_clusters == 1:
            return _e_vargrad(self.experts[0], x)
        vgrads = torch.stack([_e_vargrad(e, x)
                              for e in self.experts])
        rows = torch.arange(x.shape[0], device=x.device)
        if self._hard():
            return vgrads[predict_cluster(self.gmx, x), rows]
        probas = predict_probas(self.gmx, x)
        dprobas = predict_probas_derivatives(self.gmx, x)
        vrs = torch.stack([_e_valvar(e, x)[1] for e in self.experts])
        return (2.0 * torch.einsum("nk,nkd,kn->nd", probas, dprobas, vrs)
                + torch.einsum("nk,knd->nd", probas**2, vgrads))

    def sample(self, x, n_traj: int, generator=None, method: str = "eig",
               normals=None) -> torch.Tensor:
        """Trajectories of a single-cluster mixture (ref:
        algorithm.rs:550-558); ``generator`` / ``normals`` as in
        ``gp.gp.sample``."""
        if self.n_clusters != 1:
            raise ValueError("sampling requires a single cluster")
        return gp_sample(self.experts[0], self._x(x), n_traj, generator,
                         method, normals)


def optimize_heaviside_factor(experts, gmx: GaussianMixture, xtest,
                              ytest) -> float:
    """Grid search of the smoothing factor on held-out data
    (ref: optimize_heaviside_factor, algorithm.rs:349-378). The experts'
    predictions do not depend on the factor: they are made once."""
    ref = experts[0].theta
    xtest = torch.as_tensor(xtest, dtype=ref.dtype).to(ref.device)
    ytest = torch.as_tensor(ytest, dtype=ref.dtype).to(ref.device)
    factors = np.linspace(0.1, 2.1, 20)
    denom = float(torch.sqrt(torch.sum(xtest.double() ** 2)))
    means = torch.stack([_e_predict(e, xtest) for e in experts])  # (k, p)
    errs = []
    for f in factors:
        probas = predict_probas(gmx.with_heaviside(float(f)), xtest)
        pred = torch.sum(probas.T * means, dim=0)
        errs.append(torch.sqrt(torch.sum((pred - ytest) ** 2)))
    errors = torch.stack(errs).double().cpu().numpy() / max(denom, 1e-300)
    if errors.max() < 1e-6:
        return 1.0
    return float(factors[int(np.argmin(errors))])


def expert_params(mix: GpMixture) -> list:
    """Per-expert (trend, corr, theta), which a later refit can reuse as
    fixed hyperparameters (ref: solver_impl.rs:643-645 q_optmod reuse);
    None for a sparse expert (always retrained)."""
    return [None if isinstance(e, SgpModel)
            else (e.trend, e.corr, e.theta.double().cpu().tolist())
            for e in mix.experts]


def train_moe_on_clusters(
    x,
    y,
    gmx: GaussianMixture,
    recombination: Recombination = Recombination.SMOOTH,
    *,
    regr_names: Sequence[str] = ("constant",),
    corr_names: Sequence[str] = ("squared_exponential",),
    kpls_dim: Optional[int] = None,
    n_start: int = 10,
    seed: int = 42,
    theta_init=None,
    theta_bounds=None,
    fixed_params: Optional[list] = None,
    device=None,
    dtype=None,
) -> GpMixture:
    """Retrain the experts on an existing clustering (ref:
    train_on_clusters, moe/src/algorithm.rs), the EGO solver's refit
    between reclusterings. ``fixed_params`` (per cluster (trend, corr,
    theta) of a previous fit): each expert is refit at those fixed
    hyperparameters, with no CV and no multistart (the q_optmod reuse,
    ref: solver_impl.rs:643-645). A cluster of fewer than 3 points fits on
    all the data."""
    device, dtype = _placement(x, device, dtype)
    x = np.atleast_2d(_host(x))
    y = _host(y).reshape(x.shape[0])
    gmx = gmx.to(device, dtype)
    k = gmx.n_clusters

    def fit_cluster(xc, yc, c):
        p = fixed_params[c] if fixed_params is not None else None
        if p is not None:
            trend, corr, theta = p
            xp, yp, valid = _pad_xy(xc, yc)
            return fit_gp(
                torch.as_tensor(xp, dtype=dtype).to(device),
                torch.as_tensor(yp, dtype=dtype).to(device), corr=corr,
                trend=trend, kpls_dim=kpls_dim,
                theta_init=torch.as_tensor(theta, dtype=dtype).to(device),
                theta_fixed=True, seed=seed, theta_bounds=theta_bounds,
                mask=torch.as_tensor(valid).to(device),
            )
        return find_best_expert(
            xc, yc, regr_names, corr_names, kpls_dim, n_start, seed,
            theta_init, theta_bounds, device=device, dtype=dtype,
        )

    if k == 1:
        return GpMixture([fit_cluster(x, y, 0)], gmx, recombination)
    assign = predict_cluster(
        gmx, torch.as_tensor(x, dtype=dtype).to(device)).cpu().numpy()
    experts = []
    for c in range(k):
        sel = assign == c
        if sel.sum() < 3:
            sel = np.ones(x.shape[0], dtype=bool)
        experts.append(fit_cluster(x[sel], y[sel], c))
    return GpMixture(experts, gmx, recombination)


def train_moe(
    x,
    y,
    *,
    n_clusters: int = 1,
    recombination: Recombination = Recombination.SMOOTH,
    regr_names: Sequence[str] = ("constant",),
    corr_names: Sequence[str] = ("squared_exponential",),
    kpls_dim: Optional[int] = None,
    n_start: int = 10,
    heaviside_factor: Optional[float] = None,
    seed: int = 42,
    theta_init=None,
    theta_bounds=None,
    gp_type: str = "full",
    n_inducing: int = 10,
    sparse_method: str = "FITC",
    device=None,
    dtype=None,
    times: Optional[dict] = None,
) -> GpMixture:
    """Train a mixture of GP experts (ref: train, algorithm.rs:70-205).

    ``n_clusters``: > 0 fixed; 0 automatic; < 0 automatic up to
    -n_clusters. ``gp_type``: "full" dense kriging experts or "sparse"
    FITC / VFE experts (``sparse_method``) with ``n_inducing`` points (ref:
    GpType, moe/src/parameters.rs:98-108); sparse experts take float64
    points unless ``dtype`` says otherwise (gp/sgp.py).
    ``times`` (a dict) collects the seconds of the steps: "gmm", "cv" and
    "fit" (the CV and the fits of the first experts), "heaviside",
    "retrain"."""
    if gp_type == "sparse":
        dtype = dtype or torch.float64
    device, dtype = _placement(x, device, dtype)
    x = np.atleast_2d(_host(x))
    y = _host(y).reshape(x.shape[0])
    n, nx = x.shape
    clock = _Clock(times, device)

    if n_clusters <= 0:
        from .clustering import find_best_number_of_clusters

        max_k = (n // 10 + 1) if n_clusters == 0 else -n_clusters
        k, recombination = find_best_number_of_clusters(
            x, y, max_k, regr_names, corr_names, kpls_dim, seed,
            device=device, dtype=dtype)
    else:
        k = n_clusters

    data = torch.as_tensor(np.hstack([x, y[:, None]]), dtype=dtype).to(
        device)
    expert_kw = dict(gp_type=gp_type, n_inducing=n_inducing,
                     sparse_method=sparse_method, device=device, dtype=dtype)
    if k == 1:
        expert = find_best_expert(
            x, y, regr_names, corr_names, kpls_dim, n_start, seed,
            theta_init, theta_bounds, **expert_kw)
        gmx = from_gmm_x_marginal(fit_gmm(data, 1), nx)
        return GpMixture([expert], gmx, recombination)

    gmm = fit_gmm(data, k, n_runs=20, seed=seed)
    gmx = from_gmm_x_marginal(gmm, nx)
    # hard assignment on the joint (x, y) space (ref: sort_by_cluster)
    logp = gmm_log_prob(data, gmm.means, gmm.precisions_chol) + torch.log(
        torch.clamp(gmm.weights, min=1e-300))
    assign = torch.argmax(logp, dim=1).cpu().numpy()
    clock.mark("gmm")

    smooth_opt = (recombination is Recombination.SMOOTH
                  and heaviside_factor is None)
    if smooth_opt:
        # hold out 1 point in 5 for the heaviside search, retrain after
        # (ref: algorithm.rs:106-205)
        test_idx = np.arange(n)[::5]
        train_mask = np.ones(n, dtype=bool)
        train_mask[test_idx] = False
    else:
        train_mask = np.ones(n, dtype=bool)

    def fit_experts(sel_mask, step_times):
        experts = []
        for c in range(k):
            sel = (assign == c) & sel_mask
            if sel.sum() < 3:
                sel = assign == c  # too few points: all the cluster's
            if sel.sum() < 2:
                # a cluster of one point (or none) has no likelihood to
                # fit, and egobox_tpu's fit of it raises GpFitError: all
                # the data, as train_moe_on_clusters falls back
                sel = np.ones(n, dtype=bool)
            experts.append(find_best_expert(
                x[sel], y[sel], regr_names, corr_names, kpls_dim, n_start,
                seed, theta_init, theta_bounds, times=step_times,
                **expert_kw))
        return experts

    experts = fit_experts(train_mask, times)
    clock.restart()

    if smooth_opt:
        factor = optimize_heaviside_factor(experts, gmx, x[test_idx],
                                           y[test_idx])
        gmx = gmx.with_heaviside(factor)
        clock.mark("heaviside")
        experts = fit_experts(np.ones(n, dtype=bool), None)
        clock.mark("retrain")
    elif heaviside_factor is not None:
        gmx = gmx.with_heaviside(heaviside_factor)

    return GpMixture(experts, gmx, recombination)
