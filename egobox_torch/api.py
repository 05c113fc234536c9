"""User-facing API mirroring the egobox Python bindings
(port of egobox_tpu/api.py).

Parity surface (ref: python/src/{gp_mix.rs,sparse_gp_mix.rs,sampling.rs}
and the generated egobox.pyi):

- ``Gpx.builder(...).fit(xt, yt)`` -> Gpx with predict / predict_var /
  predict_valvar / predict_gradients / predict_var_gradients / sample /
  save / load / dims / training_data / thetas / variances / likelihoods and
  the CV metrics q2 / pva / iae_alpha;
- ``SparseGpx.builder(...)`` == SparseGpMix, plus noise_variances and
  inducings;
- ``lhs(xspecs, n_samples, seed)`` and ``sampling(method, xspecs, n, seed)``
  (mixed-integer aware, through ego/mixint.py).

Conventions preserved: n_clusters > 0 fixed / 0 auto / < 0 automax(-n)
(gp_mix.rs:197-201); n_start < 0 means fixed theta (gp_mix.rs:202-208);
1-D inputs accepted, multi-output rejected (gp_mix.rs:140-236).

Fits, loads and samplings run on ``device`` (default: the GPU, and a host
without one raises; ``device="cpu"`` runs on the CPU) in its default type,
sparse models in float64 (gp/sgp.py); results come back as numpy. The saved formats are egobox_tpu's: a payload
of dicts, lists and floats under ``"egobox_tpu.GpMixture.v1"`` (experts
tagged ``"gp"`` or ``"sgp"``) or ``"egobox_tpu.Sgp.v1"``, as JSON for a
``.json`` path and pickled otherwise, so a model saved by either package
loads in the other.
"""

from __future__ import annotations

import json
import pickle
from typing import Optional, Sequence

import numpy as np
import torch

from .config import default_dtype, resolve_device
from .convert import gmx_from_numpy, gp_model_from_numpy, sgp_model_from_numpy
from .doe.full_factorial import FullFactorial as _FullFactorial
from .doe.lhs import Lhs as _Lhs
from .doe.lhs import LhsKind
from .doe.random import Random as _Random
from .ego.mixint import MixintContext, parse_xspecs
from .gp.fit import fit_gp
from .gp.sgp import (
    SgpModel,
    fit_sgp,
    sgp_predict,
    sgp_predict_gradients,
    sgp_predict_valvar,
    sgp_predict_var,
    sgp_predict_var_gradients,
    sgp_sample,
)
from .moe.gaussian_mixture import from_gmm_x_marginal
from .moe.gmm import fit_gmm
from .moe.metrics import (
    gp_fit_predict,
    iae_alpha_score,
    pva_score,
    q2_score,
    sgp_fit_predict,
)
from .moe.moe import GpMixture, train_moe
from .types import (
    CorrelationSpec,
    Recombination,
    RegressionSpec,
    Sampling,
    SparseMethod,
    correlation_spec_names,
    regression_spec_names,
)

GPX_FORMAT = "egobox_tpu.GpMixture.v1"
SGP_FORMAT = "egobox_tpu.Sgp.v1"
_GP_ARRAYS = ("x_norm", "x_mean", "x_std", "y_mean", "y_std", "theta",
              "beta", "gamma", "r_chol", "ft", "ft_qr_r", "sigma2",
              "likelihood", "mask")
_SGP_ARRAYS = ("theta", "sigma2", "noise", "z", "w_vec", "w_inv",
               "likelihood")

_LHS_KIND = {
    Sampling.LHS: LhsKind.OPTIMIZED,
    Sampling.LHS_CLASSIC: LhsKind.CLASSIC,
    Sampling.LHS_CENTERED: LhsKind.CENTERED,
    Sampling.LHS_MAXIMIN: LhsKind.MAXIMIN,
    Sampling.LHS_CENTERED_MAXIMIN: LhsKind.CENTERED_MAXIMIN,
}


def _as_xy(xt, yt):
    xt = np.asarray(xt, dtype=float)
    if xt.ndim == 1:
        xt = xt[:, None]
    yt = np.asarray(yt, dtype=float)
    if yt.ndim == 2:
        if yt.shape[1] != 1:
            raise ValueError(
                "multi-output training not supported (ref: Gpx rejects "
                f"multi-output), got {yt.shape[1]} outputs"
            )
        yt = yt[:, 0]
    return xt, yt


def _as_x(x) -> np.ndarray:
    x = np.asarray(x, dtype=float)
    return x[:, None] if x.ndim == 1 else x


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _arr(a):
    """A tensor or array as nested lists of Python numbers."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().tolist()
    return np.asarray(a).tolist()


def _write(payload: dict, path) -> bool:
    """JSON for a ``.json`` path, pickle otherwise; False on an OS error
    (ref: egobox.pyi:442-453)."""
    try:
        if str(path).endswith(".json"):
            with open(path, "w") as f:
                json.dump(payload, f)
        else:
            with open(path, "wb") as f:
                pickle.dump(payload, f)
    except OSError:
        return False
    return True


def read_payload(path) -> dict:
    """The payload of a saved Gpx or SparseGpx (either package's)."""
    if str(path).endswith(".json"):
        with open(path) as f:
            return json.load(f)
    with open(path, "rb") as f:
        return pickle.load(f)


def _fields(entry: dict) -> dict:
    fields = {k: np.asarray(v) for k, v in entry["arrays"].items()}
    fields["w_star"] = (None if entry["w_star"] is None
                        else np.asarray(entry["w_star"]))
    return fields


def _training(payload: dict):
    return (np.asarray(payload["training"]["x"]),
            np.asarray(payload["training"]["y"]))


class GpMix:
    """GP mixture builder (ref: python/src/gp_mix.rs GpMix)."""

    def __init__(
        self,
        regr_spec: RegressionSpec = RegressionSpec.CONSTANT,
        corr_spec: CorrelationSpec = CorrelationSpec.SQUARED_EXPONENTIAL,
        kpls_dim: Optional[int] = None,
        n_clusters: int = 1,
        recombination: Recombination = Recombination.HARD,
        theta_init: Optional[Sequence[float]] = None,
        theta_bounds: Optional[Sequence[Sequence[float]]] = None,
        n_start: int = 10,
        max_eval: int = 50,
        seed: Optional[int] = None,
        device=None,
    ):
        self.regr_spec = regr_spec
        self.corr_spec = corr_spec
        self.kpls_dim = kpls_dim
        self.n_clusters = n_clusters
        self.recombination = recombination
        self.theta_init = theta_init
        self.theta_bounds = theta_bounds
        self.n_start = n_start
        self.max_eval = max_eval
        self.seed = seed if seed is not None else 42
        self.device = device

    def fit(self, xt, yt) -> "Gpx":
        xt, yt = _as_xy(xt, yt)
        device = resolve_device(self.device)
        if self.n_start < 0:
            # fixed theta at theta_init (gp_mix.rs:202-208)
            ti = self.theta_init if self.theta_init is not None else 0.1
            expert = fit_gp(
                xt, yt, corr=correlation_spec_names(self.corr_spec)[0],
                trend=regression_spec_names(self.regr_spec)[0],
                kpls_dim=self.kpls_dim, theta_init=ti, theta_fixed=True,
                seed=self.seed, device=device,
            )
            data = torch.as_tensor(np.hstack([xt, yt[:, None]]),
                                   dtype=expert.theta.dtype).to(device)
            gmx = from_gmm_x_marginal(fit_gmm(data, 1, seed=self.seed),
                                      xt.shape[1])
            mixture = GpMixture([expert], gmx, self.recombination)
        else:
            mixture = train_moe(
                xt, yt,
                n_clusters=self.n_clusters,
                recombination=self.recombination,
                regr_names=regression_spec_names(self.regr_spec),
                corr_names=correlation_spec_names(self.corr_spec),
                kpls_dim=self.kpls_dim,
                n_start=self.n_start,
                seed=self.seed,
                theta_init=self.theta_init,
                theta_bounds=self.theta_bounds,
                device=device,
            )
        return Gpx(mixture, (xt, yt), builder=self)


class Gpx:
    """Trained GP mixture (ref: python/src/gp_mix.rs Gpx)."""

    def __init__(self, mixture: GpMixture, training_data, builder=None):
        self._mixture = mixture
        self._training = training_data
        self._builder = builder

    @staticmethod
    def builder(**kwargs) -> GpMix:
        return GpMix(**kwargs)

    # -- prediction -----------------------------------------------------

    def predict(self, x) -> np.ndarray:
        return _np(self._mixture.predict(_as_x(x)))

    def predict_var(self, x) -> np.ndarray:
        return _np(self._mixture.predict_var(_as_x(x)))

    def predict_valvar(self, x):
        m, v = self._mixture.predict_valvar(_as_x(x))
        return _np(m), _np(v)

    def predict_gradients(self, x) -> np.ndarray:
        return _np(self._mixture.predict_gradients(_as_x(x)))

    def predict_var_gradients(self, x) -> np.ndarray:
        return _np(self._mixture.predict_var_gradients(_as_x(x)))

    def sample(self, x, n_traj: int, seed: Optional[int] = None):
        """Trajectories (n, n_traj); the normals from a CPU generator
        seeded with ``seed`` (0 by default)."""
        gen = torch.Generator().manual_seed(seed if seed is not None else 0)
        return _np(self._mixture.sample(_as_x(x), n_traj, gen))

    # -- introspection (ref: gp_mix.rs:242-496) --------------------------

    def dims(self):
        return (self._training[0].shape[1], 1)

    def training_data(self):
        return self._training

    def thetas(self) -> np.ndarray:
        return np.stack([_np(e.theta) for e in self._mixture.experts])

    def variances(self) -> np.ndarray:
        return np.asarray([float(e.sigma2) for e in self._mixture.experts])

    def likelihoods(self) -> np.ndarray:
        return np.asarray([float(e.likelihood)
                           for e in self._mixture.experts])

    def n_clusters(self) -> int:
        return self._mixture.n_clusters

    # -- QA metrics (ref: GpQualityAssurance, moe/src/metrics.rs) ---------

    def _fit_predict_hook(self):
        """Batched CV hook: the fold fits as one stack of masked lanes
        (moe/metrics.py gp_fit_predict), on the model's device."""
        b = self._builder or GpMix()
        theta = self._mixture.experts[0].theta
        return gp_fit_predict(
            corr=correlation_spec_names(b.corr_spec)[0],
            trend=regression_spec_names(b.regr_spec)[0],
            kpls_dim=b.kpls_dim, n_start=min(max(b.n_start, 1), 5),
            seed=b.seed, max_iters=20, device=theta.device,
            dtype=theta.dtype,
        )

    def q2(self, kfold: Optional[int] = None) -> float:
        x, y = self._training
        return q2_score(x, y, self._fit_predict_hook(), kfold)

    def pva(self, kfold: Optional[int] = None) -> float:
        x, y = self._training
        return pva_score(x, y, self._fit_predict_hook(), kfold)

    def iae_alpha(self, kfold: Optional[int] = None) -> float:
        x, y = self._training
        return iae_alpha_score(x, y, self._fit_predict_hook(), kfold)

    # -- persistence (ref: moe/src/algorithm.rs:509-525 json/bincode) ----

    def save(self, path: str) -> bool:
        """True on success, False on failure (ref: egobox.pyi:442-453)."""
        return _write(_serialize_mixture(self._mixture, self._training),
                      path)

    @staticmethod
    def load(path: str, device=None) -> "Gpx":
        """A saved Gpx (either package's) on ``device`` (default: the
        GPU) in its default type."""
        return Gpx(*_deserialize_mixture(read_payload(path), device))

    def __repr__(self):
        kinds = ", ".join(
            (e.method if isinstance(e, SgpModel) else e.trend) + "_" + e.corr
            for e in self._mixture.experts)
        return (f"Gpx(n_clusters={self._mixture.n_clusters}, "
                f"recombination={self._mixture.recombination.value}, "
                f"experts=[{kinds}])")

    __str__ = __repr__


def _serialize_mixture(mix: GpMixture, training) -> dict:
    """Typed expert registry: every kind of expert serializes with a
    ``type`` tag, the JSON / pickle counterpart of the reference's typetag
    registry of dense and sparse surrogates
    (crates/moe/src/surrogates.rs:266-422)."""
    experts = []
    for e in mix.experts:
        if isinstance(e, SgpModel):
            experts.append({
                "type": "sgp",
                "corr": e.corr,
                "method": e.method,
                "arrays": {k: _arr(getattr(e, k)) for k in _SGP_ARRAYS},
                "w_star": None if e.w_star is None else _arr(e.w_star),
            })
            continue
        experts.append({
            "type": "gp",
            "corr": e.corr,
            "trend": e.trend,
            "arrays": {k: _arr(getattr(e, k)) for k in _GP_ARRAYS},
            "w_star": None if e.w_star is None else _arr(e.w_star),
        })
    g = mix.gmx
    return {
        "format": GPX_FORMAT,
        "recombination": mix.recombination.value,
        "experts": experts,
        "gmx": {
            "weights": _arr(g.weights),
            "means": _arr(g.means),
            "covariances": _arr(g.covariances),
            "precisions_chol": _arr(g.precisions_chol),
            "heaviside_factor": float(g.heaviside_factor),
        },
        "training": {"x": _arr(training[0]), "y": _arr(training[1])},
    }


def _deserialize_mixture(payload: dict, device=None):
    device = resolve_device(device)
    sparse = any(e.get("type", "gp") == "sgp" for e in payload["experts"])
    # a mixture with a sparse expert computes in float64 (gp/sgp.py)
    dtype = torch.float64 if sparse else default_dtype(device)
    experts = []
    for e in payload["experts"]:
        # entries without a type tag predate the registry: dense GP
        if e.get("type", "gp") == "sgp":
            experts.append(sgp_model_from_numpy(
                _fields(e), e["corr"], e["method"], device, dtype))
        else:
            experts.append(gp_model_from_numpy(
                _fields(e), e["corr"], e["trend"], device, dtype))
    gmx = gmx_from_numpy(payload["gmx"], device, dtype)
    mix = GpMixture(experts, gmx, Recombination(payload["recombination"]))
    return mix, _training(payload)


# ---------------------------------------------------------------------------
# Sparse GP API (ref: python/src/sparse_gp_mix.rs)
# ---------------------------------------------------------------------------


class SparseGpMix:
    """Sparse GP builder (ref: python/src/sparse_gp_mix.rs SparseGpMix)."""

    def __init__(
        self,
        corr_spec: CorrelationSpec = CorrelationSpec.SQUARED_EXPONENTIAL,
        theta_init=None,
        theta_bounds=None,
        kpls_dim: Optional[int] = None,
        n_start: int = 10,
        nz: Optional[int] = None,
        z=None,
        method: SparseMethod = SparseMethod.FITC,
        seed: Optional[int] = None,
        subsample_warmstart: Optional[int] = None,
        device=None,
    ):
        """``subsample_warmstart`` (no reference counterpart): theta starts
        from a budgeted dense-GP MLE on a k-row random subsample (gp/sgp.py
        ``fit_sgp``); at large n the joint (theta, sigma2, noise) landscape
        is a basin lottery. bench.py's n=50 000 recipe uses 2000."""
        self.corr_spec = corr_spec
        self.theta_init = theta_init
        self.theta_bounds = theta_bounds
        self.kpls_dim = kpls_dim
        self.n_start = n_start
        self.nz = nz
        self.subsample_warmstart = subsample_warmstart
        self.z = z
        self.method = method
        self.seed = seed if seed is not None else 0
        self.device = device

    def fit(self, xt, yt) -> "SparseGpx":
        xt, yt = _as_xy(xt, yt)
        model = fit_sgp(
            xt, yt,
            corr=correlation_spec_names(self.corr_spec)[0],
            method="FITC" if self.method is SparseMethod.FITC else "VFE",
            n_inducing=self.nz if self.nz is not None else 10,
            z=self.z,
            theta_init=self.theta_init,
            theta_bounds=self.theta_bounds,
            kpls_dim=self.kpls_dim,
            n_start=self.n_start,
            seed=self.seed,
            subsample_warmstart=self.subsample_warmstart,
            device=resolve_device(self.device),
        )
        return SparseGpx(model, (xt, yt))


class SparseGpx:
    """Trained sparse GP (ref: python/src/sparse_gp_mix.rs SparseGpx)."""

    def __init__(self, model: SgpModel, training_data):
        self._model = model
        self._training = training_data

    @staticmethod
    def builder(**kwargs) -> SparseGpMix:
        return SparseGpMix(**kwargs)

    def predict(self, x) -> np.ndarray:
        return _np(sgp_predict(self._model, _as_x(x)))

    def predict_var(self, x) -> np.ndarray:
        return _np(sgp_predict_var(self._model, _as_x(x)))

    def predict_valvar(self, x):
        m, v = sgp_predict_valvar(self._model, _as_x(x))
        return _np(m), _np(v)

    def predict_gradients(self, x) -> np.ndarray:
        return _np(sgp_predict_gradients(self._model, _as_x(x)))

    def predict_var_gradients(self, x) -> np.ndarray:
        return _np(sgp_predict_var_gradients(self._model, _as_x(x)))

    def sample(self, x, n_traj: int, seed: Optional[int] = None):
        """Trajectories -> array[nsamples, n_traj] (ref: egobox.pyi:733-744,
        sparse_algorithm.rs:338-361); the normals from a CPU generator
        seeded with ``seed`` (0 by default)."""
        gen = torch.Generator().manual_seed(seed if seed is not None else 0)
        return _np(sgp_sample(self._model, _as_x(x), n_traj, gen))

    def dims(self):
        return (self._training[0].shape[1], 1)

    def training_data(self):
        return self._training

    def thetas(self) -> np.ndarray:
        return _np(self._model.theta)[None, :]

    def variances(self) -> np.ndarray:
        return np.asarray([float(self._model.sigma2)])

    def noise_variances(self) -> np.ndarray:
        return np.asarray([float(self._model.noise)])

    def likelihoods(self) -> np.ndarray:
        return np.asarray([float(self._model.likelihood)])

    def inducings(self) -> np.ndarray:
        return _np(self._model.z)

    def _fit_predict_hook(self):
        """Batched CV hook: the fold refits as one stack of lanes
        (moe/metrics.py sgp_fit_predict), on the model's device."""
        m = self._model
        return sgp_fit_predict(corr=m.corr, method=m.method,
                               n_inducing=m.z.shape[0], device=m.z.device,
                               dtype=m.z.dtype)

    def save(self, path: str) -> bool:
        """True on success, False on failure (ref: egobox.pyi:660-671)."""
        m = self._model
        return _write({
            "format": SGP_FORMAT,
            "corr": m.corr,
            "method": m.method,
            "arrays": {k: _arr(getattr(m, k)) for k in _SGP_ARRAYS},
            "w_star": None if m.w_star is None else _arr(m.w_star),
            "training": {"x": _arr(self._training[0]),
                         "y": _arr(self._training[1])},
        }, path)

    @staticmethod
    def load(path: str, device=None) -> "SparseGpx":
        """A saved SparseGpx (either package's) on ``device`` (default: the
        GPU), in float64 as the sparse GP computes."""
        payload = read_payload(path)
        model = sgp_model_from_numpy(_fields(payload), payload["corr"],
                                     payload["method"],
                                     resolve_device(device))
        return SparseGpx(model, _training(payload))

    def __repr__(self):
        m = self._model
        return (f"SparseGpx(method={m.method}, corr={m.corr}, "
                f"theta={_np(m.theta)}, variance={float(m.sigma2)}, "
                f"noise_variance={float(m.noise)})")

    __str__ = __repr__


# ---------------------------------------------------------------------------
# sampling functions (ref: python/src/sampling.rs:11-88)
# ---------------------------------------------------------------------------


def sampling(method: Sampling, xspecs, n_samples: int,
             seed: Optional[int] = None, device=None) -> np.ndarray:
    """Mixed-integer-aware sampling in the folded (user) space, drawn on
    ``device`` (default: the GPU) from a CPU generator seeded with
    ``seed``."""
    ctx = MixintContext(parse_xspecs(xspecs))
    xlimits = ctx.continuous_xlimits()
    if method is Sampling.FULL_FACTORIAL:
        pts = _FullFactorial(xlimits, device=device).sample(n_samples)
    elif method is Sampling.RANDOM:
        pts = _Random(xlimits, seed=seed, device=device).sample(n_samples)
    else:
        pts = _Lhs(xlimits, kind=_LHS_KIND[method], seed=seed,
                   device=device).sample(n_samples)
    pts = _np(pts).astype(float)
    if ctx.is_discrete:
        return ctx.fold(ctx.cast_continuous(pts))
    return pts


def lhs(xspecs, n_samples: int, seed: Optional[int] = None,
        device=None) -> np.ndarray:
    """Optimized (ESE) LHS, mixint-aware (ref: sampling.rs lhs)."""
    return sampling(Sampling.LHS, xspecs, n_samples, seed, device)
