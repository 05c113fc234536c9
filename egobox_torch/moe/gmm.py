"""Gaussian mixture model fitted by EM (port of egobox_tpu/moe/gmm.py).

k-means++ seeded EM with full covariances (the reference's linfa GMM,
crates/moe/src/algorithm.rs:120-123, n_runs=20): the ``n_runs`` restarts
are one batch dimension of every tensor, every loop has a fixed trip count,
and the best run is chosen by its final mean log-likelihood.

The random draws of a fit (the k-means++ seeding of every restart) come
from one ``GmmDraws``; a test hands in egobox_tpu's seeding instead
(torch's streams never reproduce threefry).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

from ..ops.chol_kernel import cholesky_nan


@dataclass(frozen=True)
class GmmParams:
    weights: torch.Tensor  # (k,)
    means: torch.Tensor  # (k, d)
    covariances: torch.Tensor  # (k, d, d)
    precisions_chol: torch.Tensor  # (k, d, d): C^-T with cov = C C^T
    log_likelihood: torch.Tensor  # 0-d mean log-likelihood


def _precision_chol(cov: torch.Tensor, reg: float) -> torch.Tensor:
    """C^-T for cov + reg I = C C^T (lower C), over any leading axes:
    (x - mu) @ C^-T has squared norm (x - mu)^T Sigma^-1 (x - mu). A
    covariance that is not positive definite gives NaN, as in egobox_tpu
    (the run's likelihood is then not finite and it is not chosen)."""
    d = cov.shape[-1]
    eye = torch.eye(d, dtype=cov.dtype, device=cov.device)
    c = cholesky_nan(cov + reg * eye)
    ci = torch.linalg.solve_triangular(c, eye.expand_as(c), upper=False)
    return ci.mT


def gmm_log_prob(x: torch.Tensor, means: torch.Tensor,
                 precisions_chol: torch.Tensor) -> torch.Tensor:
    """Per-component normal log-density (..., n, k) of x (..., n, d), with
    means (..., k, d) and precision factors (..., k, d, d) (ref:
    gaussian_mixture.rs:257-282)."""
    d = x.shape[-1]
    diffs = x[..., :, None, :] - means[..., None, :, :]  # (..., n, k, d)
    z = torch.einsum("...nkd,...kde->...nke", diffs, precisions_chol)
    maha = torch.sum(z**2, dim=-1)
    # log |Sigma^-1|^(1/2): the log diagonal of the precision factor
    logdet = torch.sum(torch.log(torch.abs(
        torch.diagonal(precisions_chol, dim1=-2, dim2=-1))), dim=-1)
    c = -0.5 * d * math.log(2.0 * math.pi)
    return c + logdet[..., None, :] - 0.5 * maha


class GmmDraws:
    """The draws of one GMM fit, from one CPU ``torch.Generator`` seeded
    with ``seed``."""

    def __init__(self, seed: int):
        self.generator = torch.Generator().manual_seed(seed)

    def kmeanspp(self, x: torch.Tensor, k: int, n_runs: int) -> torch.Tensor:
        """k-means++ seeding of ``n_runs`` restarts: (n_runs, k, d) centers,
        each next center drawn with probability proportional to its squared
        distance to the nearest chosen one (inverse-CDF on uniforms drawn
        up front, so the selection itself runs on x's device)."""
        n = x.shape[0]
        u = torch.rand((n_runs, k), generator=self.generator,
                       dtype=torch.float64).to(x.device)
        first = torch.clamp((u[:, 0] * n).long(), max=n - 1)
        centers = x[first][:, None, :].expand(n_runs, k, x.shape[1]).clone()
        for i in range(1, k):
            d2 = torch.sum((x[None, :, None, :] - centers[:, None, :i, :])
                           ** 2, dim=-1).amin(dim=2)  # (runs, n)
            cdf = torch.cumsum(d2, dim=1)
            target = (u[:, i].to(x.dtype) * cdf[:, -1])[:, None]
            idx = torch.clamp(torch.searchsorted(cdf, target), max=n - 1)
            centers[:, i] = x[idx[:, 0]]
        return centers


def _gmm_draws(seed: int) -> GmmDraws:
    return GmmDraws(seed)


def _kmeans(x: torch.Tensor, centers: torch.Tensor,
            n_iter: int = 10) -> torch.Tensor:
    """Lloyd iterations from centers (runs, k, d); an empty cluster keeps
    its center."""
    k = centers.shape[1]
    for _ in range(n_iter):
        d2 = torch.sum((x[None, :, None, :] - centers[:, None, :, :]) ** 2,
                       dim=-1)
        onehot = torch.nn.functional.one_hot(
            torch.argmin(d2, dim=2), k).to(x.dtype)  # (runs, n, k)
        counts = onehot.sum(dim=1)  # (runs, k)
        sums = onehot.mT @ x  # (runs, k, d)
        centers = torch.where(
            counts[..., None] > 0,
            sums / torch.clamp(counts, min=1.0)[..., None], centers)
    return centers


def _em_fit(x: torch.Tensor, centers: torch.Tensor, n_iter: int,
            reg: float) -> GmmParams:
    """EM from the k-means centers (runs, k, d): responsibilities start as
    the nearest-center one-hot, then ``n_iter`` M/E steps and a last M
    step. Every field carries the leading runs axis."""
    n = x.shape[0]
    k = centers.shape[1]
    dtype = x.dtype
    d2 = torch.sum((x[None, :, None, :] - centers[:, None, :, :]) ** 2,
                   dim=-1)
    resp = torch.nn.functional.one_hot(torch.argmin(d2, dim=2), k).to(dtype)
    eps10 = 10.0 * torch.finfo(dtype).eps

    def m_step(resp):
        nk = resp.sum(dim=1) + eps10  # (runs, k)
        weights = nk / n
        means = (resp.mT @ x) / nk[..., None]
        diffs = x[None, :, None, :] - means[:, None, :, :]  # (runs, n, k, d)
        covs = torch.einsum("rnk,rnkd,rnke->rkde", resp, diffs, diffs) / nk[
            ..., None, None]
        return weights, means, covs, _precision_chol(covs, reg)

    def e_step(weights, means, pchol):
        logp = gmm_log_prob(x[None], means, pchol) + torch.log(
            torch.clamp(weights, min=1e-30))[:, None, :]
        lse = torch.logsumexp(logp, dim=2, keepdim=True)
        return torch.exp(logp - lse), torch.mean(lse[..., 0], dim=1)

    for _ in range(n_iter):
        weights, means, _, pchol = m_step(resp)
        resp, _ = e_step(weights, means, pchol)
    weights, means, covs, pchol = m_step(resp)
    _, ll = e_step(weights, means, pchol)
    return GmmParams(weights, means, covs, pchol, ll)


def fit_gmm(x: torch.Tensor, k: int, n_runs: int = 20, n_iter: int = 50,
            reg: float = 1e-6, draws=None, seed: int = 0) -> GmmParams:
    """A k-component GMM of x (n, d): the closed form for k = 1, else the
    best of ``n_runs`` restarts (k-means++ seeding from ``draws``, default
    ``_gmm_draws(seed)``, 10 Lloyd iterations, ``n_iter`` EM steps) by final
    log-likelihood (ref: linfa GMM n_runs=20, moe/src/algorithm.rs:120-123).
    """
    if k == 1:
        mean = x.mean(dim=0)
        diff = x - mean
        cov = (diff.T @ diff) / x.shape[0]
        pchol = _precision_chol(cov, reg)[None]
        lp = gmm_log_prob(x, mean[None], pchol)
        return GmmParams(
            weights=torch.ones((1,), dtype=x.dtype, device=x.device),
            means=mean[None], covariances=cov[None], precisions_chol=pchol,
            log_likelihood=torch.mean(lp))
    if draws is None:
        draws = _gmm_draws(seed)
    centers = _kmeans(x, draws.kmeanspp(x, k, n_runs))
    runs = _em_fit(x, centers, n_iter, reg)
    lls = torch.where(torch.isfinite(runs.log_likelihood),
                      runs.log_likelihood,
                      torch.full_like(runs.log_likelihood, -torch.inf))
    best = torch.argmax(lls)
    return GmmParams(**{f.name: getattr(runs, f.name)[best]
                        for f in dataclasses.fields(GmmParams)})
