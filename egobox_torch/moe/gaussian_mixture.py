"""GaussianMixture: the x-marginal of the joint GMM, which weighs the experts
(port of egobox_tpu/moe/gaussian_mixture.py).

Cluster responsibilities (``predict_probas``), the hard assignment
(``predict_cluster``) and the heaviside factor f, which scales every
covariance by f, by scaling the precision factors by f^(-1/2) as the
reference does (ref: crates/moe/src/gaussian_mixture.rs:30-299). The
factor is a 0-d tensor, so that a captured program takes it as an input.
The derivatives of the responsibilities are analytic (egobox_tpu takes
``jax.jacfwd``; gaussian_mixture.rs:127-170 derives the same formula).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from .gmm import GmmParams, _precision_chol, gmm_log_prob


@dataclass(frozen=True)
class GaussianMixture:
    weights: torch.Tensor  # (k,)
    means: torch.Tensor  # (k, nx)
    covariances: torch.Tensor  # (k, nx, nx)
    precisions_chol: torch.Tensor  # (k, nx, nx): C^-T with cov = C C^T
    heaviside_factor: torch.Tensor  # 0-d

    @property
    def n_clusters(self) -> int:
        return self.means.shape[0]

    def with_heaviside(self, factor) -> "GaussianMixture":
        return dataclasses.replace(self, heaviside_factor=torch.as_tensor(
            factor, dtype=self.means.dtype).to(self.means.device))

    def to(self, device=None, dtype=None) -> "GaussianMixture":
        """The same mixture on ``device`` in ``dtype``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device=device, dtype=dtype)
            for f in dataclasses.fields(self)})


def from_gmm_x_marginal(gmm: GmmParams, nx: int) -> GaussianMixture:
    """The marginal on x of a joint (x, y) GMM (ref: moe/src/algorithm.rs,
    the gmx derived from the GMM on (x, y))."""
    covs_x = gmm.covariances[:, :nx, :nx]
    return GaussianMixture(
        weights=gmm.weights, means=gmm.means[:, :nx], covariances=covs_x,
        precisions_chol=_precision_chol(covs_x, 1e-10),
        heaviside_factor=torch.ones((), dtype=gmm.means.dtype,
                                    device=gmm.means.device))


def _scaled_pchol(gmx: GaussianMixture) -> torch.Tensor:
    """Covariances scaled by f: precision factors by f^(-1/2)."""
    return gmx.precisions_chol * gmx.heaviside_factor ** (-0.5)


def _log_weighted(gmx: GaussianMixture, x: torch.Tensor) -> torch.Tensor:
    """log(w_k N(x | mu_k, f Sigma_k)), (n, k)."""
    return gmm_log_prob(x, gmx.means, _scaled_pchol(gmx)) + torch.log(
        torch.clamp(gmx.weights, min=1e-300))


def predict_probas(gmx: GaussianMixture, x: torch.Tensor) -> torch.Tensor:
    """Cluster responsibilities at x (n, nx) -> (n, k)
    (ref: gaussian_mixture.rs:230-253)."""
    if gmx.n_clusters == 1:
        return torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device)
    return torch.softmax(_log_weighted(gmx, x), dim=1)


def predict_cluster(gmx: GaussianMixture, x: torch.Tensor) -> torch.Tensor:
    """Hard assignment, the argmax responsibility, (n,)
    (ref: gaussian_mixture.rs:302-316)."""
    if gmx.n_clusters == 1:
        return torch.zeros((x.shape[0],), dtype=torch.int64, device=x.device)
    return torch.argmax(_log_weighted(gmx, x), dim=1)


def predict_probas_derivatives(gmx: GaussianMixture,
                               x: torch.Tensor) -> torch.Tensor:
    """d probas / dx per row, (n, k, nx): with l_k the log of the weighted
    density, dl_k/dx = -P_k P_k^T (x - mu_k) (P_k the scaled precision
    factor) and dp_k/dx = p_k (dl_k/dx - sum_j p_j dl_j/dx)."""
    n, nx = x.shape
    k = gmx.n_clusters
    if k == 1:
        return torch.zeros((n, 1, nx), dtype=x.dtype, device=x.device)
    pchol = _scaled_pchol(gmx)
    p = predict_probas(gmx, x)  # (n, k)
    diffs = x[:, None, :] - gmx.means[None, :, :]  # (n, k, nx)
    z = torch.einsum("nkd,kde->nke", diffs, pchol)
    dl = -torch.einsum("kde,nke->nkd", pchol, z)  # (n, k, nx)
    mean_dl = torch.einsum("nk,nkd->nd", p, dl)
    return p[:, :, None] * (dl - mean_dl[:, None, :])
