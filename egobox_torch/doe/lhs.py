"""Latin hypercube sampling (port of egobox_tpu/doe/lhs.py: kinds Classic,
Centered, Maximin, CenteredMaximin and Optimized, the ESE-refined default).

Draws come from an explicit CPU ``torch.Generator`` and are moved to
``device`` afterwards (default: the GPU; ``"cpu"`` for the CPU), so a seed
gives the same design on every device.
torch's streams never reproduce JAX's threefry bits: the designs have the
same distribution as egobox_tpu's, not the same values.
"""

from __future__ import annotations

import enum

import torch

from ..config import default_dtype, resolve_device
from .utils import cdist_sq, min_pdist_sq, pdist


class LhsKind(enum.Enum):
    """ref: crates/doe/src/lhs.rs:19-33."""

    CLASSIC = "classic"
    CENTERED = "centered"
    MAXIMIN = "maximin"
    CENTERED_MAXIMIN = "centered_maximin"
    OPTIMIZED = "optimized"


def _column_perms(ns: int, nx: int, generator) -> torch.Tensor:
    """(ns, nx) index matrix: an independent permutation per column."""
    return torch.stack(
        [torch.randperm(ns, generator=generator) for _ in range(nx)], dim=1
    )


def classic_lhs(ns: int, nx: int, generator: torch.Generator, dtype=None,
                device=None) -> torch.Tensor:
    """One point uniformly inside each of ns strata, independently permuted
    per column (ref: lhs.rs:236-257)."""
    device = resolve_device(device)
    dtype = dtype or default_dtype(device)
    u = torch.rand((ns, nx), generator=generator, dtype=dtype)
    strata = (torch.arange(ns, dtype=dtype) / ns)[:, None]
    pts = strata + u / ns
    return torch.gather(pts, 0, _column_perms(ns, nx, generator)).to(device)


def centered_lhs(ns: int, nx: int, generator: torch.Generator, dtype=None,
                 device=None) -> torch.Tensor:
    """Stratum centers, independently permuted per column
    (ref: lhs.rs:259-274)."""
    device = resolve_device(device)
    dtype = dtype or default_dtype(device)
    centers = (torch.arange(ns, dtype=dtype) + 0.5) / ns
    return centers[_column_perms(ns, nx, generator)].to(device)


def maximin_lhs(ns: int, nx: int, generator: torch.Generator,
                centered: bool = False, n_draws: int = 5, dtype=None,
                device=None) -> torch.Tensor:
    """Best of ``n_draws`` random LHS by min pairwise distance
    (ref: lhs.rs:276-297)."""
    build = centered_lhs if centered else classic_lhs
    device = resolve_device(device)
    draws = [build(ns, nx, generator, dtype, device) for _ in range(n_draws)]
    scores = torch.stack([min_pdist_sq(d) for d in draws])
    return draws[int(torch.argmax(scores))]


def _phip(x: torch.Tensor, p: float) -> torch.Tensor:
    return torch.sum(pdist(x) ** (-p)) ** (1.0 / p)


def _candidate_phip(x, phip_p, i1, i2, k: int, p: float):
    """phi_p^p after swapping entries [i1, k] <-> [i2, k], for index
    vectors i1, i2 (j,) at once, by the incremental update of
    lhs.rs:191-234 over all other rows."""
    n = x.shape[0]
    rows = torch.arange(n)
    row_mask = (rows[None, :] != i1[:, None]) & (rows[None, :] != i2[:, None])
    d1_sq = cdist_sq(x[i1], x)  # (j, n)
    d2_sq = cdist_sq(x[i2], x)
    m1 = (x[None, :, k] - x[i1, k][:, None]) ** 2
    m2 = (x[None, :, k] - x[i2, k][:, None]) ** 2
    new1 = d1_sq - m1 + m2
    new2 = d2_sq + m1 - m2
    half = p / 2.0
    delta = (new1 ** (-half) - d1_sq ** (-half)
             + new2 ** (-half) - d2_sq ** (-half))
    # the masked entries (the swapped rows themselves) may be 0 ** -half
    delta = torch.where(row_mask, delta, torch.zeros_like(delta))
    return phip_p + torch.sum(delta, dim=1)


def maximin_ese(generator: torch.Generator, lhs0: torch.Tensor,
                outer_loop: int, inner_loop: int, j_range: int = 20):
    """ESE optimization of the phi_p (p = 10) maximin criterion
    (ref: lhs.rs:120-185). The outer loop adapts an acceptance temperature;
    each inner step proposes ``j_range`` single-column swaps, evaluated in
    one batched update, takes the best and accepts it by a
    simulated-annealing threshold. Runs on the CPU (``lhs0`` is a CPU
    tensor: the design is small and every step is a host decision)."""
    p = 10.0
    tol = 1e-3
    n, nx = lhs0.shape
    x = lhs0.clone()
    phip = float(_phip(x, p))
    x_best, phip_best = x.clone(), phip
    t = 0.005 * phip
    for _ in range(outer_loop):
        i1s = torch.randint(0, n, (inner_loop, j_range), generator=generator)
        i2s = torch.randint(0, n - 1, (inner_loop, j_range),
                            generator=generator)
        i2s = torch.where(i2s >= i1s, i2s + 1, i2s)  # i2 != i1
        us = torch.rand((inner_loop,), generator=generator,
                        dtype=torch.float64).tolist()
        n_acpt = n_imp = 0
        for i in range(inner_loop):
            k = (i + 1) % nx
            i1, i2 = i1s[i], i2s[i]
            cand = torch.clamp(
                _candidate_phip(x, phip**p, i1, i2, k, p), min=0.0
            ) ** (1.0 / p)
            j = int(torch.argmin(cand))
            phip_try = float(cand[j])
            if (phip_try - phip) <= t * us[i]:
                a, b = int(i1[j]), int(i2[j])
                va, vb = x[a, k].item(), x[b, k].item()
                x[a, k], x[b, k] = vb, va
                phip = phip_try
                n_acpt += 1
                if phip_try < phip_best:
                    x_best, phip_best = x.clone(), phip_try
                    n_imp += 1
        p_accpt = n_acpt / inner_loop
        p_imp = n_imp / inner_loop
        # temperature schedule (ref: lhs.rs:168-182)
        if (phip - phip_best) > tol:
            if p_accpt >= 0.1 and p_imp < p_accpt:
                t *= 0.8
            elif not (p_accpt >= 0.1 and p_imp >= p_accpt):
                t /= 0.8
        else:
            t = t / 0.7 if p_accpt <= 0.1 else t * 0.9
    return x_best


def optimized_lhs(ns: int, nx: int, generator: torch.Generator, dtype=None,
                  device=None) -> torch.Tensor:
    """Classic LHS refined by ESE (the reference default kind). Loop sizes
    per lhs.rs:81-83."""
    device = resolve_device(device)
    dtype = dtype or default_dtype(device)
    # the refinement runs in float64 on the CPU whatever the target type
    lhs0 = classic_lhs(ns, nx, generator, torch.float64, "cpu")
    if ns < 2:
        return lhs0.to(device=device, dtype=dtype)
    outer = min(int(1.5 * nx), 30)
    inner = min(20 * nx, 100)
    out = maximin_ese(generator, lhs0, max(outer, 1), inner)
    return out.to(device=device, dtype=dtype)


def lhs_normalized(generator: torch.Generator, ns: int, nx: int,
                   kind: LhsKind = LhsKind.OPTIMIZED, dtype=None,
                   device=None) -> torch.Tensor:
    """Sample ns points in [0, 1]^nx."""
    if kind is LhsKind.CLASSIC:
        return classic_lhs(ns, nx, generator, dtype, device)
    if kind is LhsKind.CENTERED:
        return centered_lhs(ns, nx, generator, dtype, device)
    if kind is LhsKind.MAXIMIN:
        return maximin_lhs(ns, nx, generator, False, 5, dtype, device)
    if kind is LhsKind.CENTERED_MAXIMIN:
        return maximin_lhs(ns, nx, generator, True, 5, dtype, device)
    if kind is LhsKind.OPTIMIZED:
        return optimized_lhs(ns, nx, generator, dtype, device)
    raise ValueError(f"unknown LHS kind: {kind}")


def scale_to_xlimits(samples: torch.Tensor, xlimits: torch.Tensor):
    """Affine map [0,1]^nx -> xlimits (nx, 2) (ref: doe/src/traits.rs)."""
    lo = xlimits[:, 0]
    hi = xlimits[:, 1]
    return samples * (hi - lo) + lo


class Lhs:
    """Object API mirroring egobox_doe::Lhs (ref: doe/src/lhs.rs).

    ``xlimits`` is an (nx, 2) array of [lower, upper] rows; samples land on
    ``device`` (default: the GPU; ``"cpu"`` for the CPU)."""

    def __init__(self, xlimits, kind: LhsKind = LhsKind.OPTIMIZED, seed=None,
                 device=None):
        device = resolve_device(device)
        self.xlimits = torch.as_tensor(xlimits, dtype=default_dtype(device),
                                       device=device)
        if self.xlimits.ndim != 2 or self.xlimits.shape[1] != 2:
            raise ValueError("xlimits must have shape (nx, 2)")
        self.kind = kind
        self.generator = torch.Generator().manual_seed(
            0 if seed is None else seed)

    def normalized_sample(self, ns: int) -> torch.Tensor:
        return lhs_normalized(self.generator, ns, self.xlimits.shape[0],
                              self.kind, self.xlimits.dtype,
                              self.xlimits.device)

    def sample(self, ns: int) -> torch.Tensor:
        return scale_to_xlimits(self.normalized_sample(ns), self.xlimits)
