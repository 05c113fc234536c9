"""Infill criteria: EI, LogEI (default), WB2, WB2S, and probability of
feasibility, as smooth elementwise functions of the surrogate posterior
(port of egobox_tpu/ego/criteria.py).

Behavioral parity with crates/ego/src/criteria/{ei.rs,wb2.rs} and
utils/{logei_helper.rs,cstr_pof.rs}. Gradients come from autograd. The
numerically stable log_ei_helper follows the three-branch scheme of the
reference (logei_helper.rs:22-37) with an asymptotic-series erfcx for very
large |u| where exp(u^2) erfc(u) would degenerate. Every branch is computed
on an argument clamped into its own valid region and then selected with
``torch.where``, so the unselected branches carry finite values and the
backward pass produces no NaN (the floors are the type's smallest normal
number in float32, where 1e-300 would round to 0). The one exception is an
exactly vanishing variance, where sqrt has no derivative: the optimizer
zeroes non-finite gradients.
"""

from __future__ import annotations

import torch

_SQRT_2PI = 2.5066282746310007
_INV_SQRT_2 = 0.7071067811865475
_LOG_2PI_OVER_2 = 0.9189385332046727  # log(2*pi)/2
_LOG_PI_OVER_2_OVER_2 = 0.2257913526447274  # log(pi/2)/2
_SQRT_PI = 1.7724538509055159
_LOG2 = 0.6931471805599453


def _floor(x: torch.Tensor) -> float:
    """The positive floor under logs: 1e-300, or the type's smallest normal
    number where that is larger."""
    return max(1e-300, torch.finfo(x.dtype).tiny)


def _t(v, like=None) -> torch.Tensor:
    """``v`` as a tensor: python numbers take ``like``'s type and device
    (float64 on the CPU when there is none)."""
    if isinstance(v, torch.Tensor):
        return v
    if like is not None:
        return torch.as_tensor(v, dtype=like.dtype, device=like.device)
    return torch.as_tensor(v, dtype=torch.float64)


def norm_pdf(u):
    return torch.exp(-0.5 * u * u) / _SQRT_2PI


def norm_cdf(u):
    return torch.special.ndtr(u)


def erfcx(z):
    """Scaled complementary error function exp(z^2) erfc(z) for z >= 0,
    switching to the asymptotic series where the product under/overflows:
    at z = 25 in float64, as egobox_tpu does; at z = 9 in float32, where
    erfc(z) leaves the normal range at z = 9.2 and exp(z^2) overflows at
    z = 9.4 (with the switch at 25 the product is 0 x inf = NaN for every
    u in (-35, -13) of log_ei_helper). The series' first dropped term is
    15 / (8 z^6): 3.5e-6 relative at z = 9."""
    z = _t(z)
    switch = 25.0 if z.dtype == torch.float64 else 9.0
    z_small = torch.clamp(z, max=switch)
    direct = torch.exp(z_small * z_small) * torch.special.erfc(z_small)
    zs = torch.clamp(z, min=switch)
    inv2 = 1.0 / (zs * zs)
    series = (1.0 - 0.5 * inv2 + 0.75 * inv2 * inv2) / (zs * _SQRT_PI)
    return torch.where(z < switch, direct, series)


def _log1mexp(x):
    """log(1 - exp(x)) for x <= 0, numerically stable."""
    # branch at -log 2 (Maechler 2012, same as the reference)
    a = torch.log(-torch.expm1(torch.clamp(x, max=-_floor(x))))
    b = torch.log1p(-torch.exp(torch.clamp(x, max=-_LOG2)))
    return torch.where(x > -_LOG2, a, b)


def log_ei_helper(u):
    """log(phi(u) + u * Phi(u)), stable over the whole real line
    (ref: logei_helper.rs:22-37)."""
    u = _t(u)
    # branch 1: u > -1, direct
    direct_arg = norm_pdf(u) + u * norm_cdf(u)
    b1 = torch.log(torch.clamp(direct_arg, min=_floor(u)))

    # branch 2: -1e6 < u <= -1, log phi + log1mexp(w)
    log_phi_u = -0.5 * u * u - _LOG_2PI_OVER_2
    um = torch.clamp(u, max=-1.0)  # keep branch-2 math in its valid region
    w = (
        torch.log(erfcx(-_INV_SQRT_2 * um) * torch.abs(um))
        + _LOG_PI_OVER_2_OVER_2
    )
    b2 = log_phi_u + _log1mexp(torch.clamp(w, max=-_floor(u)))

    # branch 3: u <= -1e6, asymptotic
    b3 = log_phi_u - 2.0 * torch.log(torch.clamp(torch.abs(u), min=1.0))

    return torch.where(u > -1.0, b1, torch.where(u > -1e6, b2, b3))


def _safe_sigma(var, sigma_weight=1.0):
    """(safe, s): the posterior deviation with vanishing values replaced by
    1 so that every expression downstream stays finite."""
    sigma = sigma_weight * torch.sqrt(torch.clamp(var, min=0.0))
    safe = sigma > torch.finfo(var.dtype).eps
    return safe, torch.where(safe, sigma, 1.0)


def ei(mean, var, fmin, sigma_weight=1.0):
    """Expected improvement (ref: criteria/ei.rs:15-92). Returns 0 where the
    variance vanishes (training points)."""
    var = _t(var)
    mean = _t(mean, var)
    safe, s = _safe_sigma(var, sigma_weight)
    u = (fmin - mean) / s
    val = s * (u * norm_cdf(u) + norm_pdf(u))
    return torch.where(safe, val, 0.0)


def log_ei(mean, var, fmin, sigma_weight=1.0):
    """log(EI), numerically stable (ref: criteria/ei.rs:99-174). Returns a
    large negative constant where the variance vanishes."""
    var = _t(var)
    mean = _t(mean, var)
    safe, s = _safe_sigma(var, sigma_weight)
    u = (fmin - mean) / s
    val = torch.log(s) + log_ei_helper(u)
    return torch.where(safe, val, -700.0)


def wb2(mean, var, fmin, scale=1.0, sigma_weight=1.0):
    """WB2(S) = scale * EI - predicted mean (ref: criteria/wb2.rs:14-93)."""
    return scale * ei(mean, var, fmin, sigma_weight) - mean


def wb2s_scale(means, vars, fmin, sigma_weight=1.0):
    """Auto scale for WB2S: ratio 100 at the EI argmax over a scaling cloud
    (ref: wb2.rs compute_wb2s_scale)."""
    ratio = 100.0
    ei_x = ei(means, vars, fmin, sigma_weight)
    i_max = torch.argmax(ei_x).reshape(1)
    ei_max = ei_x.reshape(-1).index_select(0, i_max)[0]
    pred_max = _t(means, ei_x).reshape(-1).index_select(0, i_max)[0]
    ok = torch.abs(ei_max) > 100.0 * torch.finfo(ei_x.dtype).eps
    one = torch.ones_like(ei_max)
    return torch.where(
        ok, ratio * torch.abs(pred_max) / torch.where(ok, ei_max, one), one
    )


def pof(mean, var, cstr_tol=0.0):
    """Probability of feasibility Phi((tol - mean)/sigma)
    (ref: utils/cstr_pof.rs:9-33). 0 where variance vanishes."""
    var = _t(var)
    mean = _t(mean, var)
    safe, s = _safe_sigma(var)
    val = norm_cdf((cstr_tol - mean) / s)
    return torch.where(safe, val, 0.0)


def log_pof(mean, var, cstr_tol=0.0):
    """log Phi((tol - mean)/sigma), stable via log_ndtr."""
    var = _t(var)
    mean = _t(mean, var)
    safe, s = _safe_sigma(var)
    val = torch.special.log_ndtr((cstr_tol - mean) / s)
    return torch.where(safe, val, -700.0)
