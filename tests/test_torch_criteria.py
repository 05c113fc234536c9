"""egobox_torch's infill criteria against egobox_tpu's, float64 on the CPU.

Values: rtol 1e-12 over a grid of u from -1e7 to 10 that includes the branch
points -1 and -1e6 and a vanishing variance. Gradients (autograd against
``jax.grad``): rtol 1e-9 on the same grid without the two branch points,
where ``jnp.minimum`` splits the gradient of a tie in halves and
``torch.clamp`` passes it whole (the branch the tie selects has the whole
derivative). EI and WB2 in their direct form phi(u) + u Phi(u) cancel
catastrophically in the left tail on both sides (the result is rounding
noise of either library's ndtr): their gradients are compared for u >= -7.5
(and to 1e-15 sigma absolute everywhere); pof is a bare ndtr, which the
two libraries compute to a few 1e-12 relative of each other. The gradients with respect
to mean and variance are differences of terms of size 1/sigma and 1/var:
they get 1e-13 of that size as absolute tolerance. The goldens of
tests/test_criteria.py are held on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egobox_tpu.ego import criteria as jc
from egobox_torch.ego import criteria as tc

torch.set_num_threads(2)

U_GRID = np.concatenate([
    -np.logspace(7, -3, 41), [-1.0, -1e6, 0.0], np.linspace(0.01, 10.0, 12),
])
U_SMOOTH = U_GRID[(U_GRID != -1.0) & (U_GRID != -1e6)]
FMIN = 0.3


def _posterior(u, var):
    """mean such that (FMIN - mean) / sqrt(var) == u."""
    return FMIN - u * np.sqrt(var), np.full_like(u, var)


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


@pytest.mark.parametrize("name", ["erfcx", "_log1mexp", "log_ei_helper"])
def test_helpers_match_jax(name):
    if name == "erfcx":
        z = np.concatenate([np.linspace(0.0, 30.0, 61), [25.0, 1e3, 1e7]])
    elif name == "_log1mexp":
        z = -np.concatenate([np.logspace(-12, 3, 40), [np.log(2.0)]])
    else:
        z = U_GRID
    want = np.asarray(getattr(jc, name)(jnp.asarray(z)))
    got = getattr(tc, name)(_t(z)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("name", ["ei", "log_ei", "wb2", "pof", "log_pof"])
@pytest.mark.parametrize("var", [2.5, 1e-6])
def test_criteria_values_and_grads_match_jax(name, var):
    def call(mod, mean, v):
        f = getattr(mod, name)
        if name in ("pof", "log_pof"):
            return f(mean, v, FMIN)
        if name == "wb2":
            return f(mean, v, FMIN, 3.0, 1.5)
        return f(mean, v, FMIN, 1.5)

    direct = name in ("ei", "wb2")
    sigma = 1.5 * np.sqrt(var)
    mean, v = _posterior(U_GRID, var)
    want = np.asarray(call(jc, jnp.asarray(mean), jnp.asarray(v)))
    got = call(tc, _t(mean), _t(v)).numpy()
    # the direct forms are sums that cancel in the left tail: absolute
    # tolerance at the rounding noise of their terms; pof's ndtr differs
    # between the libraries by a few 1e-12 relative
    # (and log_ndtr of a large argument, a value near -0, by 1e-16)
    rtol, atol = {"pof": (1e-11, 1e-16), "log_pof": (1e-12, 1e-15)}.get(
        name, (1e-12, 1e-15 * sigma if direct else 1e-300))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)

    u = U_SMOOTH[U_SMOOTH >= -5.0 * 1.5] if direct else U_SMOOTH
    if name in ("pof", "log_pof"):
        # the derivative of either library's log_ndtr loses digits in the
        # far tail, each in its own way (1e-10 apart at u = -30, 1e-2 at
        # -1e7): the tail is held to that, the rest to rtol 1e-9
        mean, v = _posterior(U_SMOOTH[U_SMOOTH < -10.0], var)
        gj = jax.vmap(jax.grad(lambda m, s: call(jc, m, s)))(
            jnp.asarray(mean), jnp.asarray(v))
        mt = _t(mean).requires_grad_(True)
        (gt,) = torch.autograd.grad(call(tc, mt, _t(v)).sum(), mt)
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=2e-2,
                                   atol=1e-300)
        u = U_SMOOTH[U_SMOOTH >= -10.0]
    mean, v = _posterior(u, var)
    gj = jax.vmap(jax.grad(lambda m, s: call(jc, m, s), argnums=(0, 1)))(
        jnp.asarray(mean), jnp.asarray(v))
    mt, vt = _t(mean).requires_grad_(True), _t(v).requires_grad_(True)
    gt = torch.autograd.grad(call(tc, mt, vt).sum(), (mt, vt))
    for a, b, size in zip(gt, gj, (1.0 / np.sqrt(var), 1.0 / var)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                   atol=1e-13 * size)


@pytest.mark.parametrize("name", ["ei", "log_ei", "pof", "log_pof"])
def test_vanishing_variance_matches_jax(name):
    mean = np.array([0.5, -1.0, 0.2])
    var = np.array([0.0, 1e-40, -1e-9])
    want = np.asarray(getattr(jc, name)(jnp.asarray(mean), jnp.asarray(var),
                                        FMIN))
    got = getattr(tc, name)(_t(mean), _t(var), FMIN).numpy()
    np.testing.assert_array_equal(got, want)


def test_wb2s_scale_matches_jax():
    rng = np.random.default_rng(0)
    means, vrs = rng.normal(0.0, 2.0, 50), rng.uniform(0.0, 3.0, 50)
    want = float(jc.wb2s_scale(jnp.asarray(means), jnp.asarray(vrs), FMIN))
    got = float(tc.wb2s_scale(_t(means), _t(vrs), FMIN))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    # no improvement anywhere: the scale falls back to 1
    assert float(tc.wb2s_scale(_t(means + 1e3), _t(vrs * 0), FMIN)) == 1.0


def test_float32_backward_is_finite():
    """The floors under the logs are float32's smallest normal number, not
    a 1e-300 that rounds to 0: no branch feeds NaN into the backward."""
    u = torch.tensor(U_GRID, dtype=torch.float32, requires_grad=True)
    (g,) = torch.autograd.grad(tc.log_ei_helper(u).sum(), u)
    assert torch.isfinite(g).all()
    got = tc.log_ei_helper(u).detach()
    assert torch.isfinite(got).all()
    # and the float32 values follow the float64 ones through the whole tail
    want = tc.log_ei_helper(_t(U_GRID))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5)


def test_log_ei_helper_goldens():
    """Values from the trieste implementation (logei_helper.rs:75-84)."""
    expected = [-4.7687836, -2.4851208, -0.9189385, 0.08002624, 0.69738346]
    got = tc.log_ei_helper(_t([-2.0, -1.0, 0.0, 1.0, 2.0]))
    np.testing.assert_allclose(got.numpy(), expected, atol=1e-6)


def test_log_ei_helper_grad_vs_fdiff():
    """(ref: logei_helper.rs test_d_log_ei, atol 1e-3 over [-10, 10])"""
    xs = _t(np.linspace(-10.0, 10.0, 100)).requires_grad_(True)
    (g,) = torch.autograd.grad(tc.log_ei_helper(xs).sum(), xs)
    eps = 1e-6
    with torch.no_grad():
        fd = (tc.log_ei_helper(xs + eps) - tc.log_ei_helper(xs - eps)) \
            / (2 * eps)
    np.testing.assert_allclose(g.numpy(), fd.numpy(), atol=1e-3)


def test_log_ei_helper_extreme_negative():
    got = tc.log_ei_helper(_t([-50.0, -1e3, -1e7])).numpy()
    assert np.all(np.isfinite(got))
    assert got[0] > got[1] > got[2]


def test_log_ei_consistent_with_ei():
    mean, var, fmin = 0.3, 0.5, 0.1
    np.testing.assert_allclose(np.log(float(tc.ei(mean, var, fmin))),
                               float(tc.log_ei(mean, var, fmin)), rtol=1e-10)


def test_ei_zero_at_training_point():
    assert float(tc.ei(0.5, 0.0, 1.0)) == 0.0
    assert float(tc.log_ei(0.5, 0.0, 1.0)) == -700.0


def test_ei_grad_vs_fdiff():
    fmin = 0.1

    def f(z):
        return tc.ei(z[0], torch.abs(z[1]), fmin)

    z0 = _t([0.4, 0.3]).requires_grad_(True)
    (g,) = torch.autograd.grad(f(z0), z0)
    eps = 1e-6
    for k in range(2):
        e = torch.zeros(2, dtype=torch.float64)
        e[k] = eps
        with torch.no_grad():
            fd = (f(z0 + e) - f(z0 - e)) / (2 * eps)
        np.testing.assert_allclose(float(g[k]), float(fd), rtol=1e-5)


def test_pof():
    assert float(tc.pof(-10.0, 0.01, 0.0)) > 0.999
    assert float(tc.pof(10.0, 0.01, 0.0)) < 1e-6
    # zero variance -> 0 by convention (ref: cstr_pof.rs:15-21)
    assert float(tc.pof(-1.0, 0.0, 0.0)) == 0.0
    np.testing.assert_allclose(float(tc.log_pof(0.5, 1.0, 0.0)),
                               np.log(float(tc.pof(0.5, 1.0, 0.0))),
                               rtol=1e-10)


def test_wb2():
    mean, var, fmin = 0.4, 0.2, 0.1
    v = float(tc.wb2(mean, var, fmin, scale=2.0))
    np.testing.assert_allclose(v, 2.0 * float(tc.ei(mean, var, fmin)) - mean,
                               rtol=1e-12)
