"""egobox_torch's reduced likelihood, analytic adjoint and L-BFGS solvers
against egobox_tpu, float64 on numpy inputs.

Tolerances: likelihood values and inner parameters rel 1e-9, gradients rel
1e-7 (the two packages sum in different orders; the adjoint's R^-1 is
formed by different triangular solves).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egobox_tpu.gp import kpls as jkpls
from egobox_tpu.gp import likelihood as jlk
from egobox_tpu.optim import lbfgsb as jopt
from egobox_torch.gp import kernels as tk
from egobox_torch.gp import likelihood as tlk
from egobox_torch.optim import lbfgsb as topt

torch.set_num_threads(2)

KERNELS = ["squared_exponential", "absolute_exponential", "matern32",
           "matern52"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _problem(n=60, d=3, seed=0, kpls=False):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2.0, 2.0, (n, d))
    y = (np.sum(np.sin(2.0 * x), axis=1)
         + 0.1 * rng.standard_normal(n))[:, None]
    xn = (x - x.mean(0)) / x.std(0, ddof=1)
    y_std = y.std(0, ddof=1)
    yn = (y - y.mean(0)) / y_std
    w = None
    dim = d
    if kpls:
        w = np.asarray(jkpls.pls_rotations(jnp.asarray(x), jnp.asarray(y),
                                           2))
        dim = 2
    theta = rng.uniform(0.3, 1.2, dim)
    return xn, yn, y_std, theta, w


def _opt(a, conv):
    return None if a is None else conv(a)


def _jax_vg(corr, trend, xn, yn, ys, theta, w, nugget, mask=None,
            probes=0):
    f = jlk.make_neg_reduced_likelihood(
        corr, trend, jnp.asarray(xn), jnp.asarray(yn), jnp.asarray(ys),
        _opt(w, jnp.asarray), nugget, _opt(mask, jnp.asarray), probes,
    )
    v, g = jax.value_and_grad(f)(jnp.asarray(theta))
    return float(v), np.asarray(g)


def _torch_vg(corr, trend, xn, yn, ys, theta, w, nugget, mask=None,
              probes=0):
    f = tlk.make_neg_reduced_likelihood(
        corr, trend, _t(xn), _t(yn), _t(ys), _opt(w, _t), nugget,
        _opt(mask, _t), probes,
    )
    th = _t(theta).clone().requires_grad_(True)
    v = f(th)
    v.backward()
    return float(v.detach()), th.grad.numpy()


@pytest.mark.parametrize("kpls", [False, True])
@pytest.mark.parametrize("corr", KERNELS)
def test_value_inner_and_gradient_match_jax(corr, kpls):
    trend = "linear" if kpls else "constant"
    xn, yn, ys, theta, w = _problem(kpls=kpls)
    rlf_t, inner_t = tlk.reduced_likelihood(
        corr, trend, _t(xn), _t(yn), _t(ys), _t(theta), _opt(w, _t), 1e-10)
    rlf_j, inner_j = jlk.reduced_likelihood(
        corr, trend, jnp.asarray(xn), jnp.asarray(yn), jnp.asarray(ys),
        jnp.asarray(theta), _opt(w, jnp.asarray), 1e-10)
    np.testing.assert_allclose(float(rlf_t), float(rlf_j), rtol=1e-9)
    for a, b in zip(inner_t, inner_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                   atol=1e-9 * np.max(np.abs(np.asarray(b))))
    v_t, g_t = _torch_vg(corr, trend, xn, yn, ys, theta, w, 1e-10)
    v_j, g_j = _jax_vg(corr, trend, xn, yn, ys, theta, w, 1e-10)
    np.testing.assert_allclose(v_t, v_j, rtol=1e-9)
    np.testing.assert_allclose(g_t, g_j, rtol=1e-7,
                               atol=1e-7 * np.max(np.abs(g_j)))


@pytest.mark.parametrize("kpls", [False, True])
@pytest.mark.parametrize("corr", KERNELS)
def test_theta_stack_matches_jax_and_one_theta(corr, kpls, monkeypatch):
    """The likelihood and its adjoint on a stack of thetas (the lanes and
    line-search trials of a lockstep multistart in one evaluation): every
    row's value, inner parameters and gradient against egobox_tpu's
    likelihood and ``jax.grad`` (values rel 1e-9, gradients rel 1e-7) and
    against the port's own one-theta form (rel 1e-11: the same arithmetic,
    batched). The block budget is cut so that the L1 family's Gram runs in
    several chunks of thetas and its adjoint in several row blocks."""
    monkeypatch.setattr(tlk, "_STACK_BUDGET", 2 * 60 * 60 * 3)
    trend = "linear" if kpls else "constant"
    xn, yn, ys, theta, w = _problem(kpls=kpls)
    rng = np.random.default_rng(12)
    thetas = theta * rng.uniform(0.5, 2.0, (5, theta.shape[0]))
    args = (corr, trend, _t(xn), _t(yn), _t(ys))
    rlf_s, inner_s = tlk.reduced_likelihood(*args, _t(thetas), _opt(w, _t),
                                            1e-10)
    assert rlf_s.shape == (5,) and inner_s.r_chol.shape == (5, 60, 60)
    f = tlk.make_neg_reduced_likelihood(*args, _opt(w, _t), 1e-10)
    th = _t(thetas).clone().requires_grad_(True)
    v_s = f(th)
    (g_s,) = torch.autograd.grad(v_s.sum(), th)
    v_s = v_s.detach()
    for i in range(5):
        rlf_1, inner_1 = tlk.reduced_likelihood(*args, _t(thetas[i]),
                                                _opt(w, _t), 1e-10)
        np.testing.assert_allclose(float(rlf_s[i]), float(rlf_1), rtol=1e-11)
        for a, b in zip(inner_s, inner_1):
            np.testing.assert_allclose(
                a[i].numpy(), b.numpy(), rtol=1e-9,
                atol=1e-11 * float(b.abs().max()))
        v_1, g_1 = _torch_vg(corr, trend, xn, yn, ys, thetas[i], w, 1e-10)
        v_j, g_j = _jax_vg(corr, trend, xn, yn, ys, thetas[i], w, 1e-10)
        np.testing.assert_allclose(float(v_s[i]), v_1, rtol=1e-11)
        np.testing.assert_allclose(float(v_s[i]), v_j, rtol=1e-9)
        np.testing.assert_allclose(g_s[i].numpy(), g_1, rtol=1e-9,
                                   atol=1e-11 * np.max(np.abs(g_1)))
        np.testing.assert_allclose(g_s[i].numpy(), g_j, rtol=1e-7,
                                   atol=1e-7 * np.max(np.abs(g_j)))
    # lanes x trials: any leading shape
    with torch.no_grad():
        v_lt = f(_t(thetas[:4].reshape(2, 2, -1)))
    np.testing.assert_allclose(v_lt.numpy().ravel(), v_s[:4].numpy(),
                               rtol=1e-12)


def test_theta_stack_keeps_a_failed_row_to_itself():
    """A theta whose R is not positive definite gives -inf in its own row
    of a stack and a zero gradient there; the other rows are untouched
    (duplicated points with no nugget fail at every theta, so the failing
    row is made by a NaN theta)."""
    xn, yn, ys, theta, _ = _problem(n=30)
    thetas = np.stack([theta, theta * np.nan, 0.5 * theta])
    f = tlk.make_neg_reduced_likelihood(
        "matern52", "constant", _t(xn), _t(yn), _t(ys), None, 1e-10)
    th = _t(thetas).clone().requires_grad_(True)
    v = f(th)
    (g,) = torch.autograd.grad(v.sum(), th)
    v = v.detach()
    assert np.isposinf(float(v[1])) and bool((g[1] == 0).all())
    for i in (0, 2):
        v_1, g_1 = _torch_vg("matern52", "constant", xn, yn, ys, thetas[i],
                             None, 1e-10)
        np.testing.assert_allclose(float(v[i]), v_1, rtol=1e-11)
        np.testing.assert_allclose(g[i].numpy(), g_1, rtol=1e-9)
    # a stack now takes a mask too: the failed row stays in its own row
    mask = torch.ones(30, dtype=torch.bool)
    mask[25:] = False
    r = tlk._build_r("matern52", _t(xn), _t(thetas), None, 1e-10, mask)
    for i in (0, 2):
        r1 = tlk._build_r("matern52", _t(xn), _t(thetas[i]), None, 1e-10,
                          mask)
        np.testing.assert_allclose(r[i].numpy(), r1.numpy(), rtol=1e-14)
    assert bool(torch.isnan(r[1, :25, :25]).all())


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("corr", KERNELS)
def test_build_r_matches_jax(corr, masked):
    """R with its unit diagonal and Gershgorin-scaled nugget, with and
    without a mask, against egobox_tpu's _build_r (float64, 1e-12). The
    nugget is large enough for the row-sum maximum to show in the
    diagonal."""
    xn, _, _, theta, _ = _problem(n=50, seed=6)
    mask = np.arange(50) < 41 if masked else None
    got = tlk._build_r(corr, _t(xn), _t(theta), None, 1e-2, _opt(mask, _t))
    ref = jlk._build_r(corr, jnp.asarray(xn), jnp.asarray(theta), None, 1e-2,
                       _opt(mask, jnp.asarray))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)
    assert float(got[0, 0]) > 1.01  # row sums above 1 scaled the nugget


@pytest.mark.parametrize("corr", ["squared_exponential", "matern32"])
def test_residual_api_matches_jax(corr):
    xn, yn, ys, theta, w = _problem(seed=1)
    t_log = np.log10(theta)
    fr_t, gr_t = tlk.make_neg_rlf_residual_api(
        corr, "constant", _t(xn), _t(yn), _t(ys), None, 1e-8)
    fr_j, gr_j = jlk.make_neg_rlf_residual_api(
        corr, "constant", jnp.asarray(xn), jnp.asarray(yn), jnp.asarray(ys),
        None, 1e-8)
    f_t, res_t = fr_t(_t(t_log))
    f_j, res_j = fr_j(jnp.asarray(t_log))
    np.testing.assert_allclose(float(f_t), float(f_j), rtol=1e-9)
    g_j = np.asarray(gr_j(jnp.asarray(t_log), res_j))
    np.testing.assert_allclose(gr_t(_t(t_log), res_t).numpy(), g_j,
                               rtol=1e-7, atol=1e-7 * np.max(np.abs(g_j)))


@pytest.mark.parametrize("corr", ["squared_exponential", "matern52"])
def test_masked_equals_unpadded(corr):
    """Padded rows (mask False, pinned to 0 in normalized space) leave the
    likelihood and its gradient unchanged."""
    xn, yn, ys, theta, _ = _problem(n=40, seed=2)
    pad = 9
    xp = np.concatenate([xn, np.zeros((pad, 3))])
    yp = np.concatenate([yn, np.zeros((pad, 1))])
    mask = np.arange(40 + pad) < 40
    v0, g0 = _torch_vg(corr, "constant", xn, yn, ys, theta, None, 1e-10)
    v1, g1 = _torch_vg(corr, "constant", xp, yp, ys, theta, None, 1e-10,
                       mask=mask)
    # the padded diagonal carries the scaled nugget (1 + 1e-10 row_max),
    # which moves log det by ~1e-9: rel 1e-8 against the unpadded problem
    np.testing.assert_allclose(v1, v0, rtol=1e-8)
    np.testing.assert_allclose(g1, g0, rtol=1e-7, atol=1e-9)
    v_j, g_j = _jax_vg(corr, "constant", xp, yp, ys, theta, None, 1e-10,
                       mask=mask)
    np.testing.assert_allclose(v1, v_j, rtol=1e-9)
    np.testing.assert_allclose(g1, g_j, rtol=1e-7,
                               atol=1e-7 * np.max(np.abs(g_j)))


def test_blocked_l1_adjoint_matches_jax(monkeypatch):
    """The closed-form Matern contraction streams row blocks above the
    dense budget; the blocks must sum to JAX's gradient. The contraction
    (``_l1_dphi``) lives in gp/kernels.py, which K1Gram's backward shares,
    and reads its budget there."""
    monkeypatch.setattr(tk, "_DENSE_BUDGET", 300)
    xn, yn, ys, theta, w = _problem(seed=3, kpls=True)
    v_t, g_t = _torch_vg("matern52", "constant", xn, yn, ys, theta, w, 1e-10)
    v_j, g_j = _jax_vg("matern52", "constant", xn, yn, ys, theta, w, 1e-10)
    np.testing.assert_allclose(g_t, g_j, rtol=1e-7,
                               atol=1e-7 * np.max(np.abs(g_j)))


@pytest.mark.parametrize("kpls", [False, True])
def test_stochastic_gradient_with_jax_probes(kpls, monkeypatch):
    """With egobox_tpu's fixed probes injected, the Hutchinson estimate of
    the squared-exponential gradient matches JAX's."""
    p = 16
    xn, yn, ys, theta, w = _problem(n=50, seed=4, kpls=kpls)
    z = np.asarray(jax.random.rademacher(jax.random.key(0xE60B0),
                                         (xn.shape[0], p), dtype=jnp.float64))
    monkeypatch.setattr(tlk, "_rademacher_probes",
                        lambda n, q, dtype, device: _t(z).to(dtype))
    v_t, g_t = _torch_vg("squared_exponential", "constant", xn, yn, ys,
                         theta, w, 1e-8, probes=p)
    v_j, g_j = _jax_vg("squared_exponential", "constant", xn, yn, ys, theta,
                       w, 1e-8, probes=p)
    np.testing.assert_allclose(v_t, v_j, rtol=1e-9)
    np.testing.assert_allclose(g_t, g_j, rtol=1e-7,
                               atol=1e-7 * np.max(np.abs(g_j)))
    # the port's own probes are Rademacher, fixed, of the requested shape
    monkeypatch.undo()
    probes = tlk._rademacher_probes(50, p, torch.float64, "cpu")
    assert probes.shape == (50, p)
    assert set(probes.unique().tolist()) <= {-1.0, 1.0}
    assert torch.equal(probes, tlk._rademacher_probes(50, p, torch.float64,
                                                      "cpu"))


def test_non_pd_gives_minus_inf_and_zero_gradient():
    """Duplicated rows without nugget: R is singular, the likelihood is
    -inf (never an exception) and the gradient is zeroed."""
    xn, yn, ys, theta, _ = _problem(n=20, seed=5)
    xn = np.concatenate([xn, xn[:5]])
    yn = np.concatenate([yn, yn[:5] + 1.0])
    v, g = _torch_vg("squared_exponential", "constant", xn, yn, ys,
                     np.full(3, 1e-3), None, 0.0)
    assert v == np.inf
    assert np.all(g == 0.0)


# --- L-BFGS-B and trust region: the cases of tests/test_lbfgsb.py --------


def rosen_t(x):
    return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                     + (1.0 - x[:-1]) ** 2)


def rosen_j(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                   + (1.0 - x[:-1]) ** 2)


def _vg_api(fun):
    """fun_and_res/grad_from_res pair from a plain scalar function."""
    def fun_and_res(x):
        return fun(x), ()

    def grad_from_res(x, res):
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            return torch.autograd.grad(fun(xx), xx)[0]

    return fun_and_res, grad_from_res


def _f64(*a):
    return [torch.as_tensor(v, dtype=torch.float64) for v in a]


def test_rosenbrock_box_matches_jax():
    lo, hi, x0 = _f64(np.full(4, -2.0), np.full(4, 2.0), np.full(4, -1.0))
    res = topt.minimize_lbfgsb(rosen_t, x0, lo, hi, max_iters=200)
    np.testing.assert_allclose(res.x.numpy(), np.ones(4), atol=2e-4)
    ref = jopt.minimize_lbfgsb(rosen_j, jnp.full(4, -1.0), jnp.full(4, -2.0),
                               jnp.full(4, 2.0), max_iters=200)
    assert res.n_iters == int(ref.n_iters)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), atol=1e-9)
    np.testing.assert_allclose(float(res.fun), float(ref.fun), atol=1e-12)


def test_active_box_face():
    # unconstrained minimum at (3, 3) is outside the box -> pinned
    lo, hi, x0 = _f64(np.zeros(2), np.full(2, 2.0), np.full(2, 0.5))
    res = topt.minimize_lbfgsb(lambda x: torch.sum((x - 3.0) ** 2), x0, lo,
                               hi, max_iters=100)
    np.testing.assert_allclose(res.x.numpy(), np.full(2, 2.0), atol=1e-8)


def test_quadratic_trajectory_matches_jax():
    q = np.diag([1.0, 4.0, 9.0])
    lo, hi, x0, qt = _f64(np.full(3, -10.0), np.full(3, 10.0),
                          [5.0, -3.0, 2.0], q)
    res = topt.minimize_lbfgsb(lambda x: 0.5 * x @ qt @ x, x0, lo, hi,
                               max_iters=60)
    ref = jopt.minimize_lbfgsb(lambda x: 0.5 * x @ jnp.asarray(q) @ x,
                               jnp.asarray([5.0, -3.0, 2.0]),
                               jnp.full(3, -10.0), jnp.full(3, 10.0),
                               max_iters=60)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), atol=1e-10)
    np.testing.assert_allclose(float(res.fun), float(ref.fun), atol=1e-12)


def test_nan_objective_region():
    """NaN regions are +inf: the solver stays in the valid region."""
    def fun(x):
        v = torch.sum((x - 1.0) ** 2)
        return torch.where(x[0] > 1.5, torch.full_like(v, np.nan), v)

    lo, hi, x0 = _f64(np.full(2, -3.0), np.full(2, 3.0), np.zeros(2))
    res = topt.minimize_lbfgsb(fun, x0, lo, hi, max_iters=100)
    assert np.isfinite(float(res.fun))
    np.testing.assert_allclose(res.x.numpy(), np.ones(2), atol=1e-5)


def test_batched_line_search_not_ported():
    """The name dates from when ``ls_batch > 0`` raised; the speculative
    line search is ported since, and the one-lane form gives egobox_tpu's
    iterates (tests/test_torch_lbfgsb.py holds the lockstep form)."""
    lo, hi, x0 = _f64(np.full(4, -2.0), np.full(4, 2.0), np.full(4, -1.0))
    res = topt.minimize_lbfgsb(rosen_t, x0, lo, hi, max_iters=12, ls_batch=8)
    ref = jopt.minimize_lbfgsb(rosen_j, jnp.full(4, -1.0), jnp.full(4, -2.0),
                               jnp.full(4, 2.0), max_iters=12, ls_batch=8)
    assert res.n_iters == int(ref.n_iters)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), atol=1e-9)


def test_tr_rosenbrock_box_matches_jax():
    fr, gr = _vg_api(rosen_t)
    lo, hi, x0 = _f64(np.full(4, -2.0), np.full(4, 2.0), np.full(4, -1.0))
    res = topt.minimize_tr(x0, lo, hi, fun_and_res=fr, grad_from_res=gr,
                           max_iters=500)
    np.testing.assert_allclose(res.x.numpy(), np.ones(4), atol=2e-4)
    ref = jopt.minimize_tr(
        jnp.full(4, -1.0), jnp.full(4, -2.0), jnp.full(4, 2.0),
        fun_and_res=lambda x: (rosen_j(x), ()),
        grad_from_res=lambda x, r: jax.grad(rosen_j)(x), max_iters=500,
    )
    assert res.n_iters == int(ref.n_iters)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), atol=1e-9)


def test_tr_active_box_face():
    fr, gr = _vg_api(lambda x: torch.sum((x - 3.0) ** 2))
    lo, hi, x0 = _f64(np.zeros(2), np.full(2, 2.0), np.full(2, 0.5))
    res = topt.minimize_tr(x0, lo, hi, fun_and_res=fr, grad_from_res=gr,
                           max_iters=100)
    np.testing.assert_allclose(res.x.numpy(), np.full(2, 2.0), atol=1e-6)


def test_tr_polish_economy_on_quadratic():
    """Few iterations from near the optimum make real progress, lane by
    lane."""
    q = torch.diag(torch.tensor([1.0, 4.0, 9.0], dtype=torch.float64))

    def fun(x):
        return 0.5 * x @ q @ x

    fr, gr = _vg_api(fun)
    lo, hi = _f64(np.full(3, -10.0), np.full(3, 10.0))
    for x0 in _f64([0.3, -0.2, 0.1], [0.05, 0.04, -0.03]):
        res = topt.minimize_tr(x0, lo, hi, fun_and_res=fr, grad_from_res=gr,
                               max_iters=6)
        assert float(res.fun) < 0.05 * float(fun(x0))


def test_tr_nan_region():
    def fun(x):
        v = torch.sum((x - 1.0) ** 2)
        return torch.where(x[0] > 1.5, torch.full_like(v, np.nan), v)

    fr, gr = _vg_api(fun)
    lo, hi, x0 = _f64(np.full(2, -3.0), np.full(2, 3.0), np.zeros(2))
    res = topt.minimize_tr(x0, lo, hi, fun_and_res=fr, grad_from_res=gr,
                           max_iters=120, delta0=2.0)
    assert np.isfinite(float(res.fun))
    np.testing.assert_allclose(res.x.numpy(), np.ones(2), atol=1e-4)


# ---------------------------------------------------------------------------
# the masked (output x lane) likelihood stack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("corr", KERNELS)
def test_masked_output_lane_stack_matches_jax(corr):
    """2 outputs x 3 thetas on a design of 14 rows padded to 20: one stack
    with y per lane against the port one theta at a time and against
    ``jax.vmap`` of egobox_tpu's likelihood and ``jax.grad``."""
    rng = np.random.default_rng(3)
    n, n_pad, d = 14, 6, 3
    x = np.concatenate([rng.uniform(-2, 2, (n, d)), np.zeros((n_pad, d))])
    mask = np.arange(n + n_pad) < n
    xn = (x - x[:n].mean(0)) / x[:n].std(0, ddof=1) * mask[:, None]
    ys = np.stack([np.sin(2 * x[:, 0]) + x[:, 1], np.cos(x[:, 2]) * x[:, 0]],
                  axis=1) * mask[:, None]
    y_std = ys[:n].std(0, ddof=1)
    yn = (ys - ys[:n].mean(0)) / y_std * mask[:, None]
    thetas = rng.uniform(0.3, 1.5, (2, 3, d))
    lanes = thetas.reshape(6, d)
    y_lanes = np.repeat(yn.T[:, None, :, None], 3, axis=1).reshape(6, -1, 1)
    s_lanes = np.repeat(y_std, 3)
    nugget = 1e-10

    f = tlk.make_neg_reduced_likelihood(
        corr, "constant", _t(xn), _t(y_lanes), _t(s_lanes), None, nugget,
        _t(mask))
    th = _t(lanes).clone().requires_grad_(True)
    v = f(th)
    (g,) = torch.autograd.grad(v.sum(), th)
    rlf, inner = tlk.reduced_likelihood(
        corr, "constant", _t(xn), _t(y_lanes), _t(s_lanes), _t(lanes), None,
        nugget, _t(mask))
    # lanes x trials: the trials of a lane are evaluated on its data
    with torch.no_grad():
        v2 = f(torch.stack([_t(lanes), 1.1 * _t(lanes)], dim=1))
    np.testing.assert_allclose(v2[:, 0].numpy(), v.detach().numpy(),
                               rtol=1e-12)

    def jax_one(theta, y, s):
        return jlk.reduced_likelihood(
            corr, "constant", jnp.asarray(xn), y, s, theta, None, nugget,
            jnp.asarray(mask))

    rlf_j, inner_j = jax.vmap(jax_one)(
        jnp.asarray(lanes), jnp.asarray(y_lanes), jnp.asarray(s_lanes))

    def jax_neg(theta, y, s):
        return jlk.make_neg_reduced_likelihood(
            corr, "constant", jnp.asarray(xn), y, s, None, nugget,
            jnp.asarray(mask))(theta)

    g_j = jax.vmap(jax.grad(jax_neg))(
        jnp.asarray(lanes), jnp.asarray(y_lanes), jnp.asarray(s_lanes))
    np.testing.assert_allclose(rlf.numpy(), np.asarray(rlf_j), rtol=1e-9)
    np.testing.assert_allclose(-v.detach().numpy(), np.asarray(rlf_j),
                               rtol=1e-9)
    for a, b in zip(inner, inner_j):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-9,
                                   atol=1e-9 * np.max(np.abs(b)))
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=1e-9,
                               atol=1e-9 * np.max(np.abs(np.asarray(g_j))))
    for i in range(6):
        rlf_1, inner_1 = tlk.reduced_likelihood(
            corr, "constant", _t(xn), _t(y_lanes[i]), _t(s_lanes[i:i + 1]),
            _t(lanes[i]), None, nugget, _t(mask))
        np.testing.assert_allclose(float(rlf[i]), float(rlf_1), rtol=1e-11)
        for a, b in zip(inner, inner_1):
            np.testing.assert_allclose(a[i].numpy(), b.numpy(), rtol=1e-9,
                                       atol=1e-11 * float(b.abs().max()))
