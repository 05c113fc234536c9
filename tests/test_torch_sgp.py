"""The sparse GP of egobox_torch (gp/sgp.py) and K1's gradient with respect
to theta (gp/kernels.py ``K1Gram``) against egobox_tpu on the CPU in
float64, the same numpy inputs through both; then the goldens of
tests/test_sgp.py on the port, and the port's rule for the type of the
Grams (the caller's data type; with float32 points the nugget relative to
sigma2).

JAX's draws (the inducing permutation and the LHS seeds of ``fit_sgp``, the
standard normals of ``sgp_sample``) are handed to the port: torch's streams
never reproduce threefry.

Tolerances: the likelihoods and Woodbury data at fixed parameters rtol
1e-10; predictions, variances and gradients of a converted model rtol
1e-9; the fits compare gates, not theta digits (likelihood rtol 1e-6,
predictions atol 1e-5 std(y)); the K1Gram gradient rtol 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egobox_tpu.doe.lhs import maximin_lhs as jax_maximin_lhs
from egobox_tpu.gp import sgp as jsgp
from egobox_torch.convert import sgp_model_from_numpy
from egobox_torch.gp import fit as tfit
from egobox_torch.gp import kernels as tk
from egobox_torch.gp import sgp as tsgp
from egobox_torch.ops import corr_kernel as ck

torch.set_num_threads(2)

EXACT = dict(rtol=1e-10, atol=1e-12)
L1_KERNELS = ["absolute_exponential", "matern32", "matern52"]


def _t(a):
    return torch.from_numpy(np.array(a, dtype=float))


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


def _noisy_sine(n=200, noise_std=0.1, seed=42):
    """tests/test_sgp.py's data."""
    rng = np.random.RandomState(seed)
    x = np.sort(rng.uniform(0, 4 * np.pi, (n, 1)), axis=0)
    f = np.sin(x[:, 0])
    y = f + rng.normal(0, noise_std, n)
    return x, y, f


class _JaxSgpDraws:
    """egobox_tpu's draws of ``fit_sgp(seed=s)``: key(s) split once per
    permutation (inducing rows, then the warm start's subsample), the rest
    seeding the LHS; ``sgp_fit_predict``'s per-fold keys split from
    key(s)."""

    def __init__(self, seed):
        self.seed = seed
        self.key = jax.random.key(seed)

    def permutation(self, n, device):
        k, self.key = jax.random.split(self.key)
        return torch.from_numpy(np.array(jax.random.permutation(k, n)))

    def lhs_seeds(self, n_start, dim, dtype, device):
        return torch.from_numpy(np.array(jax_maximin_lhs(
            self.key, n_start, dim, False, 5, jnp.float64))).to(dtype)

    def fold_lhs_seeds(self, n_folds, n_start, dim, dtype, device):
        keys = jax.random.split(jax.random.key(self.seed), n_folds)
        return torch.stack([torch.from_numpy(np.array(jax_maximin_lhs(
            k, n_start, dim, False, 5, jnp.float64))) for k in keys]
        ).to(dtype)


class _JaxFitDraws:
    """egobox_tpu's restart seeds of the dense ``fit_gp(seed=s)``."""

    def __init__(self, seed):
        self.seed = seed

    def lhs_seeds(self, n_start, dim, dtype, device):
        return torch.from_numpy(np.array(jax_maximin_lhs(
            jax.random.key(self.seed), n_start, dim, False, 5,
            jnp.float64))).to(dtype)


@pytest.fixture
def jax_draws(monkeypatch):
    monkeypatch.setattr(tsgp, "_sgp_draws", _JaxSgpDraws)
    monkeypatch.setattr(tfit, "_fit_draws", _JaxFitDraws)


def _sgp_fields(m):
    return {k: (None if getattr(m, k) is None else np.asarray(getattr(m, k)))
            for k in ("theta", "sigma2", "noise", "w_star", "z", "w_vec",
                      "w_inv", "likelihood")}


def _port_model(mj):
    return sgp_model_from_numpy(_sgp_fields(mj), mj.corr, mj.method,
                                device="cpu")


def _fit_problem():
    """120 noisy points of sin(3 x0) cos(3 x1) on [-1, 1]^2 and 10 located
    inducing points. Both fits are well posed here (|W_inv| <= 3e2). On
    tests/test_sgp.py's 1-d sine with 30 inducing points W_inv reaches
    1e12 and the variance sigma2 - k^T W_inv k cancels to 1e-2 absolute in
    either package (a change of BLAS thread count moves it that much): no
    parity can be held there."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-1.0, 1.0, (120, 2))
    y = np.sin(3 * x[:, 0]) * np.cos(3 * x[:, 1]) + 0.1 * rng.standard_normal(
        120)
    return x, y, x[:10]


@pytest.fixture(scope="module")
def jax_fits():
    """egobox_tpu's FITC and VFE fits of ``_fit_problem`` (given z, 5 LHS
    seeds from key(0))."""
    x, y, z = _fit_problem()
    return {m: jsgp.fit_sgp(jnp.asarray(x), jnp.asarray(y), z=jnp.asarray(z),
                            method=m, n_start=5, seed=0)
            for m in ("FITC", "VFE")}


# ---------------------------------------------------------------------------
# likelihoods at fixed parameters
# ---------------------------------------------------------------------------


def _lik_problem(seed=3, n=60, m=10):
    """Parameters (theta, theta, sigma2, noise) at which cond(Kmm) stays
    between 16 and 3.7e3: rounding then sits below 1e-12 relative, so rtol
    1e-10 compares the formulas, not two libraries' rounding (at cond 3e8
    the Woodbury vector of the two packages differs by 5e-10)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, (n, 2))
    y = (np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1])
         + 0.05 * rng.standard_normal(n))[:, None]
    z = x[rng.permutation(n)[:m]]
    params = np.array([[2.0, 3.5, 0.6, 0.01], [4.0, 1.5, 1.2, 0.2],
                       [1.5, 2.0, 0.3, 1e-4]])
    return x, y, z, params


@pytest.mark.parametrize("corr", ["squared_exponential", "matern52"])
@pytest.mark.parametrize("method", ["FITC", "VFE"])
def test_likelihood_and_woodbury_match_jax(method, corr):
    """One parameter set at a time and all of them as one stack (the
    lanes' form) against egobox_tpu's likelihood and Woodbury data."""
    x, y, z, params = _lik_problem()
    nugget = 1e-8
    jlik = jsgp._LIKELIHOODS[method]
    tlik = tsgp._LIKELIHOODS[method]
    stack = tlik(corr, _t(params[:, :2]), _t(params[:, 2]), _t(params[:, 3]),
                 _t(x), _t(y), _t(z), None, nugget)
    for i, p in enumerate(params):
        lj, wj = jlik(corr, jnp.asarray(p[:2]), jnp.asarray(p[2]),
                      jnp.asarray(p[3]), jnp.asarray(x), jnp.asarray(y),
                      jnp.asarray(z), None, nugget)
        lt, wt = tlik(corr, _t(p[:2]), _t(p[2]), _t(p[3]), _t(x), _t(y),
                      _t(z), None, nugget)
        for got in ((lt, wt.vec, wt.inv),
                    (stack[0][i], stack[1].vec[i], stack[1].inv[i])):
            np.testing.assert_allclose(float(got[0]), float(lj), **EXACT)
            np.testing.assert_allclose(_np(got[1]), np.asarray(wj.vec),
                                       rtol=1e-10, atol=1e-10)
            np.testing.assert_allclose(_np(got[2]), np.asarray(wj.inv),
                                       rtol=1e-10, atol=1e-8)


# ---------------------------------------------------------------------------
# the fit, and a converted model's predictions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["FITC", "VFE"])
def test_fit_sgp_matches_jax(method, jax_fits, jax_draws):
    """From egobox_tpu's draws (given z, its LHS seeds): the likelihood at
    the optimum and the predictions agree; theta digits are not compared
    (PERF.md: compare gates, not digits)."""
    x, y, z = _fit_problem()
    mj = jax_fits[method]
    mt = tsgp.fit_sgp(x, y, z=z, method=method, n_start=5, seed=0,
                      device="cpu")
    np.testing.assert_allclose(float(mt.likelihood), float(mj.likelihood),
                               rtol=1e-6)
    xq = np.random.default_rng(4).uniform(-1.2, 1.2, (50, 2))
    np.testing.assert_allclose(
        _np(tsgp.sgp_predict(mt, xq)),
        np.asarray(jsgp.sgp_predict(mj, jnp.asarray(xq))),
        rtol=0, atol=1e-5 * np.std(y))


@pytest.mark.parametrize("method", ["FITC", "VFE"])
def test_converted_model_predicts_as_jax(method, jax_fits):
    mj = jax_fits[method]
    mt = _port_model(mj)
    xq = np.random.default_rng(5).uniform(-1.2, 1.2, (23, 2))
    xj = jnp.asarray(xq)
    for tfun, jfun in (
        (tsgp.sgp_predict, jsgp.sgp_predict),
        (tsgp.sgp_predict_var, jsgp.sgp_predict_var),
        (tsgp.sgp_predict_gradients, jsgp.sgp_predict_gradients),
        (tsgp.sgp_predict_var_gradients, jsgp.sgp_predict_var_gradients),
    ):
        np.testing.assert_allclose(_np(tfun(mt, xq)), np.asarray(jfun(mj, xj)),
                                   rtol=1e-9, atol=1e-12)
    mean, var = tsgp.sgp_predict_valvar(mt, xq)
    jm, jv = jsgp.sgp_predict_valvar(mj, xj)
    np.testing.assert_allclose(_np(mean), np.asarray(jm), rtol=1e-9)
    np.testing.assert_allclose(_np(var), np.asarray(jv), rtol=1e-9)


@pytest.mark.parametrize("method", ["eig", "chol"])
def test_sample_with_jax_normals(method, jax_fits):
    mj = jax_fits["FITC"]
    xq = np.random.default_rng(6).uniform(-1.0, 1.0, (6, 2))
    key = jax.random.key(5)
    ref = np.asarray(jsgp.sgp_sample(mj, jnp.asarray(xq), 4, key,
                                     method=method))
    normals = _t(jax.random.normal(key, (6, 4), dtype=jnp.float64))
    got = tsgp.sgp_sample(_port_model(mj), xq, 4, method=method,
                          normals=normals)
    np.testing.assert_allclose(_np(got), ref, rtol=1e-8, atol=1e-10)


# ---------------------------------------------------------------------------
# K1Gram: the Gram's gradient with respect to theta
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", L1_KERNELS)
def test_k1gram_theta_gradient_matches_autograd(name):
    """dL/dtheta of L = sum G o r through the Function (its forward the
    plain version on CPU tensors, its backward the closed-form row-block
    contraction) against torch.autograd through the log-space formula, at
    a cross shape whose 64 rows split into row blocks (8e6 / (n2 nx) = 50
    rows per block)."""
    rng = np.random.default_rng(7)
    n1, n2, d = 64, 40_000, 4
    rows = tk._DENSE_BUDGET // (n2 * d)
    assert rows < n1
    x1, x2 = _t(rng.uniform(-1, 1, (n1, d))), _t(rng.uniform(-1, 1, (n2, d)))
    g = _t(rng.standard_normal((n1, n2)))
    theta = _t(rng.uniform(0.3, 2.0, d)).requires_grad_(True)
    before = ck.launches
    r = tk.K1Gram.apply(name, x1, x2, theta)
    (got,) = torch.autograd.grad((g * r).sum(), theta)
    ref_r = torch.exp(tk.log_corr_cross(name, x1, x2, theta))
    (ref,) = torch.autograd.grad((g * ref_r).sum(), theta)
    np.testing.assert_allclose(_np(r), _np(ref_r), **EXACT)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-10)
    assert ck.launches == before  # the plain version counts no launch


def test_corr_cross_with_theta_grad_stays_plain_on_the_cpu():
    """On CPU tensors ``corr_cross`` takes the differentiable plain formula
    whatever requires grad, and K1's wrapper counts no launch."""
    rng = np.random.default_rng(1)
    x1, x2 = _t(rng.uniform(-1, 1, (30, 3))), _t(rng.uniform(-1, 1, (40, 3)))
    theta = _t([0.5, 1.0, 2.0]).requires_grad_(True)
    before = ck.launches
    r = tk.corr_cross("matern32", x1, x2, theta)
    assert r.grad_fn is not None and ck.launches == before


# ---------------------------------------------------------------------------
# the goldens of tests/test_sgp.py on the port
# ---------------------------------------------------------------------------


def _fit(x, y, **kw):
    return tsgp.fit_sgp(x, y, device="cpu", **kw)


@pytest.mark.parametrize("method", ["FITC", "VFE"])
def test_sgp_noise_estimation(method):
    """Noise var = 0.01 +- 0.015 with 30 inducing points on n=200 noisy
    sine (ref: sparse_algorithm.rs:1004-1057); Q2 = 1 +- 2e-2."""
    x, y, f = _noisy_sine()
    m = _fit(x, y, method=method, n_inducing=30, seed=0)
    assert abs(float(m.noise) - 0.01) < 0.015
    pred = _np(tsgp.sgp_predict(m, x))
    q2 = 1 - np.sum((pred - f) ** 2) / np.sum((f - f.mean()) ** 2)
    assert abs(q2 - 1.0) < 2e-2


def test_sgp_located_inducings():
    x, y, f = _noisy_sine(150)
    z = np.linspace(0, 4 * np.pi, 25)[:, None]
    m = _fit(x, y, z=z, method="VFE")
    np.testing.assert_allclose(_np(m.z), z)
    pred = _np(tsgp.sgp_predict(m, x))
    assert np.sqrt(np.mean((pred - f) ** 2)) < 0.1


def test_sgp_variance_positive_and_grows_off_data():
    x, y, _ = _noisy_sine(100)
    m = _fit(x, y, n_inducing=20, seed=1)
    var_in = float(np.mean(_np(tsgp.sgp_predict_var(m, x[:10]))))
    var_out = float(_np(tsgp.sgp_predict_var(m, [[30.0]]))[0])
    assert var_in > 0
    assert var_out > var_in


def test_sgp_fixed_noise():
    x, y, _ = _noisy_sine(100)
    m = _fit(x, y, n_inducing=20, noise=0.05, estimate_noise=False)
    np.testing.assert_allclose(float(m.noise), 0.05)


def test_sgp_valvar_and_gradients():
    x, y, _ = _noisy_sine(100)
    m = _fit(x, y, n_inducing=20, seed=2)
    xq = np.array([[1.0], [2.0]])
    mean, var = tsgp.sgp_predict_valvar(m, xq)
    assert mean.shape == (2,) and var.shape == (2,)
    g = tsgp.sgp_predict_gradients(m, xq)
    eps = 1e-6
    fd = (float(tsgp.sgp_predict(m, [[1.0 + eps]])[0])
          - float(tsgp.sgp_predict(m, [[1.0 - eps]])[0])) / (2 * eps)
    assert abs(float(g[0, 0]) - fd) < 1e-3 * max(1.0, abs(fd))


def test_sgp_kpls():
    rng = np.random.RandomState(0)
    n, d = 120, 8
    x = rng.uniform(-1, 1, (n, d))
    y = np.sin(2 * x[:, 0]) + 0.5 * x[:, 1] + rng.normal(0, 0.05, n)
    m = _fit(x, y, kpls_dim=2, n_inducing=30, seed=3)
    assert m.theta.shape == (2,)
    pred = _np(tsgp.sgp_predict(m, x))
    assert np.corrcoef(pred, y)[0, 1] > 0.9


def test_sgp_fixed_theta():
    x, y, _ = _noisy_sine(100)
    m = _fit(x, y, n_inducing=20, theta_init=0.37, theta_fixed=True, seed=1)
    np.testing.assert_allclose(_np(m.theta), [0.37], rtol=1e-6)
    assert float(m.noise) > 0


def test_sgp_subsample_warmstart():
    x, y, _ = _noisy_sine(400)
    info = {}
    m = _fit(x, y, n_inducing=30, subsample_warmstart=100, n_start=3, seed=0,
             info=info)
    assert float(m.noise) < 0.5 * float(np.var(y))
    # the default init, the warm init and 3 seeds as one stack
    assert info["lanes"] == 5 and len(info["iterations"]) == 5
    assert info["warm_start_s"] > 0 and info["evaluations"] > 5
    xt = np.linspace(0.0, 1.0, 50)[:, None] * (x.max() - x.min()) + x.min()
    assert np.all(np.isfinite(_np(tsgp.sgp_predict(m, xt))))


def test_sgp_subsample_warmstart_kpls_rejected():
    x, y, _ = _noisy_sine(120)
    x2 = np.concatenate([x, x**2], axis=1)
    with pytest.raises(ValueError, match="subsample_warmstart"):
        _fit(x2, y, kpls_dim=1, n_inducing=20, subsample_warmstart=50)


def test_sgp_warmstart_robust_to_bad_dense_basin():
    """On a 2-d noisy sine (n=1200) the default theta lane beside the warm
    one and the 1e-1 var(y) noise init keep the fit out of the all-noise
    plateau (tests/test_sgp.py's regression)."""
    rng = np.random.default_rng(0)
    xs = rng.uniform(-1, 1, (1200, 2))
    ys = (np.sin(3 * xs[:, 0]) * np.cos(2 * xs[:, 1])
          + 0.05 * rng.standard_normal(1200))
    m = _fit(xs, ys, n_inducing=40, n_start=2, seed=0,
             subsample_warmstart=400)
    assert float(m.noise) < 0.5 * float(np.var(ys))
    yp = _np(tsgp.sgp_predict(m, xs[:300]))
    q2 = 1.0 - ((ys[:300] - yp) ** 2).sum() / (
        (ys[:300] - ys[:300].mean()) ** 2).sum()
    assert q2 > 0.9, q2


def test_fit_sgp_defaults_to_the_card():
    """numpy input with no device goes to the GPU: without one it raises,
    it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default is exercised there")
    x, y, _ = _noisy_sine(20)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsgp.fit_sgp(x, y, n_inducing=5)


# ---------------------------------------------------------------------------
# the points' type: float32 data keeps float32 points and Grams, float64
# data float64 (the algebra is float64 either way)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_grams_take_the_type_of_the_callers_data(monkeypatch, kind, dtype):
    """Every Gram of a fit, its predictions and its variance is computed
    in the caller's type (float32 or float64, numpy or tensor), with
    theta in that type too; the model keeps its inducing points in it and
    every parameter and the Woodbury data in float64. (On the card the
    float32 Grams are K1's where ``corr_cross`` takes them; float64 data
    never reaches K1.)"""
    seen = []
    plain = tsgp.corr_cross

    def spy(name, x1, x2, theta, weights=None):
        seen.append((x1.dtype, x2.dtype, theta.dtype))
        return plain(name, x1, x2, theta, weights)

    monkeypatch.setattr(tsgp, "corr_cross", spy)
    x, y, _ = _noisy_sine(60)
    x, y = x.astype(dtype), y.astype(dtype)
    if kind == "tensor":
        x, y = torch.from_numpy(x), torch.from_numpy(y)
    m = _fit(x, y, corr="matern52", n_inducing=10, n_start=2, max_iters=5,
             seed=0)
    tsgp.sgp_predict_valvar(m, np.linspace(0.0, 12.0, 7)[:, None])
    want = getattr(torch, dtype)
    assert seen and set(seen) == {(want, want, want)}
    assert m.z.dtype == want
    for f in (m.theta, m.sigma2, m.noise, m.w_vec, m.w_inv, m.likelihood):
        assert f.dtype == torch.float64


@pytest.mark.parametrize("method", ["FITC", "VFE"])
def test_float32_points_take_a_nugget_relative_to_sigma2(method):
    """With float32 points the nugget is relative to sigma2: the
    likelihood and Woodbury data equal those of float64 points with the
    absolute nugget nugget * sigma2, up to the float32 rounding of the
    Grams (rtol 1e-4 on a problem with cond(K(Z, Z)) ~1e3)."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (300, 2))
    y = np.sin(3 * x[:, 0]) + x[:, 1] + 0.05 * rng.standard_normal(300)
    z = x[:15]
    theta, sigma2, noise = _t([1.5, 0.8]), _t(2.0), _t(0.01)
    rho = 1000.0 * float(np.finfo(np.float32).eps)
    lik = tsgp._LIKELIHOODS[method]
    l32, w32 = lik("matern52", theta, sigma2, noise,
                   torch.tensor(x, dtype=torch.float32), _t(y)[:, None],
                   torch.tensor(z, dtype=torch.float32), None, rho)
    l64, w64 = lik("matern52", theta, sigma2, noise, _t(x), _t(y)[:, None],
                   _t(z), None, rho * 2.0)
    assert l32.dtype == torch.float64
    np.testing.assert_allclose(_np(l32), _np(l64), rtol=1e-4)
    np.testing.assert_allclose(_np(w32.vec), _np(w64.vec), rtol=1e-4,
                               atol=1e-4 * np.abs(_np(w64.vec)).max())
