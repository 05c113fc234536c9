"""The mixture of GP experts of egobox_torch (moe/ and the GP gradients it
takes) against egobox_tpu's on the CPU in float64, the same numpy inputs
through both. JAX's draws (the GMM's k-means++ seeding, the fits' restart
seeds) are handed to the port: torch's streams never reproduce threefry.

Tolerances: the exact paths (densities, EM from the same seeding, the
mixture's predictions and gradients at the same experts, the metrics'
formulas) rtol 1e-10; the fits, as tests/test_torch_fit.py holds them,
theta rtol 1e-5 and likelihood rtol 1e-8 (well-posed designs), and the CV
errors rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egobox_tpu import gp as jgp
from egobox_tpu import moe as jmoe
from egobox_tpu.doe.lhs import maximin_lhs as jax_maximin_lhs
from egobox_tpu.moe import gmm as jgmm
from egobox_tpu.moe import moe as jmoe_mod
from egobox_tpu.types import Recombination as JRecomb
from egobox_torch import gp as tgp
from egobox_torch import moe as tmoe
from egobox_torch.convert import (gmx_from_numpy, gp_mixture_from_numpy,
                                  gp_model_from_numpy)
from egobox_torch.gp import fit as tfit
from egobox_torch.moe import gmm as tgmm
from egobox_torch.moe import metrics as tmetrics
from egobox_torch.moe import moe as tmoe_mod
from egobox_torch.types import Recombination

torch.set_num_threads(2)

EXACT = dict(rtol=1e-10, atol=1e-12)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=float))


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


def _two_regime(n=60, seed=0):
    """tests/test_moe.py's piecewise data with two regimes."""
    rng = np.random.RandomState(seed)
    x = np.sort(rng.uniform(0, 1, (n, 1)), axis=0)
    y = np.where(x[:, 0] < 0.5, 10.0 + 2.0 * x[:, 0], -5.0 * x[:, 0] + 1.0)
    return x, y


def _two_blobs(seed=0):
    """Two regimes on two blobs of a 2-d input, 10 % noise: the clusters
    are plain and every expert's fit is well posed at egobox_tpu's nugget
    of 100 eps (on 1-d branches the likelihood drives theta towards a
    near-singular Gram, where the two packages agree to 1e-5 only)."""
    rng = np.random.RandomState(seed)
    x = np.vstack([rng.uniform(0, 1, (20, 2)), rng.uniform(2, 3, (20, 2))])
    y = np.where(x[:, 0] < 1.5, np.sin(4 * x[:, 0]) * np.cos(3 * x[:, 1]),
                 4.0 + x[:, 0] * x[:, 1]) + 0.1 * rng.standard_normal(40)
    return x, y


def _blobs(seed=0):
    rng = np.random.RandomState(seed)
    return np.vstack([rng.normal(0.0, 0.3, (30, 2)),
                      rng.normal(5.0, 0.3, (30, 2))])


class _JaxFitDraws:
    """egobox_tpu's restart seeds for ``seed``: maximin_lhs(key(seed))."""

    def __init__(self, seed):
        self.seed = seed

    def lhs_seeds(self, n_start, dim, dtype, device):
        return torch.from_numpy(np.array(jax_maximin_lhs(
            jax.random.key(self.seed), n_start, dim, False, 5,
            jnp.float64))).to(dtype=dtype, device=device)


class _JaxGmmDraws:
    """egobox_tpu's k-means++ seeding of fit_gmm's restarts for ``seed``."""

    def __init__(self, seed):
        self.seed = seed

    def kmeanspp(self, x, k, n_runs):
        keys = jax.random.split(jax.random.key(self.seed), n_runs)
        xj = jnp.asarray(x.numpy())
        c = jax.vmap(lambda kk: jgmm._kmeanspp_init(kk, xj, k))(keys)
        return torch.from_numpy(np.array(c))


@pytest.fixture
def jax_draws(monkeypatch):
    monkeypatch.setattr(tfit, "_fit_draws", _JaxFitDraws)
    monkeypatch.setattr(tgmm, "_gmm_draws", _JaxGmmDraws)


def _fields(mj):
    return {k: (None if getattr(mj, k) is None else np.asarray(getattr(mj, k)))
            for k in mj.__dataclass_fields__ if k not in ("corr", "trend")}


def _gmx_fields(g):
    return {k: np.asarray(getattr(g, k)) for k in g.__dataclass_fields__}


def _port_mixture(mj):
    return gp_mixture_from_numpy(
        [(_fields(e), e.corr, e.trend) for e in mj.experts],
        _gmx_fields(mj.gmx), mj.recombination.value, device="cpu")


def _assert_same_expert(et, ej, x_test):
    assert (et.corr, et.trend) == (ej.corr, ej.trend)
    np.testing.assert_allclose(_np(et.theta), np.asarray(ej.theta),
                               rtol=1e-5)
    np.testing.assert_allclose(float(et.likelihood), float(ej.likelihood),
                               rtol=1e-8)
    np.testing.assert_allclose(
        _np(tgp.predict(et, _t(x_test))),
        np.asarray(jgp.predict(ej, jnp.asarray(x_test))), rtol=0, atol=1e-7)


# ---------------------------------------------------------------------------
# gmm.py
# ---------------------------------------------------------------------------


def test_gmm_log_prob_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(25, 3))
    means = rng.normal(size=(2, 3))
    a = rng.normal(size=(2, 3, 3))
    covs = a @ np.swapaxes(a, 1, 2) + 0.5 * np.eye(3)
    pj = jax.vmap(lambda c: jgmm._precision_chol(c, 1e-6))(jnp.asarray(covs))
    pt = tgmm._precision_chol(_t(covs), 1e-6)
    np.testing.assert_allclose(_np(pt), np.asarray(pj), **EXACT)
    np.testing.assert_allclose(
        _np(tgmm.gmm_log_prob(_t(x), _t(means), pt)),
        np.asarray(jgmm.gmm_log_prob(jnp.asarray(x), jnp.asarray(means), pj)),
        **EXACT)


def test_em_fit_from_jax_kmeanspp_matches_jax():
    """EM from egobox_tpu's k-means++ seeding of 5 restarts: every run's
    weights, means, covariances, precision factors and likelihood."""
    x = _blobs()
    keys = jax.random.split(jax.random.key(3), 5)
    runs_j = jax.vmap(lambda kk: jgmm._em_fit(kk, jnp.asarray(x), 2, 50,
                                              1e-6))(keys)
    centers = _JaxGmmDraws(3).kmeanspp(_t(x), 2, 5)
    runs_t = tgmm._em_fit(_t(x), tgmm._kmeans(_t(x), centers), 50, 1e-6)
    for name in ("weights", "means", "covariances", "precisions_chol",
                 "log_likelihood"):
        np.testing.assert_allclose(_np(getattr(runs_t, name)),
                                   np.asarray(getattr(runs_j, name)),
                                   err_msg=name, **EXACT)


def test_fit_gmm_best_run_and_k1_match_jax(jax_draws):
    x = _blobs(1)
    for k in (1, 2):
        gj = jgmm.fit_gmm(jax.random.key(4), jnp.asarray(x), k, n_runs=6)
        gt = tgmm.fit_gmm(_t(x), k, n_runs=6, seed=4)
        for name in gj._fields:
            np.testing.assert_allclose(_np(getattr(gt, name)),
                                       np.asarray(getattr(gj, name)),
                                       err_msg=f"k={k} {name}", **EXACT)


def test_fit_gmm_separates_clusters_like_jax():
    """The port's own seeding: the same labels as egobox_tpu's fit up to a
    permutation (tests/test_moe.py::test_gmm_separates_clusters)."""
    x = np.vstack([np.random.RandomState(0).normal(0.0, 0.3, (100, 2)),
                   np.random.RandomState(1).normal(5.0, 0.3, (100, 2))])
    gj = jgmm.fit_gmm(jax.random.key(0), jnp.asarray(x), 2, n_runs=5)
    gt = tgmm.fit_gmm(_t(x), 2, n_runs=5, seed=0)

    def labels(means, pchol, w):
        lp = np.asarray(jgmm.gmm_log_prob(jnp.asarray(x), jnp.asarray(means),
                                          jnp.asarray(pchol)))
        return np.argmax(lp + np.log(np.asarray(w)), axis=1)

    lj = labels(gj.means, gj.precisions_chol, gj.weights)
    lt = labels(_np(gt.means), _np(gt.precisions_chol), _np(gt.weights))
    assert np.array_equal(lj, lt) or np.array_equal(lj, 1 - lt)
    np.testing.assert_allclose(np.sort(_np(gt.weights)), [0.5, 0.5],
                               atol=0.05)


# ---------------------------------------------------------------------------
# gaussian_mixture.py
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gmx_pair():
    """A joint (x, y) GMM of egobox_tpu, its x marginal in both packages."""
    rng = np.random.RandomState(2)
    x = np.vstack([rng.normal(0.0, 0.6, (40, 2)), rng.normal(2.0, 0.5,
                                                             (40, 2))])
    y = np.where(x[:, 0] < 1.0, 1.0, -1.0) + 0.1 * x[:, 1]
    xy = jnp.asarray(np.hstack([x, y[:, None]]))
    gmm_j = jgmm.fit_gmm(jax.random.key(1), xy, 2, n_runs=4)
    gmm_t = tgmm.GmmParams(**{k: _t(getattr(gmm_j, k))
                              for k in gmm_j._fields})
    return (jmoe.from_gmm_x_marginal(gmm_j, 2),
            tmoe.from_gmm_x_marginal(gmm_t, 2))


@pytest.mark.parametrize("factor", [1.0, 0.37, 1.9])
def test_gaussian_mixture_matches_jax(gmx_pair, factor):
    """The x marginal, the responsibilities, the hard assignment and the
    responsibilities' derivatives (analytic here, jax.jacfwd there), at
    heaviside factors 1, 0.37 and 1.9."""
    gj, gt = gmx_pair
    for name in ("weights", "means", "covariances", "precisions_chol"):
        np.testing.assert_allclose(_np(getattr(gt, name)),
                                   np.asarray(getattr(gj, name)), **EXACT)
    gj, gt = gj.with_heaviside(factor), gt.with_heaviside(factor)
    xq = np.random.default_rng(5).uniform(-1.0, 3.0, (30, 2))
    xj, xt = jnp.asarray(xq), _t(xq)
    np.testing.assert_allclose(_np(tmoe.predict_probas(gt, xt)),
                               np.asarray(jmoe.predict_probas(gj, xj)),
                               **EXACT)
    np.testing.assert_array_equal(_np(tmoe.predict_cluster(gt, xt)),
                                  np.asarray(jmoe.predict_cluster(gj, xj)))
    np.testing.assert_allclose(
        _np(tmoe.predict_probas_derivatives(gt, xt)),
        np.asarray(jmoe.predict_probas_derivatives(gj, xj)), **EXACT)
    # one cluster: probas 1, derivatives 0
    g1 = tmoe.GaussianMixture(gt.weights[:1] * 0 + 1, gt.means[:1],
                              gt.covariances[:1], gt.precisions_chol[:1],
                              gt.heaviside_factor)
    assert bool(torch.all(tmoe.predict_probas(g1, xt) == 1.0))
    assert bool(torch.all(tmoe.predict_probas_derivatives(g1, xt) == 0.0))


def test_gmx_from_numpy_rejects_missing_fields():
    with pytest.raises(ValueError, match="missing"):
        gmx_from_numpy({"weights": np.ones(2)}, device="cpu")


# ---------------------------------------------------------------------------
# gp/gp.py: gradients and sampling
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def kriging_1d():
    """tests/test_gp.py's 1-d golden model, fitted by egobox_tpu and served
    by the port."""
    xt = np.array([[0.0], [1.0], [2.0], [3.0], [4.0]])
    yt = np.array([0.0, 1.0, 1.5, 0.9, 1.0])
    mj = jgp.fit_gp(jnp.asarray(xt), jnp.asarray(yt))
    return mj, gp_model_from_numpy(_fields(mj), mj.corr, mj.trend,
                                   device="cpu")


@pytest.fixture(scope="module")
def matern_2d():
    rng = np.random.default_rng(6)
    x = rng.uniform(-2.0, 2.0, (25, 2))
    y = np.sin(2.0 * x[:, 0]) * np.cos(x[:, 1])
    mj = jgp.fit_gp(jnp.asarray(x), jnp.asarray(y), corr="matern52",
                    trend="linear", n_start=2, nugget=1e-6)
    return mj, gp_model_from_numpy(_fields(mj), mj.corr, mj.trend,
                                   device="cpu")


def test_gradient_goldens(kriging_1d):
    """tests/test_gp.py's goldens: grad(1.1) = 1.1204, var_grad(1.1) =
    0.0145, both within 1e-3."""
    _, mt = kriging_1d
    x = _t([[1.1]])
    assert abs(float(tgp.predict_gradients(mt, x)[0, 0]) - 1.1204) < 1e-3
    assert abs(float(tgp.predict_var_gradients(mt, x)[0, 0]) - 0.0145) < 1e-3


@pytest.mark.parametrize("which", ["kriging_1d", "matern_2d"])
def test_gp_gradients_match_jax_and_finite_differences(which, request):
    mj, mt = request.getfixturevalue(which)
    nx = mt.x_norm.shape[1]
    xq = np.random.default_rng(7).uniform(0.2, 3.8, (9, nx)) - (
        2.0 if nx == 2 else 0.0)
    xj, xt = jnp.asarray(xq), _t(xq)
    g, gv = tgp.predict_valvar_gradients(mt, xt)
    np.testing.assert_allclose(_np(g), np.asarray(jgp.predict_gradients(
        mj, xj)), rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(_np(gv), np.asarray(jgp.predict_var_gradients(
        mj, xj)), rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(
        _np(tgp.predict_kth_derivatives(mt, xt, nx - 1)),
        np.asarray(jgp.predict_kth_derivatives(mj, xj, nx - 1)),
        rtol=1e-9, atol=1e-10)
    # central differences, per input dimension
    eps = 1e-5
    for d in range(nx):
        step = np.zeros(nx)
        step[d] = eps
        fd = (_np(tgp.predict(mt, _t(xq + step)))
              - _np(tgp.predict(mt, _t(xq - step)))) / (2 * eps)
        np.testing.assert_allclose(_np(g)[:, d], fd, rtol=1e-5, atol=1e-6)
        fdv = (_np(tgp.predict_var(mt, _t(xq + step)))
               - _np(tgp.predict_var(mt, _t(xq - step)))) / (2 * eps)
        np.testing.assert_allclose(_np(gv)[:, d], fdv, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("method", ["eig", "chol"])
def test_posterior_cov_and_sample_match_jax(kriging_1d, method):
    """``posterior_cov`` exactly; ``sample`` with egobox_tpu's normals
    handed in: the same trajectories."""
    mj, mt = kriging_1d
    xq = np.linspace(0.0, 4.0, 12)[:, None]
    np.testing.assert_allclose(
        _np(tgp.posterior_cov(mt, _t(xq))),
        np.asarray(jgp.posterior_cov(mj, jnp.asarray(xq))), **EXACT)
    key = jax.random.key(3)
    z = np.asarray(jax.random.normal(key, (12, 7), dtype=jnp.float64))
    tj = np.asarray(jgp.sample(mj, jnp.asarray(xq), 7, key, method=method))
    tt = tgp.sample(mt, _t(xq), 7, method=method, normals=_t(z))
    np.testing.assert_allclose(_np(tt), tj, rtol=1e-6, atol=1e-8)
    gen = torch.Generator().manual_seed(0)
    assert tgp.sample(mt, _t(xq), 5, gen, method).shape == (12, 5)
    inner = tgp.inner_params(mt)
    assert inner.r_chol is mt.r_chol and inner.sigma2 is mt.sigma2


# ---------------------------------------------------------------------------
# moe.py: prediction of a mixture converted from egobox_tpu
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_mixture():
    """A 2-cluster smooth mixture trained by egobox_tpu."""
    x, y = _two_blobs()
    return jmoe.train_moe(x, y, n_clusters=2, n_start=3), x, y


def _grid():
    g = np.linspace(-0.2, 3.2, 6)
    return np.stack(np.meshgrid(g, g), axis=-1).reshape(-1, 2)


@pytest.mark.parametrize("recomb", ["smooth", "hard"])
def test_gp_mixture_predictions_match_jax(jax_mixture, recomb):
    """predict, predict_var, predict_valvar, gradients and variance
    gradients of the same experts and mixture, smooth and hard."""
    mj, _, _ = jax_mixture
    mj = jmoe.GpMixture(mj.experts, mj.gmx, JRecomb(recomb))
    mt = _port_mixture(mj)
    assert mt.recombination is Recombination(recomb) and mt.n_clusters == 2
    xq = _grid()
    xj = jnp.asarray(xq)
    for fn in ("predict", "predict_var", "predict_gradients",
               "predict_var_gradients"):
        np.testing.assert_allclose(_np(getattr(mt, fn)(xq)),
                                   np.asarray(getattr(mj, fn)(xj)),
                                   rtol=1e-9, atol=1e-9, err_msg=fn)
    mean, var = mt.predict_valvar(xq)
    torch.testing.assert_close(mean, mt.predict(xq), rtol=0, atol=0)
    # the EGO loop's container at one point and over a batch
    model_t, model_j = mt.to_model(), mj.to_model()
    mb, vb = tmoe.moe_predict_valvar_batch(model_t, _t(xq))
    mbj, vbj = jmoe.moe_predict_valvar_batch(model_j, xj)
    np.testing.assert_allclose(_np(mb), np.asarray(mbj), **EXACT)
    np.testing.assert_allclose(_np(vb), np.asarray(vbj), **EXACT)
    ms, vs = tmoe.moe_predict_valvar_single(model_t, _t(xq[4]))
    msj, vsj = jmoe.moe_predict_valvar_single(model_j, xj[4])
    np.testing.assert_allclose([float(ms), float(vs)],
                               [float(msj), float(vsj)], **EXACT)
    # lanes x trials, as the infill optimizer hands them in
    m3, _ = tmoe.moe_predict_valvar_single(model_t, _t(xq[:6]).reshape(
        2, 3, 2))
    np.testing.assert_allclose(_np(m3).ravel(), _np(mb)[:6], **EXACT)


def test_gp_mixture_gradients_match_finite_differences(jax_mixture):
    mj, _, _ = jax_mixture
    mt = _port_mixture(mj)
    x0 = np.array([[0.31, 0.5], [1.4, 1.7], [2.5, 2.2]])
    eps = 1e-5
    g = _np(mt.predict_gradients(x0))
    for d in range(2):
        step = np.eye(2)[d] * eps
        fd = (_np(mt.predict(x0 + step)) - _np(mt.predict(x0 - step))) / (
            2 * eps)
        np.testing.assert_allclose(g[:, d], fd, rtol=1e-4, atol=1e-5)


def test_sample_needs_one_cluster(jax_mixture, kriging_1d):
    mj, _, _ = jax_mixture
    with pytest.raises(ValueError, match="single cluster"):
        _port_mixture(mj).sample(np.zeros((2, 2)), 3)
    _, mt = kriging_1d
    one = tmoe.GpMixture([mt], _port_mixture(mj).gmx)
    assert one.sample(np.zeros((3, 1)), 4,
                      torch.Generator().manual_seed(1)).shape == (3, 4)


# ---------------------------------------------------------------------------
# moe.py: expert selection and training, JAX's draws handed in
# ---------------------------------------------------------------------------


def _regime_2d(n=24, seed=3):
    """A smooth 2-d function with 5 % noise: the fits' likelihood then
    prefers Grams far from singular (the CV fits run at egobox_tpu's
    nugget of 100 eps, where a noise-free smooth design leaves theta
    to the last bits of the two linear-algebra libraries)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (n, 2))
    y = np.sin(4.0 * x[:, 0]) + x[:, 1] ** 2 + 0.05 * rng.standard_normal(n)
    return x, y


@pytest.mark.parametrize("corr,trend", [("squared_exponential", "constant"),
                                        ("matern32", "linear")])
def test_cv_error_matches_jax(corr, trend, jax_draws):
    """The 5 fold fits of a combo as one stack of masked lanes: the same
    CV error as egobox_tpu's vmapped folds."""
    x, y = _regime_2d()
    ej = jmoe_mod._cv_error(x, y, corr, trend, None, 3, 11)
    et = tmoe_mod._cv_error(x, y, corr, trend, None, 3, 11, device="cpu")
    np.testing.assert_allclose(et, ej, rtol=1e-6)


def test_find_best_expert_matches_jax(jax_draws):
    """Two trends x two kernels: the same combo and the same expert."""
    x, y = _regime_2d(30, 4)
    kw = dict(regr_names=("constant", "linear"),
              corr_names=("squared_exponential", "matern52"), n_start=2,
              seed=5)
    ej = jmoe_mod.find_best_expert(x, y, **kw)
    et = tmoe_mod.find_best_expert(x, y, device="cpu", **kw)
    _assert_same_expert(et, ej, x[:7] + 0.01)


def test_a_kernel_failure_in_the_cv_propagates(monkeypatch):
    """egobox_tpu's ``_cv_error`` turns any exception into inf; the port
    catches only a fit's numerical failure, so a kernel that fails to build
    or launch is not read as a losing combo."""
    x, y = _regime_2d()

    def broken(*args, **kwargs):
        raise RuntimeError("corr_tile: launch failed")

    monkeypatch.setattr(tmoe_mod, "fit_gp_outputs", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        tmoe_mod._cv_error(x, y, "matern52", "constant", None, 2, 1,
                           device="cpu")

    def singular(*args, **kwargs):
        raise torch.linalg.LinAlgError("not positive-definite")

    monkeypatch.setattr(tmoe_mod, "fit_gp_outputs", singular)
    assert tmoe_mod._cv_error(x, y, "matern52", "constant", None, 2, 1,
                              device="cpu") == np.inf


def test_train_moe_matches_jax(jax_draws):
    """A 2-cluster smooth mixture with JAX's GMM seeding and fit seeds:
    the same clustering, heaviside factor, experts and predictions."""
    x, y = _two_blobs(1)
    kw = dict(n_clusters=2, n_start=3, seed=2)
    mj = jmoe.train_moe(x, y, **kw)
    mt = tmoe.train_moe(x, y, device="cpu", **kw)
    assert float(mt.gmx.heaviside_factor) == pytest.approx(
        float(mj.gmx.heaviside_factor), rel=1e-12)
    for name in ("weights", "means", "precisions_chol"):
        np.testing.assert_allclose(_np(getattr(mt.gmx, name)),
                                   np.asarray(getattr(mj.gmx, name)),
                                   **EXACT)
    xq = _grid()
    for et, ej in zip(mt.experts, mj.experts):
        _assert_same_expert(et, ej, xq)
    np.testing.assert_allclose(_np(mt.predict(xq)),
                               np.asarray(mj.predict(jnp.asarray(xq))),
                               rtol=0, atol=1e-7)


def _with_far_points(n_far, seed=0):
    """``_regime_2d``'s 24 points and ``n_far`` points of another regime
    far from them: the GMM gives the far points a cluster of their own."""
    x, y = _regime_2d(24, seed)
    xf = 3.0 + 0.3 * np.random.default_rng(seed + 1).uniform(0, 1, (n_far, 2))
    return np.vstack([x, xf]), np.concatenate([y, 6.0 + xf[:, 0] - xf[:, 1]])


def _joint_assignment(x, y, seed):
    """egobox_tpu's train_moe clustering of (x, y): fit_gmm from
    ``key(seed)`` and the argmax of the weighted log densities."""
    data = jnp.asarray(np.hstack([x, y[:, None]]))
    g = jgmm.fit_gmm(jax.random.key(seed), data, 2, n_runs=20)
    logp = jgmm.gmm_log_prob(data, g.means, g.precisions_chol) + jnp.log(
        jnp.maximum(g.weights, 1e-300))
    return np.asarray(jnp.argmax(logp, axis=1))


def test_train_moe_two_point_cluster_matches_jax(jax_draws):
    """A cluster of two points (one of them held out of the heaviside
    search's fits, so that fit takes both) is fitted as egobox_tpu fits
    it: the same experts, factor and predictions."""
    x, y = _with_far_points(2)
    kw = dict(n_clusters=2, n_start=2, seed=3)
    assert sorted(np.bincount(_joint_assignment(x, y, 3))) == [2, 24]
    mj = jmoe.train_moe(x, y, **kw)
    mt = tmoe.train_moe(x, y, device="cpu", **kw)
    assert float(mt.gmx.heaviside_factor) == pytest.approx(
        float(mj.gmx.heaviside_factor), rel=1e-12)
    xq = x[::3] + 0.01
    for et, ej in zip(mt.experts, mj.experts):
        _assert_same_expert(et, ej, xq)
    np.testing.assert_allclose(_np(mt.predict(xq)),
                               np.asarray(mj.predict(jnp.asarray(xq))),
                               rtol=0, atol=1e-7)


def test_train_moe_one_point_cluster_falls_back_to_all_the_data(jax_draws):
    """egobox_tpu fits a one-point cluster and raises GpFitError (its
    likelihood is -inf); the port fits that cluster's expert on all the
    data, as egobox_tpu's find_best_expert fits it there, and the other
    expert on its own cluster (ROADMAP, known faults). Seed 1: at seed 0
    the all-data fit drives one theta to its lower bound, where R is near
    all ones and the two packages stop at different optima (the
    ill-conditioned parity of ROADMAP's parity note)."""
    from egobox_tpu.gp.fit import GpFitError as JGpFitError

    x, y = _with_far_points(1, seed=1)
    kw = dict(n_clusters=2, n_start=2, seed=3)
    assign = _joint_assignment(x, y, 3)
    counts = np.bincount(assign)
    assert sorted(counts) == [1, 24]
    with pytest.raises(JGpFitError):
        jmoe.train_moe(x, y, recombination=JRecomb.HARD, **kw)
    mt = tmoe.train_moe(x, y, recombination=Recombination.HARD,
                        device="cpu", **kw)
    fit_kw = dict(regr_names=("constant",),
                  corr_names=("squared_exponential",), n_start=2, seed=3)
    thin = int(np.argmin(counts))
    xq = x[::3] + 0.01
    _assert_same_expert(mt.experts[thin],
                        jmoe_mod.find_best_expert(x, y, **fit_kw), xq)
    sel = assign == 1 - thin
    _assert_same_expert(mt.experts[1 - thin],
                        jmoe_mod.find_best_expert(x[sel], y[sel], **fit_kw),
                        xq)


def test_train_moe_on_clusters_and_heaviside_match_jax(jax_mixture,
                                                       jax_draws):
    """Retraining on egobox_tpu's clustering (CV selection, and at fixed
    hyperparameters), and the heaviside search on the same experts."""
    mj, x, y = jax_mixture
    gmx_t = _port_mixture(mj).gmx
    kw = dict(corr_names=("squared_exponential", "matern32"), n_start=2,
              seed=9)
    rj = jmoe.train_moe_on_clusters(x, y, mj.gmx, JRecomb.HARD, **kw)
    rt = tmoe.train_moe_on_clusters(x, y, gmx_t, Recombination.HARD,
                                    device="cpu", **kw)
    xq = _grid()
    for et, ej in zip(rt.experts, rj.experts):
        _assert_same_expert(et, ej, xq)
    fixed = jmoe_mod.expert_params(mj)
    fj = jmoe.train_moe_on_clusters(x, y, mj.gmx, fixed_params=fixed)
    ft = tmoe.train_moe_on_clusters(x, y, gmx_t, fixed_params=fixed,
                                    device="cpu")
    for et, ej, p in zip(ft.experts, fj.experts, fixed):
        np.testing.assert_allclose(_np(et.theta), p[2], rtol=1e-12)
        _assert_same_expert(et, ej, xq)
    xs, ys = x[::5], y[::5]
    fac_j = jmoe.optimize_heaviside_factor(mj.experts, mj.gmx,
                                           jnp.asarray(xs), jnp.asarray(ys))
    mt = _port_mixture(mj)
    assert tmoe.optimize_heaviside_factor(mt.experts, mt.gmx, xs, ys) == \
        fac_j


def test_find_best_number_of_clusters_matches_jax(jax_draws):
    """Automatic k up to 2 on tests/test_moe.py's data: the same k and
    recombination."""
    x, y = _two_regime(30)
    kj = jmoe.find_best_number_of_clusters(x, y, 2, ("constant",),
                                           ("squared_exponential",), seed=1)
    kt = tmoe.find_best_number_of_clusters(x, y, 2, ("constant",),
                                           ("squared_exponential",), seed=1,
                                           device="cpu")
    assert (kt[0], kt[1].value) == (kj[0], kj[1].value)


@pytest.mark.parametrize("build", [
    lambda x, y: tmoe.train_moe(x, y, gp_type="sparse", device="cpu"),
    lambda x, y: tmoe.find_best_expert(x, y, ("constant",),
                                       ("matern52",), gp_type="sparse",
                                       device="cpu"),
    lambda x, y: tmetrics.sgp_fit_predict(),
])
def test_sparse_experts_raise_naming_their_roadmap_item(build):
    """The three entry points that raised NotImplementedError naming
    "gp.sgp" before the sparse GP was ported (the test keeps its name) now
    take sparse experts: a mixture of ``SgpModel``, an ``SgpModel``, the
    batched CV hook."""
    from egobox_torch.gp.sgp import SgpModel

    x, y = _two_regime(10)
    out = build(x, y)
    if isinstance(out, tmoe.GpMixture):
        assert all(isinstance(e, SgpModel) for e in out.experts)
    elif callable(out):
        assert out.batched
    else:
        assert isinstance(out, SgpModel)


# ---------------------------------------------------------------------------
# metrics.py
# ---------------------------------------------------------------------------


def _mean_hook(x, y, mask, x_test):
    """A per-fold hook with an exact answer: the training mean, the
    training variance."""
    return (np.full(x_test.shape[0], y[mask].mean()),
            np.full(x_test.shape[0], y[mask].var() + 0.1))


@pytest.mark.parametrize("kfold", [None, 4])
def test_metric_formulas_match_jax(kfold):
    x, y = _regime_2d(17, 1)
    for name in ("q2_score", "pva_score", "iae_alpha_score"):
        np.testing.assert_allclose(
            getattr(tmetrics, name)(x, y, _mean_hook, kfold),
            getattr(jmoe, name)(x, y, _mean_hook, kfold), err_msg=name,
            **EXACT)
    from egobox_tpu.moe import metrics as jmetrics

    st, at, ct = tmetrics.iae_alpha_with_plot(x, y, _mean_hook, kfold)
    sj, aj, cj = jmetrics.iae_alpha_with_plot(x, y, _mean_hook, kfold)
    np.testing.assert_allclose([st], [sj], **EXACT)
    np.testing.assert_allclose(at, aj, **EXACT)
    np.testing.assert_allclose(ct, cj, **EXACT)
    np.testing.assert_allclose(tmetrics._norm_ppf([0.1, 0.5, 0.975]),
                               np.asarray(jmetrics._norm_ppf(
                                   jnp.asarray([0.1, 0.5, 0.975]))), **EXACT)


def test_gp_fit_predict_folds_match_jax(jax_draws):
    """The batched dense-GP hook: the 5 fold fits as one stack, the same
    held-out predictions and variances as egobox_tpu's vmapped folds, and
    so the same Q2 (tests/test_moe.py::test_q2_metric: Q2 > 0.98)."""
    rng = np.random.RandomState(0)
    x = rng.uniform(0, 1, (40, 2))
    y = np.sin(3 * x[:, 0]) + x[:, 1] ** 2
    masks = tmetrics._cv_masks(40, 5)
    pt, vt = tmetrics.gp_fit_predict(n_start=3, device="cpu")(x, y, masks)
    pj, vj = jmoe.gp_fit_predict(n_start=3)(x, y, masks)
    np.testing.assert_allclose(pt, np.asarray(pj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(vt, np.asarray(vj), rtol=0, atol=1e-8)
    q2 = tmetrics.q2_score(x, y, tmetrics.gp_fit_predict(n_start=3,
                                                          device="cpu"), 5)
    assert q2 > 0.98


def test_train_moe_defaults_to_the_card():
    """numpy input with no device goes to the GPU, as every entry point of
    the port: on a host without one the call raises instead of running on
    the CPU (tests/test_torch_gp.py::test_entry_points_default_to_the_card)."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default runs there")
    x, y = _two_regime(12)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmoe.train_moe(x, y, n_clusters=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmetrics.gp_fit_predict()(x, y, tmetrics._cv_masks(12, 3))
