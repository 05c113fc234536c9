"""The ported slice end to end: egobox_torch's ``fit_gp`` -> predict against
egobox_tpu's, float64 on numpy inputs; the goldens, serving a JAX-fitted
model, and the package boundary. (The fits that draw random numbers are in
test_torch_fit.py.)

Tolerances: theta rel 1e-5, likelihood rel 1e-8, predict and variance atol
1e-8. They hold for well-posed fits: the fits here carry a 1e-6 nugget
(or the recipe's 1e-3). At the default nugget (100 eps) a smooth 200-point
squared-exponential Gram is so ill-conditioned (|gamma| ~ 4e10) that
last-bit differences of the two linear-algebra libraries move the L-BFGS
end point by 5e-4 relative in theta.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egobox_tpu import gp as jgp
from egobox_torch import gp as tgp
from egobox_torch.convert import gp_model_from_numpy
from egobox_torch.doe import lhs as tlhs

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent


def _data(n, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2.0, 2.0, (n, d))
    y = np.sum(np.sin(2.0 * x), axis=1) + 0.05 * rng.standard_normal(n)
    return x, y


def _assert_same_model(mt, mj, x_test):
    np.testing.assert_allclose(mt.theta.numpy(), np.asarray(mj.theta),
                               rtol=1e-5)
    np.testing.assert_allclose(float(mt.likelihood), float(mj.likelihood),
                               rtol=1e-8)
    xt = torch.from_numpy(x_test)
    mean_t, var_t = tgp.predict_valvar(mt, xt)
    np.testing.assert_allclose(
        mean_t.numpy(), np.asarray(jgp.predict(mj, jnp.asarray(x_test))),
        rtol=0, atol=1e-8)
    np.testing.assert_allclose(
        var_t.numpy(), np.asarray(jgp.predict_var(mj, jnp.asarray(x_test))),
        rtol=0, atol=1e-8)
    torch.testing.assert_close(tgp.predict(mt, xt), mean_t, rtol=0, atol=0)
    torch.testing.assert_close(tgp.predict_var(mt, xt), var_t, rtol=0,
                               atol=0)


@pytest.mark.parametrize("corr", ["matern52", "squared_exponential"])
def test_fit_predict_matches_jax(corr):
    x, y = _data(200, 3, 0)
    x_test = np.random.default_rng(1).uniform(-2.0, 2.0, (25, 3))
    mt = tgp.fit_gp(x, y, corr=corr, n_start=0, nugget=1e-6, device="cpu")
    mj = jgp.fit_gp(x, y, corr=corr, n_start=0, nugget=1e-6)
    assert mt.theta.dtype == torch.float64
    _assert_same_model(mt, mj, x_test)


def test_fixed_theta_and_partial_tuning_match_jax():
    x, y = _data(50, 3, 6)
    for kw in (dict(theta_init=[0.5, 0.7, 0.9], theta_fixed=True),
               dict(theta_init=0.3, active=[0, 2], n_start=0)):
        mt = tgp.fit_gp(x, y, corr="absolute_exponential", device="cpu",
                        **kw)
        mj = jgp.fit_gp(x, y, corr="absolute_exponential", **kw)
        _assert_same_model(mt, mj, x[:7] + 0.01)
    assert float(mt.theta[1]) == pytest.approx(0.3, rel=1e-12)


@pytest.fixture(scope="module")
def kriging_1d():
    xt = np.array([[0.0], [1.0], [2.0], [3.0], [4.0]])
    yt = np.array([0.0, 1.0, 1.5, 0.9, 1.0])
    return tgp.fit_gp(xt, yt, device="cpu"), xt, yt


def test_kriging_interpolation(kriging_1d):
    model, xt, yt = kriging_1d
    x = torch.from_numpy(xt)
    np.testing.assert_allclose(tgp.predict(model, x).numpy(), yt, atol=1e-8)
    np.testing.assert_allclose(tgp.predict_var(model, x).numpy(), 0.0,
                               atol=1e-8)


def test_kriging_point_goldens(kriging_1d):
    """Reference goldens (test_gpmix.py:38-52) that need no gradients:
    predict(1.1) = 1.1163 +- 1e-3, var(1.1) ~ 0."""
    model, _, _ = kriging_1d
    x = torch.tensor([[1.1]], dtype=torch.float64)
    assert abs(float(tgp.predict(model, x)[0]) - 1.1163) < 1e-3
    assert abs(float(tgp.predict_var(model, x)[0])) < 1e-3


@pytest.mark.parametrize("kpls", [False, True])
def test_jax_fitted_model_served_by_port(kpls):
    x, y = _data(80, 4, 7)
    mj = jgp.fit_gp(x, y, corr="matern52", n_start=2, nugget=1e-6,
                    kpls_dim=2 if kpls else None)
    fields = {k: (None if getattr(mj, k) is None
                  else np.asarray(getattr(mj, k)))
              for k in mj.__dataclass_fields__ if k not in ("corr", "trend")}
    mt = gp_model_from_numpy(fields, mj.corr, mj.trend, device="cpu")
    assert (mt.w_star is None) == (not kpls)
    x_test = np.random.default_rng(8).uniform(-2.0, 2.0, (30, 4))
    mean, var = tgp.predict_valvar(mt, torch.from_numpy(x_test))
    np.testing.assert_allclose(
        mean.numpy(), np.asarray(jgp.predict(mj, jnp.asarray(x_test))),
        rtol=0, atol=1e-8)
    np.testing.assert_allclose(
        var.numpy(), np.asarray(jgp.predict_var(mj, jnp.asarray(x_test))),
        rtol=0, atol=1e-8)


def test_gp_model_from_numpy_rejects_missing_fields():
    with pytest.raises(ValueError, match="missing"):
        gp_model_from_numpy({"theta": np.ones(2)}, "matern52", "constant",
                            device="cpu")


def test_nonfinite_likelihood_raises_gp_fit_error():
    x, y = _data(20, 2, 8)
    y[3] = np.nan
    with pytest.raises(tgp.GpFitError):
        tgp.fit_gp(x, y, n_start=0, max_iters=2, device="cpu")


@pytest.mark.parametrize("kw", [dict(mesh=object()),
                                dict(rank_warmstart=120),
                                dict(subsample_warmstart2=90),
                                dict(ls_batch=4)])
def test_unported_options_raise(kw, monkeypatch):
    x, y = _data(20, 2, 9)
    if "mesh" in kw:
        # ported since: the mesh must be an egobox_torch.parallel Mesh
        # (tests/test_torch_parallel*.py fit on one)
        with pytest.raises(TypeError, match="Mesh"):
            tgp.fit_gp(x, y, device="cpu", **kw)
        return
    if "ls_batch" in kw:
        # ported since this test was written: the speculative line search
        # fits to egobox_tpu's optimum (same nugget as the parity tests)
        common = dict(n_start=0, max_iters=8, nugget=1e-6, **kw)
        mt = tgp.fit_gp(x, y, device="cpu", **common)
        mj = jgp.fit_gp(x, y, **common)
        np.testing.assert_allclose(mt.theta.numpy(), np.asarray(mj.theta),
                                   rtol=1e-5)
        return
    # ported since: the ranked warm start (a 60-point multistart, its
    # optima ranked on 120 points) and the second-fidelity draw (two
    # 60-point draws and one of 90), polished on 240 points, fit to
    # egobox_tpu's model with its draws handed in (the tolerances of
    # _assert_same_model)
    from test_torch_fit import _inject_jax_draws

    x, y = _data(240, 3, 10)
    rank = "rank_warmstart" in kw
    common = dict(corr="matern52", n_start=1, max_iters=4, nugget=1e-3,
                  subsample_warmstart=60, polish_iters=2, seed=3,
                  sub_draws=1 if rank else 2, **kw)
    _inject_jax_draws(monkeypatch, 3, 240, common["sub_draws"],
                      3 if rank else 1, 3, sub_m2=not rank)
    mt = tgp.fit_gp(x, y, device="cpu", **common)
    mj = jgp.fit_gp(x, y, **common)
    _assert_same_model(mt, mj, x[:15] + 0.01)


@pytest.mark.parametrize("kpls", [False, True])
def test_warmstart_theta_matches_jax(kpls):
    """The ranked warm start alone: a 1 + 3 restart multistart on 100 points
    (egobox_tpu's LHS seeds handed in), every optimum ranked on 200 points;
    the winner's theta rtol 1e-5 (nugget 1e-6)."""
    from egobox_tpu.doe.lhs import maximin_lhs as jax_maximin_lhs
    from egobox_tpu.gp import fit as jfit
    from egobox_torch.gp import fit as tfit
    from test_torch_fit import _JaxDraws

    import jax

    x, y = _data(200, 4, 12)
    y = y[:, None]
    dim = 2 if kpls else 4
    key = jax.random.key(4)
    seeds = np.asarray(jax_maximin_lhs(key, 3, dim, False, 5, jnp.float64))
    kw = dict(corr="matern52", trend="constant",
              kpls_dim=2 if kpls else None, n_start=3, max_iters=8,
              nugget=1e-6)
    theta0 = np.full(dim, 0.1)
    lo, up = np.full(dim, 1e-2), np.full(dim, 1e1)
    want = jfit._warmstart_theta(
        jnp.asarray(x[:100]), jnp.asarray(y[:100]), jnp.asarray(x),
        jnp.asarray(y), jnp.asarray(theta0), jnp.asarray(lo),
        jnp.asarray(up), key, **kw)
    t = torch.from_numpy
    got = tfit._warmstart_theta(
        t(x[:100]), t(y[:100]), t(x), t(y), t(theta0), t(lo), t(up),
        _JaxDraws([], [seeds]), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_kriging_alias_matches_jax():
    """``gp.kriging``: ``fit_gp`` with egobox_tpu's defaults, squared
    exponential and a constant trend (a keyword overrides them)."""
    x, y = _data(60, 2, 12)
    x_test = np.random.default_rng(13).uniform(-2.0, 2.0, (10, 2))
    mt = tgp.kriging(x, y, n_start=0, nugget=1e-6, device="cpu")
    mj = jgp.kriging(x, y, n_start=0, nugget=1e-6)
    assert (mt.corr, mt.trend) == (mj.corr, mj.trend) == (
        "squared_exponential", "constant")
    _assert_same_model(mt, mj, x_test)
    mt = tgp.kriging(x, y, trend="linear", n_start=0, nugget=1e-6,
                     device="cpu")
    mj = jgp.kriging(x, y, trend="linear", n_start=0, nugget=1e-6)
    assert mt.trend == mj.trend == "linear"
    _assert_same_model(mt, mj, x_test)


def test_sparse_kriging_alias_matches_jax(monkeypatch):
    """``gp.sparse_kriging``: ``fit_sgp`` with the squared exponential,
    from egobox_tpu's draws (tests/test_torch_sgp.py's problem and
    tolerance)."""
    from egobox_torch.gp import fit as tfit
    from egobox_torch.gp import sgp as tsgp
    from test_torch_sgp import _fit_problem, _JaxFitDraws, _JaxSgpDraws

    monkeypatch.setattr(tsgp, "_sgp_draws", _JaxSgpDraws)
    monkeypatch.setattr(tfit, "_fit_draws", _JaxFitDraws)
    x, y, z = _fit_problem()
    mt = tgp.sparse_kriging(x, y, z=z, n_start=2, seed=0, device="cpu")
    mj = jgp.sparse_kriging(jnp.asarray(x), jnp.asarray(y), z=jnp.asarray(z),
                            n_start=2, seed=0)
    assert mt.corr == mj.corr == "squared_exponential"
    np.testing.assert_allclose(float(mt.likelihood), float(mj.likelihood),
                               rtol=1e-6)


@pytest.mark.parametrize("trend", ["constant", "linear", "quadratic"])
def test_trend_jacobian_matches_jax(trend):
    """``gp.trends.trend_jacobian`` at one point, (p, nx), against
    egobox_tpu's ``jax.jacfwd`` of the basis."""
    from egobox_tpu.gp.trends import trend_jacobian as jax_jacobian

    x1 = np.array([0.3, -1.2, 2.5])
    got = tgp.trend_jacobian(trend, torch.from_numpy(x1))
    want = np.asarray(jax_jacobian(trend, jnp.asarray(x1)))
    assert got.shape == want.shape == (tgp.n_basis(trend, 3), 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-15, atol=0)


def test_n_train_and_dims_match_jax():
    """``GpModel.n_train`` (active rows of a padded design) and ``dims``."""
    x, y = _data(30, 3, 14)
    xp = np.concatenate([x, np.zeros((6, 3))])
    yp = np.concatenate([y, np.zeros(6)])
    mask = np.arange(36) < 30
    kw = dict(n_start=0, max_iters=3, nugget=1e-6, mask=mask)
    mt = tgp.fit_gp(xp, yp, device="cpu", **kw)
    mj = jgp.fit_gp(xp, yp, **kw)
    assert int(mt.n_train) == int(mj.n_train) == 30
    assert mt.dims == mj.dims == (3, 1)


def test_input_validation():
    x, y = _data(20, 2, 9)
    with pytest.raises(ValueError, match="multi-output"):
        tgp.fit_gp(x, np.stack([y, y], axis=1), device="cpu")
    with pytest.raises(ValueError, match="kpls_dim"):
        tgp.fit_gp(x, y, kpls_dim=3, device="cpu")


def test_entry_points_default_to_the_card():
    """Numpy input with no ``device`` goes to the GPU; on a host without
    one the entry points raise instead of running on the CPU. Tensors keep
    their device."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default runs there")
    x, y = _data(20, 2, 9)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgp.fit_gp(x, y)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gp_model_from_numpy({"theta": np.ones(2)}, "matern52", "constant")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlhs.maximin_lhs(4, 2, torch.Generator().manual_seed(0))
    m = tgp.fit_gp(torch.from_numpy(x), torch.from_numpy(y), n_start=0,
                   max_iters=2)
    assert m.theta.device.type == "cpu"


def test_import_leaves_jax_out():
    code = ("import sys, egobox_torch, egobox_torch.gp, "
            "egobox_torch.convert, egobox_torch.ops.build; "
            "bad = [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'egobox_tpu', 'triton')]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
