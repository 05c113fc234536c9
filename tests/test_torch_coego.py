"""egobox_torch's CoEGO and sigma-weight portfolio against egobox_tpu's.
float64, ``device="cpu"``.

- the host-side pieces (``portfolio``: the weights, DBSCAN, the selection;
  ``coego``: the activity groups and their theta masks) are plain numpy on
  both sides: equal on random inputs;
- ``predict_point``, ``is_objective_improved`` and ``coego_optimize_infill``
  from egobox_tpu's fitted surrogates (carried over with
  ``convert.gp_surrogates_from_numpy``), its starts and its activity: the
  trust bounds rtol 1e-9, x rtol 1e-6 (of the box width), the criterion
  rtol 1e-6;
- one ``suggest`` of each path against egobox_tpu's with its draws handed
  in (the scaling cloud and the seed completion recorded, the fits' restart
  seeds drawn from the same keys, ``state.rng`` seeded alike): CoEGO on a
  d=8 sphere with 3 groups, with and without the partial theta tuning and
  the improvement check (every group's theta rtol 1e-5, x within 1e-5 of
  the box width), and the portfolio on xsinx (the kept proposals within
  1e-5 of the box width);
- chip_smoke.py's copy of the MOPTA08-like problem against
  examples/mopta08_like.py at d=12, 6 constraints (exact).
"""

import dataclasses
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egobox_tpu.ego import coego as jcoego
from egobox_tpu.ego import config as jcfg
from egobox_tpu.ego import infill_optim as jio
from egobox_tpu.ego import portfolio as jport
from egobox_tpu.ego import solver as jsolver
from egobox_tpu.ego import surrogates as jsur
from egobox_torch import InfillStrategy
from egobox_torch.convert import gp_surrogates_from_numpy
from egobox_torch.ego import EgorConfig, EgorSolver, GpConfig
from egobox_torch.ego import coego as tcoego
from egobox_torch.ego import infill_optim as tio
from egobox_torch.ego import portfolio as tport
from egobox_torch.ego import solver as tsolver
from test_torch_ego import _ReplayDraws, xsinx

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent


def sphere(x):
    x = np.atleast_2d(x)
    return np.sum(x**2, axis=1, keepdims=True)


# ---------------------------------------------------------------------------
# host-side pieces, exact
# ---------------------------------------------------------------------------


def test_sigma_weights_and_logspace_equal_jax():
    assert tport.SIGMA_WEIGHTS == jport.SIGMA_WEIGHTS
    np.testing.assert_array_equal(tport.logspace(0.1, 100.0, 13),
                                  jport.logspace(0.1, 100.0, 13))


@pytest.mark.parametrize("seed,n,nx", [(0, 13, 1), (1, 13, 3), (2, 40, 2),
                                       (3, 25, 5)])
def test_dbscan_and_selection_equal_jax(seed, n, nx):
    rng = np.random.default_rng(seed)
    # clumps of proposals plus scattered ones, as the 13 weights give
    centers = rng.uniform(0.0, 10.0 * np.sqrt(nx), (3, nx))
    x = np.concatenate([
        centers[rng.integers(0, 3, n - 4)]
        + rng.normal(0.0, 0.3, (n - 4, nx)),
        rng.uniform(0.0, 40.0, (4, nx))])
    for eps in (0.5, 1.0, float(np.sqrt(nx))):
        assert tport.dbscan_labels(x, eps) == jport.dbscan_labels(x, eps)
    np.testing.assert_array_equal(tport.select_from_portfolio(x),
                                  jport.select_from_portfolio(x))


def test_dbscan_clusters_and_noise_as_jax():
    """tests/test_env_features.py's case."""
    x = np.array([[0.0], [0.1], [0.2], [5.0], [5.1], [20.0]])
    labels = tport.dbscan_labels(x, eps=0.5, min_pts=2)
    assert labels == jport.dbscan_labels(x, eps=0.5, min_pts=2)
    assert labels[0] == labels[1] == labels[2] != labels[3] == labels[4]
    assert labels[5] is None
    np.testing.assert_array_equal(tport.select_from_portfolio(x),
                                  jport.select_from_portfolio(x))
    np.testing.assert_array_equal(
        tport.select_from_portfolio(np.array([[0.0], [9.0], [30.0]])), [0])


@pytest.mark.parametrize("nx,n_coop", [(8, 3), (12, 5), (124, 5), (3, 5)])
def test_random_activity_and_theta_masks_equal_jax(nx, n_coop):
    for seed in range(3):
        got = tcoego.get_random_activity(np.random.default_rng(seed), nx,
                                         n_coop)
        want = jcoego.get_random_activity(np.random.default_rng(seed), nx,
                                          n_coop)
        assert len(got) == len(want) == min(n_coop, nx)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            for dim in (nx, 2):
                np.testing.assert_array_equal(
                    tcoego.activity_theta_mask(g, dim),
                    jcoego.activity_theta_mask(w, dim))
        assert sorted(np.concatenate(got).tolist()) == list(range(nx))


def test_improvement_check_switch(monkeypatch):
    monkeypatch.delenv("EGOR_COEGO_IMPROVEMENT_CHECK", raising=False)
    assert not tcoego.improvement_check_enabled()
    monkeypatch.setenv("EGOR_COEGO_IMPROVEMENT_CHECK", "1")
    assert tcoego.improvement_check_enabled()
    assert tcoego.CSTR_DOUBT == jcoego.CSTR_DOUBT


# ---------------------------------------------------------------------------
# the cooperative infill from identical surrogates
# ---------------------------------------------------------------------------


NX = 6
XLIMITS = np.array([[-2.0, 2.0]] * NX)


def _cstr_problem(x):
    """A d=6 objective and one constraint g <= 0 as columns."""
    x = np.atleast_2d(x)
    f = np.sum((x - 0.5) ** 2, axis=1) + 0.3 * np.sin(3.0 * x[:, 0])
    g = np.sum(x[:, :3], axis=1) - 1.0
    return np.stack([f, g], axis=1)


@pytest.fixture(scope="module")
def surrogates():
    rng = np.random.default_rng(21)
    x = rng.uniform(XLIMITS[:, 0], XLIMITS[:, 1], (30, NX))
    y = _cstr_problem(x)
    spec = jsur.GpSpec(corr="matern52", n_start=2, max_iters=10,
                       nugget=1e-6)
    mj = jsur.train_gp_surrogates(
        jnp.asarray(x), jnp.asarray(y), jnp.ones(30, bool), spec, seed=5)
    fields = {f.name: np.asarray(getattr(mj, f.name))
              for f in dataclasses.fields(mj)
              if f.name not in ("corr", "trend", "w_star")}
    fields["w_star"] = None
    mt = gp_surrogates_from_numpy(fields, mj.corr, mj.trend, device="cpu")
    tol = np.array([1e-3])
    feas = y[:, 1] <= tol[0]
    ib = int(np.argmin(np.where(feas, y[:, 0], np.inf)))
    best = (x[ib], y[ib], np.zeros(0))
    cloud = rng.uniform(XLIMITS[:, 0], XLIMITS[:, 1], (200, NX))
    starts = rng.uniform(XLIMITS[:, 0], XLIMITS[:, 1], (6, NX))
    return dict(mj=mj, mt=mt, best=best, cloud=cloud, starts=starts, tol=tol,
                activity=jcoego.get_random_activity(
                    np.random.default_rng(3), NX, 3))


def test_predict_point_and_challenger_check_match_jax(surrogates):
    s = surrogates
    rng = np.random.default_rng(4)
    for x in rng.uniform(-2.0, 2.0, (5, NX)):
        np.testing.assert_allclose(tcoego.predict_point(s["mt"], x),
                                   jcoego.predict_point(s["mj"], x),
                                   rtol=1e-9, atol=1e-12)
        got = tcoego.is_objective_improved(s["best"], x, s["mt"], s["tol"])
        want = jcoego.is_objective_improved(s["best"], x, s["mj"], s["tol"])
        assert got[0] == want[0]
        for g, w in zip(got[1], want[1]):
            np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-12)


def _crit_kwargs(mod, models, cloud, fmin, tols):
    s_inf, s_cstr, s_wb2 = mod.compute_scaling(
        models, cloud, fmin, tols, crit="EI", n_cstr=1, cstr_infill=False)
    return dict(fmin=fmin, scale_infill=s_inf, scale_wb2=s_wb2,
                scale_cstr=s_cstr, cstr_tols=tols, crit="EI",
                cstr_strategy="MC", n_cstr=1, cstr_infill=False,
                feasibility=True, optimizer="COBYLA")


@pytest.mark.parametrize("check", [False, True])
def test_coego_optimize_infill_matches_jax(surrogates, monkeypatch, check):
    """Three groups, each box collapsed (lo == hi) outside the group: the
    lockstep L-BFGS takes the zero-width components without NaN."""
    s = surrogates
    if check:
        monkeypatch.setenv("EGOR_COEGO_IMPROVEMENT_CHECK", "1")
    else:
        monkeypatch.delenv("EGOR_COEGO_IMPROVEMENT_CHECK", raising=False)
    fmin = float(s["best"][1][0])
    cfg = dict(n_cstr=1, cstr_tol=s["tol"])
    js = jsolver.EgorSolver(jcfg.EgorConfig(**cfg), XLIMITS)
    ts = EgorSolver(EgorConfig(**cfg), XLIMITS, device="cpu")
    starts = s["starts"]
    xj, fj = jcoego.coego_optimize_infill(
        js, s["mj"], s["best"], s["activity"], lambda: starts,
        XLIMITS[:, 0], XLIMITS[:, 1],
        _crit_kwargs(jio, s["mj"], jnp.asarray(s["cloud"]), fmin,
                     jnp.asarray(s["tol"])), cstr_tols=s["tol"])
    xt, ft = tcoego.coego_optimize_infill(
        ts, s["mt"], s["best"], s["activity"], lambda: starts,
        XLIMITS[:, 0], XLIMITS[:, 1],
        _crit_kwargs(tio, s["mt"], torch.from_numpy(s["cloud"]), fmin,
                     torch.from_numpy(s["tol"])), cstr_tols=s["tol"])
    assert np.all(np.isfinite(xt)) and np.isfinite(ft)
    np.testing.assert_allclose(xt, np.asarray(xj), rtol=0, atol=1e-6 * 4.0)
    np.testing.assert_allclose(ft, fj, rtol=1e-6)


# ---------------------------------------------------------------------------
# one suggest of each path against egobox_tpu's
# ---------------------------------------------------------------------------


def _record(monkeypatch, recorded, thetas):
    """Record egobox_tpu's LHS draws and every fitted theta."""
    for name in ("_lhs", "_lhs_in"):
        orig = getattr(jsolver.EgorSolver, name)

        def wrapped(self, *a, _orig=orig, **k):
            pts = np.asarray(_orig(self, *a, **k))
            recorded.append(pts)
            return pts

        monkeypatch.setattr(jsolver.EgorSolver, name, wrapped)
    orig_train = jsur.train_gp_surrogates

    def train(*a, **k):
        models = orig_train(*a, **k)
        thetas.append(np.asarray(models.theta))
        return models

    monkeypatch.setattr(jsolver, "train_gp_surrogates", train)


@pytest.mark.parametrize("exact_modes", [False, True])
def test_coego_suggest_matches_jax(monkeypatch, exact_modes):
    nx = 8
    xl = np.array([[-5.0, 5.0]] * nx)
    x = np.random.default_rng(7).uniform(-5.0, 5.0, (12, nx))
    y = sphere(x)
    if exact_modes:
        monkeypatch.setenv("EGOR_COEGO_IMPROVEMENT_CHECK", "1")
    else:
        monkeypatch.delenv("EGOR_COEGO_IMPROVEMENT_CHECK", raising=False)
    common = dict(n_start=4, seed=42, coego_n_coop=3)
    recorded, thetas_j = [], []
    _record(monkeypatch, recorded, thetas_j)
    jc = jcfg.EgorConfig(gp_config=jcfg.GpConfig(n_start=2, max_eval=10),
                         infill_strategy=jcfg.InfillStrategy.EI, **common)
    jc.coego_partial_theta_tuning = exact_modes
    want = jsolver.EgorSolver(jc, xl).suggest(x, y)

    thetas_t = []
    orig_train = tsolver.train_gp_surrogates

    def train(*a, **k):
        models = orig_train(*a, **k)
        thetas_t.append(models.theta.numpy())
        return models

    monkeypatch.setattr(tsolver, "train_gp_surrogates", train)
    tc = EgorConfig(gp_config=GpConfig(n_start=2, max_eval=10),
                    infill_strategy=InfillStrategy.EI, **common)
    tc.coego_partial_theta_tuning = exact_modes
    ts = EgorSolver(tc, xl, device="cpu")
    ts.draws = _ReplayDraws(recorded)
    got = ts.suggest(x, y)
    assert not ts.draws.recorded  # every draw was asked for, in order
    assert len(thetas_t) == len(thetas_j) == (3 if exact_modes else 1)
    for t, j in zip(thetas_t, thetas_j):
        np.testing.assert_allclose(t, j, rtol=1e-5)
    assert got.shape == want.shape == (1, nx)
    assert np.all(np.abs(got - want) <= 1e-5 * 10.0), (got, want)


def test_portfolio_suggest_matches_jax(monkeypatch):
    monkeypatch.setenv("EGOR_USE_GP_VAR_PORTFOLIO", "1")
    xl = np.array([[0.0, 25.0]])
    x = np.random.default_rng(5).uniform(0.0, 25.0, (8, 1))
    y = xsinx(x)
    common = dict(n_start=4, seed=42)
    recorded, thetas_j = [], []
    _record(monkeypatch, recorded, thetas_j)
    want = jsolver.EgorSolver(
        jcfg.EgorConfig(gp_config=jcfg.GpConfig(n_start=2, max_eval=10),
                        **common), xl).suggest(x, y)
    ts = EgorSolver(
        EgorConfig(gp_config=GpConfig(n_start=2, max_eval=10), **common), xl,
        device="cpu")
    ts.draws = _ReplayDraws(recorded)
    got = ts.suggest(x, y)
    assert not ts.draws.recorded
    assert got.shape == want.shape and got.shape[1] == 1
    assert np.all(np.abs(got - want) <= 1e-5 * 25.0), (got, want)


# ---------------------------------------------------------------------------
# the MOPTA08-like problem of chip_smoke.py
# ---------------------------------------------------------------------------


def test_mopta_like_copy_equals_the_example():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from examples.mopta08_like import make_problem

    fn_t, xf_t = chip_smoke.make_mopta_problem(d=12, n_cstr=6)
    fn_j, xf_j = make_problem(d=12, n_cstr=6)
    np.testing.assert_array_equal(xf_t, xf_j)
    x = np.random.default_rng(0).uniform(0.0, 1.0, (20, 12))
    np.testing.assert_array_equal(fn_t(x), fn_j(x))
    assert fn_t(x).shape == (20, 7)
    assert "jax" not in chip_smoke.__dict__ and \
        "egobox_tpu" not in chip_smoke.__dict__
