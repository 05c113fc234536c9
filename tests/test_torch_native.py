"""egobox_torch's native derivative-free solver and the host-path polish of
function constraints, against egobox_tpu's. float64, ``device="cpu"``.

- ``native.nelder_mead`` / ``minimize_dfo_constrained``: the same C++ source
  built with the same flags and driven by the same Python callbacks, so x, f
  and the evaluation count are equal to the bit;
- ``EgorSolver._fcstr_polish`` from the same surrogates (egobox_tpu's fit,
  carried over with ``convert.gp_surrogates_from_numpy``), start and scaling
  cloud: x within 1e-6 of the box width;
- the two repairs of the host path: function constraints written in torch
  operations no longer enter the infill optimizer there (the proposal is
  polished, as egobox_tpu's host path does), and ``EGOBOX_NO_FCSTR_TRACE=1``
  sends them to that path: one ``suggest`` against egobox_tpu's with its
  draws handed in, x within 1e-5 of the box width.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egobox_tpu import native as jnative
from egobox_tpu.ego import config as jcfg
from egobox_tpu.ego import infill_optim as jio
from egobox_tpu.ego import solver as jsolver
from egobox_tpu.ego import surrogates as jsur
from egobox_torch import native as tnative
from egobox_torch.convert import gp_surrogates_from_numpy
from egobox_torch.ego import EgorConfig, EgorSolver, GpConfig
from egobox_torch.ego import infill_optim as tio
from egobox_torch.ops.build import BUILD_DIR
from test_torch_ego import _ReplayDraws, xsinx

torch.set_num_threads(2)


def rosen(x):
    return float(100 * (x[1] - x[0] ** 2) ** 2 + (1 - x[0]) ** 2)


def quad_out_of_box(x):
    return float(np.sum((x - 2.0) ** 2))


# ---------------------------------------------------------------------------
# the native solver, to the bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fun,x0,lo,hi,max_eval", [
    (rosen, [-1.2, 1.0], [-5.0, -5.0], [5.0, 5.0], 4000),
    (rosen, [0.5, -0.5], [-2.0, -2.0], [2.0, 2.0], 300),
    (quad_out_of_box, [0.0, 0.0, 0.5], [-1.0] * 3, [1.0] * 3, 1000),
    (lambda x: float(np.sum((x - 0.3) ** 2) + np.sin(5 * x[0])),
     [0.9, -0.9, 0.1, 0.0], [-1.0] * 4, [1.0] * 4, 500),
])
def test_nelder_mead_equals_jax(fun, x0, lo, hi, max_eval):
    args = (np.array(x0), np.array(lo), np.array(hi))
    xt, ft, nt = tnative.nelder_mead(fun, *args, max_eval=max_eval)
    xj, fj, nj = jnative.nelder_mead(fun, *args, max_eval=max_eval)
    np.testing.assert_array_equal(xt, xj)
    assert ft == fj and nt == nj and nt > 0


def test_minimize_dfo_constrained_equals_jax():
    """min x0 + x1 s.t. 1 - x0 <= 0 and x1 >= 0.5 x0 - 0.2 in [0, 3]^2,
    the penalty rounds of both wrappers; the optimum (1, 0.3)."""
    cstrs = [lambda x: 1.0 - x[0], lambda x: 0.5 * x[0] - 0.2 - x[1]]
    args = (lambda x: float(x[0] + x[1]), cstrs, np.array([2.0, 2.0]),
            np.zeros(2), 3 * np.ones(2))
    xt, ft = tnative.minimize_dfo_constrained(*args, max_eval=2000)
    xj, fj = jnative.minimize_dfo_constrained(*args, max_eval=2000)
    np.testing.assert_array_equal(xt, xj)
    assert ft == fj
    np.testing.assert_allclose(xt, [1.0, 0.3], atol=2e-2)


def test_exception_in_the_callback_is_raised_after_the_call():
    calls = []

    def bad(x):
        calls.append(1)
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        tnative.nelder_mead(bad, np.zeros(2), -np.ones(2), np.ones(2),
                            max_eval=50)
    assert calls  # the C solver ran and called back
    with pytest.raises(ValueError, match="bound shapes"):
        tnative.nelder_mead(rosen, np.zeros(2), -np.ones(3), np.ones(2))


def test_library_is_built_into_the_build_directory():
    path = tnative.build()
    assert path.parent == BUILD_DIR and path.name.startswith(
        "libegx_native_") and path.exists()
    assert tnative.build() == path  # named by the source's hash: reused
    here = path.parents[2] / "egobox_torch" / "native"
    assert not list(here.glob("*.so"))


# ---------------------------------------------------------------------------
# the polish from identical surrogates
# ---------------------------------------------------------------------------


XLIMITS = np.array([[0.0, 3.0], [0.0, 4.0]])
CSTR_TOLS = np.array([1e-3, 1e-3])


def g24(p):
    p = np.atleast_2d(p)
    x1, x2 = p[:, 0], p[:, 1]
    c1 = -2.0 * x1**4 + 8.0 * x1**3 - 8.0 * x1**2 + x2 - 2.0
    c2 = (-4.0 * x1**4 + 32.0 * x1**3 - 88.0 * x1**2 + 96.0 * x1 + x2
          - 36.0)
    return np.array([-x1 - x2, c1, c2]).T


def _host_cstr(x):
    """x1 <= 2.1, as a host callback: numpy in, python float out."""
    return float(np.asarray(x, dtype=float)[0]) - 2.1


@pytest.fixture(scope="module")
def g24_surrogates():
    """egobox_tpu's surrogates of a 12-point G24 design (nugget 1e-6), the
    same carried over to the port, and one scaling cloud."""
    rng = np.random.default_rng(12)
    x = rng.uniform(XLIMITS[:, 0], XLIMITS[:, 1], (12, 2))
    y = g24(x)
    spec = jsur.GpSpec(n_start=2, max_iters=10, nugget=1e-6)
    mj = jsur.train_gp_surrogates(
        jnp.asarray(x), jnp.asarray(y), jnp.ones(12, bool), spec, seed=3)
    fields = {f.name: np.asarray(getattr(mj, f.name))
              for f in dataclasses.fields(mj)
              if f.name not in ("corr", "trend", "w_star")}
    fields["w_star"] = None
    mt = gp_surrogates_from_numpy(fields, mj.corr, mj.trend, device="cpu")
    feas = (y[:, 1:] <= CSTR_TOLS).all(axis=1)
    fmin = float(y[feas, 0].min()) if feas.any() else float(y[:, 0].min())
    cloud = rng.uniform(XLIMITS[:, 0], XLIMITS[:, 1], (200, 2))
    return mj, mt, fmin, cloud


@pytest.mark.parametrize("crit,cstr_infill", [("EI", False),
                                              ("LogEI", True)])
def test_fcstr_polish_matches_jax(g24_surrogates, crit, cstr_infill):
    mj, mt, fmin, cloud = g24_surrogates
    xk = np.array([2.4, 3.2])  # beyond the function constraint
    common = dict(n_cstr=2, cstr_tol=np.array([1e-3, 1e-3, 1e-3]))

    def kwargs(mod, models, cl, tols):
        s_inf, s_cstr, s_wb2 = mod.compute_scaling(
            models, cl, fmin, tols, crit=crit, n_cstr=2,
            cstr_infill=cstr_infill)
        return dict(fmin=fmin, scale_infill=s_inf, scale_wb2=s_wb2,
                    scale_cstr=s_cstr, cstr_tols=tols, crit=crit,
                    cstr_strategy="MC", n_cstr=2, cstr_infill=cstr_infill,
                    feasibility=True, optimizer="COBYLA")

    js = jsolver.EgorSolver(jcfg.EgorConfig(**common), XLIMITS)
    want = js._fcstr_polish(
        xk, mj, [_host_cstr], jnp.asarray(cloud),
        kwargs(jio, mj, jnp.asarray(cloud), jnp.asarray(CSTR_TOLS)),
        XLIMITS)
    ts = EgorSolver(EgorConfig(**common), XLIMITS, device="cpu")
    tc = torch.from_numpy(cloud)
    stats = {}
    got = ts._fcstr_polish(
        xk, mt, [_host_cstr], tc,
        kwargs(tio, mt, tc, torch.from_numpy(CSTR_TOLS)), XLIMITS,
        stats)
    width = XLIMITS[:, 1] - XLIMITS[:, 0]
    assert np.all(np.abs(got - np.asarray(want)) <= 1e-6 * width), (got,
                                                                    want)
    assert got[0] <= 2.1 + 1e-3
    # one posterior evaluation (one host read) per simplex evaluation; the
    # three rounds of at most 133 evaluations
    assert 0 < stats["evals"] <= 3 * 133


# ---------------------------------------------------------------------------
# the repairs of the host path, one suggest against egobox_tpu's
# ---------------------------------------------------------------------------


def _suggest_both(monkeypatch, fcstr_j, fcstr_t):
    """egobox_tpu's ``suggest`` with its LHS draws recorded, then the port's
    with those draws handed in; both on an 8-point xsinx design."""
    xl = np.array([[0.0, 25.0]])
    x = np.random.default_rng(5).uniform(0.0, 25.0, (8, 1))
    y = xsinx(x)
    common = dict(n_start=4, seed=42)
    recorded = []
    for name in ("_lhs", "_lhs_in"):
        orig = getattr(jsolver.EgorSolver, name)

        def wrapped(self, *a, _orig=orig, **k):
            pts = np.asarray(_orig(self, *a, **k))
            recorded.append(pts)
            return pts

        monkeypatch.setattr(jsolver.EgorSolver, name, wrapped)
    js = jsolver.EgorSolver(
        jcfg.EgorConfig(gp_config=jcfg.GpConfig(n_start=2, max_eval=10),
                        **common), xl)
    want = js.suggest(x, y, fcstrs=[fcstr_j])
    ts = EgorSolver(
        EgorConfig(gp_config=GpConfig(n_start=2, max_eval=10), **common), xl,
        device="cpu")
    ts.draws = _ReplayDraws(recorded)
    got = ts.suggest(x, y, fcstrs=[fcstr_t])
    assert not ts.draws.recorded  # every draw was asked for, in order
    return ts, got, want


def _cstr_18(x):
    """x <= 18 in operations both libraries trace (x[0] of a jax array or
    of a torch tensor)."""
    return x[0] - 18.0


@pytest.mark.parametrize("env", ["EGOBOX_NO_FUSED_STEP",
                                 "EGOBOX_NO_FCSTR_TRACE"])
def test_host_path_polishes_traceable_constraints_as_jax(monkeypatch, env):
    """Under ``EGOBOX_NO_FUSED_STEP=1`` a constraint written in torch
    operations stays out of the infill optimizer and joins through the
    polish; ``EGOBOX_NO_FCSTR_TRACE=1`` sends such a constraint to that
    host path even where the fused iteration would take it. Either way the
    port proposes egobox_tpu's point."""
    monkeypatch.setenv(env, "1")
    ts, got, want = _suggest_both(monkeypatch, _cstr_18, _cstr_18)
    assert got.shape == want.shape == (1, 1)
    assert np.all(np.abs(got - want) <= 1e-5 * 25.0), (got, want)
    assert got[0, 0] <= 18.0 + 1e-3
    assert "polish" in ts.last_times and ts.last_times["polish_evals"] > 0
    assert not ts._fcstrs_traceable((_cstr_18,)) or \
        env == "EGOBOX_NO_FUSED_STEP"


def test_host_callback_constraint_suggest_matches_jax(monkeypatch):
    """A numpy constraint returning a python float takes the host path on
    the default settings, in both packages."""

    def c18(x):
        return float(np.asarray(x, dtype=float).ravel()[0] - 18.0)

    ts, got, want = _suggest_both(monkeypatch, c18, c18)
    assert not ts._fcstrs_traceable((c18,))
    assert np.all(np.abs(got - want) <= 1e-5 * 25.0), (got, want)
