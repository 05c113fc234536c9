"""The Egor loop of egobox_torch: one step against egobox_tpu and the whole
loop against the goldens of tests/test_ego.py. float64, ``device="cpu"``.
(tests/test_torch_ego_host.py holds the host-side modules and the paths
that raise.)

One step: ``EgorSolver.suggest`` on a fixed design, the JAX solver on its
unfused path (``EGOBOX_NO_FUSED_STEP=1``, read at call time), its draws
(scaling cloud, LHS seed completion, fit restart seeds) captured and handed
to the port's draws object. Tolerance: the next x within 1e-5 of the box
width. Trajectories over many iterations are not compared: multistart
argmins branch on rounding.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import egobox_tpu as jegx
from egobox_tpu.doe.lhs import maximin_lhs as jax_maximin_lhs
from egobox_tpu.ego import config as jcfg
from egobox_tpu.ego import solver as jsolver
from egobox_tpu.ego import state as jstate
import egobox_torch as egx
from egobox_torch import convert
from egobox_torch.ego import (Egor, EgorConfig, EgorSolver, GpConfig,
                              NoMorePointToAddError)
from egobox_torch.ego.egor import EGOR_CHECKPOINT_FILE

torch.set_num_threads(2)


def xsinx(x):
    x = np.atleast_2d(x)
    return ((x - 3.5) * np.sin((x - 3.5) / np.pi)).reshape(-1, 1)


def g24(point):
    p = np.atleast_2d(point)
    x1, x2 = p[:, 0], p[:, 1]
    c1 = -2.0 * x1**4 + 8.0 * x1**3 - 8.0 * x1**2 + x2 - 2.0
    c2 = (-4.0 * x1**4 + 32.0 * x1**3 - 88.0 * x1**2 + 96.0 * x1 + x2
          - 36.0)
    return np.array([-x1 - x2, c1, c2]).T


# ---------------------------------------------------------------------------
# one step against egobox_tpu
# ---------------------------------------------------------------------------


class _JaxFitDraws:
    """The restart seeds egobox_tpu's fit draws from ``key(seed)``."""

    def __init__(self, seed):
        self.key = jax.random.key(seed)

    def lhs_seeds(self, n_start, dim, dtype, device):
        pts = jax_maximin_lhs(self.key, n_start, dim, False, 5, jnp.float64)
        return torch.from_numpy(np.array(pts)).to(dtype=dtype, device=device)


class _ReplayDraws:
    """egobox_tpu's LHS draws, in the order the solver asked for them."""

    def __init__(self, recorded):
        self.recorded = list(recorded)

    def lhs(self, n, xlimits, kind=None):
        pts = self.recorded.pop(0)
        assert pts.shape == (n, xlimits.shape[0])
        return pts

    def fit_draws(self, seed):
        return _JaxFitDraws(seed)


ONE_STEP = {
    "xsinx-8": dict(
        xlimits=np.array([[0.0, 25.0]]), fun=xsinx, n=8, kw={}),
    "g24-12": dict(
        xlimits=np.array([[0.0, 3.0], [0.0, 4.0]]), fun=g24, n=12,
        kw=dict(n_cstr=2, cstr_tol=np.array([1e-3, 1e-3]))),
}


@pytest.mark.parametrize("case", sorted(ONE_STEP))
def test_select_next_points_matches_jax(case, monkeypatch):
    c = ONE_STEP[case]
    xl = c["xlimits"]
    x = np.random.default_rng(5).uniform(xl[:, 0], xl[:, 1], (c["n"], len(xl)))
    y = c["fun"](x)
    common = dict(n_start=4, seed=42, **c["kw"])

    monkeypatch.setenv("EGOBOX_NO_FUSED_STEP", "1")
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
    want = js.suggest(x, y)

    ts = EgorSolver(
        EgorConfig(gp_config=GpConfig(n_start=2, max_eval=10), **common), xl,
        device="cpu")
    ts.draws = _ReplayDraws(recorded)
    got = ts.suggest(x, y)
    assert not ts.draws.recorded  # every draw was asked for, in order
    assert ts.last_models.x_norm.shape == (y.shape[1], c["n"], len(xl))
    width = xl[:, 1] - xl[:, 0]
    assert got.shape == want.shape == (1, len(xl))
    assert np.all(np.abs(got - want) <= 1e-5 * width), (got, want)


# ---------------------------------------------------------------------------
# the whole loop on the port
# ---------------------------------------------------------------------------


#: the seeds of the xsinx golden (the first is egobox_tpu's own) and how
#: many of them must meet the gate on x; chip_smoke.py holds the same set
#: to the same share on the GPU
XSINX_SEEDS = (42, 2, 3)
XSINX_X_MIN = 2


def test_xsinx_golden():
    """y=-15.125 +- 1e-3 @ x=18.935 +- 1e-3 in 20 iterations
    (tests/test_ego.py:51-56), over a set of seeds: y at every seed, x at 2
    of the 3 at least. Whether the last points land within 1e-3 of the
    optimum in x (1e-6 in y) depends on the draw stream (torch's is not
    JAX's) and on rounding, on both sides: egobox_tpu meets that gate at
    seeds 42, 2, 3 and misses it at seed 1."""
    x_met = []
    for seed in XSINX_SEEDS:
        egor = Egor([[0.0, 25.0]], seed=seed, device="cpu")
        res = egor.minimize(xsinx, max_iters=20)
        assert abs(res.y_opt[0] - (-15.125)) < 1e-3, seed
        assert res.x_doe.shape == (25, 1)
        assert len(egor.iteration_times) == 20
        # the default path is the fused iteration: one program per step
        assert set(egor.iteration_times[0]) == {"select", "graph", "total"}
        x_met.append(abs(res.x_opt[0] - 18.935) < 1e-3)
    assert sum(x_met) >= XSINX_X_MIN, x_met


def test_g24_utb_short():
    """The G24 golden's configuration (tests/test_ego.py:74-89) cut to 12
    iterations: a feasible point below -5.0."""
    egor = Egor(
        [[0.0, 3.0], [0.0, 4.0]], cstr_tol=np.array([1e-3, 1e-3]), n_cstr=2,
        seed=42, q_optmod=2, n_doe=5,
        cstr_strategy=egx.ConstraintStrategy.UTB, device="cpu")
    res = egor.minimize(g24, max_iters=12)
    assert res.y_opt[0] < -5.0
    assert np.all(res.y_opt[1:] <= 1e-3)
    assert res.x_doe.shape == (17, 2) and res.y_doe.shape == (17, 3)


@pytest.mark.slow
def test_g24_utb_golden():
    """y=-5.5080 +- 1e-2 @ (2.3295, 3.1785) +- 1e-2, 30 iterations."""
    egor = Egor(
        [[0.0, 3.0], [0.0, 4.0]], cstr_tol=np.array([1e-3, 1e-3]), n_cstr=2,
        seed=42, q_optmod=2, n_doe=5,
        cstr_strategy=egx.ConstraintStrategy.UTB, device="cpu")
    res = egor.minimize(g24, max_iters=30)
    assert abs(res.y_opt[0] - (-5.5080)) < 1e-2
    assert abs(res.x_opt[0] - 2.3295) < 1e-2
    assert abs(res.x_opt[1] - 3.1785) < 1e-2
    assert np.all(res.y_opt[1:] <= 1e-3)
    assert res.x_doe.shape == (35, 2)


def test_trego_runs_local_steps():
    """TREGO alternates a global step with local ones seeded inside the
    trust region; 6 iterations of G24 end feasible."""
    egor = Egor(
        [[0.0, 3.0], [0.0, 4.0]], cstr_tol=np.array([1e-3, 1e-3]), n_cstr=2,
        seed=42, n_doe=5, trego=True, device="cpu")
    res = egor.minimize(g24, max_iters=6)
    assert res.x_doe.shape[0] > 5
    assert np.all(res.y_opt[1:] <= 1e-3)
    assert res.y_opt[0] < -4.0


def test_egor_service_suggest():
    """Ask-and-tell loop with EI (tests/test_ego.py:121-138)."""
    egor = Egor([[0.0, 25.0]], infill_strategy=egx.InfillStrategy.EI,
                seed=42, device="cpu")
    x_doe = np.array([[3.0], [12.0], [24.0]])
    y_doe = xsinx(x_doe)
    for _ in range(10):
        x = egor.suggest(x_doe, y_doe)
        assert x.shape == (1, 1) and 0.0 <= x[0, 0] <= 25.0
        x_doe = np.concatenate((x_doe, x))
        y_doe = np.concatenate((y_doe, xsinx(x)))
    res = egor.get_result(x_doe, y_doe)
    assert abs(res.y_opt[0] - (-15.125)) < 1e-2
    assert egor.get_result_index(y_doe) == int(np.argmin(y_doe[:, 0]))


def test_warm_start(tmp_path):
    """Warm start reloads the evaluated DoE, or the initial-DoE snapshot
    when only that exists (tests/test_ego.py:153-171, :396-411)."""
    outdir = str(tmp_path)
    egor = Egor([[0.0, 25.0]], seed=42, outdir=outdir, n_doe=6, device="cpu")
    res = egor.minimize(xsinx, max_iters=3)
    assert os.path.exists(os.path.join(outdir, "egor_initial_doe.npy"))
    assert os.path.exists(os.path.join(outdir, "egor_doe.npy"))
    egor2 = Egor([[0.0, 25.0]], outdir=outdir, warm_start=True, seed=42,
                 device="cpu")
    res2 = egor2.minimize(xsinx, max_iters=2)
    assert res2.x_doe.shape[0] == res.x_doe.shape[0] + 2
    np.testing.assert_array_equal(res2.x_doe[:9], res.x_doe)
    os.remove(os.path.join(outdir, "egor_doe.npy"))
    np.save(os.path.join(outdir, "egor_initial_doe.npy"),
            np.hstack([res.x_doe[:6], res.y_doe[:6]]))
    res3 = Egor([[0.0, 25.0]], outdir=outdir, warm_start=True, seed=42,
                device="cpu").minimize(xsinx, max_iters=1)
    assert res3.x_doe.shape[0] == 7


def test_hot_start_checkpoint(tmp_path):
    """Hot start resumes the full solver state (tests/test_ego.py:174-184)."""
    outdir = str(tmp_path)
    egor = Egor([[0.0, 25.0]], seed=42, outdir=outdir, hot_start=0,
                device="cpu")
    egor.minimize(xsinx, max_iters=4)
    ckpt = os.path.join(outdir, EGOR_CHECKPOINT_FILE)
    with open(ckpt) as f:
        payload = json.load(f)
    assert payload["iter"] == 4
    egor2 = Egor([[0.0, 25.0]], seed=42, outdir=outdir, hot_start=0,
                 device="cpu")
    res2 = egor2.minimize(xsinx, max_iters=7)
    assert len(egor2.iteration_times) == 3  # picked up at iteration 4
    assert res2.x_doe.shape[0] == 5 + 7
    # hot_start=n extends the budget by n
    egor3 = Egor([[0.0, 25.0]], seed=42, outdir=outdir, hot_start=2,
                 device="cpu")
    egor3.minimize(xsinx, max_iters=7)
    assert len(egor3.iteration_times) == 2


def test_checkpoint_written_by_jax_resumes_in_port(tmp_path):
    """A hot-start checkpoint of egobox_tpu's Egor (the ``to_dict``
    payload) resumes in the port, through ``convert.egor_state_from_dict``
    and through ``Egor(hot_start=...)`` itself."""
    outdir = str(tmp_path)
    jegx.Egor([[0.0, 25.0]], seed=42, outdir=outdir, hot_start=0,
              n_start=4).minimize(xsinx, max_iters=2)
    with open(os.path.join(outdir, EGOR_CHECKPOINT_FILE)) as f:
        payload = json.load(f)
    state = convert.egor_state_from_dict(payload)
    assert state.iter == 2 and state.x_data.shape == (7, 1)
    assert state.theta_inits.shape == (1, 1)
    # the generator's state came along: the next draw is egobox_tpu's
    twin = jstate.EgorState.from_dict(payload)
    assert state.rng.integers(0, 2**31) == twin.rng.integers(0, 2**31)
    egor = Egor([[0.0, 25.0]], seed=42, outdir=outdir, hot_start=0,
                device="cpu")
    res = egor.minimize(xsinx, max_iters=5)
    assert len(egor.iteration_times) == 3
    assert res.x_doe.shape[0] == 10
    np.testing.assert_array_equal(res.x_doe[:7, 0],
                                  np.asarray(payload["x_data"])[:, 0])


def test_nan_objective_robustness():
    """Failed (NaN) evaluations are imputed (tests/test_ego.py:332-345)."""
    def nan_prone(x):
        x = np.atleast_2d(x)
        y = ((x - 3.5) * np.sin((x - 3.5) / np.pi)).reshape(-1, 1)
        y[x.reshape(-1, 1) > 22.0] = np.nan
        return y

    res = Egor([[0.0, 25.0]], seed=42, device="cpu").minimize(
        nan_prone, max_iters=12)
    assert abs(res.y_opt[0] - (-15.125)) < 1e-2
    assert not np.isnan(res.y_doe).any()


def test_nan_in_initial_doe_imputed():
    """NaNs in the initial DoE are imputed before any fit
    (tests/test_ego.py:348-366)."""
    def half_nan(x):
        x = np.atleast_2d(x)
        y = ((x - 3.5) * np.sin((x - 3.5) / np.pi)).reshape(-1, 1)
        y[x.reshape(-1, 1) > 12.0] = np.nan
        return y

    doe = np.array([[1.0], [6.0], [14.0], [20.0], [24.0]])  # 3/5 NaN
    res = Egor([[0.0, 25.0]], seed=1, doe=doe, device="cpu").minimize(
        half_nan, max_iters=10)
    assert not np.isnan(res.y_doe).any()
    assert res.y_opt[0] < 0.5
    assert res.x_opt[0] <= 12.0


def test_function_constraint_written_in_torch():
    """A constraint that maps a tensor to a tensor enters the optimizer as
    a hard constraint: xsinx s.t. x <= 18 (tests/test_ego.py:317-329)."""
    egor = Egor([[0.0, 25.0]], seed=42, device="cpu")
    res = egor.minimize(xsinx, fcstrs=[lambda x: x[0] - 18.0], max_iters=10)
    true_y = float(xsinx(np.array([[18.0]]))[0, 0])
    assert res.x_opt[0] <= 18.0 + 1e-3
    assert abs(res.y_opt[0] - true_y) < 0.5


def test_mixed_integer_run():
    """An INT variable: every evaluated point is an integer."""
    specs = [egx.XSpec(egx.XType.INT, [0.0, 25.0])]
    res = Egor(specs, seed=42, device="cpu").minimize(xsinx, max_iters=6)
    np.testing.assert_array_equal(res.x_doe, np.round(res.x_doe))
    assert res.y_opt[0] < -14.0


def test_constructor():
    with pytest.raises(TypeError):
        Egor()
    Egor([[0.0, 25.0]], n_doe=10, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        Egor([], device="cpu")


def test_runs_on_the_card_unless_asked_otherwise():
    """numpy in, no device: the card; without one the constructor raises."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Egor([[0.0, 25.0]], seed=42)
    egor = Egor([[0.0, 25.0]], seed=42, device="cpu")
    assert egor.solver.device.type == "cpu"
    assert egor.solver.dtype == torch.float64
    # ``dtype`` fixes the type (the float32 finding of PERF.md is made so)
    egor32 = Egor([[0.0, 25.0]], seed=42, device="cpu", dtype=torch.float32)
    egor32.minimize(xsinx, max_iters=1)
    assert egor32.solver.last_models.r_chol.dtype == torch.float32
    # the default on the card: float64 below 4 096 points, whatever the
    # kernel and the dimension
    assert egx.config.egor_dtype("cuda", 1000) == torch.float64
    assert egx.config.egor_dtype("cuda", 4095) == torch.float64
    assert egx.config.egor_dtype("cuda", 4096) == torch.float32
    assert egx.config.egor_dtype("cpu", 4096) == torch.float64


def test_full_config_dump(tmp_path):
    """egor_config.json carries the entire configuration
    (tests/test_ego.py:414-439)."""
    outdir = str(tmp_path)
    egor = Egor(
        [[0.0, 3.0], [0.0, 4.0]], n_cstr=2,
        cstr_tol=np.array([1e-3, 1e-3]), seed=11, outdir=outdir, n_doe=5,
        q_optmod=2, infill_optimizer=egx.InfillOptimizer.SLSQP, device="cpu")
    egor.minimize(g24, max_iters=1)
    with open(os.path.join(outdir, "egor_config.json")) as f:
        payload = json.load(f)
    assert payload["n_cstr"] == 2
    assert payload["cstr_tol"] == [1e-3, 1e-3]
    assert payload["q_optmod"] == 2
    assert payload["infill_optimizer"] == egx.InfillOptimizer.SLSQP.value
    assert payload["gp_config"]["n_clusters"] == 1
    assert payload["gp_config"]["recombination"] == (
        egx.Recombination.HARD.value)
    assert payload["trego"]["activated"] is False
    assert len(payload["xspecs"]) == 2
    assert payload["xspecs"][0]["xlimits"] == [0.0, 3.0]
    # the pad quantum of the fused path: EGOBOX_SHAPE_BUCKET, as in
    # egobox_tpu (the test configuration sets it)
    assert payload["shape_bucket"] == egor.config.shape_bucket == int(
        os.environ.get("EGOBOX_SHAPE_BUCKET", "8"))


def test_no_more_point_to_add_stops_the_run():
    """A solver that keeps proposing a known point gives up after its
    retries and ``minimize`` returns what it has."""
    egor = Egor([[0.0, 25.0]], seed=42, device="cpu", n_doe=4)
    def stuck(state, *a, **k):
        return state.x_data[:1].copy(), np.zeros((1, 1)), 0.0

    egor.solver.select_next_points = stuck
    res = egor.minimize(xsinx, max_iters=5)
    assert res.x_doe.shape[0] == 4
    state = egor.solver.init_state(xsinx)
    with pytest.raises(NoMorePointToAddError):
        egor.solver.ego_step(state, xsinx)
