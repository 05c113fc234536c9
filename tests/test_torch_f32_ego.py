"""The port's float32 EGO path against egobox_tpu's float32 path: the
criteria and one solver step, with the two faults of egobox_tpu's float32
that they meet. egobox_tpu runs under ``jax.enable_x64(False)``, checked
here once against a process started with ``EGOBOX_TPU_NO_X64=1``; the port
on the CPU in float32 (``dtype=torch.float32``).

Tolerances (float32 rounding, times the case's conditioning):

- LogEI where egobox_tpu's float32 value is finite: 16 eps32 relative (the
  libraries' erfc and log1p differ by an ulp or two; log1mexp amplifies
  that by 1 / |w|); where it is NaN, the port's float32 against its own
  float64 value: 1e-5 relative (the asymptotic erfcx the port takes from
  z = 9 in float32 drops 15 / (8 z^6) = 3.5e-6, which reaches LogEI times
  u^2 / |LogEI| <= 2, plus 16 ulps). EI: eps32 sigma absolute (its direct
  form cancels in the left tail on both sides) and 2 eps32 relative (the
  rounding of the value itself, about sigma u in the right tail); PoF:
  eps32 absolute.
- One step: the next x within 8 eps32 kappa of the box width, kappa =
  (1 + nugget) / nugget, the bound the Gershgorin-scaled nugget of 1e-3
  puts on the surrogates' Grams (the criterion's relative error, which
  moves its argmin by as much of the box).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egobox_tpu.doe.lhs import maximin_lhs as jax_maximin_lhs
from egobox_tpu.ego import config as jcfg
from egobox_tpu.ego import criteria as jc
from egobox_tpu.ego import solver as jsolver
from egobox_tpu.ego.surrogates import GpSpec as JGpSpec
from egobox_tpu.gp import likelihood as jlk
from egobox_torch.ego import EgorConfig, EgorSolver, GpConfig
from egobox_torch.ego import criteria as tc
from egobox_torch.ego.surrogates import GpSpec
from egobox_torch.gp import likelihood as tlk
from test_torch_criteria import FMIN, U_GRID, _posterior
from test_torch_ego import ONE_STEP

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
EPS32 = float(np.finfo(np.float32).eps)
LOGEI_RTOL, LOGEI_BAND_RTOL = 16 * EPS32, 1e-5
STEP_NUGGET = 1e-3
STEP_TOL = 8 * EPS32 * (1.0 + STEP_NUGGET) / STEP_NUGGET
#: the 10-point grid of u on which egobox_tpu's float32 log_ei_helper
#: returns NaN from -35 to -15
NAN_GRID = np.linspace(-40.0, 5.0, 10)


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _jax_log_ei_helper_f32(u):
    with jax.enable_x64(False):
        return np.asarray(jc.log_ei_helper(jnp.asarray(u, jnp.float32)))


@pytest.fixture(scope="module", autouse=True)
def no_x64_process():
    """A process started with ``EGOBOX_TPU_NO_X64=1`` that prints
    egobox_tpu's float32 ``log_ei_helper`` on NAN_GRID; started before this
    file's first test and read by its last, so that it runs beside them."""
    code = (
        "import json, jax, numpy as np\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "import jax.numpy as jnp\n"
        "from egobox_tpu.config import default_dtype\n"
        "from egobox_tpu.ego import criteria as jc\n"
        "assert not jax.config.jax_enable_x64\n"
        "assert default_dtype() == jnp.float32\n"
        f"u = jnp.asarray({NAN_GRID.tolist()!r}, jnp.float32)\n"
        "print(json.dumps(np.asarray(jc.log_ei_helper(u)).tobytes().hex()))\n"
    )
    env = dict(os.environ, EGOBOX_TPU_NO_X64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT))
    proc = subprocess.Popen([sys.executable, "-c", code], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


# ---------------------------------------------------------------------------
# 5. ego.criteria
# ---------------------------------------------------------------------------


def test_log_ei_helper_nan_band_is_the_references():
    """egobox_tpu's float32 ``erfcx`` switches to its series at z = 25
    (egobox_tpu/ego/criteria.py:32-40); below that exp(z^2) overflows in
    float32 and the product with erfc is inf x 0: ``log_ei_helper`` is NaN
    over u in [-35, -15] of NAN_GRID. The port switches at z = 9 in
    float32: finite everywhere, within LOGEI_BAND_RTOL of its float64
    value, and equal to egobox_tpu's float32 where that is finite."""
    ref = _jax_log_ei_helper_f32(NAN_GRID)
    band = ~np.isfinite(ref)
    np.testing.assert_array_equal(NAN_GRID[band], NAN_GRID[
        (NAN_GRID >= -35.0) & (NAN_GRID <= -15.0)])
    got = tc.log_ei_helper(_t(NAN_GRID)).numpy()
    got64 = tc.log_ei_helper(_t(NAN_GRID, torch.float64)).numpy()
    assert got.dtype == np.float32 and np.all(np.isfinite(got))
    np.testing.assert_allclose(got[band], got64[band],
                               rtol=LOGEI_BAND_RTOL)
    np.testing.assert_allclose(got[~band], ref[~band], rtol=LOGEI_RTOL)


@pytest.mark.parametrize("var", [2.5, 1e-6])
@pytest.mark.parametrize("name", ["log_ei", "ei", "pof"])
def test_criteria_f32_match_jax(name, var):
    """LogEI, EI and PoF over tests/test_torch_criteria.py's grid of u, in
    float32. Where egobox_tpu's float32 LogEI is NaN (its erfcx, above, and
    its large-|u| branch) the port is finite and holds its float64 value."""
    mean, v = _posterior(U_GRID, var)
    mean, v = mean.astype(np.float32), v.astype(np.float32)

    def call(mod, m, s, fmin):
        f = getattr(mod, name)
        return f(m, s) if name == "pof" else f(m, s, fmin)

    with jax.enable_x64(False):
        want = np.asarray(call(jc, jnp.asarray(mean), jnp.asarray(v),
                               jnp.float32(FMIN)))
    got = call(tc, _t(mean), _t(v), _t(FMIN)).numpy()
    assert got.dtype == want.dtype == np.float32
    if name == "pof":
        np.testing.assert_allclose(got, want, rtol=0, atol=EPS32)
        return
    if name == "ei":
        np.testing.assert_allclose(got, want, rtol=2 * EPS32,
                                   atol=EPS32 * np.sqrt(var))
        return
    fin = np.isfinite(want)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got[fin], want[fin], rtol=LOGEI_RTOL)
    if not fin.all():
        got64 = call(tc, _t(mean, torch.float64), _t(v, torch.float64),
                     _t(FMIN, torch.float64)).numpy()
        np.testing.assert_allclose(got[~fin], got64[~fin],
                                   rtol=LOGEI_BAND_RTOL)


# ---------------------------------------------------------------------------
# the surrogates' nugget in float32
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("corr", ["matern52", "squared_exponential"])
def test_references_ego_nugget_fails_a_clustered_float32_design(corr):
    """egobox_tpu's EGO surrogates take ``GpSpec.nugget`` = 100 x 2.2e-16
    in every type (egobox_tpu/ego/surrogates.py:41): in float32, 1 + that
    is 1. Once the design clusters near an optimum, as an EGO run's does
    (here 200 points of [-1, 1]^10 and 10 more within 1e-3 of one of
    them, theta 0.15), its float32 Cholesky fails: likelihood -inf, for
    the port too at that nugget. The port's surrogates take 100 eps of the
    design's type (``GpSpec.nugget`` None): finite there, within
    4 eps32 / nugget of its own float64 value. (On the card the float32
    d=10 refit of 1 011 points returned a -inf model with egobox_tpu's
    nugget; from egobox_tpu's DoE and draws the 5-35-point G24 runs land
    on the golden with it: PERF.md.)"""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.0, 1.0, (200, 10))
    x = np.concatenate([x, x[0] + 1e-3 * rng.standard_normal((10, 10))])
    y = np.sum(np.sin(2.0 * x), axis=1, keepdims=True)
    xn = ((x - x.mean(0)) / x.std(0, ddof=1)).astype(np.float32)
    ys = y.std(0, ddof=1)
    yn = ((y - y.mean(0)) / ys).astype(np.float32)
    theta = np.full(10, 0.15, np.float32)
    with jax.enable_x64(False):
        ref, _ = jlk.reduced_likelihood(
            corr, "constant", jnp.asarray(xn), jnp.asarray(yn),
            jnp.asarray(ys, jnp.float32), jnp.asarray(theta), None,
            JGpSpec().nugget)
    args = (corr, "constant", _t(xn), _t(yn), _t(ys), _t(theta), None)
    at_ref_nugget, _ = tlk.reduced_likelihood(*args, JGpSpec().nugget)
    assert float(ref) == float(at_ref_nugget) == -np.inf
    assert GpSpec().nugget is None  # 100 eps of the design's type
    nugget = 100.0 * EPS32
    got, _ = tlk.reduced_likelihood(*args, nugget)
    want, _ = tlk.reduced_likelihood(*args[:2], *(a.double() for a in
                                                  args[2:6]), None, nugget)
    assert got.dtype == torch.float32 and np.isfinite(float(got))
    assert abs(float(got) - float(want)) <= 4 * EPS32 / nugget * abs(
        float(want))


# ---------------------------------------------------------------------------
# 7. ego.solver: one step
# ---------------------------------------------------------------------------


class _JaxFitDraws:
    """The float32 restart seeds egobox_tpu's fit draws from ``key(seed)``."""

    def __init__(self, seed):
        self.key = jax.random.key(seed)

    def lhs_seeds(self, n_start, dim, dtype, device):
        with jax.enable_x64(False):
            pts = jax_maximin_lhs(self.key, n_start, dim, False, 5,
                                  jnp.float32)
        return torch.from_numpy(np.array(pts)).to(dtype=dtype, device=device)


class _ReplayDraws:
    """egobox_tpu's LHS draws, in the order its solver asked for them."""

    def __init__(self, recorded):
        self.recorded = list(recorded)

    def lhs(self, n, xlimits, kind=None):
        pts = self.recorded.pop(0)
        assert pts.shape == (n, xlimits.shape[0])
        return pts

    def fit_draws(self, seed):
        return _JaxFitDraws(seed)


@pytest.mark.parametrize("case", sorted(ONE_STEP))
def test_select_next_points_f32_matches_jax(case, monkeypatch):
    """tests/test_torch_ego.py's one-step parity in float32: both solvers
    on their unfused path in float32, egobox_tpu's draws (scaling cloud,
    LHS completion, fit seeds) captured and handed in, the surrogates'
    nugget 1e-3 on both sides (egobox_tpu's own is nothing in float32,
    above) and egobox_tpu's design unpadded (``shape_bucket=1``: its
    unfused path pads the design to the bucket, and the padded rows carry
    the nugget on their diagonal, which moves its likelihood where the
    nugget is not negligible; the port's unfused path fits the design as
    it is)."""
    c = ONE_STEP[case]
    xl = c["xlimits"]
    x = np.random.default_rng(5).uniform(xl[:, 0], xl[:, 1],
                                         (c["n"], len(xl)))
    y = c["fun"](x)
    common = dict(n_start=4, seed=42, **c["kw"])
    gpc = dict(n_start=2, max_eval=10)

    monkeypatch.setenv("EGOBOX_NO_FUSED_STEP", "1")
    recorded = []
    for name in ("_lhs", "_lhs_in"):
        orig = getattr(jsolver.EgorSolver, name)

        def wrapped(self, *a, _orig=orig, **k):
            pts = np.asarray(_orig(self, *a, **k))
            recorded.append(pts)
            return pts

        monkeypatch.setattr(jsolver.EgorSolver, name, wrapped)
    with jax.enable_x64(False):
        js = jsolver.EgorSolver(jcfg.EgorConfig(
            gp_config=jcfg.GpConfig(**gpc), shape_bucket=1, **common), xl)
        js.spec = dataclasses.replace(js.spec, nugget=STEP_NUGGET)
        want = js.suggest(x, y)
    assert all(r.dtype == np.float32 for r in recorded)

    ts = EgorSolver(EgorConfig(gp_config=GpConfig(**gpc), **common), xl,
                    device="cpu", dtype=torch.float32)
    ts.spec = dataclasses.replace(ts.spec, nugget=STEP_NUGGET)
    ts.draws = _ReplayDraws(recorded)
    got = ts.suggest(x, y)
    assert not ts.draws.recorded  # every draw was asked for, in order
    assert ts.last_models.r_chol.dtype == torch.float32
    width = xl[:, 1] - xl[:, 0]
    assert got.shape == want.shape == (1, len(xl))
    assert np.all(np.abs(got - want) <= STEP_TOL * width), (got, want)


# ---------------------------------------------------------------------------
# the toggle, once (last: its process runs from the file's first test on)
# ---------------------------------------------------------------------------


def test_in_process_float32_equals_a_no_x64_process(no_x64_process):
    """egobox_tpu under ``jax.enable_x64(False)`` in this process computes
    the same bits as a process started with ``EGOBOX_TPU_NO_X64=1`` (its
    own switch, which bench.py sets): ``log_ei_helper`` on NAN_GRID, NaN
    band included. Every float32 reference of the lane relies on it."""
    out, err = no_x64_process.communicate(timeout=240)
    assert no_x64_process.returncode == 0, err
    out = out.strip().splitlines()[-1]
    theirs = np.frombuffer(bytes.fromhex(json.loads(out)), np.float32)
    ours = _jax_log_ei_helper_f32(NAN_GRID)
    assert ours.dtype == np.float32
    assert ours.tobytes() == theirs.tobytes()
    with jax.enable_x64(False):
        from egobox_tpu.config import default_dtype

        assert default_dtype() == jnp.float32
    assert jax.config.jax_enable_x64  # restored on leaving the block
