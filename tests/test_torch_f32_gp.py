"""The port's float32 path against egobox_tpu's float32 path: the Gram, the
likelihood and its adjoint, the fit recipe, predict and variance, the
sparse GP. Inputs from numpy seeds in float32; egobox_tpu under
``jax.enable_x64(False)`` (the float32 it computes in on its accelerator;
tests/test_torch_f32_ego.py checks once that this equals a process started
with ``EGOBOX_TPU_NO_X64=1``); the port on the CPU in float32.

Tolerances are float32 rounding times the case's conditioning:

- Gram: 4 d eps32 absolute (a d-term log-space sum, exp'd); the squared
  exponential's GEMM expansion on spread points adds its cancellation,
  4 eps32 (|a_i|^2 + |b_j|^2) r_ij;
- dense likelihood, adjoint, fit, mean and variance: 4 eps32 kappa, kappa
  = (1 + nugget) / nugget (the Gershgorin-scaled nugget of 1e-3 bounds
  the Gram's condition number), relative to the value, the largest
  gradient component, max |y| and sigma2;
- sparse likelihoods: 4 eps32 kappa(K(Z, Z) + nugget) times the size of
  their largest terms, n (mean y^2 + sigma2) / noise.

A miss is a finding about the port (or about egobox_tpu, where a test says
so), never a reason to widen a tolerance.
"""

import hashlib
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egobox_tpu import gp as jgp
from egobox_tpu.gp import kernels as jk
from egobox_tpu.gp import likelihood as jlk
from egobox_tpu.gp import sgp as jsgp
from egobox_torch import gp as tgp
from egobox_torch.gp import kernels as tk
from egobox_torch.gp import likelihood as tlk
from egobox_torch.gp import sgp as tsgp
from egobox_torch.ops import corr_kernel as ck

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
EPS32 = float(np.finfo(np.float32).eps)
NUGGET = 1e-3
KAPPA = (1.0 + NUGGET) / NUGGET
RTOL = 4 * EPS32 * KAPPA
KERNELS = ("squared_exponential", "absolute_exponential", "matern32",
           "matern52")
#: SHA-256 of bench.py's data in tests/data/f32_reference.npz
#: (tools/make_f32_reference.py prints them)
BENCH_SHA256 = {
    "bench_x1": "dc5ff4326f356cd74172da859482756ada7aace815e0ed6942f5a4d4cef492a7",
    "bench_y1": "3a61c932468a58522de75e2f33edfab7ab716258e922d4ba59a258bf25cce3e5",
    "bench_x2": "ff9fc1c4d5b25cd483feed9749c99e092423f282fe4ac72b4ae38736e2477db4",
    "bench_y2": "4a53b83a14869f2b27796fbe7259ba0f9afdc243dd5a9d8883af55b3bc31c44c",
    "bench_x3": "dca6771ccfc23d2a278ef64023b90d6a38b82df9022ddd728b05b3e29b57fee0",
    "bench_y3": "aed8a3fdb02240b40cdd01e2b9fd56b2eecbefdc05540cd76ebf4453d5f72289",
}


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(a)


# ---------------------------------------------------------------------------
# 1. gp.kernels.corr_cross
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(50, 40, 3), (1024, 1024, 10)],
                         ids=["dense", "blocked"])
@pytest.mark.parametrize("name", KERNELS)
def test_corr_cross_f32_matches_jax(name, shape):
    """The dense path, and the row-blocked one above 8e6 elements (JAX's
    ``lax.map`` blocks, the port's ``_row_blocks``; K1 on the card)."""
    n1, n2, d = shape
    rng = np.random.default_rng(n1)
    x1 = rng.uniform(-1.0, 1.0, (n1, d)).astype(np.float32)
    x2 = rng.uniform(-1.0, 1.0, (n2, d)).astype(np.float32)
    th = rng.uniform(0.3, 1.5, d).astype(np.float32)
    with jax.enable_x64(False):
        want = np.asarray(jk.corr_cross(name, _j(x1), _j(x2), _j(th)))
    got = tk.corr_cross(name, _t(x1), _t(x2), _t(th))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=4 * d * EPS32)


def test_sqexp_expansion_cancels_alike_on_spread_points():
    """The squared exponential's ||a||^2 + ||b||^2 - 2 a.b expansion
    (egobox_tpu/gp/kernels.py:108-120) on points far from the origin,
    where float32 cancels: both packages within the cancellation bound
    of float64, and of each other. The port keeps the reference's order
    (scale, squares, GEMM, clamp at 0)."""
    rng = np.random.default_rng(3)
    x1 = (rng.uniform(-1.0, 1.0, (64, 4)) + 20.0).astype(np.float32)
    x2 = (x1 + rng.normal(0.0, 0.05, x1.shape)).astype(np.float32)
    th = np.full(4, 0.3, np.float32)
    with jax.enable_x64(False):
        want = np.asarray(jk.corr_cross("squared_exponential", _j(x1),
                                        _j(x2), _j(th)))
    got = tk.corr_cross("squared_exponential", _t(x1), _t(x2),
                        _t(th)).numpy()
    r64 = tk.corr_cross("squared_exponential", _t(x1).double(),
                        _t(x2).double(), _t(th).double()).numpy()
    a2 = np.sum((x1.astype(np.float64) * th) ** 2, axis=1)[:, None]
    b2 = np.sum((x2.astype(np.float64) * th) ** 2, axis=1)[None, :]
    bound = 4 * EPS32 * ((a2 + b2) * r64 + 1.0)
    # the cancellation is there: far above one ulp of r
    assert np.max(np.abs(want - r64)) > 100 * EPS32
    for v in (got, want):
        assert np.all(np.abs(v - r64) <= bound)
    assert np.all(np.abs(got - want) <= 2 * bound)


# ---------------------------------------------------------------------------
# 2. gp.likelihood
# ---------------------------------------------------------------------------


def _lik_problem(n=300, d=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2.0, 2.0, (n, d))
    y = (np.sum(np.sin(2.0 * x), axis=1)
         + 0.1 * rng.standard_normal(n))[:, None]
    y_std = y.std(0, ddof=1)
    xn = ((x - x.mean(0)) / x.std(0, ddof=1)).astype(np.float32)
    yn = ((y - y.mean(0)) / y_std).astype(np.float32)
    return xn, yn, y_std.astype(np.float32), rng.uniform(
        0.3, 1.2, d).astype(np.float32)


def _jax_vg(corr, trend, xn, yn, ys, theta, probes=0):
    with jax.enable_x64(False):
        f = jlk.make_neg_reduced_likelihood(corr, trend, _j(xn), _j(yn),
                                            _j(ys), None, NUGGET, None,
                                            probes)
        v, g = jax.value_and_grad(f)(_j(theta))
        return float(v), np.asarray(g)


def _torch_vg(corr, trend, xn, yn, ys, theta, probes=0):
    f = tlk.make_neg_reduced_likelihood(corr, trend, _t(xn), _t(yn), _t(ys),
                                        None, NUGGET, None, probes)
    th = _t(theta).clone().requires_grad_(True)
    v = f(th)
    v.backward()
    assert v.dtype == th.grad.dtype == torch.float32
    return float(v.detach()), th.grad.numpy()


def _assert_vg(got, want):
    (v_t, g_t), (v_j, g_j) = got, want
    assert abs(v_t - v_j) <= RTOL * abs(v_j), (v_t, v_j)
    assert np.max(np.abs(g_t - g_j)) <= RTOL * np.max(np.abs(g_j)), (g_t,
                                                                      g_j)


@pytest.mark.parametrize("trend", ["constant", "linear"])
@pytest.mark.parametrize("corr", ["squared_exponential", "matern52"])
def test_likelihood_and_adjoint_f32_match_jax(corr, trend):
    """``reduced_likelihood`` and its analytic adjoint at a fixed theta,
    n=300, nugget 1e-3."""
    xn, yn, ys, theta = _lik_problem()
    _assert_vg(_torch_vg(corr, trend, xn, yn, ys, theta),
               _jax_vg(corr, trend, xn, yn, ys, theta))


def test_hutchinson_gradient_f32_with_jax_probes(monkeypatch):
    """The squared exponential's stochastic-trace gradient with egobox_tpu's
    64 float32 Rademacher probes handed in (tests/test_torch_likelihood.py
    shows the float64 pattern)."""
    p = 64
    xn, yn, ys, theta = _lik_problem(seed=4)
    with jax.enable_x64(False):
        z = np.asarray(jax.random.rademacher(
            jax.random.key(0xE60B0), (xn.shape[0], p), dtype=jnp.float32))
    monkeypatch.setattr(tlk, "_rademacher_probes",
                        lambda n, q, dtype, device: _t(z).to(dtype))
    _assert_vg(_torch_vg("squared_exponential", "constant", xn, yn, ys,
                         theta, probes=p),
               _jax_vg("squared_exponential", "constant", xn, yn, ys, theta,
                       probes=p))


# ---------------------------------------------------------------------------
# 3. gp.fit.fit_gp: bench.py's shipped recipe scaled down
# ---------------------------------------------------------------------------


def test_fit_recipe_f32_matches_jax():
    """bench.py:275-277's recipe at n=2 000 (the subsample 400): 3 draws,
    1 + 1 restarts x 4 iterations, one trust-region polish iteration with
    the 64-probe Hutchinson gradient, sqexp, nugget 1e-3, fit seed 5. No
    draws handed in: the port's subsample recipes draw egobox_tpu's
    threefry stream (``gp.fit._recipe_draws``) and its probes are
    egobox_tpu's (``gp.likelihood._rademacher_probes``), in float32 as
    egobox_tpu draws them with x64 off. The final likelihood within the
    dense tolerance; theta within 1e-2 relative (both in one basin)."""
    n, d = 2000, 4
    rng = np.random.default_rng(0)
    x = rng.uniform(-2.0, 2.0, (n, d)).astype(np.float32)
    y = (np.sum(np.sin(2.0 * x), axis=1)
         + 0.05 * rng.standard_normal(n)).astype(np.float32)
    kw = dict(n_start=1, max_iters=4, nugget=NUGGET, subsample_warmstart=400,
              sub_draws=3, polish_iters=1, polish_tr=True, grad_probes=64,
              seed=5)
    with jax.enable_x64(False):
        mj = jgp.fit_gp(_j(x), _j(y), **kw)
        lk_j, th_j = float(mj.likelihood), np.asarray(mj.theta)
    mt = tgp.fit_gp(_t(x), _t(y), **kw)
    assert mt.theta.dtype == torch.float32
    assert abs(float(mt.likelihood) - lk_j) <= RTOL * abs(lk_j)
    np.testing.assert_allclose(mt.theta.numpy(), th_j, rtol=1e-2)


# ---------------------------------------------------------------------------
# 1, 2, 4 at the card's sizes: tests/data/f32_reference.npz
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def f32_tool():
    return _load("make_f32_reference", ROOT / "tools" / "make_f32_reference.py")


@pytest.fixture(scope="module")
def f32_file(f32_tool):
    return np.load(f32_tool.OUT)


@pytest.fixture(scope="module", autouse=True)
def regenerated_outputs(tmp_path_factory):
    """egobox_tpu's outputs of (a), regenerated by the tool's own functions
    in a process of their own, started before this file's first test and
    read by ``test_reference_file_matches_egobox_tpu`` (its last), so that
    the regeneration runs beside the other tests."""
    out = tmp_path_factory.mktemp("f32_reference") / "outputs.npz"
    code = (
        "import sys, numpy as np, jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        f"sys.path.insert(0, {str(ROOT / 'tools')!r})\n"
        "import make_f32_reference as m\n"
        f"np.savez({str(out)!r}, **m.reference_outputs(m.reference_inputs()))\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    proc = subprocess.Popen([sys.executable, "-c", code], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def test_port_meets_the_reference_file(f32_file):
    """chip_smoke.py's f32 check (a) on the CPU: the 1024 x 1024 Matern 5/2
    Gram, the likelihood and adjoint at n = 2 000 (both kernels), predict
    and variance of egobox_tpu's float32 fit carried over by ``convert``
    (case 4), and the criteria, each within its stated tolerance. On the
    card the same function runs with K1 building the Matern Grams."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    out = chip_smoke.f32_reference_checks(torch, ck, f32_file, "cpu")
    assert out["k1_launches"] == 0  # CPU tensors: the plain versions
    assert out["log_ei_reference_nan_at_u"]  # egobox_tpu's NaN band


def test_k1_check_rebuilds_the_phases_shapes(f32_file):
    """chip_smoke.py's f32 K1 check on the CPU, where both of its sides are
    the plain version: it rebuilds (a)'s inputs at the two shapes (a)
    launches K1 at on the card (the 1024 x 1024 Gram, the likelihood's
    2 000 x 2 000), and raises on a shape it has no inputs for."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    shapes = [(1024, 1024), (2000, 2000)]
    assert chip_smoke.f32_k1_checks(torch, ck, f32_file, shapes,
                                    "cpu") == 0.0
    with pytest.raises(RuntimeError, match="no inputs"):
        chip_smoke.f32_k1_checks(torch, ck, f32_file, [(512, 2000)], "cpu")


# ---------------------------------------------------------------------------
# 6. gp.sgp
# ---------------------------------------------------------------------------


def _sgp_data(n, d, m, seed, griewank=False):
    rng = np.random.default_rng(seed)
    if griewank:  # bench.py's sparse data, x / 600
        x = rng.uniform(-600.0, 600.0, (n, d))
        y = (np.sum(x**2 / 4000.0, axis=1)
             - np.prod(np.cos(x / np.sqrt(np.arange(1, d + 1))), axis=1)
             + 1.0)[:, None]
        y = y + 0.05 * np.std(y) * rng.standard_normal((n, 1))
        x = x / 600.0
    else:
        x = rng.uniform(-1.0, 1.0, (n, d))
        y = (np.sum(np.sin(3.0 * x), axis=1, keepdims=True)
             + 0.05 * rng.standard_normal((n, 1)))
    x, y = x.astype(np.float32), y.astype(np.float32)
    return x, y, x[rng.permutation(n)[:m]]


SGP_LIKS = {"FITC": (jsgp.fitc_likelihood, tsgp.fitc_likelihood),
            "VFE": (jsgp.vfe_likelihood, tsgp.vfe_likelihood)}


@pytest.mark.parametrize("method", sorted(SGP_LIKS))
@pytest.mark.parametrize("corr", ["squared_exponential", "matern52"])
def test_sgp_likelihoods_f32_match_jax(corr, method):
    """``fitc_likelihood`` / ``vfe_likelihood`` wholly in float32 (points,
    sigma2 and noise: the port's algebra follows sigma2's type) with
    sigma2 = 1, where the port's nugget relative to sigma2 and egobox_tpu's
    absolute one coincide (egobox_tpu's default, 1000 eps32), at theta 1
    and 2, where egobox_tpu's float32 Cholesky succeeds."""
    n, d, m, noise, nugget = 300, 3, 24, 0.01, 1000 * EPS32
    x, y, z = _sgp_data(n, d, m, 7)
    jf, tf = SGP_LIKS[method]
    scale = n * (float(np.mean(y.astype(np.float64) ** 2)) + 1.0) / noise
    for th in (1.0, 2.0):
        theta = np.full(d, th, np.float32)
        with jax.enable_x64(False):
            want = float(jf(corr, _j(theta), jnp.float32(1.0),
                            jnp.float32(noise), _j(x), _j(y), _j(z), None,
                            nugget)[0])
        got = tf(corr, _t(theta), torch.tensor(1.0), torch.tensor(noise),
                 _t(x), _t(y), _t(z), None, nugget)[0]
        assert got.dtype == torch.float32
        kmm = tk.corr_cross(corr, _t(z).double(), _t(z).double(),
                            _t(theta).double()).numpy() + nugget * np.eye(m)
        ev = np.linalg.eigvalsh(kmm)
        tol = 4 * EPS32 * (ev[-1] / ev[0]) * scale
        assert abs(float(got) - want) <= tol, (th, float(got), want, tol)


def test_sgp_float32_cholesky_fails_at_small_theta_in_the_reference():
    """Queue 3's sparse item in one test. bench.py's sparse data shape
    (Griewank / 600, d=10) at n=1 000, M=256, sigma2 = var(y), theta 0.1:
    egobox_tpu wholly in float32 (its accelerator's type, its nugget
    1000 eps32 absolute) returns NaN for both kernels: the float32
    Cholesky of sigma2 K(Z, Z) + nugget I fails. The port's default for
    float32 points (float64 algebra, nugget 100 eps32 relative to sigma2)
    is finite there, within 1 % of egobox_tpu's own float64 value (the
    nuggets differ: 0.083 against 2.2e-13)."""
    n, d, m = 1000, 10, 256
    x, y, z = _sgp_data(n, d, m, 3, griewank=True)
    s2 = float(np.var(y.astype(np.float64)))
    theta = np.full(d, 0.1, np.float32)
    for corr in ("squared_exponential", "matern52"):
        with jax.enable_x64(False):
            ref32 = float(jsgp.fitc_likelihood(
                corr, _j(theta), jnp.float32(s2), jnp.float32(0.01 * s2),
                _j(x), _j(y), _j(z), None, 1000 * EPS32)[0])
        ref64 = float(jsgp.fitc_likelihood(
            corr, jnp.asarray(theta, jnp.float64), jnp.float64(s2),
            jnp.float64(0.01 * s2), jnp.asarray(x, jnp.float64),
            jnp.asarray(y, jnp.float64), jnp.asarray(z, jnp.float64), None,
            1000 * float(np.finfo(np.float64).eps))[0])
        port = float(tsgp.fitc_likelihood(
            corr, _t(theta), torch.tensor(s2, dtype=torch.float64),
            torch.tensor(0.01 * s2, dtype=torch.float64), _t(x),
            _t(y).double(), _t(z), None,
            tsgp._default_nugget(torch.float32))[0])
        assert np.isnan(ref32), (corr, ref32)
        assert np.isfinite(port) and abs(port - ref64) <= 0.01 * abs(ref64)


# ---------------------------------------------------------------------------
# the committed reference file against egobox_tpu, last: egobox_tpu's side
# is regenerated in the background from the file's first test on
# ---------------------------------------------------------------------------


def test_reference_file_matches_egobox_tpu(f32_tool, f32_file,
                                           regenerated_outputs):
    """The committed file (chip_smoke.py's f32 phase reads it on the card)
    still holds what egobox_tpu computes: (a) regenerated, inputs to the
    bit and egobox_tpu's outputs to a few ulps (another CPU may round its
    vectorized loops otherwise); (b), bench.py's threefry data, to its
    SHA-256 digests. Under 2 MB."""
    assert f32_tool.OUT.stat().st_size < 2 * 2**20
    inp = f32_tool.reference_inputs()
    for k, v in inp.items():
        assert f32_file[k].dtype == v.dtype and np.array_equal(f32_file[k],
                                                               v), k
    proc, path = regenerated_outputs
    _, err = proc.communicate(timeout=240)
    assert proc.returncode == 0, err
    out = dict(np.load(path))
    for k, v in out.items():
        np.testing.assert_allclose(f32_file[k], v, rtol=16 * EPS32,
                                   atol=16 * EPS32, err_msg=k)
    for k, want in BENCH_SHA256.items():
        a = f32_file[k]
        assert a.dtype == np.float32 and a.shape[0] == 10_000
        assert hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest() \
            == want, k
