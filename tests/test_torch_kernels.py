"""egobox_torch kernels, trends, KPLS and LHS against egobox_tpu, and the
K1 Gram tile kernel's plain version against the Pallas kernel run by the
Pallas interpreter.

Inputs are made with numpy and handed to both packages; float64 unless
stated. The CUDA kernel itself is tested on a GPU by test_torch_cuda.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from egobox_tpu.gp import kernels as jk
from egobox_tpu.gp import kpls as jkpls
from egobox_tpu.gp import likelihood as jlk
from egobox_tpu.gp import trends as jtr
from egobox_tpu.doe import utils as jdu
from egobox_tpu.ops import pallas_corr as pc
from egobox_torch.doe import lhs as tlhs
from egobox_torch.doe import utils as tdu
from egobox_torch.gp import kernels as tk
from egobox_torch.gp import kpls as tkpls
from egobox_torch.gp import trends as ttr
from egobox_torch.ops import corr_kernel as ck

torch.set_num_threads(2)

KERNELS = ["squared_exponential", "absolute_exponential", "matern32",
           "matern52"]
L1_KERNELS = ["absolute_exponential", "matern32", "matern52"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(kpls, seed=0, n1=23, n2=17, nx=3):
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(-1.5, 1.5, (n1, nx))
    x2 = rng.uniform(-1.5, 1.5, (n2, nx))
    if kpls:
        w = rng.standard_normal((nx, 2))
        theta = rng.uniform(0.2, 1.5, 2)
    else:
        w = None
        theta = rng.uniform(0.2, 1.5, nx)
    return x1, x2, theta, w


@pytest.mark.parametrize("kpls", [False, True])
@pytest.mark.parametrize("name", KERNELS)
def test_corr_functions_match_jax(name, kpls):
    x1, x2, theta, w = _inputs(kpls)
    tw = None if w is None else _t(w)
    jw = None if w is None else jnp.asarray(w)
    d = x1[:, None, :] - x2[None, :, :]
    np.testing.assert_allclose(
        tk.corr_value(name, _t(d), _t(theta), tw).numpy(),
        np.asarray(jk.corr_value(name, jnp.asarray(d), jnp.asarray(theta),
                                 jw)),
        rtol=0, atol=1e-12,
    )
    for t_fn, j_fn in ((tk.corr_cross, jk.corr_cross),
                       (tk.log_corr_cross, jk.log_corr_cross)):
        np.testing.assert_allclose(
            t_fn(name, _t(x1), _t(x2), _t(theta), tw).numpy(),
            np.asarray(j_fn(name, jnp.asarray(x1), jnp.asarray(x2),
                            jnp.asarray(theta), jw)),
            rtol=0, atol=1e-12,
        )


@pytest.mark.parametrize("name", KERNELS)
def test_blocked_gram_matches_jax(name, monkeypatch):
    """Above the dense budget both packages stream row blocks."""
    monkeypatch.setattr(tk, "_DENSE_BUDGET", 500)
    x1, x2, theta, _ = _inputs(False, seed=1, n1=70, n2=40, nx=4)
    got = tk.corr_cross(name, _t(x1), _t(x2), _t(theta))
    ref = jk.corr_cross(name, jnp.asarray(x1), jnp.asarray(x2),
                        jnp.asarray(theta))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12)


def test_corr_gram_and_theta_bounds_match_jax():
    x1, _, theta, _ = _inputs(False, seed=2)
    got = tk.corr_gram("matern32", _t(x1), _t(theta), nugget=1e-6)
    ref = jk.corr_gram("matern32", jnp.asarray(x1), jnp.asarray(theta),
                       nugget=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-12)
    for names, nx in (("matern52", 3), (KERNELS, 10), ("matern32", 14)):
        np.testing.assert_allclose(tk.theta_bounds_heuristic(names, nx),
                                   jk.theta_bounds_heuristic(names, nx),
                                   rtol=1e-15)


@pytest.mark.parametrize("trend", ["constant", "linear", "quadratic"])
def test_trend_basis_matches_jax(trend):
    x = np.random.default_rng(3).standard_normal((9, 3))
    got = ttr.trend_basis(trend, _t(x))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jtr.trend_basis(trend,
                                                          jnp.asarray(x))),
                               atol=1e-15)
    assert got.shape[1] == ttr.n_basis(trend, 3) == jtr.n_basis(trend, 3)


@pytest.mark.parametrize("n_comp", [1, 2, 3])
def test_pls_rotations_match_jax(n_comp):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((40, 5))
    y = (x @ rng.standard_normal(5) + 0.1 * rng.standard_normal(40))[:, None]
    got = tkpls.pls_rotations(_t(x), _t(y), n_comp)
    ref = jkpls.pls_rotations(jnp.asarray(x), jnp.asarray(y), n_comp)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-10)


def test_pls_rotations_constant_output_gives_zero_weights():
    x = np.random.default_rng(5).standard_normal((20, 3))
    y = np.ones((20, 1))
    got = tkpls.pls_rotations(_t(x), _t(y), 2)
    ref = jkpls.pls_rotations(jnp.asarray(x), jnp.asarray(y), 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert not got.any()


def test_distance_helpers_match_jax():
    a = np.random.default_rng(6).standard_normal((12, 4))
    b = np.random.default_rng(7).standard_normal((5, 4))
    np.testing.assert_allclose(tdu.cdist(_t(a), _t(b)).numpy(),
                               np.asarray(jdu.cdist(jnp.asarray(a),
                                                    jnp.asarray(b))),
                               atol=1e-12)
    np.testing.assert_allclose(tdu.pdist(_t(a)).numpy(),
                               np.asarray(jdu.pdist(jnp.asarray(a))),
                               atol=1e-12)
    np.testing.assert_allclose(float(tdu.min_pdist_sq(_t(a))),
                               float(jdu.min_pdist_sq(jnp.asarray(a))),
                               rtol=1e-12)


@pytest.mark.parametrize("centered", [False, True])
def test_lhs_latin_structure(centered):
    """Each column holds exactly one point per stratum; the maximin design
    is the best of its draws (torch's stream differs from JAX's, so the
    property is checked, not the values)."""
    ns, nx = 16, 3
    build = tlhs.centered_lhs if centered else tlhs.classic_lhs
    x = build(ns, nx, torch.Generator().manual_seed(0), device="cpu")
    assert x.dtype == torch.float64 and x.shape == (ns, nx)
    for k in range(nx):
        strata = torch.sort(torch.floor(x[:, k] * ns)).values
        assert torch.equal(strata, torch.arange(ns, dtype=x.dtype))
    best = tlhs.maximin_lhs(ns, nx, torch.Generator().manual_seed(1),
                            centered, n_draws=4, device="cpu")
    gen = torch.Generator().manual_seed(1)
    draws = [build(ns, nx, gen, device="cpu") for _ in range(4)]
    assert float(tdu.min_pdist_sq(best)) == max(
        float(tdu.min_pdist_sq(d)) for d in draws)
    lim = torch.tensor([[-1.0, 1.0], [0.0, 10.0], [5.0, 6.0]],
                       dtype=torch.float64)
    scaled = tlhs.scale_to_xlimits(best, lim)
    assert bool(torch.all(scaled >= lim[:, 0]) & torch.all(scaled <= lim[:, 1]))


@pytest.fixture
def _interpret_pallas(monkeypatch):
    monkeypatch.setattr(
        pc.pl, "pallas_call",
        functools.partial(pl.pallas_call, interpret=True),
    )


@pytest.mark.usefixtures("_interpret_pallas")
@pytest.mark.parametrize(
    "name,n1,n2,d",
    [(k, 300, 200, 4) for k in L1_KERNELS] + [("matern52", 37, 41, 3)],
)
def test_corr_cross_plain_matches_pallas_interpret(name, n1, n2, d):
    """K1's plain version against the Pallas kernel, float32, atol 2e-6
    (the Pallas kernel's own parity target, tests/test_pallas.py)."""
    rng = np.random.default_rng(n1 + d)
    x1 = rng.uniform(0.0, 1.0, (n1, d)).astype(np.float32)
    x2 = rng.uniform(0.0, 1.0, (n2, d)).astype(np.float32)
    theta = rng.uniform(0.3, 1.2, d).astype(np.float32)
    got = ck.corr_cross_plain(name, _t(x1), _t(x2), _t(theta))
    ref = pc.corr_cross_pallas(name, jnp.asarray(x1), jnp.asarray(x2),
                               jnp.asarray(theta))
    assert got.dtype == torch.float32 and got.shape == (n1, n2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-6)


@pytest.mark.usefixtures("_interpret_pallas")
@pytest.mark.parametrize("name", L1_KERNELS)
def test_corr_cross_plain_large_theta_matches_pallas_interpret(name):
    """theta = 50, d = 64: r underflows to 0 except between near
    neighbours. The plain version and the Pallas kernel agree at 2e-6 with
    no NaN; the CUDA kernel is held to the plain version on these inputs
    (tests/test_torch_cuda.py)."""
    rng = np.random.default_rng(12)
    x1 = rng.standard_normal((60, 64))
    x2 = np.concatenate([x1[:20] + 1e-4 * rng.standard_normal((20, 64)),
                         x1[20:30], 5.0 * rng.standard_normal((11, 64))])
    x1, x2 = x1.astype(np.float32), x2.astype(np.float32)
    theta = np.full(64, 50.0, np.float32)
    got = ck.corr_cross_plain(name, _t(x1), _t(x2), _t(theta)).numpy()
    ref = np.asarray(pc.corr_cross_pallas(name, jnp.asarray(x1),
                                          jnp.asarray(x2),
                                          jnp.asarray(theta)))
    assert np.isfinite(got).all() and np.isfinite(ref).all()
    assert (got == 0).sum() > got.size // 2 and got.max() > 0.1
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)


@pytest.mark.parametrize("name", KERNELS)
def test_corr_cross_plain_row_sums_match_jax_build_r(name):
    """The plain version's optional row sums: their maximum is the
    Gershgorin row sum that egobox_tpu's _build_r scales the nugget by
    (float64, rtol 1e-12), and the wrapper hands them through on the CPU."""
    x, _, theta, _ = _inputs(False, seed=11, n1=45, nx=4)
    r, sums = ck.corr_cross_plain(name, _t(x), _t(x), _t(theta),
                                  row_sums=True)
    np.testing.assert_allclose(sums.numpy(), np.abs(r.numpy()).sum(1),
                               rtol=1e-14)
    assert bool((r.diagonal() == 1.0).all())
    nugget = 1e-3
    r_jax = np.asarray(jlk._build_r(name, jnp.asarray(x), jnp.asarray(theta),
                                    None, nugget, None))
    row_max_jax = (r_jax[0, 0] - 1.0) / nugget
    np.testing.assert_allclose(max(float(sums.max()), 1.0), row_max_jax,
                               rtol=1e-12)
    r2, sums2 = ck.corr_cross_tile(name, _t(x), _t(x), _t(theta),
                                   row_sums=True)
    assert torch.equal(r, r2) and torch.equal(sums, sums2)


def test_tile_wrapper_takes_plain_version_on_cpu(monkeypatch):
    """On CPU tensors the wrapper is the plain version and counts no
    launch; corr_cross never routes a CPU Gram to the kernel."""
    monkeypatch.setattr(ck, "launches", 0)
    rng = np.random.default_rng(8)
    x1 = _t(rng.standard_normal((50, 3)).astype(np.float32))
    x2 = _t(rng.standard_normal((30, 3)).astype(np.float32))
    th = _t(np.full(3, 0.7, np.float32))
    got = ck.corr_cross_tile("matern32", x1, x2, th)
    torch.testing.assert_close(got, ck.corr_cross_plain("matern32", x1, x2,
                                                        th), rtol=0, atol=0)
    monkeypatch.setattr(tk, "_DENSE_BUDGET", 10)
    tk.corr_cross("matern52", x1, x2, th)
    assert ck.launches == 0


@pytest.mark.parametrize(
    "args,exc",
    [
        (("rbf", (4, 3), (5, 3), (3,)), ValueError),
        (("matern52", (4, 3), (5, 2), (3,)), ValueError),
        (("matern52", (4, 3), (5, 3), (2,)), ValueError),
    ],
)
def test_tile_wrapper_rejects_bad_input(args, exc):
    name, s1, s2, st = args
    with pytest.raises(exc):
        ck.corr_cross_tile(name, torch.zeros(s1), torch.zeros(s2),
                           torch.ones(st))
