"""The host-side modules of egobox_torch's Egor loop against egobox_tpu's on
random inputs (exact), the traceable picker of the fused programs with
JAX's draws (atol 1e-12), and what the port left out: the clustered
surrogates, CoEGO, the portfolio and the host-callback constraints, which
raised until they were ported, run in test_torch_moe_egor.py,
test_torch_coego.py and test_torch_native.py; EgorBatch(mesh=), ported
since, runs in test_torch_parallel.py and here refuses a mesh that is not
an egobox_torch.parallel Mesh.
``device="cpu"``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import egobox_tpu as jegx
from egobox_tpu.doe.lhs import maximin_lhs as jax_maximin_lhs
from egobox_tpu.ego import config as jcfg
from egobox_tpu.ego import find_result as jfind
from egobox_tpu.ego import mixint as jmix
from egobox_tpu.ego import start_points as jstart
from egobox_tpu.ego import state as jstate
import egobox_torch as egx
from egobox_torch.ego import Egor, EgorBatch, EgorConfig, EgorState
from egobox_torch.ego import find_result as tfind
from egobox_torch.ego import mixint as tmix
from egobox_torch.ego import start_points as tstart

torch.set_num_threads(2)


def xsinx(x):
    x = np.atleast_2d(x)
    return ((x - 3.5) * np.sin((x - 3.5) / np.pi)).reshape(-1, 1)


# ---------------------------------------------------------------------------
# what raises in this slice, each naming its ROADMAP item
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("build,item", [
    (lambda: EgorBatch([xsinx, xsinx], np.array([[0.0, 25.0]]),
                       device="cpu", mesh=object()), "parallel"),
])
def test_not_ported_paths_raise_with_their_roadmap_item(build, item):
    # the parallel path is ported since (tests/test_torch_parallel.py):
    # a mesh that is not an egobox_torch.parallel Mesh is refused
    with pytest.raises(TypeError, match=f"egobox_torch.{item} Mesh"):
        build()


def test_warm_refit_n_start_zero_is_refused():
    """egobox_tpu accepts 0 and then refits with no LHS lane at all; the
    port refuses the value."""
    with pytest.raises(ValueError, match="warm_refit_n_start"):
        Egor([[0.0, 25.0]], warm_refit_n_start=0, device="cpu")
    solver = Egor([[0.0, 25.0]], warm_refit_n_start=None,
                  device="cpu").solver
    state = solver.init_state(xsinx)
    state.iter = 3
    assert solver._gp_n_start(state) == 10
    solver.config.warm_refit_n_start = 4
    assert solver._gp_n_start(state) == 4
    state.iter = 0
    assert solver._gp_n_start(state) == 10


# ---------------------------------------------------------------------------
# host-side modules against egobox_tpu's, exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_find_result_matches_jax(seed):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(30, 3))
    c = rng.normal(size=(30, 2))
    tol = np.array([1e-3, 0.1, 1e-3, 0.2])
    assert tfind.find_best_result_index(y, c, tol) == \
        jfind.find_best_result_index(y, c, tol)
    assert tfind.find_best_result_index_from(4, 20, y, c, tol) == \
        jfind.find_best_result_index_from(4, 20, y, c, tol)
    for i in range(5):
        assert tfind.is_feasible(y[i], c[i], tol) == \
            jfind.is_feasible(y[i], c[i], tol)


@pytest.mark.parametrize("seed", range(3))
def test_start_points_match_jax(seed):
    rng = np.random.default_rng(seed)
    xl = np.array([[0.0, 3.0], [-1.0, 4.0], [2.0, 2.5]])
    x = rng.uniform(xl[:, 0], xl[:, 1], (25, 3))
    np.testing.assert_array_equal(
        tstart.start_points(x, xl[:, 0], xl[:, 1], n_max=7),
        jstart.start_points(x, xl[:, 0], xl[:, 1], n_max=7))

    def fill(n):
        return np.full((n, 3), 0.5)

    a = tstart.middle_picker_starts(np.random.default_rng(9), x, xl, 12, fill)
    b = jstart.middle_picker_starts(np.random.default_rng(9), x, xl, 12, fill)
    np.testing.assert_array_equal(a, b)


def test_mixint_matches_jax():
    rng = np.random.default_rng(3)
    spec_args = [("FLOAT", [0.0, 2.0]), ("INT", [1.0, 6.0]),
                 ("ORD", [1.0, 3.0, 7.0]), ("ENUM", [3])]
    tspecs = [egx.XSpec(getattr(egx.XType, k), v) for k, v in spec_args]
    jspecs = [jegx.XSpec(getattr(jegx.XType, k), v) for k, v in spec_args]
    tc, jc = tmix.MixintContext(tspecs), jmix.MixintContext(jspecs)
    np.testing.assert_array_equal(tc.continuous_xlimits(),
                                  jc.continuous_xlimits())
    xl = tc.continuous_xlimits()
    x = rng.uniform(xl[:, 0], xl[:, 1], (20, xl.shape[0]))
    np.testing.assert_array_equal(tc.cast_continuous(x),
                                  jc.cast_continuous(x))
    np.testing.assert_array_equal(tc.to_discrete_space(x),
                                  jc.to_discrete_space(x))
    xd = tc.to_discrete_space(x)
    np.testing.assert_array_equal(tc.to_continuous_space(xd),
                                  jc.to_continuous_space(xd))
    assert tc.is_discrete and jc.is_discrete
    assert [s.xtype.value for s in tmix.parse_xspecs([[0.0, 1.0]])] == \
        [s.xtype.value for s in jmix.parse_xspecs([[0.0, 1.0]])]


def test_state_round_trip_matches_jax():
    rng = np.random.default_rng(4)
    kw = dict(x_data=rng.normal(size=(6, 2)), y_data=rng.normal(size=(6, 3)),
              c_data=np.zeros((6, 0)), cstr_tol=np.array([1e-3, 1e-3]),
              best_index=2, prev_best_index=1, feasibility=True,
              theta_inits=rng.uniform(0.1, 1.0, (3, 2)), added=6,
              prev_added=5, iter=3, sigma=0.05, in_local_phase=True,
              local_steps_left=2, prev_best_y=-1.5)
    ts = EgorState(rng=np.random.default_rng(8), **kw)
    js = jstate.EgorState(rng=np.random.default_rng(8), **kw)
    pt, pj = ts.to_dict(), js.to_dict()
    assert pt == pj
    back = EgorState.from_dict(json.loads(json.dumps(pj)))
    for k in ("x_data", "y_data", "cstr_tol", "theta_inits"):
        np.testing.assert_array_equal(getattr(back, k), kw[k])
    assert back.c_data.shape == (6, 0)
    assert (back.iter, back.best_index, back.sigma) == (3, 2, 0.05)
    assert back.rng.integers(0, 2**31) == ts.rng.integers(0, 2**31)
    bx, by, bc = back.best()
    np.testing.assert_array_equal(bx, kw["x_data"][2])


def test_config_defaults_match_jax():
    # both read the pad quantum from EGOBOX_SHAPE_BUCKET (the test
    # configuration sets it)
    tc, jc = EgorConfig(), jcfg.EgorConfig()
    for f in ("n_start", "n_doe", "n_cstr", "q_points", "q_optmod",
              "warm_refit_n_start", "coego_n_coop", "shape_bucket",
              "target", "cstr_infill"):
        assert getattr(tc, f) == getattr(jc, f), f
    np.testing.assert_array_equal(tc.resolved_cstr_tol(2),
                                  jc.resolved_cstr_tol(2))
    assert tc.trego == EgorConfig().trego
    assert (tc.trego.n_local_steps, tc.trego.beta, tc.trego.gamma,
            tc.trego.sigma0, tc.trego.d) == (
        jc.trego.n_local_steps, jc.trego.beta, jc.trego.gamma,
        jc.trego.sigma0, jc.trego.d)
    with pytest.raises(ValueError, match="q_points"):
        EgorConfig(q_points=0).check()
    with pytest.raises(ValueError, match="entries"):
        EgorConfig(n_cstr=2, cstr_tol=np.array([1.0])).resolved_cstr_tol()


# ---------------------------------------------------------------------------
# the traceable picker
# ---------------------------------------------------------------------------


def _jax_picker_draws(key, nb, n_start, nx):
    """The two draws egobox_tpu's picker makes from its key."""
    ksub, kfill = jax.random.split(key)
    scores = jax.random.uniform(ksub, (nb,), dtype=jnp.float64)
    fill = jax_maximin_lhs(kfill, n_start, nx, False, 5, jnp.float64)
    return np.asarray(scores), np.asarray(fill)


# (n_active, n_pad, nx, n_start, n_sub_max, lo, hi, key): two cases of
# tests/test_start_points_traced.py (the forced two-point subset among
# them), a box with a zero-width side, and a design small enough that the
# fill completes every row
PICKER_CASES = [
    (37, 11, 3, 6, 8, 0.0, 1.0, 1),
    (12, 4, 2, 3, 2, 0.0, 1.0, 5),
    (25, 7, 3, 5, 4, [0.0, 0.5, 0.2], [2.0, 0.5, 1.0], 9),
    (3, 5, 2, 6, 3, 0.0, 1.0, 4),
]


@pytest.mark.parametrize("case", range(len(PICKER_CASES)))
def test_traced_picker_matches_jax(case):
    n_act, n_pad, nx, n_start, n_sub, lo, hi, seed = PICKER_CASES[case]
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (n_act, nx))
    xp = np.concatenate([x, np.zeros((n_pad, nx))])
    mask = np.arange(n_act + n_pad) < n_act
    lo = np.broadcast_to(np.asarray(lo, float), (nx,)).copy()
    hi = np.broadcast_to(np.asarray(hi, float), (nx,)).copy()
    key = jax.random.key(seed)
    want = np.asarray(jstart.middle_picker_starts_traced(
        key, jnp.asarray(xp), jnp.asarray(mask), jnp.asarray(lo),
        jnp.asarray(hi), n_start, n_sub))
    scores, fill = _jax_picker_draws(key, n_act + n_pad, n_start, nx)
    got = tstart.middle_picker_starts_traced(
        torch.from_numpy(xp), torch.from_numpy(mask), torch.from_numpy(lo),
        torch.from_numpy(hi), n_start, n_sub, torch.from_numpy(scores.copy()),
        torch.from_numpy(fill.copy())).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
