"""The fused EGO iteration of egobox_torch against egobox_tpu's. float64,
``device="cpu"``; the JAX side runs on the CPU as its own tests run it.
(The pieces below it: the traceable picker in tests/test_torch_ego_host.py,
the L-BFGS form without host reads in tests/test_torch_lbfgsb.py, the
masked (output x lane) likelihood stack in tests/test_torch_likelihood.py.)

- ``fused_select_point`` / ``fused_select_points_q`` against egobox_tpu's on
  the same padded inputs and JAX's draws: x within 1e-5 of the box width,
  the criterion within rtol 1e-6 (multistart argmins on another library's
  rounding, as tests/test_torch_ego.py's one step);
- the port's fused path against its unfused path, and the gate.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egobox_tpu.doe.lhs import LhsKind as JLhsKind
from egobox_tpu.doe.lhs import lhs_normalized as jax_lhs_normalized
from egobox_tpu.doe.lhs import maximin_lhs as jax_maximin_lhs
from egobox_tpu.ego import fused_step as jfs
from egobox_torch.ego import EgorConfig, EgorSolver, GpConfig
from egobox_torch.ego import fused_step as tfs

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


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
# the fused iteration against egobox_tpu's
# ---------------------------------------------------------------------------

# xsinx fits its theta by MLE. The G24 outputs' likelihoods are flat over
# their theta lower bound (R nearly all ones on 12 points), where rounding
# sends egobox_tpu's own vmapped and one-output fits to different optima
# (theta 0.513 against 0.460 for the first constraint of this design); so
# the G24 case compares the rest of the iteration (posterior, scaling, the
# augmented-Lagrangian UTB infill) at fixed thetas.
FUSED = {
    "xsinx": dict(xl=np.array([[0.0, 25.0]]), fun=xsinx, n=8, n_cstr=0,
                  cstrat="MC", fixed=False, theta0s=np.full((1, 1), 0.1)),
    "g24-utb": dict(xl=np.array([[0.0, 3.0], [0.0, 4.0]]), fun=g24, n=12,
                    n_cstr=2, cstrat="UTB", fixed=True,
                    theta0s=np.array([[1.0, 1.0], [1.5, 1.0],
                                      [1.5, 1.0]])),
}


def _fused_inputs(case, nb=16, n_start=4, gp_n_start=2):
    c = FUSED[case]
    xl = c["xl"]
    nx = len(xl)
    rng = np.random.default_rng(5)
    x = rng.uniform(xl[:, 0], xl[:, 1], (c["n"], nx))
    y = c["fun"](x)
    m = y.shape[1]
    xp = np.zeros((nb, nx))
    xp[:c["n"]] = x
    yp = np.zeros((nb, m))
    yp[:c["n"]] = y
    mask = np.arange(nb) < c["n"]
    starts = rng.uniform(xl[:, 0], xl[:, 1], (n_start, nx))
    statics = dict(
        corr="squared_exponential", trend="constant", kpls_dim=None,
        gp_n_start=gp_n_start, gp_max_iters=50, fixed=c["fixed"],
        nugget=100.0 * 2.220446049250313e-16, crit="LogEI",
        cstr_strategy=c["cstrat"], n_cstr=c["n_cstr"], cstr_infill=False,
        feasibility=True, optimizer="COBYLA", ls_batch=8, fcstr_fns=(),
    )
    return dict(
        xp=xp, yp=yp, mask=mask, theta0s=c["theta0s"],
        theta_lo=np.full(nx, 1e-2), theta_up=np.full(nx, 1e1),
        starts=starts, lo=xl[:, 0].copy(), hi=xl[:, 1].copy(),
        fmin=np.float64(np.min(y[:, 0])),
        cstr_tols=np.full(c["n_cstr"], 1e-3), statics=statics,
        n_cloud=min(100 * nx, 1000), y=y)


def _jax_picker_draws(key, nb, n_start, nx):
    """The two draws egobox_tpu's traceable picker makes from its key."""
    ksub, kfill = jax.random.split(key)
    scores = jax.random.uniform(ksub, (nb,), dtype=jnp.float64)
    fill = jax_maximin_lhs(kfill, n_start, nx, False, 5, jnp.float64)
    return np.asarray(scores), np.asarray(fill)


def _jax_fit_seeds(key, n, dim):
    return np.asarray(jax_maximin_lhs(key, n, dim, False, 5, jnp.float64))


def _jax_cloud(key, n_cloud, lo, hi):
    u = np.asarray(jax_lhs_normalized(key, n_cloud, lo.shape[0],
                                      JLhsKind.MAXIMIN, jnp.float64))
    return lo[None, :] + u * (hi - lo)[None, :]


def _three_outputs():
    """20 points of [-1, 1]^2 padded to 24 rows, three outputs whose
    likelihoods have their optimum inside the theta bounds."""
    x = np.random.default_rng(21).uniform(-1.0, 1.0, (20, 2))
    ys = np.stack([np.sin(2.0 * x[:, 0]) + 0.5 * x[:, 1] ** 2,
                   x[:, 0] * x[:, 1] + np.cos(3.0 * x[:, 1]),
                   np.exp(0.5 * x[:, 0]) - np.sin(x[:, 1])], axis=1)
    xp, yp = np.zeros((24, 2)), np.zeros((24, 3))
    xp[:20], yp[:20] = x, ys
    return dict(xp=xp, yp=yp, mask=np.arange(24) < 20,
                theta0s=np.array([[0.1, 0.1], [0.5, 0.2], [1.0, 1.0]]),
                lo=np.full(2, 1e-2), up=np.full(2, 1e1))


_FIT3 = dict(corr="squared_exponential", n_start=3, max_iters=30,
             nugget=1e-8, ls_batch=8)


@functools.lru_cache(maxsize=1)
def _jax_three_outputs():
    from egobox_tpu.gp.fit import fit_gp_core as jax_fit_gp_core

    d = _three_outputs()
    key = jax.random.key(9)
    xp, mask = jnp.asarray(d["xp"]), jnp.asarray(d["mask"])
    lo, up = jnp.asarray(d["lo"]), jnp.asarray(d["up"])
    active = jnp.ones((2,), dtype=bool)

    def fit_one(y, theta0):
        return jax_fit_gp_core(xp, y[:, None], mask, theta0, lo, up, active,
                               key, **_FIT3)

    models = jax.jit(jax.vmap(fit_one))(jnp.asarray(d["yp"]).T,
                                        jnp.asarray(d["theta0s"]))
    seeds = _jax_fit_seeds(key, _FIT3["n_start"], 2)
    return (np.asarray(models.theta), np.asarray(models.likelihood),
            np.asarray(models.sigma2), seeds)


@pytest.mark.parametrize("chunks", ["one_stack", "lane_after_lane"])
@pytest.mark.parametrize("graph_safe", [False, True])
def test_fit_gp_outputs_matches_jax_vmapped_fit(monkeypatch, chunks,
                                                graph_safe):
    """Three outputs x (1 + 3) restarts on a masked design: the port's
    ``fit_gp_outputs`` (as one lockstep stack, and one restart at a time as
    above ``_LANES_MAX_POINTS`` points; with and without host reads)
    against ``jax.vmap`` of egobox_tpu's ``fit_gp_core`` with its seeds:
    theta rtol 1e-6, likelihood rtol 1e-8, sigma^2 rtol 1e-6. Every fitted
    theta lies inside its bounds, so the likelihood is not flat there."""
    from egobox_torch.gp import fit as tfit

    theta_j, rlf_j, sigma2_j, seeds = _jax_three_outputs()
    d = _three_outputs()
    if chunks == "lane_after_lane":
        monkeypatch.setattr(tfit, "_LANES_MAX_POINTS", 0)
    models = tfit.fit_gp_outputs(
        _t(d["xp"]), _t(d["yp"]), _t(d["mask"]), _t(d["theta0s"]),
        _t(d["lo"]), _t(d["up"]), torch.ones(2, dtype=torch.bool),
        _t(seeds), graph_safe=graph_safe, **_FIT3)
    assert np.all((theta_j > 1.05e-2) & (theta_j < 9.5))
    np.testing.assert_allclose(models.theta.numpy(), theta_j, rtol=1e-6)
    np.testing.assert_allclose(models.likelihood.numpy(), rlf_j, rtol=1e-8)
    np.testing.assert_allclose(models.sigma2.numpy(), sigma2_j, rtol=1e-6)


@pytest.mark.parametrize("case", sorted(FUSED))
def test_fused_select_point_matches_jax(case):
    inp = _fused_inputs(case)
    st = inp["statics"]
    fit_key, cloud_key = jax.random.key(11), jax.random.key(12)
    arrays = ("xp", "yp", "mask", "theta0s", "theta_lo", "theta_up")
    packed_j, models_j = jfs.fused_select_point(
        *(jnp.asarray(inp[k]) for k in arrays), fit_key, cloud_key,
        jnp.asarray(inp["starts"]), jnp.asarray(inp["lo"]),
        jnp.asarray(inp["hi"]), jnp.asarray(inp["fmin"]),
        jnp.asarray(inp["cstr_tols"]), n_cloud=inp["n_cloud"], **st)
    nx = inp["lo"].shape[0]
    seeds = _jax_fit_seeds(fit_key, st["gp_n_start"], nx)
    cloud = _jax_cloud(cloud_key, inp["n_cloud"], inp["lo"], inp["hi"])
    packed, models = tfs.fused_select_point(
        *(_t(inp[k]) for k in arrays), _t(seeds), _t(cloud),
        _t(inp["starts"]), _t(inp["lo"]), _t(inp["hi"]), _t(inp["fmin"]),
        _t(inp["cstr_tols"]), graph_safe=False, **st)
    packed_j = np.asarray(packed_j)
    width = inp["hi"] - inp["lo"]
    assert np.all(np.abs(packed[:nx].numpy() - packed_j[:nx]) <= 1e-5 * width)
    np.testing.assert_allclose(float(packed[nx]), packed_j[nx], rtol=1e-6)
    np.testing.assert_allclose(models.theta.numpy(),
                               np.asarray(models_j.theta), rtol=1e-6)
    np.testing.assert_allclose(models.likelihood.numpy(),
                               np.asarray(models_j.likelihood), rtol=1e-8)
    # the same program without host reads gives the same values
    packed_gs, _ = tfs.fused_select_point(
        *(_t(inp[k]) for k in arrays), _t(seeds), _t(cloud),
        _t(inp["starts"]), _t(inp["lo"]), _t(inp["hi"]), _t(inp["fmin"]),
        _t(inp["cstr_tols"]), graph_safe=True, **st)
    np.testing.assert_allclose(packed_gs.numpy(), packed.numpy(), rtol=1e-12)


@pytest.mark.parametrize("qei", ["KB", "CLMIN"])
def test_fused_select_points_q_matches_jax(qei):
    """q = 3 on G24 (fixed thetas, see FUSED): step j's fit seeds and cloud
    from JAX's keys folded with j, its picker draws from the folded seeds
    key; the virtual rows within rtol 1e-5."""
    q = 3
    inp = _fused_inputs("g24-utb")
    st = inp["statics"]
    nx, m = 2, 3
    fit_key, cloud_key, seeds_key = (jax.random.key(k) for k in (21, 22, 23))
    arrays = ("xp", "yp", "mask", "theta0s", "theta_lo", "theta_up")
    i_min = int(np.argmin(inp["y"][:, 0]))
    y_best = inp["y"][i_min]
    packed_j, theta_j = jfs.fused_select_points_q(
        *(jnp.asarray(inp[k]) for k in arrays), fit_key, cloud_key,
        jnp.asarray(inp["starts"]), seeds_key, jnp.asarray(inp["lo"]),
        jnp.asarray(inp["hi"]), jnp.asarray(inp["fmin"]),
        jnp.asarray(inp["cstr_tols"]), jnp.asarray(y_best),
        q_points=q, qei=qei, n_cloud=inp["n_cloud"], **st)
    nbuf = inp["xp"].shape[0] + q - 1
    k = inp["starts"].shape[0]
    seeds = np.stack([_jax_fit_seeds(jax.random.fold_in(fit_key, j),
                                     st["gp_n_start"], nx) for j in range(q)])
    clouds = np.stack([_jax_cloud(jax.random.fold_in(cloud_key, j),
                                  inp["n_cloud"], inp["lo"], inp["hi"])
                       for j in range(q)])
    picks = [_jax_picker_draws(jax.random.fold_in(seeds_key, j), nbuf, k, nx)
             for j in range(q)]
    packed, theta = tfs.fused_select_points_q(
        *(_t(inp[k2]) for k2 in arrays), _t(seeds), _t(clouds),
        _t(inp["starts"]), _t(np.stack([p[0] for p in picks])),
        _t(np.stack([p[1] for p in picks])), _t(inp["lo"]), _t(inp["hi"]),
        _t(inp["fmin"]), _t(inp["cstr_tols"]), _t(y_best), q_points=q,
        qei=qei, graph_safe=False, **st)
    packed_j = np.asarray(packed_j)
    assert packed.shape == packed_j.shape == (q, nx + 1 + m)
    width = inp["hi"] - inp["lo"]
    assert np.all(np.abs(packed[:, :nx].numpy() - packed_j[:, :nx])
                  <= 1e-5 * width)
    # the criterion at points that agree to 1e-5 of the box: rtol 1e-5
    np.testing.assert_allclose(packed[:, nx].numpy(), packed_j[:, nx],
                               rtol=1e-5)
    np.testing.assert_allclose(packed[:, nx + 1:].numpy(),
                               packed_j[:, nx + 1:], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(theta.numpy(), np.asarray(theta_j), rtol=1e-5)


# ---------------------------------------------------------------------------
# the port's fused path against its unfused path, and the gate
# ---------------------------------------------------------------------------


def _one_step(monkeypatch, fused, n_cstr):
    if fused:
        monkeypatch.delenv("EGOBOX_NO_FUSED_STEP", raising=False)
    else:
        monkeypatch.setenv("EGOBOX_NO_FUSED_STEP", "1")
    cfg = EgorConfig(seed=7, n_cstr=n_cstr, n_start=4,
                     gp_config=GpConfig(n_start=2, max_eval=10))
    if n_cstr:
        xl, fobj = np.array([[0.0, 3.0], [0.0, 4.0]]), g24
    else:
        xl, fobj = np.array([[0.0, 25.0]]), xsinx
    solver = EgorSolver(cfg, xl, device="cpu")
    state = solver.init_state(fobj)
    x_dat, _, infill = solver.select_next_points(state)
    return x_dat, infill, solver


@pytest.mark.parametrize("n_cstr", [0, 2])
def test_fused_matches_unfused(monkeypatch, n_cstr):
    """The counterpart of tests/test_fused_step.py::test_fused_matches_
    unfused_{unconstrained,constrained}: both paths take the same draws in
    the same order; the fused one fits a padded, masked design."""
    x_f, v_f, s_f = _one_step(monkeypatch, True, n_cstr)
    x_u, v_u, s_u = _one_step(monkeypatch, False, n_cstr)
    assert s_f.last_times["graph"] == "eager" and "fit" in s_u.last_times
    assert s_f.last_models.mask.shape[1] % s_f.config.shape_bucket == 0
    np.testing.assert_allclose(x_f, x_u, atol=1e-6 if not n_cstr else 1e-5)
    if not n_cstr:
        np.testing.assert_allclose(v_f, v_u, rtol=1e-5, atol=1e-8)


def test_fast_path_gating(monkeypatch):
    """The counterpart of tests/test_fused_step.py::test_fast_path_gating:
    MoE, CoEGO and the portfolio keep the general path; torch-written
    function constraints and q_points > 1 take the fused one."""
    xl = np.array([[0.0, 25.0]])
    s = EgorSolver(EgorConfig(seed=1), xl, device="cpu")
    assert s._fast_path_ok(())
    assert s._fast_path_ok((lambda x: x[0] - 18.0,))
    assert not s._fast_path_ok((lambda x: float(np.asarray(x)[0]),))
    s2 = EgorSolver(EgorConfig(seed=1, q_points=2), xl, device="cpu")
    assert s2._fast_path_ok(())
    monkeypatch.setenv("EGOR_USE_GP_RECORDER", "1")
    assert not s2._fast_path_ok(())
    monkeypatch.delenv("EGOR_USE_GP_RECORDER")
    s3 = EgorSolver(EgorConfig(seed=1, gp_config=GpConfig(n_clusters=0)), xl,
                    device="cpu")
    assert not s3._fast_path_ok(())
    s4 = EgorSolver(EgorConfig(seed=1, coego_n_coop=4), xl, device="cpu")
    assert not s4._fast_path_ok(())
    monkeypatch.setenv("EGOR_USE_GP_VAR_PORTFOLIO", "1")
    assert not s._fast_path_ok(())
    monkeypatch.delenv("EGOR_USE_GP_VAR_PORTFOLIO")
    monkeypatch.setenv("EGOBOX_NO_FUSED_STEP", "1")
    assert not s._fast_path_ok(())


def test_q_points_fused_step_through_the_solver(monkeypatch):
    """q_points = 3 through the solver's fused path: three points in the
    box, one virtual output row each, the last step's thetas kept on the
    device as the next warm start."""
    monkeypatch.delenv("EGOBOX_NO_FUSED_STEP", raising=False)
    xl = np.array([[0.0, 3.0], [0.0, 4.0]])
    s = EgorSolver(EgorConfig(seed=2, n_cstr=2, n_start=4, q_points=3,
                              gp_config=GpConfig(n_start=2, max_eval=10)),
                   xl, device="cpu")
    state = s.init_state(g24)
    x, y, _ = s.select_next_points(state)
    assert x.shape == (3, 2) and y.shape == (3, 3)
    assert np.all((x >= xl[:, 0]) & (x <= xl[:, 1]))
    assert np.all(np.isfinite(y))
    assert isinstance(state.theta_inits, torch.Tensor)
