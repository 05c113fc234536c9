"""Egor on clustered surrogates in egobox_torch: the solver's mixture
training against egobox_tpu's (JAX's clustering and fit draws handed in),
the state's clusterings and their checkpoints, the q_optmod reuse, the
fused clustered iteration against the host surrogates and lane by lane,
and whole runs (ports of tests/test_moe_state.py and
tests/test_fused_moe.py). float64, ``device="cpu"``.

Tolerances: theta rtol 1e-5 and likelihood rtol 1e-8 against egobox_tpu
(tests/test_torch_fit.py's); within the port, the fused program against
lane-by-lane fits theta rtol 1e-5 (egobox_tpu's own test's; the stack
gives every lane its own copy of the design, which sums in another order
on the near-singular Grams of a 1-d sqexp fit), and against the host
mixture at fixed thetas rtol 1e-6 (egobox_tpu's test takes 1e-4); the runs'
gates those of tests/test_fused_moe.py.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egobox_tpu.doe.lhs import maximin_lhs as jax_maximin_lhs
from egobox_tpu.ego.config import EgorConfig as JEgorConfig
from egobox_tpu.ego.config import GpConfig as JGpConfig
from egobox_tpu.ego.solver import EgorSolver as JEgorSolver
from egobox_torch import Egor, EgorBatch
from egobox_torch.convert import egor_state_from_dict, gmx_from_numpy
from egobox_torch.ego.config import EgorConfig, GpConfig
from egobox_torch.ego.fused_step import fused_select_point_moe
from egobox_torch.ego.solver import EgorSolver
from egobox_torch.ego.state import EgorState
from egobox_torch.gp import fit as tfit
from egobox_torch.gp.fit import FitDraws, fit_gp_core
from egobox_torch.moe import gmm as tgmm
from egobox_torch.moe import moe as tmoe
from egobox_torch.moe.gaussian_mixture import GaussianMixture, predict_cluster
from egobox_torch.types import CorrelationSpec, Recombination

torch.set_num_threads(2)

BOX = np.array([[0.0, 25.0]])


def piecewise(x):
    """tests/test_fused_moe.py's objective: two smooth branches with a step
    at x = 10; the optimum -15 at x = 18."""
    x = np.atleast_2d(x)
    left = (x - 3.5) * np.sin((x - 3.5) / np.pi)
    right = 0.5 * (x - 18.0) ** 2 - 15.0
    return np.where(x < 10.0, left, right).reshape(-1, 1)


def _np(a):
    return a.detach().cpu().numpy()


class _JaxFitDraws:
    def __init__(self, seed):
        self.seed = seed

    def lhs_seeds(self, n_start, dim, dtype, device):
        return torch.from_numpy(np.array(jax_maximin_lhs(
            jax.random.key(self.seed), n_start, dim, False, 5,
            jnp.float64))).to(dtype=dtype, device=device)


class _JaxGmmDraws:
    def __init__(self, seed):
        self.seed = seed

    def kmeanspp(self, x, k, n_runs):
        from egobox_tpu.moe import gmm as jgmm

        keys = jax.random.split(jax.random.key(self.seed), n_runs)
        xj = jnp.asarray(x.numpy())
        return torch.from_numpy(np.array(jax.vmap(
            lambda kk: jgmm._kmeanspp_init(kk, xj, k))(keys)))


def _solver(**gp):
    cfg = EgorConfig(gp_config=GpConfig(n_clusters=2, n_start=3, **gp),
                     seed=0, n_doe=12)
    return EgorSolver(cfg, BOX, device="cpu")


@pytest.fixture(scope="module")
def clustered():
    """A port solver whose state carries a clustering of its 12-point
    DoE (tests/test_fused_moe.py's fixture)."""
    solver = _solver()
    state = solver.init_state(piecewise)
    models = solver._train_moe(state, state.x_data, state.y_data, True)
    return solver, state, models


def _gmx_to_port(g):
    return gmx_from_numpy({k: np.asarray(getattr(g, k))
                           for k in g.__dataclass_fields__}, device="cpu")


# ---------------------------------------------------------------------------
# the solver's training against egobox_tpu
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("recluster", [False, True])
def test_train_moe_in_the_solver_matches_jax(recluster, monkeypatch):
    """One design, two solvers: on JAX's standing clustering (handed in)
    and when clustering anew (JAX's GMM seeding handed in), the same
    mixtures, experts and state. Matern 5/2 experts on a 2-d box keep the
    fits well posed."""
    monkeypatch.setattr(tfit, "_fit_draws", _JaxFitDraws)
    monkeypatch.setattr(tgmm, "_gmm_draws", _JaxGmmDraws)
    box = np.array([[0.0, 3.0], [0.0, 3.0]])

    def fun(x):
        x = np.atleast_2d(x)
        return (np.where(x[:, 0] < 1.5, np.sin(3 * x[:, 0]) * x[:, 1],
                         4.0 + x[:, 0] * x[:, 1]))[:, None]

    gp = dict(n_clusters=2, n_start=2,
              corr_spec=CorrelationSpec.MATERN52)
    js = JEgorSolver(JEgorConfig(gp_config=JGpConfig(**gp), seed=1,
                                 n_doe=20), box)
    ts = EgorSolver(EgorConfig(gp_config=GpConfig(**gp), seed=1, n_doe=20),
                    box, device="cpu")
    sj = js.init_state(fun)
    mj = js._train_moe(sj, sj.x_data, sj.y_data, True)
    if recluster:
        sj.clusterings = None
    st = EgorState(sj.x_data, sj.y_data, sj.c_data, sj.cstr_tol,
                   rng=np.random.default_rng(5))
    sj.rng = np.random.default_rng(5)
    if not recluster:
        st.clusterings = [(_gmx_to_port(g), Recombination(r.value))
                          for g, r in sj.clusterings]
    mj = js._train_moe(sj, sj.x_data, sj.y_data, True)
    mt = ts._train_moe(st, st.x_data, st.y_data, True)
    assert len(mt) == len(mj) == 1
    assert mt[0].smooth == mj[0].smooth
    for et, ej in zip(mt[0].experts, mj[0].experts):
        np.testing.assert_allclose(_np(et.theta), np.asarray(ej.theta),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(et.likelihood),
                                   float(ej.likelihood), rtol=1e-8)
    gt, gj = st.clusterings[0][0], sj.clusterings[0][0]
    np.testing.assert_allclose(_np(gt.means), np.asarray(gj.means),
                               rtol=1e-10)
    assert float(gt.heaviside_factor) == pytest.approx(
        float(gj.heaviside_factor), rel=1e-12)
    assert [[p[:2] for p in o] for o in st.moe_params] == [
        [p[:2] for p in o] for o in sj.moe_params]


# ---------------------------------------------------------------------------
# state: checkpoints, q_optmod reuse, recluster (tests/test_moe_state.py)
# ---------------------------------------------------------------------------


def _same_gmx(a, b):
    for name in ("weights", "means", "covariances", "precisions_chol",
                 "heaviside_factor"):
        np.testing.assert_allclose(np.asarray(getattr(a, name)),
                                   np.asarray(getattr(b, name)), rtol=1e-12)


def test_clusterings_checkpoint_roundtrip(clustered):
    _, state, _ = clustered
    assert state.clusterings is not None and len(state.clusterings) == 1
    restored = EgorState.from_dict(json.loads(json.dumps(state.to_dict())))
    (g0, r0), (g1, r1) = state.clusterings[0], restored.clusterings[0]
    assert r1 is r0
    _same_gmx(g1, g0)
    assert restored.moe_params == state.moe_params
    assert restored.moe_theta_inits is None


def test_a_jax_checkpoint_with_clusterings_resumes_in_the_port():
    """egobox_tpu's payload, clusterings and per-expert parameters
    included, loaded through ``convert.egor_state_from_dict``; the port's
    payload of it is the same JSON."""
    js = JEgorSolver(JEgorConfig(gp_config=JGpConfig(n_clusters=2,
                                                     n_start=3), seed=0,
                                 n_doe=12), BOX)
    sj = js.init_state(piecewise)
    js._train_moe(sj, sj.x_data, sj.y_data, True)
    payload = json.loads(json.dumps(sj.to_dict()))
    st = egor_state_from_dict(payload)
    (gt, rt), (gj, rj) = st.clusterings[0], sj.clusterings[0]
    assert rt.value == rj.value
    _same_gmx(gt, gj)
    assert st.moe_params == [[tuple(p) for p in o] for o in sj.moe_params]
    assert json.loads(json.dumps(st.to_dict())) == payload


def test_q_optmod_reuses_fixed_thetas(clustered):
    """A skip iteration refits the experts at the previous (trend, corr,
    theta): the thetas come out exactly equal."""
    solver, state, _ = clustered
    stored = [list(p) for p in state.moe_params]
    x_new = np.vstack([state.x_data, [[6.1], [7.3]]])
    y_new = np.vstack([state.y_data, piecewise(np.array([[6.1], [7.3]]))])
    models = solver._train_moe(state, x_new, y_new, optimize_theta=False)
    for k, model in enumerate(models):
        for c, expert in enumerate(model.experts):
            trend, corr, theta = stored[k][c]
            assert expert.trend == trend and expert.corr == corr
            np.testing.assert_allclose(_np(expert.theta), theta, rtol=1e-12)


def test_recluster_reoptimizes():
    solver = _solver()
    state = solver.init_state(piecewise)
    solver._train_moe(state, state.x_data, state.y_data, True)
    state.clusterings = None  # force a recluster
    x_new = np.sort(np.random.default_rng(5).uniform(0, 25, (30, 1)), axis=0)
    models = solver._train_moe(state, x_new, piecewise(x_new), True)
    assert state.clusterings is not None
    assert all(len(m.experts) >= 1 for m in models)
    assert state.clusterings[0][1] in (Recombination.HARD,
                                       Recombination.SMOOTH)


def test_automatic_clusterings_recluster_every_ten_points():
    solver = EgorSolver(EgorConfig(gp_config=GpConfig(n_clusters=0)), BOX,
                        device="cpu")
    state = EgorState(np.zeros((5, 1)), np.zeros((5, 1)), np.zeros((5, 0)),
                      np.zeros(0), added=19, prev_added=18)
    assert solver.have_to_recluster(state)  # no clustering yet
    state.clusterings = [object()]
    assert not solver.have_to_recluster(state)
    state.added = 20
    assert solver.have_to_recluster(state)
    assert not _solver().have_to_recluster(state)  # a fixed count


# ---------------------------------------------------------------------------
# the fused clustered iteration (tests/test_fused_moe.py)
# ---------------------------------------------------------------------------


def _fused_args(solver, state, gmxs, theta0s, *, fixed, seeds=None):
    """The inputs and statics ``_select_next_point_fused_moe`` gives the
    program, with fixed starts and cloud."""
    smooth = state.clusterings[0][1] is Recombination.SMOOTH
    _, t_lo, t_up = solver._theta_setup(state, state.y_data.shape[1])
    xp, yp, mask = solver._pad(state.x_data, state.y_data)
    inputs = dict(
        xp=xp, yp=yp, mask=mask, gmxs=gmxs, theta0s=theta0s, theta_lo=t_lo,
        theta_up=t_up, fit_seeds=seeds,
        cloud=torch.linspace(0.0, 25.0, 50, dtype=torch.float64)[:, None],
        starts=torch.linspace(0.5, 24.5, 6, dtype=torch.float64)[:, None],
        lo=torch.tensor([0.0], dtype=torch.float64),
        hi=torch.tensor([25.0], dtype=torch.float64),
        fmin=torch.tensor(float(state.y_data[:, 0].min()),
                          dtype=torch.float64),
        cstr_tols=torch.zeros((0,), dtype=torch.float64))
    statics = dict(
        k_clusters=gmxs[0].n_clusters, smooth=smooth, corr=solver.spec.corr,
        trend=solver.spec.trend, kpls_dim=None, gp_n_start=3,
        gp_max_iters=20, fixed=fixed, nugget=100.0 * 2.220446049250313e-16,
        crit="WB2", cstr_strategy="MC", n_cstr=0, cstr_infill=False,
        feasibility=True, optimizer="COBYLA", ls_batch=solver.spec.ls_batch,
        fcstr_fns=(), graph_safe=False)
    return inputs, statics


def test_moe_gate_requires_established_clustering():
    solver = _solver()
    state = solver.init_state(piecewise)
    assert not solver._fast_path_moe_ok(state, ())  # no clustering yet
    solver._train_moe(state, state.x_data, state.y_data, True)
    assert solver._fast_path_moe_ok(state, ())
    assert not solver._fast_path_ok(())  # not the single-cluster path
    multi = _solver(corr_spec=CorrelationSpec.SQUARED_EXPONENTIAL
                    | CorrelationSpec.MATERN52)
    assert not multi._fast_path_moe_ok(state, ())  # CV selection: host


def test_moe_gate_kill_switch(clustered, monkeypatch):
    solver, state, _ = clustered
    assert solver._fast_path_moe_ok(state, ())
    monkeypatch.setenv("EGOBOX_NO_FUSED_MOE", "1")
    assert not solver._fast_path_moe_ok(state, ())


def test_fused_moe_select_matches_host_surrogates(clustered):
    """At the host experts' fixed thetas the program's m x k lanes rebuild
    the host experts: the thetas come back as given and the in-program
    mixture predicts the design as the host mixture does."""
    solver, state, _ = clustered
    m = state.y_data.shape[1]
    gmxs = tuple(g for g, _ in state.clusterings)
    k = gmxs[0].n_clusters
    theta_fixed = torch.tensor(np.stack(
        [[np.asarray(p[2]) for p in out] for out in state.moe_params]
    )).reshape(m, k, solver.nx)
    inputs, statics = _fused_args(solver, state, gmxs, theta_fixed,
                                  fixed=True)
    packed, models, theta_last = fused_select_point_moe(**inputs, **statics)
    arr = _np(packed)
    assert 0.0 <= arr[0] <= 25.0 and np.isfinite(arr[1])
    torch.testing.assert_close(theta_last, theta_fixed, rtol=1e-12, atol=0)
    xs = torch.from_numpy(state.x_data)
    mean_fused, var_fused = tmoe.moe_predict_valvar_batch(models[0], xs)
    host = solver._train_moe(state, state.x_data, state.y_data,
                             optimize_theta=False)
    mean_host, var_host = tmoe.moe_predict_valvar_batch(host[0], xs)
    torch.testing.assert_close(mean_fused, mean_host, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(var_fused, var_host, rtol=1e-6, atol=1e-8)


def _lane_thetas(solver, inputs, statics, seeds):
    """An independent reference for the program's m x k masked fits: the
    masks rebuilt in numpy (the assignment, and the full active mask for a
    cluster of fewer than 3 rows) and one fit per lane."""
    xp, yp, mask = inputs["xp"], inputs["yp"], inputs["mask"]
    gmxs, theta0s = inputs["gmxs"], inputs["theta0s"]
    m, k, dim = theta0s.shape
    valid = _np(mask)
    out = np.zeros((m, k, dim))
    for j in range(m):
        assign = _np(predict_cluster(gmxs[j], xp))
        for c in range(k):
            mc = valid & (assign == c)
            if mc.sum() < 3:
                mc = valid
            model = fit_gp_core(
                xp, yp[:, j:j + 1], torch.from_numpy(mc),
                torch.clamp(theta0s[j, c], inputs["theta_lo"],
                            inputs["theta_up"]),
                inputs["theta_lo"], inputs["theta_up"],
                torch.ones((dim,), dtype=torch.bool), _Seeds(seeds),
                corr=statics["corr"], trend=statics["trend"],
                n_start=statics["gp_n_start"],
                max_iters=statics["gp_max_iters"], nugget=statics["nugget"],
                ls_batch=statics["ls_batch"])
            out[j, c] = _np(model.theta)
    return out


class _Seeds:
    def __init__(self, seeds):
        self.seeds = seeds

    def lhs_seeds(self, n_start, dim, dtype, device):
        return self.seeds


def test_fused_moe_live_fits_match_per_lane_fits(clustered):
    """Live fits: the program's stack of m x k masked lanes against one
    fit per lane from masks rebuilt in numpy."""
    solver, state, _ = clustered
    gmxs = tuple(g for g, _ in state.clusterings)
    theta0s = torch.full((1, 2, solver.nx), 0.1, dtype=torch.float64)
    seeds = FitDraws(0).lhs_seeds(3, solver.nx, torch.float64, "cpu")
    inputs, statics = _fused_args(solver, state, gmxs, theta0s, fixed=False,
                                  seeds=seeds)
    packed, _, theta_last = fused_select_point_moe(**inputs, **statics)
    ref = _lane_thetas(solver, inputs, statics, seeds)
    np.testing.assert_allclose(_np(theta_last), ref, rtol=1e-5)
    assert 0.0 <= float(packed[0]) <= 25.0 and np.isfinite(float(packed[1]))
    assert np.max(np.abs(ref - 0.1)) > 1e-3  # a fit happened


def _spike_gmx(at: float, dt=torch.float64):
    """Cluster 0 wide (mean 10, variance 100), cluster 1 a narrow spike at
    ``at`` (variance 0.1): only rows within about 1 of it go to cluster
    1."""
    covs = torch.tensor([[[100.0]], [[0.1]]], dtype=dt)
    return GaussianMixture(
        weights=torch.tensor([0.5, 0.5], dtype=dt),
        means=torch.tensor([[10.0], [at]], dtype=dt), covariances=covs,
        precisions_chol=1.0 / torch.sqrt(covs),
        heaviside_factor=torch.tensor(1.0, dtype=dt))


def test_fused_moe_thin_cluster_fallback(clustered):
    """A cluster with fewer than 3 active rows widens to every active row:
    the thin lane equals a full-mask fit, the fat lane its own mask's fit,
    and the two differ."""
    solver, state, _ = clustered
    gmx = _spike_gmx(float(state.x_data.max()))
    xp, _, mask = solver._pad(state.x_data, state.y_data)
    valid = _np(mask)
    assign = _np(predict_cluster(gmx, xp))
    thin, fat = valid & (assign == 1), valid & (assign == 0)
    assert 0 < thin.sum() < 3 and fat.sum() >= 3  # the scenario
    theta0s = torch.full((1, 2, solver.nx), 0.1, dtype=torch.float64)
    seeds = FitDraws(0).lhs_seeds(3, solver.nx, torch.float64, "cpu")
    inputs, statics = _fused_args(solver, state, (gmx,), theta0s,
                                  fixed=False, seeds=seeds)
    _, _, theta_last = fused_select_point_moe(**inputs, **statics)

    def direct(mc):
        return _np(fit_gp_core(
            inputs["xp"], inputs["yp"][:, :1], torch.from_numpy(mc),
            theta0s[0, 0], inputs["theta_lo"], inputs["theta_up"],
            torch.ones((1,), dtype=torch.bool), _Seeds(seeds),
            corr=statics["corr"], trend=statics["trend"], n_start=3,
            max_iters=20, nugget=statics["nugget"],
            ls_batch=statics["ls_batch"]).theta)

    th = _np(theta_last)
    np.testing.assert_allclose(th[0, 1], direct(valid), rtol=1e-5)
    np.testing.assert_allclose(th[0, 0], direct(fat), rtol=1e-5)
    assert not np.allclose(th[0, 1], th[0, 0], rtol=1e-3)


def test_a_new_clustering_changes_the_result(clustered):
    """The mixture is an input of the program, not a constant of it: the
    same call with another GMM (or only another heaviside factor) gives
    other experts and another proposal. On the card the same holds for a
    replay of the captured graph (tests/test_torch_cuda.py)."""
    solver, state, _ = clustered
    g0 = state.clusterings[0][0]
    theta0s = torch.full((1, 2, solver.nx), 0.1, dtype=torch.float64)
    seeds = FitDraws(0).lhs_seeds(3, solver.nx, torch.float64, "cpu")
    outs = []
    for g in (g0, g0.with_heaviside(0.15),
              _spike_gmx(float(state.x_data.max()))):
        inputs, statics = _fused_args(solver, state, (g,), theta0s,
                                      fixed=False, seeds=seeds)
        statics["smooth"] = True
        packed, models, theta = fused_select_point_moe(**inputs, **statics)
        mean, _ = tmoe.moe_predict_valvar_batch(
            models[0], torch.linspace(0.0, 25.0, 40,
                                      dtype=torch.float64)[:, None])
        outs.append((_np(mean), _np(theta)))
    assert not np.allclose(outs[0][0], outs[1][0])  # the factor alone
    assert not np.allclose(outs[0][1], outs[2][1])  # other lanes


# ---------------------------------------------------------------------------
# the clustered proposal against egobox_tpu's: fused and host path
# ---------------------------------------------------------------------------

#: the egor-moe2-piecewise cell's configuration (n_doe=10, 2 clusters) at
#: two (kernel, seed) pairs whose proposals are well posed. With the
#: default kernel at seed 42 one expert's Gram is near singular and the
#: criterion nearly flat at its top: there the two packages' multistart
#: argmins part on rounding even at the same fixed thetas.
PROPOSAL = {
    "sqexp-seed7": (CorrelationSpec.SQUARED_EXPONENTIAL, 7),
    "matern52-seed42": (CorrelationSpec.MATERN52, 42),
}


def _piecewise_configs(case):
    spec, seed = PROPOSAL[case]
    gp = dict(n_clusters=2, n_start=2, corr_spec=spec)
    return (JEgorConfig(gp_config=JGpConfig(**gp), seed=seed, n_doe=10),
            EgorConfig(gp_config=GpConfig(**gp), seed=seed, n_doe=10))


@functools.lru_cache(maxsize=None)
def _jax_clustered(case):
    """egobox_tpu's clustered state of the cell's 10-point DoE (its own
    draws), made once per case."""
    js = JEgorSolver(_piecewise_configs(case)[0], BOX)
    sj = js.init_state(piecewise)
    js._train_moe(sj, sj.x_data, sj.y_data, True)
    return sj


@pytest.mark.parametrize("case,fixed,smooth", [
    ("sqexp-seed7", False, True), ("sqexp-seed7", True, False),
    ("matern52-seed42", False, False), ("matern52-seed42", True, True),
], ids=["sqexp-seed7-live-smooth", "sqexp-seed7-fixed-hard",
        "matern52-seed42-live-hard", "matern52-seed42-fixed-smooth"])
def test_fused_moe_select_matches_jax(case, fixed, smooth):
    """``fused_select_point_moe`` against egobox_tpu's on the same padded
    design, clustering (egobox_tpu's, converted), theta inits and starts,
    with JAX's fit seeds and scaling cloud handed in: the proposal x within
    1e-5 of the box width, the criterion rtol 1e-6 and the experts' thetas
    rtol 1e-5 (live fits; fixed thetas come back as given). Each design
    takes live and fixed fits, smooth and hard recombination, once each:
    every pair of statics is one more egobox_tpu compile."""
    from egobox_tpu.doe.lhs import LhsKind as JLhsKind
    from egobox_tpu.doe.lhs import lhs_normalized as jax_lhs_normalized
    from egobox_tpu.ego import fused_step as jfs

    sj = _jax_clustered(case)
    solver = EgorSolver(_piecewise_configs(case)[1], BOX, device="cpu")
    state = EgorState(sj.x_data, sj.y_data, sj.c_data, sj.cstr_tol,
                      rng=np.random.default_rng(0))
    xp, yp, mask = solver._pad(state.x_data, state.y_data)
    _, t_lo, t_up = solver._theta_setup(state, 1)
    gj = sj.clusterings[0][0]
    theta0s = (np.array([[p[2] for p in sj.moe_params[0]]]) if fixed
               else np.full((1, 2, 1), 0.1))
    statics = solver._fused_statics(state, "LogEI", "MC", (), not fixed)
    statics.update(gp_n_start=solver.spec.n_start, k_clusters=2,
                   smooth=smooth)
    lo, hi = BOX[:, 0].copy(), BOX[:, 1].copy()
    starts = np.random.default_rng(3).uniform(lo, hi, (6, 1))
    fmin = float(sj.y_data.min())
    n_cloud = 100
    fit_key, cloud_key = jax.random.key(11), jax.random.key(12)
    arrays = (xp, yp, mask)
    packed_j, _, theta_j = jfs.fused_select_point_moe(
        *(jnp.asarray(_np(a)) for a in arrays), (gj,), jnp.asarray(theta0s),
        jnp.asarray(_np(t_lo)), jnp.asarray(_np(t_up)), fit_key, cloud_key,
        jnp.asarray(starts), jnp.asarray(lo), jnp.asarray(hi),
        jnp.asarray(fmin), jnp.zeros((0,)), n_cloud=n_cloud,
        **{k: v for k, v in statics.items() if k != "graph_safe"})
    seeds = np.array(jax_maximin_lhs(fit_key, solver.spec.n_start, 1,
                                       False, 5, jnp.float64))
    cloud = lo + np.asarray(jax_lhs_normalized(
        cloud_key, n_cloud, 1, JLhsKind.MAXIMIN, jnp.float64)) * (hi - lo)
    packed, _, theta = fused_select_point_moe(
        *arrays, (_gmx_to_port(gj),), torch.from_numpy(theta0s), t_lo, t_up,
        None if fixed else torch.from_numpy(seeds), torch.from_numpy(cloud),
        torch.from_numpy(starts), torch.from_numpy(lo), torch.from_numpy(hi),
        torch.tensor(fmin, dtype=torch.float64),
        torch.zeros((0,), dtype=torch.float64), graph_safe=False, **statics)
    packed_j = np.asarray(packed_j)
    assert np.all(np.abs(_np(packed[:1]) - packed_j[:1]) <= 1e-5 * 25.0), (
        _np(packed), packed_j)
    assert 0.0 < packed_j[0] < 25.0  # an interior proposal, not a bound
    np.testing.assert_allclose(float(packed[1]), packed_j[1], rtol=1e-6)
    np.testing.assert_allclose(_np(theta), np.asarray(theta_j), rtol=1e-5)


def test_host_path_clustered_suggest_matches_jax(monkeypatch):
    """One clustered host-path iteration (``EGOBOX_NO_FUSED_MOE=1``):
    ``suggest`` on the same design in both packages, with egobox_tpu's
    GMM seeding, fit seeds and LHS draws handed to the port. The GMM, the
    CV-free expert fits, the heaviside search, the retrain, the scaling
    cloud and the mixture infill: the next x within 1e-5 of the box
    width."""
    from egobox_tpu.ego import solver as jsolver

    monkeypatch.setenv("EGOBOX_NO_FUSED_MOE", "1")
    monkeypatch.setattr(tfit, "_fit_draws", _JaxFitDraws)
    monkeypatch.setattr(tgmm, "_gmm_draws", _JaxGmmDraws)
    recorded = []
    for name in ("_lhs", "_lhs_in"):
        orig = getattr(jsolver.EgorSolver, name)

        def wrapped(self, *a, _orig=orig, **k):
            pts = np.asarray(_orig(self, *a, **k))
            recorded.append(pts)
            return pts

        monkeypatch.setattr(jsolver.EgorSolver, name, wrapped)
    jcfg, tcfg = _piecewise_configs("matern52-seed42")
    x = np.random.default_rng(5).uniform(0.0, 25.0, (10, 1))
    y = piecewise(x)
    want = JEgorSolver(jcfg, BOX).suggest(x, y)
    ts = EgorSolver(tcfg, BOX, device="cpu")
    ts.draws = _ReplayDraws(recorded)
    got = ts.suggest(x, y)
    assert not ts.draws.recorded  # every draw was asked for, in order
    assert isinstance(ts.last_models, tuple)
    assert len(ts.last_models[0].experts) == 2
    assert got.shape == want.shape == (1, 1)
    assert 0.0 < want[0, 0] < 25.0
    assert np.all(np.abs(got - want) <= 1e-5 * 25.0), (got, want)


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


# ---------------------------------------------------------------------------
# whole runs (tests/test_fused_moe.py:266-288) and the other entry points
# ---------------------------------------------------------------------------


def test_fused_moe_egor_run_quality():
    egor = Egor([[0.0, 25.0]], seed=42, n_doe=12, n_clusters=2,
                device="cpu")
    res = egor.minimize(piecewise, max_iters=10)
    assert res.y_opt[0] < -14.0
    assert abs(res.x_opt[0] - 18.0) < 1.5
    kinds = [("fit" in t, "graph" in t) for t in egor.iteration_times]
    assert kinds[0] == (True, False)  # the clustering, on the host
    assert all(k == (False, True) for k in kinds[1:])  # then fused


def test_fused_moe_vs_host_path_quality(monkeypatch):
    y_fused = Egor([[0.0, 25.0]], seed=3, n_doe=12, n_clusters=2,
                   device="cpu").minimize(piecewise, max_iters=8).y_opt[0]
    monkeypatch.setenv("EGOBOX_NO_FUSED_MOE", "1")
    egor = Egor([[0.0, 25.0]], seed=3, n_doe=12, n_clusters=2, device="cpu")
    y_host = egor.minimize(piecewise, max_iters=8).y_opt[0]
    assert all("fit" in t for t in egor.iteration_times)
    assert y_fused < -13.0
    assert abs(y_fused - y_host) < 1.5


@pytest.mark.parametrize("kw", [
    dict(n_clusters=0, n_doe=10),
    dict(corr_spec=CorrelationSpec.SQUARED_EXPONENTIAL
         | CorrelationSpec.MATERN52, n_doe=8),
])
def test_automatic_clusters_and_several_kernels_run(kw):
    """Egor(n_clusters=0) and a multi-kernel Egor, which egobox_torch
    refused before the mixture was ported, run on the host path."""
    egor = Egor([[0.0, 25.0]], seed=1, device="cpu", **kw)
    res = egor.minimize(piecewise, max_iters=2)
    assert res.x_doe.shape[0] == kw["n_doe"] + 2
    assert np.all(np.isfinite(res.y_doe))
    assert isinstance(egor.solver.last_models, tuple)


def test_traced_run_and_batch_refuse_clustered_surrogates():
    """As in egobox_tpu (ego/batch.py:155-159, the traced run's gate): the
    whole-run mode takes the host loop and EgorBatch raises."""
    egor = Egor([[0.0, 25.0]], n_clusters=2, traced_run=True, device="cpu")
    assert not egor._use_traced_run(
        lambda x: (x - 3.5) * torch.sin((x - 3.5) / np.pi), (), None)
    with pytest.raises(ValueError, match="single-cluster"):
        EgorBatch([piecewise, piecewise], BOX,
                  gp_config=GpConfig(n_clusters=2), device="cpu")
