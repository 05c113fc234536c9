"""egobox_torch's infill optimizer against egobox_tpu's, float64 on the CPU.

Surrogates are fitted by egobox_tpu on a fixed 12-point G24 design
(objective + 2 constraints; nugget 1e-6, so that the condition number of R,
which multiplies every rounding difference between the two libraries, stays
near 1e6) and carried over with
``convert.gp_surrogates_from_numpy``; both sides get the same starts and the
same scaling cloud. Tolerances: the batched posterior atol 1e-9,
``compute_scaling`` rtol 1e-10, the per-start ``(xs, fs, vs)`` of
``optimize_infill`` atol 1e-7 at ``inner_iters=5, n_outer=2``; at the
default budget the chosen x within 1e-5 of the box width and f within 1e-6.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egobox_tpu.ego import infill_optim as jio
from egobox_tpu.ego import surrogates as jsur
from egobox_torch.convert import gp_surrogates_from_numpy
from egobox_torch.ego import infill_optim as tio
from egobox_torch.ego import surrogates as tsur

torch.set_num_threads(2)

XLIMITS = np.array([[0.0, 3.0], [0.0, 4.0]])
CSTR_TOLS = np.array([1e-3, 1e-3])


def g24(p):
    x1, x2 = p[:, 0], p[:, 1]
    c1 = -2.0 * x1**4 + 8.0 * x1**3 - 8.0 * x1**2 + x2 - 2.0
    c2 = (-4.0 * x1**4 + 32.0 * x1**3 - 88.0 * x1**2 + 96.0 * x1 + x2
          - 36.0)
    return np.array([-x1 - x2, c1, c2]).T


@pytest.fixture(scope="module")
def setup():
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
    starts = rng.uniform(XLIMITS[:, 0], XLIMITS[:, 1], (4, 2))
    cloud = rng.uniform(XLIMITS[:, 0], XLIMITS[:, 1], (60, 2))
    return dict(mj=mj, mt=mt, fmin=fmin, starts=starts, cloud=cloud,
                y_best=y[int(np.argmin(y[:, 0]))])


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def test_converted_container_and_batched_posterior(setup):
    mt, mj = setup["mt"], setup["mj"]
    assert mt.x_norm.shape == (3, 12, 2) and mt.r_chol.shape == (3, 12, 12)
    wm, wv = jsur.predict_valvar_cloud(mj, jnp.asarray(setup["cloud"]))
    gm, gv = tsur.predict_valvar_cloud(mt, _t(setup["cloud"]))
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), rtol=0, atol=1e-9)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=0, atol=1e-9)
    # one point, and lanes x trials of points, through the same function
    m1, v1 = tsur.predict_valvar_single(mt, _t(setup["cloud"][0]))
    np.testing.assert_allclose(m1.numpy(), np.asarray(wm)[:, 0], atol=1e-9)
    mb, vb = tsur.predict_valvar_single(mt, _t(setup["cloud"]).reshape(
        6, 10, 2))
    assert mb.shape == (3, 6, 10)
    np.testing.assert_allclose(vb.reshape(3, 60).numpy(), np.asarray(wv),
                               atol=1e-9)
    with pytest.raises(ValueError, match="leading"):
        gp_surrogates_from_numpy(
            {k: (None if v is None else v.numpy()[0])
             for k, v in dataclasses.asdict(mt).items()
             if k not in ("corr", "trend")}, mt.corr, mt.trend, device="cpu")


@pytest.mark.parametrize("kernel", ["matern52", "absolute_exponential"])
def test_batched_posterior_of_l1_kernels_matches_per_output(kernel):
    """The L1-family branch of the batched posterior against
    ``gp.predict_valvar`` output by output (fitted by the port)."""
    from egobox_torch import gp as tgp

    rng = np.random.default_rng(2)
    x = _t(rng.uniform(-1.0, 1.0, (15, 3)))
    y = _t(np.stack([np.sin(x.numpy()).sum(1), (x.numpy() ** 2).sum(1)], 1))
    models = tsur.train_gp_surrogates(
        x, y, None, tsur.GpSpec(corr=kernel, n_start=1, max_iters=5), seed=1)
    probe = _t(rng.uniform(-1.0, 1.0, (7, 3)))
    means, vrs = tsur.predict_valvar_cloud(models, probe)
    for i in range(2):
        one = dataclasses.replace(models, **{
            f.name: getattr(models, f.name)[i]
            for f in dataclasses.fields(models)
            if isinstance(getattr(models, f.name), torch.Tensor)})
        m, v = tgp.predict_valvar(one, probe)
        np.testing.assert_allclose(means[i].numpy(), m.numpy(), atol=1e-10)
        np.testing.assert_allclose(vrs[i].numpy(), v.numpy(), atol=1e-10)


@pytest.mark.parametrize("crit,cstr_infill", [
    ("LogEI", False), ("LogEI", True), ("EI", True), ("WB2S", False)])
def test_compute_scaling_matches_jax(setup, crit, cstr_infill):
    want = jio.compute_scaling(
        setup["mj"], jnp.asarray(setup["cloud"]), setup["fmin"],
        jnp.asarray(CSTR_TOLS), crit=crit, n_cstr=2, cstr_infill=cstr_infill)
    got = tio.compute_scaling(
        setup["mt"], _t(setup["cloud"]), setup["fmin"], _t(CSTR_TOLS),
        crit=crit, n_cstr=2, cstr_infill=cstr_infill)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10)


def _fc_jax(x):
    return x[0] + x[1] - 4.5


def _fc_torch(x):
    return x[0] + x[1] - 4.5


CASES = {
    "unconstrained-logei": dict(n_cstr=0),
    "mc-cobyla": dict(n_cstr=2, cstr_strategy="MC", optimizer="COBYLA"),
    "utb-slsqp": dict(n_cstr=2, cstr_strategy="UTB", optimizer="SLSQP"),
    "cstr-infill": dict(n_cstr=2, cstr_infill=True),
    "fcstr": dict(n_cstr=2, fcstr=True),
    "feasibility-false": dict(n_cstr=2, feasibility=False),
}


def _both(setup, case, **budget):
    kw = dict(CASES[case])
    m = 1 + kw["n_cstr"]
    mj = jax_slice(setup["mj"], m)
    mt = torch_slice(setup["mt"], m)
    tols = CSTR_TOLS[:kw["n_cstr"]]
    fcstr = kw.pop("fcstr", False)
    sj = jio.compute_scaling(mj, jnp.asarray(setup["cloud"]), setup["fmin"],
                             jnp.asarray(tols), n_cstr=kw["n_cstr"],
                             cstr_infill=kw.get("cstr_infill", False))
    st = tio.compute_scaling(mt, _t(setup["cloud"]), setup["fmin"], _t(tols),
                             n_cstr=kw["n_cstr"],
                             cstr_infill=kw.get("cstr_infill", False))
    extra_j, extra_t = {}, {}
    if fcstr:
        scale = np.array([4.5])
        extra_j = dict(fcstr_tols=jnp.asarray([1e-4]),
                       scale_fcstr=jnp.asarray(scale),
                       fcstr_fns=(_fc_jax,))
        extra_t = dict(fcstr_tols=_t([1e-4]), scale_fcstr=_t(scale),
                       fcstr_fns=(_fc_torch,))
    lo, hi = XLIMITS[:, 0], XLIMITS[:, 1]
    want = jio.optimize_infill(
        mj, jnp.asarray(setup["starts"]), jnp.asarray(lo), jnp.asarray(hi),
        setup["fmin"], sj[0], sj[2], sj[1], jnp.asarray(tols),
        **kw, **budget, **extra_j)
    got = tio.optimize_infill(
        mt, _t(setup["starts"]), _t(lo), _t(hi), setup["fmin"], st[0],
        st[2], st[1], _t(tols), **kw, **budget, **extra_t)
    return got, want


def jax_slice(models, m):
    import jax

    return jax.tree_util.tree_map(lambda a: a[:m], models)


def torch_slice(models, m):
    return dataclasses.replace(models, **{
        f.name: getattr(models, f.name)[:m]
        for f in dataclasses.fields(models)
        if isinstance(getattr(models, f.name), torch.Tensor)})


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimize_infill_per_start_matches_jax(setup, case):
    got, want = _both(setup, case, inner_iters=5, n_outer=2)
    for g, w in zip(got[2], want[2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-7)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-7)
    np.testing.assert_allclose(float(got[1]), float(want[1]), atol=1e-7)
    if case == "fcstr":
        # the function constraint binds: x1 + x2 <= 4.5 (+ the slack of
        # the optimizer's feasibility test, 1e-6 of the scale)
        assert float(got[0].sum()) <= 4.5 + 1e-5


@pytest.mark.parametrize("case", ["unconstrained-logei", "mc-cobyla"])
def test_optimize_infill_default_budget_matches_jax(setup, case):
    got, want = _both(setup, case)
    width = XLIMITS[:, 1] - XLIMITS[:, 0]
    assert np.all(np.abs(got[0].numpy() - np.asarray(want[0]))
                  <= 1e-5 * width), (got[0], want[0])
    assert abs(float(got[1]) - float(want[1])) <= 1e-6


@pytest.mark.parametrize("strategy", ["KB", "KBLB", "KBUB", "CLMIN"])
def test_virtual_point_matches_jax(setup, strategy):
    xk = setup["cloud"][3]
    want = jio.virtual_point(setup["mj"], jnp.asarray(xk),
                             jnp.asarray(setup["y_best"]), strategy=strategy)
    got = tio.virtual_point(setup["mt"], _t(xk), _t(setup["y_best"]),
                            strategy=strategy)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-9)


def test_eval_infill_and_cstrs_matches_jax(setup):
    xk = setup["cloud"][5]
    want = jio.eval_infill_and_cstrs(
        setup["mj"], jnp.asarray(xk), setup["fmin"], 2.0, 1.0,
        jnp.asarray(CSTR_TOLS), cstr_infill=True)
    got = tio.eval_infill_and_cstrs(
        setup["mt"], _t(xk), setup["fmin"], 2.0, 1.0, _t(CSTR_TOLS),
        cstr_infill=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-9)


def test_feas_flag_selects_between_the_static_structures(setup):
    """The runtime switch equals the static feasibility=True / False
    objective term by term (egobox_tpu holds the same in its batch path)."""
    mt = setup["mt"]
    pts = _t(setup["cloud"][:9])
    means, vrs = tsur.predict_valvar_single(mt, pts)
    args = ("LogEI", means, vrs, setup["fmin"], 2.0, 1.0, _t(CSTR_TOLS))
    for flag in (True, False):
        for cstr_infill in (True, False):
            got = tio._infill_obj_terms(*args, cstr_infill, 1.0, True,
                                        torch.tensor(flag))
            want = tio._infill_obj_terms(*args, cstr_infill, 1.0, flag)
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-14)
    with pytest.raises(ValueError, match="feas_flag"):
        tio.optimize_infill(mt, pts[:2], pts[0], pts[1], 0.0, 1.0, 1.0,
                            _t([1.0, 1.0]), _t(CSTR_TOLS), n_cstr=2,
                            feasibility=False,
                            feas_flag=torch.tensor(True))


def test_mixture_container_raises():
    """egobox_tpu's clustered container is a tuple of mixtures. Since the
    mixture is ported a tuple of ``MoeModel`` is served, one posterior per
    output as ``moe_predict_valvar_single`` gives it, at one point, per
    lane and over a cloud (test_torch_moe.py holds the mixtures against
    egobox_tpu); a tuple of anything else raises."""
    from egobox_torch import gp as tgp
    from egobox_torch import moe as tmoe

    with pytest.raises(AttributeError):
        tsur.surrogate_valvar_single((object(),), torch.zeros(2))
    with pytest.raises(AttributeError):
        tsur.surrogate_valvar_cloud((object(),), torch.zeros((3, 2)))
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.0, 1.0, (12, 2))
    experts = tuple(tgp.fit_gp(x, np.sin(3.0 * x[:, i]), n_start=0,
                               max_iters=3, device="cpu") for i in (0, 1))
    gmx = tmoe.GaussianMixture(
        weights=torch.tensor([0.4, 0.6], dtype=torch.float64),
        means=torch.tensor([[-0.5, 0.0], [0.5, 0.0]], dtype=torch.float64),
        covariances=torch.eye(2, dtype=torch.float64).expand(2, 2, 2),
        precisions_chol=torch.eye(2, dtype=torch.float64).expand(2, 2, 2),
        heaviside_factor=torch.tensor(1.0, dtype=torch.float64))
    models = (tmoe.MoeModel(experts, gmx, True),
              tmoe.MoeModel(experts, gmx, False))
    xq = torch.from_numpy(rng.uniform(-1.0, 1.0, (4, 3, 2)))
    means, vrs = tsur.surrogate_valvar_single(models, xq)
    assert means.shape == vrs.shape == (2, 4, 3)
    for j, mo in enumerate(models):
        m1, v1 = tmoe.moe_predict_valvar_batch(mo, xq.reshape(-1, 2))
        torch.testing.assert_close(means[j].reshape(-1), m1, rtol=0, atol=0)
        torch.testing.assert_close(vrs[j].reshape(-1), v1, rtol=0, atol=0)
    # another batch size: the same sums up to the last bit
    mc, vc = tsur.surrogate_valvar_cloud(models, xq[0])
    torch.testing.assert_close(mc, means[:, 0], rtol=1e-12, atol=1e-15)
    torch.testing.assert_close(vc, vrs[:, 0], rtol=1e-12, atol=1e-15)
