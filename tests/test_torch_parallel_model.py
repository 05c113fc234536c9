"""egobox_torch.parallel's distributed fit and model against
egobox_tpu.parallel: fit_theta_distributed and fit_gp(mesh=) (with
mesh_materialize), the realized DistGpModel and its serving path (predict,
variance, posterior covariance, samples; KPLS too), a DistGpModel of
egobox_tpu's carried across (convert.dist_gp_model_from_numpy), and the
sharded multistart (multistart_neg_rlf_minimize, fit_gp_multichip).

The set-up of tests/test_torch_parallel.py: 4 gloo CPU ranks spawned once
for the file, against egobox_tpu on ``make_mesh(4, axis="rows")`` of the
conftest's 8 CPU devices, then rank 0 alone on ``make_mesh(1)`` against
egobox_tpu's one-device mesh; n = 32, d = 3, bp = 4 (4 ranks) and 8
(one), float64, nugget 1e-6, egobox_tpu jitted. egobox_tpu's draws go
into the ranks: the warm start's LHS seeds (key(seed), gp/fit.py) and
the sample's normals. egobox_tpu's fit_gp(mesh=) is its
fit_theta_distributed followed by realize_dist_model at the clipped
theta; its fit is jitted here as that polish from the warm start's theta
(the same program without the host-side warm start).

Tolerances: theta 1e-4 relative; the realized factor and gamma rows 1e-10
relative; predict / var / valvar / posterior_cov / sample 1e-8; the
carried model's predictions 1e-10 relative.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as R
from egobox_tpu import gp as jgp
from egobox_tpu import parallel as jpar
from egobox_tpu.doe.lhs import maximin_lhs as jax_maximin_lhs
from egobox_torch.parallel.launch import run_ranks

torch.set_num_threads(2)

FIT_KW = dict(corr="matern52", subsample_warmstart=R.N // 2, polish_iters=2,
              seed=3)
DIST_FIELDS = ("x_norm_feed", "x_mean", "x_std", "y_mean", "y_std",
               "theta", "w_star", "beta", "gamma_feed", "l_feed", "ft_feed",
               "gram_chol", "sigma2", "likelihood")
SERVE = ("predict", "predict_var", "valvar", "cov", "sample",
         "sample_chol")


def _serve(mesh, bp, x, y, theta, xq, key):
    """egobox_tpu's realized models (plain and KPLS) and what they serve."""
    out = {}
    for name, kw, th in (("plain", {}, theta),
                         ("kpls", dict(kpls_dim=2), theta[:2])):
        m = jpar.realize_dist_model(mesh, x, y, th, corr="matern52",
                                    nugget=R.NUGGET, bp=bp, **kw)
        out[name] = dict(
            l_feed=m.l_feed, gamma_feed=m.gamma_feed,
            likelihood=m.likelihood, predict=jpar.dist_predict(m, xq),
            predict_var=jpar.dist_predict_var(m, xq),
            valvar=jnp.stack(jpar.dist_predict_valvar(m, xq)),
            cov=jpar.dist_posterior_cov(m, xq),
            sample=jpar.dist_sample(m, xq, 3, key),
            sample_chol=jpar.dist_sample(m, xq, 3, key, method="chol"))
        if name == "plain":
            out["fields"] = {k: getattr(m, k) for k in DIST_FIELDS
                             if k != "w_star"}
    return out


@pytest.fixture(scope="module")
def served():
    inp = R.data()
    x, y = jnp.asarray(inp["x"]), jnp.asarray(inp["y"])
    xq = jnp.asarray(np.random.default_rng(4).uniform(size=(7, R.NX)))
    key = jax.random.key(11)
    out = {}
    for d in (4, 1):
        mesh = jpar.make_mesh(d, axis="rows")
        out[d] = jax.tree_util.tree_map(np.asarray, jax.jit(
            lambda *a: _serve(mesh, R.BP[d], *a))(
                x, y, jnp.asarray(inp["theta"]), xq, key))
    return dict(out, xq=np.asarray(xq),
                normals=np.asarray(jax.random.normal(key, (7, 3),
                                                     jnp.float64)))


@pytest.fixture(scope="module")
def inputs(served):
    inp = R.data()
    inp.update(parts=("model",), fit_kw=FIT_KW, xq=served["xq"],
               normals=served["normals"],
               probes=np.zeros((R.N, 0)),  # no Hutchinson gradient here
               warm_lhs=np.asarray(jax_maximin_lhs(
                   jax.random.key(FIT_KW["seed"]), 10, R.NX, False, 5,
                   jnp.float64)),
               inits=np.random.default_rng(5).uniform(-2.0, 1.0, (8, R.NX)))
    for d in (4, 1):
        inp[f"jax_model_{d}"] = dict(served[d]["fields"], w_star=None)
    return inp


@pytest.fixture(scope="module")
def ranks(inputs):
    """The ranks' results, a future: they run while egobox_tpu compiles."""
    with ThreadPoolExecutor(1) as ex:
        yield ex.submit(run_ranks, R.run, 4, (inputs,), timeout=120)


@pytest.fixture(scope="module")
def fitted(inputs, ranks):
    """egobox_tpu's fit (warm start, then the distributed polish) and
    sharded multistart on its 4- and 1-device meshes."""
    x, y = jnp.asarray(inputs["x"]), jnp.asarray(inputs["y"])
    idx = np.random.default_rng(FIT_KW["seed"]).permutation(R.N)[
        :FIT_KW["subsample_warmstart"]]
    m0 = jgp.fit_gp(x[idx], y[idx], corr="matern52", nugget=R.NUGGET,
                    seed=FIT_KW["seed"])
    theta0 = jnp.clip(m0.theta, 1e-2, 1e1)
    xs = (x - x.mean(0)) / x.std(0, ddof=1)
    y_std = y.std(0, ddof=1)
    ys = (y - y.mean(0)) / y_std
    inits = jnp.asarray(inputs["inits"])
    lo, up = jnp.full((R.NX,), -2.0), jnp.full((R.NX,), 1.0)
    out = {}
    for d in (4, 1):
        mesh = jpar.make_mesh(d, axis="rows")
        theta = jax.jit(lambda t0: jpar.fit_theta_distributed(
            mesh, x, y, corr="matern52", theta0=t0,
            max_iters=FIT_KW["polish_iters"], nugget=R.NUGGET,
            bp=R.BP[d])[0])(theta0)
        tb, fb = jpar.multistart_neg_rlf_minimize(
            xs, ys, y_std, jpar.shard_starts(mesh, inits), lo, up, None,
            corr="matern52", trend="constant", max_iters=5,
            nugget=R.NUGGET)
        mgp = jpar.fit_gp_multichip(mesh, x, y, inits, corr="matern52",
                                    max_iters=5, nugget=R.NUGGET)
        out[d] = dict(theta=np.asarray(theta), multistart=np.asarray(tb),
                      multistart_f=float(fb),
                      multichip=np.asarray(mgp.theta))
    return out


def _got(ranks, d, key):
    """The ranks' ``key`` for mesh size d (rank 0's; the 4 ranks' blocks
    concatenated for the feed rows of a realized model)."""
    res = ranks.result()
    if d == 1:
        return res[0]["model_1"][key]
    got = res[0]["model_4"][key]
    if key.startswith("model_"):
        got = dict(got)
        for k in ("l_feed", "gamma_feed"):
            got[k] = np.concatenate([r["model_4"][key][k] for r in res])
        for r in res[1:]:
            for k in SERVE:
                np.testing.assert_array_equal(r["model_4"][key][k], got[k])
    return got


@pytest.mark.parametrize("d", [4, 1])
def test_fit_theta_matches_jax(ranks, fitted, d):
    """fit_theta_distributed, fit_gp(mesh=) (a DistGpModel of n rows) and
    fit_gp(mesh=, mesh_materialize=True) (a GpModel) at egobox_tpu's
    theta, rel 1e-4: the warm start on 16 points, 2 distributed
    iterations."""
    want = fitted[d]["theta"]
    np.testing.assert_allclose(_got(ranks, d, "theta_fit"), want,
                               rtol=1e-4)
    kind, theta, n = _got(ranks, d, "fit_gp")
    assert (kind, n) == ("DistGpModel", R.N)
    np.testing.assert_allclose(theta, np.clip(want, 1e-2, 1e1), rtol=1e-4)
    kind, theta = _got(ranks, d, "materialized")
    assert kind == "GpModel"
    np.testing.assert_allclose(theta, np.clip(want, 1e-2, 1e1), rtol=1e-4)
    assert "persistable GpModel" in _got(ranks, d, "save_error")


@pytest.mark.parametrize("d", [4, 1])
@pytest.mark.parametrize("name", ["plain", "kpls"])
def test_realized_model_serves_as_jax(ranks, served, d, name):
    got, want = _got(ranks, d, f"model_{name}"), served[d][name]
    for k in ("l_feed", "gamma_feed"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-10,
                                   atol=1e-10 * np.max(np.abs(want[k])))
    np.testing.assert_allclose(got["likelihood"], want["likelihood"],
                               rtol=1e-9)
    for k in SERVE:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-8,
                                   err_msg=k)


@pytest.mark.parametrize("d", [4, 1])
def test_jax_model_carried_across(ranks, served, d):
    """egobox_tpu's realized model, its arrays gathered, serves the same
    mean and variance on the port's mesh of the same size (1e-10); the
    arrays of another mesh size's layout are refused."""
    want = served[d]["plain"]["valvar"]
    np.testing.assert_allclose(_got(ranks, d, "converted"), want,
                               rtol=1e-10, atol=1e-10 * np.max(np.abs(want)))
    if d == 4:
        assert "feed layout" in _got(ranks, d, "converted_wrong_layout")


@pytest.mark.parametrize("d", [4, 1])
def test_sharded_multistart_matches_jax(ranks, fitted, d):
    """The restarts split over the ranks, the global argmin the only
    collective: the best theta and value of egobox_tpu's (rel 1e-4 and
    1e-8), and fit_gp_multichip's theta (rel 1e-4)."""
    tb, fb = _got(ranks, d, "multistart")
    np.testing.assert_allclose(tb, fitted[d]["multistart"], rtol=1e-4)
    np.testing.assert_allclose(fb, fitted[d]["multistart_f"], rtol=1e-8)
    np.testing.assert_allclose(_got(ranks, d, "multichip_theta"),
                               fitted[d]["multichip"], rtol=1e-4)
