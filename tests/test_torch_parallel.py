"""egobox_torch.parallel on torch.distributed against egobox_tpu.parallel:
the block-cyclic Cholesky, the solves, L^-1 and R^-1, the distributed
likelihood and its gradient, the mesh and the launcher (EgorBatch(mesh=)
is in test_torch_parallel_batch.py).

Four gloo ranks on the CPU, spawned once for the file
(tests/torch_parallel_ranks.py, ``launch.run_ranks``), compute every
case; egobox_tpu computes it on ``make_mesh(4, axis="rows")`` of the
conftest's 8 CPU devices, while the ranks run. Rank 0 then repeats the
cases on its own ``make_mesh(1)``, against egobox_tpu's one-device mesh.
The same mesh size and panel size give the same feed layout, so L and
every feed-row result compare elementwise (the ranks' blocks concatenated
in rank order). float64; n = 32, d = 3, bp = 4 on 4 ranks (8 panels, 2
per rank: the cyclic layout) and 8 on one. Every egobox_tpu call is
jitted: eager shard_map compiles anew at every call.

Tolerances: Cholesky, the three solves, L^-1 and R^-1 rows 1e-10
relative (to the largest entry); likelihood 1e-9; gradient 1e-7 (a second
reduction over the 4 ranks would multiply it by 4).
"""

from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as R
from egobox_tpu import parallel as jpar
from egobox_tpu.parallel.dist_chol import rinv_rows_feed, tri_inverse_feed
from egobox_torch import parallel as tpar
from egobox_torch.parallel.launch import run_ranks

torch.set_num_threads(2)

GRAD_CASES = (
    ("sqexp", "squared_exponential", 0, None),
    ("sqexp_probes", "squared_exponential", 8, None),
    ("matern52", "matern52", 0, None),
    ("kpls_matern32", "matern32", 0, 2),
)
LINALG = ("chol", "solve_lower", "solve_upperT", "linv", "rinv",
          "chol_rows", "solve_rows")


@pytest.fixture(scope="module")
def inputs():
    inp = dict(R.data(), grad_cases=GRAD_CASES)
    # egobox_tpu's fixed probes (gp/likelihood.py _sqexp_dphi_stoch)
    inp["probes"] = np.asarray(jax.random.rademacher(
        jax.random.key(0xE60B0), (R.N, 8), dtype=jnp.float64))
    inp["warm_lhs"] = np.zeros((0, R.NX))  # no warm start in this file
    inp["parts"] = ("linalg",)
    return inp


@pytest.fixture(scope="module")
def ranks(inputs):
    """The ranks' results, a future: they run while egobox_tpu compiles."""
    with ThreadPoolExecutor(1) as ex:
        yield ex.submit(run_ranks, R.run, 4, (inputs,), timeout=120)


def _normalized(x, y):
    xs = (x - x.mean(0)) / x.std(0, ddof=1)
    ys = (y - y.mean(0)) / y.std(0, ddof=1)
    return xs, ys


@pytest.fixture(scope="module")
def expected(inputs, ranks):
    """egobox_tpu's results on its 4- and 1-device meshes."""
    x, y = jnp.asarray(inputs["x"]), jnp.asarray(inputs["y"])
    theta = jnp.asarray(inputs["theta"])
    out = {}
    for d in (4, 1):
        mesh = jpar.make_mesh(d, axis="rows")
        bp = R.BP[d]
        perm = jpar.block_cyclic_perm(R.N, d, bp)
        r, rhs = jnp.asarray(inputs["spd"]), jnp.asarray(inputs["rhs"])

        @jax.jit
        def linalg(r_feed, rhs_feed, r, rhs):
            lf = jpar.cholesky_blockcyclic(mesh, r_feed, bp)
            li = tri_inverse_feed(mesh, lf, bp)
            lr = jpar.cholesky_rowsharded(mesh, r)
            return dict(
                chol=lf,
                solve_lower=jpar.solve_lower_blockcyclic(mesh, lf, rhs_feed,
                                                         bp),
                solve_upperT=jpar.solve_upperT_blockcyclic(mesh, lf,
                                                           rhs_feed, bp),
                linv=li, rinv=rinv_rows_feed(mesh, li, bp), chol_rows=lr,
                solve_rows=jpar.solve_lower_rowsharded(mesh, lr, rhs))

        res = {k: np.asarray(v) for k, v in linalg(
            r[perm], rhs[perm], r, rhs).items()}
        for name, corr, probes, kpls in GRAD_CASES:
            f, g = jpar.make_neg_rlf_distributed(
                mesh, x, y, corr=corr, nugget=R.NUGGET, bp=bp,
                kpls_dim=kpls, grad_probes=probes)
            def value_and_grad(t):
                v, res_t = f(t)
                return v, g(t, res_t)

            v, grad = jax.jit(value_and_grad)(
                jnp.log10(theta[:kpls] if kpls else theta))
            res[f"lik_{name}"] = -float(v)
            res[f"grad_{name}"] = np.asarray(grad)
        res["lik_dist"] = float(jax.jit(
            lambda x, y: jpar.reduced_likelihood_distributed(
                mesh, x, y, theta, corr="matern52", nugget=R.NUGGET))(x, y))
        res["lik_rows"] = float(jpar.reduced_likelihood_rowsharded(
            mesh, x[:-2], y[:-2], theta, corr="matern52", nugget=R.NUGGET))
        xs, ys = _normalized(x, y)
        res["lik_nonpd"] = float(jax.jit(
            lambda xs, ys: jpar.dist_likelihood_parts(
                mesh, xs, ys, theta, corr="squared_exponential",
                nugget=-1.0, bp=bp)[0])(xs, ys))
        res["cross_rows"] = np.asarray(jpar.corr_cross_multichip(
            mesh, "matern52", x, x[:5], theta))
        out[d] = res
    return out


def _got(ranks, d):
    """The ranks' results for mesh size d, feed rows concatenated."""
    res = ranks.result()
    if d == 1:
        return res[0]["linalg_1"]
    per = [r["linalg_4"] for r in res]
    out = dict(per[0])
    for k in LINALG + ("cross_rows",):
        out[k] = np.concatenate([p[k] for p in per])
    return out, per


def _close(got, want, rel):
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * np.max(np.abs(want)))


@pytest.mark.parametrize("d", [4, 1])
@pytest.mark.parametrize("what", LINALG)
def test_factor_and_solves_match_jax(ranks, expected, d, what):
    got = _got(ranks, d)
    got = got[0] if d == 4 else got
    assert got[what].shape == expected[d][what].shape
    _close(got[what], expected[d][what], 1e-10)


@pytest.mark.parametrize("d", [4, 1])
@pytest.mark.parametrize("case", [c[0] for c in GRAD_CASES])
def test_likelihood_and_gradient_match_jax(ranks, expected, d, case):
    """The value to 1e-9, the gradient to 1e-7, the same on every rank."""
    got = _got(ranks, d)
    if d == 4:
        got, per = got
        for p in per[1:]:
            assert p[f"lik_{case}"] == got[f"lik_{case}"]
            np.testing.assert_array_equal(p[f"grad_{case}"],
                                          got[f"grad_{case}"])
    np.testing.assert_allclose(got[f"lik_{case}"],
                               expected[d][f"lik_{case}"], rtol=1e-9)
    np.testing.assert_allclose(got[f"grad_{case}"],
                               expected[d][f"grad_{case}"], rtol=1e-7,
                               atol=1e-7 * np.max(np.abs(
                                   expected[d][f"grad_{case}"])))


@pytest.mark.parametrize("d", [4, 1])
def test_likelihood_entry_points_match_jax(ranks, expected, d):
    """reduced_likelihood_distributed (its own panel size),
    reduced_likelihood_rowsharded (30 rows padded to 32 on 4 ranks), the
    row blocks of corr_cross_multichip, and -inf for a non-PD Gram on
    every rank."""
    got = _got(ranks, d)
    if d == 4:
        got, per = got
        assert all(p["lik_nonpd"] == -np.inf for p in per)
    for k in ("lik_dist", "lik_rows"):
        np.testing.assert_allclose(got[k], expected[d][k], rtol=1e-9)
    assert expected[d]["lik_nonpd"] == -np.inf
    assert got["lik_nonpd"] == -np.inf
    _close(got["cross_rows"], expected[d]["cross_rows"], 1e-12)


def test_block_cyclic_perm_and_panel_size():
    for n, d in ((32, 4), (64, 4), (48, 3), (20000, 1), (4096, 4)):
        bp = tpar.pick_panel_size(n, d)
        assert bp == jpar.pick_panel_size(n, d)
        assert n % (bp * d) == 0
        perm = tpar.block_cyclic_perm(n, d, bp)
        np.testing.assert_array_equal(perm,
                                      jpar.block_cyclic_perm(n, d, bp))
        np.testing.assert_array_equal(np.sort(perm), np.arange(n))
        # rank r's block holds panels r, r + d, ... each contiguous
        blk = perm.reshape(d, -1)
        for r in range(d):
            pans = blk[r].reshape(-1, bp)
            np.testing.assert_array_equal(pans[:, 0] // bp,
                                          np.arange(r, n // bp, d))
            assert np.all(np.diff(pans, axis=1) == 1)
        # one panel per rank: the contiguous layout
        np.testing.assert_array_equal(
            tpar.block_cyclic_perm(n, d, n // d), np.arange(n))
    assert tpar.pick_panel_size(4096, 4) == 256  # 16 panels
    with pytest.raises(ValueError, match="divisible"):
        tpar.cholesky_blockcyclic(SimpleNamespace(size=4, rank=0),
                                  torch.zeros((8, 30)), 4)


def test_mesh_degrades_and_refuses(ranks):
    """make_mesh(8) on a 4-rank group warns and gives 4 ranks; n not
    divisible by the mesh raises ValueError."""
    res = ranks.result()
    for r in res:
        size, msgs = r["degraded"]
        assert size == 4 and any("degrading to a 4-rank mesh" in m
                                 for m in msgs)
        assert all("divisible by mesh size 4" in m
                   for m in r["linalg_4"]["undivided"])


def test_a_failing_rank_surfaces_without_a_hang():
    """A rank that raises while the others wait in an all_reduce: the
    parent raises its traceback at once and stops every rank."""
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 failed(.|\n)*on purpose"):
        run_ranks(R.fail_on_rank1, 3, timeout=60)
    assert time.monotonic() - t0 < 45
