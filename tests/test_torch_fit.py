"""The ported fit recipes that draw random numbers, against egobox_tpu:
the multi-fidelity recipe of the slice, the full-data polish (line search
and trust region) and LHS-seeded multistarts. JAX's draws are handed to the
port (torch's streams never reproduce threefry); float64 on numpy inputs.

Tolerances: theta rel 1e-5, likelihood rel 1e-8, predict and variance atol
1e-8, on well-posed fits (nugget 1e-6, or the recipe's 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egobox_tpu import gp as jgp
from egobox_tpu.doe.lhs import maximin_lhs as jax_maximin_lhs
from egobox_torch import gp as tgp
from egobox_torch.gp import fit as tfit
from test_torch_gp import _assert_same_model, _data

torch.set_num_threads(2)


class _JaxDraws:
    """Replays egobox_tpu's draws in the order the port asks for them."""

    def __init__(self, perms, lhs):
        self.perms, self.lhs = list(perms), list(lhs)

    def permutation(self, n, device):
        return torch.from_numpy(np.array(self.perms.pop(0))).to(device)

    def lhs_seeds(self, n_start, dim, dtype, device):
        return torch.from_numpy(np.array(self.lhs.pop(0))).to(dtype=dtype,
                                                    device=device)


def _inject_jax_draws(monkeypatch, seed, n, sub_draws, n_start, dim,
                      sub_m2=False):
    """The subsample permutations and LHS seeds of egobox_tpu's
    multi-fidelity recipe (gp/fit.py _fit_mf_fused key stream; with
    ``sub_m2`` its second-fidelity draw last; ``sub_draws=1`` is also the
    stream of the rank_warmstart recipe, whose seeds are max(n_start, 3))."""
    key = jax.random.key(seed)
    ksub, key = jax.random.split(key)
    if sub_draws == 1 and not sub_m2:
        pkeys, lkeys = [ksub], [key]
    else:
        dkeys = jax.random.split(ksub, 2 * sub_draws)
        pkeys, lkeys = list(dkeys[:sub_draws]), list(dkeys[sub_draws:])
        if sub_m2:
            k2d, k2f = jax.random.split(jax.random.fold_in(ksub, 7))
            pkeys.append(k2d)
            lkeys.append(k2f)
    perms = [np.asarray(jax.random.permutation(k, n)) for k in pkeys]
    lhs = [np.asarray(jax_maximin_lhs(k, n_start, dim, False, 5,
                                      jnp.float64)) for k in lkeys]
    monkeypatch.setattr(tfit, "_recipe_draws",
                        lambda s, *a: _JaxDraws(perms, lhs))


@pytest.mark.parametrize("kw", [dict(sub_draws=1), dict(sub_draws=2),
                                dict(sub_draws=2, subsample_warmstart2=150),
                                dict(sub_draws=1, rank_warmstart=200)],
                         ids=["one-draw", "two-draws", "second-fidelity",
                              "ranked"])
def test_subsample_recipes_draw_as_jax(kw):
    """No draws handed in: the port's subsample recipes draw egobox_tpu's
    threefry key stream (``gp.fit._recipe_draws``), so ``fit_gp(seed=5)``
    fits egobox_tpu's model (the tolerances of ``_assert_same_model``)."""
    x, y = _data(300, 3, 2)
    x_test = np.random.default_rng(3).uniform(-2.0, 2.0, (25, 3))
    common = dict(corr="matern52", n_start=1, max_iters=4, nugget=1e-3,
                  subsample_warmstart=100, polish_iters=1, polish_tr=True,
                  seed=5, **kw)
    mt = tgp.fit_gp(x, y, device="cpu", **common)
    mj = jgp.fit_gp(x, y, **common)
    _assert_same_model(mt, mj, x_test)


def test_multi_fidelity_recipe_matches_jax(monkeypatch):
    """The slice's recipe in miniature: 2 subsample draws of 100 points,
    1+1 restarts x 4 iterations each, one trust-region polish iteration of
    both candidates on the 300 points."""
    x, y = _data(300, 3, 2)
    x_test = np.random.default_rng(3).uniform(-2.0, 2.0, (25, 3))
    kw = dict(corr="matern52", n_start=1, max_iters=4, nugget=1e-3,
              subsample_warmstart=100, sub_draws=2, polish_iters=1,
              polish_tr=True, seed=5)
    _inject_jax_draws(monkeypatch, 5, 300, 2, 1, 3)
    mt = tgp.fit_gp(x, y, device="cpu", **kw)
    mj = jgp.fit_gp(x, y, **kw)
    _assert_same_model(mt, mj, x_test)


@pytest.mark.parametrize("polish_tr", [False, True])
def test_polish_matches_jax(polish_tr, monkeypatch):
    """One subsample draw, then a 3-iteration full-data polish by line
    search or trust region; the trust-region polish must also reach the
    line-search polish's likelihood (tests/test_lbfgsb.py)."""
    rng = np.random.default_rng(11)
    x = rng.uniform(-2.0, 2.0, (600, 4))
    y = (np.sum(np.sin(2.0 * x), axis=1)
         + 0.1 * rng.standard_normal(600))[:, None]
    x_test = rng.uniform(-2.0, 2.0, (20, 4))
    kw = dict(n_start=1, max_iters=6, nugget=1e-6, subsample_warmstart=200,
              polish_iters=3, seed=2)
    _inject_jax_draws(monkeypatch, 2, 600, 1, 1, 4)
    mt = tgp.fit_gp(x, y, polish_tr=polish_tr, device="cpu", **kw)
    mj = jgp.fit_gp(x, y, polish_tr=polish_tr, **kw)
    _assert_same_model(mt, mj, x_test)
    if polish_tr:
        _inject_jax_draws(monkeypatch, 2, 600, 1, 1, 4)
        lk_ls = float(tgp.fit_gp(x, y, device="cpu", **kw).likelihood)
        lk_tr = float(mt.likelihood)
        assert lk_tr >= lk_ls - 0.005 * abs(lk_ls), (lk_ls, lk_tr)


def test_multistart_kpls_masked_matches_jax(monkeypatch):
    """n_start LHS restarts (JAX's seeds injected), KPLS, a linear trend
    and a padded design in one fit."""
    x, y = _data(60, 4, 4)
    xp = np.concatenate([x, np.zeros((8, 4))])
    yp = np.concatenate([y, np.zeros(8)])
    mask = np.arange(68) < 60
    key = jax.random.key(9)
    seeds = np.asarray(jax_maximin_lhs(key, 3, 2, False, 5, jnp.float64))
    monkeypatch.setattr(tfit, "_fit_draws",
                        lambda s: _JaxDraws([], [seeds]))
    kw = dict(corr="matern32", trend="linear", kpls_dim=2, n_start=3,
              max_iters=15, seed=9, mask=mask, nugget=1e-6)
    mt = tgp.fit_gp(xp, yp, device="cpu", **kw)
    mj = jgp.fit_gp(xp, yp, **kw)
    x_test = np.random.default_rng(5).uniform(-2.0, 2.0, (10, 4))
    _assert_same_model(mt, mj, x_test)


@pytest.mark.parametrize("ls_batch", [0, 8])
@pytest.mark.parametrize("corr,kpls_dim", [
    ("matern52", None), ("absolute_exponential", None),
    ("squared_exponential", None), ("matern32", 2)])
def test_lanes_at_once_match_lane_after_lane_and_jax(corr, kpls_dim, ls_batch,
                                                     monkeypatch):
    """A multistart fit (1 + 3 restarts, JAX's seeds injected) with the
    restarts as lockstep lanes on a stack of thetas, as ``fit_gp_core``
    runs an unmasked small design, against the same fit lane after lane
    (``_LANES_MAX_POINTS`` = 0: theta rel 1e-8, likelihood rel 1e-10) and against
    egobox_tpu's vmapped fit (``_assert_same_model``)."""
    x, y = _data(40, 3, 7)
    dim = kpls_dim or 3
    key = jax.random.key(4)
    seeds = np.asarray(jax_maximin_lhs(key, 3, dim, False, 5, jnp.float64))
    monkeypatch.setattr(tfit, "_fit_draws", lambda s: _JaxDraws([], [seeds]))
    kw = dict(corr=corr, kpls_dim=kpls_dim, n_start=3, max_iters=12, seed=4,
              nugget=1e-6, ls_batch=ls_batch)
    calls = []
    real = tfit.minimize_lbfgsb

    def spy(fun, x0, *a, **k):
        calls.append(tuple(x0.shape))
        return real(fun, x0, *a, **k)

    monkeypatch.setattr(tfit, "minimize_lbfgsb", spy)
    at_once = tgp.fit_gp(x, y, device="cpu", **kw)
    assert calls == [(4, dim)]
    calls.clear()
    monkeypatch.setattr(tfit, "_LANES_MAX_POINTS", 0)
    one_by_one = tgp.fit_gp(x, y, device="cpu", **kw)
    assert calls == [(dim,)] * 4
    np.testing.assert_allclose(at_once.theta.numpy(),
                               one_by_one.theta.numpy(), rtol=1e-8)
    np.testing.assert_allclose(float(at_once.likelihood),
                               float(one_by_one.likelihood), rtol=1e-10)
    mj = jgp.fit_gp(x, y, **kw)
    x_test = np.random.default_rng(8).uniform(-2.0, 2.0, (10, 3))
    _assert_same_model(at_once, mj, x_test)


def _recording_trial_graphs(monkeypatch):
    """The statistics of every ``TrialGraph`` the fits make."""
    made = []
    real = tfit.TrialGraph

    def record(fun):
        trials = real(fun)
        made.append(trials.stats)
        return trials

    monkeypatch.setattr(tfit, "TrialGraph", record)
    return made


def test_fused_trials_fit_as_the_host_search(monkeypatch):
    """A 300-point float64 fit on the benchmark's likelihood (KPLS-1
    squared exponential, Griewank in d = 10 on +-600, constant trend,
    nugget 100 eps), restart after restart: with its line-search trials
    through one ``TrialGraph`` (eagerly on the CPU, one eager trial a
    trial, no capture), the theta and likelihood of the search that reads
    each trial's tests on the host."""
    from test_torch_lbfgsb import _Counted, host_search

    rng = np.random.default_rng(20261018)
    x = rng.uniform(-600.0, 600.0, (300, 10))
    y = (1.0 + np.sum(x**2, axis=1) / 4000.0
         - np.prod(np.cos(x / np.sqrt(np.arange(1, 11))), axis=1))
    kw = dict(corr="squared_exponential", kpls_dim=1, seed=3, device="cpu",
              nugget=100 * np.finfo(np.float64).eps)
    monkeypatch.setattr(tfit, "_LANES_MAX_POINTS", 0)
    made = _recording_trial_graphs(monkeypatch)
    fused = tgp.fit_gp(x, y, **kw)
    assert len(made) == 1
    stats = made[0]
    assert stats.captures == stats.replays == 0 and stats.eager > 0

    real = tfit.minimize_lbfgsb
    counted = []

    def on_the_host(fun, x0, lo, up, trials=None, **k):
        counted.append(_Counted(fun))
        return real(None, x0, lo, up, **k, **host_search(counted[-1]))

    monkeypatch.setattr(tfit, "minimize_lbfgsb", on_the_host)
    host = tgp.fit_gp(x, y, **kw)
    assert torch.equal(fused.theta, host.theta)
    assert float(fused.likelihood) == float(host.likelihood)
    assert len(counted) == 11  # the init and 10 restarts
    assert stats.eager == sum(c.trials - 1 for c in counted)


def test_only_the_lane_after_lane_search_makes_a_trial_graph(monkeypatch):
    """Lockstep lanes (a small design, or ``graph_safe``), the residual
    route and the speculative search (``ls_batch`` > 1) make no
    ``TrialGraph``; a fit restart after restart makes one."""
    x, y = _data(40, 3, 7)
    made = _recording_trial_graphs(monkeypatch)
    kw = dict(n_start=2, max_iters=5, nugget=1e-6, device="cpu")
    tgp.fit_gp(x, y, **kw)
    tgp.fit_gp(x, y, ls_batch=8, **kw)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)[:, None]
    one = torch.ones(3, dtype=torch.float64)
    args = (xt, yt, torch.ones(40, dtype=torch.bool), 0.1 * one, 1e-2 * one,
            1e1 * one, torch.ones(3, dtype=torch.bool), tfit.FitDraws(1))
    tfit.fit_gp_core(*args, n_start=2, max_iters=5, nugget=1e-6,
                     graph_safe=True)
    monkeypatch.setattr(tfit, "_LANES_MAX_POINTS", 0)
    tfit.fit_gp_core(*args, n_start=2, max_iters=5, nugget=1e-6,
                     residual_api=True)
    tgp.fit_gp(x, y, ls_batch=8, **kw)
    assert made == []
    tgp.fit_gp(x, y, **kw)
    assert len(made) == 1 and made[0].eager > 0
