"""The lockstep-lane form of egobox_torch's L-BFGS against its one-lane
form and against ``jax.vmap(minimize_lbfgsb)`` of egobox_tpu, float64 on the
CPU.

Tolerances: lanes against the port's one-lane solver atol 1e-12 on x after
5 iterations (the same iterates; sums over a lane axis round differently)
and 1e-9 at convergence, where up to 19 iterations have compounded that
rounding; against JAX x atol 1e-8, ``n_iters`` and ``converged`` equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egobox_tpu.optim.lbfgsb import minimize_lbfgsb as jax_minimize
from egobox_torch.optim import minimize_lbfgsb, multistart_minimize

torch.set_num_threads(2)

K, D = 6, 4
LO = np.full(D, -1.0)
UP = np.array([0.5, 2.0, 2.0, 0.8])


def _rosen_j(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def _rosen_t(x):
    return torch.sum(100.0 * (x[..., 1:] - x[..., :-1] ** 2) ** 2
                     + (1.0 - x[..., :-1]) ** 2, dim=-1)


_A = np.random.default_rng(1).standard_normal((D, D))
_Q = _A @ _A.T + 0.5 * np.eye(D)
_C = np.array([3.0, -2.5, 0.2, 4.0])  # minimum outside the box: active faces


def _quad_j(x):
    r = x - jnp.asarray(_C)
    return 0.5 * r @ jnp.asarray(_Q) @ r


def _quad_t(x):
    r = x - torch.tensor(_C)
    return 0.5 * torch.sum((r @ torch.tensor(_Q)) * r, dim=-1)


PROBLEMS = {"rosenbrock": (_rosen_j, _rosen_t), "quadratic": (_quad_j, _quad_t)}


def _starts(seed=0):
    return np.random.default_rng(seed).uniform(-1.5, 1.5, (K, D))


@pytest.mark.parametrize("problem", sorted(PROBLEMS))
@pytest.mark.parametrize("ls_batch", [0, 8])
@pytest.mark.parametrize("iters", [5, 60])
def test_lanes_match_one_lane_and_jax_vmap(problem, ls_batch, iters):
    fj, ft = PROBLEMS[problem]
    x0 = _starts()
    lo, up = torch.tensor(LO), torch.tensor(UP)
    lanes = minimize_lbfgsb(ft, torch.tensor(x0), lo, up, max_iters=iters,
                            ls_batch=ls_batch)
    for i in range(K):
        one = minimize_lbfgsb(ft, torch.tensor(x0[i]), lo, up,
                              max_iters=iters, ls_batch=ls_batch)
        np.testing.assert_allclose(lanes.x[i].numpy(), one.x.numpy(),
                                   rtol=0, atol=1e-12 if iters == 5 else 1e-9)
        assert int(lanes.n_iters[i]) == one.n_iters
        assert bool(lanes.converged[i]) == one.converged
    rj = jax.vmap(lambda x: jax_minimize(
        fj, x, jnp.asarray(LO), jnp.asarray(UP), max_iters=iters,
        ls_batch=ls_batch))(jnp.asarray(x0))
    np.testing.assert_allclose(lanes.x.numpy(), np.asarray(rj.x), rtol=0,
                               atol=1e-8)
    np.testing.assert_array_equal(lanes.n_iters.numpy(),
                                  np.asarray(rj.n_iters))
    np.testing.assert_array_equal(lanes.converged.numpy(),
                                  np.asarray(rj.converged))
    if problem == "quadratic" and iters == 60:
        # the minimum lies on active faces of the box
        x = lanes.x.numpy()
        assert np.all((x == LO) | (x == UP), axis=0).any()
        assert bool(lanes.converged.all())


def test_per_lane_bounds_and_early_lane_keeps_its_x():
    """Bounds of shape (k, d); a lane that starts at its minimum is done
    after one iteration and keeps that x while the others run."""
    x0 = _starts(3)
    x0[2] = 1.0  # Rosenbrock's minimum, inside lane 2's box
    lo = np.tile(LO, (K, 1))
    up = np.tile(UP, (K, 1))
    up[2] = 1.5
    res = minimize_lbfgsb(_rosen_t, torch.tensor(x0), torch.tensor(lo),
                          torch.tensor(up), max_iters=40, ls_batch=8)
    assert int(res.n_iters[2]) == 1 and bool(res.converged[2])
    np.testing.assert_array_equal(res.x[2].numpy(), np.ones(D))
    assert int(res.n_iters.max()) > 5
    for i in (0, 5):
        one = minimize_lbfgsb(_rosen_t, torch.tensor(x0[i]),
                              torch.tensor(lo[i]), torch.tensor(up[i]),
                              max_iters=40, ls_batch=8)
        np.testing.assert_allclose(res.x[i].numpy(), one.x.numpy(), rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("ls_batch", [0, 8])
def test_nan_objective_backs_away(ls_batch):
    """NaN beyond x0 > 0.5 counts as +inf: the search backs away from it
    and still reaches the minimum at 0.4 (lane 0) or stops at the edge of
    the valid region; a lane that starts inside the NaN region is done at
    once with an infinite value."""
    def fun(x):
        f = torch.sum((x - 0.4) ** 2, dim=-1)
        return torch.where(x[..., 0] > 0.5, torch.full_like(f, torch.nan), f)

    x0 = torch.tensor([[-1.0, 1.0], [0.45, -1.0], [0.9, 0.0]],
                      dtype=torch.float64)
    lo = torch.full((2,), -2.0, dtype=torch.float64)
    res = minimize_lbfgsb(fun, x0, lo, -lo, max_iters=30, ls_batch=ls_batch)
    np.testing.assert_allclose(res.x[:2].numpy(), 0.4, atol=1e-6)
    assert torch.isinf(res.fun[2]) and int(res.n_iters[2]) == 1
    np.testing.assert_array_equal(res.x[2].numpy(), x0[2].numpy())


def test_deeper_rounds_reach_small_steps():
    """An ill-scaled objective (a first step of 4e4 against a box of 4)
    needs a step below 2^-14: the speculative search of width 4 finds it in
    its fourth round, as the sequential search does."""
    def fun(x):
        return torch.sum(1e4 * x ** 4 + x ** 2, dim=-1)

    x0 = torch.full((3, 2), 1.0, dtype=torch.float64)
    lo = torch.full((2,), -2.0, dtype=torch.float64)
    spec = minimize_lbfgsb(fun, x0, lo, -lo, max_iters=3, ls_batch=4)
    seq = minimize_lbfgsb(fun, x0, lo, -lo, max_iters=3, ls_batch=0)
    assert bool((spec.fun < fun(x0)).all()) and bool((seq.fun < fun(x0)).all())
    rj = jax.vmap(lambda x: jax_minimize(
        lambda z: jnp.sum(1e4 * z ** 4 + z ** 2), x, jnp.full(2, -2.0),
        jnp.full(2, 2.0), max_iters=3, ls_batch=4))(jnp.ones((3, 2)))
    np.testing.assert_allclose(spec.x.numpy(), np.asarray(rj.x), atol=1e-10)


def test_multistart_minimize_picks_the_best_lane():
    x0 = torch.tensor(_starts(5))
    x, f, res = multistart_minimize(_rosen_t, x0, torch.tensor(LO),
                                    torch.tensor(UP), max_iters=30,
                                    ls_batch=8)
    assert float(f) == float(res.fun.min())
    np.testing.assert_array_equal(x.numpy(),
                                  res.x[int(res.fun.argmin())].numpy())


def test_lanes_refuse_the_residual_interface():
    x0 = torch.zeros((2, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="one lane"):
        minimize_lbfgsb(None, x0, x0[0] - 1, x0[0] + 1,
                        fun_and_res=lambda x: (x.sum(), ()),
                        grad_from_res=lambda x, r: x)


# ---------------------------------------------------------------------------
# L-BFGS without host reads
# ---------------------------------------------------------------------------


def _lanes_problem():
    """Five lanes: quadratic bowls of different conditioning (they finish
    at different iterations), a lane already at its optimum, and a lane
    whose first step overshoots by 1e6 (every trial of the first rounds
    is worse, so it needs every deeper round)."""
    scale = torch.tensor([1.0, 30.0, 1e3, 1.0, 1e6], dtype=torch.float64)
    center = torch.tensor([[0.3, -0.2], [0.5, 0.5], [-0.7, 0.1],
                           [0.0, 0.0], [0.2, 0.2]], dtype=torch.float64)
    x0 = torch.tensor([[1.5, 1.0], [-1.0, 2.0], [0.9, -1.5], [0.0, 0.0],
                       [1.2, 1.2]], dtype=torch.float64)

    def fun(x):
        lanes_first = x.ndim == 3
        s = scale[:, None] if lanes_first else scale
        c = center[:, None, :] if lanes_first else center
        d = x - c
        return s * torch.sum(d * d, dim=-1) + 0.1 * torch.sum(d**4, dim=-1)

    return fun, x0


@pytest.mark.parametrize("ls_batch", [1, 8])
def test_graph_safe_lbfgs_equals_flag_reading(ls_batch):
    fun, x0 = _lanes_problem()
    lo = torch.full((2,), -2.0, dtype=torch.float64)
    up = torch.full((2,), 2.0, dtype=torch.float64)
    kw = dict(max_iters=40, ls_batch=ls_batch)
    a = minimize_lbfgsb(fun, x0, lo, up, **kw)
    b = minimize_lbfgsb(fun, x0, lo, up, graph_safe=True, **kw)
    np.testing.assert_allclose(b.x.numpy(), a.x.numpy(), rtol=1e-12,
                               atol=0)
    np.testing.assert_allclose(b.fun.numpy(), a.fun.numpy(), rtol=1e-12,
                               atol=0)
    assert torch.equal(a.n_iters, b.n_iters)
    assert torch.equal(a.converged, b.converged)
    # lanes finish at different iterations, some before the budget
    assert len(set(a.n_iters.tolist())) > 2 and int(a.n_iters.min()) < 40
    with pytest.raises(ValueError, match="lockstep"):
        minimize_lbfgsb(lambda x: fun(x[None])[0], x0[0], lo, up,
                             graph_safe=True)


# ---------------------------------------------------------------------------
# The fused trial of the one-lane sequential search
# ---------------------------------------------------------------------------


def host_search(fun):
    """``fun`` as the residual interface: ``minimize_lbfgsb`` then runs the
    search that reads each trial's value, Armijo term and step on the host
    (three reads a trial), as the plain objective ran before its trials were
    fused. It evaluates the start's value apart from its gradient: one call
    more than the plain objective."""
    def fun_and_res(x):
        with torch.no_grad():
            return fun(x), ()

    def grad_from_res(x, res):
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(fun(xx), xx)
        return g

    return dict(fun_and_res=fun_and_res, grad_from_res=grad_from_res)


class _Counted:
    """The objective, with its calls counted as trials (no autograd) and
    gradients."""

    def __init__(self, fun):
        self.fun, self.trials, self.grads = fun, 0, 0

    def __call__(self, x):
        if torch.is_grad_enabled():
            self.grads += 1
        else:
            self.trials += 1
        return self.fun(x)


def _quad1(x):
    return torch.sum((x - 0.3) ** 2 + 0.1 * x ** 4)


def _nan_beyond(x):
    f = torch.sum((x - 0.4) ** 2)
    return torch.where(x[0] > 0.5, torch.full_like(f, torch.nan), f)


def _kink_at_the_bound(x):
    # every trial lands 5e-13 from the start, on a cliff: Armijo fails and
    # the search stops on xtol (1e-12)
    return torch.sum(-x + 1e3 * torch.relu(x - (1.0 - 2.5e-13)))


def _flat_f32(x):
    # in float32 the first trials' decrease (1e-9) is lost to rounding,
    # and in float64 their Armijo term (1e-13) is not: they fail
    return torch.sum(1.0 + 3.16e-5 * (x - 0.5) ** 2)


#: name -> (objective, x0, lower, upper, dtype, xtol)
FUSED_PROBLEMS = {
    "quad-1d": (_quad1, [1.7], [-2.0], [2.0], torch.float64, 1e-12),
    "rosenbrock-2d": (_rosen_t, [-1.2, 1.0], [-2.0, -2.0], [2.0, 2.0],
                      torch.float64, 1e-12),
    "nan-region-2d": (_nan_beyond, [-1.0, 1.0], [-2.0, -2.0], [2.0, 2.0],
                      torch.float64, 1e-12),
    "xtol-1d": (_kink_at_the_bound, [1.0 - 5e-13], [0.0], [1.0],
                torch.float64, 1e-12),
    "quad-2d-xtol": (_quad_t, [1.0, -1.0, 0.5, 0.0], LO, UP, torch.float64,
                     1e-3),
    "rosenbrock-2d-f32": (_rosen_t, [-1.2, 1.0], [-2.0, -2.0], [2.0, 2.0],
                          torch.float32, 1e-12),
    "flat-1d-f32": (_flat_f32, [0.0], [-1.0], [1.0], torch.float32, 1e-12),
}


@pytest.mark.parametrize("name", sorted(FUSED_PROBLEMS))
def test_fused_trial_search_equals_the_host_search(name):
    """The one-lane plain objective's search on the fused trial (one packed
    read a trial) against the search that reads each test on the host:
    the same x, value, iterations, convergence and objective calls. A NaN
    trial counts as +inf in both; the kinked problem stops on xtol."""
    fun, x0, lo, up, dtype, xtol = FUSED_PROBLEMS[name]

    def t(v):
        return torch.tensor(v, dtype=dtype)

    kw = dict(max_iters=40, xtol=xtol)
    fused, host = _Counted(fun), _Counted(fun)
    a = minimize_lbfgsb(fused, t(x0), t(lo), t(up), **kw)
    b = minimize_lbfgsb(None, t(x0), t(lo), t(up), **kw, **host_search(host))
    assert torch.equal(a.x, b.x) and torch.equal(a.fun, b.fun)
    assert a.x.dtype == dtype and a.fun.dtype == dtype
    assert (a.n_iters, a.converged) == (b.n_iters, b.converged)
    assert (fused.trials, fused.grads) == (host.trials - 1, host.grads)
    assert fused.trials >= a.n_iters >= 1
    if name == "nan-region-2d":
        # the first trials land in the NaN region and back away from it
        assert fused.trials > a.n_iters and bool(torch.isfinite(a.fun))
    if name == "flat-1d-f32":
        assert a.n_iters == 1 and fused.trials > 1
    if name == "xtol-1d":
        assert (a.n_iters, fused.trials, a.converged) == (1, 1, True)
        assert torch.equal(a.x, t(x0))


def test_trials_take_one_lane_and_the_sequential_search():
    from egobox_torch.optim.lbfgsb import FusedTrial

    x0 = torch.zeros((2, 2), dtype=torch.float64)
    lo, up = x0[0] - 1, x0[0] + 1
    trials = FusedTrial(_quad_t)
    for args, kw in [((_quad_t, x0), {}), ((_quad_t, x0[0]), dict(ls_batch=8)),
                     ((None, x0[0]), host_search(_quad1))]:
        with pytest.raises(ValueError, match="trials takes one lane"):
            minimize_lbfgsb(*args, lo, up, trials=trials, **kw)
