"""EgorBatch of egobox_torch: the port's side of tests/test_batch.py (the
mesh test aside: ``mesh=`` runs on 4 gloo ranks in test_torch_parallel.py).
float64, ``device="cpu"``; the
gates are those of tests/test_batch.py at the same or a smaller depth.
One problem in a batch equals the single-problem fused step on the same
draws (x within 1e-6 of the box width: the same arithmetic, batched).
"""

import numpy as np
import torch

import egobox_torch as egx
from egobox_torch import EgorBatch
from egobox_torch.ego import EgorConfig, EgorSolver, GpConfig

torch.set_num_threads(2)


def xsinx(x):
    x = np.atleast_2d(x)
    return ((x - 3.5) * np.sin((x - 3.5) / np.pi)).reshape(-1, 1)


def xsinx_shift(x):
    x = np.atleast_2d(x)
    return ((x - 4.5) * np.sin((x - 4.5) / np.pi)).reshape(-1, 1)


def quad(x):
    x = np.atleast_2d(x)
    return ((x - 17.0) ** 2 / 10.0 - 5.0).reshape(-1, 1)


def flat(x):
    return np.zeros((np.atleast_2d(x).shape[0], 1))


def _batch(fobj, xl, **kw):
    kw.setdefault("gp_config", GpConfig(n_start=2, max_eval=10))
    return EgorBatch(fobj, xl, device="cpu", **kw)


def test_batch_list_of_problems():
    probs = [xsinx, xsinx_shift, quad]
    eb = _batch(probs, np.array([[0.0, 25.0]]), seed=42, n_start=6,
                gp_config=GpConfig(n_start=3, max_eval=20))
    results = eb.minimize(max_iters=12)
    assert len(results) == 3
    n_doe = eb.default_n_doe()
    for r in results:
        assert r.y_doe.shape[0] == r.x_doe.shape[0]
        assert r.y_opt[0] <= r.y_doe[:n_doe, 0].min() + 1e-12
    assert results[0].y_opt[0] < -14.0
    assert abs(results[2].y_opt[0] - (-5.0)) < 0.5
    assert len(eb.iteration_times) == 12


def test_batch_suggest_ask_tell():
    rng = np.random.default_rng(0)
    x_doe = rng.uniform(0, 25, (3, 6, 1))
    y_doe = np.stack([np.asarray(f(x_doe[b]))
                      for b, f in enumerate([xsinx, xsinx_shift, quad])])
    eb = _batch([xsinx, xsinx_shift, quad], np.array([[0.0, 25.0]]), seed=9,
                n_start=4)
    x_next = eb.suggest(x_doe, y_doe)
    assert x_next.shape == (3, 1)
    assert np.all((x_next >= 0.0) & (x_next <= 25.0))
    for b in range(3):
        assert np.abs(x_doe[b, :, 0] - x_next[b, 0]).min() > 1e-9


class _Draws:
    """The same draws for the batch and the solver: by size, the scaling
    cloud and the seed pool; one fit seed; one subset permutation."""

    def __init__(self, xl):
        rng = np.random.default_rng(8)
        self.by_size = {100: rng.uniform(xl[:, 0], xl[:, 1], (100, 1)),
                        4: rng.uniform(xl[:, 0], xl[:, 1], (4, 1))}

    def lhs(self, n, xlimits, kind=None):
        # the pool's first rows serve any fill of up to 4 points
        return (self.by_size[4][:n] if n <= 4 else self.by_size[n]).copy()

    def fit_draws(self, seed):
        from egobox_torch.gp.fit import FitDraws
        return FitDraws(17)

    # the problem's rng
    def integers(self, lo, hi):
        return 17

    def permutation(self, n):
        return np.arange(n)[::-1].copy()


def test_one_problem_batch_equals_the_fused_step():
    """B = 1 against ``EgorSolver``'s fused step on the same design and
    the same draws: x within 1e-6 of the box width (the same arithmetic
    with a problem axis and parameters per lane, which round otherwise;
    1.5e-7 of the width apart here)."""
    xl = np.array([[0.0, 25.0]])
    x = np.random.default_rng(4).uniform(0, 25, (7, 1))
    y = xsinx(x)
    eb = _batch([xsinx], xl, seed=5, n_start=4)
    eb.draws = _Draws(xl)
    eb._rngs = [eb.draws]
    got = eb.suggest(x[None], y[None])[0]
    solver = EgorSolver(EgorConfig(seed=5, n_start=4,
                                   gp_config=GpConfig(n_start=2,
                                                      max_eval=10)),
                        xl, device="cpu")
    solver.draws = eb.draws
    state = solver.init_state(None, doe=x, y_doe=y)
    state.rng = eb.draws
    want, _, _ = solver.select_next_points(state)
    assert solver.last_times["graph"] == "eager"
    np.testing.assert_allclose(got, want[0], rtol=0, atol=1e-6 * 25.0)


def test_batch_duplicate_proposals_replaced():
    eb = _batch([flat, flat], np.array([[0.0, 1.0]]), seed=3, n_start=3,
                gp_config=GpConfig(n_start=2, max_eval=5))
    results = eb.minimize(max_iters=8)
    n_doe = eb.default_n_doe()
    for r in results:
        assert r.x_doe.shape[0] <= n_doe + 8
        d = np.abs(r.x_doe[:, None, 0] - r.x_doe[None, :, 0])
        np.fill_diagonal(d, 1.0)
        assert d.min() > 0


def test_batch_converged_slots_stop_growing():
    eb = _batch([flat, xsinx], np.array([[0.0, 25.0]]), seed=3, n_start=4,
                gp_config=GpConfig(n_start=2, max_eval=8))
    results = eb.minimize(max_iters=12)
    if eb.converged[0]:
        assert results[0].x_doe.shape[0] < results[1].x_doe.shape[0]
    assert results[1].y_opt[0] < -14.0


def test_batch_lane_compaction(monkeypatch):
    eb = _batch([flat, flat, flat, xsinx], np.array([[0.0, 25.0]]), seed=3,
                n_start=4, gp_config=GpConfig(n_start=2, max_eval=8))
    eb.converged[:3] = True
    results = eb.minimize(max_iters=12)
    assert eb._compactions > 0
    assert results[3].y_opt[0] < -14.0
    for r in results[:3]:
        assert np.all(r.y_opt == 0.0)
    monkeypatch.setenv("EGOBOX_NO_BATCH_COMPACTION", "1")
    eb = _batch([flat, xsinx], np.array([[0.0, 25.0]]), seed=3, n_start=4,
                gp_config=GpConfig(n_start=2, max_eval=8))
    eb.minimize(max_iters=3)
    assert eb._compactions == 0


def test_batch_mixint_integer_portfolio():
    eb = _batch([xsinx, xsinx], [egx.XSpec(egx.XType.INT, [0, 25])],
                seed=42, n_start=6, gp_config=GpConfig(n_start=3,
                                                       max_eval=20))
    results = eb.minimize(max_iters=10)
    for r in results:
        assert np.allclose(r.x_doe, np.round(r.x_doe))
        assert r.y_opt[0] < -13.0


def test_batch_batched_callable_and_per_problem_xlimits():
    def fbatch(x):
        centers = np.array([[5.0], [10.0]])
        return np.sum((x - centers) ** 2, axis=1, keepdims=True)

    xl = np.stack([np.array([[0.0, 20.0]]), np.array([[0.0, 30.0]])])
    eb = _batch(fbatch, xl, seed=0, n_start=4,
                gp_config=GpConfig(n_start=2, max_eval=15))
    results = eb.minimize(max_iters=10)
    assert abs(results[0].x_opt[0] - 5.0) < 1.0
    assert abs(results[1].x_opt[0] - 10.0) < 1.5


def test_batch_feasibility_first_search(monkeypatch):
    monkeypatch.setenv("EGOR_USE_MAX_PROBA_OF_FEASIBILITY", "1")

    def hard(x):  # feasible only for x >= 20
        x = np.atleast_2d(x)
        return np.stack([x[:, 0], 20.0 - x[:, 0]], axis=1)

    def easy(x):  # always feasible
        x = np.atleast_2d(x)
        return np.stack([(x[:, 0] - 17.0) ** 2 / 10.0 - 5.0,
                         -np.ones(x.shape[0])], axis=1)

    kw = dict(n_cstr=1, seed=3, n_start=6,
              gp_config=GpConfig(n_start=3, max_eval=20))
    eb = _batch([hard, easy], np.array([[0.0, 25.0]]), **kw)
    xs = np.array([1.0, 5.0, 10.0, 15.0])
    x_doe = np.stack([xs[:, None], xs[:, None]])
    y_doe = np.stack([hard(xs[:, None]), easy(xs[:, None])])
    xn = eb.suggest(x_doe, y_doe)
    assert xn.shape == (2, 1) and np.all(np.isfinite(xn))
    assert xn[0, 0] > 15.0
    res = _batch([hard, easy], np.array([[0.0, 25.0]]), **kw).minimize(
        max_iters=10)
    assert np.any(res[0].y_doe[:, 1] <= 1e-3)
    assert abs(res[1].y_opt[0] - (-5.0)) < 0.6


def test_batch_fuzz_nan_cases():
    """tests/test_batch.py's NaN fuzz cases: a NaN hole, an all-inf
    initial DoE, a NaN half-domain; the loop imputes and goes on."""
    def holey(x):
        x = np.atleast_2d(x)
        y = (x[:, 0] - 20.0) ** 2 / 10.0
        return np.where((x[:, 0] > 8.0) & (x[:, 0] < 16.0), np.nan, y)[:, None]

    for r in _batch([holey, holey], np.array([[0.0, 25.0]]), seed=11,
                    n_start=4).minimize(max_iters=8):
        assert np.all(np.isfinite(r.y_opt)) and r.y_opt[0] < 2.0

    def needle(x):
        x = np.atleast_2d(x)
        return np.where(x[:, 0] < 0.5, x[:, 0], np.inf)[:, None]

    eb = _batch([needle, needle], np.array([[2.0, 25.0]]), seed=7, n_start=4,
                gp_config=GpConfig(n_start=2, max_eval=8))
    for r in eb.minimize(max_iters=4):
        assert r.x_doe.shape[0] >= eb.default_n_doe()

    def xsinx_nan(x):
        x = np.atleast_2d(x)
        y = xsinx(x)
        y[x[:, 0] < 8.0] = np.nan
        return y

    res = _batch([xsinx_nan, xsinx], np.array([[0.0, 25.0]]), seed=1,
                 n_start=4, gp_config=GpConfig(n_start=2, max_eval=15)
                 ).minimize(max_iters=10)
    assert np.isfinite(res[0].y_doe).all() and res[0].y_opt[0] < -12.0
