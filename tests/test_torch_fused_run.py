"""The traced whole run of egobox_torch (ego/fused_run.py): the port's side
of tests/test_fused_run.py. float64, ``device="cpu"``: the objective is
written in torch operations and runs where the surrogates run. The gates
are those of tests/test_fused_run.py; the xsinx golden is held in y at
20 iterations, as tests/test_torch_ego.py holds the host loop's.
"""

import numpy as np
import pytest
import torch

from egobox_torch.ego import Egor
from egobox_torch.ego import fused_run
from egobox_torch.types import ConstraintStrategy, QInfillStrategy

torch.set_num_threads(2)


def xsinx_t(x):
    return (x - 3.5) * torch.sin((x - 3.5) / np.pi)


def xsinx_np(x):
    x = np.atleast_2d(x)
    return ((x - 3.5) * np.sin((x - 3.5) / np.pi)).reshape(-1, 1)


def g24_t(p):
    x1, x2 = p[:, :1], p[:, 1:2]
    c1 = -2.0 * x1**4 + 8.0 * x1**3 - 8.0 * x1**2 + x2 - 2.0
    c2 = (-4.0 * x1**4 + 32.0 * x1**3 - 88.0 * x1**2 + 96.0 * x1 + x2
          - 36.0)
    return torch.cat([-x1 - x2, c1, c2], dim=1)


G24 = dict(n_cstr=2, cstr_strategy=ConstraintStrategy.UTB,
           cstr_tol=np.array([2e-6, 2e-6]), n_doe=10)


def _egor(xl=((0.0, 25.0),), **kw):
    return Egor([list(r) for r in xl], device="cpu", traced_run=True, **kw)


def test_traced_run_xsinx_golden():
    """20 iterations at seed 2: y = -15.125 within 1e-3 and x = 18.935
    within 1e-3 (seed 42's traced stream ends at x = 18.9319, y met)."""
    egor = _egor(seed=2)
    res = egor.minimize(xsinx_t, max_iters=20)
    assert abs(res.y_opt[0] + 15.125) < 1e-3
    assert abs(res.x_opt[0] - 18.935) < 1e-3
    assert res.x_doe.shape == (25, 1)
    assert sum(c["iterations"] for c in egor.iteration_times) == 20
    # the cold fit runs alone in the first chunk
    assert egor.iteration_times[0]["iterations"] == 1


def test_traced_run_g24_constrained():
    egor = _egor(((0.0, 3.0), (0.0, 4.0)), seed=42, **G24)
    res = egor.minimize(g24_t, max_iters=6)
    assert res.y_opt[0] < -5.2
    assert res.y_opt[1] < 1e-2 and res.y_opt[2] < 1e-2


def test_traced_run_target_stop():
    egor = _egor(seed=3, n_doe=5, target=-14.0)
    res = egor.minimize(xsinx_t, max_iters=16)
    assert res.y_opt[0] < -14.0
    assert res.x_doe.shape[0] < 5 + 16


def test_traced_run_imputes_nonfinite():
    def nan_region(x):
        return torch.where(x > 20.0, torch.full_like(x, torch.nan),
                           xsinx_t(x))

    egor = _egor(seed=7, n_doe=5)
    res = egor.minimize(nan_region, max_iters=8)
    assert np.isfinite(res.y_doe).all()
    assert res.y_opt[0] < -10.0


def test_impute_row_matches_the_host_rule():
    """The device imputation is the host's max + 3 sigma penalty (with the
    population deviation of the active rows, as egobox_tpu's)."""
    yb = torch.tensor([[1.0, 2.0], [3.0, -1.0], [0.0, 0.0]],
                      dtype=torch.float64)
    mask = torch.tensor([True, True, False])
    got = fused_run._impute_row(torch.tensor([torch.nan, 5.0],
                                             dtype=torch.float64), yb, mask)
    assert float(got[1]) == 5.0
    assert float(got[0]) == pytest.approx(3.0 + 3.0 * 1.0)


def test_traced_run_q_points_batch():
    egor = _egor(seed=42, n_doe=5, q_points=2)
    assert egor._use_traced_run(xsinx_t, (), None)
    res = egor.minimize(xsinx_t, max_iters=6)
    assert res.y_opt[0] < -14.0
    assert 7 < res.x_doe.shape[0] <= 5 + 2 * 6
    assert np.isfinite(res.y_doe).all()


def test_traced_run_q_points_constrained_clmin():
    egor = _egor(((0.0, 3.0), (0.0, 4.0)), seed=42, q_points=2,
                 q_infill_strategy=QInfillStrategy.CLMIN, **G24)
    res = egor.minimize(g24_t, max_iters=3)
    assert res.y_opt[0] < -5.0
    assert res.y_opt[1] < 1e-2 and res.y_opt[2] < 1e-2


def test_traced_run_q_optmod():
    egor = _egor(seed=42, n_doe=5, q_optmod=3)
    assert egor._use_traced_run(xsinx_t, (), None)
    res = egor.minimize(xsinx_t, max_iters=8)
    assert res.y_opt[0] < -14.0
    assert abs(res.x_opt[0] - 18.935) < 1.5


def test_traced_run_trego():
    egor = _egor(seed=42, n_doe=5, trego=True)
    assert egor._use_traced_run(xsinx_t, (), None)
    res = egor.minimize(xsinx_t, max_iters=10)
    assert res.y_opt[0] < -14.5
    assert abs(res.x_opt[0] - 18.935) < 1.0
    # the scheduler state came back to the host
    assert egor.solver.config.trego.activated


def test_traced_run_traceable_fcstrs():
    """A constraint in torch operations runs in the program: xsinx s.t.
    x <= 18 (tests/test_fused_run.py::test_traced_run_traceable_fcstrs)."""
    def cstr_x_le_18(x):
        return x.reshape(-1)[0] - 18.0

    egor = _egor(seed=42, n_doe=5)
    res = egor.minimize(xsinx_t, fcstrs=[cstr_x_le_18], max_iters=8)
    true_y = float(xsinx_np(np.array([[18.0]]))[0, 0])
    assert res.x_opt[0] <= 18.0 + 1e-2
    assert abs(res.y_opt[0] - true_y) < 0.5


def test_traced_run_falls_back_for_host_objective():
    """A numpy objective is a host callback: the gate takes the host loop,
    which evaluates once per iteration."""
    calls = []

    def host_obj(x):
        x = np.atleast_2d(np.asarray(x))
        calls.append(x.shape[0])
        return xsinx_np(x)

    egor = _egor(seed=5, n_doe=5)
    assert not egor._use_traced_run(host_obj, (), None)
    res = egor.minimize(host_obj, max_iters=4)
    assert len(calls) >= 2
    assert res.y_opt[0] < -10.0
    assert "select" in egor.iteration_times[0]


def test_traced_run_env_kill_switch(monkeypatch):
    monkeypatch.setenv("EGOBOX_TRACED_RUN", "0")
    egor = _egor(seed=5, n_doe=5)
    assert not egor._use_traced_run(xsinx_t, (), None)
    monkeypatch.setenv("EGOBOX_TRACED_RUN", "1")
    plain = Egor([[0.0, 25.0]], seed=5, n_doe=5, device="cpu")
    assert plain._use_traced_run(xsinx_t, (), None)


def test_traced_run_gate_excludes():
    egor = _egor(seed=5, n_doe=5, n_clusters=2)
    assert not egor._use_traced_run(xsinx_t, (), None)


def test_traced_run_repeats_with_its_seed():
    r1 = _egor(seed=9, n_doe=5).minimize(xsinx_t, max_iters=6)
    r2 = _egor(seed=9, n_doe=5).minimize(xsinx_t, max_iters=6)
    np.testing.assert_array_equal(r1.x_doe, r2.x_doe)


class _JaxTracedDraws:
    """egobox_tpu's draws of a traced run in the order the port takes them
    (fit seeds, picker, scaling cloud per step): one base key per chunk
    from the solver's key chain, step j's keys ``split(fold_in(base, j),
    3)`` (ego/fused_run.py), for chunks of ``sched`` steps."""

    def __init__(self, seed, sched):
        import jax

        key = jax.random.key(seed)
        self.bases = []
        for _ in sched:
            key, sub = jax.random.split(key)
            self.bases.append(sub)
        self.sched, self.step = sched, 0

    def _keys(self):
        import jax

        s = self.step
        for c, k in enumerate(self.sched):
            if s < k:
                return jax.random.split(jax.random.fold_in(self.bases[c], s),
                                        3)
            s -= k
        raise IndexError("more steps than the schedule holds")

    def fit_draws(self, seed):
        import jax.numpy as jnp

        from egobox_tpu.doe.lhs import maximin_lhs

        kfit = self._keys()[0]

        class _Fit:
            def lhs_seeds(self, n, dim, dtype, device):
                return torch.from_numpy(np.array(maximin_lhs(
                    kfit, n, dim, False, 5, jnp.float64)))

        return _Fit()

    def picker(self, nb, n_start, nx):
        import jax
        import jax.numpy as jnp

        from egobox_tpu.doe.lhs import maximin_lhs

        ksub, kfill = jax.random.split(self._keys()[2])
        return (np.array(jax.random.uniform(ksub, (nb,), dtype=jnp.float64)),
                np.array(maximin_lhs(kfill, n_start, nx, False, 5,
                                     jnp.float64)))

    def lhs(self, n, xlimits, kind=None):
        import jax.numpy as jnp

        from egobox_tpu.doe.lhs import LhsKind, lhs_normalized

        pts = np.array(lhs_normalized(self._keys()[1], n, xlimits.shape[0],
                                      LhsKind.MAXIMIN, jnp.float64))
        self.step += 1
        return pts * (xlimits[:, 1] - xlimits[:, 0]) + xlimits[:, 0]


def test_traced_xsinx_bucket_32_x_gate_follows_the_draws(monkeypatch):
    """The x gate of the traced xsinx at bucket 32 is a property of the
    draw stream, not of the port's pad or picker: at seed 3 the port's own
    stream ends at x = 18.93306 (1.9e-3 off, the gate is 1e-3) where
    egobox_tpu's ends at 18.93521; from egobox_tpu's DoE and with its draws
    handed in, the port meets the gate as egobox_tpu does."""
    import jax.numpy as jnp

    import egobox_tpu as jegx

    monkeypatch.setenv("EGOBOX_SHAPE_BUCKET", "32")

    def xsinx_j(x):
        return (x - 3.5) * jnp.sin((x - 3.5) / jnp.pi)

    doe = np.array([[21.70194242], [0.00866018], [13.35301784],
                    [17.34547325], [8.25618931]])  # egobox_tpu's, seed 3
    rj = jegx.Egor([[0.0, 25.0]], seed=3, traced_run=True, doe=doe).minimize(
        xsinx_j, max_iters=20)
    egor = _egor(seed=3, doe=doe)
    egor.solver.draws = _JaxTracedDraws(3, [1, 19])
    rt = egor.minimize(xsinx_t, max_iters=20)
    assert abs(rj.x_opt[0] - 18.935) < 1e-3
    assert abs(rt.x_opt[0] - 18.935) < 1e-3
    assert abs(rt.y_opt[0] + 15.125) < 1e-3
    # the first 7 rows (DoE, the cold fit's proposal and the next) agree
    np.testing.assert_allclose(rt.x_doe[:7], np.asarray(rj.x_doe)[:7],
                               atol=1e-6)
