"""egobox_torch's CUDA kernels against their plain versions, on a GPU.

CUDA kernels have no CPU mode, so every test here needs a card and skips
without one. The file imports neither jax nor egobox_tpu, so it also runs
on a GPU host that has no JAX:

    python -m pytest tests/test_torch_cuda.py -q -o addopts="" --noconftest

Tolerances: K1 atol 2e-6 (tests/test_pallas.py's target), K2 atol 5e-5 on a
well-conditioned SPD panel (tests/test_pallas_chol.py's target).
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from egobox_torch import gp as tgp
from egobox_torch.types import ConstraintStrategy
from egobox_torch.gp import kernels as tk
from egobox_torch.gp import likelihood as tlk
from egobox_torch.ops import chol_kernel as chk
from egobox_torch.ops import corr_kernel as ck

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _spd(n, seed):
    a = np.random.default_rng(seed).standard_normal((n, n)) / np.sqrt(n)
    return a @ a.T + 2.0 * np.eye(n)


K1_KERNELS = ["absolute_exponential", "matern32", "matern52",
              "squared_exponential"]
K1_ATOL = 2e-6


def _k1_inputs(dev, n1, n2, d, seed, theta=(0.1, 1.0)):
    rng = np.random.default_rng(seed)
    x1 = torch.tensor(rng.standard_normal((n1, d)), dtype=torch.float32,
                      device=dev)
    x2 = torch.tensor(rng.standard_normal((n2, d)), dtype=torch.float32,
                      device=dev)
    th = torch.tensor(rng.uniform(*theta, d), dtype=torch.float32,
                      device=dev)
    return x1, x2, th


# ragged on both sides (37x41, 1000x1003: no tile edge divides them, and
# 41 and 1003 take the scalar stores), several tiles, more than one staged
# chunk of features
@pytest.mark.parametrize("name", K1_KERNELS)
def test_tile_kernel_matches_plain(dev, name):
    for n1, n2, d in ((37, 41, 3), (700, 300, 10), (129, 65, 40),
                      (1000, 1003, 10)):
        x1, x2, th = _k1_inputs(dev, n1, n2, d, 9)
        before = ck.launches
        got = ck.corr_cross_tile(name, x1, x2, th)
        torch.cuda.synchronize()
        assert ck.launches == before + 1
        assert ck.launch_shapes[(n1, n2)] >= 1
        torch.testing.assert_close(got, ck.corr_cross_plain(name, x1, x2, th),
                                   rtol=0, atol=K1_ATOL)


# below, at and above one fold group (8) and one staged chunk (32)
@pytest.mark.parametrize("d", [1, 3, 8, 10, 33, 64, 100])
def test_tile_kernel_feature_counts(dev, d):
    x1, x2, th = _k1_inputs(dev, 129, 70, d, d, theta=(0.05, 0.6))
    for name in K1_KERNELS:
        got = ck.corr_cross_tile(name, x1, x2, th)
        torch.testing.assert_close(got, ck.corr_cross_plain(name, x1, x2, th),
                                   rtol=0, atol=K1_ATOL)


def test_tile_kernel_wide(dev):
    """n1 << n2: the predict shape of the n=10000 fit."""
    x1, x2, th = _k1_inputs(dev, 2000, 10_000, 10, 11, theta=(0.1, 0.5))
    got = ck.corr_cross_tile("matern52", x1, x2, th)
    torch.testing.assert_close(got, ck.corr_cross_plain("matern52", x1, x2,
                                                        th),
                               rtol=0, atol=K1_ATOL)


# one tensor on both sides takes the symmetric launch (lower tiles, each
# stored with its transpose); 130 and 37 take the scalar stores
@pytest.mark.parametrize("n", [37, 130, 1000, 2000])
@pytest.mark.parametrize("name", K1_KERNELS)
def test_tile_kernel_symmetric(dev, name, n):
    x, _, th = _k1_inputs(dev, n, 1, 10, n, theta=(0.1, 0.6))
    got = ck.corr_cross_tile(name, x, x, th)
    assert torch.equal(got, got.T)
    assert bool((got.diagonal() == 1.0).all())
    torch.testing.assert_close(got, ck.corr_cross_plain(name, x, x, th),
                               rtol=0, atol=K1_ATOL)
    # the same data as two tensors: the general launch
    general = ck.corr_cross_tile(name, x, x.clone(), th)
    torch.testing.assert_close(got, general, rtol=0, atol=K1_ATOL)


@pytest.mark.parametrize("name", ["absolute_exponential", "matern32",
                                  "matern52"])
def test_tile_kernel_large_theta(dev, name):
    """theta = 50, d = 64: most of r underflows. No NaN, no inf, an exact 0
    wherever the plain version gives 0; near neighbours keep their value."""
    rng = np.random.default_rng(12)
    x1 = rng.standard_normal((300, 64))
    near = x1[:100] + 1e-4 * rng.standard_normal((100, 64))
    x2 = np.concatenate([near, x1[100:150], 5.0 * rng.standard_normal((53,
                                                                       64))])
    x1 = torch.tensor(x1, dtype=torch.float32, device=dev)
    x2 = torch.tensor(x2, dtype=torch.float32, device=dev)
    th = torch.full((64,), 50.0, device=dev)
    for a, b in ((x1, x2), (x1, x1)):
        got = ck.corr_cross_tile(name, a, b, th)
        ref = ck.corr_cross_plain(name, a, b, th)
        assert bool(torch.isfinite(got).all())
        assert bool((got[ref == 0] == 0).all())
        assert float(got.max()) > 0.1
        torch.testing.assert_close(got, ref, rtol=0, atol=K1_ATOL)


@pytest.mark.parametrize("name", K1_KERNELS)
def test_tile_kernel_identical_points(dev, name):
    """All points equal: r is 1 off the diagonal too."""
    row = np.random.default_rng(13).standard_normal((1, 33))
    x = torch.tensor(np.repeat(row, 150, 0), dtype=torch.float32, device=dev)
    th = torch.full((33,), 0.7, device=dev)
    for b in (x, x.clone()):
        got = ck.corr_cross_tile(name, x, b, th)
        torch.testing.assert_close(got, torch.ones_like(got), rtol=0,
                                   atol=K1_ATOL)


# symmetric and general launches, ragged and aligned edges
@pytest.mark.parametrize("n1,n2", [(1003, 1003), (2000, 2000), (700, 300),
                                   (37, 41)])
@pytest.mark.parametrize("name", K1_KERNELS)
def test_tile_kernel_row_sums(dev, name, n1, n2):
    x1, x2, th = _k1_inputs(dev, n1, n2, 10, n1 + n2, theta=(0.1, 0.6))
    if n1 == n2:
        x2 = x1
    got, sums = ck.corr_cross_tile(name, x1, x2, th, row_sums=True)
    ref = ck.corr_cross_plain(name, x1, x2, th)
    torch.testing.assert_close(got, ref, rtol=0, atol=K1_ATOL)
    if n1 == n2:
        ref.diagonal().fill_(1.0)
    torch.testing.assert_close(sums, torch.sum(torch.abs(ref), 1), rtol=1e-5,
                               atol=0)
    # the kernel's own r, summed: only the order of the sum differs
    torch.testing.assert_close(sums, torch.sum(got.double(), 1).float(),
                               rtol=2e-6, atol=0)
    again, sums2 = ck.corr_cross_tile(name, x1, x2, th, row_sums=True)
    assert torch.equal(sums, sums2) and torch.equal(got, again)


@pytest.mark.parametrize("corr", ["matern52", "absolute_exponential"])
def test_build_r_takes_the_kernels_row_sums(dev, corr, monkeypatch):
    """_build_r through K1 (Gram and row sums from one launch) against
    _build_r from the plain Gram."""
    x, _, th = _k1_inputs(dev, 1500, 1, 10, 14, theta=(0.1, 0.6))
    monkeypatch.setattr(tk, "_DENSE_BUDGET", 1000)
    before = ck.launches
    got = tlk._build_r(corr, x, th, None, 1e-3, None)
    assert ck.launches == before + 1
    ref = ck.corr_cross_plain(corr, x, x, th)
    ref.diagonal().fill_(1.0)
    row_max = torch.max(torch.sum(torch.abs(ref), dim=1))
    ref.diagonal().add_(1e-3 * torch.clamp(row_max, min=1.0))
    assert torch.equal(got, got.T)
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=K1_ATOL)
    # with a mask the sums are taken from the masked R as before
    mask = torch.arange(1500, device=dev) < 1400
    masked = tlk._build_r(corr, x, th, None, 1e-3, mask)
    assert bool((masked[1400:, :1400] == 0).all())
    off = ~torch.eye(1400, dtype=torch.bool, device=dev)
    assert torch.equal(masked[:1400, :1400][off], got[:1400, :1400][off])


def test_tile_wrapper_refuses_float64(dev):
    x = torch.zeros((4, 2), dtype=torch.float64, device=dev)
    with pytest.raises(TypeError):
        ck.corr_cross_tile("matern52", x, x, torch.ones(2, dtype=x.dtype,
                                                        device=dev))


def _panel(m, b, seed, dev):
    """[A00; B]: a well-conditioned SPD diagonal block over random rows."""
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((m - b, b)) / np.sqrt(b)
    panel = np.concatenate([_spd(b, seed), rows])
    return torch.tensor(panel, dtype=torch.float32, device=dev)


# b: one sub-panel of 32 columns, ragged widths, the main path's 256 and the
# widest accepted; m: the diagonal block alone, one row below, and the
# driver's tall panels
@pytest.mark.parametrize("b", [32, 65, 128, 200, 256, 339])
@pytest.mark.parametrize("m_kind", ["b", "b+1", "1024", "10240"])
def test_panel_kernel_matches_plain(dev, m_kind, b):
    m = {"b": b, "b+1": b + 1}.get(m_kind) or int(m_kind)
    panel = _panel(m, b, m + b, dev)
    before = chk.launches
    got = chk.factor_panel(panel)
    torch.cuda.synchronize()
    assert chk.launches == before + 1
    torch.testing.assert_close(got, chk.factor_panel_plain(panel), rtol=0,
                               atol=5e-5)


# a non-positive pivot at the first, a middle and the last column of a
# 32-column sub-panel, in a full and in a ragged last sub-panel
@pytest.mark.parametrize("b,col", [(256, 0), (256, 64), (256, 79),
                                   (256, 95), (256, 255), (200, 192),
                                   (200, 199)])
def test_panel_kernel_nan_on_non_positive_pivot(dev, b, col):
    panel = _panel(b + 100, b, col, dev)
    panel[col, col] = -1.0
    got = chk.factor_panel(panel)
    torch.cuda.synchronize()
    assert bool(torch.isnan(got[col:, col]).all())
    assert bool(torch.isfinite(got[:col, :col]).all())
    if col:
        torch.testing.assert_close(
            got[:col, :col], chk.factor_panel_plain(panel[:col, :col]),
            rtol=0, atol=5e-5)


def test_panel_kernel_stamps(dev):
    """The clock64 phase split: load, diagonal blocks, row solves,
    trailing updates and store sum to at most the total."""
    stamps = torch.zeros(6, dtype=torch.int64, device=dev)
    chk.factor_panel(_panel(1024, 256, 3, dev), stamps)
    t = stamps.tolist()
    assert all(v > 0 for v in t) and sum(t[:5]) <= t[5]


def test_panel_kernel_nan_on_non_pd(dev):
    r = torch.tensor(_spd(512, 5), dtype=torch.float32, device=dev)
    r[300, 300] = -1.0
    got = chk.panel_cholesky(r, block=256)
    torch.cuda.synchronize()
    assert bool(torch.isnan(got[300:, 256:]).any())


def test_panel_wrapper_refuses_large_block(dev):
    with pytest.raises(ValueError):
        chk.factor_panel(torch.zeros((800, 400), device=dev))


def test_fit_goes_through_both_kernels(dev, monkeypatch):
    monkeypatch.setattr(tlk, "_CHOL_NATIVE_MAX", 256)
    monkeypatch.setattr(tk, "_DENSE_BUDGET", 1000)
    monkeypatch.setenv("EGOBOX_CHOL", "pallas:128:highest")
    rng = np.random.default_rng(10)
    x = rng.uniform(-2.0, 2.0, (600, 3))
    y = np.sum(np.sin(2.0 * x), axis=1)
    before = (ck.launches, chk.launches)
    m = tgp.fit_gp(torch.tensor(x, dtype=torch.float32, device=dev),
                   torch.tensor(y, dtype=torch.float32, device=dev),
                   corr="matern52", n_start=1, max_iters=5)
    assert np.isfinite(float(m.likelihood))
    assert ck.launches > before[0] and chk.launches > before[1]


# ---------------------------------------------------------------------------
# the Egor loop's pieces on the card
# ---------------------------------------------------------------------------


def test_k1_refuses_inputs_that_require_grad(dev):
    """K1 has no backward: the wrapper raises on an input that requires
    grad, ``corr_cross`` sends such a Gram (1000 x 1003, d=10: above the
    dispatch threshold) to the plain formula and its gradient agrees with
    the plain version's; without grad the same call launches K1."""
    x1, x2, th = _k1_inputs(dev, 1000, 1003, 10, 21)
    x1.requires_grad_(True)
    weight = torch.randn((1000, 1003), device=dev,
                         generator=torch.Generator(dev).manual_seed(0))
    with pytest.raises(RuntimeError, match="no backward"):
        ck.corr_cross_tile("matern52", x1, x2, th)
    before = ck.launches
    r = tk.corr_cross("matern52", x1, x2, th)
    assert r.grad_fn is not None and ck.launches == before
    (got,) = torch.autograd.grad((r * weight).sum(), x1)
    (ref,) = torch.autograd.grad(
        (ck.corr_cross_plain("matern52", x1, x2, th) * weight).sum(), x1)
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 1e-4 * scale
    with torch.no_grad():
        tk.corr_cross("matern52", x1, x2, th)
    assert ck.launches == before + 1
    # theta that requires grad is refused the same way
    th.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        ck.corr_cross_tile("matern52", x1.detach(), x2, th)


@pytest.mark.parametrize("ls_batch", [0, 8])
def test_lockstep_lbfgs_on_the_card_matches_cpu(dev, ls_batch):
    """A bounded quadratic whose minimum lies on faces of the box, over 6
    lanes in float32 on the card against float64 on the CPU: x within 1e-3
    of the box width, every lane converged on both sides."""
    from egobox_torch.optim import minimize_lbfgsb

    rng = np.random.default_rng(1)
    a = rng.standard_normal((4, 4))
    q = a @ a.T + 0.5 * np.eye(4)
    c = np.array([3.0, -2.5, 0.2, 4.0])
    x0 = rng.uniform(-1.5, 1.5, (6, 4))
    lo, up = np.full(4, -1.0), np.array([0.5, 2.0, 2.0, 0.8])

    def run(dtype, device):
        qt = torch.tensor(q, dtype=dtype, device=device)
        ct = torch.tensor(c, dtype=dtype, device=device)

        def quad(x):
            r = x - ct
            return 0.5 * torch.sum((r @ qt) * r, dim=-1)

        return minimize_lbfgsb(
            quad, torch.tensor(x0, dtype=dtype, device=device),
            torch.tensor(lo, dtype=dtype, device=device),
            torch.tensor(up, dtype=dtype, device=device), max_iters=100,
            ls_batch=ls_batch)

    ref = run(torch.float64, "cpu")
    got = run(torch.float32, dev)
    assert got.x.is_cuda and got.n_iters.is_cuda
    err = np.abs(got.x.cpu().double().numpy() - ref.x.numpy()) / (up - lo)
    assert err.max() <= 1e-3, err
    assert bool(ref.converged.all()) and bool(got.converged.all())


def test_optimize_infill_on_the_card_matches_cpu(dev):
    """The same surrogates (fitted on the CPU in float64, nugget 1e-4), the
    same starts: the WB2 infill in float32 on the card against float64 on
    the CPU, x within 1e-3 of the box width; the constrained path runs and
    returns a point inside the box."""
    from egobox_torch.ego import infill_optim as tio
    from egobox_torch.ego import surrogates as tsur

    rng = np.random.default_rng(4)
    xl = np.array([[-2.0, 2.0], [-1.0, 3.0]])
    x = rng.uniform(xl[:, 0], xl[:, 1], (20, 2))
    y = np.stack([((x - [0.3, 1.1]) ** 2).sum(1), x[:, 0] - 1.0], axis=1)
    models = tsur.train_gp_surrogates(
        torch.tensor(x), torch.tensor(y), None,
        tsur.GpSpec(n_start=2, max_iters=10, nugget=1e-4), seed=1)
    on_card = dataclasses.replace(models, **{
        f.name: (v.to(dev) if v.dtype == torch.bool
                 else v.to(device=dev, dtype=torch.float32))
        for f in dataclasses.fields(models)
        if isinstance(v := getattr(models, f.name), torch.Tensor)})
    starts = rng.uniform(xl[:, 0], xl[:, 1], (6, 2))
    fmin = float(y[:, 0].min())

    def run(m, dtype, device, **kw):
        def t(a):
            return torch.tensor(np.asarray(a), dtype=dtype, device=device)

        return tio.optimize_infill(
            m, t(starts), t(xl[:, 0]), t(xl[:, 1]), fmin, 1.0, 1.0,
            t([1.0]), t([1e-3]), crit="WB2", **kw)

    objective_only = dataclasses.replace(models, **{
        f.name: getattr(models, f.name)[:1]
        for f in dataclasses.fields(models)
        if isinstance(getattr(models, f.name), torch.Tensor)})
    card_only = dataclasses.replace(on_card, **{
        f.name: getattr(on_card, f.name)[:1]
        for f in dataclasses.fields(on_card)
        if isinstance(getattr(on_card, f.name), torch.Tensor)})
    ref = run(objective_only, torch.float64, "cpu")
    got = run(card_only, torch.float32, dev)
    assert got[0].is_cuda
    err = np.abs(got[0].cpu().double().numpy() - ref[0].numpy()) \
        / (xl[:, 1] - xl[:, 0])
    assert err.max() <= 1e-3, (got[0], ref[0])
    ref_c = run(models, torch.float64, "cpu", n_cstr=1)
    got_c = run(on_card, torch.float32, dev, n_cstr=1)
    err = np.abs(got_c[0].cpu().double().numpy() - ref_c[0].numpy()) \
        / (xl[:, 1] - xl[:, 0])
    assert err.max() <= 1e-3, (got_c[0], ref_c[0])
    assert float(got_c[0][0]) <= 1.0 + 1e-3  # the constraint x0 <= 1


def test_egor_runs_on_the_card_by_default(dev):
    """numpy in, no device: the surrogates live on the card, in float64
    for a design this small; ``suggest`` the same."""
    import egobox_torch as egx

    def xsinx(x):
        x = np.atleast_2d(x)
        return ((x - 3.5) * np.sin((x - 3.5) / np.pi)).reshape(-1, 1)

    egor = egx.Egor([[0.0, 25.0]], seed=42)
    res = egor.minimize(xsinx, max_iters=3)
    models = egor.solver.last_models
    assert models.r_chol.is_cuda and models.r_chol.dtype == torch.float64
    assert res.x_doe.shape == (8, 1) and isinstance(res.x_opt, np.ndarray)
    x = egor.suggest(res.x_doe, res.y_doe)
    assert x.shape == (1, 1) and 0.0 <= x[0, 0] <= 25.0
    assert egx.config.egor_dtype(dev, 1000) == torch.float64
    assert egx.config.egor_dtype(dev, 4096) == torch.float32


def test_egor_in_float32_launches_k1(dev):
    """``dtype=torch.float32`` on a 900-point d=10 Matern 5/2 design
    (900^2 x 10 > 8e6): the refit's Grams are K1's and the surrogates are
    float32; the default (float64) launches none."""
    import egobox_torch as egx

    rng = np.random.default_rng(3)
    x = rng.uniform(-2.0, 2.0, (900, 10))
    y = np.sum(np.sin(x), axis=1, keepdims=True)
    from egobox_torch.ego import GpConfig

    kw = dict(seed=1, n_start=4, gp_config=GpConfig(
        corr_spec=egx.CorrelationSpec.MATERN52, n_start=1, max_eval=3))
    box = [[-2.0, 2.0]] * 10
    before = ck.launches
    e32 = egx.Egor(box, dtype=torch.float32, **kw)
    x32 = e32.suggest(x, y)
    assert ck.launches > before
    assert e32.solver.last_models.r_chol.dtype == torch.float32
    before = ck.launches
    e64 = egx.Egor(box, **kw)
    x64 = e64.suggest(x, y)
    assert ck.launches == before
    assert e64.solver.last_models.r_chol.dtype == torch.float64
    assert x32.shape == x64.shape == (1, 10)


# ---------------------------------------------------------------------------
# the fused iteration as a CUDA graph
# ---------------------------------------------------------------------------


def _xsinx_np(x):
    x = np.atleast_2d(x)
    return ((x - 3.5) * np.sin((x - 3.5) / np.pi)).reshape(-1, 1)


def _g24_np(point):
    p = np.atleast_2d(point)
    x1, x2 = p[:, 0], p[:, 1]
    c1 = -2.0 * x1**4 + 8.0 * x1**3 - 8.0 * x1**2 + x2 - 2.0
    c2 = (-4.0 * x1**4 + 32.0 * x1**3 - 88.0 * x1**2 + 96.0 * x1 + x2
          - 36.0)
    return np.array([-x1 - x2, c1, c2]).T


FUSED_CASES = {
    "xsinx": dict(xl=[[0.0, 25.0]], fun=_xsinx_np, kw={}),
    "g24": dict(xl=[[0.0, 3.0], [0.0, 4.0]], fun=_g24_np,
                kw=dict(n_cstr=2, cstr_tol=np.array([1e-3, 1e-3]),
                        cstr_strategy=ConstraintStrategy.UTB)),
}


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_captured_fused_step_equals_its_eager_run(dev, case):
    """One fused iteration run three times on the same inputs through the
    solver's graph cache: eagerly (the first sight of its signature), by
    capture and replay, and by a second replay; float64, rtol 1e-9. The
    eager run on the card also matches the CPU's (x within 1e-4 of the box
    width: a multistart argmin on another device's rounding; on an H100
    xsinx's moves by 1.5e-5 of its width)."""
    import egobox_torch as egx

    c = FUSED_CASES[case]
    xl = np.asarray(c["xl"])
    x = np.random.default_rng(5).uniform(xl[:, 0], xl[:, 1], (12, len(xl)))
    y = c["fun"](x)
    outs = {}
    for device in ("cuda", "cpu"):
        egor = egx.Egor(c["xl"], n_start=6, seed=3, device=device,
                        **c["kw"])
        solver = egor.solver
        runs = []
        for _ in range(3 if device == "cuda" else 1):
            # the same draws every time: a fresh state and draw stream
            st = solver.init_state(None, doe=x, y_doe=y)
            solver.draws = type(solver.draws)(3)
            xk, _, f = solver.select_next_points(st)
            runs.append((xk[0], f, solver.graphs.stats.last))
        outs[device] = runs
    cuda = outs["cuda"]
    assert [r[2] for r in cuda] == ["eager", "capture", "replay"]
    for xk, f, _ in cuda[1:]:
        np.testing.assert_allclose(xk, cuda[0][0], rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(f, cuda[0][1], rtol=1e-9)
    width = xl[:, 1] - xl[:, 0]
    assert np.all(np.abs(cuda[0][0] - outs["cpu"][0][0]) <= 1e-4 * width)


def test_fused_float32_fit_launches_k1_inside_the_graph(dev, monkeypatch):
    """A 1 000-point d=10 Matern 5/2 design in float32, padded to a
    bucket, captured although it is larger than the designs the fused path
    captures by default (``GRAPH_MAX_ROWS``): the fused iteration's fit
    launches K1 while the graph is captured, the replay equals the
    capture's eager twin to float32 rounding, and every K1 shape it
    launched holds against ``corr_cross_plain`` on the card."""
    import egobox_torch as egx
    from egobox_torch.ego import GpConfig, graphs

    monkeypatch.setattr(graphs, "GRAPH_MAX_ROWS", 2048)

    rng = np.random.default_rng(4)
    x = rng.uniform(-2.0, 2.0, (1000, 10))
    y = np.sum(np.sin(x), axis=1, keepdims=True)
    egor = egx.Egor([[-2.0, 2.0]] * 10, dtype=torch.float32, seed=2,
                    n_start=4, gp_config=GpConfig(
                        corr_spec=egx.CorrelationSpec.MATERN52, n_start=2,
                        max_eval=3))
    solver = egor.solver
    ck.launch_shapes.clear()
    got = []
    for _ in range(3):
        st = solver.init_state(None, doe=x, y_doe=y)
        solver.draws = type(solver.draws)(2)
        got.append(solver.select_next_points(st)[0][0])
    stats = solver.graphs.stats
    assert stats.captures == 1 and stats.replays == 2
    assert stats.kernel_replays.get("corr_tile", 0) > 0
    np.testing.assert_allclose(got[2], got[1], rtol=0, atol=0)
    assert np.all(np.abs(got[1] - got[0]) <= 1e-3 * 4.0)
    assert ck.launch_shapes
    for (n1, n2) in ck.launch_shapes:
        x1, x2, th = _k1_inputs(dev, n1, n2, 10, n1 + n2, theta=(0.1, 0.6))
        if n1 == n2:
            x2 = x1
        torch.testing.assert_close(ck.corr_cross_tile("matern52", x1, x2, th),
                                   ck.corr_cross_plain("matern52", x1, x2,
                                                       th),
                                   rtol=0, atol=K1_ATOL)


def test_traced_run_on_the_card(dev):
    """The traced xsinx run on the card: each step after the first of its
    signature is a replay, and the chunk rows are fetched once per chunk."""
    import egobox_torch as egx

    def xsinx_t(x):
        return (x - 3.5) * torch.sin((x - 3.5) / np.pi)

    egor = egx.Egor([[0.0, 25.0]], seed=2, traced_run=True)
    res = egor.minimize(xsinx_t, max_iters=12)
    assert res.y_opt[0] < -15.0
    stats = egor.solver.graphs.stats
    assert stats.captures >= 1 and stats.replays >= 8
    assert sum(c["iterations"] for c in egor.iteration_times) == 12


def test_egor_batch_on_the_card_equals_the_cpu(dev):
    """EgorBatch's batched fused step (3 problems, each on its own box) on
    the card, three times (eager, capture, replay) on the same draws, and on
    the CPU: the replays equal the eager run at rtol 1e-9, the card the CPU
    within 1e-4 of each box's width. The boxes are ones where the proposal
    is a function of the data (a 1e-11 relative change of y moves it by less
    than 1e-9 on the CPU); on [0, 25] with these 7 points the criterion is
    nearly flat and such a change moves the proposal by 0.3, so no two
    devices' roundings can be held to one answer there."""
    import egobox_torch as egx
    from egobox_torch.ego import GpConfig

    xl = np.array([[[2.0, 22.0]], [[0.0, 20.0]], [[5.0, 25.0]]])
    rng = np.random.default_rng(6)
    x = np.stack([rng.uniform(b[0, 0], b[0, 1], (7, 1)) for b in xl])
    y = np.stack([_xsinx_np(x[b]) for b in range(3)])
    out = {}
    for device in ("cuda", "cpu"):
        runs = []
        for _ in range(3 if device == "cuda" else 1):
            eb = egx.EgorBatch([_xsinx_np] * 3, xl, seed=4, n_start=4,
                               device=device,
                               gp_config=GpConfig(n_start=2, max_eval=10))
            if runs:
                eb.graphs = cache
            runs.append(eb.suggest(x, y))
            cache = eb.graphs
        out[device] = (runs, cache.stats)
    runs, stats = out["cuda"]
    assert (stats.eager, stats.captures, stats.replays) == (1, 1, 2)
    for r in runs[1:]:
        np.testing.assert_allclose(r, runs[0], rtol=1e-9, atol=1e-12)
    width = xl[:, 0, 1] - xl[:, 0, 0]
    assert np.all(np.abs(runs[0][:, 0] - out["cpu"][0][0][:, 0])
                  <= 1e-4 * width)


def test_graph_cache_drops_the_graphs_of_a_size_left(dev):
    """The cache's first call is its eager warm-up (the early-exit form);
    later calls capture a new signature at first sight and replay a known
    one; a call of another size drops every graph of the old size. Each
    result is the function's, and the pool's bytes are measured."""
    from egobox_torch.ego.graphs import GraphCache

    def fn(graph_safe, x):
        return x * 2.0 + 1.0

    cache = GraphCache()
    calls = [("a", 8, 1.0), ("a", 8, 2.0), ("b", 8, 3.0), ("a", 8, 4.0),
             ("c", 16, 5.0), ("c", 16, 6.0)]
    seen = []
    for key, size, v in calls:
        x = torch.full((size, 1), v, device=dev, dtype=torch.float64)
        out = cache.run(key, fn, {"x": x}, x.shape)
        torch.testing.assert_close(out, x * 2.0 + 1.0, rtol=0, atol=0)
        seen.append((cache.stats.last, cache.live))
    assert seen == [("eager", 0), ("capture", 1), ("capture", 2),
                    ("replay", 2), ("capture", 1), ("replay", 1)]
    assert cache.stats.evicted == 2 and cache.stats.captures == 3
    assert cache.stats.pool_peak_bytes is not None
    assert cache.stats.pool_peak_bytes > 0


# ---------------------------------------------------------------------------
# the mixture of experts and the fused clustered iteration
# ---------------------------------------------------------------------------


def _piecewise_np(x):
    x = np.atleast_2d(x)
    left = (x - 3.5) * np.sin((x - 3.5) / np.pi)
    right = 0.5 * (x - 18.0) ** 2 - 15.0
    return np.where(x < 10.0, left, right).reshape(-1, 1)


def _clustered_solver(device):
    """A solver of 2 clusters and a 12-point DoE with its clustering made
    (the host path of the first iteration)."""
    from egobox_torch.ego import EgorConfig, EgorSolver, GpConfig

    solver = EgorSolver(EgorConfig(gp_config=GpConfig(n_clusters=2,
                                                      n_start=3),
                                   seed=0, n_doe=12, n_start=6),
                        np.array([[0.0, 25.0]]), device=device)
    st = solver.init_state(_piecewise_np)
    solver._train_moe(st, st.x_data, st.y_data, True)
    return solver, st


def _moe_step(solver, st, clusterings):
    """One clustered iteration from ``st``'s design on fresh draws and a
    fresh state, the given clustering standing."""
    fresh = solver.init_state(None, doe=st.x_data, y_doe=st.y_data)
    fresh.clusterings = clusterings
    solver.draws = type(solver.draws)(3)
    xk, _, f = solver.select_next_points(fresh)
    return xk[0], f, solver.graphs.stats.last


def test_captured_fused_moe_step_equals_its_eager_run(dev):
    """The fused clustered iteration three times on the same inputs through
    the graph cache (eager, capture, replay), float64: rtol 1e-9."""
    solver, st = _clustered_solver("cuda")
    assert solver._fast_path_moe_ok(st, ())
    runs = [_moe_step(solver, st, st.clusterings) for _ in range(3)]
    assert [r[2] for r in runs] == ["eager", "capture", "replay"]
    for xk, f, _ in runs[1:]:
        np.testing.assert_allclose(xk, runs[0][0], rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(f, runs[0][1], rtol=1e-9)


def test_a_replay_after_a_recluster_uses_the_new_mixture(dev):
    """The GMM, its weights and the heaviside factor are inputs of the
    captured graph: after a new clustering (here a new heaviside factor and
    new means) the replay answers what an eager run of the new clustering
    answers, not what the captured one did."""
    import dataclasses

    solver, st = _clustered_solver("cuda")
    old = st.clusterings
    g, recomb = old[0]
    new = [(dataclasses.replace(g, means=g.means + 1.5).with_heaviside(
        0.3), recomb)]
    first = [_moe_step(solver, st, old) for _ in range(2)]
    assert [r[2] for r in first] == ["eager", "capture"]
    replay = _moe_step(solver, st, new)
    assert replay[2] == "replay"
    ref_solver, _ = _clustered_solver("cuda")
    ref = _moe_step(ref_solver, st, new)
    assert ref[2] == "eager"
    np.testing.assert_allclose(replay[0], ref[0], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(replay[1], ref[1], rtol=1e-9)
    assert not np.allclose(replay[1], first[1][1], rtol=1e-6)


@pytest.mark.parametrize("n1,n2", [(1424, 1424), (1784, 1784),
                                   (2208, 2208), (800, 1784)])
def test_k1_at_the_mixture_fold_fit_shapes(dev, n1, n2):
    """K1 at the shapes the mixture's CV fold fits, expert fits and
    heaviside predictions launch it at (chip_smoke.py's moe phase)."""
    x1, x2, th = _k1_inputs(dev, n1, n2, 10, n1 + n2, theta=(0.1, 0.6))
    if n1 == n2:
        x2 = x1
    torch.testing.assert_close(ck.corr_cross_tile("matern52", x1, x2, th),
                               ck.corr_cross_plain("matern52", x1, x2, th),
                               rtol=0, atol=K1_ATOL)


def test_train_moe_on_the_card_equals_the_cpu_at_fixed_theta(dev):
    """The experts of a mixture retrained on the card at fixed (trend,
    corr, theta) and on the CPU, float64: likelihoods rtol 1e-9,
    predictions and variances atol 1e-9. Two regimes on two blobs of a 2-d
    input with 10 % noise keep every expert's Gram well conditioned (on a
    1-d branch the fit drives theta to a near-singular Gram, where the two
    devices' roundings differ in the likelihood's sixth digit)."""
    from egobox_torch import moe

    rng = np.random.RandomState(0)
    x = np.vstack([rng.uniform(0, 1, (20, 2)), rng.uniform(2, 3, (20, 2))])
    y = np.where(x[:, 0] < 1.5, np.sin(4 * x[:, 0]) * np.cos(3 * x[:, 1]),
                 4.0 + x[:, 0] * x[:, 1]) + 0.1 * rng.standard_normal(40)
    mix = moe.train_moe(x, y, n_clusters=2, n_start=2, device="cpu")
    fixed = moe.expert_params(mix)
    g = np.linspace(-0.2, 3.2, 6)
    xq = np.stack(np.meshgrid(g, g), axis=-1).reshape(-1, 2)
    out = []
    for device in ("cuda", "cpu"):
        m = moe.train_moe_on_clusters(
            x, y, mix.gmx.to(device), fixed_params=fixed, device=device,
            dtype=torch.float64)
        out.append((torch.stack([e.likelihood for e in m.experts]).cpu(),
                    m.predict(xq).cpu(), m.predict_var(xq).cpu()))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=1e-9, atol=0)
    torch.testing.assert_close(out[0][1], out[1][1], rtol=0, atol=1e-9)
    torch.testing.assert_close(out[0][2], out[1][2], rtol=0, atol=1e-9)


def test_train_moe_card_vs_cpu_on_the_piecewise_design(dev):
    """The egor-moe2-piecewise cell's kind of data (the 1-d piecewise
    objective, 20 points), where the fit drives an expert's theta to a
    near-singular Gram: retrained at fixed (trend, corr, theta) on the card
    and on the CPU, float64, each expert's likelihood within the
    first-order bound of its conditioning, n * cond(R) * eps * (1 + |l|),
    and the predictions within cond(R) * eps * max|y|. Beside it, printed:
    cond(R), the card's difference and the CPU's own spread when the rows
    come in another order."""
    from egobox_torch import moe

    eps = float(np.finfo(np.float64).eps)
    rng = np.random.RandomState(0)
    x = np.sort(rng.uniform(0.0, 25.0, (20, 1)), axis=0)
    y = np.where(x[:, 0] < 10.0, (x[:, 0] - 3.5) * np.sin((x[:, 0] - 3.5)
                                                           / np.pi),
                 0.5 * (x[:, 0] - 18.0) ** 2 - 15.0)
    mix = moe.train_moe(x, y, n_clusters=2, n_start=2, device="cpu")
    fixed = moe.expert_params(mix)
    perm = rng.permutation(20)
    xq = np.linspace(-1.0, 26.0, 30)[:, None]
    fits = {}
    for name, device, rows in (("cuda", "cuda", slice(None)),
                               ("cpu", "cpu", slice(None)),
                               ("cpu-permuted", "cpu", perm)):
        fits[name] = moe.train_moe_on_clusters(
            x[rows], y[rows], mix.gmx.to(device), fixed_params=fixed,
            device=device, dtype=torch.float64)
    conds = []
    for c, (ea, eb, ep) in enumerate(zip(fits["cuda"].experts,
                                         fits["cpu"].experts,
                                         fits["cpu-permuted"].experts)):
        cond = float(torch.linalg.cond(eb.r_chol @ eb.r_chol.T))
        n_c, lik = int(eb.mask.sum()), float(eb.likelihood)
        d_card = abs(float(ea.likelihood) - lik)
        d_perm = abs(float(ep.likelihood) - lik)
        print(f"expert {c}: n {n_c} theta {eb.theta.tolist()} cond(R) "
              f"{cond:.3e} likelihood {lik:.10g} |card - cpu| {d_card:.3e} "
              f"|cpu permuted - cpu| {d_perm:.3e}")
        assert d_card <= n_c * cond * eps * (1.0 + abs(lik))
        conds.append(cond)
    tol = max(conds) * eps * float(np.max(np.abs(y)))
    for f in ("predict", "predict_var"):
        a = getattr(fits["cuda"], f)(xq).cpu()
        b = getattr(fits["cpu"], f)(xq)
        print(f"{f}: |card - cpu| {float((a - b).abs().max()):.3e} "
              f"(bound {tol:.3e})")
        torch.testing.assert_close(a, b, rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# the sparse GP on the card: K1 under autograd
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["absolute_exponential", "matern32",
                                  "matern52"])
def test_k1gram_forward_and_backward_on_the_card(dev, name):
    """A Gram whose theta requires grad (300 x 30 000, d=10: above the
    dispatch threshold) launches K1 once through ``K1Gram``; its value
    agrees with the plain version at K1's atol, and its theta gradient with
    autograd through the plain formula in float32 and in float64 (error
    over the largest component within 1e-4)."""
    x1, x2, th = _k1_inputs(dev, 300, 30_000, 10, 31, theta=(0.1, 0.6))
    weight = torch.randn((300, 30_000), device=dev,
                         generator=torch.Generator(dev).manual_seed(1))
    thg = th.clone().requires_grad_(True)
    before = ck.launches
    r = tk.corr_cross(name, x1, x2, thg)
    assert ck.launches == before + 1 and r.grad_fn is not None
    (got,) = torch.autograd.grad((weight * r).sum(), thg)
    torch.testing.assert_close(r.detach(),
                               ck.corr_cross_plain(name, x1, x2, th),
                               rtol=0, atol=K1_ATOL)
    for dtype in (torch.float32, torch.float64):
        t = th.to(dtype).requires_grad_(True)
        ref_r = torch.exp(tk.log_corr_cross(name, x1.to(dtype),
                                            x2.to(dtype), t))
        (ref,) = torch.autograd.grad((weight.to(dtype) * ref_r).sum(), t)
        err = float((got.double() - ref.double()).abs().max()
                    / ref.double().abs().max())
        print(f"{name} {dtype}: K1Gram theta gradient rel err {err:.3e}")
        assert err <= 1e-4


def test_sgp_fit_on_the_card_equals_the_cpu(dev):
    """The same FITC fit (float64, the same draws: one CPU generator) on
    the card and on the CPU: likelihood rtol 1e-6, predictions within
    1e-5 std(y)."""
    from egobox_torch.gp import sgp

    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (400, 2))
    y = np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1]) + 0.05 * rng.standard_normal(
        400)
    xq = rng.uniform(-1, 1, (50, 2))
    out = {}
    for device in (dev, torch.device("cpu")):
        m = sgp.fit_sgp(torch.tensor(x, device=device),
                        torch.tensor(y, device=device), n_inducing=20,
                        n_start=4, seed=3)
        out[device.type] = (float(m.likelihood),
                            sgp.sgp_predict(m, xq).cpu().numpy())
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-6)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=0,
                               atol=1e-5 * np.std(y))


def test_sgp_fit_takes_k1_at_every_cross_gram(dev):
    """A Matern 5/2 FITC fit of numpy float32 input (128 inducing points,
    8 000 points, d=10: 1e7 terms per cross Gram) keeps float32 points and
    builds every 128 x 8 000 Gram of its lanes with K1 through ``K1Gram``
    (one launch per likelihood evaluation and one for the final
    likelihood; the 128 x 128 K(Z, Z), below the dispatch threshold, in
    the plain float32 formula); its likelihood within 1e-3 of a float64
    recomputation of the same model (float64 Grams, the fit's nugget, 100
    eps32 sigma2, as an absolute one). The same data as float64 runs no K1
    launch."""
    from egobox_torch.gp import sgp

    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (8000, 10)).astype(np.float32)
    y = (np.sum(np.sin(2 * x), axis=1)
         + 0.05 * rng.standard_normal(8000)).astype(np.float32)
    kw = dict(corr="matern52", n_inducing=128, n_start=2, max_iters=8,
              seed=0)
    ck.launch_shapes.clear()
    info = {}
    m = sgp.fit_sgp(x, y, info=info, **kw)
    assert m.theta.dtype == torch.float64 and m.theta.is_cuda
    assert m.z.dtype == torch.float32
    assert ck.launch_shapes[(128, 8000)] == info["evaluations"] + 1
    assert (128, 128) not in ck.launch_shapes
    nugget = sgp._default_nugget(torch.float32) * float(m.sigma2)
    lkh64, _ = sgp.fitc_likelihood(
        "matern52", m.theta, m.sigma2, m.noise,
        torch.tensor(x, dtype=torch.float64, device=dev),
        torch.tensor(y, dtype=torch.float64, device=dev)[:, None],
        m.z.double(), None, nugget)
    assert abs(float(m.likelihood) - float(lkh64)) <= 1e-3 * abs(
        float(lkh64))
    before = ck.launches
    m64 = sgp.fit_sgp(x.astype(np.float64), y.astype(np.float64), **kw)
    assert m64.z.dtype == torch.float64 and ck.launches == before


# ---------------------------------------------------------------------------
# CoEGO, the polish of host-callback constraints and the ranked warm start
# ---------------------------------------------------------------------------


def test_coego_iteration_on_the_card(dev):
    """One CoEGO iteration at d=12 with partial theta tuning and the
    improvement check, on the card (the host path): a new point in the
    box, one fit per group."""
    import os

    import egobox_torch as egx

    def sphere(x):
        return np.sum(np.atleast_2d(x) ** 2, axis=1, keepdims=True)

    os.environ["EGOR_COEGO_IMPROVEMENT_CHECK"] = "1"
    try:
        egor = egx.Egor([[-5.0, 5.0]] * 12, seed=1, coego_n_coop=3,
                        infill_strategy=egx.InfillStrategy.EI)
        egor.config.coego_partial_theta_tuning = True
        res = egor.minimize(sphere, max_iters=1)
    finally:
        del os.environ["EGOR_COEGO_IMPROVEMENT_CHECK"]
    assert egor.solver.last_models.theta.is_cuda
    assert res.x_doe.shape == (14, 12)
    assert np.all((res.x_doe >= -5.0) & (res.x_doe <= 5.0))
    assert "fit" in egor.iteration_times[0]


def test_fcstr_polish_on_the_card_matches_cpu(dev):
    """The same surrogates (float64, fitted on the CPU) on the card and on
    the CPU, the same start and cloud: the polished x within 1e-6 of the
    box width, one host read per evaluation."""
    from egobox_torch.ego import EgorConfig, EgorSolver
    from egobox_torch.ego import infill_optim as tio
    from egobox_torch.ego import surrogates as tsur

    rng = np.random.default_rng(12)
    xl = np.array([[0.0, 3.0], [0.0, 4.0]])
    x = rng.uniform(xl[:, 0], xl[:, 1], (12, 2))
    y = np.stack([-x[:, 0] - x[:, 1], x[:, 1] - 2.0 * x[:, 0] - 1.0], axis=1)
    models = tsur.train_gp_surrogates(
        torch.tensor(x), torch.tensor(y), None,
        tsur.GpSpec(n_start=2, max_iters=10, nugget=1e-6), seed=3)
    cloud = rng.uniform(xl[:, 0], xl[:, 1], (200, 2))

    def host_cstr(p):
        return float(np.asarray(p, dtype=float)[0]) - 2.1

    def polish(device):
        m = dataclasses.replace(models, **{
            f.name: getattr(models, f.name).to(device)
            for f in dataclasses.fields(models)
            if isinstance(getattr(models, f.name), torch.Tensor)})
        cl = torch.tensor(cloud, device=device)
        tols = torch.tensor([1e-3], device=device, dtype=torch.float64)
        s_inf, s_cstr, s_wb2 = tio.compute_scaling(m, cl, float(y[:, 0].min()),
                                                   tols, crit="EI", n_cstr=1)
        kw = dict(fmin=float(y[:, 0].min()), scale_infill=s_inf,
                  scale_wb2=s_wb2, scale_cstr=s_cstr, cstr_tols=tols,
                  crit="EI", cstr_strategy="MC", n_cstr=1,
                  cstr_infill=False, feasibility=True, optimizer="COBYLA")
        solver = EgorSolver(EgorConfig(n_cstr=1,
                                       cstr_tol=np.array([1e-3, 1e-3])), xl,
                            device=device, dtype=torch.float64)
        stats = {}
        xp = solver._fcstr_polish(np.array([2.6, 3.5]), m, [host_cstr], cl,
                                  kw, xl, stats)
        return xp, stats["evals"]

    got, evals = polish(dev)
    want, evals_cpu = polish("cpu")
    assert np.all(np.abs(got - want) <= 1e-6 * (xl[:, 1] - xl[:, 0])), (
        got, want)
    assert evals > 0 and got[0] <= 2.1 + 1e-3


def test_rank_warmstart_fit_launches_k1_at_the_ranking_shapes(dev):
    """fit_gp(subsample_warmstart=1000, rank_warmstart=2000) at n=3000,
    d=10, Matern 5/2, float32: K1 builds the 1000^2 Grams of the
    multistart, the 2000^2 of the ranking and the 3000^2 of the polish."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-600.0, 600.0, (3000, 10))
    s = np.sum(x**2 / 4000.0, axis=1)
    y = s - np.prod(np.cos(x / np.sqrt(np.arange(1, 11))), axis=1) + 1.0
    ck.launch_shapes.clear()
    before = ck.launches
    m = tgp.fit_gp(x.astype(np.float32), y.astype(np.float32),
                   corr="matern52", n_start=1, max_iters=4, nugget=1e-3,
                   subsample_warmstart=1000, rank_warmstart=2000,
                   polish_iters=1, polish_tr=True, seed=0)
    assert m.theta.is_cuda and np.isfinite(float(m.likelihood))
    assert ck.launches > before
    for shape in ((1000, 1000), (2000, 2000), (3000, 3000)):
        assert ck.launch_shapes[shape] >= 1, dict(ck.launch_shapes)


def _nccl_card_rank(rank, world_size):
    """The rank side of the test below: its mesh's card, its current
    device, and an all_reduce over NCCL."""
    from egobox_torch import parallel as P

    mesh = P.make_mesh()
    total = P._comm.all_reduce(mesh, torch.ones(1, device=mesh.device))
    return (mesh.size, mesh.device.index, torch.cuda.current_device(),
            float(total))


def test_nccl_ranks_take_distinct_cards(dev):
    """run_ranks(backend="nccl") over every card of the host: rank r's
    mesh computes on card r, its current device, and the group reduces."""
    from egobox_torch.parallel.launch import run_ranks

    w = torch.cuda.device_count()
    got = run_ranks(_nccl_card_rank, w, backend="nccl", timeout=300)
    assert got == [(w, r, r, float(w)) for r in range(w)]


_TORCHRUN_RANK = """
import json, torch
from egobox_torch import parallel as P
mesh = P.make_mesh()
total = P._comm.all_reduce(
    mesh, torch.full((1,), mesh.rank + 1.0, device=mesh.device))
print(json.dumps([mesh.rank, mesh.size, mesh.device.index,
                  torch.cuda.current_device(),
                  torch.distributed.get_backend(mesh.group), float(total)]))
mesh.close()
"""


def _torchrun_ranks(local_ranks):
    """Processes started as torchrun starts its ranks on one host
    (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``), one for each entry of
    ``local_ranks``, each making ``make_mesh()``; their (returncode,
    stdout, stderr)."""
    root = Path(__file__).resolve().parents[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "GROUP_RANK",
                        "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = os.pathsep.join(
        filter(None, [str(root), env.get("PYTHONPATH")]))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    w = len(local_ranks)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _TORCHRUN_RANK], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(env, WORLD_SIZE=str(w), RANK=str(r), LOCAL_RANK=str(lr),
                 LOCAL_WORLD_SIZE=str(w), MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=port)) for r, lr in enumerate(local_ranks)]
    got = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            got.append((p.returncode, out, err))
    finally:
        for p in procs:
            p.kill()
    return got


def test_make_mesh_joins_a_torchrun_style_group_on_the_cards(dev):
    """Two ranks launched as torchrun launches them make one NCCL mesh of
    2 ranks on cards 0 and 1, and reduce over it; with ``LOCAL_RANK`` 0
    for both, both refuse, naming card 0."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 cards or more")
    got = _torchrun_ranks([0, 1])
    assert [rc for rc, _, _ in got] == [0, 0], [err for _, _, err in got]
    assert [json.loads(out.strip().splitlines()[-1]) for _, out, _ in got] \
        == [[r, 2, r, r, "nccl", 3.0] for r in range(2)]
    for rc, _, err in _torchrun_ranks([0, 0]):
        assert rc != 0
        assert "ranks [0, 1] of the mesh sit on one card, card 0:" in err


def test_a_capture_that_cannot_succeed_raises(dev):
    """An objective that reads a device value on the host (``.item()``)
    cannot be captured: the traced run raises when it captures, and does
    not go on eagerly. (Last in the file: a capture that failed may leave
    the context's capture state behind.)"""
    import egobox_torch as egx

    def reads_the_host(x):
        shift = float((x * 0).sum().item())
        return (x - 3.5 + shift) * torch.sin((x - 3.5) / np.pi)

    egor = egx.Egor([[0.0, 25.0]], seed=42, traced_run=True)
    with pytest.raises(RuntimeError):
        egor.minimize(reads_the_host, max_iters=6)
    assert egor.solver.graphs.stats.captures == 0
