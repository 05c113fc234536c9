"""egobox_torch's CUDA kernels against their plain versions, on a GPU.

CUDA kernels have no CPU mode, so every test here needs a card and skips
without one. The file imports neither jax nor egobox_tpu, so it also runs
on a GPU host that has no JAX:

    python -m pytest tests/test_torch_cuda.py -q -o addopts="" --noconftest

Tolerances: K1 atol 2e-6 (tests/test_pallas.py's target), K2 atol 5e-5 on a
well-conditioned SPD panel (tests/test_pallas_chol.py's target).
"""

import numpy as np
import pytest
import torch

from egobox_torch import gp as tgp
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
