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


@pytest.mark.parametrize("name", ["absolute_exponential", "matern32",
                                  "matern52", "squared_exponential"])
def test_tile_kernel_matches_plain(dev, name):
    rng = np.random.default_rng(9)
    for n1, n2, d in ((37, 41, 3), (700, 300, 10), (129, 65, 40)):
        x1 = torch.tensor(rng.standard_normal((n1, d)), dtype=torch.float32,
                          device=dev)
        x2 = torch.tensor(rng.standard_normal((n2, d)), dtype=torch.float32,
                          device=dev)
        th = torch.tensor(rng.uniform(0.1, 1.0, d), dtype=torch.float32,
                          device=dev)
        before = ck.launches
        got = ck.corr_cross_tile(name, x1, x2, th)
        torch.cuda.synchronize()
        assert ck.launches == before + 1
        torch.testing.assert_close(got, ck.corr_cross_plain(name, x1, x2, th),
                                   rtol=0, atol=2e-6)


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
