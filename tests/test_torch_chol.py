"""egobox_torch's K2 Cholesky panel (plain version) and its blocked Cholesky
against egobox_tpu's Pallas panel kernel and ``pallas_cholesky``, run by
the Pallas interpreter, in float64; and the ``EGOBOX_CHOL`` dispatch of
the likelihood. The CUDA kernel itself is tested on a GPU by
test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egobox_tpu.gp import likelihood as jlk
from egobox_tpu.ops import pallas_chol as jpc
from egobox_torch.gp import likelihood as tlk
from egobox_torch.ops import chol_kernel as chk

torch.set_num_threads(2)


def _spd(n, seed):
    a = np.random.default_rng(seed).standard_normal((n, n)) / np.sqrt(n)
    return a @ a.T + 2.0 * np.eye(n)


def test_factor_panel_plain_matches_pallas_interpret():
    n, b = 1024, 256
    panel = _spd(n, 0)[:, :b]
    got = chk.factor_panel(torch.from_numpy(panel))
    ref = jpc.factor_panel(jnp.asarray(panel), 1024, True)
    assert got.dtype == torch.float64 and got.shape == (n, b)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("n", [512, 1280])
def test_panel_cholesky_matches_pallas_interpret(n):
    # n=512 is 2 panels of 256; n=1280 is 5
    r = _spd(n, n)
    got = chk.panel_cholesky(torch.from_numpy(r), block=256)
    ref = jpc.pallas_cholesky(jnp.asarray(r), block=256, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(got.numpy(), np.linalg.cholesky(r), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("n,block", [(300, 128), (97, 128), (700, 256)])
def test_panel_cholesky_pads_to_block(n, block):
    """n not a multiple of the block: identity padding, cropped factor;
    n <= block: the library factorization."""
    r = _spd(n, 3 * n)
    got = chk.panel_cholesky(torch.from_numpy(r), block=block)
    assert got.shape == (n, n)
    np.testing.assert_allclose(got.numpy(), np.linalg.cholesky(r), rtol=0,
                               atol=1e-10)


def test_not_positive_definite_gives_nan():
    r = _spd(300, 4)
    r[150, 150] = -5.0
    got = chk.panel_cholesky(torch.from_numpy(r), block=128)
    assert torch.isnan(got).any()
    assert torch.isnan(chk.cholesky_nan(torch.from_numpy(r))).all()


def test_likelihood_dispatch_through_panels(monkeypatch):
    """EGOBOX_CHOL=pallas:<b>:<prec> routes the likelihood factorization
    through the panel factorization in both packages without changing the
    value. egobox_tpu reads the variable when it traces, so its caches are
    cleared first."""
    rng = np.random.default_rng(3)
    x = rng.uniform(size=(160, 3))
    y = rng.standard_normal((160, 1))
    theta = np.asarray([0.4, 0.2, 0.8])

    def rlf_both():
        jv, _ = jlk.reduced_likelihood(
            "matern52", "constant", jnp.asarray(x), jnp.asarray(y),
            jnp.ones(()), jnp.asarray(theta), None, 1e-3,
        )
        tv, _ = tlk.reduced_likelihood(
            "matern52", "constant", torch.from_numpy(x), torch.from_numpy(y),
            torch.ones(()), torch.from_numpy(theta), None, 1e-3,
        )
        return float(jv), float(tv)

    j_native, t_native = rlf_both()
    calls = {"torch": 0, "jax": 0}

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(chk, "factor_panel", count("torch", chk.factor_panel))
    monkeypatch.setattr(jpc, "factor_panel", count("jax", jpc.factor_panel))
    monkeypatch.setattr(tlk, "_CHOL_NATIVE_MAX", 64)
    monkeypatch.setattr(jlk, "_CHOL_NATIVE_MAX", 64)
    monkeypatch.setenv("EGOBOX_CHOL", "pallas:128:high")
    jax.clear_caches()
    try:
        j_panel, t_panel = rlf_both()
    finally:
        jax.clear_caches()
    assert calls["torch"] == 2 and calls["jax"] == 2  # 160 -> 2 panels
    np.testing.assert_allclose(t_panel, j_panel, rtol=1e-12)
    np.testing.assert_allclose(t_panel, t_native, rtol=1e-12)
    np.testing.assert_allclose(j_native, t_native, rtol=1e-12)


def test_stack_above_the_native_limit_takes_the_panel_driver(monkeypatch):
    """A stack of matrices above the native limit goes through the K2
    driver matrix by matrix (the lanes of a one-output fit are a stack of
    one): each factor equals ``panel_cholesky``'s, bit for bit."""
    monkeypatch.setattr(tlk, "_CHOL_NATIVE_MAX", 64)
    monkeypatch.setenv("EGOBOX_CHOL", "pallas:32:highest")
    r = torch.stack([torch.from_numpy(_spd(100, s)) for s in (1, 2)])
    for stack in (r[:1], r, r.reshape(1, 2, 100, 100)):
        got = tlk._cholesky(stack)
        want = torch.stack([chk.panel_cholesky(m, block=32)
                            for m in stack.reshape(-1, 100, 100)])
        assert torch.equal(got, want.reshape(stack.shape))


@pytest.mark.parametrize("spec", ["blk:inverse:2048:high", "pallas:256",
                                  "pallas:256:bf16", "cusolver"])
def test_cholesky_spec_rejected(spec, monkeypatch):
    monkeypatch.setenv("EGOBOX_CHOL", spec)
    with pytest.raises(ValueError, match="EGOBOX_CHOL"):
        tlk._cholesky(torch.eye(8, dtype=torch.float64))


def test_panel_arguments_rejected():
    with pytest.raises(ValueError):
        chk.factor_panel(torch.zeros((4, 8)))  # m < b
    with pytest.raises(ValueError):
        chk.panel_cholesky(torch.eye(4), precision="bf16")
