"""egobox_torch's LHS kinds and the ESE refinement against egobox_tpu's.

torch's generator never reproduces JAX's threefry bits, so designs are
compared by their distribution: Latin-hypercube structure, and the phi_p
(p = 10) criterion after ESE from the same ``lhs0``: no worse than
``lhs0``'s and within 5 % of JAX's median over 5 seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egobox_tpu.doe import lhs as jlhs
from egobox_torch.doe import lhs as tlhs

torch.set_num_threads(2)


def _is_lhs(x, ns):
    strata = np.floor(np.asarray(x) * ns).astype(int)
    return all(sorted(col) == list(range(ns)) for col in strata.T)


@pytest.mark.parametrize("kind", list(tlhs.LhsKind))
def test_every_kind_is_a_latin_hypercube(kind):
    gen = torch.Generator().manual_seed(3)
    x = tlhs.lhs_normalized(gen, 12, 3, kind, device="cpu")
    assert x.shape == (12, 3) and x.dtype == torch.float64
    assert _is_lhs(x.numpy(), 12)
    assert [k.value for k in tlhs.LhsKind] == [k.value for k in jlhs.LhsKind]


def test_optimized_lhs_is_a_latin_hypercube_and_repeats_with_its_seed():
    a = tlhs.optimized_lhs(15, 2, torch.Generator().manual_seed(7),
                           device="cpu")
    b = tlhs.optimized_lhs(15, 2, torch.Generator().manual_seed(7),
                           device="cpu")
    assert _is_lhs(a.numpy(), 15)
    assert torch.equal(a, b)
    assert tlhs.optimized_lhs(1, 2, torch.Generator().manual_seed(7),
                              device="cpu").shape == (1, 2)


def test_candidate_phip_matches_full_recomputation():
    x = tlhs.classic_lhs(9, 3, torch.Generator().manual_seed(2), device="cpu")
    p = 10.0
    phip_p = tlhs._phip(x, p) ** p
    i1, i2 = torch.tensor([0, 4, 8]), torch.tensor([3, 1, 2])
    got = tlhs._candidate_phip(x, phip_p, i1, i2, 1, p)
    for j in range(3):
        y = x.clone()
        y[i1[j], 1], y[i2[j], 1] = x[i2[j], 1], x[i1[j], 1]
        np.testing.assert_allclose(float(got[j]),
                                   float(tlhs._phip(y, p) ** p), rtol=1e-10)
        want = jlhs._candidate_phip(jnp.asarray(x.numpy()),
                                    jnp.asarray(float(phip_p)),
                                    int(i1[j]), int(i2[j]), 1, p)
        np.testing.assert_allclose(float(got[j]), float(want), rtol=1e-10)


def test_ese_improves_phip_like_jax():
    ns, nx, outer, inner = 20, 3, 4, 60
    ratios_t, ratios_j = [], []
    for seed in range(5):
        lhs0 = np.asarray(jlhs.classic_lhs(jax.random.key(seed), ns, nx,
                                           jnp.float64))
        phip0 = float(jlhs._phip(jnp.asarray(lhs0), 10.0))
        xj = jlhs.maximin_ese(jax.random.key(100 + seed),
                              jnp.asarray(lhs0), outer, inner)
        xt = tlhs.maximin_ese(torch.Generator().manual_seed(100 + seed),
                              torch.tensor(lhs0), outer, inner)
        assert _is_lhs(xt.numpy(), ns)
        phip_t = float(tlhs._phip(xt, 10.0))
        assert phip_t <= phip0 * (1 + 1e-12)
        ratios_t.append(phip_t / phip0)
        ratios_j.append(float(jlhs._phip(xj, 10.0)) / phip0)
    assert np.median(ratios_t) <= 1.05 * np.median(ratios_j), (ratios_t,
                                                               ratios_j)
    assert np.median(ratios_t) < 0.9


def test_lhs_object_scales_to_its_limits():
    xl = np.array([[0.0, 25.0], [-3.0, 3.0]])
    s = tlhs.Lhs(xl, tlhs.LhsKind.MAXIMIN, seed=4, device="cpu").sample(8)
    assert s.shape == (8, 2)
    assert bool(((s >= torch.tensor(xl[:, 0]))
                 & (s <= torch.tensor(xl[:, 1]))).all())
    with pytest.raises(ValueError):
        tlhs.Lhs([0.0, 1.0], device="cpu")


# ---------------------------------------------------------------------------
# full factorial and uniform random designs
# ---------------------------------------------------------------------------

from egobox_tpu import doe as jdoe  # noqa: E402
from egobox_torch import doe as tdoe  # noqa: E402


@pytest.mark.parametrize("ns,nx", [(9, 2), (7, 2), (8, 3), (5, 1), (10, 3),
                                   (1, 4), (30, 2)])
def test_full_factorial_equals_jax(ns, nx):
    """The same grid as egobox_tpu's, to the last bit, truncation to ns
    rows included (tests/test_doe.py:60-70)."""
    got = tdoe.full_factorial_normalized(ns, nx, device="cpu")
    want = np.asarray(jdoe.full_factorial_normalized(ns, nx, jnp.float64))
    assert got.shape == (ns, nx) and got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)


def test_full_factorial_and_random_objects():
    """The object APIs scale into their xlimits (tests/test_doe.py:61-80);
    FullFactorial equals egobox_tpu's, Random stays in the box and repeats
    with its seed."""
    xl = np.array([[0.0, 1.0], [-2.0, 3.0], [10.0, 11.0]])
    ff = tdoe.FullFactorial(xl, device="cpu").sample(9)
    np.testing.assert_allclose(
        ff.numpy(), np.asarray(jdoe.FullFactorial(jnp.asarray(xl)).sample(9)),
        rtol=0, atol=1e-15)
    np.testing.assert_array_equal(np.unique(ff[:, 2].numpy()), [10.0, 11.0])
    r = tdoe.Random(xl, seed=1, device="cpu")
    x = r.sample(50)
    assert x.shape == (50, 3)
    assert bool(((x >= torch.from_numpy(xl[:, 0]))
                 & (x <= torch.from_numpy(xl[:, 1]))).all())
    again = tdoe.Random(xl, seed=1, device="cpu").sample(50)
    assert torch.equal(x, again)
    assert not torch.equal(x, r.sample(50))  # the stream moves on
    u = tdoe.random_normalized(torch.Generator().manual_seed(2), 40, 2,
                               device="cpu")
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    with pytest.raises(ValueError, match="xlimits"):
        tdoe.Random(np.zeros(3), device="cpu")
    with pytest.raises(ValueError, match="xlimits"):
        tdoe.FullFactorial(np.zeros((2, 3)), device="cpu")


@pytest.mark.parametrize("x64", [False, True], ids=["float32", "float64"])
def test_threefry_stream_is_jaxs(x64):
    """doe/threefry.py draws JAX's bits: keys, splits, fold_in, random
    bits, uniforms, permutations, Rademacher draws and egobox_tpu's maximin
    LHS, over seeds (0xE60B0 is the probes' key) and sizes, in the type of
    each x64 mode (float32 off, as egobox_tpu runs on its accelerator;
    float64 on)."""
    from egobox_torch.doe import threefry as tf

    np_dt, jdt = (np.float64, jnp.float64) if x64 else (np.float32,
                                                         jnp.float32)
    with jax.enable_x64(x64):
        # a seed above 32 bits keeps its high word only with x64 on
        for seed in (0, 42, 0xE60B0, 2**31 - 1) + ((2**40 + 5,) if x64
                                                    else ()):
            k = jax.random.key(seed)
            kd = tf.key(seed)
            assert np.array_equal(kd, jax.random.key_data(k))
            assert np.array_equal(tf.split(kd, 5), jax.random.key_data(
                jax.random.split(k, 5)))
            assert np.array_equal(tf.fold_in(kd, 7), jax.random.key_data(
                jax.random.fold_in(k, 7)))
            assert np.array_equal(tf.random_bits(kd, 32, (7, 3)),
                                  jax.random.bits(k, (7, 3), jnp.uint32))
            assert np.array_equal(tf.uniform(kd, (11, 4), np_dt),
                                  jax.random.uniform(k, (11, 4), jdt))
            assert np.array_equal(tf.rademacher(kd, (50, 8), np_dt),
                                  jax.random.rademacher(k, (50, 8),
                                                        dtype=jdt))
            for n in (1, 8, 2000, 10_000):
                assert np.array_equal(tf.permutation(kd, n),
                                      jax.random.permutation(k, n))
            for ns, nx in ((1, 10), (3, 2), (20, 3)):
                got = tf.maximin_lhs(kd, ns, nx, np_dt)
                assert got.dtype == np_dt
                assert np.array_equal(got, jlhs.maximin_lhs(
                    k, ns, nx, False, 5, jdt))
