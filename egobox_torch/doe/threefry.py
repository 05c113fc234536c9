"""JAX's default random stream (threefry2x32, ``jax_threefry_partitionable``
on, its default) in numpy: keys, splits, ``fold_in``, random bits,
uniforms, permutations, Rademacher draws and egobox_tpu's maximin LHS, bit
for bit. The draws are small (a few 10^4 numbers), so numpy on the host
serves them; the caller moves the result to its device.

The port draws its EGO loop from torch generators, but a fit recipe that
draws subsamples is a lottery over its draws: bench.py's shipped fit was
calibrated to its 1 % quality gate on the threefry draws of
``fit_gp(seed=42)`` (0.19 / 0.49 / 0.39 % on its data's seeds 1-3), and
another stream's draws miss it on some seeds. So the subsample recipes of
``gp.fit.fit_gp`` and the stochastic gradient's probes draw from this
module, the stream egobox_tpu draws from (gp/fit.py, gp/likelihood.py).
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: after each group of 4 rounds: (key word added to x0, key word added to
#: x1, the group's counter added to x1)
_INJECT = ((1, 2, 1), (2, 0, 2), (0, 1, 3), (1, 2, 4), (2, 0, 5))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry 2x32 hash of the counter pairs (x1, x2) under the key
    (k1, k2): 20 rounds (jax/_src/prng.py ``_threefry2x32_lowering``)."""
    u32 = np.uint32
    x1 = np.asarray(x1, u32).copy()
    x2 = np.asarray(x2, u32).copy()
    ks = (u32(k1), u32(k2), u32(k1) ^ u32(k2) ^ u32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x1 += ks[0]
        x2 += ks[1]
        for i, (a, b, c) in enumerate(_INJECT):
            for r in _ROTATIONS[i % 2]:
                x1 += x2
                x2 = (x2 << u32(r)) | (x2 >> u32(32 - r))
                x2 ^= x1
            x1 += ks[a]
            x2 += ks[b] + u32(c)
    return x1, x2


def key(seed: int) -> np.ndarray:
    """``jax.random.key(seed)``'s data: the 64-bit seed as two words."""
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    np.uint32)


def _hash_iota(k, shape):
    """threefry2x32 of the 64-bit iota over ``shape`` (high words 0)."""
    n = math.prod(shape)
    lo = np.arange(n, dtype=np.uint32).reshape(shape)
    return threefry2x32(k[0], k[1], np.zeros(shape, np.uint32), lo)


def split(k, num: int = 2) -> np.ndarray:
    """``jax.random.split(k, num)``: (num, 2) keys."""
    b1, b2 = _hash_iota(k, (num,))
    return np.stack([b1, b2], axis=1)


def fold_in(k, data: int) -> np.ndarray:
    """``jax.random.fold_in(k, data)``."""
    b1, b2 = threefry2x32(k[0], k[1], [0], [data & 0xFFFFFFFF])
    return np.array([b1[0], b2[0]], np.uint32)


def random_bits(k, bit_width: int, shape) -> np.ndarray:
    """``jax.random.bits``: 32-bit words, or 64-bit ones."""
    b1, b2 = _hash_iota(k, tuple(shape))
    if bit_width == 32:
        return b1 ^ b2
    return (b1.astype(np.uint64) << np.uint64(32)) | b2.astype(np.uint64)


def uniform(k, shape, dtype) -> np.ndarray:
    """``jax.random.uniform(k, shape, dtype)`` on [0, 1), float32 or
    float64: the top mantissa bits of one draw, exponent of 1, minus 1."""
    dtype = np.dtype(dtype)
    if dtype == np.float32:
        bits = (random_bits(k, 32, shape) >> np.uint32(9)) | np.uint32(
            0x3F800000)
        out = bits.view(np.float32) - np.float32(1.0)
    else:
        bits = (random_bits(k, 64, shape) >> np.uint64(12)) | np.uint64(
            0x3FF0000000000000)
        out = bits.view(np.float64) - 1.0
    return np.maximum(out, dtype.type(0.0))


def permutation(k, n: int) -> np.ndarray:
    """``jax.random.permutation(k, n)``: stable sorts of arange(n) by fresh
    32-bit keys, as many rounds as make collisions negligible."""
    x = np.arange(n)
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        k, sub = split(k)
        x = x[np.argsort(random_bits(sub, 32, (n,)), kind="stable")]
    return x


def rademacher(k, shape, dtype) -> np.ndarray:
    """``jax.random.rademacher(k, shape, dtype)`` as egobox_tpu draws it:
    the Bernoulli's uniform in float32 when x64 is off (float32 data), in
    float64 when it is on."""
    b = uniform(k, shape, dtype) < np.dtype(dtype).type(0.5)
    return (2 * b.astype(dtype) - 1).astype(dtype)


def _fma(a, b, c, dtype) -> np.ndarray:
    """a * b + c rounded once to ``dtype``, as XLA's CPU code fuses it:
    exact in float64 for float32 operands, by fractions for float64."""
    if dtype == np.float32:
        return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
                + np.asarray(c, np.float64)).astype(np.float32)
    a, b, c = np.broadcast_arrays(a, b, c)
    out = np.empty(a.shape, np.float64)
    for i in np.ndindex(a.shape):
        out[i] = float(Fraction(float(a[i])) * Fraction(float(b[i]))
                       + Fraction(float(c[i])))
    return out


def _min_pdist_sq(x: np.ndarray):
    """egobox_tpu/doe/utils.py ``min_pdist_sq`` (the GEMM expansion)."""
    a2 = np.sum(x * x, axis=1)
    sq = np.maximum(a2[:, None] + a2[None, :] - 2.0 * (x @ x.T), 0.0)
    np.fill_diagonal(sq, np.inf)
    return np.min(sq)


def maximin_lhs(k, ns: int, nx: int, dtype, n_draws: int = 5) -> np.ndarray:
    """egobox_tpu's ``maximin_lhs(k, ns, nx, False, n_draws, dtype)``: the
    best of ``n_draws`` classic LHS (a uniform point in each of ns strata,
    the columns permuted independently) by minimum pairwise distance."""
    dtype = np.dtype(dtype)
    draws = []
    for kd in split(k, n_draws):
        k1, k2 = split(kd)
        u = uniform(k1, (ns, nx), dtype)
        # arange(ns) / ns + u / ns: XLA divides by the constant as a
        # product with its reciprocal, the first product fused into the sum
        inv = dtype.type(1.0) / dtype.type(ns)
        pts = _fma(np.arange(ns, dtype=dtype)[:, None], inv, u * inv, dtype)
        perms = np.stack([permutation(kc, ns) for kc in split(k2, nx)])
        draws.append(np.take_along_axis(pts, perms.T, axis=0))
    scores = [_min_pdist_sq(d) for d in draws]
    return draws[int(np.argmax(scores))]
