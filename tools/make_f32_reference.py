"""Write tests/data/f32_reference.npz: egobox_tpu's float32 results on
inputs made from numpy seeds, and bench.py's own data, for the port's
float32 checks on the card (``chip_smoke.py --phases f32``), which imports
no JAX.

    python tools/make_f32_reference.py [--out PATH]

Runs egobox_tpu on the CPU with x64 off (``jax.enable_x64(False)``, the
float32 it computes in on its accelerator; the same numbers as a process
started with ``EGOBOX_TPU_NO_X64=1``, which tests/test_torch_f32_ego.py
checks). JAX is needed; it takes about 20 s. The file holds:

(a) the inputs and egobox_tpu's float32 outputs of the float32 lane's
    cases at sizes the card's routes reach (``reference_inputs`` /
    ``reference_outputs``):
    - ``gram_*``: a Matern 5/2 ``corr_cross`` of 1024 x 1024 points, d=10
      (1.05e7 elements: the K1 kernel on the card); every 16th row of the
      Gram and the row sums of all of it (the whole Gram is 4 MB);
    - ``lik_*``: the reduced likelihood and its analytic adjoint at fixed
      theta, n=2 000, d=10, constant trend, nugget 1e-3, for the squared
      exponential and Matern 5/2 (K1 on the card);
    - ``gp_*``: a model egobox_tpu fits in float32 (n=200, d=4, Matern 5/2,
      nugget 1e-3, 2 LHS starts, 20 iterations), every field, and its mean
      and variance at 100 points;
    - ``crit_*``: LogEI, EI and PoF over tests/test_torch_criteria.py's
      grid of u (variance 2.5), NaN where egobox_tpu's float32 LogEI is;
(b) ``bench_x{s}`` / ``bench_y{s}``: ``bench._make_data(jnp, jax, s,
    10 000, 10, float32)`` for the seeds of ``GOLDEN_DIRECT_LKH`` (1-3),
    threefry draws, the same bits on every backend. (Seed 0, bench.py's
    warm-up, is left out: the card warms up on seed 1.)

tests/test_torch_f32_gp.py regenerates (a) and holds the file to it, and
holds (b) to the SHA-256 digests this script prints.
"""

from __future__ import annotations

import argparse
import hashlib
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "tests" / "data" / "f32_reference.npz"

GRAM_N, GRAM_D, GRAM_ROW_STEP = 1024, 10, 16
LIK_N, LIK_D, LIK_CORRS = 2000, 10, ("squared_exponential", "matern52")
GP_N, GP_D, GP_Q, GP_CORR = 200, 4, 100, "matern52"
NUGGET = 1e-3
GP_FIT_KW = dict(corr=GP_CORR, nugget=NUGGET, n_start=2, max_iters=20)
CRIT_VAR, CRIT_FMIN = 2.5, 0.3
BENCH_SEEDS, BENCH_N, BENCH_D = (1, 2, 3), 10_000, 10
#: the GpModel fields carried over by ``egobox_torch.convert``
GP_FIELDS = ("x_norm", "x_mean", "x_std", "y_mean", "y_std", "theta",
             "beta", "gamma", "r_chol", "ft", "ft_qr_r", "sigma2",
             "likelihood", "mask")


def u_grid() -> np.ndarray:
    """tests/test_torch_criteria.py's U_GRID."""
    return np.concatenate([
        -np.logspace(7, -3, 41), [-1.0, -1e6, 0.0],
        np.linspace(0.01, 10.0, 12),
    ])


def reference_inputs() -> dict:
    """The inputs of (a), float32, from numpy seeds."""
    f32 = np.float32
    rng = np.random.default_rng(1010)
    out = {
        "gram_x1": rng.uniform(-1.0, 1.0, (GRAM_N, GRAM_D)).astype(f32),
        "gram_x2": rng.uniform(-1.0, 1.0, (GRAM_N, GRAM_D)).astype(f32),
        "gram_theta": rng.uniform(0.3, 1.5, GRAM_D).astype(f32),
    }
    x = rng.uniform(-600.0, 600.0, (LIK_N, LIK_D))
    y = (np.sum(x**2 / 4000.0, axis=1)
         - np.prod(np.cos(x / np.sqrt(np.arange(1, LIK_D + 1))), axis=1)
         + 1.0)[:, None]
    y_std = y.std(0, ddof=1)
    out["lik_x"] = ((x - x.mean(0)) / x.std(0, ddof=1)).astype(f32)
    out["lik_y"] = ((y - y.mean(0)) / y_std).astype(f32)
    out["lik_y_std"] = y_std.astype(f32)
    for corr in LIK_CORRS:
        out[f"lik_theta_{corr}"] = rng.uniform(0.05, 0.5, LIK_D).astype(f32)
    xg = rng.uniform(-2.0, 2.0, (GP_N, GP_D))
    out["gp_x"] = xg.astype(f32)
    out["gp_y"] = (np.sum(np.sin(2.0 * xg), axis=1)
                   + 0.05 * rng.standard_normal(GP_N)).astype(f32)
    out["gp_xq"] = rng.uniform(-2.0, 2.0, (GP_Q, GP_D)).astype(f32)
    u = u_grid()
    out["crit_mean"] = (CRIT_FMIN - u * np.sqrt(CRIT_VAR)).astype(f32)
    out["crit_var"] = np.full(u.shape, CRIT_VAR, f32)
    return out


def reference_outputs(inp: dict) -> dict:
    """egobox_tpu's float32 results on ``inp`` (x64 off for the call)."""
    import jax
    import jax.numpy as jnp

    from egobox_tpu import gp as jgp
    from egobox_tpu.ego import criteria as jc
    from egobox_tpu.gp import kernels as jk
    from egobox_tpu.gp import likelihood as jlk

    out = {}
    with jax.enable_x64(False):
        a = {k: jnp.asarray(v) for k, v in inp.items()}
        gram = np.asarray(jk.corr_cross("matern52", a["gram_x1"],
                                        a["gram_x2"], a["gram_theta"]))
        out["gram_rows"] = np.arange(0, GRAM_N, GRAM_ROW_STEP)
        out["gram_ref_rows"] = gram[out["gram_rows"]]
        out["gram_ref_row_sums"] = np.sum(gram.astype(np.float64), axis=1)
        for corr in LIK_CORRS:
            f = jlk.make_neg_reduced_likelihood(
                corr, "constant", a["lik_x"], a["lik_y"], a["lik_y_std"],
                None, NUGGET, None, 0)
            v, g = jax.value_and_grad(f)(a[f"lik_theta_{corr}"])
            out[f"lik_ref_neg_{corr}"] = np.asarray(v)
            out[f"lik_ref_grad_{corr}"] = np.asarray(g)
        model = jgp.fit_gp(a["gp_x"], a["gp_y"], **GP_FIT_KW)
        for k in GP_FIELDS:
            out[f"gp_{k}"] = np.asarray(getattr(model, k))
        mean, var = jgp.predict_valvar(model, a["gp_xq"])
        out["gp_ref_mean"] = np.asarray(mean)
        out["gp_ref_var"] = np.asarray(var)
        args = (a["crit_mean"], a["crit_var"], jnp.float32(CRIT_FMIN))
        out["crit_ref_log_ei"] = np.asarray(jc.log_ei(*args))
        out["crit_ref_ei"] = np.asarray(jc.ei(*args))
        out["crit_ref_pof"] = np.asarray(jc.pof(a["crit_mean"],
                                                a["crit_var"]))
    return out


def bench_data() -> dict:
    """(b): bench.py's data for the seeds of its golden, float32."""
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, str(ROOT))
    import bench

    out = {}
    with jax.enable_x64(False):
        for s in BENCH_SEEDS:
            x, y = bench._make_data(jnp, jax, s, BENCH_N, BENCH_D,
                                    jnp.float32)
            out[f"bench_x{s}"] = np.asarray(x)
            out[f"bench_y{s}"] = np.asarray(y)
    return out


def digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    inp = reference_inputs()
    data = {**inp, **reference_outputs(inp), **bench_data()}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(args.out, **data)
    print(f"{args.out}: {args.out.stat().st_size} bytes, {len(data)} arrays")
    for s in BENCH_SEEDS:
        for k in (f"bench_x{s}", f"bench_y{s}"):
            print(f"  {k} sha256 {digest(data[k])}")


if __name__ == "__main__":
    main()
