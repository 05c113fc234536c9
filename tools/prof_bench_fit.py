"""bench.py's shipped fit on bench.py's data, on the card, against bench.py's
quality gate, by draw stream.

    python tools/prof_bench_fit.py --make-draws build/jax_fit_draws.npz
        (CPU, jax needed: egobox_tpu's draws of that fit)
    python tools/prof_bench_fit.py [--draws build/jax_fit_draws.npz]
        [--fit-seeds 0-15] [--polish-iters 10]          (the card)

The fit is bench.py:275-277's (squared exponential, float32, nugget 1e-3,
3 subsample draws of 2 000 points, 1 + 1 restarts x 4 iterations, one
trust-region polish iteration with the 64-probe Hutchinson gradient; fit
seed 42, fit_gp's default, as bench.py calls it) on bench.py's data of
seeds 1-3 (tests/data/f32_reference.npz). Each run prints one JSON line:
data seed, draw stream, wall seconds, likelihood, and the deficit
``100 (gold - lkh) / |gold|`` against bench.py's GOLDEN_DIRECT_LKH (gate
1.0 %, bench.py QUALITY_TOL_PCT). Streams: ``port``, what ``fit_gp`` draws
(egobox_tpu's threefry key stream, gp.fit._recipe_draws, and its probes);
``torch``, the torch-generator stream the port drew from before (a
``FitDraws`` per fit, probes from a generator seeded with 0xE60B0);
``handed``, egobox_tpu's draws computed by JAX (``--make-draws``) and
handed in, which must give ``port``'s numbers. ``port`` also in float64
and with ``--polish-iters`` polish iterations; ``port`` and ``torch`` at
the ``--fit-seeds`` too (the spread of the recipe over its draws). No JAX
on the card: the handed draws come from the file.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import BENCH_FIT_KW, F32_FILE, GOLDEN_DIRECT_LKH  # noqa: E402

FIT_SEED, SUB_DRAWS, N, D, PROBES = 42, 3, 10_000, 10, 64


def make_draws(path: Path):
    """egobox_tpu's draws of ``fit_gp(seed=42, sub_draws=3, n_start=1)``
    at n=10 000, d=10 in float32 (gp/fit.py _fit_mf_fused's key stream,
    as tests/test_torch_fit.py hands it to the port) and the probes of
    gp/likelihood.py _sqexp_dphi_stoch."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from egobox_tpu.doe.lhs import maximin_lhs

    with jax.enable_x64(False):
        ksub, _ = jax.random.split(jax.random.key(FIT_SEED))
        dkeys = jax.random.split(ksub, 2 * SUB_DRAWS)
        perms = np.stack([np.asarray(jax.random.permutation(k, N))
                          for k in dkeys[:SUB_DRAWS]]).astype(np.int16)
        lhs = np.stack([np.asarray(maximin_lhs(k, 1, D, False, 5,
                                               jnp.float32))
                        for k in dkeys[SUB_DRAWS:]])
        probes = np.asarray(jax.random.rademacher(
            jax.random.key(0xE60B0), (N, PROBES), dtype=jnp.float32))
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, perms=perms, lhs=lhs,
                        probes=probes.astype(np.int8))
    print(f"{path}: {path.stat().st_size} bytes")


class _Replay:
    def __init__(self, perms, lhs):
        self.perms, self.lhs = list(perms), list(lhs)

    def permutation(self, n, device):
        import torch

        return torch.from_numpy(self.perms.pop(0).astype(np.int64)).to(device)

    def lhs_seeds(self, n_start, dim, dtype, device):
        import torch

        return torch.from_numpy(self.lhs.pop(0)).to(dtype=dtype,
                                                    device=device)


def run(args):
    import torch

    import egobox_torch as egx
    from egobox_torch.gp import fit as tfit
    from egobox_torch.gp import likelihood as tlk

    if not torch.cuda.is_available():
        raise SystemExit("prof_bench_fit.py: needs an NVIDIA GPU")
    ref = np.load(F32_FILE)
    jd = np.load(args.draws) if args.draws else None
    saved = tfit._recipe_draws, tlk._rademacher_probes

    def torch_probes(n, q, dtype, device):
        gen = torch.Generator().manual_seed(0xE60B0)
        z = torch.randint(0, 2, (n, q), generator=gen)
        return (2 * z - 1).to(dtype=dtype, device=device)

    def fit(seed, stream, fit_seed=FIT_SEED, dtype=torch.float32, **kw):
        x = torch.from_numpy(ref[f"bench_x{seed}"]).to("cuda", dtype)
        y = torch.from_numpy(ref[f"bench_y{seed}"]).to("cuda", dtype)
        if stream == "handed":
            tfit._recipe_draws = lambda s, *a: _Replay(jd["perms"],
                                                       jd["lhs"])
            z = torch.from_numpy(jd["probes"].astype(np.float32))
            tlk._rademacher_probes = (
                lambda n, q, dt, device: z.to(device=device, dtype=dt))
        elif stream == "torch":
            tfit._recipe_draws = lambda s, *a: tfit.FitDraws(s)
            tlk._rademacher_probes = torch_probes
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = egx.gp.fit_gp(x, y, seed=fit_seed,
                              **dict(BENCH_FIT_KW, **kw))
            lkh = float(m.likelihood)
            wall = time.perf_counter() - t0
        finally:
            tfit._recipe_draws, tlk._rademacher_probes = saved
        gold = GOLDEN_DIRECT_LKH[seed]
        out = dict(data_seed=seed, stream=stream, fit_seed=fit_seed,
                   dtype=str(dtype).split(".")[-1], wall_s=wall,
                   likelihood=lkh, quality_delta_pct=100.0 * (gold - lkh)
                   / abs(gold), theta=m.theta.tolist(), **kw)
        print(json.dumps(out), flush=True)
        return out

    fit(1, "port")  # warm-up
    for seed in (1, 2, 3):
        fit(seed, "port")
        if jd is not None:
            fit(seed, "handed")
        fit(seed, "torch")
        fit(seed, "port", dtype=torch.float64)
        fit(seed, "port", polish_iters=args.polish_iters)
    lo, hi = (int(v) for v in args.fit_seeds.split("-"))
    spread = {}
    for stream in ("port", "torch"):
        for seed in (1, 2, 3):
            spread[f"{stream} {seed}"] = [
                fit(seed, stream, fit_seed=fs)["quality_delta_pct"]
                for fs in range(lo, hi + 1)]
    print(json.dumps({"deltas_by_stream_and_data_seed_over_fit_seeds":
                      spread}))
    print(subprocess_smi(), flush=True)


def subprocess_smi():
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--make-draws", type=Path)
    ap.add_argument("--draws", type=Path)
    ap.add_argument("--fit-seeds", default="0-15")
    ap.add_argument("--polish-iters", type=int, default=10)
    args = ap.parse_args()
    if args.make_draws:
        make_draws(args.make_draws)
    else:
        run(args)


if __name__ == "__main__":
    main()
