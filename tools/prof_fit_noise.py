#!/usr/bin/env python3
"""How far rounding noise in R moves the end point of the slice fit.

    python3 tools/prof_fit_noise.py [--eps 1e-7 3e-8]

Fits chip_smoke.py's slice (n=10000, d=10, matern52, seeds 1-3) on one
NVIDIA GPU as it is, then again with every symmetric K1 Gram multiplied
by ``1 + eps * e``, ``e`` a fixed symmetric matrix of uniform noise in
(-1, 1), the diagonal kept at 1. Prints the likelihood and the first
three components of theta* of each fit. A change to K1 that only moves
R's rounding (a few 1e-8 relative) can be told from a fault by this: where
the noise moves theta* as far as the change did, the truncated optimizer
branches on rounding and the change is not to blame.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import FIT_KW, make_data  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--eps", type=float, nargs="*", default=[1e-7, 3e-8])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("prof_fit_noise: needs an NVIDIA GPU")
    from egobox_torch import gp
    from egobox_torch.ops import corr_kernel as ck

    os.environ["EGOBOX_CHOL"] = "pallas:256:highest"
    kernel = ck.corr_cross_tile

    def fits(tag):
        for seed in (1, 2, 3):
            x, y, _, _ = make_data(torch, seed)
            model = gp.fit_gp(x, y, seed=seed, **FIT_KW)
            print(f"{tag} seed {seed}: likelihood "
                  f"{float(model.likelihood)!r}, theta[:3] "
                  f"{model.theta.tolist()[:3]}", flush=True)

    fits("as it is")
    for eps in args.eps:
        def noisy(name, x1, x2, theta_w, row_sums=False, eps=eps):
            res = kernel(name, x1, x2, theta_w, row_sums)
            r = res[0] if row_sums else res
            if x1.data_ptr() == x2.data_ptr():
                gen = torch.Generator(device="cuda").manual_seed(1)
                e = torch.rand(r.shape, generator=gen, device="cuda") - 0.5
                r.mul_(1.0 + (e + e.T) * eps)
                r.diagonal().fill_(1.0)
            return res

        ck.corr_cross_tile = noisy
        try:
            fits(f"noise {eps:g}")
        finally:
            ck.corr_cross_tile = kernel


if __name__ == "__main__":
    main()
