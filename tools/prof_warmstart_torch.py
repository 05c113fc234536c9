#!/usr/bin/env python3
"""The warm starts of the slice fit, recipe against recipe, on one GPU.

    python3 tools/prof_warmstart_torch.py [--seeds 0 1 2 3]
        [--recipes single,slice,rank,draw2]

Fits chip_smoke.py's slice data (n=10 000, d=10, Griewank, Matern 5/2,
float32, the K2-driven Cholesky) at each seed with each recipe and prints
one JSON line per fit: seconds, likelihood, a float64 recomputation of it
at the fitted theta, the holdout Q2 on the seed's 2 000 points, K1's
launches by shape and K2's, counted from 0 around the fit. The recipes
are chip_smoke.py's FIT_KW with one subsample draw (``single``, fit_gp's
default), as shipped (``slice``, three draws), with the ranked warm start
(``rank``, HD_RANK_KW) and with the second-fidelity draw (``draw2``,
HD_DRAW2_KW). Nothing is gated: it shows where each recipe lands.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import (  # noqa: E402
    DEV, FIT_KW, HD_DRAW2_KW, HD_RANK_KW, _q2, make_data,
)

RECIPES = dict(single=dict(FIT_KW, sub_draws=1), slice=FIT_KW,
               rank=HD_RANK_KW, draw2=HD_DRAW2_KW)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1, 2, 3])
    ap.add_argument("--recipes", default=",".join(RECIPES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("prof_warmstart_torch: needs an NVIDIA GPU")
    from egobox_torch import gp
    from egobox_torch.gp.likelihood import reduced_likelihood
    from egobox_torch.ops import chol_kernel as chk
    from egobox_torch.ops import corr_kernel as ck

    for seed in args.seeds:
        x, y, xh, yh = make_data(torch, seed)
        x64 = torch.tensor(x, dtype=torch.float32, device=DEV).double()
        y64 = torch.tensor(y, dtype=torch.float32,
                           device=DEV).double()[:, None]
        xm, xs, ym, ys = x64.mean(0), x64.std(0), y64.mean(0), y64.std(0)
        for name in args.recipes.split(","):
            os.environ["EGOBOX_CHOL"] = "pallas:256:highest"
            ck.launches, chk.launches = 0, 0
            ck.launch_shapes.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model = gp.fit_gp(x, y, seed=seed, **RECIPES[name])
            lkh = float(model.likelihood)  # host sync
            fit_s = time.perf_counter() - t0
            k1, k2 = ck.launches, chk.launches
            shapes = {f"{a}x{b}": c
                      for (a, b), c in sorted(ck.launch_shapes.items())}
            mean, _ = gp.predict_valvar(model, xh)
            q2 = _q2(mean.double().cpu().numpy(),
                     yh.double().cpu().numpy())
            os.environ["EGOBOX_CHOL"] = "native"
            lkh64, _ = reduced_likelihood(
                "matern52", "constant", (x64 - xm) / xs, (y64 - ym) / ys,
                ys, model.theta.double(), None, FIT_KW["nugget"])
            print(json.dumps(dict(
                seed=seed, recipe=name, fit_s=fit_s, likelihood=lkh,
                likelihood_f64=float(lkh64), q2=q2, k1_launches=k1,
                k1_by_shape=shapes, k2_launches=k2,
                theta=model.theta.tolist(),
                device=torch.cuda.get_device_name(0))), flush=True)
            del model


if __name__ == "__main__":
    main()
