#!/usr/bin/env python3
"""Time a multistart GP fit of egobox_torch with its restarts as lockstep
lanes on a stack of thetas against the same fit lane after lane, on one
NVIDIA GPU: where ``gp.fit.fit_gp_core`` should switch between the two.

    python3 tools/prof_fit_lanes.py [--ns 250,500,1000,1500,2000]
        [--cases 5:8:10,2:0:4] [--d 10] [--corr matern52]
        [--dtype float32]

A case is ``lanes:ls_batch:max_iters``: 5:8:10 is a warm refit of the Egor
loop (4 restarts and the carried theta, the speculative line search), 2:0:4
a subfit of the n = 10 000 recipe. Data: Griewank on +-600. For every n and
case one warm-up fit and one timed fit (host clock around a synchronised
fit) in each mode, the mode forced through ``gp.fit``'s two limits. Prints
one JSON line per n and case with both times, both likelihoods and the
peak memory of each mode; the first line carries the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import griewank  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ns", default="250,500,1000,1500,2000")
    ap.add_argument("--cases", default="5:8:10,2:0:4")
    ap.add_argument("--d", type=int, default=10)
    ap.add_argument("--corr", default="matern52")
    ap.add_argument("--dtype", default="float32")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("prof_fit_lanes: needs an NVIDIA GPU")
    from egobox_torch import gp
    from egobox_torch.gp import fit as tfit

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps(dict(card=card, torch=torch.__version__)), flush=True)
    dtype = getattr(torch, args.dtype)
    modes = {"lanes_at_once": (2**62, 2**62), "lane_after_lane": (0, 0)}

    for n in (int(v) for v in args.ns.split(",")):
        rng = np.random.default_rng(n)
        x = rng.uniform(-600.0, 600.0, (n, args.d))
        xt = torch.tensor(x, dtype=dtype, device="cuda")
        yt = torch.tensor(griewank(x), dtype=dtype, device="cuda")
        for case in args.cases.split(","):
            lanes, ls_batch, max_iters = (int(v) for v in case.split(":"))
            out = dict(n=n, d=args.d, corr=args.corr, dtype=args.dtype,
                       lanes=lanes, ls_batch=ls_batch, max_iters=max_iters,
                       card=card)
            for mode, (nbytes, points) in modes.items():
                tfit._LANES_BYTES, tfit._LANES_MAX_POINTS = nbytes, points
                for timed in (False, True):
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    t0 = time.perf_counter()
                    model = gp.fit_gp(xt, yt, corr=args.corr,
                                      n_start=lanes - 1, max_iters=max_iters,
                                      ls_batch=ls_batch, seed=1)
                    lkh = float(model.likelihood)  # host sync
                    dt = time.perf_counter() - t0
                out[f"{mode}_s"] = dt
                out[f"{mode}_likelihood"] = lkh
                out[f"{mode}_peak_gib"] = (
                    torch.cuda.max_memory_allocated() / 2**30)
            print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
