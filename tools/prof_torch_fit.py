#!/usr/bin/env python3
"""Profile one egobox_torch slice fit on one NVIDIA GPU.

    python3 tools/prof_torch_fit.py [--seed 1] [--top 15]

The fit of chip_smoke.py: n=10000, d=10 Griewank data, matern52, the
bench's shipped recipe, ``EGOBOX_CHOL=pallas:256:highest`` (both hand
kernels on the path). One warm-up fit (seed 0), then one unprofiled fit and
one fit under ``torch.profiler`` (CPU and CUDA activities) of ``--seed``.
Prints one JSON line: the wall times, the device busy time summed over all
device activity in the profiled fit, the idle share, the launch counts of
both kernels, the ``--top`` device-time sums by kernel name, and the sums
of the port's own kernels whatever their rank (``own``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import DIM, FIT_KW, N_TRAIN, griewank  # noqa: E402


def device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("prof_torch_fit: needs an NVIDIA GPU")
    from egobox_torch import gp
    from egobox_torch.ops import chol_kernel as chk, corr_kernel as ck

    os.environ["EGOBOX_CHOL"] = "pallas:256:highest"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()

    def fit(seed):
        rng = np.random.default_rng(seed)
        x = rng.uniform(-600.0, 600.0, (N_TRAIN, DIM))
        y = griewank(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = gp.fit_gp(x, y, seed=seed, **FIT_KW)
        float(model.likelihood)  # host sync
        return time.perf_counter() - t0

    fit(0)
    wall_plain = fit(args.seed)
    ck.launches = chk.launches = 0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall_prof = fit(args.seed)
    launches = {"corr_tile": ck.launches, "factor_panel": chk.launches}
    rows = []
    for evt in prof.key_averages():
        us = device_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((us, evt.count, evt.key))
    rows.sort(reverse=True)
    busy_s = sum(us for us, _, _ in rows) / 1e6
    own = [r for r in rows if any(k in r[2] for k in (
        "corr_tile_kernel", "panel_diag_kernel", "panel_apply_kernel"))]
    print(json.dumps({
        "card": card, "seed": args.seed,
        "fit_s_unprofiled": wall_plain, "fit_s_profiled": wall_prof,
        "device_busy_s": busy_s, "idle_share": 1.0 - busy_s / wall_prof,
        "launches": launches,
        "top": [{"kernel": k[:90], "ms": us / 1e3, "count": n}
                for us, n, k in rows[:args.top]],
        "own": [{"kernel": k[:90], "ms": us / 1e3, "count": n}
                for us, n, k in own],
    }), flush=True)


if __name__ == "__main__":
    main()
