#!/usr/bin/env python3
"""Count the PyTorch operations of one lockstep L-BFGS iteration of the
constrained infill (G24: objective + 2 constraints, 20 lanes, the
augmented-Lagrangian path at its default budget).

    python3 tools/prof_infill_ops.py [--device cpu|cuda]

Prints one JSON line: L-BFGS iterations run, ``aten::`` operations in all
and per iteration (views and allocations included), and the wall seconds of
the call. The count is the same on every device; the
seconds are those of the device asked for.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from egobox_torch.ego import infill_optim as tio  # noqa: E402
from egobox_torch.ego import surrogates as tsur  # noqa: E402
from egobox_torch.optim import lbfgsb  # noqa: E402


def g24(p):
    x1, x2 = p[:, 0], p[:, 1]
    c1 = -2.0 * x1**4 + 8.0 * x1**3 - 8.0 * x1**2 + x2 - 2.0
    c2 = (-4.0 * x1**4 + 32.0 * x1**3 - 88.0 * x1**2 + 96.0 * x1 + x2
          - 36.0)
    return np.array([-x1 - x2, c1, c2]).T


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    dev = ap.parse_args().device
    rng = np.random.default_rng(0)
    lo, hi = np.array([0.0, 0.0]), np.array([3.0, 4.0])

    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float64, device=dev)

    x = rng.uniform(lo, hi, (20, 2))
    models = tsur.train_gp_surrogates(
        t(x), t(g24(x)), None,
        tsur.GpSpec(n_start=2, max_iters=10, nugget=1e-8), seed=0)
    starts, tols = t(rng.uniform(lo, hi, (20, 2))), t([1e-3, 1e-3])
    scales = tio.compute_scaling(models, starts, -3.0, tols, n_cstr=2)

    iterations = 0
    two_loop = lbfgsb._two_loop_lanes

    def counted(*args):
        nonlocal iterations
        iterations += 1
        return two_loop(*args)

    lbfgsb._two_loop_lanes = counted
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        x_best, f_best, _ = tio.optimize_infill(
            models, starts, t(lo), t(hi), -3.0, scales[0], scales[2],
            scales[1], tols, n_cstr=2)
        f_best = float(f_best)  # host sync
        seconds = time.perf_counter() - t0
    lbfgsb._two_loop_lanes = two_loop
    ops = sum(e.count for e in prof.key_averages()
              if e.key.startswith("aten::"))
    print(json.dumps(dict(
        device=dev, lbfgs_iterations=iterations, aten_ops=ops,
        aten_ops_per_iteration=ops / iterations, seconds=seconds,
        seconds_per_iteration=seconds / iterations,
        note="seconds include the profiler's own cost")))


if __name__ == "__main__":
    main()
