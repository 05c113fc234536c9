"""G24 (UTB) in float32: egobox_tpu against the port from egobox_tpu's DoE
and with its draws handed in, row by row, on the CPU.

    python tools/f32_g24_compare.py [--seeds 42,2] [--iters 30]

The configuration of tests/test_ego.py's G24 golden (UTB, cstr_tol 1e-3,
n_doe 5, q_optmod 2). egobox_tpu runs in float32 under
``jax.enable_x64(False)``, on its unfused path (EGOBOX_NO_FUSED_STEP=1,
which consumes its draws in the order of its fused path), its LHS draws
(the DoE, the scaling clouds, the multistart completions) recorded; its
fused default path is run too for its landing. The port runs in float32
on the CPU (``dtype=torch.float32``, unfused) with those draws replayed and
egobox_tpu's float32 fit seeds (tests/test_torch_f32_ego.py's
``_ReplayDraws``): as it is (its surrogates' nugget 100 eps32), with
egobox_tpu's nugget (100 x 2.2e-16, nothing in float32), and with
egobox_tpu's nugget and its float32 ``erfcx`` (the series from z = 25,
where the port switches at z = 9 in float32), which puts egobox_tpu's NaN
band back into LogEI. Each pair of runs
is compared row by row: the first row whose x differs by more than 1e-3
of the box width, and at the iteration that proposed it each side's
surrogate thetas and likelihoods. One JSON line per run and per
comparison. Not a tier-1 test: a seed takes minutes here.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
BOX = np.array([[0.0, 3.0], [0.0, 4.0]])
GOLDEN = -5.5080
PART_TOL = 1e-3  # of the box width


def g24(point):
    p = np.atleast_2d(point)
    x1, x2 = p[:, 0], p[:, 1]
    c1 = -2.0 * x1**4 + 8.0 * x1**3 - 8.0 * x1**2 + x2 - 2.0
    c2 = (-4.0 * x1**4 + 32.0 * x1**3 - 88.0 * x1**2 + 96.0 * x1 + x2
          - 36.0)
    return np.array([-x1 - x2, c1, c2]).T


def _kw(egx, seed):
    return dict(cstr_tol=np.array([1e-3, 1e-3]), n_cstr=2, seed=seed,
                q_optmod=2, n_doe=5,
                cstr_strategy=egx.ConstraintStrategy.UTB)


def _spy_fits(mod, log):
    """Record (thetas, likelihoods) of every surrogate fit ``mod``'s
    solver makes."""
    orig = mod.train_gp_surrogates

    def spy(*a, **k):
        m = orig(*a, **k)
        log.append((np.asarray(m.theta, dtype=float).tolist(),
                    np.asarray(m.likelihood, dtype=float).tolist()))
        return m

    mod.train_gp_surrogates = spy
    return orig


def reference_run(seed, iters, fused):
    """egobox_tpu in float32; with ``fused=False`` its LHS draws and fits
    recorded."""
    import jax

    import egobox_tpu as jegx
    from egobox_tpu.ego import solver as jsolver

    draws, fits, saved = [], [], {}
    if not fused:
        os.environ["EGOBOX_NO_FUSED_STEP"] = "1"
        for name in ("_lhs", "_lhs_in"):
            saved[name] = getattr(jsolver.EgorSolver, name)

            def rec(self, *a, _orig=saved[name], **k):
                pts = np.asarray(_orig(self, *a, **k))
                draws.append(pts)
                return pts

            setattr(jsolver.EgorSolver, name, rec)
        fit_orig = _spy_fits(jsolver, fits)
    try:
        t0 = time.perf_counter()
        with jax.enable_x64(False):
            res = jegx.Egor(BOX, **_kw(jegx, seed)).minimize(
                g24, max_iters=iters)
        wall = time.perf_counter() - t0
    finally:
        os.environ.pop("EGOBOX_NO_FUSED_STEP", None)
        for name, f in saved.items():
            setattr(jsolver.EgorSolver, name, f)
        if not fused:
            jsolver.train_gp_surrogates = fit_orig
    return dict(x=np.asarray(res.x_doe, dtype=float),
                x_opt=np.asarray(res.x_opt, dtype=float).tolist(),
                y_opt=np.asarray(res.y_opt, dtype=float).tolist(),
                wall_s=wall, draws=draws, fits=fits)


def _erfcx_switch_25(z):
    """egobox_tpu's erfcx (egobox_tpu/ego/criteria.py:32-40) in torch: the
    series from z = 25 in every type (NaN in float32 for z in (9.4, 25))."""
    import torch

    z_small = torch.clamp(z, max=25.0)
    direct = torch.exp(z_small * z_small) * torch.special.erfc(z_small)
    zs = torch.clamp(z, min=25.0)
    inv2 = 1.0 / (zs * zs)
    series = (1.0 - 0.5 * inv2 + 0.75 * inv2 * inv2) / (zs * 1.7724538509055159)
    return torch.where(z < 25.0, direct, series)


def port_run(seed, iters, draws, nugget, erfcx_25=False):
    """The port in float32 on the CPU, unfused, replaying ``draws``."""
    import torch

    import egobox_torch as egx
    from egobox_torch.ego import criteria as tc
    from egobox_torch.ego import solver as tsolver

    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_f32_ego import _ReplayDraws

    fits = []
    fit_orig = _spy_fits(tsolver, fits)
    erfcx_orig = tc.erfcx
    if erfcx_25:
        tc.erfcx = _erfcx_switch_25
    os.environ["EGOBOX_NO_FUSED_STEP"] = "1"
    try:
        egor = egx.Egor(BOX, device="cpu", dtype=torch.float32,
                        **_kw(egx, seed))
        egor.solver.draws = _ReplayDraws(draws)
        if nugget is not None:
            egor.solver.spec = dataclasses.replace(egor.solver.spec,
                                                   nugget=nugget)
        t0 = time.perf_counter()
        res = egor.minimize(g24, max_iters=iters)
        wall = time.perf_counter() - t0
    finally:
        os.environ.pop("EGOBOX_NO_FUSED_STEP", None)
        tsolver.train_gp_surrogates = fit_orig
        tc.erfcx = erfcx_orig
    return dict(x=np.asarray(res.x_doe, dtype=float),
                x_opt=np.asarray(res.x_opt, dtype=float).tolist(),
                y_opt=np.asarray(res.y_opt, dtype=float).tolist(),
                wall_s=wall, fits=fits)


def compare(ref, port, n_doe=5):
    """The first row whose x differs by more than PART_TOL of the box, and
    the two sides' fits at the iteration that proposed it."""
    width = BOX[:, 1] - BOX[:, 0]
    diff = np.max(np.abs(port["x"] - ref["x"]) / width, axis=1)
    parted = np.nonzero(diff > PART_TOL)[0]
    out = dict(rows=int(diff.shape[0]), max_row_diff=float(np.max(diff)),
               row_diffs=[float(d) for d in diff])
    if parted.size:
        row = int(parted[0])
        it = row - n_doe
        out.update(first_parting_row=row, iteration=it,
                   ref_x=ref["x"][row].tolist(), port_x=port["x"][row].tolist())
        if 0 <= it < min(len(ref["fits"]), len(port["fits"])):
            out.update(ref_fit=ref["fits"][it], port_fit=port["fits"][it])
    else:
        out["first_parting_row"] = None
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="42,2")
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    torch.set_num_threads(4)
    from egobox_tpu.ego.surrogates import GpSpec as JGpSpec

    ref_nugget = JGpSpec().nugget

    for seed in (int(s) for s in args.seeds.split(",")):
        fused = reference_run(seed, args.iters, fused=True)
        print(json.dumps(dict(seed=seed, run="egobox_tpu float32 fused",
                              x_opt=fused["x_opt"], y_opt=fused["y_opt"],
                              golden_miss=fused["y_opt"][0] - GOLDEN,
                              wall_s=fused["wall_s"])), flush=True)
        ref = reference_run(seed, args.iters, fused=False)
        print(json.dumps(dict(seed=seed, run="egobox_tpu float32 unfused",
                              x_opt=ref["x_opt"], y_opt=ref["y_opt"],
                              golden_miss=ref["y_opt"][0] - GOLDEN,
                              wall_s=ref["wall_s"])), flush=True)
        for label, nugget, erfcx_25 in (
                ("as it is", None, False),
                ("egobox_tpu's nugget", ref_nugget, False),
                ("egobox_tpu's nugget and float32 erfcx", ref_nugget, True)):
            port = port_run(seed, args.iters, ref["draws"], nugget, erfcx_25)
            print(json.dumps(dict(
                seed=seed, run=f"port float32 unfused, {label}",
                x_opt=port["x_opt"], y_opt=port["y_opt"],
                golden_miss=port["y_opt"][0] - GOLDEN,
                y_vs_egobox_tpu=port["y_opt"][0] - ref["y_opt"][0],
                wall_s=port["wall_s"],
                compare=compare(ref, port))), flush=True)


if __name__ == "__main__":
    main()
