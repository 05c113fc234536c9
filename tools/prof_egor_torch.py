#!/usr/bin/env python3
"""Run the Egor cells of egobox_torch on the GPU and print, per run, the
result against its golden gate, the time per EGO iteration (split into
fit, cloud and infill on the unfused path, per graph call on the fused
path, per chunk on the traced run), the host reads per iteration and the
CUDA-graph statistics.

    python3 tools/prof_egor_torch.py [--cells xsinx,g24,trego,d10]
        [--paths fused,unfused,traced] [--dtypes policy,float32,float64]
        [--seeds 42] [--device cuda] [--precision]
        [--d10-doe 1000] [--d10-iters 4] [--graph-max-rows N]

Paths: ``fused`` is Egor's default (one program per iteration, a CUDA
graph per signature on the card), ``unfused`` sets EGOBOX_NO_FUSED_STEP=1,
``traced`` gives Egor the cell's objective in torch operations with
``traced_run=True`` (the whole run on the device, one fetch per chunk).
Host reads are the synchronizing operations PyTorch reports under
``torch.cuda.set_sync_debug_mode("warn")`` during ``minimize`` (the
device-to-host reads; the solver's host-to-device copies are asynchronous),
per EGO iteration.

Cells: ``xsinx`` (20 iterations, gate |y + 15.125| < 1e-3 and
|x - 18.935| < 1e-3), ``g24`` (G24 with 2 surrogate constraints, UTB,
q_optmod 2, 30 iterations, gate |y + 5.508| < 1e-2, x within 1e-2 of
(2.3295, 3.1785), feasible to 1e-3), ``trego`` (G24, TREGO, 40 iterations,
the gate on y), ``d10`` (Griewank on +-600, d = 10, a ``--d10-doe``-point
DoE (1 000), matern52, ``--d10-iters`` iterations (4); its Grams are the K1
kernel's in float32 only; each line also carries the memory the allocator
reserved after each iteration). ``--graph-max-rows`` sets
``ego.graphs.GRAPH_MAX_ROWS`` (the largest padded design the fused path
captures) for the run, to time graphs where the default does not take them.
``policy`` is the package's own choice of type (``config.egor_dtype``:
float64 below 4 096 points). ``--precision`` adds the float32 finding: the
posterior of one float64-fitted G24 model evaluated in float32 and float64.

Every line printed is one JSON object; the first carries the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import egobox_torch as egx  # noqa: E402
from egobox_torch.ops import corr_kernel  # noqa: E402


def xsinx(x):
    x = np.atleast_2d(x)
    return ((x - 3.5) * np.sin((x - 3.5) / np.pi)).reshape(-1, 1)


def g24(point):
    p = np.atleast_2d(point)
    x1, x2 = p[:, 0], p[:, 1]
    c1 = -2.0 * x1**4 + 8.0 * x1**3 - 8.0 * x1**2 + x2 - 2.0
    c2 = (-4.0 * x1**4 + 32.0 * x1**3 - 88.0 * x1**2 + 96.0 * x1 + x2
          - 36.0)
    return np.array([-x1 - x2, c1, c2]).T


def griewank(x):
    x = np.atleast_2d(x)
    i = np.sqrt(np.arange(1, x.shape[1] + 1))
    return (np.sum(x**2, axis=1) / 4000.0
            - np.prod(np.cos(x / i), axis=1) + 1.0).reshape(-1, 1)


G24_KW = dict(cstr_tol=np.array([1e-3, 1e-3]), n_cstr=2, n_doe=5)


def xsinx_t(x):
    return (x - 3.5) * torch.sin((x - 3.5) / np.pi)


def g24_t(p):
    x1, x2 = p[:, :1], p[:, 1:2]
    c1 = -2.0 * x1**4 + 8.0 * x1**3 - 8.0 * x1**2 + x2 - 2.0
    c2 = (-4.0 * x1**4 + 32.0 * x1**3 - 88.0 * x1**2 + 96.0 * x1 + x2
          - 36.0)
    return torch.cat([-x1 - x2, c1, c2], dim=1)


def griewank_t(x):
    i = torch.sqrt(torch.arange(1, x.shape[1] + 1, dtype=x.dtype,
                                device=x.device))
    return (torch.sum(x**2, dim=1) / 4000.0
            - torch.prod(torch.cos(x / i), dim=1) + 1.0)[:, None]


def run_cell(cell, seed, device, dtype, path="fused", d10_doe=1000,
             d10_iters=4):
    kw = dict(seed=seed, device=device, dtype=dtype,
              traced_run=path == "traced")
    traced = path == "traced"
    if cell == "xsinx":
        ego = egx.Egor([[0.0, 25.0]], **kw)
        fun, iters = (xsinx_t if traced else xsinx), 20
    elif cell == "g24":
        ego = egx.Egor([[0.0, 3.0], [0.0, 4.0]], q_optmod=2,
                       cstr_strategy=egx.ConstraintStrategy.UTB,
                       **G24_KW, **kw)
        fun, iters = (g24_t if traced else g24), 30
    elif cell == "trego":
        ego = egx.Egor([[0.0, 3.0], [0.0, 4.0]], trego=True, **G24_KW, **kw)
        fun, iters = (g24_t if traced else g24), 40
    elif cell == "d10":
        doe = np.random.default_rng(seed).uniform(-600.0, 600.0,
                                                  (d10_doe, 10))
        ego = egx.Egor(np.array([[-600.0, 600.0]] * 10), doe=doe,
                       corr_spec=egx.CorrelationSpec.MATERN52, **kw)
        fun, iters = (griewank_t if traced else griewank), d10_iters
    else:
        raise ValueError(cell)
    reserved = []
    if device == "cuda" and not traced:
        inner = fun

        def fun(x, inner=inner):
            # once for the DoE, then once per iteration
            reserved.append(torch.cuda.memory_reserved() / 2**30)
            return inner(x)
    corr_kernel.launches = 0
    if path == "unfused":
        os.environ["EGOBOX_NO_FUSED_STEP"] = "1"
    syncs = []
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if device == "cuda":
                torch.cuda.set_sync_debug_mode("warn")
            t0 = time.perf_counter()
            res = ego.minimize(fun, max_iters=iters)
            wall = time.perf_counter() - t0
            if device == "cuda":
                torch.cuda.set_sync_debug_mode("default")
        syncs = [w for w in caught if "synchroniz" in str(w.message)]
    finally:
        os.environ.pop("EGOBOX_NO_FUSED_STEP", None)
    times = ego.iteration_times
    n_iters = int(sum(t.get("iterations", 1) for t in times))
    stats = ego.solver.graphs.stats.as_dict()
    out = dict(
        cell=cell, path=path, seed=seed, device=device,
        dtype=str(ego.solver.dtype), x_opt=res.x_opt.tolist(),
        y_opt=res.y_opt.tolist(), n_doe=int(res.x_doe.shape[0]),
        iterations=n_iters, wall_s=wall, iters_per_s=n_iters / wall,
        k1_launches=corr_kernel.launches,
        host_reads=len(syncs), host_reads_per_iteration=len(syncs) / n_iters,
        graphs=stats, replays_per_iteration=stats["replays"] / n_iters,
        reserved_gib_per_iteration=reserved[1:],
    )
    keys = {"unfused": ("total", "fit", "cloud", "infill"),
            "fused": ("total", "select"), "traced": ("chunk",)}[path]
    for key in keys:
        vals = [t[key] for t in times]
        out[f"{key}_s_median"] = statistics.median(vals)
        out[f"{key}_s_max"] = max(vals)
    if path == "fused":
        for how in ("eager", "capture", "replay"):
            vals = [t["select"] for t in times if t["graph"] == how]
            if vals:
                out[f"select_s_median_{how}"] = statistics.median(vals)
    if cell == "xsinx":
        out["gate"] = bool(abs(res.y_opt[0] + 15.125) < 1e-3
                           and abs(res.x_opt[0] - 18.935) < 1e-3)
    elif cell in ("g24", "trego"):
        ok = abs(res.y_opt[0] + 5.5080) < 1e-2
        if cell == "g24":
            ok = (ok and abs(res.x_opt[0] - 2.3295) < 1e-2
                  and abs(res.x_opt[1] - 3.1785) < 1e-2)
        out["gate"] = bool(ok and np.all(res.y_opt[1:] <= 1e-3))
    else:
        out["gate"] = bool(res.y_opt[0] <= griewank(doe).min())
    return out


def precision_probe(device):
    """One G24 design clustered as the EGO loop clusters it, fitted in
    float64; the constraint posteriors at the optimum in both types."""
    from egobox_torch.ego.surrogates import (GpSpec, predict_valvar_single,
                                             train_gp_surrogates)
    rng = np.random.default_rng(0)
    xopt = np.array([2.3295, 3.1785])
    x = np.concatenate([
        rng.uniform([0.0, 0.0], [3.0, 4.0], (10, 2)),
        xopt + rng.normal(0.0, 1e-2, (25, 2)),
    ])
    y = g24(x)
    out = {}
    models64 = train_gp_surrogates(
        torch.as_tensor(x, device=device), torch.as_tensor(y, device=device),
        None, GpSpec(n_start=4), seed=0)
    probe = torch.as_tensor(xopt, device=device)
    m64, v64 = predict_valvar_single(models64, probe)
    out["mean_float64"] = m64.tolist()
    import dataclasses
    fields = {f.name: getattr(models64, f.name)
              for f in dataclasses.fields(models64)}
    models32 = type(models64)(**{
        k: (v.float() if isinstance(v, torch.Tensor)
            and v.dtype == torch.float64 else v) for k, v in fields.items()})
    m32, _ = predict_valvar_single(models32, probe.float())
    out["mean_float32_of_float64_fit"] = m32.tolist()
    models32f = train_gp_surrogates(
        torch.as_tensor(x, device=device, dtype=torch.float32),
        torch.as_tensor(y, device=device, dtype=torch.float32),
        None, GpSpec(n_start=4), seed=0)
    m32f, _ = predict_valvar_single(models32f, probe.float())
    out["mean_float32_fit"] = m32f.tolist()
    out["truth"] = g24(xopt)[0].tolist()
    out["nugget_float32"] = 100.0 * torch.finfo(torch.float32).eps
    return dict(precision_probe=out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", default="xsinx,g24,trego,d10")
    ap.add_argument("--paths", default="fused")
    ap.add_argument("--dtypes", default="policy")
    ap.add_argument("--seeds", default="42")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--precision", action="store_true")
    ap.add_argument("--d10-doe", type=int, default=1000)
    ap.add_argument("--d10-iters", type=int, default=4)
    ap.add_argument("--graph-max-rows", type=int, default=None)
    args = ap.parse_args()
    if args.graph_max_rows is not None:
        from egobox_torch.ego import graphs
        graphs.GRAPH_MAX_ROWS = args.graph_max_rows
    card = None
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
        ).stdout.strip()
    print(json.dumps(dict(card=card, torch=torch.__version__)), flush=True)
    dtypes = {"policy": None, "float32": torch.float32,
              "float64": torch.float64}
    if args.precision:
        print(json.dumps(precision_probe(args.device)), flush=True)
    for cell in args.cells.split(","):
        for path in args.paths.split(","):
            for name in args.dtypes.split(","):
                for seed in args.seeds.split(","):
                    out = run_cell(cell, int(seed), args.device,
                                   dtypes[name], path, args.d10_doe,
                                   args.d10_iters)
                    out["asked_dtype"] = name
                    out["card"] = card
                    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
