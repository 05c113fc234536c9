#!/usr/bin/env python3
"""Smoke run of egobox_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device: requires CUDA, prints the card's name and power limit;
2. build: compiles the CUDA kernels from ``egobox_torch/csrc``;
3. K1 (Gram tile) against ``corr_cross_plain`` on the card, float32;
4. K2 (Cholesky panel) against float64 ``torch.linalg.cholesky``;
5. the slice: the dense kriging fit at n=10000, d=10 (Matern 5/2, K2-driven
   Cholesky) on Griewank data, then predict on 2000 holdout points.

It prints one JSON line describing the kernels, then, as its last line,
``{"ok": true, "device": {...}}``. Needs no network and imports no JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N_TRAIN, N_HOLD, DIM = 10_000, 2_000, 10
FIT_KW = dict(corr="matern52", n_start=1, max_iters=4, nugget=1e-3,
              subsample_warmstart=2000, sub_draws=3, polish_iters=1,
              polish_tr=True)
K1_ATOL = 2e-6
Q2_MIN = 0.98  # bench.py:125
DEV = "cuda"


def device_phase():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    print(smi[0], flush=True)
    return torch


def import_port():
    """Import egobox_torch from this checkout, and from nowhere else."""
    sys.path.insert(0, str(ROOT))
    import egobox_torch

    where = Path(egobox_torch.__file__).resolve().parent.parent
    if where != ROOT:
        raise RuntimeError(f"egobox_torch imported from {where}, not {ROOT}")
    if "jax" in sys.modules:
        raise RuntimeError("jax was imported")
    return egobox_torch


def time_ms(torch, fn, reps=5):
    """Median CUDA-event time of ``fn`` in ms, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def griewank(x):
    s = np.sum(x**2 / 4000.0, axis=1)
    p = np.prod(np.cos(x / np.sqrt(np.arange(1, x.shape[1] + 1))), axis=1)
    return s - p + 1.0


def k1_phase(torch, ck):
    """K1 against its plain version: 3 L1 kernels at 2000^2 and 10000^2
    (d=10) and the unaligned 37x41 (d=3)."""
    rng = np.random.default_rng(1)
    dev = DEV
    worst = 0.0
    cases = [(n, n, 10) for n in (2000, 10_000)] + [(37, 41, 3)]
    for n1, n2, d in cases:
        x1 = torch.tensor(rng.standard_normal((n1, d)), dtype=torch.float32,
                          device=dev)
        x2 = torch.tensor(rng.standard_normal((n2, d)), dtype=torch.float32,
                          device=dev)
        th = torch.tensor(rng.uniform(0.1, 1.5, d), dtype=torch.float32,
                          device=dev)
        for name in ("absolute_exponential", "matern32", "matern52"):
            got = ck.corr_cross_tile(name, x1, x2, th)
            ref = ck.corr_cross_plain(name, x1, x2, th)
            torch.cuda.synchronize()
            if got.shape != (n1, n2):
                raise RuntimeError(f"K1 shape {tuple(got.shape)}")
            err = float(torch.max(torch.abs(got - ref)))
            if not err <= K1_ATOL:
                raise RuntimeError(f"K1 {name} {n1}x{n2}x{d}: max abs err "
                                   f"{err:.3g} > {K1_ATOL}")
            worst = max(worst, err)
    # timing at the slice's full-data Gram: matern52, 10000^2, d=10
    x = torch.tensor(rng.standard_normal((N_TRAIN, DIM)), dtype=torch.float32,
                     device=dev)
    th = torch.full((DIM,), 0.5, dtype=torch.float32, device=dev)
    ms = time_ms(torch, lambda: ck.corr_cross_tile("matern52", x, x, th))
    plain_ms = time_ms(torch, lambda: ck.corr_cross_plain("matern52", x, x,
                                                          th))
    print(f"K1 corr_tile: {3 * len(cases)} cases, max abs err {worst!r} "
          f"(atol {K1_ATOL}); matern52 10000x10000 d=10: kernel {ms!r} ms, "
          f"plain {plain_ms!r} ms", flush=True)
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms)


def _spd(torch, n, seed):
    g = torch.Generator(device=DEV).manual_seed(seed)
    a = torch.randn((n, n), generator=g, dtype=torch.float64,
                    device=DEV) / n**0.5
    return a @ a.T + 2.0 * torch.eye(n, dtype=torch.float64, device=DEV)


def k2_phase(torch, chk, lik):
    """K2 against float64 torch.linalg.cholesky."""
    # one panel, the shape of tests/test_pallas_chol.py
    r = _spd(torch, 1024, 0)
    l64 = torch.linalg.cholesky(r)
    out = chk.factor_panel(r[:, :256].float().contiguous())
    torch.cuda.synchronize()
    panel_err = float(torch.max(torch.abs(out.double() - l64[:, :256])))
    if not panel_err <= 5e-5:
        raise RuntimeError(f"K2 factor_panel 1024x256: {panel_err:.3g}")
    # the full blocked Cholesky, 5 panels
    r = _spd(torch, 1280, 1)
    l_k2 = chk.panel_cholesky(r.float(), block=256)
    err1280 = float(torch.max(torch.abs(l_k2.double()
                                        - torch.linalg.cholesky(r))))
    if not err1280 <= 2e-4:
        raise RuntimeError(f"K2 panel_cholesky n=1280: {err1280:.3g}")
    # n=10240 on the slice's own kind of matrix: the Matern 5/2 R of
    # normalized Griewank inputs with the Gershgorin-scaled 1e-3 nugget
    rng = np.random.default_rng(2)
    x = rng.uniform(-600.0, 600.0, (10_240, DIM))
    x = (x - x.mean(0)) / x.std(0, ddof=1)
    xt = torch.tensor(x, dtype=torch.float32, device=DEV)
    th = torch.full((DIM,), 0.3, dtype=torch.float32, device=DEV)
    r32 = lik._build_r("matern52", xt, th, None, 1e-3, None)
    l64 = torch.linalg.cholesky(r32.double())
    l_k2 = chk.panel_cholesky(r32, block=256)
    l_lib = torch.linalg.cholesky_ex(r32)[0]
    err_k2 = float(torch.max(torch.abs(l_k2.double() - l64)))
    err_lib = float(torch.max(torch.abs(l_lib.double() - l64)))
    # f32 rounding in a Cholesky of order n grows with n * eps * cond(R);
    # the library's own f32 factor of the same R measures that floor, and
    # K2 may not exceed it by more than 4x
    tol = max(2e-4, 4.0 * err_lib)
    if not err_k2 <= tol:
        raise RuntimeError(f"K2 panel_cholesky n=10240: {err_k2:.3g} > "
                           f"{tol:.3g} (library f32: {err_lib:.3g})")
    chol_ms = time_ms(torch, lambda: chk.panel_cholesky(r32, block=256))
    lib_ms = time_ms(torch, lambda: torch.linalg.cholesky_ex(r32))
    a_panel = r32[:, :256].contiguous()
    ms = time_ms(torch, lambda: chk.factor_panel(a_panel))
    plain_ms = time_ms(torch, lambda: chk.factor_panel_plain(a_panel))
    print(f"K2 factor_panel: 1024x256 max abs err {panel_err!r} (atol 5e-5);"
          f" n=1280 {err1280!r} (atol 2e-4); n=10240 {err_k2!r} (tol "
          f"{tol!r}, library f32 {err_lib!r}); panel 10240x256: kernel "
          f"{ms!r} ms, plain {plain_ms!r} ms; Cholesky n=10240: "
          f"K2-driven {chol_ms!r} ms, cholesky_ex {lib_ms!r} ms", flush=True)
    del r32, l64, l_k2, l_lib
    torch.cuda.empty_cache()
    return dict(max_abs_err=panel_err, ms=ms, plain_ms=plain_ms,
                chol_ms=chol_ms, cholesky_ex_ms=lib_ms)


def make_data(torch, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-600.0, 600.0, (N_TRAIN + N_HOLD, DIM))
    y = griewank(x)
    xt = torch.tensor(x, dtype=torch.float32, device=DEV)
    yt = torch.tensor(y, dtype=torch.float32, device=DEV)
    return xt[:N_TRAIN], yt[:N_TRAIN], xt[N_TRAIN:], yt[N_TRAIN:]


def slice_phase(torch, ck, chk):
    from egobox_torch import gp
    from egobox_torch.gp.likelihood import reduced_likelihood

    os.environ["EGOBOX_CHOL"] = "pallas:256:highest"

    def fit(seed):
        x, y, xh, yh = make_data(torch, seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = gp.fit_gp(x, y, seed=seed, **FIT_KW)
        lkh = float(model.likelihood)  # host sync
        return time.perf_counter() - t0, lkh, model, (x, y, xh, yh)

    # the main-path run whose launches are counted
    ck.launches = 0
    chk.launches = 0
    _, lkh0, _, _ = fit(0)
    launches = {"corr_tile": ck.launches, "factor_panel": chk.launches}
    if not np.isfinite(lkh0):
        raise RuntimeError(f"warm-up fit likelihood {lkh0}")
    if min(launches.values()) <= 0:
        raise RuntimeError(f"a kernel was not launched by the fit: "
                           f"{launches}")

    times, q2s = [], []
    for seed in (1, 2, 3):
        before = (ck.launches, chk.launches)
        t, lkh, model, (x, y, xh, yh) = fit(seed)
        if not (ck.launches > before[0] and chk.launches > before[1]):
            raise RuntimeError(f"seed {seed}: a kernel counter did not rise")
        if not np.isfinite(lkh):
            raise RuntimeError(f"seed {seed}: likelihood {lkh}")
        # float64 plain recomputation at theta*: library Cholesky, plain Gram
        os.environ["EGOBOX_CHOL"] = "native"
        x64, y64 = x.double(), y.double()[:, None]
        xm, xs = x64.mean(0), x64.std(0)
        ym, ys = y64.mean(0), y64.std(0)
        lkh64, _ = reduced_likelihood(
            "matern52", "constant", (x64 - xm) / xs, (y64 - ym) / ys, ys,
            model.theta.double(), None, FIT_KW["nugget"],
        )
        os.environ["EGOBOX_CHOL"] = "pallas:256:highest"
        rel = abs(lkh - float(lkh64)) / abs(float(lkh64))
        if not rel <= 1e-3:
            raise RuntimeError(f"seed {seed}: f32 likelihood {lkh} vs f64 "
                               f"{float(lkh64)} (rel {rel:.3g} > 1e-3)")
        mean, var = gp.predict_valvar(model, xh)
        if not bool(torch.all(torch.isfinite(var)) & torch.all(var >= 0)):
            raise RuntimeError(f"seed {seed}: predict_var not finite/>= 0")
        if mean.shape != yh.shape or not bool(torch.all(
                torch.isfinite(mean))):
            raise RuntimeError(f"seed {seed}: bad predict {mean.shape}")
        yh64, mean64 = yh.double(), mean.double()
        q2 = 1.0 - float(torch.sum((yh64 - mean64) ** 2)
                         / torch.sum((yh64 - yh64.mean()) ** 2))
        if not q2 >= Q2_MIN:
            raise RuntimeError(f"seed {seed}: holdout Q2 {q2} < {Q2_MIN}")
        times.append(t)
        q2s.append(q2)
        print(f"slice seed {seed}: fit {t!r} s, likelihood {lkh!r} (f64 "
              f"{float(lkh64)!r}, rel {rel!r}), theta "
              f"{model.theta.tolist()}, holdout Q2 {q2!r}", flush=True)
        del model
    print(f"slice: n={N_TRAIN} d={DIM} matern52 fit median "
          f"{statistics.median(times)!r} s over seeds 1-3, Q2 min "
          f"{min(q2s)!r}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30!r} GiB", flush=True)
    return launches


def main():
    torch = device_phase()
    import_port()
    from egobox_torch.gp import likelihood as lik
    from egobox_torch.ops import build, chol_kernel as chk, corr_kernel as ck

    t0 = time.perf_counter()
    lib_path = build.build(force=True)
    build.load_library()
    print(f"build: {time.perf_counter() - t0!r} s -> "
          f"{lib_path.relative_to(ROOT)}", flush=True)
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    k1 = k1_phase(torch, ck)
    k2 = k2_phase(torch, chk, lik)
    launches = slice_phase(torch, ck, chk)

    kernels = [
        dict(name="corr_tile", route="cuda",
             source="egobox_torch/csrc/corr_tile.cu",
             replaces="egobox_tpu/ops/pallas_corr.py:73",
             launches=launches["corr_tile"], max_abs_err=k1["max_abs_err"],
             ms=k1["ms"], plain_ms=k1["plain_ms"]),
        dict(name="factor_panel", route="cuda",
             source="egobox_torch/csrc/chol_panel.cu",
             replaces="egobox_tpu/ops/pallas_chol.py:147",
             launches=launches["factor_panel"],
             max_abs_err=k2["max_abs_err"], ms=k2["ms"],
             plain_ms=k2["plain_ms"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
