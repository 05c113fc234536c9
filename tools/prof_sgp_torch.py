#!/usr/bin/env python3
"""The sparse GP of egobox_torch at scale on one NVIDIA GPU, with float32
points (its large Matern / absexp Grams from K1) or float64 points.

    python3 tools/prof_sgp_torch.py
        [--cases corr:method:n:nz:n_start:max_iters:seed,...]
        [--data float32,float64] [--nuggets default,1e-6,...] [--warm 2000]

Each case fits ``gp.fit_sgp`` on the first ``n`` rows of chip_smoke.py's
sparse data (Griewank on +-600 divided by 600, d=10, 5 % noise) with
``nz`` inducing points, ``n_start`` LHS lanes, ``max_iters`` iterations,
the fit's ``seed`` and a ``--warm``-row dense warm start, once per data
type: ``float32`` hands in the float32 numpy data (float32 points and
Grams, K1's where ``gp.kernels.corr_cross`` takes them, the nugget
relative to sigma2), ``float64`` the same values as float64 (every Gram
in float64, the nugget absolute). With float32 data the fit runs once per
``--nuggets`` value (``default``: the fit's own). Prints, per run, one
JSON line: fit seconds, lanes x iterations, K1 launches, theta, sigma2,
noise, the fit's likelihood, two float64 recomputations on the card at
the fitted parameters (the same model: float64 Grams with the run's
nugget as an absolute one, ``likelihood_same_model_float64``; and the
float64 fit's model, absolute nugget 1000 eps64,
``likelihood_float64_model``), and the holdout Q2 on 2 000 clean points.
Defaults: chip_smoke.py phase 13's case (b) and the VFE fit of (c).

    python3 tools/prof_sgp_torch.py --cv [--cv-n 20000] [--data ...]

runs instead gpqa's 5-fold cross-validation (``moe.metrics.q2_score``
with ``sgp_fit_predict``: Matern 5/2, VFE, 256 inducing points, the
hook's defaults) on the first ``--cv-n`` rows, with float32 and with
float64 points, and prints the Q2 of each.

    python3 tools/prof_sgp_torch.py --kzz [--kzz-corr matern52]
        [--thetas 0.1,0.15,0.2,0.3]

reports instead, on the CPU, why the algebra is float64: for the
n=50 000, M=512 recipe's inducing points (fit seed 1) and a theta set to
each value in every dimension, sigma2 = 9 var(y) (where the fits end) and
egobox_tpu's absolute nugget 1000 eps of each type, whether a float32
Cholesky of sigma2 K(Z, Z) + nugget I succeeds, the smallest eigenvalue
of that matrix in float32 and in float64, and the FITC likelihood (noise
9) computed wholly in float32 and in float64.

    python3 tools/prof_sgp_torch.py --grad-faults

prints the relative error of K1Gram's theta gradient at chip_smoke.py's
fit shape (512 x 50 000, Matern 5/2, theta 0.1 to 0.2) against a float64
autograd of the plain formula: the sound backward, and planted faults
(the Matern 3/2 term in place of the Matern 5/2 one; theta scaled by
1 + 1e-3, 1e-4, 1e-5 in the backward), to place the limit of
chip_smoke.py's gradient check between them.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def run(corr, method, n, nz, n_start, max_iters, seed, data, nugget, warm):
    from egobox_torch.gp import sgp
    from egobox_torch.ops import corr_kernel as ck

    x, y, xh, yh = cs.sgp_data()
    x, y = x[:n], y[:n]
    if data == "float64":
        x, y = x.astype(np.float64), y.astype(np.float64)
    ck.launches = 0
    info = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = sgp.fit_sgp(x, y, corr=corr, method=method, n_inducing=nz,
                    n_start=n_start, max_iters=max_iters, seed=seed,
                    subsample_warmstart=warm, nugget=nugget, info=info)
    lkh = float(m.likelihood)
    fit_s = time.perf_counter() - t0
    launches = ck.launches
    q2 = cs._q2(sgp.sgp_predict(m, xh).double().cpu().numpy(), yh)
    eps64 = torch.finfo(torch.float64).eps
    rho = sgp._default_nugget(m.z.dtype) if nugget is None else nugget
    same = rho * float(m.sigma2) if m.z.dtype == torch.float32 else rho
    x64 = torch.tensor(x, dtype=torch.float64, device=cs.DEV)
    y64 = torch.tensor(y, dtype=torch.float64, device=cs.DEV)[:, None]
    z64 = m.z.double()
    lik = sgp._LIKELIHOODS[method]
    with torch.no_grad():
        l_same = float(lik(corr, m.theta, m.sigma2, m.noise, x64, y64, z64,
                           None, same)[0])
        l_model = float(lik(corr, m.theta, m.sigma2, m.noise, x64, y64, z64,
                            None, 1000.0 * eps64)[0])
    return dict(corr=corr, method=method, n=n, nz=nz, data=data,
                nugget=rho, seed=seed, fit_s=fit_s,
                warm_start_s=info.get("warm_start_s"), lanes=info["lanes"],
                iterations=info["iterations"],
                evaluations=info["evaluations"], k1_launches=launches,
                theta=m.theta.tolist(), sigma2=float(m.sigma2),
                noise=float(m.noise), likelihood=lkh,
                likelihood_same_model_float64=l_same,
                likelihood_float64_model=l_model, q2=q2)


def kzz(corr, thetas):
    from egobox_torch.gp import sgp

    x, y, _, _ = cs.sgp_data()
    y = y.astype(float)
    z = x[sgp._sgp_draws(1).permutation(x.shape[0], "cpu")[:cs.SGP_M]]
    s2 = 9.0 * float(y.var(ddof=1))
    for th in thetas:
        row = dict(corr=corr, theta=th, sigma2=s2)
        for dt in (torch.float32, torch.float64):
            t = lambda a: torch.tensor(a, dtype=dt)  # noqa: E731
            nugget = 1000.0 * torch.finfo(dt).eps
            theta = torch.full((x.shape[1],), th, dtype=dt)
            kmm = s2 * sgp.corr_cross(corr, t(z), t(z), theta) + nugget * (
                torch.eye(len(z), dtype=dt))
            name = str(dt).split(".")[1]
            row[f"chol_ok_{name}"] = bool(
                torch.linalg.cholesky_ex(kmm)[1] == 0)
            row[f"eig_min_{name}"] = float(torch.linalg.eigvalsh(kmm)[0])
            # float32 points take a nugget relative to sigma2: hand in
            # nugget / sigma2 to add the same absolute one
            rel = nugget / s2 if dt == torch.float32 else nugget
            lkh, _ = sgp.fitc_likelihood(corr, theta, t(s2), t(9.0), t(x),
                                         t(y)[:, None], t(z), None, rel)
            row[f"likelihood_{name}"] = float(lkh)
        print(json.dumps(row), flush=True)


def cv(n, data):
    from egobox_torch.moe import metrics

    x, y, _, _ = cs.sgp_data()
    dt = torch.float32 if data == "float32" else torch.float64
    hook = metrics.sgp_fit_predict(corr="matern52", method="VFE",
                                   n_inducing=256, device=cs.DEV, dtype=dt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q2 = metrics.q2_score(x[:n].astype(np.float64),
                          y[:n].astype(np.float64), hook, 5)
    return dict(cv="q2_score 5 folds, matern52 VFE nz=256", n=n, data=data,
                seconds=time.perf_counter() - t0, q2=q2)


def grad_faults():
    from egobox_torch.gp import kernels as tk

    x, _, _, _ = cs.sgp_data()
    xt = torch.tensor(x, device=cs.DEV)
    z = xt[torch.randperm(x.shape[0], generator=torch.Generator().manual_seed(
        1))[:cs.SGP_M].to(cs.DEV)].contiguous()
    th = torch.linspace(0.1, 0.2, x.shape[1], device=cs.DEV)
    g = torch.randn((cs.SGP_M, x.shape[0]), device=cs.DEV,
                    generator=torch.Generator(cs.DEV).manual_seed(0))
    th64 = th.double().requires_grad_(True)
    r64 = torch.exp(tk.log_corr_cross("matern52", z.double(), xt.double(),
                                      th64))
    (g64,) = torch.autograd.grad((g.double() * r64).sum(), th64)
    del r64
    dlog, dphi = tk._dlog_term, tk._l1_dphi

    def wrong_kernel(name, u):
        return dlog("matern32", u)

    def scaled_theta(f):
        def dphi_f(name, c, x1, x2, theta, w_star):
            return dphi(name, c, x1, x2, theta * f, w_star)
        return dphi_f

    out = {}
    for label, patch in (("sound", None), ("matern32_term", wrong_kernel),
                         ("theta_1e-3", scaled_theta(1.0 + 1e-3)),
                         ("theta_1e-4", scaled_theta(1.0 + 1e-4)),
                         ("theta_1e-5", scaled_theta(1.0 + 1e-5))):
        if label == "matern32_term":
            tk._dlog_term = patch
        elif patch is not None:
            tk._l1_dphi = patch
        try:
            t = th.clone().requires_grad_(True)
            r = tk.corr_cross("matern52", z, xt, t)
            (g32,) = torch.autograd.grad((g * r).sum(), t)
        finally:
            tk._dlog_term, tk._l1_dphi = dlog, dphi
        out[label] = float(torch.max(torch.abs(g32.double() - g64))
                           / torch.max(torch.abs(g64)))
    return dict(grad_faults="K1Gram theta gradient rel err vs float64 "
                "autograd, 512x50000 matern52", **out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default="matern52:FITC:50000:512:2:30:1,"
                    "matern52:VFE:20000:256:10:50:0")
    ap.add_argument("--data", default="float32,float64")
    ap.add_argument("--nuggets", default="default")
    ap.add_argument("--warm", type=int, default=2000)
    ap.add_argument("--cv", action="store_true")
    ap.add_argument("--cv-n", type=int, default=20_000)
    ap.add_argument("--grad-faults", action="store_true")
    ap.add_argument("--kzz", action="store_true")
    ap.add_argument("--kzz-corr", default="squared_exponential")
    ap.add_argument("--thetas", default="0.1,0.15,0.2,0.25,0.3")
    args = ap.parse_args()
    if args.kzz:
        cs.import_port()
        kzz(args.kzz_corr, [float(v) for v in args.thetas.split(",")])
        return
    cs.device_phase()
    cs.import_port()
    if args.grad_faults:
        print(json.dumps(grad_faults()), flush=True)
        return
    if args.cv:
        for data in args.data.split(","):
            print(json.dumps(cv(args.cv_n, data)), flush=True)
        return
    nuggets = [None if v == "default" else float(v)
               for v in args.nuggets.split(",")]
    for case in args.cases.split(","):
        corr, method, *ints = case.split(":")
        for data in args.data.split(","):
            for nugget in (nuggets if data == "float32" else [None]):
                print(json.dumps(run(corr, method, *map(int, ints), data,
                                     nugget, args.warm)), flush=True)


if __name__ == "__main__":
    main()
