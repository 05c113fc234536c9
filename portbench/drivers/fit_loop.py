"""Closed loop of dense GP fits: ``gp.fit_gp`` back to back on host arrays,
the model's likelihood read back on the host.

The data sets are one pool of ``pool_size`` designs, drawn from the
traffic's ``pool_seed`` and so the same for every seed: the fit's work
depends on its data (the restarts' L-BFGS-B iterations), and a pool of
fresh designs per seed made runs of different seeds differ by far more
than two runs of one seed. The seed draws the order: the window fits the
pool pass after pass, each pass in an order of its own, until
``--seconds`` have passed; ``fit_s`` is the window's seconds over the fits
completed in it. Each data set carries its own fit seed, so a data set
asks the same work of every pass. Set-up runs ``warmup`` fits on data of a
stream of their own.

The models of ``check_fits`` fits, drawn from the seed among the window's
first ``check_among``, and of the last fit are kept; after the window the
program predicts ``n_holdout`` held-out points (drawn from the seed) with
each, and the reference recomputes from the raw data the likelihood at
each kept model's theta, the likelihood's maximum over the theta bounds,
and the posterior mean and variance."""

from __future__ import annotations

import sys
import time

import numpy as np

from .. import common
from ..reference.gp_ref import Problem
from ..trace import traced

#: fit_gp's keyword arguments a configuration's "fit" entry may set
FIT_KEYS = ("n_start", "max_iters", "nugget", "theta_init", "theta_bounds")


def lhs(gen: np.random.Generator, n: int, dim: int, lo: float, hi: float):
    """A randomized Latin hypercube of n points in [lo, hi]^dim: in each
    dimension one point in each of n equal strata, at a uniform place in
    it, the strata in an order of their own."""
    u = (np.argsort(gen.random((n, dim)), axis=0)
         + gen.random((n, dim))) / n
    return lo + (hi - lo) * u


def make_data(config: dict, gen: np.random.Generator, n: int):
    lo, hi = config["box"]
    x = lhs(gen, n, config["dim"], lo, hi)
    return x, common.FUNCTIONS[config["function"]](x)


def fit_kwargs(config: dict) -> dict:
    kw = {k: config["fit"][k] for k in FIT_KEYS if k in config["fit"]}
    kw.update(corr=config["corr"], trend=config["trend"],
              kpls_dim=config["kpls_dim"])
    return kw


def to_device(x, dtype: str, device: str):
    import torch

    return torch.as_tensor(x, dtype=getattr(torch, dtype), device=device)


class Driver:
    def __init__(self, config, traffic, seed, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = device
        self.kw = fit_kwargs(config)
        self.dtype = config.get("program_dtype", config["dtype"])

    def _inputs(self, x, y):
        return (to_device(x, self.dtype, self.device),
                to_device(y, self.dtype, self.device))

    def setup(self):
        from egobox_torch import gp

        self.gp = gp
        cfg, tr = self.config, self.traffic
        gen = common.rng(tr["pool_seed"], 1)
        n = cfg["n_train"]
        self.data = []
        for _ in range(tr["pool_size"]):
            x, y = make_data(cfg, gen, n)
            self.data.append((x, y, int(gen.integers(0, 2**31))))
        self.passes = common.rng(self.seed, 5)
        self.order = []
        self.holdout = make_data(cfg, common.rng(self.seed, 2),
                                 cfg["n_holdout"])[0]
        pick = common.rng(self.seed, 3)
        self.keep = set(int(i) for i in pick.choice(
            tr["check_among"], size=tr["check_fits"], replace=False))
        warm = common.rng(self.seed, 4)
        for _ in range(tr["warmup"]):
            x, y = make_data(cfg, warm, n)
            model = gp.fit_gp(*self._inputs(x, y), seed=0, **self.kw)
            float(model.likelihood)
            self.gp.predict_valvar(model, to_device(
                self.holdout, self.dtype, self.device))

    def window(self, seconds: float, trace: bool):
        import torch

        traces, host, kept = [], [], {}
        self.fit_times = []
        n_trace = self.traffic["trace_units"] if trace else 0
        n_host = self.traffic["trace_host_units"] if trace else 0
        failed = 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        with traced(n_trace > 0, self.device, traces, host_ops=False):
            for i in range(n_trace):
                self._fit(i, kept)
        with traced(n_host > 0, self.device, host, host_ops=True):
            for i in range(n_trace, n_trace + n_host):
                self._fit(i, kept)
        i = n_trace + n_host
        while time.perf_counter() < deadline:
            try:
                self._fit(i, kept)
            except self.gp.GpFitError:
                failed += 1
            i += 1
        t1 = time.perf_counter()
        self.kept = kept
        print(f"portbench: {i} fits, seconds each: "
              f"{[round(t, 4) for t in self.fit_times]}", file=sys.stderr)
        out = dict(end_to_end={"fit_s": (t1 - t0) / i}, attempted=i,
                   failed=failed, window_s=t1 - t0,
                   units=i, traced_units=n_trace, host_traced_units=n_host,
                   trace=traces[0]() if traces else None,
                   host_trace=host[0]() if host else None)
        if self.device == "cuda":
            torch.cuda.synchronize()
        return out

    def data_set(self, i: int) -> int:
        """The pool's index of the window's i-th fit."""
        while len(self.order) <= i:
            self.order.extend(int(j) for j in
                              self.passes.permutation(len(self.data)))
        return self.order[i]

    def _fit(self, i, kept):
        x, y, fit_seed = self.data[self.data_set(i)]
        t = time.perf_counter()
        model = self.gp.fit_gp(*self._inputs(x, y), seed=fit_seed, **self.kw)
        float(model.likelihood)  # the host reads the answer
        self.fit_times.append(time.perf_counter() - t)
        kept["last"] = (i, model)
        if i in self.keep:
            kept[i] = (i, model)

    def finish(self):
        """The program's answers of the kept fits: the held-out posterior."""
        xh = to_device(self.holdout, self.dtype, self.device)
        self.answers = []
        seen = set()
        for i, model in self.kept.values():
            if i in seen:
                continue
            seen.add(i)
            mean, var = self.gp.predict_valvar(model, xh)
            self.answers.append(dict(
                i=i, theta=float(model.theta.reshape(-1)[0]),
                likelihood=float(model.likelihood),
                mean=mean.double().cpu().numpy(),
                var=var.double().cpu().numpy()))

    def free(self):
        self.kept = None

    def check(self) -> dict:
        """The worst over the kept fits of: the likelihood's gap at the
        program's theta; the likelihood the reference finds above it over
        the theta bounds (the optimisation left short); the held-out mean's
        gap in std(y) and the variance's in sigma^2. All relative."""
        cfg = self.config
        lo, hi = cfg["fit"]["theta_bounds"]
        worst = dict(lkh_gap=0.0, theta_gain=0.0, mean_gap=0.0, var_gap=0.0)
        for a in self.answers:
            x, y, _ = self.data[self.data_set(a["i"])]
            prob = Problem(x, y, nugget=cfg["fit"]["nugget"],
                           device=self.device)
            try:
                ref = prob.model(a["theta"])
            except ValueError:  # no likelihood at the program's theta
                return dict.fromkeys(worst, float("nan"))
            scale = abs(ref.likelihood)
            _, best = prob.best_likelihood(lo, hi)
            mean, var = ref.predict_valvar(self.holdout)
            worst["lkh_gap"] = max(worst["lkh_gap"], abs(
                a["likelihood"] - ref.likelihood) / scale)
            worst["theta_gain"] = max(worst["theta_gain"],
                                      (best - ref.likelihood) / scale)
            worst["mean_gap"] = max(worst["mean_gap"], float(
                np.max(np.abs(a["mean"] - mean)) / np.std(y, ddof=1)))
            worst["var_gap"] = max(worst["var_gap"], float(
                np.max(np.abs(a["var"] - var)) / ref.sigma2))
            del prob, ref
        if not self.answers:
            return {}
        return worst
