"""One run of one cell: set-up, the measured window, the check of what the
window produced against the plain reference, and the result's line.

Everything that belongs to one cell is found by name: ``BENCHMARK.json``
names the cell's configuration (``configs/<config>.json``) and its traffic
(``traffic/<traffic>.json``); the traffic file names the module
``drivers/<name>.py`` that runs that kind of traffic; the limits of the
cell's comparison are in ``checks/<cell>.json``; each per-layer metric is
read by ``metrics/<metric>.py``. A later cell or metric adds files; it does
not edit these."""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import time

from . import common

#: run-time caches of the program, at fixed paths inside the checkout
CACHE_DIRS = {
    "TORCH_EXTENSIONS_DIR": "build/portbench/torch_extensions",
    "TRITON_CACHE_DIR": "build/portbench/triton",
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="Run one cell of BENCHMARK.json and print its result.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def load_spec(checkout=common.CHECKOUT) -> dict:
    return common.load_json(checkout / "BENCHMARK.json")


class Cell:
    """A cell of the spec with its configuration, traffic and limits."""

    def __init__(self, spec: dict, name: str, root=common.ROOT):
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise SystemExit(f"portbench: no workload {name!r} in "
                             f"BENCHMARK.json ({sorted(cells)})")
        self.spec = spec
        self.workload = cells[name]
        self.name = name
        self.chips = int(self.workload["chips"])
        self.config = common.load_json(
            root / "configs" / f"{self.workload['config']}.json")
        self.traffic = common.load_json(
            root / "traffic" / f"{self.workload['traffic']}.json")
        self.limits = common.load_json(root / "checks" / f"{name}.json")
        self.root = root

    def _applies(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def end_to_end(self) -> list:
        return [m for m in self.spec["end_to_end"] if self._applies(m)]

    def per_layer(self) -> list:
        """Per-layer metrics whose cells include this one; without a
        ``workloads`` key, those whose end-to-end metric this cell has."""
        mine = {m["name"] for m in self.end_to_end()}
        return [m for m in self.spec["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in mine)]

    def driver(self):
        return importlib.import_module(
            f"portbench.drivers.{self.traffic['driver']}")


def load_reader(root, name: str):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def judge(checks: dict, limits: dict):
    """(correct, rows): every number compared beside its limit; a number
    that is missing, not finite or above its limit fails."""
    rows, ok = {}, True
    for name, limit in limits.items():
        value = checks.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        rows[name] = {"value": value, "limit": limit}
    for name in checks:
        if name not in limits:
            raise RuntimeError(f"check {name!r} has no limit in checks/")
    return ok, rows


def require_devices(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("portbench: torch.cuda.is_available() is false; "
                         "the benchmark runs on NVIDIA GPUs only")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"portbench: the cell needs {chips} GPU(s), "
                         f"{torch.cuda.device_count()} visible")


def import_program():
    """The program of this checkout, and no other installation of it."""
    import egobox_torch

    where = os.path.dirname(os.path.dirname(os.path.realpath(
        egobox_torch.__file__)))
    if where != os.path.realpath(common.CHECKOUT):
        raise SystemExit(f"portbench: egobox_torch was imported from {where}, "
                         f"not from this checkout ({common.CHECKOUT})")
    return egobox_torch


def _last_cpu():
    """The CPU this process last ran on (Linux), or None."""
    try:
        with open("/proc/self/stat") as f:
            return int(f.read().rsplit(")", 1)[1].split()[36])
    except (OSError, ValueError, IndexError):
        return None


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             overrides: dict | None = None) -> dict:
    """Run one cell and return its result (the dict printed as JSON).
    ``overrides`` replaces entries of the configuration and the traffic (the
    tests' tiny sizes)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    for key, rel in CACHE_DIRS.items():
        os.environ[key] = str(common.CHECKOUT / rel)
    import_program()
    config = dict(cell.config, **(overrides or {}).get("config", {}))
    traffic = dict(cell.traffic, **(overrides or {}).get("traffic", {}))
    drv = cell.driver().Driver(config, traffic, seed, device)
    drv.setup()
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    out = drv.window(seconds, trace)
    print(f"portbench: host cpus allowed {len(os.sched_getaffinity(0))}, "
          f"last on cpu {_last_cpu()}", file=sys.stderr)
    drv.finish()
    peak = (torch.cuda.max_memory_allocated() if device == "cuda"
            else 0)
    loaded = common.forbidden_loaded()
    if loaded:
        raise SystemExit(f"portbench: modules of JAX or of the JAX package "
                         f"were loaded: {loaded}")
    drv.free()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    # an answer that never came (a failed fit, an Egor loop that stopped
    # before the window closed) fails the run
    t_check = time.perf_counter()
    checks = dict(drv.check(), failed=out["failed"])
    print(f"portbench: the check took {time.perf_counter() - t_check!r} s",
          file=sys.stderr)
    correct, rows = judge(checks, dict(cell.limits, failed=0))

    e2e = dict(out["end_to_end"], setup_s=setup_s)
    if trace:
        metrics = {}
        ctx = dict(out, config=config, traffic=traffic, cell=cell.name)
        for m in cell.per_layer():
            value = load_reader(cell.root, m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end() if m["name"] in e2e}
    dev = {
        "platform": "gpu" if device == "cuda" else device,
        "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                 else device),
        "count": cell.chips,
        "memory_peak_bytes": int(peak),
    }
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": dev}
    if trace:
        tr = out.get("trace")
        dev["busy_s"] = tr.busy_s if tr else 0.0
        dev["window_s"] = tr.window_s if tr else 0.0
        if tr:
            result["breakdown"] = {"device_ops": tr.device_ops(),
                                   "idle_gaps": tr.idle_gaps()}
    result["checks"] = rows
    return result


def main(argv=None, t_start: float | None = None) -> int:
    args = parse_args(argv)
    spec = load_spec()
    cell = Cell(spec, args.workload)
    require_devices(cell.chips)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      t_start=t_start)
    print(f"correct: {result['correct']}", file=sys.stderr)
    for name, row in result["checks"].items():
        print(f"check {name}: {row['value']!r} (limit {row['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
