"""Readings for the limits of a cell's check: many seeds of the program, of
a control, or of the program with a fault planted, in one process (set-up
is paid per seed). From the root of a checkout, on a card:

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --seconds 4 [--control program-float32] [--fault <name>]

prints one JSON line per seed with the numbers compared. The control is
the program's own lower-precision path switched on: ``program-float32``,
the program computing in float32 (its type on CUDA) for a configuration
stated in float64. The faults are ``faults.FAULTS``'s.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import faults, harness  # noqa: E402

CONTROLS = ("program-float32",)


def run_seeds(workload: str, seeds, seconds: float, control=None,
              fault=None, device: str = "cuda", overrides=None, spec=None):
    """One result per seed (``harness.run_cell``'s) under ``control`` or
    ``fault``; the cell is looked up in ``spec`` (default:
    BENCHMARK.json)."""
    cell = harness.Cell(spec or harness.load_spec(), workload)
    overrides = dict(overrides or {})
    if control == "program-float32":
        overrides["config"] = dict(overrides.get("config", {}),
                                   program_dtype="float32")
    elif control is not None:
        raise ValueError(f"unknown control {control!r}")
    undo = faults.FAULTS[fault]() if fault else None
    out = []
    try:
        for seed in seeds:
            t = time.perf_counter()
            res = harness.run_cell(cell, seed, seconds, False, device=device,
                                   overrides=overrides)
            res["seed"], res["control"], res["fault"] = seed, control, fault
            res["run_s"] = time.perf_counter() - t
            out.append(res)
            print(json.dumps(res), flush=True)
    finally:
        if undo is not None:
            undo()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control", choices=CONTROLS)
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    args = ap.parse_args(argv)
    cell = harness.Cell(harness.load_spec(), args.workload)
    harness.require_devices(cell.chips)
    run_seeds(args.workload, [int(s) for s in args.seeds.split(",")],
              args.seconds, args.control, args.fault)
    return 0


if __name__ == "__main__":
    sys.exit(main())
