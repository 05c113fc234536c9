#!/usr/bin/env python3
"""Time egobox_torch's K2 Cholesky panel kernel on one NVIDIA GPU.

    python3 tools/prof_k2.py [--root CHECKOUT] [--label NAME]

Imports ``egobox_torch`` from CHECKOUT (default: this checkout), so that
two versions of the kernel can be timed in turn in one process each, on
one card. Times, with chip_smoke.py's ``time_ms`` (CUDA-event medians of
5 runs of 10 calls in a row, after a warm-up), the diagonal-only 256x256
panel, the 10240x256 panel (the driver's first and tallest), the plain
version of the latter, the K2-driven n=10240 Cholesky and
``torch.linalg.cholesky_ex`` on chip_smoke.py's ``slice_r`` matrix.
Where the kernel takes a ``stamps`` tensor, also prints its clock64 phase
split of the 256x256 diagonal kernel, in cycles and in microseconds at
the SM clock that nvidia-smi reads right after. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import slice_r, time_ms  # noqa: E402

PHASES = ("load", "diag_blocks", "row_solves", "trailing", "store")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root",
                    default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="change")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("prof_k2: needs an NVIDIA GPU")
    # egobox_torch from --root, ahead of this checkout
    sys.path.insert(0, str(Path(args.root).resolve()))
    from egobox_torch.gp import likelihood as lik
    from egobox_torch.ops import build, chol_kernel as chk

    build.build(force=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()

    r32 = slice_r(torch, lik)
    diag = r32[:256, :256].contiguous()
    tall = r32[:, :256].contiguous()
    res = {
        "label": args.label, "card": card,
        "panel_256x256_ms": time_ms(torch, lambda: chk.factor_panel(diag)),
        "panel_10240x256_ms": time_ms(torch,
                                      lambda: chk.factor_panel(tall)),
        "plain_10240x256_ms": time_ms(
            torch, lambda: chk.factor_panel_plain(tall)),
        "chol_10240_ms": time_ms(
            torch, lambda: chk.panel_cholesky(r32, block=256), batch=2),
        "cholesky_ex_10240_ms": time_ms(
            torch, lambda: torch.linalg.cholesky_ex(r32), batch=2),
    }
    res["apply_10240x256_ms"] = (res["panel_10240x256_ms"]
                                 - res["panel_256x256_ms"])
    if "stamps" in inspect.signature(chk.factor_panel).parameters:
        stamps = torch.zeros(6, dtype=torch.int64, device="cuda")
        cycles = []
        for _ in range(5):
            chk.factor_panel(diag, stamps)
            cycles.append(stamps.tolist())
        med = [statistics.median(c[p] for c in cycles) for p in range(6)]
        mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True).stdout.split()[0])
        res["diag_cycles"] = dict(zip(PHASES + ("total",), med))
        res["sm_clock_mhz"] = mhz
        res["diag_us"] = {k: v / mhz for k, v in res["diag_cycles"].items()}
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
