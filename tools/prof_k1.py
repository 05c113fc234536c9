#!/usr/bin/env python3
"""Time egobox_torch's K1 Gram tile kernel on one NVIDIA GPU.

    python3 tools/prof_k1.py [--root CHECKOUT] [--label NAME]

Imports ``egobox_torch`` from CHECKOUT (default: this checkout), so that
two versions of the kernel can be timed in turn in one process each, on
one card. Times, with chip_smoke.py's ``time_ms`` (CUDA-event medians of
5 runs of 10 calls in a row, after a warm-up), at d=10:

- K1 matern52 at the three shapes of the n=10000 fit: the 10000^2 and
  2000^2 Grams R(x, x) (one tensor on both sides) and the 2000x10000
  predict; the 10000^2 Gram also with the same data as two tensors, and
  with the row sums where the wrapper has them;
- K1 absexp and matern32 at 10000^2; the plain version at 10000^2;
- the likelihood's ``_build_r`` (Gram, unit diagonal, largest row sum,
  nugget) at 10000^2 and 2000^2, and its tail: ``_build_r`` less the Gram;
- the three matern52 shapes again as 10 launches captured in a CUDA graph
  (``*_graph_ms``: the device's time alone; in a Python loop the 2000^2
  launch is bound by the host's launch cost), and ``fill_`` of a 10000^2
  float32 tensor, the store rate the card reaches on the Gram's bytes.

Prints the bounds of the three shapes (bytes at 3.35 TB/s, operations at
67 TFLOP/s, as chip_smoke.py counts them) and one JSON line.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import bound, time_ms  # noqa: E402

D = 10
SHAPES = {"10000x10000": (10_000, 10_000), "2000x2000": (2_000, 2_000),
          "2000x10000": (2_000, 10_000)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root",
                    default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="change")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("prof_k1: needs an NVIDIA GPU")
    # egobox_torch from --root, ahead of this checkout
    sys.path.insert(0, str(Path(args.root).resolve()))
    from egobox_torch.gp import likelihood as lik
    from egobox_torch.ops import build, corr_kernel as ck

    build.build(force=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()

    rng = np.random.default_rng(3)
    xs = {n: torch.tensor(rng.standard_normal((n, D)), dtype=torch.float32,
                          device="cuda") for n in (2_000, 10_000)}
    th = torch.full((D,), 0.5, dtype=torch.float32, device="cuda")
    x10k, x2k = xs[10_000], xs[2_000]
    x10k_copy = x10k.clone()

    def k1(name, a, b, **kw):
        return time_ms(torch, lambda: ck.corr_cross_tile(name, a, b, th, **kw))

    def k1_graph(a, b, calls=10):
        ck.corr_cross_tile("matern52", a, b, th)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                ck.corr_cross_tile("matern52", a, b, th)
        return time_ms(torch, graph.replay, batch=1) / calls

    res = {"label": args.label, "card": card, "d": D}
    res["k1_matern52_10000x10000_ms"] = k1("matern52", x10k, x10k)
    res["k1_matern52_2000x2000_ms"] = k1("matern52", x2k, x2k)
    res["k1_matern52_2000x10000_ms"] = k1("matern52", x2k, x10k)
    res["k1_matern52_10000x10000_two_tensors_ms"] = k1("matern52", x10k,
                                                       x10k_copy)
    if "row_sums" in inspect.signature(ck.corr_cross_tile).parameters:
        res["k1_matern52_10000x10000_row_sums_ms"] = k1(
            "matern52", x10k, x10k, row_sums=True)
        res["k1_matern52_2000x2000_row_sums_ms"] = k1(
            "matern52", x2k, x2k, row_sums=True)
    res["k1_absexp_10000x10000_ms"] = k1("absolute_exponential", x10k, x10k)
    res["k1_matern32_10000x10000_ms"] = k1("matern32", x10k, x10k)
    res["plain_matern52_10000x10000_ms"] = time_ms(
        torch, lambda: ck.corr_cross_plain("matern52", x10k, x10k, th),
        batch=2)
    for n, x in xs.items():
        key = f"build_r_matern52_{n}x{n}_ms"
        res[key] = time_ms(torch, lambda: lik._build_r(
            "matern52", x, th, None, 1e-3, None))
        res[f"build_r_tail_{n}x{n}_ms"] = (
            res[key] - res[f"k1_matern52_{n}x{n}_ms"])
    res["k1_matern52_10000x10000_graph_ms"] = k1_graph(x10k, x10k)
    res["k1_matern52_2000x2000_graph_ms"] = k1_graph(x2k, x2k)
    res["k1_matern52_2000x10000_graph_ms"] = k1_graph(x2k, x10k)
    full = torch.empty((10_000, 10_000), dtype=torch.float32, device="cuda")
    res["fill_10000x10000_ms"] = time_ms(torch, lambda: full.fill_(1.0))
    for key, (n1, n2) in SHAPES.items():
        # chip_smoke.py's count: 8 operations per term, one exp per output
        ms, by = bound(4 * ((n1 + n2) * D + D + n1 * n2),
                       n1 * n2 * (8 * D + 1))
        res[f"bound_{key}_ms"] = ms
        res[f"bound_{key}_by"] = by
        print(f"bound {key} d={D}: {ms!r} ms ({by})", flush=True)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
