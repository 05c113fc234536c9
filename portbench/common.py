"""What every part of the benchmark shares: the test function, seeds, and
the check that nothing of JAX was loaded."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent  # the benchmark's folder
CHECKOUT = ROOT.parent

#: modules that may not be loaded in a run, compared by the whole name
#: before the first dot
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "egobox_tpu")


def griewank(x: np.ndarray) -> np.ndarray:
    """Griewank's function, row by row: (n, d) -> (n,)."""
    s = np.sum(x**2 / 4000.0, axis=1)
    p = np.prod(np.cos(x / np.sqrt(np.arange(1, x.shape[1] + 1))), axis=1)
    return s - p + 1.0


FUNCTIONS = {"griewank": griewank}


def rng(seed: int, *stream: int) -> np.random.Generator:
    """numpy's generator for one stream of a run's seed (any size)."""
    return np.random.default_rng([int(seed) % 2**64, *stream])


def forbidden_loaded(modules=None) -> list:
    """Names in ``sys.modules`` whose top-level name is forbidden."""
    modules = sys.modules if modules is None else modules
    return sorted(name for name in modules
                  if name.split(".", 1)[0] in FORBIDDEN_MODULES)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)
