"""Numeric configuration for egobox_torch.

The reference (egobox_tpu) computes in float64 on the CPU and float32 on the
accelerator; the port keeps that split: float64 on the CPU (parity tests),
float32 on CUDA (the card's native type).

Reduced-precision matmuls are switched off at import. egobox_tpu/config.py
records the constrained G24 benchmark landing at -3.9 instead of -5.5 when
f32 matmuls ran as single-pass bf16; TF32 (10 mantissa bits) is the same
hazard for the Gram expansion, the GLS products and the R^-1 assembly.
"""

from __future__ import annotations

import logging
import os

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

# EGOBOX_LOG sets the package log level, as in egobox_tpu
logger = logging.getLogger("egobox_torch")
_level = os.environ.get("EGOBOX_LOG")
if _level:
    _handler = logging.StreamHandler()
    _handler.setFormatter(
        logging.Formatter("[%(levelname)s %(name)s] %(message)s")
    )
    logger.addHandler(_handler)
    logger.setLevel(getattr(logging, _level.upper(), logging.INFO))


def default_dtype(device=None) -> torch.dtype:
    """float32 on CUDA, float64 elsewhere."""
    if device is not None and torch.device(device).type == "cuda":
        return torch.float32
    return torch.float64


#: designs below this many points are fitted by the library Cholesky
#: (gp/likelihood.py _CHOL_NATIVE_MAX); the Egor loop computes them in
#: float64 on CUDA
_EGOR_FLOAT64_BELOW = 4096


def egor_dtype(device, n: int) -> torch.dtype:
    """The type the Egor loop computes its surrogates and infill in for a
    design of n points, unless the caller fixes one (``Egor(dtype=...)``).

    On CUDA, designs below 4 096 points are computed in float64, whatever
    the kernel. The EGO loop clusters its design around the optimum, the
    Gram's condition number reaches 1 / nugget, and in float32 the
    posterior mean then carries an error of the order of the constraint
    tolerances: egobox_tpu itself misses the G24 golden in float32
    (-5.390 and -5.366 for -5.508 at seeds 42 and 2;
    tools/f32_g24_compare.py, PERF.md).
    Such designs are bound by launches, not by arithmetic, and the card
    has a real FP64 rate. ``Egor(dtype=torch.float32)`` asks for
    float32, the type the K1 kernel builds large L1-family Grams in."""
    base = default_dtype(device)
    if base == torch.float32 and n < _EGOR_FLOAT64_BELOW:
        return torch.float64
    return base


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    GPU. Without one the default raises; it never falls back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "egobox_torch runs on the GPU unless asked otherwise and this "
            "host has no CUDA device: pass device='cpu' (or CPU tensors) to "
            "run on the CPU"
        )
    return torch.device("cuda")


def as_tensor(x, dtype=None, device=None) -> torch.Tensor:
    """A tensor stays where it is (cast to ``dtype`` when given); anything
    else goes to ``resolve_device(device)`` in ``dtype`` or that device's
    default type."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    device = resolve_device(device)
    return torch.as_tensor(
        x, dtype=dtype or default_dtype(device), device=device
    )
