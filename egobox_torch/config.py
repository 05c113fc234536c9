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
