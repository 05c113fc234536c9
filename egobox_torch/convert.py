"""Build the port's ``GpModel`` from the arrays of a model fitted elsewhere
(e.g. an egobox_tpu ``GpModel`` converted field by field with
``np.asarray``), so the port can serve it."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import default_dtype, resolve_device
from .gp.gp import GpModel

_STATIC = ("corr", "trend")


def gp_model_from_numpy(fields: dict, corr: str, trend: str, device=None,
                        dtype=None) -> GpModel:
    """``fields`` maps every array field of ``GpModel`` to a numpy array
    (``w_star`` may be None, or ``np.asarray(None)``). Floating fields go to
    ``device`` (default: the GPU; ``"cpu"`` to serve on the CPU) in
    ``dtype`` (default: the device's default type); ``mask`` stays
    boolean."""
    device = resolve_device(device)
    dtype = dtype or default_dtype(device)
    names = [f.name for f in dataclasses.fields(GpModel)
             if f.name not in _STATIC]
    missing = [k for k in names if k not in fields]
    if missing:
        raise ValueError(f"gp_model_from_numpy: missing fields {missing}")
    out = {}
    for k in names:
        v = fields[k]
        if v is None or (isinstance(v, np.ndarray) and v.dtype == object
                         and v.shape == () and v.item() is None):
            if k != "w_star":
                raise ValueError(f"gp_model_from_numpy: {k} is None")
            out[k] = None
            continue
        t_dtype = torch.bool if k == "mask" else dtype
        out[k] = torch.from_numpy(np.array(v)).to(device=device,
                                                  dtype=t_dtype)
    return GpModel(**out, corr=corr, trend=trend)
