"""K1: the fused correlation (Gram) tile kernel for the L1-family kernels.

Replaces egobox_tpu/ops/pallas_corr.py (``corr_cross_pallas``). The CUDA
source is ``egobox_torch/csrc/corr_tile.cu``: it is bound by FP32
instruction issue and then by its stores, so it works in product form (no
log1p per term, one exp per 8 features), keeps 8x4 outputs per thread in
registers, stores 16-byte vectors, computes a symmetric Gram's lower tiles
only (each stored with its transpose, the result symmetric bit for bit) and
can return the Gram's row sums from the registers it stores. The kernel's
header has the reasoning. ``corr_cross_tile`` launches it on CUDA tensors
and takes ``corr_cross_plain``, which keeps the log-space formula of the
JAX package, only for CPU tensors.
"""

from __future__ import annotations

import collections

import torch

from . import build

_SQRT3 = 1.7320508075688772
_SQRT5 = 2.23606797749979
_KIND = {
    "squared_exponential": 0,
    "absolute_exponential": 1,
    "matern32": 2,
    "matern52": 3,
}
#: rows of x1 per block of the plain version: bounds its (rows, n2, d)
#: broadcast tensor to about 8e6 elements
_PLAIN_BUDGET = 8_000_000

#: edge of the kernel's output tile: the row sums come back as one partial
#: per row and tile of this many columns
_TILE = 64

#: kernel launches since the last reset (the plain version does not count)
launches = 0
#: the same launches by output shape (n1, n2)
launch_shapes: collections.Counter = collections.Counter()


def needs_grad(*tensors) -> bool:
    """True when autograd would record an operation on these tensors."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _log_terms(name: str, u: torch.Tensor) -> torch.Tensor:
    """Per-feature log r contribution, summed over the last axis."""
    if name == "absolute_exponential":
        t = -u
    elif name == "matern32":
        v = _SQRT3 * u
        t = torch.log1p(v) - v
    elif name == "matern52":
        v = _SQRT5 * u
        t = torch.log1p(v + (5.0 / 3.0) * u * u) - v
    else:
        t = -0.5 * u * u
    return torch.sum(t, dim=-1)


def corr_cross_plain(name: str, x1: torch.Tensor, x2: torch.Tensor,
                     theta_w: torch.Tensor, row_sums: bool = False):
    """Plain PyTorch version of the kernel: r(x1, x2) (n1, n2) with the
    per-feature length scales ``theta_w`` (d,), in row blocks. With
    ``row_sums`` it returns ``(r, sum_j |r[i, j]|)``."""
    n1, d = x1.shape
    rows = max(1, _PLAIN_BUDGET // max(1, x2.shape[0] * d))
    out = []
    for s in range(0, n1, rows):
        u = torch.abs(x1[s:s + rows, None, :] - x2[None, :, :]) * theta_w
        out.append(torch.exp(_log_terms(name, u)))
    r = torch.cat(out, dim=0) if out else x1.new_empty((0, x2.shape[0]))
    if row_sums:
        return r, torch.sum(torch.abs(r), dim=1)
    return r


def corr_cross_tile(name: str, x1: torch.Tensor, x2: torch.Tensor,
                    theta_w: torch.Tensor, row_sums: bool = False):
    """r(x1, x2) of shape (n1, n2) for identity KPLS weights: the CUDA
    kernel on CUDA tensors (contiguous float32 only), the plain version on
    CPU tensors. With ``row_sums`` it returns ``(r, sum_j |r[i, j]|)``, the
    sums reduced in a fixed order (the same bits on every call). When ``x1``
    and ``x2`` are the same tensor the kernel computes the lower tiles only
    and r is symmetric bit for bit, its diagonal exactly 1."""
    global launches
    if name not in _KIND:
        raise ValueError(f"unknown kernel: {name}")
    if x1.ndim != 2 or x2.ndim != 2 or x1.shape[1] != x2.shape[1]:
        raise ValueError(f"x1 {tuple(x1.shape)}, x2 {tuple(x2.shape)}: "
                         "expected (n1, d) and (n2, d)")
    if theta_w.shape != (x1.shape[1],):
        raise ValueError(f"theta_w {tuple(theta_w.shape)}: expected "
                         f"({x1.shape[1]},)")
    tensors = (x1, x2, theta_w)
    if all(t.device.type == "cpu" for t in tensors):
        return corr_cross_plain(name, x1, x2, theta_w, row_sums)
    if needs_grad(*tensors):
        raise RuntimeError(
            "corr_cross_tile: the CUDA kernel has no backward and an input "
            "requires grad; differentiate the plain formula instead "
            "(gp.kernels.corr_cross dispatches it)"
        )
    if not all(t.is_cuda and t.device == x1.device for t in tensors):
        raise ValueError("corr_cross_tile: x1, x2, theta_w must share one "
                         "CUDA device (or all lie on the CPU)")
    if not all(t.dtype == torch.float32 for t in tensors):
        raise TypeError("corr_cross_tile: the CUDA kernel takes float32 "
                        f"only, got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("corr_cross_tile: inputs must be contiguous")
    n1, d = x1.shape
    n2 = x2.shape[0]
    out = torch.empty((n1, n2), dtype=torch.float32, device=x1.device)
    partial = None
    if row_sums:
        partial = torch.empty((n1, -(-n2 // _TILE)), dtype=torch.float32,
                              device=x1.device)
    symmetric = x1.data_ptr() == x2.data_ptr() and n1 == n2
    lib = build.load_library()
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream(x1.device).cuda_stream
        err = lib.egx_corr_tile(
            _KIND[name], x1.data_ptr(), x2.data_ptr(), theta_w.data_ptr(),
            out.data_ptr(), None if partial is None else partial.data_ptr(),
            n1, n2, d, int(symmetric), stream,
        )
    build.check(err, "corr_tile")
    launches += 1
    launch_shapes[(n1, n2)] += 1
    if row_sums:
        return out, torch.sum(partial, dim=1)
    return out
