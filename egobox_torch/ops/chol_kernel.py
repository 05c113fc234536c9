"""K2: the Cholesky panel kernel and the blocked Cholesky that drives it.

Replaces egobox_tpu/ops/pallas_chol.py (``factor_panel`` and the blocked
loop ``pallas_cholesky``). The CUDA source is ``egobox_torch/csrc/chol_panel.cu``;
its header says what bounds it on the H100 and how the design answers that.
``factor_panel`` launches it on CUDA tensors and takes
``factor_panel_plain`` only for CPU tensors.
"""

from __future__ import annotations

import contextlib

import torch

from . import build

#: kernel launches since the last reset (the plain version does not count)
launches = 0

#: dynamic shared memory a Hopper CTA may use
_SMEM_BYTES = 232_448
#: the kernel's sub-panel width and rows of B per apply CTA
_NB = 32
_ROWS = 32
PRECISIONS = ("highest", "high", "default")


def cholesky_nan(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, all NaN when ``a`` is not positive definite
    (JAX's ``cholesky`` returns NaN there; the likelihood turns it into
    -inf). ``cholesky_ex`` reports the failure without a host sync."""
    l_fac, info = torch.linalg.cholesky_ex(a)
    return torch.where((info == 0)[..., None, None], l_fac,
                       torch.full_like(l_fac, float("nan")))


def factor_panel_plain(a_panel: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: [L00; B L00^-T] for
    a_panel (m, b) = [A00; B]."""
    b = a_panel.shape[1]
    l00 = cholesky_nan(a_panel[:b])
    eye = torch.eye(b, dtype=a_panel.dtype, device=a_panel.device)
    linv = torch.linalg.solve_triangular(l00, eye, upper=False)
    return torch.cat([l00, a_panel[b:] @ linv.T], dim=0)


def smem_bytes(b: int) -> int:
    """Shared memory the larger of the kernel's two CTAs needs at least for
    a block of b columns: the diagonal CTA holds the packed lower triangle
    (rounded up to 4 floats) and 32 reciprocal pivots (and, where they
    fit, staging copies for the row solves and the trailing update); an
    apply CTA holds its 32 rows and 32 rows of L00, each padded to a
    multiple of 32 columns plus 4, and 32 reciprocal pivots."""
    bp = -(-b // _NB) * _NB
    diag = -(-(b * (b + 1) // 2) // 4) * 4 + _NB
    return 4 * max(diag, (_ROWS + _NB) * (bp + 4) + _NB)


def factor_panel(a_panel: torch.Tensor, stamps: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """Factorize one block column: ``a_panel`` (m, b), m >= b, holds the
    symmetric diagonal block in its first b rows and the sub-diagonal rows
    below (already left-looking-updated). Returns [L00; B L00^-T] of the
    same shape. CUDA tensors (contiguous float32) launch the kernel; CPU
    tensors take the plain version. ``stamps``, a CUDA int64 tensor of 6,
    receives the diagonal kernel's clock64 phase split (cycles: load,
    diagonal blocks, row solves, trailing updates, store, total)."""
    global launches
    if a_panel.ndim != 2 or a_panel.shape[0] < a_panel.shape[1]:
        raise ValueError(f"a_panel {tuple(a_panel.shape)}: expected (m, b) "
                         "with m >= b")
    if a_panel.device.type == "cpu":
        return factor_panel_plain(a_panel)
    if not a_panel.is_cuda:
        raise ValueError(f"factor_panel: unsupported device {a_panel.device}")
    if a_panel.dtype != torch.float32:
        raise TypeError("factor_panel: the CUDA kernel takes float32 only, "
                        f"got {a_panel.dtype}")
    if not a_panel.is_contiguous():
        raise ValueError("factor_panel: a_panel must be contiguous")
    m, b = a_panel.shape
    if smem_bytes(b) > _SMEM_BYTES:
        raise ValueError(f"factor_panel: block {b} too large for one CTA's "
                         "shared memory (b <= 340)")
    if stamps is not None and not (stamps.is_cuda and stamps.numel() >= 6
                                   and stamps.dtype == torch.int64):
        raise ValueError("factor_panel: stamps must be a CUDA int64 tensor "
                         "of at least 6")
    out = torch.empty_like(a_panel)
    lib = build.load_library()
    with torch.cuda.device(a_panel.device):
        stream = torch.cuda.current_stream(a_panel.device).cuda_stream
        err = lib.egx_factor_panel(
            a_panel.data_ptr(), out.data_ptr(), m, b,
            None if stamps is None else stamps.data_ptr(), stream)
    build.check(err, "factor_panel")
    launches += 1
    return out


@contextlib.contextmanager
def _matmul_tf32(enabled: bool):
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def panel_cholesky(r: torch.Tensor, block: int = 256,
                   precision: str = "highest") -> torch.Tensor:
    """Lower Cholesky of an SPD matrix through ``factor_panel``.

    Left-looking block-column loop (as pallas_cholesky): per panel one GEMM
    applies the accumulated update, then ``factor_panel`` factorizes the
    column. ``precision`` governs only the trailing-update GEMMs on CUDA:
    ``highest`` and ``high`` run full float32, ``default`` allows TF32.
    (``high`` is bf16x3 on the TPU, about 1e-6 relative; TF32 keeps about
    3 decimal digits, so only ``default`` maps to it.) n is padded with an
    identity block to a multiple of ``block``; n <= block takes the library
    factorization. Not positive definite -> NaN in the factor."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    n = r.shape[0]
    b = block
    if n <= b:
        return cholesky_nan(r)
    nb = -(-n // b)
    n_pad = nb * b
    if n_pad != n:
        rp = torch.zeros((n_pad, n_pad), dtype=r.dtype, device=r.device)
        rp[:n, :n] = r
        rp[n:, n:].diagonal().fill_(1.0)
        r = rp
    l_fac = torch.zeros_like(r)
    with _matmul_tf32(precision == "default"):
        for k in range(nb):
            s = k * b
            a_col = r[s:, s:s + b]
            if k:
                a_col = a_col - l_fac[s:, :s] @ l_fac[s:s + b, :s].T
            l_fac[s:, s:s + b] = factor_panel(a_col.contiguous())
    return l_fac[:n, :n]
