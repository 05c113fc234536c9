"""Distributed Cholesky and triangular solves over a 1-D mesh of ranks
(port of egobox_tpu/parallel/dist_chol.py).

Layout: BLOCK-CYCLIC row ownership. The n rows are split into ``npan``
panels of ``bp`` rows; rank d owns panels d, d+D, d+2D, ... so every rank
keeps participating in the trailing updates until the last panels. A
matrix in "feed layout" stacks each rank's owned panels in order:
``feedperm = block_cyclic_perm(n, D, bp)`` maps feed position -> global
(elimination-order) row, and each rank holds its ``n / D`` feed rows (its
"local" block, columns in natural order). ``bp = n // D`` makes feedperm
the identity (the ``*_rowsharded`` wrappers).

The panel loops keep egobox_tpu's order of operations. Where its
``shard_map`` bodies compute on every device and select the owner's result
with ``jnp.where`` + ``psum``, the owner computes and broadcasts; where
they mask rows of the other panels out of an update, the update runs on
the rows it keeps (a rank's rows of panels >= k are a suffix of its block:
global panel numbers grow along it). Communication per panel k: one
broadcast of the owner's previous columns (bp x k bp) and of the bp x bp
diagonal factor. The reference has no distributed factorization at all
(single-process LAPACK potrf, crates/gp/src/algorithm.rs:988-1056).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.chol_kernel import cholesky_nan
from . import _comm


def block_cyclic_perm(n: int, n_dev: int, bp: int) -> np.ndarray:
    """feedperm (n,) with feedperm[feed_pos] = global row index: rank d's
    block (feed positions [d*n/D, (d+1)*n/D)) holds panels d, d+D, ... of
    the elimination order, each panel contiguous."""
    npan = n // bp
    order = np.arange(n).reshape(npan, bp)
    return np.concatenate(
        [order[d::n_dev].reshape(-1) for d in range(n_dev)]
    )


def pick_panel_size(n: int, n_dev: int) -> int:
    """Largest panel size bp with n % (bp * n_dev) == 0 and at least
    ~4 panels per rank (so the cyclic layout actually balances); falls
    back to the contiguous bp = n // n_dev when n/D has no small factors."""
    base = n // n_dev
    for bp in range(base // 4, 0, -1):
        if base % bp == 0:
            return bp
    return base


def _check_shard(n: int, n_dev: int, bp: int) -> None:
    if n % (bp * n_dev) != 0:
        raise ValueError(
            f"n={n} must be divisible by bp*n_dev={bp}*{n_dev}"
        )


def _local_indices(n: int, n_dev: int, bp: int, idx: int):
    """(gpan, gidx) of rank ``idx``'s local rows: global panel / global
    row of each, as numpy arrays (gidx is that rank's block of
    feedperm)."""
    n_loc = n // n_dev
    jloc = np.arange(n_loc) // bp
    off = np.arange(n_loc) % bp
    gpan = jloc * n_dev + idx
    return gpan, gpan * bp + off


def _first_row(k: int, idx: int, n_dev: int, bp: int, n_loc: int) -> int:
    """The first local row of rank ``idx`` whose global panel is >= k."""
    j = -(-(k - idx) // n_dev) if k > idx else 0
    return min(j * bp, n_loc)


def _check_local(mesh, a: torch.Tensor, bp: int) -> int:
    """n of a local block (n / D, n) in feed layout, checked."""
    n_loc, n = a.shape[-2], a.shape[-1]
    _check_shard(n, mesh.size, bp)
    if n_loc * mesh.size != n:
        raise ValueError(f"local block of {n_loc} rows on a {mesh.size}-rank "
                         f"mesh, expected {n // mesh.size} (n={n})")
    return n


def cholesky_blockcyclic(mesh, r_feed: torch.Tensor, bp: int) -> torch.Tensor:
    """Lower Cholesky of an SPD matrix in block-cyclic feed layout:
    ``r_feed`` is this rank's block of R[feedperm, :] (rows permuted,
    columns in natural order); returns its block of L[feedperm, :].
    Left-looking panel loop: the owner's previous columns are broadcast,
    the diagonal block is factored on its owner (the library Cholesky, as
    egobox_tpu there) and broadcast, the rows below are solved on every
    rank. A non-PD panel gives NaN rows below and a zero (sanitized)
    diagonal block, which the caller's finiteness guard must catch."""
    n = _check_local(mesh, r_feed, bp)
    n_loc = r_feed.shape[0]
    n_dev, idx = mesh.size, mesh.rank
    l_local = torch.zeros_like(r_feed)
    for k in range(n // bp):
        o = k % n_dev
        sl = (k // n_dev) * bp  # local offset of panel k on its owner
        mine = idx == o
        cols = slice(k * bp, (k + 1) * bp)
        lo = _first_row(k, idx, n_dev, bp, n_loc)
        # left-looking update of the panel-k columns on my rows of panels
        # >= k: S = R[:, cols_k] - L[:, :k bp] @ L[panel-k rows, :k bp]^T
        if k:
            top = _comm.broadcast(mesh, l_local[sl:sl + bp, :k * bp], o)
            a_col = torch.addmm(r_feed[lo:, cols], l_local[lo:, :k * bp],
                                top.T, alpha=-1.0)
        else:
            a_col = r_feed[lo:, cols]
        # the owner's local rows sl:sl+bp ARE the diagonal block
        lkk = torch.empty((bp, bp), dtype=r_feed.dtype, device=r_feed.device)
        if mine:
            lkk = torch.tril(cholesky_nan(a_col[sl - lo:sl - lo + bp]))
        lkk = _comm.broadcast(mesh, lkk, o)
        if lo < n_loc:
            l_local[lo:, cols] = torch.linalg.solve_triangular(
                lkk.T, a_col, upper=True, left=False)
        if mine:
            l_local[sl:sl + bp, cols] = torch.tril(torch.where(
                torch.isfinite(lkk), lkk, torch.zeros_like(lkk)))
    return l_local


def _solve_lower_inplace(mesh, l_feed, b, bp):
    """Forward substitution L X = B into ``b`` (this rank's feed rows):
    once panel k is solved its rows hold X, the rows of later panels the
    running residual."""
    n = _check_local(mesh, l_feed, bp)
    n_loc = l_feed.shape[0]
    n_dev, idx = mesh.size, mesh.rank
    for k in range(n // bp):
        o = k % n_dev
        sl = (k // n_dev) * bp
        cols = slice(k * bp, (k + 1) * bp)
        xk = torch.empty((bp,) + tuple(b.shape[1:]), dtype=b.dtype,
                         device=b.device)
        if idx == o:
            xk = torch.linalg.solve_triangular(
                l_feed[sl:sl + bp, cols], b[sl:sl + bp], upper=False)
            b[sl:sl + bp] = xk
        xk = _comm.broadcast(mesh, xk, o)
        lo = _first_row(k + 1, idx, n_dev, bp, n_loc)
        if lo < n_loc:
            b[lo:] -= l_feed[lo:, cols] @ xk
    return b


def solve_lower_blockcyclic(mesh, l_feed: torch.Tensor,
                            rhs_feed: torch.Tensor, bp: int) -> torch.Tensor:
    """Forward substitution L X = B with L and B in block-cyclic feed
    layout (this rank's rows of each); returns this rank's rows of X. Each
    panel's solved block is broadcast and eliminated from the later rows
    by local GEMMs."""
    return _solve_lower_inplace(mesh, l_feed, rhs_feed.clone(), bp)


def solve_upperT_blockcyclic(mesh, l_feed: torch.Tensor,
                             rhs_feed: torch.Tensor,
                             bp: int) -> torch.Tensor:
    """Backward substitution L^T X = B with L and B in block-cyclic feed
    layout; returns this rank's rows of X. Panels are eliminated in
    REVERSE order: at panel k every rank contributes
    L_local[:, cols_k]^T @ X_local over its already-solved rows (panels
    > k: rows of panels < k are zero in column block k), the all_reduce
    lands the sum on every rank, and the owner back-solves its bp x bp
    diagonal block transposed. Same O(n^2 p / D) per-rank GEMM cost as the
    forward solve; the model realization's gamma = L^-T (yt - Ft beta)
    without an (n, n) inverse (gp/likelihood.py's two triangular solves,
    themselves mirroring gp/src/algorithm.rs:988-1056)."""
    n = _check_local(mesh, l_feed, bp)
    n_loc = l_feed.shape[0]
    n_dev, idx = mesh.size, mesh.rank
    x_local = torch.zeros_like(rhs_feed)
    for k in reversed(range(n // bp)):
        sl = (k // n_dev) * bp
        cols = slice(k * bp, (k + 1) * bp)
        lo = _first_row(k + 1, idx, n_dev, bp, n_loc)
        s = _comm.all_reduce(mesh, l_feed[lo:, cols].T @ x_local[lo:])
        if idx == k % n_dev:
            x_local[sl:sl + bp] = torch.linalg.solve_triangular(
                l_feed[sl:sl + bp, cols].T, rhs_feed[sl:sl + bp] - s,
                upper=True)
    return x_local


def tri_inverse_feed(mesh, l_feed: torch.Tensor, bp: int) -> torch.Tensor:
    """This rank's rows of L^-1 (feed layout, columns natural) from L in
    feed layout: the forward solve with an identity right-hand side built
    locally as one-hot rows (no replicated (n, n) identity)."""
    n = _check_local(mesh, l_feed, bp)
    _, gidx = _local_indices(n, mesh.size, bp, mesh.rank)
    eye_rows = torch.zeros_like(l_feed)
    dev = l_feed.device
    eye_rows[torch.arange(l_feed.shape[0], device=dev),
             torch.as_tensor(gidx, device=dev)] = 1.0
    return _solve_lower_inplace(mesh, l_feed, eye_rows, bp)


def rinv_rows_feed(mesh, linv_feed: torch.Tensor, bp: int) -> torch.Tensor:
    """This rank's rows of R^-1 = L^-T L^-1 (feed layout) from L^-1 in
    feed layout. Inner products run over rows (permutation-invariant): for
    each output panel k every rank contributes
    Linv_local[:, cols_k]^T @ Linv_local over its rows of panels >= k (the
    others are zero in column block k: L^-1 is lower triangular) and the
    all_reduce lands it on the owner: every rank GEMMs every panel."""
    n = _check_local(mesh, linv_feed, bp)
    n_loc = linv_feed.shape[0]
    n_dev, idx = mesh.size, mesh.rank
    out = torch.zeros_like(linv_feed)
    for k in range(n // bp):
        sl = (k // n_dev) * bp
        lo = _first_row(k, idx, n_dev, bp, n_loc)
        rows_k = _comm.all_reduce(
            mesh, linv_feed[lo:, k * bp:(k + 1) * bp].T @ linv_feed[lo:])
        if idx == k % n_dev:
            out[sl:sl + bp] = rows_k
    return out


# ---------------------------------------------------------------------------
# contiguous-layout wrappers (bp = n // D makes feedperm the identity, so
# these take and return contiguous row blocks of natural-order matrices)


def cholesky_rowsharded(mesh, r: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky of an (n, n) SPD matrix from this rank's contiguous
    row block (n / D, n); returns its row block of L."""
    return cholesky_blockcyclic(mesh, r, r.shape[1] // mesh.size)


def solve_lower_rowsharded(mesh, l: torch.Tensor,
                           rhs: torch.Tensor) -> torch.Tensor:
    """Forward substitution L X = B on contiguous row blocks."""
    return solve_lower_blockcyclic(mesh, l, rhs, l.shape[1] // mesh.size)


def reduced_likelihood_distributed(
    mesh,
    x,  # (n, nx)
    y,  # (n,) or (n, 1)
    theta,
    *,
    corr: str = "squared_exponential",
    trend: str = "constant",
    nugget: float | None = None,
) -> torch.Tensor:
    """Fully distributed exact reduced likelihood: row-block Gram build
    (O(n^2 d / D) per rank), block-cyclic distributed Cholesky,
    distributed forward solves, all_reduce for logdet / GLS; no rank holds
    an (n, n) buffer. ``x`` and ``y`` are replicated. Failure semantics of
    the single-device reduced_likelihood (gp/likelihood.py, itself
    mirroring crates/gp/src/algorithm.rs:988-1056): a non-PD Gram or an
    ill-conditioned Ft gives -inf. n must be divisible by the mesh size.
    For the distributed FIT see parallel/dist_fit.py."""
    from .dist_fit import _normalize, dist_likelihood_parts
    from .sharding import replicated

    x = torch.atleast_2d(replicated(mesh, x))
    y = replicated(mesh, y).to(x.dtype)
    if y.ndim == 1:
        y = y[:, None]
    if nugget is None:
        nugget = 100.0 * torch.finfo(x.dtype).eps
    x_norm, y_norm, _ = _normalize(x, y)
    rlf, _ = dist_likelihood_parts(
        mesh, x_norm, y_norm, replicated(mesh, theta).to(x.dtype),
        corr=corr, trend=trend, nugget=float(nugget),
    )
    return rlf
