"""KPLS dimension reduction: PLS1 rotation weights
(port of egobox_tpu/gp/kpls.py).

For a single output each NIPALS power iteration converges in one step
(w ∝ X^T y), so the decomposition is a short unrolled sequence of products
and deflations. A constant residual gives a zero weight matrix, as in the
reference (algorithm.rs:848-852).
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def pls_rotations(x: torch.Tensor, y: torch.Tensor,
                  n_comp: int) -> torch.Tensor:
    """X-rotation matrix (nx, n_comp) of a PLS1 regression of y (n, 1) on
    x (n, nx): W (P^T W)^-1 of the standardized NIPALS regression."""
    xm = x.mean(dim=0)
    xs = x.std(dim=0, correction=1)
    xs = torch.where(xs <= 0, torch.ones_like(xs), xs)
    big_x = (x - xm) / xs
    ym = y.mean()
    ys = y.std(correction=1)
    ys = torch.where(ys <= 0, torch.ones_like(ys), ys)
    big_y = ((y - ym) / ys)[:, 0]

    ws, ps = [], []
    ok = torch.ones((), dtype=torch.bool, device=x.device)
    one = torch.ones((), dtype=x.dtype, device=x.device)
    for _ in range(n_comp):
        w = big_x.T @ big_y
        nw = torch.linalg.norm(w)
        ok = ok & (nw > _EPS)
        w = torch.where(nw > _EPS, w / torch.where(nw > _EPS, nw, one),
                        torch.zeros_like(w))
        t = big_x @ w
        tt = torch.dot(t, t)
        safe_tt = torch.where(tt > _EPS, tt, one)
        p = (big_x.T @ t) / safe_tt
        c = torch.dot(big_y, t) / safe_tt
        big_x = big_x - t[:, None] * p[None, :]
        big_y = big_y - t * c
        ws.append(w)
        ps.append(p)

    w_mat = torch.stack(ws, dim=1)  # (nx, k)
    p_mat = torch.stack(ps, dim=1)
    ptw = p_mat.T @ w_mat  # (k, k)
    # W @ inv(P^T W); solve_ex reports a singular P^T W instead of raising
    rot, info = torch.linalg.solve_ex(ptw.T, w_mat.T)
    rot = rot.T
    keep = torch.all(torch.isfinite(rot)) & ok & (info == 0)
    return torch.where(keep, rot, torch.zeros_like(rot))
