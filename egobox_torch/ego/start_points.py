"""Multistart seed selection for infill optimization (port of
egobox_tpu/ego/start_points.py).

Ports the behavior of crates/ego/src/utils/start_points.rs (midpoints between
training points that are farther from every other point) and the
MiddlePickerMultiStarter (solver_computations.rs:56-124). The greedy midpoint
scan is O(n^2) on a handful of points and inherently sequential: it stays on
the host (numpy); the LHS completion comes from the solver's draws.
``middle_picker_starts_traced`` is the same picker in tensor operations with
no host read, for the fused programs (the virtual-point loop of q > 1 and
the traced run draw their seeds from a design that exists only on the
device).
"""

from __future__ import annotations

import numpy as np
import torch


def start_points(x: np.ndarray, xl: np.ndarray, xu: np.ndarray,
                 n_max: int | None = None) -> np.ndarray:
    """Midpoints of training-point pairs, closest pairs first, keeping a
    midpoint only if no other training point or already-kept midpoint is
    closer to it than its parents (ref: start_points.rs:7-85)."""
    x = np.asarray(x, dtype=float)
    n, d = x.shape
    xrange = np.asarray(xu, dtype=float) - np.asarray(xl, dtype=float)
    xrange = np.where(xrange == 0, 1.0, xrange)

    pairs = []
    for i in range(1, n):
        for j in range(i):
            dist = np.linalg.norm((x[i] - x[j]) / xrange)
            pairs.append((i, j, dist))
    pairs.sort(key=lambda t: t[2])

    xstart: list[np.ndarray] = []
    for i, j, _ in pairs:
        xij = (x[i] + x[j]) / 2.0
        d_ij = np.linalg.norm((x[i] - xij) / xrange)
        good = True
        for k in range(n):
            if k in (i, j):
                continue
            if np.linalg.norm((x[k] - xij) / xrange) < d_ij:
                good = False
                break
        if good:
            for xk in xstart:
                if np.linalg.norm((xk - xij) / xrange) < d_ij:
                    good = False
                    break
        if good:
            xstart.append(xij)
        if n_max is not None and len(xstart) >= n_max:
            break

    if not xstart:
        return np.zeros((0, d))
    return np.stack(xstart)


def middle_picker_starts(rng: np.random.Generator, x_train: np.ndarray,
                         xlimits: np.ndarray, n_start: int,
                         lhs_fill) -> np.ndarray:
    """MiddlePicker multistart: midpoints of a random subset of training
    points, completed with maximin LHS (ref: solver_computations.rs:62-114).

    ``lhs_fill(n)`` must return (n, nx) maximin-LHS points in xlimits.
    """
    nt = x_train.shape[0]
    n_sub = max(nt // 10, 2)
    idx = rng.permutation(nt)[:n_sub]
    mids = start_points(
        x_train[idx], xlimits[:, 0], xlimits[:, 1], n_max=n_start
    )
    missing = n_start - mids.shape[0]
    if missing <= 0:
        return mids[:n_start]
    fill = np.asarray(lhs_fill(max(missing, 3)))[:missing]
    if mids.shape[0] == 0:
        return fill
    return np.concatenate([mids, fill], axis=0)


def middle_picker_starts_traced(
    xp: torch.Tensor,  # (nb, nx) padded training design
    mask: torch.Tensor,  # (nb,) active rows
    lo: torch.Tensor,  # (nx,) seed box
    hi: torch.Tensor,
    n_start: int,
    n_sub_max: int,
    scores: torch.Tensor,  # (nb,) uniform draws in [0, 1)
    fill: torch.Tensor,  # (n_start, nx) maximin LHS in [0, 1]^nx
) -> torch.Tensor:
    """The MiddlePicker with static shapes and no host read (port of
    egobox_tpu's ``middle_picker_starts_traced``, the semantic mirror of
    ``middle_picker_starts``): the same greedy midpoint selection on the
    random subset of n_sub = clip(nt // 10, 2, n_sub_max) active rows with
    the lowest ``scores``, completed with ``fill`` scaled into [lo, hi].
    Pair buffers are sized by ``n_sub_max``; invalid pairs sort last.

    Both draws are inputs (egobox_tpu draws them from one key: the scores
    as ``uniform(ksub, (nb,))``, the fill as ``maximin_lhs(kfill,
    n_start, nx)``), so that tests can hand in JAX's."""
    nb, nx = xp.shape
    dev, dtype = xp.device, xp.dtype
    s = int(n_sub_max)
    nt = torch.sum(mask.to(torch.int64))
    n_sub = torch.clamp(nt // 10, 2, s)
    inf = torch.full_like(scores, torch.inf)
    order = torch.argsort(torch.where(mask, scores, inf), stable=True)
    sub_idx = order[:s]
    sub = xp[sub_idx]  # (s, nx)
    in_sub = (torch.arange(s, device=dev) < n_sub) & mask[sub_idx]

    xrange = torch.where(hi - lo == 0, torch.ones_like(hi), hi - lo)
    subn = sub / xrange[None, :]

    iu, ju = torch.triu_indices(s, s, 1, device=dev)
    diff = subn[iu] - subn[ju]
    pd = torch.sqrt(torch.sum(diff * diff, dim=-1))  # (P,)
    valid = in_sub[iu] & in_sub[ju]
    porder = torch.argsort(torch.where(valid, pd, torch.full_like(pd,
                                                                  torch.inf)),
                           stable=True)
    pi, pj = iu[porder], ju[porder]
    mids = (sub[pi] + sub[pj]) / 2.0  # (P, nx) by pair distance
    dij = pd[porder] / 2.0
    pvalid = valid[porder]

    # midpoints with a non-parent subset point closer than the parents
    # (independent of the greedy state)
    dist_pm = torch.linalg.norm(
        (sub[None, :, :] - mids[:, None, :]) / xrange[None, None, :], dim=-1)
    kidx = torch.arange(s, device=dev)[None, :]
    is_parent = (kidx == pi[:, None]) | (kidx == pj[:, None])
    other_close = torch.any(
        (dist_pm < dij[:, None]) & in_sub[None, :] & ~is_parent, dim=1)

    rows = torch.arange(n_start, device=dev)
    buf = torch.zeros((n_start, nx), dtype=dtype, device=dev)
    cnt = torch.zeros((), dtype=torch.int64, device=dev)
    for p in range(iu.shape[0]):
        mid = mids[p]
        d_acc = torch.linalg.norm((buf - mid[None, :]) / xrange, dim=1)
        ok = (pvalid[p] & ~other_close[p] & (cnt < n_start)
              & ~torch.any((d_acc < dij[p]) & (rows < cnt)))
        buf = torch.where((ok & (rows == cnt))[:, None], mid[None, :], buf)
        cnt = cnt + ok.to(cnt.dtype)

    fill = lo[None, :] + fill * (hi - lo)[None, :]
    fill_rows = fill[torch.clamp(rows - cnt, 0, n_start - 1)]
    return torch.where((rows < cnt)[:, None], buf, fill_rows)
