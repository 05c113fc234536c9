"""Box-constrained L-BFGS with Armijo backtracking, and its trust-region
variant (port of egobox_tpu/optim/lbfgsb.py).

egobox_tpu runs each solver as one ``lax.while_loop`` vmapped over
multistart lanes; a finished lane keeps its state while the others run. The
port solves one lane per call and the caller loops over lanes, which gives
the same iterates. Vectors stay tensors on the objective's device; the
scalar decisions (acceptance, convergence) are taken on the host.

Limited-memory two-loop recursion over a circular (s, y) history, gradient
projection onto the box, NaN/inf objective values treated as +inf so the
search backs away from invalid regions (ref: algorithm.rs:893-896).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch


class LbfgsbResult(NamedTuple):
    x: torch.Tensor
    fun: torch.Tensor
    n_iters: int
    converged: bool
    #: residuals of the accepted final point when the objective was given
    #: as fun_and_res/grad_from_res (else an empty tuple)
    res: object = ()


def _sanitize(f: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(f), f, torch.full_like(f, math.inf))


def _finite_or_zero(g: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(g), g, torch.zeros_like(g))


class _History:
    """Circular (s, y) history, newest first in the two-loop recursion."""

    def __init__(self, size: int, d: int, like: torch.Tensor):
        self.size = size
        self.s = torch.zeros((size, d), dtype=like.dtype, device=like.device)
        self.y = torch.zeros_like(self.s)
        self.rho = [0.0] * size
        self.valid = [False] * size
        self.head = 0

    def push(self, s, y, sy: float) -> None:
        self.s[self.head] = s
        self.y[self.head] = y
        self.rho[self.head] = 1.0 / sy if sy != 0 else 1.0
        self.valid[self.head] = True
        self.head = (self.head + 1) % self.size

    def apply(self, g: torch.Tensor) -> torch.Tensor:
        """H @ g by the two-loop recursion over the valid slots."""
        order = [(self.head - 1 - i) % self.size for i in range(self.size)]
        q = g
        alphas = []
        for i in order:
            a = self.rho[i] * torch.dot(self.s[i], q) if self.valid[i] else 0.0
            if self.valid[i]:
                q = q - a * self.y[i]
            alphas.append(a)
        newest = (self.head - 1) % self.size
        sy = torch.dot(self.s[newest], self.y[newest])
        yy = torch.dot(self.y[newest], self.y[newest])
        gamma = sy / yy if self.valid[newest] and float(yy) > 0 else 1.0
        r = gamma * q
        for i, a in zip(reversed(order), reversed(alphas)):
            if self.valid[i]:
                b = self.rho[i] * torch.dot(self.y[i], r)
                r = r + (a - b) * self.s[i]
        return r


def _proj_grad_norm(x, g, lower, upper) -> float:
    """Max-norm of the gradient with components pointing out of active
    box faces zeroed."""
    pg = torch.where((x <= lower) & (g > 0), torch.zeros_like(g), g)
    pg = torch.where((x >= upper) & (pg < 0), torch.zeros_like(pg), pg)
    return float(torch.max(torch.abs(pg)))


def _descent_direction(hist: _History, g: torch.Tensor) -> torch.Tensor:
    direction = -hist.apply(g)
    # fall back to steepest descent if not a descent direction
    return direction if float(torch.dot(direction, g)) < 0 else -g


def _value_and_grad(fun: Callable):
    def vg(x):
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            f = fun(xx)
            (g,) = torch.autograd.grad(f, xx)
        return f.detach(), g

    return vg


def minimize_lbfgsb(
    fun: Callable,
    x0: torch.Tensor,
    lower: torch.Tensor,
    upper: torch.Tensor,
    max_iters: int = 50,
    history: int = 8,
    max_ls: int = 20,
    gtol: float = 1e-8,
    xtol: float = 1e-12,
    fun_and_res: Callable = None,
    grad_from_res: Callable = None,
    ls_batch: int = 0,
    final_grad: bool = True,
) -> LbfgsbResult:
    """Minimize ``fun`` (scalar, differentiable by autograd) over the box
    [lower, upper], from x0 (d,).

    ``fun_and_res``/``grad_from_res`` reuse an expensive forward: trials
    call ``fun_and_res(x) -> (f, res)`` and the accepted trial's residuals
    feed ``grad_from_res(x, res) -> g``. ``final_grad=False`` skips the
    gradient on the last allowed iteration (its value is discarded).
    The speculative batched line search (``ls_batch > 0``) is not ported.
    """
    if ls_batch > 0:
        raise NotImplementedError(
            "egobox_torch: the batched line search (ls_batch > 0) is not "
            "ported"
        )
    c1 = 1e-4

    def clip(x):
        return torch.clamp(x, lower, upper)

    x = clip(x0)
    if fun_and_res is None:
        vg = _value_and_grad(fun)

        def fun_and_res(x):
            with torch.no_grad():
                return fun(x), ()

        def grad_from_res(x, res):
            return vg(x)[1]

        f, g = vg(x)
        res = ()
    else:
        f, res = fun_and_res(x)
        g = grad_from_res(x, res)
    f = _sanitize(f)
    g = _finite_or_zero(g)
    hist = _History(history, x.shape[0], x)

    it, done = 0, False
    while it < max_iters and not done:
        direction = _descent_direction(hist, g)
        f_val = float(f)
        # Armijo backtracking along the projected path clip(x + a d); the
        # last trial is carried even when none passes
        alpha = 1.0
        for _ in range(max_ls):
            x_new = clip(x + alpha * direction)
            f_raw, res_new = fun_and_res(x_new)
            f_new = _sanitize(f_raw)
            dx = x_new - x
            alpha *= 0.5
            ok = float(f_new) <= f_val + c1 * float(torch.dot(g, dx))
            stuck = float(torch.max(torch.abs(dx))) <= xtol
            if ok or stuck:
                break
        improved = float(f_new) < f_val
        if not improved:
            x_new, f_new, res_new = x, f, res
        need_grad = final_grad or (it + 1) < max_iters
        g_new = grad_from_res(x_new, res_new) if need_grad and improved else g
        g_new = _finite_or_zero(g_new)

        s = x_new - x
        y = g_new - g
        sy = float(torch.dot(s, y))
        if improved and sy > 1e-10 * float(torch.linalg.norm(s)) * float(
            torch.linalg.norm(y)
        ):
            hist.push(s, y, sy)
        done = (not improved) or _proj_grad_norm(x_new, g_new, lower,
                                                  upper) <= gtol
        x, f, res, g = x_new, f_new, res_new, g_new
        it += 1
    return LbfgsbResult(x=x, fun=f, n_iters=it, converged=done, res=res)


def minimize_tr(
    x0: torch.Tensor,
    lower: torch.Tensor,
    upper: torch.Tensor,
    *,
    fun_and_res: Callable,
    grad_from_res: Callable,
    max_iters: int = 50,
    history: int = 8,
    delta0: float = 0.25,
    delta_max: float = 4.0,
    gtol: float = 1e-8,
    final_grad: bool = False,
) -> LbfgsbResult:
    """Box-constrained trust-region L-BFGS: exactly one objective forward
    per iteration (accepted or not), gradient only on acceptance.

    The step is the L-BFGS direction clipped to an adaptive radius; the
    radius grows (x2, up to ``delta_max``) when the actual decrease exceeds
    0.75 of the first-order prediction at the radius, and shrinks (x0.25)
    below 0.25. A rejected step retries from the same point next iteration
    with the smaller radius."""

    def clip(x):
        return torch.clamp(x, lower, upper)

    x = clip(x0)
    f, res = fun_and_res(x)
    f = _sanitize(f)
    g = _finite_or_zero(grad_from_res(x, res))
    hist = _History(history, x.shape[0], x)
    delta = delta0

    it, done = 0, False
    while it < max_iters and not done:
        direction = _descent_direction(hist, g)
        dnorm = float(torch.linalg.norm(direction))
        scale = min(1.0, delta / max(dnorm, 1e-30))
        x_new = clip(x + scale * direction)
        s = x_new - x
        snorm = float(torch.linalg.norm(s))

        f_raw, res_new = fun_and_res(x_new)
        f_new = _sanitize(f_raw)
        f_val, f_new_val = float(f), float(f_new)
        pred = -float(torch.dot(g, s))  # first-order predicted decrease
        ratio = (f_val - f_new_val) / max(pred, 1e-30)
        if ratio > 0.75 and snorm >= 0.99 * delta:
            delta = min(delta * 2.0, delta_max)
        elif ratio < 0.25:
            delta = delta * 0.25

        improved = f_new_val < f_val
        if not improved:
            x_new, f_new, res_new = x, f, res
        need_grad = final_grad or (it + 1) < max_iters
        g_new = grad_from_res(x_new, res_new) if need_grad and improved else g
        g_new = _finite_or_zero(g_new)

        y = g_new - g
        sy = float(torch.dot(s, y))
        if improved and sy > 1e-10 * snorm * float(torch.linalg.norm(y)):
            hist.push(s, y, sy)
        # a dead radius or a converged projected gradient terminates; a
        # rejected step does not
        done = delta < 1e-10 or (
            improved and _proj_grad_norm(x_new, g_new, lower, upper) <= gtol
        )
        x, f, res, g = x_new, f_new, res_new, g_new
        it += 1
    return LbfgsbResult(x=x, fun=f, n_iters=it, converged=done, res=res)
