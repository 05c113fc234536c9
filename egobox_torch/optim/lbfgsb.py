"""Box-constrained L-BFGS with Armijo backtracking, and its trust-region
variant (port of egobox_tpu/optim/lbfgsb.py).

egobox_tpu runs each solver as one ``lax.while_loop`` vmapped over
multistart lanes; a finished lane keeps its state while the others run.
``minimize_lbfgsb`` has both forms:

- one lane (``x0`` of shape (d,)): vectors stay tensors on the objective's
  device, the scalar decisions (acceptance, convergence) are taken on the
  host. The n = 10 000 fit uses it with ``fun_and_res``/``grad_from_res``;
- lockstep lanes (``x0`` of shape (k, d)): every per-lane quantity (history,
  rho, valid, head, done, iteration count) is a tensor with a leading lane
  axis, all lanes advance in one set of launches, a finished lane keeps its
  state, and the host reads one pair of flags per iteration;
- ``graph_safe=True``: the lockstep form with no host read at all, for a
  CUDA graph. It runs fixed trip counts (every one of ``max_iters``
  iterations, every deeper line-search round, every backtracking step) and
  freezes finished lanes with the same masks, so it returns what the
  flag-reading form returns (egobox_tpu's ``lax.while_loop``s stop early;
  frozen lanes do not change either way).

``ls_batch > 1`` is the speculative line search of egobox_tpu: all
``ls_batch`` backtracking steps are evaluated at once (in the lockstep form
as one call of the objective on k x ls_batch points) and the first
Armijo-passing one is taken, the lowest when none passes.

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
    graph_safe: bool = False,
) -> LbfgsbResult:
    """Minimize ``fun`` (scalar, differentiable by autograd) over the box
    [lower, upper], from x0 (d,).

    ``fun_and_res``/``grad_from_res`` reuse an expensive forward: trials
    call ``fun_and_res(x) -> (f, res)`` and the accepted trial's residuals
    feed ``grad_from_res(x, res) -> g``. ``final_grad=False`` skips the
    gradient on the last allowed iteration (its value is discarded).

    ``ls_batch > 1``: the speculative line search. In this one-lane form the
    ``ls_batch`` trials of a round are evaluated one after the other (the
    same selection, no batched forward).

    Lockstep lanes: with ``x0`` of shape (k, d), ``lower``/``upper`` of shape
    (d,) or (k, d) and ``fun`` mapping (k, d) -> (k,) and, for
    ``ls_batch > 1``, (k, ls_batch, d) -> (k, ls_batch), with independent
    lanes (the gradient of ``fun(x).sum()`` is each lane's gradient), all
    lanes are solved at once; ``x``, ``fun``, ``n_iters`` and ``converged``
    of the result then carry the lane axis. The residual interface is
    one-lane only.

    ``graph_safe``: the lockstep form without host reads (see the module
    docstring); it takes lockstep lanes only.
    """
    if graph_safe and x0.ndim != 2:
        raise ValueError("minimize_lbfgsb: graph_safe takes lockstep lanes, "
                         "x0 of shape (k, d)")
    if x0.ndim == 2:
        if fun_and_res is not None or grad_from_res is not None:
            raise ValueError(
                "minimize_lbfgsb: fun_and_res/grad_from_res take one lane; "
                "lockstep lanes (x0 of shape (k, d)) need a batched fun"
            )
        return _minimize_lanes(fun, x0, lower, upper, max_iters, history,
                               max_ls, gtol, xtol, ls_batch, final_grad,
                               graph_safe)
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

    def trial(alpha):
        x_new = clip(x + alpha * direction)
        f_raw, res_new = fun_and_res(x_new)
        return x_new, _sanitize(f_raw), res_new

    def search_sequential():
        # Armijo backtracking along the projected path clip(x + a d); the
        # last trial is carried even when none passes
        alpha = 1.0
        for _ in range(max_ls):
            x_new, f_new, res_new = trial(alpha)
            dx = x_new - x
            alpha *= 0.5
            ok = float(f_new) <= f_val + c1 * float(torch.dot(g, dx))
            stuck = float(torch.max(torch.abs(dx))) <= xtol
            if ok or stuck:
                break
        return x_new, f_new, res_new

    def search_speculative():
        # rounds of ls_batch halvings; a deeper round only while no trial
        # of the last one improves, down to the sequential 2^-max_ls reach
        scale, n_rounds = 1.0, max(1, -(-max_ls // ls_batch))
        for r in range(n_rounds):
            trials = [trial(scale * 0.5**j) for j in range(ls_batch)]
            fs = [float(t[1]) for t in trials]
            if min(fs) < f_val:
                break
            scale *= 0.5**ls_batch
        armijo = [
            fj <= f_val + c1 * float(torch.dot(g, t[0] - x))
            for fj, t in zip(fs, trials)
        ]
        idx = armijo.index(True) if any(armijo) else fs.index(min(fs))
        return trials[idx]

    search = search_speculative if ls_batch > 1 else search_sequential
    it, done = 0, False
    while it < max_iters and not done:
        direction = _descent_direction(hist, g)
        f_val = float(f)
        x_new, f_new, res_new = search()
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


def _two_loop_lanes(g, s_hist, y_hist, rho, valid, head):
    """H @ g for every lane: the two-loop recursion over each lane's
    circular history, newest first, invalid slots masked out."""
    k, h, d = s_hist.shape
    order = (head[:, None] - 1 - torch.arange(h, device=g.device)) % h
    idx = order[:, :, None].expand(k, h, d)
    s_o = torch.gather(s_hist, 1, idx)  # (k, h, d), newest first
    y_o = torch.gather(y_hist, 1, idx)
    rho_o = torch.gather(rho, 1, order)
    valid_o = torch.gather(valid, 1, order)
    zero = torch.zeros_like(rho_o[:, 0])
    q = g
    alphas = []
    for i in range(h):
        a = torch.where(valid_o[:, i],
                        rho_o[:, i] * torch.sum(s_o[:, i] * q, dim=1), zero)
        q = q - a[:, None] * y_o[:, i]
        alphas.append(a)
    sy = torch.sum(s_o[:, 0] * y_o[:, 0], dim=1)
    yy = torch.sum(y_o[:, 0] * y_o[:, 0], dim=1)
    ok = valid_o[:, 0] & (yy > 0)
    gamma = torch.where(ok, sy / torch.where(ok, yy, torch.ones_like(yy)),
                        torch.ones_like(yy))
    r = gamma[:, None] * q
    for i in reversed(range(h)):
        b = torch.where(valid_o[:, i],
                        rho_o[:, i] * torch.sum(y_o[:, i] * r, dim=1), zero)
        r = r + torch.where(valid_o[:, i], alphas[i] - b, zero)[:, None] \
            * s_o[:, i]
    return r


def _minimize_lanes(fun, x0, lower, upper, max_iters, history, max_ls, gtol,
                    xtol, ls_batch, final_grad,
                    graph_safe=False) -> LbfgsbResult:
    """The lockstep form of ``minimize_lbfgsb``: the state of egobox_tpu's
    vmapped ``lax.while_loop`` (lbfgsb.py:261-304) as tensors with a leading
    lane axis. Every lane computes every iteration; the updates of a lane
    that is done (or out of iterations) are masked out, so it keeps its
    state while the others run.

    Host reads: one pair of flags per iteration (is any lane active, does
    any lane need a deeper line-search round), one more per deeper round,
    and with the sequential search (``ls_batch <= 1``) one per trial; none
    with ``graph_safe``, which runs every trip instead of stopping when the
    flags say that no lane needs it."""
    c1 = 1e-4
    k, d = x0.shape
    dev = x0.device
    lo = torch.broadcast_to(lower, (k, d))
    up = torch.broadcast_to(upper, (k, d))

    def value_and_grad(x):
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            f = fun(xx)
            (g,) = torch.autograd.grad(f.sum(), xx)
        return f.detach(), g

    def value(x):
        with torch.no_grad():
            return _sanitize(fun(x))

    x = torch.clamp(x0.detach(), lo, up)
    f, g = value_and_grad(x)
    f = _sanitize(f)
    g = _finite_or_zero(g)
    s_hist = torch.zeros((k, history, d), dtype=x.dtype, device=dev)
    y_hist = torch.zeros_like(s_hist)
    rho = torch.zeros((k, history), dtype=x.dtype, device=dev)
    valid = torch.zeros((k, history), dtype=torch.bool, device=dev)
    head = torch.zeros((k,), dtype=torch.long, device=dev)
    it = torch.zeros((k,), dtype=torch.long, device=dev)
    done = torch.zeros((k,), dtype=torch.bool, device=dev)
    lanes = torch.arange(k, device=dev)
    if ls_batch > 1:
        alphas = 0.5 ** torch.arange(ls_batch, dtype=x.dtype, device=dev)
        n_rounds = max(1, -(-max_ls // ls_batch))

    def trial_batch(scale):
        step = (scale[:, None] * alphas[None, :])[:, :, None]
        xs = torch.clamp(x[:, None, :] + step * direction[:, None, :],
                         lo[:, None, :], up[:, None, :])
        return xs, value(xs)

    for n in range(max_iters):
        active = ~done  # every lane has run n < max_iters iterations
        direction = -_two_loop_lanes(g, s_hist, y_hist, rho, valid, head)
        descent = torch.sum(direction * g, dim=1) < 0
        direction = torch.where(descent[:, None], direction, -g)

        if ls_batch > 1:
            scale = torch.ones((k,), dtype=x.dtype, device=dev)
            xs, fs = trial_batch(scale)
            deeper = active & (torch.min(fs, dim=1).values >= f)
            any_deeper = True
            if not graph_safe:
                any_active, any_deeper = torch.stack(
                    [active.any(), deeper.any()]).tolist()
                if not any_active:
                    break
            r = 1
            while any_deeper and r < n_rounds:
                # only the lanes with no improving trial move on
                scale = torch.where(deeper, scale * 0.5**ls_batch, scale)
                xs_n, fs_n = trial_batch(scale)
                xs = torch.where(deeper[:, None, None], xs_n, xs)
                fs = torch.where(deeper[:, None], fs_n, fs)
                r += 1
                deeper = deeper & (torch.min(fs, dim=1).values >= f)
                any_deeper = graph_safe or bool(deeper.any())
            dxs = xs - x[:, None, :]
            armijo = fs <= f[:, None] + c1 * torch.sum(
                dxs * g[:, None, :], dim=2)
            idx = torch.where(armijo.any(dim=1),
                              torch.argmax(armijo.to(torch.int8), dim=1),
                              torch.argmin(fs, dim=1))
            x_new, f_new = xs[lanes, idx], fs[lanes, idx]
        else:
            if not graph_safe and not bool(active.any()):
                break
            # per-lane Armijo backtracking: a lane stops at its first
            # passing (or stuck) trial and keeps it; the last trial is
            # carried even when none passes
            searching = active.clone()
            x_new, f_new = x, f
            alpha = 1.0
            for _ in range(max_ls):
                x_t = torch.clamp(x + alpha * direction, lo, up)
                f_t = value(x_t)
                dx = x_t - x
                x_new = torch.where(searching[:, None], x_t, x_new)
                f_new = torch.where(searching, f_t, f_new)
                ok = f_t <= f + c1 * torch.sum(g * dx, dim=1)
                stuck = torch.max(torch.abs(dx), dim=1).values <= xtol
                searching = searching & ~(ok | stuck)
                alpha *= 0.5
                if not graph_safe and not bool(searching.any()):
                    break

        improved = (f_new < f) & active
        x_new = torch.where(improved[:, None], x_new, x)
        f_new = torch.where(improved, f_new, f)
        if final_grad or (n + 1) < max_iters:
            g_at = _finite_or_zero(value_and_grad(x_new)[1])
            g_new = torch.where(improved[:, None], g_at, g)
        else:
            g_new = g

        s = x_new - x
        y = g_new - g
        sy = torch.sum(s * y, dim=1)
        good = improved & (sy > 1e-10 * torch.linalg.norm(s, dim=1)
                           * torch.linalg.norm(y, dim=1))
        # each lane's head slot, where its pair is good (a one-hot built on
        # the device: an index assignment would copy a host scalar)
        slot = ((torch.arange(history, device=dev)[None, :] == head[:, None])
                & good[:, None])
        s_hist = torch.where(slot[:, :, None], s[:, None, :], s_hist)
        y_hist = torch.where(slot[:, :, None], y[:, None, :], y_hist)
        rho_new = 1.0 / torch.where(sy != 0, sy, torch.ones_like(sy))
        rho = torch.where(slot, rho_new[:, None], rho)
        valid = valid | slot
        head = torch.where(good, (head + 1) % history, head)

        pg = torch.where((x_new <= lo) & (g_new > 0),
                         torch.zeros_like(g_new), g_new)
        pg = torch.where((x_new >= up) & (pg < 0), torch.zeros_like(pg), pg)
        converged = torch.max(torch.abs(pg), dim=1).values <= gtol
        done = torch.where(active, ~improved | converged, done)
        it = it + active.to(it.dtype)
        x, f, g = x_new, f_new, g_new
    return LbfgsbResult(x=x, fun=f, n_iters=it, converged=done)


def multistart_minimize(fun, x0s, lower, upper, **kw):
    """Multistart over lockstep lanes: ``x0s`` (k, d) -> the best
    ``(x, f)`` across starts and the per-lane result (port of
    egobox_tpu/optim/lbfgsb.py ``multistart_minimize``; ``fun`` as the
    lockstep form of ``minimize_lbfgsb`` takes it)."""
    res = minimize_lbfgsb(fun, x0s, lower, upper, **kw)
    best = torch.argmin(res.fun)
    return res.x[best], res.fun[best], res


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
