"""Plain reference of dense kriging with KPLS weights.

Straight PyTorch, written from the published definitions (egobox's
``crates/gp/src/algorithm.rs``, ``correlation_models.rs`` and its PLS
weights), and independent of the package under test: it imports nothing of
it. It takes raw training data and works out everything else again: the
normalization, the PLS weights, the Gram, the regularized correlation
matrix, its Cholesky factor, the GLS trend, the reduced likelihood, the
posterior, and the likelihood's maximum over theta, all in float64 (with
TF32 switched off in torch all the same).
"""

from __future__ import annotations

import math

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: elements of one (rows, n2, d) block of squared differences
BLOCK_ELEMENTS = 32_000_000
#: the global search over theta: points per decade of the log grid, and
#: golden-section steps around the grid's best point
GRID_PER_DECADE = 10
GOLDEN_STEPS = 16
_GOLD = (math.sqrt(5.0) - 1.0) / 2.0


def _solve_lower(l_fac, b):
    return torch.linalg.solve_triangular(l_fac, b, upper=False)


def normalize(v: torch.Tensor):
    """Column means and standard deviations (n - 1 denominator; a zero
    deviation counts as 1)."""
    mean = v.mean(dim=0)
    std = v.std(dim=0, unbiased=True)
    return mean, torch.where(std <= 0, torch.ones_like(std), std)


def pls_weights(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(nx, 1): the rotation of a one-component PLS regression of y on x,
    both standardized. With one component NIPALS stops after one step:
    w = X^T y / |X^T y|, and the rotation W (P^T W)^-1 is w itself
    (P^T W = t^T X w / t^T t = 1). Its sign does not matter: the kernel
    takes its squares."""
    xm, xs = normalize(x)
    ym, ys = normalize(y)
    w = ((x - xm) / xs).T @ ((y - ym) / ys)
    return w / torch.linalg.norm(w)


def weighted_sq_dist(x1, x2, weights):
    """(n1, n2): sum_j (sum_k w_jk^2) (x1_j - x2_j)^2, from the differences
    themselves, in blocks of rows of x1. For one component this is the
    whole of the squared-exponential Gram's dependence on the points."""
    if weights.shape[1] != 1:
        raise ValueError("the reference has one KPLS component only")
    c = weights[:, 0] ** 2
    n2, d = x2.shape
    rows = max(1, BLOCK_ELEMENTS // max(1, n2 * d))
    out = torch.empty((x1.shape[0], n2), dtype=x1.dtype, device=x1.device)
    for s in range(0, x1.shape[0], rows):
        diff = x1[s:s + rows, None, :] - x2[None, :, :]
        out[s:s + rows] = torch.sum(diff * diff * c, dim=-1)
    return out


def sqexp_from_dist(dist, theta: float):
    """r = exp(-theta^2 / 2 * dist): egobox's squared exponential with
    KPLS weights, exp(-1/2 sum_j (theta w_j)^2 (x1_j - x2_j)^2)."""
    return torch.exp(-0.5 * theta * theta * dist)


class Problem:
    """One training set, normalized, with its PLS weights and the weighted
    squared distances of its points: what the likelihood needs at any
    theta. ``nugget`` regularizes R as the configuration states: R's
    diagonal is 1 + nugget * max(1, largest row sum of |R|)."""

    def __init__(self, x, y, *, nugget: float, device=None):
        dt = torch.float64
        device = device or "cpu"
        x = torch.as_tensor(x, dtype=dt, device=device)
        y = torch.as_tensor(y, dtype=dt, device=device).reshape(-1, 1)
        self.n = x.shape[0]
        self.x_mean, self.x_std = normalize(x)
        self.y_mean, self.y_std = normalize(y)
        self.xn = (x - self.x_mean) / self.x_std
        self.yn = (y - self.y_mean) / self.y_std
        self.weights = pls_weights(x, y)
        self.dist = weighted_sq_dist(self.xn, self.xn, self.weights)
        self.nugget = nugget

    def factor(self, theta: float):
        """(L, info): the Cholesky factor of the regularized R at theta."""
        r = sqexp_from_dist(self.dist, theta)
        r.diagonal().fill_(1.0)
        row_max = float(torch.sum(torch.abs(r), dim=1).max())
        r.diagonal().add_(self.nugget * max(1.0, row_max))
        l_fac, info = torch.linalg.cholesky_ex(r)
        return l_fac, int(info)

    def likelihood(self, theta: float) -> float:
        """egobox's reduced likelihood at theta; -inf where R is not
        positive definite to float64."""
        l_fac, info = self.factor(theta)
        if info != 0:
            return -math.inf
        return _GlsFit(self, l_fac).likelihood

    def best_likelihood(self, lo: float, hi: float) -> tuple:
        """(theta, likelihood): the likelihood's maximum over [lo, hi], by
        a log grid of ``GRID_PER_DECADE`` points a decade and a golden
        section between the best grid point's neighbours."""
        decades = math.log10(hi / lo)
        k = max(2, int(math.ceil(decades * GRID_PER_DECADE)) + 1)
        grid = [lo * (hi / lo) ** (i / (k - 1)) for i in range(k)]
        vals = [self.likelihood(t) for t in grid]
        i = max(range(k), key=lambda j: vals[j])
        best = (grid[i], vals[i])
        a = math.log(grid[max(0, i - 1)])
        b = math.log(grid[min(k - 1, i + 1)])
        c, d = b - _GOLD * (b - a), a + _GOLD * (b - a)
        fc, fd = self.likelihood(math.exp(c)), self.likelihood(math.exp(d))
        for _ in range(GOLDEN_STEPS):
            if fc >= fd:
                b, d, fd = d, c, fc
                c = b - _GOLD * (b - a)
                fc = self.likelihood(math.exp(c))
            else:
                a, c, fc = c, d, fd
                d = a + _GOLD * (b - a)
                fd = self.likelihood(math.exp(d))
        for t, v in ((math.exp(c), fc), (math.exp(d), fd)):
            if v > best[1]:
                best = (t, v)
        return best

    def model(self, theta: float) -> "_GlsFit":
        l_fac, info = self.factor(theta)
        if info != 0:
            raise ValueError(f"R is not positive definite at theta={theta}")
        return _GlsFit(self, l_fac, theta)


class _GlsFit:
    """The constant-trend GLS fit on a factor of R: trend, residual weights,
    process variance, the reduced likelihood and the posterior."""

    def __init__(self, p: Problem, l_fac, theta: float | None = None):
        n, dt = p.n, p.xn.dtype
        self.p, self.l_fac, self.theta = p, l_fac, theta
        ones = torch.ones((n, 1), dtype=dt, device=p.xn.device)
        self.ft = _solve_lower(l_fac, ones)
        yt = _solve_lower(l_fac, p.yn)
        ftft = self.ft.T @ self.ft  # (1, 1)
        self.qr_r = torch.sqrt(ftft)
        self.beta = (self.ft.T @ yt) / ftft
        rho = yt - self.ft * self.beta
        self.gamma = torch.linalg.solve_triangular(l_fac.T, rho, upper=True)
        self.sigma2_norm = torch.sum(rho * rho) / n
        logdet = 2.0 * torch.sum(torch.log10(torch.diagonal(l_fac))) / n
        self.likelihood = float(-n * (torch.log10(self.sigma2_norm) + logdet))
        self.sigma2 = float(self.sigma2_norm) * float(p.y_std) ** 2

    def predict_valvar(self, x, rows: int = 4096):
        """Posterior mean and variance (clipped at 0) at x, as float64
        numpy arrays, in blocks of ``rows`` points."""
        p = self.p
        x = torch.as_tensor(x, dtype=torch.float64, device=p.xn.device)
        means, variances = [], []
        for s in range(0, x.shape[0], rows):
            xn = (x[s:s + rows] - p.x_mean) / p.x_std
            r = sqexp_from_dist(weighted_sq_dist(xn, p.xn, p.weights),
                                self.theta)  # (b, n)
            mean = self.beta[0, 0] + (r @ self.gamma)[:, 0]
            means.append(mean * p.y_std + p.y_mean)
            rt = _solve_lower(self.l_fac, r.T)  # (n, b)
            u = ((self.ft.T @ rt)[0] - 1.0) / self.qr_r[0, 0]
            mse = 1.0 - torch.sum(rt * rt, dim=0) + u * u
            variances.append(torch.clamp(mse, min=0.0) * self.sigma2_norm
                             * p.y_std ** 2)
        return (torch.cat(means).cpu().numpy(),
                torch.cat(variances).cpu().numpy())
