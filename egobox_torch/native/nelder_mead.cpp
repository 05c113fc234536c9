// Derivative-free box-constrained simplex optimizer (native runtime
// component).
//
// Role parity with the reference's COBYLA/SLSQP local optimizers
// (egobox's cobyla/slsqp crates, used at crates/gp/src/optimization.rs and
// crates/ego/src/optimizers/optimizer.rs): a robust derivative-free local
// minimizer for noisy/flat objectives where the gradient-based device path is
// unreliable. Exposed through a C ABI consumed via ctypes
// (egobox_torch/native/__init__.py); constraints are handled by the Python
// wrapper with an adaptive penalty, matching the COBYLA usage pattern.
//
// Algorithm: Nelder-Mead with the adaptive parameters of Gao & Han (2012)
// and projection of every trial vertex onto the box.

#include <algorithm>
#include <cmath>
#include <cstring>
#include <vector>

extern "C" {

typedef double (*egx_objfn)(const double* x, int n, void* user);

// returns number of function evaluations used (>0), or -1 on bad input
int egx_nelder_mead(egx_objfn f, void* user, int n, double* x,
                    const double* lo, const double* hi, int max_eval,
                    double xatol, double fatol, double* fmin_out) {
  if (n <= 0 || max_eval <= 0) return -1;

  // adaptive NM parameters (Gao & Han 2012)
  const double alpha = 1.0;
  const double beta = 1.0 + 2.0 / n;
  const double gamma = 0.75 - 1.0 / (2.0 * n);
  const double delta = 1.0 - 1.0 / n;

  auto clip = [&](std::vector<double>& v) {
    for (int i = 0; i < n; ++i) v[i] = std::min(std::max(v[i], lo[i]), hi[i]);
  };

  int evals = 0;
  auto eval = [&](const std::vector<double>& v) {
    ++evals;
    double val = f(v.data(), n, user);
    if (!std::isfinite(val)) val = 1e300;
    return val;
  };

  // initial simplex: x0 plus per-coordinate steps scaled to the box
  std::vector<std::vector<double>> simplex(n + 1,
                                           std::vector<double>(x, x + n));
  clip(simplex[0]);
  for (int i = 0; i < n; ++i) {
    double span = hi[i] - lo[i];
    double step = (span > 0) ? 0.05 * span : 0.1;
    if (simplex[0][i] + step > hi[i]) step = -step;
    simplex[i + 1][i] += step;
    clip(simplex[i + 1]);
  }

  std::vector<double> fv(n + 1);
  for (int i = 0; i <= n; ++i) fv[i] = eval(simplex[i]);

  std::vector<int> order(n + 1);
  std::vector<double> centroid(n), xr(n), xe(n), xc(n);

  while (evals < max_eval) {
    for (int i = 0; i <= n; ++i) order[i] = i;
    std::sort(order.begin(), order.end(),
              [&](int a, int b) { return fv[a] < fv[b]; });
    int best = order[0], worst = order[n], second_worst = order[n - 1];

    // convergence: simplex size and function spread
    double fspread = std::fabs(fv[worst] - fv[best]);
    double xspread = 0.0;
    for (int i = 0; i < n; ++i)
      xspread = std::max(
          xspread, std::fabs(simplex[worst][i] - simplex[best][i]));
    if (fspread <= fatol && xspread <= xatol) break;

    // centroid of all but worst
    std::fill(centroid.begin(), centroid.end(), 0.0);
    for (int k = 0; k <= n; ++k) {
      if (k == worst) continue;
      for (int i = 0; i < n; ++i) centroid[i] += simplex[k][i];
    }
    for (int i = 0; i < n; ++i) centroid[i] /= n;

    // reflection
    std::vector<double> xrv(n);
    for (int i = 0; i < n; ++i)
      xrv[i] = centroid[i] + alpha * (centroid[i] - simplex[worst][i]);
    clip(xrv);
    double fr = eval(xrv);

    if (fr < fv[best]) {
      // expansion
      std::vector<double> xev(n);
      for (int i = 0; i < n; ++i)
        xev[i] = centroid[i] + beta * (xrv[i] - centroid[i]);
      clip(xev);
      double fe = eval(xev);
      if (fe < fr) {
        simplex[worst] = xev;
        fv[worst] = fe;
      } else {
        simplex[worst] = xrv;
        fv[worst] = fr;
      }
    } else if (fr < fv[second_worst]) {
      simplex[worst] = xrv;
      fv[worst] = fr;
    } else {
      // contraction (outside if reflected better than worst, else inside)
      std::vector<double> xcv(n);
      bool outside = fr < fv[worst];
      const std::vector<double>& towards = outside ? xrv : simplex[worst];
      for (int i = 0; i < n; ++i)
        xcv[i] = centroid[i] + gamma * (towards[i] - centroid[i]);
      clip(xcv);
      double fc = eval(xcv);
      double fref = outside ? fr : fv[worst];
      if (fc <= fref) {
        simplex[worst] = xcv;
        fv[worst] = fc;
      } else {
        // shrink towards best
        for (int k = 0; k <= n; ++k) {
          if (k == best) continue;
          for (int i = 0; i < n; ++i)
            simplex[k][i] =
                simplex[best][i] + delta * (simplex[k][i] - simplex[best][i]);
          clip(simplex[k]);
          fv[k] = eval(simplex[k]);
          if (evals >= max_eval) break;
        }
      }
    }
  }

  int best = 0;
  for (int i = 1; i <= n; ++i)
    if (fv[i] < fv[best]) best = i;
  std::memcpy(x, simplex[best].data(), n * sizeof(double));
  if (fmin_out) *fmin_out = fv[best];
  return evals;
}

}  // extern "C"
