"""Faults planted under the timed path, for the tests that see them come out
not correct (``tests/test_portbench_faults.py``, on the CPU) and for their
readings at the cell's full size on a card (``calibrate.py --fault``).

Each fault replaces ``egobox_torch.gp.fit_gp``, which the fit loop calls,
and returns a function that puts it back."""

from __future__ import annotations

import dataclasses


def _swap(wrap):
    from egobox_torch import gp

    fit = gp.fit_gp
    gp.fit_gp = wrap(fit)

    def undo():
        gp.fit_gp = fit

    return undo


def stale_model():
    """Every fit returns the model of the first: the state never moves."""
    first = []

    def wrap(fit):
        def stale(x, y, **kw):
            if not first:
                first.append(fit(x, y, **kw))
            return first[0]
        return stale

    return _swap(wrap)


def theta_unchanged():
    """Theta stays at its init: the likelihood is never optimised."""
    def wrap(fit):
        def fixed(x, y, **kw):
            return fit(x, y, **dict(kw, theta_fixed=True))
        return fixed

    return _swap(wrap)


def one_iteration():
    """The optimisation cut short: no restarts, one L-BFGS-B iteration."""
    def wrap(fit):
        def short(x, y, **kw):
            return fit(x, y, **dict(kw, n_start=0, max_iters=1))
        return short

    return _swap(wrap)


def half_the_data():
    """The model is fitted on the first half of the points."""
    def wrap(fit):
        def half(x, y, **kw):
            n = x.shape[0] // 2
            return fit(x[:n], y[:n], **kw)
        return half

    return _swap(wrap)


def likelihood_altered():
    """The answer altered where it is produced: the likelihood 1 % off."""
    def wrap(fit):
        def altered(x, y, **kw):
            m = fit(x, y, **kw)
            return dataclasses.replace(m, likelihood=m.likelihood * 1.01)
        return altered

    return _swap(wrap)


FAULTS = {
    "stale-model": stale_model,
    "theta-unchanged": theta_unchanged,
    "one-iteration": one_iteration,
    "half-the-data": half_the_data,
    "likelihood-altered": likelihood_altered,
}
