"""Device milliseconds per fit of the library's Cholesky and triangular
solves that the fit's line-search trial graph replays, in the window traced
with the host's operations.

factor_ms.fit reads these kernels where the host launches them, inside its
Cholesky and solve operations. A graph's kernels are launched by its replay
(inside the program's ``egobox_torch.lkh_trial`` span) and lie outside
those operations, so factor_ms.fit plus this reading is the layer's device
time. The program runs each fit's trial once eagerly before it captures it
(inside ``egobox_torch.lkh_trial_warmup``): of the replays' kernels of each
name this reader takes the share of device time that the warm-ups' kernels
of that name spent inside the Cholesky and solves. None where the program
has no trial span (every trial dispatched operator by operator)."""

import bisect
from collections import defaultdict

#: the host operations of factor_ms.fit
FACTOR_OPS = ("aten::linalg_cholesky_ex", "aten::linalg_cholesky",
              "aten::linalg_solve_triangular", "aten::linalg_solve_ex")
TRIAL_SPAN = "egobox_torch.lkh_trial"
WARMUP_SPAN = "egobox_torch.lkh_trial_warmup"


def launched_inside(tr, host_ops) -> set:
    """Correlation ids of the device work whose launch lies inside a host
    operation named in ``host_ops``, on the launching thread."""
    spans, starts = {}, {}
    for thread, evs in tr.host.items():
        merged = []
        for s, e in sorted((s, e) for s, e, name in evs if name in host_ops):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        spans[thread] = merged
        starts[thread] = [s for s, _ in merged]
    inside = set()
    for _, _, _, corr in tr.device:
        where = tr.launches.get(corr)
        if where is None or not spans.get(where[0]):
            continue
        thread, at = where
        i = bisect.bisect_right(starts[thread], at) - 1
        if i >= 0 and spans[thread][i][1] >= at:
            inside.add(corr)
    return inside


def read(ctx):
    tr = ctx.get("host_trace")
    units = ctx.get("host_traced_units")
    if tr is None or not units:
        return None
    trial = launched_inside(tr, (TRIAL_SPAN,))
    if not trial:
        return None
    warm = launched_inside(tr, (WARMUP_SPAN,))
    factor = launched_inside(tr, FACTOR_OPS)
    in_factor, total = defaultdict(int), defaultdict(int)
    for s, e, name, corr in tr.device:
        if corr in warm:
            total[name] += e - s
            if corr in factor:
                in_factor[name] += e - s
    t = sum((e - s) * in_factor[name] / total[name]
            for s, e, name, corr in tr.device
            if corr in trial and total.get(name))
    return 1e-6 * t / units if t > 0 else None
