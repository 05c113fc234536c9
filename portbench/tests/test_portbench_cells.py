"""Each cell's harness path at a tiny size on the CPU: set-up, window,
check against the reference, and the result's line."""

from __future__ import annotations

import json

import pytest

from portbench import harness
from portbench.tests import tiny

CELLS = sorted(tiny.OVERRIDES)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_cpu(name, trace):
    res = tiny.run(name, bool(trace))
    json.dumps(res)  # the result's line is JSON
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    cell = harness.Cell(tiny.spec(), name)
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        names = {m["name"] for m in cell.per_layer()}
        assert set(res["metrics"]) <= names
        # a CPU run reads no device time: only counters and the idle share
        for key in res["metrics"]:
            assert not key.startswith("factor_ms")
    else:
        assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end()}
        assert all(m["value"] > 0 for m in res["metrics"].values())
    for row in res["checks"].values():
        assert row["value"] <= row["limit"]


#: the inputs each driver draws from the seed in set-up, and those that are
#: the same for every seed (the fit cell's pool of data sets)
INPUTS = {
    "gp-fit.kpls1-d10-n3k":
        lambda d: [d.holdout, [d.data_set(i) for i in range(40)]],
}
SHARED = {
    "gp-fit.kpls1-d10-n3k": lambda d: [x for x, _, _ in d.data],
}


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_inputs(name):
    """The seed fixes the inputs: two set-ups of one seed draw the same
    data, another seed other data; a pool shared by every seed is the
    same under each."""
    import numpy as np

    cell = harness.Cell(tiny.spec(), name)
    over = tiny.OVERRIDES[name]

    def driver(seed):
        traffic = dict(cell.traffic, **dict(over["traffic"], warmup=0))
        drv = cell.driver().Driver(dict(cell.config, **over["config"]),
                                   traffic, seed, "cpu")
        drv.setup()
        return drv

    a, b, c = driver(tiny.SEED), driver(tiny.SEED), driver(tiny.SEED + 1)
    same = [np.array_equal(u, v) for u, v in
            zip(INPUTS[name](a), INPUTS[name](b))]
    other = [np.array_equal(u, w) for u, w in
             zip(INPUTS[name](a), INPUTS[name](c))]
    assert all(same) and not any(other)
    for u, w in zip(SHARED[name](a), SHARED[name](c)):
        assert np.array_equal(u, w)


def test_each_pass_fits_the_whole_pool():
    cell = harness.Cell(tiny.spec(), "gp-fit.kpls1-d10-n3k")
    over = tiny.OVERRIDES["gp-fit.kpls1-d10-n3k"]
    traffic = dict(cell.traffic, **dict(over["traffic"], warmup=0))
    drv = cell.driver().Driver(dict(cell.config, **over["config"]),
                               traffic, tiny.SEED, "cpu")
    drv.setup()
    k = len(drv.data)
    for p in range(5):
        assert sorted(drv.data_set(i) for i in range(p * k, (p + 1) * k)) \
            == list(range(k))


def test_the_design_is_a_latin_hypercube():
    """One point in each of n equal strata of every dimension."""
    import numpy as np

    from portbench.drivers.fit_loop import lhs

    x = lhs(np.random.default_rng(5), 64, 3, -600.0, 600.0)
    strata = np.floor((x + 600.0) / 1200.0 * 64).astype(int)
    for j in range(3):
        assert sorted(strata[:, j]) == list(range(64))
