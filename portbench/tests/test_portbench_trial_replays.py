"""The reader of ``trial_replays.fit`` on a synthetic trace: the program's
trial span counted per fit traced with the host's operations, and nothing
where the span never ran."""

from __future__ import annotations

import pytest

from portbench import common, harness
from portbench.tests.test_portbench_arith import CUDA, Ev
from portbench.trace import WINDOW_SPAN, Trace

SPAN = "egobox_torch.lkh_trial"


@pytest.fixture
def read():
    return harness.load_reader(common.ROOT, "trial_replays.fit")


def test_counts_the_trial_span_per_traced_fit(read):
    tr = Trace([
        Ev(WINDOW_SPAN, 0, 1000),
        *(Ev(SPAN, 10 + 100 * i, 20) for i in range(7)),
        Ev("cudaGraphLaunch", 12, 5, corr=3),
        Ev("getrf_wo_pivot", 20, 30, dev=CUDA, corr=3),
        # the span's mark on the device's timeline is not a call
        Ev(SPAN, 20, 30, dev=CUDA),
        Ev(SPAN, 2000, 20),  # after the window
    ])
    assert read({"host_trace": tr, "host_traced_units": 2}) == 3.5


def test_reads_nothing_without_the_span(read):
    # the parent: trials dispatched operator by operator, no span
    tr = Trace([Ev(WINDOW_SPAN, 0, 1000),
                Ev("aten::linalg_cholesky_ex", 10, 20)])
    assert read({"host_trace": tr, "host_traced_units": 2}) is None
    assert read({"host_trace": None, "host_traced_units": 0}) is None
    assert read({}) is None
