"""The reader of ``trial_factor_ms.fit`` on a synthetic trace: the trial
graph's kernels, each name's time shared as the eager warm-up trial shared
it between the Cholesky and solves and the other operations, per fit traced
with the host's operations; nothing where the program has no trial span."""

from __future__ import annotations

import pytest

from portbench import common, harness
from portbench.tests.test_portbench_arith import CUDA, Ev
from portbench.trace import WINDOW_SPAN, Trace

SPAN = "egobox_torch.lkh_trial"
WARMUP = "egobox_torch.lkh_trial_warmup"


@pytest.fixture
def read():
    return harness.load_reader(common.ROOT, "trial_factor_ms.fit")


def _eager_trial():
    # the warm-up, dispatched operator by operator: the Cholesky launches
    # getrf and a copy, the Gram launches a copy three times as long
    return [
        Ev(WARMUP, 10, 80),
        Ev("aten::linalg_cholesky_ex", 10, 20),
        Ev("cudaLaunchKernel", 12, 2, corr=1),
        Ev("getrf_wo_pivot", 15, 100_000, dev=CUDA, corr=1),
        Ev("cudaLaunchKernel", 14, 2, corr=2),
        Ev("copy", 100_020, 1_000, dev=CUDA, corr=2),
        Ev("aten::linalg_solve_triangular", 40, 10),
        Ev("cudaLaunchKernel", 42, 2, corr=3),
        Ev("trsv_ln", 101_100, 50_000, dev=CUDA, corr=3),
        Ev("aten::mm", 60, 10),
        Ev("cudaLaunchKernel", 62, 2, corr=4),
        Ev("copy", 151_200, 3_000, dev=CUDA, corr=4),
        Ev("cudaLaunchKernel", 70, 2, corr=5),
        Ev("elementwise", 154_300, 7_000, dev=CUDA, corr=5),
    ]


def test_reads_the_library_kernels_of_the_replays(read):
    tr = Trace([
        Ev(WINDOW_SPAN, 0, 10_000_000),
        *_eager_trial(),
        # two replays, each launching the trial's kernels at once
        *(ev for k, t in enumerate((1_000_000, 2_000_000)) for ev in (
            Ev(SPAN, t, 20),
            Ev("cudaGraphLaunch", t + 5, 5, corr=10 + k),
            Ev("getrf_wo_pivot", t + 10, 100_000, dev=CUDA, corr=10 + k),
            Ev("copy", t + 100_010, 4_000, dev=CUDA, corr=10 + k),
            Ev("trsv_ln", t + 104_010, 50_000, dev=CUDA, corr=10 + k),
            Ev("elementwise", t + 154_010, 7_000, dev=CUDA, corr=10 + k))),
        # an eager Cholesky outside the warm-up is factor_ms.fit's alone
        Ev("aten::linalg_cholesky_ex", 3_000_000, 20),
        Ev("cudaLaunchKernel", 3_000_005, 2, corr=20),
        Ev("getrf_wo_pivot", 3_000_010, 100_000, dev=CUDA, corr=20),
        Ev("cudaLaunchKernel", 3_000_008, 2, corr=21),
        Ev("copy", 3_100_010, 9_000, dev=CUDA, corr=21),
    ])
    # per replay: getrf and trsv whole, a quarter of the copies (1 000 of
    # the warm-up's 4 000 ns were the Cholesky's), none of the elementwise
    # kernel; two replays over 2 fits
    assert read({"host_trace": tr, "host_traced_units": 2}) == pytest.approx(
        2 * (100_000 + 1_000 + 50_000) * 1e-6 / 2)


def test_reads_nothing_without_the_span(read):
    # the parent: every trial dispatched operator by operator
    tr = Trace([Ev(WINDOW_SPAN, 0, 1_000_000), *_eager_trial()])
    assert read({"host_trace": tr, "host_traced_units": 2}) is None
    assert read({"host_trace": None, "host_traced_units": 0}) is None
    assert read({}) is None
