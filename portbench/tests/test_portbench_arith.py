"""The benchmark's arithmetic on hand-counted cases: the busy and idle
time of a trace, the attribution of device time, the count of host
operations, and the judgement of a check."""

from __future__ import annotations

import math

import pytest
import torch

from portbench import harness, kernels
from portbench.trace import WINDOW_SPAN, Trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Ev:
    """A stand-in for the profiler's event."""

    def __init__(self, name, start, dur, dev=CPU, corr=0, thread=1):
        self._v = (name, start, dur, dev, corr, thread)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]


def _trace():
    return Trace([
        Ev(WINDOW_SPAN, 0, 100),
        Ev("aten::linalg_cholesky_ex", 6, 10),
        Ev("cudaLaunchKernel", 7, 1, corr=7),
        Ev("aten::mul", 50, 10),
        Ev("cudaLaunchKernel", 52, 1, corr=8),
        Ev("cudaStreamSynchronize", 60, 25),
        Ev("potrf_kernel", 10, 20, dev=CUDA, corr=7),
        Ev("elementwise_kernel", 20, 20, dev=CUDA, corr=8),
        Ev("corr_tile_kernel", 90, 30, dev=CUDA, corr=9),
        Ev("corr_tile_kernel", 150, 30, dev=CUDA, corr=10),
    ])


def test_busy_and_idle_by_hand():
    tr = _trace()
    # [10, 40] and [90, 100] (the last cut at the window's end; the one
    # after the window left out)
    assert tr.window_s == pytest.approx(100e-9)
    assert tr.busy_s == pytest.approx(40e-9)
    ctx = {"trace": tr}
    assert kernels.idle_pct(ctx) == pytest.approx(60.0)
    assert tr.device_time_under(("aten::linalg_cholesky_ex",)) == \
        pytest.approx(20e-9)
    assert tr.device_time_under(("aten::mul",)) == pytest.approx(20e-9)
    ops = dict(tr.device_ops())
    assert ops == pytest.approx({"potrf_kernel": 20e-9,
                                 "elementwise_kernel": 20e-9,
                                 "corr_tile_kernel": 10e-9})


def test_idle_gaps_by_what_the_host_did():
    # gaps: [0, 10] (the window span alone: python), [40, 90] whose middle
    # (65) lies in the synchronize
    gaps = dict(_trace().idle_gaps())
    assert gaps == pytest.approx({"cudaStreamSynchronize": 50e-9,
                                  f"python in {WINDOW_SPAN}": 10e-9})


def test_host_ops_counted_once_per_call():
    tr = _trace()
    ctx = {"host_trace": tr, "host_traced_units": 2}
    assert tr.host_op_count(("aten::linalg_cholesky_ex",)) == 1
    assert tr.host_op_count(("aten::linalg_cholesky_ex", "aten::mul")) == 2
    assert kernels.host_ops_per_unit(ctx, ("aten::mul",)) == 0.5
    assert kernels.host_ops_per_unit(ctx, ("aten::cumsum",)) is None
    # a call nested in another of the named ones counts once
    nested = Trace([Ev(WINDOW_SPAN, 0, 100),
                    Ev("aten::linalg_cholesky", 5, 20),
                    Ev("aten::linalg_cholesky_ex", 6, 10),
                    Ev("aten::linalg_cholesky_ex", 200, 10)])
    assert nested.host_op_count(("aten::linalg_cholesky",
                                 "aten::linalg_cholesky_ex")) == 1


@pytest.mark.parametrize("value,ok", [(0.5, True), (1.0, True), (1.5, False),
                                      (math.nan, False), (None, False)])
def test_judge(value, ok):
    checks = {} if value is None else {"gap": value}
    correct, rows = harness.judge(checks, {"gap": 1.0})
    assert correct is ok
    assert rows == {"gap": {"value": value, "limit": 1.0}}
