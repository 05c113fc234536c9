"""The traced window: ``torch.profiler`` over the device and the host, and
its reduction to what the per-layer readers and the result's ``device``
and ``breakdown`` need.

Busy time is the union of every device interval (kernels, copies, sets)
inside the window; idle time the rest. Device time is attributed either by
kernel name or by the host operation that launched the kernel (the
profiler's correlation id joins a kernel to its launch, and the launch lies
inside the operation on the host's thread).

A window traced with ``host_ops`` records the host's operations too, which
attributes device time to them and costs the host some time per operation;
without, only the device's activity and the CUDA runtime's calls are
recorded, and two synchronizes mark the window's ends."""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

import torch

WINDOW_SPAN = "portbench.window"
#: the runtime call that marks the ends of a window traced without host ops
SYNC = "cudaDeviceSynchronize"
#: longest name kept for an entry of the breakdown
NAME_CHARS = 120


def _intervals_union(iv):
    """Merged, sorted (start, end) of possibly overlapping intervals."""
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _annotation(e) -> bool:
    """True for a host span the profiler also draws on the device."""
    probe = getattr(e, "is_user_annotation", None)
    return bool(probe()) if probe is not None else False


class Trace:
    """The events of one traced window, in nanoseconds of one clock."""

    def __init__(self, events):
        self.device = []  # (start, end, name, correlation id)
        self.host = defaultdict(list)  # thread -> [(start, end, name)]
        launches = {}
        window = None
        syncs = []
        for e in events:
            start, dur = e.start_ns(), e.duration_ns()
            name = e.name()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if name.startswith("portbench.") or _annotation(e):
                    continue  # a span's mark on the device's timeline
                self.device.append((start, start + dur, name,
                                    e.correlation_id()))
                continue
            thread = e.start_thread_id()
            if name == WINDOW_SPAN:
                window = (start, start + dur, thread)
            elif name == SYNC:
                syncs.append((start, start + dur, thread))
            self.host[thread].append((start, start + dur, name))
            if name.startswith(("cuda", "cu")) and e.correlation_id():
                launches[e.correlation_id()] = (thread, start)
        if window is None and len(syncs) >= 2:
            syncs.sort()
            window = (syncs[0][0], syncs[-1][1], syncs[0][2])
        if window is None:
            raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span and "
                               f"no two {SYNC} calls")
        self.t0, self.t1, self.thread = window
        self.launches = launches
        for evs in self.host.values():
            evs.sort()
        inside = []
        for s, e, name, corr in self.device:
            s, e = max(s, self.t0), min(e, self.t1)
            if e > s:
                inside.append((s, e, name, corr))
        self.device = inside
        self.busy = _intervals_union([(s, e) for s, e, _, _ in inside])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-9

    def device_time_under(self, host_ops) -> float:
        """Seconds of device work launched from inside a host operation
        named in ``host_ops``."""
        spans = {thread: _intervals_union([(s, e) for s, e, name in evs
                                           if name in host_ops])
                 for thread, evs in self.host.items()}
        starts = {t: [s for s, _ in iv] for t, iv in spans.items()}
        total = 0
        for s, e, _, corr in self.device:
            where = self.launches.get(corr)
            if where is None:
                continue
            thread, at = where
            iv = spans.get(thread)
            if not iv:
                continue
            # the merged spans are disjoint: only the latest one starting
            # at or before the launch can hold it
            i = bisect.bisect_right(starts[thread], at) - 1
            if i >= 0 and iv[i][1] >= at:
                total += e - s
        return total * 1e-9

    def host_op_count(self, host_ops) -> int:
        """Calls of the host operations named in ``host_ops`` that start
        inside the window, on any thread; a call nested in another of them
        counts once."""
        k = 0
        for evs in self.host.values():
            end = None
            for s, e, name in evs:
                if name in host_ops and self.t0 <= s < self.t1:
                    if end is None or s >= end:
                        k += 1
                        end = e
        return k

    def device_ops(self, top: int = 10):
        """The device operations that took most time: [[name, seconds]]."""
        by = defaultdict(int)
        for s, e, name, _ in self.device:
            by[name[:NAME_CHARS]] += e - s
        rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[name, ns * 1e-9] for name, ns in rows]

    def idle_gaps(self, top: int = 10):
        """Idle device time by what the host's main thread was doing: the
        innermost host operation open at the middle of each gap, or the
        Python between operations. [[name, seconds]], largest first."""
        gaps = []
        prev = self.t0
        for s, e in self.busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        evs = self.host.get(self.thread, [])
        by = defaultdict(int)
        stack, j = [], 0
        for s, e in gaps:
            mid = (s + e) // 2
            while j < len(evs) and evs[j][0] <= mid:
                stack.append(evs[j])
                j += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            name = stack[-1][2] if stack else "python"
            if name.startswith("portbench."):
                name = f"python in {name}"
            by[name[:NAME_CHARS]] += e - s
        rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[name, ns * 1e-9] for name, ns in rows]


@contextlib.contextmanager
def traced(enabled: bool, device: str, sink: list, host_ops: bool = True):
    """Profile the block when ``enabled``; append to ``sink`` a function that
    reduces the profile to the block's ``Trace`` (called once the measured
    window has closed: the reduction takes seconds). The block runs inside the window span (a synchronize at each
    end marks it where the host's operations are not recorded) and ends
    with a synchronize, so that its device work lies inside the window."""
    if not enabled:
        yield
        return
    cuda = device == "cuda"
    acts = [torch.profiler.ProfilerActivity.CUDA] if cuda else []
    if host_ops or not cuda:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW_SPAN):
            if cuda:
                torch.cuda.synchronize()
            yield
            if cuda:
                torch.cuda.synchronize()
    sink.append(lambda: Trace(prof.profiler.kineto_results.events()))
