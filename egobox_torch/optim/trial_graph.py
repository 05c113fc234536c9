"""The line-search trial of the one-lane L-BFGS-B as one CUDA graph.

``TrialGraph`` runs lbfgsb.py's ``fused_trial`` (the clip, the objective
without autograd, the Armijo and stuck tests) for every trial of every
restart of one fit: captured at the fit's first trial, replayed after, each
replay inside the profiler span ``TRIAL_SPAN``. It belongs to one fit:
``close`` frees the graph when the fit returns, so nothing keyed by the
data outlives the fit. Its memory pool belongs to the card
(``_card_pool``): the closed graph's blocks go back to it, and the next
fit's capture takes them again instead of asking the device for memory
anew. A capture that had to grow a pool an earlier fit used (a fit of
another size) lets the pool go when its fit returns: the caching allocator
frees a pool no graph holds when it runs short of memory or empties its
cache, and the next fit starts a new one. Fits on one card run one at a
time, as every caller runs them: two live trial graphs of one card would
share the pool's blocks. The warm-up trial runs inside the span
``WARMUP_SPAN``.
"""

from __future__ import annotations

import functools
import time

import torch

from ..ops.graph_stats import (GraphStats, add_counts, launch_counts,
                               launches_since)
from .lbfgsb import FusedTrial, fused_trial

#: the profiler spans around each replay of a ``TrialGraph`` and around
#: the eager trial before its capture
TRIAL_SPAN = "egobox_torch.lkh_trial"
WARMUP_SPAN = "egobox_torch.lkh_trial_warmup"

#: each card's graph memory pool for its trial graphs: [the graph that
#: holds it, whether a fit has captured into it]
_POOLS: dict = {}


@functools.lru_cache(maxsize=None)
def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """One side stream per card for every ``TrialGraph``: the warm-up and
    the capture run on it, and the library keeps a cuBLAS workspace per
    stream, so a stream per fit would leave one workspace per fit."""
    return torch.cuda.Stream(device)


def _card_pool(device: torch.device) -> list:
    """The card's entry of ``_POOLS``, made at need: the pool of a graph of
    one small kernel, captured here and never replayed, which holds the
    pool (in the device's and the pinned host allocators) while each fit's
    graph comes and goes. The pool keeps graph memory, and no data."""
    if device not in _POOLS:
        anchor = torch.cuda.CUDAGraph()
        with torch.cuda.stream(_capture_stream(device)):
            anchor.capture_begin()
            try:
                torch.zeros((), device=device)
            finally:
                anchor.capture_end()
        _POOLS[device] = [anchor, False]
    return _POOLS[device]


class TrialGraph(FusedTrial):
    """``FusedTrial`` with its trial captured as one CUDA graph (see the
    module docstring) for the one-lane L-BFGS-B of one fit on the GPU. The
    objective's data are captured by address: a caller that changes them
    between restarts copies into the same tensors.

    The first ``start`` on CUDA tensors copies its inputs into static
    buffers, runs the trial once eagerly on the capture stream (the warm-up:
    cuSOLVER's and cuBLAS's handles and workspaces are made there), then
    captures it into the card's pool; the graph halves its own alpha after
    each trial. Every later ``start`` copies the iteration's point,
    direction, gradient, value and box into those buffers, and every
    ``step`` replays the graph and reads the packed tests once. On CPU
    tensors every trial runs eagerly. ``stats`` counts the warm-up
    (``eager``; every trial on the CPU), the capture and the replays; the
    pool's bytes are not measured."""

    def __init__(self, fun):
        super().__init__(fun)
        self.stats = GraphStats(pool_bytes=None, pool_peak_bytes=None)
        self._graph = None

    def start(self, x, direction, g, f, lower, upper, xtol) -> None:
        if not x.is_cuda:
            super().start(x, direction, g, f, lower, upper, xtol)
            return
        inputs = (x, direction, g, f, lower, upper)
        if self._graph is None:
            self._capture(inputs, xtol)
        elif xtol != self._xtol:
            raise ValueError(f"TrialGraph: captured with xtol={self._xtol}, "
                             f"started with xtol={xtol}")
        else:
            for dst, src in zip(self._inputs, inputs):
                dst.copy_(src)
        self._alpha.fill_(1.0)

    def step(self) -> list:
        if self._graph is None:
            self.stats.eager += 1
            return super().step()
        with torch.profiler.record_function(TRIAL_SPAN):
            self._graph.replay()
        self.stats.replays += 1
        add_counts(self.stats.kernel_replays, self._launches)
        return self._packed.tolist()

    def result(self):
        if self._graph is None:
            return super().result()
        # the next replay overwrites the graph's outputs
        return self._x_new.clone(), self._f_new.clone()

    def _trial(self):
        x, direction, g, f, lower, upper = self._inputs
        self._x_new, self._f_new, self._packed = fused_trial(
            self.fun, x, direction, self._alpha, g, f, lower, upper,
            self._xtol)
        self._alpha.mul_(0.5)

    def _capture(self, inputs, xtol) -> None:
        device = inputs[0].device
        self._inputs = tuple(torch.clone(t) for t in inputs)
        self._alpha = torch.ones((), dtype=inputs[0].dtype, device=device)
        self._xtol = xtol
        side = _capture_stream(device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side), \
                torch.profiler.record_function(WARMUP_SPAN):
            self._trial()
        self.stats.eager += 1
        counts = launch_counts()
        t0 = time.perf_counter()
        self._device, self._pool = device, _card_pool(device)
        held = torch.cuda.memory_reserved(device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            graph.capture_begin(pool=self._pool[0].pool())
            try:
                self._trial()
            finally:
                graph.capture_end()
        torch.cuda.current_stream().wait_stream(side)
        # what the capture reserved went to the pool
        self._let_go = (self._pool[1]
                        and torch.cuda.memory_reserved(device) > held)
        self._pool[1] = True
        self.stats.capture_s += time.perf_counter() - t0
        self.stats.captures += 1
        self._launches = launches_since(counts)
        add_counts(self.stats.kernel_captured, self._launches)
        self._graph = graph

    def close(self) -> None:
        """Free the graph and its buffers (the host has read the last
        replay, so nothing runs on them): their blocks are free in the
        card's pool for the next fit's capture, or the pool goes with them
        where this capture had to grow it."""
        if self._graph is None:
            return
        self._graph = self._inputs = self._alpha = None
        self._x_new = self._f_new = self._packed = None
        if self._let_go and _POOLS.get(self._device) is self._pool:
            del _POOLS[self._device]
        self._pool = None
