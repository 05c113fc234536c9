"""CUDA graphs of the fused EGO programs: capture once per signature,
replay after.

egobox_tpu compiles each fused program once per signature (shape bucket,
output count, the statics of the fused program) and caches it;
one iteration is then one dispatch and one host fetch. On the GPU the
counterpart is a captured ``torch.cuda.CUDAGraph``: the iteration's
thousands of small launches become one replay, and the host does no work
per kernel.

``GraphCache.run(key, fn, inputs, size)`` runs ``fn(graph_safe, **inputs)``.
Every tensor of ``inputs`` is an input of the graph, also inside nests of
tuples and dataclasses (the clustered iteration's mixtures): a replay
copies them all into the captured buffers, so that no value of a call is
baked into a graph. What the key does not hold must be such a tensor.
With ``graph_safe=True`` the function reads nothing on the host (its loops
run fixed trip counts, optim/lbfgsb.py); with ``graph_safe=False`` the same
operations stop early where the trip counts let them, with equal results.

- On CPU tensors the call runs eagerly in the early-exit form (the caller
  asked for the CPU).
- On CUDA tensors the cache's first call runs eagerly in the early-exit
  form, on a side stream: it is the warm-up a capture needs (autograd, the
  cuBLAS and cuSOLVER workspaces, the nvcc build of the kernels happen
  there) and its result is the call's result. Every later call of a new
  signature captures ``fn`` in the fixed-trip form on copies of its inputs
  and replays the graph; a call of a known signature copies its inputs
  into those buffers and replays.

Designs of more than ``GRAPH_MAX_ROWS`` rows are not captured: every call
runs eagerly in the early-exit form.

``size`` is the padded design's shape. The design of a run only grows, so
a call of another size drops every graph of the old one: their memory goes
back to the device. The graphs of one size share one memory pool (at most
one of them runs at a time, and each keeps its outputs).

A capture that fails raises: nothing catches it and runs the call eagerly
instead. The outputs handed back are copies, so that the next replay does
not overwrite them.

The cache counts what the graphs cost (captures, capture seconds, the
bytes their pool holds, replays, evictions) and, for the kernels of
``ops``, the launches a capture recorded and the launches replays made
(ops/graph_stats.py).
"""

from __future__ import annotations

import dataclasses
import time

import torch

from ..ops.graph_stats import (GraphStats, add_counts, launch_counts,
                               launches_since)

#: designs padded to more rows than this run eagerly, in the early-exit
#: form, at every call: there the device time of the fixed trip counts
#: outweighs the host dispatch a graph saves. On an H100 (d=10, float64) a
#: replay took 0.48x an unfused iteration at 128 rows, 0.86x at 256 (where
#: a bucket of 32 iterations just pays its capture back) and 1.16x at 512
#: (PERF.md, PR 5)
GRAPH_MAX_ROWS = 256


def _tree_map(fn, obj):
    """``fn`` on every tensor of a nest of tuples, lists, dicts and
    dataclasses (the GpModel container); anything else as it is."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, (tuple, list)):
        out = [_tree_map(fn, v) for v in obj]
        return type(obj)(*out) if hasattr(obj, "_fields") else type(obj)(out)
    if isinstance(obj, dict):
        return {k: _tree_map(fn, v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _tree_map(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    return obj


def _tensors(obj):
    out = []
    _tree_map(out.append, obj)
    return out


def _pool_bytes(pool):
    """The device memory a graph memory pool holds: the segments the
    allocator's snapshot files under the pool's id (None where the snapshot
    does not name the pool of its segments)."""
    segs = torch.cuda.memory_snapshot()
    if segs and "segment_pool_id" not in segs[0]:
        return None
    return sum(s["total_size"] for s in segs
               if tuple(s["segment_pool_id"]) == tuple(pool))


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    inputs: dict
    outputs: object
    launches: dict  # kernel name -> launches held by the graph


class GraphCache:
    """Captured graphs by signature (see the module docstring). One cache
    belongs to one solver; it holds the graphs of one design size."""

    def __init__(self):
        self._graphs: dict = {}
        self._size = None
        self._pool = None
        self._warm = False
        self._side = None
        self.stats = GraphStats()

    @property
    def live(self) -> int:
        """The number of graphs held."""
        return len(self._graphs)

    def run(self, key, fn, inputs: dict, size):
        dev = next(v.device for v in inputs.values()
                   if isinstance(v, torch.Tensor))
        if dev.type != "cuda":
            self.stats.last = "eager"
            return fn(graph_safe=False, **inputs)
        if size != self._size:
            self._evict()
            self._size = size
        if not self._warm or size[-2] > GRAPH_MAX_ROWS:
            self._warm = True
            self.stats.eager += 1
            self.stats.last = "eager"
            return self._eager(fn, inputs)
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._capture(key, fn, inputs)
            self.stats.last = "capture"
        else:
            for name, v in inputs.items():
                for dst, src in zip(_tensors(entry.inputs[name]),
                                    _tensors(v)):
                    dst.copy_(src)
            self.stats.last = "replay"
        entry.graph.replay()
        self.stats.replays += 1
        add_counts(self.stats.kernel_replays, entry.launches)
        return _tree_map(torch.clone, entry.outputs)

    def _evict(self):
        """Drop every graph and its pool (their size is not the design's
        any more); the memory goes back to the device."""
        if not self._graphs:
            return
        torch.cuda.synchronize()
        self.stats.evicted += len(self._graphs)
        self._graphs.clear()
        self._pool = None
        torch.cuda.empty_cache()

    def _side_stream(self):
        if self._side is None:
            self._side = torch.cuda.Stream()
        return self._side

    def _eager(self, fn, inputs):
        side = self._side_stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            out = fn(graph_safe=False, **inputs)
        torch.cuda.current_stream().wait_stream(side)
        for t in _tensors(out):
            t.record_stream(torch.cuda.current_stream())
        return out

    def _capture(self, key, fn, inputs) -> _Graph:
        static = {k: _tree_map(torch.clone, v) for k, v in inputs.items()}
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        counts = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            outputs = fn(graph_safe=True, **static)
        torch.cuda.synchronize()
        self.stats.capture_s += time.perf_counter() - t0
        self.stats.captures += 1
        held = _pool_bytes(self._pool)
        self.stats.pool_bytes = held
        self.stats.pool_peak_bytes = (
            None if held is None or self.stats.pool_peak_bytes is None
            else max(self.stats.pool_peak_bytes, held))
        launches = launches_since(counts)
        add_counts(self.stats.kernel_captured, launches)
        entry = _Graph(graph, static, outputs, launches)
        self._graphs[key] = entry
        return entry
