"""Run a function on the ranks of a process group on this host.

``run_ranks(fn, world_size, args)`` spawns ``world_size`` processes (the
``spawn`` start method: a parent with threads, or with CUDA initialized,
cannot fork safely), each joining one ``torch.distributed`` group through
a ``FileStore`` in a temporary directory (no port to collide with another
group), calls ``fn(rank, world_size, *args)`` in each and returns what
each returned, in rank order. ``fn`` must be importable by name (a
module-level function) and return something picklable (numpy, not
tensors).

A rank that raises reports its traceback and leaves the group; the others
may then wait in a collective, so the parent stops every rank and raises
with that traceback as soon as it arrives, and stops them all after
``timeout`` seconds. A failure surfaces; nothing is retried.
"""

from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback

import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(fn, rank, world_size, store_path, timeout, args, results):
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world_size),
            rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout))
        results.put((rank, True, fn(rank, world_size, *args)))
    except Exception:  # the rank's boundary: report to the parent
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world_size: int, args: tuple = (), *,
              timeout: float = 120.0) -> list:
    """``[fn(r, world_size, *args) for r in ranks]``, one process per rank
    on a gloo group (CPU tensors, or CUDA tensors of several ranks sharing
    one GPU: NCCL refuses those). Raises ``RuntimeError`` with the first
    failing rank's traceback, or when a rank dies without a result, and
    ``TimeoutError`` after ``timeout`` seconds; every rank is stopped
    before it returns."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(
            target=_rank_main,
            args=(fn, r, world_size, store, timeout, args, results),
            daemon=True) for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(out) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    missing = sorted(set(range(world_size)) - set(out))
                    raise TimeoutError(f"run_ranks: ranks {missing} gave no "
                                       f"result within {timeout} s")
                try:
                    rank, ok, payload = results.get(timeout=min(1.0, left))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode not in (None, 0)]
                    if not dead:
                        continue
                    try:  # a message may still be in the pipe
                        rank, ok, payload = results.get(timeout=2.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"run_ranks: rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} and no result"
                        ) from None
                if not ok:
                    raise RuntimeError(f"run_ranks: rank {rank} failed:\n"
                                       f"{payload}")
                out[rank] = payload
        finally:
            for p in procs:
                p.join(timeout=10 if len(out) == world_size else 0)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [out[r] for r in range(world_size)]
