"""Run a function on the ranks of a process group on this host.

``run_ranks(fn, world_size, args)`` spawns ``world_size`` processes (the
``spawn`` start method: a parent with threads, or with CUDA initialized,
cannot fork safely), each joining one ``torch.distributed`` group through
a ``FileStore`` in a temporary directory (no port to collide with another
group), calls ``fn(rank, world_size, *args)`` in each and returns what
each returned, in rank order. ``fn`` must be importable by name (a
module-level function) and return something picklable (numpy, not
tensors).

Two backends. ``"gloo"`` (the default) for CPU tensors, or for CUDA
tensors of several ranks sharing one card. ``"nccl"`` puts rank r on card
r (``card_index``): the rank makes that card its current device, and
sets ``LOCAL_RANK`` to it, before it joins the group, so ``make_mesh``
and every ``"cuda"`` tensor of the rank land there. NCCL refuses two
ranks on one card, so the launcher refuses a host without CUDA, or with
fewer cards than ranks, before it spawns anything; it never falls back
to gloo or to a shared card.

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
from typing import Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def card_index(rank: int, n_ranks: int, n_cards: int) -> int:
    """The card of ``rank`` (an index among this host's ranks: the rank
    itself for ``run_ranks``, torchrun's ``LOCAL_RANK``) among ``n_ranks``
    ranks of a host with ``n_cards`` cards, one rank per card. Raises
    ``ValueError`` when the host has more ranks than cards, or the index
    lies beyond its cards."""
    if n_ranks > n_cards:
        raise ValueError(f"{n_ranks} ranks on a host with {n_cards} CUDA "
                         "card(s): NCCL needs one card per rank")
    if not 0 <= rank < n_cards:
        raise ValueError(f"rank {rank} maps to card {rank}, which this host "
                         f"with {n_cards} card(s) does not have")
    return rank


def _place(backend: str, rank: int, world_size: int):
    """Put this rank on its card before it joins the group: with
    ``"nccl"`` card ``card_index(rank)`` becomes the current device and
    ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` name it, so that ``make_mesh``
    reads the same card (a value inherited from the parent's launcher
    is overwritten); with ``"gloo"`` both variables are dropped and the
    ranks share the current device. Returns the card, or None."""
    for k in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        os.environ.pop(k, None)
    if backend != "nccl":
        return None
    card = card_index(rank, world_size, torch.cuda.device_count())
    os.environ.update(LOCAL_RANK=str(card), LOCAL_WORLD_SIZE=str(world_size))
    torch.cuda.set_device(card)
    return card


def _join(backend, store, rank, world_size, timeout):
    card = _place(backend, rank, world_size)
    # with device_id NCCL comes up inside init_process_group: a fault
    # shows at the start, not in the first collective
    kw = {} if card is None else {"device_id": torch.device("cuda", card)}
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout),
                            **kw)


def _rank_main(fn, rank, world_size, store_path, timeout, backend, args,
               results):
    try:
        _join(backend, dist.FileStore(store_path, world_size), rank,
              world_size, timeout)
        results.put((rank, True, fn(rank, world_size, *args)))
    except Exception:  # the rank's boundary: report to the parent
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _check_nccl(world_size: int) -> None:
    """Refuse, before anything is spawned, a host where ``world_size``
    NCCL ranks cannot each have a card; then build the kernel library
    once, so that the ranks load it instead of compiling it side by
    side."""
    if not torch.cuda.is_available():
        raise RuntimeError("run_ranks(backend='nccl') needs CUDA: "
                           "torch.cuda.is_available() is false")
    if not dist.is_nccl_available():
        raise RuntimeError("run_ranks(backend='nccl'): this PyTorch has "
                           "no NCCL")
    card_index(world_size - 1, world_size, torch.cuda.device_count())
    from ..ops import build

    build.build()


def run_ranks(fn, world_size: int, args: tuple = (), *,
              timeout: float = 120.0, backend: str = "gloo") -> list:
    """``[fn(r, world_size, *args) for r in ranks]``, one process per rank
    on a ``backend`` group: ``"gloo"`` (CPU tensors, or CUDA tensors of
    several ranks sharing one card) or ``"nccl"`` (rank r on card r; a
    host without CUDA or with fewer cards than ranks raises before any
    process starts). Raises ``RuntimeError`` with the first failing
    rank's traceback, or when a rank dies without a result, and
    ``TimeoutError`` after ``timeout`` seconds; every rank is stopped
    before it returns."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"run_ranks: backend {backend!r} is not 'gloo' "
                         "or 'nccl'")
    if backend == "nccl":
        _check_nccl(world_size)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(
            target=_rank_main,
            args=(fn, r, world_size, store, timeout, backend, args, results),
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
