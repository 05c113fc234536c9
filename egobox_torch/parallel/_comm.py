"""The collectives of the distributed GP, on a mesh's process group.

Only ``all_reduce`` (SUM, MAX, MIN) and ``broadcast``: what NCCL, gloo on
CPU tensors and gloo on CUDA tensors all support. A row gather is an
``all_reduce`` SUM of a zero-filled buffer into which each rank writes its
own rows (x + 0 is x, NaN included, so only the owner's values land).
c10d collectives carry no autograd: every caller reduces values, never
differentiates through a collective.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def all_reduce(mesh, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """The reduction of ``t`` over the mesh's ranks, a new tensor, the same
    on every rank."""
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=_OPS[op], group=mesh.group)
    return out


def broadcast(mesh, t: torch.Tensor, src: int) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank, a new tensor. Every rank passes a
    tensor of the same shape and type; only ``src``'s values are read."""
    if mesh.rank == src:
        out = t.detach().clone(memory_format=torch.contiguous_format)
    else:
        out = torch.empty(t.shape, dtype=t.dtype, device=t.device)
    dist.broadcast(out, src=src, group=mesh.group)
    return out


def gather_rows(mesh, local: torch.Tensor, n: int,
                offset: int) -> torch.Tensor:
    """(n, ...) on every rank from each rank's rows ``local`` placed at
    ``offset``: an all_reduce SUM of a zero-filled buffer."""
    buf = torch.zeros((n,) + tuple(local.shape[1:]), dtype=local.dtype,
                      device=local.device)
    buf[offset:offset + local.shape[0]] = local
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    return buf
