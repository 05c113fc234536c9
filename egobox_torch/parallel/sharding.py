"""The mesh of the distributed GP, and the embarrassingly parallel fan-outs
over it (port of egobox_tpu/parallel/sharding.py).

egobox_tpu runs one controller over a ``jax.sharding.Mesh`` of devices;
the port is SPMD over processes: one rank per process, all running the
same program on a ``torch.distributed`` process group. A ``Mesh`` wraps
that group. A "sharded" value is the rank's own block of rows (a
contiguous block of the leading axis here; the block-cyclic feed layout of
``dist_chol``), a "replicated" value the same tensor on every rank. Every
reduction XLA inserts for a sharded operand is an explicit collective
(``_comm``).

- multistart theta optimization -> restarts sharded over the ranks
  (gp/src/algorithm.rs:928-945 rayon par_iter), the argmin the only
  collective;
- the Gram row blocks of a training set (``corr_cross_multichip``,
  ``reduced_likelihood_rowsharded``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import warnings
from typing import Optional

import torch
import torch.distributed as dist

from ..config import as_tensor, resolve_device
from . import _comm
from .launch import card_index


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: this process's rank in a process group of ``size``
    ranks, and the device it computes on. ``axis_names`` has one name, as
    egobox_tpu's meshes. ``close()`` destroys the group when ``make_mesh``
    created it."""

    group: object
    rank: int
    size: int
    axis_names: tuple
    device: torch.device
    owns_group: bool = False

    def close(self) -> None:
        if not self.owns_group:
            return
        if self.group is dist.group.WORLD:
            dist.destroy_process_group()
        else:
            dist.destroy_process_group(self.group)


def _card() -> int:
    """This rank's card: ``$LOCAL_RANK`` where a launcher set it and the
    process sees more than one card (checked against them,
    ``launch.card_index``), else the current device. ``run_ranks(
    backend="nccl")`` sets both to card r for rank r; a launcher that
    gives each process a card of its own (``CUDA_VISIBLE_DEVICES``)
    leaves that card visible alone, as the current device."""
    local = os.environ.get("LOCAL_RANK")
    n_cards = torch.cuda.device_count()
    if local is None or n_cards <= 1:
        return torch.cuda.current_device()
    local = int(local)
    return card_index(local, int(os.environ.get("LOCAL_WORLD_SIZE",
                                                local + 1)), n_cards)


def check_distinct_cards(mesh: Mesh, card: int, ident: str) -> None:
    """Raise ``ValueError`` naming the card when two ranks of ``mesh`` sit
    on one. ``card`` is the rank's card index, ``ident`` the card's UUID:
    the index alone cannot tell cards apart when a launcher makes each
    process see its own card as card 0. Each rank writes (index, a hash
    of the UUID) into its row of a (size, 2) table, and an all_reduce
    hands every rank the whole table."""
    table = torch.zeros((mesh.size, 2), dtype=torch.int64,
                        device=mesh.device)
    key = int.from_bytes(hashlib.blake2b(ident.encode(),
                                         digest_size=7).digest(), "big")
    table[mesh.rank] = torch.tensor([card, key], dtype=torch.int64)
    rows = [tuple(r) for r in _comm.all_reduce(mesh, table).tolist()]
    for index, key in rows:
        ranks = [r for r, row in enumerate(rows) if row[1] == key]
        if len(ranks) > 1:
            raise ValueError(
                f"make_mesh: ranks {ranks} of the mesh sit on one card, "
                f"card {index}: NCCL needs one card per rank (start the "
                "ranks with run_ranks(backend='nccl'), or set LOCAL_RANK)")


def _check_nccl_cards(mesh: Mesh) -> None:
    """``check_distinct_cards`` for a mesh of NCCL ranks, on a gloo group
    of the same ranks: NCCL itself fails, less plainly, when two ranks
    share a card. One host only: a group larger than the launcher's
    ``LOCAL_WORLD_SIZE`` raises."""
    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world > local:
        raise ValueError(f"make_mesh: the group's {world} ranks span more "
                         f"than one host ({local} on this one); a mesh "
                         "over several hosts is not supported")
    side = dist.new_group(list(range(mesh.size)), backend="gloo",
                          use_local_synchronization=True)
    try:
        check_distinct_cards(
            dataclasses.replace(mesh, group=side, device=torch.device("cpu")),
            mesh.device.index,
            str(torch.cuda.get_device_properties(mesh.device).uuid))
    finally:
        dist.destroy_process_group(side)


def make_mesh(n_devices: Optional[int] = None, axis: str = "starts", *,
              device=None, backend: Optional[str] = None) -> Mesh:
    """A mesh over the first ``n_devices`` ranks (default: all of them),
    the port's counterpart of egobox_tpu's "first n devices of the host".

    ``device`` defaults to the GPU (``config.resolve_device``: a host
    without one raises). Three rules place the ranks and find the group:

    - **Device choice.** With ``device`` a bare ``"cuda"`` (the default),
      each rank computes on the card its launcher chose: ``cuda:$LOCAL_RANK``
      where a launcher set ``LOCAL_RANK`` (torchrun does;
      ``launch.run_ranks(backend="nccl")`` sets it, and the current
      device, to card r for rank r), else the current device (a process
      that sees one card only takes that one, whatever ``LOCAL_RANK``).
    - **Distinct cards.** On an NCCL group of several ranks on one host
      the ranks check, over a gloo group of the same ranks, that no two
      resolved to the same card (told apart by UUID), and raise
      ``ValueError`` naming the card if they did.
    - **Joining a launched group.** With no process group initialized and
      ``WORLD_SIZE`` > 1 in the environment (torchrun's ``RANK``,
      ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), the rank joins
      that group (``init_method="env://"``; on the card it first makes
      its card current) with ``backend`` or the device's (NCCL for CUDA,
      gloo for the CPU), and ``close()`` ends it.

    With neither a group nor those variables the mesh is this process
    alone: ``make_mesh`` starts a one-rank group on a ``HashStore``;
    asked for more ranks then, it warns and degrades to one, as
    egobox_tpu degrades to the devices it has. In an initialized group of
    W ranks, more than W degrades to W with a warning; fewer (or another
    ``backend`` than the group's) makes a new group of ranks 0 .. n - 1,
    which only those ranks call. Several ranks on one GPU need
    ``backend="gloo"``. An init that fails raises."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", _card())
    default_backend = backend or ("nccl" if device.type == "cuda"
                                  else "gloo")
    owns = False
    if not dist.is_initialized():
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            n = n_devices or 1
            if n > 1:
                warnings.warn(
                    f"make_mesh: asked for {n} ranks, have 1 (no process "
                    "group is initialized) — degrading to a 1-rank mesh",
                    stacklevel=2,
                )
            dist.init_process_group(default_backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
            return Mesh(dist.group.WORLD, 0, 1, (axis,), device, True)
        if device.type == "cuda":
            # no device_id: NCCL comes up at the first collective, after
            # the distinct-card check below
            torch.cuda.set_device(device)
        dist.init_process_group(default_backend, init_method="env://")
        owns = True
    world, rank = dist.get_world_size(), dist.get_rank()
    n = n_devices or world
    if n > world:
        warnings.warn(
            f"make_mesh: asked for {n} ranks, the process group has "
            f"{world} — degrading to a {world}-rank mesh", stacklevel=2)
        n = world
    if n == world and backend in (None, dist.get_backend()):
        mesh = Mesh(dist.group.WORLD, rank, n, (axis,), device, owns)
    elif rank >= n:
        raise ValueError(f"make_mesh: rank {rank} is not among the first "
                         f"{n} ranks of the mesh")
    else:
        group = dist.new_group(list(range(n)), backend=backend,
                               use_local_synchronization=True)
        mesh = Mesh(group, rank, n, (axis,), device, True)
    if (mesh.size > 1 and device.type == "cuda"
            and dist.get_backend(mesh.group) == "nccl"):
        _check_nccl_cards(mesh)
    return mesh


def _block(mesh: Mesh, n: int, what: str) -> slice:
    if n % mesh.size != 0:
        raise ValueError(f"{what}: {n} rows must be divisible by the "
                         f"{mesh.size}-rank mesh")
    n_loc = n // mesh.size
    return slice(mesh.rank * n_loc, (mesh.rank + 1) * n_loc)


def shard_starts(mesh: Mesh, arr) -> torch.Tensor:
    """This rank's contiguous block of the leading axis of ``arr`` (the
    whole (k, ...) batch, the same on every rank), on the mesh's device."""
    arr = replicated(mesh, arr)
    return arr[_block(mesh, arr.shape[0], "shard_starts")]


def replicated(mesh: Mesh, arr) -> torch.Tensor:
    """``arr`` on the mesh's device (a tensor keeps its type)."""
    return as_tensor(arr, device=mesh.device).to(mesh.device)


def shard_rows(mesh: Mesh, arr) -> torch.Tensor:
    """Alias of shard_starts for the data axis (row blocks of a training
    set / Gram matrix)."""
    return shard_starts(mesh, arr)


def corr_cross_multichip(mesh: Mesh, name: str, x1, x2, theta,
                         weights=None) -> torch.Tensor:
    """This rank's row block of the cross-correlation Gram r(x1, x2): x1
    (n1, nx) replicated, split in contiguous blocks over the ranks, each
    against the whole x2 (the n^2 d work of the reference's rayon
    pdist/cdist, doe/src/utils.rs, spread over ranks)."""
    from ..gp.kernels import corr_cross

    x1 = shard_rows(mesh, x1)
    x2 = replicated(mesh, x2).to(x1.dtype)
    theta = replicated(mesh, theta).to(x1.dtype)
    return corr_cross(name, x1, x2, theta, weights)


def reduced_likelihood_rowsharded(
    mesh: Mesh,
    x,  # (n, nx)
    y,  # (n,) or (n, 1)
    theta,
    *,
    corr: str = "squared_exponential",
    trend: str = "constant",
    nugget: Optional[float] = None,
) -> torch.Tensor:
    """Exact reduced likelihood with the Gram built in row blocks over the
    ranks (the O(n^2 d) assembly distributed), then gathered: where XLA
    gathers egobox_tpu's factorization onto one device, every rank here
    gathers the row blocks and factors the whole R (n^3/3 per rank).
    n is padded up to a multiple of the mesh size with masked rows: the
    masked likelihood is exact (gp/likelihood.py), so padding does not
    change the value."""
    from ..gp.fit import _masked_norm
    from ..gp.kernels import corr_cross
    from ..gp.likelihood import likelihood_from_r

    x = torch.atleast_2d(replicated(mesh, x))
    dtype = x.dtype
    y = replicated(mesh, y).to(dtype)
    if y.ndim == 1:
        y = y[:, None]
    n = x.shape[0]
    n_pad = -(-n // mesh.size) * mesh.size
    mask = torch.arange(n_pad, device=x.device) < n
    if n_pad != n:
        x = torch.nn.functional.pad(x, (0, 0, 0, n_pad - n))
        y = torch.nn.functional.pad(y, (0, 0, 0, n_pad - n))
    if nugget is None:
        nugget = 100.0 * torch.finfo(dtype).eps

    m = mask.to(dtype)
    n_obs = torch.sum(m)
    x_mean, x_std = _masked_norm(x, m, n_obs)
    y_mean, y_std = _masked_norm(y, m, n_obs)
    x_norm = (x - x_mean) / x_std * m[:, None]
    y_norm = (y - y_mean) / y_std * m[:, None]

    rows = _block(mesh, n_pad, "reduced_likelihood_rowsharded")
    theta = replicated(mesh, theta).to(dtype)
    r_loc = corr_cross(corr, x_norm[rows], x_norm, theta)
    r_loc.mul_(m[rows, None] * m[None, :])
    r_loc[torch.arange(r_loc.shape[0], device=x.device), torch.arange(
        rows.start, rows.stop, device=x.device)] = 1.0  # exact unit diagonal
    r = _comm.gather_rows(mesh, r_loc, n_pad, rows.start)
    del r_loc
    row_max = torch.amax(torch.sum(torch.abs(r), dim=1))
    r.diagonal().add_(nugget * torch.clamp(row_max, min=1.0))
    rlf, _ = likelihood_from_r(r, trend, x_norm, y_norm, y_std, mask)
    return rlf


def multistart_neg_rlf_minimize(
    x_norm, y_norm, y_std, inits, lo, up, mask,
    *, corr: str, trend: str, max_iters: int = 50, nugget: float = 1e-10,
    mesh: Optional[Mesh] = None,
):
    """Minimize the negative reduced likelihood from ``inits`` (k, dim) in
    log10-theta space, every start one lane of a lockstep L-BFGS. With a
    ``mesh``, ``inits`` is this rank's block of the starts
    (``shard_starts``); the global argmin (ties to the first start, as
    ``jnp.argmin``) is the only collective. Returns (x, fun) of the best
    start, the same on every rank."""
    from ..gp.likelihood import make_neg_reduced_likelihood
    from ..optim.lbfgsb import minimize_lbfgsb

    neg_rlf = make_neg_reduced_likelihood(
        corr, trend, x_norm, y_norm, y_std, None, nugget, mask)
    res = minimize_lbfgsb(lambda t: neg_rlf(10.0**t), inits, lo, up,
                          max_iters=max_iters)
    fun = torch.where(torch.isfinite(res.fun), res.fun,
                      torch.full_like(res.fun, float("inf")))
    best = int(torch.argmin(fun))
    x_best, f_best = res.x[best], fun[best]
    if mesh is None or mesh.size == 1:
        return x_best, f_best
    f_min = _comm.all_reduce(mesh, f_best, "min")
    mine = torch.where(f_best == f_min, mesh.rank, mesh.size)
    owner = int(_comm.all_reduce(mesh, mine.to(torch.int64), "min"))
    return _comm.broadcast(mesh, x_best, owner), f_min


def fit_gp_multichip(
    mesh: Mesh,
    x,
    y,
    inits,  # (k, dim) log10-theta starts, k % mesh.size == 0
    theta_bounds=(1e-2, 1e1),
    *,
    corr: str = "squared_exponential",
    trend: str = "constant",
    max_iters: int = 30,
    mask=None,
    nugget: Optional[float] = None,
):
    """GP MLE with the multistart axis sharded over the ranks; returns the
    fitted GpModel (replicated). ``inits`` is the whole set of starts, the
    same on every rank."""
    from ..gp.fit import _fit_draws, _masked_norm, fit_gp_core

    x = replicated(mesh, x)
    dtype = x.dtype
    y = replicated(mesh, y).to(dtype)
    if y.ndim == 1:
        y = y[:, None]
    n = x.shape[0]
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=x.device)
    mask = replicated(mesh, mask).to(torch.bool)
    m = mask.to(dtype)
    n_obs = torch.sum(m)
    x_mean, x_std = _masked_norm(x, m, n_obs)
    y_mean, y_std = _masked_norm(y, m, n_obs)
    x_norm = (x - x_mean) / x_std * m[:, None]
    y_norm = (y - y_mean) / y_std * m[:, None]

    inits = replicated(mesh, inits).to(dtype)
    dim = inits.shape[1]
    lo = torch.full((dim,), float(theta_bounds[0]), dtype=dtype,
                    device=x.device).log10()
    up = torch.full((dim,), float(theta_bounds[1]), dtype=dtype,
                    device=x.device).log10()
    if nugget is None:
        nugget = 100.0 * torch.finfo(dtype).eps
    t_best, _ = multistart_neg_rlf_minimize(
        x_norm, y_norm, y_std, shard_starts(mesh, inits), lo, up, mask,
        corr=corr, trend=trend, max_iters=max_iters, nugget=nugget,
        mesh=mesh,
    )
    theta = 10.0**t_best
    # the final fixed-theta fit assembles the model
    return fit_gp_core(
        x, y, mask, theta, 10.0**lo, 10.0**up,
        torch.ones_like(theta, dtype=torch.bool), _fit_draws(0),
        corr=corr, trend=trend, fixed=True, nugget=nugget,
    )
