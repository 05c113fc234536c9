"""Carry weights and state over from a model fitted or a run started
elsewhere: the port's ``GpModel`` (one model, or the surrogate container
with a leading output axis) from the arrays of e.g. an egobox_tpu
``GpModel`` converted field by field with ``np.asarray``, an ``SgpModel``
from those of egobox_tpu's sparse GP, a ``GaussianMixture`` and a
``GpMixture`` (dense or sparse experts) from those of egobox_tpu's,
``EgorState`` from the hot-start checkpoint payload (clusterings
included), and a ``DistGpModel`` from the gathered arrays of
egobox_tpu's, each rank keeping its rows."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import default_dtype, resolve_device
from .ego.state import EgorState
from .gp.gp import GpModel
from .gp.sgp import SgpModel
from .moe.gaussian_mixture import GaussianMixture
from .moe.moe import GpMixture
from .types import Recombination

_STATIC = ("corr", "trend", "method")


def _tensors_from_numpy(cls, fields: dict, device, dtype, where: str):
    """Every array field of the dataclass ``cls`` from ``fields`` (numpy
    arrays; ``w_star`` may be None or ``np.asarray(None)``): floating
    fields on ``device`` in ``dtype``, ``mask`` boolean."""
    device = resolve_device(device)
    dtype = dtype or default_dtype(device)
    names = [f.name for f in dataclasses.fields(cls)
             if f.name not in _STATIC]
    missing = [k for k in names if k not in fields]
    if missing:
        raise ValueError(f"{where}: missing fields {missing}")
    out = {}
    for k in names:
        v = fields[k]
        if v is None or (isinstance(v, np.ndarray) and v.dtype == object
                         and v.shape == () and v.item() is None):
            if k != "w_star":
                raise ValueError(f"{where}: {k} is None")
            out[k] = None
            continue
        t_dtype = torch.bool if k == "mask" else dtype
        out[k] = torch.from_numpy(np.array(v)).to(device=device,
                                                  dtype=t_dtype)
    return out


def gp_model_from_numpy(fields: dict, corr: str, trend: str, device=None,
                        dtype=None) -> GpModel:
    """``fields`` maps every array field of ``GpModel`` to a numpy array
    (``w_star`` may be None, or ``np.asarray(None)``). Floating fields go to
    ``device`` (default: the GPU; ``"cpu"`` to serve on the CPU) in
    ``dtype`` (default: the device's default type); ``mask`` stays
    boolean."""
    return GpModel(**_tensors_from_numpy(GpModel, fields, device, dtype,
                                         "gp_model_from_numpy"),
                   corr=corr, trend=trend)


def sgp_model_from_numpy(fields: dict, corr: str, method: str, device=None,
                         dtype=None) -> SgpModel:
    """``SgpModel`` from the arrays of every field of egobox_tpu's
    (``theta``, ``sigma2``, ``noise``, ``w_star`` (None allowed), ``z``,
    ``w_vec``, ``w_inv``, ``likelihood``), its kernel and its method
    ("FITC" or "VFE"), on ``device`` (default: the GPU) in ``dtype``
    (default: float64, the type the sparse GP computes in)."""
    return SgpModel(**_tensors_from_numpy(SgpModel, fields, device,
                                          dtype or torch.float64,
                                          "sgp_model_from_numpy"),
                    corr=corr, method=method)


def gp_surrogates_from_numpy(fields: dict, corr: str, trend: str,
                             device=None, dtype=None) -> GpModel:
    """The surrogate container of the EGO loop (``ego.surrogates``: one
    ``GpModel`` whose tensors carry a leading axis over the 1 + n_cstr
    outputs) from the arrays of egobox_tpu's batched ``GpModel``, which has
    the same layout. ``fields`` and the other arguments are those of
    ``gp_model_from_numpy``."""
    models = gp_model_from_numpy(fields, corr, trend, device, dtype)
    if models.x_norm.ndim != 3:
        raise ValueError(
            "gp_surrogates_from_numpy: expected fields with a leading "
            f"output axis, x_norm has shape {tuple(models.x_norm.shape)}"
        )
    m = models.x_norm.shape[0]
    for f in dataclasses.fields(GpModel):
        v = getattr(models, f.name)
        if isinstance(v, torch.Tensor) and v.shape[0] != m:
            raise ValueError(
                f"gp_surrogates_from_numpy: {f.name} has leading axis "
                f"{v.shape[0]}, expected {m}"
            )
    return models


def gmx_from_numpy(fields: dict, device=None, dtype=None) -> GaussianMixture:
    """``GaussianMixture`` from the arrays of every field of egobox_tpu's
    (``weights``, ``means``, ``covariances``, ``precisions_chol``,
    ``heaviside_factor``), on ``device`` (default: the GPU) in ``dtype``
    (default: the device's type)."""
    device = resolve_device(device)
    dtype = dtype or default_dtype(device)
    names = [f.name for f in dataclasses.fields(GaussianMixture)]
    missing = [k for k in names if k not in fields]
    if missing:
        raise ValueError(f"gmx_from_numpy: missing fields {missing}")
    return GaussianMixture(**{
        k: torch.from_numpy(np.array(fields[k], dtype=float)).to(
            device=device, dtype=dtype) for k in names})


def gp_mixture_from_numpy(experts: list, gmx_fields: dict,
                          recombination=Recombination.SMOOTH, device=None,
                          dtype=None) -> GpMixture:
    """``GpMixture`` built from the arrays of egobox_tpu's mixture:
    ``experts`` is one triple per expert, (fields, corr, trend) for a dense
    one as ``gp_model_from_numpy`` takes them, (fields, corr, method) for
    a sparse one (its fields hold ``w_vec``) as ``sgp_model_from_numpy``
    takes them; ``gmx_fields`` the
    mixture's arrays (``gmx_from_numpy``). A mixture with a sparse expert
    is float64 unless ``dtype`` says otherwise."""
    if dtype is None and any("w_vec" in f for f, _, _ in experts):
        dtype = torch.float64
    return GpMixture(
        [(sgp_model_from_numpy if "w_vec" in f else gp_model_from_numpy)(
            f, corr, kind, device, dtype) for f, corr, kind in experts],
        gmx_from_numpy(gmx_fields, device, dtype),
        Recombination(recombination))


def egor_state_from_dict(payload: dict) -> EgorState:
    """``EgorState`` from the payload of ``EgorState.to_dict()``, the
    hot-start checkpoint ``egor_checkpoint.json``; egobox_tpu writes the
    same payload, so its checkpoints resume in the port, their clusterings
    (host float64 tensors, moved to the solver's device when used) and
    per-expert parameters included."""
    return EgorState.from_dict(payload)


def dist_gp_model_from_numpy(fields: dict, mesh, corr: str, trend: str,
                             bp: int, dtype=None):
    """``DistGpModel`` on ``mesh`` from the gathered arrays of egobox_tpu's
    (``np.asarray`` of each field: ``x_norm_feed``, ``l_feed``,
    ``gamma_feed``, ``ft_feed`` in feed order, (n, ...); ``gram_chol``,
    ``beta``, the normalization, ``theta``, ``w_star`` (None allowed),
    ``sigma2``, ``likelihood``), realized on a mesh of the same size with
    panel size ``bp``. Every rank calls it with the same arrays and keeps
    its own feed rows, on the mesh's device in ``dtype`` (default: the
    device's type). Raises ``ValueError`` when ``l_feed`` is not in the
    block-cyclic feed layout of this mesh size and ``bp``."""
    from .parallel import _comm
    from .parallel.dist_chol import _check_shard, _local_indices
    from .parallel.dist_model import DistGpModel

    arrays = [f.name for f in dataclasses.fields(DistGpModel)
              if f.name not in ("mesh", "bp", "corr", "trend")]
    t = _tensors_from_numpy(
        dataclasses.make_dataclass("DistFields", arrays), fields,
        mesh.device, dtype, "dist_gp_model_from_numpy")
    n = t["l_feed"].shape[0]
    _check_shard(n, mesh.size, bp)
    n_loc = n // mesh.size
    rows = slice(mesh.rank * n_loc, (mesh.rank + 1) * n_loc)
    for k in ("x_norm_feed", "gamma_feed", "l_feed", "ft_feed"):
        t[k] = t[k][rows].contiguous()
    # in the feed layout of (mesh.size, bp), row i of the block has no
    # entry right of its global row gidx[i]; every rank raises if one sees
    # a violation
    _, gidx = _local_indices(n, mesh.size, bp, mesh.rank)
    upper = (torch.arange(n, device=mesh.device)[None, :]
             > torch.as_tensor(gidx, device=mesh.device)[:, None])
    bad = torch.any(upper & (t["l_feed"] != 0)).to(t["l_feed"].dtype)
    if bool(_comm.all_reduce(mesh, bad, "max")):
        raise ValueError(
            "dist_gp_model_from_numpy: l_feed is not in the block-cyclic "
            f"feed layout of a {mesh.size}-rank mesh with bp={bp}")
    return DistGpModel(**t, mesh=mesh, bp=bp, corr=corr, trend=trend)
