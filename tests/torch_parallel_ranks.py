"""The rank side of tests/test_torch_parallel*.py: what each gloo rank of a
4-rank CPU group computes with egobox_torch.parallel from numpy inputs,
returned as numpy (rank-local blocks; the tests concatenate them in rank
order, which is the feed order). Rank 0 then runs the same cases on its
own ``make_mesh(1)``. This module imports neither jax nor egobox_tpu: the
ranks are spawned processes that import it by name. egobox_tpu's draws
(warm-start LHS seeds, Hutchinson probes, sample normals) come in the
inputs and are put in place here, in the rank.
"""

from __future__ import annotations

import contextlib
import warnings

import numpy as np
import torch

NUGGET = 1e-6
N, NX = 32, 3
#: the panel size by mesh size: 8 panels, 2 per rank, on 4 ranks
BP = {4: 4, 1: 8}


def data() -> dict:
    """The design, an SPD matrix and right-hand sides, theta (numpy)."""
    rng = np.random.default_rng(3)
    x = rng.uniform(size=(N, NX))
    y = (np.sin(3.0 * x[:, 0]) + x[:, 1] ** 2 + 0.1 * x[:, 2])[:, None]
    a = rng.standard_normal((N, N))
    return dict(x=x, y=y, spd=a @ a.T + N * np.eye(N),
                rhs=rng.standard_normal((N, 2)),
                theta=np.array([0.5, 0.8, 1.2]), bp=BP)


class _Draws:
    """Replays egobox_tpu's warm-start LHS seeds (gp/fit.py FitDraws)."""

    def __init__(self, lhs):
        self.lhs = list(lhs)

    def permutation(self, n, device):
        raise AssertionError("the distributed warm start draws no "
                             "permutation from FitDraws")

    def lhs_seeds(self, n_start, dim, dtype, device):
        return torch.from_numpy(np.array(self.lhs.pop(0))).to(dtype=dtype,
                                                            device=device)


def _np(t):
    return t.detach().cpu().numpy()


@contextlib.contextmanager
def _injected(inp):
    """egobox_tpu's draws in this process while the parity cases run (the
    EgorBatch runs keep the port's own)."""
    from egobox_torch.gp import fit as tfit
    from egobox_torch.gp import likelihood as tlik

    probes = inp["probes"]

    def rademacher(n, p, dtype, device):
        assert (n, p) == probes.shape
        return torch.from_numpy(probes).to(dtype=dtype, device=device)

    saved = tfit._fit_draws, tlik._rademacher_probes
    tfit._fit_draws = lambda seed: _Draws([inp["warm_lhs"]])
    tlik._rademacher_probes = rademacher
    try:
        yield
    finally:
        tfit._fit_draws, tlik._rademacher_probes = saved


def _linalg_cases(mesh, inp):
    """The factorization, the solves, L^-1 and R^-1, the likelihood and
    its gradient on ``mesh`` (D = mesh.size)."""
    from egobox_torch import parallel as P
    from egobox_torch.parallel.dist_chol import (rinv_rows_feed,
                                                  tri_inverse_feed)
    from egobox_torch.parallel.dist_fit import _normalize

    D = mesh.size
    bp = inp["bp"][D]
    out = {}
    t = torch.from_numpy
    x, y, theta = t(inp["x"]), t(inp["y"]), t(inp["theta"])
    n = x.shape[0]
    perm = P.block_cyclic_perm(n, D, bp)
    n_loc = n // D
    mine = perm[mesh.rank * n_loc:(mesh.rank + 1) * n_loc]

    r, rhs = t(inp["spd"]), t(inp["rhs"])
    l_feed = P.cholesky_blockcyclic(mesh, r[mine], bp)
    linv = tri_inverse_feed(mesh, l_feed, bp)
    out["chol"] = _np(l_feed)
    out["solve_lower"] = _np(P.solve_lower_blockcyclic(mesh, l_feed,
                                                       rhs[mine], bp))
    out["solve_upperT"] = _np(P.solve_upperT_blockcyclic(mesh, l_feed,
                                                         rhs[mine], bp))
    out["linv"] = _np(linv)
    out["rinv"] = _np(rinv_rows_feed(mesh, linv, bp))
    blk = slice(mesh.rank * n_loc, (mesh.rank + 1) * n_loc)
    l_rows = P.cholesky_rowsharded(mesh, r[blk])
    out["chol_rows"] = _np(l_rows)
    out["solve_rows"] = _np(P.solve_lower_rowsharded(mesh, l_rows,
                                                     rhs[blk]))

    # value and adjoint at one theta
    t10 = torch.log10(theta)
    for name, corr, probes, kpls in inp["grad_cases"]:
        f, g = P.make_neg_rlf_distributed(
            mesh, x, y, corr=corr, nugget=NUGGET, bp=bp, kpls_dim=kpls,
            grad_probes=probes)
        tt = t10[:kpls] if kpls else t10
        v, res = f(tt)
        out[f"lik_{name}"] = float(-v)
        out[f"grad_{name}"] = _np(g(tt, res))
    out["lik_dist"] = float(P.reduced_likelihood_distributed(
        mesh, x, y, theta, corr="matern52", nugget=NUGGET))
    out["lik_rows"] = float(P.reduced_likelihood_rowsharded(
        mesh, x[:-2], y[:-2], theta, corr="matern52", nugget=NUGGET))
    # a non-PD Gram (a negative nugget) is -inf on every rank
    xn, yn, _ = _normalize(x, y)
    out["lik_nonpd"] = float(P.dist_likelihood_parts(
        mesh, xn, yn, theta, corr="squared_exponential", nugget=-1.0,
        bp=bp)[0])
    out["cross_rows"] = _np(P.corr_cross_multichip(mesh, "matern52", x,
                                                   x[:5], theta))
    if D > 1:
        out["undivided"] = []
        for bad in (lambda: P.make_neg_rlf_distributed(mesh, x[:-1],
                                                       y[:-1]),
                    lambda: P.realize_dist_model(mesh, x[:-1], y[:-1],
                                                 theta)):
            try:
                bad()
                out["undivided"].append("no error")
            except ValueError as e:
                out["undivided"].append(str(e))
    return out


def _model_cases(mesh, inp):
    """The fit, the realized model and its serving path, the converted
    model and the sharded multistart on ``mesh``."""
    from egobox_torch import gp
    from egobox_torch import parallel as P
    from egobox_torch.convert import dist_gp_model_from_numpy
    from egobox_torch.parallel.dist_fit import _normalize

    D = mesh.size
    bp = inp["bp"][D]
    out = {}
    t = torch.from_numpy
    x, y, theta, xq = (t(inp["x"]), t(inp["y"]), t(inp["theta"]),
                       t(inp["xq"]))

    # the fit: warm start (egobox_tpu's LHS seeds) + distributed polish
    fit_kw = dict(inp["fit_kw"], nugget=NUGGET)
    theta_fit, _ = P.fit_theta_distributed(mesh, x, y, bp=bp, **fit_kw)
    out["theta_fit"] = _np(theta_fit)
    model = gp.fit_gp(inp["x"], inp["y"], mesh=mesh, dist_bp=bp, **fit_kw)
    out["fit_gp"] = (type(model).__name__, _np(model.theta),
                     model.n_train)
    mat = gp.fit_gp(inp["x"], inp["y"], mesh=mesh, dist_bp=bp,
                    mesh_materialize=True, **fit_kw)
    out["materialized"] = (type(mat).__name__, _np(mat.theta))
    try:
        model.save("unused.json")
    except NotImplementedError as e:
        out["save_error"] = str(e)

    # the realized model at a fixed theta and its serving path
    normals = t(inp["normals"])
    for name, kw, th in (("plain", {}, theta),
                         ("kpls", dict(kpls_dim=2), theta[:2])):
        mdl = P.realize_dist_model(mesh, x, y, th, corr="matern52",
                                   nugget=NUGGET, bp=bp, **kw)
        out[f"model_{name}"] = dict(
            l_feed=_np(mdl.l_feed), gamma_feed=_np(mdl.gamma_feed),
            likelihood=float(mdl.likelihood), predict=_np(mdl.predict(xq)),
            predict_var=_np(mdl.predict_var(xq)),
            valvar=_np(torch.stack(mdl.predict_valvar(xq))),
            cov=_np(mdl.posterior_cov(xq)),
            sample=_np(mdl.sample(xq, 3, normals=normals)),
            sample_chol=_np(mdl.sample(xq, 3, method="chol",
                                       normals=normals)))

    # egobox_tpu's realized model carried over
    conv = dist_gp_model_from_numpy(inp[f"jax_model_{D}"], mesh,
                                    "matern52", "constant", bp=bp)
    out["converted"] = _np(torch.stack(conv.predict_valvar(xq)))
    if D > 1:  # the same arrays in another mesh size's layout
        try:
            dist_gp_model_from_numpy(inp["jax_model_1"], mesh, "matern52",
                                     "constant", bp=bp)
            out["converted_wrong_layout"] = "no error"
        except ValueError as e:
            out["converted_wrong_layout"] = str(e)

    # the multistart over the ranks' starts
    xn, yn, (_, _, _, y_std) = _normalize(x, y)
    inits = t(inp["inits"])
    lo = torch.full((x.shape[1],), -2.0, dtype=x.dtype)
    up = torch.full((x.shape[1],), 1.0, dtype=x.dtype)
    tb, fb = P.multistart_neg_rlf_minimize(
        xn, yn, y_std, P.shard_starts(mesh, inits), lo, up, None,
        corr="matern52", trend="constant", max_iters=5, nugget=NUGGET,
        mesh=mesh)
    out["multistart"] = (_np(tb), float(fb))
    mgp = P.fit_gp_multichip(mesh, x, y, inits, corr="matern52",
                             max_iters=5, nugget=NUGGET)
    out["multichip_theta"] = _np(mgp.theta)
    return out


def _quad_batch(centers):
    def fbatch(x):  # (B, 1) -> (B, 1)
        _quad_batch.calls += 1
        return np.sum((x - centers[:, None]) ** 2, axis=1, keepdims=True)

    return fbatch


@contextlib.contextmanager
def lane_blocks(size):
    """The fused batch program run on ``size`` contiguous blocks of its
    lanes, padded as a ``size``-rank mesh pads them (ego/batch.py
    ``_run_program``): the arithmetic of a mesh run, without a mesh. A
    lane's last bits depend on the width of the batch it is computed in
    (vectorized transcendental functions round their tail elements
    differently), and an EGO run amplifies them, so a mesh run is held
    to this run, and to the plain run only where both are one block."""
    from egobox_torch.ego import batch as B

    whole = B.fused_select_point_batch

    def blocks(**kw):
        lanes = kw["xp"].shape[0]
        width = -(-max(lanes, size) // size) * size
        blk = width // size
        ins = {}
        for k, v in kw.items():
            if k in B._LANE_INPUTS and v is not None and width > lanes:
                v = torch.cat([v, v[:1].expand((width - lanes,)
                                               + tuple(v.shape[1:]))])
            ins[k] = v
        outs = [whole(**{k: (v[s:s + blk] if k in B._LANE_INPUTS
                             and v is not None else v)
                         for k, v in ins.items()})
                for s in range(0, width, blk)]
        return tuple(torch.cat(o)[:lanes] for o in zip(*outs))

    B.fused_select_point_batch = blocks
    try:
        yield
    finally:
        B.fused_select_point_batch = whole


def _egor_batch(mesh):
    """tests/test_batch.py:44-62's eight quadratics, 8 iterations."""
    from egobox_torch import EgorBatch
    from egobox_torch.ego.config import GpConfig

    centers = np.arange(8, dtype=float) * 2.0 + 4.0
    xl = np.broadcast_to(np.array([[0.0, 25.0]]), (8, 1, 2))
    _quad_batch.calls = 0
    res = EgorBatch(_quad_batch(centers), xl, mesh=mesh, seed=5, n_start=4,
                    gp_config=GpConfig(n_start=2, max_eval=10),
                    device="cpu").minimize(max_iters=8)
    return dict(centers=centers, calls=_quad_batch.calls,
                x_opt=np.stack([r.x_opt for r in res]),
                x_doe=np.stack([r.x_doe for r in res]))


def run(rank, world_size, inp):
    """The entry point of each rank (``launch.run_ranks``): the case
    groups ``inp["parts"]`` names ("linalg", "model", "batch") on the
    whole group's mesh, then on rank 0's one-rank mesh (``world_size`` of
    at least 3 with "batch")."""
    from egobox_torch import EgorBatch
    from egobox_torch import parallel as P

    torch.set_num_threads(1)
    cases = {"linalg": _linalg_cases, "model": _model_cases}
    out = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mesh = P.make_mesh(2 * world_size, axis="rows", device="cpu")
    out["degraded"] = (mesh.size, [str(w.message) for w in caught])
    for part in inp["parts"]:
        if part in cases:
            with _injected(inp):
                out[f"{part}_{world_size}"] = cases[part](mesh, inp)
    if "batch" in inp["parts"]:
        out["batch_mesh"] = _egor_batch(mesh)
        if rank < 3:
            mesh3 = P.make_mesh(3, device="cpu")
            try:
                EgorBatch(_quad_batch(np.zeros(8)),
                          np.broadcast_to(np.array([[0.0, 25.0]]),
                                          (8, 1, 2)),
                          mesh=mesh3, seed=5, device="cpu")
                out["batch_3"] = "no error"
            except ValueError as e:
                out["batch_3"] = str(e)
            mesh3.close()
    # then each rank alone: rank 0 on its one-rank mesh, ranks 1 and 2 the
    # references of the EgorBatch runs (no mesh; on 4 blocks of lanes)
    if rank == 0:
        mesh1 = P.make_mesh(1, axis="rows", device="cpu")
        for part in inp["parts"]:
            if part in cases:
                with _injected(inp):
                    out[f"{part}_1"] = cases[part](mesh1, inp)
        if "batch" in inp["parts"]:
            out["batch_mesh1"] = _egor_batch(mesh1)
        mesh1.close()
    elif rank == 1 and "batch" in inp["parts"]:
        out["batch_plain"] = _egor_batch(None)
    elif rank == 2 and "batch" in inp["parts"]:
        with lane_blocks(world_size):
            out["batch_blocks"] = _egor_batch(None)
    return out


def fail_on_rank1(rank, world_size):
    """Rank 1 raises while the others wait for it in a collective."""
    import torch.distributed as dist

    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    t = torch.ones(1)
    dist.all_reduce(t)
    return float(t)
