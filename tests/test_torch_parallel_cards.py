"""One rank per card (egobox_torch.parallel.launch and .sharding) on the
CPU: the rank-to-card rule, the NCCL launcher's refusals before it spawns
anything, the distinct-card check on 2 gloo ranks, and ``make_mesh``
joining a group launched as torchrun launches one (``WORLD_SIZE``,
``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``). What needs the cards themselves
is in tests/test_torch_cuda.py. No JAX: nothing here has a counterpart to
hold against, egobox_tpu's mesh being one controller's.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from egobox_torch.parallel import launch, sharding
from egobox_torch.parallel.launch import card_index, run_ranks

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("rank, n_ranks, n_cards, card", [
    (0, 1, 1, 0),
    (3, 4, 4, 3),
    (1, 2, 8, 1),
    (1, 2, 2, 1),
    (0, 4, 4, 0),
])
def test_card_index_maps_a_rank_to_its_card(rank, n_ranks, n_cards, card):
    assert card_index(rank, n_ranks, n_cards) == card


@pytest.mark.parametrize("rank, n_ranks, n_cards, match", [
    (0, 4, 2, "4 ranks on a host with 2 CUDA card"),
    (0, 1, 0, "1 ranks on a host with 0 CUDA card"),
    (2, 2, 2, "rank 2 maps to card 2"),
    (4, 4, 4, "rank 4 maps to card 4"),
])
def test_card_index_refuses_more_ranks_than_cards(rank, n_ranks, n_cards,
                                                  match):
    with pytest.raises(ValueError, match=match):
        card_index(rank, n_ranks, n_cards)


def test_make_mesh_takes_local_rank_as_the_card(monkeypatch):
    """A rank's card is ``$LOCAL_RANK``, checked against the host's cards
    and the launcher's ``LOCAL_WORLD_SIZE``."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert sharding._card() == 1
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="4 ranks on a host with 2"):
        sharding._card()
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(ValueError, match="3 ranks on a host with 2"):
        sharding._card()


def test_a_process_that_sees_one_card_takes_it(monkeypatch):
    """A launcher that gives each process a card of its own
    (``CUDA_VISIBLE_DEVICES``) leaves it the one visible card: the
    current device, whatever ``LOCAL_RANK`` says."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert sharding._card() == 0


def test_nccl_rank_names_its_card_where_make_mesh_reads_it(monkeypatch):
    """An NCCL rank of ``run_ranks`` sets its card as the current device
    and as ``LOCAL_RANK``, over what the parent's own launcher left
    there, so ``make_mesh`` reads that card; a gloo rank drops both
    variables and keeps the current device."""
    cards = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_device", cards.append)
    monkeypatch.setenv("LOCAL_RANK", "3")  # the parent's, inherited
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    assert launch._place("nccl", 1, 2) == 1
    assert cards == [1]
    assert (os.environ["LOCAL_RANK"], os.environ["LOCAL_WORLD_SIZE"]) == (
        "1", "2")
    assert sharding._card() == 1
    with pytest.raises(ValueError, match="5 ranks on a host with 4"):
        launch._place("nccl", 0, 5)
    assert launch._place("gloo", 1, 2) is None
    assert "LOCAL_RANK" not in os.environ
    assert "LOCAL_WORLD_SIZE" not in os.environ
    assert sharding._card() == 0 and cards == [1]


def _no_spawn(*args, **kw):
    raise AssertionError("run_ranks spawned a process")


def test_nccl_launcher_refuses_a_host_without_cuda(monkeypatch):
    """Before any process starts, and with no fallback to gloo."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    monkeypatch.setattr(launch.mp, "get_context", _no_spawn)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        run_ranks(_mesh_rank, 1, backend="nccl")
    with pytest.raises(ValueError, match="'gloo' or 'nccl'"):
        run_ranks(_mesh_rank, 1, backend="mpi")


def test_nccl_launcher_refuses_more_ranks_than_cards(monkeypatch):
    monkeypatch.setattr(launch.mp, "get_context", _no_spawn)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(launch.dist, "is_nccl_available", lambda: True)
    with pytest.raises(ValueError, match="4 ranks on a host with 2"):
        run_ranks(_mesh_rank, 4, backend="nccl")


def _mesh_rank(rank, world_size):
    """The rank side of the distinct-card test: the check with cards
    (0, 1), with both ranks on card 0 of one host, and with each on card
    0 of its own view (distinct UUIDs); then a group larger than its
    host's ``LOCAL_WORLD_SIZE``."""
    mesh = sharding.make_mesh(device="cpu")
    sharding.check_distinct_cards(mesh, rank, f"GPU-{rank}")
    sharding.check_distinct_cards(mesh, 0, f"GPU-{rank}")
    errors = []
    try:
        sharding.check_distinct_cards(mesh, 0, "GPU-0")
    except ValueError as e:
        errors.append(str(e))
    os.environ["LOCAL_WORLD_SIZE"] = "1"
    try:
        sharding._check_nccl_cards(mesh)
    except ValueError as e:
        errors.append(str(e))
    return mesh.size, errors


def test_distinct_card_check_on_two_gloo_ranks():
    """Cards (0, 1) pass, and two ranks that each see their own card as
    card 0; one card for both raises on both ranks, naming card 0. A
    group that spans more than one host raises."""
    for size, errors in run_ranks(_mesh_rank, 2, timeout=60):
        assert size == 2
        assert len(errors) == 2, errors
        assert "ranks [0, 1] of the mesh sit on one card, card 0:" in errors[0]
        assert "2 ranks span more than one host (1 on this one)" in errors[1]


_MESH_SCRIPT = """
import json, warnings
import torch
from egobox_torch import parallel as P
with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    mesh = P.make_mesh(2, device="cpu")
total = P._comm.all_reduce(mesh, torch.tensor([mesh.rank + 1.0]))
print(json.dumps(dict(rank=mesh.rank, size=mesh.size, total=float(total),
                      warned=[str(w.message) for w in caught])))
mesh.close()
"""

_LAUNCH_VARS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                "GROUP_RANK", "MASTER_ADDR", "MASTER_PORT")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_make_mesh_joins_a_group_launched_as_torchrun_does():
    """Two processes started with torchrun's variables make one 2-rank
    mesh; a process without them is still one rank, with the warning."""
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCH_VARS}
    env["PYTHONPATH"] = os.pathsep.join(
        filter(None, [str(ROOT), env.get("PYTHONPATH")]))
    port = str(_free_port())
    envs = [dict(env, WORLD_SIZE="2", RANK=str(r), MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=port) for r in range(2)] + [env]
    procs = [subprocess.Popen([sys.executable, "-c", _MESH_SCRIPT], env=e,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for e in envs]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=90)
            assert p.returncode == 0, err
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
    assert [(o["rank"], o["size"], o["total"]) for o in outs[:2]] == [
        (0, 2, 3.0), (1, 2, 3.0)]
    assert not any(o["warned"] for o in outs[:2])
    alone = outs[2]
    assert (alone["rank"], alone["size"], alone["total"]) == (0, 1, 1.0)
    assert any("degrading to a 1-rank mesh" in w for w in alone["warned"])


def test_chip_smoke_checks_k1_at_every_shape_of_a_distributed_run():
    """chip_smoke.py's K1 check of a distributed run on the CPU, where both
    of its sides are the plain version: on a one-rank mesh's model it
    rebuilds the row block of the Gram (the feed rows against all rows),
    the prediction's cross Gram, and the warm start's subsample of the
    fit's seed, and raises on a shape it has no inputs for."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from egobox_torch import parallel as P
    from egobox_torch.ops import corr_kernel as ck

    n, q = 2048, 16
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.uniform(-2.0, 2.0, (n + q, 2)))
    y = torch.sin(x).sum(dim=1, keepdim=True)
    mesh = P.make_mesh(device="cpu")
    try:
        model = P.realize_dist_model(mesh, x[:n], y[:n],
                                     torch.tensor([0.5, 2.0]),
                                     corr="matern52")
        args = (torch, ck, model, x[:n], x[n:])
        assert chip_smoke.dist_k1_checks(
            *args, [(n, n), (n, q), (2000, 2000)], seed=1) == 0.0
        with pytest.raises(RuntimeError, match="2000x2000, a shape with "
                                               "no inputs"):
            chip_smoke.dist_k1_checks(*args, [(n, n), (2000, 2000)])
    finally:
        mesh.close()
