"""EgorBatch(mesh=) of egobox_torch on 4 gloo CPU ranks, spawned once for
the file (tests/torch_parallel_ranks.py): tests/test_batch.py:44-67's 8
quadratics (seed 5, 4 infill starts, GpConfig(n_start=2, max_eval=10), 8
iterations) held to the port's runs without a mesh, which every rank
reproduces (the same host state, the same draws), and to egobox_tpu's
gate |x_opt - c| < 1. float64, ``device="cpu"``; no JAX is needed here.
"""

import numpy as np
import pytest

import torch_parallel_ranks as R
from egobox_torch.parallel.launch import run_ranks


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(R.run, 4, (dict(parts=("batch",)),), timeout=120)


def test_egor_batch_mesh_equals_no_mesh_run(ranks):
    """Every proposal of the 4-rank run equals, to 1e-8, the port's run
    without a mesh whose program runs on the same 4 blocks of lanes
    (torch_parallel_ranks.lane_blocks; the plain run computes each lane in
    a batch of 8 and its last bits differ, which the run amplifies), and
    so does the one-rank mesh's the plain run's; both meet egobox_tpu's
    gate |x_opt - c| < 1, and the objective runs on rank 0 only."""
    for got, want in [(r["batch_mesh"], ranks[2]["batch_blocks"])
                      for r in ranks] + [(ranks[0]["batch_mesh1"],
                                          ranks[1]["batch_plain"])]:
        np.testing.assert_allclose(got["x_doe"], want["x_doe"], rtol=0,
                                   atol=1e-8)
        assert np.all(np.abs(got["x_opt"][:, 0] - got["centers"]) < 1.0)
    assert ranks[0]["batch_mesh"]["calls"] == ranks[1]["batch_plain"]["calls"]
    assert ranks[0]["batch_mesh"]["calls"] > 8
    assert [r["batch_mesh"]["calls"] for r in ranks[1:]] == [0, 0, 0]


def test_egor_batch_refuses_8_problems_over_3_ranks(ranks):
    """B must divide by the mesh size (a 3-rank group of the 4)."""
    for r in ranks[:3]:
        assert "divisible by the 3-rank mesh" in r["batch_3"]
