"""A run with the timed path broken underneath comes out not correct: for
each cell, each fault it can have. The runs skip the look for a card and
run at the tiny sizes on the CPU; everything else is the harness's path.

The faults (``portbench/faults.py``): a step that returns its state
unchanged (the first fit's model for every data set, or theta left at its
init); the optimisation cut short (no restarts, one iteration); half of
the batch left out; an answer altered where it is produced. (One card:
there is no exchange between cards to leave out.)"""

from __future__ import annotations

import pytest

import egobox_torch
from egobox_torch import gp
from portbench import faults
from portbench.tests import tiny

CELL_FAULTS = [("gp-fit.kpls1-d10-n3k", f) for f in sorted(faults.FAULTS)]


@pytest.mark.parametrize("name,fault", CELL_FAULTS,
                         ids=lambda v: v.replace(" ", "-"))
def test_a_broken_path_is_not_correct(name, fault):
    undo = faults.FAULTS[fault]()
    try:
        res = tiny.run(name)
    finally:
        undo()
    assert res["attempted"] >= 1
    assert res["correct"] is False, res["checks"]


def test_the_faults_reach_the_program():
    """The patched name is the one the fit loop calls, and each fault puts
    it back."""
    assert egobox_torch.gp is gp
    fit = gp.fit_gp
    for plant in faults.FAULTS.values():
        undo = plant()
        assert gp.fit_gp is not fit
        undo()
        assert gp.fit_gp is fit
