"""The control comes out not correct: the cell's comparison run with the
program's own lower-precision path switched on, at the cell's full size,
on three seeds. On a card only (the float32 path is the card's):

    python3 -m pytest portbench/tests/test_portbench_controls.py \\
        -o addopts="" -q -s

prints each run's numbers beside its limits."""

from __future__ import annotations

import pytest

#: cell -> (control, window seconds): the program in float32 for the
#: configuration stated in float64
CONTROLS = {
    "gp-fit.kpls1-d10-n3k": ("program-float32", 3.0),
}
SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CONTROLS))
def test_the_control_is_not_correct(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control is the card's "
                    "float32 path at the cell's full size")
    from portbench import calibrate

    control, seconds = CONTROLS[name]
    runs = calibrate.run_seeds(name, SEEDS, seconds, control)
    assert [r["correct"] for r in runs] == [False] * len(SEEDS)
