"""Tiny sizes of each cell for the CPU: the same harness path, the same
limits, a configuration and a traffic small enough for a test run."""

from __future__ import annotations

OVERRIDES = {
    "gp-fit.kpls1-d10-n3k": {
        "config": {"n_train": 120, "n_holdout": 50},
        "traffic": {"pool_size": 4, "warmup": 1, "check_fits": 2,
                    "check_among": 3, "trace_units": 1,
                    "trace_host_units": 1}},
}

#: window seconds at the tiny sizes
SECONDS = {"gp-fit.kpls1-d10-n3k": 0.3}
SEED = 2**31 + 977


def spec() -> dict:
    from portbench import harness

    return harness.load_spec()


def run(name: str, trace: bool = False, seed: int = SEED):
    """``harness.run_cell`` of the cell at its tiny size on the CPU, with
    two threads (the tests run in several processes at once)."""
    import torch

    from portbench import harness

    torch.set_num_threads(2)

    cell = harness.Cell(spec(), name)
    return harness.run_cell(cell, seed, SECONDS[name], trace,
                            device="cpu", overrides=OVERRIDES[name])
