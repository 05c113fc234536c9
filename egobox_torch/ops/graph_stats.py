"""What the port's CUDA graphs cost, counted one way wherever it captures
one (ego/graphs.py ``GraphCache``, optim/trial_graph.py ``TrialGraph``).

For the kernels of this package the stats count the launches a capture
recorded and the launches replays made: a kernel's own counter rises once
per launch the host issues, in a capture too, where the launch is recorded
and does not run. The launches that ran are the counter's rise, less
``kernel_captured``, plus ``kernel_replays``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from . import chol_kernel, corr_kernel

_KERNELS = {"corr_tile": corr_kernel, "factor_panel": chol_kernel}


@dataclasses.dataclass
class GraphStats:
    """What the graphs of one cache (or one trial graph) cost, summed over
    its signatures."""

    eager: int = 0  # the warm-up call (its result is the call's)
    captures: int = 0
    capture_s: float = 0.0
    #: device memory the pool of the live graphs held after the last
    #: capture, and the most it held after any capture (None: not measured)
    pool_bytes: Optional[int] = 0
    pool_peak_bytes: Optional[int] = 0
    #: graphs dropped because the design outgrew their size
    evicted: int = 0
    replays: int = 0
    #: kernel launches recorded by captures (they did not run), and made
    #: by replays, by kernel name
    kernel_captured: dict = dataclasses.field(default_factory=dict)
    kernel_replays: dict = dataclasses.field(default_factory=dict)
    #: what the last call did: "eager", "capture" or "replay"
    last: str = ""

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def add_counts(counts: dict, more: dict) -> None:
    for name, n in more.items():
        counts[name] = counts.get(name, 0) + n


def launch_counts() -> dict:
    """Each kernel's launch counter now."""
    return {k: mod.launches for k, mod in _KERNELS.items()}


def launches_since(counts: dict) -> dict:
    """The launches each kernel's counter rose by since ``counts``."""
    return {k: mod.launches - counts[k] for k, mod in _KERNELS.items()
            if mod.launches > counts[k]}
