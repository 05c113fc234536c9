"""Box-constrained quasi-Newton solvers."""

from .lbfgsb import LbfgsbResult, minimize_lbfgsb, minimize_tr

__all__ = ["LbfgsbResult", "minimize_lbfgsb", "minimize_tr"]
