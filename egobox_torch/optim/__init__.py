"""Box-constrained quasi-Newton solvers."""

from .lbfgsb import (LbfgsbResult, minimize_lbfgsb, minimize_tr,
                     multistart_minimize)

__all__ = ["LbfgsbResult", "minimize_lbfgsb", "minimize_tr",
           "multistart_minimize"]
