"""DoE sampling: classic, centered, maximin and ESE-optimized LHS, full
factorial and uniform random designs, distance helpers."""

from .full_factorial import FullFactorial, full_factorial_normalized
from .lhs import (Lhs, LhsKind, centered_lhs, classic_lhs, lhs_normalized,
                  maximin_ese, maximin_lhs, optimized_lhs, scale_to_xlimits)
from .random import Random, random_normalized
from .utils import cdist, cdist_sq, min_pdist_sq, pdist, pdist_sq

__all__ = [
    "FullFactorial",
    "Lhs",
    "LhsKind",
    "Random",
    "cdist",
    "cdist_sq",
    "centered_lhs",
    "classic_lhs",
    "full_factorial_normalized",
    "lhs_normalized",
    "maximin_ese",
    "maximin_lhs",
    "min_pdist_sq",
    "optimized_lhs",
    "pdist",
    "pdist_sq",
    "random_normalized",
    "scale_to_xlimits",
]
