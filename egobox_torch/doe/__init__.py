"""DoE sampling: classic, centered, maximin and ESE-optimized LHS, distance
helpers."""

from .lhs import (Lhs, LhsKind, centered_lhs, classic_lhs, lhs_normalized,
                  maximin_ese, maximin_lhs, optimized_lhs, scale_to_xlimits)
from .utils import cdist, cdist_sq, min_pdist_sq, pdist, pdist_sq

__all__ = [
    "Lhs",
    "LhsKind",
    "cdist",
    "cdist_sq",
    "centered_lhs",
    "classic_lhs",
    "lhs_normalized",
    "maximin_ese",
    "maximin_lhs",
    "min_pdist_sq",
    "optimized_lhs",
    "pdist",
    "pdist_sq",
    "scale_to_xlimits",
]
