"""DoE sampling: classic, centered and maximin LHS, distance helpers."""

from .lhs import centered_lhs, classic_lhs, maximin_lhs, scale_to_xlimits
from .utils import cdist, cdist_sq, min_pdist_sq, pdist, pdist_sq

__all__ = [
    "cdist",
    "cdist_sq",
    "centered_lhs",
    "classic_lhs",
    "maximin_lhs",
    "min_pdist_sq",
    "pdist",
    "pdist_sq",
    "scale_to_xlimits",
]
