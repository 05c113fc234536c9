"""Mixed-integer design-space machinery: continuous relaxation, one-hot
fold/unfold, discrete casting.

Behavioral parity with crates/ego/src/gpmix/mixint.rs:
- ``continuous_xlimits``  <- as_continuous_limits (mixint.rs:38-67)
- ``fold`` / ``unfold``   <- fold_with_enum_index / unfold_with_enum_mask
  (mixint.rs:77-144)
- ``cast_continuous``     <- cast_to_discrete_values (mixint.rs:167-217):
  INT rounds, ORD snaps to the closest allowed level, ENUM one-hot argmax.

These are pure array transforms (vectorized numpy on the host-side DoE
bookkeeping path; the GP itself always sees the casted continuous space).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from ..types import XSpec, XType


def parse_xspecs(xspecs) -> List[XSpec]:
    """Accept XSpec list, (nx, 2) array, or list of [lb, ub] pairs
    (ref: python/src/domain.rs:5-82)."""
    if isinstance(xspecs, np.ndarray):
        xspecs = xspecs.tolist()
    out: List[XSpec] = []
    for s in xspecs:
        if isinstance(s, XSpec):
            out.append(s)
        else:
            lb, ub = float(s[0]), float(s[1])
            out.append(XSpec(XType.FLOAT, [lb, ub]))
    if not out:
        raise ValueError("empty xspecs")
    return out


@dataclass
class MixintContext:
    """(ref: MixintContext factory, mixint.rs:790-859)"""

    xspecs: Sequence[XSpec]

    def __post_init__(self):
        self.xspecs = list(self.xspecs)

    @property
    def is_discrete(self) -> bool:
        return any(s.xtype is not XType.FLOAT for s in self.xspecs)

    @property
    def n_folded(self) -> int:
        return len(self.xspecs)

    @property
    def n_continuous(self) -> int:
        return sum(
            s.n_levels if s.xtype is XType.ENUM else 1 for s in self.xspecs
        )

    def continuous_xlimits(self) -> np.ndarray:
        """(ncont, 2) relaxed limits (ref: mixint.rs:38-67)."""
        rows = []
        for s in self.xspecs:
            if s.xtype is XType.ENUM:
                rows.extend([[0.0, 1.0]] * s.n_levels)
            elif s.xtype is XType.ORD:
                vals = [float(v) for v in s.xlimits]
                rows.append([min(vals), max(vals)])
            else:
                rows.append([float(s.xlimits[0]), float(s.xlimits[1])])
        return np.asarray(rows, dtype=float)

    # ------------------------------------------------------------------

    def cast_continuous(self, x: np.ndarray) -> np.ndarray:
        """Snap continuous-relaxed points onto valid discrete values,
        keeping the unfolded layout (ref: cast_to_discrete_values)."""
        x = np.atleast_2d(np.asarray(x, dtype=float)).copy()
        j = 0
        for s in self.xspecs:
            if s.xtype is XType.FLOAT:
                j += 1
            elif s.xtype is XType.INT:
                x[:, j] = np.clip(
                    np.round(x[:, j]), s.xlimits[0], s.xlimits[1]
                )
                j += 1
            elif s.xtype is XType.ORD:
                vals = np.asarray([float(v) for v in s.xlimits])
                idx = np.argmin(
                    np.abs(x[:, j : j + 1] - vals[None, :]), axis=1
                )
                x[:, j] = vals[idx]
                j += 1
            else:  # ENUM: one-hot argmax
                n = s.n_levels
                block = x[:, j : j + n]
                arg = np.argmax(block, axis=1)
                block[:] = 0.0
                block[np.arange(block.shape[0]), arg] = 1.0
                x[:, j : j + n] = block
                j += n
        return x

    def fold(self, x: np.ndarray) -> np.ndarray:
        """Unfolded (continuous layout) -> folded user space; ENUM blocks
        collapse to their argmax level index (ref: mixint.rs:77-112)."""
        x = np.atleast_2d(np.asarray(x, dtype=float))
        cols = []
        j = 0
        for s in self.xspecs:
            if s.xtype is XType.ENUM:
                n = s.n_levels
                cols.append(
                    np.argmax(x[:, j : j + n], axis=1).astype(float)
                )
                j += n
            else:
                cols.append(x[:, j])
                j += 1
        return np.stack(cols, axis=1)

    def unfold(self, x: np.ndarray) -> np.ndarray:
        """Folded user space -> unfolded continuous layout; ENUM level
        index expands to a one-hot mask (ref: mixint.rs:115-144)."""
        x = np.atleast_2d(np.asarray(x, dtype=float))
        cols = []
        for k, s in enumerate(self.xspecs):
            if s.xtype is XType.ENUM:
                n = s.n_levels
                onehot = np.zeros((x.shape[0], n))
                idx = np.clip(np.round(x[:, k]).astype(int), 0, n - 1)
                onehot[np.arange(x.shape[0]), idx] = 1.0
                cols.append(onehot)
            else:
                cols.append(x[:, k : k + 1])
        return np.concatenate(cols, axis=1)

    # ------------------------------------------------------------------

    def to_discrete_space(self, x_cont: np.ndarray) -> np.ndarray:
        """(ref: to_discrete_space, mixint.rs:220-226)"""
        if not self.is_discrete:
            return np.atleast_2d(np.asarray(x_cont, dtype=float))
        return self.fold(self.cast_continuous(x_cont))

    def to_continuous_space(self, x_folded: np.ndarray) -> np.ndarray:
        """(ref: to_continuous_space, mixint.rs:148-153)"""
        if not self.is_discrete:
            return np.atleast_2d(np.asarray(x_folded, dtype=float))
        return self.unfold(x_folded)
