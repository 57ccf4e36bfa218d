"""Cone dimension metadata.

The canonical conic form consumed by every solver in this framework is

    minimize    (1/2) x'Px + q'x
    subject to  Ax + s = b,   s in K

where K is a product of Zero, NonNeg, SOC, Exp, PSD and Pow3D cones, ordered
Zero -> NonNeg -> SOC -> Exp -> PSD -> Pow3D to match the dual-variable layout
of the reference implementation (cvxpylayers parse_args.py:241-248).

`ConeDims` is a static, hashable description of that product cone. It is part
of the jit cache key for every compiled solve, so it must be immutable.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ConeDims:
    """Static description of a product cone K.

    Attributes:
      zero:   number of zero-cone rows (equality constraints; dual is free).
      nonneg: number of nonnegative-orthant rows.
      soc:    tuple of second-order-cone block sizes (each >= 1; block layout
              is (t, x) with ||x|| <= t).
      exp:    number of 3-dimensional primal exponential cones
              cl{(x, y, z) : y > 0, y*exp(x/y) <= z}.
      psd:    tuple of PSD block *matrix side lengths* s; each block occupies
              s*(s+1)//2 rows in svec (scaled lower-triangular) layout.
      pow3:   tuple of powers alpha for 3-dim power cones
              {(x, y, z) : x^alpha * y^(1-alpha) >= |z|, x >= 0, y >= 0}.
    """

    zero: int = 0
    nonneg: int = 0
    soc: Tuple[int, ...] = ()
    exp: int = 0
    psd: Tuple[int, ...] = ()
    pow3: Tuple[float, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "soc", tuple(int(d) for d in self.soc))
        object.__setattr__(self, "psd", tuple(int(s) for s in self.psd))
        object.__setattr__(self, "pow3", tuple(float(a) for a in self.pow3))
        for d in self.soc:
            if d < 1:
                raise ValueError(f"SOC block size must be >= 1, got {d}")
        for s in self.psd:
            if s < 1:
                raise ValueError(f"PSD block side must be >= 1, got {s}")
        for a in self.pow3:
            if not (0.0 < a < 1.0):
                raise ValueError(f"pow cone alpha must be in (0, 1), got {a}")

    @property
    def soc_total(self) -> int:
        return sum(self.soc)

    @property
    def psd_total(self) -> int:
        return sum(s * (s + 1) // 2 for s in self.psd)

    @property
    def total(self) -> int:
        """Total embedded dimension m of the product cone."""
        return (
            self.zero
            + self.nonneg
            + self.soc_total
            + 3 * self.exp
            + self.psd_total
            + 3 * len(self.pow3)
        )

    # Offsets of each cone family within the stacked (m,) vector.
    @property
    def offset_nonneg(self) -> int:
        return self.zero

    @property
    def offset_soc(self) -> int:
        return self.zero + self.nonneg

    @property
    def offset_exp(self) -> int:
        return self.offset_soc + self.soc_total

    @property
    def offset_psd(self) -> int:
        return self.offset_exp + 3 * self.exp

    @property
    def offset_pow(self) -> int:
        return self.offset_psd + self.psd_total

    def is_polyhedral(self) -> bool:
        return not self.soc and self.exp == 0 and not self.psd and not self.pow3
