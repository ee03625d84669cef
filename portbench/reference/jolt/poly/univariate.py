"""Host-side univariate round polynomials (Python ints mod p).

Mirrors `crates/jolt-prover-legacy/src/poly/unipoly.rs`.  Round polynomials
are tiny (<= ~30 coefficients); all interpolation/evaluation happens on the
host in exact int arithmetic, at the transcript boundary.  Device kernels
produce the evaluations; this module turns them into wire-format coefficients.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

from ..field.params import FR


@dataclasses.dataclass
class UniPoly:
    """Coefficient-form univariate polynomial, coeffs[i] * x^i."""

    coeffs: List[int]
    p: int = FR.modulus

    # ---- constructors ---------------------------------------------------


    # ---- ops ------------------------------------------------------------

    def evaluate(self, r: int) -> int:
        acc = 0
        for c in reversed(self.coeffs):
            acc = (acc * r + c) % self.p
        return acc

    @classmethod
    def decompress(cls, compressed: Sequence[int], hint: int,
                   p: int = FR.modulus) -> "UniPoly":
        """Recover c1 from hint = p(0) + p(1) (unipoly.rs:309-321)."""
        linear = (hint - 2 * compressed[0] - sum(compressed[1:])) % p
        return cls([compressed[0] % p, linear, *[c % p for c in compressed[1:]]], p)
