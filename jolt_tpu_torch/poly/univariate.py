"""Host-side univariate round polynomials (Python ints mod p).

Mirrors `crates/jolt-prover-legacy/src/poly/unipoly.rs`.  Round polynomials
are tiny (<= ~30 coefficients); all interpolation/evaluation happens on the
host in exact int arithmetic, at the transcript boundary.  Device kernels
produce the evaluations; this module turns them into wire-format coefficients.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

from ..field.params import FR, FieldParams


def _inv(x: int, p: int) -> int:
    return pow(x, -1, p)


@dataclasses.dataclass
class UniPoly:
    """Coefficient-form univariate polynomial, coeffs[i] * x^i."""

    coeffs: List[int]
    p: int = FR.modulus

    # ---- constructors ---------------------------------------------------

    @classmethod
    def from_evals(cls, evals: Sequence[int], p: int = FR.modulus) -> "UniPoly":
        """Interpolate from evaluations at 0, 1, ..., n-1 (unipoly.rs:35-43)."""
        n = len(evals)
        if n == 3:
            return cls._degree2(evals[0], evals[1], evals[2], p)
        if n == 4:
            return cls._degree3(evals[0], evals[1], evals[2], evals[3], p)
        return cls(cls._vandermonde(list(evals), p), p)

    @classmethod
    def from_evals_and_hint(cls, hint: int, evals: Sequence[int],
                            p: int = FR.modulus) -> "UniPoly":
        """Evals at {0, 2, 3, ..., n} plus hint = p(0)+p(1) (unipoly.rs:47-70)."""
        e1 = (hint - evals[0]) % p
        return cls.from_evals([evals[0], e1, *evals[1:]], p)

    @classmethod
    def _degree2(cls, e0, e1, e2, p) -> "UniPoly":
        two_inv = _inv(2, p)
        c0 = e0 % p
        c2 = (e0 - e1 - e1 + e2) * two_inv % p
        c1 = (e1 - e0 - c2) % p
        return cls([c0, c1, c2], p)

    @classmethod
    def _degree3(cls, e0, e1, e2, e3, p) -> "UniPoly":
        two_inv, six_inv = _inv(2, p), _inv(6, p)
        c0 = e0 % p
        c3 = (e3 - e0 + (e1 - e2) * 3) * six_inv % p
        c2 = ((e0 - e1 - e1 + e2) * two_inv - 3 * c3) % p
        c1 = (e1 - e0 - c2 - c3) % p
        return cls([c0, c1, c2, c3], p)

    @staticmethod
    def _vandermonde(evals: List[int], p: int) -> List[int]:
        """Solve V c = evals for points 0..n-1 by Gaussian elimination mod p."""
        n = len(evals)
        A = [[pow(i, j, p) for j in range(n)] + [evals[i] % p] for i in range(n)]
        for col in range(n):
            piv = next(r for r in range(col, n) if A[r][col] % p != 0)
            A[col], A[piv] = A[piv], A[col]
            inv_p = _inv(A[col][col], p)
            A[col] = [v * inv_p % p for v in A[col]]
            for r in range(n):
                if r != col and A[r][col]:
                    f = A[r][col]
                    A[r] = [(v - f * w) % p for v, w in zip(A[r], A[col])]
        return [A[i][n] for i in range(n)]

    # ---- ops ------------------------------------------------------------

    def evaluate(self, r: int) -> int:
        acc = 0
        for c in reversed(self.coeffs):
            acc = (acc * r + c) % self.p
        return acc

    def scale(self, k: int) -> "UniPoly":
        return UniPoly([c * k % self.p for c in self.coeffs], self.p)

    def add(self, other: "UniPoly") -> "UniPoly":
        n = max(len(self.coeffs), len(other.coeffs))
        a = self.coeffs + [0] * (n - len(self.coeffs))
        b = other.coeffs + [0] * (n - len(other.coeffs))
        return UniPoly([(x + y) % self.p for x, y in zip(a, b)], self.p)

    def compress(self) -> List[int]:
        """Drop the linear coefficient (unipoly.rs:299-307):
        [c0, c2, c3, ...]."""
        return [self.coeffs[0]] + list(self.coeffs[2:])

    @classmethod
    def decompress(cls, compressed: Sequence[int], hint: int,
                   p: int = FR.modulus) -> "UniPoly":
        """Recover c1 from hint = p(0) + p(1) (unipoly.rs:309-321)."""
        linear = (hint - 2 * compressed[0] - sum(compressed[1:])) % p
        return cls([compressed[0] % p, linear, *[c % p for c in compressed[1:]]], p)
