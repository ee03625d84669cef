"""Eq polynomial evaluation tables.

Torch counterpart of the JAX package's `poly/eq.py` (analog of
`EqPolynomial::evals`, `crates/jolt-prover-legacy/src/poly/eq_poly.rs`):
big-endian convention, r[0] corresponds to the MSB of the table index.

eq(r, x) = prod_j (r_j x_j + (1-r_j)(1-x_j)); the table over all x in
{0,1}^n is built by n doubling steps, each one mont_mul of the current table
by r_j (by value) and an interleave -- O(T) multiplies total.
"""

from __future__ import annotations

from typing import Sequence


from ..field import FR


def eq_int(point_a: Sequence[int], point_b: Sequence[int]) -> int:
    """Host-side eq(a, b) for two int points (verifier-side work)."""
    p = FR.modulus
    acc = 1
    for a, b in zip(point_a, point_b):
        acc = acc * ((a * b + (1 - a) * (1 - b)) % p) % p
    return acc
