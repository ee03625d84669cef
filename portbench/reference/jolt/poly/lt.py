"""The less-than polynomial LT(x, r): MLE of the indicator [x < r].

Torch counterpart of the JAX package's `poly/lt.py` (reference:
`crates/jolt-prover-legacy/src/poly/lt_poly.rs`; used by the registers/RAM
Val-evaluation sumchecks: Val(k, j) = sum_{j' < j} inc terms).

Table construction (big-endian, bit 0 = MSB, matching eq.evals):
  LT(x, r) = sum_b [x_b = 0] * r_b * prod_{b' < b} eq(x_b', r_b')
built by doubling: per bit, (lt, eqacc) -> new leaves for x_b in {0,1}.
"""

from __future__ import annotations

from typing import Sequence


from ..field import FR


def lt_point_int(point_x: Sequence[int], point_r: Sequence[int]) -> int:
    """Host evaluation of the LT MLE at two field points (both big-endian)."""
    p = FR.modulus
    lt, eqacc = 0, 1
    for xb, rb in zip(point_x, point_r):
        lt = (lt + eqacc * ((1 - xb) % p) * rb) % p
        eqacc = eqacc * ((xb * rb + (1 - xb) * (1 - rb)) % p) % p
    return lt
