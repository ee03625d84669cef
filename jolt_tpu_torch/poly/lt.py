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

import torch

from ..field import FR, ops


def evals(point: Sequence[int], device="cuda") -> torch.Tensor:
    """Table [LT(x, point)]_{x in [2^n]} as a limb tensor (L, 2^n)."""
    lt = ops.zeros((1,), device)
    eqacc = ops.ones((1,), device)
    for r in point:
        eq1 = ops.mont_mul(eqacc, r)        # r by value
        lt0 = ops.add(lt, eq1)              # x_b = 0: add r_b * eqacc
        eq0 = ops.sub(eqacc, eq1)           # eqacc * (1 - r_b)
        lt = torch.stack([lt0, lt], dim=-1).reshape(ops.N_LIMBS, -1)
        eqacc = torch.stack([eq0, eq1], dim=-1).reshape(ops.N_LIMBS, -1)
    return lt


def lt_int(x: int, point: Sequence[int]) -> int:
    """Host evaluation of LT(x, point) for integer x (verifier side)."""
    p = FR.modulus
    n = len(point)
    lt, eqacc = 0, 1
    for b in range(n):
        xb = (x >> (n - 1 - b)) & 1
        rb = point[b]
        if xb == 0:
            lt = (lt + eqacc * rb) % p
        eqacc = eqacc * ((rb if xb else (1 - rb)) % p) % p
    return lt


def lt_point_int(point_x: Sequence[int], point_r: Sequence[int]) -> int:
    """Host evaluation of the LT MLE at two field points (both big-endian)."""
    p = FR.modulus
    lt, eqacc = 0, 1
    for xb, rb in zip(point_x, point_r):
        lt = (lt + eqacc * ((1 - xb) % p) * rb) % p
        eqacc = eqacc * ((xb * rb + (1 - xb) * (1 - rb)) % p) % p
    return lt
