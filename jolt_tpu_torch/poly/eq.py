"""Eq polynomial evaluation tables.

Torch counterpart of the JAX package's `poly/eq.py` (analog of
`EqPolynomial::evals`, `crates/jolt-prover-legacy/src/poly/eq_poly.rs`):
big-endian convention, r[0] corresponds to the MSB of the table index.

eq(r, x) = prod_j (r_j x_j + (1-r_j)(1-x_j)); the table over all x in
{0,1}^n is built by n doubling steps, each one mont_mul of the current table
by r_j and an interleave -- O(T) multiplies total.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..field import FR, ops


def _double(E: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """One doubling step: E (L, S) -> (L, 2S) appending variable r as new LSB."""
    hi = ops.mont_mul(E, r)              # E * r      -> x_new = 1
    lo = ops.sub(E, hi)                  # E * (1-r)  -> x_new = 0
    return torch.stack([lo, hi], dim=-1).reshape(E.shape[0], -1)


def evals(point: Sequence[int], device="cuda",
          scale: Optional[int] = None) -> torch.Tensor:
    """Table [eq(point, x)]_{x in [2^n]} as limb tensor (L, 2^n).

    point is host-side ints (point[0] = MSB var); optional scaling factor
    multiplies every entry (eq_poly.rs:96 `evals_with_scaling`)."""
    E = ops.pack_ints([1 if scale is None else scale], device)
    for r in point:
        E = _double(E, ops.pack_ints([r], device))
    return E


def eq_int(point_a: Sequence[int], point_b: Sequence[int]) -> int:
    """Host-side eq(a, b) for two int points (verifier-side work)."""
    p = FR.modulus
    acc = 1
    for a, b in zip(point_a, point_b):
        acc = acc * ((a * b + (1 - a) * (1 - b)) % p) % p
    return acc
