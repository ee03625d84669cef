"""Dense multilinear polynomials as field limb tensors.

Torch counterpart of the JAX package's `poly/dense.py` (analog of the
reference's `DensePolynomial`, `crates/jolt-prover-legacy/src/poly/
dense_mlpoly.rs`).  An n-variable MLE over Fr is a tensor (8, 2**n) of
evaluations over the boolean hypercube, index bits big-endian: variable 0 is
the MSB of the index.  A pass takes its pairs through `ops.pair_halves`,
which under a cycle mesh keeps them sharded.  Binding orders:
  * HighToLow: bind the MSB variable; P'[i] = P[i] + r*(P[i+T/2]-P[i]);
  * LowToHigh: bind the LSB variable; P'[i] = P[2i] + r*(P[2i+1]-P[2i]).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..field import ops


def bind_high(P: torch.Tensor, r) -> torch.Tensor:
    """Bind the MSB variable to challenge r (a canonical int, or a
    Montgomery scalar (L, 1)): K1's bind of the two halves."""
    return ops.bind(*ops.pair_halves(P), r)


def bind_low(P: torch.Tensor, r) -> torch.Tensor:
    """Bind the LSB variable to challenge r (a canonical int, or a
    Montgomery scalar (L, 1)): K1's bind of the interleaved pairs."""
    return ops.bind(*ops.pair_halves(P, low=True), r)


def bind(P: torch.Tensor, r, order: str) -> torch.Tensor:
    """Bind the MSB variable (order "high") or the LSB variable (any other
    order) to challenge r."""
    return (bind_high if order == "high" else bind_low)(P, r)


def evaluate(P: torch.Tensor, point: Sequence[int]) -> int:
    """Evaluate the MLE at a host-side point (list of ints, point[0] = MSB
    variable): a host loop of device binds, for tests and small
    verifier-side work."""
    assert P.shape[-1] == 1 << len(point)
    for r in point:          # bind MSB first -> HighToLow over the point
        P = bind_high(P, r)
    return ops.unpack_ints(P)[0]


def sumcheck_eval_points_high(P: torch.Tensor, degree: int) -> torch.Tensor:
    """Per-index univariate evals at X in {0, 2, 3, ..., degree} for the MSB
    variable: (L, degree, T/2); entry [:, 0] is X=0, entry [:, j>=1] is
    X=j+1 (eval(X) = lo + X*(hi-lo), by repeated addition of the slope):
    K1's evals form, written straight into the output."""
    return ops.evals(*ops.pair_halves(P), degree)


def sumcheck_eval_points_low(P: torch.Tensor, degree: int) -> torch.Tensor:
    """`sumcheck_eval_points_high` for the LSB variable: the interleaved
    pairs (P[2i], P[2i+1]), (L, degree, T/2)."""
    return ops.evals(*ops.pair_halves(P, low=True), degree)


def from_ints(vals: Sequence[int], device="cuda") -> torch.Tensor:
    return ops.pack_ints(vals, device)


def from_u64_column(lo, hi, device="cuda") -> torch.Tensor:
    """Unsigned 64-bit values given as their low and high 32-bit words
    (numpy or torch, uint32 or any integer type holding those bits) ->
    Montgomery form (8, n) on `device`."""
    device = ops.resolve_device(device)

    def words(x) -> torch.Tensor:
        x = ops.host(x) if isinstance(x, torch.Tensor) else np.asarray(x)
        return ops.upload(x.astype(np.uint32).view(np.int32), device)
    return ops.from_u64(words(lo), words(hi))
