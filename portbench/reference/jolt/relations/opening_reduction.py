"""Joint batched-opening reduction: reduce every terminal committed-poly
claim (polys of different sizes, opened at different points) to openings of
all polynomials at ONE common point (stage 8).

Torch counterpart of the JAX package's `relations/opening_reduction.py`
(reference: `crates/jolt-openings/src/lib.rs:12-19`, `zkvm/prover.rs:
2097-2260`).  Per dense claim (P, q, v) one instance proves
    v = sum_x eq(q, x) * P(x);
the one-hot claims go through `grouped_onehot.GroupedOneHot`.  After the
shared challenges r* the verifier checks eq(q, r*_suffix) * P(r*_suffix)
against the running claim and scales each opening by the zero-padding
embedding factor prod_{j < max-n} (1 - r*_j) for the joint PCS opening
(with Dory, ROADMAP A11).  One-hot polynomials are committed
address-major (index = k*T + j).

`DenseOpening`'s round is the JAX package's `booleanity._ham_cycle_kernel`
(eq times P at degree 2, both bound HighToLow), which is K2's 2-factor
product round: `DenseOpening` is a `sumcheck.product.ProductSumcheck` of
[eq(q, .), P], a `FusedInstance` that takes the device tier in stage 8.
`SparseOneHotOpening` opens a one-hot matrix from its index stream with
the address and cycle rounds of `booleanity._OneHotRounds` (the Hamming
kind's, times the point's address factor), also a `FusedInstance`.
"""

from __future__ import annotations

from typing import List, Sequence


from ..field import FR
from ..poly import eq
from ..sumcheck.engine import SumcheckInstance

P = FR.modulus


def cycle_major_to_address_major_point(point: Sequence[int],
                                       log_T: int) -> List[int]:
    """Relation sumchecks produce (r_cycle ++ r_addr) opening points over
    cycle-major arrays; the same evaluation over the address-major committed
    layout is at (r_addr ++ r_cycle)."""
    return list(point[log_T:]) + list(point[:log_T])


class OpeningReductionVerifier(SumcheckInstance):
    """Verifier twin for both sparse and dense reduction instances."""

    degree = 2

    def __init__(self, num_vars: int, point: Sequence[int], claim: int,
                 p_opening: int):
        self.n = num_vars
        self.q = [x % P for x in point]
        self.claim = claim % P
        self.p_opening = p_opening % P

    @property
    def num_rounds(self) -> int:
        return self.n

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        return self.claim

    def expected_output_claim(self, accumulator: OpeningAccumulator,
                              r: Sequence[int]) -> int:
        return eq.eq_int(self.q, list(r)) * self.p_opening % P


def embedding_factor(r_star: Sequence[int], num_vars: int) -> int:
    """Zero-padding embedding: a 2^n-coefficient poly inside the
    2^max space evaluates at r* to P(r*[-n:]) * prod_high (1 - r*_j)."""
    acc = 1
    for rj in r_star[:len(r_star) - num_vars]:
        acc = acc * ((1 - rj) % P) % P
    return acc
