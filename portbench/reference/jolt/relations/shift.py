"""Spartan shift sumcheck: PC-chaining soundness for the five `next_*`
R1CS input openings (torch counterpart of the JAX package's
`relations/shift.py`).

Reference: `crates/jolt-prover-legacy/src/zkvm/spartan/shift.rs:40-55` --
the batched identity over cycles j binding every cycle's next-row claims to
the ACTUAL next row:

    NextUnexpandedPC(r) + g*NextPC(r) + g^2*NextIsVirtual(r)
      + g^3*NextIsFirstInSequence(r) + g^4*NextIsNoop(r)
    = sum_j W'(r, j) * COL(j)

where COL = UnexpandedPC + g*PC + g^2*IsVirtual + g^3*IsFirstInSequence
+ g^4*IsNoop is the CURRENT-row combination and W' is the shifted eq
weight.  Our trace padding (tracer/trace.py padding_target) guarantees the
last padded row is a non-virtual NOOP bytecode row, so the witness
convention is uniformly  next_col(j) = col(min(j+1, T-1))  for all five
columns (r1cs_inputs.py:420-432), giving the clamped-shift weight

    W'[y] = eq(r, y-1)          for 1 <= y <= T-1   (W'[0] = 0)
          + eq(r, 1^n)          at y = T-1          (the clamp)

with the closed form  W'(rho) = EqPlusOne(rho, r) + prod(r) * prod(rho)
(split_eq.eq_plus_one_int; the reference instead zeroes next_pc at the
boundary and folds IsNoop's boundary into a (1 - IsNoop) term --
`zkvm/r1cs/inputs.rs:485-492`; the clamp form needs no special-casing).

The output claim COL(rho) is NOT trusted: it reduces to a public
bytecode-table lookup (all five current-row columns are columns of the
expanded program: relations/bytecode.py), proven in stage 6 by a
SparseOneHotTableEval instance over the SAME committed bytecode one-hot
used by the main read-raf -- closing the chain
  next_* openings -> shift sumcheck -> public table x committed ra_bc.

"""

from __future__ import annotations

from typing import List, Sequence


from ..field import FR
from ..poly.split_eq import eq_plus_one_int
from ..sumcheck.engine import SumcheckInstance

P = FR.modulus

# (stage-1 opening name of the next_* claim, bytecode table column of the
# current-row value), in gamma-power order -- shared prover/verifier
SHIFT_COLUMNS: List = [
    ("next_unexpanded_pc", "unexpanded_pc"),
    ("next_pc", "pc"),
    ("next_is_virtual", "flag_VirtualInstruction"),
    ("next_is_first_in_sequence", "flag_IsFirstInSequence"),
    ("next_is_noop", "is_noop"),
]


def shift_weight_eval_int(r_cycle: Sequence[int],
                          rho: Sequence[int]) -> int:
    """Closed-form MLE of the W' table at rho (verifier side, O(log T))."""
    r = [x % P for x in r_cycle]
    q = [x % P for x in rho]
    acc = eq_plus_one_int(q, r)          # indicator rho = r + 1
    prod_r, prod_q = 1, 1
    for x in r:
        prod_r = prod_r * x % P
    for x in q:
        prod_q = prod_q * x % P
    return (acc + prod_r * prod_q) % P


def shift_combined_claim(openings: Sequence[int], gamma: int) -> int:
    """gamma-combination of the five next_* openings (input claim)."""
    acc, g = 0, 1
    for c in openings:
        acc = (acc + g * c) % P
        g = g * gamma % P
    return acc


class ShiftVerifier(SumcheckInstance):
    """Verifier twin: terminal check W'(rho) * COL(rho)."""

    degree = 2

    def __init__(self, log_T: int, gamma: int, r_cycle: Sequence[int],
                 col_opening: int):
        self.n = log_T
        self.gamma = gamma
        self.r_cycle = [x % P for x in r_cycle]
        self.col_opening = col_opening % P

    @property
    def num_rounds(self) -> int:
        return self.n

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        return shift_combined_claim(
            [accumulator.get_claim(("r1cs_input", name))
             for name, _ in SHIFT_COLUMNS], self.gamma)

    def expected_output_claim(self, accumulator: OpeningAccumulator,
                              r: Sequence[int]) -> int:
        return (shift_weight_eval_int(self.r_cycle, list(r))
                * self.col_opening % P)
