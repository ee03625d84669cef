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

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..field import FR, ops
from ..poly import eq
from ..poly.split_eq import eq_plus_one_int
from ..sumcheck.engine import OpeningAccumulator, SumcheckInstance
from ..sumcheck.product import ProductRounds

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


def shift_weight_evals(r_cycle: Sequence[int],
                       device="cuda") -> torch.Tensor:
    """Device table W' over cycles: the eq table of r_cycle shifted down by
    one slot with the last entry clamped (accumulating eq(r, T-1))."""
    E = eq.evals([x % P for x in r_cycle], device)
    zero = torch.zeros_like(E[:, :1])
    W = torch.cat([zero, E[:, :-1]], dim=1)
    # clamp: W'[T-1] += E[T-1]
    last = ops.add(W[:, -1:], E[:, -1:])
    return torch.cat([W[:, :-1], last], dim=1)


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


def shift_column_values(bc_table, pc_idx: Sequence[int],
                        gamma: int) -> List[int]:
    """Prover-side COL stream: the gamma-combined current-row columns,
    computed as the public-table lookup TAB_shift[pc_idx[j]] so the shift
    output claim and the stage-6 bytecode instance agree by construction."""
    from .bytecode import combined_table
    K = len(bc_table["pc"])
    tab = combined_table(bc_table, 0, K, gamma, SHIFT_COLUMNS)
    tab_np = np.asarray(tab, dtype=object)
    return [int(v) for v in tab_np[np.asarray(pc_idx, dtype=np.int64)]]


class ShiftSumcheck(SumcheckInstance):
    """Prover instance: sum_j W'(r_cycle, j) * COL(j), degree 2, log T
    rounds, HighToLow: a two-factor product sumcheck of (W', COL), whose
    rounds run on K2 (`ProductRounds`: one pass per round binds at r_j and
    forms round j + 1's evals at X in {0, 2})."""

    degree = 2

    def __init__(self, col_values: Sequence[int], r_cycle: Sequence[int],
                 gamma: int, device="cuda"):
        self.n = len(r_cycle)
        assert len(col_values) == 1 << self.n
        self.gamma = gamma
        self.device = torch.device(device)
        self.rounds = ProductRounds((shift_weight_evals(r_cycle, self.device),
                                     ops.pack_ints(col_values, self.device)))
        self.final_openings: Optional[dict] = None

    @property
    def num_rounds(self) -> int:
        return self.n

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        return shift_combined_claim(
            [accumulator.get_claim(("r1cs_input", name))
             for name, _ in SHIFT_COLUMNS], self.gamma)

    def message_evals_dev(self, round: int):
        return self.rounds.message()

    def ingest_challenge(self, r: int, round: int) -> None:
        self.rounds.bind(r)

    def finalize(self) -> None:
        _, cols = self.rounds.flush()
        self.final_openings = {"cols": ops.unpack_ints(cols)[0]}

    def cache_openings(self, accumulator: OpeningAccumulator,
                       r_slice: Sequence[int]) -> None:
        accumulator.insert(("shift", "cols"), list(r_slice),
                           self.final_openings["cols"])

    def expected_output_claim(self, accumulator, r):  # pragma: no cover
        raise NotImplementedError


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

    def message_evals_dev(self, round):  # pragma: no cover
        raise NotImplementedError("verifier instance")

    def ingest_challenge(self, r, round):  # pragma: no cover
        raise NotImplementedError("verifier instance")

    def expected_output_claim(self, accumulator: OpeningAccumulator,
                              r: Sequence[int]) -> int:
        return (shift_weight_eval_int(self.r_cycle, list(r))
                * self.col_opening % P)
