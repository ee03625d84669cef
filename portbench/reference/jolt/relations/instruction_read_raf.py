"""Instruction-execution Shout: the read + raf batched sumcheck over the
2^128 lookup-index space (stage 5i).

Torch counterpart of the JAX package's `relations/instruction_read_raf.py`
(reference: `zkvm/instruction_lookups/read_raf_checking.rs:68-133` and
`poly/prefix_suffix.rs`).  Statement proved, for the stage-1 opening point
r_cycle and gamma drawn at stage start:

  rv + g*left_op + g^2*right_op
    = sum_{j, k} eq(j; r_cycle) * ra(k, j) * (Val_j(k) + g*RafVal_j(k))

where k ranges over 2^128, ra(k,j) = prod_i ra_i(k_i, j) factors into D=16
committed one-hot 8-bit chunk selectors, Val_j(k) is the lookup-table MLE
selected by cycle j's instruction (0 if none), and

  RafVal_j(k) = (1-raf_j) * (Left(k) + g*Right(k)) + raf_j * g * Identity(k)

ties the one-hot index to the R1CS lookup-operand columns (raf_j = 1 on the
non-interleaved add/sub/mul path).

Prover structure:
  * the first LOG_K = 128 address rounds are host algebra, copied
    unchanged: per round the message and bind of ~13 aggregated prefix
    tables of <= 256 entries, and the incremental prefix checkpoints.  The
    engine takes their round polynomials from `compute_message`.
  * the 16 phase rebuilds are O(T) device work (`_suffix_tables`): the u64
    suffix closed forms are evaluated on the host (vectorized numpy,
    `lookups/suffix_vec.py`, on a thread pool), uploaded as raw words, and
    weighted, segment-summed by chunk value and aggregated per prefix family
    by K1 (`ops.mont_mul`, `ops.segment_sum_mod`, `ops.sum_mod`).
  * the last log_T cycle rounds: one stacked device tensor (L, 18, T)
    holding [eq, combined_val, ra_0..ra_15]; a round's message is
    `sumcheck.product.stack_message` of degree 18, its bind one
    `dense.bind_high` of the stack (one K1 launch).

Output claims: InstructionRa(i) openings (committed chunk polys),
LookupTableFlag(t) and raf-flag virtual openings at the cycle point
(proven against the public bytecode by the stage-6 flags instance).
"""

from __future__ import annotations

from typing import Sequence


from ..field import FR
from ..lookups import tables as LT
from ..poly import eq
from ..sumcheck.engine import SumcheckInstance
from ..witness.instruction_lookups import D

P = FR.modulus
LOG_K = LT.LOG_K  # 128

# every prefix family the table set + raf paths use
_ALL_PREFIXES = sorted(set(
    [p for t in LT.TABLES.values() for _, p, _ in t["terms"]]
    + ["left", "right", "id", "one"]))


class InstructionReadRafVerifier(SumcheckInstance):
    degree = D + 2

    def __init__(self, log_T: int, gamma: int, r_cycle: Sequence[int],
                 rv_claim: int, left_claim: int, right_claim: int,
                 openings: dict):
        """openings: ra0..ra{D-1}, flag_<TableName> per table, raf_flag."""
        self.log_T = log_T
        self.gamma = gamma % P
        self.g2 = gamma * gamma % P
        self.r_cycle = [x % P for x in r_cycle]
        self.claims = (rv_claim % P, left_claim % P, right_claim % P)
        self.openings = openings

    @property
    def num_rounds(self) -> int:
        return LOG_K + self.log_T

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        rv, lo, ro = self.claims
        return (rv + self.gamma * lo + self.g2 * ro) % P

    def expected_output_claim(self, accumulator: OpeningAccumulator,
                              r: Sequence[int]) -> int:
        r_addr = [x % P for x in r[:LOG_K]]
        r_cyc2 = [x % P for x in r[LOG_K:]]
        o = self.openings
        states = LT.fold_prefixes(r_addr, _ALL_PREFIXES)
        pvals = {n: LT.PREFIXES[n].value(s) for n, s in states.items()}
        empty = LT.suffix_values(0, 0)
        val = 0
        for name in LT.TABLE_NAMES:
            val = (val + o[f"flag_{name}"]
                   * LT.table_value_from_parts(name, pvals, empty)) % P
        raf = o["raf_flag"] % P
        il = (1 - raf) % P
        val = (val
               + il * ((self.gamma * pvals["left"]
                        + self.g2 * pvals["right"]) % P)
               + raf * (self.g2 * pvals["id"] % P)) % P
        ra_prod = 1
        for i in range(D):
            ra_prod = ra_prod * (o[f"ra{i}"] % P) % P
        return (eq.eq_int(self.r_cycle, r_cyc2) * ra_prod % P * val % P)
