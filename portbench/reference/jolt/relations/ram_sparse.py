"""Sparse Twist RAM and register relations: O(T + K) memory, no dense
K x T arrays.

Torch counterpart of the host-engine tier of the JAX package's
`relations/ram_sparse.py` (reference: the sorted sparse read/write matrices
of `subprotocols/read_write_matrix/mod.rs`, `ram.rs` RamCycleMajorEntry, and
the phase structure of `zkvm/ram/read_write_checking.rs`):

  * cycle phase (first log T rounds, LSB-first binding): the K x T matrices
    ra(k,j) / Val(k,j) are represented by one entry per ACCESS (here: one
    per cycle, since idle cycles access the dummy cell k=0).  Binding the
    cycle LSB pairs entries in the same column at adjacent rows; a missing
    partner's implicit coefficients are ra = 0 and Val = the value CARRIED
    between accesses (Val is constant within a column between accesses), so
    each entry tracks the u64 `prev`/`next` carried values exactly as the
    reference's `prev_val`/`next_val`.  Entry count never exceeds T.
  * address phase (last log K rounds, MSB-first binding on dense O(K)
    tensors): after all cycle variables bind, at most one entry per column
    survives; ra / Val materialize as K-length vectors (untouched columns
    keep ra = 0, Val = Init(k)) and the remaining rounds run dense.

The pairing pattern over all rounds depends only on the access positions,
NOT on the challenges, so the whole merge schedule precomputes on the host
with numpy (`RamPairSchedule`, logic unchanged) and uploads its index
tensors and implicit-Val fills to the device once, when it is built;
per-round device work is gathers + field ops over at most T lanes, and
every Fr op goes through K1 (gamma powers by value; the challenge by
value on the host engine, as a device scalar on the device tier).

Every relation here is a `FusedInstance` (the counterpart of the JAX
package's scan hooks): nothing in a round's message or bind reads a
value back or copies to or from the host -- the address phase's tables
and the public per-column constants are made before the first round --
so a stage of them runs on the device tier (`sumcheck/fused.py`), its
finals (`final_tensors`) fetched with the stage's one copy.

Relations (all degree <= 3):
  registers rw:  sum eq(r_cyc,j) [wa (inc + Val) + (g ra1 + g^2 ra2) Val]
  registers val: sum LT(j,r_cyc) inc(j) wa(k,j) eqA(r_addr,k)
  RAM rw:        sum eq(r_cyc,j) ra(k,j) ((1+g) Val(k,j) + g inc(j))
  RAM raf:       sum eq(r_cyc,j) ra(k,j) A(k)          (A public affine)
  RAM val eval:  sum LT(j,r_cyc) inc(j) ra(k,j) eqA(r_addr,k)
  output check:  sum inc(j) ra(k,j) W(k)               (W public sparse)
  one-hot table: sum eq(r_cyc,j) M(k,j) TAB(k)         (TAB public dense:
                 the register rafs and the bytecode read-raf of stage 6)

In the address phase every relation's remaining sum carries one fully bound
cycle factor (EQ[:, :1], LT*INC or INC[:, :1]).  The JAX host engine scales
the host evals by it (a `post` hook); here the message's mod-p finish (K1's
reduce form) multiplies it in on the device.  Both are exact mod p, so the
proof bytes are the same.

Opening points are normalized to the canonical big-endian cycle-major
order (r_cycle ++ r_addr): cycle challenges arrive LSB-first and reverse;
address challenges arrive MSB-first and keep their order.
"""

from __future__ import annotations

from typing import Sequence


from ..field import FR
from ..poly import eq, lt
from ..sumcheck.engine import SumcheckInstance
from ..witness.registers import LOG_K as REG_LOG_K
from .ram import (RamOutputCheckVerifier, RamRafEvaluationVerifier,
                  RamReadWriteCheckingVerifier, RamValEvaluationVerifier,
                  addr_mle_eval, init_mle_eval)
from .registers_rw import index_mle_eval

P = FR.modulus


# ---------------------------------------------------------------------------
# host-side pair schedule
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# device round work
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# shared prover base
# ---------------------------------------------------------------------------


def _norm_split(r: Sequence[int], log_T: int):
    """Raw LSB-first cycle + MSB-first address challenges -> big-endian."""
    return list(reversed(r[:log_T])), list(r[log_T:])


# ---------------------------------------------------------------------------
# the four RAM relations
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# generic one-hot x public-table relation (registers raf, bytecode read-raf)
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# registers: read/write checking (3 ports) + Val evaluation
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# verifier twins: the dense twins' algebra, LSB-first cycle order
# ---------------------------------------------------------------------------

class _SparseNorm:
    def _split(self, r: Sequence[int]):
        return _norm_split(r, self.log_T)


class SparseRamReadWriteCheckingVerifier(_SparseNorm,
                                         RamReadWriteCheckingVerifier):
    def expected_output_claim(self, accumulator: OpeningAccumulator,
                              r: Sequence[int]) -> int:
        r_cyc, _ = self._split(r)
        o = self.openings
        g = self.gamma
        term = ((1 + g) * o["val"] + g * o["inc"]) % P
        return eq.eq_int(self.r_cycle, r_cyc) * o["ra"] % P * term % P


class SparseRamRafEvaluationVerifier(_SparseNorm, RamRafEvaluationVerifier):
    def expected_output_claim(self, accumulator: OpeningAccumulator,
                              r: Sequence[int]) -> int:
        r_cyc, r_addr = self._split(r)
        a_eval = addr_mle_eval(r_addr, self.witness_base)
        return (eq.eq_int(self.r_cycle, r_cyc) * self.openings["ra"] % P
                * a_eval % P)


class SparseRamValEvaluationVerifier(_SparseNorm, RamValEvaluationVerifier):
    def expected_output_claim(self, accumulator: OpeningAccumulator,
                              r: Sequence[int]) -> int:
        r_cyc_new, r_addr_new = self._split(r)
        o = self.openings
        lt_eval = lt.lt_point_int(r_cyc_new, self.r_cyc)
        eq_addr = eq.eq_int(self.r_addr, r_addr_new)
        return lt_eval * eq_addr % P * o["ra"] % P * o["inc"] % P


class SparseRamOutputCheckVerifier(_SparseNorm, RamOutputCheckVerifier):
    def expected_output_claim(self, accumulator: OpeningAccumulator,
                              r: Sequence[int]) -> int:
        _, r_addr = self._split(r)
        w_eval = init_mle_eval(self.w_sparse, r_addr)
        o = self.openings
        return w_eval * o["ra"] % P * o["inc"] % P


class _SparseVerifier(_SparseNorm, SumcheckInstance):
    degree = 3

    @property
    def num_rounds(self) -> int:
        return self.log_T + self.log_K


class SparseRegistersReadWriteCheckingVerifier(_SparseVerifier):
    def __init__(self, log_T: int, gamma: int, r_cycle: Sequence[int],
                 claims: Sequence[int], openings: dict):
        self.log_T = log_T
        self.log_K = REG_LOG_K
        self.gamma = gamma
        self.r_cycle = list(r_cycle)
        self.claims = list(claims)
        self.openings = openings

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        rd, rs1, rs2 = self.claims
        return (rd + self.gamma * rs1 + self.gamma * self.gamma % P * rs2) % P

    def expected_output_claim(self, accumulator: OpeningAccumulator,
                              r: Sequence[int]) -> int:
        r_cyc, _ = self._split(r)
        o = self.openings
        g, g2 = self.gamma, self.gamma * self.gamma % P
        inner = (o["wa"] * ((o["inc"] + o["val"]) % P)
                 + g * o["ra1"] % P * o["val"]
                 + g2 * o["ra2"] % P * o["val"]) % P
        return eq.eq_int(self.r_cycle, r_cyc) * inner % P


class SparseRegistersValEvaluationVerifier(_SparseVerifier):
    def __init__(self, log_T: int, r_addr: Sequence[int],
                 r_cyc: Sequence[int], val_claim: int, openings: dict):
        self.log_T = log_T
        self.log_K = REG_LOG_K
        self.r_addr = list(r_addr)
        self.r_cyc = list(r_cyc)
        self.val_claim = val_claim
        self.openings = openings

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        return self.val_claim % P

    def expected_output_claim(self, accumulator: OpeningAccumulator,
                              r: Sequence[int]) -> int:
        r_cyc_new, r_addr_new = self._split(r)
        o = self.openings
        lt_eval = lt.lt_point_int(r_cyc_new, self.r_cyc)
        eq_addr = eq.eq_int(self.r_addr, r_addr_new)
        return lt_eval * eq_addr % P * o["wa"] % P * o["inc"] % P


class SparseRegistersRafVerifier(_SparseVerifier):
    def __init__(self, log_T: int, r_cycle, index_claim: int,
                 m_opening: int):
        self.log_T = log_T
        self.log_K = REG_LOG_K
        self.r_cycle = list(r_cycle)
        self.index_claim = index_claim
        self.m_opening = m_opening

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        return self.index_claim % P

    def expected_output_claim(self, accumulator: OpeningAccumulator,
                              r: Sequence[int]) -> int:
        r_cyc, r_addr = self._split(r)
        return (eq.eq_int(self.r_cycle, r_cyc) * self.m_opening % P
                * index_mle_eval(r_addr) % P)


class SparseBytecodeReadRafVerifier(_SparseVerifier):
    def __init__(self, log_T: int, log_K: int, gamma: int,
                 r_cycle: Sequence[int], claims: Sequence[int],
                 program, openings: dict, columns=None):
        self.log_T, self.log_K = log_T, log_K
        self.gamma = gamma
        self.r_cycle = list(r_cycle)
        self.claims = list(claims)
        self.program = program
        self.openings = openings
        self.columns = columns

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        acc, g = 0, 1
        for c in self.claims:
            acc = (acc + g * c) % P
            g = g * self.gamma % P
        return acc

    def expected_output_claim(self, accumulator: OpeningAccumulator,
                              r: Sequence[int]) -> int:
        from .bytecode import combined_table_eval
        r_cyc, r_addr = self._split(r)
        tab_eval = combined_table_eval(self.program, 1 << self.log_K,
                                       self.gamma, r_addr, self.columns)
        return (eq.eq_int(self.r_cycle, r_cyc) * self.openings["ra"] % P
                * tab_eval % P)
