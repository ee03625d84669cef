"""Grouped one-hot sumcheck relations: many matrices / claims, ONE instance.

Torch counterpart of the JAX package's `relations/grouped_onehot.py`
(reference: `subprotocols/booleanity.rs`, `zkvm/ram/hamming_booleanity.rs`,
`poly/opening_proof.rs`).  Stages 7 (booleanity + Hamming weight over every
one-hot access matrix) and 8 (opening reduction of every committed-poly
claim) group m matrices of one (K, T) into one instance by a gamma-RLC
drawn after all points and claims are fixed:

    combined_claim = sum_q gamma^q claim_q
    message(X)     = sum_q gamma^q message_q(X)

Per matrix q, with index stream c_q (M_q(k, j) = [c_q(j) = k]), cycle
table w (every member shares one: stage 7's eq tables per kind, stage 8's
per (K, point) group) and address point q_addr (or none, for the Hamming
weight):

    value:       claim_q = sum_{k,j} eq(q_addr, k) w(j) M_q(k, j)
    booleanity:  0       = sum_{k,j} eq(q_addr, k) w(j) (M_q^2 - M_q)

over log_K address rounds (MSB first) then log_T cycle rounds (HighToLow).

The JAX package works each address round over (L, M, T) arrays: per cycle
j the running products U(c_j) = prod_{i<b} chi(rho_i, bit_i(c_j)) and
suffix weights S(c_j) = prod_{i>b} chi(q_i, bit_i(c_j)), a select and
4-7 field ops per message point.  Every per-cycle factor there depends on
j only through c_j, so the port folds the cycles into the K addresses
once, H_q(k) = sum_{j: c_q(j) = k} w(j) (one integer scatter-add and one
K1 reduce), and runs the address rounds over (L, M, K):

    value:       msg_b(X) = A_q chiX_q(X) sum_k H_q S_q U chi(X, bit_b(k))
    booleanity:  msg_b(X) = A_q chiX_q(X) sum_k H_q S_q (t^2 - t),
                                               t = U chi(X, bit_b(k))

The port keeps the products G = H S U (and H S U^2 for booleanity) over
(L, M, K) and multiplies them a round by chi(rho_b, bit_b(k)) (squared
for U^2) over chi(q_{b+1}, bit_{b+1}(k)): U takes the new challenge and S
is divided as the JAX package divides it (no point coordinate in {0, 1}).
What does not depend on the challenges is made once, before the first
round, and uploaded in one copy, as the JAX package's scan hooks do: per
round the static part of the message coefficient, chiX_q(X) = chi(q_b, X)
times chi(X, bit), per (point, kind, member, bit b of k); the inverses
of chi(q_{b+1}, 0/1); and the affine chi_q(r) = c0 + c1 r of each
member's address factor (as its two ends chi(q_b, 0), chi(q_b, 1)).  What
does depend on them runs on the device from the challenge, an int by
value or the device tier's device scalar: (1 - r, r) (one K1 bind), its
square, A_q *= chi_q(r) (a bind and a product over the M members), the
coefficients A_q times their static part, and G's update.  An address
round's message is 3 K1 launches on (L, M, K), K <= 256, for the same
field values as the JAX package's.  U itself is needed once, at the end
of the address phase: eq(rho, k) over the K addresses (`eq.evals` of the
address challenges).

After the last address round the cycle phase starts from E = w and
V_q(j) = U(c_q(j)) (one gather, (L, M, T)).  The value kind's message is
linear in V, so it runs as a 2-factor product on K2 (`ProductRounds`):
of A_0 w and V_0 for one member, else of w and V_c = sum_q A_q V_q with
the V stack bound on K1 for the members' openings.  Booleanity's message
(V^2 - V) runs on the V stack through K1 (evals, products, one reduce
with the A_q as its scale).

Nothing in a round waits for the card, so `GroupedOneHot` is a
`FusedInstance` and its stages (7 and 8) run on the device tier
(`sumcheck/fused.py`), the counterpart of the JAX package's scan hooks;
its finals are the bound V_q, the members' openings.
"""

from __future__ import annotations

from typing import Sequence


from ..field import FR
from ..sumcheck.engine import SumcheckInstance

P = FR.modulus


# ---------------------------------------------------------------------------
# verifier twin
# ---------------------------------------------------------------------------

class GroupedOneHotVerifier(SumcheckInstance):
    """Verifier twin: expected = sum_q gamma^q expected_q with the
    per-matrix openings m_q taken from the proof."""

    def __init__(self, M: int, log_K: int, log_T: int, w_evals, q_addrs,
                 claims, gamma: int, m_openings, booleanity: bool = False):
        """w_evals: per-matrix CALLABLE r_cyc -> eq-table evaluation at the
        bound cycle point (host int), or a precomputed host int table
        closure; q_addrs as in the prover (None = no address factor)."""
        self.M = M
        self.log_K, self.log_T = log_K, log_T
        self.degree = 3 if booleanity else 2
        self.booleanity = booleanity
        self.w_evals = w_evals
        self.q_addrs = q_addrs
        self._claims = [c % P for c in claims]
        self.gamma = gamma % P
        self.m_openings = [m % P for m in m_openings]

    @property
    def num_rounds(self) -> int:
        return self.log_K + self.log_T

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        acc, gam = 0, 1
        for c in self._claims:
            acc = (acc + gam * c) % P
            gam = gam * self.gamma % P
        return acc

    def expected_output_claim(self, accumulator: OpeningAccumulator,
                              r: Sequence[int]) -> int:
        r_addr = [x % P for x in r[:self.log_K]]
        r_cyc = [x % P for x in r[self.log_K:]]
        total, gam = 0, 1
        for q, wf, m in zip(self.q_addrs, self.w_evals, self.m_openings):
            a = 1
            if q is not None:
                for qi, ri in zip(q, r_addr):
                    a = a * ((qi * ri + (1 - qi) * (1 - ri)) % P) % P
            w = wf(r_cyc)
            inner = (m * m - m) % P if self.booleanity else m
            total = (total + gam * a % P * w % P * inner) % P
            gam = gam * self.gamma % P
        return total
