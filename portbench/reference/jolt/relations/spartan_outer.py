"""Spartan outer sumcheck over the uniform RV64 R1CS, with univariate skip.

Torch counterpart of the JAX package's `relations/spartan_outer.py`.
Proves

    0 = sum_{k,j} weight(k) * eq(tau, j) * (Az(k,j)*Bz(k,j) - Cz(k,j))

over the constraint axis (k in [22]) and cycle axis (j in [T]), following
the reference's stage-1 shape (`zkvm/spartan/outer.rs`,
`subprotocols/univariate_skip.rs:29-131`): the 22 rows split into 2 groups
of 11, the slot-in-group index maps to the window {-5..5}, and the first
round sends ONE univariate

    s1(Y) = L(tau_high, Y) * t1(Y),        deg(s1) <= 30 (31 coeffs)

evaluated only at the 10 extrapolated targets (t1 vanishes on the window).
After the skip challenge r0 the remaining sumcheck runs 1 + log T rounds
(group bit, then cycle bits) over tensors of length 2T.

Device work: the 38 input columns lift to Montgomery form, and Az/Bz/Cz
row combos are sparse linear combinations of them, summed exactly in int64
limb planes (`ops.reduce_cols`).  Host work: transcript, Lagrange algebra,
verifier algebra.

Two tiers hold the columns, as in the JAX package, with the same bytes:
below `STREAM_THRESHOLD` cycles the whole Montgomery stack (8, 38, T)
lives on the device (32 B a value); from it on, the streaming tier keeps
only the witness words (4, 38, T) and the sign mask (38, T) there (17 B a
value, `StreamedColumns`) and lifts one `STREAM_CHUNK` of cycles at a time
for each of its three consumers: the uni-skip extended sums, the matrices
bound at Y=r0 and the 38 input openings.  `prove` / `prove_uniskip` force
a tier with the private `_stream_stage1`.
"""

from __future__ import annotations

from typing import Sequence


from ..field import FR
from ..poly import eq
from ..poly import lagrange as lag
from ..r1cs import constraints as C
from ..sumcheck.engine import SumcheckInstance
from ..witness.r1cs_inputs import NUM_VARS

P = FR.modulus

# constraint-axis geometry: 22 rows = 2 groups x 11 slots
UNISKIP_DOMAIN = 11
UNISKIP_DEGREE = 10                      # extended targets outside the window
UNISKIP_NUM_COEFFS = 3 * UNISKIP_DEGREE + 1   # deg(L * t1) <= 30
NUM_GROUPS = 2
assert C.NUM_CONSTRAINTS == NUM_GROUPS * UNISKIP_DOMAIN


def num_stage1_rounds(log_T: int) -> int:
    """Remaining-sumcheck rounds after the uni-skip first round."""
    return 1 + log_T


# ---------------------------------------------------------------------------
# device evaluation of sparse row combos
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# uni-skip first round (prover)
# ---------------------------------------------------------------------------


def verify_uniskip(coeffs: Sequence[int], transcript):
    """Verifier half of the skip round: degree bound, base-window sum = 0
    (`UniSkipFirstRoundProof::verify`), challenge + next claim."""
    from ..sumcheck.engine import SumcheckError
    if not 0 < len(coeffs) <= UNISKIP_NUM_COEFFS:
        raise SumcheckError(
            f"uniskip poly has {len(coeffs)} coeffs (max {UNISKIP_NUM_COEFFS})")
    transcript.append_scalars(b"uniskip_poly", coeffs)
    r0 = transcript.challenge_scalar_optimized()
    if lag.domain_sum(coeffs, UNISKIP_DOMAIN) != 0:
        raise SumcheckError("uniskip base-window sum is nonzero")
    return r0, lag.eval_poly(coeffs, r0)


# ---------------------------------------------------------------------------
# remaining sumcheck: 1 group round + log T cycle rounds over 2T tensors
# ---------------------------------------------------------------------------


class SpartanOuterVerifier(SumcheckInstance):
    """Verifier half: recomputes Az/Bz/Cz(r0, r_g, r_cycle) from the 38
    input openings via chi_k = l_{slot_k}(r0) * eq(r_g, g_k)."""

    def __init__(self, num_rounds: int, tau: Sequence[int], r0: int,
                 input_openings: Sequence[int], claim: int):
        self._num_rounds = num_rounds
        self.tau = list(tau)           # [tau_high, tau_g, *tau_cyc]
        self.r0 = r0 % P
        self.z = list(input_openings)
        self._claim = claim % P
        assert len(self.z) == NUM_VARS

    @property
    def num_rounds(self) -> int:
        return self._num_rounds

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        return self._claim

    def expected_output_claim(self, accumulator: OpeningAccumulator,
                              r: Sequence[int]) -> int:
        r = list(r)
        r_g = r[0]
        y_basis = lag.lagrange_basis_at(
            lag.symmetric_domain(UNISKIP_DOMAIN), self.r0)
        rows = C.all_rows()
        az = bz = cz = 0
        for k, (a, b, c) in enumerate(rows):
            g, slot = divmod(k, UNISKIP_DOMAIN)
            chi = y_basis[slot] * (r_g if g else (1 - r_g)) % P
            az = (az + chi * self._eval_lc(a)) % P
            bz = (bz + chi * self._eval_lc(b)) % P
            cz = (cz + chi * self._eval_lc(c)) % P
        # eq over (tau_g, tau_cyc) vs r, times the Lagrange kernel factor
        l_scale = lag.eval_poly(
            lag.lagrange_kernel_coeffs(self.tau[0], UNISKIP_DOMAIN), self.r0)
        eq_tau_r = eq.eq_int(self.tau[1:], r)
        return l_scale * eq_tau_r % P * ((az * bz - cz) % P) % P

    def _eval_lc(self, lc) -> int:
        return sum(coeff * self.z[v] for v, coeff in lc) % P
