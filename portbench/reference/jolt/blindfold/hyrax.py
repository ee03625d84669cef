"""Hyrax-style grid openings + the host Spartan sumchecks over the folded
relaxed R1CS (phases 4-6 of BlindFold).

Copied from the JAX package's `blindfold/hyrax.py`, logic unchanged;
`hyrax_verify`'s row combination is `pedersen.msm` (the native
library).  `mle_eval_host` also serves the prover's advice openings.

Everything here runs on HOST field ints: the verifier R1CS is tiny
(m ~ 2^9..2^12), far below the crossover where the device field kernels
pay for their dispatch.  Reference: `crates/jolt-blindfold/src/prove.rs`,
`verify.rs`; Hyrax (eprint 2017/1132) for the row-combination opening.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


from ..field.params import FR
from ..poly.univariate import UniPoly
from ..sumcheck.engine import SumcheckError
from .pedersen import msm, pedersen_commit

P = FR.modulus


# ---------------------------------------------------------------------------
# host MLE helpers (dense int lists, MSB-first variable order)
# ---------------------------------------------------------------------------

def eq_evals_host(point: Sequence[int]) -> List[int]:
    tab = [1]
    for r in point:
        r = r % P
        nxt = []
        for w in tab:
            wr = w * r % P
            nxt.append((w - wr) % P)
            nxt.append(wr)
        tab = nxt
    return tab


def sumcheck_verify_host(compressed_polys: Sequence[Sequence[int]],
                         claim: int, degree: int,
                         transcript: Blake2bTranscript,
                         ) -> Tuple[int, List[int]]:
    """Replays the rounds; returns (final claim, challenges)."""
    cur = claim % P
    rs = []
    for compressed in compressed_polys:
        if len(compressed) == 0 or len(compressed) > degree:
            raise SumcheckError("blindfold: round degree out of bounds")
        poly = UniPoly.decompress(list(compressed), cur)
        transcript.append_scalars(b"sumcheck_poly", list(compressed))
        r = transcript.challenge_scalar_optimized()
        rs.append(r)
        cur = poly.evaluate(r)
    return cur, rs


# ---------------------------------------------------------------------------
# Hyrax opening
# ---------------------------------------------------------------------------


def hyrax_verify(comms: Sequence[object], basis: PedersenBasis,
                 point: Sequence[int], comb: Sequence[int],
                 rho: int) -> int:
    """Verifier: check sum_i eq(r_row,i) C_i == Ped(comb, rho); return the
    implied evaluation sum_j eq(r_col, j) comb_j.  Raises on mismatch."""
    rows = len(comms)
    cols = len(comb)
    lr = rows.bit_length() - 1
    eq_row = eq_evals_host(point[:lr])
    lhs = msm(list(comms), eq_row)
    rhs = pedersen_commit(basis, list(comb), rho)
    if lhs != rhs:
        raise ValueError("hyrax: row-combination commitment mismatch")
    eq_col = eq_evals_host(point[lr:])
    return sum(e * c for e, c in zip(eq_col, comb)) % P
