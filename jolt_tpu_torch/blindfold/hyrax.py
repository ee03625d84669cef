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
from ..transcript import Blake2bTranscript
from .pedersen import PedersenBasis, msm, pedersen_commit

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


def mle_eval_host(vals: Sequence[int], point: Sequence[int]) -> int:
    cur = [v % P for v in vals]
    for r in point:
        r = r % P
        half = len(cur) // 2
        cur = [(cur[i] + r * (cur[i + half] - cur[i])) % P
               for i in range(half)]
    return cur[0]


def _bind(cur: List[int], r: int) -> List[int]:
    half = len(cur) // 2
    return [(cur[i] + r * (cur[i + half] - cur[i])) % P
            for i in range(half)]


def sumcheck_prove_host(arrays: List[List[int]], combine, degree: int,
                        claim: int, transcript: Blake2bTranscript,
                        ) -> Tuple[List[List[int]], List[int], List[int]]:
    """Generic dense host sumcheck: proves claim = sum_x combine(arrays at
    x).  Messages at X in {0, 2, .., degree}; compressed (c1 dropped).
    Returns (compressed_polys, challenges, final array values)."""
    n_rounds = (len(arrays[0])).bit_length() - 1
    cur = [list(a) for a in arrays]
    polys, rs = [], []
    prev = claim % P
    for _ in range(n_rounds):
        half = len(cur[0]) // 2
        evals = []
        for X in [0] + list(range(2, degree + 1)):
            tot = 0
            for i in range(half):
                vals = [(a[i] + X * (a[i + half] - a[i])) % P for a in cur]
                tot += combine(vals)
            evals.append(tot % P)
        poly = UniPoly.from_evals_and_hint(prev, evals, P)
        compressed = poly.compress()
        transcript.append_scalars(b"sumcheck_poly", compressed)
        r = transcript.challenge_scalar_optimized()
        rs.append(r)
        prev = poly.evaluate(r)
        cur = [_bind(a, r) for a in cur]
        polys.append(compressed)
    return polys, rs, [a[0] for a in cur]


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

def hyrax_open(values: Sequence[int], blinds: Sequence[int],
               rows: int, cols: int,
               point: Sequence[int]) -> Tuple[List[int], int]:
    """Prover: combined row  w = sum_i eq(r_row, i) row_i  and combined
    blinding, for point = (r_row || r_col), MSB-first."""
    lr = rows.bit_length() - 1
    eq_row = eq_evals_host(point[:lr])
    comb = [0] * cols
    rho = 0
    for i in range(rows):
        w = eq_row[i]
        rho = (rho + w * blinds[i]) % P
        base = i * cols
        for j in range(cols):
            comb[j] = (comb[j] + w * values[base + j]) % P
    return comb, rho


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
