"""BlindFold verifier R1CS: the sumcheck verifier's checks as constraints.

Copied from the JAX package's `blindfold/r1cs.py`, logic unchanged.

Phase 2 (`book/src/how/blindfold.md`, `crates/jolt-blindfold/src/r1cs.rs`):
both sides deterministically build a sparse R1CS over Z = [u, W] whose
satisfiability == "every committed sumcheck round was consistent".

Layout (Hyrax grid, row-major): W is an R' x C grid.
  * rows [0, n_coeff_rows): ONE ROW PER SUMCHECK ROUND holding that
    round's compressed coefficients (c_0, c_2, .., c_d) zero-padded to C.
    Their Pedersen commitments are exactly the phase-1 round commitments.
  * rows [n_coeff_rows, R'): the claim chains (claim_0..claim_R per
    stage) packed sequentially, then zero padding.

Constraints (all linear -- Fiat-Shamir values are BAKED into matrix
coefficients, so A/B/C are identical on both sides):
  * chain start:  claim_0 - input_claim0 = 0
  * per round j:  claim_{j+1} = c_0 (1 - 2 r) + r claim_j
                              + sum_{k>=2} c_k (r^k - r)
    (the compressed poly's implied linear coefficient
     c_1 = claim_j - 2 c_0 - sum c_k is substituted, so no aux vars)
  * chain end:    claim_R - expected = 0

A linear constraint L(z) = 0 is encoded as the relaxed-R1CS row
(L(z)) * (u) = 0, i.e. A = L, B = e_u, C = 0 -- degree-2 homogeneous, so
Nova folding applies unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

from ..field.params import FR

P = FR.modulus


@dataclass
class VerifierR1CS:
    """Sparse verifier R1CS + the Hyrax grid layout of its witness."""

    A: Coo
    B: Coo
    C: Coo
    m: int                 # padded constraint count (power of two)
    n_vars: int            # 1 + R'*C
    grid_rows: int         # R'
    grid_cols: int         # C
    n_coeff_rows: int
    # (stage, round) -> grid row of its coefficient vector
    coeff_row: Dict[Tuple[int, int], int] = field(default_factory=dict)
    # (stage, j) -> flat W index of claim_j
    claim_idx: Dict[Tuple[int, int], int] = field(default_factory=dict)


def _next_pow2(n: int) -> int:
    m = 1
    while m < max(n, 1):
        m *= 2
    return m


def build_verifier_r1cs(stages: Sequence[ZkStageData]) -> VerifierR1CS:
    """Deterministic construction from the stages' PUBLIC data only
    (round counts, degrees, challenges, input claims, expected outputs)."""
    C = _next_pow2(max(s.max_degree for s in stages))
    n_coeff_rows = sum(s.max_rounds for s in stages)

    # claim-chain values live after the coefficient rows, packed row-major
    coeff_row: Dict[Tuple[int, int], int] = {}
    row = 0
    for si, s in enumerate(stages):
        for j in range(s.max_rounds):
            coeff_row[(si, j)] = row
            row += 1
    claim_idx: Dict[Tuple[int, int], int] = {}
    flat = n_coeff_rows * C
    for si, s in enumerate(stages):
        for j in range(s.max_rounds + 1):
            claim_idx[(si, j)] = flat
            flat += 1
    grid_rows = _next_pow2((flat + C - 1) // C)
    n_vars = 1 + grid_rows * C

    A: Coo = []
    B: Coo = []
    Cm: Coo = []
    con = 0

    def lin(terms: List[Tuple[int, int]]):
        """Emit linear constraint sum coeff*Z[var] = 0 (var 0 = u)."""
        nonlocal con
        for v, c in terms:
            if c % P:
                A.append((con, v, c % P))
        B.append((con, 0, 1))
        con += 1

    for si, s in enumerate(stages):
        cvar = lambda j: 1 + claim_idx[(si, j)]
        # chain start
        lin([(cvar(0), 1), (0, -s.input_claim0)])
        for j in range(s.max_rounds):
            r = s.challenges[j] % P
            base = 1 + coeff_row[(si, j)] * C
            terms = [(cvar(j + 1), 1),
                     (base + 0, -(1 - 2 * r)),        # c_0
                     (cvar(j), -r)]
            rk = r * r % P
            for k in range(2, s.max_degree + 1):
                terms.append((base + k - 1, -((rk - r) % P)))
                rk = rk * r % P
            lin(terms)
        # chain end
        assert s.final_expected is not None, "stage missing final binding"
        lin([(cvar(s.max_rounds), 1), (0, -s.final_expected)])

    m = _next_pow2(con)
    return VerifierR1CS(A=A, B=B, C=Cm, m=m, n_vars=n_vars,
                        grid_rows=grid_rows, grid_cols=C,
                        n_coeff_rows=n_coeff_rows, coeff_row=coeff_row,
                        claim_idx=claim_idx)
