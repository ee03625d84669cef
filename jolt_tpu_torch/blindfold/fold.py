"""Nova folding of the BlindFold verifier R1CS (phase 3).

Copied from the JAX package's `blindfold/fold.py`, logic unchanged.

The real witness Z1 (u=1, E=0) folds with a RANDOM satisfying relaxed
instance (Z2, u2, E2 := Az2 o Bz2 - u2 Cz2): the random instance is a
one-time pad, so the folded witness Z' = Z1 + r Z2 reveals nothing.

Row commitments fold homomorphically; the phase-1 round commitments ARE
the real instance's coefficient-row commitments, so only the value rows,
the random instance's rows, the cross term T, and E2 need fresh Pedersen
commitments.  Reference: `crates/jolt-blindfold/src/relaxed.rs`,
`prove.rs` (cross-term + fold), Nova (eprint 2021/370).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

from ..field.params import FR
from .pedersen import PedersenBasis, pedersen_commit
from .r1cs import VerifierR1CS, matvec

P = FR.modulus


@dataclass
class CommittedGrid:
    """Row-wise Pedersen commitments to a flat vector viewed as a grid."""

    values: List[int]          # flat, len = rows*cols
    blinds: List[int]          # per row
    comms: List[object]        # per row (G1 points)
    rows: int
    cols: int


def commit_grid(basis: PedersenBasis, values: Sequence[int], rows: int,
                cols: int, rng,
                preset: dict | None = None) -> CommittedGrid:
    """Commit every row; `preset` maps row -> (blind, comm) for rows
    already committed in phase 1 (coefficient rows)."""
    basis.extend(cols)
    blinds, comms = [], []
    for i in range(rows):
        if preset and i in preset:
            rho, comm = preset[i]
        else:
            rho = rng.randrange(P)
            comm = pedersen_commit(basis, values[i * cols:(i + 1) * cols],
                                   rho)
        blinds.append(rho)
        comms.append(comm)
    return CommittedGrid(values=list(values), blinds=blinds, comms=comms,
                         rows=rows, cols=cols)


def grid_dims(m: int, cols: int) -> Tuple[int, int]:
    rows = (m + cols - 1) // cols
    r = 1
    while r < rows:
        r *= 2
    return r, cols


def cross_term(r1cs: VerifierR1CS, z1: Sequence[int], u1: int,
               z2: Sequence[int], u2: int) -> List[int]:
    """T = Az1 o Bz2 + Az2 o Bz1 - u1 Cz2 - u2 Cz1."""
    az1 = matvec(r1cs.A, r1cs.m, z1)
    bz1 = matvec(r1cs.B, r1cs.m, z1)
    cz1 = matvec(r1cs.C, r1cs.m, z1)
    az2 = matvec(r1cs.A, r1cs.m, z2)
    bz2 = matvec(r1cs.B, r1cs.m, z2)
    cz2 = matvec(r1cs.C, r1cs.m, z2)
    return [(a1 * b2 + a2 * b1 - u1 * c2 - u2 * c1) % P
            for a1, b1, c1, a2, b2, c2
            in zip(az1, bz1, cz1, az2, bz2, cz2)]


def error_of(r1cs: VerifierR1CS, z: Sequence[int], u: int) -> List[int]:
    """E := Az o Bz - u Cz (makes any (z, u) a satisfying relaxed pair)."""
    az = matvec(r1cs.A, r1cs.m, z)
    bz = matvec(r1cs.B, r1cs.m, z)
    cz = matvec(r1cs.C, r1cs.m, z)
    return [(a * b - u * c) % P for a, b, c in zip(az, bz, cz)]


def fold_vectors(v1: Sequence[int], v2: Sequence[int], r: int) -> List[int]:
    return [(a + r * b) % P for a, b in zip(v1, v2)]
