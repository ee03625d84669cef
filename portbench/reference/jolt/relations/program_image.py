"""Committed program-image (initial RAM) claim reduction.

Torch counterpart of the JAX package's `relations/program_image.py`
(reference: committed-bytecode mode, `zkvm/claim_reductions/
program_image.rs`, `zkvm/prover.rs:2633`): the program image's
contribution to `Val_init(r_address)` is supplied by the prover as a
SCALAR claim instead of the verifier re-evaluating the sparse initial
image.  A dedicated sumcheck binds the scalar to an opening of the dense
committed program-image words polynomial:

    claim = sum_{j < 2^m} shifted_eq[j] * image[j],
    shifted_eq[j] = eq(r_addr, start_index + j)   (0 past 2^log_K)

with the image opening joining the stage-8 joint Dory reduction.  The
verifier's per-proof image work is O(log K): the shifted-eq MLE at the
bound point via a carry DP (`program_image.rs:467`), plus a commitment
check cached per program and setup.

`image_words`, `shifted_eq_table`, `eval_shifted_eq` and
`ProgramImageReductionVerifier` are host code copied with their logic
unchanged.  `ProgramImageReduction` is a `DenseOpening` whose first factor
is the shifted-eq table instead of an eq table: a 2-factor product
sumcheck on K2.
"""

from __future__ import annotations

from typing import List, Sequence


from ..field import FR
from ..sumcheck.engine import SumcheckInstance

P = FR.modulus


def image_words(code: bytes) -> List[int]:
    """The committed polynomial's coefficients: one dword per 8 code
    bytes, zero-padded to a power of two (>= 1)."""
    n = (len(code) + 7) // 8
    m = 1
    while m < n:
        m *= 2
    out = []
    for i in range(m):
        out.append(int.from_bytes(code[8 * i:8 * i + 8].ljust(8, b"\x00"),
                                  "little"))
    return out


class ProgramImageReductionVerifier(SumcheckInstance):
    """Verifier twin: expected final claim =
    eval_shifted_eq(r_addr, start, rho) * image_opening."""

    degree = 2

    def __init__(self, m: int, r_addr: Sequence[int], start_index: int,
                 claim: int, image_opening: int):
        self.m = m
        self.r_addr = [x % P for x in r_addr]
        self.start_index = start_index
        self.claim = claim % P
        self.opening = image_opening % P
