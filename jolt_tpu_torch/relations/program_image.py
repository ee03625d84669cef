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

import torch

from ..field import FR, ops
from ..sumcheck.engine import OpeningAccumulator, SumcheckInstance
from .opening_reduction import DenseOpening

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


def shifted_eq_table(r_addr: Sequence[int], start_index: int,
                     m: int) -> List[int]:
    """Dense prover-side table eq(r_addr, start_index + j) for j < 2^m
    (0 where start_index + j >= 2^len(r_addr)).

    Built by aligned-subcube decomposition of [start, start + 2^m): each
    maximal aligned k-block contributes selector(high bits) * eq-table
    over its low bits -- O(2^m) total work
    (`program_image.rs:242` shifted_program_image_eq_slice)."""
    ell = len(r_addr)
    r = [x % P for x in r_addr]
    K = 1 << ell
    n = 1 << m
    out = [0] * n

    # eq tables over the s LOWEST variables of r_addr, built on demand
    low_tables: dict = {0: [1]}

    def low_table(s: int) -> List[int]:
        t = low_tables.get(s)
        if t is None:
            prev = low_table(s - 1)
            ri = r[ell - s]          # the NEW var is the highest of the s
            half = 1 << (s - 1)      # low vars -> high bit of the index
            t = [0] * (1 << s)
            for i, v in enumerate(prev):
                t[i] = v * (1 - ri) % P
                t[half + i] = v * ri % P
            low_tables[s] = t
        return t

    def selector(prefix: int, s: int) -> int:
        """prod over the ell - s HIGH variables of chi(r_i, bit_i(prefix))."""
        sel = 1
        for i in range(ell - s):
            bit = (prefix >> (ell - s - 1 - i)) & 1
            sel = sel * (r[i] if bit else (1 - r[i]) % P) % P
        return sel

    # greedy aligned decomposition of [start, min(start + n, K))
    k = start_index
    end = min(start_index + n, K)
    while k < end:
        s = 0
        while (k % (1 << (s + 1)) == 0 and k + (1 << (s + 1)) <= end
               and s + 1 <= ell):
            s += 1
        sel = selector(k >> s, s)
        t = low_table(s)
        base = k - start_index
        for i in range(1 << s):
            out[base + i] = sel * t[i] % P
        k += 1 << s
    return out


def eval_shifted_eq(r_addr: Sequence[int], start_index: int,
                    rho: Sequence[int]) -> int:
    """The shifted-eq MLE evaluated at rho (big-endian, m = len(rho)
    variables) in O(ell) field ops: a carry DP from the LSB
    (`program_image.rs:467`).  dp0/dp1 = total weight of carry-in 0/1
    states; a carry out of the top bit means start + y >= 2^ell -> no
    matching address -> dropped."""
    ell = len(r_addr)
    m = len(rho)
    assert m <= ell
    r = [x % P for x in r_addr]
    y = [x % P for x in rho]
    dp0, dp1 = 1, 0
    for lsb in range(ell):
        start_bit = (start_index >> lsb) & 1
        r_bit = r[ell - 1 - lsb]
        k0, k1 = (1 - r_bit) % P, r_bit
        if lsb < m:
            r_y = y[m - 1 - lsb]
            y_opts = ((0, (1 - r_y) % P), (1, r_y))
        else:
            y_opts = ((0, 1),)
        n0, n1 = 0, 0
        for carry_in, w in ((0, dp0), (1, dp1)):
            if w == 0:
                continue
            for y_bit, y_f in y_opts:
                tot = start_bit + carry_in + y_bit
                addr_f = k1 if (tot & 1) else k0
                contrib = w * y_f % P * addr_f % P
                if (tot >> 1) & 1:
                    n1 = (n1 + contrib) % P
                else:
                    n0 = (n0 + contrib) % P
        dp0, dp1 = n0, n1
    return dp0


class ProgramImageReduction(DenseOpening):
    """Prover instance: claim = sum_j shifted_eq[j] * image[j], reducing
    to an opening of the committed image polynomial at the bound point:
    a `DenseOpening` of the image words whose first factor is the
    shifted-eq slice."""

    def __init__(self, words: Sequence[int], r_addr: Sequence[int],
                 start_index: int, claim: int, device="cuda"):
        m = (len(words) - 1).bit_length() if len(words) > 1 else 0
        assert len(words) == 1 << m
        weights = ops.pack_ints(shifted_eq_table(r_addr, start_index, m),
                                torch.device(device))
        super().__init__(list(words), [0] * m, claim, "program_image",
                         device, weights=weights)

    def cache_openings(self, accumulator: OpeningAccumulator,
                       r_slice: Sequence[int]) -> None:
        accumulator.insert(("program_image", "init"), list(r_slice),
                           self.final_openings["p"])


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

    @property
    def num_rounds(self) -> int:
        return self.m

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        return self.claim

    def message_evals_dev(self, round):  # pragma: no cover
        raise NotImplementedError("verifier instance")

    def ingest_challenge(self, r, round):  # pragma: no cover
        raise NotImplementedError("verifier instance")

    def expected_output_claim(self, accumulator: OpeningAccumulator,
                              r: Sequence[int]) -> int:
        rho = [x % P for x in r]
        return eval_shifted_eq(self.r_addr, self.start_index,
                               rho) * self.opening % P
