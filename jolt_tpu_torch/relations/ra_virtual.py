"""ra virtualization: tie a full one-hot access matrix's opening to its
d committed 8-bit chunk sub-selectors (stage 6v).

Torch counterpart of the JAX package's `relations/ra_virtual.py`
(reference: `zkvm/ram/ra_virtual.rs` / `zkvm/instruction_lookups/
ra_virtual.rs` and the committed id space `RamRa(i)` / `BytecodeRa(i)`,
`zkvm/witness.rs:24-74`) -- the reference NEVER commits a one-hot wider
than 256 rows (`poly/one_hot_polynomial.rs:107` asserts K <= 256); wide
address spaces (RAM, bytecode) are committed as d = ceil(log K / 8) chunk
selectors and the full ra is a VIRTUAL polynomial tied to them by this
sumcheck:

    ra(r_addr, r_cycle) = sum_j eq(r_cycle, j) * prod_i ra_i(b_i(r_addr), j)

where b_i splits r_addr into blocks (block 0 carries log K - 8(d-1) vars,
the rest 8), using eq(r_addr, k) = prod_i eq(b_i(r_addr), chunk_i(k)).
The bound per-factor values ARE the committed chunk matrices' openings at
(r_cycle', block point) -- each chunk matrix is committed at its natural
width 2^w_i, so opening points are the bare block slices.

One instance per accumulated full-ra claim; instances across matrices and
claim points batch into one stage.  The d + 1 factors [eq, ra_0..ra_{d-1}]
form a degree-(d+1) HighToLow product sumcheck, so `RaVirtual` is a
`sumcheck.product.ProductSumcheck`: with d + 1 <= 3 factors (every
instance of the main path: RAM and bytecode spaces of 9-16 address bits)
its rounds run on K2, with more on the factor stack through K1.  As a
`ProductSumcheck` it is a `FusedInstance`: with d + 1 <= 3 its stage takes
the device tier (`sumcheck/fused.py`), the counterpart of the JAX
package's scan hooks.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..field import FR, ops
from ..poly import eq
from ..sumcheck.engine import OpeningAccumulator, SumcheckInstance
from ..sumcheck.product import ProductSumcheck

P = FR.modulus


def d_chunks(log_K: int) -> int:
    """Number of committed 8-bit chunk selectors for a log_K-bit space."""
    return max(1, (log_K + 7) // 8)


def block_widths(log_K: int) -> List[int]:
    """Variable counts per chunk block (block 0 may be narrower)."""
    d = d_chunks(log_K)
    return [log_K - 8 * (d - 1)] + [8] * (d - 1)


def chunk_streams(indices: np.ndarray, log_K: int) -> List[np.ndarray]:
    """Per-chunk index streams from the full index stream; chunk 0 holds
    the most-significant block (committed 2^w_i rows each; block 0 may be narrower)."""
    idx = np.asarray(indices, np.int64)
    d = d_chunks(log_K)
    return [((idx >> (8 * (d - 1 - i))) & 0xFF).astype(np.int64)
            for i in range(d)]


def block_point(r_addr: Sequence[int], log_K: int, i: int) -> List[int]:
    """Block i's address coordinates: the committed chunk matrix is exactly
    2^w_i rows wide (block 0 may be narrower than 8), so the opening point
    is the bare block slice -- no zero padding (literal-0/1 coordinates
    would break the grouped reduction's division trick)."""
    ws = block_widths(log_K)
    start = sum(ws[:i])
    return [x % P for x in r_addr[start:start + ws[i]]]


class RaVirtual(ProductSumcheck):
    """One full-ra claim -> d chunk openings (prover side): the product
    sumcheck of [eq(r_cycle, .), ra_0, .., ra_{d-1}] with the claim given.
    `chunks` are the d per-cycle chunk index streams (numpy, or int64
    tensors already on `device`)."""

    def __init__(self, chunks: Sequence, log_K: int,
                 r_cycle: Sequence[int], r_addr: Sequence[int], claim: int,
                 tag: Tuple[str, int], device="cuda"):
        self.log_K = log_K
        self.d = len(chunks)
        self.r_addr = [x % P for x in r_addr]
        self.tag = tag            # (commit-name prefix, claim index)
        device = torch.device(device)
        factors = [eq.evals([x % P for x in r_cycle], device)]
        ws = block_widths(log_K)
        off = 0
        for i in range(self.d):
            blk = self.r_addr[off:off + ws[i]]
            off += ws[i]
            v_tab = eq.evals(blk, device)             # (L, 2^w)
            col = ops.upload(chunks[i], device, torch.int64)
            factors.append(v_tab[:, col])
        super().__init__(factors)
        self._claim = claim % P
        self.final_openings: Optional[List[int]] = None

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        return self._claim

    def fused_store(self, values: List[int]) -> None:
        super().fused_store(values)
        self.final_openings = self.final_claims[1:]   # the chunk factors

    def cache_openings(self, accumulator: OpeningAccumulator,
                       r_slice: Sequence[int]) -> None:
        prefix, t = self.tag
        for i in range(self.d):
            pt = list(r_slice) + block_point(self.r_addr, self.log_K, i)
            accumulator.insert((f"{prefix}_virt", (t, i)), pt,
                               self.final_openings[i])


class RaVirtualVerifier(SumcheckInstance):
    def __init__(self, log_T: int, log_K: int, r_cycle: Sequence[int],
                 claim: int, chunk_openings: Sequence[int]):
        self.log_T = log_T
        self.log_K = log_K
        self.d = d_chunks(log_K)
        self.degree = self.d + 1
        self.r_cycle = [x % P for x in r_cycle]
        self._claim = claim % P
        self.chunk_openings = [x % P for x in chunk_openings]

    @property
    def num_rounds(self) -> int:
        return self.log_T

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        return self._claim

    def message_evals_dev(self, round):  # pragma: no cover
        raise NotImplementedError("verifier instance")

    def ingest_challenge(self, r, round):  # pragma: no cover
        raise NotImplementedError("verifier instance")

    def expected_output_claim(self, accumulator: OpeningAccumulator,
                              r: Sequence[int]) -> int:
        acc = eq.eq_int(self.r_cycle, [x % P for x in r])
        for o in self.chunk_openings:
            acc = acc * o % P
        return acc
