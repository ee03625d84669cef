"""Joint batched-opening reduction: reduce every terminal committed-poly
claim (polys of different sizes, opened at different points) to openings of
all polynomials at ONE common point (stage 8).

Torch counterpart of the JAX package's `relations/opening_reduction.py`
(reference: `crates/jolt-openings/src/lib.rs:12-19`, `zkvm/prover.rs:
2097-2260`).  Per dense claim (P, q, v) one instance proves
    v = sum_x eq(q, x) * P(x);
the one-hot claims go through `grouped_onehot.GroupedOneHot`.  After the
shared challenges r* the verifier checks eq(q, r*_suffix) * P(r*_suffix)
against the running claim and scales each opening by the zero-padding
embedding factor prod_{j < max-n} (1 - r*_j) for the joint PCS opening
(with Dory, ROADMAP A11).  One-hot polynomials are committed
address-major (index = k*T + j).

`DenseOpening`'s round is the JAX package's `booleanity._ham_cycle_kernel`
(eq times P at degree 2, both bound HighToLow), which is K2's 2-factor
product round: `DenseOpening` is a `sumcheck.product.ProductSumcheck` of
[eq(q, .), P].  `SparseOneHotOpening` (ROADMAP A19) and the `scan_*` /
`fused_*` hooks (A16) are not ported.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..field import FR, ops
from ..poly import eq
from ..sumcheck.engine import OpeningAccumulator, SumcheckInstance
from ..sumcheck.product import ProductSumcheck

P = FR.modulus


def onehot_address_major(indices: Sequence[int], K: int) -> List[int]:
    """Committed coefficient vector for a one-hot matrix, index = k*T + j."""
    T = len(indices)
    out = [0] * (K * T)
    for j, c in enumerate(indices):
        out[int(c) * T + j] = 1
    return out


def cycle_major_to_address_major_point(point: Sequence[int],
                                       log_T: int) -> List[int]:
    """Relation sumchecks produce (r_cycle ++ r_addr) opening points over
    cycle-major arrays; the same evaluation over the address-major committed
    layout is at (r_addr ++ r_cycle)."""
    return list(point[log_T:]) + list(point[:log_T])


class DenseOpening(ProductSumcheck):
    """v = sum_x eq(q, x) * P(x) for a dense coefficient vector (a list of
    ints, or its Montgomery limbs (8, 2^n) already on `device`).
    `weights` (limbs (8, 2^n) on `device`) takes the place of the eq
    table as the first factor: the program-image reduction's shifted-eq
    slice (`program_image.ProgramImageReduction`)."""

    def __init__(self, coeffs, point: Sequence[int], claim: int, label: str,
                 device="cuda", weights: Optional[torch.Tensor] = None):
        device = torch.device(device)
        self.q = [x % P for x in point]
        Pv = (coeffs if isinstance(coeffs, torch.Tensor)
              else ops.pack_ints(coeffs, device))
        assert Pv.shape[-1] == 1 << len(self.q)
        if weights is None:
            weights = eq.evals(self.q, device)
        assert weights.shape == Pv.shape
        super().__init__([weights, Pv])
        self.claim = claim % P
        self.label = label
        self.final_openings: Optional[dict] = None

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        return self.claim

    def fused_store(self, values: List[int]) -> None:
        super().fused_store(values)
        self.final_openings = {"p": self.final_claims[1]}

    def cache_openings(self, accumulator: OpeningAccumulator,
                       r_slice: Sequence[int]) -> None:
        accumulator.insert(("joint_opening", self.label), list(r_slice),
                           self.final_openings["p"])


class OpeningReductionVerifier(SumcheckInstance):
    """Verifier twin for both sparse and dense reduction instances."""

    degree = 2

    def __init__(self, num_vars: int, point: Sequence[int], claim: int,
                 p_opening: int):
        self.n = num_vars
        self.q = [x % P for x in point]
        self.claim = claim % P
        self.p_opening = p_opening % P

    @property
    def num_rounds(self) -> int:
        return self.n

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        return self.claim

    def message_evals_dev(self, round):  # pragma: no cover
        raise NotImplementedError("verifier instance")

    def ingest_challenge(self, r, round):  # pragma: no cover
        raise NotImplementedError("verifier instance")

    def expected_output_claim(self, accumulator: OpeningAccumulator,
                              r: Sequence[int]) -> int:
        return eq.eq_int(self.q, list(r)) * self.p_opening % P


def embedding_factor(r_star: Sequence[int], num_vars: int) -> int:
    """Zero-padding embedding: a 2^n-coefficient poly inside the
    2^max space evaluates at r* to P(r*[-n:]) * prod_high (1 - r*_j)."""
    acc = 1
    for rj in r_star[:len(r_star) - num_vars]:
        acc = acc * ((1 - rj) % P) % P
    return acc
