"""Generic product sumcheck instance: claim = sum_x prod_k P_k(x).

Torch counterpart of the JAX package's `sumcheck/product.py` (the
reference's `mles_product_sum.rs` analog and the engine's test vehicle; an
eq-weighted relation passes the eq table as one of the factors).  Binding
order: HighToLow.

`round_step` is the counterpart of the JAX package's round-step entry point
(`__graft_entry__.py`, `round_step`): one product-sumcheck round of three
factors at degree 3 -- the message evals and the HighToLow bind at a given
challenge -- which on a CUDA device is kernel K2 in its "message_bind"
order.  A live prover round cannot use that order: there the challenge r_j
is drawn from round j's message.  `ProductRounds` drives K2's other orders
instead: the first round's message alone, then per round one pass that
binds at r_j and forms round j + 1's message, then the last bind alone.
`ProductSumcheck` with 2 or 3 factors runs on it (and so does the shift
sumcheck, `relations/shift.py`); other factor counts keep the torch tier,
with K1 carrying every product.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..field import FR, kernels, ops
from ..poly import dense
from .engine import OpeningAccumulator, SumcheckInstance

P = FR.modulus


def _product_message(polys: Sequence[torch.Tensor],
                     degree: int) -> torch.Tensor:
    """Round-message evals at X in {0, 2, .., degree} for a product of MLEs:
    (L, degree, 1) with evals[:, j] = sum_i prod_k P_k,X_j[i]."""
    acc = None
    for Pk in polys:
        e = dense.sumcheck_eval_points_high(Pk, degree)   # (L, deg, T/2)
        acc = e if acc is None else ops.mont_mul(acc, e)
    return ops.sum_mod(acc)


def _product_claim(polys: Sequence[torch.Tensor]) -> torch.Tensor:
    acc = None
    for Pk in polys:
        acc = Pk if acc is None else ops.mont_mul(acc, Pk)
    return ops.sum_mod(acc)


def round_step(polys: Sequence[torch.Tensor], r: torch.Tensor
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """One degree-3 product-sumcheck round of three factors (each (8, T)):
    the message evals at X = 0, 2, 3 as (8, 3, 1) and the factors bound
    HighToLow at r (8, 1).  K2 on the card, its plain version on the CPU."""
    if len(polys) != 3:
        raise ValueError(f"round_step: {len(polys)} factors (K2 takes 3)")
    msg, *bound = kernels.product_round_deg3(*polys, r)
    return msg, tuple(bound)


class ProductRounds:
    """The factors of a HighToLow product sumcheck of 2 or 3 factors at
    degree 2 or 3, through its live rounds on K2: `message()` gives the
    round's evals at X = 0, 2, .., NF as (8, NF, 1); `bind(r)` only stores
    the challenge, which the next `message()` binds in the same pass
    ("bind_message"), or `flush()` alone ("bind").  The first message has
    no bind before it ("message").  So each round is one K2 call: on the
    card at most two launches, on the CPU its plain version."""

    def __init__(self, polys: Sequence[torch.Tensor]):
        self.polys: Tuple[torch.Tensor, ...] = tuple(polys)
        self._r: Optional[int] = None        # the challenge not yet bound

    def message(self) -> torch.Tensor:
        if self._r is None:
            msg, _ = kernels.product_round(self.polys, None, "message")
        else:
            msg, self.polys = kernels.product_round(self.polys, self._r,
                                                    "bind_message")
            self._r = None
        return msg

    def bind(self, r: int) -> None:
        self.flush()
        self._r = r

    def flush(self) -> Tuple[torch.Tensor, ...]:
        """Bind the stored challenge, if any; returns the factors."""
        if self._r is not None:
            _, self.polys = kernels.product_round(self.polys, self._r, "bind")
            self._r = None
        return self.polys


class ProductSumcheck(SumcheckInstance):
    """Prover instance for sum_x prod_k P_k(x) over the full hypercube.
    With 2 or 3 factors its rounds run on K2 (`ProductRounds`)."""

    def __init__(self, polys: List[torch.Tensor]):
        T = polys[0].shape[-1]
        assert all(p.shape[-1] == T for p in polys)
        self.polys = list(polys)
        self.device = polys[0].device
        self._num_rounds = T.bit_length() - 1
        assert 1 << self._num_rounds == T
        self._rounds = (ProductRounds(polys) if len(polys) in (2, 3)
                        else None)
        self._input_claim: Optional[int] = None
        self.final_claims: Optional[List[int]] = None

    # -- prover ----------------------------------------------------------

    @property
    def num_rounds(self) -> int:
        return self._num_rounds

    @property
    def degree(self) -> int:
        return len(self.polys)

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        if self._input_claim is None:
            self._input_claim = ops.unpack_ints(_product_claim(self.polys))[0]
        return self._input_claim

    def message_evals_dev(self, round: int) -> torch.Tensor:
        if self._rounds is not None:
            return self._rounds.message()
        return _product_message(self.polys, self.degree)

    def ingest_challenge(self, r: int, round: int) -> None:
        if self._rounds is not None:
            self._rounds.bind(r)
            return
        r_dev = ops.pack_ints([r], self.device)
        self.polys = [dense.bind_high(Pk, r_dev) for Pk in self.polys]

    def finalize(self) -> None:
        if self._rounds is not None:
            self.polys = list(self._rounds.flush())
        self.final_claims = [ops.unpack_ints(Pk)[0] for Pk in self.polys]

    def cache_openings(self, accumulator: OpeningAccumulator,
                       r_slice: Sequence[int]) -> None:
        if self.final_claims is None:
            self.finalize()
        for k, claim in enumerate(self.final_claims):
            accumulator.insert(("product_poly", id(self), k), r_slice, claim)

    # -- verifier --------------------------------------------------------

    def expected_output_claim(self, accumulator: OpeningAccumulator,
                              r: Sequence[int]) -> int:
        acc = 1
        for claim in self.final_claims:
            acc = acc * claim % P
        return acc


class VerifierProductSumcheck(SumcheckInstance):
    """Verifier-side twin: consumes per-factor opening claims from the proof."""

    def __init__(self, num_rounds: int, input_claim: int,
                 factor_claims: List[int]):
        self._num_rounds = num_rounds
        self._input_claim = input_claim
        self.factor_claims = factor_claims

    @property
    def num_rounds(self) -> int:
        return self._num_rounds

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        return self._input_claim

    def message_evals_dev(self, round):  # pragma: no cover
        raise NotImplementedError("verifier instance")

    def ingest_challenge(self, r, round):  # pragma: no cover
        raise NotImplementedError("verifier instance")

    def expected_output_claim(self, accumulator: OpeningAccumulator,
                              r: Sequence[int]) -> int:
        acc = 1
        for claim in self.factor_claims:
            acc = acc * claim % P
        return acc
