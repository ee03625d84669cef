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
sumcheck, `relations/shift.py`); with any other factor count it holds
its factors as one stack (L, F, T) whose message is `stack_message` on K1
and whose bind is one `dense.bind_high`.  The ra virtualization of stage
6v (`relations/ra_virtual.py`), the dense opening reduction of stage 8 and
the program-image reduction of stage 7 (`relations/opening_reduction.py`,
`relations/program_image.py`) are `ProductSumcheck`s; the instruction
read-raf's 18-factor cycle rounds call `stack_message` directly.

`ProductSumcheck` is a `FusedInstance`: K2 and K1's bind read a device
challenge where it lies, so its rounds run on the device tier as they
run on the host engine.  Its degree is its factor count, so with 4 or
more factors (degree above K4's 3) its stage takes the host engine
(`sumcheck/fused.py:device_tier`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch

from ..field import FR, kernels, ops
from ..poly import dense
from .engine import OpeningAccumulator, SumcheckInstance
from .fused import FusedInstance

P = FR.modulus


def stack_message(S: torch.Tensor, degree: int) -> torch.Tensor:
    """Round-message evals at X in {0, 2, .., degree} of sum_j prod_f
    S[:, f, j] for a stack S (L, F, T) of F factors bound HighToLow:
    (L, degree, 1).  K1's evals form over the whole stack (one launch,
    (L, degree, F, T/2)), a chain of F - 1 K1 products along the factors,
    and one `sum_mod`: the JAX package's `_cycle_message_kernel`, which
    walks the eval points one at a time only to bound the TPU's memory
    (the same bytes either way)."""
    e = dense.sumcheck_eval_points_high(S, degree)       # (L, deg, F, T/2)
    acc = e[:, :, 0]
    for f in range(1, S.shape[1]):
        acc = ops.mont_mul(acc, e[:, :, f])
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
    card at most two launches, on the CPU its plain version.  The challenge
    is a canonical int (by value) or a device scalar (8, 1), which K2 reads
    where it lies."""

    def __init__(self, polys: Sequence[torch.Tensor]):
        self.polys: Tuple[torch.Tensor, ...] = tuple(polys)
        # the challenge not yet bound
        self._r: Optional[Union[int, torch.Tensor]] = None

    def message(self) -> torch.Tensor:
        if self._r is None:
            msg, _ = kernels.product_round(self.polys, None, "message")
        else:
            msg, self.polys = kernels.product_round(self.polys, self._r,
                                                    "bind_message")
            self._r = None
        return msg

    def bind(self, r: Union[int, torch.Tensor]) -> None:
        self.flush()
        self._r = r

    def flush(self) -> Tuple[torch.Tensor, ...]:
        """Bind the stored challenge, if any; returns the factors."""
        if self._r is not None:
            _, self.polys = kernels.product_round(self.polys, self._r, "bind")
            self._r = None
        return self.polys


class ProductSumcheck(FusedInstance):
    """Prover instance for sum_x prod_k P_k(x) over the full hypercube.
    With 2 or 3 factors its rounds run on K2 (`ProductRounds`); with any
    other count on the stack (L, F, T) through K1 (`stack_message`).  Its
    finals are the bound factors (`final_claims`)."""

    def __init__(self, polys: Sequence[torch.Tensor]):
        T = polys[0].shape[-1]
        assert all(p.shape[-1] == T for p in polys)
        self.device = polys[0].device
        self._num_rounds = T.bit_length() - 1
        assert 1 << self._num_rounds == T
        self._degree = len(polys)
        if len(polys) in (2, 3):
            self._rounds: Optional[ProductRounds] = ProductRounds(polys)
            self.S: Optional[torch.Tensor] = None
        else:
            self._rounds = None
            self.S = torch.stack(list(polys), dim=1)      # (L, F, T)
        self._input_claim: Optional[int] = None
        self.final_claims: Optional[List[int]] = None

    # -- prover ----------------------------------------------------------

    @property
    def num_rounds(self) -> int:
        return self._num_rounds

    @property
    def degree(self) -> int:
        return self._degree

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        if self._input_claim is None:
            factors = (self._rounds.polys if self._rounds is not None
                       else self.S.unbind(1))
            self._input_claim = ops.unpack_ints(_product_claim(factors))[0]
        return self._input_claim

    def message_evals_dev(self, round: int) -> torch.Tensor:
        if self._rounds is not None:
            return self._rounds.message()
        return stack_message(self.S, self.degree)

    def ingest_challenge(self, r: int, round: int) -> None:
        if self._rounds is not None:
            self._rounds.bind(r)
        else:
            self.S = dense.bind_high(self.S, r)

    def fused_finals(self) -> List[torch.Tensor]:
        if self._rounds is not None:
            return [torch.cat(self._rounds.flush(), dim=1)]    # (L, F)
        return [self.S.reshape(self.S.shape[0], -1)]

    def fused_store(self, values: List[int]) -> None:
        self.final_claims = list(values)
        self._rounds = self.S = None

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
