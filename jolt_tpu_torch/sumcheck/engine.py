"""Batched sumcheck engine: host driver + device round messages.

Torch counterpart of the JAX package's `sumcheck/engine.py` (the reference
protocol flow, `crates/jolt-prover-legacy/src/subprotocols/sumcheck.rs:34-185`
prove, `:413` verify): the transcript and round-poly algebra stay on the
host (tiny, sequential); each instance's round message and bind run as
torch work over its bound MLE tensors, and the engine copies every
instance's message to the host with ONE device-to-host copy per round.
An instance whose round message is host work (the instruction read-raf's
address rounds) returns None from `message_evals_dev` and gives its round
polynomial from `compute_message`.

Protocol (prove):
  1. absorb every instance's input claim (label "sumcheck_claim")
  2. draw batching coefficients (128-bit BE challenge scalars)
  3. scale claim_i by 2^(max_rounds - rounds_i)   [front-loaded batching]
  4. per round: active instances emit degree-d univariates; inactive emit
     the constant claim/2; RLC-combine; compress (drop linear coeff);
     absorb ("sumcheck_poly"); draw r_j = challenge_scalar_optimized
     (125-bit); update claims; active instances bind.
  5. finalize; cache openings per instance on the accumulator's id space;
     flush pending opening claims to the transcript ("opening_claim").

Step 4's absorb is the `rounds` sink's: `ClearRounds` absorbs each
compressed round polynomial and keeps it for the proof; the zk mode's
`blindfold.zk_sumcheck.CommittedRounds` absorbs a Pedersen commitment to
it instead.  The round loop itself is the same in both modes.

This is the host tier.  `prove` runs a stage through
`fused.prove_fused`, which takes the device tier instead (the transcript
on the card, one fetch a stage) when `fused.device_tier` says so, and
this engine otherwise; both give the same bytes.

Spans (`utils/profiling.py`): steps 1-4 run in `engine.rounds`, step 5 in
`stage.openings`; each round's copy counts one `d2h` there.
"""

from __future__ import annotations

import abc
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..field import ops
from ..field.params import FR
from ..poly.univariate import UniPoly
from ..transcript import Blake2bTranscript
from ..utils import profiling

P = FR.modulus


class SumcheckError(Exception):
    pass


class OpeningAccumulator:
    """Host-side opening-claim DAG edge manager.

    Analog of `ProverOpeningAccumulator` (`poly/opening_proof.rs:226-240`):
    maps OpeningId -> (opening_point, claim); sumchecks insert output claims
    (`cache_openings`), later sumchecks consume them as input claims;
    committed-polynomial claims flow to the stage-8 batched opening.
    """

    def __init__(self):
        self.openings: Dict[object, Tuple[Tuple[int, ...], int]] = {}
        self.pending_claims: List[int] = []

    def insert(self, opening_id, point: Sequence[int], claim: int) -> None:
        self.openings[opening_id] = (tuple(point), claim % P)
        self.pending_claims.append(claim % P)

    def get_claim(self, opening_id) -> int:
        return self.openings[opening_id][1]

    def get_point(self, opening_id) -> Tuple[int, ...]:
        return self.openings[opening_id][0]

    def flush_to_transcript(self, transcript: Blake2bTranscript) -> None:
        # opening_proof.rs:656-661
        for claim in self.pending_claims:
            transcript.append_scalar(b"opening_claim", claim)
        self.pending_claims = []


class SumcheckInstance(abc.ABC):
    """One sumcheck instance (prover side), `SumcheckInstanceProver` analog
    (`subprotocols/sumcheck_prover.rs:10-64`)."""

    @property
    @abc.abstractmethod
    def num_rounds(self) -> int: ...

    def round_offset(self, max_num_rounds: int) -> int:
        # default: active only in the last num_rounds rounds
        return max_num_rounds - self.num_rounds

    @abc.abstractmethod
    def input_claim(self, accumulator: OpeningAccumulator) -> int: ...

    @abc.abstractmethod
    def message_evals_dev(self, round: int) -> Optional[torch.Tensor]:
        """The round message's Montgomery-limb evaluations (8, ...) at the
        points other than 1, as a tensor on the instance's device; or None
        when the round's message is host work (`compute_message`).

        The engine fetches ALL instances' tensors with ONE device-to-host
        copy per round; kernel launches before it stay asynchronous."""

    def compute_message(self, round: int, previous_claim: int) -> UniPoly:
        """The round polynomial computed on the host, for a round whose
        `message_evals_dev` is None."""
        raise NotImplementedError(
            f"{type(self).__name__} has no host message for round {round}")

    @abc.abstractmethod
    def ingest_challenge(self, r: int, round: int) -> None: ...

    def finalize(self) -> None:
        pass

    def cache_openings(self, accumulator: OpeningAccumulator,
                       r_slice: Sequence[int]) -> None:
        pass

    # ---- verifier half -------------------------------------------------

    @abc.abstractmethod
    def expected_output_claim(self, accumulator: OpeningAccumulator,
                              r: Sequence[int]) -> int:
        """Verifier: the value the final bound claim must equal, computed
        from opening claims / direct evaluation at the challenge point."""

    def normalize_opening_point(self, r: Sequence[int]) -> Sequence[int]:
        return r


class ClearRounds:
    """The rounds of a batched sumcheck in the clear: each round's batched
    polynomial is compressed, absorbed ("sumcheck_poly") and kept in
    `polys` for the proof."""

    def __init__(self):
        self.polys: List[List[int]] = []

    def start(self, instances: Sequence[SumcheckInstance],
              coeffs: Sequence[int], claims: Sequence[int]) -> None:
        """Before the first round: the batching coefficients and the
        instances' scaled input claims."""

    def send(self, batched: UniPoly, transcript: Blake2bTranscript) -> None:
        compressed = batched.compress()
        transcript.append_scalars(b"sumcheck_poly", compressed)
        self.polys.append(compressed)

    def bound(self, r: int, claims: Sequence[int]) -> None:
        """After a round's challenge `r`: each instance's claim at r."""


class BatchedSumcheck:
    """`BatchedSumcheck::{prove, verify}`."""

    @staticmethod
    def prove(instances: Sequence[SumcheckInstance],
              accumulator: OpeningAccumulator,
              transcript: Blake2bTranscript,
              rounds: Optional[ClearRounds] = None,
              ) -> Tuple[List[List[int]], List[int]]:
        """Returns the round polynomials `rounds` kept (`ClearRounds` by
        default: the compressed polynomials) and the challenges."""
        rounds = ClearRounds() if rounds is None else rounds
        max_rounds = max(i.num_rounds for i in instances)

        prof = profiling.active()
        with prof.span("engine.rounds"):
            for inst in instances:
                transcript.append_scalar(b"sumcheck_claim",
                                         inst.input_claim(accumulator))
            coeffs = transcript.challenge_vector(len(instances))

            claims = [
                (inst.input_claim(accumulator)
                 << (max_rounds - inst.num_rounds)) % P
                for inst in instances
            ]
            rounds.start(instances, coeffs, claims)

            two_inv = pow(2, -1, P)
            r_sumcheck: List[int] = []

            for rnd in range(max_rounds):
                # 1: launch every active instance's message (async); an
                # instance whose message is host work this round computes
                # it, 2: ONE blocking device-to-host copy for the device
                # messages (`ops.host`: the round's `d2h`), 3: interpolate
                # on the host.
                polys: List[Optional[UniPoly]] = [None] * len(instances)
                active: List[int] = []
                arrays = []
                for i, (inst, claim) in enumerate(zip(instances, claims)):
                    off = inst.round_offset(max_rounds)
                    if off <= rnd < off + inst.num_rounds:
                        arr = inst.message_evals_dev(rnd - off)
                        if arr is None:
                            polys[i] = inst.compute_message(rnd - off,
                                                            claim)
                        else:
                            active.append(i)
                            arrays.append(arr)
                    else:
                        polys[i] = UniPoly([claim * two_inv % P])
                if arrays:
                    # under a cycle mesh each message is gathered whole
                    # first
                    flat = [ops.whole(a).reshape(a.shape[0], -1)
                            for a in arrays]
                    host = ops.host(torch.cat(flat, dim=1))
                    bounds = np.cumsum([0] + [f.shape[1] for f in flat])
                    for k, i in enumerate(active):
                        evals = ops.np_unpack_ints(
                            host[:, bounds[k]:bounds[k + 1]])
                        polys[i] = UniPoly.from_evals_and_hint(
                            claims[i], evals, P)

                batched = UniPoly([0])
                for poly, c in zip(polys, coeffs):
                    batched = batched.add(poly.scale(c))

                rounds.send(batched, transcript)
                r_j = transcript.challenge_scalar_optimized()
                r_sumcheck.append(r_j)

                claims = [poly.evaluate(r_j) for poly in polys]
                rounds.bound(r_j, claims)

                for inst in instances:
                    off = inst.round_offset(max_rounds)
                    if off <= rnd < off + inst.num_rounds:
                        inst.ingest_challenge(r_j, rnd - off)

        with prof.span("stage.openings"):
            for inst in instances:
                inst.finalize()
            for inst in instances:
                off = inst.round_offset(max_rounds)
                inst.cache_openings(accumulator,
                                    r_sumcheck[off:off + inst.num_rounds])
            accumulator.flush_to_transcript(transcript)

        return rounds.polys, r_sumcheck

    @staticmethod
    def verify(compressed_polys: List[List[int]],
               instances: Sequence[SumcheckInstance],
               accumulator: OpeningAccumulator,
               transcript: Blake2bTranscript,
               ) -> List[int]:
        """Replays the transcript, checks every round's claim equation and the
        final output claim of each instance.  Returns the challenge vector."""
        max_rounds = max(i.num_rounds for i in instances)
        if len(compressed_polys) != max_rounds:
            raise SumcheckError("wrong number of round polynomials")
        # degree bound (sumcheck.rs:596-601): a compressed degree-d poly has
        # d coefficients; reject empty or over-degree rounds so proofs are
        # not malleable by padding
        max_degree = max(getattr(i, "degree", 3) for i in instances)
        for rnd, compressed in enumerate(compressed_polys):
            if len(compressed) == 0 or len(compressed) > max_degree:
                raise SumcheckError(
                    f"round {rnd}: degree {len(compressed)} out of bounds "
                    f"(max {max_degree})")

        input_claims = [inst.input_claim(accumulator) for inst in instances]
        for claim in input_claims:
            transcript.append_scalar(b"sumcheck_claim", claim)
        coeffs = transcript.challenge_vector(len(instances))

        # batched running claim (the verifier tracks only the RLC combination)
        claim = sum(
            c * ((ic << (max_rounds - inst.num_rounds)) % P)
            for c, ic, inst in zip(coeffs, input_claims, instances)
        ) % P

        r_sumcheck: List[int] = []
        for rnd in range(max_rounds):
            compressed = compressed_polys[rnd]
            poly = UniPoly.decompress(compressed, claim)  # enforces s(0)+s(1)=claim
            transcript.append_scalars(b"sumcheck_poly", compressed)
            r_j = transcript.challenge_scalar_optimized()
            r_sumcheck.append(r_j)
            claim = poly.evaluate(r_j)

        # final check: sum over instances of coeff * expected_output * dummy
        # scaling. An instance inactive before round `off` contributed
        # claim-halving in dummy rounds; after its activation the claim tracks
        # its own polynomial exactly, so its terminal value is its output
        # claim evaluated at its slice of challenges.
        expected = 0
        for inst, c in zip(instances, coeffs):
            off = inst.round_offset(max_rounds)
            r_slice = r_sumcheck[off:off + inst.num_rounds]
            expected = (expected + c * inst.expected_output_claim(accumulator, r_slice)) % P

        if expected != claim:
            raise SumcheckError(
                f"sumcheck output claim mismatch: expected {expected}, got {claim}")
        return r_sumcheck
