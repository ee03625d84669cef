"""ZK sumcheck: rounds commit their coefficients instead of revealing them.

Torch counterpart of the JAX package's `blindfold/zk_sumcheck.py`.  Phase 1
of BlindFold (`book/src/how/blindfold.md`, `crates/jolt-blindfold`
prove.rs): the prover runs the standard batched sumcheck, but each round's
compressed coefficient vector (c_0, c_2, .., c_d) goes into the Fiat-Shamir
transcript as a Pedersen COMMITMENT; the verifier derives identical
challenges from the commitments but never sees a coefficient.  All round
checks (sum consistency, Horner chaining, final output binding) are
deferred to the BlindFold verifier R1CS (r1cs.py).

The round loop is the engine's own (`BatchedSumcheck.prove`: every
instance's message on the device, one device-to-host copy a round); this
module gives it the `CommittedRounds` sink, so a zk stage launches exactly
the kernels of the plain stage.  `ZkStageData` and `zk_replay_challenges`
are copied with their logic unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from ..field.params import FR
from ..poly.univariate import UniPoly
from ..sumcheck.engine import (BatchedSumcheck, ClearRounds,
                               OpeningAccumulator, SumcheckInstance)
from ..transcript import Blake2bTranscript
from ..utils import profiling
from .pedersen import PedersenBasis, pedersen_commit, point_bytes

P = FR.modulus


@dataclass
class ZkStageData:
    """Everything BlindFold needs from one ZK sumcheck stage."""

    label: str
    max_rounds: int
    max_degree: int
    input_claim0: int                 # batched scaled input claim (public)
    round_coeffs: List[List[int]]     # per round: compressed (c0,c2..cd)
    blinds: List[int]                 # per round Pedersen blinding (witness)
    commitments: List[object]         # per round G1 point (public)
    challenges: List[int]             # r_j (public, derived from comms)
    claims: List[int]                 # claim_0 .. claim_R (witness chain)
    final_expected: Optional[int] = None  # bound at chain end (public v1)


class CommittedRounds(ClearRounds):
    """The engine's round sink in zk mode: each round's compressed
    polynomial, zero-padded to the stage's max degree, is committed with a
    fresh blind drawn from `rng` (one `randrange(P)` a round, after the
    batched polynomial is formed, as the JAX package draws it) and the
    transcript absorbs the commitment ("zk_sumcheck_comm"); nothing is kept
    in the clear.  `data` records the stage for BlindFold.  The commits
    run under the `zk.commit` span."""

    def __init__(self, basis: PedersenBasis, rng, label: str):
        super().__init__()
        self.basis = basis
        self.rng = rng
        self.label = label
        self.data: Optional[ZkStageData] = None

    def start(self, instances: Sequence[SumcheckInstance],
              coeffs: Sequence[int], claims: Sequence[int]) -> None:
        self.coeffs = list(coeffs)
        claim0 = sum(c * cl for c, cl in zip(coeffs, claims)) % P
        max_degree = max(getattr(i, "degree", 3) for i in instances)
        self.basis.extend(max_degree)
        self.data = ZkStageData(
            label=self.label,
            max_rounds=max(i.num_rounds for i in instances),
            max_degree=max_degree, input_claim0=claim0, round_coeffs=[],
            blinds=[], commitments=[], challenges=[], claims=[claim0])

    def send(self, batched: UniPoly, transcript: Blake2bTranscript) -> None:
        compressed = batched.compress()
        padded = list(compressed) + [0] * (self.data.max_degree
                                           - len(compressed))
        rho = self.rng.randrange(P)
        with profiling.active().span("zk.commit"):
            comm = pedersen_commit(self.basis, padded, rho)
        transcript.append_bytes(b"zk_sumcheck_comm", point_bytes(comm))
        self.data.round_coeffs.append(padded)
        self.data.blinds.append(rho)
        self.data.commitments.append(comm)

    def bound(self, r: int, claims: Sequence[int]) -> None:
        self.data.challenges.append(r)
        self.data.claims.append(
            sum(c * cl for c, cl in zip(self.coeffs, claims)) % P)


def zk_prove_stage(instances: Sequence[SumcheckInstance],
                   accumulator: OpeningAccumulator,
                   transcript: Blake2bTranscript,
                   basis: PedersenBasis,
                   rng, label: str) -> Tuple[ZkStageData, List[int]]:
    """BatchedSumcheck.prove with committed round messages: the transcript
    absorbs point_bytes(commitment) under "zk_sumcheck_comm" instead of
    the coefficients; coefficients/blindings accumulate in ZkStageData."""
    rounds = CommittedRounds(basis, rng, label)
    _, r_sumcheck = BatchedSumcheck.prove(instances, accumulator, transcript,
                                          rounds)
    return rounds.data, r_sumcheck


def zk_replay_challenges(commit_bytes: Sequence[bytes],
                         input_claims: Sequence[int],
                         n_inst: int,
                         transcript: Blake2bTranscript) -> Tuple[List[int], List[int]]:
    """Verifier side of phase 1: replay the transcript over the round
    COMMITMENTS, returning (batching coeffs, challenges)."""
    for claim in input_claims:
        transcript.append_scalar(b"sumcheck_claim", claim)
    coeffs = transcript.challenge_vector(n_inst)
    rs = []
    for cb in commit_bytes:
        transcript.append_bytes(b"zk_sumcheck_comm", cb)
        rs.append(transcript.challenge_scalar_optimized())
    return coeffs, rs
