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
