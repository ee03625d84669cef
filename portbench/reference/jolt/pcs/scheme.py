"""Scheme-agnostic PCS seam for the prover/verifier.

The reference routes every commitment through the `CommitmentScheme` /
`AdditivelyHomomorphic` trait tree (`crates/jolt-openings/src/lib.rs:20-37`)
so Dory (production, transparent setup) and HyperKZG (trusted setup) are
interchangeable behind the stage-0 commit and stage-8 joint opening.  This
module is that seam for the TPU stack:

  * `commit(name, coeffs, bits)`   -> wire commitment (absorbable object)
  * `absorb(transcript, comm)`        transcript framing per scheme
  * `open_rlc(weights, rlc, point, value, transcript)` -> opening proof for
       the mu-RLC of the named committed polynomials at one point
       (prover side; may use per-name prover hints retained from commit)
  * `combine(commitments, weights)`-> homomorphically combined commitment
  * `verify_rlc(joint, point, value, proof, transcript)` -> bool

Point convention (both schemes): point[0] binds the MOST significant index
bit (big-endian variables), matching the stage-8 reduction's r*.

`make_scheme` keeps call sites simple: a raw `KZGSetup`/`DorySetup` is
wrapped in the matching scheme; a scheme instance passes through; None
means sumcheck-only mode (no commitment layer).

Copied from the JAX package's `pcs/scheme.py`.  What differs: every
scheme takes the `device` its device work runs on (`make_scheme(setup,
device="cuda")`; `prove` passes its own), never chosen by whether a card
is present: HyperKZG's MSMs run there, and Dory's G1 work (one-hot tier
1, the dense commits, the opening's phase B) takes K3 on a CUDA device
and the native library on the CPU (`pcs/dory.py`).
The benchmark's copy keeps Dory alone: its configurations name no other
scheme, so the HyperKZG scheme and its proof type are cut here.
"""

from __future__ import annotations

from typing import Dict, Sequence


from ..field.params import FR_MODULUS as P
from .dory import (Dory, DoryCommitment, DorySetup, gt_exp, gt_mul,
                   gt_to_bytes, _run as _dory_run)


class DoryScheme:
    """Dory behind the seam (production scheme; transparent setup), its
    verifier side."""

    name = "dory"

    def __init__(self, setup: DorySetup, device="cpu"):
        self.dory = Dory(setup, device)
        self.setup = setup

    def absorb(self, transcript: Blake2bTranscript,
               comm: DoryCommitment) -> None:
        transcript.append_bytes(b"commitment", gt_to_bytes(comm.c))

    def combine(self, commitments: Dict[str, object],
                weights: Dict[str, int]):
        joint = None
        tasks = []
        for name, w in weights.items():
            c = commitments[name]
            if not isinstance(c, DoryCommitment):
                return None
            tasks.append((_member_power, (c.c, w)))
        # one task a commitment, in the Dory verifier's pool where one is
        # set (`dory.parallel`)
        for term in _dory_run(tasks):
            if term is None:
                return None
            joint = term if joint is None else gt_mul(joint, term)
        return joint

    def verify_rlc(self, joint, point: Sequence[int], value: int, proof,
                   transcript: Blake2bTranscript) -> bool:
        if joint is None:
            return False
        return self.dory.verify(DoryCommitment(c=joint), point, value, proof,
                                transcript)


def _member_power(c, w):
    """c^w, or None where c is not in GT: GT-membership (c^r == 1, the
    order-r subgroup of Fq12*) rejects adversarial wire elements outside
    the pairing target group.  NB gt_exp reduces exponents mod r, so the
    check uses raw pow."""
    if not c.pow(P).is_one():
        return None
    return gt_exp(c, w)


def make_scheme(setup, device="cuda"):
    """None | KZGSetup | DorySetup | scheme instance -> scheme | None; a
    new scheme runs its device work on `device`."""
    if setup is None:
        return None
    if isinstance(setup, DoryScheme):
        return setup
    if isinstance(setup, DorySetup):
        return DoryScheme(setup, device)
    raise TypeError(f"unknown PCS setup type {type(setup)!r}")
