"""BlindFold phases 2-6: R1CS build, Nova fold, Spartan, Hyrax openings.

Copied from the JAX package's `blindfold/prove.py`, logic unchanged
(every MSM is `pedersen.msm`, on the native library).  `proof_io.py`
decodes `BlindFoldProof` from here.

Entry: blindfold_prove(stages, basis, transcript, rng) after every ZK
sumcheck stage recorded its ZkStageData (zk_sumcheck.py).  The returned
BlindFoldProof + the phase-1 round commitments convince a verifier that
every committed round was consistent, without revealing a coefficient.
Reference flow: `crates/jolt-blindfold/src/prove.rs`,
`book/src/how/blindfold.md` phases 2-6.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List


@dataclass
class BlindFoldProof:
    value_comms: List[object]          # real-instance non-coefficient rows
    u2: int
    z2_comms: List[object]
    t_comms: List[object]
    e2_comms: List[object]
    outer_polys: List[List[int]]
    az_r: int
    bz_r: int
    cz_r: int
    inner_polys: List[List[int]]
    w_comb: List[int]
    w_rho: int
    e_comb: List[int]
    e_rho: int
    e_rows: int = 0
    e_cols: int = 0
