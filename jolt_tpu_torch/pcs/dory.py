"""Dory's proof-format types, copied from the JAX package's `pcs/dory.py`
(`DoryCommitment`, `DoryProof`): the proof codec (`proof_io.py`) encodes
and decodes them.  The scheme itself (setup, commit, the RLC opening and
its verifier) is ROADMAP A11; without it `prove` runs at `setup=None` and
a proof holds no commitment and no opening proof.
"""

from __future__ import annotations

import dataclasses
from typing import List

from ..curve import bn254_host as host
from ..curve.fq_tower import Fq12
from ..curve.pairing import G2Point


@dataclasses.dataclass
class DoryCommitment:
    c: Fq12                       # tier-2 AFGHO commitment (GT)


@dataclasses.dataclass
class DoryProof:
    e1: host.Point                       # sum_i L_i C1_i (G1)
    # phase A (Dory-reduce), per round:
    a_d1l: List[Fq12]
    a_d1r: List[Fq12]
    a_d2l: List[Fq12]
    a_d2r: List[Fq12]
    a_cplus: List[Fq12]
    a_cminus: List[Fq12]
    a_final_v1: host.Point
    a_final_v2: G2Point
    # phase B (generator-folding IPA), per round:
    b_xl: List[host.Point]
    b_xr: List[host.Point]
    b_yl: List[int]
    b_yr: List[int]
    b_final_s: int
