"""BlindFold's proof-format type, copied from the JAX package's
`blindfold/prove.py` (`BlindFoldProof`), for the proof codec.  The zk mode
that produces it is ROADMAP A14.
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
