"""HyperKZG's proof-format type, copied from the JAX package's
`pcs/hyperkzg.py` (`HyperKZGProof`), for the proof codec.  That module
imports JAX at its top, so only the type is copied; the scheme is ROADMAP
A15.
"""

from __future__ import annotations

import dataclasses
from typing import List

from ..curve import bn254_host as host


@dataclasses.dataclass
class HyperKZGProof:
    fold_commitments: List[host.Point]          # commitments to f_1..f_{l-1}
    evals: List[List[int]]                      # per f_i: [f_i(r), f_i(-r), f_i(r^2)]
    witnesses: List[host.Point]                 # KZG quotients for {r, -r, r^2}
