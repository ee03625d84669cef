"""Pedersen vector commitments over BN254 G1 for the BlindFold layer.

Copied from the JAX package's `blindfold/pedersen.py`, logic unchanged,
except that every MSM (`pedersen_commit`, and `msm` for the BlindFold
verifier's folds and Hyrax checks) runs on the native library of
`csrc/pairing.cpp` (`curve/native_pairing.g1_msm`): the same group
element as the JAX package's Python double-and-add `g1_msm`, about 100x
faster; the Python tier runs only when JOLT_TPU_NO_NATIVE_PAIRING asks
for it.  The original notes follow.

C = sum_i v_i * G_i + rho * H  -- perfectly hiding (rho uniform),
computationally binding under DLOG.  Generators derive deterministically
from a domain label via try-and-increment hash-to-curve
(`_hash_to_point`), so nobody knows discrete logs between them.

Reference: `crates/jolt-blindfold` row committers + the Hyrax paper's
matrix commitment (eprint 2017/1132).  Row vectors here are short (a
sumcheck round's compressed coefficients, or one Hyrax grid row).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Optional, Sequence

from ..curve import bn254_host as host
from ..curve import native_pairing
from ..field.params import FQ, FR

P = FR.modulus
Q = FQ.modulus


def _hash_to_point(label: bytes, i: int) -> host.Point:
    """Try-and-increment hash-to-curve: x = H(label || i || ctr) mod q
    until x^3 + 3 is a square; y = smaller sqrt (deterministic sign)."""
    ctr = 0
    while True:
        h = hashlib.blake2b(label + i.to_bytes(4, "big")
                            + ctr.to_bytes(4, "big"), digest_size=32)
        x = int.from_bytes(h.digest(), "big") % Q
        rhs = (x * x % Q * x + 3) % Q
        y = pow(rhs, (Q + 1) // 4, Q)
        if y * y % Q == rhs:
            if y > Q - y:
                y = Q - y
            return (x, y)
        ctr += 1


@dataclass
class PedersenBasis:
    """n message generators + one blinding generator."""

    G: List[host.Point]
    H: host.Point
    label: bytes

    @classmethod
    def create(cls, n: int, label: bytes = b"jolt-tpu/blindfold") -> "PedersenBasis":
        G = [_hash_to_point(label, i) for i in range(n)]
        H = _hash_to_point(label + b"/blind", 0)
        return cls(G=G, H=H, label=label)

    def extend(self, n: int) -> None:
        while len(self.G) < n:
            self.G.append(_hash_to_point(self.label, len(self.G)))


def pedersen_commit(basis: PedersenBasis, values: Sequence[int],
                    rho: int) -> host.Point:
    """C = sum v_i G_i + rho H (host MSM; rows are short)."""
    assert len(values) <= len(basis.G)
    pts = list(basis.G[:len(values)]) + [basis.H]
    scalars = [v % P for v in values] + [rho % P]
    return msm(pts, scalars)


def msm(points: Sequence[host.Point], scalars: Sequence[int]) -> host.Point:
    """sum_i scalars[i] * points[i] on the native library (the value of
    `bn254_host.g1_msm`)."""
    fast = native_pairing.g1_msm(list(points), list(scalars))
    return host.g1_msm(points, scalars) if fast is None else fast[0]


def point_bytes(p: Optional[host.Point]) -> bytes:
    """64-byte BE affine encoding (infinity = all-zero), the transcript
    absorb format used by the rest of the codebase."""
    if p is None:
        return b"\x00" * 64
    return p[0].to_bytes(32, "big") + p[1].to_bytes(32, "big")
