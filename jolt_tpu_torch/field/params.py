"""Field parameter tables of the JAX package, copied.

In the port this module supplies the BN254 moduli (`FR`, `FQ`) and the JAX
package's 13-bit-limb constants, which `interop.from_jax_limbs` reads.  The
port's own layout (8 x 32-bit limbs, R = 2^256) lives in `field/kernels.py`
and `field/ops.py`.  The original notes follow.

The reference (`reference crates/jolt-field`) represents BN254 field
elements as 4x64-bit Montgomery limbs (`src/limbs.rs:8-15`) on CPUs with
64x64->128 multipliers.  TPUs have 32-bit integer VPU lanes and no widening
multiply, so we use a different decomposition designed for the hardware:

    * 20 limbs x 13 bits, stored as ``uint32``.
    * Schoolbook products of two 13-bit limbs are < 2**26; a full 20x20
      schoolbook column plus the Montgomery-reduction column never exceeds
      40 * (2**13-1)**2 + 2**19 < 2**32, so *no carry handling is needed
      anywhere inside the multiply loop* -- the whole Montgomery multiply is
      branch-free uint32 adds/muls/shifts, perfectly vectorizable on the VPU.
    * Montgomery radix R = 2**(13*20) = 2**260.

Layout convention: limbs-first.  A batch of N field elements is an array of
shape ``(NUM_LIMBS, N)`` (or ``(NUM_LIMBS, *batch)``), so the batch axis maps
onto TPU vector lanes (last dim, 128-wide) and the limb axis onto sublanes.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Limb geometry (shared by Fr and Fq; both are 254-bit primes).
# ---------------------------------------------------------------------------

LIMB_BITS = 13
NUM_LIMBS = 20
LIMB_MASK = (1 << LIMB_BITS) - 1
TOTAL_BITS = LIMB_BITS * NUM_LIMBS  # 260

# BN254 scalar field modulus (Fr) -- the field all Jolt polynomials live in.
# Matches ark_bn254::Fr (`crates/jolt-field/src/lib.rs` re-exports).
FR_MODULUS = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# BN254 base field modulus (Fq) -- coordinates of G1/G2 points.
FQ_MODULUS = 21888242871839275222246405745257275088696311157297823662689037894645226208583


def int_to_limbs(x: int, n: int = NUM_LIMBS, bits: int = LIMB_BITS) -> np.ndarray:
    """Decompose a non-negative int into little-endian `bits`-bit limbs."""
    assert 0 <= x < (1 << (n * bits)), "value out of range"
    mask = (1 << bits) - 1
    return np.array([(x >> (bits * i)) & mask for i in range(n)], dtype=np.uint32)


def limbs_to_int(limbs, bits: int = LIMB_BITS) -> int:
    """Recompose little-endian limbs (any int dtype) into a Python int."""
    out = 0
    for i, limb in enumerate(np.asarray(limbs).tolist()):
        out |= int(limb) << (bits * i)
    return out


@dataclasses.dataclass(frozen=True)
class FieldParams:
    """Precomputed constants for one prime field in the 13-bit-limb domain."""

    name: str
    modulus: int
    num_limbs: int = NUM_LIMBS
    limb_bits: int = LIMB_BITS

    def __post_init__(self):
        object.__setattr__(self, "r", 1 << (self.num_limbs * self.limb_bits))
        object.__setattr__(self, "r_mod_p", self.r % self.modulus)
        object.__setattr__(self, "r2_mod_p", (self.r * self.r) % self.modulus)
        object.__setattr__(self, "r_inv", pow(self.r, -1, self.modulus))
        # -p^-1 mod 2^limb_bits (the per-limb Montgomery factor)
        base = 1 << self.limb_bits
        object.__setattr__(self, "n0inv", (-pow(self.modulus, -1, base)) % base)
        object.__setattr__(self, "p_limbs", int_to_limbs(self.modulus, self.num_limbs, self.limb_bits))
        object.__setattr__(self, "one_mont_limbs", int_to_limbs(self.r_mod_p, self.num_limbs, self.limb_bits))
        object.__setattr__(self, "r2_limbs", int_to_limbs(self.r2_mod_p, self.num_limbs, self.limb_bits))
        object.__setattr__(self, "zero_limbs", np.zeros(self.num_limbs, dtype=np.uint32))

    # ---- host-side conversions (Python ints; slow path, test/IO only) ----

    def to_mont(self, x: int) -> int:
        return (x * self.r) % self.modulus

    def from_mont(self, x_mont: int) -> int:
        return (x_mont * self.r_inv) % self.modulus

    def int_to_mont_limbs(self, x: int) -> np.ndarray:
        return int_to_limbs(self.to_mont(x % self.modulus), self.num_limbs, self.limb_bits)

    def mont_limbs_to_int(self, limbs) -> int:
        return self.from_mont(limbs_to_int(limbs, self.limb_bits))


FR = FieldParams("bn254_fr", FR_MODULUS)
FQ = FieldParams("bn254_fq", FQ_MODULUS)


def _selfcheck() -> Tuple[int, int]:
    # (p * -p^-1) mod 2^13 == -1 mod 2^13
    for fp in (FR, FQ):
        assert (fp.modulus * fp.n0inv) % (1 << LIMB_BITS) == (1 << LIMB_BITS) - 1
        assert limbs_to_int(fp.p_limbs) == fp.modulus
    return FR.n0inv, FQ.n0inv


_selfcheck()
