"""BN254 Fq (the base field: G1 coordinates) in the port's layout.

The counterpart of the JAX package's `ops.*(..., fp=FQ)`: 8 x 32-bit limbs,
little-endian, limbs-first ``(8, *batch)`` int32 tensors, Montgomery form
with R = 2^256 and modulus `params.FQ_MODULUS`, every value normalized
(< q).

This module holds the Montgomery constants and the plain versions, the
algorithms of Fr's (`field/kernels.py`: `mont_mul_plain`, `add_plain`,
`sub_plain`) with q as the modulus.  It has no kernel of its own: on the
card every Fq product lives inside K3 (``csrc/g1.cu`` on ``csrc/fq.cuh``),
and these plain versions serve `curve/g1.py`'s plain G1, which the tests
and `chip_smoke.py`'s comparisons run.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from . import kernels
from .kernels import N_LIMBS
from .params import FQ_MODULUS

Q = FQ_MODULUS
R = 1 << 256
R_MOD_Q = R % Q
R2_MOD_Q = R * R % Q
R_INV = pow(R, -1, Q)
N0 = (-pow(Q, -1, 1 << 32)) % (1 << 32)      # -q^-1 mod 2^32


def mont_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * 2^-256 mod q (a < 2^256, b < q)."""
    return kernels.mont_mul_plain(a, b, Q)


def add_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod q."""
    return kernels.add_plain(a, b, Q)


def sub_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod q."""
    return kernels.sub_plain(a, b, Q)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    """Boolean mask over the batch dims: a == 0."""
    return torch.all(a == 0, dim=0)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """Elementwise select: mask ? a : b (mask has the batch shape)."""
    return torch.where(mask[None], a, b)


# ---------------------------------------------------------------------------
# host <-> limbs
# ---------------------------------------------------------------------------

def mont_words(vals: Sequence[int]) -> np.ndarray:
    """Canonical ints -> their Montgomery forms as (8, n) uint32 words."""
    buf = b"".join((int(v) % Q * R % Q).to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u4").reshape(len(vals), N_LIMBS).T


def pack_ints(vals: Sequence[int], device="cuda") -> torch.Tensor:
    """Canonical ints -> Montgomery limbs (8, len(vals)) on `device`."""
    words = np.array(mont_words(vals), dtype=np.uint32).view(np.int32)
    return torch.from_numpy(words).to(device)


def np_unpack_ints(arr: np.ndarray) -> List[int]:
    """(8, ...) int32/uint32 Montgomery words -> canonical ints."""
    flat = np.ascontiguousarray(
        arr.reshape(N_LIMBS, -1).astype(np.uint32).T)
    raw = flat.astype("<u4").tobytes()
    return [int.from_bytes(raw[32 * i:32 * i + 32], "little") * R_INV % Q
            for i in range(flat.shape[0])]


def unpack_ints(a: torch.Tensor) -> List[int]:
    """Montgomery limbs (8, N) -> canonical ints."""
    return np_unpack_ints(a.cpu().numpy())
