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

from . import kernels, ops
from .kernels import N_LIMBS
from .params import FQ_MODULUS

Q = FQ_MODULUS
R = 1 << 256
R_MOD_Q = R % Q
R2_MOD_Q = R * R % Q
R_INV = pow(R, -1, Q)
N0 = (-pow(Q, -1, 1 << 32)) % (1 << 32)      # -q^-1 mod 2^32


# CPU batches of at most this many elements take the plain versions on
# Python ints: each result is the one value < q that the limb algorithm
# gives too, and a small batch costs ~0.1 ms instead of ~1 ms of torch ops
# (a 254-bit plain scalar_mul over a few lanes: ~0.7 s instead of ~4.5 s)
_INT_PATH = 512


def _small(a: torch.Tensor, b: torch.Tensor):
    """The two operands broadcast, as flat lists of ints when they are a
    small CPU batch (`_INT_PATH`), else None."""
    a, b = torch.broadcast_tensors(a, b)
    if a.device.type != "cpu" or a[0].numel() > _INT_PATH:
        return a, b, None
    return a, b, (_flat_ints(a), _flat_ints(b))


def _flat_ints(a: torch.Tensor) -> List[int]:
    raw = np.ascontiguousarray(
        a.reshape(N_LIMBS, -1).to(torch.int32).numpy().view(np.uint32).T
    ).tobytes()
    return [int.from_bytes(raw[i:i + 32], "little")
            for i in range(0, len(raw), 32)]


def _from_ints(vals: Sequence[int], like: torch.Tensor) -> torch.Tensor:
    buf = b"".join(v.to_bytes(32, "little") for v in vals)
    words = np.frombuffer(buf, "<u4").view(np.int32).reshape(-1, N_LIMBS)
    return torch.from_numpy(words.T.copy()).reshape(like.shape)


def mont_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * 2^-256 mod q (a < 2^256, b < q)."""
    a, b, ints = _small(a, b)
    if ints is None:
        return kernels.mont_mul_plain(a, b, Q)
    return _from_ints([x * y * R_INV % Q for x, y in zip(*ints)], a)


def add_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod q: the sum, less q where it reaches q."""
    a, b, ints = _small(a, b)
    if ints is None:
        return kernels.add_plain(a, b, Q)
    return _from_ints([s - Q if s >= Q else s
                       for s in (x + y for x, y in zip(*ints))], a)


def sub_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod q: the difference, plus q where it borrows."""
    a, b, ints = _small(a, b)
    if ints is None:
        return kernels.sub_plain(a, b, Q)
    return _from_ints([d + Q if d < 0 else d
                       for d in (x - y for x, y in zip(*ints))], a)


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
    return ops.upload(words, device)


def np_unpack_ints(arr: np.ndarray) -> List[int]:
    """(8, ...) int32/uint32 Montgomery words -> canonical ints."""
    flat = np.ascontiguousarray(
        arr.reshape(N_LIMBS, -1).astype(np.uint32).T)
    raw = flat.astype("<u4").tobytes()
    return [int.from_bytes(raw[32 * i:32 * i + 32], "little") * R_INV % Q
            for i in range(flat.shape[0])]


def unpack_ints(a: torch.Tensor) -> List[int]:
    """Montgomery limbs (8, N) -> canonical ints."""
    return np_unpack_ints(ops.host(a))
