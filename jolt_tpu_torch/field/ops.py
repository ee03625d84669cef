"""BN254 Fr arithmetic on torch tensors of 32-bit limbs.

The port's own field tier (the JAX package keeps 20 x 13-bit limbs because
the TPU has no widening multiply; Hopper has 32x32->64 integer multiplies):

  * 8 limbs x 32 bits, little-endian, stored as ``torch.int32`` holding the
    uint32 bit pattern, limbs-first ``(8, *batch)`` so every limb plane is
    contiguous and neighbouring CUDA threads load neighbouring words;
  * Montgomery form with R = 2^256: a field element x is stored as
    x * R mod p, normalized (< p);
  * ops broadcast over the batch dims, so a scalar is shape ``(8, 1)``.

Compare with the JAX package only as canonical ints (`unpack_ints`,
`interop.from_jax_limbs`): the two Montgomery forms differ (R = 2^260 there).

Every Montgomery product goes through `kernels.mont_mul`: on a CUDA tensor
that is the hand-written kernel (K1, ``csrc/mont_mul.cu``) for every batch
size, on a CPU tensor its plain version.  No lane threshold: the reference's
2048-lane / 128-lane rule sizes Pallas blocks on the TPU, while one launch of
K1 costs less on the card than the ~150 tensor ops of the plain version at
any size.

Overflow bounds of the plain path (int64 working words):
  * add / sub / neg: limbwise sums of two 32-bit limbs plus a carry (< 2^33)
    or differences with a borrow (> -2^33);
  * `mont_mul_plain` (kernels.py): 16-bit sub-limbs, schoolbook columns
    < 16 * (2^16-1)^2 < 2^36, plus reduction terms and carries < 2^38;
  * `sum_mod` / `reduce_cols`: each 32-bit limb plane sums exactly in int64
    for up to 2^31 terms (< 2^63); the carry-out h above 2^256 is < 2^32
    and folds back as h * 2^256 mod p.  Sums are exact mod p and
    order-free, so no lazy chunking like the reference's 2^18-term bound
    (which exists only because of 13-bit limbs) is needed.
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import numpy as np
import torch

from . import kernels
from .kernels import (MASK32, N_LIMBS, P, P_LIMBS, R, R2_MOD_P, R_MOD_P,
                      _pack_limbs, _sub_p_select)

R_INV = pow(R, -1, P)
_I32 = torch.int32


def _limbs_of(x: int) -> List[int]:
    """int (< 2^256) -> 8 little-endian 32-bit words as signed int32 values."""
    out = []
    for i in range(N_LIMBS):
        w = (x >> (32 * i)) & MASK32
        out.append(w - (1 << 32) if w >= 1 << 31 else w)
    return out


@functools.lru_cache(maxsize=4096)
def _limbs_on(x: int, device: torch.device) -> torch.Tensor:
    """The 8 limbs of x as an int32 tensor on `device`, uploaded once per
    (value, device): a host-to-device copy per call was one pageable copy
    and one host round trip for every constant of every round.  Callers
    never write into the result (every op here returns a new tensor)."""
    return torch.tensor(_limbs_of(x), dtype=_I32, device=device)


@functools.lru_cache(maxsize=16)
def _p_words(device: torch.device) -> torch.Tensor:
    """p's 8 words as int64 on `device` (the addend of `sub`), made once."""
    return torch.tensor(P_LIMBS, dtype=torch.int64, device=device)


def _const(x: int, device, ndim: int = 1) -> torch.Tensor:
    return _limbs_on(x, torch.device(device)).reshape(
        (N_LIMBS,) + (1,) * ndim)


def u64_words(a: torch.Tensor) -> torch.Tensor:
    """int32 limbs -> int64 holding the unsigned 32-bit value."""
    return a.to(torch.int64) & MASK32


def _carry(s: torch.Tensor) -> torch.Tensor:
    """Propagate carries of int64 limb sums (any sign, result >= 0 and
    < 2^256) into 32-bit words; returns int64 (8, ...)."""
    out = torch.empty_like(s)
    c = torch.zeros_like(s[0])
    for i in range(N_LIMBS):
        v = s[i] + c
        out[i] = v & MASK32
        c = v >> 32
    return out


# ---------------------------------------------------------------------------
# add / sub / neg / mont_mul
# ---------------------------------------------------------------------------

def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p."""
    a, b = torch.broadcast_tensors(a, b)
    return _pack_limbs(_sub_p_select(_carry(u64_words(a) + u64_words(b))))


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p, as a + (p - b) with one conditional subtract."""
    a, b = torch.broadcast_tensors(a, b)
    p = _p_words(a.device).reshape((N_LIMBS,) + (1,) * (a.dim() - 1))
    # p - b in [1, p]; a + (p - b) < 2p; the cond-subtract maps p to 0
    return _pack_limbs(_sub_p_select(_carry(u64_words(a) + p - u64_words(b))))


def neg(a: torch.Tensor) -> torch.Tensor:
    return sub(torch.zeros_like(a), a)


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a * b * R^-1 mod p (K1 on the card)."""
    return kernels.mont_mul(a, b)


def const_mont(c: int, batch_shape=(), device="cuda") -> torch.Tensor:
    """Constant c in Montgomery form, broadcastable over `batch_shape`."""
    return _const((c % P) * R % P, device, max(len(batch_shape), 1))


def zeros(batch_shape, device="cuda") -> torch.Tensor:
    """The field zero over `batch_shape`: (8, *batch_shape)."""
    return torch.zeros((N_LIMBS,) + tuple(batch_shape), dtype=_I32,
                       device=device)


def ones(batch_shape, device="cuda") -> torch.Tensor:
    """The field one (Montgomery form) broadcast over `batch_shape`, a
    read-only expanded view: (8, *batch_shape)."""
    one = _const(R_MOD_P, device, len(batch_shape))
    return one.expand((N_LIMBS,) + tuple(batch_shape))


# ---------------------------------------------------------------------------
# conversions
# ---------------------------------------------------------------------------

def from_words(words: torch.Tensor) -> torch.Tensor:
    """Plain little-endian 32-bit words (k <= 8, *batch) of a value < p ->
    Montgomery form: one mont_mul by R^2."""
    k = words.shape[0]
    plain = torch.zeros((N_LIMBS,) + tuple(words.shape[1:]), dtype=_I32,
                        device=words.device)
    plain[:k] = words.to(_I32)
    return mont_mul(plain, _const(R2_MOD_P, words.device, words.dim() - 1))


def from_u64(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Unsigned 64-bit values given as two 32-bit words -> Montgomery form."""
    return from_words(torch.stack([lo.to(_I32), hi.to(_I32)]))


def from_u32(x: torch.Tensor) -> torch.Tensor:
    return from_words(x.to(_I32)[None])


def to_canonical(a: torch.Tensor) -> torch.Tensor:
    """Montgomery -> canonical limbs (x mod p): mont_mul by plain 1."""
    return mont_mul(a, _const(1, a.device, a.dim() - 1))


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """Elementwise field select: mask ? a : b (mask has the batch shape)."""
    return torch.where(mask[None], a, b)


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def reduce_cols(cols: torch.Tensor) -> torch.Tensor:
    """Exact int64 limb sums S = sum_i cols[i] 2^(32 i) (each plane a sum of
    < 2^31 words) -> S mod p in Montgomery form.

    S = lo + h * 2^256 with lo < 2^256 and h < 2^32; since every summand is
    Montgomery-form, S mod p = mont_mul(lo, R) + mont_mul(h, R^2)
    (mont_mul by the Montgomery 1 reduces any lo < 2^256 below p)."""
    out = torch.empty_like(cols)
    c = torch.zeros_like(cols[0])
    for i in range(N_LIMBS):
        v = cols[i] + c
        out[i] = v & MASK32
        c = v >> 32
    dev, nd = cols.device, cols.dim() - 1
    lo = mont_mul(_pack_limbs(out), _const(R_MOD_P, dev, nd))
    h = torch.zeros_like(out)
    h[0] = c
    hi = mont_mul(_pack_limbs(h), _const(R2_MOD_P, dev, nd))
    return add(lo, hi)


def sum_mod(a: torch.Tensor) -> torch.Tensor:
    """Sum field elements over the LAST axis -> shape (..., 1)."""
    if a.shape[-1] >= 1 << 31:
        raise ValueError("sum_mod: more than 2^31 terms overflow int64 limbs")
    return reduce_cols(u64_words(a).sum(dim=-1, keepdim=True))


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inner product over the last axis: sum_i a_i * b_i -> (..., 1)."""
    return sum_mod(mont_mul(a, b))


# ---------------------------------------------------------------------------
# host <-> device conversion of Python ints
# ---------------------------------------------------------------------------

def _words_of_ints(vals) -> np.ndarray:
    """Canonical ints -> (8, n) uint32 words (host)."""
    n = len(vals)
    buf = b"".join((int(v) % P).to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u4").reshape(n, N_LIMBS).T


def pack_ints(vals: Sequence[int], device="cuda") -> torch.Tensor:
    """Python ints -> Montgomery limbs (8, len(vals)).  A single scalar
    converts on the host; a list ships canonical words and multiplies by
    R^2 on the device."""
    if len(vals) == 1:
        return _const(int(vals[0]) % P * R % P, device)
    words = torch.from_numpy(_words_of_ints(vals).astype(np.int32))
    return from_words(words.to(device))


def np_unpack_ints(arr: np.ndarray) -> List[int]:
    """(8, ...) int32/uint32 Montgomery words (host) -> canonical ints."""
    flat = np.ascontiguousarray(
        arr.reshape(N_LIMBS, -1).astype(np.uint32).T)
    raw = flat.astype("<u4").tobytes()
    return [int.from_bytes(raw[32 * i:32 * i + 32], "little") * R_INV % P
            for i in range(flat.shape[0])]


def unpack_ints(a: torch.Tensor) -> List[int]:
    """Montgomery limbs (8, N) -> list of canonical Python ints."""
    return np_unpack_ints(a.cpu().numpy())
