"""Vectorized suffix-family evaluation over whole cycle columns.

numpy-uint64 twins of `tables.SUFFIXES` (reference:
`crates/jolt-lookup-tables/src/tables/suffixes/`), evaluated on the
de-interleaved suffix halves of every cycle at once.  Feeds the device
suffix-table kernel in `relations/instruction_read_raf.py`: per phase, each
(group, suffix) stream becomes one masked (lo, hi) u64 pair that the kernel
lifts to Montgomery form and segment-sums by chunk value.

Value convention: a suffix value is returned as (lo, hi) uint64 arrays with
value = hi * 2^64 + lo.  Only the `id` family (the raw suffix integer, up
to 2^120) has a nonzero hi; every other family fits u64 (bounds documented
per function).  Exactness is equivalence-tested against the scalar
`tables.SUFFIXES` oracle in tests/test_lookup_tables.py.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

_U64 = np.uint64
M64 = (1 << 64) - 1


def _z(x):
    return np.zeros_like(x)


def _popcount(v: np.ndarray) -> np.ndarray:
    """uint64 popcount (SWAR)."""
    m1 = _U64(0x5555555555555555)
    m2 = _U64(0x3333333333333333)
    m4 = _U64(0x0F0F0F0F0F0F0F0F)
    h01 = _U64(0x0101010101010101)
    v = v - ((v >> _U64(1)) & m1)
    v = (v & m2) + ((v >> _U64(2)) & m2)
    v = (v + (v >> _U64(4))) & m4
    return (v * h01) >> _U64(56)


def _rsh_fold(xs: np.ndarray, ys: np.ndarray, pairs: int) -> np.ndarray:
    """MSB-first fold e = e*(1+y_p) + x_p*y_p (virtual_srl.rs); result
    < 2^pairs <= 2^60, fits u64."""
    e = _z(xs)
    one = _U64(1)
    for p in range(pairs - 1, -1, -1):
        y = (ys >> _U64(p)) & one
        x = (xs >> _U64(p)) & one
        e = e * (one + y) + x * y
    return e


def _sign_ext(ys: np.ndarray, pairs: int) -> np.ndarray:
    """sum_{p < pairs, y_p = 0} 2^(63-p) < 2^64."""
    acc = _z(ys)
    one = _U64(1)
    for p in range(pairs):
        acc = acc + (one - ((ys >> _U64(p)) & one)) * (one << _U64(63 - p))
    return acc


def _lsh_fold(xs: np.ndarray, ys: np.ndarray, pairs: int) -> np.ndarray:
    """Rotate wrap mass sum_p x_p*(1-y_p)*2^p*prod_{q>p}(1+y_q) over the
    low `pairs` bit pairs (virtual_rotr.rs second_sum); every term is a
    distinct power of two <= 2^63, fits u64."""
    acc = _z(xs)
    prod = np.ones_like(xs)
    one = _U64(1)
    for p in range(pairs - 1, -1, -1):
        yp = (ys >> _U64(p)) & one
        xp = (xs >> _U64(p)) & one
        acc = acc + xp * (one - yp) * prod * (one << _U64(p))
        prod = prod * (one + yp)
    return acc


def _xor_rot(v: np.ndarray, rot: int, pairs: int, xlen: int) -> np.ndarray:
    """sum_{p < pairs} bit_p(v) * 2^((p - rot) mod xlen): the suffix part
    of the xor-rotate tables (weights at GLOBAL target positions)."""
    acc = _z(v)
    one = _U64(1)
    for p in range(pairs):
        acc = acc + (((v >> _U64(p)) & one) << _U64((p - rot) % xlen))
    return acc


def eval_suffix(name: str, xs: np.ndarray, ys: np.ndarray,
                s_lo: np.ndarray, s_hi: np.ndarray,
                L: int) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized `tables.SUFFIXES[name](xs, ys, s, L)`.

    xs, ys: de-interleaved suffix halves (L//2 bits each, u64);
    s_lo/s_hi: the raw suffix integer s = s_hi*2^64 + s_lo.  Returns
    (lo, hi) u64 arrays."""
    half = L // 2
    ones_h = _U64(((1 << half) - 1) & M64)
    one = _U64(1)
    b = lambda cond: cond.astype(_U64)

    if name == "one":
        return np.ones_like(xs), _z(xs)
    if name == "and":
        return xs & ys, _z(xs)
    if name == "or":
        return xs | ys, _z(xs)
    if name == "xor":
        return xs ^ ys, _z(xs)
    if name == "eq":
        return b(xs == ys), _z(xs)
    if name == "ltu":
        return b(xs < ys), _z(xs)
    if name == "low64":
        return s_lo, _z(xs)
    if name == "alow64":
        return s_lo & _U64(M64 - 1), _z(xs)
    if name == "hi64":
        return s_hi, _z(xs)
    if name == "left":
        return xs, _z(xs)
    if name == "right":
        return ys, _z(xs)
    if name == "id":
        return s_lo, s_hi
    if name == "rsh":
        return _rsh_fold(xs, ys, half), _z(xs)
    if name == "rsh_helper":
        return one << _popcount(ys), _z(xs)
    if name == "sign_ext":
        return _sign_ext(ys, half), _z(xs)
    if name == "pow2":
        return one << (s_lo & _U64(63)), _z(xs)
    if name == "pow2w":
        return one << (s_lo & _U64(31)), _z(xs)
    if name == "zerox":
        return b(xs == 0), _z(xs)
    if name == "zeroy":
        return b(ys == 0), _z(xs)
    if name in ("zerox_onesy", "chdiv"):
        return b((xs == 0) & (ys == ones_h)), _z(xs)
    if name == "chdivw":
        xpat = _U64(((((1 << half) - 1) >> 31) << 31) & M64)
        return b((ys == ones_h) & (xs == xpat)), _z(xs)
    if name == "hizero":
        return b(s_hi == 0), _z(xs)
    if name == "nbit0":
        if L == 0:
            return np.ones_like(xs), _z(xs)
        return b((s_lo & one) == 0), _z(xs)
    if name == "align4":
        if L == 0:
            return np.ones_like(xs), _z(xs)
        return b((s_lo & _U64(3)) == 0), _z(xs)
    if name == "low32":
        return s_lo & _U64(0xFFFFFFFF), _z(xs)
    if name == "bit31":
        return (s_lo >> _U64(31)) & one, _z(xs)
    # ---- inline-extension families ------------------------------------
    if name == "andn":
        return xs & ~ys, _z(xs)   # xs/ys pre-masked to half bits
    if name == "lsh":
        return _lsh_fold(xs, ys, half), _z(xs)
    if name == "lshw":
        return _lsh_fold(xs, ys, min(half, 32)), _z(xs)
    if name == "rshw":
        return _rsh_fold(xs, ys, min(half, 32)), _z(xs)
    if name == "rshw_helper":
        return one << _popcount(ys & _U64(0xFFFFFFFF)), _z(xs)
    if name == "rev8w":
        out = _z(s_lo)
        for k in range(8):
            g0 = 8 * k
            if g0 >= L:
                break
            kp = 3 - k if k < 4 else 11 - k
            bmask = _U64(0xFF if L - g0 >= 8 else (1 << (L - g0)) - 1)
            byte = (s_lo >> _U64(g0)) & bmask
            out = out | (byte << _U64(8 * kp))
        return out, _z(s_lo)
    if name.startswith("xor_rotw"):
        r = int(name[len("xor_rotw"):])
        return _xor_rot(xs ^ ys, r, min(half, 32), 32), _z(xs)
    if name.startswith("xor_rot"):
        r = int(name[len("xor_rot"):])
        return _xor_rot(xs ^ ys, r, half, 64), _z(xs)
    raise KeyError(f"unknown suffix family {name}")
