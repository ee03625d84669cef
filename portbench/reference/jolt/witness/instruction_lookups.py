"""Instruction-lookup witness: per-cycle lookup indices, table choices,
and the d-chunked one-hot address decomposition.

Reference: `crates/jolt-prover-legacy/src/zkvm/instruction_lookups/mod.rs`
(LOG_K = 128), `zkvm/witness.rs:24-74` (CommittedPolynomial::InstructionRa(i)),
`zkvm/config.rs:175-210` (OneHotParams: log_k_chunk=8 -> d=16 committed
one-hot chunk selectors ra_i(k_i, j), each over 2^8 rows).

The lookup index is derived from the SAME shaped operands the R1CS
constrains (`witness/r1cs_inputs.py` left/right lookup operand columns), so
the read-raf sumcheck closes the loop: R1CS shapes operands ->  raf ties the
one-hot index to the operands -> read ties LookupOutput to the table MLE at
the index -> R1CS routes LookupOutput into rd/branch/jump semantics.

Extraction is fully vectorized (numpy): the 128-bit interleave runs through
a 16-bit Morton spread table, chunks come from u64 shifts, and the prover
self-check (LookupOutput column == table entry -- the reference's
debug-assert at witness generation) evaluates each table's closed form on
whole operand arrays.
"""

from __future__ import annotations


import numpy as np

from ..lookups import tables as LT

M64 = (1 << 64) - 1
_U64 = np.uint64

# OneHotParams: log_k_chunk = 8, d = LOG_K / log_k_chunk = 16
LOG_M = 8
D = LT.LOG_K // LOG_M  # 16


# ---------------------------------------------------------------------------
# vectorized interleave (Morton): 16-bit spread table
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# vectorized table entries (the prover self-check closed forms)
#
# `split` tables consume the de-interleaved operands (x, y); `raw` tables
# consume the index halves (lo, hi).  Semantics mirror TABLES[...]["entry"]
# exactly on honest witnesses (equivalence-tested in tests/test_lookup_tables).
# ---------------------------------------------------------------------------

def _i64(v):
    return v.astype(np.uint64).view(np.int64)


def _rsh_fold_vec(x, y):
    """MSB-first fold of virtual_srl.rs, vectorized over cycles."""
    e = np.zeros_like(x)
    one = _U64(1)
    for p in range(63, -1, -1):
        yp = (y >> _U64(p)) & one
        xp = (x >> _U64(p)) & one
        e = e * (one + yp) + xp * yp
    return e


def _sra_mass(x, y):
    """Sign-extension mass: x_63 * sum_{p<63, y_p=0} 2^(63-p)."""
    m = np.zeros_like(x)
    one = _U64(1)
    for p in range(63):
        clear = one - ((y >> _U64(p)) & one)
        m = m + clear * (one << _U64(63 - p))
    return ((x >> _U64(63)) & one) * m


def _b(v):
    return v.astype(_U64)


def _lsh_fold_vec(x, y, pairs=64):
    """Rotate wrap mass (virtual_rotr.rs second_sum), vectorized."""
    acc = np.zeros_like(x)
    prod = np.ones_like(x)
    one = _U64(1)
    for p in range(pairs - 1, -1, -1):
        yp = (y >> _U64(p)) & one
        xp = (x >> _U64(p)) & one
        acc = acc + xp * (one - yp) * prod * (one << _U64(p))
        prod = prod * (one + yp)
    return acc


def _rsh_fold_w(x, y):
    """rsh fold over the low 32 pairs only (virtual_rotrw.rs)."""
    e = np.zeros_like(x)
    one = _U64(1)
    for p in range(31, -1, -1):
        yp = (y >> _U64(p)) & one
        xp = (x >> _U64(p)) & one
        e = e * (one + yp) + xp * yp
    return e


def _rotr_vec(v, r, bits):
    mask = _U64(M64 if bits == 64 else (1 << bits) - 1)
    v = v & mask
    return ((v >> _U64(r)) | (v << _U64(bits - r))) & mask


def _rev8w_vec(lo, hi):
    out = np.zeros_like(lo)
    for k in range(8):
        kp = 3 - k if k < 4 else 11 - k
        byte = (lo >> _U64(8 * k)) & _U64(0xFF)
        out = out | (byte << _U64(8 * kp))
    return out


_VEC_ENTRIES = {
    # raw: f(lo, hi)
    "RangeCheck": ("raw", lambda lo, hi: lo),
    "RangeCheckAligned": ("raw", lambda lo, hi: lo & _U64(M64 - 1)),
    "UpperWord": ("raw", lambda lo, hi: hi),
    "Pow2": ("raw", lambda lo, hi: _U64(1) << (lo & _U64(63))),
    "Pow2W": ("raw", lambda lo, hi: _U64(1) << (lo & _U64(31))),
    "ShiftRightBitmask": ("raw",
                          lambda lo, hi: _U64(0) - (_U64(1) << (lo & _U64(63)))),
    "SignExtendHalfWord": ("raw", lambda lo, hi: (lo & _U64(0xFFFFFFFF)) | (
        ((lo >> _U64(31)) & _U64(1)) * _U64(0xFFFFFFFF00000000))),
    "LowerHalfWord": ("raw", lambda lo, hi: lo & _U64(0xFFFFFFFF)),
    "HalfwordAlignment": ("raw", lambda lo, hi: _b((lo & _U64(1)) == 0)),
    "WordAlignment": ("raw", lambda lo, hi: _b((lo & _U64(3)) == 0)),
    "MulUNoOverflow": ("raw", lambda lo, hi: _b(hi == 0)),
    # split: f(x, y) on de-interleaved operands
    "And": ("split", lambda x, y: x & y),
    "Or": ("split", lambda x, y: x | y),
    "Xor": ("split", lambda x, y: x ^ y),
    "Equal": ("split", lambda x, y: _b(x == y)),
    "NotEqual": ("split", lambda x, y: _b(x != y)),
    "UnsignedLessThan": ("split", lambda x, y: _b(x < y)),
    "SignedLessThan": ("split", lambda x, y: _b(_i64(x) < _i64(y))),
    "UnsignedGreaterThanEqual": ("split", lambda x, y: _b(x >= y)),
    "SignedGreaterThanEqual": ("split", lambda x, y: _b(_i64(x) >= _i64(y))),
    "UnsignedLessThanEqual": ("split", lambda x, y: _b(x <= y)),
    "SignMask": ("split",
                 lambda x, y: ((x >> _U64(63)) & _U64(1)) * _U64(M64)),
    "ValidDiv0": ("split",
                  lambda x, y: np.where(x != 0, _U64(1), _b(y == _U64(M64)))),
    "ValidUnsignedRemainder": ("split",
                               lambda x, y: _b((y == 0) | (x < y))),
    "VirtualChangeDivisor": ("split", lambda x, y: np.where(
        (x == _U64(1 << 63)) & (y == _U64(M64)), _U64(1), y)),
    "VirtualChangeDivisorW": ("split", lambda x, y: np.where(
        (x == _U64(0xFFFFFFFF80000000)) & (y == _U64(M64)), _U64(1), y)),
    "VirtualSRL": ("split", _rsh_fold_vec),
    "VirtualSRA": ("split", lambda x, y: _rsh_fold_vec(x, y) + _sra_mass(x, y)),
    # inline-extension tables
    "Andn": ("split", lambda x, y: x & ~y),
    "VirtualROTR": ("split",
                    lambda x, y: _rsh_fold_vec(x, y) + _lsh_fold_vec(x, y)),
    "VirtualROTRW": ("split",
                     lambda x, y: _rsh_fold_w(x, y) + _lsh_fold_vec(x, y, 32)),
    "VirtualRev8W": ("raw", _rev8w_vec),
}
for _rot in (16, 24, 32, 63):
    _VEC_ENTRIES[f"VirtualXORROT{_rot}"] = (
        "split", lambda x, y, R=_rot: _rotr_vec(x ^ y, R, 64))
for _rot in (7, 8, 12, 16):
    _VEC_ENTRIES[f"VirtualXORROTW{_rot}"] = (
        "split", lambda x, y, R=_rot: _rotr_vec(x ^ y, R, 32))
assert set(_VEC_ENTRIES) == set(LT.TABLE_NAMES)
