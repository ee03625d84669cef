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

import dataclasses
from typing import List

import numpy as np

from ..field.params import FR
from ..lookups import tables as LT
from ..riscv import isa
from ..tracer.trace import Trace
from . import flags as F
from .r1cs_inputs import (R1CSCycleInputs, V_LEFT_LOOKUP_OPERAND,
                          V_LOOKUP_OUTPUT, V_RIGHT_LOOKUP_OPERAND)

P = FR.modulus
M64 = (1 << 64) - 1
_U64 = np.uint64

# OneHotParams: log_k_chunk = 8, d = LOG_K / log_k_chunk = 16
LOG_M = 8
M = 1 << LOG_M
D = LT.LOG_K // LOG_M  # 16


@dataclasses.dataclass
class InstructionLookupWitness:
    indices: List[int]       # [T] 128-bit lookup indices (exact ints)
    table_ids: List[int]     # [T] index into LT.TABLE_NAMES, or -1
    interleaved: List[int]   # [T] 1 = interleaved-operand instruction
    chunks: np.ndarray       # [D, T] uint32: chunk c of each index,
    #                          chunk 0 = most-significant LOG_M bits
    T: int
    # vectorized views consumed by the device suffix-table kernel
    idx_lo: np.ndarray = None   # [T] u64: low 64 index bits
    idx_hi: np.ndarray = None   # [T] u64: high 64 index bits
    x64: np.ndarray = None      # [T] u64: de-interleaved left operand
    y64: np.ndarray = None      # [T] u64: de-interleaved right operand
    table_ids_np: np.ndarray = None   # [T] int32 (-1 = no table)
    inter_np: np.ndarray = None       # [T] bool

    def __post_init__(self):
        if self.idx_lo is None:   # hand-built witnesses (tests): derive
            self.idx_lo = np.array([i & M64 for i in self.indices], _U64)
            self.idx_hi = np.array([(i >> 64) & M64 for i in self.indices],
                                   _U64)
            self.x64, self.y64 = _unmorton(self.idx_lo, self.idx_hi)
            self.table_ids_np = np.asarray(self.table_ids, np.int32)
            self.inter_np = np.asarray(self.interleaved, bool)

    def onehot_chunk(self, i: int) -> List[int]:
        """Committed InstructionRa(i): cycle-major one-hot [M*T]."""
        out = [0] * (M * self.T)
        col = self.chunks[i]
        for j in range(self.T):
            out[j * M + int(col[j])] = 1
        return out


# ---------------------------------------------------------------------------
# vectorized interleave (Morton): 16-bit spread table
# ---------------------------------------------------------------------------

_SPREAD16 = None


def _spread16() -> np.ndarray:
    global _SPREAD16
    if _SPREAD16 is None:
        x = np.arange(65536, dtype=_U64)
        x = (x | (x << _U64(8))) & _U64(0x00FF00FF)
        x = (x | (x << _U64(4))) & _U64(0x0F0F0F0F)
        x = (x | (x << _U64(2))) & _U64(0x33333333)
        x = (x | (x << _U64(1))) & _U64(0x55555555)
        _SPREAD16 = x
    return _SPREAD16


def _morton(x: np.ndarray, y: np.ndarray):
    """(lo64, hi64) of interleave_bits(x, y): y at even, x at odd bits."""
    S = _spread16()
    m16 = _U64(0xFFFF)

    def parts(v):
        return [S[((v >> _U64(16 * i)) & m16).astype(np.int64)]
                for i in range(4)]

    xp, yp = parts(x), parts(y)
    lo = yp[0] | (yp[1] << _U64(32)) | ((xp[0] | (xp[1] << _U64(32))) << _U64(1))
    hi = yp[2] | (yp[3] << _U64(32)) | ((xp[2] | (xp[3] << _U64(32))) << _U64(1))
    return lo, hi


def _compact_even(v: np.ndarray) -> np.ndarray:
    """Gather the bits at even positions of a u64 into the low 32 bits."""
    v = v & _U64(0x5555555555555555)
    v = (v | (v >> _U64(1))) & _U64(0x3333333333333333)
    v = (v | (v >> _U64(2))) & _U64(0x0F0F0F0F0F0F0F0F)
    v = (v | (v >> _U64(4))) & _U64(0x00FF00FF00FF00FF)
    v = (v | (v >> _U64(8))) & _U64(0x0000FFFF0000FFFF)
    return (v | (v >> _U64(16))) & _U64(0x00000000FFFFFFFF)


def _unmorton(lo: np.ndarray, hi: np.ndarray):
    """Vectorized `uninterleave_bits`: (x, y) halves of the 128-bit index
    (y = even bits, x = odd bits)."""
    y = _compact_even(lo) | (_compact_even(hi) << _U64(32))
    x = _compact_even(lo >> _U64(1)) | (_compact_even(hi >> _U64(1)) << _U64(32))
    return x, y


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

# per-kind static metadata indexed by numeric kind id
_KIND_META = None


def _kind_meta():
    global _KIND_META
    if _KIND_META is None:
        n = len(isa.KINDS)
        inter = np.zeros(n, dtype=bool)
        tid = np.full(n, -1, dtype=np.int32)
        no_inter = {"AddOperands", "SubtractOperands", "MultiplyOperands",
                    "Advice"}
        for kid in range(n):
            kind = isa.KINDS[kid]
            cf = F.FLAGS[kind][0]
            inter[kid] = not (no_inter & set(cf))
            tname = LT.KIND_TABLE.get(kind)
            if tname is not None:
                tid[kid] = LT.TABLE_INDEX[tname]
        _KIND_META = (inter, tid)
    return _KIND_META


def extract_instruction_lookup_witness(
        trace: Trace, inputs: R1CSCycleInputs) -> InstructionLookupWitness:
    T = inputs.T
    kid = np.asarray(trace.col("kind"), dtype=np.int64)[:T]
    inter_by_kid, tid_by_kid = _kind_meta()
    inter = inter_by_kid[kid]
    table_ids_np = tid_by_kid[kid]

    left = inputs.lo[V_LEFT_LOOKUP_OPERAND]
    r_lo = inputs.lo[V_RIGHT_LOOKUP_OPERAND]
    r_hi = inputs.hi[V_RIGHT_LOOKUP_OPERAND]
    out64 = inputs.lo[V_LOOKUP_OUTPUT]

    # non-interleaved indices are the raw u128 operand with left == 0
    # (`instructions/riscv/add.rs:10-17`); a nonzero left there is a
    # witness-extraction bug, not a provable state
    if (left[~inter] != 0).any() or (r_hi[inter] != 0).any():
        raise ValueError("lookup operand shape violates interleave class")
    m_lo, m_hi = _morton(left, r_lo)
    idx_lo = np.where(inter, m_lo, r_lo)
    idx_hi = np.where(inter, m_hi, r_hi)

    chunks = np.zeros((D, T), dtype=np.uint32)
    for i in range(8):
        chunks[i] = ((idx_hi >> _U64(56 - 8 * i)) & _U64(0xFF)).astype(np.uint32)
        chunks[8 + i] = ((idx_lo >> _U64(56 - 8 * i)) & _U64(0xFF)).astype(np.uint32)

    # prover self-check: the R1CS LookupOutput column must equal the table
    # entry at the index (zkvm witness-gen debug assert analog)
    bad = (table_ids_np < 0) & (out64 != 0)
    if bad.any():
        j = int(np.nonzero(bad)[0][0])
        raise ValueError(
            f"nonzero LookupOutput for no-table {isa.KINDS[int(kid[j])]}@{j}")
    for t in np.unique(table_ids_np):
        if t < 0:
            continue
        name = LT.TABLE_NAMES[t]
        mask = table_ids_np == t
        basis, fn = _VEC_ENTRIES[name]
        want = (fn(idx_lo[mask], idx_hi[mask]) if basis == "raw"
                else fn(left[mask], r_lo[mask]))
        got = out64[mask]
        if (got != want).any():
            rel = int(np.nonzero(got != want)[0][0])
            j = int(np.nonzero(mask)[0][rel])
            raise ValueError(
                f"lookup output mismatch at cycle {j} "
                f"({isa.KINDS[int(kid[j])]}): column {int(out64[j])} vs table "
                f"{LT.table_entry(name, (int(idx_hi[j]) << 64) | int(idx_lo[j]))}")

    hi_list = idx_hi.tolist()
    lo_list = idx_lo.tolist()
    indices = [(h << 64) | l for h, l in zip(hi_list, lo_list)]
    x_half, y_half = _unmorton(idx_lo, idx_hi)
    return InstructionLookupWitness(
        indices=indices, table_ids=table_ids_np.tolist(),
        interleaved=inter.astype(np.int64).tolist(), chunks=chunks, T=T,
        idx_lo=idx_lo, idx_hi=idx_hi, x64=x_half, y64=y_half,
        table_ids_np=table_ids_np.astype(np.int32), inter_np=inter)
