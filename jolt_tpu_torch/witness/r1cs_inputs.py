"""Trace -> per-cycle R1CS witness variables (the 38-column z vector).

Mirrors `crates/jolt-prover-legacy/src/zkvm/r1cs/inputs.rs` +
`crates/jolt-witness/src/witnesses/operands.rs`:

  * instruction inputs: left = rs1 | PC | 0, right = rs2 | imm-masked | 0
    (all masked to unsigned 64-bit -- operand signedness is handled by the
    lookup tables, `instructions/riscv/addi.rs:10-19`)
  * Product = left * right as an exact integer (`operands.rs:122-133`)
  * lookup operands per the Add/Sub/Mul shaping flags
    (`instructions/riscv/{add,sub,mul}.rs` to_lookup_operands)
  * Imm enters the field *signed* (`operands.rs:135-139`)

Values are exact Python ints (possibly >64-bit, possibly negative) reduced
mod p at field packing time.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from ..field.params import FR
from ..lookups import tables as LT
from ..riscv import isa
from ..tracer.trace import Trace
from . import flags as F

P = FR.modulus
M64 = (1 << 64) - 1

# Variable indices (crates/jolt-r1cs/src/constraints/rv64.rs:22-64)
V_CONST = 0
V_LEFT_INSTRUCTION_INPUT = 1
V_RIGHT_INSTRUCTION_INPUT = 2
V_PRODUCT = 3
V_SHOULD_BRANCH = 4
V_PC = 5
V_UNEXPANDED_PC = 6
V_IMM = 7
V_RAM_ADDRESS = 8
V_RS1_VALUE = 9
V_RS2_VALUE = 10
V_RD_WRITE_VALUE = 11
V_RAM_READ_VALUE = 12
V_RAM_WRITE_VALUE = 13
V_LEFT_LOOKUP_OPERAND = 14
V_RIGHT_LOOKUP_OPERAND = 15
V_NEXT_UNEXPANDED_PC = 16
V_NEXT_PC = 17
V_NEXT_IS_VIRTUAL = 18
V_NEXT_IS_FIRST_IN_SEQUENCE = 19
V_LOOKUP_OUTPUT = 20
V_SHOULD_JUMP = 21
V_FLAG_BASE = 22           # 14 circuit flags in CIRCUIT_FLAGS order
V_BRANCH = 36
V_NEXT_IS_NOOP = 37
NUM_VARS = 38

VAR_NAMES = (
    ["const", "left_input", "right_input", "product", "should_branch", "pc",
     "unexpanded_pc", "imm", "ram_address", "rs1_value", "rs2_value",
     "rd_write_value", "ram_read_value", "ram_write_value",
     "left_lookup_operand", "right_lookup_operand", "next_unexpanded_pc",
     "next_pc", "next_is_virtual", "next_is_first_in_sequence",
     "lookup_output", "should_jump"]
    + [f"flag_{name}" for name in F.CIRCUIT_FLAGS]
    + ["branch", "next_is_noop"]
)


def _s64(x: int) -> int:
    return x - (1 << 64) if x >> 63 else x


def _lookup_output(kind: str, rs1: int, rs2: int, imm: int, pc: int,
                   rd_post: int) -> int:
    """Per-kind lookup output (jolt-lookup-tables/src/instructions/riscv/*).

    For WriteLookupOutputToRD instructions the output equals the value
    written to rd; branches produce the comparison bit; jumps the target;
    asserts are 1 on any honest trace (the extractor's table self-check
    rejects a violating trace before proving)."""
    if F.circuit_flag(kind, "Assert"):
        return 1
    if F.circuit_flag(kind, "WriteLookupOutputToRD"):
        return rd_post
    if F.instruction_flag(kind, "Branch"):
        a, b = rs1, rs2
        return {
            "BEQ": a == b, "BNE": a != b,
            "BLT": _s64(a) < _s64(b), "BGE": _s64(a) >= _s64(b),
            "BLTU": a < b, "BGEU": a >= b,
        }[kind] and 1 or 0
    if kind == "JAL":
        return (pc + imm) & M64
    if kind == "JALR":
        return (rs1 + imm) & M64 & ~1
    return 0


# columns whose exact value is signed (two's-complement 128-bit lo/hi);
# everything else is an unsigned 128-bit (lo, hi) pair
SIGNED_COLS = frozenset([V_IMM, V_RAM_ADDRESS])


@dataclasses.dataclass
class R1CSCycleInputs:
    """All 38 columns as (lo, hi) u64 numpy pairs of padded-trace length.

    The exact integer of column v at cycle j is hi*2^64 + lo, minus 2^128
    when v is in SIGNED_COLS and bit 127 is set.  `columns` / `col()`
    materialize exact Python-int lists lazily (the compatibility surface
    for the satisfaction checker and tests); the prover's device on-ramp
    (`spartan_outer.pack_input_columns`) lifts lo/hi directly."""

    lo: np.ndarray             # (NUM_VARS, T) uint64
    hi: np.ndarray             # (NUM_VARS, T) uint64
    T: int

    _columns: List = None

    @property
    def columns(self) -> List[List[int]]:
        if self._columns is None:
            self._columns = [self.col(i) for i in range(NUM_VARS)]
        return self._columns

    def col(self, idx: int) -> List[int]:
        if self._columns is not None:
            return self._columns[idx]
        lo = self.lo[idx].tolist()
        hi = self.hi[idx].tolist()
        if idx in SIGNED_COLS:
            return [(h << 64 | l) - (1 << 128 if h >> 63 else 0)
                    for l, h in zip(lo, hi)]
        return [(h << 64) | l for l, h in zip(lo, hi)]


def row_circuit_flags(row) -> frozenset:
    """Kind flags + per-row sequence flags (VirtualInstruction,
    IsFirst/IsLastInSequence, DoNotUpdateUnexpandedPC on every non-final
    sequence row, and IsCompressed for RVC source instructions)."""
    cf = set(F.FLAGS[row.kind][0])
    if row.virtual:
        cf.add("VirtualInstruction")
        if row.first:
            cf.add("IsFirstInSequence")
        if row.last:
            cf.add("IsLastInSequence")
        else:
            cf.add("DoNotUpdateUnexpandedPC")
    if getattr(row, "compressed", False):
        cf.add("IsCompressed")
    return frozenset(cf)


_HALT_ROW = None


def halt_row():
    """The one-past-the-end bytecode row (NOOP); trace padding rows point
    here, as do cycles that fall off the end of the program."""
    global _HALT_ROW
    if _HALT_ROW is None:
        from ..riscv.program import Row
        _HALT_ROW = Row(kind="NOOP", address=0)
    return _HALT_ROW


# ---------------------------------------------------------------------------
# vectorized extraction: per-kind static tables + per-program row tables
# ---------------------------------------------------------------------------

_U64 = np.uint64
_KIND_TABLES = None


def _kind_tables():
    """Static per-kind metadata as numpy tables (built once)."""
    global _KIND_TABLES
    if _KIND_TABLES is None:
        n = len(isa.KINDS)
        cf = np.zeros((n, len(F.CIRCUIT_FLAGS)), bool)
        inf = np.zeros((n, len(F.INSTRUCTION_FLAGS)), bool)
        provable = np.zeros(n, bool)
        br_id = np.full(n, -1, np.int32)   # BEQ..BGEU -> 0..5
        jal = np.zeros(n, bool)
        jalr = np.zeros(n, bool)
        eff_kind = np.zeros(n, np.int8)    # 0 none, 1 SLLI, 2 SRLI/SRAI
        branches = ["BEQ", "BNE", "BLT", "BGE", "BLTU", "BGEU"]
        for kid, kind in enumerate(isa.KINDS):
            fl = F.FLAGS.get(kind)
            if fl is None:
                continue
            for fi, fname in enumerate(F.CIRCUIT_FLAGS):
                cf[kid, fi] = fname in fl[0]
            for fi, fname in enumerate(F.INSTRUCTION_FLAGS):
                inf[kid, fi] = fname in fl[1]
            provable[kid] = kind in F.PROVABLE_KINDS
            if kind in branches:
                br_id[kid] = branches.index(kind)
            jal[kid] = kind == "JAL"
            jalr[kid] = kind == "JALR"
            if kind == "SLLI":
                eff_kind[kid] = 1
            elif kind in ("SRLI", "SRAI"):
                eff_kind[kid] = 2
        _KIND_TABLES = dict(cf=cf, inf=inf, provable=provable, br=br_id,
                            jal=jal, jalr=jalr, eff=eff_kind)
    return _KIND_TABLES


def _program_tables(program):
    """Per-row static arrays for a program (cached on the object):
    kind id, imm as (lo u64, neg bool), virtual/first/last."""
    tabs = getattr(program, "_r1cs_row_tables", None)
    if tabs is not None:
        return tabs
    n = program.n_rows
    kid = np.zeros(n + 1, np.int32)
    imm_lo = np.zeros(n + 1, _U64)
    imm_neg = np.zeros(n + 1, bool)
    virt = np.zeros(n + 1, bool)
    first = np.zeros(n + 1, bool)
    last = np.zeros(n + 1, bool)
    comp = np.zeros(n + 1, bool)
    noop_id = isa.KIND_ID["NOOP"]
    kid[n] = noop_id   # one-past-the-end halt row
    for i, row in enumerate(program.rows):
        kid[i] = isa.KIND_ID[row.kind]
        v = row.imm
        assert -(1 << 63) <= v < (1 << 64), "row imm out of modeled range"
        imm_lo[i] = _U64(v & M64)
        imm_neg[i] = v < 0
        virt[i] = row.virtual
        first[i] = row.first
        last[i] = row.last
        comp[i] = row.compressed
    tabs = dict(kid=kid, imm_lo=imm_lo, imm_neg=imm_neg, virt=virt,
                first=first, last=last, comp=comp, noop=noop_id)
    program._r1cs_row_tables = tabs
    return tabs


def _mulhi64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """High 64 bits of a*b (u64 x u64 schoolbook on 32-bit halves)."""
    m32 = _U64(0xFFFFFFFF)
    a0, a1 = a & m32, a >> _U64(32)
    b0, b1 = b & m32, b >> _U64(32)
    t = a0 * b0
    k = t >> _U64(32)
    t = a1 * b0 + k
    w1 = t & m32
    w2 = t >> _U64(32)
    t = a0 * b1 + w1
    return a1 * b1 + w2 + (t >> _U64(32))


def extract_r1cs_inputs(trace: Trace, strict: bool = True) -> R1CSCycleInputs:
    """Fully vectorized (numpy) witness extraction -- no per-cycle Python.

    Semantics identical to the reference mapping documented in the module
    docstring; equivalence with the per-cycle scalar path is pinned by the
    satisfaction tests (tests/test_r1cs.py) and the eval fuzz harness."""
    T = trace.padded_length
    kid = np.asarray(trace.col("kind"), np.int64)
    program = trace.program
    KT = _kind_tables()

    if strict:
        bad = ~KT["provable"][kid]
        if bad.any():
            j = int(np.nonzero(bad)[0][0])
            raise ValueError(
                f"{isa.KINDS[int(kid[j])]} at cycle {j} is not a final "
                f"bytecode row (expansion bug)")

    def u64(name):
        lo, hi = trace.u64_col(name)
        return lo.astype(_U64) | (hi.astype(_U64) << _U64(32))

    pc = u64("pc")
    pc_idx = u64("pc_idx")
    rs1v = u64("rs1_val")
    rs2v = u64("rs2_val")
    rd_post = u64("rd_post")
    ram_pre = u64("ram_pre")
    ram_post = u64("ram_post")

    # per-cycle bytecode-row statics (halt row for out-of-range pc_idx)
    if program is not None:
        PT = _program_tables(program)
        k_idx = np.minimum(pc_idx, _U64(program.n_rows)).astype(np.int64)
        row_kid = PT["kid"][k_idx]
        mism = (row_kid != kid) & (kid != PT["noop"])
        if mism.any():
            j = int(np.nonzero(mism)[0][0])
            raise ValueError(
                f"trace kind {isa.KINDS[int(kid[j])]} at cycle {j} disagrees "
                f"with bytecode row {int(k_idx[j])} "
                f"({isa.KINDS[int(row_kid[j])]})")
        imm_lo = PT["imm_lo"][k_idx].copy()
        imm_neg = PT["imm_neg"][k_idx].copy()
        virt = PT["virt"][k_idx]
        first = PT["first"][k_idx]
        last = PT["last"][k_idx]
        comp = PT["comp"][k_idx]
        noop_id = PT["noop"]
    else:
        imm_lo = np.zeros(T, _U64)
        imm_neg = np.zeros(T, bool)
        virt = first = last = comp = np.zeros(T, bool)
        noop_id = isa.KIND_ID["NOOP"]

    is_noop = kid == noop_id
    imm_lo[is_noop] = 0
    imm_neg[is_noop] = False
    # 1:1 virtual rewrites (2^shift / shift bitmask): nonneg u64 results
    eff = KT["eff"][kid]
    m_slli = eff == 1
    m_sr = eff == 2
    sh = imm_lo & _U64(63)
    imm_lo = np.where(m_slli, _U64(1) << sh, imm_lo)
    imm_lo = np.where(m_sr, ((_U64(M64) >> sh) << sh), imm_lo)
    imm_neg = imm_neg & ~(m_slli | m_sr)

    # circuit flags: kind table + per-row sequence flags
    cf = KT["cf"][kid].copy()                 # (T, 14)
    ci = {n: i for i, n in enumerate(F.CIRCUIT_FLAGS)}
    cf[:, ci["VirtualInstruction"]] |= virt
    cf[:, ci["IsFirstInSequence"]] |= virt & first
    cf[:, ci["IsLastInSequence"]] |= virt & last
    cf[:, ci["DoNotUpdateUnexpandedPC"]] |= virt & ~last
    cf[:, ci["IsCompressed"]] |= comp
    inf = KT["inf"][kid]                      # (T, 6)
    ii = {n: i for i, n in enumerate(F.INSTRUCTION_FLAGS)}

    left = np.where(inf[:, ii["LeftOperandIsRs1Value"]], rs1v,
                    np.where(inf[:, ii["LeftOperandIsPC"]], pc, _U64(0)))
    right = np.where(inf[:, ii["RightOperandIsRs2Value"]], rs2v,
                     np.where(inf[:, ii["RightOperandIsImm"]], imm_lo,
                              _U64(0)))
    prod_lo = left * right
    prod_hi = _mulhi64(left, right)

    # lookup output (precedence: Assert > WriteLookupOutputToRD > Branch >
    # JAL > JALR > 0)
    s1 = rs1v.view(np.int64)
    s2 = rs2v.view(np.int64)
    br = KT["br"][kid]
    br_out = np.select(
        [br == 0, br == 1, br == 2, br == 3, br == 4, br == 5],
        [rs1v == rs2v, rs1v != rs2v, s1 < s2, s1 >= s2,
         rs1v < rs2v, rs1v >= rs2v], False).astype(_U64)
    lookup_out = np.select(
        [cf[:, ci["Assert"]], cf[:, ci["WriteLookupOutputToRD"]],
         inf[:, ii["Branch"]], KT["jal"][kid], KT["jalr"][kid]],
        [np.ones(T, _U64), rd_post, br_out,
         pc + imm_lo, (rs1v + imm_lo) & _U64(M64 - 1)],
        _U64(0))

    add_f = cf[:, ci["AddOperands"]]
    sub_f = cf[:, ci["SubtractOperands"]]
    mul_f = cf[:, ci["MultiplyOperands"]]
    mem_f = cf[:, ci["Load"]] | cf[:, ci["Store"]]
    advice_f = cf[:, ci["Advice"]]

    # lookup operands: advice -> rd_post; add -> left+right (<=2^65);
    # sub -> left-right+2^64; mul -> product; else raw (left, right)
    asm = add_f | sub_f | mul_f
    ll = np.where(advice_f | asm, _U64(0), left)
    add_lo = left + right
    add_hi = (add_lo < left).astype(_U64)
    sub_lo = left - right
    sub_hi = (left >= right).astype(_U64)
    rl_lo = np.select([advice_f, add_f, sub_f, mul_f],
                      [rd_post, add_lo, sub_lo, prod_lo], right)
    rl_hi = np.select([add_f, sub_f, mul_f],
                      [add_hi, sub_hi, prod_hi], _U64(0))

    # ram address: exact signed rs1 + imm on load/store rows
    ra_lo = rs1v + imm_lo
    carry = (ra_lo < rs1v).astype(_U64)
    ra_hi = carry + np.where(imm_neg, _U64(M64), _U64(0))   # wraps mod 2^64
    ra_lo = np.where(mem_f, ra_lo, _U64(0))
    ra_hi = np.where(mem_f, ra_hi, _U64(0))

    lo = np.zeros((NUM_VARS, T), _U64)
    hi = np.zeros((NUM_VARS, T), _U64)

    def put(idx, vlo, vhi=None):
        lo[idx] = vlo
        if vhi is not None:
            hi[idx] = vhi

    put(V_CONST, np.ones(T, _U64))
    put(V_LEFT_INSTRUCTION_INPUT, left)
    put(V_RIGHT_INSTRUCTION_INPUT, right)
    put(V_PRODUCT, prod_lo, prod_hi)
    put(V_PC, pc_idx)   # raw (unclipped) bytecode index, as in the scalar path
    put(V_UNEXPANDED_PC, pc)
    put(V_IMM, imm_lo, np.where(imm_neg, _U64(M64), _U64(0)))
    put(V_RAM_ADDRESS, ra_lo, ra_hi)
    put(V_RS1_VALUE, rs1v)
    put(V_RS2_VALUE, rs2v)
    put(V_RD_WRITE_VALUE, rd_post)
    put(V_RAM_READ_VALUE, np.where(mem_f, ram_pre, _U64(0)))
    put(V_RAM_WRITE_VALUE, np.where(mem_f, ram_post, _U64(0)))
    put(V_LEFT_LOOKUP_OPERAND, ll)
    put(V_RIGHT_LOOKUP_OPERAND, rl_lo, rl_hi)
    put(V_LOOKUP_OUTPUT, lookup_out)
    branch_col = inf[:, ii["Branch"]].astype(_U64)
    put(V_BRANCH, branch_col)
    for fi in range(len(F.CIRCUIT_FLAGS)):
        put(V_FLAG_BASE + fi, cf[:, fi].astype(_U64))

    # next-row-dependent columns (padding rows self-repeat at the end)
    def shift1(a):
        return np.concatenate([a[1:], a[-1:]])

    next_is_noop = np.concatenate([is_noop[1:], [True]]).astype(_U64)
    put(V_NEXT_UNEXPANDED_PC, shift1(pc))
    put(V_NEXT_PC, shift1(lo[V_PC]))
    # nrow for the final cycle is the halt row (virtual=first=False)
    nvirt = np.concatenate([virt[1:], [False]])
    nfirst = np.concatenate([first[1:], [False]])
    put(V_NEXT_IS_VIRTUAL, nvirt.astype(_U64))
    put(V_NEXT_IS_FIRST_IN_SEQUENCE, nfirst.astype(_U64))
    put(V_NEXT_IS_NOOP, next_is_noop)
    put(V_SHOULD_JUMP,
        cf[:, ci["Jump"]].astype(_U64) * (_U64(1) - next_is_noop))
    put(V_SHOULD_BRANCH, lookup_out * branch_col)

    return R1CSCycleInputs(lo=lo, hi=hi, T=T)
