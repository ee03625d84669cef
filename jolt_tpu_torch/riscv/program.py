"""Bytecode expansion: source RV64IM instructions -> provable row sequences.

TPU-stack analog of the reference's static expansion pipeline
(`crates/jolt-program/src/expand/mod.rs` expand_instruction + the recipes in
`expand/{memory,shifts,arithmetic,division}/` and the virtual instruction
set `crates/jolt-riscv/src/instructions/{virt,assert}/`).

Every source instruction expands -- statically, as a pure function of the
program image -- into one or more FINAL rows, each of which has a direct
lookup table (lookups/tables.py KIND_TABLE) or needs none.  The expanded
row index is the proving PC (R1CS `PC` column; one bytecode Shout row per
expanded row); the source byte address is the `UnexpandedPC`.

Conventions:
  * virtual registers: x32 is reserved for the rd=x0 jump rewrite
    (emulator.py); expansion temporaries allocate upward from x33.  The
    register file is 128-wide end to end, so virtual registers flow through
    the registers Twist argument like any architectural register.
  * advice rows (`VirtualAdvice`) carry an `advice` spec
    (op, src_rs1, src_rs2): at trace time the emulator computes the advice
    value from the CURRENT register state (advice rows come first in their
    sequences, before any operand is clobbered), mirroring
    `tracer/src/instruction/mod.rs:190` trace_inline_sequence_with_advice.
    The spec is an execution hint only -- proofs constrain advice purely
    through the assert rows that follow.
  * a sequence never contains branches or jumps; asserts are branch-format
    rows whose lookup output is constrained to 1 by the R1CS Assert flag.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from . import isa

M64 = (1 << 64) - 1

# first virtual register available to expansion temporaries
VTEMP_BASE = 33
NUM_REGS = 128
# persistent LR/SC reservation registers (never allocated as temps):
# mirror of the reference's reservation_{w,d}_register()
# (expand/memory/lrw.rs) -- a reservation survives across sequences as
# ordinary register state flowing through the Twist argument.
RESV_W = 126
RESV_D = 127
RAM_START = 0x80000000

# advice ops: value = f(regs[rs1], regs[rs2]) evaluated pre-sequence
ADVICE_OPS = [
    "divu_q",       # unsigned quotient (u64::MAX when divisor == 0)
    "div_q",        # signed quotient as u64 (RISC-V edge cases)
    "div_r_abs",    # |signed remainder|
    "divuw_q",      # unsigned word quotient (zext operands)
    "divw_q",       # signed word quotient, sign-extended
    "divw_r_abs",   # |signed word remainder|
]
ADVICE_OP_ID = {n: i for i, n in enumerate(ADVICE_OPS)}


def advice_value(op: str, a: int, b: int) -> int:
    """The advice oracle (honest-prover values; never trusted by the proof)."""
    def s64(v):
        v &= M64
        return v - (1 << 64) if v >> 63 else v

    def s32(v):
        v &= 0xFFFFFFFF
        return v - (1 << 32) if v >> 31 else v

    if op == "divu_q":
        return M64 if b == 0 else a // b
    if op == "divuw_q":
        ua, ub = a & 0xFFFFFFFF, b & 0xFFFFFFFF
        return M64 if ub == 0 else ua // ub
    if op in ("div_q", "div_r_abs"):
        sa, sb = s64(a), s64(b)
        if sb == 0:
            q, r = -1, sa
        elif sa == -(1 << 63) and sb == -1:
            q, r = sa, 0
        else:
            q = abs(sa) // abs(sb)
            if (sa < 0) != (sb < 0):
                q = -q
            r = sa - q * sb
        return (q & M64) if op == "div_q" else abs(r)
    if op in ("divw_q", "divw_r_abs"):
        sa, sb = s32(a), s32(b)
        if sb == 0:
            q, r = -1, sa
        elif sa == -(1 << 31) and sb == -1:
            q, r = sa, 0
        else:
            q = abs(sa) // abs(sb)
            if (sa < 0) != (sb < 0):
                q = -q
            r = sa - q * sb
        return (q & M64) if op == "divw_q" else abs(r)
    raise ValueError(op)


@dataclasses.dataclass
class Row:
    """One final (provable) bytecode row.

    first/last are set only on virtual rows (reference flag convention: the
    R1CS guard `VirtualInstruction - IsLastInSequence` must vanish on 1:1
    rows, constraints.rs NextPCEqPCPlusOneIfInline)."""
    kind: str
    address: int                  # unexpanded source pc (byte address)
    rd: int = 0
    rs1: int = 0
    rs2: int = 0
    imm: int = 0                  # exact int (may exceed 12/20-bit encodings)
    virtual: bool = False         # member of a >1-row sequence
    first: bool = False
    last: bool = False
    advice: Optional[Tuple[str, int, int]] = None  # (op, rs1, rs2)
    compressed: bool = False      # source instruction was 16-bit (RVC)

    @property
    def advances_pc(self) -> bool:
        """The unexpanded PC advances after this row (1:1 rows and the
        final row of each sequence)."""
        return not self.virtual or self.last

    @property
    def length(self) -> int:
        """Source instruction length in bytes (IsCompressed circuit flag +
        the PC-advance / jump-link arithmetic)."""
        return 2 if self.compressed else 4


@dataclasses.dataclass
class Program:
    """The expanded (public) program: proving-PC space = row index.

    `entry` is the image load base (row k's source address = entry + 4k'
    for its originating word); `start` is the initial PC (equal to entry
    for raw assembler images; an ELF's e_entry may point mid-image)."""
    rows: List[Row]
    addr2row: Dict[int, int]      # source address -> first row index
    code: bytes
    entry: int
    start: int = None

    def __post_init__(self):
        if self.start is None:
            self.start = self.entry

    @property
    def n_rows(self) -> int:
        return len(self.rows)


class _Builder:
    def __init__(self, address: int):
        self.address = address
        self.rows: List[Row] = []
        self._next_tmp = VTEMP_BASE

    def tmp(self) -> int:
        r = self._next_tmp
        assert r < RESV_W, "virtual register pool exhausted"
        self._next_tmp += 1
        return r

    def emit(self, kind, rd=0, rs1=0, rs2=0, imm=0, advice=None):
        self.rows.append(Row(kind=kind, address=self.address, rd=rd, rs1=rs1,
                             rs2=rs2, imm=imm, advice=advice))

    def finalize(self) -> List[Row]:
        n = len(self.rows)
        virt = n > 1
        for i, row in enumerate(self.rows):
            row.virtual = virt
            row.first = virt and i == 0
            row.last = virt and i == n - 1
        return self.rows


# ---------------------------------------------------------------------------
# recipes (reference files cited per group)
# ---------------------------------------------------------------------------

def _narrow_load(b: _Builder, d, size: int, signed: bool) -> None:
    """LB/LBU/LH/LHU/LW/LWU via containing-dword load + shift extraction
    (expand/memory/shared.rs expand_{byte,halfword,word}_load)."""
    v0, v1 = b.tmp(), b.tmp()
    if size == 2:
        b.emit("VirtualAssertHalfwordAlignment", rs1=d.rs1, imm=d.imm)
    elif size == 4:
        b.emit("VirtualAssertWordAlignment", rs1=d.rs1, imm=d.imm)
    b.emit("ADDI", rd=v0, rs1=d.rs1, imm=d.imm)       # effective address
    b.emit("ANDI", rd=v1, rs1=v0, imm=-8)             # aligned dword address
    b.emit("LD", rd=v1, rs1=v1, imm=0)
    # ((addr ^ (8 - size)) << 3) & 63 == (dword bytes above the target) * 8
    b.emit("XORI", rd=v0, rs1=v0, imm=8 - size)
    b.emit("VirtualMULI", rd=v0, rs1=v0, imm=8)       # SLLI by 3
    b.emit("VirtualPow2", rd=v0, rs1=v0)
    b.emit("MUL", rd=v1, rs1=v1, rs2=v0)              # SLL: value into high bits
    # immediate right shift back down (SRAI/SRLI 1:1 bitmask rewrite)
    b.emit("SRAI" if signed else "SRLI", rd=d.rd, rs1=v1, imm=64 - 8 * size)


def _narrow_store(b: _Builder, d, size: int) -> None:
    """SB/SH/SW via masked dword read-modify-write
    (expand/memory/shared.rs expand_narrow_store)."""
    v0, v1, v2, v3 = b.tmp(), b.tmp(), b.tmp(), b.tmp()
    if size == 2:
        b.emit("VirtualAssertHalfwordAlignment", rs1=d.rs1, imm=d.imm)
    elif size == 4:
        b.emit("VirtualAssertWordAlignment", rs1=d.rs1, imm=d.imm)
    b.emit("ADDI", rd=v0, rs1=d.rs1, imm=d.imm)
    b.emit("ANDI", rd=v1, rs1=v0, imm=-8)
    b.emit("LD", rd=v2, rs1=v1, imm=0)
    b.emit("VirtualMULI", rd=v3, rs1=v0, imm=8)       # byte offset * 8
    b.emit("VirtualPow2", rd=v3, rs1=v3)              # 2^(off*8)
    b.emit("LUI", rd=v0, imm=(1 << (8 * size)) - 1)   # narrow mask
    b.emit("MUL", rd=v0, rs1=v0, rs2=v3)              # mask << (off*8)
    b.emit("MUL", rd=v3, rs1=d.rs2, rs2=v3)           # value << (off*8)
    b.emit("XOR", rd=v3, rs1=v2, rs2=v3)
    b.emit("AND", rd=v3, rs1=v3, rs2=v0)
    b.emit("XOR", rd=v2, rs1=v2, rs2=v3)
    b.emit("SD", rs1=v1, rs2=v2, imm=0)


def _sext_word(b: _Builder, rd, rs) -> None:
    b.emit("VirtualSignExtendWord", rd=rd, rs1=rs)


def _signed_div_rem(b: _Builder, d, word: bool, rem_out: bool) -> None:
    """DIV/REM/DIVW/REMW (expand/division/shared.rs expand_signed_div_rem):
    advice quotient a2 and |remainder| a3, proven against the RISC-V signed
    contract (div-0 quotient, MIN/-1 overflow via change-divisor, product
    recomposition, |rem| < |divisor|)."""
    a2, a3, t0, t1 = b.tmp(), b.tmp(), b.tmp(), b.tmp()
    qop = "divw_q" if word else "div_q"
    rop = "divw_r_abs" if word else "div_r_abs"
    b.emit("VirtualAdvice", rd=a2, advice=(qop, d.rs1, d.rs2))
    b.emit("VirtualAdvice", rd=a3, advice=(rop, d.rs1, d.rs2))
    if word:
        dividend, divisor = b.tmp(), b.tmp()
        _sext_word(b, dividend, d.rs1)
        _sext_word(b, divisor, d.rs2)
    else:
        dividend, divisor = d.rs1, d.rs2
    shmat = 31 if word else 63
    b.emit("VirtualAssertValidDiv0", rs1=divisor, rs2=a2)
    b.emit("VirtualChangeDivisorW" if word else "VirtualChangeDivisor",
           rd=t0, rs1=dividend, rs2=divisor)
    t2, t3 = b.tmp(), b.tmp()
    if word:
        # quotient must be its own word sign extension; remainder data fits
        # the low word
        _sext_word(b, t1, a2)
        b.emit("VirtualAssertEQ", rs1=t1, rs2=a2)
        b.emit("SRAI", rd=t2, rs1=a3, imm=32)
        b.emit("VirtualAssertEQ", rs1=t2, rs2=0)
    else:
        # q * divisor' must not overflow signed 64: high == sign of low.
        # MULH is itself a source-only kind, so its movsign lowering
        # (expand/arithmetic/mulh.rs) is inlined here.
        sx, sy = b.tmp(), b.tmp()
        b.emit("VirtualMovsign", rd=sx, rs1=a2)
        b.emit("VirtualMovsign", rd=sy, rs1=t0)
        b.emit("MUL", rd=sx, rs1=sx, rs2=t0)
        b.emit("MUL", rd=sy, rs1=sy, rs2=a2)
        b.emit("MULHU", rd=t1, rs1=a2, rs2=t0)
        b.emit("ADD", rd=t1, rs1=t1, rs2=sx)
        b.emit("ADD", rd=t1, rs1=t1, rs2=sy)
        b.emit("MUL", rd=t2, rs1=a2, rs2=t0)
        b.emit("SRAI", rd=t3, rs1=t2, imm=63)
        b.emit("VirtualAssertEQ", rs1=t1, rs2=t3)
    # signed remainder = |rem| conditionally negated to the dividend's sign
    b.emit("SRAI", rd=t1, rs1=dividend, imm=shmat)
    b.emit("XOR", rd=t3, rs1=a3, rs2=t1)
    b.emit("SUB", rd=t3, rs1=t3, rs2=t1)
    # recomposition: q * divisor' + rem == dividend
    b.emit("MUL", rd=t2, rs1=a2, rs2=t0)
    b.emit("ADD", rd=t2, rs1=t2, rs2=t3)
    b.emit("VirtualAssertEQ", rs1=t2, rs2=dividend)
    # |rem| < |divisor'| (or divisor' == 0)
    b.emit("SRAI", rd=t1, rs1=t0, imm=shmat)
    abs_div = b.tmp()
    b.emit("XOR", rd=abs_div, rs1=t0, rs2=t1)
    b.emit("SUB", rd=abs_div, rs1=abs_div, rs2=t1)
    b.emit("VirtualAssertValidUnsignedRemainder", rs1=a3, rs2=abs_div)
    out = t3 if rem_out else a2
    if word:
        _sext_word(b, d.rd, out)
    else:
        b.emit("ADDI", rd=d.rd, rs1=out, imm=0)


def _unsigned_div_rem(b: _Builder, d, word: bool, rem_out: bool) -> None:
    """DIVU/REMU/DIVUW/REMUW (expand/division/divu.rs + shared word recipe):
    advice quotient, then q*divisor no-overflow, q*divisor <= dividend, and
    remainder validity."""
    if word:
        x, y = b.tmp(), b.tmp()
        b.emit("VirtualZeroExtendWord", rd=x, rs1=d.rs1)
        b.emit("VirtualZeroExtendWord", rd=y, rs1=d.rs2)
        qop = "divuw_q"
    else:
        x, y = d.rs1, d.rs2
        qop = "divu_q"
    v0, v1 = b.tmp(), b.tmp()
    b.emit("VirtualAdvice", rd=v0, advice=(qop, d.rs1, d.rs2))
    b.emit("VirtualAssertValidDiv0", rs1=y, rs2=v0)
    b.emit("VirtualAssertMulUNoOverflow", rs1=v0, rs2=y)
    b.emit("MUL", rd=v1, rs1=v0, rs2=y)
    b.emit("VirtualAssertLTE", rs1=v1, rs2=x)
    b.emit("SUB", rd=v1, rs1=x, rs2=v1)
    b.emit("VirtualAssertValidUnsignedRemainder", rs1=v1, rs2=y)
    out = v1 if rem_out else v0
    if word:
        _sext_word(b, d.rd, out)
    else:
        b.emit("ADDI", rd=d.rd, rs1=out, imm=0)


# ---------------------------------------------------------------------------
# RV64A recipes (expand/memory/{amo*,lr*,sc*}.rs): single-hart RMW through
# the existing aligned-dword memory rows.  Reservations live in RESV_W/RESV_D.
# ---------------------------------------------------------------------------

class _NS:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def _assert_ram_region(b: _Builder, rs1: int) -> None:
    """LR/SC reservations are only modeled for ordinary RAM
    (expand/memory/lrw.rs RAM-region assertion)."""
    t = b.tmp()
    b.emit("ADDI", rd=t, rs1=0, imm=RAM_START)
    b.emit("VirtualAssertLTE", rs1=t, rs2=rs1)


def _select(b: _Builder, out: int, t01: int, a: int, c: int) -> None:
    """out = t01 ? a : c for a boolean register t01 (branch-free:
    out = c + t*(a - c) exactly, since t in {0,1})."""
    d1 = b.tmp()
    b.emit("SUB", rd=d1, rs1=a, rs2=c)
    b.emit("MUL", rd=d1, rs1=d1, rs2=t01)
    b.emit("ADD", rd=out, rs1=c, rs2=d1)


def _amo_new_value(b: _Builder, op: str, word: bool, v_old: int,
                   rs2: int) -> int:
    """Rows computing the AMO replacement value; v_old is the (sign-
    extended, for word) old memory value."""
    v_new = b.tmp()
    if op == "SWAP":
        b.emit("ADDI", rd=v_new, rs1=rs2, imm=0)
    elif op in ("ADD", "XOR", "AND", "OR"):
        b.emit(op, rd=v_new, rs1=v_old, rs2=rs2)
    else:   # MIN/MAX/MINU/MAXU: compare width-extended, keep payload
        unsigned = op.endswith("U")
        e1, e2 = b.tmp(), b.tmp()
        if word:
            ext = "VirtualZeroExtendWord" if unsigned else \
                "VirtualSignExtendWord"
            b.emit(ext, rd=e1, rs1=v_old)
            b.emit(ext, rd=e2, rs1=rs2)
        else:
            e1, e2 = v_old, rs2
        t = b.tmp()
        cmp_kind = "SLTU" if unsigned else "SLT"
        if op.startswith("MIN"):
            b.emit(cmp_kind, rd=t, rs1=e1, rs2=e2)   # t = e1 < e2
        else:
            b.emit(cmp_kind, rd=t, rs1=e2, rs2=e1)   # t = e1 > e2
        _select(b, v_new, t, e1, e2)                 # t ? e1 : e2
    return v_new


def _cond_narrow_store(b: _Builder, rs1: int, value: int, size: int,
                       cond: Optional[int]) -> None:
    """_narrow_store with the write masked by a boolean `cond` register
    (None = unconditional); the dword RMW degenerates to a rewrite of the
    old value when cond = 0."""
    v0, v1, v2, v3 = b.tmp(), b.tmp(), b.tmp(), b.tmp()
    if size == 2:
        b.emit("VirtualAssertHalfwordAlignment", rs1=rs1, imm=0)
    elif size == 4:
        b.emit("VirtualAssertWordAlignment", rs1=rs1, imm=0)
    b.emit("ADDI", rd=v0, rs1=rs1, imm=0)
    b.emit("ANDI", rd=v1, rs1=v0, imm=-8)
    b.emit("LD", rd=v2, rs1=v1, imm=0)
    b.emit("VirtualMULI", rd=v3, rs1=v0, imm=8)
    b.emit("VirtualPow2", rd=v3, rs1=v3)
    b.emit("LUI", rd=v0, imm=(1 << (8 * size)) - 1)
    b.emit("MUL", rd=v0, rs1=v0, rs2=v3)
    b.emit("MUL", rd=v3, rs1=value, rs2=v3)
    b.emit("XOR", rd=v3, rs1=v2, rs2=v3)
    b.emit("AND", rd=v3, rs1=v3, rs2=v0)
    if cond is not None:
        b.emit("MUL", rd=v3, rs1=v3, rs2=cond)
    b.emit("XOR", rd=v2, rs1=v2, rs2=v3)
    b.emit("SD", rs1=v1, rs2=v2, imm=0)


def _expand_atomic(b: _Builder, d) -> None:
    k = d.kind
    word = k.endswith("W")
    rd_t = d.rd if d.rd else VTEMP_BASE - 1   # x32 sink keeps side effects
    if k in ("LRW", "LRD"):
        _assert_ram_region(b, d.rs1)
        b.emit("ADDI", rd=RESV_W if word else RESV_D, rs1=d.rs1, imm=0)
        b.emit("ADDI", rd=RESV_D if word else RESV_W, rs1=0, imm=0)
        if word:
            _narrow_load(b, _NS(rd=rd_t, rs1=d.rs1, imm=0), 4, signed=True)
        else:
            b.emit("LD", rd=rd_t, rs1=d.rs1, imm=0)
        return
    if k in ("SCW", "SCD"):
        _assert_ram_region(b, d.rs1)
        t, succ = b.tmp(), b.tmp()
        b.emit("XOR", rd=t, rs1=RESV_W if word else RESV_D, rs2=d.rs1)
        b.emit("SLTIU", rd=succ, rs1=t, imm=1)        # 1 iff match
        if word:
            _cond_narrow_store(b, d.rs1, d.rs2, 4, succ)
        else:
            v_old, diff = b.tmp(), b.tmp()
            b.emit("LD", rd=v_old, rs1=d.rs1, imm=0)
            b.emit("XOR", rd=diff, rs1=v_old, rs2=d.rs2)
            b.emit("MUL", rd=diff, rs1=diff, rs2=succ)
            b.emit("XOR", rd=v_old, rs1=v_old, rs2=diff)
            b.emit("SD", rs1=d.rs1, rs2=v_old, imm=0)
        # any SC invalidates both reservations; status: 0 = success
        b.emit("ADDI", rd=RESV_W, rs1=0, imm=0)
        b.emit("ADDI", rd=RESV_D, rs1=0, imm=0)
        b.emit("XORI", rd=rd_t, rs1=succ, imm=1)
        return
    op = k[3:-1]
    v_old = b.tmp()
    if word:
        _narrow_load(b, _NS(rd=v_old, rs1=d.rs1, imm=0), 4, signed=True)
    else:
        b.emit("LD", rd=v_old, rs1=d.rs1, imm=0)
    v_new = _amo_new_value(b, op, word, v_old, d.rs2)
    if word:
        _cond_narrow_store(b, d.rs1, v_new, 4, None)
    else:
        b.emit("SD", rs1=d.rs1, rs2=v_new, imm=0)
    b.emit("ADDI", rd=rd_t, rs1=v_old, imm=0)


_ATOMIC_KINDS = frozenset([
    "LRW", "LRD", "SCW", "SCD",
    "AMOSWAPW", "AMOSWAPD", "AMOADDW", "AMOADDD", "AMOXORW", "AMOXORD",
    "AMOANDW", "AMOANDD", "AMOORW", "AMOORD",
    "AMOMINW", "AMOMIND", "AMOMAXW", "AMOMAXD",
    "AMOMINUW", "AMOMINUD", "AMOMAXUW", "AMOMAXUD"])


def expand_decoded(d, address: int) -> List[Row]:
    """Expand one decoded instruction into its final row sequence."""
    k = d.kind
    b = _Builder(address)
    rd = d.rd

    if k == "INLINE":
        from .inlines import expand_inline
        expand_inline(b, d)
    elif k in _ATOMIC_KINDS:
        _expand_atomic(b, d)
    elif k in ("LB", "LBU", "LH", "LHU", "LW", "LWU"):
        size = {"LB": 1, "LBU": 1, "LH": 2, "LHU": 2, "LW": 4, "LWU": 4}[k]
        _narrow_load(b, d, size, signed=k in ("LB", "LH", "LW"))
    elif k in ("SB", "SH", "SW"):
        _narrow_store(b, d, {"SB": 1, "SH": 2, "SW": 4}[k])
    elif k == "SLL":  # expand/shifts/sll.rs
        v = b.tmp()
        b.emit("VirtualPow2", rd=v, rs1=d.rs2)
        b.emit("MUL", rd=rd, rs1=d.rs1, rs2=v)
    elif k == "SRL":  # expand/shifts/srl.rs
        v = b.tmp()
        b.emit("VirtualShiftRightBitmask", rd=v, rs1=d.rs2)
        b.emit("VirtualSRL", rd=rd, rs1=d.rs1, rs2=v)
    elif k == "SRA":  # expand/shifts/sra.rs
        v = b.tmp()
        b.emit("VirtualShiftRightBitmask", rd=v, rs1=d.rs2)
        b.emit("VirtualSRA", rd=rd, rs1=d.rs1, rs2=v)
    elif k == "SLLW":  # expand/shifts/sllw.rs
        v = b.tmp()
        b.emit("VirtualPow2W", rd=v, rs1=d.rs2)
        b.emit("MUL", rd=rd, rs1=d.rs1, rs2=v)
        _sext_word(b, rd, rd)
    elif k == "SRLW":  # expand/shifts/srlw.rs: embed in the high half
        vb, vr = b.tmp(), b.tmp()
        b.emit("VirtualMULI", rd=vr, rs1=d.rs1, imm=1 << 32)
        b.emit("ORI", rd=vb, rs1=d.rs2, imm=32)
        b.emit("VirtualShiftRightBitmask", rd=vb, rs1=vb)
        b.emit("VirtualSRL", rd=rd, rs1=vr, rs2=vb)
        _sext_word(b, rd, rd)
    elif k == "SRAW":  # expand/shifts/sraw.rs
        vr, vb = b.tmp(), b.tmp()
        _sext_word(b, vr, d.rs1)
        b.emit("ANDI", rd=vb, rs1=d.rs2, imm=0x1F)
        b.emit("VirtualShiftRightBitmask", rd=vb, rs1=vb)
        b.emit("VirtualSRA", rd=rd, rs1=vr, rs2=vb)
        _sext_word(b, rd, rd)
    elif k == "SLLIW":  # expand/shifts/slliw.rs
        b.emit("VirtualMULI", rd=rd, rs1=d.rs1, imm=1 << (d.imm & 0x1F))
        _sext_word(b, rd, rd)
    elif k == "SRLIW":  # expand/shifts/srliw.rs
        v = b.tmp()
        b.emit("VirtualMULI", rd=v, rs1=d.rs1, imm=1 << 32)
        b.emit("SRLI", rd=rd, rs1=v, imm=32 + (d.imm & 0x1F))
        _sext_word(b, rd, rd)
    elif k == "SRAIW":  # word arithmetic shift on the sign-extended word
        v = b.tmp()
        _sext_word(b, v, d.rs1)
        b.emit("SRAI", rd=rd, rs1=v, imm=d.imm & 0x1F)
    elif k == "ADDIW":  # expand/arithmetic/addiw.rs
        b.emit("ADDI", rd=rd, rs1=d.rs1, imm=d.imm)
        _sext_word(b, rd, rd)
    elif k in ("ADDW", "SUBW"):  # expand/arithmetic/{addw,subw}.rs
        b.emit(k[:-1], rd=rd, rs1=d.rs1, rs2=d.rs2)
        _sext_word(b, rd, rd)
    elif k == "MULW":  # expand/arithmetic/mulw.rs
        b.emit("MUL", rd=rd, rs1=d.rs1, rs2=d.rs2)
        _sext_word(b, rd, rd)
    elif k == "MULH":  # expand/arithmetic/mulh.rs
        sx, sy, t = b.tmp(), b.tmp(), b.tmp()
        b.emit("VirtualMovsign", rd=sx, rs1=d.rs1)
        b.emit("VirtualMovsign", rd=sy, rs1=d.rs2)
        b.emit("MUL", rd=sx, rs1=sx, rs2=d.rs2)
        b.emit("MUL", rd=sy, rs1=sy, rs2=d.rs1)
        b.emit("MULHU", rd=t, rs1=d.rs1, rs2=d.rs2)
        b.emit("ADD", rd=t, rs1=t, rs2=sx)
        b.emit("ADD", rd=rd, rs1=t, rs2=sy)
    elif k == "MULHSU":  # expand/arithmetic/mulhsu.rs
        sx, t = b.tmp(), b.tmp()
        b.emit("VirtualMovsign", rd=sx, rs1=d.rs1)
        b.emit("MUL", rd=sx, rs1=sx, rs2=d.rs2)
        b.emit("MULHU", rd=t, rs1=d.rs1, rs2=d.rs2)
        b.emit("ADD", rd=rd, rs1=t, rs2=sx)
    elif k in ("DIV", "REM", "DIVW", "REMW"):
        _signed_div_rem(b, d, word=k.endswith("W"), rem_out=k.startswith("REM"))
    elif k in ("DIVU", "REMU", "DIVUW", "REMUW"):
        _unsigned_div_rem(b, d, word=k.endswith("W"),
                          rem_out=k.startswith("REM"))
    else:
        # 1:1 final row (including the SLLI/SRLI/SRAI immediate rewrites,
        # applied at witness/bytecode-table build via LT.effective_imm)
        b.emit(k, rd=d.rd, rs1=d.rs1, rs2=d.rs2, imm=d.imm)

    return b.finalize()


# kinds with no rd destination (rd field decodes as 0 but means nothing)
_NO_RD = frozenset([
    "NOOP", "SB", "SH", "SW", "SD", "BEQ", "BNE", "BLT", "BGE", "BLTU",
    "BGEU", "FENCE", "ECALL", "EBREAK", "HOSTIO"])


def expand_program(code: bytes, entry: int, start: int = None) -> Program:
    """Statically expand a program image (pure function of (code, entry);
    both prover and verifier derive the same public row table).

    The walk is 2-byte granular: a halfword whose low bits aren't 0b11 is
    an RVC (compressed) instruction; its expanded rows carry the
    IsCompressed flag so the R1CS PC-advance constraints use +2."""
    rows: List[Row] = []
    addr2row: Dict[int, int] = {}
    n = len(code)
    off = 0
    while off + 2 <= n:
        addr = entry + off
        addr2row[addr] = len(rows)
        lo = int.from_bytes(code[off:off + 2], "little")
        if lo & 3 == 3:
            if off + 4 > n:
                rows.append(Row(kind="NOOP", address=addr))
                off += 2
                continue
            word = int.from_bytes(code[off:off + 4], "little")
            step = 4
            try:
                d = isa.decode(word)
            except isa.DecodeError:
                rows.append(Row(kind="NOOP", address=addr))
                off += step
                continue
        else:
            step = 2
            try:
                d = isa.decode_compressed(lo)
            except isa.DecodeError:
                rows.append(Row(kind="NOOP", address=addr))
                off += step
                continue
        comp = d.length == 2
        # rd = x0 with a destination and no side effect is architecturally a
        # no-op; the R1CS cannot satisfy RdWrite == LookupOutput through the
        # x0 sink, so expansion replaces it with `addi x32, x0, 0` -- a real
        # row that advances the PC (NOOP rows carry DoNotUpdateUnexpandedPC
        # and are reserved for trace padding).  Reference: expand/mod.rs
        # rd-zero rewrite; jumps keep their x32 rewrite instead.
        if (d.rd == 0 and d.kind not in _NO_RD
                and d.kind not in ("JAL", "JALR", "INLINE")
                and d.kind not in _ATOMIC_KINDS):   # atomics keep side effects
            rows.append(Row(kind="ADDI", address=addr, rd=VTEMP_BASE - 1,
                            compressed=comp))
            off += step
            continue
        seq = expand_decoded(d, addr)
        for row in seq:
            row.compressed = comp
        if d.kind in ("JAL", "JALR") and d.rd == 0:
            seq[0].rd = 32  # x0-jump rewrite (emulator.py Emulator.step)
        rows.extend(seq)
        off += step
    # one-past-the-end halt row (pc after the final instruction)
    addr2row[entry + n] = len(rows)
    return Program(rows=rows, addr2row=addr2row, code=code, entry=entry,
                   start=start)
