"""RV64IM instruction decoding.

TPU-stack analog of the reference tracer's decoder
(`reference tracer/src/instruction/mod.rs`, 132 instruction modules,
fetch/decode in `tracer/src/emulator/cpu.rs`).  Round-1 scope: RV64I + M
(+ ECALL/EBREAK/FENCE); A (atomics) and C (compressed) follow in later
rounds (the decoder interface already returns instruction length so C drops
in without changing callers).

Decoded form: (kind, rd, rs1, rs2, imm) with imm sign-extended as the ISA
specifies.  Register ids are plain ints 0..31 (virtual registers 32..127 are
used only by virtual instruction sequences, added with the bytecode-expansion
layer).
"""

from __future__ import annotations

import dataclasses

# Instruction kinds -- stable small ints used in the SoA trace. Order is
# protocol-relevant later (bytecode Shout); keep append-only.
KINDS = [
    "NOOP",  # padding rows
    # RV64I
    "LUI", "AUIPC", "JAL", "JALR",
    "BEQ", "BNE", "BLT", "BGE", "BLTU", "BGEU",
    "LB", "LH", "LW", "LD", "LBU", "LHU", "LWU",
    "SB", "SH", "SW", "SD",
    "ADDI", "SLTI", "SLTIU", "XORI", "ORI", "ANDI", "SLLI", "SRLI", "SRAI",
    "ADD", "SUB", "SLL", "SLT", "SLTU", "XOR", "SRL", "SRA", "OR", "AND",
    "ADDIW", "SLLIW", "SRLIW", "SRAIW",
    "ADDW", "SUBW", "SLLW", "SRLW", "SRAW",
    "FENCE", "ECALL", "EBREAK",
    # RV64M
    "MUL", "MULH", "MULHSU", "MULHU", "DIV", "DIVU", "REM", "REMU",
    "MULW", "DIVW", "DIVUW", "REMW", "REMUW",
    # virtual instructions (bytecode-expansion targets; these are FINAL
    # provable rows -- reference `tracer/src/instruction/virtual_*.rs` and
    # `crates/jolt-riscv/src/instructions/{virt,assert}/`)
    "VirtualAdvice", "VirtualMovsign", "VirtualPow2", "VirtualPow2W",
    "VirtualShiftRightBitmask", "VirtualSignExtendWord",
    "VirtualZeroExtendWord", "VirtualChangeDivisor", "VirtualChangeDivisorW",
    "VirtualSRL", "VirtualSRA", "VirtualMULI",
    "VirtualAssertEQ", "VirtualAssertLTE", "VirtualAssertValidDiv0",
    "VirtualAssertValidUnsignedRemainder", "VirtualAssertMulUNoOverflow",
    "VirtualAssertHalfwordAlignment", "VirtualAssertWordAlignment",
    # RV64A (source-only: every atomic expands to a final-row sequence,
    # single-hart RMW semantics -- reference tracer/src/instruction/amo*.rs
    # + jolt-program/src/expand/memory/{amo*,lr*,sc*}.rs)
    "LRW", "LRD", "SCW", "SCD",
    "AMOSWAPW", "AMOSWAPD", "AMOADDW", "AMOADDD", "AMOXORW", "AMOXORD",
    "AMOANDW", "AMOANDD", "AMOORW", "AMOORD",
    "AMOMINW", "AMOMIND", "AMOMAXW", "AMOMAXD",
    "AMOMINUW", "AMOMINUD", "AMOMAXUW", "AMOMAXUD",
    # inline-extension kinds (reference jolt-inlines/* + Zbb ANDN):
    # ANDN is a real encodable instruction (Zbb, used inside inline
    # sequences); the Virtual* rotates appear only as expansion targets.
    # INLINE is the source-only custom opcode (0x0B/0x2B) expanded by
    # riscv/program.py into the registered sequence (never a final row).
    "ANDN", "VirtualROTRI", "VirtualROTRIW", "VirtualRev8W",
    "VirtualXORROT16", "VirtualXORROT24", "VirtualXORROT32",
    "VirtualXORROT63",
    "VirtualXORROTW7", "VirtualXORROTW8", "VirtualXORROTW12",
    "VirtualXORROTW16",
    "INLINE",
    # VirtualHostIO (reference tracer/src/instruction/virtual_host_io.rs,
    # opcode 0x5B funct3=2): guest intrinsics -- print, cycle-tracking
    # markers -- dispatched on x10 call id at TRACE time; a provable no-op
    # row (FENCE class) in the circuit.
    "HOSTIO",
]
KIND_ID = {name: i for i, name in enumerate(KINDS)}


@dataclasses.dataclass(frozen=True)
class Decoded:
    kind: str
    rd: int = 0
    rs1: int = 0
    rs2: int = 0
    imm: int = 0      # sign-extended
    length: int = 4   # bytes (2 for compressed, later)


def _sext(value: int, bits: int) -> int:
    sign = 1 << (bits - 1)
    return (value & (sign - 1)) - (value & sign)


class DecodeError(Exception):
    pass


_BRANCH = {0: "BEQ", 1: "BNE", 4: "BLT", 5: "BGE", 6: "BLTU", 7: "BGEU"}
_LOAD = {0: "LB", 1: "LH", 2: "LW", 3: "LD", 4: "LBU", 5: "LHU", 6: "LWU"}
_STORE = {0: "SB", 1: "SH", 2: "SW", 3: "SD"}
_OPIMM = {0: "ADDI", 2: "SLTI", 3: "SLTIU", 4: "XORI", 6: "ORI", 7: "ANDI"}
_OP = {  # (funct3, funct7) -> kind
    (0, 0x00): "ADD", (0, 0x20): "SUB", (1, 0x00): "SLL", (2, 0x00): "SLT",
    (3, 0x00): "SLTU", (4, 0x00): "XOR", (5, 0x00): "SRL", (5, 0x20): "SRA",
    (6, 0x00): "OR", (7, 0x00): "AND",
    (0, 0x01): "MUL", (1, 0x01): "MULH", (2, 0x01): "MULHSU", (3, 0x01): "MULHU",
    (4, 0x01): "DIV", (5, 0x01): "DIVU", (6, 0x01): "REM", (7, 0x01): "REMU",
}
_OP32 = {
    (0, 0x00): "ADDW", (0, 0x20): "SUBW", (1, 0x00): "SLLW",
    (5, 0x00): "SRLW", (5, 0x20): "SRAW",
    (0, 0x01): "MULW", (4, 0x01): "DIVW", (5, 0x01): "DIVUW",
    (6, 0x01): "REMW", (7, 0x01): "REMUW",
}


def decode(word: int) -> Decoded:
    """Decode one 32-bit instruction word."""
    opcode = word & 0x7F
    rd = (word >> 7) & 0x1F
    funct3 = (word >> 12) & 0x7
    rs1 = (word >> 15) & 0x1F
    rs2 = (word >> 20) & 0x1F
    funct7 = (word >> 25) & 0x7F

    if opcode == 0x37:
        return Decoded("LUI", rd=rd, imm=_sext(word & 0xFFFFF000, 32))
    if opcode == 0x17:
        return Decoded("AUIPC", rd=rd, imm=_sext(word & 0xFFFFF000, 32))
    if opcode == 0x6F:
        imm = (((word >> 31) & 1) << 20) | (((word >> 12) & 0xFF) << 12) \
            | (((word >> 20) & 1) << 11) | (((word >> 21) & 0x3FF) << 1)
        return Decoded("JAL", rd=rd, imm=_sext(imm, 21))
    if opcode == 0x67 and funct3 == 0:
        return Decoded("JALR", rd=rd, rs1=rs1, imm=_sext(word >> 20, 12))
    if opcode == 0x63:
        if funct3 not in _BRANCH:
            raise DecodeError(f"bad branch funct3 {funct3}")
        imm = (((word >> 31) & 1) << 12) | (((word >> 7) & 1) << 11) \
            | (((word >> 25) & 0x3F) << 5) | (((word >> 8) & 0xF) << 1)
        return Decoded(_BRANCH[funct3], rs1=rs1, rs2=rs2, imm=_sext(imm, 13))
    if opcode == 0x03:
        if funct3 not in _LOAD:
            raise DecodeError(f"bad load funct3 {funct3}")
        return Decoded(_LOAD[funct3], rd=rd, rs1=rs1, imm=_sext(word >> 20, 12))
    if opcode == 0x23:
        if funct3 not in _STORE:
            raise DecodeError(f"bad store funct3 {funct3}")
        imm = ((word >> 25) << 5) | rd
        return Decoded(_STORE[funct3], rs1=rs1, rs2=rs2, imm=_sext(imm, 12))
    if opcode == 0x13:
        if funct3 == 1 and (word >> 26) == 0:
            return Decoded("SLLI", rd=rd, rs1=rs1, imm=(word >> 20) & 0x3F)
        if funct3 == 5:
            shamt = (word >> 20) & 0x3F
            top = word >> 26
            if top == 0x00:
                return Decoded("SRLI", rd=rd, rs1=rs1, imm=shamt)
            if top == 0x10:
                return Decoded("SRAI", rd=rd, rs1=rs1, imm=shamt)
            raise DecodeError("bad shift funct")
        if funct3 in _OPIMM:
            return Decoded(_OPIMM[funct3], rd=rd, rs1=rs1, imm=_sext(word >> 20, 12))
        raise DecodeError(f"bad op-imm funct3 {funct3}")
    if opcode == 0x1B:
        if funct3 == 0:
            return Decoded("ADDIW", rd=rd, rs1=rs1, imm=_sext(word >> 20, 12))
        shamt = (word >> 20) & 0x1F
        if funct3 == 1 and funct7 == 0:
            return Decoded("SLLIW", rd=rd, rs1=rs1, imm=shamt)
        if funct3 == 5 and funct7 == 0x00:
            return Decoded("SRLIW", rd=rd, rs1=rs1, imm=shamt)
        if funct3 == 5 and funct7 == 0x20:
            return Decoded("SRAIW", rd=rd, rs1=rs1, imm=shamt)
        raise DecodeError("bad op-imm-32")
    if opcode == 0x33:
        if (funct3, funct7) == (7, 0x20):     # Zbb ANDN (inline sequences)
            return Decoded("ANDN", rd=rd, rs1=rs1, rs2=rs2)
        key = (funct3, funct7)
        if key not in _OP:
            raise DecodeError(f"bad op {key}")
        return Decoded(_OP[key], rd=rd, rs1=rs1, rs2=rs2)
    if opcode in (0x0B, 0x2B):
        # custom-0/custom-1 INLINE (reference jolt-inlines; sdk host.rs
        # __submit_inline_op OPCODE check).  The (opcode, funct3, funct7)
        # selector is packed into imm; riscv/program.py expands it into
        # the registered virtual sequence -- never a final row.
        return Decoded("INLINE", rd=rd, rs1=rs1, rs2=rs2,
                       imm=(opcode << 10) | (funct7 << 3) | funct3)
    if opcode == 0x3B:
        key = (funct3, funct7)
        if key not in _OP32:
            raise DecodeError(f"bad op-32 {key}")
        return Decoded(_OP32[key], rd=rd, rs1=rs1, rs2=rs2)
    if opcode == 0x2F:
        funct5 = funct7 >> 2      # aq/rl bits (funct7 & 3) are ignored
        width = {2: "W", 3: "D"}.get(funct3)
        amo = {0x02: "LR", 0x03: "SC", 0x01: "AMOSWAP", 0x00: "AMOADD",
               0x04: "AMOXOR", 0x0C: "AMOAND", 0x08: "AMOOR",
               0x10: "AMOMIN", 0x14: "AMOMAX", 0x18: "AMOMINU",
               0x1C: "AMOMAXU"}.get(funct5)
        if width is None or amo is None:
            raise DecodeError(f"bad AMO funct5/funct3 {funct5}/{funct3}")
        if amo == "LR" and rs2 != 0:
            raise DecodeError("LR with rs2 != 0")
        return Decoded(amo + width, rd=rd, rs1=rs1, rs2=rs2)
    if opcode == 0x5B and funct3 == 2:
        # VirtualHostIO (jolt-platform print/cycle-tracking intrinsics;
        # `.insn i 0x5B, 2, x0, x0, 0` -- args ride x10-x13 at runtime)
        return Decoded("HOSTIO")
    if opcode == 0x0F:
        return Decoded("FENCE")
    if opcode == 0x73:
        if word == 0x00000073:
            return Decoded("ECALL")
        if word == 0x00100073:
            return Decoded("EBREAK")
        raise DecodeError(f"unsupported SYSTEM instruction {word:#010x}")
    raise DecodeError(f"unsupported opcode {opcode:#04x} (word {word:#010x})")


# ---------------------------------------------------------------------------
# RVC (compressed) decoding: every 16-bit instruction maps to a base kind
# with length=2 (the IsCompressed circuit flag + PC-advance arithmetic are
# driven by Decoded.length).  Reference: tracer decompression in
# `tracer/src/emulator/cpu.rs` (uncompress) + `jolt-riscv` IsCompressed.
# ---------------------------------------------------------------------------

def _bits(w: int, hi: int, lo: int) -> int:
    return (w >> lo) & ((1 << (hi - lo + 1)) - 1)


def decode_compressed(h: int) -> Decoded:
    """Decode one 16-bit RVC halfword into its base-instruction form."""
    if h & 3 == 3:
        raise DecodeError("not a compressed instruction")
    if h == 0:
        raise DecodeError("illegal compressed instruction 0x0000")
    op = h & 3
    funct3 = _bits(h, 15, 13)
    L = 2

    def C(kind, **kw):
        return Decoded(kind, length=L, **kw)

    if op == 0:
        rdp = 8 + _bits(h, 4, 2)
        rs1p = 8 + _bits(h, 9, 7)
        if funct3 == 0:   # C.ADDI4SPN
            imm = (_bits(h, 12, 11) << 4) | (_bits(h, 10, 7) << 6) \
                | (_bits(h, 6, 6) << 2) | (_bits(h, 5, 5) << 3)
            if imm == 0:
                raise DecodeError("reserved C.ADDI4SPN imm=0")
            return C("ADDI", rd=rdp, rs1=2, imm=imm)
        if funct3 in (2, 3, 6, 7):  # C.LW/C.LD/C.SW/C.SD
            if funct3 in (2, 6):
                imm = (_bits(h, 12, 10) << 3) | (_bits(h, 6, 6) << 2) \
                    | (_bits(h, 5, 5) << 6)
                kind = "LW" if funct3 == 2 else "SW"
            else:
                imm = (_bits(h, 12, 10) << 3) | (_bits(h, 6, 5) << 6)
                kind = "LD" if funct3 == 3 else "SD"
            if kind in ("LW", "LD"):
                return C(kind, rd=rdp, rs1=rs1p, imm=imm)
            return C(kind, rs1=rs1p, rs2=rdp, imm=imm)
        raise DecodeError(f"unsupported C0 funct3 {funct3}")
    if op == 1:
        rd = _bits(h, 11, 7)
        imm6 = _sext((_bits(h, 12, 12) << 5) | _bits(h, 6, 2), 6)
        if funct3 == 0:   # C.ADDI / C.NOP
            return C("ADDI", rd=rd, rs1=rd, imm=imm6)
        if funct3 == 1:   # C.ADDIW (RV64)
            if rd == 0:
                raise DecodeError("reserved C.ADDIW rd=0")
            return C("ADDIW", rd=rd, rs1=rd, imm=imm6)
        if funct3 == 2:   # C.LI
            return C("ADDI", rd=rd, rs1=0, imm=imm6)
        if funct3 == 3:
            if rd == 2:   # C.ADDI16SP
                imm = _sext((_bits(h, 12, 12) << 9) | (_bits(h, 6, 6) << 4)
                            | (_bits(h, 5, 5) << 6) | (_bits(h, 4, 3) << 7)
                            | (_bits(h, 2, 2) << 5), 10)
                if imm == 0:
                    raise DecodeError("reserved C.ADDI16SP imm=0")
                return C("ADDI", rd=2, rs1=2, imm=imm)
            if rd == 0 or imm6 == 0:
                raise DecodeError("reserved C.LUI")
            return C("LUI", rd=rd, imm=imm6 << 12)
        if funct3 == 4:
            rdp = 8 + _bits(h, 9, 7)
            f2 = _bits(h, 11, 10)
            if f2 == 0 or f2 == 1:   # C.SRLI / C.SRAI
                sh = (_bits(h, 12, 12) << 5) | _bits(h, 6, 2)
                return C("SRLI" if f2 == 0 else "SRAI", rd=rdp, rs1=rdp,
                         imm=sh)
            if f2 == 2:   # C.ANDI
                return C("ANDI", rd=rdp, rs1=rdp, imm=imm6)
            rs2p = 8 + _bits(h, 4, 2)
            f2b = _bits(h, 6, 5)
            if _bits(h, 12, 12) == 0:
                kind = ["SUB", "XOR", "OR", "AND"][f2b]
            else:
                if f2b == 0:
                    kind = "SUBW"
                elif f2b == 1:
                    kind = "ADDW"
                else:
                    raise DecodeError("reserved C1 op")
            return C(kind, rd=rdp, rs1=rdp, rs2=rs2p)
        if funct3 == 5:   # C.J
            imm = _sext((_bits(h, 12, 12) << 11) | (_bits(h, 11, 11) << 4)
                        | (_bits(h, 10, 9) << 8) | (_bits(h, 8, 8) << 10)
                        | (_bits(h, 7, 7) << 6) | (_bits(h, 6, 6) << 7)
                        | (_bits(h, 5, 3) << 1) | (_bits(h, 2, 2) << 5), 12)
            return C("JAL", rd=0, imm=imm)
        # C.BEQZ / C.BNEZ
        rs1p = 8 + _bits(h, 9, 7)
        imm = _sext((_bits(h, 12, 12) << 8) | (_bits(h, 11, 10) << 3)
                    | (_bits(h, 6, 5) << 6) | (_bits(h, 4, 3) << 1)
                    | (_bits(h, 2, 2) << 5), 9)
        return C("BEQ" if funct3 == 6 else "BNE", rs1=rs1p, rs2=0, imm=imm)
    # op == 2
    rd = _bits(h, 11, 7)
    rs2 = _bits(h, 6, 2)
    if funct3 == 0:   # C.SLLI
        sh = (_bits(h, 12, 12) << 5) | _bits(h, 6, 2)
        return C("SLLI", rd=rd, rs1=rd, imm=sh)
    if funct3 == 2:   # C.LWSP
        if rd == 0:
            raise DecodeError("reserved C.LWSP rd=0")
        imm = (_bits(h, 12, 12) << 5) | (_bits(h, 6, 4) << 2) \
            | (_bits(h, 3, 2) << 6)
        return C("LW", rd=rd, rs1=2, imm=imm)
    if funct3 == 3:   # C.LDSP
        if rd == 0:
            raise DecodeError("reserved C.LDSP rd=0")
        imm = (_bits(h, 12, 12) << 5) | (_bits(h, 6, 5) << 3) \
            | (_bits(h, 4, 2) << 6)
        return C("LD", rd=rd, rs1=2, imm=imm)
    if funct3 == 4:
        if _bits(h, 12, 12) == 0:
            if rs2 == 0:   # C.JR
                if rd == 0:
                    raise DecodeError("reserved C.JR rs1=0")
                return C("JALR", rd=0, rs1=rd, imm=0)
            return C("ADD", rd=rd, rs1=0, rs2=rs2)   # C.MV
        if rs2 == 0:
            if rd == 0:   # C.EBREAK
                return C("EBREAK")
            return C("JALR", rd=1, rs1=rd, imm=0)    # C.JALR
        return C("ADD", rd=rd, rs1=rd, rs2=rs2)      # C.ADD
    if funct3 == 6:   # C.SWSP
        imm = (_bits(h, 12, 9) << 2) | (_bits(h, 8, 7) << 6)
        return C("SW", rs1=2, rs2=rs2, imm=imm)
    if funct3 == 7:   # C.SDSP
        imm = (_bits(h, 12, 10) << 3) | (_bits(h, 9, 7) << 6)
        return C("SD", rs1=2, rs2=rs2, imm=imm)
    raise DecodeError(f"unsupported C2 funct3 {funct3}")
