"""Minimal two-pass RV64IM assembler for guest test programs.

The reference builds guests with the Rust RISC-V toolchain; this image has no
cross-compiler, so test guests are written in assembly and assembled here.
Supports labels, the RV64IM mnemonics of `isa.py`, and common pseudo-ops.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

_M32 = (1 << 32) - 1

REG_NAMES = {
    "zero": 0, "ra": 1, "sp": 2, "gp": 3, "tp": 4,
    "t0": 5, "t1": 6, "t2": 7, "s0": 8, "fp": 8, "s1": 9,
    "a0": 10, "a1": 11, "a2": 12, "a3": 13, "a4": 14, "a5": 15,
    "a6": 16, "a7": 17, "s2": 18, "s3": 19, "s4": 20, "s5": 21,
    "s6": 22, "s7": 23, "s8": 24, "s9": 25, "s10": 26, "s11": 27,
    "t3": 28, "t4": 29, "t5": 30, "t6": 31,
}
for _i in range(32):
    REG_NAMES[f"x{_i}"] = _i


def _reg(tok: str) -> int:
    tok = tok.strip()
    if tok not in REG_NAMES:
        raise ValueError(f"unknown register {tok!r}")
    return REG_NAMES[tok]


def _enc_r(op, f3, f7, rd, rs1, rs2):
    return op | (rd << 7) | (f3 << 12) | (rs1 << 15) | (rs2 << 20) | (f7 << 25)

def _enc_i(op, f3, rd, rs1, imm):
    return op | (rd << 7) | (f3 << 12) | (rs1 << 15) | ((imm & 0xFFF) << 20)

def _enc_s(op, f3, rs1, rs2, imm):
    return op | ((imm & 0x1F) << 7) | (f3 << 12) | (rs1 << 15) | (rs2 << 20) \
        | (((imm >> 5) & 0x7F) << 25)

def _enc_b(op, f3, rs1, rs2, imm):
    return op | (((imm >> 11) & 1) << 7) | (((imm >> 1) & 0xF) << 8) | (f3 << 12) \
        | (rs1 << 15) | (rs2 << 20) | (((imm >> 5) & 0x3F) << 25) | (((imm >> 12) & 1) << 31)

def _enc_u(op, rd, imm20):
    return op | (rd << 7) | ((imm20 & 0xFFFFF) << 12)

def _enc_j(op, rd, imm):
    return op | (rd << 7) | (((imm >> 12) & 0xFF) << 12) | (((imm >> 11) & 1) << 20) \
        | (((imm >> 1) & 0x3FF) << 21) | (((imm >> 20) & 1) << 31)


_R_OPS = {
    "add": (0x33, 0, 0x00), "sub": (0x33, 0, 0x20), "sll": (0x33, 1, 0x00),
    "slt": (0x33, 2, 0x00), "sltu": (0x33, 3, 0x00), "xor": (0x33, 4, 0x00),
    "srl": (0x33, 5, 0x00), "sra": (0x33, 5, 0x20), "or": (0x33, 6, 0x00),
    "and": (0x33, 7, 0x00),
    "addw": (0x3B, 0, 0x00), "subw": (0x3B, 0, 0x20), "sllw": (0x3B, 1, 0x00),
    "srlw": (0x3B, 5, 0x00), "sraw": (0x3B, 5, 0x20),
    "mul": (0x33, 0, 0x01), "mulh": (0x33, 1, 0x01), "mulhsu": (0x33, 2, 0x01),
    "mulhu": (0x33, 3, 0x01), "div": (0x33, 4, 0x01), "divu": (0x33, 5, 0x01),
    "rem": (0x33, 6, 0x01), "remu": (0x33, 7, 0x01),
    "mulw": (0x3B, 0, 0x01), "divw": (0x3B, 4, 0x01), "divuw": (0x3B, 5, 0x01),
    "remw": (0x3B, 6, 0x01), "remuw": (0x3B, 7, 0x01),
    "andn": (0x33, 7, 0x20),               # Zbb (inline sequences)
    # INLINE custom-0 selectors (jolt-inlines/sha2/src/lib.rs):
    # sha256 rs1, rs2 -- compress block at (rs2) into state at (rs1)
    "sha256": (0x0B, 0, 0x00), "sha256init": (0x0B, 1, 0x00),
    # keccak256 rs1 -- permute the 25-lane Keccak state at (rs1)
    "keccak256": (0x0B, 0, 0x01),
    # blake2b rs1, rs2 -- compress message block + t/f at (rs2) into the
    # 8-word state at (rs1) (jolt-inlines/blake2/src/lib.rs)
    "blake2b": (0x0B, 0, 0x02),
}
_I_OPS = {
    "addi": (0x13, 0), "slti": (0x13, 2), "sltiu": (0x13, 3), "xori": (0x13, 4),
    "ori": (0x13, 6), "andi": (0x13, 7), "addiw": (0x1B, 0), "jalr": (0x67, 0),
}
_LOADS = {"lb": 0, "lh": 1, "lw": 2, "ld": 3, "lbu": 4, "lhu": 5, "lwu": 6}
_STORES = {"sb": 0, "sh": 1, "sw": 2, "sd": 3}
_BRANCHES = {"beq": 0, "bne": 1, "blt": 4, "bge": 5, "bltu": 6, "bgeu": 7}
_SHIFTS_I = {"slli": (0x13, 1, 0), "srli": (0x13, 5, 0), "srai": (0x13, 5, 0x10),
             # W-shift "top" values are pre-shifted so that sh | (top << 6)
             # lands funct7 at word bits 25.. (5-bit shamt): 0x10<<6 == 0x20<<5
             "slliw": (0x1B, 1, 0), "srliw": (0x1B, 5, 0),
             "sraiw": (0x1B, 5, 0x10)}

_MEM_RE = re.compile(r"^(-?\w+)\((\w+)\)$")


def assemble(source: str, base: int = 0x80000000) -> bytes:
    """Two-pass assembly of `source` at address `base` -> machine code bytes."""
    lines = []
    for raw in source.splitlines():
        line = raw.split("#")[0].strip()
        if line:
            lines.append(line)

    # pass 1: label addresses (every real instruction is 4 bytes; li is 1-4)
    labels: Dict[str, int] = {}
    items: List[Tuple[str, List[str]]] = []
    addr = base
    for line in lines:
        while ":" in line:
            lbl, line = line.split(":", 1)
            labels[lbl.strip()] = addr
            line = line.strip()
        if not line:
            continue
        parts = line.split(None, 1)
        mnem = parts[0].lower()
        args = [a.strip() for a in parts[1].split(",")] if len(parts) > 1 else []
        count = _instr_count(mnem, args)
        items.append((mnem, args))
        addr += 4 * count

    # pass 2: encode
    words: List[int] = []
    addr = base
    for mnem, args in items:
        ws = _encode(mnem, args, addr, labels)
        words.extend(ws)
        addr += 4 * len(ws)

    out = bytearray()
    for w in words:
        out += int(w & _M32).to_bytes(4, "little")
    return bytes(out)


def _instr_count(mnem: str, args: List[str]) -> int:
    if mnem == "li":
        return len(_li_words(0, int(args[1], 0)))
    if mnem in ("call", "la"):
        return 2
    return 1


def _li_words(rd: int, value: int) -> List[int]:
    """Load-immediate expansion (up to 64-bit constants)."""
    v = value & ((1 << 64) - 1)
    sv = v - (1 << 64) if v >> 63 else v
    if -(1 << 11) <= sv < (1 << 11):
        return [_enc_i(0x13, 0, rd, 0, sv)]
    if -(1 << 31) <= sv < (1 << 31) - 0x800:
        # hi must fit signed 20 bits: requires sv < 2^31 - 2048, otherwise
        # fall through to the unsigned-32 zero-extend sequence
        hi = (sv + 0x800) >> 12
        lo = sv - (hi << 12)
        out = [_enc_u(0x37, rd, hi)]
        if lo:
            out.append(_enc_i(0x13, 0, rd, rd, lo))
        return out
    if 0 <= sv < (1 << 32) or (v >> 32) == 0:
        # unsigned 32-bit constant (e.g. RAM addresses like 0x80100000):
        # lui+addi give the right low 32 bits (sign-extended); slli/srli
        # zero-extend to 64 bits.
        lo32 = v & 0xFFFFFFFF
        hi = ((lo32 + 0x800) >> 12) & 0xFFFFF
        lo = lo32 - (((lo32 + 0x800) >> 12) << 12)
        out = [_enc_u(0x37, rd, hi)]
        if lo:
            out.append(_enc_i(0x13, 0, rd, rd, lo))
        out.append(_enc_i(0x13, 1, rd, rd, 32))        # slli rd, rd, 32
        out.append(_enc_i(0x13, 5, rd, rd, 32))        # srli rd, rd, 32
        return out
    # general 64-bit: load the signed high 32 bits via lui+addi, then shift in
    # the low 32 bits as three non-negative chunks (11+11+10 bits) so every
    # addi immediate stays positive.
    hi32 = sv >> 32
    hi = (hi32 + 0x800) >> 12
    lo = hi32 - (hi << 12)
    out = [_enc_u(0x37, rd, hi & 0xFFFFF)]
    if lo:
        out.append(_enc_i(0x13, 0, rd, rd, lo))
    lo32 = v & 0xFFFFFFFF
    for shift, start in ((11, 21), (11, 10), (10, 0)):
        chunk = (lo32 >> start) & ((1 << shift) - 1)
        out.append(_enc_i(0x13, 1, rd, rd, shift))       # slli rd, rd, shift
        if chunk:
            out.append(_enc_i(0x13, 0, rd, rd, chunk))   # addi rd, rd, chunk
    return out


def _encode(mnem: str, args: List[str], addr: int, labels: Dict[str, int]) -> List[int]:
    def imm_or_label(tok: str) -> int:
        tok = tok.strip()
        if tok in labels:
            return labels[tok]
        return int(tok, 0)

    if mnem in _R_OPS:
        op, f3, f7 = _R_OPS[mnem]
        if len(args) == 1 and op == 0x0B:   # inline: rd/rs2 unused
            return [_enc_r(op, f3, f7, 0, _reg(args[0]), 0)]
        if len(args) == 2 and op == 0x0B:   # inline: rd unused
            return [_enc_r(op, f3, f7, 0, _reg(args[0]), _reg(args[1]))]
        return [_enc_r(op, f3, f7, _reg(args[0]), _reg(args[1]), _reg(args[2]))]
    if mnem in _SHIFTS_I:
        op, f3, top = _SHIFTS_I[mnem]
        sh = int(args[2], 0)
        return [_enc_i(op, f3, _reg(args[0]), _reg(args[1]), sh | (top << 6))]
    if mnem in _I_OPS:
        op, f3 = _I_OPS[mnem]
        if mnem == "jalr" and len(args) == 1:
            return [_enc_i(op, f3, 1, _reg(args[0]), 0)]
        m = _MEM_RE.match(args[2]) if len(args) > 2 else None
        if mnem == "jalr" and m:
            return [_enc_i(op, f3, _reg(args[0]), _reg(m.group(2)), int(m.group(1), 0))]
        return [_enc_i(op, f3, _reg(args[0]), _reg(args[1]), int(args[2], 0))]
    if mnem in _LOADS:
        m = _MEM_RE.match(args[1])
        return [_enc_i(0x03, _LOADS[mnem], _reg(args[0]), _reg(m.group(2)),
                       int(m.group(1), 0))]
    if mnem in _STORES:
        m = _MEM_RE.match(args[1])
        return [_enc_s(0x23, _STORES[mnem], _reg(m.group(2)), _reg(args[0]),
                       int(m.group(1), 0))]
    if mnem in _BRANCHES:
        target = imm_or_label(args[2])
        return [_enc_b(0x63, _BRANCHES[mnem], _reg(args[0]), _reg(args[1]),
                       target - addr)]
    if mnem == "lui":
        return [_enc_u(0x37, _reg(args[0]), int(args[1], 0))]
    if mnem == "auipc":
        return [_enc_u(0x17, _reg(args[0]), int(args[1], 0))]
    if mnem == "jal":
        if len(args) == 1:
            rd, target = 1, imm_or_label(args[0])
        else:
            rd, target = _reg(args[0]), imm_or_label(args[1])
        return [_enc_j(0x6F, rd, target - addr)]
    # pseudo-ops
    if mnem == "nop":
        return [_enc_i(0x13, 0, 0, 0, 0)]
    if mnem == "mv":
        return [_enc_i(0x13, 0, _reg(args[0]), _reg(args[1]), 0)]
    if mnem == "li":
        return _li_words(_reg(args[0]), int(args[1], 0))
    if mnem == "j":
        return [_enc_j(0x6F, 0, imm_or_label(args[0]) - addr)]
    if mnem == "ret":
        return [_enc_i(0x67, 0, 0, 1, 0)]
    if mnem == "call":
        target = imm_or_label(args[0])
        off = target - addr
        hi = (off + 0x800) >> 12
        lo = off - (hi << 12)
        return [_enc_u(0x17, 1, hi), _enc_i(0x67, 0, 1, 1, lo)]
    if mnem == "la":
        target = imm_or_label(args[1])
        off = target - addr
        hi = (off + 0x800) >> 12
        lo = off - (hi << 12)
        return [_enc_u(0x17, _reg(args[0]), hi),
                _enc_i(0x13, 0, _reg(args[0]), _reg(args[0]), lo)]
    if mnem == "hostio":
        # VirtualHostIO: opcode 0x5B funct3=2, all operand fields zero
        # (call id / ptr / len / event ride a0-a3)
        return [0x5B | (2 << 12)]
    if mnem == "ecall":
        return [0x00000073]
    if mnem == "ebreak":
        return [0x00100073]
    raise ValueError(f"unknown mnemonic {mnem!r}")
