"""Per-instruction circuit and instruction flags.

Mirrors the `jolt_instruction!` declarations in
`reference crates/jolt-riscv/src/instructions/{i,m}/*.rs` for the
RV64IM subset, plus the NoOp special case
(`instructions/mod.rs:499-502`: NoOp sets only DoNotUpdateUnexpandedPC).
"""

from __future__ import annotations

from typing import Dict, FrozenSet, Tuple

# CircuitFlags (jolt-riscv/src/flags.rs:24-53); order = bit index
CIRCUIT_FLAGS = [
    "AddOperands", "SubtractOperands", "MultiplyOperands", "Load", "Store",
    "Jump", "WriteLookupOutputToRD", "VirtualInstruction", "Assert",
    "DoNotUpdateUnexpandedPC", "Advice", "IsCompressed",
    "IsFirstInSequence", "IsLastInSequence",
]
# InstructionFlags (flags.rs:84-97)
INSTRUCTION_FLAGS = [
    "LeftOperandIsPC", "RightOperandIsImm", "LeftOperandIsRs1Value",
    "RightOperandIsRs2Value", "Branch", "IsNoop",
]

_RS1_RS2 = ("LeftOperandIsRs1Value", "RightOperandIsRs2Value")
_RS1_IMM = ("LeftOperandIsRs1Value", "RightOperandIsImm")
_PC_IMM = ("LeftOperandIsPC", "RightOperandIsImm")
_WR = ("WriteLookupOutputToRD",)

# kind -> (circuit_flags, instruction_flags)
FLAGS: Dict[str, Tuple[Tuple[str, ...], Tuple[str, ...]]] = {
    "NOOP": (("DoNotUpdateUnexpandedPC",), ("IsNoop",)),
    "LUI": (("AddOperands",) + _WR, ("RightOperandIsImm",)),
    "AUIPC": (("AddOperands",) + _WR, _PC_IMM),
    "JAL": (("AddOperands", "Jump"), _PC_IMM),
    "JALR": (("AddOperands", "Jump"), _RS1_IMM),
    "BEQ": ((), _RS1_RS2 + ("Branch",)),
    "BNE": ((), _RS1_RS2 + ("Branch",)),
    "BLT": ((), _RS1_RS2 + ("Branch",)),
    "BGE": ((), _RS1_RS2 + ("Branch",)),
    "BLTU": ((), _RS1_RS2 + ("Branch",)),
    "BGEU": ((), _RS1_RS2 + ("Branch",)),
    # loads/stores: operands feed the address lookup via R1CS, not rs1/rs2
    "LB": (("Load",), ()), "LH": (("Load",), ()), "LW": (("Load",), ()),
    "LD": (("Load",), ()), "LBU": (("Load",), ()), "LHU": (("Load",), ()),
    "LWU": (("Load",), ()),
    "SB": (("Store",), ()), "SH": (("Store",), ()), "SW": (("Store",), ()),
    "SD": (("Store",), ()),
    "ADDI": (("AddOperands",) + _WR, _RS1_IMM),
    "SLTI": (_WR, _RS1_IMM),
    "SLTIU": (_WR, _RS1_IMM),
    "XORI": (_WR, _RS1_IMM),
    "ORI": (_WR, _RS1_IMM),
    "ANDI": (_WR, _RS1_IMM),
    # SLLI is 1:1-rewritten to VirtualMULI (multiply by 2^shift), so it
    # carries MultiplyOperands; SRLI/SRAI become interleaved bitmask-operand
    # shift-table lookups (jolt-program expand/shifts/)
    "SLLI": (("MultiplyOperands",) + _WR, _RS1_IMM),
    "SRLI": (_WR, _RS1_IMM),
    "SRAI": (_WR, _RS1_IMM),
    "ADD": (("AddOperands",) + _WR, _RS1_RS2),
    "SUB": (("SubtractOperands",) + _WR, _RS1_RS2),
    "SLL": (_WR, _RS1_RS2),
    "SLT": (_WR, _RS1_RS2),
    "SLTU": (_WR, _RS1_RS2),
    "XOR": (_WR, _RS1_RS2),
    "SRL": (_WR, _RS1_RS2),
    "SRA": (_WR, _RS1_RS2),
    "OR": (_WR, _RS1_RS2),
    "AND": (_WR, _RS1_RS2),
    "ADDIW": (("AddOperands",) + _WR, _RS1_IMM),
    "SLLIW": (_WR, _RS1_IMM),
    "SRLIW": (_WR, _RS1_IMM),
    "SRAIW": (_WR, _RS1_IMM),
    "ADDW": (("AddOperands",) + _WR, _RS1_RS2),
    "SUBW": (("SubtractOperands",) + _WR, _RS1_RS2),
    "SLLW": (_WR, _RS1_RS2),
    "SRLW": (_WR, _RS1_RS2),
    "SRAW": (_WR, _RS1_RS2),
    "FENCE": ((), ()),
    "ECALL": ((), ()),
    "EBREAK": ((), ()),
    "HOSTIO": ((), ()),
    "MUL": (("MultiplyOperands",) + _WR, _RS1_RS2),
    "MULHU": (("MultiplyOperands",) + _WR, _RS1_RS2),
    "MULW": (("MultiplyOperands",) + _WR, _RS1_RS2),
    # MULH/MULHSU/DIV*/REM* are virtual-sequence expanded in the reference
    # (no direct lookup); until bytecode expansion lands they are emulate-only.
    # source-only kinds below are bytecode-expanded (riscv/program.py) and
    # never appear in a proving trace; entries kept for the semantic oracle
    "MULH": (("MultiplyOperands",) + _WR, _RS1_RS2),
    "MULHSU": (("MultiplyOperands",) + _WR, _RS1_RS2),
    "DIV": (_WR, _RS1_RS2), "DIVU": (_WR, _RS1_RS2),
    "REM": (_WR, _RS1_RS2), "REMU": (_WR, _RS1_RS2),
    "DIVW": (_WR, _RS1_RS2), "DIVUW": (_WR, _RS1_RS2),
    "REMW": (_WR, _RS1_RS2), "REMUW": (_WR, _RS1_RS2),
    # virtual (final) instructions, jolt-riscv/src/instructions/{virt,assert}
    "VirtualAdvice": (("Advice",) + _WR, ()),
    "VirtualMovsign": (_WR, _RS1_IMM),
    "VirtualPow2": (("AddOperands",) + _WR, ("LeftOperandIsRs1Value",)),
    "VirtualPow2W": (("AddOperands",) + _WR, ("LeftOperandIsRs1Value",)),
    "VirtualShiftRightBitmask": (("AddOperands",) + _WR,
                                 ("LeftOperandIsRs1Value",)),
    "VirtualSignExtendWord": (("AddOperands",) + _WR,
                              ("LeftOperandIsRs1Value",)),
    "VirtualZeroExtendWord": (("AddOperands",) + _WR,
                              ("LeftOperandIsRs1Value",)),
    "VirtualChangeDivisor": (_WR, _RS1_RS2),
    "VirtualChangeDivisorW": (_WR, _RS1_RS2),
    "VirtualSRL": (_WR, _RS1_RS2),
    "VirtualSRA": (_WR, _RS1_RS2),
    "VirtualMULI": (("MultiplyOperands",) + _WR, _RS1_IMM),
    "VirtualAssertEQ": (("Assert",), _RS1_RS2),
    "VirtualAssertLTE": (("Assert",), _RS1_RS2),
    "VirtualAssertValidDiv0": (("Assert",), _RS1_RS2),
    "VirtualAssertValidUnsignedRemainder": (("Assert",), _RS1_RS2),
    "VirtualAssertMulUNoOverflow": (("MultiplyOperands", "Assert"), _RS1_RS2),
    "VirtualAssertHalfwordAlignment": (("AddOperands", "Assert"), _RS1_IMM),
    "VirtualAssertWordAlignment": (("AddOperands", "Assert"), _RS1_IMM),
    # inline-extension kinds (jolt-riscv instructions/{i/andn,virt/*}.rs)
    "ANDN": (_WR, _RS1_RS2),
    "VirtualROTRI": (_WR, _RS1_IMM),
    "VirtualROTRIW": (_WR, _RS1_IMM),
    "VirtualRev8W": (("AddOperands",) + _WR, ("LeftOperandIsRs1Value",)),
    "INLINE": ((), ()),   # source-only: always expanded, never a final row
}
for _rot in (16, 24, 32, 63):
    FLAGS[f"VirtualXORROT{_rot}"] = (_WR, _RS1_RS2)
for _rot in (7, 8, 12, 16):
    FLAGS[f"VirtualXORROTW{_rot}"] = (_WR, _RS1_RS2)

# RV64A source kinds: always expanded into final-row sequences
# (riscv/program.py); entries exist only for the semantic oracle.
for _amo in ["LRW", "LRD", "SCW", "SCD",
             "AMOSWAPW", "AMOSWAPD", "AMOADDW", "AMOADDD", "AMOXORW",
             "AMOXORD", "AMOANDW", "AMOANDD", "AMOORW", "AMOORD",
             "AMOMINW", "AMOMIND", "AMOMAXW", "AMOMAXD",
             "AMOMINUW", "AMOMINUD", "AMOMAXUW", "AMOMAXUD"]:
    FLAGS[_amo] = ((), _RS1_RS2)

# Kinds that may appear as FINAL bytecode rows: every one has a direct
# lookup table (or none needed).  Source-only kinds (sub-word memory ops,
# register/word shifts, W arithmetic, MULH*, div/rem) are expanded by
# riscv/program.py into sequences of these.
PROVABLE_KINDS: FrozenSet[str] = frozenset([
    "NOOP", "LUI", "AUIPC", "JAL", "JALR",
    "BEQ", "BNE", "BLT", "BGE", "BLTU", "BGEU",
    "LD", "SD",
    "ADDI", "SLTI", "SLTIU", "XORI", "ORI", "ANDI",
    "ADD", "SUB", "SLT", "SLTU", "XOR", "OR", "AND",
    "SLLI", "SRLI", "SRAI",
    "FENCE", "ECALL", "EBREAK", "HOSTIO", "MUL", "MULHU",
    "VirtualAdvice", "VirtualMovsign", "VirtualPow2", "VirtualPow2W",
    "VirtualShiftRightBitmask", "VirtualSignExtendWord",
    "VirtualZeroExtendWord", "VirtualChangeDivisor", "VirtualChangeDivisorW",
    "VirtualSRL", "VirtualSRA", "VirtualMULI",
    "VirtualAssertEQ", "VirtualAssertLTE", "VirtualAssertValidDiv0",
    "VirtualAssertValidUnsignedRemainder", "VirtualAssertMulUNoOverflow",
    "VirtualAssertHalfwordAlignment", "VirtualAssertWordAlignment",
    "ANDN", "VirtualROTRI", "VirtualROTRIW", "VirtualRev8W",
    "VirtualXORROT16", "VirtualXORROT24", "VirtualXORROT32",
    "VirtualXORROT63",
    "VirtualXORROTW7", "VirtualXORROTW8", "VirtualXORROTW12",
    "VirtualXORROTW16",
])


def circuit_flag(kind: str, flag: str) -> int:
    return 1 if flag in FLAGS[kind][0] else 0


def instruction_flag(kind: str, flag: str) -> int:
    return 1 if flag in FLAGS[kind][1] else 0
