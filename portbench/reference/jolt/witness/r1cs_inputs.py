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


from . import flags as F


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


# ---------------------------------------------------------------------------
# vectorized extraction: per-kind static tables + per-program row tables
# ---------------------------------------------------------------------------
