"""The Jolt RV64 uniform R1CS: 19 eq-conditional + 3 product constraints.

Direct port of `crates/jolt-prover-legacy/src/zkvm/r1cs/constraints.rs:236-597`
(layout: `crates/jolt-r1cs/src/constraints/rv64.rs:22-70`).

Constraint forms:
  * eq-conditional row k: Az = guard, Bz = left - right, Cz = 0
  * product row: Az = left factor, Bz = right factor, Cz = output variable

A linear combination (LC) is a list of (var_index, coeff) with an optional
constant term folded into the V_CONST column (z[0] == 1).
"""

from __future__ import annotations

from typing import List, Tuple


from ..witness import r1cs_inputs as W


BIAS64 = 1 << 64  # two's-complement bias (constraints.rs:303)

_F = {name: W.V_FLAG_BASE + i
      for i, name in enumerate(
          ["AddOperands", "SubtractOperands", "MultiplyOperands", "Load",
           "Store", "Jump", "WriteLookupOutputToRD", "VirtualInstruction",
           "Assert", "DoNotUpdateUnexpandedPC", "Advice", "IsCompressed",
           "IsFirstInSequence", "IsLastInSequence"])}


def _lc(*terms) -> LC:
    return [(v, c) for v, c in terms if c != 0]


# (label, guard LC, left-minus-right LC); Cz = 0
EQ_CONSTRAINTS: List[Tuple[str, LC, LC]] = [
    ("RamAddrEqRs1PlusImmIfLoadStore",
     _lc((_F["Load"], 1), (_F["Store"], 1)),
     _lc((W.V_RAM_ADDRESS, 1), (W.V_RS1_VALUE, -1), (W.V_IMM, -1))),
    ("RamAddrEqZeroIfNotLoadStore",
     _lc((W.V_CONST, 1), (_F["Load"], -1), (_F["Store"], -1)),
     _lc((W.V_RAM_ADDRESS, 1))),
    ("RamReadEqRamWriteIfLoad",
     _lc((_F["Load"], 1)),
     _lc((W.V_RAM_READ_VALUE, 1), (W.V_RAM_WRITE_VALUE, -1))),
    ("RamReadEqRdWriteIfLoad",
     _lc((_F["Load"], 1)),
     _lc((W.V_RAM_READ_VALUE, 1), (W.V_RD_WRITE_VALUE, -1))),
    ("Rs2EqRamWriteIfStore",
     _lc((_F["Store"], 1)),
     _lc((W.V_RS2_VALUE, 1), (W.V_RAM_WRITE_VALUE, -1))),
    ("LeftLookupZeroUnlessAddSubMul",
     _lc((_F["AddOperands"], 1), (_F["SubtractOperands"], 1), (_F["MultiplyOperands"], 1)),
     _lc((W.V_LEFT_LOOKUP_OPERAND, 1))),
    ("LeftLookupEqLeftInputOtherwise",
     _lc((W.V_CONST, 1), (_F["AddOperands"], -1), (_F["SubtractOperands"], -1),
         (_F["MultiplyOperands"], -1)),
     _lc((W.V_LEFT_LOOKUP_OPERAND, 1), (W.V_LEFT_INSTRUCTION_INPUT, -1))),
    ("RightLookupAdd",
     _lc((_F["AddOperands"], 1)),
     _lc((W.V_RIGHT_LOOKUP_OPERAND, 1), (W.V_LEFT_INSTRUCTION_INPUT, -1),
         (W.V_RIGHT_INSTRUCTION_INPUT, -1))),
    ("RightLookupSub",
     _lc((_F["SubtractOperands"], 1)),
     _lc((W.V_RIGHT_LOOKUP_OPERAND, 1), (W.V_LEFT_INSTRUCTION_INPUT, -1),
         (W.V_RIGHT_INSTRUCTION_INPUT, 1), (W.V_CONST, -BIAS64))),
    ("RightLookupEqProductIfMul",
     _lc((_F["MultiplyOperands"], 1)),
     _lc((W.V_RIGHT_LOOKUP_OPERAND, 1), (W.V_PRODUCT, -1))),
    ("RightLookupEqRightInputOtherwise",
     _lc((W.V_CONST, 1), (_F["AddOperands"], -1), (_F["SubtractOperands"], -1),
         (_F["MultiplyOperands"], -1), (_F["Advice"], -1)),
     _lc((W.V_RIGHT_LOOKUP_OPERAND, 1), (W.V_RIGHT_INSTRUCTION_INPUT, -1))),
    ("AssertLookupOne",
     _lc((_F["Assert"], 1)),
     _lc((W.V_LOOKUP_OUTPUT, 1), (W.V_CONST, -1))),
    ("RdWriteEqLookupIfWriteLookupToRd",
     _lc((_F["WriteLookupOutputToRD"], 1)),
     _lc((W.V_RD_WRITE_VALUE, 1), (W.V_LOOKUP_OUTPUT, -1))),
    ("RdWriteEqPCPlusConstIfWritePCtoRD",
     _lc((_F["Jump"], 1)),
     _lc((W.V_RD_WRITE_VALUE, 1), (W.V_UNEXPANDED_PC, -1), (W.V_CONST, -4),
         (_F["IsCompressed"], 2))),
    ("NextUnexpPCEqLookupIfShouldJump",
     _lc((W.V_SHOULD_JUMP, 1)),
     _lc((W.V_NEXT_UNEXPANDED_PC, 1), (W.V_LOOKUP_OUTPUT, -1))),
    ("NextUnexpPCEqPCPlusImmIfShouldBranch",
     _lc((W.V_SHOULD_BRANCH, 1)),
     _lc((W.V_NEXT_UNEXPANDED_PC, 1), (W.V_UNEXPANDED_PC, -1), (W.V_IMM, -1))),
    ("NextUnexpPCUpdateOtherwise",
     _lc((W.V_CONST, 1), (W.V_SHOULD_BRANCH, -1), (_F["Jump"], -1)),
     _lc((W.V_NEXT_UNEXPANDED_PC, 1), (W.V_UNEXPANDED_PC, -1), (W.V_CONST, -4),
         (_F["DoNotUpdateUnexpandedPC"], 4), (_F["IsCompressed"], 2))),
    ("NextPCEqPCPlusOneIfInline",
     _lc((_F["VirtualInstruction"], 1), (_F["IsLastInSequence"], -1)),
     _lc((W.V_NEXT_PC, 1), (W.V_PC, -1), (W.V_CONST, -1))),
    ("MustStartSequenceFromBeginning",
     _lc((W.V_NEXT_IS_VIRTUAL, 1), (W.V_NEXT_IS_FIRST_IN_SEQUENCE, -1)),
     _lc((W.V_CONST, 1), (_F["DoNotUpdateUnexpandedPC"], -1))),
]

# (label, left LC, right LC, output LC)  [Az*Bz = Cz]
PRODUCT_CONSTRAINTS: List[Tuple[str, LC, LC, LC]] = [
    ("Instruction",
     _lc((W.V_LEFT_INSTRUCTION_INPUT, 1)),
     _lc((W.V_RIGHT_INSTRUCTION_INPUT, 1)),
     _lc((W.V_PRODUCT, 1))),
    ("ShouldBranch",
     _lc((W.V_LOOKUP_OUTPUT, 1)),
     _lc((W.V_BRANCH, 1)),
     _lc((W.V_SHOULD_BRANCH, 1))),
    ("ShouldJump",
     _lc((_F["Jump"], 1)),
     _lc((W.V_CONST, 1), (W.V_NEXT_IS_NOOP, -1)),
     _lc((W.V_SHOULD_JUMP, 1))),
]

NUM_EQ = len(EQ_CONSTRAINTS)                 # 19
NUM_CONSTRAINTS = NUM_EQ + len(PRODUCT_CONSTRAINTS)  # 22


def all_rows() -> List[Tuple[LC, LC, LC]]:
    """All 22 rows as (A, B, C) LCs, in constraint order."""
    rows = [(g, lmr, []) for _, g, lmr in EQ_CONSTRAINTS]
    rows += [(l, r, o) for _, l, r, o in PRODUCT_CONSTRAINTS]
    return rows
