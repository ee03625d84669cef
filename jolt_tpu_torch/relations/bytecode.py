"""Bytecode read-raf Shout: decoded-field openings vs the public program.

Reference: `zkvm/bytecode/read_raf_checking.rs` (stage 6a/6b).

Relation (all decoded columns batched under gamma powers):
    sum_{k,j} eq(r_cycle, j) * ra_bc(k,j) * TAB(k) = sum_c gamma^c * claim_c
where TAB = sum_c gamma^c * C_c and C_c are the PUBLIC decoded-program
columns (pc affine, imm, circuit flags, branch flag).  The verifier
evaluates TAB(r_addr) itself from the program -- the prover cannot lie
about decoding.  The prover-side instance is the sparse
SparseOneHotTableEval tier (relations/ram_sparse.py); ra_bc booleanity and
Hamming weight run in stage 7.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from ..field import FR
from ..witness.bytecode import TABLE_COLUMNS, decode_table

P = FR.modulus

# opening name in stage-1 id space -> table column (pc = expanded row
# index, unexpanded_pc = source byte address)
CLAIM_COLUMNS: List = [("pc", "pc"), ("unexpanded_pc", "unexpanded_pc"),
                       ("imm", "imm"), ("branch", "branch")] + [
    (f"flag_{n}", f"flag_{n}")
    for n in ("AddOperands", "SubtractOperands", "MultiplyOperands", "Load",
              "Store", "Jump", "WriteLookupOutputToRD", "VirtualInstruction",
              "Assert", "DoNotUpdateUnexpandedPC", "Advice", "IsCompressed",
              "IsFirstInSequence", "IsLastInSequence")] + [
    ("_virtual_rd_idx", "rd_idx"), ("_virtual_rs1_idx", "rs1_idx"),
    ("_virtual_rs2_idx", "rs2_idx")]


def combined_table(table: Dict[str, List[int]], entry: int, K: int,
                   gamma: int, columns=None) -> List[int]:
    out = [0] * K
    g = 1
    for _, col_name in (columns or CLAIM_COLUMNS):
        col = table[col_name]
        for k in range(K):
            out[k] = (out[k] + g * col[k]) % P
        g = g * gamma % P
    return out


def combined_table_eval(program, K: int, gamma: int,
                        r_addr: Sequence[int], columns=None) -> int:
    """Verifier-side: MLE of the combined public table at r_addr (the
    expanded program is a pure function of the public image)."""
    tab = combined_table(decode_table(program, K), program.entry, K, gamma,
                         columns)
    n = len(r_addr)
    assert K == 1 << n
    # chi weights via iterative halving (O(K) muls)
    vals = [v % P for v in tab]
    for rb in reversed(r_addr):  # bind LSB var first
        vals = [(vals[2 * i] + rb * (vals[2 * i + 1] - vals[2 * i])) % P
                for i in range(len(vals) // 2)]
    return vals[0]
