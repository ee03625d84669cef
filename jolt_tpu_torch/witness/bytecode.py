"""Bytecode witness: the Shout one-hot read argument over the EXPANDED
program.

Reference: `zkvm/bytecode/read_raf_checking.rs` + `BytecodePreprocessing`.

Each cycle reads one bytecode row: ra_bc(k, j) is one-hot at k = the
expanded row index (the proving PC; riscv/program.py).  The public table
holds, per row k, the decoded/expanded fields the R1CS consumed as witness
columns: the row index itself (PC), the unexpanded source address, imm, the
14 circuit flags (including the per-row sequence flags), the register
indices and the lookup-table selector columns.  The one-past-the-end halt
row and power-of-two padding rows are NOOP (DoNotUpdateUnexpandedPC), which
makes trace padding rows consistent with the table with no special-casing.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from ..field.params import FR
from ..lookups import tables as LT
from ..riscv.program import Program, Row
from ..tracer.trace import Trace
from . import flags as F
from .r1cs_inputs import row_circuit_flags

P = FR.modulus

# ordered public table columns; each proves one stage-1 opening (register
# index columns prove the register-raf virtual claims; lk_* columns prove
# the instruction read-raf's lookup-table / raf flag claims)
TABLE_COLUMNS = (
    ["pc", "unexpanded_pc", "imm", "branch", "is_noop"]
    + [f"flag_{name}" for name in F.CIRCUIT_FLAGS]
    + ["rd_idx", "rs1_idx", "rs2_idx"]
    + [f"lk_{name}" for name in LT.TABLE_NAMES] + ["lk_raf"]
)

_NO_RD_KINDS = frozenset(
    ["NOOP", "SD", "BEQ", "BNE", "BLT", "BGE", "BLTU",
     "BGEU", "FENCE", "ECALL", "EBREAK", "HOSTIO"])


@dataclasses.dataclass
class BytecodeWitness:
    pc_idx: List[int]                 # [T] per-cycle bytecode row index
    table: Dict[str, List[int]]       # public: column -> [K] values (mod p)
    K: int
    log_K: int
    T: int
    entry: int


def bytecode_K(program: Program) -> int:
    """Table size: expanded rows + the halt row, next power of two."""
    K = 1
    while K < program.n_rows + 1:
        K *= 2
    return K


def decode_table(program: Program, K: int) -> Dict[str, List[int]]:
    """Public expanded-program table, padded with NOOP rows.  Pure function
    of the public program image (both prover and verifier compute it)."""
    table: Dict[str, List[int]] = {c: [0] * K for c in TABLE_COLUMNS}
    halt_addr = program.entry + len(program.code)
    halt = Row(kind="NOOP", address=halt_addr)
    for k in range(K):
        row = program.rows[k] if k < program.n_rows else halt
        kind = row.kind
        cf = row_circuit_flags(row)
        inf = F.FLAGS[kind][1]
        rd = row.rd
        if rd == 0 and kind in ("JAL", "JALR"):
            rd = 32  # the x0-jump virtual-register rewrite (emulator.py)
        if kind in _NO_RD_KINDS or "Assert" in cf:
            rd = 0
        imm = row.imm
        eff = LT.effective_imm(kind, imm)
        if eff is not None:
            imm = eff
        table["pc"][k] = k
        table["unexpanded_pc"][k] = row.address if k < program.n_rows \
            else halt_addr
        table["imm"][k] = imm % P
        table["branch"][k] = 1 if "Branch" in inf else 0
        table["is_noop"][k] = 1 if kind == "NOOP" else 0
        for name in F.CIRCUIT_FLAGS:
            table[f"flag_{name}"][k] = 1 if name in cf else 0
        table["rd_idx"][k] = rd
        table["rs1_idx"][k] = row.rs1
        table["rs2_idx"][k] = row.rs2
        lk = LT.KIND_TABLE.get(kind)
        if lk is not None:
            table[f"lk_{lk}"][k] = 1
        interleaved = not ({"AddOperands", "SubtractOperands",
                            "MultiplyOperands", "Advice"} & set(cf))
        table["lk_raf"][k] = 0 if interleaved else 1
    return table


def extract_bytecode_witness(trace: Trace) -> BytecodeWitness:
    T = trace.padded_length
    program: Program = trace.program
    lo, hi = trace.u64_col("pc_idx")
    pc_idx = (lo.astype(np.uint64)
              | (hi.astype(np.uint64) << np.uint64(32))).tolist()
    pc_idx = [int(k) for k in pc_idx]

    K = bytecode_K(program)
    log_K = K.bit_length() - 1
    for j, k in enumerate(pc_idx):
        assert 0 <= k < K, f"pc_idx out of bytecode range at cycle {j}"

    return BytecodeWitness(pc_idx=pc_idx,
                           table=decode_table(program, K),
                           K=K, log_K=log_K, T=T, entry=program.entry)
