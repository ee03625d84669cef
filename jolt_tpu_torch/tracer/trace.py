"""Execution trace: the witness interface between host tracer and TPU prover.

Structure-of-arrays trace matching the reference's `JoltTraceRow` semantics
(`crates/jolt-riscv/src/trace_row.rs`, `tracer/src/jolt_cycle_adapter.rs`):
per cycle {instruction kind, pc, register ids, pre-values, write value, RAM
access {dword address, pre, post}, immediate, next pc}.

The trace is padded to a power of two with NOOP rows: padded length =
max(256, next_pow2(T + 1)) per `zkvm/prover.rs:346-362`
(MIN_PADDED_TRACE_LENGTH = 256, `commitment_scheme.rs:41`).

All u64 columns are stored as two uint32 arrays (lo, hi): TPUs have no
64-bit integer units, and the field on-ramp (`ops.from_u64`) consumes u32
pairs directly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from ..riscv import isa
from ..riscv.assembler import assemble
from ..riscv.emulator import (Emulator, JoltDevice, MemoryLayout,
                              RAM_START_ADDRESS, RowEmulator)
from ..riscv.elf import is_elf, load_elf
from ..riscv.program import expand_program

# column -> dtype; u64 columns are split into <name>_lo / <name>_hi uint32
TRACE_FIELDS = [
    ("kind", np.uint16),
    ("pc", "u64"),
    ("rd", np.uint8),       # 255 = none
    ("rs1", np.uint8),
    ("rs2", np.uint8),
    ("rs1_val", "u64"),
    ("rs2_val", "u64"),
    ("rd_pre", "u64"),
    ("rd_post", "u64"),
    ("ram_addr", "u64"),    # aligned dword address, 0 = no access
    ("ram_pre", "u64"),
    ("ram_post", "u64"),
    ("imm", "i64"),
    ("next_pc", "u64"),
    ("pc_idx", "u64"),      # expanded bytecode row index (the proving PC)
    ("next_pc_idx", "u64"),
]


@dataclasses.dataclass
class Trace:
    """SoA execution trace (padded), plus the public I/O device state."""

    columns: Dict[str, np.ndarray]
    length: int            # unpadded cycle count
    padded_length: int
    device: JoltDevice
    memory_layout: MemoryLayout
    code: bytes = b""      # the (public) program image
    entry: int = RAM_START_ADDRESS
    program: object = None  # riscv.program.Program (expanded public rows)

    def col(self, name: str) -> np.ndarray:
        return self.columns[name]

    def u64_col(self, name: str):
        """(lo, hi) uint32 pair for a 64-bit column."""
        return self.columns[name + "_lo"], self.columns[name + "_hi"]

    @property
    def log_T(self) -> int:
        return self.padded_length.bit_length() - 1


def _padded_length(T: int, min_padded: int = 256) -> int:
    """Next power of two above T (strictly: +1 for the final no-op row),
    floored at MIN_PADDED_TRACE_LENGTH=256 (commitment_scheme.rs:41).
    Tests may lower the floor -- the protocol works at any power of two."""
    m = min_padded
    while m < T + 1:
        m *= 2
    return m


def padding_target(program, last_kind: str, final_pc: int, final_idx: int):
    """(pc, pc_idx) for trace padding rows.

    Padding NOOP cycles must read a NOOP bytecode row whose address
    satisfies the R1CS next-pc constraints of the final real cycle:
      * if the row after the final cycle is a NOOP row (or the halt row),
        padding continues there (termination store placed at the end of
        the image -- the assembler-guest convention);
      * if the final cycle is a jump (the reference's jump-to-self
        termination heuristic, tracer/src/lib.rs:331), its Jump flag
        disables the next-pc constraints and padding reads the halt row.
    """
    halt_addr = program.entry + len(program.code)
    n = program.n_rows
    if final_idx == n:
        return halt_addr, n
    if final_idx < n and program.rows[final_idx].kind == "NOOP":
        return program.rows[final_idx].address, final_idx
    if last_kind in ("JAL", "JALR"):
        return halt_addr, n
    raise ValueError(
        "guest must terminate with the store as the last image instruction "
        f"or end on a jump-to-self (last kind {last_kind}, next row "
        f"{final_idx} is {program.rows[final_idx].kind})")


def trace_program(code: bytes | str, inputs: bytes = b"",
                  layout: Optional[MemoryLayout] = None,
                  max_cycles: int = 1 << 24,
                  entry: int = RAM_START_ADDRESS,
                  min_padded: int = 256,
                  trusted_advice: bytes = b"",
                  untrusted_advice: bytes = b"") -> Trace:
    """Assemble (if given source) and execute a guest, returning the padded
    SoA trace.  The guest signals completion by storing to the termination
    address (see `MemoryLayout`)."""
    if isinstance(code, str):
        code = assemble(code, base=entry)
    start = entry
    if is_elf(code):
        loaded = load_elf(code)
        code, entry, start = loaded.image, loaded.base, loaded.entry
    layout = layout or MemoryLayout()
    device = JoltDevice(layout, inputs, trusted_advice, untrusted_advice)
    program = expand_program(code, entry, start)
    emu = RowEmulator(device, program)
    rows = emu.run(max_cycles=max_cycles)

    T = len(rows)
    padded = _padded_length(T, min_padded)

    n_fields = len(TRACE_FIELDS)
    raw = np.zeros((T, n_fields), dtype=np.uint64)
    if T:
        raw[:] = np.array(
            [[r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7], r[8], r[9],
              r[10], r[11], r[12] & ((1 << 64) - 1), r[13], r[14], r[15]]
             for r in rows],
            dtype=np.uint64)

    cols: Dict[str, np.ndarray] = {}
    for i, (name, dt) in enumerate(TRACE_FIELDS):
        full = np.zeros(padded, dtype=np.uint64)
        full[:T] = raw[:, i]
        if dt in ("u64", "i64"):
            cols[name + "_lo"] = (full & 0xFFFFFFFF).astype(np.uint32)
            cols[name + "_hi"] = (full >> np.uint64(32)).astype(np.uint32)
        else:
            cols[name] = full.astype(dt)

    # Padding rows are NOOP (kind id 0); pc of padding rows repeats the final
    # next_pc so PC-continuity relations stay satisfiable.
    if T and padded > T:
        last_kind = isa.KINDS[int(raw[T - 1, 0])]
        final_pc, final_idx = padding_target(
            program, last_kind, int(raw[T - 1, 13]), int(raw[T - 1, 15]))
        cols["pc_lo"][T:] = final_pc & 0xFFFFFFFF
        cols["pc_hi"][T:] = final_pc >> 32
        cols["next_pc_lo"][T:] = final_pc & 0xFFFFFFFF
        cols["next_pc_hi"][T:] = final_pc >> 32
        cols["pc_idx_lo"][T:] = final_idx & 0xFFFFFFFF
        cols["pc_idx_hi"][T:] = final_idx >> 32
        cols["next_pc_idx_lo"][T:] = final_idx & 0xFFFFFFFF
        cols["next_pc_idx_hi"][T:] = final_idx >> 32
        cols["rd"][T:] = 255

    return Trace(columns=cols, length=T, padded_length=padded,
                 device=device, memory_layout=layout, code=code, entry=entry,
                 program=program)
