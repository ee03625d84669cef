"""ctypes bindings for the native C++ row tracer (csrc/tracer.cpp).

Python performs the static bytecode expansion (riscv/program.py) and
serializes the FINAL row table; the C++ tracer executes it and produces the
identical SoA `Trace` as the Python RowEmulator.  Equivalence is a test
gate (the reference's serial-vs-parallel tracer paranoia checks,
`tracer/src/parallel.rs:54-60`).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

from ..riscv import isa
from ..riscv.assembler import assemble
from ..riscv.emulator import JoltDevice, MemoryLayout, RAM_START_ADDRESS
from ..riscv.elf import is_elf, load_elf
from ..riscv.program import ADVICE_OP_ID, Program, expand_program
from .trace import TRACE_FIELDS, Trace, _padded_length

_PKG_DIR = os.path.join(os.path.dirname(__file__), "..")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_SO = os.path.join(_BUILD_DIR, "libjolt_tracer.so")
_SRC = os.path.join(_PKG_DIR, "csrc", "tracer.cpp")

# mirror of tracer.cpp ProgRow
_PROG_DTYPE = np.dtype([
    ("kind", np.uint16), ("rd", np.uint8), ("rs1", np.uint8),
    ("rs2", np.uint8), ("flags", np.uint8), ("advice_op", np.int8),
    ("advice_rs1", np.uint8), ("advice_rs2", np.uint8),
    ("_pad", np.uint8, 3),
    ("imm", np.int64), ("address", np.uint64),
])


class _TraceResult(ctypes.Structure):
    _fields_ = [
        ("rows", ctypes.c_void_p), ("count", ctypes.c_uint64),
        ("outputs", ctypes.c_void_p), ("outputs_len", ctypes.c_uint64),
        ("panic_flag", ctypes.c_int32), ("status", ctypes.c_int32),
        ("rows_owner", ctypes.c_void_p), ("machine_owner", ctypes.c_void_p),
        ("console", ctypes.c_void_p), ("console_len", ctypes.c_uint64),
        ("markers", ctypes.c_void_p), ("markers_len", ctypes.c_uint64),
    ]


_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-pthread", "-o", _SO, _SRC],
            check=True)
    lib = ctypes.CDLL(_SO)
    lib.jolt_trace_rows.restype = ctypes.POINTER(_TraceResult)
    lib.jolt_trace_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64,
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_char_p, ctypes.c_uint64,
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
        # trusted / untrusted advice: (bytes, len, start, end) each
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_uint64,
    ]
    lib.jolt_trace_rows_parallel.restype = ctypes.POINTER(_TraceResult)
    lib.jolt_trace_rows_parallel.argtypes = (
        lib.jolt_trace_rows.argtypes + [ctypes.c_uint64, ctypes.c_uint64])
    lib.jolt_trace_free.argtypes = [ctypes.POINTER(_TraceResult)]
    lib.jolt_trace_fill_columns.argtypes = [ctypes.POINTER(_TraceResult)] + \
        [ctypes.c_void_p] * 28
    _lib = lib
    return lib


def serialize_program(program: Program) -> np.ndarray:
    """Pack the expanded rows into the C ABI ProgRow array."""
    arr = np.zeros(program.n_rows, dtype=_PROG_DTYPE)
    for i, r in enumerate(program.rows):
        arr[i]["kind"] = isa.KIND_ID[r.kind]
        arr[i]["rd"] = r.rd
        arr[i]["rs1"] = r.rs1
        arr[i]["rs2"] = r.rs2
        arr[i]["flags"] = ((1 if r.virtual else 0) | (2 if r.first else 0)
                           | (4 if r.last else 0)
                           | (8 if r.compressed else 0))
        if r.advice is not None:
            op, a, b = r.advice
            arr[i]["advice_op"] = ADVICE_OP_ID[op]
            arr[i]["advice_rs1"] = a
            arr[i]["advice_rs2"] = b
        else:
            arr[i]["advice_op"] = -1
        arr[i]["imm"] = np.int64(r.imm if -(1 << 63) <= r.imm < (1 << 63)
                                 else r.imm - (1 << 64))
        arr[i]["address"] = r.address
    return arr


def trace_program_native(code: bytes | str, inputs: bytes = b"",
                         layout: Optional[MemoryLayout] = None,
                         max_cycles: int = 1 << 24,
                         entry: int = RAM_START_ADDRESS,
                         parallel: Optional[int] = None,
                         chunk_rows: Optional[int] = None,
                         trusted_advice: bytes = b"",
                         untrusted_advice: bytes = b"") -> Trace:
    """Native-tracer twin of `trace_program` (same Trace output).

    parallel > 1 (or JOLT_TRACER_PARALLEL=n) enables two-pass chunked
    tracing: pass-1 execute-only checkpoints + parallel chunk re-trace,
    bit-identical to the serial path (the reference's TRACER_PARALLEL /
    JOLT_TRACER_CHUNK_ROWS knobs, tracer/src/lib.rs:313-325)."""
    if parallel is None:
        parallel = int(os.environ.get("JOLT_TRACER_PARALLEL", "0"))
    if chunk_rows is None:
        chunk_rows = int(os.environ.get("JOLT_TRACER_CHUNK_ROWS", "65536"))
    if isinstance(code, str):
        code = assemble(code, base=entry)
    start = entry
    if is_elf(code):
        loaded = load_elf(code)
        code, entry, start = loaded.image, loaded.base, loaded.entry
    layout = layout or MemoryLayout()
    program = expand_program(code, entry, start)
    prog_arr = serialize_program(program)
    lib = _load()
    common = (prog_arr.ctypes.data_as(ctypes.c_void_p), program.n_rows,
              code, len(code), entry, program.start, inputs, len(inputs),
              layout.input_start, layout.input_end,
              layout.output_start, layout.output_end,
              layout.panic, layout.termination, layout.io_end,
              trusted_advice, len(trusted_advice),
              layout.trusted_advice_start, layout.trusted_advice_end,
              untrusted_advice, len(untrusted_advice),
              layout.untrusted_advice_start, layout.untrusted_advice_end,
              max_cycles)
    if parallel and parallel > 1:
        res_p = lib.jolt_trace_rows_parallel(*common, chunk_rows, parallel)
    else:
        res_p = lib.jolt_trace_rows(*common)
    res = res_p.contents
    try:
        if res.status == 1:
            raise ValueError("native tracer: bad jump target / failed assert")
        if res.status == 2:
            raise RuntimeError(f"exceeded max_cycles={max_cycles}")
        T = int(res.count)
        padded = _padded_length(T)
        cols = {}
        for name, dt in TRACE_FIELDS:
            if dt in ("u64", "i64"):
                cols[name + "_lo"] = np.zeros(padded, dtype=np.uint32)
                cols[name + "_hi"] = np.zeros(padded, dtype=np.uint32)
            else:
                cols[name] = np.zeros(padded, dtype=dt)
        ptr_order = ["kind", "rd", "rs1", "rs2"] + [
            f"{n}_{w}" for n, dt in TRACE_FIELDS if dt in ("u64", "i64")
            for w in ("lo", "hi")]
        ptrs = [cols[k].ctypes.data_as(ctypes.c_void_p) for k in ptr_order]
        lib.jolt_trace_fill_columns(res_p, *ptrs)
        outputs = bytes(np.ctypeslib.as_array(
            ctypes.cast(res.outputs, ctypes.POINTER(ctypes.c_uint8)),
            shape=(int(res.outputs_len),))) if res.outputs_len else b""
        panic = bool(res.panic_flag)
        console = bytes(np.ctypeslib.as_array(
            ctypes.cast(res.console, ctypes.POINTER(ctypes.c_uint8)),
            shape=(int(res.console_len),))) if res.console_len else b""
        marker_blob = bytes(np.ctypeslib.as_array(
            ctypes.cast(res.markers, ctypes.POINTER(ctypes.c_uint8)),
            shape=(int(res.markers_len),))) if res.markers_len else b""
    finally:
        lib.jolt_trace_free(res_p)

    # decode cycle-marker records: [u32 event][u64 cycle][u32 len][label]
    cycle_markers = []
    off = 0
    while off + 16 <= len(marker_blob):
        event = int.from_bytes(marker_blob[off:off + 4], "little")
        cyc = int.from_bytes(marker_blob[off + 4:off + 12], "little")
        ln = int.from_bytes(marker_blob[off + 12:off + 16], "little")
        label = marker_blob[off + 16:off + 16 + ln].decode("utf-8",
                                                           "replace")
        cycle_markers.append((label, event, cyc))
        off += 16 + ln

    if T and padded > T:
        from .trace import padding_target
        last_kind = isa.KINDS[int(cols["kind"][T - 1])]
        final_pc, final_idx = padding_target(
            program, last_kind,
            int(cols["next_pc_lo"][T - 1])
            | int(cols["next_pc_hi"][T - 1]) << 32,
            int(cols["next_pc_idx_lo"][T - 1])
            | int(cols["next_pc_idx_hi"][T - 1]) << 32)
        cols["pc_lo"][T:] = final_pc & 0xFFFFFFFF
        cols["pc_hi"][T:] = final_pc >> 32
        cols["next_pc_lo"][T:] = final_pc & 0xFFFFFFFF
        cols["next_pc_hi"][T:] = final_pc >> 32
        cols["pc_idx_lo"][T:] = final_idx & 0xFFFFFFFF
        cols["pc_idx_hi"][T:] = final_idx >> 32
        cols["next_pc_idx_lo"][T:] = final_idx & 0xFFFFFFFF
        cols["next_pc_idx_hi"][T:] = final_idx >> 32
        cols["rd"][T:] = 255

    device = JoltDevice(layout, inputs, trusted_advice, untrusted_advice)
    device.outputs = bytearray(outputs)
    device.panic = panic
    device.terminated = True
    device.console = bytearray(console)
    device.cycle_markers = cycle_markers
    return Trace(columns=cols, length=T, padded_length=padded,
                 device=device, memory_layout=layout, code=code, entry=entry,
                 program=program)
