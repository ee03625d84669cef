"""Trace checkpointing: save/load a full execution trace to one file.

Copied from the JAX package's `tracer/trace_io.py` (host code, logic
unchanged): the files the two packages write load in either.

Analog of the reference's trace-to-file path (`tracer/src/emulator/` trace
dumps + `jolt-program` preprocessing serialization, SURVEY §5.4): trace
once, prove many times / elsewhere.  Format: a single .npz holding the SoA
columns plus a JSON header (layout, device state, program image).  The
expanded Program is NOT stored -- it is a deterministic function of
(code, entry, start) and is rebuilt on load, which doubles as an integrity
check that the loader/expander pipeline matches the trace.
"""

from __future__ import annotations

import io
import json

import numpy as np

from ..riscv.emulator import JoltDevice, MemoryLayout
from ..riscv.program import expand_program
from .trace import Trace

_FORMAT = 1


def save_trace(tr: Trace, path: str) -> None:
    header = {
        "format": _FORMAT,
        "length": tr.length,
        "padded_length": tr.padded_length,
        "entry": tr.entry,
        "start": tr.program.start if tr.program is not None else tr.entry,
        "layout": {
            "max_input_size": tr.memory_layout.max_input_size,
            "max_output_size": tr.memory_layout.max_output_size,
            "stack_size": tr.memory_layout.stack_size,
            "heap_size": tr.memory_layout.heap_size,
        },
        "inputs": bytes(tr.device.inputs).hex(),
        "outputs": bytes(tr.device.outputs).hex(),
        "panic": bool(tr.device.panic),
        "terminated": bool(tr.device.terminated),
    }
    arrays = dict(tr.columns)
    arrays["__code__"] = np.frombuffer(tr.code, dtype=np.uint8)
    arrays["__header__"] = np.frombuffer(
        json.dumps(header).encode(), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


def load_trace(path: str) -> Trace:
    with open(path, "rb") as f:
        data = np.load(io.BytesIO(f.read()))
    header = json.loads(bytes(data["__header__"]).decode())
    if header.get("format") != _FORMAT:
        raise ValueError(f"unsupported trace format {header.get('format')}")
    code = bytes(data["__code__"])
    layout = MemoryLayout(**header["layout"])
    device = JoltDevice(layout, bytes.fromhex(header["inputs"]))
    device.outputs = bytearray(bytes.fromhex(header["outputs"]))
    device.panic = header["panic"]
    device.terminated = header["terminated"]
    columns = {k: data[k] for k in data.files
               if not k.startswith("__")}
    program = expand_program(code, header["entry"], header["start"])
    return Trace(columns=columns, length=header["length"],
                 padded_length=header["padded_length"], device=device,
                 memory_layout=layout, code=code, entry=header["entry"],
                 program=program)
