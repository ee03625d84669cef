"""Carry state across from the JAX package without importing it.

Both functions take plain numpy arrays, ints, bytes and dicts, so a test
that holds the port against the JAX package can hand the same trace and the
same field values to both.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .field import ops
from .field.params import FR, limbs_to_int
from .riscv.emulator import JoltDevice, MemoryLayout
from .riscv.program import expand_program
from .tracer.trace import Trace

# JAX package Montgomery form: x * 2^260; the port's: x * 2^256
_JAX_TO_PORT = pow(1 << 4, -1, FR.modulus)


def from_jax_limbs(limbs: np.ndarray, device="cuda") -> torch.Tensor:
    """The JAX package's Montgomery limbs (20, *batch) uint32, 13 bits each,
    R = 2^260 -> the port's Montgomery limbs (8, *batch) int32, R = 2^256."""
    limbs = np.asarray(limbs, dtype=np.uint32)
    batch = limbs.shape[1:]
    flat = limbs.reshape(limbs.shape[0], -1)
    p = FR.modulus
    vals = [limbs_to_int(flat[:, i]) * _JAX_TO_PORT % p
            for i in range(flat.shape[1])]
    words = np.zeros((ops.N_LIMBS, len(vals)), dtype=np.uint32)
    if vals:
        buf = b"".join(v.to_bytes(32, "little") for v in vals)
        words = np.frombuffer(buf, dtype="<u4").reshape(-1, ops.N_LIMBS).T
    t = torch.from_numpy(np.array(words, dtype=np.uint32).view(np.int32))
    return t.reshape((ops.N_LIMBS,) + batch).to(device)


def trace_from_numpy(columns: Dict[str, np.ndarray], length: int,
                     padded_length: int, device_state: dict, layout: dict,
                     code: bytes, entry: int,
                     program_rows: Optional[Sequence[dict]] = None,
                     start: Optional[int] = None) -> Trace:
    """The port's `Trace` from the plain fields of a JAX package trace.

    `device_state` holds the public I/O (`inputs`, `outputs`, `panic`, and
    optionally `trusted_advice` / `untrusted_advice`); `layout` holds the
    `MemoryLayout` constructor fields.  The port expands the program itself
    from (code, entry, start); `program_rows`, the other side's expanded
    rows as dicts of `Row` fields, must equal that expansion."""
    mem = MemoryLayout(**layout)
    dev = JoltDevice(mem, bytes(device_state.get("inputs", b"")),
                     bytes(device_state.get("trusted_advice", b"")),
                     bytes(device_state.get("untrusted_advice", b"")))
    dev.outputs = bytearray(device_state.get("outputs", b""))
    dev.panic = bool(device_state.get("panic", False))
    dev.terminated = True
    program = expand_program(code, entry, entry if start is None else start)
    if program_rows is not None:
        mine = [dataclasses.asdict(r) for r in program.rows]
        if mine != [dict(r) for r in program_rows]:
            raise ValueError("program rows differ from the port's expansion")
    cols = {k: np.array(v, copy=True) for k, v in columns.items()}
    return Trace(columns=cols, length=length, padded_length=padded_length,
                 device=dev, memory_layout=mem, code=code, entry=entry,
                 program=program)
