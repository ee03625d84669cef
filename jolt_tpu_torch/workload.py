"""The main path's workload, and the card it runs on.

The workload is `bench.py`'s: the sha2-chain guest
(`examples/gen_sha256.py:emit_inline`, ~2.3k cycles per SHA-256
compression), hashing `SHA2_INPUT` `SHA2_CHAIN` times, which lands the trace
at ~2^18 cycles.  `chip_smoke.py` and `profile_prefix.py` run it at that
size; the tests run it at chain=1.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib.util
import io
import os
import pathlib
import re
import subprocess
from typing import Callable, Dict, Tuple

from .riscv.emulator import MemoryLayout
from .tracer.native import trace_program_native
from .tracer.trace import Trace

SHA2_CHAIN = 114          # ~2^18 cycles, the bench's size
SHA2_INPUT = bytes(range(32))
_GEN_SHA256 = (pathlib.Path(__file__).resolve().parent.parent / "examples"
               / "gen_sha256.py")


def sha2_chain_layout() -> MemoryLayout:
    return MemoryLayout(max_input_size=64, max_output_size=64)


def sha2_chain_source(layout: MemoryLayout, chain: int) -> str:
    """The guest's assembly; the generator imports nothing, so it is loaded
    by file path."""
    spec = importlib.util.spec_from_file_location("gen_sha256", _GEN_SHA256)
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen.emit_inline(input_start=layout.input_start,
                           output_start=layout.output_start,
                           termination=layout.termination, chain=chain)


def sha2_chain_digest(chain: int) -> bytes:
    out = SHA2_INPUT
    for _ in range(chain):
        out = hashlib.sha256(out).digest()
    return out


def sha2_chain_trace(chain: int = SHA2_CHAIN) -> Trace:
    """Trace the guest with the native tracer; raises if its output is not
    the SHA-256 chain of the input."""
    layout = sha2_chain_layout()
    trace = trace_program_native(sha2_chain_source(layout, chain),
                                 layout=layout, inputs=SHA2_INPUT)
    if bytes(trace.device.outputs[:32]) != sha2_chain_digest(chain):
        raise RuntimeError(f"sha2-chain output wrong (chain={chain})")
    return trace


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def timed_stages(fn: Callable[[], object]
                 ) -> Tuple[object, Dict[str, float], str]:
    """Run `fn()` with the prover's stage timing on (JOLT_TPU_STAGE_TIMING);
    return its result, the seconds of each stage and the printed lines."""
    buf = io.StringIO()
    os.environ["JOLT_TPU_STAGE_TIMING"] = "1"
    try:
        with contextlib.redirect_stdout(buf):
            out = fn()
    finally:
        del os.environ["JOLT_TPU_STAGE_TIMING"]
    text = buf.getvalue()
    stages = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"\[prove\] ([\w-]+): ([0-9.]+)s", text)}
    return out, stages, text
