"""Host SDK: the `#[jolt::provable]` analog.

The reference proc-macro generates a per-guest API family
(`jolt-sdk/macros/src/lib.rs:21,130-562`):

    compile_X, preprocess_shared_X, preprocess_prover_X,
    build_prover_X, build_verifier_X, trace_X, analyze_X

Python needs no codegen: `Guest` packages the same lifecycle as methods,
and `provable()` builds one from a guest source (assembly text, raw image
bytes, or an ELF path) plus the memory-layout attributes the macro accepts
(`max_input_size`, `max_output_size`, `stack_size`, `heap_size`,
`max_trace_length`).

    guest = provable("examples/fibonacci.s", max_input_size=64,
                     max_output_size=64)
    prove_fib = guest.build_prover(pcs="dory")
    verify_fib = guest.build_verifier(pcs="dory")
    output, proof = prove_fib(inputs)
    assert verify_fib(inputs, output.outputs, output.panic, proof)

Preprocessing (ELF decode -> bytecode expansion -> program digest) runs
once per guest and is shared by every prove/verify closure, mirroring
`preprocess_shared` / `JoltProverPreprocessing`.

Torch counterpart of the JAX package's `sdk.py`, the same API with one
more attribute: `device`, where the prover closures run (the card,
"cuda", unless the caller asks for "cpu"; with no card "cuda" raises when
the guest is built).  Verification is host work.
"""

from __future__ import annotations

import collections
import dataclasses
import os
from typing import Callable, Dict, Optional, Tuple

from .prover.prover import (JoltProof, preprocessing_digest, prove,
                            resolve_device)
from .riscv import isa
from .riscv.assembler import assemble
from .riscv.elf import is_elf, load_elf
from .riscv.emulator import RAM_START_ADDRESS, MemoryLayout
from .riscv.program import Program, expand_program
from .tracer.trace import Trace, trace_program
from .verifier.verifier import (PublicIO, VerificationError,
                                expected_bytecode_log_K, verify)


@dataclasses.dataclass
class GuestOutput:
    """What a prover closure returns beside the proof (the reference's
    `(output, proof, io_device)` triple)."""
    outputs: bytes
    panic: bool
    trace_length: int


@dataclasses.dataclass
class ProgramSummary:
    """`analyze_X` result: per-instruction cycle counts
    (`host/analyze.rs`)."""
    trace_length: int
    padded_length: int
    counts: Dict[str, int]

    def top(self, n: int = 10):
        return collections.Counter(self.counts).most_common(n)


class Guest:
    """One guest program's host API (compile + preprocess + closures)."""

    def __init__(self, source, max_input_size: int = 64,
                 max_output_size: int = 64, stack_size: int = 4096,
                 heap_size: int = 1 << 25, max_trace_length: int = 1 << 24,
                 max_trusted_advice_size: int = 0,
                 max_untrusted_advice_size: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.layout = MemoryLayout(
            max_input_size=max_input_size,
            max_output_size=max_output_size,
            stack_size=stack_size,
            heap_size=heap_size,
            max_trusted_advice_size=max_trusted_advice_size,
            max_untrusted_advice_size=max_untrusted_advice_size)
        self.max_trace_length = max_trace_length
        # ---- compile_X: source -> machine image -------------------------
        if isinstance(source, str) and os.path.exists(source):
            source = open(source, "rb").read()
            if not is_elf(source):
                source = source.decode()
        if isinstance(source, str):
            self.code = assemble(source)
            self.entry = self.start = RAM_START_ADDRESS
        elif is_elf(source):
            loaded = load_elf(source)
            self.code, self.entry, self.start = (loaded.image, loaded.base,
                                                 loaded.entry)
        else:
            self.code = bytes(source)
            self.entry = self.start = RAM_START_ADDRESS
        self._program: Optional[Program] = None
        self._digest: Optional[bytes] = None

    # ---- preprocess_shared_X -------------------------------------------
    @property
    def program(self) -> Program:
        if self._program is None:
            self._program = expand_program(self.code, self.entry, self.start)
        return self._program

    def preprocess(self) -> bytes:
        """Shared preprocessing digest (bytecode expansion is cached);
        both prove and verify bind it through the FS preamble."""
        if self._digest is None:
            prog = self.program
            self._digest = preprocessing_digest(
                self.code, self.entry, prog.start, self.layout,
                expected_bytecode_log_K(prog), 0)
        return self._digest

    # ---- trace_X / analyze_X ---------------------------------------------
    def trace(self, inputs: bytes = b"", trusted_advice: bytes = b"",
              untrusted_advice: bytes = b"") -> Trace:
        return trace_program(self.code, inputs=inputs, layout=self.layout,
                             entry=self.entry,
                             max_cycles=self.max_trace_length,
                             trusted_advice=trusted_advice,
                             untrusted_advice=untrusted_advice)

    def analyze(self, inputs: bytes = b"") -> ProgramSummary:
        tr = self.trace(inputs)
        counts = collections.Counter(
            isa.KINDS[k] for k in tr.col("kind")[:tr.length].tolist())
        return ProgramSummary(trace_length=tr.length,
                              padded_length=tr.padded_length,
                              counts=dict(counts))

    def run(self, inputs: bytes = b"") -> GuestOutput:
        tr = self.trace(inputs)
        return GuestOutput(bytes(tr.device.outputs), tr.device.panic,
                           tr.length)

    # ---- build_prover_X / build_verifier_X --------------------------------
    def build_prover(self, pcs=None) -> Callable[[bytes],
                                                 Tuple[GuestOutput, JoltProof]]:
        """Returns prove_X(inputs) -> (output, proof).  `pcs` as in
        prove(): None (sumcheck-only), 'dory', 'hyperkzg', or a setup;
        the proof runs on the guest's device."""
        self.preprocess()

        def prove_fn(inputs: bytes = b"", trusted_advice: bytes = b"",
                     untrusted_advice: bytes = b""):
            tr = self.trace(inputs, trusted_advice, untrusted_advice)
            proof = prove(tr, setup=pcs, device=self.device)
            return GuestOutput(bytes(tr.device.outputs), tr.device.panic,
                               tr.length), proof

        return prove_fn

    def build_verifier(self, pcs=None) -> Callable[..., bool]:
        """Returns verify_X(inputs, outputs, panic, proof) -> bool --
        succinct: no guest execution, the program's public expansion only."""
        self.preprocess()

        def verify_fn(inputs: bytes, outputs: bytes, panic: bool,
                      proof: JoltProof) -> bool:
            io = PublicIO(proof.trace_length, proof.padded_length, inputs,
                          outputs, panic, self.layout, self.code,
                          self.entry, self.start)
            setup = pcs
            if isinstance(pcs, str):
                from .prover.prover import _resolve_setup
                setup = _resolve_setup(pcs, proof.padded_length,
                                       proof.ram_log_K,
                                       proof.bytecode_log_K, self.device)
            try:
                return verify(proof, io, setup=setup)
            except VerificationError:
                return False

        return verify_fn


def provable(source, **attrs) -> Guest:
    """The `#[jolt::provable(...)]` analog: build a Guest with the macro's
    memory attributes (max_input_size, max_output_size, stack_size,
    heap_size, max_trace_length) and the prover's `device`."""
    return Guest(source, **attrs)
