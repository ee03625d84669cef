"""The Jolt verifier, as far as the port's prover reaches.

Torch-package counterpart of the JAX package's `verifier/verifier.py`:
`verify_stage1` validates the proof-carried config, replays the preamble
and checks stage 1 (Spartan uni-skip + outer) and stage 1s (shift) exactly
as the full verifier does in the sumcheck-only configuration.  All of it is
host work on Python ints.
"""

from __future__ import annotations

from ..config import ConfigError, ProofConfig
from ..field.params import FR
from ..prover.prover import Stage1Proof, fiat_shamir_preamble
from ..relations.shift import ShiftVerifier
from ..relations.spartan_outer import (SpartanOuterVerifier,
                                       num_stage1_rounds, verify_uniskip)
from ..riscv.emulator import MemoryLayout
from ..riscv.program import expand_program
from ..sumcheck.engine import BatchedSumcheck, OpeningAccumulator, SumcheckError
from ..tracer.trace import Trace
from ..transcript import Blake2bTranscript
from ..witness.bytecode import bytecode_K
from ..witness.r1cs_inputs import NUM_VARS, VAR_NAMES

P = FR.modulus


class VerificationError(Exception):
    pass


class PublicIO:
    """The public statement: what the verifier actually gets (no trace)."""

    def __init__(self, trace_length: int, padded_length: int,
                 inputs: bytes, outputs: bytes, panic: bool,
                 memory_layout=None, code: bytes = b"", entry: int = 0,
                 start: int = None):
        self.trace_length = trace_length
        self.padded_length = padded_length
        self.inputs = inputs
        self.outputs = outputs
        self.panic = panic
        self.memory_layout = memory_layout or MemoryLayout()
        self.code = code
        self.entry = entry
        self.start = entry if start is None else start

    @classmethod
    def from_trace(cls, trace: Trace) -> "PublicIO":
        return cls(trace.length, trace.padded_length,
                   bytes(trace.device.inputs), bytes(trace.device.outputs),
                   trace.device.panic, trace.memory_layout,
                   trace.code, trace.entry, trace.program.start)


def verify_stage1(proof: Stage1Proof, io: PublicIO) -> bool:
    """Check stages 1 and 1s of `proof` against the public statement;
    returns True or raises VerificationError."""
    program = expand_program(io.code, io.entry, io.start)
    if proof.bytecode_log_K != bytecode_K(program).bit_length() - 1:
        raise VerificationError("bytecode_log_K inconsistent with program")
    log_T = io.padded_length.bit_length() - 1
    try:
        proof_config = ProofConfig.from_dict(proof.config or {})
        proof_config.validate(log_T, proof.ram_log_K)
    except ConfigError as e:
        raise VerificationError(f"invalid proof config: {e}") from e
    transcript = Blake2bTranscript(b"Jolt")
    fiat_shamir_preamble(transcript, io.trace_length, io.padded_length,
                         io.inputs, io.outputs, io.panic, io.code, io.entry,
                         io.start, io.memory_layout, proof.ram_log_K,
                         proof.bytecode_log_K, config=proof_config)
    accumulator = OpeningAccumulator()

    # ---- Stage 1: Spartan outer (uni-skip + remaining sumcheck) ---------
    num_rounds = num_stage1_rounds(log_T)
    tau = transcript.challenge_vector(1 + num_rounds)

    if len(proof.r1cs_input_openings) != NUM_VARS:
        raise VerificationError("wrong number of R1CS input openings")
    if proof.r1cs_input_openings[0] != 1:
        raise VerificationError("const-column opening must be 1")

    try:
        r0_skip, claim1 = verify_uniskip(proof.stage1_uniskip, transcript)
    except SumcheckError as e:
        raise VerificationError(f"stage1 uniskip: {e}") from e

    inst1 = SpartanOuterVerifier(num_rounds, tau, r0_skip,
                                 proof.r1cs_input_openings, claim1)
    try:
        r1 = BatchedSumcheck.verify(proof.stage1_polys, [inst1], accumulator,
                                    transcript)
    except SumcheckError as e:
        raise VerificationError(f"stage1: {e}") from e

    r_cycle = r1[1:]
    for v in range(NUM_VARS):
        accumulator.insert(("r1cs_input", VAR_NAMES[v]), r_cycle,
                           proof.r1cs_input_openings[v])
    accumulator.flush_to_transcript(transcript)

    # ---- Stage 1s: Spartan shift (PC chaining) --------------------------
    gamma_sh = transcript.challenge_scalar()
    inst_sh = ShiftVerifier(log_T, gamma_sh, r_cycle, proof.shift_opening)
    try:
        r_sh = BatchedSumcheck.verify(proof.shift_polys, [inst_sh],
                                      accumulator, transcript)
    except SumcheckError as e:
        raise VerificationError(f"shift: {e}") from e
    accumulator.insert(("shift", "cols"), r_sh, proof.shift_opening)
    accumulator.flush_to_transcript(transcript)
    return True
