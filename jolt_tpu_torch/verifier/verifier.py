"""The Jolt verifier, as far as the port's prover reaches.

Torch-package counterpart of the JAX package's `verifier/verifier.py`:
`verify_prefix` validates the proof-carried config, replays the preamble
and checks stage 1 (Spartan uni-skip + outer), stage 1s (shift), stages 2
and 3 (registers read/write checking and Val evaluation) and stages 4 and 5
(RAM read/write + raf, then Val evaluation + output check) exactly as the
full verifier does in the sumcheck-only configuration.  All of it is host
work on Python ints.
"""

from __future__ import annotations

from ..config import ConfigError, ProofConfig
from ..field.params import FR
from ..prover.prover import (PrefixProof, fiat_shamir_preamble,
                             require_no_advice)
from ..relations.ram_sparse import (SparseRamOutputCheckVerifier,
                                    SparseRamRafEvaluationVerifier,
                                    SparseRamReadWriteCheckingVerifier,
                                    SparseRamValEvaluationVerifier,
                                    SparseRegistersReadWriteCheckingVerifier,
                                    SparseRegistersValEvaluationVerifier)
from ..relations.shift import ShiftVerifier
from ..relations.spartan_outer import (SpartanOuterVerifier,
                                       num_stage1_rounds, verify_uniskip)
from ..riscv.emulator import MemoryLayout
from ..riscv.program import expand_program
from ..sumcheck.engine import BatchedSumcheck, OpeningAccumulator, SumcheckError
from ..tracer.trace import Trace
from ..transcript import Blake2bTranscript
from ..witness.bytecode import bytecode_K
from ..witness.r1cs_inputs import (NUM_VARS, V_RAM_ADDRESS,
                                   V_RAM_READ_VALUE, V_RAM_WRITE_VALUE,
                                   V_RD_WRITE_VALUE, V_RS1_VALUE, V_RS2_VALUE,
                                   VAR_NAMES)
from ..witness.ram import initial_memory_vals

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


def verify_prefix(proof: PrefixProof, io: PublicIO) -> bool:
    """Check stages 1 through 5 of `proof` against the public statement;
    returns True or raises VerificationError."""
    require_no_advice(io.memory_layout)
    program = expand_program(io.code, io.entry, io.start)
    if proof.bytecode_log_K != bytecode_K(program).bit_length() - 1:
        raise VerificationError("bytecode_log_K inconsistent with program")
    log_T = io.padded_length.bit_length() - 1
    try:
        proof_config = ProofConfig.from_dict(proof.config or {})
        proof_config.validate(log_T, proof.ram_log_K)
    except ConfigError as e:
        raise VerificationError(f"invalid proof config: {e}") from e
    if proof_config.committed_program_image:
        raise NotImplementedError(
            "the committed program image needs the program-image claim "
            "reduction (ROADMAP A13), not ported yet")
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

    # ---- Stage 2: registers read/write checking ------------------------
    gamma = transcript.challenge_scalar()
    claims = [proof.r1cs_input_openings[V_RD_WRITE_VALUE],
              proof.r1cs_input_openings[V_RS1_VALUE],
              proof.r1cs_input_openings[V_RS2_VALUE]]
    inst2 = SparseRegistersReadWriteCheckingVerifier(
        log_T, gamma, r_cycle, claims, proof.stage2_openings)
    try:
        r2 = BatchedSumcheck.verify(proof.stage2_polys, [inst2], accumulator,
                                    transcript)
    except SumcheckError as e:
        raise VerificationError(f"stage2: {e}") from e
    r2_cyc, r2_addr = inst2._split(r2)
    r2n = r2_cyc + r2_addr
    for name in ("wa", "ra1", "ra2", "val"):
        accumulator.insert(("registers", name), r2n,
                           proof.stage2_openings[name])
    accumulator.insert(("registers", "inc"), r2_cyc,
                       proof.stage2_openings["inc"])
    accumulator.flush_to_transcript(transcript)

    # ---- Stage 3: registers Val evaluation -----------------------------
    val_claim = proof.stage2_openings["val"]
    inst3 = SparseRegistersValEvaluationVerifier(
        log_T, r2_addr, r2_cyc, val_claim, proof.stage3_openings)
    try:
        r3 = BatchedSumcheck.verify(proof.stage3_polys, [inst3], accumulator,
                                    transcript)
    except SumcheckError as e:
        raise VerificationError(f"stage3: {e}") from e
    r3_cyc, r3_addr = inst3._split(r3)
    accumulator.insert(("registers_val_eval", "wa"), r3_cyc + r3_addr,
                       proof.stage3_openings["wa"])
    accumulator.insert(("registers_val_eval", "inc"), r3_cyc,
                       proof.stage3_openings["inc"])
    accumulator.flush_to_transcript(transcript)

    # ---- Stage 4: RAM read/write checking + raf evaluation (batched) ----
    gamma_ram = transcript.challenge_scalar()
    rv_claim = proof.r1cs_input_openings[V_RAM_READ_VALUE]
    wv_claim = proof.r1cs_input_openings[V_RAM_WRITE_VALUE]
    addr_claim = proof.r1cs_input_openings[V_RAM_ADDRESS]
    o4 = proof.stage4_openings
    inst4a = SparseRamReadWriteCheckingVerifier(
        log_T, proof.ram_log_K, gamma_ram, r_cycle, rv_claim, wv_claim,
        {"ra": o4["rw_ra"], "val": o4["rw_val"], "inc": o4["rw_inc"]})
    inst4b = SparseRamRafEvaluationVerifier(
        log_T, proof.ram_log_K, r_cycle, addr_claim,
        io.memory_layout.witness_base, {"ra": o4["raf_ra"]})
    try:
        r4 = BatchedSumcheck.verify(proof.stage4_polys, [inst4a, inst4b],
                                    accumulator, transcript)
    except SumcheckError as e:
        raise VerificationError(f"stage4: {e}") from e
    # sparse tier: cycle vars bound LSB-first -> normalize to big-endian
    r4_cyc, r4_addr = inst4a._split(r4)
    r4n = r4_cyc + r4_addr
    for name in ("ra", "val"):
        accumulator.insert(("ram", name), r4n, o4[f"rw_{name}"])
    accumulator.insert(("ram", "inc"), r4_cyc, o4["rw_inc"])
    accumulator.insert(("ram_raf", "ra"), r4n, o4["raf_ra"])
    accumulator.flush_to_transcript(transcript)

    # ---- Stage 5: RAM Val evaluation + output check ----------------------
    # public initial image = inputs region + program image, restricted to
    # the proof's RAM address space (same rule as the prover witness)
    init_vals = initial_memory_vals(io.inputs, io.memory_layout, io.code,
                                    io.entry, K=1 << proof.ram_log_K)
    o5 = proof.stage5_openings
    inst5 = SparseRamValEvaluationVerifier(
        log_T, proof.ram_log_K, r4_addr, r4_cyc, o4["rw_val"], init_vals,
        {"ra": o5["ra"], "inc": o5["inc"]})
    z_out = transcript.challenge_scalar()
    inst5b = SparseRamOutputCheckVerifier(
        log_T, proof.ram_log_K, z_out, io.outputs, io.memory_layout,
        io.memory_layout.witness_base, init_vals,
        {"ra": o5["oc_ra"], "inc": o5["oc_inc"]})
    try:
        r5 = BatchedSumcheck.verify(proof.stage5_polys, [inst5, inst5b],
                                    accumulator, transcript)
    except SumcheckError as e:
        raise VerificationError(f"stage5: {e}") from e
    r5_cyc, r5_addr = inst5._split(r5)
    r5n = r5_cyc + r5_addr
    accumulator.insert(("ram_val_eval", "ra"), r5n, o5["ra"])
    accumulator.insert(("ram_val_eval", "inc"), r5_cyc, o5["inc"])
    accumulator.insert(("ram_output", "ra"), r5n, o5["oc_ra"])
    accumulator.insert(("ram_output", "inc"), r5_cyc, o5["oc_inc"])
    accumulator.flush_to_transcript(transcript)
    return True
