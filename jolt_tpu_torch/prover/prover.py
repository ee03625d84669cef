"""The Jolt prover pipeline on torch, as far as the port reaches.

Torch counterpart of the JAX package's `prover/prover.py`.  `prove_stage1`
is the prefix of its `prove` in the same order: witness extraction (what
stage 1 needs), the Fiat-Shamir preamble, no commitments (the
sumcheck-only configuration, `setup=None`), then

  1   Spartan outer (R1CS, uni-skip first round + 1 + log T rounds)
  1s  Spartan shift sumcheck (PC chaining via EqPlusOne)

Later stages extend this function into the port's full `prove`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time
from typing import Dict, List

import torch

from ..config import ProofConfig
from ..relations.shift import ShiftSumcheck, shift_column_values
from ..relations.spartan_outer import (SpartanOuterProver, num_stage1_rounds,
                                       prove_uniskip)
from ..sumcheck.engine import BatchedSumcheck, OpeningAccumulator
from ..tracer.trace import Trace
from ..transcript import Blake2bTranscript
from ..witness.bytecode import extract_bytecode_witness
from ..witness.r1cs_inputs import extract_r1cs_inputs
from ..witness.ram import extract_ram_log


@dataclasses.dataclass
class Stage1Proof:
    """The stage-1 / 1s parts of the wire-format proof, named as in the
    JAX package's `JoltProof`, plus the transcript checkpoints."""

    trace_length: int          # unpadded
    padded_length: int
    stage1_uniskip: List[int]          # uni-skip first-round poly (31 coeffs)
    stage1_polys: List[List[int]]      # compressed round polys
    r1cs_input_openings: List[int]     # 38 openings at r_cycle
    shift_polys: List[List[int]]       # PC-chaining shift sumcheck
    shift_opening: int                 # combined current-row cols at rho
    ram_log_K: int
    bytecode_log_K: int
    # prover-chosen protocol configuration (config.ProofConfig wire dict)
    config: Dict[str, int]
    # Fiat-Shamir tape: {"stage", "n_rounds", "state" (hex)} after
    # stage1-spartan and after stage1s-shift
    fs_tape: List[dict]


def preprocessing_digest(code: bytes, entry: int, start: int, memory_layout,
                         bytecode_log_K: int, padded_length: int) -> bytes:
    """32-byte digest of the preprocessing artifact, the analog of the
    reference's `preprocessing.digest()` absorbed first in the preamble:
    the code bytes, entry/start addresses, the memory-layout geometry, the
    bytecode table size and the padded trace length, all public."""
    h = hashlib.blake2b(digest_size=32)
    for tag, val in (
        (b"code", code),
        (b"entry", entry), (b"start", start),
        (b"max_input", memory_layout.max_input_size),
        (b"max_output", memory_layout.max_output_size),
        (b"stack", memory_layout.stack_size),
        (b"heap", memory_layout.heap_size),
        (b"max_trusted_advice", memory_layout.max_trusted_advice_size),
        (b"max_untrusted_advice", memory_layout.max_untrusted_advice_size),
        (b"bytecode_log_K", bytecode_log_K),
        (b"padded_T", padded_length),
    ):
        h.update(tag)
        h.update(val if isinstance(val, bytes) else int(val).to_bytes(8, "big"))
    return h.digest()


def fiat_shamir_preamble(transcript: Blake2bTranscript, trace_length: int,
                         padded_length: int, inputs: bytes, outputs: bytes,
                         panic: bool, code: bytes, entry: int, start: int,
                         memory_layout, ram_log_K: int,
                         bytecode_log_K: int,
                         config: "ProofConfig" = None) -> None:
    """Preamble binding the full public statement (same labels, types and
    order as the reference's `fiat_shamir_preamble`, `zkvm/mod.rs:257-301`)."""
    transcript.append_bytes(
        b"preprocessing_digest",
        preprocessing_digest(code, entry, start, memory_layout,
                             bytecode_log_K, padded_length))
    transcript.append_u64(b"max_input_size", memory_layout.max_input_size)
    transcript.append_u64(b"max_output_size", memory_layout.max_output_size)
    transcript.append_u64(b"heap_size", memory_layout.heap_size)
    transcript.append_bytes(b"inputs", inputs)
    transcript.append_bytes(b"outputs", outputs)
    transcript.append_u64(b"panic", 1 if panic else 0)
    transcript.append_u64(b"ram_K", 1 << ram_log_K)
    transcript.append_u64(b"trace_length", trace_length)
    transcript.append_u64(b"entry_address", entry)
    log_T = padded_length.bit_length() - 1
    if config is None:
        config = ProofConfig.new(log_T, ram_log_K)
    rw, oh = config.read_write, config.one_hot
    transcript.append_u64(b"ram_rw_phase1_num_rounds",
                          rw.ram_rw_phase1_num_rounds)
    transcript.append_u64(b"ram_rw_phase2_num_rounds",
                          rw.ram_rw_phase2_num_rounds)
    transcript.append_u64(b"registers_rw_phase1_num_rounds",
                          rw.registers_rw_phase1_num_rounds)
    transcript.append_u64(b"registers_rw_phase2_num_rounds",
                          rw.registers_rw_phase2_num_rounds)
    transcript.append_u64(b"log_k_chunk", oh.log_k_chunk)
    transcript.append_u64(b"lookups_ra_virtual_log_k_chunk",
                          oh.lookups_ra_virtual_log_k_chunk)
    transcript.append_u64(b"dory_layout", config.dory_layout)
    transcript.append_u64(b"committed_program_image",
                          config.committed_program_image)


def resolve_device(device) -> torch.device:
    """The device a caller asked for; a CUDA device must exist (no silent
    fall-back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available (pass device='cpu' to run on the CPU)")
    return device


def _tape_entry(label: str, transcript: Blake2bTranscript) -> dict:
    return {"stage": label, "n_rounds": transcript.n_rounds,
            "state": transcript.state.hex()}


class _StageTimer:
    """JOLT_TPU_STAGE_TIMING=1 prints one line per finished stage, as the
    JAX package's prover does: `[prove] <label>: <seconds>s`, plus the
    device's peak allocated memory on CUDA.  Every stage ends in a
    device-to-host copy, so the host clock covers its device work."""

    def __init__(self, device: torch.device):
        self.on = bool(os.environ.get("JOLT_TPU_STAGE_TIMING"))
        self.device = device
        self.t0 = time.perf_counter()

    def mark(self, label: str) -> None:
        now = time.perf_counter()
        if self.on:
            mem = ""
            if self.device.type == "cuda":
                peak = torch.cuda.max_memory_allocated(self.device)
                mem = f" peak_mem={peak / 2**30:.3f}G"
            print(f"[prove] {label}: {now - self.t0:.4f}s{mem}", flush=True)
        self.t0 = now


def prove_stage1(trace: Trace, device="cuda") -> Stage1Proof:
    """Prove stages 1 and 1s of the trace on `device` (the card unless the
    caller asks for the CPU)."""
    device = resolve_device(device)
    timer = _StageTimer(device)
    # ---- witness extraction (host), as far as stage 1 needs it ----------
    inputs = extract_r1cs_inputs(trace)
    ram_wit = extract_ram_log(trace)
    bc_wit = extract_bytecode_witness(trace)
    log_T = trace.log_T
    timer.mark("witness-extraction")

    transcript = Blake2bTranscript(b"Jolt")
    proof_config = ProofConfig.new(log_T, ram_wit.log_K)
    fiat_shamir_preamble(
        transcript, trace.length, trace.padded_length,
        bytes(trace.device.inputs), bytes(trace.device.outputs),
        trace.device.panic, trace.code, trace.entry, trace.program.start,
        trace.memory_layout, ram_wit.log_K, bc_wit.log_K,
        config=proof_config)
    accumulator = OpeningAccumulator()
    # ---- Stage 0: no commitments in the sumcheck-only configuration -----

    # ---- Stage 1: Spartan outer (uni-skip + remaining sumcheck) ---------
    # tau = [tau_high (Lagrange kernel), tau_g (group bit), *tau_cyc]
    tau = transcript.challenge_vector(1 + num_stage1_rounds(log_T))
    cols_dev, s1_coeffs, r0_skip, claim1, l_scale = prove_uniskip(
        inputs, tau, transcript, device)
    outer = SpartanOuterProver(inputs, tau[1:], r0_skip, claim1, l_scale,
                               cols_dev)
    del cols_dev
    stage1_polys, _ = BatchedSumcheck.prove([outer], accumulator, transcript)
    input_openings = list(outer.input_openings)
    del outer          # release the stage's device tensors
    fs_tape = [_tape_entry("stage1-spartan", transcript)]
    timer.mark("stage1-spartan")

    # ---- Stage 1s: Spartan shift (PC chaining) --------------------------
    r_cycle = list(accumulator.get_point(("r1cs_input", "rs1_value")))
    gamma_sh = transcript.challenge_scalar()
    shift_cols = shift_column_values(bc_wit.table, bc_wit.pc_idx, gamma_sh)
    shift_inst = ShiftSumcheck(shift_cols, r_cycle, gamma_sh, device)
    shift_polys, _ = BatchedSumcheck.prove([shift_inst], accumulator,
                                           transcript)
    fs_tape.append(_tape_entry("stage1s-shift", transcript))
    timer.mark("stage1s-shift")

    return Stage1Proof(
        trace_length=trace.length,
        padded_length=trace.padded_length,
        stage1_uniskip=list(s1_coeffs),
        stage1_polys=stage1_polys,
        r1cs_input_openings=input_openings,
        shift_polys=shift_polys,
        shift_opening=shift_inst.final_openings["cols"],
        ram_log_K=ram_wit.log_K,
        bytecode_log_K=bc_wit.log_K,
        config=proof_config.as_dict(),
        fs_tape=fs_tape,
    )
