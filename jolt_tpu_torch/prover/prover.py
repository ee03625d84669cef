"""The Jolt prover pipeline on torch, as far as the port reaches.

Torch counterpart of the JAX package's `prover/prover.py`.  `prove_prefix`
is the prefix of its `prove` in the same order, with the same transcript
draws: witness extraction (what these stages need), the Fiat-Shamir
preamble, no commitments (the sumcheck-only configuration, `setup=None`;
no zk, no committed program image), then

  1   Spartan outer (R1CS, uni-skip first round + 1 + log T rounds)
  1s  Spartan shift sumcheck (PC chaining via EqPlusOne)
  2   registers read/write checking       (sparse Twist)
  3   registers Val evaluation            (Twist prefix-sum via LT)
  4   RAM read/write checking + raf       (sparse Twist, batched)
  5   RAM Val evaluation + output check   (batched)

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
from ..relations.ram_sparse import (RamPairSchedule, SparseRamOutputCheck,
                                    SparseRamRafEvaluation,
                                    SparseRamReadWriteChecking,
                                    SparseRamValEvaluation,
                                    SparseRegistersReadWriteChecking,
                                    SparseRegistersValEvaluation)
from ..relations.shift import ShiftSumcheck, shift_column_values
from ..relations.spartan_outer import (SpartanOuterProver, num_stage1_rounds,
                                       prove_uniskip)
from ..sumcheck.engine import BatchedSumcheck, OpeningAccumulator
from ..tracer.trace import Trace
from ..transcript import Blake2bTranscript
from ..witness.bytecode import extract_bytecode_witness
from ..witness.r1cs_inputs import extract_r1cs_inputs
from ..witness.ram import extract_ram_log
from ..witness.registers import extract_register_log


@dataclasses.dataclass
class PrefixProof:
    """The stage 1-5 parts of the wire-format proof, named as in the JAX
    package's `JoltProof`, plus the transcript checkpoints."""

    trace_length: int          # unpadded
    padded_length: int
    stage1_uniskip: List[int]          # uni-skip first-round poly (31 coeffs)
    stage1_polys: List[List[int]]      # compressed round polys
    r1cs_input_openings: List[int]     # 38 openings at r_cycle
    shift_polys: List[List[int]]       # PC-chaining shift sumcheck
    shift_opening: int                 # combined current-row cols at rho
    stage2_polys: List[List[int]]      # registers read/write checking
    stage2_openings: Dict[str, int]    # wa/ra1/ra2/val/inc at bound point
    stage3_polys: List[List[int]]      # registers Val evaluation
    stage3_openings: Dict[str, int]    # wa/inc at new bound point
    stage4_polys: List[List[int]]      # RAM rw-checking + raf (batched)
    stage4_openings: Dict[str, int]    # rw_ra/rw_val/rw_inc + raf_ra
    stage5_polys: List[List[int]]      # RAM Val evaluation + output check
    stage5_openings: Dict[str, int]    # ra/inc + oc_ra/oc_inc
    ram_log_K: int
    bytecode_log_K: int
    # prover-chosen protocol configuration (config.ProofConfig wire dict)
    config: Dict[str, int]
    # Fiat-Shamir tape: {"stage", "n_rounds", "state" (hex)} after each of
    # stage1-spartan, stage1s-shift, stage2-reg-rw, stage3-reg-val and
    # stage4-5-ram
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


def require_no_advice(layout) -> None:
    """The ported prefix has no advice regions (the bench's and fib's
    `MemoryLayout(64, 64)` have none): their Init contribution needs the
    committed advice polynomials and the stage-8 reduction."""
    kinds = [k for k in ("trusted", "untrusted")
             if layout.advice_region(k)[1] > 0]
    if kinds:
        raise NotImplementedError(
            f"{' and '.join(kinds)} advice regions need the advice openings "
            "and the stage-8 joint reduction (ROADMAP A11), not ported yet")


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


def prove_prefix(trace: Trace, device="cuda") -> PrefixProof:
    """Prove stages 1 through 5 of the trace on `device` (the card unless
    the caller asks for the CPU)."""
    device = resolve_device(device)
    require_no_advice(trace.memory_layout)
    timer = _StageTimer(device)
    # ---- witness extraction (host), as far as stages 1-5 need it --------
    inputs = extract_r1cs_inputs(trace)
    reg_wit = extract_register_log(trace)
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
    fs_tape: List[dict] = []

    def finish(label: str) -> None:
        fs_tape.append(_tape_entry(label, transcript))
        timer.mark(label)

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
    del outer          # release each finished stage's device tensors
    finish("stage1-spartan")

    # ---- Stage 1s: Spartan shift (PC chaining) --------------------------
    r_cycle = list(accumulator.get_point(("r1cs_input", "rs1_value")))
    gamma_sh = transcript.challenge_scalar()
    shift_cols = shift_column_values(bc_wit.table, bc_wit.pc_idx, gamma_sh)
    shift_inst = ShiftSumcheck(shift_cols, r_cycle, gamma_sh, device)
    shift_polys, _ = BatchedSumcheck.prove([shift_inst], accumulator,
                                           transcript)
    shift_opening = shift_inst.final_openings["cols"]
    del shift_inst
    finish("stage1s-shift")

    # ---- Stage 2: registers read/write checking ------------------------
    # r_cycle and the rd/rs1/rs2 claims are the stage-1 openings.
    claims = [accumulator.get_claim(("r1cs_input", "rd_write_value")),
              accumulator.get_claim(("r1cs_input", "rs1_value")),
              accumulator.get_claim(("r1cs_input", "rs2_value"))]
    gamma = transcript.challenge_scalar()
    rw = SparseRegistersReadWriteChecking(reg_wit, gamma, r_cycle, claims,
                                          device)
    stage2_polys, _ = BatchedSumcheck.prove([rw], accumulator, transcript)
    stage2_openings = dict(rw.final_openings)
    del rw
    finish("stage2-reg-rw")

    # ---- Stage 3: registers Val evaluation -----------------------------
    val_pt2 = accumulator.get_point(("registers", "val"))
    r2_cyc, r2_addr = list(val_pt2[:log_T]), list(val_pt2[log_T:])
    val_claim = accumulator.get_claim(("registers", "val"))
    ve = SparseRegistersValEvaluation(reg_wit, r2_addr, r2_cyc, val_claim,
                                      device)
    stage3_polys, _ = BatchedSumcheck.prove([ve], accumulator, transcript)
    stage3_openings = dict(ve.final_openings)
    del ve
    finish("stage3-reg-val")

    # ---- Stage 4: RAM read/write checking + raf evaluation (batched) ----
    gamma_ram = transcript.challenge_scalar()
    rv_claim = accumulator.get_claim(("r1cs_input", "ram_read_value"))
    wv_claim = accumulator.get_claim(("r1cs_input", "ram_write_value"))
    addr_claim = accumulator.get_claim(("r1cs_input", "ram_address"))
    ram_sched = RamPairSchedule(ram_wit.cols, ram_wit.pre, ram_wit.post,
                                ram_wit.K, device=device)
    ram_rw = SparseRamReadWriteChecking(
        ram_sched, ram_wit.log_K, ram_wit.init_vals, ram_wit.inc, gamma_ram,
        r_cycle, rv_claim, wv_claim)
    ram_raf = SparseRamRafEvaluation(ram_sched, ram_wit.log_K,
                                     ram_wit.witness_base, r_cycle,
                                     addr_claim)
    stage4_polys, _ = BatchedSumcheck.prove([ram_rw, ram_raf], accumulator,
                                            transcript)
    stage4_openings = {
        **{f"rw_{k}": v for k, v in ram_rw.final_openings.items()},
        **{f"raf_{k}": v for k, v in ram_raf.final_openings.items()}}
    del ram_rw, ram_raf

    # ---- Stage 5: RAM Val evaluation + output check (batched) ------------
    val_pt = accumulator.get_point(("ram", "val"))  # normalized (cyc, addr)
    r4_cyc, r4_addr = list(val_pt[:log_T]), list(val_pt[log_T:])
    ram_val_claim = accumulator.get_claim(("ram", "val"))
    ram_ve = SparseRamValEvaluation(ram_sched, ram_wit.log_K,
                                    ram_wit.init_vals, ram_wit.inc,
                                    r4_addr, r4_cyc, ram_val_claim)
    z_out = transcript.challenge_scalar()
    ram_oc = SparseRamOutputCheck(ram_sched, ram_wit.log_K,
                                  ram_wit.init_vals, ram_wit.inc,
                                  trace.memory_layout, ram_wit.witness_base,
                                  z_out, bytes(trace.device.outputs))
    stage5_polys, _ = BatchedSumcheck.prove([ram_ve, ram_oc], accumulator,
                                            transcript)
    stage5_openings = {
        **dict(ram_ve.final_openings),
        **{f"oc_{k}": v for k, v in ram_oc.final_openings.items()}}
    del ram_ve, ram_oc, ram_sched
    finish("stage4-5-ram")

    return PrefixProof(
        trace_length=trace.length,
        padded_length=trace.padded_length,
        stage1_uniskip=list(s1_coeffs),
        stage1_polys=stage1_polys,
        r1cs_input_openings=input_openings,
        shift_polys=shift_polys,
        shift_opening=shift_opening,
        stage2_polys=stage2_polys,
        stage2_openings=stage2_openings,
        stage3_polys=stage3_polys,
        stage3_openings=stage3_openings,
        stage4_polys=stage4_polys,
        stage4_openings=stage4_openings,
        stage5_polys=stage5_polys,
        stage5_openings=stage5_openings,
        ram_log_K=ram_wit.log_K,
        bytecode_log_K=bc_wit.log_K,
        config=proof_config.as_dict(),
        fs_tape=fs_tape,
    )
