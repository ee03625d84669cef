"""The Jolt prover pipeline on torch.

Torch counterpart of the JAX package's `prover/prover.py`.  `prove` is its
`prove` in the same order, with the same transcript draws: witness
extraction, the Fiat-Shamir preamble, then

  0   Dory commitments of the witness polynomials (with a setup; their
      G1 work on `device`)
  1   Spartan outer (R1CS, uni-skip first round + 1 + log T rounds)
  1s  Spartan shift sumcheck (PC chaining via EqPlusOne)
  2   registers read/write checking       (sparse Twist)
  3   registers Val evaluation            (Twist prefix-sum via LT)
  4   RAM read/write checking + raf       (sparse Twist, batched)
  5   RAM Val evaluation + output check   (batched; + advice openings
      and the committed image's claim)
  5i  instruction-execution read-raf Shout over 2^128
  6   bytecode read-raf + register rafs + lookup-flag columns (batched)
  6v  RAM/bytecode ra virtualization to committed 8-bit chunk selectors
  7   one-hot booleanity + Hamming weight (grouped by K; + the
      program-image claim reduction)
  8   joint opening-reduction sumcheck (grouped by (K, point)), then
      with a setup one Dory opening of the claims' random linear
      combination (phase B on `device`)

At `setup=None` (the sumcheck-only configuration) stage 0 and the joint
opening are left out and the proof carries the bare opening claims.
With `zk=True` every batched stage's rounds go through the BlindFold
committed-round sink (`blindfold/zk_sumcheck.py`) and one BlindFold proof
follows the joint opening; `committed_image=True` commits the program
image and proves its Init contribution (`relations/program_image.py`).
`prove_prefix` stops after stage 6v; `prove` runs the same prefix and
continues.

Every relation of a batched stage is made through the backend seam
(`kernels/registry.py`, `get_backend().make(slot, ...)`) at the JAX
package's slot sites; the few it builds directly, as the JAX package
does (stages 6, 6v and 8), take their slot's tier through
`apply_tier`.  Each stage runs through `sumcheck/fused.py:prove_fused`,
which picks its tier by one rule (`device_tier`): on the card stages 1,
1s, 2-6, 6v, 7 and 8 take the device tier (the transcript's round tail on
K4, one fetch a stage), stage 5i the host engine (its address rounds are
host work, as in the JAX package), and the zk mode's stages the host
engine's committed rounds.  Forcing a slot's tier or swapping its
implementation leaves the proof's bytes unchanged.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import random
import time
from typing import Callable, ClassVar, Dict, List, Optional

import numpy as np
import torch

from ..blindfold.hyrax import mle_eval_host
from ..blindfold.pedersen import PedersenBasis, point_bytes
from ..blindfold.prove import blindfold_prove
from ..blindfold.zk_sumcheck import zk_prove_stage
from ..config import LOG_K_CHUNK, ProofConfig
from ..field import kernels, ops
from ..field.params import FR
from ..kernels import get_backend
from ..lookups import tables as LT
from ..pcs.scheme import make_scheme
from ..poly import eq
from ..relations.bytecode import CLAIM_COLUMNS
from ..relations.grouped_onehot import GroupedOneHot
from ..relations.opening_reduction import (cycle_major_to_address_major_point,
                                           embedding_factor)
from ..relations.program_image import image_words, shifted_eq_table
from ..relations.ra_virtual import RaVirtual, block_widths, chunk_streams
from ..relations.ram_sparse import (RamPairSchedule, SparseOneHotTableEval,
                                    combined_table_dev, index_table)
from ..relations.shift import SHIFT_COLUMNS, shift_column_values
from ..relations.spartan_outer import num_stage1_rounds, prove_uniskip
from ..sumcheck.engine import OpeningAccumulator
from ..sumcheck.fused import prove_fused
from ..tracer.trace import Trace
from ..transcript import Blake2bTranscript
from ..utils import profiling
from ..witness.bytecode import extract_bytecode_witness
from ..witness.instruction_lookups import (
    D as LK_D, extract_instruction_lookup_witness)
from ..witness.r1cs_inputs import extract_r1cs_inputs
from ..witness.ram import (advice_poly_coeffs, advice_subcube,
                           extract_ram_log, remap_address)
from ..witness.registers import extract_register_log

P = FR.modulus

LOOKUP_FLAG_COLUMNS = ([(f"flag_{n}", f"lk_{n}") for n in LT.TABLE_NAMES]
                       + [("raf", "lk_raf")])

# full-ra virtual claims consumed by the ra-virtualization stage, in order
RAM_RA_SOURCES = [("ram", "ra"), ("ram_raf", "ra"),
                  ("ram_val_eval", "ra"), ("ram_output", "ra")]
BC_RA_SOURCES = [("bytecode", "ra"), ("bytecode_flags", "ra"),
                 ("bytecode_shift", "ra")]


@dataclasses.dataclass
class PrefixProof:
    """The stage 1-6v parts of the wire-format proof, named as in
    `JoltProof`, plus the transcript checkpoints."""

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
    stage5i_polys: List[List[int]]     # instruction read-raf Shout
    stage5i_openings: Dict[str, int]   # ra0..ra15, flag_<table>, raf_flag
    stage6_polys: List[List[int]]      # bytecode read-raf + register rafs
    stage6_openings: Dict[str, int]    # bytecode ra + register one-hot opens
    stage6_claims: List[int]           # virtual rd/rs1/rs2 index claims
    bytecode_log_K: int
    stage6v_polys: List[List[int]]     # ram/bytecode ra virtualization
    stage6v_openings: Dict[str, int]   # per-(source, chunk) openings
    advice_openings: Dict[str, int]    # trusted/untrusted Init openings
    # prover-chosen protocol configuration (config.ProofConfig wire dict)
    config: Dict[str, int]
    # Fiat-Shamir tape: {"stage", "n_rounds", "state" (hex)} after each of
    # stage1-spartan, stage1s-shift, stage2-reg-rw, stage3-reg-val,
    # stage4-5-ram, stage5i-instr-lookups, stage6-bytecode and
    # stage6v-ra-virtual
    fs_tape: List[dict]


@dataclasses.dataclass
class JoltProof:
    """Wire-format proof parts (`JoltProofParts`, zkvm/prover.rs:561-583):
    the JAX package's `JoltProof`, field for field and in its order, which
    `proof_io.serialize_proof` encodes."""

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
    stage4_openings: Dict[str, int]    # ra/val/inc (rw) + ra (raf)
    stage5_polys: List[List[int]]      # RAM Val evaluation + output check
    stage5_openings: Dict[str, int]
    ram_log_K: int
    stage5i_polys: List[List[int]]     # instruction read-raf Shout
    stage5i_openings: Dict[str, int]   # ra0..ra15, flag_<table>, raf_flag
    stage6_polys: List[List[int]]      # bytecode read-raf + register rafs
    stage6_openings: Dict[str, int]    # bytecode ra + register one-hot opens
    stage6_claims: List[int]           # virtual rd/rs1/rs2 index claims
    bytecode_log_K: int
    stage6v_polys: List[List[int]]     # ram/bytecode ra virtualization
    stage6v_openings: Dict[str, int]   # per-(source, chunk) openings
    stage7_polys: List[List[int]]      # booleanity + hamming (all one-hots)
    stage7_openings: Dict[str, int]    # per-matrix bound openings
    stage8_polys: List[List[int]]      # joint opening-reduction sumcheck
    stage8_openings: List[int]         # per-entry P_i(r*) terminal values
    commitments: Dict[str, object]     # committed polys (G1 points)
    opening_proofs: Dict[str, object]  # "joint" -> DoryProof|HyperKZGProof
    advice_openings: Dict[str, int] = None   # trusted/untrusted Init openings
    # zk mode (BlindFold): per-stage Pedersen round commitments replace the
    # stageN_polys coefficient lists, plus one BlindFoldProof
    zk_commitments: Dict[str, List[bytes]] = None
    zk_blindfold: object = None
    # prover-chosen protocol configuration, re-validated by the verifier
    # (config.ProofConfig wire dict; ref zkvm/config.rs:95-210)
    config: Dict[str, int] = None
    # committed-bytecode mode: the program image's contribution to
    # Val_init(r4_addr) (claim_reductions/program_image.rs)
    program_image_claim: int = None
    # the prover's transcript checkpoints (`PrefixProof.fs_tape` plus
    # stage7-booleanity, stage8-reduction, with a setup stage8-openings
    # and with zk blindfold); not a dataclass field, so not in the wire
    # format
    # (a decoded proof has None)
    fs_tape: ClassVar[Optional[List[dict]]] = None


def committed_poly_names(d_ram: int = 1, d_bc: int = 1,
                         advice_kinds=(), committed_image: bool = False):
    """Canonical commitment absorb order, shared by prover and verifier
    (one-hot access matrices then dense increment columns).  RAM and
    bytecode access matrices are committed as d 8-bit chunk selectors
    (reference RamRa(i)/BytecodeRa(i), `zkvm/witness.rs:24-74`) so no
    committed one-hot exceeds 256 rows.  `advice_kinds` (derived from the
    public MemoryLayout advice sizes) appends the trusted/untrusted advice
    polynomials (`zkvm/prover.rs:806-860`)."""
    return (["wa", "ra1", "ra2"]
            + [f"ram_ra{i}" for i in range(d_ram)]
            + [f"bc_ra{i}" for i in range(d_bc)]
            + [f"lk_ra{i}" for i in range(LK_D)]
            + ["inc", "ram_inc"]
            + [f"{k}_advice" for k in advice_kinds]
            + (["program_image"] if committed_image else []))


def advice_kinds_of(layout) -> tuple:
    """('trusted'?, 'untrusted'?) in canonical order, from the PUBLIC
    memory layout (both sides derive the same commitment/entry lists)."""
    return tuple(k for k in ("trusted", "untrusted")
                 if layout.advice_region(k)[1] > 0)


def stage8_entry_ids(d_ram: int = 1, d_bc: int = 1, advice_kinds=(),
                     committed_image: bool = False):
    """Ordered (accumulator_id, commitment_name) pairs covering EVERY
    committed-polynomial opening produced by stages 1-7.  Shared by prover
    and verifier so the joint reduction is built identically on both sides;
    entries deduplicate on (commitment, point) with claim-equality checks."""
    ids = [
        (("registers", "wa"), "wa"), (("registers", "ra1"), "ra1"),
        (("registers", "ra2"), "ra2"), (("registers", "inc"), "inc"),
        (("registers_val_eval", "wa"), "wa"),
        (("registers_val_eval", "inc"), "inc"),
        (("ram", "inc"), "ram_inc"),
        (("ram_val_eval", "inc"), "ram_inc"),
        (("ram_output", "inc"), "ram_inc"),
        (("registers_raf", "wa"), "wa"), (("registers_raf", "ra1"), "ra1"),
        (("registers_raf", "ra2"), "ra2"),
    ]
    # ra-virtualization outputs: chunk openings per full-ra source claim
    for t in range(len(RAM_RA_SOURCES)):
        for i in range(d_ram):
            ids.append(((f"ram_ra_virt", (t, i)), f"ram_ra{i}"))
    for t in range(len(BC_RA_SOURCES)):
        for i in range(d_bc):
            ids.append(((f"bc_ra_virt", (t, i)), f"bc_ra{i}"))
    for i in range(LK_D):
        ids.append((("instr_ra", i), f"lk_ra{i}"))
    onehot_labels = (["reg_wa", "reg_ra1", "reg_ra2"]
                     + [f"ram_ra{i}" for i in range(d_ram)]
                     + [f"bc_ra{i}" for i in range(d_bc)]
                     + [f"lk_ra{i}" for i in range(LK_D)])
    cnames = (["wa", "ra1", "ra2"]
              + [f"ram_ra{i}" for i in range(d_ram)]
              + [f"bc_ra{i}" for i in range(d_bc)]
              + [f"lk_ra{i}" for i in range(LK_D)])
    for label, cname in zip(onehot_labels, cnames):
        ids.append(((("booleanity"), label), cname))
        ids.append(((("hamming"), label), cname))
    for kind in advice_kinds:
        ids.append((("advice", kind), f"{kind}_advice"))
    if committed_image:
        ids.append((("program_image", "init"), "program_image"))
    return ids


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


def required_num_vars(padded_length: int, ram_log_K: int,
                      bytecode_log_K: int) -> int:
    """log2 of the largest committed-polynomial length: the PCS setup size
    shared by prover and verifier (derivable from public proof fields).

    With ra chunking (relations/ra_virtual.py) no committed one-hot exceeds
    2^LOG_K_CHUNK = 256 rows, so the bound is 256 * T regardless of the
    RAM / bytecode address-space sizes."""
    del ram_log_K, bytecode_log_K
    return LOG_K_CHUNK + (padded_length - 1).bit_length()


def _resolve_setup(setup, padded_length, ram_log_K, bytecode_log_K,
                   device="cuda"):
    """Accept 'dory' / 'hyperkzg' strings and size the setup from the trace
    (the KZG powers built on `device`); raw setup objects pass through."""
    if setup == "dory":
        from ..pcs.dory import DorySetup
        return DorySetup.generate(
            required_num_vars(padded_length, ram_log_K, bytecode_log_K))
    if setup == "hyperkzg":
        from ..pcs.hyperkzg import KZGSetup
        nv = required_num_vars(padded_length, ram_log_K, bytecode_log_K)
        return KZGSetup.generate(1 << nv, device=device)
    return setup


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


# callables run with the label at the end of each stage of `prove` (after
# the stage's fetch): how a caller reads a counter stage by stage, such as
# the collectives of `torch.distributed.tensor.debug.CommDebugMode` under
# a cycle mesh (`chip_smoke.py`)
stage_hooks: List[Callable[[str], None]] = []


class _StageTimer:
    """JOLT_TPU_STAGE_TIMING=1 prints one line per finished stage, as the
    JAX package's prover does: `[prove] <label>: <seconds>s`, plus the
    device's peak allocated memory on CUDA and the stage's kernel launches
    (`k1=<form>:<n>,..` for each K1 form, `k2=<n>` K2 calls,
    `k3=<form>:<n>,..` for each K3 form, `k4=<n>` K4 launches).  Each
    stage's
    end is also a zero-length `torch.profiler` range "[prove] <label>", so
    a profile can split device time by stage (`profile_prefix.py`).  Every
    stage ends in a device-to-host copy, so the host clock covers its
    device work."""

    def __init__(self, device: torch.device):
        self.on = bool(os.environ.get("JOLT_TPU_STAGE_TIMING"))
        self.device = device
        self.launches = self._launches()
        self.t0 = time.perf_counter()

    @staticmethod
    def _launches() -> Dict[str, int]:
        return {**kernels.k1_launches(), "k2": kernels.product_round.launches,
                **{f"k3_{f}": n for f, n in kernels.k3_launches().items()},
                "k4": kernels.k4_launches()}

    def mark(self, label: str) -> None:
        for hook in stage_hooks:
            hook(label)
        now = time.perf_counter()
        if self.on:
            with torch.profiler.record_function(f"[prove] {label}"):
                pass
            mem = ""
            if self.device.type == "cuda":
                peak = torch.cuda.max_memory_allocated(self.device)
                mem = f" peak_mem={peak / 2**30:.3f}G"
            n = self._launches()
            d = {k: n[k] - self.launches[k] for k in n}
            self.launches = n
            k1 = ",".join(f"{f}:{d[f]}" for f in kernels.FORMS)
            k3 = ",".join(f"{f}:{d['k3_' + f]}" for f in kernels.K3_FORMS)
            print(f"[prove] {label}: {now - self.t0:.4f}s{mem} k1={k1} "
                  f"k2={d['k2']} k3={k3} k4={d['k4']}", flush=True)
        self.t0 = now


def prove_prefix(trace: Trace, device="cuda",
                 _stream_stage1=None) -> PrefixProof:
    """Prove stages 1 through 6v of the trace on `device` (the card unless
    the caller asks for the CPU); `_stream_stage1` as `prove`'s."""
    return _prove(trace, resolve_device(device), full=False,
                  _stream_stage1=_stream_stage1)


def prove(trace: Trace, setup=None, device="cuda", zk: bool = False,
          zk_rng=None, committed_image: bool = False,
          _stream_stage1=None) -> JoltProof:
    """Prove the trace on `device` (the card unless the caller asks for the
    CPU), as the JAX package's `prove(trace, setup=setup, zk=zk,
    zk_rng=zk_rng, committed_image=committed_image)`: stages 1 through 8,
    and with a setup (a `DorySetup` or `KZGSetup`, a scheme instance, or
    "dory" / "hyperkzg" to build one sized from the trace) the stage-0
    commitments and the joint opening proof.  `setup=None` is the
    sumcheck-only configuration: the proof carries the bare opening
    claims, no commitments and no joint opening proof.  Dory's G1 work
    (one-hot tier 1, the dense commits, the opening's phase B) runs on
    `device` (K3 on the card, the native library on the CPU) and the rest
    of Dory on the host (`pcs/dory.py`, the native library of
    `csrc/pairing.cpp`); HyperKZG's MSMs run on `device` (K3 on the card)
    and its opening's algebra on the host (`pcs/hyperkzg.py`).

    zk=True Pedersen-commits every batched stage's round polynomials
    instead of sending them, and one BlindFold proof (Nova fold + Spartan
    over the verifier R1CS, host work) attests every round check; the
    stage-1 uni-skip polynomial and the opening claims stay in the clear,
    as in the JAX package.  `zk_rng` (default SystemRandom) supplies the
    blinds; the same seed gives the JAX package's bytes.  The device work
    is the plain prove's.  committed_image=True commits the program-image
    words and proves the image's Init contribution through a stage-7
    claim reduction instead of the verifier evaluating it; the image must
    lie in the trace's RAM address space (ROADMAP C2), and zk with the
    committed image is refused (ROADMAP C1).

    Stage 1 streams its columns from `spartan_outer.STREAM_THRESHOLD`
    cycles on; the private `_stream_stage1` forces the tier (True, or a
    power-of-two chunk length, to stream; False not to), as the JAX
    package's `JOLT_TPU_STREAM_STAGE1=1` does; the bytes are the same."""
    if zk and committed_image:
        raise NotImplementedError(
            "zk=True with committed_image=True is refused: the JAX "
            "package's own verifier rejects such a proof (ROADMAP C1)")
    return _prove(trace, resolve_device(device), full=True, setup=setup,
                  zk=zk, zk_rng=zk_rng, committed_image=committed_image,
                  _stream_stage1=_stream_stage1)


def _prove(trace: Trace, device: torch.device, full: bool, setup=None,
           zk: bool = False, zk_rng=None, committed_image: bool = False,
           _stream_stage1=None):
    """The prover's stages in `prove`'s order: through stage 6v (a
    `PrefixProof`), or with `full` through stage 8 (a `JoltProof`), with
    the Dory commitments and joint opening when `setup` is given, the
    committed rounds and the BlindFold proof with `zk`, and the program
    image with `committed_image`."""
    timer = _StageTimer(device)
    # ---- witness extraction (host) --------------------------------------
    inputs = extract_r1cs_inputs(trace)
    reg_wit = extract_register_log(trace)
    ram_wit = extract_ram_log(trace)
    bc_wit = extract_bytecode_witness(trace)
    lk_wit = extract_instruction_lookup_witness(trace, inputs)
    log_T = trace.log_T
    T_pad = trace.padded_length
    # RAM/bytecode matrices commit as d 8-bit chunk selectors (ra_virtual);
    # stages 6v, 7 and 8 read the chunk streams
    ram_chunks = chunk_streams(ram_wit.cols, ram_wit.log_K)
    bc_chunks = chunk_streams(np.asarray(bc_wit.pc_idx), bc_wit.log_K)
    # advice polynomials (zkvm/prover.rs:806-860): dense dword vectors over
    # the full advice regions, opened in stage 5 and reduced in stage 8
    layout = trace.memory_layout
    advice_kinds = advice_kinds_of(layout)
    advice_coeffs = {
        kind: advice_poly_coeffs(layout, kind, bytes(
            getattr(trace.device, f"{kind}_advice", b"")))
        for kind in advice_kinds}
    # every access matrix's index stream and width K (RAM/bytecode as their
    # committed chunk selectors), and the dense committed columns: stage 0
    # commits them, stages 7 and 8 prove over them
    onehot_meta = {"wa": (reg_wit.rd_eff, 128), "ra1": (reg_wit.rs1_eff, 128),
                   "ra2": (reg_wit.rs2_eff, 128)}
    for i, w in enumerate(block_widths(ram_wit.log_K)):
        onehot_meta[f"ram_ra{i}"] = (ram_chunks[i], 1 << w)
    for i, w in enumerate(block_widths(bc_wit.log_K)):
        onehot_meta[f"bc_ra{i}"] = (bc_chunks[i], 1 << w)
    for i in range(LK_D):
        onehot_meta[f"lk_ra{i}"] = (lk_wit.chunks[i], 256)
    dense_meta = {"inc": reg_wit.inc, "ram_inc": ram_wit.inc,
                  **{f"{k}_advice": advice_coeffs[k] for k in advice_kinds}}
    # committed-bytecode mode: commit the program-image words polynomial
    # (claim_reductions/program_image.rs; the verifier recomputes and
    # caches the trusted commitment from the public program)
    pi_words = pi_start = None
    if committed_image:
        pi_words = image_words(trace.code)
        pi_start = remap_address(trace.entry, ram_wit.witness_base)
        if pi_start >> ram_wit.log_K:
            # eval_shifted_eq reads only the low log K bits of the start,
            # while the table is 0 past 2^log K: the JAX package's verifier
            # rejects such a proof at stage 7
            raise NotImplementedError(
                f"committed_image=True with the image at RAM index "
                f"{pi_start}, outside the trace's 2^{ram_wit.log_K} RAM "
                "addresses, is refused: the JAX package's own verifier "
                "rejects such a proof (ROADMAP C2)")
        dense_meta["program_image"] = pi_words
        # split-verification semantics: the verifier evaluates an
        # inputs-only Init and ADDS the image claim, while the witness
        # OVERWRITES on overlap -- so the image range must be disjoint
        # from the input and advice witness regions or honest proofs fail
        pi_end = pi_start + len(pi_words)
        regions = [("inputs", remap_address(layout.input_start,
                                            ram_wit.witness_base),
                    (layout.max_input_size + 7) // 8)]
        for kind in advice_kinds:
            a_start, a_size = layout.advice_region(kind)
            regions.append((f"{kind} advice",
                            remap_address(a_start, ram_wit.witness_base),
                            (a_size + 7) // 8))
        for rname, r0, nwords in regions:
            assert pi_end <= r0 or r0 + nwords <= pi_start, \
                f"committed image overlaps the {rname} region"
    timer.mark("witness-extraction")

    transcript = Blake2bTranscript(b"Jolt")
    proof_config = ProofConfig.new(log_T, ram_wit.log_K,
                                   committed_image=committed_image)
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

    # the zk seam: every batched stage runs through `_stage`, which in zk
    # mode gives the engine the committed-round sink and records the
    # stage's ZkStageData for BlindFold
    zk_stages: List[object] = []
    zk_commit_bytes: Dict[str, List[bytes]] = {}
    if zk:
        zk_basis = PedersenBasis.create(8)
        zk_rng = zk_rng or random.SystemRandom()

    # every relation of a batched stage is built through the backend seam
    # (`kernels/registry.py`) at the JAX package's slot sites; `_stage`
    # runs a stage on the device tier or the host engine
    # (`sumcheck/fused.py:device_tier`), the zk mode's stages on the host
    # engine's committed rounds
    _bk = get_backend()

    def _stage(insts, label):
        if not zk:
            return prove_fused(insts, accumulator, transcript)
        data, rs = zk_prove_stage(insts, accumulator, transcript, zk_basis,
                                  zk_rng, label)
        data.final_expected = data.claims[-1]
        zk_stages.append(data)
        zk_commit_bytes[label] = [point_bytes(c) for c in data.commitments]
        return [], rs

    # ---- Stage 0: commit the witness polynomials -------------------------
    # (zkvm/prover.rs:689-800 generate_and_commit_witness_polynomials --
    # commitments absorb BEFORE any challenge so they bind the witness.)
    commitments: Dict[str, object] = {}
    pcs = make_scheme(_resolve_setup(setup, T_pad, ram_wit.log_K,
                                     bc_wit.log_K, device), device)
    # sparse committed-poly descriptors: (positions int64, values|None=ones,
    # padded length) -- no dense K*T vector is ever materialized
    committed_sparse: Dict[str, tuple] = {}
    if pcs is not None:
        # pay-per-bit commits (msm/mod.rs:16-80): one-hot access matrices
        # are binary, committed ADDRESS-MAJOR (position = k*T + j) so the
        # joint reduction's address phase stays sparse; tier 1 runs as
        # point segment sums over every matrix at once (commit_sparse_many:
        # K3's bucket sums on the card, native on the CPU).  Increments are
        # SIGNED (negative deltas wrap mod p), so they take the full-width
        # path (cheap: length T).
        arange_T = np.arange(T_pad, dtype=np.int64)
        for name, (indices, Km) in onehot_meta.items():
            idx = np.asarray(indices, np.int64)
            committed_sparse[name] = (idx * T_pad + arange_T, None,
                                      Km * T_pad)
        for name, coeffs in dense_meta.items():
            vals = [int(v) % P for v in coeffs]
            committed_sparse[name] = (
                np.arange(len(vals), dtype=np.int64), vals, len(vals))
        names = committed_poly_names(len(ram_chunks), len(bc_chunks),
                                     advice_kinds, committed_image)
        onehot_names = [n for n in names if committed_sparse[n][1] is None]
        prof = profiling.active()
        with prof.span("commit.onehot"):
            if hasattr(pcs, "commit_sparse_many"):
                commitments.update(pcs.commit_sparse_many(
                    [(n, committed_sparse[n][0]) for n in onehot_names]))
            else:
                for n in onehot_names:
                    commitments[n] = pcs.commit_sparse(
                        n, committed_sparse[n][0], committed_sparse[n][2])
        with prof.span("commit.dense"):
            for name in names:
                if name not in commitments:
                    commitments[name] = pcs.commit(
                        name, committed_sparse[name][1], bits=254)
        for name in names:
            pcs.absorb(transcript, commitments[name])
        finish("stage0-commit")

    # ---- Stage 1: Spartan outer (uni-skip + remaining sumcheck) ---------
    # tau = [tau_high (Lagrange kernel), tau_g (group bit), *tau_cyc]
    tau = transcript.challenge_vector(1 + num_stage1_rounds(log_T))
    cols_dev, s1_coeffs, r0_skip, claim1, l_scale = prove_uniskip(
        inputs, tau, transcript, device, _stream_stage1)
    outer = _bk.make("spartan_outer", inputs, tau[1:], r0_skip, claim1,
                     l_scale, cols_dev)
    del cols_dev
    stage1_polys, _ = _stage([outer], "s1")
    input_openings = list(outer.input_openings)
    del outer          # release each finished stage's device tensors
    finish("stage1-spartan")

    # ---- Stage 1s: Spartan shift (PC chaining) --------------------------
    r_cycle = list(accumulator.get_point(("r1cs_input", "rs1_value")))
    gamma_sh = transcript.challenge_scalar()
    shift_cols = shift_column_values(bc_wit.table, bc_wit.pc_idx, gamma_sh)
    shift_inst = _bk.make("spartan_shift", shift_cols, r_cycle, gamma_sh,
                          device)
    shift_polys, _ = _stage([shift_inst], "s1s")
    shift_opening = shift_inst.final_openings["cols"]
    del shift_inst
    finish("stage1s-shift")

    # ---- Stage 2: registers read/write checking ------------------------
    # r_cycle and the rd/rs1/rs2 claims are the stage-1 openings.
    claims = [accumulator.get_claim(("r1cs_input", "rd_write_value")),
              accumulator.get_claim(("r1cs_input", "rs1_value")),
              accumulator.get_claim(("r1cs_input", "rs2_value"))]
    gamma = transcript.challenge_scalar()
    rw = _bk.make("registers_read_write", reg_wit, gamma, r_cycle, claims,
                  device)
    stage2_polys, _ = _stage([rw], "s2")
    stage2_openings = dict(rw.final_openings)
    del rw
    finish("stage2-reg-rw")

    # ---- Stage 3: registers Val evaluation -----------------------------
    val_pt2 = accumulator.get_point(("registers", "val"))
    r2_cyc, r2_addr = list(val_pt2[:log_T]), list(val_pt2[log_T:])
    val_claim = accumulator.get_claim(("registers", "val"))
    ve = _bk.make("registers_val_evaluation", reg_wit, r2_addr, r2_cyc,
                  val_claim, device)
    stage3_polys, _ = _stage([ve], "s3")
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
    ram_rw = _bk.make(
        "ram_read_write", ram_sched, ram_wit.log_K, ram_wit.init_vals,
        ram_wit.inc, gamma_ram, r_cycle, rv_claim, wv_claim)
    ram_raf = _bk.make("ram_raf_evaluation", ram_sched, ram_wit.log_K,
                       ram_wit.witness_base, r_cycle, addr_claim)
    stage4_polys, _ = _stage([ram_rw, ram_raf], "s4")
    stage4_openings = {
        **{f"rw_{k}": v for k, v in ram_rw.final_openings.items()},
        **{f"raf_{k}": v for k, v in ram_raf.final_openings.items()}}
    del ram_rw, ram_raf

    # ---- Stage 5: RAM Val evaluation + output check (batched) ------------
    val_pt = accumulator.get_point(("ram", "val"))  # normalized (cyc, addr)
    r4_cyc, r4_addr = list(val_pt[:log_T]), list(val_pt[log_T:])
    ram_val_claim = accumulator.get_claim(("ram", "val"))
    # advice openings: each advice region is a size-aligned subcube of the
    # address space, so its contribution to Init(r4_addr) factors as
    # selector(high vars) * AdviceMLE(low vars); the MLE opening joins the
    # stage-8 joint reduction (ref compute_advice_init_contributions)
    advice_openings: Dict[str, int] = {}
    for kind in advice_kinds:
        a_vars, _ = advice_subcube(layout, kind, ram_wit.log_K)
        r_low = r4_addr[len(r4_addr) - a_vars:]
        advice_openings[kind] = mle_eval_host(advice_coeffs[kind], r_low)
        accumulator.insert(("advice", kind), tuple(r_low),
                           advice_openings[kind])
    # committed-bytecode mode: the program image's Init(r4_addr)
    # contribution as a scalar claim (exact, on Python ints), bound to the
    # committed image polynomial by the stage-7 reduction sumcheck
    image_claim = None
    if committed_image:
        pi_table = shifted_eq_table(r4_addr, pi_start,
                                    (len(pi_words) - 1).bit_length()
                                    if len(pi_words) > 1 else 0)
        image_claim = sum(t * w for t, w in zip(pi_table, pi_words)) % P
        accumulator.insert(("program_image", "claim"), tuple(r4_addr),
                           image_claim)
    ram_ve = _bk.make("ram_val_check", ram_sched, ram_wit.log_K,
                      ram_wit.init_vals, ram_wit.inc, r4_addr, r4_cyc,
                      ram_val_claim)
    z_out = transcript.challenge_scalar()
    ram_oc = _bk.make("ram_output_check", ram_sched, ram_wit.log_K,
                      ram_wit.init_vals, ram_wit.inc, trace.memory_layout,
                      ram_wit.witness_base, z_out,
                      bytes(trace.device.outputs))
    stage5_polys, _ = _stage([ram_ve, ram_oc], "s5")
    stage5_openings = {
        **dict(ram_ve.final_openings),
        **{f"oc_{k}": v for k, v in ram_oc.final_openings.items()}}
    del ram_ve, ram_oc, ram_sched
    finish("stage4-5-ram")

    # ---- Stage 5i: instruction-execution read-raf Shout ------------------
    # Binds LookupOutput / lookup operands to the table MLEs over the
    # 2^128 interleaved-operand index space.
    gamma_lk = transcript.challenge_scalar()
    lk = _bk.make(
        "instruction_read_raf", lk_wit, gamma_lk, r_cycle,
        accumulator.get_claim(("r1cs_input", "lookup_output")),
        accumulator.get_claim(("r1cs_input", "left_lookup_operand")),
        accumulator.get_claim(("r1cs_input", "right_lookup_operand")),
        device)
    stage5i_polys, r5i = _stage([lk], "s5i")
    r_lk_cyc = r5i[LT.LOG_K:]
    stage5i_openings = {f"ra{i}": lk.final_openings[f"ra{i}"]
                        for i in range(LK_D)}
    for t, tname in enumerate(LT.TABLE_NAMES):
        stage5i_openings[f"flag_{tname}"] = lk.flag_claims[t]
    stage5i_openings["raf_flag"] = lk.raf_flag_claim
    del lk
    finish("stage5i-instr-lookups")

    # ---- Stage 6: bytecode read-raf + register index rafs (batched) ------
    # The rd/rs1/rs2 index streams are proven from BOTH sides against the
    # same virtual claims: bytecode side (public decoded columns) and
    # register side (the one-hot access matrices).  A second bytecode
    # instance proves the lookup-table / raf flag claims of stage 5i, a
    # third the shift sumcheck's output claim.
    gamma_bc = transcript.challenge_scalar()
    idx_cols = ops.from_u32(torch.from_numpy(np.asarray(
        [reg_wit.rd_eff, reg_wit.rs1_eff, reg_wit.rs2_eff],
        dtype=np.int32)).to(device))                            # (8, 3, T)
    idx_claims = ops.unpack_ints(ops.dot(
        eq.evals(r_cycle, device)[:, None, :], idx_cols).reshape(8, -1))
    del idx_cols
    bc_claims = [accumulator.get_claim(("r1cs_input", name))
                 for name, _ in CLAIM_COLUMNS[:-3]] + idx_claims

    def _combine(claims):
        acc, g = 0, 1
        for c in claims:
            acc = (acc + g * c) % P
            g = g * gamma_bc % P
        return acc

    zeros_T = np.zeros(T_pad, dtype=np.uint64)
    bc_sched = RamPairSchedule(bc_wit.pc_idx, zeros_T, zeros_T, bc_wit.K,
                               device=device)

    def _bc_table(gamma, columns=None):
        return combined_table_dev(bc_wit.table, bc_wit.entry, bc_wit.K,
                                  gamma, columns=columns, device=device)
    # built directly, as in the JAX package, with the tier of the slot
    # that names their class
    def _bc(inst):
        return _bk.apply_tier("bytecode_read_raf", inst)
    bc = _bc(SparseOneHotTableEval(bc_sched, bc_wit.log_K,
                                   _bc_table(gamma_bc), r_cycle,
                                   _combine(bc_claims), ("bytecode", "ra")))
    flag_claims = [accumulator.get_claim(("instr_flag", n))
                   for n in LT.TABLE_NAMES]
    flag_claims.append(accumulator.get_claim(("instr_flag", "raf")))
    bc_flags = _bc(SparseOneHotTableEval(
        bc_sched, bc_wit.log_K, _bc_table(gamma_bc, LOOKUP_FLAG_COLUMNS),
        r_lk_cyc, _combine(flag_claims), ("bytecode_flags", "ra")))
    # shift-output claim: the gamma_sh-combined current-row columns at the
    # shift sumcheck's bound point reduce to the same public table
    bc_shift = _bc(SparseOneHotTableEval(
        bc_sched, bc_wit.log_K, _bc_table(gamma_sh, SHIFT_COLUMNS),
        list(accumulator.get_point(("shift", "cols"))),
        accumulator.get_claim(("shift", "cols")), ("bytecode_shift", "ra")))
    reg_idx_tab = index_table(128, device)
    raf_insts = []
    for idx_stream, claim, name in ((reg_wit.rd_eff, idx_claims[0], "wa"),
                                    (reg_wit.rs1_eff, idx_claims[1], "ra1"),
                                    (reg_wit.rs2_eff, idx_claims[2], "ra2")):
        sched_p = RamPairSchedule(idx_stream, zeros_T, zeros_T, 128,
                                  device=device)
        raf_insts.append(_bc(SparseOneHotTableEval(
            sched_p, 7, reg_idx_tab, r_cycle, claim,
            ("registers_raf", name), opening_key="m")))
    raf_rd, raf_rs1, raf_rs2 = raf_insts
    stage6_polys, _ = _stage(
        [bc, bc_flags, bc_shift, raf_rd, raf_rs1, raf_rs2], "s6")
    stage6_openings = {"ra": bc.final_openings["ra"],
                       "flags_ra": bc_flags.final_openings["ra"],
                       "shift_ra": bc_shift.final_openings["ra"],
                       "raf_wa": raf_rd.final_openings["m"],
                       "raf_ra1": raf_rs1.final_openings["m"],
                       "raf_ra2": raf_rs2.final_openings["m"]}
    del bc, bc_flags, bc_shift, raf_rd, raf_rs1, raf_rs2, raf_insts
    del bc_sched, reg_idx_tab
    finish("stage6-bytecode")

    # ---- Stage 6v: RAM/bytecode ra virtualization -------------------------
    # Every full-ra opening accumulated by stages 4-6 reduces to openings of
    # the d committed 8-bit chunk selectors (relations/ra_virtual.py).
    # Spaces that already fit one chunk (log_K <= 8) re-index the claim
    # directly: the 256-row committed MLE at the zero-padded point IS the
    # full-ra MLE.
    insts6v = []
    for prefix, streams, log_Kv, sources in (
            ("ram_ra", ram_chunks, ram_wit.log_K, RAM_RA_SOURCES),
            ("bc_ra", bc_chunks, bc_wit.log_K, BC_RA_SOURCES)):
        chunks = [torch.from_numpy(c).to(device) for c in streams]
        for t, oid in enumerate(sources):
            pt, cl = accumulator.openings[oid]
            r_cyc_v, r_addr_v = list(pt[:log_T]), list(pt[log_T:])
            if len(chunks) == 1:
                accumulator.insert((f"{prefix}_virt", (t, 0)),
                                   r_cyc_v + r_addr_v, cl)
            else:
                insts6v.append(_bk.apply_tier(
                    "ram_ra_virtualization",
                    RaVirtual(chunks, log_Kv, r_cyc_v, r_addr_v, cl,
                              (prefix, t), device)))
        del chunks
    stage6v_polys: List[List[int]] = []
    stage6v_openings: Dict[str, int] = {}
    if insts6v:
        stage6v_polys, _ = _stage(insts6v, "s6v")
        for inst in insts6v:
            prefix, t = inst.tag
            for i, v in enumerate(inst.final_openings):
                stage6v_openings[f"{prefix}_{t}_{i}"] = v
    del insts6v
    finish("stage6v-ra-virtual")

    prefix = dict(
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
        stage5i_polys=stage5i_polys,
        stage5i_openings=stage5i_openings,
        stage6_polys=stage6_polys,
        stage6_openings=stage6_openings,
        stage6_claims=list(idx_claims),
        bytecode_log_K=bc_wit.log_K,
        stage6v_polys=stage6v_polys,
        stage6v_openings=stage6v_openings,
        advice_openings=advice_openings,
        config=proof_config.as_dict())
    if not full:
        return PrefixProof(**prefix, fs_tape=fs_tape)

    # ---- Stage 7: one-hot booleanity + Hamming weight (all matrices) -----
    labels7 = {"wa": "reg_wa", "ra1": "reg_ra1", "ra2": "reg_ra2"}
    matrices = [(labels7.get(name, name), idx, K)
                for name, (idx, K) in onehot_meta.items()]
    max_log_K = max(K.bit_length() - 1 for _, _, K in matrices)
    r_b = transcript.challenge_vector(max_log_K + log_T)
    r_h = transcript.challenge_vector(log_T)
    gamma7 = transcript.challenge_scalar()
    # same-K matrices group into ONE gamma-RLC instance per (kind, K)
    groups7: Dict[int, list] = {}
    for label, idx, K in matrices:
        groups7.setdefault(K, []).append((label, idx))
    E_bcyc = eq.evals(r_b[max_log_K:], device)
    E_h = eq.evals(r_h, device)
    insts7 = []
    for K, members in groups7.items():
        log_Km = K.bit_length() - 1
        r_addr = r_b[max_log_K - log_Km:max_log_K]
        labs = [lab for lab, _ in members]
        idx = torch.from_numpy(np.stack(
            [np.asarray(s, dtype=np.int64) for _, s in members])).to(device)
        m7 = len(members)
        insts7.append(_bk.make(
            "booleanity", idx, K, E_bcyc, [r_addr] * m7, [0] * m7, gamma7,
            labs, booleanity=True, opening_kind="booleanity"))
        insts7.append(_bk.make(
            "ram_hamming_booleanity", idx, K, E_h, [None] * m7, [1] * m7,
            gamma7, labs, booleanity=False, opening_kind="hamming"))
    pi_inst = None
    if committed_image:
        pi_inst = _bk.make("program_image_claim_reduction", pi_words,
                           r4_addr, pi_start, image_claim, device)
        insts7.append(pi_inst)
    stage7_polys, _ = _stage(insts7, "s7")
    stage7_openings: Dict[str, int] = {}
    for inst in insts7:
        if inst is pi_inst:
            stage7_openings["program_image_init"] = inst.final_openings["p"]
            continue
        kind7 = "bool" if inst.booleanity else "ham"
        for lab, v in zip(inst.labels, inst.final_openings):
            stage7_openings[f"{kind7}_{lab}"] = v
    del insts7, pi_inst, E_bcyc, E_h
    finish("stage7-booleanity")

    # ---- Stage 8: joint opening reduction --------------------------------
    # Reduce EVERY committed-poly claim from stages 1-7 to openings at one
    # shared point r*, then a single homomorphic RLC PCS opening
    # (prove_packed_openings, zkvm/prover.rs:2097-2260); with no PCS the
    # proof carries those openings and no joint opening proof.
    entries = []          # (commitment_name, cycle-major point, claim)
    seen: Dict[object, int] = {}
    for oid, cname in stage8_entry_ids(len(ram_chunks), len(bc_chunks),
                                       advice_kinds, committed_image):
        pt, cl = accumulator.openings[oid]
        if (cname, pt) in seen:
            if seen[(cname, pt)] != cl:
                raise AssertionError(f"inconsistent duplicate claim {oid}")
            continue
        seen[(cname, pt)] = cl
        entries.append((cname, list(pt), cl))
    gamma8 = transcript.challenge_scalar()
    # one-hot entries group by (K, point, reduced mod p): the members of a
    # group share one address point and one cycle eq table (L, T); dense
    # entries stay singletons.  Entries reorder group-first, so
    # stage8_openings follows the instances' outputs.
    groups8: Dict[tuple, list] = {}
    dense8 = []
    for cname, pt, cl in entries:
        if cname in onehot_meta:
            key8 = (onehot_meta[cname][1], tuple(x % P for x in pt))
            groups8.setdefault(key8, []).append((cname, pt, cl))
        else:
            dense8.append((cname, pt, cl))
    entries = [e for g in groups8.values() for e in g] + dense8
    insts8 = []
    n8 = 0
    eq_tables: Dict[tuple, torch.Tensor] = {}   # by cycle point
    for (K, _), members in groups8.items():
        log_Km = K.bit_length() - 1
        q = cycle_major_to_address_major_point(
            members[0][1], len(members[0][1]) - log_Km)
        q_cyc = tuple(x % P for x in q[log_Km:])
        if q_cyc not in eq_tables:
            eq_tables[q_cyc] = eq.evals(list(q_cyc), device)
        m8 = len(members)
        insts8.append(_bk.apply_tier(
            "hamming_weight_claim_reduction", GroupedOneHot(
                [onehot_meta[c][0] for c, _, _ in members], K,
                eq_tables[q_cyc], [q[:log_Km]] * m8,
                [cl for _, _, cl in members], gamma8,
                [f"{n8 + i}_{c}" for i, (c, _, _) in enumerate(members)],
                booleanity=False, opening_kind="joint_opening")))
        n8 += m8
    dense_dev: Dict[str, torch.Tensor] = {}     # each column packed once
    for cname, pt, cl in dense8:
        if cname not in dense_dev:
            dense_dev[cname] = ops.pack_ints(dense_meta[cname], device)
        insts8.append(_bk.make("inc_claim_reduction", dense_dev[cname], pt,
                               cl, f"{n8}_{cname}", device))
        n8 += 1
    del eq_tables, dense_dev
    stage8_polys, r8 = _stage(insts8, "s8")
    stage8_openings: List[int] = []
    for inst in insts8:
        if isinstance(inst, GroupedOneHot):
            stage8_openings.extend(inst.final_openings)
        else:
            stage8_openings.append(inst.final_openings["p"])
    del insts8
    finish("stage8-reduction")

    # single RLC opening of  sum_i mu^i * P~_i  at r*
    opening_proofs: Dict[str, object] = {}
    if pcs is not None:
        mu = transcript.challenge_scalar()
        n_max = max(committed_sparse[c][2] for c, _, _ in entries)
        assert n_max == 1 << len(r8)
        weights: Dict[str, int] = {}
        mup = 1
        value = 0
        for (cname, pt, cl), o in zip(entries, stage8_openings):
            weights[cname] = (weights.get(cname, 0) + mup) % P
            value = (value + mup * o % P
                     * embedding_factor(r8, len(pt))) % P
            mup = mup * mu % P
        # sparse RLC as weighted PARTS [(positions, w, values|None)]:
        # duplicate positions combine additively inside the opening, and
        # the combined-row build runs on the native mod-r kernel without
        # materializing per-entry weighted values
        rlc_parts = [(committed_sparse[cname][0], w,
                      committed_sparse[cname][1])
                     for cname, w in weights.items()]
        opening_proofs["joint"] = pcs.open_rlc(weights, rlc_parts, r8,
                                               value, transcript)
        finish("stage8-openings")
    zk_blindfold = None
    if zk:
        zk_blindfold = blindfold_prove(zk_stages, zk_basis, transcript,
                                       zk_rng)
        finish("blindfold")

    proof = JoltProof(
        **{k: v for k, v in prefix.items()
           if k not in ("advice_openings", "config")},
        stage7_polys=stage7_polys,
        stage7_openings=stage7_openings,
        stage8_polys=stage8_polys,
        stage8_openings=stage8_openings,
        commitments=commitments,
        opening_proofs=opening_proofs,
        advice_openings=advice_openings,
        zk_commitments=zk_commit_bytes if zk else None,
        zk_blindfold=zk_blindfold,
        config=proof_config.as_dict(),
        program_image_claim=image_claim)
    proof.fs_tape = fs_tape
    return proof
