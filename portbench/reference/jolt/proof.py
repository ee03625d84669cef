"""The proof containers and the constants the verifier shares with the
prover: `JoltProof`, `PrefixProof`, the committed polynomials' names and
order, the Fiat-Shamir preamble, and the setup's size for a trace
(`required_num_vars`).

Cut from the port's `prover/prover.py` (at e0c4691) to what the verify
path reads; the prover itself is not in this copy.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import ClassVar, Dict, List, Optional


from .config import LOG_K_CHUNK, ProofConfig
from .lookups import tables as LT
from .witness.instruction_lookups import D as LK_D


LOOKUP_FLAG_COLUMNS = ([(f"flag_{n}", f"lk_{n}") for n in LT.TABLE_NAMES]
                       + [("raf", "lk_raf")])

# full-ra virtual claims consumed by the ra-virtualization stage, in order
RAM_RA_SOURCES = [("ram", "ra"), ("ram_raf", "ra"),
                  ("ram_val_eval", "ra"), ("ram_output", "ra")]
BC_RA_SOURCES = [("bytecode", "ra"), ("bytecode_flags", "ra"),
                 ("bytecode_shift", "ra")]


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
