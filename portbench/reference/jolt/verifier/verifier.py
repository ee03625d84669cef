"""The Jolt verifier: stage-sequential succinct verification.

Torch-package counterpart of the JAX package's `verifier/verifier.py`
(`crates/jolt-verifier/src/verifier.rs:176-230`), with or without a Dory
setup, in clear mode, in zk mode and with the committed program image.
`verify` validates the proof-carried config, replays the preamble, absorbs
the commitments (with a setup; the program image's against the trusted
commitment recomputed from the public program) and checks stage 1
(Spartan uni-skip +
outer), stage 1s (shift), stages 2 and 3 (registers read/write checking
and Val evaluation), stages 4 and 5 (RAM read/write + raf, then Val
evaluation + output check, with the advice regions' and the committed
image's Init contributions), stage 5i (the instruction read-raf Shout),
stage 6 (bytecode read-raf and the register rafs), stage 6v (ra
virtualization), stage 7 (booleanity + Hamming weight, + the program-image
claim reduction), stage 8 (the joint opening reduction), with a setup the
joint Dory opening of the reduced claims and, in zk mode, the BlindFold
proof of every committed round, exactly as the JAX package's verifier
does; `verify_prefix` stops after stage 6v.  All of it is host work on
Python ints and the native pairing library.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List

from ..blindfold.pedersen import PedersenBasis
from ..blindfold.verify import BlindFoldError, blindfold_verify
from ..blindfold.zk_sumcheck import ZkStageData, zk_replay_challenges
from ..config import ConfigError, ProofConfig
from ..curve import bn254_host
from ..field.params import FR
from ..lookups import tables as LT
from ..pcs.dory import DorySetup
from ..pcs.scheme import make_scheme
from ..poly.eq import eq_int
from ..proof import (BC_RA_SOURCES, LOOKUP_FLAG_COLUMNS,
                             RAM_RA_SOURCES, advice_kinds_of,
                             committed_poly_names, fiat_shamir_preamble,
                             stage8_entry_ids)
from ..relations.bytecode import CLAIM_COLUMNS
from ..relations.grouped_onehot import GroupedOneHotVerifier
from ..relations.instruction_read_raf import InstructionReadRafVerifier
from ..relations.opening_reduction import (OpeningReductionVerifier,
                                           cycle_major_to_address_major_point,
                                           embedding_factor)
from ..relations.program_image import (ProgramImageReductionVerifier,
                                       image_words)
from ..relations.ra_virtual import (RaVirtualVerifier, block_point,
                                    block_widths, d_chunks)
from ..relations.ram_sparse import (SparseBytecodeReadRafVerifier,
                                    SparseRamOutputCheckVerifier,
                                    SparseRamRafEvaluationVerifier,
                                    SparseRamReadWriteCheckingVerifier,
                                    SparseRamValEvaluationVerifier,
                                    SparseRegistersRafVerifier,
                                    SparseRegistersReadWriteCheckingVerifier,
                                    SparseRegistersValEvaluationVerifier)
from ..relations.shift import SHIFT_COLUMNS, ShiftVerifier
from ..relations.spartan_outer import (SpartanOuterVerifier,
                                       num_stage1_rounds, verify_uniskip)
from ..riscv.emulator import MemoryLayout
from ..riscv.program import expand_program
from ..sumcheck.engine import BatchedSumcheck, OpeningAccumulator, SumcheckError
from ..transcript import Blake2bTranscript
from ..witness.bytecode import bytecode_K
from ..witness.instruction_lookups import D as LK_D
from ..witness.instruction_lookups import LOG_M as LK_LOG_M
from ..witness.r1cs_inputs import (NUM_VARS, V_LEFT_LOOKUP_OPERAND,
                                   V_LOOKUP_OUTPUT, V_RAM_ADDRESS,
                                   V_RAM_READ_VALUE, V_RAM_WRITE_VALUE,
                                   V_RD_WRITE_VALUE, V_RIGHT_LOOKUP_OPERAND,
                                   V_RS1_VALUE, V_RS2_VALUE, VAR_NAMES)
from ..witness.ram import advice_subcube, initial_memory_vals, remap_address

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


_PI_COMMIT_CACHE: Dict[tuple, object] = {}


def expected_bytecode_log_K(program) -> int:
    """log2 of the bytecode space `verify` expects for the program."""
    return bytecode_K(program).bit_length() - 1

def _program_image_commitment(pcs, code: bytes):
    """Recompute (and cache per program+scheme shape) the commitment to
    the program-image words polynomial."""
    digest_fn = getattr(pcs, "setup_digest", None)
    if digest_fn is None:
        # unknown scheme: no reliable setup identity -> never cache (a
        # stale hit would corrupt the verifier's trust anchor)
        return pcs.commit("program_image", image_words(code), bits=254)
    key = (hashlib.blake2b(code, digest_size=16).digest(),
           type(pcs).__name__, digest_fn())
    hit = _PI_COMMIT_CACHE.get(key)
    if hit is None:
        hit = pcs.commit("program_image", image_words(code), bits=254)
        if len(_PI_COMMIT_CACHE) > 64:
            _PI_COMMIT_CACHE.clear()
        _PI_COMMIT_CACHE[key] = hit
    return hit


def _pt_from_bytes(b: bytes):
    """A zk round commitment from its 64-byte encoding (all zero is the
    point at infinity); off-curve points are rejected."""
    if b == b"\x00" * 64:
        return None
    if len(b) != 64:
        raise VerificationError("bad zk commitment encoding")
    pt = (int.from_bytes(b[:32], "big"), int.from_bytes(b[32:], "big"))
    if not bn254_host.g1_is_on_curve(pt):
        raise VerificationError("zk commitment off curve")
    return pt


class _Run:
    """One verification's state across its stages: the transcript, the
    accumulator, the committed-image flag with stage 4's address point
    r4_addr, and the zk seam.  `stage(polys, insts, label)` checks one
    batched stage: its clear round polynomials through the sumcheck
    verifier or, when the proof carries round commitments, the challenges
    replayed from the commitments, recording the stage's public
    `ZkStageData` for BlindFold (`zk_stages`)."""

    def __init__(self, proof, transcript: Blake2bTranscript, ci: bool):
        self.transcript = transcript
        self.accumulator = OpeningAccumulator()
        self.ci = ci
        self.r4_addr: List[int] = []
        self.zk_commitments = getattr(proof, "zk_commitments", None)
        self.zk = bool(self.zk_commitments)
        self.zk_stages: List[ZkStageData] = []

    def stage(self, polys, insts, label: str) -> List[int]:
        accumulator, transcript = self.accumulator, self.transcript
        if not self.zk:
            return BatchedSumcheck.verify(polys, insts, accumulator,
                                          transcript)
        comm_bytes = self.zk_commitments.get(label)
        if comm_bytes is None:
            raise VerificationError(f"missing zk round commitments {label}")
        max_rounds = max(i.num_rounds for i in insts)
        if len(comm_bytes) != max_rounds:
            raise VerificationError(f"stage {label}: zk round count")
        input_claims = [i.input_claim(accumulator) for i in insts]
        coeffs, rs = zk_replay_challenges(comm_bytes, input_claims,
                                          len(insts), transcript)
        claim0 = sum(
            c * ((ic << (max_rounds - i.num_rounds)) % P)
            for c, ic, i in zip(coeffs, input_claims, insts)) % P
        expected = 0
        for inst, c in zip(insts, coeffs):
            off = max_rounds - inst.num_rounds
            expected = (expected + c * inst.expected_output_claim(
                accumulator, rs[off:off + inst.num_rounds])) % P
        self.zk_stages.append(ZkStageData(
            label=label, max_rounds=max_rounds,
            max_degree=max(getattr(i, "degree", 3) for i in insts),
            input_claim0=claim0, round_coeffs=[], blinds=[],
            commitments=[_pt_from_bytes(cb) for cb in comm_bytes],
            challenges=rs, claims=[], final_expected=expected))
        return rs


def verify(proof: JoltProof, io: PublicIO, setup=None) -> bool:
    """Check every stage of `proof` (stages 1 through 8, with a setup --
    a `DorySetup` or `KZGSetup`, or a scheme -- the commitments and the
    joint opening, and in zk mode the BlindFold proof) against the public
    statement, as the JAX package's `verify(proof, io, setup=setup)`;
    returns True or raises VerificationError."""
    # Dory's verifier work (the image commitment included) is host work
    pcs = make_scheme(setup, "cpu" if isinstance(setup, DorySetup)
                      else "cuda")
    run = _verify_through_6v(proof, io, pcs)
    log_T = io.padded_length.bit_length() - 1
    _verify_stages_7_8(proof, io, log_T, run, pcs)
    if run.zk:
        # BlindFold attests every committed round check (Nova fold +
        # Spartan over the verifier R1CS; ref zkvm/prover.rs:1564-1610)
        if proof.zk_blindfold is None:
            raise VerificationError("zk proof missing BlindFold proof")
        try:
            ok = blindfold_verify(run.zk_stages, proof.zk_blindfold,
                                  PedersenBasis.create(8), run.transcript)
        except BlindFoldError as e:
            raise VerificationError(f"blindfold: {e}") from e
        if not ok:
            raise VerificationError("blindfold verification failed")
    return True


def _verify_through_6v(proof, io: PublicIO, pcs=None) -> _Run:
    """Stages 1 through 6v of a `PrefixProof` or a `JoltProof` (the fields
    they share), after the commitments' absorption when `pcs` is given;
    returns the verification's state."""
    program = expand_program(io.code, io.entry, io.start)
    if proof.bytecode_log_K != expected_bytecode_log_K(program):
        raise VerificationError("bytecode_log_K inconsistent with program")
    log_T = io.padded_length.bit_length() - 1
    try:
        proof_config = ProofConfig.from_dict(proof.config or {})
        proof_config.validate(log_T, proof.ram_log_K)
    except ConfigError as e:
        raise VerificationError(f"invalid proof config: {e}") from e
    ci = proof_config.committed_program_image == 1
    transcript = Blake2bTranscript(b"Jolt")
    fiat_shamir_preamble(transcript, io.trace_length, io.padded_length,
                         io.inputs, io.outputs, io.panic, io.code, io.entry,
                         io.start, io.memory_layout, proof.ram_log_K,
                         proof.bytecode_log_K, config=proof_config)
    if pcs is not None:
        for name in committed_poly_names(d_chunks(proof.ram_log_K),
                                         d_chunks(proof.bytecode_log_K),
                                         advice_kinds_of(io.memory_layout),
                                         ci):
            if name not in proof.commitments:
                raise VerificationError(f"missing commitment {name}")
            pcs.absorb(transcript, proof.commitments[name])
        if ci:
            # the image polynomial is a pure function of the public
            # program: recompute the trusted commitment once per
            # (program, scheme) and reject a mismatched prover commitment
            # (program_image.rs "trusted commitment")
            expected_c = _program_image_commitment(pcs, io.code)
            if proof.commitments["program_image"] != expected_c:
                raise VerificationError(
                    "program_image commitment does not match the program")
    run = _Run(proof, transcript, ci)
    accumulator = run.accumulator

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
        r1 = run.stage(proof.stage1_polys, [inst1], "s1")
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
        r_sh = run.stage(proof.shift_polys, [inst_sh], "s1s")
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
        r2 = run.stage(proof.stage2_polys, [inst2], "s2")
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
        r3 = run.stage(proof.stage3_polys, [inst3], "s3")
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
        r4 = run.stage(proof.stage4_polys, [inst4a, inst4b], "s4")
    except SumcheckError as e:
        raise VerificationError(f"stage4: {e}") from e
    # sparse tier: cycle vars bound LSB-first -> normalize to big-endian
    r4_cyc, r4_addr = inst4a._split(r4)
    run.r4_addr = r4_addr
    r4n = r4_cyc + r4_addr
    for name in ("ra", "val"):
        accumulator.insert(("ram", name), r4n, o4[f"rw_{name}"])
    accumulator.insert(("ram", "inc"), r4_cyc, o4["rw_inc"])
    accumulator.insert(("ram_raf", "ra"), r4n, o4["raf_ra"])
    accumulator.flush_to_transcript(transcript)

    # ---- Stage 5: RAM Val evaluation + output check ----------------------
    # public initial image = inputs region + program image, restricted to
    # the proof's RAM address space (same rule as the prover witness);
    # committed-image mode drops the program image from the directly
    # evaluated Init (its contribution arrives as a proven scalar claim)
    init_vals = initial_memory_vals(io.inputs, io.memory_layout,
                                    b"" if ci else io.code,
                                    io.entry, K=1 << proof.ram_log_K)
    # advice contribution to Init(r4_addr): selector-scaled openings of
    # the committed advice polynomials (the regions are size-aligned
    # subcubes; ref zkvm/ram/mod.rs compute_advice_init_contributions).
    # Claims are proof-carried, accumulated here and proven by stage 8.
    adv_extra = 0
    adv_open = proof.advice_openings or {}
    for kind in advice_kinds_of(io.memory_layout):
        if kind not in adv_open:
            raise VerificationError(f"missing {kind} advice opening")
        try:
            a_vars, pfx = advice_subcube(io.memory_layout, kind,
                                         proof.ram_log_K)
        except AssertionError as e:
            raise VerificationError(f"advice region: {e}") from e
        claim = adv_open[kind] % P
        n_hi = proof.ram_log_K - a_vars
        sel = 1
        for i in range(n_hi):
            bit = (pfx >> (n_hi - 1 - i)) & 1
            rj = r4_addr[i] % P
            sel = sel * (rj if bit else (1 - rj) % P) % P
        adv_extra = (adv_extra + sel * claim) % P
        accumulator.insert(("advice", kind),
                           tuple(r4_addr[len(r4_addr) - a_vars:]), claim)
    if ci:
        if proof.program_image_claim is None:
            raise VerificationError("missing program_image_claim")
        adv_extra = (adv_extra + proof.program_image_claim) % P
        accumulator.insert(("program_image", "claim"), tuple(r4_addr),
                           proof.program_image_claim % P)
    o5 = proof.stage5_openings
    inst5 = SparseRamValEvaluationVerifier(
        log_T, proof.ram_log_K, r4_addr, r4_cyc, o4["rw_val"], init_vals,
        {"ra": o5["ra"], "inc": o5["inc"]}, extra_init=adv_extra)
    z_out = transcript.challenge_scalar()
    inst5b = SparseRamOutputCheckVerifier(
        log_T, proof.ram_log_K, z_out, io.outputs, io.memory_layout,
        io.memory_layout.witness_base, init_vals,
        {"ra": o5["oc_ra"], "inc": o5["oc_inc"]})
    try:
        r5 = run.stage(proof.stage5_polys, [inst5, inst5b], "s5")
    except SumcheckError as e:
        raise VerificationError(f"stage5: {e}") from e
    r5_cyc, r5_addr = inst5._split(r5)
    r5n = r5_cyc + r5_addr
    accumulator.insert(("ram_val_eval", "ra"), r5n, o5["ra"])
    accumulator.insert(("ram_val_eval", "inc"), r5_cyc, o5["inc"])
    accumulator.insert(("ram_output", "ra"), r5n, o5["oc_ra"])
    accumulator.insert(("ram_output", "inc"), r5_cyc, o5["oc_inc"])
    accumulator.flush_to_transcript(transcript)

    # ---- Stage 5i: instruction-execution read-raf Shout ------------------
    gamma_lk = transcript.challenge_scalar()
    o5i = proof.stage5i_openings
    inst5i = InstructionReadRafVerifier(
        log_T, gamma_lk, r_cycle,
        proof.r1cs_input_openings[V_LOOKUP_OUTPUT],
        proof.r1cs_input_openings[V_LEFT_LOOKUP_OPERAND],
        proof.r1cs_input_openings[V_RIGHT_LOOKUP_OPERAND], o5i)
    try:
        r5i = run.stage(proof.stage5i_polys, [inst5i], "s5i")
    except SumcheckError as e:
        raise VerificationError(f"stage5i: {e}") from e
    r_lk_addr, r_lk_cyc = r5i[:LT.LOG_K], r5i[LT.LOG_K:]
    for tname in LT.TABLE_NAMES:
        accumulator.insert(("instr_flag", tname), r_lk_cyc,
                           o5i[f"flag_{tname}"])
    accumulator.insert(("instr_flag", "raf"), r_lk_cyc, o5i["raf_flag"])
    for i in range(LK_D):
        pt = list(r_lk_cyc) + list(r_lk_addr[LK_LOG_M * i:LK_LOG_M * (i + 1)])
        accumulator.insert(("instr_ra", i), pt, o5i[f"ra{i}"])
    accumulator.flush_to_transcript(transcript)

    # ---- Stage 6: bytecode read-raf (decoded fields vs public program) --
    gamma_bc = transcript.challenge_scalar()
    name_to_idx = {n: i for i, n in enumerate(VAR_NAMES)}
    idx_claims = list(proof.stage6_claims)
    bc_claims = [proof.r1cs_input_openings[name_to_idx[name]]
                 for name, _ in CLAIM_COLUMNS[:-3]] + idx_claims
    o6 = proof.stage6_openings
    inst6 = SparseBytecodeReadRafVerifier(
        log_T, proof.bytecode_log_K, gamma_bc, r_cycle, bc_claims,
        program, {"ra": o6["ra"]})
    flag_claims = [o5i[f"flag_{n}"] for n in LT.TABLE_NAMES]
    flag_claims.append(o5i["raf_flag"])
    inst6f = SparseBytecodeReadRafVerifier(
        log_T, proof.bytecode_log_K, gamma_bc, r_lk_cyc, flag_claims,
        program, {"ra": o6["flags_ra"]},
        columns=LOOKUP_FLAG_COLUMNS)
    inst6s = SparseBytecodeReadRafVerifier(
        log_T, proof.bytecode_log_K, gamma_sh, list(r_sh),
        [proof.shift_opening], program, {"ra": o6["shift_ra"]},
        columns=SHIFT_COLUMNS)
    raf_insts = [SparseRegistersRafVerifier(log_T, r_cycle, idx_claims[i],
                                            o6[f"raf_{n}"])
                 for i, n in enumerate(("wa", "ra1", "ra2"))]
    stage6_insts = [inst6, inst6f, inst6s] + raf_insts
    try:
        r6 = run.stage(proof.stage6_polys, stage6_insts, "s6")
    except SumcheckError as e:
        raise VerificationError(f"stage6: {e}") from e
    max6 = max(i.num_rounds for i in stage6_insts)

    def _norm6(inst):
        c, a = inst._split(r6[max6 - inst.num_rounds:])
        return c + a

    accumulator.insert(("bytecode", "ra"), _norm6(inst6), o6["ra"])
    accumulator.insert(("bytecode_flags", "ra"), _norm6(inst6f),
                       o6["flags_ra"])
    accumulator.insert(("bytecode_shift", "ra"), _norm6(inst6s),
                       o6["shift_ra"])
    for i, n in enumerate(("wa", "ra1", "ra2")):
        accumulator.insert(("registers_raf", n), _norm6(raf_insts[i]),
                           o6[f"raf_{n}"])
    accumulator.flush_to_transcript(transcript)

    # ---- Stage 6v: RAM/bytecode ra virtualization ------------------------
    # full-ra claims reduce to committed chunk-selector openings (mirrors
    # the prover's stage 6v; d == 1 spaces re-index claims directly)
    insts6v = []
    meta6v = []
    for prefix, log_Kv, sources in (
            ("ram_ra", proof.ram_log_K, RAM_RA_SOURCES),
            ("bc_ra", proof.bytecode_log_K, BC_RA_SOURCES)):
        d = d_chunks(log_Kv)
        for t, oid in enumerate(sources):
            pt, cl = accumulator.openings[oid]
            r_cyc_v, r_addr_v = list(pt[:log_T]), list(pt[log_T:])
            if d == 1:
                accumulator.insert((f"{prefix}_virt", (t, 0)),
                                   r_cyc_v + r_addr_v, cl)
            else:
                try:
                    chunk_ops = [proof.stage6v_openings[f"{prefix}_{t}_{i}"]
                                 for i in range(d)]
                except KeyError as e:
                    raise VerificationError(
                        f"missing stage6v opening {e}") from e
                insts6v.append(RaVirtualVerifier(log_T, log_Kv, r_cyc_v, cl,
                                                 chunk_ops))
                meta6v.append((prefix, t, d, r_addr_v, log_Kv))
    if insts6v:
        try:
            r6v = run.stage(proof.stage6v_polys, insts6v, "s6v")
        except SumcheckError as e:
            raise VerificationError(f"stage6v: {e}") from e
        for inst, (prefix, t, d, r_addr_v, log_Kv) in zip(insts6v, meta6v):
            for i in range(d):
                accumulator.insert(
                    (f"{prefix}_virt", (t, i)),
                    list(r6v) + block_point(r_addr_v, log_Kv, i),
                    proof.stage6v_openings[f"{prefix}_{t}_{i}"])
        accumulator.flush_to_transcript(transcript)
    return run


def _verify_stages_7_8(proof: JoltProof, io: PublicIO, log_T: int,
                       run: _Run, pcs=None) -> None:
    """Stages 7 and 8 (`verifier.py:484-645` of the JAX package), and the
    joint PCS opening when `pcs` is given."""
    transcript, accumulator, ci = run.transcript, run.accumulator, run.ci
    # ---- Stage 7: one-hot booleanity + Hamming weight --------------------
    mat_dims = [("reg_wa", 7), ("reg_ra1", 7), ("reg_ra2", 7)]
    for i, w in enumerate(block_widths(proof.ram_log_K)):
        mat_dims.append((f"ram_ra{i}", w))
    for i, w in enumerate(block_widths(proof.bytecode_log_K)):
        mat_dims.append((f"bc_ra{i}", w))
    for i in range(LK_D):
        mat_dims.append((f"lk_ra{i}", 8))
    max_log_K = max(lk for _, lk in mat_dims)
    r_b = transcript.challenge_vector(max_log_K + log_T)
    r_h = transcript.challenge_vector(log_T)
    gamma7 = transcript.challenge_scalar()
    o7 = proof.stage7_openings
    # mirror the prover's (kind, K) grouping (relations/grouped_onehot.py)
    groups7: Dict[int, list] = {}
    for label, lk_m in mat_dims:
        groups7.setdefault(1 << lk_m, []).append(label)
    insts7 = []
    group_meta7 = []
    try:
        for Km, labels in groups7.items():
            lk_m = Km.bit_length() - 1
            r_addr = [x % P for x in r_b[max_log_K - lk_m:max_log_K]]
            r_bcyc = [x % P for x in r_b[max_log_K:]]
            m7 = len(labels)
            w_bool = [(lambda rc, p=r_bcyc: eq_int(p, rc))] * m7
            w_ham = [(lambda rc, p=[x % P for x in r_h]: eq_int(p, rc))] * m7
            insts7.append(GroupedOneHotVerifier(
                m7, lk_m, log_T, w_bool, [r_addr] * m7, [0] * m7, gamma7,
                [o7[f"bool_{lab}"] for lab in labels], booleanity=True))
            group_meta7.append(("bool", lk_m, labels))
            insts7.append(GroupedOneHotVerifier(
                m7, lk_m, log_T, w_ham, [None] * m7, [1] * m7, gamma7,
                [o7[f"ham_{lab}"] for lab in labels], booleanity=False))
            group_meta7.append(("ham", lk_m, labels))
    except KeyError as e:
        raise VerificationError(f"missing stage7 opening {e}") from e
    if ci:
        # committed-image claim reduction rides the stage-7 batch
        pi_m = max(len(image_words(io.code)).bit_length() - 1, 0)
        if pi_m > proof.ram_log_K:
            # prover-chosen ram_log_K smaller than the image: fail closed
            # with a VerificationError, not a downstream AssertionError
            raise VerificationError(
                "ram_log_K too small for the committed program image")
        pi_start = remap_address(io.entry, io.memory_layout.witness_base)
        if "program_image_init" not in o7:
            raise VerificationError("missing program_image_init opening")
        insts7.append(ProgramImageReductionVerifier(
            pi_m, run.r4_addr, pi_start, proof.program_image_claim,
            o7["program_image_init"]))
        group_meta7.append(("image", pi_m, None))
    try:
        r7 = run.stage(proof.stage7_polys, insts7, "s7")
    except SumcheckError as e:
        raise VerificationError(f"stage7: {e}") from e
    max7 = max(i.num_rounds for i in insts7)
    for inst, (kind7, lk_m, labels) in zip(insts7, group_meta7):
        r_sl = r7[max7 - inst.num_rounds:]
        if kind7 == "image":
            accumulator.insert(("program_image", "init"), list(r_sl),
                               o7["program_image_init"])
            continue
        pt = list(r_sl[lk_m:]) + list(r_sl[:lk_m])      # cycle-major order
        oid = "booleanity" if kind7 == "bool" else "hamming"
        for lab in labels:
            accumulator.insert((oid, lab), pt, o7[f"{kind7}_{lab}"])
    accumulator.flush_to_transcript(transcript)

    # ---- Stage 8: joint opening reduction --------------------------------
    # Every committed-poly claim from stages 1-7 must be covered by the
    # reduction; with a setup one joint PCS opening then checks the reduced
    # openings.
    onehot_logK = {"wa": 7, "ra1": 7, "ra2": 7}
    for i, w in enumerate(block_widths(proof.ram_log_K)):
        onehot_logK[f"ram_ra{i}"] = w
    for i, w in enumerate(block_widths(proof.bytecode_log_K)):
        onehot_logK[f"bc_ra{i}"] = w
    for i in range(LK_D):
        onehot_logK[f"lk_ra{i}"] = 8
    entries = []
    seen = {}
    for oid, cname in stage8_entry_ids(
            d_chunks(proof.ram_log_K), d_chunks(proof.bytecode_log_K),
            advice_kinds_of(io.memory_layout), ci):
        if oid not in accumulator.openings:
            raise VerificationError(f"missing stage output claim {oid}")
        pt, cl = accumulator.openings[oid]
        key = (cname, pt)
        if key in seen:
            if seen[key] != cl:
                raise VerificationError(
                    f"inconsistent duplicate claim for {oid}")
            continue
        seen[key] = cl
        entries.append((cname, list(pt), cl))
    if len(proof.stage8_openings) != len(entries):
        raise VerificationError("wrong number of stage-8 openings")
    gamma8 = transcript.challenge_scalar()
    # mirror the prover's (K, point) grouping (shared eq table per group);
    # dense entries stay singletons; entries reorder group-first, aligned
    # with the openings
    groups8: Dict[tuple, list] = {}
    dense8 = []
    for cname, pt, cl in entries:
        if cname in onehot_logK:
            key8 = (1 << onehot_logK[cname], tuple(x % P for x in pt))
            groups8.setdefault(key8, []).append((cname, pt, cl))
        else:
            dense8.append((cname, pt, cl))
    entries = [e for g in groups8.values() for e in g] + dense8
    insts8 = []
    pos = 0
    for (Km, _), members in groups8.items():
        log_Km = Km.bit_length() - 1
        qa8, wf8, cls8 = [], [], []
        for cname, pt, cl in members:
            q = cycle_major_to_address_major_point(pt, len(pt) - log_Km)
            qa8.append([x % P for x in q[:log_Km]])
            wf8.append(lambda rc, p=[x % P for x in q[log_Km:]]:
                       eq_int(p, rc))
            cls8.append(cl)
        m8 = len(members)
        insts8.append(GroupedOneHotVerifier(
            m8, log_Km, len(members[0][1]) - log_Km, wf8, qa8, cls8,
            gamma8, proof.stage8_openings[pos:pos + m8]))
        pos += m8
    for cname, pt, cl in dense8:
        insts8.append(OpeningReductionVerifier(
            len(pt), pt, cl, proof.stage8_openings[pos]))
        pos += 1
    try:
        r8 = run.stage(proof.stage8_polys, insts8, "s8")
    except SumcheckError as e:
        raise VerificationError(f"stage8: {e}") from e
    max8 = max(i.num_rounds for i in insts8)
    for n8, ((cname, pt, cl), o) in enumerate(
            zip(entries, proof.stage8_openings)):
        accumulator.insert(("joint_opening", f"{n8}_{cname}"),
                           r8[max8 - len(pt):], o)
    accumulator.flush_to_transcript(transcript)

    if pcs is not None:
        mu = transcript.challenge_scalar()
        weights = {}
        mup = 1
        value = 0
        for (cname, pt, cl), o in zip(entries, proof.stage8_openings):
            weights[cname] = (weights.get(cname, 0) + mup) % P
            value = (value + mup * o % P
                     * embedding_factor(r8, len(pt))) % P
            mup = mup * mu % P
        joint_comm = pcs.combine(proof.commitments, weights)
        op = proof.opening_proofs.get("joint")
        if op is None:
            raise VerificationError("missing joint opening proof")
        if not pcs.verify_rlc(joint_comm, r8, value, op, transcript):
            raise VerificationError("joint opening proof invalid")
