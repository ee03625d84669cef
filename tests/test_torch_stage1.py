"""The torch port's stage-1 slice against the JAX package, on the CPU.

The same fib trace (the guest and 64/64 layout of tests/test_prove_verify.py)
goes through the JAX package and, via `interop.trace_from_numpy`, through
`jolt_tpu_torch.prove_prefix(..., device="cpu")`.  The main path's guest,
the sha2-chain at chain=1 (3447 cycles, padded 2^12: the SHA-256 inline
expansion, the native tracer on inline rows), is traced by each package's
own tracers and proved by each package.  Every compared value is an exact
integer or transcript byte string.

The JAX side is NOT `jolt_tpu.prove(tr)`: its full pipeline takes minutes
on this CPU, so `_jax_prefix` drives the JAX package's own stage functions
in the order of `jolt_tpu/prover/prover.py:466-627` -- witness extraction,
the preamble with `ProofConfig.new`, no commitments (`setup=None`), `tau`,
`prove_uniskip`, the `spartan_outer` instance through `prove_scan`,
`gamma_sh`, `shift_column_values` and the `spartan_shift` instance, then
the stage 2-5 instances of the backend registry, then stages 5i, 6 and 6v
as `prove` builds them (`_jax_stages_5i_6v`), then stages 7 and 8
(`_jax_stages_7_8`) -- and reads the transcript's (n_rounds, state) where
`prove` records its FS tape (`JOLT_TPU_FS_TRACE`); `_jax_proof` fills the
JAX package's `JoltProof` from it.  On the fib trace `test_torch_prefix.py`
compares every stage, 1 to 6v, against one run of the JAX side and
`test_torch_prove_jax.py` (slow tier) stages 7, 8 and the proof bytes;
`test_torch_prefix_sha2.py` (slow tier) compares the whole proof on the
sha2-chain at chain=1; this module holds the port's stage-1 proof to its
verifier and the port's tracers to the JAX package's on the sha2-chain.
"""

import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

from jolt_tpu.config import ProofConfig
from jolt_tpu.field import ops as jops
from jolt_tpu.kernels import get_backend
from jolt_tpu.lookups import tables as LT
from jolt_tpu.poly import dense as jdense
from jolt_tpu.poly import eq as jeq
from jolt_tpu.prover import prover as jprover
from jolt_tpu.prover.prover import fiat_shamir_preamble
from jolt_tpu.relations import bytecode as jbc
from jolt_tpu.relations import grouped_onehot as jgo
from jolt_tpu.relations import opening_reduction as jor
from jolt_tpu.relations import ra_virtual as jrv
from jolt_tpu.relations import ram_sparse as jrs
from jolt_tpu.relations import shift as jshift
from jolt_tpu.relations import spartan_outer as jso
from jolt_tpu.riscv.emulator import MemoryLayout as JaxLayout
from jolt_tpu.sumcheck.engine import OpeningAccumulator
from jolt_tpu.sumcheck.scan import prove_scan
from jolt_tpu.tracer import trace_program
from jolt_tpu.transcript import Blake2bTranscript
from jolt_tpu.witness.bytecode import extract_bytecode_witness
from jolt_tpu.witness.instruction_lookups import (
    D as LK_D, extract_instruction_lookup_witness)
from jolt_tpu.witness.r1cs_inputs import extract_r1cs_inputs
from jolt_tpu.witness.ram import extract_ram_log
from jolt_tpu.witness.registers import extract_register_log

import jolt_tpu_torch as jt
from jolt_tpu_torch import workload
from jolt_tpu_torch.field import ops as tops
from jolt_tpu_torch.interop import from_jax_limbs, trace_from_numpy
from jolt_tpu_torch.poly import dense as tdense
from jolt_tpu_torch.poly import eq as teq
from jolt_tpu_torch.relations import shift as tshift
from jolt_tpu_torch.relations import spartan_outer as tso
from jolt_tpu_torch.tracer import trace_program as t_trace_program
from jolt_tpu_torch.witness.r1cs_inputs import \
    extract_r1cs_inputs as t_extract_r1cs_inputs
from test_prove_verify import FIB, L

# One intra-op thread: the suite runs in several worker processes, and
# torch's default of a thread per core in each oversubscribes the CPU
# (the fib prefix: ~6 s alone, ~250 s with six such processes).
torch.set_num_threads(1)

P = jops.FR.modulus
CPU = "cpu"


def _port_trace(tr):
    return trace_from_numpy(
        tr.columns, tr.length, tr.padded_length,
        {"inputs": bytes(tr.device.inputs),
         "outputs": bytes(tr.device.outputs), "panic": tr.device.panic},
        dataclasses.asdict(tr.memory_layout), tr.code, tr.entry,
        [dataclasses.asdict(r) for r in tr.program.rows], tr.program.start)


def _jax_prefix(tr, last="stage6v-ra-virtual"):
    """The JAX package's stages of `prove` at `setup=None`, stage by stage,
    up to and including the stage labelled `last` (through stage 8 with
    `last="stage8-reduction"`): one accumulator and one
    transcript, every instance made through the backend registry and run by
    `prove_scan`, in `prove`'s order.  Returns the `JoltProof` fields and
    the FS-tape entries of the stages it ran."""
    bk = get_backend()
    inputs = extract_r1cs_inputs(tr)
    reg_wit = extract_register_log(tr)
    ram_wit = extract_ram_log(tr)
    bc_wit = extract_bytecode_witness(tr)
    log_T = tr.log_T
    transcript = Blake2bTranscript(b"Jolt")
    fiat_shamir_preamble(
        transcript, tr.length, tr.padded_length, bytes(tr.device.inputs),
        bytes(tr.device.outputs), tr.device.panic, tr.code, tr.entry,
        tr.program.start, tr.memory_layout, ram_wit.log_K, bc_wit.log_K,
        config=ProofConfig.new(log_T, ram_wit.log_K))
    acc = OpeningAccumulator()
    tau = transcript.challenge_vector(1 + jso.num_stage1_rounds(log_T))
    cols_dev, s1_coeffs, r0, claim1, l_scale = jso.prove_uniskip(
        inputs, tau, transcript)
    outer = bk.make("spartan_outer", inputs, tau[1:], r0, claim1, l_scale,
                    cols_dev)
    tape = []

    def mark(label):
        tape.append({"stage": label, "n_rounds": transcript.n_rounds,
                     "state": transcript.state.hex()})

    stage1_polys, _ = prove_scan([outer], acc, transcript)
    mark("stage1-spartan")
    r_cycle = list(acc.get_point(("r1cs_input", "rs1_value")))
    gamma_sh = transcript.challenge_scalar()
    shift_cols = jshift.shift_column_values(bc_wit.table, bc_wit.pc_idx,
                                            gamma_sh)
    shift_inst = bk.make("spartan_shift", shift_cols, r_cycle, gamma_sh)
    shift_polys, _ = prove_scan([shift_inst], acc, transcript)
    mark("stage1s-shift")
    out = {"stage1_uniskip": list(s1_coeffs), "stage1_polys": stage1_polys,
           "r1cs_input_openings": list(outer.input_openings),
           "shift_polys": shift_polys,
           "shift_opening": shift_inst.final_openings["cols"],
           "fs_tape": tape}
    if last == "stage1s-shift":
        return out
    # stage 2: registers read/write checking
    claims = [acc.get_claim(("r1cs_input", n))
              for n in ("rd_write_value", "rs1_value", "rs2_value")]
    gamma = transcript.challenge_scalar()
    rw = bk.make("registers_read_write", reg_wit, gamma, r_cycle, claims)
    stage2_polys, _ = prove_scan([rw], acc, transcript)
    mark("stage2-reg-rw")
    # stage 3: registers Val evaluation
    pt2 = acc.get_point(("registers", "val"))
    ve = bk.make("registers_val_evaluation", reg_wit, list(pt2[log_T:]),
                 list(pt2[:log_T]), acc.get_claim(("registers", "val")))
    stage3_polys, _ = prove_scan([ve], acc, transcript)
    mark("stage3-reg-val")
    # stage 4: RAM read/write checking + raf evaluation
    gamma_ram = transcript.challenge_scalar()
    rv, wv, addr = (acc.get_claim(("r1cs_input", n)) for n in
                    ("ram_read_value", "ram_write_value", "ram_address"))
    sched = jrs.RamPairSchedule(ram_wit.cols, ram_wit.pre, ram_wit.post,
                                ram_wit.K)
    ram_rw = bk.make("ram_read_write", sched, ram_wit.log_K,
                     ram_wit.init_vals, ram_wit.inc, gamma_ram, r_cycle, rv,
                     wv)
    ram_raf = bk.make("ram_raf_evaluation", sched, ram_wit.log_K,
                      ram_wit.witness_base, r_cycle, addr)
    stage4_polys, _ = prove_scan([ram_rw, ram_raf], acc, transcript)
    # stage 5: RAM Val evaluation + output check
    pt4 = acc.get_point(("ram", "val"))
    ram_ve = bk.make("ram_val_check", sched, ram_wit.log_K,
                     ram_wit.init_vals, ram_wit.inc, list(pt4[log_T:]),
                     list(pt4[:log_T]), acc.get_claim(("ram", "val")))
    z_out = transcript.challenge_scalar()
    ram_oc = bk.make("ram_output_check", sched, ram_wit.log_K,
                     ram_wit.init_vals, ram_wit.inc, tr.memory_layout,
                     ram_wit.witness_base, z_out, bytes(tr.device.outputs))
    stage5_polys, _ = prove_scan([ram_ve, ram_oc], acc, transcript)
    mark("stage4-5-ram")
    out = {**out,
           "stage2_polys": stage2_polys,
           "stage2_openings": dict(rw.final_openings),
           "stage3_polys": stage3_polys,
           "stage3_openings": dict(ve.final_openings),
           "stage4_polys": stage4_polys,
           "stage4_openings": {
               **{f"rw_{k}": v for k, v in ram_rw.final_openings.items()},
               **{f"raf_{k}": v for k, v in
                  ram_raf.final_openings.items()}},
           "stage5_polys": stage5_polys,
           "stage5_openings": {
               **dict(ram_ve.final_openings),
               **{f"oc_{k}": v for k, v in ram_oc.final_openings.items()}}}
    if last == "stage4-5-ram":
        return out
    return {**out, **_jax_stages_5i_6v(tr, bk, acc, transcript, mark, inputs,
                                       reg_wit, ram_wit, bc_wit, r_cycle,
                                       gamma_sh, last)}


def _jax_stages_5i_6v(tr, bk, acc, transcript, mark, inputs, reg_wit,
                      ram_wit, bc_wit, r_cycle, gamma_sh, last):
    """Stages 5i, 6 and 6v of the JAX package's `prove`
    (`jolt_tpu/prover/prover.py:628-738`), continuing `_jax_prefix`'s
    accumulator and transcript, up to and including the stage `last`."""
    log_T, T_pad = tr.log_T, tr.padded_length
    lk_wit = extract_instruction_lookup_witness(tr, inputs)
    # stage 5i: instruction read-raf
    gamma_lk = transcript.challenge_scalar()
    lk = bk.make("instruction_read_raf", lk_wit, gamma_lk, r_cycle,
                 *(acc.get_claim(("r1cs_input", n)) for n in
                   ("lookup_output", "left_lookup_operand",
                    "right_lookup_operand")))
    stage5i_polys, r5i = prove_scan([lk], acc, transcript)
    mark("stage5i-instr-lookups")
    r_lk_cyc = r5i[LT.LOG_K:]
    o5i = {f"ra{i}": lk.final_openings[f"ra{i}"] for i in range(LK_D)}
    for t, name in enumerate(LT.TABLE_NAMES):
        o5i[f"flag_{name}"] = lk.flag_claims[t]
    o5i["raf_flag"] = lk.raf_flag_claim
    out = {"stage5i_polys": stage5i_polys, "stage5i_openings": o5i}
    if last == "stage5i-instr-lookups":
        return out
    # stage 6: bytecode read-raf + register rafs
    gamma_bc = transcript.challenge_scalar()
    e_cyc = jeq.evals(r_cycle)
    streams = (reg_wit.rd_eff, reg_wit.rs1_eff, reg_wit.rs2_eff)
    idx_claims = [jops.unpack_ints(jops.dot(e_cyc, jops.pack_ints(col)))[0]
                  for col in streams]

    def combine(claims):
        a, g = 0, 1
        for c in claims:
            a, g = (a + g * c) % P, g * gamma_bc % P
        return a

    zeros = np.zeros(T_pad, dtype=np.uint64)
    bc_sched = jrs.RamPairSchedule(bc_wit.pc_idx, zeros, zeros, bc_wit.K)

    def table(gamma, columns=None):
        return jrs.combined_table_dev(bc_wit.table, bc_wit.entry, bc_wit.K,
                                      gamma, columns=columns)
    bc_claims = [acc.get_claim(("r1cs_input", n))
                 for n, _ in jbc.CLAIM_COLUMNS[:-3]] + idx_claims
    flag_claims = [acc.get_claim(("instr_flag", n))
                   for n in LT.TABLE_NAMES + ["raf"]]
    insts = [
        jrs.SparseOneHotTableEval(bc_sched, bc_wit.log_K, table(gamma_bc),
                                  r_cycle, combine(bc_claims),
                                  ("bytecode", "ra")),
        jrs.SparseOneHotTableEval(
            bc_sched, bc_wit.log_K,
            table(gamma_bc, jprover.LOOKUP_FLAG_COLUMNS), r_lk_cyc,
            combine(flag_claims), ("bytecode_flags", "ra")),
        jrs.SparseOneHotTableEval(
            bc_sched, bc_wit.log_K, table(gamma_sh, jshift.SHIFT_COLUMNS),
            list(acc.get_point(("shift", "cols"))),
            acc.get_claim(("shift", "cols")), ("bytecode_shift", "ra"))]
    reg_tab = jrs.index_table(128)
    for col, claim, name in zip(streams, idx_claims, ("wa", "ra1", "ra2")):
        insts.append(jrs.SparseOneHotTableEval(
            jrs.RamPairSchedule(col, zeros, zeros, 128), 7, reg_tab, r_cycle,
            claim, ("registers_raf", name), opening_key="m"))
    stage6_polys, _ = prove_scan(insts, acc, transcript)
    mark("stage6-bytecode")
    out.update(stage6_polys=stage6_polys, stage6_claims=list(idx_claims),
               stage6_openings={
                   "ra": insts[0].final_openings["ra"],
                   "flags_ra": insts[1].final_openings["ra"],
                   "shift_ra": insts[2].final_openings["ra"],
                   **{f"raf_{n}": inst.final_openings["m"] for n, inst in
                      zip(("wa", "ra1", "ra2"), insts[3:])}})
    if last == "stage6-bytecode":
        return out
    # stage 6v: RAM / bytecode ra virtualization
    insts6v = []
    for prefix, idx, log_Kv, sources in (
            ("ram_ra", ram_wit.cols, ram_wit.log_K, jprover.RAM_RA_SOURCES),
            ("bc_ra", np.asarray(bc_wit.pc_idx), bc_wit.log_K,
             jprover.BC_RA_SOURCES)):
        chunks = jrv.chunk_streams(idx, log_Kv)
        for t, oid in enumerate(sources):
            pt, cl = acc.openings[oid]
            if len(chunks) == 1:
                acc.insert((f"{prefix}_virt", (t, 0)), list(pt), cl)
            else:
                insts6v.append(jrv.RaVirtual(chunks, log_Kv, list(pt[:log_T]),
                                             list(pt[log_T:]), cl,
                                             (prefix, t)))
    stage6v_polys, o6v = [], {}
    if insts6v:
        stage6v_polys, _ = prove_scan(insts6v, acc, transcript)
        for inst in insts6v:
            prefix, t = inst.tag
            for i, v in enumerate(inst.final_openings):
                o6v[f"{prefix}_{t}_{i}"] = v
    mark("stage6v-ra-virtual")
    out.update(stage6v_polys=stage6v_polys, stage6v_openings=o6v)
    if last == "stage6v-ra-virtual":
        return out
    return {**out, **_jax_stages_7_8(tr, bk, acc, transcript, mark, reg_wit,
                                     ram_wit, bc_wit, lk_wit)}


def _jax_proof(tr, out):
    """The JAX package's `JoltProof` at `setup=None` from `_jax_prefix`'s
    fields through stage 8 (as `prove` fills it, `prover.py:920-964`)."""
    ram_log_K = extract_ram_log(tr).log_K
    fields = {f.name for f in dataclasses.fields(jprover.JoltProof)}
    return jprover.JoltProof(
        trace_length=tr.length, padded_length=tr.padded_length,
        ram_log_K=ram_log_K,
        bytecode_log_K=extract_bytecode_witness(tr).log_K,
        commitments={}, opening_proofs={}, advice_openings={},
        config=ProofConfig.new(tr.log_T, ram_log_K).as_dict(),
        **{k: v for k, v in out.items() if k in fields})


def _jax_stages_7_8(tr, bk, acc, transcript, mark, reg_wit, ram_wit, bc_wit,
                    lk_wit):
    """Stages 7 and 8 of the JAX package's `prove` at `setup=None`
    (`jolt_tpu/prover/prover.py:739-884`; no advice regions, no committed
    image), continuing `_jax_stages_5i_6v`'s accumulator and transcript;
    stage 8 on the host engine, the tier `prove` takes on the CPU."""
    log_T = tr.log_T
    ram_chunks = jrv.chunk_streams(ram_wit.cols, ram_wit.log_K)
    bc_chunks = jrv.chunk_streams(np.asarray(bc_wit.pc_idx), bc_wit.log_K)
    onehot_meta = {"wa": (reg_wit.rd_eff, 128), "ra1": (reg_wit.rs1_eff, 128),
                   "ra2": (reg_wit.rs2_eff, 128)}
    matrices = [("reg_wa", reg_wit.rd_eff, 128),
                ("reg_ra1", reg_wit.rs1_eff, 128),
                ("reg_ra2", reg_wit.rs2_eff, 128)]
    for prefix, chunks, log_Kc in (("ram_ra", ram_chunks, ram_wit.log_K),
                                   ("bc_ra", bc_chunks, bc_wit.log_K)):
        for i, w in enumerate(jrv.block_widths(log_Kc)):
            onehot_meta[f"{prefix}{i}"] = (chunks[i], 1 << w)
            matrices.append((f"{prefix}{i}", chunks[i].tolist(), 1 << w))
    for i in range(LK_D):
        onehot_meta[f"lk_ra{i}"] = (lk_wit.chunks[i], 256)
        matrices.append((f"lk_ra{i}", lk_wit.chunks[i].tolist(), 256))
    # stage 7: booleanity + Hamming weight, one instance per (kind, K)
    max_log_K = max(K.bit_length() - 1 for _, _, K in matrices)
    r_b = transcript.challenge_vector(max_log_K + log_T)
    r_h = transcript.challenge_vector(log_T)
    gamma7 = transcript.challenge_scalar()
    groups7 = {}
    for label, idx, K in matrices:
        groups7.setdefault(K, []).append((label, idx))
    e_bcyc, e_h = jeq.evals(r_b[max_log_K:]), jeq.evals(r_h)
    insts7 = []
    for K, members in groups7.items():
        r_addr = r_b[max_log_K - (K.bit_length() - 1):max_log_K]
        labels, streams = [m[0] for m in members], [m[1] for m in members]
        m7 = len(members)
        insts7.append(bk.make("booleanity", streams, K, [e_bcyc] * m7,
                              [r_addr] * m7, [0] * m7, gamma7, labels,
                              booleanity=True, opening_kind="booleanity"))
        insts7.append(bk.make("ram_hamming_booleanity", streams, K,
                              [e_h] * m7, [None] * m7, [1] * m7, gamma7,
                              labels, booleanity=False,
                              opening_kind="hamming"))
    stage7_polys, _ = prove_scan(insts7, acc, transcript)
    o7 = {}
    for inst in insts7:
        kind = "bool" if inst.booleanity else "ham"
        for label, v in zip(inst.labels, inst.final_openings):
            o7[f"{kind}_{label}"] = v
    mark("stage7-booleanity")
    # stage 8: the joint opening reduction
    d_ram, d_bc = len(ram_chunks), len(bc_chunks)
    dense_meta = {"inc": reg_wit.inc, "ram_inc": ram_wit.inc}
    entries, seen = [], {}
    for oid, cname in jprover.stage8_entry_ids(d_ram, d_bc):
        pt, cl = acc.openings[oid]
        if (cname, pt) in seen:
            assert seen[(cname, pt)] == cl
            continue
        seen[(cname, pt)] = cl
        entries.append((cname, list(pt), cl))
    gamma8 = transcript.challenge_scalar()
    groups8, dense8 = {}, []
    for cname, pt, cl in entries:
        if cname in onehot_meta:
            key = (onehot_meta[cname][1], tuple(x % P for x in pt))
            groups8.setdefault(key, []).append((cname, pt, cl))
        else:
            dense8.append((cname, pt, cl))
    insts8, n8 = [], 0
    for (K, _), members in groups8.items():
        log_K = K.bit_length() - 1
        q = jor.cycle_major_to_address_major_point(
            members[0][1], len(members[0][1]) - log_K)
        w = jeq.evals(q[log_K:])
        labels = [f"{n8 + i}_{c}" for i, (c, _, _) in enumerate(members)]
        n8 += len(members)
        insts8.append(jgo.GroupedOneHot(
            [onehot_meta[c][0] for c, _, _ in members], K,
            [w] * len(members), [q[:log_K]] * len(members),
            [cl for _, _, cl in members], gamma8, labels,
            booleanity=False, opening_kind="joint_opening"))
    for cname, pt, cl in dense8:
        insts8.append(bk.make("inc_claim_reduction", dense_meta[cname], pt,
                              cl, f"{n8}_{cname}"))
        n8 += 1
    for inst in insts8:
        inst.force_host = True
    stage8_polys, _ = prove_scan(insts8, acc, transcript)
    o8 = []
    for inst in insts8:
        if isinstance(inst, jgo.GroupedOneHot):
            o8.extend(inst.final_openings)
        else:
            o8.append(inst.final_openings["p"])
    mark("stage8-reduction")
    return {"stage7_polys": stage7_polys, "stage7_openings": o7,
            "stage8_polys": stage8_polys, "stage8_openings": o8}


@pytest.fixture(scope="module")
def fib():
    tr = trace_program(FIB, layout=L)
    return tr, _port_trace(tr)


@pytest.fixture(scope="module")
def port_proof(fib):
    return jt.prove_prefix(fib[1], device=CPU)


def test_proof_header_fields(port_proof, fib):
    tr = fib[0]
    assert port_proof.trace_length == tr.length
    assert port_proof.padded_length == tr.padded_length
    assert port_proof.ram_log_K == extract_ram_log(tr).log_K
    assert port_proof.bytecode_log_K == extract_bytecode_witness(tr).log_K


def test_verify_stage1_accepts(port_proof, fib):
    assert jt.verify_prefix(port_proof, jt.PublicIO.from_trace(fib[1]))


@pytest.mark.parametrize("idx", [0, 7, 30])
def test_verify_stage1_rejects_tampered_uniskip(port_proof, fib, idx):
    bad = copy.deepcopy(port_proof)
    bad.stage1_uniskip[idx] = (bad.stage1_uniskip[idx] + 1) % P
    with pytest.raises(jt.VerificationError):
        jt.verify_prefix(bad, jt.PublicIO.from_trace(fib[1]))


@pytest.mark.parametrize("part", ["stage1_polys", "shift_polys",
                                  "r1cs_input_openings", "shift_opening"])
def test_verify_stage1_rejects_tampered_rounds(port_proof, fib, part):
    bad = copy.deepcopy(port_proof)
    if part == "shift_opening":
        bad.shift_opening = (bad.shift_opening + 1) % P
    elif part == "r1cs_input_openings":
        bad.r1cs_input_openings[5] = (bad.r1cs_input_openings[5] + 1) % P
    else:
        poly = getattr(bad, part)[3]
        poly[0] = (poly[0] + 1) % P
    with pytest.raises(jt.VerificationError):
        jt.verify_prefix(bad, jt.PublicIO.from_trace(fib[1]))


def test_trace_from_numpy_matches(fib):
    tr, pt = fib
    assert pt.length == tr.length and pt.padded_length == tr.padded_length
    assert set(pt.columns) == set(tr.columns)
    for k in tr.columns:
        np.testing.assert_array_equal(pt.columns[k], tr.columns[k])
    assert bytes(pt.device.outputs) == bytes(tr.device.outputs)
    rows = [dataclasses.asdict(r) for r in tr.program.rows]
    rows[0]["imm"] += 1
    with pytest.raises(ValueError):
        trace_from_numpy(tr.columns, tr.length, tr.padded_length,
                         {"outputs": bytes(tr.device.outputs)},
                         dataclasses.asdict(tr.memory_layout), tr.code,
                         tr.entry, rows)


def test_native_tracer_matches_python_tracer(fib):
    from jolt_tpu_torch.riscv.emulator import MemoryLayout
    from jolt_tpu_torch.tracer import trace_program as t_trace
    from jolt_tpu_torch.tracer.native import trace_program_native
    layout = MemoryLayout(**dataclasses.asdict(L))
    py = t_trace(FIB, layout=layout)
    nat = trace_program_native(FIB, layout=layout)
    assert (nat.length, nat.padded_length) == (py.length, py.padded_length)
    for k in py.columns:
        np.testing.assert_array_equal(nat.columns[k], py.columns[k])
    assert bytes(nat.device.outputs) == bytes(fib[0].device.outputs)


# ---- the main path's guest: the sha2-chain at chain=1 ------------------

@pytest.fixture(scope="module")
def sha2():
    """The JAX package's trace, and the port's native and Python traces."""
    layout = workload.sha2_chain_layout()
    src = workload.sha2_chain_source(layout, 1)
    jax_tr = trace_program(src, layout=JaxLayout(**dataclasses.asdict(layout)),
                           inputs=workload.SHA2_INPUT)
    return {"jax": jax_tr,
            "native": workload.sha2_chain_trace(1),
            "python": t_trace_program(src, layout=layout,
                                      inputs=workload.SHA2_INPUT)}


@pytest.mark.parametrize("tracer", ["native", "python"])
def test_sha2_port_tracers_match_jax(sha2, tracer):
    tr, pt = sha2["jax"], sha2[tracer]
    assert (pt.length, pt.padded_length) == (tr.length, tr.padded_length)
    assert tr.padded_length == 1 << 12
    assert set(pt.columns) == set(tr.columns)
    for k in tr.columns:
        np.testing.assert_array_equal(pt.columns[k], tr.columns[k])
    assert bytes(pt.device.outputs[:32]) == workload.sha2_chain_digest(1)


# ---- device modules of the slice, one by one --------------------------

def _rand_vals(n, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    return [int(sum(int(w) << (32 * i) for i, w in enumerate(row))) % P
            for row in words]


def test_eq_evals_matches_jax():
    point = _rand_vals(6, 1)
    assert (tops.unpack_ints(teq.evals(point, CPU))
            == jops.unpack_ints(jeq.evals(point)))
    assert (tops.unpack_ints(teq.evals(point, CPU, scale=12345))
            == jops.unpack_ints(jeq.evals(point, scale=12345)))


def test_bind_high_matches_jax():
    vals, r = _rand_vals(64, 2), _rand_vals(1, 3)[0]
    got = tdense.bind_high(tops.pack_ints(vals, CPU), tops.pack_ints([r], CPU))
    want = jdense.bind_high(jops.pack_ints(vals), jops.pack_ints([r]))
    assert tops.unpack_ints(got) == jops.unpack_ints(want)


@pytest.mark.parametrize("degree", [2, 3])
def test_eval_points_high_match_jax(degree):
    vals = _rand_vals(64, 4)
    got = tdense.sumcheck_eval_points_high(tops.pack_ints(vals, CPU), degree)
    want = jdense.sumcheck_eval_points_high(jops.pack_ints(vals), degree)
    assert got.shape[1:] == tuple(want.shape[1:])
    assert (tops.unpack_ints(got.reshape(8, -1))
            == jops.unpack_ints(want.reshape(want.shape[0], -1)))


def test_pack_input_columns_matches_jax(fib):
    tr, pt = fib
    got = tso.pack_input_columns(t_extract_r1cs_inputs(pt), CPU)
    want = jso.pack_input_columns(extract_r1cs_inputs(tr))
    assert torch.equal(got, from_jax_limbs(np.asarray(want), CPU))


def test_combo_matches_jax(fib):
    tr, pt = fib
    cols_t = tso.pack_input_columns(t_extract_r1cs_inputs(pt), CPU)
    cols_j = jso.pack_input_columns(extract_r1cs_inputs(tr))
    y_basis = _rand_vals(tso.UNISKIP_DOMAIN, 5)
    for m in range(3):
        rows_t = [(g, tso._group_w_rows(y_basis)[g][m]) for g in range(2)]
        got = tso._combo(cols_t, tso._combo_terms(rows_t, CPU), 2)
        want = jso._combo_kernel(cols_j, *jso._combo_terms(rows_t), 2)
        assert torch.equal(got, from_jax_limbs(np.asarray(want), CPU))


def test_shift_weight_evals_match_jax():
    r = _rand_vals(5, 6)
    assert (tops.unpack_ints(tshift.shift_weight_evals(r, CPU))
            == jops.unpack_ints(jshift.shift_weight_evals(r)))
