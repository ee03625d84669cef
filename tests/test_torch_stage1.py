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
the stage 2-5 instances of the backend registry -- and reads the
transcript's (n_rounds, state) where `prove` records its FS tape
(`JOLT_TPU_FS_TRACE`).  This module compares stages 1 and 1s (the JAX side
stops after `stage1s-shift`); `test_torch_prefix.py` compares stages 2-5.
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
from jolt_tpu.poly import dense as jdense
from jolt_tpu.poly import eq as jeq
from jolt_tpu.prover.prover import fiat_shamir_preamble
from jolt_tpu.relations import ram_sparse as jrs
from jolt_tpu.relations import shift as jshift
from jolt_tpu.relations import spartan_outer as jso
from jolt_tpu.riscv.emulator import MemoryLayout as JaxLayout
from jolt_tpu.sumcheck.engine import OpeningAccumulator
from jolt_tpu.sumcheck.scan import prove_scan
from jolt_tpu.tracer import trace_program
from jolt_tpu.transcript import Blake2bTranscript
from jolt_tpu.witness.bytecode import extract_bytecode_witness
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

P = jops.FR.modulus
CPU = "cpu"


def _port_trace(tr):
    return trace_from_numpy(
        tr.columns, tr.length, tr.padded_length,
        {"inputs": bytes(tr.device.inputs),
         "outputs": bytes(tr.device.outputs), "panic": tr.device.panic},
        dataclasses.asdict(tr.memory_layout), tr.code, tr.entry,
        [dataclasses.asdict(r) for r in tr.program.rows], tr.program.start)


def _jax_prefix(tr, last="stage4-5-ram"):
    """The JAX package's stage 1-5 prefix of `prove`, stage by stage, up to
    and including the stage labelled `last`: one accumulator and one
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
    return {**out,
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


@pytest.fixture(scope="module")
def fib():
    tr = trace_program(FIB, layout=L)
    return tr, _port_trace(tr)


@pytest.fixture(scope="module")
def jax_stage1(fib):
    return _jax_prefix(fib[0], last="stage1s-shift")


@pytest.fixture(scope="module")
def port_proof(fib):
    return jt.prove_prefix(fib[1], device=CPU)


@pytest.mark.parametrize("field", ["stage1_uniskip", "stage1_polys",
                                   "r1cs_input_openings", "shift_polys",
                                   "shift_opening"])
def test_stage1_field_matches_jax(port_proof, jax_stage1, field):
    assert getattr(port_proof, field) == jax_stage1[field]


@pytest.mark.parametrize("i,stage", [(0, "stage1-spartan"),
                                     (1, "stage1s-shift")])
def test_fs_tape_matches_jax(port_proof, jax_stage1, i, stage):
    assert port_proof.fs_tape[i] == jax_stage1["fs_tape"][i]
    assert port_proof.fs_tape[i]["stage"] == stage


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


@pytest.fixture(scope="module")
def sha2_jax_stage1(sha2):
    return _jax_prefix(sha2["jax"], last="stage1s-shift")


@pytest.fixture(scope="module")
def sha2_port_proof(sha2):
    return jt.prove_prefix(sha2["native"], device=CPU)


@pytest.mark.parametrize("tracer", ["native", "python"])
def test_sha2_port_tracers_match_jax(sha2, tracer):
    tr, pt = sha2["jax"], sha2[tracer]
    assert (pt.length, pt.padded_length) == (tr.length, tr.padded_length)
    assert tr.padded_length == 1 << 12
    assert set(pt.columns) == set(tr.columns)
    for k in tr.columns:
        np.testing.assert_array_equal(pt.columns[k], tr.columns[k])
    assert bytes(pt.device.outputs[:32]) == workload.sha2_chain_digest(1)


@pytest.mark.parametrize("field", ["stage1_uniskip", "stage1_polys",
                                   "r1cs_input_openings", "shift_polys",
                                   "shift_opening", "fs_tape"])
def test_sha2_stage1_matches_jax(sha2_port_proof, sha2_jax_stage1, field):
    want = sha2_jax_stage1[field]
    got = getattr(sha2_port_proof, field)
    if field == "fs_tape":        # the JAX side stops after stage 1s
        got = got[:len(want)]
    assert got == want


def test_sha2_verify_stage1_accepts(sha2_port_proof, sha2):
    assert jt.verify_prefix(sha2_port_proof,
                            jt.PublicIO.from_trace(sha2["native"]))


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
