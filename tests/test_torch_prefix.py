"""The torch port's stages 1-6v against the JAX package, and its whole fib
proof against the JAX verifier, on the CPU.

The fib trace of tests/test_prove_verify.py goes through the JAX package's
stage functions (`test_torch_stage1._jax_prefix`: one accumulator, one
transcript, `prove`'s order, every instance through the backend registry
and `prove_scan`) and through `jolt_tpu_torch.prove(..., device="cpu")`.
Every stage-1/1s and `stage2..6v` field of the proof and the FS-tape state
after each of the eight stages must be equal, and so must those of the
port's prefix with every stage it can on the device tier (every slot but
s5i's forced there, `with_tier`: one fetch a stage); `verify_prefix` must accept
the proof and reject it with a tampered round polynomial or opening in
each stage.  The whole proof (stages 1-8), written by the port's codec,
must decode in the JAX package's codec and pass its `verify`; the port's
`verify` must accept it and reject a tampered round polynomial or opening
of stage 7 and of stage 8; the port's codec must round-trip it and the
JAX codec's bytes of it.  (Its stage-7/8 fields and bytes are held to the
JAX package's own stages in the slow `test_torch_prove_jax.py`: the JAX
package's stage-7/8 compiles cost 82 s cold on this CPU.)  Fib's RAM and bytecode spaces fit
one 8-bit chunk, so its stage 6v has no sumcheck: the same guest with a
2 KiB input region (RAM log K = 9, two chunks) proves and verifies stage
6v in the port, and its tampered round polynomials and chunk openings are
rejected.

Below those, the device modules of the slice meet their JAX counterparts
one by one on seeded inputs (after the whole-prefix tests, so the JAX
package's compiles of the shapes they share are already in this process):
the RAM pair schedule and a cycle message of stages 2-5;
`ops.segment_sum_mod`; the instruction read-raf's suffix-table build at
phase 0 and a later phase (T = 2^6) and its flag claims; the stacked
product message at 18 and 3 factors; a whole `RaVirtual` sumcheck (d = 2,
log K = 12, T = 2^5) on copied transcripts, and the port's verifier on it;
a whole `SparseOneHotTableEval` sumcheck on fib's bytecode schedule and on
a register stream; the instruction-lookup witness.

The sha2-chain at chain=1 gets the same whole-prefix comparison in
`test_torch_prefix_sha2.py` (slow tier: the JAX package's compiles for a
second trace shape take minutes on this CPU); its RAM and bytecode spaces
(log K 13 and 12) give stage 6v seven instances of d = 2.
"""

import copy
import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jolt_tpu import proof_io as jproof_io
from jolt_tpu.field import ops as jops
from jolt_tpu.poly import dense as jdense
from jolt_tpu.poly import eq as jeq
from jolt_tpu.poly import lt as jlt
from jolt_tpu.relations import instruction_read_raf as jir
from jolt_tpu.relations import ra_virtual as jrv
from jolt_tpu.relations import ram_sparse as jrs
from jolt_tpu.sumcheck.engine import BatchedSumcheck as JBatched
from jolt_tpu.sumcheck.engine import OpeningAccumulator as JAcc
from jolt_tpu.tracer import trace_program
from jolt_tpu.transcript import Blake2bTranscript as JTranscript
from jolt_tpu.verifier import verify as j_verify
from jolt_tpu.verifier.verifier import PublicIO as JPublicIO
from jolt_tpu.witness.bytecode import extract_bytecode_witness
from jolt_tpu.witness.instruction_lookups import \
    extract_instruction_lookup_witness
from jolt_tpu.witness.r1cs_inputs import extract_r1cs_inputs
from jolt_tpu.witness.ram import extract_ram_log
from jolt_tpu.witness.registers import extract_register_log

import jolt_tpu_torch as jt
from jolt_tpu_torch import proof_io
from jolt_tpu_torch.kernels import JoltBackend, set_backend
from jolt_tpu_torch.field import ops as tops
from jolt_tpu_torch.interop import from_jax_limbs
from jolt_tpu_torch.lookups import tables as tLT
from jolt_tpu_torch.poly import dense as tdense
from jolt_tpu_torch.poly import eq as teq
from jolt_tpu_torch.poly import lt as tlt
from jolt_tpu_torch.relations import instruction_read_raf as tir
from jolt_tpu_torch.relations import ra_virtual as trv
from jolt_tpu_torch.relations import ram_sparse as trs
from jolt_tpu_torch.riscv.emulator import MemoryLayout
from jolt_tpu_torch.sumcheck import product as tproduct
from jolt_tpu_torch.sumcheck.engine import BatchedSumcheck as TBatched
from jolt_tpu_torch.sumcheck.engine import OpeningAccumulator as TAcc
from jolt_tpu_torch.sumcheck.engine import SumcheckError
from jolt_tpu_torch.tracer import trace_program as t_trace_program
from jolt_tpu_torch.transcript import Blake2bTranscript as TTranscript
from jolt_tpu_torch.utils import profiling
from jolt_tpu_torch.witness.bytecode import \
    extract_bytecode_witness as t_extract_bytecode_witness
from jolt_tpu_torch.witness.instruction_lookups import \
    extract_instruction_lookup_witness as t_extract_lookup_witness
from jolt_tpu_torch.witness.r1cs_inputs import \
    extract_r1cs_inputs as t_extract_r1cs_inputs
from jolt_tpu_torch.witness.ram import extract_ram_log as t_extract_ram_log
from jolt_tpu_torch.witness.registers import \
    extract_register_log as t_extract_register_log
from test_instruction_read_raf import _synthetic_witness
from test_prove_verify import FIB, L
from test_torch_stage1 import _jax_prefix, _port_trace, _rand_vals

# One intra-op thread: the suite runs in several worker processes, and
# torch's default of a thread per core in each oversubscribes the CPU
# (the fib prefix: ~6 s alone, ~250 s with six such processes).
torch.set_num_threads(1)

P = jops.FR.modulus
CPU = "cpu"
STAGES = (2, 3, 4, 5, "5i", "6", "6v")
WIDE = MemoryLayout(max_input_size=2048, max_output_size=64)


@pytest.fixture(scope="module")
def fib():
    tr = trace_program(FIB, layout=L)
    return tr, _port_trace(tr)


@pytest.fixture(scope="module")
def jax_prefix(fib):
    return _jax_prefix(fib[0])


@pytest.fixture(scope="module")
def port_proof(fib):
    """The port's whole proof of fib (stages 1-8); its stage 1-6v fields
    are `prove_prefix`'s, since `prove` runs the same prefix."""
    return jt.prove(fib[1], device=CPU)


@pytest.mark.parametrize("field", ["stage1_uniskip", "stage1_polys",
                                   "r1cs_input_openings", "shift_polys",
                                   "shift_opening"])
def test_stage1_field_matches_jax(port_proof, jax_prefix, field):
    assert getattr(port_proof, field) == jax_prefix[field]


@pytest.mark.parametrize("i,stage", [(0, "stage1-spartan"),
                                     (1, "stage1s-shift")])
def test_fs_tape_matches_jax(port_proof, jax_prefix, i, stage):
    assert port_proof.fs_tape[i] == jax_prefix["fs_tape"][i]
    assert port_proof.fs_tape[i]["stage"] == stage


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("part", ["polys", "openings"])
def test_prefix_field_matches_jax(port_proof, jax_prefix, stage, part):
    field = f"stage{stage}_{part}"
    assert getattr(port_proof, field) == jax_prefix[field]


def test_stage6_claims_match_jax(port_proof, jax_prefix):
    assert port_proof.stage6_claims == jax_prefix["stage6_claims"]


@pytest.mark.parametrize("i,stage", [(2, "stage2-reg-rw"),
                                     (3, "stage3-reg-val"),
                                     (4, "stage4-5-ram"),
                                     (5, "stage5i-instr-lookups"),
                                     (6, "stage6-bytecode"),
                                     (7, "stage6v-ra-virtual")])
def test_prefix_fs_tape_matches_jax(port_proof, jax_prefix, i, stage):
    assert port_proof.fs_tape[i]["stage"] == stage
    assert port_proof.fs_tape[i] == jax_prefix["fs_tape"][i]


@pytest.fixture(scope="module")
def device_prefix(fib):
    """fib's prefix with every slot whose class has the device tier forced
    to it, and the fetches it made."""
    set_backend(JoltBackend.default().with_every_slot("device"))
    try:
        with profiling.recording() as prof:
            proof = jt.prove_prefix(fib[1], device=CPU)
    finally:
        set_backend(None)
    return proof, prof.tally("d2h", within="fused.fetch")


@pytest.mark.parametrize("stage", STAGES)
def test_device_tier_prefix_matches_jax(device_prefix, jax_prefix, stage):
    """Each stage's relations on the device tier (s5i on the host engine)
    give the JAX package's round polynomials and openings on fib."""
    proof = device_prefix[0]
    for part in ("polys", "openings"):
        field = f"stage{stage}_{part}"
        assert getattr(proof, field) == jax_prefix[field]


def test_device_tier_prefix_fs_tape_matches_jax(device_prefix, jax_prefix):
    proof, fetches = device_prefix
    assert proof.fs_tape == jax_prefix["fs_tape"]
    # s1, s1s, s2, s3, s4, s5 and s6 (fib's stage 6v has no sumcheck)
    assert fetches == 7


def test_prefix_openings_keys(port_proof):
    assert set(port_proof.stage2_openings) == {"wa", "ra1", "ra2", "val",
                                               "inc"}
    assert set(port_proof.stage3_openings) == {"wa", "inc"}
    assert set(port_proof.stage4_openings) == {"rw_ra", "rw_val", "rw_inc",
                                               "raf_ra"}
    assert set(port_proof.stage5_openings) == {"ra", "inc", "oc_ra",
                                               "oc_inc"}
    assert set(port_proof.stage5i_openings) == (
        {f"ra{i}" for i in range(16)} | {"raf_flag"}
        | {f"flag_{n}" for n in tLT.TABLE_NAMES})
    assert set(port_proof.stage6_openings) == {
        "ra", "flags_ra", "shift_ra", "raf_wa", "raf_ra1", "raf_ra2"}
    assert port_proof.stage6v_polys == [] == list(
        port_proof.stage6v_openings)


@pytest.fixture(scope="module")
def wide():
    """The fib guest with a 2 KiB input region: RAM log K = 9, so stage 6v
    has four d = 2 instances (the port alone)."""
    src = FIB.replace(str(L.output_start), str(WIDE.output_start)).replace(
        str(L.termination), str(WIDE.termination))
    trace = t_trace_program(src, layout=WIDE)
    return trace, jt.prove_prefix(trace, device=CPU)


def test_wide_stage6v_verifies(wide):
    trace, proof = wide
    assert proof.ram_log_K == 9 and proof.bytecode_log_K <= 8
    assert len(proof.stage6v_polys) == trace.log_T
    assert set(proof.stage6v_openings) == {
        f"ram_ra_{t}_{i}" for t in range(4) for i in range(2)}
    assert jt.verify_prefix(proof, jt.PublicIO.from_trace(trace))


@pytest.mark.parametrize("part", ["polys", "openings"])
def test_wide_stage6v_rejects_tampering(wide, part):
    trace, proof = wide
    bad = copy.deepcopy(proof)
    if part == "polys":
        bad.stage6v_polys[3][1] = (bad.stage6v_polys[3][1] + 1) % P
    else:
        bad.stage6v_openings["ram_ra_2_0"] = (
            bad.stage6v_openings["ram_ra_2_0"] + 1) % P
    with pytest.raises(jt.VerificationError, match="stage6v"):
        jt.verify_prefix(bad, jt.PublicIO.from_trace(trace))


def test_verify_prefix_accepts(port_proof, fib):
    assert jt.verify_prefix(port_proof, jt.PublicIO.from_trace(fib[1]))


@pytest.mark.parametrize("stage", STAGES[:-1])
def test_verify_prefix_rejects_tampered_round_poly(port_proof, fib, stage):
    bad = copy.deepcopy(port_proof)
    poly = getattr(bad, f"stage{stage}_polys")[2]
    poly[0] = (poly[0] + 1) % P
    with pytest.raises(jt.VerificationError, match=f"stage{stage}"):
        jt.verify_prefix(bad, jt.PublicIO.from_trace(fib[1]))


@pytest.mark.parametrize("stage,key", [(2, "val"), (2, "inc"), (3, "wa"),
                                       (4, "rw_val"), (4, "raf_ra"),
                                       (5, "ra"), (5, "oc_inc"),
                                       ("5i", "ra3"), ("5i", "flag_And"),
                                       ("5i", "raf_flag"), ("6", "ra"),
                                       ("6", "flags_ra"), ("6", "raf_ra1")])
def test_verify_prefix_rejects_tampered_opening(port_proof, fib, stage, key):
    bad = copy.deepcopy(port_proof)
    openings = getattr(bad, f"stage{stage}_openings")
    openings[key] = (openings[key] + 1) % P
    with pytest.raises(jt.VerificationError, match=f"stage{stage}"):
        jt.verify_prefix(bad, jt.PublicIO.from_trace(fib[1]))


# ---- the whole proof: stages 7 and 8, the codec, the JAX verifier -------

def test_prove_fields(port_proof, fib):
    labels = (["reg_wa", "reg_ra1", "reg_ra2", "ram_ra0", "bc_ra0"]
              + [f"lk_ra{i}" for i in range(16)])
    assert set(port_proof.stage7_openings) == {
        f"{kind}_{lab}" for kind in ("bool", "ham") for lab in labels}
    assert len(port_proof.stage7_polys) == 8 + fib[1].log_T
    assert len(port_proof.stage8_polys) == 8 + fib[1].log_T
    assert port_proof.commitments == {} == port_proof.opening_proofs
    assert port_proof.advice_openings == {}
    assert [e["stage"] for e in port_proof.fs_tape[-2:]] == [
        "stage7-booleanity", "stage8-reduction"]


def test_proof_decodes_and_verifies_in_jax(port_proof, fib):
    decoded, statement = jproof_io.deserialize_proof(
        proof_io.serialize_proof(port_proof, {"outputs": b"\x01"}))
    assert statement == {"outputs": b"\x01"}
    assert decoded.stage8_openings == port_proof.stage8_openings
    assert j_verify(decoded, JPublicIO.from_trace(fib[0]))


def test_verify_accepts(port_proof, fib):
    assert jt.verify(port_proof, jt.PublicIO.from_trace(fib[1]))


@pytest.mark.parametrize("stage", [7, 8])
@pytest.mark.parametrize("part", ["polys", "openings"])
def test_verify_rejects_tampered_stage(port_proof, fib, stage, part):
    bad = copy.deepcopy(port_proof)
    if part == "polys":
        poly = getattr(bad, f"stage{stage}_polys")[5]
        poly[1] = (poly[1] + 1) % P
    elif stage == 7:
        bad.stage7_openings["bool_lk_ra3"] = (
            bad.stage7_openings["bool_lk_ra3"] + 1) % P
    else:
        bad.stage8_openings[4] = (bad.stage8_openings[4] + 1) % P
    with pytest.raises(jt.VerificationError, match=f"stage{stage}"):
        jt.verify(bad, jt.PublicIO.from_trace(fib[1]))


def test_codec_round_trips_port_and_jax_bytes(port_proof):
    blob = proof_io.serialize_proof(port_proof)
    again, _ = proof_io.deserialize_proof(blob)
    assert proof_io.serialize_proof(again) == blob
    # bytes the JAX codec wrote (from its own decode of the port's bytes)
    jax_blob = jproof_io.serialize_proof(jproof_io.deserialize_proof(blob)[0])
    assert jax_blob == blob
    assert proof_io.serialize_proof(
        proof_io.deserialize_proof(jax_blob)[0]) == jax_blob


# ---- witness and relation helpers, one by one ---------------------------

def test_register_log_matches_jax(fib):
    want = extract_register_log(fib[0])
    got = t_extract_register_log(fib[1])
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, f.name


def test_lt_evals_matches_jax():
    point = _rand_vals(5, 11)
    got = tops.unpack_ints(tlt.evals(point, CPU))
    assert got == jops.unpack_ints(jlt.evals(point))
    assert got[:5] == [tlt.lt_int(x, point) for x in range(5)]
    x = _rand_vals(5, 12)
    assert tlt.lt_point_int(x, point) == jlt.lt_point_int(x, point)
    assert tlt.lt_int(7, point) == jlt.lt_int(7, point)


def test_bind_low_matches_jax():
    vals, r = _rand_vals(64, 13), _rand_vals(1, 14)[0]
    got = tdense.bind_low(tops.pack_ints(vals, CPU), tops.pack_ints([r], CPU))
    want = jdense.bind_low(jops.pack_ints(vals), jops.pack_ints([r]))
    assert tops.unpack_ints(got) == jops.unpack_ints(want)


def test_evaluate_matches_jax():
    vals, point = _rand_vals(16, 15), _rand_vals(4, 16)
    assert (tdense.evaluate(tops.pack_ints(vals, CPU), point)
            == jdense.evaluate(jops.pack_ints(vals), point))


def test_zeros_ones_match_jax():
    for shape in [(3,), (2, 4)]:
        for t, j in ((tops.zeros(shape, CPU), jops.zeros(shape)),
                     (tops.ones(shape, CPU), jops.ones(shape))):
            assert t.shape[1:] == tuple(j.shape[1:])
            assert torch.equal(t, from_jax_limbs(np.asarray(j), CPU))


def _port_sched(ram):
    return trs.RamPairSchedule(ram.cols, ram.pre, ram.post, ram.K,
                               device=CPU)


@pytest.mark.parametrize("stream", ["ram", "registers"])
def test_pair_schedule_matches_jax(fib, stream):
    """Every round's device tensors equal the JAX schedule's arrays."""
    if stream == "ram":
        ram_j, ram_t = extract_ram_log(fib[0]), t_extract_ram_log(fib[1])
        want = jrs.RamPairSchedule(ram_j.cols, ram_j.pre, ram_j.post,
                                   ram_j.K)
        got = _port_sched(ram_t)
    else:
        log_j, log_t = extract_register_log(fib[0]), t_extract_register_log(
            fib[1])
        want = jrs.RamPairSchedule(log_j.cols, log_j.prev, log_j.post, 128,
                                   rows=log_j.rows, T=log_j.T)
        got = trs.RamPairSchedule(log_t.cols, log_t.prev, log_t.post, 128,
                                  rows=log_t.rows, T=log_t.T, device=CPU)
    assert len(got.rounds) == len(want.rounds) == got.log_T
    for g, w in zip(got.rounds, want.rounds):
        for name in ("even_src", "odd_src", "has_e", "has_o", "rows"):
            np.testing.assert_array_equal(getattr(g, name).numpy(),
                                          np.asarray(getattr(w, name)))
        np.testing.assert_array_equal(g.cols, w.cols)
        assert g.n_real == w.n_real
        for name in ("imp_e", "imp_o"):
            assert torch.equal(getattr(g, name), from_jax_limbs(
                np.asarray(getattr(w, name)), CPU))
    np.testing.assert_array_equal(got.final_cols_dev.numpy(), want.final_cols)
    assert torch.equal(got.initial_val(),
                       from_jax_limbs(np.asarray(want.initial_val()), CPU))


def test_rw_cycle_message_matches_jax(fib):
    """One RAM read/write cycle-round message on the fib schedule."""
    ram_j, ram_t = extract_ram_log(fib[0]), t_extract_ram_log(fib[1])
    sj = jrs.RamPairSchedule(ram_j.cols, ram_j.pre, ram_j.post, ram_j.K)
    st = _port_sched(ram_t)
    rng = random.Random(17)
    point = [rng.randrange(P) for _ in range(st.log_T)]
    g = rng.randrange(P)
    rj, rt = sj.rounds[0], st.rounds[0]
    want = jrs._rw_cycle_message(
        jops.ones((sj.n_entries0,)), sj.initial_val(), jeq.evals(point),
        jops.pack_ints(ram_j.inc), rj.even_src, rj.odd_src, rj.has_e,
        rj.has_o, rj.imp_e, rj.imp_o, rj.rows, jops.pack_ints([1 + g]),
        jops.pack_ints([g]))
    got = trs._rw_cycle_message(
        tops.ones((st.n_entries0,), CPU), st.initial_val(),
        teq.evals(point, CPU), tops.pack_ints(ram_t.inc, CPU), rt.even_src,
        rt.odd_src, rt.has_e, rt.has_o, rt.imp_e, rt.imp_o, rt.rows,
        (1 + g) % P, g)
    assert got.shape == (8, 3, 1)
    assert tops.unpack_ints(got.reshape(8, -1)) == jops.unpack_ints(
        want.reshape(want.shape[0], -1))


# ---- stages 5i, 6 and 6v: the device modules, one by one ------------------

def _ints(t: torch.Tensor):
    return tops.unpack_ints(t.reshape(t.shape[0], -1))


def _jints(a):
    return jops.unpack_ints(a.reshape(a.shape[0], -1))


@pytest.mark.parametrize("lead", [(), (3,)])
def test_segment_sum_mod_matches_jax(lead):
    n, segs = 200, 11
    vals = _rand_vals(n * int(np.prod(lead, dtype=int)), 21)
    ids = np.random.default_rng(22).integers(0, segs, n)
    got = tops.segment_sum_mod(
        tops.pack_ints(vals, CPU).reshape((8,) + lead + (n,)),
        torch.from_numpy(ids), segs)
    want = jops.segment_sum_mod(
        jops.pack_ints(vals).reshape((-1,) + lead + (n,)),
        jnp.asarray(ids.astype(np.int32)), segs)
    assert got.shape == (8,) + lead + (segs,)
    assert _ints(got) == _jints(want)
    rows = np.asarray(vals, dtype=object).reshape(-1, n)
    assert _ints(got) == [sum(row[ids == s]) % P for row in rows
                          for s in range(segs)]


# ---- the instruction read-raf's device work -----------------------------

def _lookup_instances(T=64, seed=5):
    """The JAX package's and the port's `InstructionReadRaf` on one
    synthetic witness (every table family, the raf identity path and
    no-table rows), with seeded gamma, r_cycle and claims."""
    wit, _, _, _ = _synthetic_witness(T, seed)
    gamma, *r_cycle = _rand_vals(1 + T.bit_length() - 1, seed + 1)
    claims = _rand_vals(3, seed + 2)
    j = jir.InstructionReadRaf(wit, gamma, r_cycle, *claims)
    t = tir.InstructionReadRaf(wit, gamma, r_cycle, *claims, device=CPU)
    return j, t


@pytest.mark.parametrize("phase", [0, 5])
def test_suffix_tables_match_jax(phase):
    """One phase's suffix tables Q (and the running u column it folds)
    equal the JAX package's, after the same finished-phase tables."""
    j, t = _lookup_instances()
    if phase:
        tabs = [_rand_vals(256, 30 + p) for p in range(phase)]
        j.v_done, t.v_done = list(tabs), list(tabs)
        j._init_phase(phase)
        t._init_phase(phase)
    assert t._pre_used == j._pre_used
    assert t.QP == j.QP and t.QP
    assert tops.unpack_ints(t.u_dev) == jops.unpack_ints(j.u_dev)


@pytest.mark.parametrize("nf", [18, 3])
def test_stack_message_matches_jax(nf):
    T = 16
    vals = _rand_vals(nf * T, 40 + nf)
    got = tproduct.stack_message(
        tops.pack_ints(vals, CPU).reshape(8, nf, T), nf)
    want = jir._cycle_message_kernel(
        jops.pack_ints(vals).reshape((-1, nf, T)), nf)
    assert got.shape == (8, nf, 1)
    assert _ints(got) == _jints(want)


def test_flag_claims_match_jax():
    j, _ = _lookup_instances()
    r = _rand_vals(6, 50)
    tid = j.wit.table_ids_np + 1
    inter = j.wit.inter_np.astype(np.int32)
    flags, raf = jir._flag_claims_kernel(
        jeq.evals(r), jnp.asarray(tid.astype(np.int32)), jnp.asarray(inter))
    got = tir._flag_claims(teq.evals(r, CPU),
                           torch.from_numpy(tid.astype(np.int64)),
                           torch.from_numpy(inter.astype(np.int64)))
    assert _ints(got) == _jints(flags) + _jints(raf)


# ---- stage 6v: ra virtualization ----------------------------------------

def _ra_virtual_case(seed=60, T=32, log_K=12):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 1 << log_K, T)
    r_cyc = _rand_vals(T.bit_length() - 1, seed + 1)
    r_addr = _rand_vals(log_K, seed + 2)
    e_cyc = jir.host_eq_evals(r_cyc)
    e_addr = jir.host_eq_evals(r_addr)
    claim = sum(e * e_addr[k] for e, k in zip(e_cyc, idx)) % P
    return idx, r_cyc, r_addr, claim, log_K


def _prove_ra_virtual(pkg, idx, r_cyc, r_addr, claim, log_K):
    chunks = jrv.chunk_streams(idx, log_K)
    if pkg == "jax":
        inst = jrv.RaVirtual(chunks, log_K, r_cyc, r_addr, claim, ("ram_ra", 1))
        tr, acc, batched = JTranscript(b"ra6v"), JAcc(), JBatched
    else:
        inst = trv.RaVirtual(chunks, log_K, r_cyc, r_addr, claim,
                             ("ram_ra", 1), device=CPU)
        tr, acc, batched = TTranscript(b"ra6v"), TAcc(), TBatched
    tr.append_scalar(b"prior", 12345)             # a copied transcript
    polys, r = batched.prove([inst], acc, tr)
    return inst, polys, r, acc, tr


def test_ra_virtual_matches_jax():
    case = _ra_virtual_case()
    assert trv.d_chunks(case[-1]) == 2
    j, jp, jr, jacc, jtr = _prove_ra_virtual("jax", *case)
    t, tp, tr_, tacc, ttr = _prove_ra_virtual("torch", *case)
    assert tp == jp and tr_ == jr
    assert t.final_openings == j.final_openings
    assert tacc.openings == jacc.openings
    assert ttr.state == jtr.state
    assert (trv.chunk_streams(case[0], 12)[0]
            == jrv.chunk_streams(case[0], 12)[0]).all()
    assert [trv.block_point(case[2], 12, i) for i in range(2)] == [
        jrv.block_point(case[2], 12, i) for i in range(2)]


@pytest.mark.parametrize("tamper", [None, "poly", "opening"])
def test_ra_virtual_verifier(tamper):
    """The port's verifier accepts the port's stage-6v sumcheck and rejects
    it with a tampered round polynomial or chunk opening."""
    idx, r_cyc, r_addr, claim, log_K = _ra_virtual_case(seed=70)
    inst, polys, _, _, _ = _prove_ra_virtual("torch", idx, r_cyc, r_addr,
                                             claim, log_K)
    polys, chunk_ops = copy.deepcopy(polys), list(inst.final_openings)
    if tamper == "poly":
        polys[2][1] = (polys[2][1] + 1) % P
    elif tamper == "opening":
        chunk_ops[1] = (chunk_ops[1] + 1) % P
    tr = TTranscript(b"ra6v")
    tr.append_scalar(b"prior", 12345)
    ver = trv.RaVirtualVerifier(len(r_cyc), log_K, r_cyc, claim, chunk_ops)
    if tamper is None:
        TBatched.verify(polys, [ver], TAcc(), tr)
    else:
        with pytest.raises(SumcheckError):
            TBatched.verify(polys, [ver], TAcc(), tr)


def test_ra_virtual_four_factors_verifies():
    """A space of three chunks (log K = 17: four factors) runs on the
    stacked K1 message instead of K2; the port's verifier accepts it."""
    idx, r_cyc, r_addr, claim, log_K = _ra_virtual_case(seed=90, T=16,
                                                        log_K=17)
    inst, polys, _, _, _ = _prove_ra_virtual("torch", idx, r_cyc, r_addr,
                                             claim, log_K)
    assert inst.d == 3 and inst._rounds is None
    assert all(len(p) == 4 for p in polys)
    tr = TTranscript(b"ra6v")
    tr.append_scalar(b"prior", 12345)
    ver = trv.RaVirtualVerifier(len(r_cyc), log_K, r_cyc, claim,
                                inst.final_openings)
    TBatched.verify(polys, [ver], TAcc(), tr)


# ---- stage 6: one-hot x public-table sumchecks on the fib trace ---------

@pytest.mark.parametrize("which", ["bytecode", "registers_raf"])
def test_sparse_onehot_table_eval_matches_jax(fib, which):
    tr, pt = fib
    T = tr.padded_length
    zeros = np.zeros(T, dtype=np.uint64)
    r_cycle = _rand_vals(tr.log_T, 80)
    gamma = _rand_vals(1, 81)[0]
    if which == "bytecode":
        bj, bt = extract_bytecode_witness(tr), t_extract_bytecode_witness(pt)
        stream, K, log_K = bj.pc_idx, bj.K, bj.log_K
        tab_j = jrs.combined_table_dev(bj.table, bj.entry, K, gamma)
        tab_t = trs.combined_table_dev(bt.table, bt.entry, K, gamma,
                                       device=CPU)
        t_stream, key = bt.pc_idx, "ra"
    else:
        stream = extract_register_log(tr).rs1_eff
        t_stream = t_extract_register_log(pt).rs1_eff
        K, log_K, key = 128, 7, "m"
        tab_j, tab_t = jrs.index_table(K), trs.index_table(K, CPU)
    assert torch.equal(tab_t, from_jax_limbs(np.asarray(tab_j), CPU))
    tab = jops.unpack_ints(tab_j)
    e = jir.host_eq_evals(r_cycle)
    claim = sum(w * tab[k] for w, k in zip(e, stream)) % P
    oid = ("bytecode", "ra")
    j = jrs.SparseOneHotTableEval(
        jrs.RamPairSchedule(stream, zeros, zeros, K), log_K, tab_j, r_cycle,
        claim, oid, opening_key=key)
    t = trs.SparseOneHotTableEval(
        trs.RamPairSchedule(t_stream, zeros, zeros, K, device=CPU), log_K,
        tab_t, r_cycle, claim, oid, opening_key=key)
    jtr, ttr = JTranscript(b"s6"), TTranscript(b"s6")
    jacc, tacc = JAcc(), TAcc()
    jp, jr = JBatched.prove([j], jacc, jtr)
    tp, tr_ = TBatched.prove([t], tacc, ttr)
    assert tp == jp and tr_ == jr
    assert t.final_openings == j.final_openings
    assert tacc.openings == jacc.openings and ttr.state == jtr.state


# ---- witness --------------------------------------------------------------

def test_instruction_lookup_witness_matches_jax(fib):
    tr, pt = fib
    want = extract_instruction_lookup_witness(tr, extract_r1cs_inputs(tr))
    got = t_extract_lookup_witness(pt, t_extract_r1cs_inputs(pt))
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, f.name
    assert tLT.TABLE_NAMES == jir.LT.TABLE_NAMES
