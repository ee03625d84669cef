"""Every batched stage of the port's `prove` on the device tier
(`jolt_tpu_torch/sumcheck/fused.py`), on the CPU, where the round tail
and the kernels run their plain versions.

Each relation class that is a `FusedInstance` runs a seeded stage forced
to the device tier (`force_device`, one fetch a stage) and on the port's
host engine, and the two give the same round polynomials, challenges,
openings and transcript state; the seeded stages of stages 6v-8 also give
the JAX package's relations' on its host engine.  (The relations of
fib's schedules are held to the JAX package's on the device tier through
fib's whole prefix, in tests/test_torch_prefix.py, whose JAX prefix has
already paid the JAX package's compiles of those shapes.)  The stages:

  * s2, s3: the register read/write and Val-evaluation relations on fib's
    register log;
  * s4, s5: the RAM read/write + raf and Val-evaluation + output-check
    pairs on fib's RAM schedule (two instances sharing one schedule);
  * s6: a bytecode read-raf and a register raf (`SparseOneHotTableEval`,
    two address widths, so two round offsets);
  * s6v: two d = 2 `RaVirtual`s (log K = 12, T = 2^5);
  * s7/s8: four `GroupedOneHot`s (booleanity, Hamming weight, the value
    kind with three members and with one) at T = 2^6, a `DenseOpening`
    and a `ProgramImageReduction`, of 5 to 11 rounds.

fib's whole `prove` with stage 1 streamed (four chunks), on the host
engine and on the device tier, gives the default's bytes.
fib's whole `prove` with every slot that has the device tier forced to
it (`with_every_slot("device")`; `apply_tier` for the instances `prove`
builds directly) gives the default run's bytes, with one fetch for each of its
device-tier stages, and the JAX package's codec and `verify` accept it.
A tampered fetch of a stage of 40 instances raises
`TranscriptDivergence`; a stage of 65 instances (above K4's 64) takes the
host engine.
"""

import numpy as np
import pytest
import torch

from jolt_tpu import proof_io as jproof_io
from jolt_tpu.field import ops as jops
from jolt_tpu.poly import eq as jeq
from jolt_tpu.relations import grouped_onehot as jgo
from jolt_tpu.relations import opening_reduction as jor
from jolt_tpu.relations import program_image as jpi
from jolt_tpu.relations import ra_virtual as jrv
from jolt_tpu.sumcheck.engine import BatchedSumcheck as JBatched
from jolt_tpu.sumcheck.engine import OpeningAccumulator as JAcc
from jolt_tpu.tracer import trace_program
from jolt_tpu.transcript import Blake2bTranscript as JTranscript
from jolt_tpu.verifier import verify as j_verify
from jolt_tpu.verifier.verifier import PublicIO as JPublicIO

import jolt_tpu_torch as jt
from jolt_tpu_torch.kernels import JoltBackend, set_backend
from jolt_tpu_torch.poly import eq as teq
from jolt_tpu_torch.proof_io import serialize_proof
from jolt_tpu_torch.relations import grouped_onehot as tgo
from jolt_tpu_torch.relations import opening_reduction as tor
from jolt_tpu_torch.relations import program_image as tpi
from jolt_tpu_torch.relations import ra_virtual as trv
from jolt_tpu_torch.relations import ram_sparse as trs
from jolt_tpu_torch.sumcheck import fused
from jolt_tpu_torch.sumcheck.engine import BatchedSumcheck as TBatched
from jolt_tpu_torch.sumcheck.engine import OpeningAccumulator as TAcc
from jolt_tpu_torch.sumcheck.fused import (FusedInstance, TranscriptDivergence,
                                           device_tier, prove_fused)
from jolt_tpu_torch.transcript import Blake2bTranscript as TTranscript
from jolt_tpu_torch.utils import profiling
from jolt_tpu_torch.witness.bytecode import \
    extract_bytecode_witness as t_extract_bytecode_witness
from jolt_tpu_torch.witness.ram import extract_ram_log as t_extract_ram_log
from jolt_tpu_torch.witness.registers import \
    extract_register_log as t_extract_register_log
from test_prove_verify import FIB, L
from test_torch_prefix import _ra_virtual_case
from test_torch_prove import T_MOD, _onehot_case
from test_torch_stage1 import _port_trace, _rand_vals

torch.set_num_threads(1)

P = jops.FR.modulus
CPU = "cpu"

@pytest.fixture(scope="module")
def fib():
    tr = trace_program(FIB, layout=L)
    return tr, _port_trace(tr)


# ---- the stages, each built by either package --------------------------

def _s2(pkg, fib):
    log = t_extract_register_log(fib[1])
    r_cycle, claims = _rand_vals(fib[0].log_T, 300), _rand_vals(3, 301)
    gamma = _rand_vals(1, 302)[0]
    return [trs.SparseRegistersReadWriteChecking(log, gamma, r_cycle, claims,
                                                 device=CPU)]


def _s3(pkg, fib):
    log = t_extract_register_log(fib[1])
    r_addr, r_cyc = _rand_vals(7, 310), _rand_vals(fib[0].log_T, 311)
    claim = _rand_vals(1, 312)[0]
    return [trs.SparseRegistersValEvaluation(log, r_addr, r_cyc, claim,
                                             device=CPU)]


def _ram(fib):
    ram = t_extract_ram_log(fib[1])
    return ram, trs.RamPairSchedule(ram.cols, ram.pre, ram.post, ram.K,
                                    device=CPU)


def _s4(pkg, fib):
    ram, sched = _ram(fib)
    r_cycle = _rand_vals(fib[0].log_T, 320)
    gamma, rv, wv, addr = _rand_vals(4, 321)
    return [trs.SparseRamReadWriteChecking(sched, ram.log_K, ram.init_vals,
                                           ram.inc, gamma, r_cycle, rv, wv),
            trs.SparseRamRafEvaluation(sched, ram.log_K, ram.witness_base,
                                       r_cycle, addr)]


def _s5(pkg, fib):
    ram, sched = _ram(fib)
    r_addr = _rand_vals(ram.log_K, 330)
    r_cyc = _rand_vals(fib[0].log_T, 331)
    val_claim, z = _rand_vals(2, 332)
    return [trs.SparseRamValEvaluation(sched, ram.log_K, ram.init_vals,
                                       ram.inc, r_addr, r_cyc, val_claim),
            trs.SparseRamOutputCheck(sched, ram.log_K, ram.init_vals, ram.inc,
                                     fib[1].memory_layout, ram.witness_base,
                                     z, bytes(fib[0].device.outputs))]


def _s6(pkg, fib):
    T = fib[0].padded_length
    zeros = np.zeros(T, dtype=np.uint64)
    r_cycle = _rand_vals(fib[0].log_T, 340)
    gamma, c_bc, c_raf = _rand_vals(3, 341)
    bw = t_extract_bytecode_witness(fib[1])
    rs1 = t_extract_register_log(fib[1]).rs1_eff
    tab = trs.combined_table_dev(bw.table, bw.entry, bw.K, gamma, device=CPU)
    return [trs.SparseOneHotTableEval(
                trs.RamPairSchedule(bw.pc_idx, zeros, zeros, bw.K,
                                    device=CPU),
                bw.log_K, tab, r_cycle, c_bc, ("bytecode", "ra")),
            trs.SparseOneHotTableEval(
                trs.RamPairSchedule(rs1, zeros, zeros, 128, device=CPU), 7,
                trs.index_table(128, CPU), r_cycle, c_raf,
                ("registers_raf", "ra1"), opening_key="m")]


def _s6v(pkg, fib):
    out = []
    for t, seed in enumerate((60, 61)):
        idx, r_cyc, r_addr, claim, log_K = _ra_virtual_case(seed=seed)
        chunks = jrv.chunk_streams(idx, log_K)
        if pkg == "jax":
            out.append(jrv.RaVirtual(chunks, log_K, r_cyc, r_addr, claim,
                                     ("ram_ra", t)))
        else:
            out.append(trv.RaVirtual(chunks, log_K, r_cyc, r_addr, claim,
                                     ("ram_ra", t), device=CPU))
    return out


# the four `GroupedOneHot` cases of tests/test_torch_prove.py
ONEHOT = [(3, 16, True, True), (2, 16, False, False), (3, 8, False, True),
          (1, 32, False, True)]


def _s78(pkg, fib):
    out = []
    for k, (M, K, booleanity, points) in enumerate(ONEHOT):
        streams, K, r_cyc, q, claims, gamma = _onehot_case(
            M, K, 100 + M + K, booleanity, points)
        labels = [f"g{k}_{i}" for i in range(M)]
        if pkg == "jax":
            out.append(jgo.GroupedOneHot(
                streams, K, [jeq.evals(r_cyc)] * M, [q] * M, claims, gamma,
                labels, booleanity=booleanity, opening_kind="t"))
        else:
            out.append(tgo.GroupedOneHot(
                streams, K, teq.evals(r_cyc, CPU), [q] * M, claims, gamma,
                labels, booleanity=booleanity, opening_kind="t"))
    coeffs, point = _rand_vals(T_MOD, 200), _rand_vals(6, 201)
    words, r_addr = _rand_vals(32, 350), _rand_vals(12, 351)
    claim_d, claim_pi = _rand_vals(2, 352)
    if pkg == "jax":
        out += [jor.DenseOpening(coeffs, point, claim_d, "d"),
                jpi.ProgramImageReduction(words, r_addr, 40, claim_pi)]
    else:
        out += [tor.DenseOpening(coeffs, point, claim_d, "d", device=CPU),
                tpi.ProgramImageReduction(words, r_addr, 40, claim_pi,
                                          device=CPU)]
    return out


STAGES = {"s2": _s2, "s3": _s3, "s4": _s4, "s5": _s5, "s6": _s6,
          "s6v": _s6v, "s78": _s78}


def _fetches(prof) -> int:
    """The device tier's fetches a recording saw: the `d2h` counts of its
    `fused.fetch` spans (one a stage)."""
    return prof.tally("d2h", within="fused.fetch")


def _run(pkg, tier, build, fib):
    """One stage on a copied transcript: (polys, challenges, openings,
    transcript state, fetches made)."""
    insts = build(pkg, fib)
    if pkg == "jax":
        tr, acc, prover = JTranscript(b"stages"), JAcc(), JBatched.prove
    else:
        tr, acc = TTranscript(b"stages"), TAcc()
        prover = prove_fused if tier == "device" else TBatched.prove
        for inst in insts:
            assert isinstance(inst, FusedInstance)
            inst.force_device = tier == "device"
        assert device_tier(insts) == (tier == "device")
    tr.append_scalar(b"prior", 4242)
    with profiling.recording() as prof:
        polys, r = prover(insts, acc, tr)
    return polys, r, acc.openings, tr.state, _fetches(prof)


@pytest.mark.parametrize("stage", list(STAGES))
def test_device_tier_stage_matches_host_engine(fib, stage):
    dev = _run("torch", "device", STAGES[stage], fib)
    host = _run("torch", "host", STAGES[stage], fib)
    assert dev[4] == 1 and host[4] == 0          # one fetch on the tier
    assert dev[:4] == host[:4]


@pytest.mark.parametrize("stage", ["s6v", "s78"])
def test_device_tier_stage_matches_jax(fib, stage):
    """The seeded stages of the JAX package's own relations (those of fib's
    schedules, s2-s6, are held to the JAX package's prefix in
    tests/test_torch_prefix.py)."""
    dev = _run("torch", "device", STAGES[stage], fib)
    jax = _run("jax", "host", STAGES[stage], fib)
    assert dev[:4] == jax[:4]


# ---- fib's whole prove with every stage it can on the device tier -------

@pytest.fixture(scope="module")
def fib_proofs(fib):
    """fib's proof by default (CPU: every stage on the host engine) and
    with every device-tier slot forced to the device tier, with the
    latter's fetches."""
    default = jt.prove(fib[1], device=CPU)
    set_backend(JoltBackend.default().with_every_slot("device"))
    try:
        with profiling.recording() as prof:
            forced = jt.prove(fib[1], device=CPU)
    finally:
        set_backend(None)
    return default, forced, _fetches(prof)


def test_all_device_prove_gives_the_default_bytes(fib_proofs):
    default, forced, fetches = fib_proofs
    assert serialize_proof(forced) == serialize_proof(default)
    assert forced.fs_tape == default.fs_tape
    # fib's spaces fit one chunk, so stage 6v has no sumcheck: s1, s1s,
    # s2, s3, s4, s5, s6, s7 and s8 on the device tier, s5i on the host
    assert not forced.stage6v_polys
    assert fetches == 9


def test_all_device_proof_verifies_in_jax(fib, fib_proofs):
    proof, statement = jproof_io.deserialize_proof(
        serialize_proof(fib_proofs[1]))
    assert j_verify(proof, JPublicIO.from_trace(fib[0]))


@pytest.fixture(scope="module")
def streamed_proofs(fib):
    """fib's proof with stage 1 streamed in four chunks of 64 cycles
    (`_stream_stage1`), on the host engine and with every device-tier slot
    forced to the device tier, with the latter's fetches."""
    chunk = fib[1].padded_length // 4
    host = jt.prove(fib[1], device=CPU, _stream_stage1=chunk)
    set_backend(JoltBackend.default().with_every_slot("device"))
    try:
        with profiling.recording() as prof:
            forced = jt.prove(fib[1], device=CPU, _stream_stage1=chunk)
    finally:
        set_backend(None)
    return host, forced, _fetches(prof)


@pytest.mark.parametrize("tier", ["host", "device"])
def test_streamed_stage1_gives_the_materialized_bytes(fib_proofs,
                                                      streamed_proofs, tier):
    default = fib_proofs[0]
    proof = streamed_proofs[0 if tier == "host" else 1]
    assert serialize_proof(proof) == serialize_proof(default)
    assert proof.fs_tape == default.fs_tape
    if tier == "device":
        assert streamed_proofs[2] == fib_proofs[2] == 9


# ---- wide stages ---------------------------------------------------------

def _dense_stage(n, seed, force=True):
    """n `DenseOpening`s of 2 to 5 variables (degree 2)."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        nv = 2 + k % 4
        coeffs = [int(v) for v in rng.integers(0, 1 << 62, 1 << nv)]
        point = [int(v) for v in rng.integers(0, 1 << 62, nv)]
        inst = tor.DenseOpening(coeffs, point, int(rng.integers(1 << 62)),
                                f"d{k}", device=CPU)
        inst.force_device = force
        out.append(inst)
    return out


@pytest.mark.parametrize("rnd", [0, 3])
def test_tampered_fetch_of_a_wide_stage_raises(monkeypatch, rnd):
    n, width = 40, 2
    real = fused._fetch

    def tampered(buffers):
        host = real(buffers).copy()
        host[9 + 16 * n + rnd * width * 8 + 8] ^= 1   # coefficient 1
        return host
    monkeypatch.setattr(fused, "_fetch", tampered)
    with pytest.raises(TranscriptDivergence, match=f"at round {rnd} of 5"):
        prove_fused(_dense_stage(n, 7), TAcc(), TTranscript(b"wide"))


def test_more_than_64_instances_take_the_host_engine():
    insts = _dense_stage(65, 8)
    assert not device_tier(insts) and device_tier(insts[:64])
    acc, tr = TAcc(), TTranscript(b"wide")
    with profiling.recording() as prof:
        got = prove_fused(insts, acc, tr)
    assert _fetches(prof) == 0 and prof.tally("d2h") >= 5
    acc2, tr2 = TAcc(), TTranscript(b"wide")
    want = TBatched.prove(_dense_stage(65, 8, force=False), acc2, tr2)
    assert got == want and tr.state == tr2.state
    assert list(acc.openings.values()) == list(acc2.openings.values())
