"""The torch port's full `prove` / `verify` (stages 1-8 at `setup=None`),
its stage-7/8 modules and its proof codec, on the CPU.

  * A fib guest that reads its count from a trusted advice region and its
    seeds from an untrusted one: the port proves it (advice openings in
    stage 5, their dense entries in stage 8) and both the port's verifier
    and the JAX package's (after the JAX codec decodes the port's bytes)
    accept it; a tampered or missing advice opening is rejected.
  * `GroupedOneHot` (booleanity, and the value kind with one and with
    three members) and `DenseOpening` on seeded inputs at T = 2^6 give the
    JAX package's round polynomials, openings and transcript, and the
    port's verifier twins accept them.
  * The codec: a proof holding every point type (G1, G2, GT, Dory and
    HyperKZG proofs, a BlindFold proof) written by the JAX codec decodes in
    the port and re-encodes to the same bytes, and back.
  * With a Dory setup (`DorySetup.generate(13)`, the guest of the JAX
    package's `tests/test_full_pipeline_dory.py`): the port's `verify`
    accepts the proof, the JAX codec decodes it and the JAX package's
    `verify` accepts it with the JAX package's own setup, `setup="dory"`
    sizes the same setup and gives the same proof, and a tampered
    commitment or opening is rejected.
  * `prove(setup="hyperkzg")` sizes a KZG setup and its proof verifies;
    `prove` refuses zk with the committed image, naming the ROADMAP
    item.

The fib proof itself (no advice) is held against the JAX package in
`test_torch_prefix.py` (fields of stages 1-6v, JAX decode and verify,
tamper tests of stages 7 and 8) and byte for byte in the slow
`test_torch_prove_jax.py`.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from jolt_tpu import proof_io as jproof_io
from jolt_tpu.curve import bn254_host as jhost
from jolt_tpu.curve.fq_tower import Fq2 as JFq2, Fq6 as JFq6, Fq12 as JFq12
from jolt_tpu.curve.pairing import G2_GEN as J_G2_GEN
from jolt_tpu.field import ops as jops
from jolt_tpu.poly import eq as jeq
from jolt_tpu.relations import grouped_onehot as jgo
from jolt_tpu.relations import opening_reduction as jor
from jolt_tpu.riscv.emulator import MemoryLayout as JaxLayout
from jolt_tpu.sumcheck.engine import BatchedSumcheck as JBatched
from jolt_tpu.sumcheck.engine import OpeningAccumulator as JAcc
from jolt_tpu.tracer import trace_program as j_trace_program
from jolt_tpu.transcript import Blake2bTranscript as JTranscript
from jolt_tpu.verifier import verify as j_verify
from jolt_tpu.verifier.verifier import PublicIO as JPublicIO

import jolt_tpu_torch as jt
from jolt_tpu_torch import proof_io
from jolt_tpu_torch.pcs.dory import DoryCommitment, DorySetup
from jolt_tpu_torch.poly import eq as teq
from jolt_tpu_torch.prover.prover import committed_poly_names
from jolt_tpu_torch.relations import grouped_onehot as tgo
from jolt_tpu_torch.relations import opening_reduction as tor
from jolt_tpu_torch.riscv.emulator import MemoryLayout
from jolt_tpu_torch.sumcheck.engine import BatchedSumcheck as TBatched
from jolt_tpu_torch.sumcheck.engine import OpeningAccumulator as TAcc
from jolt_tpu_torch.sumcheck.engine import SumcheckError
from jolt_tpu_torch.tracer import trace_program
from jolt_tpu_torch.transcript import Blake2bTranscript as TTranscript
from test_torch_stage1 import _rand_vals

# One intra-op thread: the suite runs in several worker processes, and
# torch's default of a thread per core in each oversubscribes the CPU.
torch.set_num_threads(1)

P = jops.FR.modulus
CPU = "cpu"

ADVICE = MemoryLayout(max_input_size=64, max_output_size=64,
                      max_trusted_advice_size=32,
                      max_untrusted_advice_size=16)
TRUSTED = (20).to_bytes(8, "little") + bytes(24)
UNTRUSTED = (0).to_bytes(8, "little") + (1).to_bytes(8, "little")
# fib(n) with n from the trusted region and the seeds from the untrusted one
FIB_ADVICE = f"""
    li   t0, {ADVICE.trusted_advice_start}
    ld   a0, 0(t0)
    li   t0, {ADVICE.untrusted_advice_start}
    ld   a1, 0(t0)
    ld   a2, 8(t0)
loop:
    beq  a0, zero, done
    add  a3, a1, a2
    mv   a1, a2
    mv   a2, a3
    addi a0, a0, -1
    j    loop
done:
    li   t0, {ADVICE.output_start}
    sd   a1, 0(t0)
    li   t1, {ADVICE.termination}
    li   t2, 1
    sd   t2, 0(t1)
"""


@pytest.fixture(scope="module")
def advice():
    """The port's trace and proof of the advice fib, and the JAX
    package's trace of the same guest (its public statement)."""
    trace = trace_program(FIB_ADVICE, layout=ADVICE, trusted_advice=TRUSTED,
                          untrusted_advice=UNTRUSTED)
    assert int.from_bytes(bytes(trace.device.outputs[:8]), "little") == 6765
    jax_tr = j_trace_program(
        FIB_ADVICE, layout=JaxLayout(**dataclasses.asdict(ADVICE)),
        trusted_advice=TRUSTED, untrusted_advice=UNTRUSTED)
    return trace, jt.prove(trace, device=CPU), jax_tr


def test_advice_proof_verifies_in_both_packages(advice):
    trace, proof, jax_tr = advice
    assert set(proof.advice_openings) == {"trusted", "untrusted"}
    assert jt.verify(proof, jt.PublicIO.from_trace(trace))
    blob = proof_io.serialize_proof(proof)
    decoded, _ = jproof_io.deserialize_proof(blob)
    assert decoded.advice_openings == proof.advice_openings
    assert j_verify(decoded, JPublicIO.from_trace(jax_tr))


@pytest.mark.parametrize("change", ["tampered", "missing"])
def test_advice_opening_change_is_rejected(advice, change):
    trace, proof, _ = advice
    bad = copy.deepcopy(proof)
    if change == "tampered":
        bad.advice_openings["trusted"] = (
            bad.advice_openings["trusted"] + 1) % P
    else:
        bad.advice_openings = {}
    with pytest.raises(jt.VerificationError):
        jt.verify(bad, jt.PublicIO.from_trace(trace))


def test_advice_prefix_verifies(advice):
    """`verify_prefix` checks the advice openings' stage-5 role too."""
    trace, proof, _ = advice
    assert jt.verify_prefix(proof, jt.PublicIO.from_trace(trace))


# ---- the whole prover with a Dory setup -----------------------------------

DORY_LAYOUT = MemoryLayout(max_input_size=64, max_output_size=64)
# the JAX package's Dory pipeline guest (tests/test_full_pipeline_dory.py)
DORY_GUEST = f"""
    li   a1, 21
    li   a2, 34
    add  a3, a1, a2
    xor  a4, a1, a2
    and  a5, a3, a4
    add  a3, a3, a5
    li   t0, {DORY_LAYOUT.output_start}
    sd   a3, 0(t0)
    li   t1, {DORY_LAYOUT.termination}
    li   t2, 1
    sd   t2, 0(t1)
"""


@pytest.fixture(scope="module")
def dory_srs_dir(tmp_path_factory):
    """The port's setup cache of the Dory tests."""
    return str(tmp_path_factory.mktemp("port_srs"))


@pytest.fixture(scope="module")
def dory(dory_srs_dir):
    """The port's trace, setup (13 variables: 256 x 32, nu = 6, sigma = 7)
    and proof of the guest on the CPU."""
    trace = trace_program(DORY_GUEST, layout=DORY_LAYOUT, min_padded=32)
    setup = DorySetup.generate(13, cache_dir=dory_srs_dir)
    return trace, setup, jt.prove(trace, setup=setup, device=CPU)


def test_dory_proof_verifies_in_both_packages(dory, tmp_path):
    from jolt_tpu.pcs.dory import DorySetup as JDorySetup
    trace, setup, proof = dory
    assert (setup.nu, setup.sigma) == (6, 7)
    assert set(proof.commitments) == set(committed_poly_names(1, 1))
    assert all(isinstance(c, DoryCommitment)
               for c in proof.commitments.values())
    assert [e["stage"] for e in proof.fs_tape][0] == "stage0-commit"
    assert proof.fs_tape[-1]["stage"] == "stage8-openings"
    assert jt.verify(proof, jt.PublicIO.from_trace(trace), setup=setup)
    blob = proof_io.serialize_proof(proof)
    decoded, _ = jproof_io.deserialize_proof(blob)
    jax_tr = j_trace_program(DORY_GUEST, layout=JaxLayout(
        **dataclasses.asdict(DORY_LAYOUT)), min_padded=32)
    assert j_verify(decoded, JPublicIO.from_trace(jax_tr),
                    setup=JDorySetup.generate(13, cache_dir=str(tmp_path)))


def test_prove_sizes_the_named_dory_setup(dory, dory_srs_dir, monkeypatch):
    """`prove(setup="dory")` takes the setup the trace needs (13 variables
    here, from the port's cache) and gives the proof that passing that
    setup gives."""
    from jolt_tpu_torch.pcs import dory as tdory
    trace, setup, proof = dory
    monkeypatch.setattr(tdory, "SRS_CACHE_DIR", dory_srs_dir)
    named = jt.prove(trace, setup="dory", device=CPU)
    assert (proof_io.serialize_proof(named)
            == proof_io.serialize_proof(proof))
    assert named.fs_tape == proof.fs_tape
    assert jt.verify(named, jt.PublicIO.from_trace(trace), setup=setup)


@pytest.mark.parametrize("change", ["commitment", "opening", "proof",
                                    "no_setup"])
def test_dory_tampering_is_rejected(dory, change):
    """A tampered commitment, stage-8 opening or joint opening proof fails
    the joint Dory check; without the setup the commitments are not
    absorbed, so the transcript (and stage 1) diverges."""
    trace, setup, proof = dory
    bad = copy.deepcopy(proof)
    if change == "commitment":
        c = bad.commitments["inc"].c
        bad.commitments["inc"] = DoryCommitment(c=c * c)
    elif change == "opening":
        bad.stage8_openings[0] = (bad.stage8_openings[0] + 1) % P
    elif change == "proof":
        bad.opening_proofs["joint"].b_final_s = (
            bad.opening_proofs["joint"].b_final_s + 1) % P
    with pytest.raises(jt.VerificationError):
        jt.verify(bad, jt.PublicIO.from_trace(trace),
                  setup=None if change == "no_setup" else setup)


# ---- stage 7/8 modules against the JAX package -------------------------

T_MOD = 1 << 6


def _onehot_case(M, K, seed, booleanity, points=True):
    rng = np.random.default_rng(seed)
    streams = [rng.integers(0, K, T_MOD) for _ in range(M)]
    log_K = K.bit_length() - 1
    r_cyc = _rand_vals(6, seed + 1)
    q = _rand_vals(log_K, seed + 2) if points else None
    gamma = _rand_vals(1, seed + 3)[0]
    e_cyc = [int(v) for v in jops.unpack_ints(jeq.evals(r_cyc))]
    e_addr = ([int(v) for v in jops.unpack_ints(jeq.evals(q))] if points
              else [1] * K)
    claims = ([0] * M if booleanity else
              [sum(e_cyc[j] * e_addr[s[j]] for j in range(T_MOD)) % P
               for s in streams])
    return streams, K, r_cyc, q, claims, gamma


def _prove_onehot(pkg, streams, K, r_cyc, q, claims, gamma, booleanity):
    M = len(streams)
    labels = [f"m{i}" for i in range(M)]
    if pkg == "jax":
        inst = jgo.GroupedOneHot(streams, K, [jeq.evals(r_cyc)] * M,
                                 [q] * M, claims, gamma, labels,
                                 booleanity=booleanity, opening_kind="t")
        tr, acc, batched = JTranscript(b"s78"), JAcc(), JBatched
    else:
        inst = tgo.GroupedOneHot(streams, K, teq.evals(r_cyc, CPU), [q] * M,
                                 claims, gamma, labels,
                                 booleanity=booleanity, opening_kind="t")
        tr, acc, batched = TTranscript(b"s78"), TAcc(), TBatched
    tr.append_scalar(b"prior", 4242)              # a copied transcript
    polys, r = batched.prove([inst], acc, tr)
    return inst, polys, r, acc, tr


@pytest.mark.parametrize("M,K,booleanity,points", [
    (3, 16, True, True),      # booleanity, stage 7
    (3, 8, False, True),      # value kind, several members (V_c on K2)
    (1, 32, False, True),     # value kind, one member (A w on K2)
    (2, 16, False, False),    # Hamming weight, no address point
])
def test_grouped_onehot_matches_jax(M, K, booleanity, points):
    case = _onehot_case(M, K, 100 + M + K, booleanity, points)
    j, jp, jr, jacc, jtr = _prove_onehot("jax", *case, booleanity)
    t, tp, tr_, tacc, ttr = _prove_onehot("torch", *case, booleanity)
    assert tp == jp and tr_ == jr
    assert t.final_openings == j.final_openings
    assert tacc.openings == jacc.openings
    assert ttr.state == jtr.state
    # the port's verifier twin accepts the port's sumcheck, and rejects a
    # tampered round polynomial
    streams, K, r_cyc, q, claims, gamma = case
    for tamper in (False, True):
        polys = copy.deepcopy(tp)
        if tamper:
            polys[3][0] = (polys[3][0] + 1) % P
        ver = tgo.GroupedOneHotVerifier(
            M, K.bit_length() - 1, 6,
            [lambda rc: teq.eq_int(r_cyc, rc)] * M, [q] * M, claims, gamma,
            t.final_openings, booleanity=booleanity)
        vtr = TTranscript(b"s78")
        vtr.append_scalar(b"prior", 4242)
        if tamper:
            with pytest.raises(SumcheckError):
                TBatched.verify(polys, [ver], TAcc(), vtr)
        else:
            TBatched.verify(polys, [ver], TAcc(), vtr)


def test_dense_opening_matches_jax():
    coeffs = _rand_vals(T_MOD, 200)
    point = _rand_vals(6, 201)
    claim = sum(c * e for c, e in zip(
        coeffs, jops.unpack_ints(jeq.evals(point)))) % P
    out = {}
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            inst = jor.DenseOpening(coeffs, point, claim, "d")
            tr, acc, batched = JTranscript(b"s8"), JAcc(), JBatched
        else:
            inst = tor.DenseOpening(coeffs, point, claim, "d", device=CPU)
            tr, acc, batched = TTranscript(b"s8"), TAcc(), TBatched
        polys, r = batched.prove([inst], acc, tr)
        out[pkg] = (polys, r, inst.final_openings, acc.openings, tr.state)
    assert out["torch"] == out["jax"]
    polys, r, fin, _, _ = out["torch"]
    ver = tor.OpeningReductionVerifier(6, point, claim, fin["p"])
    TBatched.verify(polys, [ver], TAcc(), TTranscript(b"s8"))
    assert tor.embedding_factor(r, 4) == jor.embedding_factor(r, 4)
    assert (tor.cycle_major_to_address_major_point(point, 4)
            == jor.cycle_major_to_address_major_point(point, 4))
    assert (tor.onehot_address_major([3, 0, 2], 4)
            == jor.onehot_address_major([3, 0, 2], 4))


# ---- the proof codec ---------------------------------------------------

def _jax_pcs_proof():
    """A JAX `JoltProof` holding every codec type: G1 points (and the
    point at infinity), G2 points, GT elements, Dory and HyperKZG proofs
    and a BlindFold proof (values are valid encodings, not a real proof)."""
    from jolt_tpu.blindfold.prove import BlindFoldProof
    from jolt_tpu.pcs.dory import DoryCommitment, DoryProof
    from jolt_tpu.pcs.hyperkzg import HyperKZGProof
    from jolt_tpu.prover.prover import JoltProof
    g = [jhost.g1_mul(jhost.G1_GEN, k) for k in (3, 5, 7, 11)]
    gt = [JFq12(JFq6(*[JFq2(k + 6 * i, k + 6 * i + 1) for i in range(3)]),
                JFq6(*[JFq2(k + 6 * i + 2, k * i + 3) for i in range(3)]))
          for k in (1, 2)]
    dory = DoryProof(g[0], gt, gt[:1], [], gt, gt[1:], gt, None, J_G2_GEN,
                     g[1:3], [None, g[3]], [1, P - 1], [2], 5)
    kzg = HyperKZGProof(g[:2], [[1, 2, 3]], g[2:])
    bf = BlindFoldProof([g[0]], 7, [g[1]], [], [g[2]], [[1, 2]], 3, 4, 5,
                        [[6]], [7, 8], 9, [10], 11, 2, 3)
    return JoltProof(
        trace_length=5, padded_length=256, stage1_uniskip=[1, 2],
        stage1_polys=[[3, P - 1]], r1cs_input_openings=[1],
        shift_polys=[[4]], shift_opening=P - 2, stage2_polys=[],
        stage2_openings={"wa": 5}, stage3_polys=[], stage3_openings={},
        stage4_polys=[], stage4_openings={}, stage5_polys=[],
        stage5_openings={}, ram_log_K=8, stage5i_polys=[],
        stage5i_openings={}, stage6_polys=[], stage6_openings={},
        stage6_claims=[6], bytecode_log_K=7, stage6v_polys=[],
        stage6v_openings={}, stage7_polys=[[7, 8, 9]],
        stage7_openings={"bool_x": 3}, stage8_polys=[], stage8_openings=[10],
        commitments={"wa": DoryCommitment(gt[0])},
        opening_proofs={"joint": dory, "kzg": kzg},
        advice_openings={"trusted": 9},
        zk_commitments={"s1": [b"\x01" * 64]}, zk_blindfold=bf,
        config={"log_k_chunk": 8}, program_image_claim=12)


def test_codec_round_trips_jax_bytes_with_every_point_type():
    blob = jproof_io.serialize_proof(_jax_pcs_proof(), {"outputs": b"\x07"})
    proof, statement = proof_io.deserialize_proof(blob)
    assert statement == {"outputs": b"\x07"}
    assert type(proof.opening_proofs["joint"]).__module__ == \
        "jolt_tpu_torch.pcs.dory"
    assert proof_io.serialize_proof(proof, statement) == blob
    again, _ = jproof_io.deserialize_proof(
        proof_io.serialize_proof(proof, statement))
    assert jproof_io.serialize_proof(again, statement) == blob


def test_codec_rejects_bad_bytes():
    blob = jproof_io.serialize_proof(_jax_pcs_proof())
    with pytest.raises(proof_io.ProofDecodeError):
        proof_io.deserialize_proof(bytes([blob[0] + 1]) + blob[1:])
    with pytest.raises(proof_io.ProofDecodeError):
        proof_io.deserialize_proof(blob + b"\x00")


# ---- entry points --------------------------------------------------------

@pytest.mark.parametrize("kwargs,item", [
    ({"zk": True, "committed_image": True}, "C1")])
def test_prove_refuses_what_is_not_ported(kwargs, item):
    """zk together with the committed image is refused before any work,
    since the JAX package's verifier rejects its own proof of the two
    (ROADMAP C1)."""
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        jt.prove(None, device=CPU, **kwargs)


def test_prove_accepts_the_named_hyperkzg_setup(tmp_path, monkeypatch):
    """`prove(setup="hyperkzg", device="cpu")` sizes a KZG setup from the
    trace (2^13 powers for the Dory guest at 32 cycles), commits and opens
    with HyperKZG, carries a `HyperKZGProof` under
    `opening_proofs["joint"]`, and `verify` accepts it with that setup."""
    from jolt_tpu_torch.pcs import hyperkzg as thkzg
    monkeypatch.setattr(thkzg, "SRS_CACHE_DIR", str(tmp_path))
    trace = trace_program(DORY_GUEST, layout=DORY_LAYOUT, min_padded=32)
    proof = jt.prove(trace, setup="hyperkzg", device=CPU)
    assert isinstance(proof.opening_proofs["joint"], thkzg.HyperKZGProof)
    assert set(proof.commitments) == set(committed_poly_names(1, 1))
    assert proof.fs_tape[-1]["stage"] == "stage8-openings"
    assert trace.padded_length == 32
    setup = thkzg.KZGSetup.generate(1 << 13, device=CPU)
    assert [p.name for p in tmp_path.iterdir()] == [
        f"kzg_torch_{1 << 13}_{thkzg.DEFAULT_TAU % 997_651}.npz"]
    assert jt.verify(proof, jt.PublicIO.from_trace(trace), setup=setup)
