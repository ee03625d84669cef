"""The torch port's BlindFold modules (`jolt_tpu_torch/blindfold/`) against
the JAX package's `jolt_tpu.blindfold`, on the CPU, byte for byte.

  * `PedersenBasis.create(8)` gives the JAX package's points, and
    `pedersen_commit` (on the native MSM) its commitments, zero entries and
    the point at infinity included.
  * On a seeded list of `ZkStageData` (two stages whose claim chains are
    consistent, committed under a seeded blind stream): the verifier R1CS,
    the witness, the whole `BlindFoldProof` of `blindfold_prove` under the
    same `random.Random` seed and transcript, and the transcript after it
    equal the JAX package's; the folded relaxed instance satisfies
    `check_relaxed`; both packages' `blindfold_verify` accept the proof and
    the port's rejects a tampered one.
  * `zk_prove_stage` (the engine's round loop with the committed-round
    sink) on a seeded 3-factor `ProductSumcheck` at T = 2^6 gives the JAX
    package's commitments, challenges, claims, blinds and transcript, and
    the plain engine on the same instance keeps its round polynomials.
"""

import copy
import dataclasses
import random

import pytest
import torch

from jolt_tpu.blindfold import fold as jfold
from jolt_tpu.blindfold import pedersen as jped
from jolt_tpu.blindfold import prove as jprove
from jolt_tpu.blindfold import r1cs as jr1cs
from jolt_tpu.blindfold import verify as jverify
from jolt_tpu.blindfold import zk_sumcheck as jzk
from jolt_tpu.curve import bn254_host as jhost
from jolt_tpu.poly import dense as jdense
from jolt_tpu.sumcheck.engine import OpeningAccumulator as JAcc
from jolt_tpu.sumcheck.product import ProductSumcheck as JProductSumcheck
from jolt_tpu.transcript import Blake2bTranscript as JTranscript

from jolt_tpu_torch.blindfold import fold as tfold
from jolt_tpu_torch.blindfold import pedersen as tped
from jolt_tpu_torch.blindfold import prove as tprove
from jolt_tpu_torch.blindfold import r1cs as tr1cs
from jolt_tpu_torch.blindfold import verify as tverify
from jolt_tpu_torch.blindfold import zk_sumcheck as tzk
from jolt_tpu_torch.field import ops as tops
from jolt_tpu_torch.sumcheck.engine import BatchedSumcheck
from jolt_tpu_torch.sumcheck.engine import OpeningAccumulator as TAcc
from jolt_tpu_torch.sumcheck.product import ProductSumcheck
from jolt_tpu_torch.transcript import Blake2bTranscript as TTranscript

# One intra-op thread: the suite runs in several worker processes, and
# torch's default of a thread per core in each oversubscribes the CPU.
torch.set_num_threads(1)

P = tped.P
CPU = "cpu"


def test_pedersen_matches_jax():
    rng = random.Random(11)
    tb, jb = tped.PedersenBasis.create(8), jped.PedersenBasis.create(8)
    assert (tb.G, tb.H) == (jb.G, jb.H)
    tb.extend(12)
    jb.extend(12)
    assert tb.G == jb.G
    for n in (1, 4, 12):
        vals = [rng.randrange(P) for _ in range(n)]
        vals[0] = 0                             # a zero entry
        rho = rng.randrange(P)
        assert (tped.pedersen_commit(tb, vals, rho)
                == jped.pedersen_commit(jb, vals, rho))
    # all-zero values and blind commit to the point at infinity
    assert tped.pedersen_commit(tb, [0, 0], 0) is None
    pts = [jb.G[0], None, jb.G[1]]
    assert tped.msm(pts, [3, 5, P - 1]) == jhost.g1_msm(pts, [3, 5, P - 1])
    assert tped.point_bytes(None) == jped.point_bytes(None) == bytes(64)
    assert tped.point_bytes(jb.H) == jped.point_bytes(jb.H)


def _seeded_stages(ped, zk, seed=21):
    """Two stages (3 rounds at degree 3, 4 rounds at degree 2) with random
    round polynomials and challenges, their claim chains consistent and
    each round committed with a seeded blind."""
    rng = random.Random(seed)
    basis = ped.PedersenBasis.create(8)
    stages = []
    for label, rounds, degree in (("a", 3, 3), ("b", 4, 2)):
        claim = rng.randrange(P)
        data = zk.ZkStageData(label=label, max_rounds=rounds,
                              max_degree=degree, input_claim0=claim,
                              round_coeffs=[], blinds=[], commitments=[],
                              challenges=[], claims=[claim])
        for _ in range(rounds):
            cs = [rng.randrange(P) for _ in range(degree)]   # c0, c2..cd
            r = rng.randrange(P)
            # claim_{j+1} = c0 (1 - 2r) + r claim_j + sum_k c_k (r^k - r)
            nxt = (cs[0] * (1 - 2 * r) + r * claim) % P
            for k in range(2, degree + 1):
                nxt = (nxt + cs[k - 1] * (pow(r, k, P) - r)) % P
            rho = rng.randrange(P)
            data.round_coeffs.append(cs)
            data.blinds.append(rho)
            data.commitments.append(ped.pedersen_commit(basis, cs, rho))
            data.challenges.append(r)
            data.claims.append(nxt)
            claim = nxt
        data.final_expected = claim
        stages.append(data)
    return stages, basis


def _public(stages):
    return [dataclasses.replace(s, round_coeffs=[], blinds=[], claims=[])
            for s in stages]


@pytest.fixture(scope="module")
def folded():
    """Both packages' R1CS, witness and BlindFold proof of the seeded
    stages, each with its transcript."""
    out = {}
    for pkg, ped, zk, r1cs, prove, tr in (
            ("torch", tped, tzk, tr1cs, tprove, TTranscript),
            ("jax", jped, jzk, jr1cs, jprove, JTranscript)):
        stages, basis = _seeded_stages(ped, zk)
        rc = r1cs.build_verifier_r1cs(stages)
        witness = r1cs.assign_witness(rc, stages)
        transcript = tr(b"bf-test")
        transcript.append_scalar(b"prior", 77)
        proof = prove.blindfold_prove(stages, basis, transcript,
                                      random.Random(5))
        out[pkg] = (stages, basis, rc, witness, proof, transcript)
    return out


def test_r1cs_and_witness_match_jax(folded):
    t_stages, _, t_rc, t_w, _, _ = folded["torch"]
    j_stages, _, j_rc, j_w, _, _ = folded["jax"]
    assert [dataclasses.asdict(s) for s in t_stages] == \
        [dataclasses.asdict(s) for s in j_stages]
    assert dataclasses.asdict(t_rc) == dataclasses.asdict(j_rc)
    assert (t_rc.m, t_rc.grid_rows, t_rc.grid_cols) == (16, 16, 4)
    assert t_w == j_w
    z = [1] + t_w
    zero = [0] * t_rc.m
    assert tr1cs.matvec(t_rc.A, t_rc.m, z) == jr1cs.matvec(j_rc.A, j_rc.m, z)
    assert tr1cs.check_relaxed(t_rc, z, 1, zero)
    bad = list(z)
    bad[1 + t_rc.claim_idx[(0, 1)]] += 1        # break one chain link
    assert not tr1cs.check_relaxed(t_rc, bad, 1, zero)


def test_fold_matches_jax_and_stays_satisfied(folded):
    _, _, rc, w1, _, _ = folded["torch"]
    rng = random.Random(8)
    u2 = rng.randrange(P)
    z2 = [u2] + [rng.randrange(P) for _ in w1]
    z1 = [1] + w1
    e2 = tfold.error_of(rc, z2, u2)
    t = tfold.cross_term(rc, z1, 1, z2, u2)
    assert e2 == jfold.error_of(rc, z2, u2)
    assert t == jfold.cross_term(rc, z1, 1, z2, u2)
    r = rng.randrange(P)
    zf = tfold.fold_vectors(z1, z2, r)
    assert zf == jfold.fold_vectors(z1, z2, r)
    ef = [(r * a + r * r * b) % P for a, b in zip(t, e2)]
    assert tr1cs.check_relaxed(rc, zf, zf[0], ef)


def test_blindfold_proof_matches_jax(folded):
    *_, t_proof, t_tr = folded["torch"]
    *_, j_proof, j_tr = folded["jax"]
    assert dataclasses.asdict(t_proof) == dataclasses.asdict(j_proof)
    assert (t_tr.state, t_tr.n_rounds) == (j_tr.state, j_tr.n_rounds)


@pytest.mark.parametrize("tamper", [None, "w_comb", "az", "coeff_comm"])
def test_blindfold_verify(folded, tamper):
    """Both verifiers accept the port's proof; the port's rejects a
    tampered opening row, claim or round commitment."""
    stages, _, _, _, proof, _ = folded["torch"]
    pub = _public(stages)
    proof = copy.deepcopy(proof)
    if tamper == "w_comb":
        proof.w_comb[0] = (proof.w_comb[0] + 1) % P
    elif tamper == "az":
        proof.az_r = (proof.az_r + 1) % P
    elif tamper == "coeff_comm":
        pub[0].commitments[0] = jhost.g1_mul(pub[0].commitments[0], 2)

    def transcript(cls):
        t = cls(b"bf-test")
        t.append_scalar(b"prior", 77)
        return t
    if tamper is None:
        assert tverify.blindfold_verify(pub, proof, tped.PedersenBasis.create(
            8), transcript(TTranscript))
        assert jverify.blindfold_verify(_public(folded["jax"][0]), proof,
                                        jped.PedersenBasis.create(8),
                                        transcript(JTranscript))
    else:
        with pytest.raises(tverify.BlindFoldError):
            tverify.blindfold_verify(pub, proof, tped.PedersenBasis.create(8),
                                     transcript(TTranscript))


def _zk_stage(pkg, ints, seed):
    if pkg == "jax":
        inst = JProductSumcheck([jdense.from_ints(v) for v in ints])
        acc, tr, basis, zk = JAcc(), JTranscript(b"zk"), \
            jped.PedersenBasis.create(8), jzk
    else:
        inst = ProductSumcheck([tops.pack_ints(v, CPU) for v in ints])
        acc, tr, basis, zk = TAcc(), TTranscript(b"zk"), \
            tped.PedersenBasis.create(8), tzk
    tr.append_scalar(b"prior", 4242)
    data, rs = zk.zk_prove_stage([inst], acc, tr, basis, random.Random(seed),
                                 "s")
    return data, rs, inst.final_claims, (tr.state, tr.n_rounds)


def test_zk_prove_stage_matches_jax():
    rng = random.Random(31)
    ints = [[rng.randrange(P) for _ in range(1 << 6)] for _ in range(3)]
    t_data, t_rs, t_fin, t_tr = _zk_stage("torch", ints, 3)
    j_data, j_rs, j_fin, j_tr = _zk_stage("jax", ints, 3)
    assert (t_data.max_rounds, t_data.max_degree) == (6, 3)
    assert dataclasses.asdict(t_data) == dataclasses.asdict(j_data)
    assert (t_rs, t_fin, t_tr) == (j_rs, j_fin, j_tr)
    # the recorded rounds satisfy the verifier R1CS's round checks
    t_data.final_expected = t_data.claims[-1]
    rc = tr1cs.build_verifier_r1cs([t_data])
    assert tr1cs.check_relaxed(rc, [1] + tr1cs.assign_witness(rc, [t_data]),
                               1, [0] * rc.m)
    # the same instance on the plain sink sends the polynomials in clear
    inst = ProductSumcheck([tops.pack_ints(v, CPU) for v in ints])
    tr = TTranscript(b"zk")
    tr.append_scalar(b"prior", 4242)
    polys, rs = BatchedSumcheck.prove([inst], TAcc(), tr)
    assert len(polys) == 6 and rs != t_rs
    assert [p + [0] * (3 - len(p)) for p in polys][0] == \
        t_data.round_coeffs[0]
