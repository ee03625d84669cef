"""The torch port's committed-image mode (`prove(committed_image=True)`,
`jolt_tpu_torch/relations/program_image.py`) against the JAX package's, on
the CPU.

  * `image_words`, `shifted_eq_table` and `eval_shifted_eq` give the JAX
    package's values; `ProgramImageReduction` (a `DenseOpening` on K2's
    plain version with the shifted-eq slice as its first factor) gives the
    JAX package's round polynomials, opening and transcript, and its
    verifier twin accepts.
  * The guest of the JAX package's `tests/test_program_image.py` (it reads
    its own code through RAM): the port's proof carries the image claim
    and the stage-7 image opening, round-trips through the JAX codec, and
    both packages' `verify` accept it and reject a tampered image claim or
    image opening.
  * With a 2^6 Dory setup, both verifiers recompute the trusted image
    commitment and reject a swapped one before any sumcheck; the port's
    commitment cache keys on the setup's identity (`setup_digest`).
  * fib (which never reads its code, so its 2^5 RAM addresses do not hold
    the image at index 33) is refused with the committed image: the JAX
    package's own verifier rejects its proof of it at stage 7 (ROADMAP C2).
"""

import copy
import dataclasses
import random

import pytest
import torch

from jolt_tpu import proof_io as jproof_io
from jolt_tpu.pcs.dory import DorySetup as JDorySetup
from jolt_tpu.pcs.scheme import make_scheme as j_make_scheme
from jolt_tpu.relations import program_image as jpi
from jolt_tpu.riscv.emulator import MemoryLayout as JaxLayout
from jolt_tpu.sumcheck.engine import BatchedSumcheck as JBatched
from jolt_tpu.sumcheck.engine import OpeningAccumulator as JAcc
from jolt_tpu.tracer import trace_program as j_trace_program
from jolt_tpu.transcript import Blake2bTranscript as JTranscript
from jolt_tpu.verifier import VerificationError as JVerificationError
from jolt_tpu.verifier import verify as j_verify
from jolt_tpu.verifier.verifier import PublicIO as JPublicIO

import jolt_tpu_torch as jt
from jolt_tpu_torch import proof_io
from jolt_tpu_torch.pcs import dory as tdory
from jolt_tpu_torch.pcs.scheme import make_scheme
from jolt_tpu_torch.prover.prover import committed_poly_names
from jolt_tpu_torch.relations import program_image as tpi
from jolt_tpu_torch.riscv.emulator import MemoryLayout
from jolt_tpu_torch.sumcheck.engine import BatchedSumcheck as TBatched
from jolt_tpu_torch.sumcheck.engine import OpeningAccumulator as TAcc
from jolt_tpu_torch.tracer import trace_program
from jolt_tpu_torch.transcript import Blake2bTranscript as TTranscript
from jolt_tpu_torch.verifier import verifier as tverifier
from test_program_image import GUEST, L
from test_zk_prove import FIB

# One intra-op thread: the suite runs in several worker processes, and
# torch's default of a thread per core in each oversubscribes the CPU.
torch.set_num_threads(1)

P = tpi.P
CPU = "cpu"


def test_image_helpers_match_jax():
    rng = random.Random(3)
    for code in (b"", bytes(range(24)), rng.randbytes(200)):
        assert tpi.image_words(code) == jpi.image_words(code)
    ell, m = 10, 5
    r = [rng.randrange(P) for _ in range(ell)]
    rho = [rng.randrange(P) for _ in range(m)]
    for start in (0, 24, 37, (1 << ell) - 20, 1 << ell):
        assert (tpi.shifted_eq_table(r, start, m)
                == jpi.shifted_eq_table(r, start, m))
        assert (tpi.eval_shifted_eq(r, start, rho)
                == jpi.eval_shifted_eq(r, start, rho))


def test_image_reduction_matches_jax():
    rng = random.Random(4)
    words = [rng.randrange(1 << 64) for _ in range(16)]
    r_addr = [rng.randrange(P) for _ in range(10)]
    start = 37
    claim = sum(t * w for t, w in zip(
        tpi.shifted_eq_table(r_addr, start, 4), words)) % P
    out = {}
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            inst = jpi.ProgramImageReduction(words, r_addr, start, claim)
            tr, acc, batched = JTranscript(b"pi"), JAcc(), JBatched
        else:
            inst = tpi.ProgramImageReduction(words, r_addr, start, claim,
                                             device=CPU)
            tr, acc, batched = TTranscript(b"pi"), TAcc(), TBatched
        polys, r = batched.prove([inst], acc, tr)
        out[pkg] = (polys, r, inst.final_openings, acc.openings, tr.state)
    assert out["torch"] == out["jax"]
    polys, _, fin, openings, _ = out["torch"]
    assert list(openings) == [("program_image", "init")]
    ver = tpi.ProgramImageReductionVerifier(4, r_addr, start, claim,
                                            fin["p"])
    TBatched.verify(polys, [ver], TAcc(), TTranscript(b"pi"))


@pytest.fixture(scope="module")
def image():
    """The port's trace and committed-image proof of the guest on the CPU,
    and the JAX package's trace of it (its public statement)."""
    layout = dataclasses.asdict(L)
    trace = trace_program(GUEST, layout=MemoryLayout(**layout))
    jax_tr = j_trace_program(GUEST, layout=JaxLayout(**layout))
    return trace, jt.prove(trace, committed_image=True, device=CPU), jax_tr


def test_image_proof_verifies_in_both_packages(image):
    trace, proof, jax_tr = image
    assert proof.config["committed_program_image"] == 1
    assert proof.program_image_claim is not None
    assert "program_image_init" in proof.stage7_openings
    assert jt.verify(proof, jt.PublicIO.from_trace(trace))
    assert jt.verify_prefix(proof, jt.PublicIO.from_trace(trace))
    blob = proof_io.serialize_proof(proof)
    decoded, _ = jproof_io.deserialize_proof(blob)
    assert decoded.program_image_claim == proof.program_image_claim
    assert jproof_io.serialize_proof(decoded) == blob
    ported, _ = proof_io.deserialize_proof(blob)
    assert proof_io.serialize_proof(ported) == blob
    assert j_verify(decoded, JPublicIO.from_trace(jax_tr))


@pytest.mark.parametrize("verifier", ["torch", "jax"])
@pytest.mark.parametrize("field", ["claim", "opening"])
def test_image_tampering_is_rejected(image, verifier, field):
    trace, proof, jax_tr = image
    bad = copy.deepcopy(proof)
    if field == "claim":
        bad.program_image_claim = (bad.program_image_claim + 1) % P
    else:
        bad.stage7_openings["program_image_init"] = (
            bad.stage7_openings["program_image_init"] + 1) % P
    if verifier == "torch":
        with pytest.raises(jt.VerificationError):
            jt.verify(bad, jt.PublicIO.from_trace(trace))
    else:
        decoded, _ = jproof_io.deserialize_proof(
            proof_io.serialize_proof(bad))
        with pytest.raises(JVerificationError):
            j_verify(decoded, JPublicIO.from_trace(jax_tr))


@pytest.fixture(scope="module")
def setups6(tmp_path_factory):
    return (tdory.DorySetup.generate(
                6, cache_dir=str(tmp_path_factory.mktemp("port_srs"))),
            JDorySetup.generate(
                6, cache_dir=str(tmp_path_factory.mktemp("jax_srs"))))


@pytest.mark.parametrize("verifier", ["torch", "jax"])
def test_image_commitment_swap_is_rejected(image, setups6, verifier):
    """With a setup the verifier absorbs the commitments, then compares the
    image commitment with the one it recomputes from the public program:
    a swapped commitment fails there, the right one passes that check and
    fails later (this proof was made without a setup)."""
    trace, proof, jax_tr = image
    port_setup, jax_setup = setups6
    right = make_scheme(port_setup, CPU).commit(
        "program_image", tpi.image_words(trace.code))
    names = committed_poly_names(1, 1, (), True)
    errors = []
    for image_c in (make_scheme(port_setup, CPU).commit("x", [1, 2, 3, 4]),
                    right):
        bad = copy.deepcopy(proof)
        bad.commitments = {n: right for n in names}
        bad.commitments["program_image"] = image_c
        if verifier == "torch":
            with pytest.raises(jt.VerificationError) as e:
                jt.verify(bad, jt.PublicIO.from_trace(trace),
                          setup=port_setup)
        else:
            decoded, _ = jproof_io.deserialize_proof(
                proof_io.serialize_proof(bad))
            with pytest.raises(JVerificationError) as e:
                j_verify(decoded, JPublicIO.from_trace(jax_tr),
                         setup=jax_setup)
        errors.append(str(e.value))
    assert "program_image commitment" in errors[0]
    assert "program_image commitment" not in errors[1]


def test_trusted_commitment_cache(setups6, tmp_path):
    """The verifier's recomputed image commitment equals the JAX
    package's, is cached per (program, setup) and recomputed for another
    setup."""
    port_setup, jax_setup = setups6
    code = bytes(range(64)) * 2
    tverifier._PI_COMMIT_CACHE.clear()
    s_a = make_scheme(port_setup, CPU)
    got_a = tverifier._program_image_commitment(s_a, code)
    want = j_make_scheme(jax_setup).commit("x", jpi.image_words(code))
    assert tdory.gt_to_bytes(got_a.c) == tdory.gt_to_bytes(want.c)
    assert tverifier._program_image_commitment(s_a, code) is got_a
    s_b = make_scheme(tdory.DorySetup.generate(7, cache_dir=str(tmp_path)),
                      CPU)
    assert s_b.setup_digest() != s_a.setup_digest()
    got_b = tverifier._program_image_commitment(s_b, code)
    assert got_b.c != got_a.c
    assert len(tverifier._PI_COMMIT_CACHE) == 2


def test_image_outside_ram_is_refused():
    trace = trace_program(FIB, layout=MemoryLayout(**dataclasses.asdict(L)),
                          min_padded=32)
    with pytest.raises(NotImplementedError, match="ROADMAP C2"):
        jt.prove(trace, committed_image=True, device=CPU)
