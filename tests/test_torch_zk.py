"""The torch port's zero-knowledge mode (`prove(zk=True)`, BlindFold) on
the CPU, held against the JAX package's verifier and codec.

The guest is the fib of the JAX package's `tests/test_zk_prove.py`
(`min_padded=32`), proven by the port with `zk_rng=random.Random(42)`:

  * every batched stage's round polynomials are replaced by Pedersen
    commitments (`zk_commitments`, one per round, under the JAX package's
    stage labels) and one BlindFold proof follows; the uni-skip polynomial
    and the opening claims stay in the clear; the FS tape ends with the
    BlindFold proof's transcript state;
  * the proof round-trips through the port's codec and the JAX codec, and
    both packages' `verify` accept it;
  * both verifiers reject the tampering cases of the JAX package's
    `tests/test_zk_prove.py` (a round commitment swapped for another
    stage's, a changed BlindFold proof, a missing BlindFold proof);
  * `verify_prefix` refuses a zk proof, whose round checks only BlindFold
    attests.

The byte equality of the port's zk proof with the JAX package's is the
slow tier's (`test_torch_zk_jax.py`).
"""

import copy
import dataclasses
import random

import pytest
import torch

from jolt_tpu import proof_io as jproof_io
from jolt_tpu.riscv.emulator import MemoryLayout as JaxLayout
from jolt_tpu.tracer import trace_program as j_trace_program
from jolt_tpu.verifier import VerificationError as JVerificationError
from jolt_tpu.verifier import verify as j_verify
from jolt_tpu.verifier.verifier import PublicIO as JPublicIO

import jolt_tpu_torch as jt
from jolt_tpu_torch import proof_io
from jolt_tpu_torch.riscv.emulator import MemoryLayout
from jolt_tpu_torch.tracer import trace_program
from test_zk_prove import FIB, L

# One intra-op thread: the suite runs in several worker processes, and
# torch's default of a thread per core in each oversubscribes the CPU.
torch.set_num_threads(1)

P = jt.prover.prover.P
CPU = "cpu"
# the batched stages of fib's proof (its RAM and bytecode spaces fit one
# chunk, so it has no stage-6v instance)
LABELS = ["s1", "s1s", "s2", "s3", "s4", "s5", "s5i", "s6", "s7", "s8"]


@pytest.fixture(scope="module")
def zk():
    """The port's trace and zk proof of fib, the JAX package's trace of
    fib, and the proof as the JAX codec decodes the port's bytes."""
    layout = dataclasses.asdict(L)
    trace = trace_program(FIB, layout=MemoryLayout(**layout), min_padded=32)
    jax_tr = j_trace_program(FIB, layout=JaxLayout(**layout), min_padded=32)
    proof = jt.prove(trace, zk=True, zk_rng=random.Random(42), device=CPU)
    decoded, _ = jproof_io.deserialize_proof(proof_io.serialize_proof(proof))
    return trace, proof, jax_tr, decoded


def test_zk_proof_hides_the_rounds(zk):
    _, proof, _, _ = zk
    assert sorted(proof.zk_commitments) == sorted(LABELS)
    for f in ("stage1_polys", "shift_polys", "stage2_polys", "stage3_polys",
              "stage4_polys", "stage5_polys", "stage5i_polys",
              "stage6_polys", "stage6v_polys", "stage7_polys",
              "stage8_polys"):
        assert getattr(proof, f) == []
    assert all(len(c) == 64 for cs in proof.zk_commitments.values()
               for c in cs)
    assert len(proof.stage1_uniskip) > 0 and proof.stage8_openings
    assert proof.zk_blindfold is not None
    assert [e["stage"] for e in proof.fs_tape][-2:] == ["stage8-reduction",
                                                        "blindfold"]


def test_zk_proof_verifies_in_both_packages(zk):
    trace, proof, jax_tr, decoded = zk
    assert jt.verify(proof, jt.PublicIO.from_trace(trace))
    blob = proof_io.serialize_proof(proof)
    assert jproof_io.serialize_proof(decoded) == blob
    assert decoded.zk_commitments == proof.zk_commitments
    ported, _ = proof_io.deserialize_proof(blob)
    assert proof_io.serialize_proof(ported) == blob
    assert jt.verify(ported, jt.PublicIO.from_trace(trace))
    assert j_verify(decoded, JPublicIO.from_trace(jax_tr))


def _tamper(proof, change):
    bad = copy.deepcopy(proof)
    if change == "commitment":
        # another valid point (the first round of a different stage): the
        # challenges change and BlindFold must catch the inconsistency
        bad.zk_commitments["s2"][0] = proof.zk_commitments["s3"][0]
    elif change == "blindfold":
        bad.zk_blindfold.u2 = (bad.zk_blindfold.u2 + 1) % P
    else:
        bad.zk_blindfold = None
    return bad


@pytest.mark.parametrize("verifier", ["torch", "jax"])
@pytest.mark.parametrize("change", ["commitment", "blindfold", "missing"])
def test_zk_tampering_is_rejected(zk, verifier, change):
    trace, proof, jax_tr, decoded = zk
    if verifier == "torch":
        with pytest.raises(jt.VerificationError):
            jt.verify(_tamper(proof, change), jt.PublicIO.from_trace(trace))
    else:
        with pytest.raises(JVerificationError):
            j_verify(_tamper(decoded, change), JPublicIO.from_trace(jax_tr))


def test_verify_prefix_refuses_a_zk_proof(zk):
    trace, proof, _, _ = zk
    with pytest.raises(jt.VerificationError, match="BlindFold"):
        jt.verify_prefix(proof, jt.PublicIO.from_trace(trace))
