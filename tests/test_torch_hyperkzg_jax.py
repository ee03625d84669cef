"""The torch port's whole proof with a HyperKZG setup against the JAX
package's, byte for byte, on the CPU (slow tier).

On the guest of the JAX package's `tests/test_full_pipeline_pcs.py`
(min_padded=32, `KZGSetup.generate(256 * 32)`): the port's
`prove(trace, setup=..., device="cpu")` and `jolt_tpu.prove(trace,
setup=...)` give the same proof bytes (commitments and the HyperKZG
opening included) and the same FS tape (JOLT_TPU_FS_TRACE) from
stage0-commit through stage8-openings; the port's and the JAX package's
`verify` accept the port's proof, and the port's rejects a tampered
commitment.  The JAX package's `msm_pippenger` at N = 512 equals the
port's plain one by affine point.  Slow tier: the JAX package's KZG
setup, prove and Python MSMs take minutes on this CPU.
"""

import copy
import dataclasses
import json
import random

import numpy as np
import pytest

from jolt_tpu import proof_io as jproof_io
from jolt_tpu.curve import g1 as jg1
from jolt_tpu.pcs import KZGSetup as JKZGSetup
from jolt_tpu.prover import prove as j_prove
from jolt_tpu.riscv.emulator import MemoryLayout as JaxLayout
from jolt_tpu.tracer import trace_program
from jolt_tpu.verifier import verify as j_verify
from jolt_tpu.verifier.verifier import PublicIO as JPublicIO

import jolt_tpu_torch as jt
from jolt_tpu_torch import proof_io
from jolt_tpu_torch.curve import bn254_host as host
from jolt_tpu_torch.curve import g1
from jolt_tpu_torch.pcs.hyperkzg import KZGSetup
from test_full_pipeline_pcs import GUEST, L
from test_torch_stage1 import _port_trace

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


@pytest.fixture(scope="module")
def kzg_proofs(tmp_path_factory, monkeypatch_module):
    """The guest proven with the 256 x 32 KZG setup by the JAX package
    (with its FS tape) and by the port on the CPU."""
    jax_tr = trace_program(GUEST, layout=JaxLayout(**dataclasses.asdict(L)),
                           min_padded=32)
    tmp = tmp_path_factory.mktemp("kzg")
    tape = tmp / "tape.json"
    n = 256 * jax_tr.padded_length
    jsetup = JKZGSetup.generate(n, cache_dir=str(tmp / "jax_srs"))
    monkeypatch_module.setenv("JOLT_TPU_FS_TRACE", str(tape))
    jax_proof = j_prove(jax_tr, setup=jsetup)
    monkeypatch_module.delenv("JOLT_TPU_FS_TRACE")
    setup = KZGSetup.generate(n, device="cpu",
                              cache_dir=str(tmp / "port_srs"))
    trace = _port_trace(jax_tr)
    port_proof = jt.prove(trace, setup=setup, device="cpu")
    statement = {"outputs": bytes(jax_tr.device.outputs)}
    return (port_proof, jax_proof, json.loads(tape.read_text()), statement,
            trace, jax_tr, setup, jsetup)


def test_kzg_proof_bytes_match_jax(kzg_proofs):
    port_proof, jax_proof, _, statement, *_ = kzg_proofs
    assert port_proof.opening_proofs and port_proof.commitments
    assert (proof_io.serialize_proof(port_proof, statement)
            == jproof_io.serialize_proof(jax_proof, statement))


def test_kzg_fs_tape_matches_jax(kzg_proofs):
    port_proof, _, jax_tape, *_ = kzg_proofs
    assert [e["stage"] for e in jax_tape][0] == "witness-extraction"
    assert port_proof.fs_tape == jax_tape[1:]
    assert [e["stage"] for e in port_proof.fs_tape][::11] == [
        "stage0-commit", "stage8-openings"]


def test_both_verifiers_accept_the_ports_proof(kzg_proofs):
    port_proof, _, _, statement, trace, jax_tr, setup, jsetup = kzg_proofs
    assert jt.verify(port_proof, jt.PublicIO.from_trace(trace), setup=setup)
    decoded, _ = jproof_io.deserialize_proof(
        proof_io.serialize_proof(port_proof, statement))
    assert j_verify(decoded, JPublicIO.from_trace(jax_tr), setup=jsetup)


def test_tampered_commitment_is_rejected(kzg_proofs):
    port_proof, _, _, _, trace, _, setup, _ = kzg_proofs
    bad = copy.deepcopy(port_proof)
    bad.commitments["inc"] = host.g1_add(bad.commitments["inc"], host.G1_GEN)
    with pytest.raises(jt.VerificationError):
        jt.verify(bad, jt.PublicIO.from_trace(trace), setup=setup)


def test_msm_pippenger_matches_jax():
    n = 512
    rng = random.Random(8)
    pts = [host.g1_random(rng) for _ in range(n)]
    ks = [rng.randrange(host.R) for _ in range(n)]
    words = np.array([[(k >> (32 * w)) & 0xFFFFFFFF for k in ks]
                      for w in range(8)], dtype=np.uint32)
    want = jg1.unpack_points(jg1.msm_pippenger(jg1.pack_points(pts), words,
                                               254))
    got = g1.unpack_points(g1.msm_pippenger(g1.pack_points(pts, "cpu"),
                                            words, 254))
    assert got == want == [host.g1_msm_pippenger(pts, ks)]
