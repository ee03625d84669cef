"""The torch port's whole fib proof against the JAX package's, byte for
byte, on the CPU (slow tier).

`jolt_tpu_torch.prove(fib, device="cpu")` and the JAX package's stages 1-8
(`test_torch_stage1._jax_prefix(..., last="stage8-reduction")`: `prove`'s
order at `setup=None`, stage 8 on the host engine as `prove` runs it on
the CPU) must give equal stage-7 and stage-8 fields, equal FS-tape states
after both stages, and `proof_io.serialize_proof` bytes equal to the JAX
codec's bytes of the JAX package's `JoltProof`.  Slow tier because the
JAX package's stage-7/8 compiles for fib cost 82 s cold on this CPU (the
fast tier checks the same proof with the JAX package's verifier,
`test_torch_prefix.py`).

With a Dory setup, the guest of the JAX package's
`tests/test_full_pipeline_dory.py`: the port's `prove(trace, setup=...)`
on the CPU and `jolt_tpu.prove(trace, setup=...)` give the same proof
bytes (the commitments and the joint opening proof included), and the
port's FS tape equals the JAX package's (JOLT_TPU_FS_TRACE) from
stage0-commit through stage8-openings.
"""

import json

import pytest

from jolt_tpu import proof_io as jproof_io
from jolt_tpu.pcs.dory import DorySetup as JDorySetup
from jolt_tpu.prover import prove as j_prove
from jolt_tpu.tracer import trace_program

import jolt_tpu_torch as jt
from jolt_tpu_torch import proof_io
from jolt_tpu_torch.pcs.dory import DorySetup
from test_prove_verify import FIB, L
from test_torch_prove import DORY_GUEST, DORY_LAYOUT
from test_torch_stage1 import _jax_prefix, _jax_proof, _port_trace

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def fib():
    tr = trace_program(FIB, layout=L)
    return tr, _port_trace(tr)


@pytest.fixture(scope="module")
def jax_full(fib):
    return _jax_prefix(fib[0], last="stage8-reduction")


@pytest.fixture(scope="module")
def port_proof(fib):
    return jt.prove(fib[1], device="cpu")


@pytest.mark.parametrize("field", ["stage7_polys", "stage7_openings",
                                   "stage8_polys", "stage8_openings"])
def test_stage78_field_matches_jax(port_proof, jax_full, field):
    assert getattr(port_proof, field) == jax_full[field]


@pytest.mark.parametrize("i,stage", [(8, "stage7-booleanity"),
                                     (9, "stage8-reduction")])
def test_stage78_fs_tape_matches_jax(port_proof, jax_full, i, stage):
    assert port_proof.fs_tape[i]["stage"] == stage
    assert port_proof.fs_tape[i] == jax_full["fs_tape"][i]


def test_proof_bytes_match_jax(port_proof, jax_full, fib):
    statement = {"outputs": bytes(fib[0].device.outputs)}
    assert (proof_io.serialize_proof(port_proof, statement)
            == jproof_io.serialize_proof(_jax_proof(fib[0], jax_full),
                                         statement))


@pytest.fixture(scope="module")
def dory_proofs(tmp_path_factory, monkeypatch_module):
    """The same guest proven with a 13-variable Dory setup by the port (on
    the CPU) and by the JAX package, with the JAX package's FS tape."""
    from jolt_tpu.riscv.emulator import MemoryLayout as JaxLayout
    import dataclasses
    jax_tr = trace_program(DORY_GUEST, layout=JaxLayout(
        **dataclasses.asdict(DORY_LAYOUT)), min_padded=32)
    tmp = tmp_path_factory.mktemp("dory")
    tape = tmp / "tape.json"
    monkeypatch_module.setenv("JOLT_TPU_FS_TRACE", str(tape))
    jax_proof = j_prove(jax_tr, setup=JDorySetup.generate(
        13, cache_dir=str(tmp / "jax_srs")))
    monkeypatch_module.delenv("JOLT_TPU_FS_TRACE")
    port_proof = jt.prove(_port_trace(jax_tr), setup=DorySetup.generate(
        13, cache_dir=str(tmp / "port_srs")), device="cpu")
    statement = {"outputs": bytes(jax_tr.device.outputs)}
    return (port_proof, jax_proof, json.loads(tape.read_text()), statement)


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


def test_dory_proof_bytes_match_jax(dory_proofs):
    port_proof, jax_proof, _, statement = dory_proofs
    assert port_proof.opening_proofs and port_proof.commitments
    assert (proof_io.serialize_proof(port_proof, statement)
            == jproof_io.serialize_proof(jax_proof, statement))


def test_dory_fs_tape_matches_jax(dory_proofs):
    port_proof, _, jax_tape, _ = dory_proofs
    # the JAX tape's first entry marks witness extraction, before the
    # transcript exists
    assert [e["stage"] for e in jax_tape][0] == "witness-extraction"
    assert port_proof.fs_tape == jax_tape[1:]
    assert [e["stage"] for e in port_proof.fs_tape][::11] == [
        "stage0-commit", "stage8-openings"]


def test_dory_k3_route_proof_bytes_match_native(fib, tmp_path):
    """The fib proof with a 2^16 Dory setup (256 x 256): the K3 route (the
    route of a CUDA Dory; here on CPU tensors, K3's plain versions) gives
    the native route's `serialize_proof` bytes and FS tape, and verifies."""
    from jolt_tpu_torch.pcs.scheme import DoryScheme
    from jolt_tpu_torch.prover.prover import required_num_vars
    trace = fib[1]
    setup = DorySetup.generate(
        required_num_vars(trace.padded_length, 0, 0),
        cache_dir=str(tmp_path))
    native = jt.prove(trace, setup=setup, device="cpu")
    k3 = jt.prove(trace, setup=DoryScheme(setup, "cpu", _k3=True),
                  device="cpu")
    assert (setup.nu, setup.sigma) == (8, 8)
    assert proof_io.serialize_proof(k3) == proof_io.serialize_proof(native)
    assert k3.fs_tape == native.fs_tape
    assert jt.verify(k3, jt.PublicIO.from_trace(trace), setup=setup)
