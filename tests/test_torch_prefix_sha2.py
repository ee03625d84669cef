"""The torch port's whole proof of the main path's guest against the JAX
package, on the CPU: the sha2-chain at chain=1 (3447 cycles, padded 2^12),
traced by each package's own tracer (the port's native one), proved by
`jolt_tpu_torch.prove(..., device="cpu")` and by the JAX package's stage
functions through stage 8 (`test_torch_stage1._jax_prefix`).  Every proof
field, every FS-tape entry and the `proof_io.serialize_proof` bytes must be
equal, and the port's `verify` and the JAX package's must accept.  Its
RAM and bytecode spaces (log K 13 and 12) are two 8-bit chunks each, so
stage 6v batches seven ra-virtualization instances of three factors (the
fib trace of the fast tier has none), and stages 7 and 8 see K = 32 and
K = 16 chunk matrices beside the 128- and 256-row ones.

Slow tier: the JAX package compiles its round functions anew for this
trace shape, several minutes on this CPU; the fast tier holds the fib trace
to the same comparison (`test_torch_prefix.py`).
"""

import dataclasses

import pytest

from jolt_tpu import proof_io as jproof_io
from jolt_tpu.riscv.emulator import MemoryLayout as JaxLayout
from jolt_tpu.tracer import trace_program
from jolt_tpu.verifier import verify as j_verify
from jolt_tpu.verifier.verifier import PublicIO as JPublicIO

import jolt_tpu_torch as jt
from jolt_tpu_torch import proof_io, workload
from test_torch_stage1 import _jax_prefix, _jax_proof

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def traces():
    layout = workload.sha2_chain_layout()
    src = workload.sha2_chain_source(layout, 1)
    jax_tr = trace_program(src, layout=JaxLayout(**dataclasses.asdict(layout)),
                           inputs=workload.SHA2_INPUT)
    return jax_tr, workload.sha2_chain_trace(1)


@pytest.fixture(scope="module")
def jax_prefix(traces):
    return _jax_prefix(traces[0], last="stage8-reduction")


@pytest.fixture(scope="module")
def port_proof(traces):
    return jt.prove(traces[1], device="cpu")


@pytest.mark.parametrize("field", [
    "stage1_uniskip", "stage1_polys", "r1cs_input_openings", "shift_polys",
    "shift_opening", "stage2_polys", "stage2_openings", "stage3_polys",
    "stage3_openings", "stage4_polys", "stage4_openings", "stage5_polys",
    "stage5_openings", "stage5i_polys", "stage5i_openings", "stage6_polys",
    "stage6_openings", "stage6_claims", "stage6v_polys", "stage6v_openings",
    "stage7_polys", "stage7_openings", "stage8_polys", "stage8_openings",
    "fs_tape"])
def test_sha2_prefix_matches_jax(port_proof, jax_prefix, field):
    assert getattr(port_proof, field) == jax_prefix[field]


def test_sha2_verify_prefix_accepts(port_proof, traces):
    assert jt.verify_prefix(port_proof, jt.PublicIO.from_trace(traces[1]))


def test_sha2_proof_bytes_match_jax(port_proof, jax_prefix, traces):
    blob = proof_io.serialize_proof(port_proof)
    assert blob == jproof_io.serialize_proof(_jax_proof(traces[0],
                                                        jax_prefix))


def test_sha2_verify_accepts_in_both_packages(port_proof, traces):
    assert jt.verify(port_proof, jt.PublicIO.from_trace(traces[1]))
    decoded, _ = jproof_io.deserialize_proof(
        proof_io.serialize_proof(port_proof))
    assert j_verify(decoded, JPublicIO.from_trace(traces[0]))


def test_sha2_stage6v_has_d2_instances(port_proof):
    assert (port_proof.ram_log_K, port_proof.bytecode_log_K) == (13, 12)
    assert len(port_proof.stage6v_openings) == 2 * (4 + 3)
