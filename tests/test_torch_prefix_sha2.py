"""The torch port's stages 1-5 on the main path's guest against the JAX
package, on the CPU: the sha2-chain at chain=1 (3447 cycles, padded 2^12),
traced by each package's own tracer (the port's native one), proved by
`jolt_tpu_torch.prove_prefix(..., device="cpu")` and by the JAX package's
stage functions (`test_torch_stage1._jax_prefix`).  Every proof field and
every FS-tape entry must be equal, and `verify_prefix` must accept.

Slow tier: the JAX package compiles its stage 2-5 round functions anew for
this trace shape, about two minutes on a 4-core CPU; the fast tier holds the
fib trace to the same comparison (`test_torch_prefix.py`).
"""

import dataclasses

import pytest

from jolt_tpu.riscv.emulator import MemoryLayout as JaxLayout
from jolt_tpu.tracer import trace_program

import jolt_tpu_torch as jt
from jolt_tpu_torch import workload
from test_torch_stage1 import _jax_prefix

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
    return _jax_prefix(traces[0])


@pytest.fixture(scope="module")
def port_proof(traces):
    return jt.prove_prefix(traces[1], device="cpu")


@pytest.mark.parametrize("field", [
    "stage1_uniskip", "stage1_polys", "r1cs_input_openings", "shift_polys",
    "shift_opening", "stage2_polys", "stage2_openings", "stage3_polys",
    "stage3_openings", "stage4_polys", "stage4_openings", "stage5_polys",
    "stage5_openings", "fs_tape"])
def test_sha2_prefix_matches_jax(port_proof, jax_prefix, field):
    assert getattr(port_proof, field) == jax_prefix[field]


def test_sha2_verify_prefix_accepts(port_proof, traces):
    assert jt.verify_prefix(port_proof, jt.PublicIO.from_trace(traces[1]))
