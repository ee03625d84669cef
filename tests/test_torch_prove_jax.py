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
"""

import pytest

from jolt_tpu import proof_io as jproof_io
from jolt_tpu.tracer import trace_program

import jolt_tpu_torch as jt
from jolt_tpu_torch import proof_io
from test_prove_verify import FIB, L
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
