"""The port's `prove` under the cycle mesh at more ranks (slow tier).

  * the 16-cycle guest of tests/test_sharded_prove.py at D = 4 and 8
    (gloo ranks, tests/torch_mesh_ranks.py's side imports no JAX): every
    rank's proof bytes equal the JAX package's `prove` under
    `use_mesh(cycle_mesh(8))` on the suite's 8 virtual CPU devices,
    compared through `jolt_tpu.proof_io.serialize_proof`;
  * the guest at D = 2 with stage 1 forced to stream == one process;
  * fib at D = 2 and 4, at `setup=None` (the suite's fib(20), 256
    cycles padded) and with `DorySetup.generate(13)` (fib(2), 27 cycles
    padded to 32, the size a 13-variable setup holds: 256 x 32): every
    rank's bytes and FS tape equal D = 1's, and the verifiers accept.
"""

import dataclasses
import functools

import pytest
import torch

from jolt_tpu.parallel.mesh import cycle_mesh as j_cycle_mesh
from jolt_tpu.parallel.mesh import use_mesh as j_use_mesh
from jolt_tpu.pcs.dory import DorySetup as JDorySetup
from jolt_tpu.proof_io import deserialize_proof
from jolt_tpu.proof_io import serialize_proof as j_serialize_proof
from jolt_tpu.prover.prover import prove as j_prove
from jolt_tpu.riscv.emulator import MemoryLayout as JaxLayout
from jolt_tpu.tracer.trace import trace_program as j_trace_program
from jolt_tpu.verifier.verifier import PublicIO as JPublicIO
from jolt_tpu.verifier.verifier import verify as j_verify

import jolt_tpu_torch as jt
from jolt_tpu_torch import proof_io
from jolt_tpu_torch.parallel.spawn import prove_rank, run_ranks
from jolt_tpu_torch.pcs.dory import DorySetup
from jolt_tpu_torch.tracer import trace_program
from test_prove_verify import FIB, L as FIB_LAYOUT
from test_torch_mesh import GUEST, L

pytestmark = pytest.mark.slow

torch.set_num_threads(1)

FIB2 = FIB.replace("li   a0, 20", "li   a0, 2")


@pytest.fixture(scope="module")
def guest_jax_bytes():
    """The JAX package's proof of the guest under its 8-device mesh."""
    jtr = j_trace_program(GUEST, layout=JaxLayout(**dataclasses.asdict(L)),
                          min_padded=16)
    with j_use_mesh(j_cycle_mesh(8)):
        return j_serialize_proof(j_prove(jtr))


@pytest.mark.parametrize("D", [4, 8])
def test_guest_on_d_ranks_equals_the_jax_packages_mesh_proof(
        guest_jax_bytes, D):
    tr = trace_program(GUEST, layout=L, min_padded=16)
    for out in run_ranks(prove_rank, D, tr, None, "cpu"):
        assert out["bytes"] == guest_jax_bytes
        assert out["fetches"] == 0


def test_guest_streamed_on_two_ranks_equals_one_process():
    """Stage 1 forced to stream (four chunks of 4 cycles) under the mesh:
    the streamed combos are gathered into their outputs, the bytes are
    one process's."""
    tr = trace_program(GUEST, layout=L, min_padded=16)
    want = proof_io.serialize_proof(jt.prove(tr, device="cpu"))
    for out in run_ranks(functools.partial(prove_rank, device="cpu",
                                           _stream_stage1=4),
                         2, tr):
        assert out["bytes"] == want


@pytest.fixture(scope="module")
def dory13(tmp_path_factory):
    return DorySetup.generate(13, cache_dir=str(
        tmp_path_factory.mktemp("mesh_srs")))


@pytest.fixture(scope="module")
def fib_traces():
    return {"none": trace_program(FIB, layout=FIB_LAYOUT),
            "dory": trace_program(FIB2, layout=FIB_LAYOUT, min_padded=32)}


@pytest.fixture(scope="module")
def fib_d1(fib_traces, dory13):
    """D = 1's proofs (one rank under `cycle_mesh(1)`), by setup."""
    return {k: run_ranks(prove_rank, 1, tr,
                         dory13 if k == "dory" else None, "cpu")[0]
            for k, tr in fib_traces.items()}


@pytest.mark.parametrize("setup", ["none", "dory"])
@pytest.mark.parametrize("D", [2, 4])
def test_fib_on_d_ranks_equals_one(fib_traces, fib_d1, dory13, setup, D,
                                   tmp_path):
    tr = fib_traces[setup]
    if setup == "dory":
        assert tr.padded_length == 32
    want = fib_d1[setup]
    for out in run_ranks(prove_rank, D, tr,
                         dory13 if setup == "dory" else None, "cpu"):
        assert out["bytes"] == want["bytes"]
        assert out["fs_tape"] == want["fs_tape"]
    proof, _ = proof_io.deserialize_proof(want["bytes"])
    assert jt.verify(proof, jt.PublicIO.from_trace(tr),
                     setup=dory13 if setup == "dory" else None)
    if D == 2:
        jtr = j_trace_program(
            FIB if setup == "none" else FIB2,
            layout=JaxLayout(**dataclasses.asdict(FIB_LAYOUT)),
            min_padded=256 if setup == "none" else 32)
        decoded, _ = deserialize_proof(want["bytes"])
        assert j_verify(decoded, JPublicIO.from_trace(jtr), setup=(
            JDorySetup.generate(13, cache_dir=str(tmp_path))
            if setup == "dory" else None))
