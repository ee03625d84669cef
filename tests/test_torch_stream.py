"""Stage 1's streaming tier (`relations/spartan_outer.py`) against the JAX
package's, on the CPU.

The fib trace (T = 256) streamed in four chunks of 64 cycles on both
sides: the JAX package's stage-1 functions under
`JOLT_TPU_STREAM_STAGE1=1`, with its `STREAM_CHUNK` set to the same 64
(both set with `monkeypatch` on the JAX side), and the port's under
`_stream_stage1=64`.  They give the same uni-skip polynomial, the same
matrices bound at Y=r0 and the same 38 input openings; the port's
streamed stage (host engine and device tier) gives the same round
polynomials and openings as its materialized one.  The port's whole fib
proof streamed is held to its materialized bytes on both tiers in
tests/test_torch_fused_stages.py.
"""

import numpy as np
import pytest
import torch

from jolt_tpu.relations import spartan_outer as jso
from jolt_tpu.sumcheck.engine import OpeningAccumulator as JAcc
from jolt_tpu.sumcheck.scan import prove_scan
from jolt_tpu.tracer import trace_program
from jolt_tpu.transcript import Blake2bTranscript as JTranscript
from jolt_tpu.witness.r1cs_inputs import extract_r1cs_inputs

from jolt_tpu_torch.interop import from_jax_limbs
from jolt_tpu_torch.relations import spartan_outer as tso
from jolt_tpu_torch.sumcheck import fused
from jolt_tpu_torch.sumcheck.engine import BatchedSumcheck as TBatched
from jolt_tpu_torch.sumcheck.engine import OpeningAccumulator as TAcc
from jolt_tpu_torch.transcript import Blake2bTranscript as TTranscript
from jolt_tpu_torch.witness.r1cs_inputs import \
    extract_r1cs_inputs as t_extract_r1cs_inputs
from test_prove_verify import FIB, L
from test_torch_stage1 import _port_trace

torch.set_num_threads(1)

CPU = torch.device("cpu")
CHUNK = 64


@pytest.fixture(scope="module")
def fib():
    tr = trace_program(FIB, layout=L)
    assert tr.padded_length // CHUNK >= 4
    return tr, _port_trace(tr)


def _jax_stage1(tr):
    """The JAX package's stage 1, streamed: (uni-skip coefficients, the
    bound matrices, round polynomials, 38 openings)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JOLT_TPU_STREAM_STAGE1", "1")
        mp.setattr(jso, "STREAM_CHUNK", CHUNK)
        inputs = extract_r1cs_inputs(tr)
        t = JTranscript(b"stream")
        tau = t.challenge_vector(1 + jso.num_stage1_rounds(tr.log_T))
        cols, s1, r0, claim1, l_scale = jso.prove_uniskip(inputs, tau, t)
        assert cols[0] == "stream"
        outer = jso.SpartanOuterProver(inputs, tau[1:], r0, claim1, l_scale,
                                       cols)
        mats = [np.asarray(m) for m in (outer.AZ, outer.BZ, outer.CZ)]
        polys, _ = prove_scan([outer], JAcc(), t)
    return s1, mats, polys, outer.input_openings


def _port_stage1(trace, stream, tier="host"):
    inputs = t_extract_r1cs_inputs(trace)
    t = TTranscript(b"stream")
    tau = t.challenge_vector(1 + tso.num_stage1_rounds(trace.log_T))
    cols, s1, r0, claim1, l_scale = tso.prove_uniskip(
        inputs, tau, t, CPU, _stream_stage1=stream)
    assert isinstance(cols, tso.StreamedColumns) == bool(stream)
    outer = tso.SpartanOuterProver(inputs, tau[1:], r0, claim1, l_scale,
                                   cols)
    mats = [outer.AZ, outer.BZ, outer.CZ]
    prover = TBatched.prove
    if tier == "device":
        outer.force_device = True
        prover = fused.prove_fused
    f0 = fused.fetches
    polys, _ = prover([outer], TAcc(), t)
    return s1, mats, polys, outer.input_openings, fused.fetches - f0


@pytest.fixture(scope="module")
def runs(fib):
    tr, pt = fib
    return {"jax": _jax_stage1(tr),
            "stream": _port_stage1(pt, CHUNK),
            "stream-device": _port_stage1(pt, CHUNK, "device"),
            "materialized": _port_stage1(pt, False)}


def test_uniskip_polynomial_matches_jax_streamed(runs):
    assert (runs["stream"][0] == runs["jax"][0]
            == runs["materialized"][0])


def test_bound_matrices_match_jax_streamed(runs):
    for got, want, mat in zip(runs["stream"][1], runs["jax"][1],
                              runs["materialized"][1]):
        assert torch.equal(got, from_jax_limbs(want, CPU))
        assert torch.equal(got, mat)


@pytest.mark.parametrize("run", ["stream", "stream-device"])
def test_rounds_and_openings_match_jax_streamed(runs, run):
    assert runs[run][2] == runs["jax"][2] == runs["materialized"][2]
    assert runs[run][3] == runs["jax"][3] == runs["materialized"][3]
    assert len(runs[run][3]) == tso.NUM_VARS
    # the device tier's openings ride in the stage's one fetch
    assert runs[run][4] == (1 if run == "stream-device" else 0)


def test_stream_chunk_picks_the_tier():
    T = tso.STREAM_THRESHOLD
    assert tso.stream_chunk(T // 2) == 0
    assert tso.stream_chunk(T) == tso.STREAM_CHUNK
    assert tso.stream_chunk(T, False) == 0
    assert tso.stream_chunk(256, True) == 256
    assert tso.stream_chunk(256, 64) == 64
    with pytest.raises(ValueError, match="power of two"):
        tso.stream_chunk(256, 48)
