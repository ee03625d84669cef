"""The port's copies of the JAX package's host modules, on the CPU.

  * `transcript/keccak.py` and `transcript/poseidon.py`: after the same
    appends, the port's transcripts squeeze the JAX package's challenges
    and reach its states.
  * `claims/`: `Expr` degrees and evaluations, the opening-id space, and
    the naive interpreter (`NaiveExprProver`, the backend's "naive" slot)
    proving the same stage as the JAX package's, accepted by both
    packages' `NaiveExprVerifier`s.
  * `tracer/trace_io.py`: a trace that one package writes loads in the
    other with equal columns, program image and device state.
"""

import random

import numpy as np
import pytest
import torch

from jolt_tpu import claims as jclaims
from jolt_tpu import transcript as jtr
from jolt_tpu.sumcheck.engine import BatchedSumcheck as JBatched
from jolt_tpu.sumcheck.engine import OpeningAccumulator as JAcc
from jolt_tpu.tracer import trace_io as jio
from jolt_tpu.tracer.trace import trace_program as j_trace_program

from jolt_tpu_torch import claims as tclaims
from jolt_tpu_torch import transcript as ttr
from jolt_tpu_torch.field.params import FR
from jolt_tpu_torch.riscv.emulator import MemoryLayout
from jolt_tpu_torch.sumcheck.engine import BatchedSumcheck as TBatched
from jolt_tpu_torch.sumcheck.engine import OpeningAccumulator as TAcc
from jolt_tpu_torch.tracer import trace_io as tio
from jolt_tpu_torch.tracer.trace import trace_program as t_trace_program
from test_trace_io import GUEST
from test_trace_io import L as J_LAYOUT

torch.set_num_threads(1)

P = FR.modulus


@pytest.mark.parametrize("name", ["KeccakTranscript", "PoseidonTranscript"])
def test_transcript_variants_match_jax(name):
    mine, theirs = getattr(ttr, name)(b"variant"), getattr(jtr, name)(
        b"variant")
    rng = random.Random(3)
    vals = [rng.randrange(P) for _ in range(7)]
    for t in (mine, theirs):
        t.append_scalar(b"s", 12345)
        t.append_scalars(b"v", vals[:3])
        t.append_bytes(b"b", b"\x01\x02\x03" * 11)
        t.append_scalars(b"w", vals[3:])
    assert mine.challenge_scalar() == theirs.challenge_scalar()
    assert mine.challenge_vector(3) == theirs.challenge_vector(3)
    assert (mine.challenge_scalar_optimized()
            == theirs.challenge_scalar_optimized())
    assert mine.state == theirs.state


def _expr(mod):
    return ((mod.Const(5) - mod.Poly("m")) * mod.Poly("m") * mod.Poly("e")
            + mod.Challenge("g") * mod.Poly("a") * mod.Poly("e"))


def test_expr_and_ids_match_jax():
    mine, theirs = _expr(tclaims), _expr(jclaims)
    assert mine.degree() == theirs.degree() == 3
    assert mine.poly_leaves() == theirs.poly_leaves()
    assert mine.challenge_leaves() == theirs.challenge_leaves()
    rng = random.Random(9)
    for _ in range(5):
        env = {n: rng.randrange(P) for n in ("m", "e", "a")}
        g = {"g": rng.randrange(P)}
        assert mine.evaluate(env, g) == theirs.evaluate(env, g)
    for lk_d in (4, 8):
        assert tclaims.all_committed(lk_d) == jclaims.all_committed(lk_d)
    assert ([m.name for m in tclaims.SumcheckId]
            == [m.name for m in jclaims.SumcheckId])
    for sc, poly in zip(tclaims.SumcheckId, tclaims.CommittedPolynomial):
        mine_id = tclaims.OpeningId(sc, poly)
        their_id = jclaims.OpeningId(jclaims.SumcheckId[sc.name],
                                     jclaims.CommittedPolynomial[poly.name])
        assert mine_id.key() == their_id.key()


def test_naive_prover_round_trip_matches_jax():
    rng = random.Random(21)
    n = 4
    leaves = {k: [rng.randrange(P) for _ in range(1 << n)]
              for k in ("m", "e", "a")}
    chal = {"g": rng.randrange(P)}
    out = {}
    for name, mod, batched, acc, tr in (
            ("torch", tclaims, TBatched, TAcc, ttr),
            ("jax", jclaims, JBatched, JAcc, jtr)):
        expr = _expr(mod)
        inst = mod.NaiveExprProver(expr, leaves, chal)
        t = tr.Blake2bTranscript(b"naive")
        polys, r = batched.prove([inst], acc(), t)
        claim = mod.sum_over_hypercube(expr, leaves, chal)
        ver = mod.NaiveExprVerifier(
            expr, claim, n, chal,
            claimed={k: inst.polys[k][0] for k in leaves})
        tv = tr.Blake2bTranscript(b"naive")
        assert batched.verify(polys, [ver], acc(), tv) == r
        out[name] = (polys, r, t.state,
                     {k: inst.polys[k][0] for k in leaves})
    assert out["torch"] == out["jax"]


def _same_trace(a, b):
    assert (a.length, a.padded_length, a.entry, a.code) == (
        b.length, b.padded_length, b.entry, b.code)
    assert bytes(a.device.outputs) == bytes(b.device.outputs)
    assert a.device.panic == b.device.panic
    assert set(a.columns) == set(b.columns)
    for k in a.columns:
        np.testing.assert_array_equal(a.columns[k], b.columns[k], err_msg=k)
    assert a.program.n_rows == b.program.n_rows


def test_trace_files_load_in_either_package(tmp_path):
    layout = MemoryLayout(max_input_size=64, max_output_size=64)
    mine = t_trace_program(GUEST, layout=layout, min_padded=16)
    theirs = j_trace_program(GUEST, layout=J_LAYOUT, min_padded=16)
    tio.save_trace(mine, str(tmp_path / "port.npz"))
    jio.save_trace(theirs, str(tmp_path / "jax.npz"))
    _same_trace(jio.load_trace(str(tmp_path / "port.npz")), theirs)
    _same_trace(tio.load_trace(str(tmp_path / "jax.npz")), mine)
