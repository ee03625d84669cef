"""The torch port's stages 2-5 against the JAX package, on the CPU.

The fib trace of tests/test_prove_verify.py goes through the JAX package's
stage functions (`test_torch_stage1._jax_prefix`: one accumulator, one
transcript, `prove`'s order, every instance through the backend registry
and `prove_scan`) and through `jolt_tpu_torch.prove_prefix(...,
device="cpu")`.  Every `stage2..5` field of the proof and the FS-tape
state after `stage2-reg-rw`, `stage3-reg-val` and `stage4-5-ram` must be
equal; `verify_prefix` must accept the proof and reject it with a tampered
round polynomial or opening in each stage.  Below those, the relation
helpers of the slice meet their JAX counterparts one by one.

The sha2-chain at chain=1 gets the same whole-prefix comparison in
`test_torch_prefix_sha2.py` (slow tier: the JAX package's compiles for a
second trace shape take about two minutes on this CPU).
"""

import copy
import dataclasses
import random

import numpy as np
import pytest
import torch

from jolt_tpu.field import ops as jops
from jolt_tpu.poly import dense as jdense
from jolt_tpu.poly import eq as jeq
from jolt_tpu.poly import lt as jlt
from jolt_tpu.relations import ram_sparse as jrs
from jolt_tpu.tracer import trace_program
from jolt_tpu.witness.ram import extract_ram_log
from jolt_tpu.witness.registers import extract_register_log

import jolt_tpu_torch as jt
from jolt_tpu_torch.field import ops as tops
from jolt_tpu_torch.interop import from_jax_limbs
from jolt_tpu_torch.poly import dense as tdense
from jolt_tpu_torch.poly import eq as teq
from jolt_tpu_torch.poly import lt as tlt
from jolt_tpu_torch.relations import ram_sparse as trs
from jolt_tpu_torch.riscv.emulator import MemoryLayout
from jolt_tpu_torch.tracer import trace_program as t_trace_program
from jolt_tpu_torch.witness.ram import extract_ram_log as t_extract_ram_log
from jolt_tpu_torch.witness.registers import \
    extract_register_log as t_extract_register_log
from test_prove_verify import FIB, L
from test_torch_stage1 import _jax_prefix, _port_trace, _rand_vals

P = jops.FR.modulus
CPU = "cpu"
STAGES = (2, 3, 4, 5)


@pytest.fixture(scope="module")
def fib():
    tr = trace_program(FIB, layout=L)
    return tr, _port_trace(tr)


@pytest.fixture(scope="module")
def jax_prefix(fib):
    return _jax_prefix(fib[0])


@pytest.fixture(scope="module")
def port_proof(fib):
    return jt.prove_prefix(fib[1], device=CPU)


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("part", ["polys", "openings"])
def test_prefix_field_matches_jax(port_proof, jax_prefix, stage, part):
    field = f"stage{stage}_{part}"
    assert getattr(port_proof, field) == jax_prefix[field]


@pytest.mark.parametrize("i,stage", [(2, "stage2-reg-rw"),
                                     (3, "stage3-reg-val"),
                                     (4, "stage4-5-ram")])
def test_prefix_fs_tape_matches_jax(port_proof, jax_prefix, i, stage):
    assert port_proof.fs_tape[i]["stage"] == stage
    assert port_proof.fs_tape[i] == jax_prefix["fs_tape"][i]


def test_prefix_openings_keys(port_proof):
    assert set(port_proof.stage2_openings) == {"wa", "ra1", "ra2", "val",
                                               "inc"}
    assert set(port_proof.stage3_openings) == {"wa", "inc"}
    assert set(port_proof.stage4_openings) == {"rw_ra", "rw_val", "rw_inc",
                                               "raf_ra"}
    assert set(port_proof.stage5_openings) == {"ra", "inc", "oc_ra",
                                               "oc_inc"}


def test_verify_prefix_accepts(port_proof, fib):
    assert jt.verify_prefix(port_proof, jt.PublicIO.from_trace(fib[1]))


@pytest.mark.parametrize("stage", STAGES)
def test_verify_prefix_rejects_tampered_round_poly(port_proof, fib, stage):
    bad = copy.deepcopy(port_proof)
    poly = getattr(bad, f"stage{stage}_polys")[2]
    poly[0] = (poly[0] + 1) % P
    with pytest.raises(jt.VerificationError, match=f"stage{stage}"):
        jt.verify_prefix(bad, jt.PublicIO.from_trace(fib[1]))


@pytest.mark.parametrize("stage,key", [(2, "val"), (2, "inc"), (3, "wa"),
                                       (4, "rw_val"), (4, "raf_ra"),
                                       (5, "ra"), (5, "oc_inc")])
def test_verify_prefix_rejects_tampered_opening(port_proof, fib, stage, key):
    bad = copy.deepcopy(port_proof)
    openings = getattr(bad, f"stage{stage}_openings")
    openings[key] = (openings[key] + 1) % P
    with pytest.raises(jt.VerificationError, match=f"stage{stage}"):
        jt.verify_prefix(bad, jt.PublicIO.from_trace(fib[1]))


def test_advice_layout_is_not_ported():
    """A layout with an advice region raises, naming the ROADMAP item,
    before any work: the prefix never falls back."""
    layout = MemoryLayout(max_input_size=64, max_output_size=64,
                          max_trusted_advice_size=64)
    trace = t_trace_program(f"""
        li t1, {layout.termination}
        li t2, 1
        sd t2, 0(t1)
    """, layout=layout)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        jt.prove_prefix(trace, device=CPU)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        jt.verify_prefix(None, jt.PublicIO.from_trace(trace))


# ---- witness and relation helpers, one by one ---------------------------

def test_register_log_matches_jax(fib):
    want = extract_register_log(fib[0])
    got = t_extract_register_log(fib[1])
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, f.name


def test_lt_evals_matches_jax():
    point = _rand_vals(5, 11)
    got = tops.unpack_ints(tlt.evals(point, CPU))
    assert got == jops.unpack_ints(jlt.evals(point))
    assert got[:5] == [tlt.lt_int(x, point) for x in range(5)]
    x = _rand_vals(5, 12)
    assert tlt.lt_point_int(x, point) == jlt.lt_point_int(x, point)
    assert tlt.lt_int(7, point) == jlt.lt_int(7, point)


def test_bind_low_matches_jax():
    vals, r = _rand_vals(64, 13), _rand_vals(1, 14)[0]
    got = tdense.bind_low(tops.pack_ints(vals, CPU), tops.pack_ints([r], CPU))
    want = jdense.bind_low(jops.pack_ints(vals), jops.pack_ints([r]))
    assert tops.unpack_ints(got) == jops.unpack_ints(want)


def test_evaluate_matches_jax():
    vals, point = _rand_vals(16, 15), _rand_vals(4, 16)
    assert (tdense.evaluate(tops.pack_ints(vals, CPU), point)
            == jdense.evaluate(jops.pack_ints(vals), point))


def test_zeros_ones_match_jax():
    for shape in [(3,), (2, 4)]:
        for t, j in ((tops.zeros(shape, CPU), jops.zeros(shape)),
                     (tops.ones(shape, CPU), jops.ones(shape))):
            assert t.shape[1:] == tuple(j.shape[1:])
            assert torch.equal(t, from_jax_limbs(np.asarray(j), CPU))


def _port_sched(ram):
    return trs.RamPairSchedule(ram.cols, ram.pre, ram.post, ram.K,
                               device=CPU)


@pytest.mark.parametrize("stream", ["ram", "registers"])
def test_pair_schedule_matches_jax(fib, stream):
    """Every round's device tensors equal the JAX schedule's arrays."""
    if stream == "ram":
        ram_j, ram_t = extract_ram_log(fib[0]), t_extract_ram_log(fib[1])
        want = jrs.RamPairSchedule(ram_j.cols, ram_j.pre, ram_j.post,
                                   ram_j.K)
        got = _port_sched(ram_t)
    else:
        log_j, log_t = extract_register_log(fib[0]), t_extract_register_log(
            fib[1])
        want = jrs.RamPairSchedule(log_j.cols, log_j.prev, log_j.post, 128,
                                   rows=log_j.rows, T=log_j.T)
        got = trs.RamPairSchedule(log_t.cols, log_t.prev, log_t.post, 128,
                                  rows=log_t.rows, T=log_t.T, device=CPU)
    assert len(got.rounds) == len(want.rounds) == got.log_T
    for g, w in zip(got.rounds, want.rounds):
        for name in ("even_src", "odd_src", "has_e", "has_o", "rows"):
            np.testing.assert_array_equal(getattr(g, name).numpy(),
                                          np.asarray(getattr(w, name)))
        np.testing.assert_array_equal(g.cols, w.cols)
        assert g.n_real == w.n_real
        for name in ("imp_e", "imp_o"):
            assert torch.equal(getattr(g, name), from_jax_limbs(
                np.asarray(getattr(w, name)), CPU))
    np.testing.assert_array_equal(got.final_cols_dev.numpy(), want.final_cols)
    assert torch.equal(got.initial_val(),
                       from_jax_limbs(np.asarray(want.initial_val()), CPU))


def test_rw_cycle_message_matches_jax(fib):
    """One RAM read/write cycle-round message on the fib schedule."""
    ram_j, ram_t = extract_ram_log(fib[0]), t_extract_ram_log(fib[1])
    sj = jrs.RamPairSchedule(ram_j.cols, ram_j.pre, ram_j.post, ram_j.K)
    st = _port_sched(ram_t)
    rng = random.Random(17)
    point = [rng.randrange(P) for _ in range(st.log_T)]
    g = rng.randrange(P)
    rj, rt = sj.rounds[0], st.rounds[0]
    want = jrs._rw_cycle_message(
        jops.ones((sj.n_entries0,)), sj.initial_val(), jeq.evals(point),
        jops.pack_ints(ram_j.inc), rj.even_src, rj.odd_src, rj.has_e,
        rj.has_o, rj.imp_e, rj.imp_o, rj.rows, jops.pack_ints([1 + g]),
        jops.pack_ints([g]))
    got = trs._rw_cycle_message(
        tops.ones((st.n_entries0,), CPU), st.initial_val(),
        teq.evals(point, CPU), tops.pack_ints(ram_t.inc, CPU), rt.even_src,
        rt.odd_src, rt.has_e, rt.has_o, rt.imp_e, rt.imp_o, rt.rows,
        tops.pack_ints([1 + g], CPU), tops.pack_ints([g], CPU))
    assert got.shape == (8, 3, 1)
    assert tops.unpack_ints(got.reshape(8, -1)) == jops.unpack_ints(
        want.reshape(want.shape[0], -1))
