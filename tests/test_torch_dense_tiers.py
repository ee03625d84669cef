"""The port's alternative relation tiers against the JAX package, on the CPU.

  * `Booleanity`, `HammingWeight` (`relations/booleanity.py`) and
    `SparseOneHotOpening` (`relations/opening_reduction.py`) on seeded
    index streams at T = 32 and K = 8, 16, 128, batched as one stage: the
    port's host engine and its device tier (forced, one fetch) give the
    JAX package's round polynomials, challenges, openings and transcript
    state, and the port's verifier twins accept them.
  * The dense Twist provers (`relations/registers_rw.py`: read-write,
    Val evaluation, raf; `relations/ram.py`: read-write, raf, Val
    evaluation, output check) on the port's witness of the tiny trace of
    tests/test_naive_oracle.py (T = 64), one stage a module: the JAX
    package's naive interpreter (`jolt_tpu.claims.naive`, host ints) over
    each relation's `Expr` with the K*T broadcast leaves gives the same
    round polynomials, challenges and opened values, at the true claims, and the port's verifier twins accept.  The JAX package's
    dense classes themselves are held to the port's in the slow
    tests/test_torch_dense_twist_jax.py (they compile each round's
    kernels at each shape).
"""

import random

import pytest
import torch

from jolt_tpu.claims.expr import Challenge, Poly
from jolt_tpu.claims.naive import NaiveExprProver
from jolt_tpu.relations import booleanity as jbool
from jolt_tpu.relations import opening_reduction as jor
from jolt_tpu.sumcheck.engine import BatchedSumcheck as JBatched
from jolt_tpu.sumcheck.engine import OpeningAccumulator as JAcc
from jolt_tpu.transcript import Blake2bTranscript as JTranscript

from jolt_tpu_torch.field import ops as tops
from jolt_tpu_torch.field.params import FR
from jolt_tpu_torch.poly import eq as teq
from jolt_tpu_torch.poly import lt as tlt
from jolt_tpu_torch.relations import booleanity as tbool
from jolt_tpu_torch.relations import opening_reduction as tor
from jolt_tpu_torch.relations import ram as tram
from jolt_tpu_torch.relations import registers_rw as treg
from jolt_tpu_torch.riscv.emulator import MemoryLayout
from jolt_tpu_torch.sumcheck import fused
from jolt_tpu_torch.sumcheck.engine import BatchedSumcheck as TBatched
from jolt_tpu_torch.sumcheck.engine import OpeningAccumulator as TAcc
from jolt_tpu_torch.sumcheck.fused import device_tier, prove_fused
from jolt_tpu_torch.tracer import trace_program as t_trace_program
from jolt_tpu_torch.transcript import Blake2bTranscript as TTranscript
from jolt_tpu_torch.witness.ram import (address_of_index,
                                        extract_ram_witness as t_ram_witness)
from jolt_tpu_torch.witness.registers import \
    extract_register_witness as t_reg_witness
from test_naive_oracle import GUEST
from test_torch_stage1 import _rand_vals

torch.set_num_threads(1)

P = FR.modulus
CPU = torch.device("cpu")
T_LAYOUT = MemoryLayout(max_input_size=64, max_output_size=64)
LOG_T = 5
# (K, seed) of each seeded index stream
STREAMS = [(128, 11), (8, 12), (16, 13)]


def _stream(K, seed):
    rng = random.Random(seed)
    return [rng.randrange(K) for _ in range(1 << LOG_T)]


def _bits(x, n):
    return [(x >> (n - 1 - i)) & 1 for i in range(n)]


def _onehot_claim(idx, K, point):
    """sum_j eq(q, (c_j, j)), the value SparseOneHotOpening proves."""
    n = K.bit_length() - 1
    return sum(teq.eq_int(point, _bits(c, n) + _bits(j, LOG_T))
               for j, c in enumerate(idx)) % P


def _onehot_stage(mod, opening_mod, device=None):
    kw = {} if device is None else {"device": device}
    insts = []
    for i, (K, seed) in enumerate(STREAMS):
        idx = _stream(K, seed)
        lk = K.bit_length() - 1
        r_addr = _rand_vals(lk, 100 + i)
        r_cyc = _rand_vals(LOG_T, 110 + i)
        insts.append(mod.Booleanity(idx, K, r_addr, r_cyc, f"m{i}", **kw))
        insts.append(mod.HammingWeight(idx, K, r_cyc, f"m{i}", **kw))
        point = _rand_vals(lk + LOG_T, 120 + i)
        insts.append(opening_mod.SparseOneHotOpening(
            idx, K, point, _onehot_claim(idx, K, point), f"o{i}", **kw))
    return insts


def _prove(pkg, insts, tier=None):
    """One stage on a fresh transcript: (polys, challenges, openings,
    transcript state, fetches made)."""
    if pkg == "jax":
        tr, acc, prover = JTranscript(b"tiers"), JAcc(), JBatched.prove
    else:
        tr, acc = TTranscript(b"tiers"), TAcc()
        prover = TBatched.prove
        if tier == "device":
            for inst in insts:
                inst.force_device = True
            assert device_tier(insts)
            prover = prove_fused
    tr.append_scalar(b"prior", 4242)
    f0 = fused.fetches
    polys, r = prover(insts, acc, tr)
    return polys, r, acc.openings, tr.state, fused.fetches - f0


@pytest.fixture(scope="module")
def onehot_jax():
    return _prove("jax", _onehot_stage(jbool, jor))


@pytest.mark.parametrize("tier", ["host", "device"])
def test_onehot_relations_match_jax(onehot_jax, tier):
    insts = _onehot_stage(tbool, tor, CPU)
    got = _prove("torch", insts, tier)
    assert got[4] == (1 if tier == "device" else 0)
    assert got[:4] == onehot_jax[:4]
    # the verifier twins accept the proof
    polys, r = got[0], got[1]
    vers = []
    for i, (K, _) in enumerate(STREAMS):
        b, h, o = insts[3 * i:3 * i + 3]
        lk = K.bit_length() - 1
        vers.append(tbool.BooleanityVerifier(lk, LOG_T, b.r_addr, b.r_cyc,
                                             b.final_openings["m"]))
        vers.append(tbool.HammingWeightVerifier(lk, LOG_T, h.r_cycle,
                                                h.final_openings["m"]))
        vers.append(tor.OpeningReductionVerifier(
            lk + LOG_T, o.q_addr + o.q_cyc, o.claim, o.final_openings["p"]))
    tv = TTranscript(b"tiers")
    tv.append_scalar(b"prior", 4242)
    assert TBatched.verify(polys, vers, TAcc(), tv) == r


@pytest.fixture(scope="module")
def tiny():
    return t_trace_program(GUEST, layout=T_LAYOUT, min_padded=32)


def _table(vals, T, K, axis):
    """A per-cycle (axis "j") or per-address ("k") column broadcast to the
    K*T cycle-major leaf (index j*K + k)."""
    vals = [v % P for v in vals]
    return [vals[i // K] if axis == "j" else vals[i % K]
            for i in range(K * T)]


def _naive(expr, leaves, challenges=None):
    inst = NaiveExprProver(expr, leaves, challenges)
    inst.degree = 3             # every leaf product is multilinear in a round
    return inst


def _registers(tr):
    wit = t_reg_witness(tr)
    K, T, log_T = 128, wit.T, tr.log_T
    r_cycle = _rand_vals(log_T, 200)
    r_addr = _rand_vals(7, 201)
    g = _rand_vals(1, 202)[0]
    g2 = g * g % P
    e = _table(tops.unpack_ints(teq.evals(r_cycle, CPU)), T, K, "j")
    inc = _table(wit.inc, T, K, "j")
    rw = (Poly("e") * (Poly("wa") * (Poly("inc") + Poly("val"))
                       + Challenge("g") * Poly("ra1") * Poly("val")
                       + Challenge("g2") * Poly("ra2") * Poly("val")))
    rw_leaves = {"e": e, "wa": wit.wa, "ra1": wit.ra1, "ra2": wit.ra2,
                 "val": wit.val, "inc": inc}
    val_leaves = {"lt": _table(tops.unpack_ints(tlt.evals(r_cycle, CPU)),
                               T, K, "j"),
                  "eqa": _table(tops.unpack_ints(teq.evals(r_addr, CPU)),
                                T, K, "k"),
                  "wa": wit.wa, "inc": inc}
    val = Poly("lt") * Poly("eqa") * Poly("wa") * Poly("inc")
    raf = Poly("e") * Poly("m") * Poly("b")
    raf_leaves = {"e": e, "m": wit.wa, "b": _table(range(K), T, K, "k")}
    naive = [_naive(rw, rw_leaves, {"g": g, "g2": g2}),
             _naive(val, val_leaves), _naive(raf, raf_leaves)]
    c_rw, c_val, c_raf = (n.input_claim(None) for n in naive)
    port = [treg.RegistersReadWriteChecking(wit, g, r_cycle, [c_rw, 0, 0],
                                            CPU),
            treg.RegistersValEvaluation(wit, r_addr, r_cycle, c_val, CPU),
            treg.RegistersRaf(wit.wa, None, r_cycle, c_raf, "rd", CPU)]
    names = [("wa", "ra1", "ra2", "val", "inc"), ("wa", "inc"),
             (("m", "m"),)]

    def verifiers(o):
        return [treg.RegistersReadWriteCheckingVerifier(
                    log_T, g, r_cycle, [c_rw, 0, 0], o[0]),
                treg.RegistersValEvaluationVerifier(log_T, r_addr, r_cycle,
                                                    c_val, o[1]),
                treg.RegistersRafVerifier(log_T, r_cycle, c_raf,
                                          o[2]["m"])]
    return naive, port, names, verifiers


def _ram(tr):
    wit = t_ram_witness(tr)
    K, T, log_T = wit.K, wit.T, tr.log_T
    r_cycle = _rand_vals(log_T, 210)
    r_addr = _rand_vals(wit.log_K, 211)
    g, z = _rand_vals(2, 212)
    e = _table(tops.unpack_ints(teq.evals(r_cycle, CPU)), T, K, "j")
    inc = _table(wit.inc, T, K, "j")
    layout, outputs = tr.memory_layout, bytes(tr.device.outputs)
    W = [0] * K
    zp = 1
    for k in tram.output_region_cells(layout, wit.witness_base, K):
        W[k], zp = zp, zp * z % P
    rw = Poly("e") * Poly("ra") * ((1 + Challenge("g")) * Poly("val")
                                   + Challenge("g") * Poly("inc"))
    addrs = [address_of_index(k, wit.witness_base) for k in range(K)]
    naive = [
        _naive(rw, {"e": e, "ra": wit.ra, "val": wit.val, "inc": inc},
               {"g": g}),
        _naive(Poly("e") * Poly("ra") * Poly("a"),
               {"e": e, "ra": wit.ra, "a": _table(addrs, T, K, "k")}),
        _naive(Poly("lt") * Poly("eqa") * Poly("ra") * Poly("inc"),
               {"lt": _table(tops.unpack_ints(tlt.evals(r_cycle, CPU)),
                             T, K, "j"),
                "eqa": _table(tops.unpack_ints(teq.evals(r_addr, CPU)),
                              T, K, "k"),
                "ra": wit.ra, "inc": inc}),
        _naive(Poly("w") * Poly("ra") * Poly("inc"),
               {"w": _table(W, T, K, "k"), "ra": wit.ra, "inc": inc})]
    c_rw, c_addr, c_val, _ = (n.input_claim(None) for n in naive)
    c_val = (c_val + tram.init_mle_eval(wit.init_vals, r_addr)) % P
    port = [tram.RamReadWriteChecking(wit, g, r_cycle, c_rw, 0, CPU),
            tram.RamRafEvaluation(wit, r_cycle, c_addr, CPU),
            tram.RamValEvaluation(wit, r_addr, r_cycle, c_val, CPU),
            tram.RamOutputCheck(wit, layout, z, outputs, CPU)]
    names = [("ra", "val", "inc"), ("ra",), ("ra", "inc"), ("ra", "inc")]

    def verifiers(o):
        lk = wit.log_K
        return [tram.RamReadWriteCheckingVerifier(log_T, lk, g,
                                                  r_cycle, c_rw, 0, o[0]),
                tram.RamRafEvaluationVerifier(log_T, lk, r_cycle, c_addr,
                                              wit.witness_base, o[1]),
                tram.RamValEvaluationVerifier(log_T, lk, r_addr, r_cycle,
                                              c_val, wit.init_vals, o[2]),
                tram.RamOutputCheckVerifier(log_T, lk, z, outputs, layout,
                                            wit.witness_base, wit.init_vals,
                                            o[3])]
    return naive, port, names, verifiers


@pytest.mark.parametrize("build", [_registers, _ram],
                         ids=["registers", "ram"])
def test_dense_twist_provers_match_the_naive_interpreter(tiny, build):
    naive, port, names, verifiers = build(tiny)
    want = _prove("jax", naive)
    got = _prove("torch", port, "host")
    # the same round polynomials and challenges (the stages then flush
    # different opening ids: the naive tier opens every leaf)
    assert got[:2] == want[:2]
    for inst, nv, ns in zip(port, naive, names):
        for n in ns:
            mine, theirs = n if isinstance(n, tuple) else (n, n)
            assert inst.final_openings[mine] == nv.polys[theirs][0], n
    # the tables broadcast in place: a cycle column stays (8, T, 1)
    assert port[0].tables["inc"].shape[1:] == (1, 1)
    tv = TTranscript(b"tiers")
    tv.append_scalar(b"prior", 4242)
    assert TBatched.verify(got[0], verifiers([i.final_openings
                                              for i in port]),
                           TAcc(), tv) == got[1]
