"""The torch port on the card: K1 (every form: mul, add, sub, bind, evals,
reduce), K2 (every pass order, 2 and 3 factors, its on-card finish of the
message, and a device challenge read by pointer against the same challenge
by value) and K4 (the round tail, on seeded stages of 1-4 and of 33-64
instances of degrees 1-3 with inactive rounds and edge values) against
their plain versions, the device tier of every batched stage but s5i
on "cuda" against the host engine (fib's prefix and whole proof, the
round loops under the sync debug mode "error"), the segment sums and the
stacked product message of stage 5i, the ra virtualization of stage 6v and
the grouped one-hot and dense-opening instances of stages 7 and 8 on
"cuda" against "cpu", and the prover on "cuda" against the prover on "cpu"
(stages 1-6v, with and without stage-6v instances; the whole proof's bytes,
with and without advice regions, and with a Dory setup); stage 1 streamed
on the card (the materialized bytes, no synchronizing call in the loops),
and the alternative tiers: the one-hot relations (`Booleanity`,
`HammingWeight`, `SparseOneHotOpening`) on the device tier == the host
engine == "cpu", the dense Twist provers "cuda" == "cpu", the naive
interpreter == a `DenseOpening` on the card.

These tests need an NVIDIA GPU; without one they skip.  The machine with
the card has no JAX, so this module imports none, and there it runs
without the suite's JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from jolt_tpu_torch import PublicIO, prove, prove_prefix, verify, verify_prefix
from jolt_tpu_torch.field import kernels, ops
from jolt_tpu_torch.poly import eq
from jolt_tpu_torch.proof_io import serialize_proof
from jolt_tpu_torch.relations.grouped_onehot import GroupedOneHot
from jolt_tpu_torch.relations.opening_reduction import DenseOpening
from jolt_tpu_torch.relations.ra_virtual import RaVirtual, chunk_streams
from jolt_tpu_torch.riscv.emulator import MemoryLayout
from jolt_tpu_torch.sumcheck.engine import BatchedSumcheck, OpeningAccumulator
from jolt_tpu_torch.sumcheck.product import (ProductSumcheck, round_step,
                                             stack_message)
from jolt_tpu_torch.transcript import Blake2bTranscript
from jolt_tpu_torch.transcript import device as dt
from jolt_tpu_torch.tracer import trace_program

pytestmark = pytest.mark.cuda


def _field_ints(rng, n):
    """n numpy-seeded field elements (canonical ints)."""
    words = rng.integers(0, 1 << 63, size=(n, 4), dtype=np.uint64)
    return [int(sum(int(w) << (64 * i) for i, w in enumerate(row))) % kernels.P
            for row in words]


# the wide seeded stages (seed, instances): past one warp's 32 lanes, up to
# K4's 64
K4_WIDE = ((100, 33), (101, 47), (102, 64))


def k4_case(seed: int, n_inst: int = 0) -> dict:
    """A seeded stage for the round tail: 1-4 instances of degrees 1-3 and
    1-4 rounds each (active in their last rounds, so inactive before),
    scaled claims and batching coefficients with the edge values 0 and
    p - 1 among them, each round's evals (edges too), and a starting state
    from a real transcript.  Every value a canonical int (the CPU test
    holds the plain version against the host transcript with it, the
    card test K4 against the plain version).

    With `n_inst` (33-64), a wide stage of that many instances of mixed
    degrees (the first three 1, 2 and 3) in three rounds, an instance of
    degree d active in the last 4 - d: round 0 has only degree-1
    instances active (1 compressed coefficient), round 1 degree 1-2 (2),
    round 2 all (3)."""
    rng = np.random.default_rng(seed)
    if n_inst:
        n = n_inst
        degrees = [1, 2, 3] + [int(d) for d in rng.integers(1, 4, n - 3)]
        rounds = [4 - d for d in degrees]
    else:
        n = int(rng.integers(1, 5))
        degrees = [int(d) for d in rng.integers(1, 4, n)]
        rounds = [int(k) for k in rng.integers(1, 5, n)]
    max_rounds = max(rounds)
    claims = _field_ints(rng, n)
    claims[0] = 0
    if n > 1:
        claims[1] = kernels.P - 1
    tr = Blake2bTranscript(b"Jolt")
    for v in _field_ints(rng, int(rng.integers(0, 4))):
        tr.append_scalar(b"k4_case", v)
    evals = []
    for rnd in range(max_rounds):
        row = []
        for d, k in zip(degrees, rounds):
            if rnd < max_rounds - k:
                row.append(None)
                continue
            vals = _field_ints(rng, d)
            pick = int(rng.integers(0, 4))
            if pick < d:
                vals[pick] = (0, kernels.P - 1)[int(rng.integers(0, 2))]
            row.append(vals)
        evals.append(row)
    return {"degrees": degrees, "claims": claims,
            "coeffs": _field_ints(rng, n), "state": tr.state,
            "n_rounds": tr.n_rounds, "evals": evals}


def run_k4_case(case: dict, device, tail=None):
    """The case's rounds through `tail` (`dt.round_tail` by default) on
    `device`; returns the stage buffers after each round (host copies)."""
    tail = tail or dt.round_tail
    degrees = case["degrees"]
    bufs = dt.stage_buffers(device, case["state"], case["n_rounds"],
                            case["claims"], case["coeffs"],
                            len(case["evals"]), max(degrees))
    out = []
    for rnd, row in enumerate(case["evals"]):
        evals = [None if v is None else
                 ops.pack_ints_host(v, device).reshape(8, d, 1)
                 for v, d in zip(row, degrees)]
        tail(evals, degrees, bufs, rnd,
             dt.compressed_len([v is not None for v in row], degrees))
        out.append(bufs.all.cpu().clone())
    return out


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the chip)")
    return torch.device("cuda")


def test_k1_matches_plain_on_card(card):
    """K1 equals mont_mul_plain bit for bit with both operands streaming,
    a broadcast scalar and per-row weights, and counts its launches."""
    gen = torch.Generator(device=card)
    gen.manual_seed(7)
    w = torch.randint(0, 1 << 32, (8, 4, 1 << 14), generator=gen,
                      device=card, dtype=torch.int64)
    w[7] %= 0x30644E72
    a = (w - ((w >> 31) << 32)).to(torch.int32)
    b = a.flip(-1).contiguous()
    before = kernels.mont_mul.launches
    for x, y in ((a, b), (a[:, :1, :1], b), (a[:, :, :1], b)):
        assert torch.equal(kernels.mont_mul(x, y),
                           kernels.mont_mul_plain(x, y))
    torch.cuda.synchronize()
    assert kernels.mont_mul.launches == before + 3


# K1's forms, each in the layouts the prover gives it: operand shapes,
# "int" for a value passed by value, and (lo, hi) as halves or pairs of one
# tensor or as two tensors
_K1_CASES = {
    "mul": [((8, 4, 1000), (8, 4, 1000)), ((8, 4, 1), (8, 4, 1000)),
            ((8, 1001), "int"), ((8, 7, 1), (8, 1, 1))],
    "add": [((8, 3, 998), (8, 3, 998)), ((8, 998), (8, 1))],
    "sub": [((8, 1000), (8, 1000)), ("int", (8, 2, 999))],
    "bind": [((8, 1024), "high", "int"), ((8, 1024), "low", (8, 1)),
             ((8, 3, 500), "low", "int"), ((8, 999), "split", "int")],
    "evals": [((8, 1024), 3, "high"), ((8, 3, 500), 2, "high"),
              ((8, 999), 3, "split")],
    "reduce": [((8, 3, 1), None), ((8, 1000), "int"),
               ((8, 20, 100), (8, 1, 1))],
}


def _k1_operands(form, key, gen, card):
    P = kernels.P

    def field(shape):
        return _rand_field(gen, shape, card)

    def value():
        return int(torch.randint(0, 1 << 62, (1,), generator=gen,
                                 device=card)) ** 4 % P

    def pair(shape, layout):
        *batch, h = shape
        if layout == "split":
            return field(shape), field(shape)
        whole = field(tuple(batch) + (2 * h,))
        return ((whole[..., :h], whole[..., h:]) if layout == "high"
                else (whole[..., 0::2], whole[..., 1::2]))
    if form in ("mul", "add", "sub"):
        return [value() if s == "int" else field(s) for s in key]
    if form == "bind":
        return [*pair(key[0], key[1]),
                value() if key[2] == "int" else field(key[2])]
    if form == "evals":
        return [*pair(key[0], key[2]), key[1]]
    w = torch.randint(0, 1 << 62, key[0], generator=gen, device=card,
                      dtype=torch.int64)
    w[7] >>= 1
    return [w, None if key[1] is None else
            value() if key[1] == "int" else field(key[1])]


@pytest.mark.parametrize("columns", [0, 1, 2])
@pytest.mark.parametrize("form", ["mul", "add", "sub", "bind", "evals",
                                  "reduce"])
def test_k1_every_form_matches_plain_on_card(card, form, columns):
    """Each K1 form equals its plain version bit for bit in each layout,
    with the columns a thread chosen by size (0) or forced to 1 or 2, and
    each call is one launch of that form."""
    gen = torch.Generator(device=card)
    gen.manual_seed(kernels.FORMS.index(form))
    wrapper = {"mul": kernels.mont_mul, "add": kernels.add,
               "sub": kernels.sub, "bind": kernels.bind,
               "evals": kernels.evals, "reduce": kernels.reduce}[form]
    for key in _K1_CASES[form]:
        args = _k1_operands(form, key, gen, card)
        before = kernels.k1_launches()
        kernels.force_k1_columns(columns)
        try:
            got = wrapper(*args)
            torch.cuda.synchronize()
        finally:
            kernels.force_k1_columns(0)
        assert kernels.k1_launches()[form] == before[form] + 1
        nb = max(a.dim() for a in args if isinstance(a, torch.Tensor)) - 1
        plain = [kernels._plain_operand(a, card, nb)
                 if isinstance(a, int) and not (form == "evals" and a is
                                                 args[-1]) else a
                 for a in args]
        want = {"mul": kernels.mont_mul_plain, "add": kernels.add_plain,
                "sub": kernels.sub_plain, "bind": kernels.bind_plain,
                "evals": kernels.evals_plain,
                "reduce": kernels.reduce_plain}[form](*plain)
        assert got.shape == want.shape and torch.equal(got, want), key


def _rand_field(gen, shape, card):
    w = torch.randint(0, 1 << 32, shape, generator=gen, device=card,
                      dtype=torch.int64)
    w[7] %= 0x30644E72
    return (w - ((w >> 31) << 32)).to(torch.int32)


@pytest.mark.parametrize("log_t", [12, 18])
def test_k2_matches_plain_on_card(card, log_t):
    """K2 equals product_round_deg3_plain bit for bit (message and the
    three bound factors) and counts one launch."""
    gen = torch.Generator(device=card)
    gen.manual_seed(log_t)
    polys = [_rand_field(gen, (8, 1 << log_t), card) for _ in range(3)]
    r = _rand_field(gen, (8, 1), card)
    before = kernels.product_round.launches
    msg, *bound = kernels.product_round_deg3(*polys, r)
    want_msg, want_bound = kernels.product_round_plain(polys, r,
                                                       "message_bind")
    torch.cuda.synchronize()
    assert kernels.product_round.launches == before + 1
    for g, w in zip((msg, *bound), (want_msg, *want_bound)):
        assert g.shape == w.shape and torch.equal(g, w)


@pytest.mark.parametrize("order", kernels.ORDERS)
@pytest.mark.parametrize("nf", [2, 3])
def test_k2_every_order_matches_plain_on_card(card, nf, order):
    """Each pass order at 2 and 3 factors equals the plain version bit for
    bit, on seeded inputs and on factors and challenges of 0, 1 and r-1."""
    gen = torch.Generator(device=card)
    gen.manual_seed(nf * 10 + kernels.ORDERS.index(order))
    polys = [_rand_field(gen, (8, 1 << 12), card) for _ in range(nf)]
    edge = [0, 1, kernels.P - 1]
    pick = torch.randint(0, 3, (nf, 1 << 8), generator=gen, device=card)
    edges = [ops.pack_ints([edge[int(v)] for v in row], card)
             for row in pick.tolist()]
    for ps, r in ((polys, _rand_field(gen, (8, 1), card)),
                  (edges, 0), (edges, 1), (edges, kernels.P - 1)):
        msg, bound = kernels.product_round(ps, r, order)
        want_msg, want_bound = kernels.product_round_plain(ps, r, order)
        assert (msg is None) == (want_msg is None)
        assert msg is None or torch.equal(msg, want_msg)
        assert (bound is None) == (want_bound is None)
        assert bound is None or all(torch.equal(b, w)
                                    for b, w in zip(bound, want_bound))


@pytest.mark.parametrize("order", ["message_bind", "bind_message", "bind"])
@pytest.mark.parametrize("nf", [2, 3])
def test_k2_device_r_equals_r_by_value_on_card(card, nf, order):
    """K2 with the challenge as a device scalar (read by pointer) gives
    what it gives with the same challenge by value, and what the plain
    version gives."""
    gen = torch.Generator(device=card)
    gen.manual_seed(50 + nf)
    polys = [_rand_field(gen, (8, 1 << 12), card) for _ in range(nf)]
    for r_int in (0, 1, kernels.P - 1, 12345678901234567890):
        r_dev = ops.pack_ints([r_int], card)
        got = kernels.product_round(polys, r_dev, order)
        by_value = kernels.product_round(polys, r_int, order)
        want = kernels.product_round_plain(polys, r_int, order)
        for g, v, w in zip(got, by_value, want):
            assert (g is None) == (v is None) == (w is None)
            if g is None:
                continue
            g, v, w = ([g] if isinstance(g, torch.Tensor) else g,
                       [v] if isinstance(v, torch.Tensor) else v,
                       [w] if isinstance(w, torch.Tensor) else w)
            assert all(torch.equal(a, b) and torch.equal(a, c)
                       for a, b, c in zip(g, v, w))


@pytest.mark.parametrize("seed", range(6))
def test_k4_matches_plain_on_card(card, seed):
    """K4 equals its plain version bit for bit on the card, after every
    round of a seeded stage, and counts one launch a round (seed 5 has a
    squeeze with the top three bits of its 128 set:
    tests/test_torch_transcript_device.py)."""
    case = k4_case(seed)
    before = kernels.k4_launches()
    got = run_k4_case(case, card)
    assert kernels.k4_launches() == before + len(case["evals"])
    want = run_k4_case(case, card, dt.round_tail_plain)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("seed,n_inst", K4_WIDE)
def test_k4_matches_plain_on_card_wide(card, seed, n_inst):
    """K4 equals its plain version bit for bit on the card after every
    round of a wide seeded stage (33-64 instances: both halves of its
    field warps; 1, 2 and 3 compressed coefficients; inactive instances
    of every degree), one launch a round."""
    case = k4_case(seed, n_inst)
    before = kernels.k4_launches()
    got = run_k4_case(case, card)
    assert kernels.k4_launches() == before + len(case["evals"])
    want = run_k4_case(case, card, dt.round_tail_plain)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


FIB20 = """
        li   a0, 20
        li   a1, 0
        li   a2, 1
    loop:
        beq  a0, zero, done
        add  a3, a1, a2
        mv   a1, a2
        mv   a2, a3
        addi a0, a0, -1
        j    loop
    done:
        li   t0, {output_start}
        sd   a1, 0(t0)
        li   t1, {termination}
        li   t2, 1
        sd   t2, 0(t1)
"""


def _fib20():
    layout = MemoryLayout(max_input_size=64, max_output_size=64)
    return trace_program(FIB20.format(output_start=layout.output_start,
                                      termination=layout.termination),
                         layout=layout)


def _on_device_tier(fn):
    """fn() with each device-tier stage's round loop and finals under the
    sync debug mode "error" (a synchronizing CUDA call raises); returns its
    result, the K4 launches and the fetches it made."""
    from jolt_tpu_torch.sumcheck import fused
    k4, f0 = kernels.k4_launches(), fused.fetches
    real = fused._device_rounds

    def no_sync(*args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    fused._device_rounds = no_sync
    try:
        out = fn()
    finally:
        fused._device_rounds = real
    return out, kernels.k4_launches() - k4, fused.fetches - f0


def _rounds(proof, fields):
    return sum(len(getattr(proof, f)) for f in fields)


PREFIX_TIER_POLYS = ["stage1_polys", "shift_polys", "stage2_polys",
                     "stage3_polys", "stage4_polys", "stage5_polys",
                     "stage6_polys"]


def test_stage1_device_tier_on_card(card):
    """fib's prefix on the card takes the device tier in every batched
    stage but s5i (one K4 launch a round of the stage's longest instance,
    one fetch a stage, no synchronizing call from a stage's first message
    to its fetch; fib's stage 6v has no sumcheck) and gives the proof and
    FS tape of the host engine, every slot forced there through the
    backend seam."""
    from jolt_tpu_torch.kernels import JoltBackend, set_backend
    trace = _fib20()
    dev, k4, fetches = _on_device_tier(lambda: prove_prefix(trace,
                                                            device=card))
    assert not dev.stage6v_polys
    assert k4 == _rounds(dev, PREFIX_TIER_POLYS)
    assert fetches == len(PREFIX_TIER_POLYS)
    set_backend(JoltBackend.default().with_every_slot("host"))
    try:
        host, k4, fetches = _on_device_tier(
            lambda: prove_prefix(trace, device=card))
    finally:
        set_backend(None)
    assert k4 == 0 and fetches == 0
    assert dataclasses.asdict(dev) == dataclasses.asdict(host)


def test_prove_device_tier_on_card_equals_host_forced(card):
    """fib's whole proof on the card's device tier (s1-s8 but s5i) has the
    bytes and FS tape of the all-host-forced run, with no synchronizing
    call from a stage's first message to its fetch, and verifies."""
    from jolt_tpu_torch.kernels import JoltBackend, set_backend
    trace = _fib20()
    dev, k4, fetches = _on_device_tier(lambda: prove(trace, device=card))
    tier_polys = PREFIX_TIER_POLYS + ["stage7_polys", "stage8_polys"]
    assert k4 == _rounds(dev, tier_polys) and fetches == len(tier_polys)
    set_backend(JoltBackend.default().with_every_slot("host"))
    try:
        host = prove(trace, device=card)
    finally:
        set_backend(None)
    assert serialize_proof(dev) == serialize_proof(host)
    assert dev.fs_tape == host.fs_tape
    assert verify(dev, PublicIO.from_trace(trace))


def test_streamed_stage1_on_card(card):
    """fib's whole proof on the card with stage 1 streamed in four chunks
    (`_stream_stage1`) has the materialized proof's bytes and FS tape,
    with one fetch a device-tier stage and no synchronizing call from a
    stage's first message to its fetch (the streamed openings included)."""
    trace = _fib20()
    chunk = trace.padded_length // 4
    streamed, k4, fetches = _on_device_tier(
        lambda: prove(trace, device=card, _stream_stage1=chunk))
    materialized, k4_m, fetches_m = _on_device_tier(
        lambda: prove(trace, device=card))
    assert serialize_proof(streamed) == serialize_proof(materialized)
    assert streamed.fs_tape == materialized.fs_tape
    assert (k4, fetches) == (k4_m, fetches_m)


def onehot_stage(trace, device):
    """A19's one-hot relations on a trace's index streams (the rd register
    stream, K = 128; the bytecode's, K = 2^log K; the RAM's, K = 2^log K):
    a `Booleanity`, a `HammingWeight` and a `SparseOneHotOpening` each,
    with seeded points and claims."""
    from jolt_tpu_torch.relations.booleanity import Booleanity, HammingWeight
    from jolt_tpu_torch.relations.opening_reduction import \
        SparseOneHotOpening
    from jolt_tpu_torch.witness.bytecode import extract_bytecode_witness
    from jolt_tpu_torch.witness.ram import extract_ram_log
    from jolt_tpu_torch.witness.registers import extract_register_log
    log_t = trace.log_T
    bc = extract_bytecode_witness(trace)
    ram = extract_ram_log(trace)
    streams = [(extract_register_log(trace).rd_eff, 128),
               (bc.pc_idx, 1 << bc.log_K), (ram.cols, 1 << ram.log_K)]
    rng = np.random.default_rng(31)
    insts = []
    for i, (idx, K) in enumerate(streams):
        lk = K.bit_length() - 1
        r_addr, r_cyc, point, claim = (
            _field_ints(rng, lk), _field_ints(rng, log_t),
            _field_ints(rng, lk + log_t), _field_ints(rng, 1)[0])
        idx = np.asarray(idx, dtype=np.int64)
        insts += [Booleanity(idx, K, r_addr, r_cyc, f"b{i}", device=device),
                  HammingWeight(idx, K, r_cyc, f"h{i}", device=device),
                  SparseOneHotOpening(idx, K, point, claim, f"o{i}",
                                      device=device)]
    return insts


def run_stage(insts, tier):
    """The stage on a fresh transcript on its instances' device: the
    device tier (forced) or the host engine; (round polynomials, openings,
    transcript state) and its K4 launches."""
    from jolt_tpu_torch.sumcheck.fused import prove_fused
    acc, transcript = OpeningAccumulator(), Blake2bTranscript(b"a19")
    k4 = kernels.k4_launches()
    if tier == "device":
        for inst in insts:
            inst.force_device = True
        polys, _ = prove_fused(insts, acc, transcript)
    else:
        polys, _ = BatchedSumcheck.prove(insts, acc, transcript)
    return (polys, acc.openings, transcript.state), kernels.k4_launches() - k4


def test_onehot_relations_card_equal_host_and_cpu(card):
    """Booleanity, HammingWeight and SparseOneHotOpening on fib's streams:
    the card's device tier (one K4 launch a round, no synchronizing call
    in the loop) == the card's host engine == the CPU."""
    trace = _fib20()
    (dev, k4), _, _ = _on_device_tier(
        lambda: run_stage(onehot_stage(trace, card), "device"))
    host, k4_h = run_stage(onehot_stage(trace, card), "host")
    cpu, _ = run_stage(onehot_stage(trace, "cpu"), "host")
    assert dev == host == cpu
    insts = onehot_stage(trace, "cpu")
    assert k4 == max(i.num_rounds for i in insts) and k4_h == 0


def dense_stages(trace, device):
    """The dense Twist provers of `registers_rw.py` and of `ram.py` on the
    trace's dense witnesses, with seeded points and claims: one stage a
    module."""
    from jolt_tpu_torch.relations import ram as ram_mod, registers_rw
    from jolt_tpu_torch.witness.ram import extract_ram_witness
    from jolt_tpu_torch.witness.registers import extract_register_witness
    reg = extract_register_witness(trace)
    rng = np.random.default_rng(32)
    log_t = trace.log_T
    r_cyc = _field_ints(rng, log_t)
    g, c1, c2, c3, c4, z = _field_ints(rng, 6)
    stages = [[registers_rw.RegistersReadWriteChecking(
                   reg, g, r_cyc, [c1, c2, c3], device),
               registers_rw.RegistersValEvaluation(
                   reg, _field_ints(rng, 7), r_cyc, c4, device),
               registers_rw.RegistersRaf(reg.wa, None, r_cyc, c1, "rd",
                                         device)]]
    rw = extract_ram_witness(trace)
    stages.append([
        ram_mod.RamReadWriteChecking(rw, g, r_cyc, c1, c2, device),
        ram_mod.RamRafEvaluation(rw, r_cyc, c3, device),
        ram_mod.RamValEvaluation(rw, _field_ints(rng, rw.log_K), r_cyc, c4,
                                 device),
        ram_mod.RamOutputCheck(rw, trace.memory_layout, z,
                               bytes(trace.device.outputs), device)])
    return stages


def test_dense_twist_card_equals_cpu(card):
    trace = _fib20()
    for on_card, on_cpu in zip(dense_stages(trace, card),
                               dense_stages(trace, "cpu")):
        assert run_stage(on_card, "host") == run_stage(on_cpu, "host")


def test_naive_expr_equals_dense_opening_on_card(card):
    """The naive interpreter (host ints) and a `DenseOpening` on the card
    prove sum_x eq(q, x) P(x) with the same round polynomials."""
    from jolt_tpu_torch.claims import NaiveExprProver, Poly
    rng = np.random.default_rng(33)
    q, vals = _field_ints(rng, 6), _field_ints(rng, 64)
    naive = NaiveExprProver(Poly("e") * Poly("p"), {
        "e": ops.unpack_ints(eq.evals(q, "cpu")), "p": vals})
    dense = DenseOpening(vals, q, naive.input_claim(None), "p",
                         device=card)
    assert run_stage([naive], "host")[0][0] == run_stage([dense], "host")[0][0]


@pytest.mark.parametrize("nf", [2, 3])
def test_k2_finish_matches_reduce_cols_on_card(card, nf):
    """The finish kernel's message equals ops.reduce_cols of the pass
    kernel's block sums (added in int64)."""
    gen = torch.Generator(device=card)
    gen.manual_seed(40 + nf)
    polys = [_rand_field(gen, (8, 1 << 16), card) for _ in range(nf)]
    r = _rand_field(gen, (8, 1), card)
    for order in ("message_bind", "message", "bind_message"):
        partial, _ = kernels.launch_product_round(polys, r, order,
                                                  finish=False)
        cols = partial.reshape(nf, 8, -1).sum(dim=-1).T[:, :, None]
        msg, _ = kernels.product_round(polys, r, order)
        assert torch.equal(msg, ops.reduce_cols(cols))


def test_product_sumcheck_card_equals_cpu(card):
    """ProductSumcheck of 2 and 3 factors on K2's live-round orders gives
    the same proof on the card as on the CPU."""
    gen = torch.Generator(device=card)
    gen.manual_seed(3)
    for nf in (2, 3):
        polys = [_rand_field(gen, (8, 1 << 10), card) for _ in range(nf)]
        runs = []
        for ps in (polys, [p.cpu() for p in polys]):
            inst = ProductSumcheck(ps)
            proof, r = BatchedSumcheck.prove([inst], OpeningAccumulator(),
                                             Blake2bTranscript(b"card"))
            runs.append((proof, r, inst.final_claims))
        assert runs[0] == runs[1]


def test_round_step_chained_on_card(card):
    """Twelve chained round_step calls (2^12 down to 2) with seeded
    challenges: every round's message and bound factors equal the plain
    version's."""
    gen = torch.Generator(device=card)
    gen.manual_seed(12)
    polys = tuple(_rand_field(gen, (8, 1 << 12), card) for _ in range(3))
    for _ in range(12):
        r = _rand_field(gen, (8, 1), card)
        msg, bound = round_step(polys, r)
        want = kernels.product_round_plain(polys, r, "message_bind")
        assert torch.equal(msg, want[0])
        assert all(torch.equal(b, w) for b, w in zip(bound, want[1]))
        polys = bound
    assert polys[0].shape == (8, 1)


def test_segment_sum_and_stack_message_card_equal_cpu(card):
    gen = torch.Generator(device=card)
    gen.manual_seed(21)
    a = _rand_field(gen, (8, 3, 5000), card)
    ids = torch.randint(0, 300, (5000,), generator=gen, device=card)
    assert torch.equal(ops.segment_sum_mod(a, ids, 300).cpu(),
                       ops.segment_sum_mod(a.cpu(), ids.cpu(), 300))
    for nf in (18, 3):
        S = _rand_field(gen, (8, nf, 1 << 12), card)
        assert torch.equal(stack_message(S, nf).cpu(),
                           stack_message(S.cpu(), nf))


def test_ra_virtual_card_equals_cpu(card):
    """A d = 2 ra-virtualization instance runs its rounds on K2 (log T + 1
    calls) and gives the same proof on the card as on the CPU."""
    gen = torch.Generator()
    gen.manual_seed(6)
    log_t, log_k = 10, 13
    idx = torch.randint(0, 1 << log_k, (1 << log_t,), generator=gen).numpy()
    r_cyc = [int(x) for x in torch.randint(0, 1 << 62, (log_t,),
                                           generator=gen)]
    r_addr = [int(x) for x in torch.randint(0, 1 << 62, (log_k,),
                                            generator=gen)]
    runs = []
    for dev in (card, "cpu"):
        inst = RaVirtual(chunk_streams(idx, log_k), log_k, r_cyc, r_addr, 7,
                         ("ram_ra", 0), device=dev)
        before = kernels.product_round.launches
        proof, r = BatchedSumcheck.prove([inst], OpeningAccumulator(),
                                         Blake2bTranscript(b"6v"))
        runs.append((proof, r, inst.final_openings))
        if dev is card:
            assert kernels.product_round.launches == before + log_t + 1
    assert runs[0] == runs[1]


def test_prove_stage1_card_equals_cpu(card):
    layout = MemoryLayout(max_input_size=64, max_output_size=64)
    trace = trace_program(f"""
        li   a0, 20
        li   a1, 0
        li   a2, 1
    loop:
        beq  a0, zero, done
        add  a3, a1, a2
        mv   a1, a2
        mv   a2, a3
        addi a0, a0, -1
        j    loop
    done:
        li   t0, {layout.output_start}
        sd   a1, 0(t0)
        li   t1, {layout.termination}
        li   t2, 1
        sd   t2, 0(t1)
    """, layout=layout)
    on_card = prove_prefix(trace, device=card)
    on_cpu = prove_prefix(trace, device="cpu")
    assert dataclasses.asdict(on_card) == dataclasses.asdict(on_cpu)
    assert verify_prefix(on_card, PublicIO.from_trace(trace))


def test_prove_prefix_stage6v_card_equals_cpu(card):
    """The fib guest with a 2 KiB input region (RAM log K = 9): stage 6v
    has four d = 2 instances, on K2 on the card."""
    layout = MemoryLayout(max_input_size=2048, max_output_size=64)
    trace = trace_program(f"""
        li   a0, 20
        li   a1, 0
        li   a2, 1
    loop:
        beq  a0, zero, done
        add  a3, a1, a2
        mv   a1, a2
        mv   a2, a3
        addi a0, a0, -1
        j    loop
    done:
        li   t0, {layout.output_start}
        sd   a1, 0(t0)
        li   t1, {layout.termination}
        li   t2, 1
        sd   t2, 0(t1)
    """, layout=layout)
    on_card = prove_prefix(trace, device=card)
    on_cpu = prove_prefix(trace, device="cpu")
    assert on_card.stage6v_polys
    assert dataclasses.asdict(on_card) == dataclasses.asdict(on_cpu)
    assert verify_prefix(on_card, PublicIO.from_trace(trace))


@pytest.mark.parametrize("members,booleanity,points", [
    (5, True, True), (3, False, True), (1, False, True), (4, False, False)])
def test_grouped_onehot_card_equals_cpu(card, members, booleanity, points):
    """Stage 7/8's grouped instance (booleanity on K1; the value kind's
    cycle rounds on K2) gives the same proof on the card as on the CPU."""
    gen = torch.Generator()
    gen.manual_seed(8 + members)
    log_t, K = 10, 64
    streams = torch.randint(0, K, (members, 1 << log_t), generator=gen)
    r_cyc = [int(x) for x in torch.randint(2, 1 << 62, (log_t,),
                                           generator=gen)]
    q = [int(x) for x in torch.randint(2, 1 << 62, (6,), generator=gen)]
    runs = []
    for dev in (card, "cpu"):
        inst = GroupedOneHot(streams, K, eq.evals(r_cyc, dev),
                             [q if points else None] * members,
                             list(range(members)), 99,
                             [str(i) for i in range(members)],
                             booleanity=booleanity)
        proof, r = BatchedSumcheck.prove([inst], OpeningAccumulator(),
                                         Blake2bTranscript(b"s7"))
        runs.append((proof, r, inst.final_openings))
    assert runs[0] == runs[1]


def test_dense_opening_card_equals_cpu(card):
    gen = torch.Generator()
    gen.manual_seed(9)
    coeffs = [int(x) for x in torch.randint(0, 1 << 62, (1 << 10,),
                                            generator=gen)]
    point = [int(x) for x in torch.randint(0, 1 << 62, (10,), generator=gen)]
    runs = []
    for dev in (card, "cpu"):
        inst = DenseOpening(coeffs, point, 5, "d", device=dev)
        before = kernels.product_round.launches
        proof, r = BatchedSumcheck.prove([inst], OpeningAccumulator(),
                                         Blake2bTranscript(b"s8"))
        runs.append((proof, r, inst.final_openings))
        if dev is card:
            assert kernels.product_round.launches == before + 10 + 1
    assert runs[0] == runs[1]


@pytest.mark.parametrize("advice", [False, True])
def test_prove_card_equals_cpu(card, advice):
    """The whole proof (stages 1-8) of fib, and of fib reading its count
    and seeds from advice regions, has the same bytes on the card as on
    the CPU, and verifies."""
    layout = MemoryLayout(max_input_size=64, max_output_size=64,
                          max_trusted_advice_size=32 if advice else 0,
                          max_untrusted_advice_size=16 if advice else 0)
    load = (f"""
        li   t0, {layout.trusted_advice_start}
        ld   a0, 0(t0)
        li   t0, {layout.untrusted_advice_start}
        ld   a1, 0(t0)
        ld   a2, 8(t0)""" if advice else """
        li   a0, 20
        li   a1, 0
        li   a2, 1""")
    trace = trace_program(load + f"""
    loop:
        beq  a0, zero, done
        add  a3, a1, a2
        mv   a1, a2
        mv   a2, a3
        addi a0, a0, -1
        j    loop
    done:
        li   t0, {layout.output_start}
        sd   a1, 0(t0)
        li   t1, {layout.termination}
        li   t2, 1
        sd   t2, 0(t1)
    """, layout=layout,
        trusted_advice=(20).to_bytes(8, "little") if advice else b"",
        untrusted_advice=(1).to_bytes(16, "little") if advice else b"")
    on_card = prove(trace, device=card)
    on_cpu = prove(trace, device="cpu")
    assert serialize_proof(on_card) == serialize_proof(on_cpu)
    assert verify(on_card, PublicIO.from_trace(trace))


def test_prove_with_dory_card_equals_cpu(card, tmp_path):
    """With a Dory setup (13 variables), the whole proof of a small guest
    -- the commitments and the joint opening proof included -- has the
    same bytes and FS tape on the card (Dory's G1 work on K3) as on the
    CPU (the native library), and verifies."""
    from jolt_tpu_torch.pcs.dory import DorySetup
    layout = MemoryLayout(max_input_size=64, max_output_size=64)
    trace = trace_program(f"""
        li   a1, 21
        li   a2, 34
        add  a3, a1, a2
        xor  a4, a1, a2
        and  a5, a3, a4
        add  a3, a3, a5
        li   t0, {layout.output_start}
        sd   a3, 0(t0)
        li   t1, {layout.termination}
        li   t2, 1
        sd   t2, 0(t1)
    """, layout=layout, min_padded=32)
    setup = DorySetup.generate(13, cache_dir=str(tmp_path))
    on_card = prove(trace, setup=setup, device=card)
    on_cpu = prove(trace, setup=setup, device="cpu")
    assert on_card.opening_proofs and on_card.commitments
    assert serialize_proof(on_card) == serialize_proof(on_cpu)
    assert on_card.fs_tape == on_cpu.fs_tape
    assert verify(on_card, PublicIO.from_trace(trace), setup=setup)


def test_prove_fib_with_dory_k3_route_on_card(card, tmp_path):
    """The fib proof with a 2^16 Dory setup: on the card the K3 route
    launches K3 (bucket_sum, scalar_mul, add, normalize) and gives the
    bytes and FS tape of the native route on the card and of the CPU."""
    from jolt_tpu_torch.pcs.dory import DorySetup
    from jolt_tpu_torch.pcs.scheme import DoryScheme
    from jolt_tpu_torch.prover.prover import required_num_vars
    layout = MemoryLayout(max_input_size=64, max_output_size=64)
    trace = trace_program(f"""
        li   a0, 20
        li   a1, 0
        li   a2, 1
    loop:
        beq  a0, zero, done
        add  a3, a1, a2
        mv   a1, a2
        mv   a2, a3
        addi a0, a0, -1
        j    loop
    done:
        li   t0, {layout.output_start}
        sd   a1, 0(t0)
        li   t1, {layout.termination}
        li   t2, 1
        sd   t2, 0(t1)
    """, layout=layout)
    setup = DorySetup.generate(required_num_vars(trace.padded_length, 0, 0),
                               cache_dir=str(tmp_path))
    kernels.reset_launches()
    on_card = prove(trace, setup=setup, device=card)
    k3 = kernels.k3_launches()
    assert all(k3[f] for f in ("bucket_sum", "scalar_mul", "add",
                               "normalize")), k3
    native = prove(trace, setup=DoryScheme(setup, card, _k3=False),
                   device=card)
    on_cpu = prove(trace, setup=setup, device="cpu")
    blob = serialize_proof(on_card)
    assert blob == serialize_proof(native) == serialize_proof(on_cpu)
    assert on_card.fs_tape == native.fs_tape == on_cpu.fs_tape
    assert verify(on_card, PublicIO.from_trace(trace), setup=setup)


# ---- K3: the G1 kernel (csrc/g1.cu) ---------------------------------------

def _g1_points(n, seed):
    import random
    from jolt_tpu_torch.curve import bn254_host as host
    rng = random.Random(seed)
    return [host.g1_random(rng) for _ in range(n)]


def _equal(P, Q):
    return all(torch.equal(a, b) for a, b in zip(P, Q))


def test_k3_matches_plain_on_card(card):
    """K3's add (with infinity, P + P and P + (-P) lanes, and an infinity
    whose X, Y are not 0), double and 254-bit scalar_mul equal their plain
    versions bit for bit on the same card tensors, one launch each; a
    halving of one tensor is one launch over its two strided halves."""
    import random
    from jolt_tpu_torch.curve import bn254_host as host
    from jolt_tpu_torch.curve import g1
    pts = _g1_points(64, 1)
    pts[1] = None
    other = _g1_points(64, 2)
    other[0] = other[1] = None
    other[2] = pts[2]
    other[3] = host.g1_neg(pts[3])
    P = g1.pack_points(pts, card)
    Q = g1.pack_points(other, card)
    mask = torch.ones(64, dtype=torch.bool, device=card)
    mask[4] = False
    P = g1.mask_points(g1.jacobian_double(P), mask)
    before = kernels.k3_launches()
    got = g1.jacobian_add(P, Q)
    assert _equal(got, g1.jacobian_add_plain(P, Q))
    assert _equal(g1.jacobian_double(got), g1.jacobian_double_plain(got))
    h = g1._halve(got)
    assert _equal(h, g1.jacobian_add_plain(tuple(c[:, :32] for c in got),
                                           tuple(c[:, 32:] for c in got)))
    rng = random.Random(3)
    ks = [rng.randrange(1 << 254) for _ in range(64)]
    words = torch.tensor([[(k >> (32 * w)) & 0xFFFFFFFF for k in ks]
                          for w in range(8)], dtype=torch.int64)
    words = (words - ((words >> 31) << 32)).to(torch.int32).to(card)
    m = g1.batch_scalar_mul(Q, words, 254)
    assert _equal(m, g1.batch_scalar_mul_plain(Q, words, 254))
    torch.cuda.synchronize()
    after = kernels.k3_launches()
    assert {f: after[f] - before[f] for f in after} == {
        "add": 2, "double": 1, "scalar_mul": 1, "normalize": 0,
        "bucket_sum": 0, "bucket_reduce": 0}
    assert g1.unpack_points(m) == [host.g1_mul(p, k)
                                   for p, k in zip(other, ks)]


def test_msm_and_kzg_on_card(card, tmp_path):
    """The device Pippenger MSM at 2^12 lanes equals the host's; the KZG
    setup built on the card has [tau^i] G1 as its powers, and a commit on
    the card equals the same setup's commit on the CPU."""
    import random
    import numpy as np
    from jolt_tpu_torch.curve import bn254_host as host
    from jolt_tpu_torch.curve import g1
    from jolt_tpu_torch.pcs.hyperkzg import DEFAULT_TAU, HyperKZG, KZGSetup
    n = 1 << 12
    pts = _g1_points(n, 4)
    rng = random.Random(5)
    ks = [rng.randrange(host.R) for _ in range(n)]
    raw = b"".join(k.to_bytes(32, "little") for k in ks)
    words = np.frombuffer(raw, dtype="<u4").reshape(n, 8).T
    got = g1.unpack_points(g1.msm(g1.pack_points(pts, card), words, 254))
    assert got == [host.g1_msm_pippenger(pts, ks)]
    setup = KZGSetup.generate(64, device=card, cache_dir=str(tmp_path))
    want = [host.g1_mul(host.G1_GEN, pow(DEFAULT_TAU, i, host.R))
            for i in range(64)]
    assert setup.host_powers() == want
    coeffs = ks[:50]
    assert (HyperKZG(setup).commit_ints(coeffs)
            == HyperKZG(setup.to("cpu")).commit_ints(coeffs))


def test_dory_device_tier_on_card(card, tmp_path):
    """Dory's one-hot commit on the card (the K3 route: one bucket_sum over
    the rows) gives the native route's row hints and commitments."""
    import numpy as np
    from jolt_tpu_torch.pcs.dory import Dory, DorySetup, gt_to_bytes
    setup = DorySetup.generate(10, cache_dir=str(tmp_path))
    rng = np.random.default_rng(6)
    positions = [rng.integers(0, 16, 64).astype(np.int64) * 64
                 + np.arange(64) for _ in range(3)]
    native = Dory(setup, "cpu").commit_onehot_many(positions)
    before = kernels.k3_launches()["bucket_sum"]
    on_card = Dory(setup, card).commit_onehot_many(positions)
    assert kernels.k3_launches()["bucket_sum"] > before
    one = Dory(setup, card).commit_onehot(positions[0])
    for (c, h), (nc, nh) in zip(on_card + [one], native + native[:1]):
        assert h.rows == nh.rows
        assert gt_to_bytes(c.c) == gt_to_bytes(nc.c)


def _card_points(n, seed, card):
    """n affine points [k_i] G on the card (seeded 64-bit k_i), lane 1 at
    infinity, and the same as host points."""
    from jolt_tpu_torch.curve import bn254_host as host
    from jolt_tpu_torch.curve import g1
    gen = torch.Generator().manual_seed(seed)
    words = torch.randint(0, 1 << 31, (2, n), generator=gen,
                          dtype=torch.int32).to(card)
    base = tuple(c.expand(-1, n) for c in g1.pack_points([host.G1_GEN],
                                                          card))
    P = g1.normalize(g1.batch_scalar_mul(base, words, 64))
    P[2][:, 1] = 0
    P[0][:, 1] = P[1][:, 1] = 0
    return P, g1.unpack_points(P)


def test_k3_new_forms_match_plain_on_card(card):
    """normalize (infinity with X, Y kept among the lanes), bucket_sum
    (a segment of every lane, one of a point and its negation, of a point
    twice, of infinity bases, single-lane and empty segments, one long
    enough for three levels) and bucket_reduce at c = 4, 8 and 12 equal
    their plain versions bit for bit on the same card tensors."""
    from jolt_tpu_torch.curve import bn254_host as host
    from jolt_tpu_torch.curve import g1
    n = 1 << 12
    P, pts = _card_points(n, 7, card)
    J = g1.jacobian_double(P)
    J[2][:, 5] = 0                              # infinity, X and Y kept
    before = kernels.k3_launches()
    N = g1.normalize(J)
    assert _equal(N, g1.normalize_plain(J))
    assert g1.unpack_points(tuple(c[:, :8] for c in N)) == [
        None if i in (1, 5) else host.g1_double(p)
        for i, p in enumerate(pts[:8])]
    neg = g1.pack_points([host.g1_neg(pts[2])], card)
    Q = tuple(torch.cat([a, b], 1) for a, b in zip(P, neg))    # lane n: -P2
    lanes = torch.cat([torch.arange(n), torch.tensor([2, n, 3, 3, 1, 1, 4]),
                       torch.arange(0, n, 3)]).to(torch.int32)
    offs = torch.tensor([0, n, n + 2, n + 4, n + 6, n + 7, n + 7,
                         n + 7 + len(range(0, n, 3))])
    S = g1.bucket_sum(Q, lanes.to(card), offs.to(card))
    assert _equal(S, g1.bucket_sum_plain(Q, lanes.to(card), offs.to(card)))
    got = g1.unpack_points(S)
    assert got[1:6] == [None, host.g1_double(pts[3]), None, pts[4], None]
    for c in (4, 8, 12):
        B = tuple(c_.repeat(1, (4 << c) // n + 1)[:, :4 << c]
                  for c_ in g1.jacobian_double(P))
        R = g1.bucket_reduce(B, c)
        assert _equal(R, g1.bucket_reduce_plain(B, c))
    torch.cuda.synchronize()
    after = kernels.k3_launches()
    assert after["normalize"] - before["normalize"] == 1
    assert after["bucket_sum"] - before["bucket_sum"] == 4        # levels
    assert after["bucket_reduce"] - before["bucket_reduce"] == 3


@pytest.mark.parametrize("log_n", [12, 16])
def test_msm_on_card_equals_host(card, log_n):
    """The card's Pippenger (digits, sort and buckets on the card) from
    device words equals the host's MSM as an affine point, and so does a
    commit of the same coefficients through a KZG setup."""
    import random
    from jolt_tpu_torch.curve import bn254_host as host
    from jolt_tpu_torch.curve import g1
    n = 1 << log_n
    P, pts = _card_points(n, log_n, card)
    rng = random.Random(log_n)
    ks = [rng.randrange(host.R) for _ in range(n)]
    ks[:4] = [0, 5, 5, 5]
    raw = b"".join(k.to_bytes(32, "little") for k in ks)
    import numpy as np
    words = torch.from_numpy(np.frombuffer(raw, dtype="<u4").reshape(n, 8)
                             .T.copy().view(np.int32)).to(card)
    want = host.g1_msm_pippenger(pts, ks)
    assert g1.unpack_points(g1.msm(P, words, 254)) == [want]
    for c in (8, 12):
        assert g1.unpack_points(g1.msm_pippenger(P, words, 254, c)) == [want]


def test_kzg_setup_on_card_equals_cpu(card, tmp_path):
    """KZGSetup.generate on the card (scalar_mul, then normalize) gives the
    CPU's powers, affine (Z = R), and a one-hot commit equals the CPU's."""
    import numpy as np
    from jolt_tpu_torch.curve import g1
    from jolt_tpu_torch.pcs.hyperkzg import HyperKZG, KZGSetup
    on_card = KZGSetup.generate(1 << 10, device=card,
                                cache_dir=str(tmp_path / "card"))
    on_cpu = KZGSetup.generate(1 << 10, device="cpu",
                               cache_dir=str(tmp_path / "cpu"))
    g1.check_affine(on_card.g1_powers_dev, "the card's powers")
    assert on_card.host_powers() == on_cpu.host_powers()
    pos = np.array([0, 3, 3, 17, 1000], dtype=np.int64)
    assert (HyperKZG(on_card).commit_positions(pos)
            == HyperKZG(on_cpu).commit_positions(pos))


@pytest.mark.parametrize("npoly,degree", [(2, 2), (3, 3)])
def test_sharded_round_step_on_card_equals_cpu(card, tmp_path, npoly,
                                               degree):
    """`sumcheck/sharded.py:sharded_round_step` at D = 1 on the card (a
    one-rank NCCL mesh, K1's evals, mul, bind and reduce forms on the
    rank's shard) equals its result on plain CPU tensors, message and
    bound polys, bit for bit."""
    import torch.distributed as dist
    from jolt_tpu_torch.parallel import cycle_mesh, shard_mle, unshard_mle
    from jolt_tpu_torch.sumcheck.sharded import sharded_round_step
    rng = np.random.default_rng(npoly * 10 + degree)
    T = 1 << 12
    polys = [ops.pack_ints(_field_ints(rng, T), "cpu") for _ in range(npoly)]
    r = _field_ints(rng, 1)[0]
    # plain tensors in the layout at D = 1: (8, T, 1)
    msg_cpu, bound_cpu = sharded_round_step([p[..., None] for p in polys],
                                            r, degree)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = cycle_mesh(1)
        before = kernels.k1_launches()
        msg, bound = sharded_round_step(
            [shard_mle(p.to(card), mesh) for p in polys], r, degree)
        after = kernels.k1_launches()
        assert torch.equal(msg.full_tensor().cpu(), msg_cpu)
        for b, want in zip(bound, bound_cpu):
            assert torch.equal(unshard_mle(b).cpu(), want[..., 0])
    finally:
        dist.destroy_process_group()
    assert all(after[f] > before[f] for f in ("evals", "mul", "bind",
                                              "reduce"))
