"""The torch port on the card: K1 (every form: mul, add, sub, bind, evals,
reduce) and K2 (every pass order, 2 and 3 factors, and its on-card finish
of the message) against their plain versions, the segment sums and the
stacked product message of stage 5i, the ra virtualization of stage 6v and
the grouped one-hot and dense-opening instances of stages 7 and 8 on
"cuda" against "cpu", and the prover on "cuda" against the prover on "cpu"
(stages 1-6v, with and without stage-6v instances; the whole proof's bytes,
with and without advice regions, and with a Dory setup).

These tests need an NVIDIA GPU; without one they skip.  The machine with
the card has no JAX, so this module imports none, and there it runs
without the suite's JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py
"""

import dataclasses

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
from jolt_tpu_torch.tracer import trace_program

pytestmark = pytest.mark.cuda


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
    same bytes and FS tape on the card as on the CPU, and verifies."""
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
        "add": 2, "double": 1, "scalar_mul": 1}
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


def test_dory_device_tier_on_card(card, tmp_path, monkeypatch):
    """Dory's one-hot commit on the card (the device segmented scan) gives
    the native tier's row hints and commitments."""
    import numpy as np
    from jolt_tpu_torch.pcs.dory import Dory, DorySetup, gt_to_bytes
    setup = DorySetup.generate(10, cache_dir=str(tmp_path))
    rng = np.random.default_rng(6)
    positions = [rng.integers(0, 16, 64).astype(np.int64) * 64
                 + np.arange(64) for _ in range(3)]
    native = Dory(setup, "cpu").commit_onehot_many(positions)
    monkeypatch.setenv("JOLT_TPU_NO_NATIVE_PAIRING", "1")
    before = kernels.k3_launches()["add"]
    on_card = Dory(setup, card).commit_onehot_many(positions)
    assert kernels.k3_launches()["add"] > before
    one = Dory(setup, card).commit_onehot(positions[0])
    for (c, h), (nc, nh) in zip(on_card + [one], native + native[:1]):
        assert h.rows == nh.rows
        assert gt_to_bytes(c.c) == gt_to_bytes(nc.c)
