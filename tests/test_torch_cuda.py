"""The torch port on the card: K1 and K2 (every pass order, 2 and 3
factors, and its on-card finish of the message) against their plain
versions, and the prover on "cuda" against the prover on "cpu".

These tests need an NVIDIA GPU; without one they skip.  The machine with
the card has no JAX, so this module imports none, and there it runs
without the suite's JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py
"""

import dataclasses

import pytest
import torch

from jolt_tpu_torch import PublicIO, prove_prefix, verify_prefix
from jolt_tpu_torch.field import kernels, ops
from jolt_tpu_torch.riscv.emulator import MemoryLayout
from jolt_tpu_torch.sumcheck.engine import BatchedSumcheck, OpeningAccumulator
from jolt_tpu_torch.sumcheck.product import ProductSumcheck, round_step
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
