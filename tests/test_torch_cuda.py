"""The torch port on the card: K1 against its plain version, and the
prover on "cuda" against the prover on "cpu".

These tests need an NVIDIA GPU; without one they skip.  The machine with
the card has no JAX, so this module imports none, and there it runs
without the suite's JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py
"""

import dataclasses

import pytest
import torch

from jolt_tpu_torch import PublicIO, prove_stage1, verify_stage1
from jolt_tpu_torch.field import kernels
from jolt_tpu_torch.riscv.emulator import MemoryLayout
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
    on_card = prove_stage1(trace, device=card)
    on_cpu = prove_stage1(trace, device="cpu")
    assert dataclasses.asdict(on_card) == dataclasses.asdict(on_cpu)
    assert verify_stage1(on_card, PublicIO.from_trace(trace))
