"""The seeded inputs repeat for one seed and differ between seeds."""

import pytest

from portbench import traffic
from portbench.reference.jolt.riscv.emulator import MemoryLayout
from portbench.spec import load_cell

SHA2 = load_cell("dory-sha2-2p18").traffic


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**40 + 3])
def test_inputs_repeat_for_one_seed(seed):
    a = traffic.guest_runs(SHA2, seed, MemoryLayout)
    b = traffic.guest_runs(SHA2, seed, MemoryLayout)
    assert a == b
    assert len({g.inputs for g in a}) == SHA2["traces"]
    assert all(len(g.inputs) == 32 for g in a)


def test_inputs_differ_between_seeds():
    seen = set()
    for seed in (1, 2, 3, 2**31, 2**31 + 1):
        for g in traffic.guest_runs(SHA2, seed, MemoryLayout):
            seen.add(g.inputs)
    assert len(seen) == 5 * SHA2["traces"]


def test_u64_inputs_stay_in_range():
    spec = {"kind": "u64", "lo": 100, "hi": 110}
    vals = {int.from_bytes(traffic.input_bytes(spec, s, i), "little")
            for s in range(20) for i in range(3)}
    assert vals <= set(range(100, 110)) and len(vals) > 3


def test_template_renders_the_params():
    src = traffic.guest_source(SHA2, MemoryLayout(64, 64))
    assert "li   a6, 114" in src and "{" not in src
