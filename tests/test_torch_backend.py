"""The port's backend seam (`jolt_tpu_torch/kernels/registry.py`), on the
CPU.

Its slot table is the JAX package's, key for key; every class slot
resolves to a class of the port but the two the port does not have yet
(ROADMAP A19), whose factories raise.  `prove` builds each relation
through the seam at the JAX package's slot sites, and proof bytes are
backend-invariant: on the small guest of the JAX package's
`tests/test_backend_registry.py` at `setup=None`, slots forced to the host
tier with every slot wrapped (swapped) give the default's bytes.  The
default's bytes are held to the JAX package's by the port's other tests,
so no JAX `prove` runs here; stage 1's slots forced to the device tier
are held to the host engine and the JAX package in
`tests/test_torch_stage1.py`.
"""

import importlib

import pytest
import torch

from jolt_tpu.kernels import SLOTS as JAX_SLOTS

import jolt_tpu_torch as jt
from jolt_tpu_torch.kernels import JoltBackend, SLOTS, get_backend, set_backend
from jolt_tpu_torch.kernels.registry import NOT_PORTED
from jolt_tpu_torch.proof_io import serialize_proof
from jolt_tpu_torch.riscv.emulator import MemoryLayout
from jolt_tpu_torch.tracer import trace_program

torch.set_num_threads(1)

L = MemoryLayout(max_input_size=64, max_output_size=64)
GUEST = f"""
    li   a0, 6
    li   a1, 7
    mul  a2, a0, a1
    li   t0, {L.output_start}
    sd   a2, 0(t0)
    li   t1, {L.termination}
    li   t2, 1
    sd   t2, 0(t1)
"""
# the slots `prove` makes at setup=None without the committed image (the
# JAX package's sites but "program_image_claim_reduction")
PROVE_SLOTS = {"spartan_outer", "spartan_shift", "registers_read_write",
               "registers_val_evaluation", "ram_read_write",
               "ram_raf_evaluation", "ram_val_check", "ram_output_check",
               "instruction_read_raf", "booleanity",
               "ram_hamming_booleanity", "inc_claim_reduction"}


def test_slots_equal_the_jax_packages():
    assert list(SLOTS) == list(JAX_SLOTS)
    assert SLOTS == JAX_SLOTS


def test_class_slots_resolve_but_the_unported_raise():
    factories = JoltBackend.default().factories
    assert set(NOT_PORTED) == {"opening", "naive"}
    assert set(NOT_PORTED) <= set(factories)
    for name, factory in factories.items():
        if name in NOT_PORTED:
            with pytest.raises(NotImplementedError, match="A19"):
                factory()
            continue
        mod_name, cls_name = factory.target.split(":")
        cls = getattr(importlib.import_module(f"jolt_tpu_torch.{mod_name}"),
                      cls_name)
        assert isinstance(cls, type), name


def test_tiers_are_host_or_device():
    with pytest.raises(ValueError, match="tier"):
        JoltBackend.default().with_tier("spartan_outer", "scan")
    # a slot whose instances have no device tier refuses to be forced there
    backend = (JoltBackend.default()
               .with_slot("registers_read_write", lambda: object())
               .with_tier("registers_read_write", "device"))
    with pytest.raises(ValueError, match="no device tier"):
        backend.make("registers_read_write")


def test_set_backend_installs_and_resets():
    mine = JoltBackend.default().with_tier("booleanity", "host")
    set_backend(mine)
    try:
        assert get_backend() is mine
    finally:
        set_backend(None)
    assert get_backend() is not mine and not get_backend().tiers


@pytest.fixture(scope="module")
def guest():
    """The guest's trace and the default backend's proof."""
    tr = trace_program(GUEST, layout=L)
    set_backend(None)
    return tr, jt.prove(tr, device="cpu")


@pytest.fixture(scope="module")
def mixed(guest):
    """One `prove` with every class slot wrapped in a factory that records
    its calls (a swapped implementation) and four slots forced to the host
    tier: its proof bytes and the slots it made."""
    calls = []
    backend = JoltBackend.default()
    for name, factory in backend.factories.items():
        def wrapped(*args, _name=name, _factory=factory, **kwargs):
            calls.append(_name)
            return _factory(*args, **kwargs)
        backend = backend.with_slot(name, wrapped)
    for name in ("registers_read_write", "booleanity", "spartan_outer",
                 "spartan_shift"):
        backend = backend.with_tier(name, "host")
    set_backend(backend)
    try:
        return serialize_proof(jt.prove(guest[0], device="cpu")), calls
    finally:
        set_backend(None)


def test_host_forced_and_swapped_slots_leave_proof_bytes_unchanged(guest,
                                                                    mixed):
    assert mixed[0] == serialize_proof(guest[1])


def test_prove_makes_the_jax_packages_slots(mixed):
    """`prove` made its relations through the seam, at the slots of the
    JAX package's sites."""
    assert set(mixed[1]) == PROVE_SLOTS
