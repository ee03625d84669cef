"""The port's backend seam (`jolt_tpu_torch/kernels/registry.py`), on the
CPU.

Its slot table is the JAX package's, key for key; every class slot
resolves to a class of the port, and the two slots no `prove` path makes
("opening", "naive") build through the seam.  `prove` builds each relation
through the seam at the JAX package's slot sites, and proof bytes are
backend-invariant: on the small guest of the JAX package's
`tests/test_backend_registry.py` at `setup=None`, slots forced to the host
tier with every slot wrapped (swapped) give the default's bytes.  The
default's bytes are held to the JAX package's by the port's other tests,
so no JAX `prove` runs here; stage 1's slots forced to the device tier
are held to the host engine and the JAX package in
`tests/test_torch_stage1.py`, every stage's in
`tests/test_torch_fused_stages.py`.  `apply_tier` gives the instances
`prove` builds directly (stages 6, 6v and 8) their slot's tier: forcing
the slots of stages 6 and 8 to the device tier takes those two stages,
and no other, onto it with the default's bytes.
"""

import importlib

import pytest
import torch

from jolt_tpu.kernels import SLOTS as JAX_SLOTS

import jolt_tpu_torch as jt
from jolt_tpu_torch.kernels import JoltBackend, SLOTS, get_backend, set_backend
from jolt_tpu_torch.kernels.registry import _CLASS_SLOTS, NOT_PORTED
from jolt_tpu_torch.proof_io import serialize_proof
from jolt_tpu_torch.riscv.emulator import MemoryLayout
from jolt_tpu_torch.sumcheck.fused import FusedInstance
from jolt_tpu_torch.tracer import trace_program
from jolt_tpu_torch.utils import profiling

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


class FusedProbe(FusedInstance):
    """An instance of no relation, for the tier flags alone."""

    num_rounds = 0

    def input_claim(self, accumulator):  # pragma: no cover
        return 0

    def message_evals_dev(self, round):  # pragma: no cover
        raise NotImplementedError

    def ingest_challenge(self, r, round):  # pragma: no cover
        raise NotImplementedError

    def expected_output_claim(self, accumulator, r):  # pragma: no cover
        raise NotImplementedError


def test_slots_equal_the_jax_packages():
    assert list(SLOTS) == list(JAX_SLOTS)
    assert SLOTS == JAX_SLOTS


def _build_args(slot):
    """Small constructor arguments for the slots no `prove` path makes."""
    if slot == "opening":
        return ([1, 0, 3, 2], 4, [5, 6, 7, 8], 1, "m"), {"device": "cpu"}
    if slot == "naive":
        from jolt_tpu_torch.claims import Poly
        return (Poly("a") * Poly("b"), {"a": [1, 2], "b": [3, 4]}), {}
    return None


@pytest.mark.parametrize("slot", sorted(_CLASS_SLOTS))
def test_every_class_slot_resolves_and_builds(slot):
    """Every class slot's factory resolves to a class of the port (none is
    left unported), and the two slots no `prove` path makes build their
    instances through the seam."""
    assert not NOT_PORTED
    factory = JoltBackend.default().factories[slot]
    mod_name, cls_name = factory.target.split(":")
    cls = getattr(importlib.import_module(f"jolt_tpu_torch.{mod_name}"),
                  cls_name)
    assert isinstance(cls, type)
    args = _build_args(slot)
    if args is not None:
        inst = JoltBackend.default().with_tier(slot, "host").make(
            slot, *args[0], **args[1])
        assert type(inst) is cls and inst.force_host


def test_tiers_are_host_or_device():
    with pytest.raises(ValueError, match="tier"):
        JoltBackend.default().with_tier("spartan_outer", "scan")
    # a slot whose instances have no device tier refuses to be forced there
    backend = (JoltBackend.default()
               .with_slot("registers_read_write", lambda: object())
               .with_tier("registers_read_write", "device"))
    with pytest.raises(ValueError, match="no device tier"):
        backend.make("registers_read_write")


def test_with_every_slot_forces_each_slot_that_can_take_the_tier():
    device = JoltBackend.default().with_every_slot("device").tiers
    assert set(device) == (set(_CLASS_SLOTS)
                           - {"instruction_read_raf", "commitment", "naive"})
    assert "opening" in device
    assert set(device.values()) == {"device"}
    host = JoltBackend.default().with_every_slot("host").tiers
    assert set(host) == set(_CLASS_SLOTS)
    assert set(host.values()) == {"host"}


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


def test_apply_tier_gives_a_directly_built_instance_its_slots_tier():
    backend = (JoltBackend.default().with_tier("bytecode_read_raf", "device")
               .with_tier("ram_ra_virtualization", "host"))
    for slot, tier in (("bytecode_read_raf", "device"),
                       ("ram_ra_virtualization", "host"),
                       ("hamming_weight_claim_reduction", None)):
        inst = backend.apply_tier(slot, FusedProbe())
        assert getattr(inst, "force_device", False) == (tier == "device")
        assert getattr(inst, "force_host", False) == (tier == "host")
    with pytest.raises(ValueError, match="no device tier"):
        backend.apply_tier("bytecode_read_raf", object())


def test_prove_forces_the_directly_built_classes(guest):
    """Stage 6's `SparseOneHotTableEval`s and stage 8's `GroupedOneHot`s
    are built outside `make`: forcing their slots (and stage 8's dense
    openings') to the device tier sends stages 6 and 8, and no other, to
    it, with the default's bytes."""
    backend = JoltBackend.default()
    for slot in ("bytecode_read_raf", "hamming_weight_claim_reduction",
                 "inc_claim_reduction"):
        backend = backend.with_tier(slot, "device")
    set_backend(backend)
    try:
        with profiling.recording() as prof:
            proof = jt.prove(guest[0], device="cpu")
    finally:
        set_backend(None)
    assert prof.tally("d2h", within="fused.fetch") == 2
    assert serialize_proof(proof) == serialize_proof(guest[1])
