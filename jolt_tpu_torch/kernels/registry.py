"""The backend seam: the prover's relations by slot, swappable at runtime.

Torch counterpart of the JAX package's `kernels/registry.py` (the
reference's `jolt-kernels` backend registry): every heavy unit of the
prover that holds no transcript is a named SLOT whose implementation can be
swapped, and `prove` builds each relation through `get_backend().make(slot,
...)` at the JAX package's sites.  The contract is that proof bytes are
backend-invariant: any mix of slot implementations and tiers gives the same
transcript and the same proof (`tests/test_torch_backend.py`).

`SLOTS` is the JAX package's table, key for key and row for row: each slot's
reference module, and the class of this package that carries it (a
'module:Class' target under `jolt_tpu_torch`) or a note naming the slot or
stage that carries it here.  Every class target resolves; no path of
`prove` makes the "opening" (`SparseOneHotOpening`) or "naive"
(`NaiveExprProver`, host work on Python ints) slots, as in the JAX
package.

Tiers.  `with_tier(slot, "host")` sets `force_host` on the slot's
instances, which sends their whole batched stage to the host engine;
`with_tier(slot, "device")` sets `force_device`, which sends it to the
device tier (`sumcheck/fused.py`) even on CPU tensors, where the round
tail and the kernels run their plain versions -- how the CPU tests reach
that tier.  A stage takes the device tier only when all its instances can
(`sumcheck/fused.py:device_tier`), so the granularity within a stage is
the stage.  `with_tier` is the one way to force a tier: the JAX package's
`JOLT_TPU_BACKEND_TIER` environment parse is not ported.

`prove` builds some relations directly, as the JAX package does: stage
6's `SparseOneHotTableEval`s, stage 6v's `RaVirtual`s and stage 8's
`GroupedOneHot`s.  `apply_tier(slot, inst)` gives each of them the tier of
the slot that names its class here ("bytecode_read_raf",
"ram_ra_virtualization" and "hamming_weight_claim_reduction"), exactly as
`make` gives its own.  `with_every_slot(tier)` is `with_tier` on every
slot that can take the tier: with "device" every slot whose class is a
`FusedInstance` -- every batched stage's loop on the device tier but stage
5i's (`InstructionReadRaf`, whose address rounds are host work in the JAX
package too), and "opening" -- with "host" every slot.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict, Optional

from ..sumcheck.fused import FusedInstance

_PKG = __name__.split(".")[0]
TIERS = ("host", "device")


def _class(path: str) -> type:
    """The class of a 'module:Class' target, imported."""
    mod_name, cls_name = path.split(":")
    return getattr(importlib.import_module(f"{_PKG}.{mod_name}"), cls_name)


def _lazy(path: str) -> Callable:
    """Import-on-first-use factory for a 'module:Class' target."""
    def make(*args, **kwargs):
        return _class(path)(*args, **kwargs)
    make.target = path
    return make


#: slot -> (reference module under jolt-kernels/src/reference/,
#:          the implementation: a 'module:Class' target, or a note naming
#:          the slot/stage that carries the function in this DAG)
SLOTS: Dict[str, tuple] = {
    "spartan_outer": ("spartan_outer.rs",
                      "relations.spartan_outer:SpartanOuterProver"),
    "spartan_product": ("spartan_product.rs",
                        "folded: the 3 product rows prove inside stage-1 "
                        "uni-skip (relations/spartan_outer.py)"),
    "spartan_shift": ("spartan_shift.rs", "relations.shift:ShiftSumcheck"),
    "instruction_read_raf": (
        "instruction_read_raf.rs",
        "relations.instruction_read_raf:InstructionReadRaf"),
    "instruction_ra_virtualization": (
        "instruction_ra_virtualization.rs",
        "folded: lk_ra chunks commit directly at log_k_chunk=8; products "
        "prove inside InstructionReadRaf's address phase"),
    "instruction_input": ("instruction_input.rs",
                          "folded: operand columns open as stage-1 R1CS "
                          "inputs (witness/r1cs_inputs.py)"),
    "instruction_claim_reduction": (
        "instruction_claim_reduction.rs",
        "folded: stage-8 (K, point) grouped opening reduction"),
    "ram_read_write": ("ram_read_write.rs",
                       "relations.ram_sparse:SparseRamReadWriteChecking"),
    "ram_val_check": ("ram_val_check.rs",
                      "relations.ram_sparse:SparseRamValEvaluation"),
    "ram_raf_evaluation": ("ram_raf_evaluation.rs",
                           "relations.ram_sparse:SparseRamRafEvaluation"),
    "ram_output_check": ("ram_output_check.rs",
                         "relations.ram_sparse:SparseRamOutputCheck"),
    "ram_ra_virtualization": ("ram_ra_virtualization.rs",
                              "relations.ra_virtual:RaVirtual"),
    "ram_ra_claim_reduction": (
        "ram_ra_claim_reduction.rs",
        "folded: stage-6v ra-virtualization + stage-8 grouping"),
    "ram_hamming_booleanity": (
        "ram_hamming_booleanity.rs",
        "relations.grouped_onehot:GroupedOneHot"),
    "registers_read_write": (
        "registers_read_write.rs",
        "relations.ram_sparse:SparseRegistersReadWriteChecking"),
    "registers_val_evaluation": (
        "registers_val_evaluation.rs",
        "relations.ram_sparse:SparseRegistersValEvaluation"),
    "registers_claim_reduction": (
        "registers_claim_reduction.rs",
        "folded: register raf instances batch into stage 6 "
        "(prover.py stage6) + stage-8 grouping"),
    "bytecode_read_raf": ("bytecode_read_raf.rs",
                          "relations.ram_sparse:SparseOneHotTableEval"),
    "bytecode_claim_reduction": (
        "bytecode_claim_reduction.rs",
        "folded: bytecode ra virtualization (stage 6v) + stage-8"),
    "booleanity": ("booleanity.rs", "relations.grouped_onehot:GroupedOneHot"),
    "hamming_weight_claim_reduction": (
        "hamming_weight_claim_reduction.rs",
        "relations.grouped_onehot:GroupedOneHot"),
    "inc_claim_reduction": ("inc_claim_reduction.rs",
                            "relations.opening_reduction:DenseOpening"),
    "advice_claim_reduction": (
        "advice_claim_reduction.rs",
        "folded: subcube-aligned advice selector split (prover.py "
        "advice_openings) + stage-8 DenseOpening"),
    "program_image_claim_reduction": (
        "program_image_claim_reduction.rs",
        "relations.program_image:ProgramImageReduction"),
    "precommitted_reduction": (
        "precommitted_reduction.rs",
        "relations.program_image:ProgramImageReduction"),
    "commitment": ("commitment.rs", "pcs.scheme:DoryScheme"),
    "opening": ("opening.rs",
                "relations.opening_reduction:SparseOneHotOpening"),
    "naive": ("naive.rs", "claims.naive:NaiveExprProver"),
}

#: class targets this package does not have yet, and the ROADMAP item
#: (none since A19)
NOT_PORTED: Dict[str, str] = {}

#: slots that resolve to an instantiable class (the rest are folded into
#: a carrying slot, documented above)
_CLASS_SLOTS = {k: v[1] for k, v in SLOTS.items()
                if ":" in v[1] and " " not in v[1]}


@dataclasses.dataclass
class JoltBackend:
    """Per-slot factory table + tier overrides.

    `make(slot, *args)` constructs the slot's prover instance; replacing a
    factory (`with_slot`) or forcing a tier (`with_tier(slot, "host" |
    "device")`) must not change proof bytes."""

    factories: Dict[str, Callable]
    tiers: Dict[str, str] = dataclasses.field(default_factory=dict)

    @classmethod
    def default(cls) -> "JoltBackend":
        return cls({name: _lazy(t) for name, t in _CLASS_SLOTS.items()})

    def with_slot(self, slot: str, factory: Callable) -> "JoltBackend":
        f = dict(self.factories)
        f[slot] = factory
        return JoltBackend(f, dict(self.tiers))

    def with_tier(self, slot: str, tier: str) -> "JoltBackend":
        if tier not in TIERS:
            raise ValueError(f"tier {tier!r} (want one of {TIERS})")
        t = dict(self.tiers)
        t[slot] = tier
        return JoltBackend(dict(self.factories), t)

    def with_every_slot(self, tier: str) -> "JoltBackend":
        """Every slot whose instances can take `tier` forced to it: every
        slot to "host"; to "device", each slot whose class is a
        `FusedInstance` (all but stage 5i's `InstructionReadRaf`, the
        commitment scheme and the naive interpreter)."""
        b = self
        for slot, target in _CLASS_SLOTS.items():
            if tier == "device" and not issubclass(_class(target),
                                                   FusedInstance):
                continue
            b = b.with_tier(slot, tier)
        return b

    def make(self, slot: str, *args, **kwargs):
        return self.apply_tier(slot, self.factories[slot](*args, **kwargs))

    def apply_tier(self, slot: str, inst):
        """Give `inst` the slot's tier (`force_host` / `force_device`), as
        `make` does; for an instance `prove` builds directly, of a class
        that `SLOTS` names for the slot.  Returns `inst`."""
        tier = self.tiers.get(slot)
        if tier == "host":
            # its whole batched stage takes the host engine
            inst.force_host = True
        elif tier == "device":
            if not isinstance(inst, FusedInstance):
                raise ValueError(f"slot {slot!r}: {type(inst).__name__} "
                                 "has no device tier in this port")
            inst.force_device = True
        return inst


_BACKEND: Optional[JoltBackend] = None


def get_backend() -> JoltBackend:
    global _BACKEND
    if _BACKEND is None:
        _BACKEND = JoltBackend.default()
    return _BACKEND


def set_backend(backend: Optional[JoltBackend]) -> None:
    """Install a backend (None resets to the default on next use)."""
    global _BACKEND
    _BACKEND = backend


def default_backend() -> JoltBackend:
    return JoltBackend.default()
