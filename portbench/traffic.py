"""The one traffic generator: a traffic file (`traffic/<name>.json`) is
data, and this module turns it and a seed into the guest runs to prove.

A traffic file holds
  * "guest": the name of an assembly template `guests/<guest>.txt`, with
    `{input_start:#x}`, `{output_start:#x}`, `{termination:#x}` and the
    names of "params" as fields;
  * "params": the template's own values (e.g. {"chain": 114});
  * "memory_layout": {"max_input_size": n, "max_output_size": n};
  * "input": {"kind": "bytes", "length": n} (bytes drawn from the seed) or
    {"kind": "u64", "lo": a, "hi": b} (one little-endian u64 in [a, b));
  * "traces": how many distinct inputs a run proves in turn;
  * "padded_log2": the padded trace length every input must give;
  * "expect" (optional): a second witness of the output that the plain
    reference computes itself (`reference/check.py`).
Input i of seed s is drawn from blake2b("portbench/<s>/<i>"), so the same
seed gives the same inputs and any whole number is a seed.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import List

from .spec import HERE, SpecError

# each side builds the guest from its own MemoryLayout class (the port's,
# or the reference's copy), so neither takes the other's addresses
_LAYOUT_KEYS = ("max_input_size", "max_output_size")


@dataclasses.dataclass(frozen=True)
class GuestRun:
    index: int
    source: str          # the guest's assembly
    inputs: bytes
    max_input_size: int
    max_output_size: int


def _draw(seed: int, index: int, n: int) -> bytes:
    out, ctr = b"", 0
    while len(out) < n:
        out += hashlib.blake2b(f"portbench/{seed}/{index}/{ctr}".encode(),
                               digest_size=64).digest()
        ctr += 1
    return out[:n]


def input_bytes(spec: dict, seed: int, index: int) -> bytes:
    kind = spec["kind"]
    if kind == "bytes":
        return _draw(seed, index, int(spec["length"]))
    if kind == "u64":
        lo, hi = int(spec["lo"]), int(spec["hi"])
        v = lo + int.from_bytes(_draw(seed, index, 8), "little") % (hi - lo)
        return v.to_bytes(8, "little")
    raise SpecError(f"unknown input kind {kind!r}")


def guest_source(traffic: dict, layout) -> str:
    """The guest's assembly for `layout` (an object with input_start,
    output_start and termination)."""
    path = os.path.join(HERE, "guests", f"{traffic['guest']}.txt")
    if not os.path.isfile(path):
        raise SpecError(f"missing guest template portbench/guests/"
                        f"{traffic['guest']}.txt")
    with open(path) as f:
        template = f.read()
    return template.format(input_start=layout.input_start,
                           output_start=layout.output_start,
                           termination=layout.termination,
                           **traffic.get("params", {}))


def guest_runs(traffic: dict, seed: int, layout_cls) -> List[GuestRun]:
    """The run's distinct guest runs: `traffic["traces"]` of them, each
    with its input drawn from (seed, i).  `layout_cls` is the
    MemoryLayout class of the side that asks (the port's or the
    reference's copy), built from the traffic's sizes."""
    sizes = traffic["memory_layout"]
    layout = layout_cls(**{k: int(sizes[k]) for k in _LAYOUT_KEYS})
    source = guest_source(traffic, layout)
    return [GuestRun(i, source, input_bytes(traffic["input"], seed, i),
                     int(sizes["max_input_size"]),
                     int(sizes["max_output_size"]))
            for i in range(int(traffic["traces"]))]
