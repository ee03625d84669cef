"""Helpers the per-layer readers share: a mean over the window's proves."""

from __future__ import annotations

from typing import Iterable, Optional

# the root spans of `prove` (utils/profiling.py) that make up the sumcheck
# stages s1 ... s8
SUMCHECK_STAGES = ("stage1-spartan", "stage1s-shift", "stage2-reg-rw",
                   "stage3-reg-val", "stage4-5-ram", "stage5i-instr-lookups",
                   "stage6-bytecode", "stage6v-ra-virtual",
                   "stage7-booleanity", "stage8-reduction")


def mean(values: Iterable[Optional[float]]) -> Optional[float]:
    """The mean of the values, or None where any prove lacks one (a reader
    that finds nothing to read returns nothing)."""
    values = list(values)
    if not values or any(v is None for v in values):
        return None
    return sum(values) / len(values)


def span_mean(window, name: str) -> Optional[float]:
    return mean(spans.get(name) for spans in window.spans)
