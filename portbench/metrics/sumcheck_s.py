"""Seconds a prove spends in the sumcheck stages s1 ... s8: the sum of
their root spans (`utils/profiling.py`), the mean over the window's
proves."""

from ._common import SUMCHECK_STAGES, mean

LAYER = "sumcheck stages"
UNIT = "s"
MOVES = "prove_cycles_per_s"


def read(window):
    return mean(sum(spans[s] for s in SUMCHECK_STAGES)
                if all(s in spans for s in SUMCHECK_STAGES) else None
                for spans in window.spans)
