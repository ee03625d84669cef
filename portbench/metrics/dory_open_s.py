"""Seconds a prove spends in the root span `stage8-openings` of the port's
profiler (`utils/profiling.py`), the mean over the window's proves."""

from ._common import span_mean

LAYER = "PCS Dory"
UNIT = "s"
MOVES = "prove_cycles_per_s"


def read(window):
    return span_mean(window, "stage8-openings")
