"""Seconds a prove spends in the set-up of the sumcheck stages s1 ... s8:
the `stage.setup` spans (everything a batched stage does before its
rounds: instances, schedules, tables, input claims; `prover/prover.py`)
under the ten stage roots, the mean over the window's proves."""

from ._common import SUMCHECK_STAGES, mean
from ._trees import trees

LAYER = "sumcheck stages"
UNIT = "s"
MOVES = "prove_cycles_per_s"


def read(window):
    proves = trees(window)
    if proves is None:
        return None
    return mean(sum(c.wall_s for r in roots if r.name in SUMCHECK_STAGES
                    for c in r.children if c.name == "stage.setup")
                for roots in proves)
