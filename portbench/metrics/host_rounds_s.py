"""Seconds a prove spends in the host engine's round loops of the sumcheck
stages s1 ... s8: the `engine.rounds` spans (`sumcheck/engine.py`, from a
stage's input claims through its last round) under the ten stage roots,
the mean over the window's proves.  At the Dory cell that is stage 5i,
whose address rounds are host algebra; the other stages take the device
tier (`fused.rounds`)."""

from ._common import SUMCHECK_STAGES, mean
from ._trees import trees, walk

LAYER = "sumcheck stages"
UNIT = "s"
MOVES = "prove_cycles_per_s"


def read(window):
    proves = trees(window)
    if proves is None:
        return None
    return mean(sum(s.wall_s for r in roots if r.name in SUMCHECK_STAGES
                    for s in walk(r) if s.name == "engine.rounds")
                for roots in proves)
