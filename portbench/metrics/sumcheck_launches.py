"""Kernel launches a prove makes in the sumcheck stages s1 ... s8: K1, K2
and K4, from the port's counters read at each stage's end
(`prover.stage_hooks`), the mean over the window's proves.  An exact
count: the stages are launch-bound on the host."""

from ._common import SUMCHECK_STAGES, mean

LAYER = "sumcheck stages"
UNIT = "launches"
MOVES = "prove_cycles_per_s"


def read(window):
    return mean(sum(sum(stages[s].values()) for s in SUMCHECK_STAGES)
                if all(s in stages for s in SUMCHECK_STAGES) else None
                for stages in window.stage_launches)
