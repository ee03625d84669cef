"""MiB a prove copies from the host to the card: the counter `h2d_bytes`
(`ops.upload`, the prove path's one way to put host data on the card)
summed over the prove's span tree, over 2^20, the mean over the window's
proves."""

from ._common import mean
from ._trees import counted, trees

LAYER = "device"
UNIT = "MiB"
MOVES = "prove_cycles_per_s"


def read(window):
    proves = trees(window)
    if proves is None:
        return None
    return mean(counted(roots, "h2d_bytes") / 2**20 for roots in proves)
