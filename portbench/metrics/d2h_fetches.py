"""Device-to-host copies a prove makes: the counter `d2h` (`ops.host`, the
prove path's one way to read the card's values) summed over the prove's
span tree, the mean over the window's proves.  Each is a wait for the
card: one a host-engine round with a device message, one a device-tier
stage, and each of the host's reads in set-up and Dory."""

from ._common import mean
from ._trees import counted, trees

LAYER = "device"
UNIT = "fetches"
MOVES = "prove_cycles_per_s"


def read(window):
    proves = trees(window)
    if proves is None:
        return None
    return mean(counted(roots, "d2h") for roots in proves)
