"""The share of the window in which no kernel, copy or set ran on the
card: 100 minus the union of the device intervals of the `torch.profiler`
trace over the window's wall time."""

LAYER = "device"
UNIT = "%"
MOVES = "prove_cycles_per_s"


def read(window):
    if window.device is None or window.device.window_s <= 0:
        return None
    return 100.0 * (1.0 - window.device.busy_s / window.device.window_s)
