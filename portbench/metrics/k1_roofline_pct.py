"""K1's share of its roofline over the window: the least time of each K1
launch's work (`portbench/bounds.py`, frozen from the port's
`workload.k1_bound_ms`, applied to the port's launch records
`kernels.record`) summed, over the device time of the same launches in
the trace.  Launches are paired by form, in order; a form whose traced
launches do not match its records in number is left out of both sums, so
numerator and denominator always cover the same launches."""

from .. import bounds

LAYER = "kernels"
UNIT = "%"
MOVES = "prove_cycles_per_s"


def read(window):
    if window.device is None:
        return None
    by_form = {}
    for form, key in window.k1_records:
        by_form.setdefault(form, []).append(key)
    least = spent = 0.0
    for form, keys in by_form.items():
        times = window.device.k1_s.get(form, [])
        if len(times) != len(keys):
            continue
        least += sum(bounds.k1_bound_ms(form, k)[0] for k in keys) / 1e3
        spent += sum(times)
    if spent <= 0:
        return None
    return 100.0 * least / spent
