"""K3's share of its roofline over the window: the least time of each K3
launch's work (`portbench/bounds_k3.py`, frozen from the port's
`workload.k3_bound_ms`, applied to the launch records "k3_<form>" in
`kernels.record`) summed, over the device time of the traced `k3_<form>`
kernels.  Paired by form: a form with records and no traced time, or
traced time and no records, is left out of both sums.  The device trace
keeps each operation's total time, not each launch's, so the launches are
not matched one by one (K1's reader does that for K1)."""

import re

from .. import bounds_k3

LAYER = "kernels"
UNIT = "%"
MOVES = "prove_cycles_per_s"

_K3_NAME = re.compile(r"(?:^|[^\w])k3_(" + "|".join(bounds_k3.FORMS)
                      + r")(?:$|[^\w])")


def read(window):
    if window.device is None:
        return None
    keys = {}
    for form, key in window.k1_records:
        if form.startswith("k3_"):
            keys.setdefault(form[3:], []).append(key)
    spent = {}
    for name, seconds in window.device.ops_s.items():
        m = _K3_NAME.search(name)
        if m:
            spent[m.group(1)] = spent.get(m.group(1), 0.0) + seconds
    least = total = 0.0
    for form, ks in keys.items():
        if spent.get(form, 0.0) <= 0:
            continue
        least += sum(bounds_k3.k3_bound_ms(form, k)[0] for k in ks) / 1e3
        total += spent[form]
    if total <= 0:
        return None
    return 100.0 * least / total
