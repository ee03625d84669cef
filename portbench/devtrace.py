"""Reduces a `torch.profiler` trace of the measured window (CUDA activity
only) to what the per-layer metrics and the breakdown read: the device's
busy time (the union of kernel, copy and set intervals), its idle gaps,
the time of each device operation by name, and K1's launches in order.

Kineto stamps device events in Unix nanoseconds; the harness takes
`time.time_ns()` beside `time.perf_counter()` at the window's start, which
maps a device instant onto the host's span clock.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Tuple


@dataclasses.dataclass
class DeviceTrace:
    busy_s: float                    # union of device intervals in window
    window_s: float
    ops_s: Dict[str, float]          # device seconds by operation name
    gaps: List[Tuple[int, int]]      # idle intervals in window (Unix ns)
    k1_s: Dict[str, List[float]]     # K1 form -> each launch's seconds
    n_events: int


# K1's kernels (`csrc/mont_mul.cu`): one a form and column count, named
# k1_<form>_v1 / _v2 and k1_reduce; the trace may give them demangled
# with their namespace and parameters
_K1_NAME = re.compile(r"(?:^|[^\w])k1_(mul|add|sub|bind|evals|reduce)"
                      r"(?:_v[12])?(?:$|[^\w])")


def k1_form(name: str):
    """`k1_mul_v1` -> "mul", `(anonymous namespace)::k1_reduce(Launch)`
    -> "reduce"; None if the kernel is not K1's."""
    m = _K1_NAME.search(name)
    return m.group(1) if m else None


def _device_events(prof) -> List[Tuple[str, int, int]]:
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        start = e.start_ns()
        out.append((e.name(), start, start + e.duration_ns()))
    out.sort(key=lambda t: t[1])
    return out


def reduce(prof, lo_ns: int, hi_ns: int) -> DeviceTrace:
    """The device activity of `prof` clipped to [lo_ns, hi_ns]."""
    events = _device_events(prof)
    ops: Dict[str, float] = {}
    k1: Dict[str, List[float]] = {}
    gaps: List[Tuple[int, int]] = []
    busy, cursor = 0, lo_ns
    for name, s, e in events:
        ops[name] = ops.get(name, 0.0) + (e - s) / 1e9
        form = k1_form(name)
        if form is not None:
            k1.setdefault(form, []).append((e - s) / 1e9)
        s, e = max(s, lo_ns), min(e, hi_ns)
        if e <= s or e <= cursor:
            continue
        if s > cursor:
            gaps.append((cursor, s))
        busy += e - max(s, cursor)
        cursor = e
    if cursor < hi_ns:
        gaps.append((cursor, hi_ns))
    return DeviceTrace(busy / 1e9, (hi_ns - lo_ns) / 1e9, ops, gaps, k1,
                       len(events))
