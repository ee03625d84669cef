"""Where `prove` spends its time on one CUDA device.

    python3 -m jolt_tpu_torch.profile_prefix

Traces the main path's workload (`workload.sha2_chain_trace`: the
sha2-chain guest at chain=114, ~2^18 cycles), runs `prove(trace,
setup=None, device="cuda")` (stages 1-8; the name is the module's from
when the port reached stage 6v) once to warm up (kernel builds,
allocator), then once under `torch.profiler`, and prints one JSON line:
the wall time of each stage (inflated by the profiler's own cost), the
summed device time of all kernels and copies, the device's busy share of
the wall time, and per stage (witness extraction, s1 ... s8) its device
time, busy share and K1 (per form) and K2 launches; K1's launches and device time per form (`k1_mul`, ..,
`k1_reduce`), K2's launches and device time, K1's kernel-only time per
launch shape beside that shape's bound, the device kernels that are
neither K1 nor K2, and the ten operations with the most device time.  A
third run under `cProfile` gives the host's split: the cumulative seconds
of the port's functions that take the most (`host_top`; the suffix
evaluation's worker threads are not profiled, their wait is in their
caller).

A stage's device time is that of the kernels and copies that start between
the end of the stage before and its own end (`workload.stage_device_s`).

K1's launches are matched to their shapes by order: every K1 launch
appends its form and operand shapes to `kernels.record`, and the card runs
the launches of one stream in the order they were made.  A form whose
traced kernels do not number its launches (the tracer dropped one) gets no
per-shape times; its `traced` count says so.
"""

from __future__ import annotations

import cProfile
import collections
import json
import pstats
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from . import prove
from .field import kernels
from .workload import (card_line, k1_bound_ms, sha2_chain_trace,
                       stage_device_s, timed_stages)

K2_KERNELS = ("round_kernel", "finish_kernel")


def _k1_form(name: str):
    """The K1 form a device kernel's name belongs to, or None."""
    for form in kernels.FORMS:
        if f"k1_{form}" in name:
            return form
    return None


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_prefix needs a CUDA device")
    trace = sha2_chain_trace()
    prove(trace, device="cuda")                        # warm-up
    torch.cuda.synchronize()

    def run():
        prove(trace, device="cuda")
        torch.cuda.synchronize()

    kernels.reset_launches()
    kernels.record = []
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, stages, _, stage_launches = timed_stages(run)
            wall = time.perf_counter() - t0
    finally:
        records, kernels.record = kernels.record, None
    stage_s = stage_device_s(prof)
    # kernels and copies on the card (one stream: their times do not overlap)
    by_name = {}
    k1_events = collections.defaultdict(list)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            c, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (c + 1, us + e.time_range.elapsed_us())
            form = _k1_form(e.name)
            if form is not None:
                k1_events[form].append(e)
    rows = sorted(((k, c, us) for k, (c, us) in by_name.items()),
                  key=lambda r: -r[2])
    device_us = sum(us for _, _, us in rows)
    k2_rows = [r for r in rows if any(k in r[0] for k in K2_KERNELS)]
    others = [r for r in rows if _k1_form(r[0]) is None
              and not any(k in r[0] for k in K2_KERNELS)]
    # K1 per form, and per launch shape within each form
    launches = kernels.k1_launches()
    k2_calls = kernels.product_round.launches
    per_shape = collections.defaultdict(lambda: [0, 0.0])
    k1_forms = {}
    for form in kernels.FORMS:
        keys = [k for f, k in records if f == form]
        events = sorted(k1_events[form], key=lambda e: e.time_range.start)
        # the tracer may drop an event; then the order no longer matches
        # launches to shapes, and the form has no per-shape times
        if len(events) == len(keys):
            for key, e in zip(keys, events):
                per_shape[(form, key)][0] += 1
                per_shape[(form, key)][1] += e.time_range.elapsed_us()
        k1_forms[form] = {
            "launches": launches[form], "traced": len(events),
            "device_s": sum(e.time_range.elapsed_us() for e in events) / 1e6}
    k1_shapes = []
    for (form, key), (count, us) in sorted(per_shape.items(),
                                           key=lambda kv: -kv[1][1]):
        bound, by = k1_bound_ms(form, key)
        mean_ms = us / count / 1e3
        k1_shapes.append({"form": form, "key": repr(key), "launches": count,
                          "device_s": us / 1e6, "mean_ms": mean_ms,
                          "bound_ms": bound, "bound_by": by,
                          "share_of_bound": bound / mean_ms})
    # the host's split, from a third run under cProfile
    host = cProfile.Profile()
    host.runcall(run)
    host_top = [
        {"function": f"{file.split('jolt_tpu_torch/')[-1]}:{line}({name})",
         "calls": nc, "cum_s": ct}
        for (file, line, name), (_, nc, _, ct, _) in sorted(
            pstats.Stats(host).stats.items(), key=lambda kv: -kv[1][3])
        if "jolt_tpu_torch" in file][:40]
    print(json.dumps({
        "card": card_line(),
        "cycles": trace.length, "padded_length": trace.padded_length,
        "wall_s": wall, "stage_s": stages,
        "device_busy_s": device_us / 1e6,
        "device_busy_share": device_us / 1e6 / wall,
        "stages": {label: {
            "wall_s": stages.get(label), "device_s": dev_s,
            "busy_share": (dev_s / stages[label] if stages.get(label)
                           else None),
            **stage_launches.get(label, {})}
            for label, dev_s in stage_s.items()},
        "k1_launches": sum(launches.values()),
        "k1_device_s": sum(f["device_s"] for f in k1_forms.values()),
        "k1_forms": k1_forms,
        "k2_calls": k2_calls,
        "k2_kernel_launches": sum(c for _, c, _ in k2_rows),
        "k2_device_s": sum(us for _, _, us in k2_rows) / 1e6,
        "other_kernels": sum(c for k, c, _ in others if "Memcpy" not in k
                             and "Memset" not in k),
        "k1_shapes": k1_shapes,
        "top_device_ops": [{"op": k[:80], "count": c, "device_s": us / 1e6}
                           for k, c, us in rows[:10]],
        "top_other_ops": [{"op": k[:80], "count": c, "device_s": us / 1e6}
                          for k, c, us in others[:10]],
        "host_top": host_top,
    }))


if __name__ == "__main__":
    main()
