"""Where `prove_prefix` spends its time on one CUDA device.

    python3 -m jolt_tpu_torch.profile_prefix

Traces the main path's workload (`workload.sha2_chain_trace`: the
sha2-chain guest at chain=114, ~2^18 cycles), runs `prove_prefix` once to
warm up (kernel builds, allocator), then once under `torch.profiler`, and
prints one JSON line: the wall time of each stage (inflated by the
profiler's own cost), the summed device time of all kernels and copies, the
device's busy share of the wall time, K1's and K2's launches and device
time, K1's kernel-only time per launch shape beside that shape's bound, and
the ten operations with the most device time.

K1's launches are matched to their shapes by order: every Montgomery
product of the path goes through `ops.mont_mul`, which records its operand
shapes here, and the card runs the launches of one stream in the order
they were made.
"""

from __future__ import annotations

import collections
import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from . import prove_prefix
from .field import kernels, ops
from .workload import card_line, k1_bound_ms, sha2_chain_trace, timed_stages

K1_KERNEL = "mont_mul_kernel"
K2_KERNELS = ("round_kernel", "finish_kernel")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_prefix needs a CUDA device")
    trace = sha2_chain_trace()
    prove_prefix(trace, device="cuda")                 # warm-up
    torch.cuda.synchronize()

    launch_shapes = []
    field_mul = ops.mont_mul

    def recording(a, b):
        launch_shapes.append((tuple(a.shape), tuple(b.shape)))
        return field_mul(a, b)

    def run():
        prove_prefix(trace, device="cuda")
        torch.cuda.synchronize()

    kernels.mont_mul.launches = 0
    kernels.product_round.launches = 0
    ops.mont_mul = recording
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, stages, _ = timed_stages(run)
            wall = time.perf_counter() - t0
    finally:
        ops.mont_mul = field_mul
    # kernels and copies on the card (one stream: their times do not overlap)
    by_name = {}
    k1_events = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            c, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (c + 1, us + e.time_range.elapsed_us())
            if K1_KERNEL in e.name:
                k1_events.append(e)
    rows = sorted(((k, c, us) for k, (c, us) in by_name.items()),
                  key=lambda r: -r[2])
    device_us = sum(us for _, _, us in rows)
    k1_us = sum(us for key, _, us in rows if K1_KERNEL in key)
    k2_us = sum(us for key, _, us in rows
                if any(k in key for k in K2_KERNELS))
    k2_count = sum(c for key, c, _ in rows
                   if any(k in key for k in K2_KERNELS))
    if len(k1_events) != len(launch_shapes):
        raise RuntimeError(f"{len(k1_events)} K1 kernels traced for "
                           f"{len(launch_shapes)} launches")
    k1_events.sort(key=lambda e: e.time_range.start)
    per_shape = collections.defaultdict(lambda: [0, 0.0])
    for shape, e in zip(launch_shapes, k1_events):
        per_shape[shape][0] += 1
        per_shape[shape][1] += e.time_range.elapsed_us()
    k1_shapes = []
    for (a, b), (count, us) in sorted(per_shape.items(),
                                      key=lambda kv: -kv[1][1]):
        bound, by = k1_bound_ms(a, b)
        mean_ms = us / count / 1e3
        k1_shapes.append({"a": list(a), "b": list(b), "launches": count,
                          "device_s": us / 1e6, "mean_ms": mean_ms,
                          "bound_ms": bound, "bound_by": by,
                          "share_of_bound": bound / mean_ms})
    print(json.dumps({
        "card": card_line(),
        "cycles": trace.length, "padded_length": trace.padded_length,
        "wall_s": wall, "stage_s": stages,
        "device_busy_s": device_us / 1e6,
        "device_busy_share": device_us / 1e6 / wall,
        "k1_launches": kernels.mont_mul.launches, "k1_device_s": k1_us / 1e6,
        "k2_calls": kernels.product_round.launches,
        "k2_kernel_launches": k2_count, "k2_device_s": k2_us / 1e6,
        "k1_shapes": k1_shapes,
        "top_device_ops": [{"op": k[:80], "count": c, "device_s": us / 1e6}
                           for k, c, us in rows[:10]],
    }))


if __name__ == "__main__":
    main()
