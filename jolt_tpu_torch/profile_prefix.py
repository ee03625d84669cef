"""Where `prove_prefix` spends its time on one CUDA device.

    python3 -m jolt_tpu_torch.profile_prefix

Traces the main path's workload (`workload.sha2_chain_trace`: the
sha2-chain guest at chain=114, ~2^18 cycles), runs `prove_prefix` once to
warm up (K1 build, allocator), then once under `torch.profiler`, and prints
one JSON line: the wall time of each stage (inflated by the profiler's own
cost), the summed device time of all kernels and copies, the device's busy
share of the wall time, K1's launches and device time, and the ten
operations with the most device time.
"""

from __future__ import annotations

import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from . import prove_prefix
from .field import kernels
from .workload import card_line, sha2_chain_trace, timed_stages


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_prefix needs a CUDA device")
    trace = sha2_chain_trace()
    prove_prefix(trace, device="cuda")                 # warm-up
    torch.cuda.synchronize()

    def run():
        prove_prefix(trace, device="cuda")
        torch.cuda.synchronize()

    kernels.mont_mul.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, stages, _ = timed_stages(run)
        wall = time.perf_counter() - t0
    # kernels and copies on the card (one stream: their times do not overlap)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            c, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (c + 1, us + e.time_range.elapsed_us())
    rows = sorted(((k, c, us) for k, (c, us) in by_name.items()),
                  key=lambda r: -r[2])
    device_us = sum(us for _, _, us in rows)
    k1_us = sum(us for key, _, us in rows if "mont_mul_kernel" in key)
    print(json.dumps({
        "card": card_line(),
        "cycles": trace.length, "padded_length": trace.padded_length,
        "wall_s": wall, "stage_s": stages,
        "device_busy_s": device_us / 1e6,
        "device_busy_share": device_us / 1e6 / wall,
        "k1_launches": kernels.mont_mul.launches, "k1_device_s": k1_us / 1e6,
        "top_device_ops": [{"op": k[:80], "count": c, "device_s": us / 1e6}
                           for k, c, us in rows[:10]],
    }))


if __name__ == "__main__":
    main()
