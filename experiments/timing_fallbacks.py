"""The timing helpers of chip_smoke.py and k4_parts.py on the card, each
way they can take: K1's mul at 2^20, K2's message_bind round at 2^18 (2
factors) and K4's round tail at 2 x 3, timed with torch.profiler as it
is, with a profiler that keeps 2 launches of a kernel a trace (the mean
over the pooled traces), and with one that keeps none (CUDA events over
calls queued behind a sleep kernel).

    python experiments/timing_fallbacks.py      # one CUDA card
"""
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "experiments")]
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import k4_parts as k4p  # noqa: E402
from jolt_tpu_torch.field import kernels, ops  # noqa: E402
from jolt_tpu_torch.transcript import device as dt  # noqa: E402

kernels.build(("K1", "K2", "K4"))
dev = torch.device("cuda")
gen = torch.Generator(device=dev)
gen.manual_seed(0)
n = 1 << 20
x, y = (cs.rand_field((8, n), gen, dev) for _ in range(2))
polys = tuple(cs.rand_field((8, 1 << 18), gen, dev) for _ in range(2))
r = cs.rand_field((8, 1), gen, dev)
real_profile = cs.profile


def run(tag):
    sets = cs.cold_copies((x, y))
    k1 = cs.kernel_ms(lambda *a: kernels.mont_mul(*a), sets, ("k1_mul",))
    k2 = cs.time_k2(kernels, ops, polys, r, "message_bind")
    k4 = k4p.time_shape(dt.round_tail, (3, 3), dev)
    print(f"{tag}: K1 mul {k1}; K2 pass {k2['pass_ms']:.5f} finish "
          f"{k2['finish_ms']:.5f} total {k2['ms']:.5f}; K4 {k4}", flush=True)


class Kept:
    def __init__(self, keep, **kw):
        self.keep, self.p = keep, real_profile(**kw)

    def __enter__(self):
        self.p.__enter__()
        return self

    def __exit__(self, *a):
        return self.p.__exit__(*a)

    def events(self):
        out, seen = [], {}
        for e in self.p.events():
            if e.device_type == cs.DeviceType.CUDA:
                k = e.name
                seen[k] = seen.get(k, 0) + 1
                if seen[k] > self.keep:
                    continue
            out.append(e)
        return out


run("profiler")
for keep in (2, 0):
    cs.profile = k4p.profile = (lambda keep: lambda **kw: Kept(keep, **kw))(
        keep)
    run(f"keep {keep} a trace")
print("nvidia-smi:", __import__("subprocess").run(
    ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
    capture_output=True, text=True).stdout.strip())
