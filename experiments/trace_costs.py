"""What the port's tracing costs and whether its clock is the device
trace's, at the benchmark's Dory cell (`dory-sha2-2p18`), on one card.

    python3 experiments/trace_costs.py [--proves 2] [--seed 11] \
        [--out trace_costs.json]

In one process, after the cell's set-up and a warm-up prove (the
benchmark's `portbench.harness.Program`, its caches included):
  1. untraced proves, then traced ones (the span profiler on, every launch
     of K1-K4 recorded, `torch.profiler` over the card), alternating, each
     timed on the host clock: what tracing costs when on;
  2. one untraced prove with a null profiler that counts its calls
     (`span`, `count`, `stage`), and each call's cost on this host timed
     alone: what tracing costs when off;
  3. from the traced proves: for K1, K2 (its pass kernel), K3 (each form)
     and K4, the traced kernels against the launch records in number, and
     each kernel's start less its record's enqueue stamp put on the Unix
     clock through the profiler's anchor (`utils/profiling.py`), overall
     and by stage (the stage root whose span holds the stamp);
  4. from the same proves, the card's idle time by innermost span (the
     benchmark's breakdown rule, `portbench/harness.py`), whole: the
     share of the idle time inside the sumcheck stages' and witness
     extraction's root spans that falls under a named child span.
Prints one line a part and writes everything to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from contextlib import contextmanager

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


class CountingNull:
    """A disabled profiler that counts the calls the prove makes of it."""

    def __init__(self, real):
        self.real, self.calls = real, {"span": 0, "count": 0, "stage": 0}
        self.enabled, self.proves = False, []

    @contextmanager
    def span(self, name):
        self.calls["span"] += 1
        with self.real.span(name):
            yield

    def count(self, name, n=1):
        self.calls["count"] += 1
        self.real.count(name, n)

    def stage(self, name, start, end):
        self.calls["stage"] += 1
        return self.real.stage(name, start, end)


def per_call_ns(prof, n=200_000):
    """Each disabled call's cost on this host, in ns (best of 5)."""
    out = {}
    for what in ("span", "count", "stage", "active"):
        best = None
        for _ in range(5):
            t0 = time.perf_counter_ns()
            if what == "span":
                for _ in range(n):
                    with prof.span("x"):
                        pass
            elif what == "count":
                for _ in range(n):
                    prof.count("d2h", 8)
            elif what == "stage":
                for _ in range(n):
                    prof.stage("x", 0.0, 1.0)
            else:
                from jolt_tpu_torch.utils import profiling
                for _ in range(n):
                    profiling.active()
            dt = (time.perf_counter_ns() - t0) / n
            best = dt if best is None else min(best, dt)
        out[what] = best
    return out


def kind_of(name: str):
    import re
    if "round_kernel" in name:
        return "k2"
    if "k4_round_tail" in name:
        return "k4"
    m = re.search(r"k3_(add|double|scalar_mul|normalize|bucket_sum|"
                  r"bucket_reduce)\b", name)
    if m:
        return f"k3_{m.group(1)}"
    return "k1" if re.search(r"(?:^|\W)k1_", name) else None


def clock_check(events, records, stamps, anchor, roots):
    """Traced kernels against records by kind, and the lags."""
    traced = {}
    for name, start in events:
        k = kind_of(name)
        if k is not None:
            traced.setdefault(k, []).append(start)
    enq = {}
    for (form, _), t in zip(records, stamps):
        from jolt_tpu_torch.field import kernels
        k = "k1" if form in kernels.FORMS else form
        enq.setdefault(k, []).append(t)
    out = {"counts": {k: [len(traced.get(k, [])), len(v)]
                      for k, v in enq.items()}}
    stage_of = []
    for r in roots:
        stage_of.append((round(r.start * 1e9), round((r.start + r.wall_s)
                                                    * 1e9), r.name))
    lags, by_stage, by_kind = [], {}, {}
    for k, ts in enq.items():
        starts = sorted(traced.get(k, []))
        if len(starts) != len(ts):
            continue
        for s, t in zip(starts, ts):
            lag = s - anchor.unix_ns(t)
            lags.append(lag)
            by_kind.setdefault(k, []).append(lag)
            label = next((n for a, b, n in stage_of if a <= t < b),
                         "outside prove")
            by_stage.setdefault(label, []).append(lag)
    med = {k: statistics.median(v) / 1e3 for k, v in by_stage.items()}
    out.update(
        n_paired=len(lags),
        share_not_before_50us=(sum(x >= -50_000 for x in lags) / len(lags)
                               if lags else None),
        min_lag_us=min(lags) / 1e3 if lags else None,
        median_lag_us=statistics.median(lags) / 1e3 if lags else None,
        median_lag_us_by_stage=med,
        median_lag_us_by_kind={k: statistics.median(v) / 1e3
                               for k, v in by_kind.items()})
    return out


def idle_split(tp, roots, anchor, t0: float, t1: float) -> dict:
    """The card's idle time over [t0, t1] (perf_counter s) by innermost
    span path, and the share of the idle time inside the roots of the
    sumcheck stages and witness extraction under a child span."""
    from portbench import devtrace
    from portbench.harness import _attribute
    from portbench.metrics._common import SUMCHECK_STAGES
    dev = devtrace.reduce(tp, anchor.unix_ns(round(t0 * 1e9)),
                          anchor.unix_ns(round(t1 * 1e9)))
    idle = {}
    for lo, hi in dev.gaps:
        a = (lo - anchor.time_ns + anchor.perf_ns) / 1e9
        b = (hi - anchor.time_ns + anchor.perf_ns) / 1e9
        _attribute(roots, a, b, "", idle)
    named = ("witness-extraction",) + SUMCHECK_STAGES
    inside = sum(v for k, v in idle.items() if k.split("/")[0] in named)
    leaf = sum(idle.get(k, 0.0) for k in named)
    return {"busy_s": dev.busy_s, "window_s": dev.window_s,
            "idle_in_named_roots_s": inside,
            "of_it_under_a_child": 1 - leaf / inside if inside else None,
            "root_leaves_s": {k: idle[k] for k in named if k in idle},
            "top": sorted(idle.items(), key=lambda kv: -kv[1])[:12]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--proves", type=int, default=2)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--out", default="trace_costs.json")
    args = ap.parse_args(argv)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from portbench.harness import CACHE_DIR, Program
    from portbench.spec import load_cell
    cell = load_cell("dory-sha2-2p18")
    P = Program("cuda")
    P.load_kernels()
    setup = P.dory_setup(cell, CACHE_DIR)
    _, traces = P.traces(cell, args.seed)
    kernels, profiling = P.kernels, P.profiling
    P.prove(traces[-1], setup=setup, device="cuda")
    P.sync()
    out = {"card": torch.cuda.get_device_name(0), "untraced_s": [],
           "traced_s": [], "clock": []}

    span = {}

    def timed(trace):
        t0 = time.perf_counter()
        P.prove(trace, setup=setup, device="cuda")
        P.sync()
        span["t"] = (t0, time.perf_counter())
        return span["t"][1] - t0

    for k in range(args.proves):
        tr = traces[k % len(traces)]
        out["untraced_s"].append(timed(tr))
        prof = profiling.Profiler()
        profiling.PROFILER = prof
        kernels.record = []
        with profile(activities=[ProfilerActivity.CUDA]) as tp:
            out["traced_s"].append(timed(tr))
        records, kernels.record = kernels.record, None
        stamps = list(kernels.record_ns)
        profiling.PROFILER = profiling.Profiler(enabled=False)
        events = [(e.name(), e.start_ns())
                  for e in tp.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA
                  and not e.is_user_annotation()]
        chk = clock_check(events, records, stamps, prof.anchor, prof.roots)
        chk["idle"] = idle_split(tp, prof.roots, prof.anchor, *span["t"])
        chk["k4_records"] = sum(f == "k4" for f, _ in records)
        chk["d2h"] = prof.tally("d2h")
        chk["h2d_mib"] = prof.tally("h2d_bytes") / 2**20
        chk["copies_by_stage"] = {
            r.name: [prof.tally("d2h", roots=[r]),
                     round(prof.tally("h2d_bytes", roots=[r]) / 2**20, 3)]
            for r in prof.roots}
        out["clock"].append(chk)
        print(f"[on] prove {k}: untraced {out['untraced_s'][-1]:.3f} s, "
              f"traced {out['traced_s'][-1]:.3f} s", flush=True)
        print(f"[clock] prove {k}: " + json.dumps(chk), flush=True)

    counting = CountingNull(profiling.Profiler(enabled=False))
    profiling.PROFILER = counting
    kernels.reset_launches()
    timed(traces[0])
    launches = (sum(kernels.k1_launches().values())
                + kernels.product_round.launches
                + sum(kernels.k3_launches().values())
                + kernels.k4_launches())
    profiling.PROFILER = profiling.Profiler(enabled=False)
    cost = per_call_ns(profiling.Profiler(enabled=False))
    # a launch's look at `kernels.record` (two while it is None)
    n = 200_000
    t0 = time.perf_counter_ns()
    for _ in range(n):
        t = time.perf_counter_ns() if kernels.record is not None else 0
        if kernels.record is not None:
            pass
    cost["launch_check"] = (time.perf_counter_ns() - t0) / n
    calls = counting.calls
    off_ns = sum(calls[k] * cost[k] for k in calls) \
        + sum(calls.values()) * cost["active"] \
        + launches * cost["launch_check"]
    prove_s = statistics.median(out["untraced_s"])
    out["off"] = {"calls_per_prove": calls, "launches_per_prove": launches,
                  "ns_per_call": cost, "untraced_prove_s": prove_s,
                  "cost_ms": off_ns / 1e6,
                  "share_of_prove": off_ns / 1e9 / prove_s}
    print(f"[off] a prove's calls {calls} and {launches} launches, ns a "
          f"call {cost}: {off_ns / 1e6:.3f} ms of a {prove_s:.3f} s prove "
          f"({100 * off_ns / 1e9 / prove_s:.4f} %)", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
