"""One run of one cell: set-up, the measured window of back-to-back
`jolt_tpu_torch.prove` calls, the reference's check, the result.

`run_cell` is the whole run on a given device; `run.py` adds the look for
the card and prints.  The tests drive `run_cell` on the CPU at a small
size, which is the only way a run reaches the CPU.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import random
import sys
import time
from typing import Dict, List, Optional

from . import traffic as traffic_gen
from .spec import HERE, Cell

CACHE_DIR = os.path.join(HERE, ".cache")
# modules that may not be loaded in the process that prints the result
FORBIDDEN = ("jax", "jaxlib", "flax", "jolt_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc), so set-up counts
    the interpreter's start and every import."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's (`jolt_tpu_torch` is neither)."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Window:
    """What the measured window leaves for the per-layer readers: one
    entry a completed prove in `spans` (root span -> seconds) and
    `stage_launches` (stage -> kernel -> launches), K1's launch records in
    order, and the reduced device trace (None off the card)."""
    spans: List[Dict[str, float]]
    stage_launches: List[Dict[str, Dict[str, int]]]
    k1_records: list
    device: Optional[object]


def _launch_counts(kernels) -> Dict[str, int]:
    return {"k1": sum(kernels.k1_launches().values()),
            "k2": kernels.product_round.launches,
            "k4": kernels.k4_launches()}


def _attribute(spans, lo: float, hi: float, prefix: str,
               out: Dict[str, float]) -> float:
    """Add to `out` the part of [lo, hi) (perf_counter seconds) that each
    innermost span of `spans` covers, by the span's path; returns the
    part the spans cover."""
    covered = 0.0
    for s in spans:
        a, b = max(lo, s.start), min(hi, s.start + s.wall_s)
        if b <= a:
            continue
        path = f"{prefix}/{s.name}" if prefix else s.name
        inner = _attribute(s.children, a, b, path, out)
        if b - a > inner:
            out[path] = out.get(path, 0.0) + (b - a - inner)
        covered += b - a
    return covered


def _op_name(name: str) -> str:
    """A device operation's name without its template and parameters."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for stop in "<(":
        name = name.split(stop, 1)[0]
    return name.strip()


class Program:
    """The system under test: the entry points of `jolt_tpu_torch` that
    the benchmark drives, imported once, and the set-up steps of a run."""

    def __init__(self, device: str = "cuda", prove_fn=None):
        for key in [k for k in os.environ if k.startswith("JOLT_TPU_")]:
            del os.environ[key]        # the port's debug switches stay off
        import torch
        import jolt_tpu_torch
        from jolt_tpu_torch.curve import native_pairing
        from jolt_tpu_torch.field import kernels
        from jolt_tpu_torch.pcs.dory import DorySetup
        from jolt_tpu_torch.proof_io import serialize_proof
        from jolt_tpu_torch.prover import prover
        from jolt_tpu_torch.riscv.emulator import MemoryLayout
        from jolt_tpu_torch.tracer import native as native_tracer
        from jolt_tpu_torch.utils import profiling
        self.torch, self.kernels, self.prover = torch, kernels, prover
        self.native_pairing, self.native_tracer = native_pairing, native_tracer
        self.DorySetup, self.MemoryLayout = DorySetup, MemoryLayout
        self.serialize_proof, self.profiling = serialize_proof, profiling
        self.prove = prove_fn or jolt_tpu_torch.prove
        self.device = device
        self.is_cuda = torch.device(device).type == "cuda"

    def load_kernels(self) -> None:
        """The port's native libraries and, on the card, K1-K4: built into
        the port's `_build/` at a checkout's first run, then loaded."""
        self.native_pairing.load()
        self.native_tracer._load()
        if self.is_cuda:
            for name in ("K1", "K2", "K3", "K4"):
                self.kernels._load(name)

    def dory_setup(self, cell: Cell, cache_dir: str):
        """The configuration's Dory setup, generated into the cache at a
        checkout's first run, then loaded from it."""
        conf, log_T = cell.config, int(cell.traffic["padded_log2"])
        if conf["trace_log2"] != log_T:
            raise ValueError(f"traffic {cell.entry['traffic']} pads to "
                             f"2^{log_T}, config {cell.entry['config']} is "
                             f"sized for 2^{conf['trace_log2']}")
        num_vars = self.prover.required_num_vars(1 << log_T, 0, 0)
        return self.DorySetup.generate(
            num_vars, nu=min(num_vars // 2, int(conf["dory_max_nu"])),
            cache_dir=os.path.join(cache_dir, "srs"))

    def traces(self, cell: Cell, seed: int):
        """The seed's guest runs (`traffic.py`) and the port's traces of
        them; raises if one does not pad to the traffic's size."""
        runs = traffic_gen.guest_runs(cell.traffic, seed, self.MemoryLayout)
        traces = []
        for g in runs:
            tr = self.native_tracer.trace_program_native(
                g.source, layout=self.MemoryLayout(g.max_input_size,
                                                   g.max_output_size),
                inputs=g.inputs)
            if tr.padded_length != 1 << int(cell.traffic["padded_log2"]):
                raise ValueError(f"input {g.index} of seed {seed} pads to "
                                 f"{tr.padded_length}")
            traces.append(tr)
        return runs, traces

    def sync(self) -> None:
        if self.is_cuda:
            self.torch.cuda.synchronize()

    def job(self, prove_index: int, run, trace, proof):
        """What the reference judges of one proof: its bytes (the port's
        wire format) and the statement the port's trace claims."""
        from .reference.check import Job
        return Job(prove_index=prove_index, input_index=run.index,
                   inputs=run.inputs, claimed_length=trace.length,
                   claimed_padded=trace.padded_length,
                   claimed_outputs=bytes(trace.device.outputs),
                   claimed_panic=bool(trace.device.panic),
                   proof=self.serialize_proof(proof))


def zk_rng(cell: Cell, seed: int, k: int):
    """The blinds of prove k of a run (None outside zk)."""
    return random.Random(f"portbench/zk/{seed}/{k}") \
        if cell.config["zk"] else None


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", prove_fn=None, log=print,
             cache_dir: str = CACHE_DIR) -> dict:
    """Set up, measure and check one run; returns the result's fields.
    `prove_fn` replaces `jolt_tpu_torch.prove` (the tests plant faults
    with it); `cache_dir` holds both sides' Dory setups."""
    split = {"start": process_age_s()}
    P = Program(device, prove_fn)
    split["imports"] = process_age_s()
    P.load_kernels()
    split["kernels"] = process_age_s()
    setup = P.dory_setup(cell, cache_dir)
    split["setup"] = process_age_s()
    runs, traces = P.traces(cell, seed)
    split["traces"] = process_age_s()
    # warm-up: the window's shapes, on the input the window reaches last
    zk = bool(cell.config["zk"])
    for w in range(int(cell.settings["warmup_proves"])):
        P.prove(traces[-1], setup=setup, device=device, zk=zk,
                zk_rng=zk_rng(cell, seed, -1 - w))
    P.sync()
    split["warmup"] = setup_s = process_age_s()
    keys = list(split)
    log("[setup] " + " ".join(f"{b} {split[b] - split[a]:.3f}"
                              for a, b in zip(keys, keys[1:]))
        + f" (before the harness {split['start']:.3f}) total {setup_s:.3f} s")
    torch, kernels, profiling = P.torch, P.kernels, P.profiling
    prover_mod, is_cuda = P.prover, P.is_cuda

    # ---- the measured window --------------------------------------------
    spans, stage_launches, prof = [], [], None
    if trace:
        profiling.enable()
        kernels.record = []
        current: Dict[str, Dict[str, int]] = {}
        state = {"last": None}

        def hook(label):
            now = _launch_counts(kernels)
            prev = state["last"]
            current[label] = {k: now[k] - prev[k] for k in now}
            state["last"] = now
        prover_mod.stage_hooks.append(hook)
        if is_cuda:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
    if is_cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    proofs, prove_s, failed, errors = [], [], 0, []
    t0_unix = time.time_ns()
    t0 = time.perf_counter()
    k = 0
    try:
        while True:
            idx = k % len(traces)
            if trace:
                profiling.PROFILER.roots = []
                current = {}
                state["last"] = _launch_counts(kernels)
            try:
                t_prove = time.perf_counter()
                proof = P.prove(traces[idx], setup=setup, device=device,
                                zk=zk, zk_rng=zk_rng(cell, seed, k))
                P.sync()
                prove_s.append(time.perf_counter() - t_prove)
                proofs.append((k, idx, proof))
                if trace:
                    spans.append(list(profiling.PROFILER.roots))
                    stage_launches.append(current)
            except Exception as e:     # a failed prove counts; the run goes on
                failed += 1
                errors.append(f"prove {k}: {type(e).__name__}: {e}")
            k += 1
            if time.perf_counter() - t0 >= seconds:
                break
        t_end = time.perf_counter()
    finally:
        if trace:
            if prof is not None:
                prof.__exit__(None, None, None)
            prover_mod.stage_hooks.remove(hook)
    window_s = t_end - t0
    peak = torch.cuda.max_memory_allocated() if is_cuda else 0
    cycles = sum(traces[idx].length for _, idx, _ in proofs)

    # ---- per-layer readings (traced run) ---------------------------------
    per_layer, breakdown = {}, None
    if trace:
        from . import devtrace
        dev = devtrace.reduce(prof, t0_unix,
                              t0_unix + int(window_s * 1e9)) if is_cuda \
            else None
        win = Window([{s.name: s.wall_s for s in roots} for roots in spans],
                     stage_launches, list(kernels.record or []), dev)
        kernels.record = None
        for name, reader in cell.readers.items():
            value = reader.read(win)
            if value is not None:
                per_layer[name] = {"value": value, "unit": reader.UNIT}
        if dev is not None:
            log(f"[trace] device events {dev.n_events}; K1 launches "
                f"traced {sum(len(v) for v in dev.k1_s.values())} of "
                f"{len(win.k1_records)} recorded")
            breakdown = _breakdown(dev, spans, t0, t0_unix)
        profiling.PROFILER = profiling.Profiler(enabled=False)

    # ---- free the program's state, then the reference's check -------------
    from .reference import check as ref_check
    chosen = ref_check.sample(len(proofs), seed,
                              int(cell.settings["checked_proofs"]))
    jobs = [P.job(proofs[j][0], runs[proofs[j][1]], traces[proofs[j][1]],
                  proofs[j][2]) for j in chosen]
    claimed_all = [(runs[i].inputs, bytes(t.device.outputs))
                   for i, t in enumerate(traces)]
    del proofs, traces, setup
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    verdict = ref_check.judge(cell.config, cell.traffic, jobs, claimed_all,
                              cache_dir=os.path.join(cache_dir, "reference"),
                              log=log)
    log(f"[check] {time.perf_counter() - t_check:.3f} s for "
        f"{len(jobs)} proof(s)")
    correct = verdict.correct and failed == 0 and len(jobs) > 0
    for e in errors:
        log(f"[fail] {e}")

    if trace:
        metrics = per_layer
    else:
        measured = {"prove_cycles_per_s": (cycles / window_s, "cycles/s"),
                    "peak_device_gib": (peak / 2**30, "GiB"),
                    "setup_s": (setup_s, "s")}
        metrics = {m["name"]: dict(zip(("value", "unit"),
                                       measured[m["name"]]))
                   for m in cell.end_to_end}
    log(f"[window] {k - failed} proves completed, {failed} failed, "
        f"{cycles} cycles in {window_s:.6f} s; peak {peak} B; "
        f"{len(jobs)} checked; each prove "
        + " ".join(f"{x:.3f}" for x in prove_s) + " s")
    out = {"correct": bool(correct), "attempted": k, "failed": failed,
           "metrics": metrics, "device": {"memory_peak_bytes": int(peak)}}
    if trace and is_cuda:
        out["device"]["busy_s"] = dev.busy_s
        out["device"]["window_s"] = dev.window_s
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": value, "limit": limit}
                     for name, value, limit in verdict.numbers}
    return out


def _breakdown(dev, spans, t0: float, t0_unix: int) -> dict:
    """The ten device operations that took most time (by name, summed
    over the window), and the ten host spans under which the card sat
    idle longest: each idle gap split among the innermost spans open
    during it ("outside prove" where none was), summed over the window."""
    ops: Dict[str, float] = {}
    for name, s in dev.ops_s.items():
        ops[_op_name(name)] = ops.get(_op_name(name), 0.0) + s
    roots = [s for prove_roots in spans for s in prove_roots]
    idle: Dict[str, float] = {}
    for lo, hi in dev.gaps:
        a, b = t0 + (lo - t0_unix) / 1e9, t0 + (hi - t0_unix) / 1e9
        rest = (b - a) - _attribute(roots, a, b, "", idle)
        if rest > 0:
            idle["outside prove"] = idle.get("outside prove", 0.0) + rest
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in gaps]}
