"""Benchmark sweep harness: per-workload size grids, run-dir artifacts.

Analog of the reference's `jolt-prover` profile/benchmark harness
(reference `crates/jolt-prover/src/profile.rs:199-330`): a named
workload family is calibrated to a target log2 trace size, proved, and the
results land in a fresh run directory as machine-readable JSON --
`sweep.jsonl` (one record per point: cycles, wall seconds, kHz, peak HBM,
proof bytes) plus `summary.json`.  Per-workload default scales mirror the
reference (fib 16, sha2-chain 22).

Workloads are calibrated by linear scaling from a probe trace: cycle count
is affine in the iteration parameter, so one small trace pins the
per-iteration cost and the iteration count for a 2^n-cycle target follows
directly (tracing is cheap next to proving).

Torch counterpart of the JAX package's `eval/sweep.py`: the same
workloads and records, proved on `device` (the card unless the caller
asks for the CPU); `hbm_bytes` is the card's peak allocated memory.

Usage:
    python -m jolt_tpu_torch.cli sweep --workloads fib,sha2-chain \
        --min-log2 12 --max-log2 16 --pcs dory --out runs/
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Optional, Tuple


# ---------------------------------------------------------------------------
# workload registry: name -> (source_builder(n_iter, layout), probe_iters,
#                             default_log2)
# ---------------------------------------------------------------------------

def _fib_src(n: int, layout) -> Tuple[str, bytes]:
    return (f"""
    li   a0, {n}
    li   a1, 0
    li   a2, 1
loop:
    beq  a0, zero, done
    add  a3, a1, a2
    mv   a1, a2
    mv   a2, a3
    addi a0, a0, -1
    j    loop
done:
    li   t0, {layout.output_start}
    sd   a1, 0(t0)
    li   t1, {layout.termination}
    li   t2, 1
    sd   t2, 0(t1)
""", b"")


def _sha2_chain_src(n: int, layout) -> Tuple[str, bytes]:
    """Chained SHA-256 over the INLINE custom opcode (the reference's own
    bench class, `benches/e2e_profiling.rs:78-85`)."""
    import importlib.util
    import pathlib
    spec = importlib.util.spec_from_file_location(
        "gen_sha256",
        pathlib.Path(__file__).resolve().parents[2] / "examples"
        / "gen_sha256.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    src = gen.emit_inline(input_start=layout.input_start,
                          output_start=layout.output_start,
                          termination=layout.termination, chain=max(n, 1))
    return src, bytes(range(32))


def _keccak_chain_src(n: int, layout) -> Tuple[str, bytes]:
    """Chained Keccak-f[1600] permutations via the keccak256 inline."""
    lines = [f"    li   s0, {layout.input_start}",
             "    li   s1, 0x80010000",
             # state = first 8 input bytes replicated is fine for a bench;
             # zero-init state, absorb one input dword into lane 0
             "    ld   t0, 0(s0)",
             "    sd   t0, 0(s1)"]
    for i in range(1, 25):
        lines.append(f"    sd   zero, {8 * i}(s1)")
    lines.append(f"    li   s2, {max(n, 1)}")
    lines.append("kloop:")
    lines.append("    keccak256 s1")
    lines.append("    addi s2, s2, -1")
    lines.append("    bne  s2, zero, kloop")
    lines.append("    ld   t1, 0(s1)")
    lines.append(f"    li   t0, {layout.output_start}")
    lines.append("    sd   t1, 0(t0)")
    lines.append(f"    li   t2, {layout.termination}")
    lines.append("    li   t3, 1")
    lines.append("    sd   t3, 0(t2)")
    return "\n".join(lines) + "\n", bytes(range(8))


def _blake2b_chain_src(n: int, layout) -> Tuple[str, bytes]:
    """Chained Blake2b-256 via the BLAKE2B inline (the reference ladder's
    blake2b rung, `inlines.md:138`)."""
    import importlib.util
    import pathlib
    spec = importlib.util.spec_from_file_location(
        "gen_blake2b",
        pathlib.Path(__file__).resolve().parents[2] / "examples"
        / "gen_blake2b.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    src = gen.emit_inline(input_start=layout.input_start,
                          output_start=layout.output_start,
                          termination=layout.termination, chain=max(n, 1))
    return src, bytes(range(32))


def _map_ops_src(n: int, layout) -> Tuple[str, bytes]:
    """Memory-heavy rung (btreemap analog, `e2e_profiling.rs:19-24`):
    n LCG-keyed inserts/updates into an open-addressing hash table in
    guest heap (scattered RAM traffic dominates), then a checksum scan."""
    table = 0x80040000      # 2^14 slots x 16 B = 256 KB in the heap
    src = f"""
    li   s0, 0x{table:x}           # slot table (keys at +0, vals at +8)
    li   s1, {max(n, 1)}           # op counter
    li   s2, 12345                 # LCG state
    li   s3, 0x3fff                # slot mask (2^14 slots)
    li   s4, 6364136223846793005   # LCG multiplier (Knuth)
    li   s5, 1442695040888963407   # LCG increment
oploop:
    mul  s2, s2, s4
    add  s2, s2, s5
    ori  t1, s2, 1                 # key (nonzero)
    srli t2, t1, 17
    xor  t2, t2, t1
    and  t2, t2, s3                # home slot
probe:
    slli t3, t2, 4
    add  t3, t3, s0
    ld   t4, 0(t3)
    beq  t4, zero, insert
    beq  t4, t1, update
    addi t2, t2, 1
    and  t2, t2, s3
    j    probe
insert:
    sd   t1, 0(t3)
update:
    sd   s2, 8(t3)
    addi s1, s1, -1
    bne  s1, zero, oploop
    li   t5, 0                     # checksum over the first 512 keys
    li   t6, 0
ckloop:
    slli t3, t6, 4
    add  t3, t3, s0
    ld   t4, 0(t3)
    add  t5, t5, t4
    addi t6, t6, 1
    li   t0, 512
    bne  t6, t0, ckloop
    li   t0, {layout.output_start}
    sd   t5, 0(t0)
    li   t1, {layout.termination}
    li   t2, 1
    sd   t2, 0(t1)
"""
    return src, b""


WORKLOADS: Dict[str, Tuple[Callable, int, int]] = {
    # name: (builder, probe_iters, default_log2)
    "fib": (_fib_src, 64, 16),
    "sha2-chain": (_sha2_chain_src, 4, 22),
    "keccak-chain": (_keccak_chain_src, 4, 20),
    "blake2b-chain": (_blake2b_chain_src, 4, 20),
    "map-ops": (_map_ops_src, 256, 20),
}


# ---------------------------------------------------------------------------
# calibration + one measured point
# ---------------------------------------------------------------------------

def _trace(builder, n_iter, layout, native=True):
    src, inputs = builder(n_iter, layout)
    if native:
        from ..tracer.native import trace_program_native as tp
    else:
        from ..tracer import trace_program as tp
    return tp(src, layout=layout, inputs=inputs)


def calibrate(name: str, target_log2: int, layout=None, native=True):
    """Iteration count landing the trace at ~2^target_log2 cycles, via one
    probe trace (cycle count is affine in the iteration parameter)."""
    from ..riscv.emulator import MemoryLayout
    layout = layout or MemoryLayout(max_input_size=64, max_output_size=64)
    builder, probe_n, _ = WORKLOADS[name]
    base = _trace(builder, probe_n, layout, native).length
    tiny = _trace(builder, 1, layout, native).length if probe_n > 1 else base
    per_iter = max((base - tiny) / max(probe_n - 1, 1), 1.0)
    overhead = tiny - per_iter
    n = max(int(((1 << target_log2) - overhead) / per_iter), 1)
    return n, layout


def run_point(name: str, target_log2: int, pcs: Optional[str] = None,
              native: bool = True, warm: bool = False,
              device="cuda") -> dict:
    """Trace + prove one calibrated workload point on `device`; returns
    the record."""
    import torch

    from ..prover.prover import prove, resolve_device

    device = resolve_device(device)
    builder = WORKLOADS[name][0]
    n_iter, layout = calibrate(name, target_log2, native=native)
    t0 = time.perf_counter()
    tr = _trace(builder, n_iter, layout, native)
    trace_s = time.perf_counter() - t0

    setup = pcs if pcs in ("dory", "hyperkzg") else None
    if warm:
        prove(tr, setup=setup, device=device)
    t0 = time.perf_counter()
    proof = prove(tr, setup=setup, device=device)
    prove_s = time.perf_counter() - t0
    from ..proof_io import serialize_proof
    try:
        proof_bytes = len(serialize_proof(proof))
    except Exception:
        proof_bytes = None
    hbm = (int(torch.cuda.max_memory_allocated(device)) or None
           if device.type == "cuda" else None)
    return {
        "workload": name,
        "target_log2": target_log2,
        "iters": n_iter,
        "cycles": tr.length,
        "padded": tr.padded_length,
        "trace_s": round(trace_s, 3),
        "prove_s": round(prove_s, 3),
        "khz": round(tr.length / prove_s / 1e3, 3),
        "padded_khz": round(tr.padded_length / prove_s / 1e3, 3),
        "pcs": pcs or "none",
        "proof_bytes": proof_bytes,
        "hbm_bytes": hbm,
    }


def run_sweep(workloads, min_log2: int, max_log2: int,
              pcs: Optional[str] = None, out_dir: str = "runs",
              native: bool = True, warm: bool = False,
              device="cuda") -> dict:
    """Grid {workloads} x {min_log2..max_log2}; artifacts in a fresh
    run dir (run-dir-per-run layout, profile.rs:199-233)."""
    stamp = time.strftime("%Y%m%d-%H%M%S")
    run_dir = os.path.join(out_dir, f"sweep-{stamp}")
    os.makedirs(run_dir, exist_ok=True)
    records = []
    path = os.path.join(run_dir, "sweep.jsonl")
    with open(path, "w") as f:
        for name in workloads:
            if name not in WORKLOADS:
                raise KeyError(f"unknown workload {name!r}; "
                               f"have {sorted(WORKLOADS)}")
            for lg in range(min_log2, max_log2 + 1):
                rec = run_point(name, lg, pcs=pcs, native=native, warm=warm,
                                device=device)
                records.append(rec)
                f.write(json.dumps(rec) + "\n")
                f.flush()
                print(f"[sweep] {name}@2^{lg}: {rec['cycles']} cycles, "
                      f"{rec['prove_s']}s ({rec['khz']} kHz)", flush=True)
    summary = {
        "run_dir": run_dir,
        "pcs": pcs or "none",
        "best_khz": max((r["khz"] for r in records), default=0.0),
        "points": len(records),
    }
    with open(os.path.join(run_dir, "summary.json"), "w") as f:
        json.dump({"summary": summary, "records": records}, f, indent=1)
    return summary
