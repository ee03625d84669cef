"""Benchmark: the port's end-to-end prover throughput on one NVIDIA GPU.

    python3 -m jolt_tpu_torch.bench

Prints the card, the host, the timed run's stage lines, and last ONE JSON
line: {"metric", "value", "unit", "vs_baseline"}, as the JAX package's
root `bench.py` does.

Headline metric: e2e proving throughput in RISC-V cycles/second, trace ->
proof INCLUSIVE: witness extraction, the Dory witness commitments (stage
0: one-hot tier-1 segment sums and the dense row MSMs on the card's K3,
tier-2 pairings on the host), every sumcheck stage (1-8, on the card)
and the final Dory RLC opening (phase B's MSMs and Gamma1 folds on K3,
its pairings and Fr folds on the host) -- the scope of the reference's
"Proved in Xs (Y kHz)" log metric (`zkvm/prover.rs:588-592`).  The
timed run's Dory spans (`utils/profiling.py`) print before the JSON
line.

Workload: the sha2-chain guest of `workload.py` at chain=114 (~2^18
cycles; no knob), the reference's own bench class
(`benches/e2e_profiling.rs:78-85`).  The Dory setup (2^26: nu = 10,
sigma = 16) is built, or loaded from the port's cache, outside the timed
window.  The first `prove` warms the card (kernel builds, allocator); the
SECOND is timed.  The setup keeps Gamma1's copy on the card from the
first `prove`; each `prove` builds its own Dory instance, so the timed
one encodes the setup's G2 points for the native pairings again (the
`encode.setup` span), as the JAX package's bench does.  The proof is then
verified, outside the timed window.

vs_baseline: ratio against the reference's 500,000 cycles/s e2e prover
throughput (MacBook M4 Max 16-core figure, BASELINE.md).
"""

from __future__ import annotations

import json
import os
import time

from .pcs.dory import DorySetup
from .prover.prover import prove, required_num_vars
from .utils import profiling
from .verifier.verifier import PublicIO, verify
from .workload import SHA2_CHAIN, card_line, host_line, sha2_chain_trace

BASELINE_CYCLES_PER_S = 500_000.0   # reference e2e cycles/s (BASELINE.md)
# the Dory spans of the timed prove (`prover/prover.py` stage 0,
# `pcs/dory.py`, `pcs/scheme.py`)
DORY_SPANS = ("commit.onehot", "commit.dense", "commit.tier1",
              "commit.tier2", "encode.setup", "open.rlc_rows", "open.e1", "open.A.pair",
              "open.A.g1fold", "open.A.g2fold", "open.B.row", "open.B.msm",
              "open.B.g1fold")


def main() -> None:
    print(f"[bench] card: {card_line()}; host: {host_line()}", flush=True)
    tr = sha2_chain_trace()          # raises if the chain's output is wrong
    print(f"[bench] sha2-chain chain={SHA2_CHAIN}: {tr.length} cycles, "
          f"padded {tr.padded_length}", flush=True)
    t0 = time.perf_counter()
    setup = DorySetup.generate(required_num_vars(tr.padded_length, 0, 0))
    print(f"[bench] Dory setup nu={setup.nu} sigma={setup.sigma}: "
          f"{time.perf_counter() - t0:.2f}s", flush=True)

    prove(tr, setup=setup, device="cuda")      # warm-up, untimed
    os.environ["JOLT_TPU_STAGE_TIMING"] = "1"
    prof = profiling.PROFILER = profiling.Profiler()
    try:
        t0 = time.perf_counter()
        proof = prove(tr, setup=setup, device="cuda")
        dt = time.perf_counter() - t0
    finally:
        del os.environ["JOLT_TPU_STAGE_TIMING"]
        profiling.PROFILER = profiling.Profiler(enabled=False)
    print("[bench] Dory spans (s): " + ", ".join(
        f"{name} {prof.total(name):.4f}" for name in DORY_SPANS), flush=True)
    t0 = time.perf_counter()
    verify(proof, PublicIO.from_trace(tr), setup=setup)
    print(f"[bench] prove {dt:.3f}s; verify accepted in "
          f"{time.perf_counter() - t0:.3f}s", flush=True)

    cycles_per_s = tr.length / dt
    print(json.dumps({
        "metric": "e2e_prove_throughput",
        "value": round(cycles_per_s, 1),
        "unit": "cycles/s",
        "vs_baseline": round(cycles_per_s / BASELINE_CYCLES_PER_S, 6),
    }), flush=True)


if __name__ == "__main__":
    main()
