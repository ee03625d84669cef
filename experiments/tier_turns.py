"""The main path's batched stages on both tiers, in turns, in one process:
each stage's wall seconds with every stage it can on the device tier
(`sumcheck/fused.py`: s1-s8 but s5i) and with every slot forced to the
host engine (`kernels.JoltBackend.with_tier(slot, "host")`).  On a
machine with one NVIDIA GPU:

    python3 experiments/tier_turns.py --out tier_turns.json

The sha2-chain at chain=114 (`workload.sha2_chain_trace`, 2^18 cycles)
proved at `setup=None` (the stages' own work; Dory's stages are the same
on both tiers) once to warm the card, then in the order device, host,
host, device, device, host: so each tier runs first and last as often.
Each run's stage seconds come from the prover's stage timing
(`workload.timed_stages`); each run's proof bytes must equal the first's.
It prints the card's name and power limit, one line a run, and the
per-stage median of each tier with its spread, and writes all of it as
JSON to FILE.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

ORDER = ["device", "host", "host", "device", "device", "host"]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path, required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("tier_turns: no CUDA device")
    from jolt_tpu_torch import prove
    from jolt_tpu_torch.kernels import JoltBackend, set_backend
    from jolt_tpu_torch.proof_io import serialize_proof
    from jolt_tpu_torch.workload import (card_line, sha2_chain_trace,
                                         timed_stages)

    host = JoltBackend.default().with_every_slot("host")
    print(f"[turns] card: {card_line()}", flush=True)
    tr = sha2_chain_trace()
    want = serialize_proof(prove(tr, device="cuda"))       # warm-up
    runs = []
    for tier in ORDER:
        set_backend(host if tier == "host" else None)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            proof, stage_s, _, launches = timed_stages(
                lambda: prove(tr, device="cuda"))
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
        finally:
            set_backend(None)
        if serialize_proof(proof) != want:
            sys.exit(f"tier_turns: the {tier} run's proof differs")
        k4 = sum(v["k4"] for v in launches.values())
        if (k4 == 0) != (tier == "host"):
            sys.exit(f"tier_turns: the {tier} run launched K4 {k4} times")
        runs.append({"tier": tier, "prove_s": total, "stage_s": stage_s,
                     "k4": k4})
        print(f"[turns] {tier}: prove {total:.3f}s; " + ", ".join(
            f"{k} {v:.4f}" for k, v in stage_s.items()), flush=True)
    summary = {}
    for label in runs[0]["stage_s"]:
        summary[label] = {}
        for tier in ("device", "host"):
            vals = [r["stage_s"][label] for r in runs if r["tier"] == tier]
            summary[label][tier] = {"median": statistics.median(vals),
                                    "min": min(vals), "max": max(vals)}
        d, h = summary[label]["device"], summary[label]["host"]
        print(f"[turns] {label}: device {d['median']:.4f}s ({d['min']:.4f}"
              f"-{d['max']:.4f}), host {h['median']:.4f}s ({h['min']:.4f}-"
              f"{h['max']:.4f})", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": card_line(), "order": ORDER,
                                    "cycles": tr.length, "runs": runs,
                                    "summary": summary}, indent=1))


if __name__ == "__main__":
    main()
