"""The readings that set the check's limits, at a cell's own size: the
program's sound proofs, the control, and the planted faults.  Not part of
a benchmark run; run it on the card:

    python3 -m portbench.control --workload dory-sha2-2p18 \
        --seeds 11 12 13 --out control-dory.json

For each seed, in one process and one set-up: the port proves the seed's
first input once, and the reference judges
  * the proof as made (the lower reading: what sound runs give);
  * the control (`reference/lower_precision.py`: every Fr scalar the
    proof carries in the clear kept to its low 128 bits);
  * four faults planted in the program's answer: a token altered where it
    is produced (stage 2's first opening claim, plus one), the state
    unchanged (the previous seed's proof handed in for this seed's input),
    half of the work left out (the joint opening proof dropped), and the
    mode flipped (the same trace proved with zk the other way from the
    configuration: a clear proof where it states zk, or the reverse).
Each reading is the check's numbers (`reference/check.py`).  Writes one
JSON object with every reading to --out and prints a table.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import random
import sys
import time

from . import harness
from .reference import check as ref_check
from .reference.lower_precision import lower_precision
from .spec import load_cell


def _planted(proof, kind: str):
    if kind == "token altered":
        key = next(iter(proof.stage2_openings))
        proof.stage2_openings[key] += 1
    elif kind == "half the work":
        proof.opening_proofs = {}
    return proof


def readings(cell, seeds, device: str = "cuda",
             cache_dir: str = harness.CACHE_DIR, log=print) -> dict:
    """Every reading of the cell at `seeds` (two or more), in one process
    and one set-up."""
    P = harness.Program(device)
    P.load_kernels()
    setup = P.dory_setup(cell, cache_dir)
    zk = bool(cell.config["zk"])
    jobs = {}                     # (seed, kind) -> Job
    prove_s, prev = [], None
    for seed in seeds:
        runs, traces = P.traces(cell, seed)
        t = time.perf_counter()
        proof = P.prove(traces[0], setup=setup, device=device, zk=zk,
                        zk_rng=harness.zk_rng(cell, seed, 0))
        P.sync()
        prove_s.append(time.perf_counter() - t)
        sound = P.job(0, runs[0], traces[0], proof)
        jobs[seed, "sound"] = sound
        jobs[seed, "control"] = dataclasses.replace(
            sound, proof=lower_precision(sound.proof))
        for kind in ("token altered", "half the work"):
            jobs[seed, kind] = P.job(0, runs[0], traces[0],
                                     _planted(copy.deepcopy(proof), kind))
        flipped = P.prove(traces[0], setup=setup, device=device, zk=not zk,
                          zk_rng=harness.zk_rng(cell, seed, 0)
                          or random.Random(f"portbench/flip/{seed}"))
        jobs[seed, "mode flipped"] = P.job(0, runs[0], traces[0], flipped)
        del flipped
        if prev is not None:
            jobs[seed, "state unchanged"] = dataclasses.replace(
                sound, proof=prev)
        prev = sound.proof
        del proof, traces
    peak = P.torch.cuda.max_memory_allocated() if P.is_cuda else 0
    del setup
    out = []
    for (seed, kind), job in jobs.items():
        t = time.perf_counter()
        v = ref_check.judge(cell.config, cell.traffic, [job],
                            [(job.inputs, job.claimed_outputs)],
                            os.path.join(cache_dir, "reference"), log=log)
        out.append({"seed": seed, "kind": kind,
                    "numbers": {n: x for n, x, _ in v.numbers},
                    "rejected_at": v.rejected_at,
                    "check_s": time.perf_counter() - t})
        log(f"[control] seed {seed} {kind:16s} "
            + " ".join(f"{n}={x}" for n, x in out[-1]["numbers"].items())
            + f" {out[-1]['check_s']:.1f} s " + "; ".join(v.rejected_at))
    return {"workload": cell.name, "seeds": list(seeds), "prove_s": prove_s,
            "memory_peak_bytes": peak,
            "device": (P.torch.cuda.get_device_name(0) if P.is_cuda
                       else "cpu"),
            "readings": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if len(args.seeds) < 2:
        ap.error("the state-unchanged fault needs two seeds or more")
    out = readings(load_cell(args.workload), args.seeds,
                   log=lambda m: print(m, flush=True))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
