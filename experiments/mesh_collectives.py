"""The collectives `prove` issues under the cycle mesh, by kind and stage,
and where the binds stay sharded: D ranks as processes over gloo on the
CPU (`parallel.spawn.run_ranks`), the collectives counted by
`torch.distributed.tensor.debug.CommDebugMode`.  Counts, not times.

    python3 experiments/mesh_collectives.py --ranks 2 --chain 1

The trace is the sha2-chain at `--chain` (`workload.sha2_chain_trace`;
chain=1 is 2^12 cycles padded), proved at `setup=None`.  Every rank's
proof bytes must equal one process's.  It prints one line a stage (rank
0's counts; the ranks issue the same collectives): the collectives, and
the placements of the tensors the stage's passes made -- K1's binds and
evals (`ops.bind`, `ops.evals`) and K2's bound factors -- as
{kind: {placement: n}}, "Shard" where the pass kept the cycle shard.
With `--out` it writes them as JSON.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def _placement(t) -> str:
    from jolt_tpu_torch.field.kernels import is_dtensor
    if not is_dtensor(t):
        return "plain"
    return type(t.placements[0]).__name__


def placements_rank(rank: int, world: int, tr) -> dict:
    """`spawn.prove_rank` on the CPU with the collectives counted, and a
    tally, stage by stage, of the placements of the binds', evals' and K2
    rounds' outputs."""
    from jolt_tpu_torch.field import kernels, ops
    from jolt_tpu_torch.parallel.spawn import prove_rank
    from jolt_tpu_torch.prover import prover
    stages, now = {}, {}
    depth = [0]

    def tallied(kind, fn, outs):
        def wrapper(*args, **kwargs):
            depth[0] += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                depth[0] -= 1
            if depth[0] == 0:
                for t in outs(out):
                    c = now.setdefault(kind, {})
                    c[_placement(t)] = c.get(_placement(t), 0) + 1
            return out
        return wrapper
    ops.bind = tallied("bind", ops.bind, lambda o: [o])
    ops.evals = tallied("evals", ops.evals, lambda o: [o])
    kernels.product_round = tallied("k2_bound", kernels.product_round,
                                    lambda o: o[1] or ())

    def hook(label: str) -> None:
        stages[label] = dict(now)
        now.clear()
    prover.stage_hooks.append(hook)
    try:
        out = prove_rank(rank, world, tr, None, "cpu", None, True)
    finally:
        prover.stage_hooks.remove(hook)
    out["placements"] = stages
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--chain", type=int, default=1)
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args()
    from jolt_tpu_torch import prove
    from jolt_tpu_torch.parallel.spawn import run_ranks
    from jolt_tpu_torch.proof_io import serialize_proof
    from jolt_tpu_torch.workload import sha2_chain_trace
    torch.set_num_threads(1)
    tr = sha2_chain_trace(args.chain)
    outs = run_ranks(placements_rank, args.ranks, tr)
    want = serialize_proof(prove(tr, device="cpu"))
    if any(o["bytes"] != want for o in outs):
        raise SystemExit("a rank's proof differs from one process's")
    stages = outs[0]["comm"]
    if any(o["comm"] != stages for o in outs):
        raise SystemExit("the ranks issued different collectives")
    print(f"sha2-chain chain={args.chain}: {tr.length} cycles, padded "
          f"{tr.padded_length}; {args.ranks} ranks over gloo on the CPU; "
          "proof bytes == one process's on every rank")
    places = outs[0]["placements"]
    for label in places:
        print(f"{label}: collectives {stages.get(label, {})}, placements "
              f"{places[label]}")
    if args.out:
        args.out.write_text(json.dumps({
            "ranks": args.ranks, "chain": args.chain,
            "padded": tr.padded_length, "collectives_by_stage": stages,
            "placements_by_stage": places}, indent=1))


if __name__ == "__main__":
    main()
