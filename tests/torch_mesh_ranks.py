"""The ranks' side of tests/test_torch_mesh.py and test_torch_mesh_slow.py.

Each function runs on one rank of `jolt_tpu_torch.parallel.spawn.run_ranks`
(the default process group is up) and returns plain data: canonical ints,
placements as strings, proof bytes.  This module imports no JAX, so the
spawned ranks never load it.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor

from jolt_tpu_torch.field import kernels, ops
from jolt_tpu_torch.parallel import mesh as pm
from jolt_tpu_torch.parallel.spawn import prove_rank
from jolt_tpu_torch.poly import dense
from jolt_tpu_torch.sumcheck import fused
from jolt_tpu_torch.sumcheck.sharded import sharded_round_step

# maybe_shard's inputs: batch shapes of (8, *batch) tensors
SHAPES = [(16,), (3,), (1,), (4, 16), (6,), (16, 1), (2, 12)]


def canon(t: torch.Tensor) -> List[int]:
    """Canonical ints of a field tensor, gathered whole."""
    return ops.unpack_ints(ops.whole(t).reshape(kernels.N_LIMBS, -1))


def round_cases(cases: Sequence[Tuple[int, int]], polys: Sequence[List[int]],
                r: int, D: int) -> List[dict]:
    """`sharded_round_step` on `shard_mle` of each case's first `npoly`
    polys (ints of length T) at r, as canonical ints."""
    mesh = pm.cycle_mesh(D, device="cpu")
    out = []
    for npoly, degree in cases:
        ps = [pm.shard_mle(ops.pack_ints(p, "cpu"), mesh)
              for p in polys[:npoly]]
        msg, bound = sharded_round_step(ps, r, degree)
        out.append({"msg": canon(msg),
                    "bound": [ops.unpack_ints(pm.unshard_mle(b))
                              for b in bound],
                    "placements": [str(b.placements) for b in bound]})
    return out


def _both(fn, *xs) -> Tuple[List[int], List[int], str]:
    """fn on the mesh-placed operands (each `maybe_shard`-ed) and on the
    plain ones: (mesh result, plain result, mesh result's placements)."""
    with pm.use_mesh(pm.cycle_mesh(device="cpu")):
        placed = [pm.maybe_shard(x) if isinstance(x, torch.Tensor) else x
                  for x in xs]
        got = fn(*placed)
        pl = str(got.placements) if isinstance(got, DTensor) else "plain"
        got = canon(got)
    return got, canon(fn(*xs)), pl


def _k2(x, y, r: int, order: str, part: str) -> torch.Tensor:
    """K2's round of the factors (x, y) in `order`: its message, or its
    second bound factor."""
    msg, bound = kernels.product_round((x, y), r, order)
    return msg if part == "msg" else bound[1]


def checks_rank(rank: int, world: int, data: dict) -> dict:
    """Every tier-1 check of one rank at D = world: placements, the local
    shards of `shard_mle`, `sharded_round_step`, the field ops on the mesh
    against one rank, the launch guards, and the guest's proof."""
    D = world
    out: Dict[str, object] = {}
    mesh = pm.cycle_mesh(device="cpu")
    with pm.use_mesh(mesh):
        out["placements"] = [
            str(pm.maybe_shard(torch.zeros((8,) + s, dtype=torch.int32)
                               ).placements) for s in SHAPES]
    sh = pm.shard_mle(ops.pack_ints(data["mle"], "cpu"), mesh)
    out["shard"] = ops.unpack_ints(sh.to_local().reshape(8, -1))
    out["rounds"] = round_cases(data["cases"], data["polys"], data["r"], D)

    a = ops.pack_ints(data["a"], "cpu")             # (8, T)
    b = ops.pack_ints(data["b"], "cpu")
    ids = torch.tensor(data["ids"])
    T = a.shape[-1]
    out["ops"] = {
        "sum_mod": _both(ops.sum_mod, a),
        "segment_sum_mod": _both(
            lambda x: ops.segment_sum_mod(x, ids, 5), a),
        # Shard x Replicate: b's one column broadcasts over a's cycles
        "mont_mul": _both(ops.mont_mul, a, b[:, :1]),
        "bind": _both(lambda x, y: ops.bind(x, y, data["r"]), a, b),
        # a pass's pairs (`pair_halves`): the bound tensor keeps the shard
        "bind_high": _both(lambda x: dense.bind_high(x, data["r"]), a),
        "bind_low": _both(lambda x: dense.bind_low(x, data["r"]), a),
        "evals_high": _both(
            lambda x: dense.sumcheck_eval_points_high(x, 3), a),
        "evals": _both(lambda x, y: ops.evals(x, y, 3), a, b),
        # K2 on each rank's pairs: the message summed over the ranks, the
        # bound factors sharded; "bind_message" as a bind and a message
        **{f"k2_{order}_{part}": _both(
            lambda x, y, order=order, part=part: _k2(x, y, data["r"], order,
                                                     part), a, b)
           for order in kernels.ORDERS
           for part in ("msg", "bound")
           if (order, part) not in (("bind", "msg"), ("message", "bound"))},
        "dot_2d": _both(ops.dot, a.reshape(8, 2, T // 2),
                        b.reshape(8, 2, T // 2)),
    }

    with pm.use_mesh(mesh):
        dt = pm.maybe_shard(a)
        guards = []
        for launch in (
                lambda: kernels._k1("mul", (dt, dt, None), dt.shape,
                                    dt.shape, None),
                lambda: kernels.launch_product_round((dt, dt), 0,
                                                     "message")):
            try:
                launch()
                guards.append("no error")
            except TypeError as e:
                guards.append(str(e))
        out["guards"] = guards

        class Forced(fused.FusedInstance):
            degree, device, force_device = 2, torch.device("cpu"), True
            num_rounds = 1
            input_claim = message_evals_dev = ingest_challenge = None
            expected_output_claim = None
        out["device_tier_forced"] = fused.device_tier([Forced()])

    # the guest's proof with every slot forced to the device tier, and the
    # placement of every field tensor `from_words` made
    made: List[Tuple[tuple, str]] = []
    real = ops.maybe_shard

    def record(t):
        placed = real(t)
        made.append((tuple(t.shape), str(placed.placements)))
        return placed
    ops.maybe_shard = record
    try:
        out["prove"] = prove_rank(rank, world, data["trace"],
                                  device="cpu", every_slot="device")
    finally:
        ops.maybe_shard = real
    out["made"] = made
    return out


def rounds_rank(rank: int, world: int, data: dict) -> dict:
    """`sharded_round_step` and this rank's `shard_mle` shard at D =
    world."""
    mesh = pm.cycle_mesh(device="cpu")
    sh = pm.shard_mle(ops.pack_ints(data["mle"], "cpu"), mesh)
    return {"shard": ops.unpack_ints(sh.to_local().reshape(8, -1)),
            "rounds": round_cases(data["cases"], data["polys"], data["r"],
                                  world)}
