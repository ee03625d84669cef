"""The port's cycle mesh (`jolt_tpu_torch/parallel/mesh.py`,
`sumcheck/sharded.py`) against the JAX package's, on the CPU.

The port's ranks are processes over gloo (`parallel.spawn`); their side of
each check is in tests/torch_mesh_ranks.py, which imports no JAX.  The JAX
side runs here on the suite's 8 virtual CPU devices.  Field values are
compared as canonical ints, exactly: no tolerance.

  * `maybe_shard`'s placements equal the JAX rule's, and rank d's shard of
    `shard_mle` equals the JAX package's addressable shard d;
  * `sharded_round_step` at D = 2 and 4, 2 and 3 polys of degree 1-3,
    equals `jolt_tpu.sumcheck.sharded.sharded_round_step` under
    `cycle_mesh(D)` (message and bound polys);
  * the field ops on a 2-rank mesh, K2's orders among them, equal their
    1-rank results, and their placements are what the mesh rule says: a
    pass's pairs keep the cycle shard, sums come back whole;
  * a DTensor handed to a launch raises; `cycle_mesh` raises with no
    process group; `device_tier` is False under a mesh even when forced;
  * the 16-cycle guest of tests/test_sharded_prove.py at D = 1 and 2:
    each rank's `serialize_proof` bytes and FS tape equal the
    single-process proof's, the field tensors `from_words` made are
    sharded where the JAX rule shards, and `jolt_tpu.verifier.verify`
    accepts the proof.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jolt_tpu.field import ops as jops
from jolt_tpu.parallel import mesh as jmesh
from jolt_tpu.proof_io import deserialize_proof
from jolt_tpu.sumcheck.sharded import sharded_round_step as j_round_step
from jolt_tpu.tracer.trace import trace_program as j_trace_program
from jolt_tpu.verifier.verifier import PublicIO as JPublicIO
from jolt_tpu.verifier.verifier import verify as j_verify

import jolt_tpu_torch as jt
import torch_mesh_ranks as ranks
from jolt_tpu_torch.parallel import cycle_mesh
from jolt_tpu_torch.parallel.spawn import prove_rank, start_ranks
from jolt_tpu_torch.proof_io import serialize_proof
from jolt_tpu_torch.riscv.emulator import MemoryLayout
from jolt_tpu_torch.tracer import trace_program

torch.set_num_threads(1)

L = MemoryLayout(max_input_size=64, max_output_size=64)
GUEST = f"""
    li   a1, 5
    li   a2, 9
    add  a3, a1, a2
    xor  a4, a1, a2
    li   t0, {L.output_start}
    sd   a3, 0(t0)
    li   t1, {L.termination}
    li   t2, 1
    sd   t2, 0(t1)
"""
CASES = [(n, d) for n in (2, 3) for d in (1, 2, 3)]
M = 4                        # the local pair axis of sharded_round_step


def _field(rng, n):
    """n field elements (canonical ints) from numpy's generator."""
    return [int(x) % jops.FR.modulus for x in
            (int(a) | int(b) << 64 | int(c) << 128 | int(d) << 192
             for a, b, c, d in rng.integers(0, 2**63, (n, 4)))]


def _data(D: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    T = M * D
    return {"mle": _field(rng, 8 * D), "cases": CASES,
            "polys": [_field(rng, T) for _ in range(3)],
            "r": _field(rng, 1)[0]}


def _canon_j(a) -> list:
    a = np.asarray(a)
    return jops.unpack_ints(a.reshape(a.shape[0], -1))


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Both rank sets, started at once: D = 2 runs every check (the
    guest's proof too), D = 4 `sharded_round_step` and `shard_mle`."""
    tr = trace_program(GUEST, layout=L, min_padded=16)
    d2 = _data(2, 17)
    rng = np.random.default_rng(18)
    T = 16
    d2.update(trace=tr, a=_field(rng, T), b=_field(rng, T),
              ids=[int(i) for i in rng.integers(0, 5, T)])
    d4 = _data(4, 19)
    # each rank set's FileStore and results in a directory of its own
    run2 = start_ranks(ranks.checks_rank, 2, d2,
                       workdir=str(tmp_path_factory.mktemp("ranks2")))
    run4 = start_ranks(ranks.rounds_rank, 4, d4,
                       workdir=str(tmp_path_factory.mktemp("ranks4")))
    # D = 1, the mesh `chip_smoke.py` runs on the card: every axis whole
    run1 = start_ranks(prove_rank, 1, tr, None, "cpu",
                       workdir=str(tmp_path_factory.mktemp("ranks1")))
    single = jt.prove(tr, device="cpu")
    return {"d2": d2, "d4": d4, "tr": tr, "single": single,
            "out2": run2.join(), "out4": run4.join(), "out1": run1.join()}


def _jax_rounds(data: dict, D: int) -> list:
    mesh = jmesh.cycle_mesh(D)
    r = jops.pack_ints([data["r"]]).reshape(-1, 1, 1)
    out = []
    for npoly, degree in data["cases"]:
        ps = tuple(jmesh.shard_mle(jops.pack_ints(p), mesh)
                   for p in data["polys"][:npoly])
        msg, bound = j_round_step(ps, r, degree)
        out.append({"msg": _canon_j(msg),
                    "bound": [_canon_j(jmesh.unshard_mle(b))
                              for b in bound]})
    return out


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_round_step_equals_the_jax_packages(spawned, D):
    data = spawned[f"d{D}"]
    want = _jax_rounds(data, D)
    for rank_out in spawned[f"out{D}"]:
        got = rank_out["rounds"]
        for case, g, w in zip(data["cases"], got, want):
            assert g["msg"] == w["msg"], case
            assert g["bound"] == w["bound"], case
            # the binds stay on their ranks
            assert set(g["placements"]) == {"(Shard(dim=2),)"}, case


@pytest.mark.parametrize("D", [2, 4])
def test_shard_mle_shards_equal_the_jax_packages(spawned, D):
    data = spawned[f"d{D}"]
    mesh = jmesh.cycle_mesh(D)
    arr = jmesh.shard_mle(jops.pack_ints(data["mle"]), mesh)
    by_device = {s.device: s.data for s in arr.addressable_shards}
    for d, dev in enumerate(mesh.devices.flat):
        assert spawned[f"out{D}"][d]["shard"] == _canon_j(by_device[dev])


def test_maybe_shard_places_as_the_jax_package(spawned):
    want = []
    with jmesh.use_mesh(jmesh.cycle_mesh(2)):
        for s in ranks.SHAPES:
            spec = jmesh.maybe_shard(jnp.zeros((20,) + s, jnp.uint32)
                                     ).sharding.spec
            want.append(f"(Shard(dim={len(s)}),)"
                        if len(spec) and spec[-1] == "cycle"
                        else "(Replicate(),)")
    for out in spawned["out2"]:
        assert out["placements"] == want


K2_CASES = [f"k2_{order}_{part}"
            for order in ("message_bind", "message", "bind_message", "bind")
            for part in ("msg", "bound")
            if (order, part) not in (("bind", "msg"), ("message", "bound"))]


@pytest.mark.parametrize("op", ["sum_mod", "segment_sum_mod", "mont_mul",
                                "bind", "bind_high", "bind_low",
                                "evals_high", "evals", "dot_2d"] + K2_CASES)
def test_field_ops_on_two_ranks_equal_one(spawned, op):
    """Each op on maybe_shard-ed operands equals the plain op; the limb
    sums and K2's messages come back `Replicate` (all-reduced), the
    elementwise forms keep the cycle shard, and so do a pass's pairs:
    a bind over the sharded axis, HighToLow or LowToHigh, its evals, and
    K2's bound factors."""
    placement = {"sum_mod": "(Replicate(),)",
                 "segment_sum_mod": "(Replicate(),)",
                 "mont_mul": "(Shard(dim=1),)", "bind": "(Shard(dim=1),)",
                 "bind_high": "(Shard(dim=1),)",
                 "bind_low": "(Shard(dim=1),)",
                 "evals_high": "(Shard(dim=2),)",
                 "evals": "(Shard(dim=2),)", "dot_2d": "(Replicate(),)",
                 **{c: "(Replicate(),)" if c.endswith("msg")
                    else "(Shard(dim=1),)" for c in K2_CASES}}
    for out in spawned["out2"]:
        got, plain, pl = out["ops"][op]
        assert got == plain
        assert pl == placement[op]


def test_a_dtensor_never_reaches_a_launch(spawned):
    for out in spawned["out2"]:
        assert all("DTensor reached the kernel launch" in g
                   for g in out["guards"]), out["guards"]
        assert out["device_tier_forced"] is False


def test_cycle_mesh_raises_without_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        cycle_mesh(2, device="cpu")


def test_guest_proof_on_two_ranks_equals_one(spawned):
    """Every rank's proof, with every slot forced to the device tier,
    equals the single-process proof in bytes and FS tape; no stage took
    the device tier; the JAX verifier accepts it."""
    single = spawned["single"]
    blob = serialize_proof(single)
    for out in spawned["out2"]:
        assert out["prove"]["bytes"] == blob
        assert out["prove"]["fs_tape"] == single.fs_tape
        assert out["prove"]["fetches"] == 0
    jtr = j_trace_program(GUEST, layout=L, min_padded=16)
    decoded, _ = deserialize_proof(spawned["out2"][1]["prove"]["bytes"])
    assert j_verify(decoded, JPublicIO.from_trace(jtr))


def test_guest_proof_on_one_rank_equals_one_process(spawned):
    """`cycle_mesh(1)`: one rank holds every axis (a length-1 axis stays
    `Replicate`, so every reshape of the prover goes through); bytes and
    FS tape are the single process's, every stage on the host engine."""
    (out,) = spawned["out1"]
    assert out["bytes"] == serialize_proof(spawned["single"])
    assert out["fs_tape"] == spawned["single"].fs_tape
    assert out["fetches"] == 0 and out["k4"] == 0


def test_witness_columns_are_sharded_by_the_jax_rule(spawned):
    """Every field tensor `from_words` made under the mesh is `Shard` on
    its last axis exactly where the JAX rule shards (a batch axis, at
    least D long and a multiple of D); the stage-1 columns (8, 38, T)
    are among the sharded ones."""
    for out in spawned["out2"]:
        made = out["made"]
        assert made
        for shape, pl in made:
            shard = len(shape) >= 2 and shape[-1] >= 2 and shape[-1] % 2 == 0
            assert pl == (f"(Shard(dim={len(shape) - 1}),)" if shard
                          else "(Replicate(),)"), shape
        assert ((8, 38, 16), "(Shard(dim=2),)") in made
