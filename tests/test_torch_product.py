"""The port's product sumcheck and its round kernel K2 against the JAX
package, on the CPU.

  * `ProductSumcheck` runs `tests/test_sumcheck.py`'s cases through both
    packages' batched sumcheck engines: the same round polynomials,
    challenges, final claims and transcript state; the port's verifier twin
    accepts and rejects a tampered round.  With 2 or 3 factors its rounds
    run on K2's live-round orders (`ProductRounds`), with 1 on the torch
    tier.
  * K2's plain version (`product_round_plain`; the wrapper takes it for CPU
    tensors), in each pass order: "message_bind", "message" and "bind"
    against the body of the JAX package's round-step entry point
    (`__graft_entry__.entry`: the jnp composition
    `sumcheck_eval_points_high` / `mont_mul` / `sum_mod` / `bind_high`) at
    T = 2^8 and 2^10, and "bind_message" against `dense.bind_high` followed
    by `sumcheck.product._product_message_kernel` at T = 2^6, 2^8, 2^10 for 2
    and 3 factors.  JAX cannot run the Pallas kernel on the CPU;
    `tests/test_pallas_kernels.py` checks its algebra the same way.
  * The message's mod-p finish (`ops.reduce_cols`, which K2's finish kernel
    equals on the card) against Python ints at extreme column sums.
"""

import random

import numpy as np
import pytest
import torch

import __graft_entry__
from jolt_tpu.field import ops as jops
from jolt_tpu.field.params import FR
from jolt_tpu.poly import dense as jdense
from jolt_tpu.poly import eq as jeq
from jolt_tpu.sumcheck import BatchedSumcheck as JBatchedSumcheck
from jolt_tpu.sumcheck import OpeningAccumulator as JOpeningAccumulator
from jolt_tpu.sumcheck.product import ProductSumcheck as JProductSumcheck
from jolt_tpu.sumcheck.product import _product_message_kernel
from jolt_tpu.transcript import Blake2bTranscript as JTranscript

from jolt_tpu_torch.field import kernels
from jolt_tpu_torch.field import ops as tops
from jolt_tpu_torch.poly import eq as teq
from jolt_tpu_torch.sumcheck.engine import (BatchedSumcheck,
                                            OpeningAccumulator,
                                            SumcheckError)
from jolt_tpu_torch.sumcheck.product import (ProductSumcheck,
                                             VerifierProductSumcheck,
                                             round_step)
from jolt_tpu_torch.transcript import Blake2bTranscript

P = FR.modulus
CPU = "cpu"


def _factor_ints(seed, sizes_and_factors):
    rng = random.Random(seed)
    return [[[rng.randrange(P) for _ in range(1 << n)] for _ in range(k)]
            for n, k in sizes_and_factors]


def _run_both(instances_j, instances_t, label):
    acc_j, tj = JOpeningAccumulator(), JTranscript(label)
    acc_t, tt = OpeningAccumulator(), Blake2bTranscript(label)
    claims_j = [i.input_claim(acc_j) for i in instances_j]
    claims_t = [i.input_claim(acc_t) for i in instances_t]
    proof_j, r_j = JBatchedSumcheck.prove(instances_j, acc_j, tj)
    proof_t, r_t = BatchedSumcheck.prove(instances_t, acc_t, tt)
    assert claims_t == claims_j
    assert proof_t == proof_j and r_t == r_j
    assert tt.state == tj.state and tt.n_rounds == tj.n_rounds
    assert ([i.final_claims for i in instances_t]
            == [i.final_claims for i in instances_j])
    return proof_t, r_t, claims_t, tt


@pytest.mark.parametrize("seed,shape", [
    (10, [(4, 2)]),                      # test_single_product_sumcheck
    (11, [(5, 3)]),                      # test_single_cubic_sumcheck
    (12, [(4, 2), (6, 3), (3, 1)]),      # test_batched_unequal_rounds
])
def test_product_sumcheck_matches_jax(seed, shape):
    ints = _factor_ints(seed, shape)
    inst_j = [JProductSumcheck([jdense.from_ints(v) for v in fs])
              for fs in ints]
    inst_t = [ProductSumcheck([tops.pack_ints(v, CPU) for v in fs])
              for fs in ints]
    proof, r, claims, tt = _run_both(inst_j, inst_t, b"test_sumcheck")
    # the port's verifier twin replays the same transcript
    ver = [VerifierProductSumcheck(i.num_rounds, c, i.final_claims)
           for i, c in zip(inst_t, claims)]
    acc_v, tv = OpeningAccumulator(), Blake2bTranscript(b"test_sumcheck")
    assert BatchedSumcheck.verify(proof, ver, acc_v, tv) == r
    for inst in inst_t:
        for k, claim in enumerate(inst.final_claims):
            acc_v.insert(("product_poly", id(inst), k), r, claim)
    acc_v.flush_to_transcript(tv)
    assert tv.state == tt.state
    bad = [list(c) for c in proof]
    bad[1][0] = (bad[1][0] + 1) % P
    with pytest.raises(SumcheckError):
        BatchedSumcheck.verify(bad, ver, OpeningAccumulator(),
                               Blake2bTranscript(b"test_sumcheck"))


def test_eq_weighted_product_sumcheck_matches_jax():
    """claim = sum_x eq(tau, x) A(x) B(x), the Spartan-outer shape."""
    rng = random.Random(16)
    tau = [rng.randrange(P) for _ in range(5)]
    a, b = ([rng.randrange(P) for _ in range(32)] for _ in range(2))
    inst_j = JProductSumcheck([jeq.evals(tau), jdense.from_ints(a),
                               jdense.from_ints(b)])
    inst_t = ProductSumcheck([teq.evals(tau, CPU), tops.pack_ints(a, CPU),
                              tops.pack_ints(b, CPU)])
    _, r, _, _ = _run_both([inst_j], [inst_t], b"eqw")
    assert inst_t.final_claims[0] == jeq.eq_int(tau, r)


# ---- K2's function: one fused round at degree 3 --------------------------

def _round_inputs(log_t, seed, nf=3):
    """nf seeded factors of 2^log_t canonical ints, and a challenge."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(nf * (1 << log_t) + 1, 8),
                         dtype=np.uint64)
    vals = [sum(int(w) << (32 * i) for i, w in enumerate(row)) % P
            for row in words]
    n = 1 << log_t
    return [vals[k * n:(k + 1) * n] for k in range(nf)], vals[-1]


def _ints(msg):
    return tops.unpack_ints(msg.reshape(8, -1))


@pytest.mark.parametrize("log_t", [8, 10])
def test_k2_plain_matches_jax_round_step(log_t):
    ints, r = _round_inputs(log_t, log_t)
    jax_round_step, _ = __graft_entry__.entry()
    msg_j, bound_j = jax_round_step(tuple(jops.pack_ints(v) for v in ints),
                                    jops.pack_ints([r]))
    polys = [tops.pack_ints(v, CPU) for v in ints]
    r_t = tops.pack_ints([r], CPU)
    want_msg = jops.unpack_ints(msg_j.reshape(msg_j.shape[0], -1))
    want_bound = [jops.unpack_ints(b) for b in bound_j]
    msg_s, bound_s = round_step(polys, r_t)
    for msg, bound in (kernels.product_round_plain(polys, r_t,
                                                   "message_bind"),
                       kernels.product_round_plain(polys, r,
                                                   "message_bind"),
                       (msg_s, bound_s)):
        assert msg.shape == (8, 3, 1)
        assert _ints(msg) == want_msg
        assert [tops.unpack_ints(b) for b in bound] == want_bound
    msg, none = kernels.product_round_plain(polys, None, "message")
    assert none is None and _ints(msg) == want_msg
    none, bound = kernels.product_round_plain(polys, r, "bind")
    assert none is None
    assert [tops.unpack_ints(b) for b in bound] == want_bound


@pytest.mark.parametrize("nf", [2, 3])
@pytest.mark.parametrize("log_t", [6, 8, 10])
def test_k2_bind_message_plain_matches_jax(log_t, nf):
    """The live-round order: bind at r, then the message of the bound
    factors, against the JAX package's bind_high and product message."""
    ints, r = _round_inputs(log_t, 100 * nf + log_t, nf)
    r_j = jops.pack_ints([r])
    bound_j = tuple(jdense.bind_high(jops.pack_ints(v), r_j) for v in ints)
    msg_j = _product_message_kernel(bound_j, nf)
    want_msg = jops.unpack_ints(msg_j.reshape(msg_j.shape[0], -1))
    want_bound = [jops.unpack_ints(b) for b in bound_j]
    polys = [tops.pack_ints(v, CPU) for v in ints]
    for msg, bound in (kernels.product_round_plain(polys, r, "bind_message"),
                       kernels.product_round(polys, tops.pack_ints([r], CPU),
                                             "bind_message")):
        assert msg.shape == (8, nf, 1)
        assert _ints(msg) == want_msg
        assert [tops.unpack_ints(b) for b in bound] == want_bound


def test_k2_finish_exact_at_extreme_sums():
    """The message's mod-p finish at column sums near its limits: every
    32-bit word near 2^32 - 1 over 2^31 - 1 terms (so the carry h above
    2^256 is ~2^31), and a many-block sum of all-ones words, against Python
    ints."""
    n_terms = (1 << 31) - 1
    rng = np.random.default_rng(7)
    low = rng.integers(0, 1 << 16, size=(8, 3, 1), dtype=np.int64)
    cols = torch.from_numpy(n_terms * ((1 << 32) - 1 - low))
    got = _ints(tops.reduce_cols(cols))
    want = [sum(int(cols[l, k, 0]) << (32 * l) for l in range(8)) % P
            * pow(1 << 256, -1, P) % P for k in range(3)]
    assert got == want
    words = torch.full((8, 3, 4096), -1, dtype=torch.int32)   # 2^32 - 1
    got = _ints(tops.sum_mod(words))
    s = 4096 * ((1 << 256) - 1)
    assert got == [s % P * pow(1 << 256, -1, P) % P] * 3


def test_round_step_chained_matches_python_ints():
    """Chained rounds 2^4 -> 1 against the definition on Python ints."""
    ints, _ = _round_inputs(4, 3)
    rng = random.Random(5)
    polys = tuple(tops.pack_ints(v, CPU) for v in ints)
    while len(ints[0]) > 1:
        r = rng.randrange(P)
        h = len(ints[0]) // 2
        want = [sum(_prod(v[i] + x * (v[i + h] - v[i]) for v in ints)
                    for i in range(h)) % P for x in (0, 2, 3)]
        msg, polys = round_step(polys, tops.pack_ints([r], CPU))
        assert tops.unpack_ints(msg.reshape(8, -1)) == want
        ints = [[(v[i] + r * (v[i + h] - v[i])) % P for i in range(h)]
                for v in ints]
        assert [tops.unpack_ints(p) for p in polys] == ints


def _prod(it):
    out = 1
    for x in it:
        out = out * x % P
    return out


def test_k2_wrapper_takes_plain_on_cpu_without_launching():
    ints, r = _round_inputs(6, 9)
    polys = [tops.pack_ints(v, CPU) for v in ints]
    r_t = tops.pack_ints([r], CPU)
    before = kernels.product_round.launches
    msg, *bound = kernels.product_round_deg3(*polys, r_t)
    want = kernels.product_round_plain(polys, r_t, "message_bind")
    assert torch.equal(msg, want[0])
    assert all(torch.equal(g, w) for g, w in zip(bound, want[1]))
    for nf in (2, 3):
        for order in kernels.ORDERS:
            msg, bound = kernels.product_round(polys[:nf], r, order)
            want_msg, want_bound = kernels.product_round_plain(polys[:nf], r,
                                                               order)
            assert (msg is None) == (want_msg is None)
            assert msg is None or torch.equal(msg, want_msg)
            assert (bound is None) == (want_bound is None)
            assert bound is None or all(
                torch.equal(b, w) for b, w in zip(bound, want_bound))
    assert kernels.product_round.launches == before


def test_k2_wrapper_refuses_mixed_devices_and_bad_shapes():
    a = torch.zeros((8, 4), dtype=torch.int32)
    r = torch.zeros((8, 1), dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.product_round_deg3(a, a, a, r.to("meta"))
    with pytest.raises(ValueError):
        round_step([a, a], r)
    with pytest.raises(ValueError):                  # four factors
        kernels.product_round([a] * 4, r, "message")
    with pytest.raises(ValueError):                  # no such order
        kernels.product_round([a] * 2, r, "bind_twice")
    with pytest.raises(ValueError):                  # T/4 pairs: T >= 4
        kernels.product_round([a[:, :2]] * 2, r, "bind_message")
