"""The port's G1 (`jolt_tpu_torch/curve/g1.py`) against the JAX package's
(`jolt_tpu/curve/g1.py`), on the CPU.

Seeded random points (`bn254_host.g1_random`) with infinity, P + P and
P + (-P) lanes among them go through both packages.  On the CPU the port's
K3 wrappers take their plain versions (`*_plain`, the same formulas on
`field/fq.py`).  The ops compare as canonical ints of X, Y and Z (both
compute the same rational functions of the inputs); the segmented scan,
whose tree differs from `jax.lax.associative_scan`'s, and the Pippenger MSM
compare as affine points.  K3 itself runs only on the card: its tests are
in tests/test_torch_cuda.py.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jolt_tpu.curve import g1 as jg1
from jolt_tpu.field import ops as jops
from jolt_tpu.field.params import FQ

from jolt_tpu_torch.curve import bn254_host as host
from jolt_tpu_torch.curve import g1
from jolt_tpu_torch.field import fq, kernels

torch.set_num_threads(1)

CPU = "cpu"
N = 16


def _points(n, seed):
    rng = random.Random(seed)
    return [host.g1_random(rng) for _ in range(n)]


@pytest.fixture(scope="module")
def pts():
    """N points: lane 1 is infinity."""
    p = _points(N, 1)
    p[1] = None
    return p


@pytest.fixture(scope="module")
def others(pts):
    """A second batch against `pts`: lane 0 infinity (and lane 1, so both
    operands are at infinity there), lane 2 equal (P + P), lane 3 the
    negation (P + (-P)), the rest random."""
    q = _points(N, 2)
    q[0] = q[1] = None
    q[2] = pts[2]
    q[3] = host.g1_neg(pts[3])
    return q


def _jax_ints(P):
    return [jops.unpack_ints(c, FQ) for c in P]


def _port_ints(P):
    return [fq.unpack_ints(c.reshape(8, -1)) for c in P]


def _both(points):
    return jg1.pack_points(points), g1.pack_points(points, CPU)


def _garbage_infinity(jP, tP):
    """The batches with lane 4's Z set to 0 and its X, Y kept: an
    infinity that is not (0, 0, 0), as a double-and-add makes them."""
    mask = np.ones(N, dtype=bool)
    mask[4] = False
    return (jg1.mask_points(jP, jnp.asarray(mask)),
            g1.mask_points(tP, torch.from_numpy(mask)))


def test_pack_unpack_roundtrip(pts):
    jP, tP = _both(pts)
    assert g1.unpack_points(tP) == pts
    assert _port_ints(tP) == _jax_ints(jP)


def test_jacobian_add_matches_jax(pts, others):
    (jP, tP), (jQ, tQ) = _both(pts), _both(others)
    jP, tP = _garbage_infinity(jP, tP)
    # non-trivial Z on both sides: add a double's output to a sum's
    jD, tD = jg1.jacobian_double(jP), g1.jacobian_double(tP)
    jS, tS = jg1.jacobian_add(jP, jQ), g1.jacobian_add(tP, tQ)
    assert _port_ints(tS) == _jax_ints(jS)
    jT, tT = jg1.jacobian_add(jD, jS), g1.jacobian_add(tD, tS)
    assert _port_ints(tT) == _jax_ints(jT)
    # P + P doubles, P + (-P) is (0, 0, 0), infinity + Q is Q
    got = g1.unpack_points(tS)
    assert got[2] == host.g1_double(pts[2]) and got[3] is None
    assert got[0] == pts[0] and got[1] is None
    assert _port_ints(tS)[2][3] == 0 and _port_ints(tS)[0][3] == 0
    assert got[5:] == [host.g1_add(a, b) for a, b in zip(pts[5:], others[5:])]


def test_jacobian_double_matches_jax(pts):
    jP, tP = _both(pts)
    jP, tP = _garbage_infinity(jP, tP)
    jD, tD = jg1.jacobian_double(jP), g1.jacobian_double(tP)
    assert _port_ints(tD) == _jax_ints(jD)
    got = g1.unpack_points(tD)
    assert got[4] is None
    assert got[5:] == [host.g1_double(p) for p in pts[5:]]


def test_tree_sum_and_mask_points_match_jax(pts):
    jP, tP = _both(pts[:13])                 # 13: padded to 16
    mask = np.array([i % 3 != 1 for i in range(13)])
    jM = jg1.mask_points(jP, jnp.asarray(mask))
    tM = g1.mask_points(tP, torch.from_numpy(mask))
    assert _port_ints(tM) == _jax_ints(jM)
    jT, tT = jg1.tree_sum(jM), g1.tree_sum(tM)
    assert _port_ints(tT) == _jax_ints(jT)
    want = None
    for p, m in zip(pts[:13], mask):
        if m:
            want = host.g1_add(want, p)
    assert g1.unpack_points(tT) == [want]


def test_msm_binary_and_u8_match_jax(pts):
    jP, tP = _both(pts)
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, N).astype(np.uint32)
    jB = jg1.msm_binary(jP, jnp.asarray(bits))
    tB = g1.msm_binary(tP, torch.from_numpy(bits.view(np.int32)))
    assert _port_ints(tB) == _jax_ints(jB)
    u8 = rng.integers(0, 256, N).astype(np.uint32)
    u8[:2] = [255, 0]
    jU = jg1.msm_u8(jP, jnp.asarray(u8))
    tU = g1.msm_u8(tP, torch.from_numpy(u8.view(np.int32)))
    assert _port_ints(tU) == _jax_ints(jU)
    assert g1.unpack_points(tU) == [host.g1_msm(pts, [int(k) for k in u8])]


def test_batch_scalar_mul_254_bits_matches_jax(pts):
    jP, tP = _both(pts)
    rng = random.Random(4)
    ks = [rng.randrange(1 << 254) for _ in range(N)]
    ks[0], ks[6] = 0, 1
    words = np.array([[(k >> (32 * w)) & 0xFFFFFFFF for k in ks]
                      for w in range(8)], dtype=np.uint32)
    jM = jg1.batch_scalar_mul(jP, jnp.asarray(words), 254)
    tM = g1.batch_scalar_mul(tP, torch.from_numpy(words.view(np.int32)), 254)
    assert _port_ints(tM) == _jax_ints(jM)
    assert g1.unpack_points(tM) == [host.g1_mul(p, k)
                                    for p, k in zip(pts, ks)]


def test_segmented_scan_totals_match_jax():
    """Segment totals (at each segment's last lane) equal the JAX
    package's as affine points, segments of 1 to 4 lanes (8 lanes: the
    JAX package's scan compiles for ~40 s at 12 lanes, ~2 min at 40)."""
    pts = _points(8, 5)
    pts[6] = None
    heads = np.zeros(8, dtype=np.uint32)
    heads[[0, 3, 4]] = 1
    jP, tP = _both(pts)
    jS = jg1.segmented_scan_points(jP, jnp.asarray(heads[None]))
    tS = g1.segmented_scan_points(tP, torch.from_numpy(heads[None]
                                                       .view(np.int32)))
    lasts = np.nonzero(np.concatenate([heads[1:], [1]]))[0]
    j_aff = jg1.unpack_points(tuple(a[:, lasts] for a in jS))
    t_aff = g1.unpack_points(tuple(a[:, lasts] for a in tS))
    assert t_aff == j_aff
    # every prefix, against the host
    acc, want = None, []
    for p, h in zip(pts, heads):
        acc = host.g1_add(None if h else acc, p)
        want.append(acc)
    assert g1.unpack_points(tS) == want


def test_msm_pippenger_matches_host():
    """Pippenger at N = 512 (full-width scalars, zeros among them) equals
    `bn254_host.g1_msm_pippenger` and `g1_msm` as an affine point, through
    `msm`'s dispatch."""
    n = 512
    pts = _points(n, 6)
    rng = random.Random(7)
    ks = [rng.randrange(host.R) for _ in range(n)]
    ks[:3] = [0, 1, 0]
    words = np.array([[(k >> (32 * w)) & 0xFFFFFFFF for k in ks]
                      for w in range(8)], dtype=np.uint32)
    tP = g1.pack_points(pts, CPU)
    got = g1.unpack_points(g1.msm(tP, words, 254))
    assert got == [host.g1_msm_pippenger(pts, ks)]
    assert got == [host.g1_msm(pts, ks)]


def test_wrappers_take_plain_on_cpu_without_launching(pts):
    before = kernels.k3_launches()
    tP = g1.pack_points(pts, CPU)
    assert all(torch.equal(a, b) for a, b in
               zip(g1.jacobian_add(tP, tP), g1.jacobian_add_plain(tP, tP)))
    assert kernels.k3_launches() == before
    with pytest.raises(TypeError):
        g1.jacobian_double(tuple(c.to(torch.int64) for c in tP))
