"""The port's Pippenger MSM and K3's new forms (`jolt_tpu_torch/curve/g1.py`:
`normalize`, `bucket_sum`, `bucket_reduce`, `msm_pippenger`) against the
JAX package's host curve (`jolt_tpu/curve/bn254_host.py`), on the CPU.

On the CPU each K3 wrapper takes its plain version (`*_plain`), which
makes the same additions in the same order as the kernel; K3 itself runs
only on the card (tests/test_torch_cuda.py).  Points compare as affine
points.  Sizes are small and the window widths narrow, so that buckets
collide: zero scalars, equal scalars (one bucket: the mixed add doubles),
a point and its negation in one bucket, infinity bases and single-point
buckets.
"""

import random

import numpy as np
import pytest
import torch

from jolt_tpu.curve import bn254_host as jhost

from jolt_tpu_torch.curve import bn254_host as host
from jolt_tpu_torch.curve import g1
from jolt_tpu_torch.field import fq, kernels

torch.set_num_threads(1)

CPU = "cpu"


def _points(n, seed):
    rng = random.Random(seed)
    return [host.g1_random(rng) for _ in range(n)]


@pytest.fixture(scope="module")
def pts():
    """40 seeded points; lane 3 is infinity."""
    p = _points(40, 1)
    p[3] = None
    return p


def _words(ks):
    return np.array([[(k >> (32 * w)) & 0xFFFFFFFF for k in ks]
                     for w in range(8)], dtype=np.uint32)


def _lam(P, lam):
    """The same points in other Jacobian coordinates: (l^2 X, l^3 Y, l Z)."""
    lt = fq.pack_ints([lam], CPU)
    l2 = fq.mont_mul_plain(lt, lt)
    return (fq.mont_mul_plain(P[0], l2),
            fq.mont_mul_plain(P[1], fq.mont_mul_plain(l2, lt)),
            fq.mont_mul_plain(P[2], lt))


def test_normalize_matches_jax_host(pts):
    """Jacobian points of general Z (and an infinity whose X, Y are kept)
    normalize to the JAX package's affine points with Z = R mod q, and
    infinity to (0, 0, 0)."""
    P = _lam(g1.pack_points(pts[:8], CPU), 0xBEEF)
    P[2][:, 5] = 0
    before = kernels.k3_launches()
    N = g1.normalize(P)
    assert kernels.k3_launches() == before
    want = [None if i in (3, 5) else p for i, p in enumerate(pts[:8])]
    assert g1.unpack_points(N) == want
    assert fq.unpack_ints(N[2]) == [0 if p is None else 1 for p in want]
    assert fq.unpack_ints(N[0])[3] == fq.unpack_ints(N[1])[5] == 0
    assert want[4] == jhost.g1_add(pts[4], None)


def test_mixed_add_equals_the_generic_add(pts):
    """madd-2007-bl gives add-2007-bl's coordinates on every edge: the
    accumulator at infinity, the base at infinity, P + P, P + (-P)."""
    acc = _lam(g1.pack_points(pts[:8], CPU), 77)
    base = [None, pts[1], pts[2], host.g1_neg(pts[3] or pts[0]), None,
            pts[5], host.g1_neg(pts[6]), pts[7]]
    acc[2][:, 0] = 0
    Q = g1.affine_bases(g1.pack_points(base, CPU))
    got = g1.jacobian_madd_plain(acc, Q)
    assert all(torch.equal(a, b) for a, b in
               zip(got, g1.jacobian_add_plain(acc, Q)))
    assert g1.unpack_points(got) == [
        jhost.g1_add(p, q) for p, q in
        zip([None] + pts[1:8], base)]


def _one_segment(P, lanes):
    return g1.bucket_sum(P, torch.tensor(lanes, dtype=torch.int32),
                         torch.tensor([0, len(lanes)]))


def test_bucket_sum_segments_match_jax_host(pts):
    """Segments of every kind against the JAX package's host sums, one of
    them long enough for three levels of chunks."""
    P = g1.pack_points(pts, CPU)
    long = [i % 40 for i in range(300)]
    segs = [long, [2, 2], [0, 3], [3], [7], [], [5, 6, 7, 8, 9]]
    lanes = torch.tensor(sum(segs, []), dtype=torch.int32)
    offs = torch.tensor(np.cumsum([0] + [len(s) for s in segs]))
    got = g1.unpack_points(g1.bucket_sum(P, lanes, offs))
    want = []
    for s in segs:
        acc = None
        for i in s:
            acc = jhost.g1_add(acc, pts[i])
        want.append(acc)
    assert got == want
    # a point and its negation in one segment
    Q = g1.pack_points([pts[4], host.g1_neg(pts[4])], CPU)
    assert g1.unpack_points(_one_segment(Q, [0, 1, 0])) == [pts[4]]


def _multiples(n, seed):
    """n bases c_i A for a seeded point A, c_i = i + 1 (a chain of host
    adds), with lane 3 at infinity (c_3 = 0) and lane 5 the negation of
    lane 4 once n >= 40: the points and their c_i."""
    A = _points(1, seed)[0]
    pts, acc = [], None
    for _ in range(n):
        acc = host.g1_add(acc, A)
        pts.append(acc)
    cs = list(range(1, n + 1))
    if n >= 40:
        pts[3], cs[3] = None, 0
        pts[5], cs[5] = host.g1_neg(pts[4]), -cs[4]
    return A, pts, cs


def _msm_cases():
    rng = random.Random(9)
    full = [rng.randrange(host.R) for _ in range(1000)]
    return [
        ("random-1", 1, 3, full[:1]),
        ("random-3", 3, 2, full[:3]),
        ("random-512", 512, None, full[:512]),
        ("random-1000", 1000, 5, full[:1000]),
        ("zeros", 40, 4, [0] * 40),
        ("equal", 40, 4, [full[0]] * 40),
        ("small", 40, 3, [rng.randrange(8) for _ in range(40)]),
    ]


@pytest.mark.parametrize("name,n,c,ks", _msm_cases(),
                         ids=[c[0] for c in _msm_cases()])
def test_msm_matches_jax_host(name, n, c, ks):
    """`msm_pippenger` (digits, sort, bucket_sum, bucket_reduce; at 512
    lanes through `msm`'s dispatch) against the JAX package's host curve:
    `g1_msm` up to 40 lanes; above, on bases c_i A, one `g1_mul` of A by
    sum_i k_i c_i."""
    A, pts, cs = _multiples(n, n)
    words = _words(ks)
    P = g1.pack_points(pts, CPU)
    got = g1.unpack_points(g1.msm(P, words, 254) if c is None
                           else g1.msm_pippenger(P, words, 254, c))
    if n <= 40:
        want = jhost.g1_msm(pts, ks)
    else:
        want = jhost.g1_mul(A, sum(k * ci for k, ci in zip(ks, cs))
                            % host.R)
    assert got == [want]


def test_kzg_setup_refuses_a_cache_of_jacobian_powers(tmp_path):
    """The MSM takes its bases affine: a setup's cache whose powers have
    another Z (the same points in other Jacobian coordinates) is refused
    when it loads, and its affine cache loads."""
    from jolt_tpu_torch.pcs.hyperkzg import KZGSetup
    setup = KZGSetup.generate(16, device=CPU, cache_dir=str(tmp_path))
    g1.check_affine(setup.g1_powers_dev, "the setup")
    (cache,) = tmp_path.glob("kzg_torch_affine_16_*.npz")
    J = _lam(setup.g1_powers_dev, 0x51)
    np.savez(cache, **{k: c.numpy() for k, c in zip("xyz", J)})
    with pytest.raises(ValueError, match="not affine"):
        KZGSetup.generate(16, device=CPU, cache_dir=str(tmp_path))
    np.savez(cache, **{k: c.numpy()
                       for k, c in zip("xyz", setup.g1_powers_dev)})
    assert (KZGSetup.generate(16, device=CPU, cache_dir=str(tmp_path))
            .host_powers() == setup.host_powers())


def test_bucket_reduce_matches_the_weighted_sum():
    """sum_w 2^(c w) sum_k k B_k at c = 2 and 9 (two and 256 threads a
    window, one and two buckets a thread)."""
    for c, n_win in ((2, 3), (9, 2)):
        nb = n_win << c
        bk = _points(7, c)
        pts = [bk[i % 7] if i % 5 else None for i in range(nb)]
        B = g1.pack_points(pts, CPU)
        want = None
        for i, p in enumerate(pts):
            w, k = divmod(i, 1 << c)
            want = jhost.g1_add(want, jhost.g1_mul(p, k << (c * w))
                                if p is not None else None)
        assert g1.unpack_points(g1.bucket_reduce(B, c)) == [want]


def test_commit_positions_bucket_sum_matches_jax_host(tmp_path):
    """The one-segment `bucket_sum` that commits a one-hot vector on the
    card equals the JAX package's MSM of the 0/1 vector over the same
    powers, and the CPU commit."""
    from jolt_tpu_torch.pcs.hyperkzg import HyperKZG, KZGSetup
    setup = KZGSetup.generate(64, device=CPU, cache_dir=str(tmp_path))
    pos = np.array([0, 3, 17, 31, 63], dtype=np.int64)
    got = g1.unpack_points(_one_segment(setup.g1_powers_dev, pos.tolist()))
    ones = [1 if i in pos else 0 for i in range(64)]
    want = jhost.g1_msm(setup.host_powers(), ones)
    assert got == [want] == [HyperKZG(setup).commit_positions(pos)]


def test_dory_device_tier_rows_match_native(tmp_path):
    """Dory's one-hot tier 1 on the K3 route (one `bucket_sum`, segments =
    rows; here K3's plain versions) on a seeded small one-hot gives the
    native route's rows (`native_pairing.g1_segment_sums`)."""
    from jolt_tpu_torch.curve import native_pairing
    from jolt_tpu_torch.pcs.dory import Dory, DorySetup
    if not native_pairing.available():
        pytest.skip("the native pairing library did not build")
    setup = DorySetup.generate(6, cache_dir=str(tmp_path))
    rng = np.random.default_rng(11)
    cols = 1 << setup.sigma
    positions = [rng.integers(0, 1 << 6, 40).astype(np.int64),
                 np.sort(rng.integers(0, cols, 30)).astype(np.int64)
                 + cols * 2]
    before = kernels.k3_launches()
    dev = Dory(setup, CPU, _k3=True).onehot_rows(positions)
    assert kernels.k3_launches() == before
    assert dev == Dory(setup, CPU).onehot_rows(positions)
    assert sum(r is not None for rows in dev for r in rows) > 2


@pytest.mark.parametrize("op", ["mont_mul", "add", "sub"])
def test_fq_int_path_equals_the_limb_algorithm(op):
    """A small CPU batch's plain Fq op on Python ints gives the limb
    algorithm's words (`kernels.*_plain` with q), edge values included."""
    rng = random.Random(17)
    vals = [0, 1, 2, fq.Q - 1, fq.Q - 2, fq.R_MOD_Q, (1 << 255) % fq.Q]
    vals += [rng.randrange(fq.Q) for _ in range(41)]
    a = fq.pack_ints(vals, CPU).reshape(8, 6, 8)
    b = fq.pack_ints(vals[::-1], CPU).reshape(8, 6, 8)
    got = getattr(fq, f"{op}_plain")(a, b[:, :1])
    want = getattr(kernels, f"{op}_plain")(a, b[:, :1], fq.Q)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert a[0].numel() <= fq._INT_PATH


def test_msm_rows_matches_host():
    """`msm_rows` below 512 lanes (one scalar_mul over every row, one tree
    sum): each row's sum is the host MSM of that row, a row of zero
    scalars at infinity."""
    rng = random.Random(23)
    pts = [host.g1_mul(host.G1_GEN, rng.randrange(1, host.R))
           for _ in range(3)]
    ks = [[rng.randrange(1 << 64) for _ in range(3)], [0, 0, 0],
          [5, 0, (1 << 64) - 1]]
    words = torch.from_numpy(np.array(
        [[[(k >> 32 * w) & 0xFFFFFFFF for k in row] for row in ks]
         for w in range(2)], dtype=np.uint32).view(np.int32))
    P = tuple(c[:, None] for c in g1.pack_points(pts, CPU))
    got = g1.unpack_points(g1.msm_rows(P, words, 64))
    assert got == [host.g1_msm_pippenger(pts, row) for row in ks]
    assert got[1] is None
