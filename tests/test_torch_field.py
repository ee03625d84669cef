"""The torch port's Fr tier against the JAX package's, on the CPU.

Seeded numpy inputs (with 0, 1 and r-1 among them) go through
`jolt_tpu.field.ops` and `jolt_tpu_torch.field.ops` on device="cpu"; the
results are compared as canonical ints, exactly.  On the CPU the JAX
package's `mont_mul` takes its rolled tier and the port's wrapper takes
`mont_mul_plain`.  Batches sit on both sides of the JAX package's
2048-lane Pallas threshold.  The K1 kernel itself runs only on the card:
its tests are in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jolt_tpu.field import ops as jops
from jolt_tpu.field.params import FR

from jolt_tpu_torch.field import kernels
from jolt_tpu_torch.field import ops as tops
from jolt_tpu_torch.interop import from_jax_limbs

P = FR.modulus
CPU = "cpu"
BATCHES = [1, 2047, 2048, 4096]


def _vals(n: int, seed: int):
    """n seeded field elements; the first ones are r-1, 0 and 1."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    out = [int.from_bytes(row.astype("<u4").tobytes(), "little") % P
           for row in words]
    for i, edge in enumerate([P - 1, 0, 1][:n]):
        out[i] = edge
    return out


def _both(vals):
    return jops.pack_ints(vals), tops.pack_ints(vals, CPU)


BINARY = {
    "mont_mul": (jops.mont_mul, tops.mont_mul),
    "add": (jops.add, tops.add),
    "sub": (jops.sub, tops.sub),
}


@pytest.mark.parametrize("n", BATCHES)
@pytest.mark.parametrize("op", sorted(BINARY))
def test_binary_op_matches_jax(op, n):
    xs, ys = _vals(n, 1), _vals(n, 2)[::-1]
    (ja, ta), (jb, tb) = _both(xs), _both(ys)
    jf, tf = BINARY[op]
    assert tops.unpack_ints(tf(ta, tb)) == jops.unpack_ints(jf(ja, jb))


@pytest.mark.parametrize("n", BATCHES)
def test_neg_matches_jax(n):
    ja, ta = _both(_vals(n, 3))
    assert tops.unpack_ints(tops.neg(ta)) == jops.unpack_ints(jops.neg(ja))


@pytest.mark.parametrize("n", BATCHES)
def test_from_u64_matches_jax(n):
    rng = np.random.default_rng(4)
    lo = rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    lo[:2], hi[:2] = 0xFFFFFFFF, 0xFFFFFFFF
    want = jops.unpack_ints(jops.from_u64(jnp.asarray(lo), jnp.asarray(hi)))
    got = tops.unpack_ints(tops.from_u64(torch.from_numpy(lo.view(np.int32)),
                                         torch.from_numpy(hi.view(np.int32))))
    assert got == want
    assert got[0] == (1 << 64) - 1
    want32 = jops.unpack_ints(jops.from_u32(jnp.asarray(lo)))
    assert tops.unpack_ints(tops.from_u32(torch.from_numpy(
        lo.view(np.int32)))) == want32


@pytest.mark.parametrize("n", BATCHES)
def test_sum_mod_matches_jax(n):
    ja, ta = _both(_vals(n, 5))
    assert (tops.unpack_ints(tops.sum_mod(ta))
            == jops.unpack_ints(jops.sum_mod(ja)))


@pytest.mark.parametrize("n", BATCHES)
def test_dot_matches_jax(n):
    (ja, ta), (jb, tb) = _both(_vals(n, 6)), _both(_vals(n, 7))
    assert (tops.unpack_ints(tops.dot(ta, tb))
            == jops.unpack_ints(jops.dot(ja, jb)))


def test_sum_mod_rows_and_wide_carry():
    """sum_mod over the last axis of a 2-D batch, with every term r-1 so
    the int64 limb planes carry far past 2^256."""
    vals = [P - 1] * 4096
    t = tops.pack_ints(vals, CPU).reshape(8, 4, 1024)
    got = tops.unpack_ints(tops.sum_mod(t).reshape(8, 4))
    assert got == [1024 * (P - 1) % P] * 4


def test_broadcast_scalar_and_rows():
    xs = _vals(6, 8)
    s = _vals(1, 9)[0]
    ta = tops.pack_ints(xs, CPU).reshape(8, 2, 3)
    got = tops.mont_mul(tops.pack_ints([s], CPU)[:, :, None], ta)
    assert tops.unpack_ints(got.reshape(8, 6)) == [s * x % P for x in xs]
    w = tops.pack_ints([3, 5], CPU)[:, :, None]              # per-row weight
    got = tops.mont_mul(w, ta)
    assert (tops.unpack_ints(got.reshape(8, 6))
            == [(3 if i < 3 else 5) * x % P for i, x in enumerate(xs)])


def test_const_select_canonical():
    xs = _vals(4, 10)
    ta = tops.pack_ints(xs, CPU)
    c = tops.const_mont(7, (1,), CPU)
    assert tops.unpack_ints(tops.mont_mul(ta, c)) == [7 * x % P for x in xs]
    mask = torch.tensor([True, False, True, False])
    got = tops.select(mask, ta, torch.zeros_like(ta))
    assert tops.unpack_ints(got) == [xs[0], 0, xs[2], 0]
    canon = tops.to_canonical(ta)
    words = canon.numpy().astype(np.uint32).T.astype("<u4")
    assert [int.from_bytes(w.tobytes(), "little") for w in words] == xs


@pytest.mark.parametrize("n", [1, 2048])
def test_from_jax_limbs(n):
    vals = _vals(n, 11)
    ja, ta = _both(vals)
    got = from_jax_limbs(np.asarray(ja), CPU)
    assert torch.equal(got, ta)
    assert tops.unpack_ints(got) == vals


def test_mont_mul_plain_edges_against_ints():
    """The plain version against Python ints on 0, 1, r-1 and a < 2^256
    first operand (the reduction's input range)."""
    edge = [0, 1, P - 1, (1 << 256) - 1]
    a = [x for x in edge for _ in edge[:3]]
    b = [y for _ in edge for y in edge[:3]]

    def words(vals):
        raw = b"".join(v.to_bytes(32, "little") for v in vals)
        w = np.frombuffer(raw, dtype="<u4").reshape(-1, 8).T
        return torch.from_numpy(np.ascontiguousarray(w).view(np.int32))
    out = kernels.mont_mul_plain(words(a), words(b))
    raw = out.numpy().astype(np.uint32).T.astype("<u4")
    got = [int.from_bytes(r.tobytes(), "little") for r in raw]
    r_inv = pow(1 << 256, -1, P)
    assert got == [x * y * r_inv % P for x, y in zip(a, b)]


def test_wrapper_takes_plain_on_cpu_without_launching():
    before = kernels.mont_mul.launches
    ta = tops.pack_ints(_vals(8, 12), CPU)
    assert torch.equal(kernels.mont_mul(ta, ta), kernels.mont_mul_plain(ta, ta))
    assert kernels.mont_mul.launches == before


def test_constants_upload_once_per_value_and_device():
    """Field constants (a scalar `pack_ints`, `_const`, `sub`'s p words)
    are made once per (value, device) and reused, and reuse changes no
    result."""
    s = _vals(1, 13)[0]
    a, b = tops.pack_ints([s], CPU), tops.pack_ints([s], CPU)
    assert a.data_ptr() == b.data_ptr()
    assert tops.unpack_ints(a) == [s]
    assert tops.ones((3,), CPU).data_ptr() == tops.const_mont(1, (1,),
                                                            CPU).data_ptr()
    xs, ys = _vals(5, 14), _vals(5, 15)
    for _ in range(2):
        got = tops.sub(tops.pack_ints(xs, CPU), tops.pack_ints(ys, CPU))
        assert tops.unpack_ints(got) == [(x - y) % P for x, y in zip(xs, ys)]


def test_kernel_source_constants_match_the_field():
    """The words of p, R mod p and R^2 mod p and -p^-1 mod 2^32 that the
    port's CUDA kernels compile in (`csrc/fr.cuh`) are the field's."""
    import pathlib
    import re
    src = (pathlib.Path(kernels.__file__).resolve().parents[1] / "csrc"
           / "fr.cuh").read_text()

    def words(name):
        body = re.search(rf"#define {name}\s*\\\s*\{{([^}}]*)\}}", src).group(1)
        return sum(int(w, 16) << (32 * i)
                   for i, w in enumerate(re.findall(r"0x([0-9a-f]+)u", body)))

    R = 1 << 256
    assert words("FR_P_WORDS") == P
    assert words("FR_R_WORDS") == R % P
    assert words("FR_R2_WORDS") == R * R % P
    n0 = int(re.search(r"kN0 = 0x([0-9a-f]+)u", src).group(1), 16)
    assert n0 * P % (1 << 32) == (1 << 32) - 1
