"""The torch port's Fr tier against the JAX package's, on the CPU.

Seeded numpy inputs (with 0, 1 and r-1 among them) go through
`jolt_tpu.field.ops` and `jolt_tpu_torch.field.ops` on device="cpu"; the
results are compared as canonical ints, exactly.  On the CPU the JAX
package's `mont_mul` takes its rolled tier and the port's wrapper takes
`mont_mul_plain`.  Batches sit on both sides of the JAX package's
2048-lane Pallas threshold.  The K1 kernel itself runs only on the card:
its tests are in tests/test_torch_cuda.py.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jolt_tpu.field import ops as jops
from jolt_tpu.field.params import FR

from jolt_tpu_torch import workload
from jolt_tpu_torch.field import kernels
from jolt_tpu_torch.field import ops as tops
from jolt_tpu_torch.interop import from_jax_limbs

# One intra-op thread: the suite runs in several worker processes, and
# torch's default of a thread per core in each oversubscribes the CPU
# (the fib prefix: ~6 s alone, ~250 s with six such processes).
torch.set_num_threads(1)

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


# ---- K1's forms: each plain version against the JAX package ------------

from jolt_tpu.poly import dense as jdense  # noqa: E402


def _pair(n, seed):
    """Seeded canonical ints (edges first) as JAX and port limbs."""
    return _both(_vals(n, seed))


@pytest.mark.parametrize("n", [2048, 4096])
@pytest.mark.parametrize("op", ["add", "sub"])
def test_add_sub_plain_match_jax(op, n):
    """add_plain / sub_plain on streaming operands, a broadcast scalar and a
    per-row operand, against jops.add / jops.sub."""
    (ja, ta), (jb, tb) = _pair(n, 20), _pair(n, 21)
    plain = getattr(kernels, f"{op}_plain")
    jf = getattr(jops, op)
    assert tops.unpack_ints(plain(ta, tb)) == jops.unpack_ints(jf(ja, jb))
    (js, ts) = _pair(1, 22)
    assert (tops.unpack_ints(plain(ta, ts))
            == jops.unpack_ints(jf(ja, jnp.broadcast_to(js, ja.shape))))
    rows = ta.reshape(8, 2, n // 2)
    w = tops.pack_ints([P - 1, 1], CPU)[:, :, None]            # per row
    got = tops.unpack_ints(plain(rows, w).reshape(8, n))
    xs = tops.unpack_ints(ta)
    sign = 1 if op == "add" else -1
    assert got == [(x + sign * (P - 1 if i < n // 2 else 1)) % P
                   for i, x in enumerate(xs)]


@pytest.mark.parametrize("r_as", ["int", "tensor"])
@pytest.mark.parametrize("order", ["high", "low"])
def test_bind_plain_matches_jax(order, r_as):
    jp, tp = _pair(4096, 23)
    r = _vals(3, 24)[2]
    r_t = r if r_as == "int" else tops.pack_ints([r], CPU)
    half = 2048
    if order == "high":
        lo, hi = tp[:, :half], tp[:, half:]
    else:
        lo, hi = tp[:, 0::2], tp[:, 1::2]
    got = kernels.bind_plain(lo, hi, kernels._plain_operand(r_t, CPU, 1))
    want = getattr(jdense, f"bind_{order}")(jp, jops.pack_ints([r]))
    assert tops.unpack_ints(got) == jops.unpack_ints(want)
    assert torch.equal(kernels.bind(lo, hi, r_t), got)


@pytest.mark.parametrize("degree", [2, 3])
def test_evals_plain_matches_jax(degree):
    jp, tp = _pair(4096, 25)
    got = kernels.evals_plain(tp[:, :2048], tp[:, 2048:], degree)
    want = jdense.sumcheck_eval_points_high(jp, degree)
    assert got.shape == (8, degree, 2048)
    assert (tops.unpack_ints(got.reshape(8, -1))
            == jops.unpack_ints(want.reshape(want.shape[0], -1)))


@pytest.mark.parametrize("scale", [None, "int", "tensor"])
@pytest.mark.parametrize("n", [2048, 4096])
def test_reduce_plain_matches_jax(n, scale):
    """reduce_plain of the int64 limb-plane sums, with and without a scale,
    against jops.sum_mod followed by a product."""
    ja, ta = _pair(n, 26)
    s = _vals(2, 27)[1]
    cols = kernels.u64_words(ta).sum(dim=-1, keepdim=True)
    arg = {None: None, "int": s, "tensor": tops.pack_ints([s], CPU)}[scale]
    got = kernels.reduce_plain(
        cols, None if arg is None else kernels._plain_operand(arg, CPU, 1))
    want = jops.sum_mod(ja)
    if scale is not None:
        want = jops.mont_mul(want, jops.pack_ints([s]))
    assert tops.unpack_ints(got) == jops.unpack_ints(want)
    assert torch.equal(tops.sum_mod(ta, arg), got)


@pytest.mark.parametrize("form", kernels.FORMS)
def test_k1_wrappers_take_plain_on_cpu_without_launching(form):
    xs = tops.pack_ints(_vals(16, 28), CPU)
    r = _vals(2, 29)[1]
    cols = kernels.u64_words(xs).sum(dim=-1, keepdim=True)
    calls = {
        "mul": (lambda: kernels.mont_mul(xs, r),
                lambda: kernels.mont_mul_plain(xs, tops.pack_ints([r], CPU))),
        "add": (lambda: kernels.add(xs, xs), lambda: kernels.add_plain(xs, xs)),
        "sub": (lambda: kernels.sub(0, xs),
                lambda: kernels.sub_plain(torch.zeros_like(xs), xs)),
        "bind": (lambda: kernels.bind(xs[:, 0::2], xs[:, 1::2], r),
                 lambda: kernels.bind_plain(xs[:, 0::2], xs[:, 1::2],
                                            tops.pack_ints([r], CPU))),
        "evals": (lambda: kernels.evals(xs[:, :8], xs[:, 8:], 3),
                  lambda: kernels.evals_plain(xs[:, :8], xs[:, 8:], 3)),
        "reduce": (lambda: kernels.reduce(cols, r),
                   lambda: kernels.reduce_plain(
                       cols, tops.pack_ints([r], CPU))),
    }
    before = kernels.k1_launches()
    got, want = calls[form][0](), calls[form][1]()
    assert torch.equal(got, want)
    assert kernels.k1_launches() == before


def test_k1_wrappers_refuse_what_the_kernel_does_not_take():
    a = tops.pack_ints(_vals(8, 30), CPU)
    with pytest.raises(ValueError):
        kernels.add(a, a.to("meta"))
    with pytest.raises(TypeError):
        kernels.sub(a, a.to(torch.int64))
    with pytest.raises(ValueError):
        kernels.bind(a, a, a)                 # r must be one element
    with pytest.raises(ValueError):
        kernels.evals(a, a, 0)
    with pytest.raises(TypeError):
        kernels.reduce(a)                     # the sums are int64


# ---- K1's launch records, run by an emulator of the kernel -------------
#
# The CUDA kernel runs only on the card.  Here each wrapper's CUDA branch
# runs on CPU tensors with its launch handed to `_emulate`, which reads and
# writes memory exactly where csrc/mont_mul.cu would for that record
# (operand kinds, strides, merged rows, the evals planes) and checks the
# alignment that the kernel's 64-bit accesses need; its
# arithmetic is Python ints.  So the wrapper's description of every layout
# is held against the plain version before any launch on the card.

_R_INV = pow(1 << 256, -1, P)
_K = kernels


def _emulate(form, out, L):
    n0, n1, deg = L.n0, L.n1, max(L.deg, 1)
    N = n0 * n1
    assert 8 * deg * N < 1 << 31

    def words(o, off, width=4):
        assert off + 7 * o.sl < 1 << 31                  # 32-bit offsets
        ctype = ctypes.c_uint32 if width == 4 else ctypes.c_uint64
        return [ctype.from_address(o.p + width * (off + l * o.sl)).value
                for l in range(8)]

    def value(o, row, col, width=4):
        if o.kind == _K._SCALAR:
            ws = list(o.w)
        else:
            s1 = 0 if o.kind == _K._ROW else o.s1
            off = row * o.s0 + col * s1
            if o.kind == _K._VEC:
                assert o.s1 == 1
                assert col % 2 or (o.p + 4 * off) % 8 == 0
                assert o.sl % 2 == 0
            ws = words(o, off, width)
        return sum(w << (32 * l) for l, w in enumerate(ws))

    for row in range(n0):
        for col in range(n1):
            if form == "reduce":
                x = value(L.a, row, col, width=8)
            else:
                x, y = value(L.a, row, col), value(L.b, row, col)
            if form == "mul":
                outs = [x * y * _R_INV % P]
            elif form == "add":
                outs = [(x + y) % P]
            elif form == "sub":
                outs = [(x - y) % P]
            elif form == "bind":
                r = value(L.c, row, col)
                outs = [(x + (y - x) * r * _R_INV) % P]
            elif form == "evals":
                outs = [x] + [(y + k * (y - x)) % P for k in range(1, deg)]
            else:
                outs = [x % P]
                if L.c.kind != _K._NONE:
                    outs = [outs[0] * value(L.c, row, col) * _R_INV % P]
            for k, v in enumerate(outs):
                for l in range(8):
                    addr = out.data_ptr() + 4 * (l * deg * N + k * N
                                                 + row * n1 + col)
                    ctypes.c_uint32.from_address(addr).value = \
                        (v >> (32 * l)) & 0xFFFFFFFF


def _field(shape, seed):
    n = int(np.prod(shape[1:]))
    return tops.pack_ints(_vals(n, seed), CPU).reshape(shape)


def _sums(shape, seed):
    """Exact int64 limb-plane sums of 5 field elements per entry."""
    return kernels.u64_words(_field(tuple(shape) + (5,), seed)).sum(dim=-1)


_S = _vals(2, 31)[1]


def _halves(P, r):
    h = P.shape[-1] // 2
    return _K.bind(P[..., :h], P[..., h:], r)


def _pairs(P, r):
    return _K.bind(P[..., 0::2], P[..., 1::2], r)


def _points(P, degree):
    h = P.shape[-1] // 2
    return _K.evals(P[..., :h], P[..., h:], degree)


# name -> (the operands, the wrapper that takes them, the kinds of operands
# a, b, c it must launch)
_LAYOUTS = {
    "mul streaming": (lambda: (_field((8, 2, 8), 1), _field((8, 2, 8), 2)),
                      _K.mont_mul, ("VEC", "VEC", "NONE")),
    "mul int": (lambda: (_field((8, 3, 4), 3), _S), _K.mont_mul,
                ("VEC", "SCALAR", "NONE")),
    "mul odd planes": (lambda: (_field((8, 15), 4), _S), _K.mont_mul,
                       ("STRIDED", "SCALAR", "NONE")),
    "mul per row": (lambda: (_field((8, 4, 1), 5), _field((8, 4, 6), 6)),
                    _K.mont_mul, ("ROW", "VEC", "NONE")),
    "mul unaligned view": (lambda: (_field((8, 12), 7)[:, 1:9],
                                    _field((8, 8), 8)),
                           _K.mont_mul, ("STRIDED", "VEC", "NONE")),
    "mul broadcast copy": (lambda: (_field((8, 2, 1, 4), 9),
                                    _field((8, 2, 3, 4), 10)),
                           _K.mont_mul, ("VEC", "VEC", "NONE")),
    "mul one column": (lambda: (_field((8, 5, 1), 11), _field((8, 5, 1), 12)),
                       _K.mont_mul, ("STRIDED", "STRIDED", "NONE")),
    "add device scalar": (lambda: (_field((8, 6), 13), _field((8, 1), 14)),
                          _K.add, ("VEC", "ROW", "NONE")),
    "sub neg": (lambda: (0, _field((8, 3, 2), 15)), _K.sub,
                ("SCALAR", "VEC", "NONE")),
    "bind high": (lambda: (_field((8, 16), 16), _S), _halves,
                  ("VEC", "VEC", "SCALAR")),
    "bind high rows": (lambda: (_field((8, 3, 8), 17), _S), _halves,
                       ("VEC", "VEC", "SCALAR")),
    "bind low": (lambda: (_field((8, 16), 19), _field((8, 1), 18)), _pairs,
                 ("STRIDED", "STRIDED", "ROW")),
    "bind low rows": (lambda: (_field((8, 3, 8), 20), _S), _pairs,
                      ("STRIDED", "STRIDED", "SCALAR")),
    "bind low odd": (lambda: (_field((8, 14), 21), _S), _pairs,
                     ("STRIDED", "STRIDED", "SCALAR")),
    "bind split": (lambda: (_field((8, 6), 22), _field((8, 6), 23), _S),
                   _K.bind, ("VEC", "VEC", "SCALAR")),
    "evals high 2": (lambda: (_field((8, 16), 24), 2), _points,
                     ("VEC", "VEC", "NONE")),
    "evals high 3 rows": (lambda: (_field((8, 2, 8), 25), 3), _points,
                          ("VEC", "VEC", "NONE")),
    "evals split 3": (lambda: (_field((8, 6), 26), _field((8, 6), 27), 3),
                      _K.evals, ("VEC", "VEC", "NONE")),
    # a stacked product's message (`product.stack_message`): the eval
    # points of every factor's halves, then factor planes of that output
    "evals stack": (lambda: (_field((8, 3, 16), 32), 4), _points,
                    ("VEC", "VEC", "NONE")),
    "mul stack factors": (lambda: (_field((8, 4, 3, 8), 33)[:, :, 0],
                                   _field((8, 4, 3, 8), 34)[:, :, 2]),
                          _K.mont_mul, ("VEC", "VEC", "NONE")),
    "reduce": (lambda: (_sums((8, 3, 1), 28),), _K.reduce,
               ("STRIDED", "NONE", "NONE")),
    "reduce int scale": (lambda: (_sums((8, 3, 1), 29), _S), _K.reduce,
                         ("STRIDED", "NONE", "SCALAR")),
    "reduce row scale": (lambda: (_sums((8, 4, 6), 30), _field((8, 4, 1), 31)),
                         _K.reduce, ("VEC", "NONE", "ROW")),
}
_KIND_NAMES = {getattr(_K, f"_{k}"): k for k in
               ("NONE", "SCALAR", "ROW", "VEC", "STRIDED")}


@pytest.mark.parametrize("name", sorted(_LAYOUTS))
def test_k1_launch_record_addresses_every_layout(name, monkeypatch):
    make, wrapper, kinds = _LAYOUTS[name]
    args = make()
    want = wrapper(*args)                          # the plain version
    launched = []

    def emulate(form, out, L):
        launched.append(tuple(_KIND_NAMES[o.kind] for o in (L.a, L.b, L.c)))
        _emulate(form, out, L)

    monkeypatch.setattr(_K, "_device", lambda form, *xs: torch.device("cuda"))
    monkeypatch.setattr(_K, "_go", emulate)
    got = wrapper(*args)
    assert launched == [kinds]
    assert got.shape == want.shape and torch.equal(got, want)


# ---- K1's bounds -------------------------------------------------------

_MB = 1 << 20


@pytest.mark.parametrize("form, key, n_bytes, mads", [
    ("mul", ((8, _MB), (8, _MB)), 96 * _MB, 272 * _MB),
    ("sub", ((8, _MB), "int"), 64 * _MB, 0),
    ("bind", ((8, 1 << 17), "high", "int"), 96 << 17, 272 << 17),
    ("bind", ((8, 1 << 17), "split", (8, 1)), (96 << 17) + 32, 272 << 17),
    ("evals", ((8, 1 << 18), 3, "split"), 160 << 18, 0),
    ("reduce", ((8, 20, 1 << 18), None), 96 * 20 << 18, 32 * 20 << 18),
    ("reduce", ((8, _MB), (8, 1)), 96 * _MB + 32, (272 + 32) * _MB),
])
def test_k1_bound_counts_what_the_function_needs(form, key, n_bytes, mads):
    """Each input byte read once, each output byte written once, and the
    multiply-adds the function needs: the reduce form's folds are 32 a
    column, plus a product only with a scale."""
    ms, by = workload.k1_bound_ms(form, key)
    t_bytes = n_bytes / workload.HBM_BYTES_PER_S * 1e3
    t_ops = mads / workload.INT32_MAD_PER_S * 1e3
    assert ms == pytest.approx(max(t_bytes, t_ops), rel=1e-12)
    assert by == ("bytes" if t_bytes >= t_ops else "operations")


def test_stage_timer_lines_give_each_stages_launches(monkeypatch):
    """The prover's stage timer prints each stage's K1 launches per form,
    K2 calls and K3 launches per form, and `workload.timed_stages` reads
    them back per stage (launches stood in for by bumping the counts
    between the marks)."""
    from jolt_tpu_torch.prover.prover import _StageTimer

    def bump(form, n):
        fn = kernels.product_round if form == "k2" else kernels._K1[form]
        monkeypatch.setattr(fn, "launches", fn.launches + n)

    def bump_k3(form, n):
        monkeypatch.setitem(kernels.k3_counts, form,
                            kernels.k3_counts[form] + n)

    def run():
        timer = _StageTimer(torch.device("cpu"))
        bump("mul", 3)
        bump("k2", 2)
        timer.mark("stage-a")
        bump("reduce", 5)
        bump_k3("add", 7)
        timer.mark("stage-b")
        return "done"

    out, stages, text, launches = workload.timed_stages(run)
    assert out == "done" and sorted(stages) == ["stage-a", "stage-b"]
    assert text.count("[prove] ") == 2
    zero = dict.fromkeys(kernels.FORMS, 0)
    zero3 = dict.fromkeys(kernels.K3_FORMS, 0)
    assert launches == {"stage-a": {"k1": {**zero, "mul": 3}, "k2": 2,
                                    "k3": zero3},
                        "stage-b": {"k1": {**zero, "reduce": 5}, "k2": 0,
                                    "k3": {**zero3, "add": 7}}}


# ---- the Fr ops on K1 (from_i64, eq_mask, is_zero, pow_const, inv,
# batch_inverse) and the plain Fq ops, against the JAX package ----------

from jolt_tpu.field.params import FQ  # noqa: E402

from jolt_tpu_torch.field import fq as tfq  # noqa: E402

Q = FQ.modulus


@pytest.mark.parametrize("n", [1, 64])
def test_from_i64_matches_jax(n):
    rng = np.random.default_rng(30)
    lo = rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    if n > 4:   # -1, -2^63, 2^63 - 1 and 0
        lo[:4] = [0xFFFFFFFF, 0, 0xFFFFFFFF, 0]
        hi[:4] = [0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0]
    want = jops.unpack_ints(jops.from_i64(jnp.asarray(lo), jnp.asarray(hi)))
    got = tops.unpack_ints(tops.from_i64(torch.from_numpy(lo.view(np.int32)),
                                         torch.from_numpy(hi.view(np.int32))))
    assert got == want
    if n > 4:
        assert got[:4] == [P - 1, P - (1 << 63), (1 << 63) - 1, 0]


def test_eq_mask_and_is_zero_match_jax():
    xs = _vals(16, 31)
    ys = [x if i % 3 else (x + 1) % P for i, x in enumerate(xs)]
    xs[5] = ys[5] = 0
    (jx, tx), (jy, ty) = _both(xs), _both(ys)
    assert (tops.eq_mask(tx, ty).tolist()
            == np.asarray(jops.eq_mask(jx, jy)).tolist())
    assert (tops.is_zero(tx).tolist()
            == np.asarray(jops.is_zero(jx)).tolist())
    assert tops.is_zero(tx).tolist() == [x == 0 for x in xs]


@pytest.mark.parametrize("e", [0, 1, 5, (1 << 64) + 3])
def test_pow_const_matches_jax(e):
    ja, ta = _both(_vals(8, 32))
    assert (tops.unpack_ints(tops.pow_const(ta, e))
            == jops.unpack_ints(jops.pow_const(ja, e)))


def test_inv_matches_jax():
    xs = _vals(8, 33)
    ja, ta = _both(xs)
    got = tops.unpack_ints(tops.inv(ta))
    assert got == jops.unpack_ints(jops.inv(ja))
    assert got == [pow(x, -1, P) if x else 0 for x in xs]


@pytest.mark.parametrize("shape", [(7,), (3, 6)])
def test_batch_inverse_matches_jax(shape):
    n = int(np.prod(shape))
    xs = _vals(n, 34)
    xs[2] = 0
    ja, ta = _both(xs)
    ja, ta = ja.reshape((-1,) + shape), ta.reshape((8,) + shape)
    got = tops.unpack_ints(tops.batch_inverse(ta).reshape(8, n))
    assert got == jops.unpack_ints(jops.batch_inverse(ja).reshape(-1, n))
    assert got == [pow(x, -1, P) if x else 0 for x in xs]


def _fq_vals(n, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    out = [int.from_bytes(row.astype("<u4").tobytes(), "little") % Q
           for row in words]
    out[:3] = [Q - 1, 0, 1]
    return out


@pytest.mark.parametrize("op", ["mont_mul", "add", "sub"])
def test_fq_plain_ops_match_jax(op):
    """field/fq.py's plain Montgomery product, sum and difference against
    jolt_tpu.field.ops.*(..., fp=FQ), as canonical ints; is_zero and select
    on the results."""
    xs, ys = _fq_vals(64, 35), _fq_vals(64, 36)[::-1]
    ja, jb = jops.pack_ints(xs, FQ), jops.pack_ints(ys, FQ)
    ta, tb = tfq.pack_ints(xs, CPU), tfq.pack_ints(ys, CPU)
    got = getattr(tfq, f"{op}_plain")(ta, tb)
    want = jops.unpack_ints(getattr(jops, op)(ja, jb, FQ), FQ)
    assert tfq.unpack_ints(got) == want
    zero = tfq.is_zero(got)
    assert zero.tolist() == [w == 0 for w in want]
    assert tfq.unpack_ints(tfq.select(zero, tb, got)) == [
        y if w == 0 else w for w, y in zip(want, ys)]


def test_fq_kernel_source_constants_match_the_field():
    """The Fq words that K3 compiles in (`csrc/fq.cuh`) are q, R mod q,
    R^2 mod q and -q^-1 mod 2^32, as `field/fq.py` has them."""
    import pathlib
    import re
    src = (pathlib.Path(kernels.__file__).resolve().parents[1] / "csrc"
           / "fq.cuh").read_text()

    def words(name):
        body = re.search(rf"#define {name}\s*\\\s*\{{([^}}]*)\}}", src).group(1)
        return sum(int(w, 16) << (32 * i)
                   for i, w in enumerate(re.findall(r"0x([0-9a-f]+)u", body)))
    assert words("FQ_Q_WORDS") == Q == tfq.Q
    assert words("FQ_R_WORDS") == tfq.R_MOD_Q
    assert words("FQ_R2_WORDS") == tfq.R2_MOD_Q
    n0 = int(re.search(r"kN0 = 0x([0-9a-f]+)u", src).group(1), 16)
    assert n0 == tfq.N0 and n0 * Q % (1 << 32) == (1 << 32) - 1
