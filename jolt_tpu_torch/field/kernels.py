"""The port's hand-written Hopper kernels for Fr, and their plain versions.

  * K1 (``csrc/mont_mul.cu``) replaces the JAX package's Pallas kernel
    ``field/pallas_ops.py:mont_mul``.  It is the port's elementwise Fr
    kernel, in six forms (`FORMS`), one wrapper each:
      `mont_mul`  the Montgomery product;
      `add`, `sub`  (a +- b) mod p;
      `bind`      lo + r (hi - lo), HighToLow halves or LowToHigh pairs;
      `evals`     a pair's values at X = 0, 2, .., d (sumcheck eval points);
      `reduce`    exact int64 limb-plane sums -> Fr, times an optional scale.
    An int operand is a canonical field element and reaches the kernel by
    value in its parameters (a challenge, a constant): no upload.
  * K2 `product_round` (``csrc/product_round.cu``) replaces
    ``field/pallas_ops.py:product_round_deg3``: one HighToLow round of a
    product sumcheck of 2 or 3 factors (message evals and the bound factors
    in one pass, in one of four orders, the message finished mod p on the
    card); `product_round_deg3` is its "message_bind" order at 3 factors.
  * K3 (``csrc/g1.cu`` on ``csrc/fq.cuh``) is the port's BN254 G1 kernel
    (add, double, scalar multiplication, normalization, Pippenger's bucket
    sums and bucket reduction over Fq); it replaces no Pallas kernel but
    the JAX package's jnp G1.  Its wrappers and plain versions
    live in `curve/g1.py`; it builds here, with K1 and K2, and its launch
    counts per form are `k3_counts` (`k3_launches()`).
  * K4 (``csrc/transcript.cu``) is one batched sumcheck round's tail on
    the card: the instances' coefficients from their message evals, their
    random linear combination, the round's Blake2b transcript steps and
    challenge, and the claims at it.  It replaces no Pallas kernel but the
    JAX package's jnp device transcript.  Its wrapper and plain version
    live in `transcript/device.py` (`round_tail`, `round_tail_plain`); it
    builds and launches here (`launch_round_tail`, `k4_launches()`).

On CPU tensors each wrapper calls its plain version (`mont_mul_plain`,
`add_plain`, `sub_plain`, `bind_plain`, `evals_plain`, `reduce_plain`,
`product_round_plain`); on CUDA tensors it launches its kernel or raises.
DTensors (the cycle mesh, `parallel/mesh.py`) reach a wrapper through one
rule (`_on_mesh`): K1's forms run on each rank's local shard, K2 on each
rank's own pairs; a DTensor that reaches a launch raises.
Each wrapper counts its launches in ``.launches`` (`k1_launches()` gives
K1's per form); with `record` set to a list, every K1 launch also appends
(form, key), key the operands' shapes (`_key`).

The kernels build at first use from the sources in this package, one
``nvcc -gencode arch=compute_90a,code=sm_90a`` per source, all started
together, into ``_build/`` (listed in ``.gitignore``), and bind through
ctypes, so nothing is compiled when this module is imported.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
import os
import shutil
import subprocess
import sys
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from .params import FR_MODULUS

N_LIMBS = 8
MASK32 = (1 << 32) - 1
P = FR_MODULUS
R = 1 << 256
R_MOD_P = R % P
R2_MOD_P = R * R % P

_I32 = torch.int32


# ---------------------------------------------------------------------------
# limb words
# ---------------------------------------------------------------------------

def _limbs_of(x: int) -> List[int]:
    """int (< 2^256) -> 8 little-endian 32-bit words as signed int32 values."""
    out = []
    for i in range(N_LIMBS):
        w = (x >> (32 * i)) & MASK32
        out.append(w - (1 << 32) if w >= 1 << 31 else w)
    return out


@functools.lru_cache(maxsize=4096)
def _limbs_on(x: int, device: torch.device) -> torch.Tensor:
    """The 8 limbs of x as an int32 tensor on `device`, uploaded once per
    (value, device).  Callers never write into the result (every op
    returns a new tensor)."""
    return torch.tensor(_limbs_of(x), dtype=_I32, device=device)


@functools.lru_cache(maxsize=4096)
def _mont_words(x: int) -> "ctypes.Array":
    """A canonical field element's Montgomery words, for a kernel's
    parameters."""
    mont = x % P * R % P
    return (ctypes.c_uint32 * N_LIMBS)(
        *[(mont >> (32 * i)) & MASK32 for i in range(N_LIMBS)])


def _scalar(x: int, device, nbatch: int) -> torch.Tensor:
    """A canonical int as Montgomery limbs (8, 1, .., 1) with `nbatch`
    batch axes on `device`: the plain versions' form of a by-value
    scalar."""
    return _limbs_on(x % P * R % P, torch.device(device)).reshape(
        (N_LIMBS,) + (1,) * nbatch)


def _pack_limbs(w: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int32 bit patterns."""
    return (w - ((w >> 31) << 32)).to(torch.int32)


def u64_words(a: torch.Tensor) -> torch.Tensor:
    """int32 limbs -> int64 holding the unsigned 32-bit value."""
    return a.to(torch.int64) & MASK32


@functools.lru_cache(maxsize=64)
def _limb_index(n: int, nbatch: int, device: torch.device) -> torch.Tensor:
    return torch.arange(n, device=device).reshape((n,) + (1,) * nbatch)


def _ripple(r: torch.Tensor, gen: torch.Tensor, stop: torch.Tensor):
    """Carries (or borrows) of a word chain without a loop over the words:
    word i sends one out when it generates one (`gen`, 0/1) or passes on
    the one it takes in; `stop` marks the words whose carry out does not
    depend on their carry in.  Each word's carry out is the `gen` of the
    last stopping word at or below it (0 when there is none).  Returns
    (the carry into each word, the carry out of the top)."""
    idx = _limb_index(r.shape[0], r.dim() - 1, r.device)
    last = torch.cummax(torch.where(stop, idx, -1), dim=0).values
    out = torch.where(last >= 0, gen.gather(0, last.clamp(min=0)), 0)
    return torch.cat([torch.zeros_like(out[:1]), out[:-1]]), out[-1]


def _carry(s: torch.Tensor) -> torch.Tensor:
    """Propagate the carries of int64 limb sums (each in [0, 2^33), the
    value < 2^256) into 32-bit words; returns int64 (8, ...)."""
    r, g = s & MASK32, s >> 32
    into, _ = _ripple(r, g, (g != 0) | (r != MASK32))
    return (r + into) & MASK32


def _sub_words(w: torch.Tensor, v: torch.Tensor):
    """w - v mod 2^256 for int64 words in [0, 2^32): (words, borrow out of
    the top, 0/1)."""
    d = w - v
    r, g = d & MASK32, (d >> 63) & 1
    into, out = _ripple(r, g, (g != 0) | (r != 0))
    return (r - into) & MASK32, out


def _sub_p_select(w: torch.Tensor, p: int = P) -> torch.Tensor:
    """w (int64 words, value < 2p) -> w - p if w >= p else w."""
    pw = _p_words(w.device, p).reshape((N_LIMBS,) + (1,) * (w.dim() - 1))
    d, borrow = _sub_words(w, pw)
    return torch.where(borrow.bool()[None], w, d)


@functools.lru_cache(maxsize=16)
def _p_words(device: torch.device, p: int = P) -> torch.Tensor:
    """The modulus' 8 words as int64 on `device` (the addend of
    `sub_plain`)."""
    return torch.tensor(_words_of(p), dtype=torch.int64, device=device)


@functools.lru_cache(maxsize=4)
def _words_of(p: int) -> Tuple[int, ...]:
    """A modulus' 8 little-endian 32-bit words."""
    return tuple((p >> (32 * i)) & MASK32 for i in range(N_LIMBS))


_ONE_SHOT_SCHOOLBOOK = 1 << 14       # elements (a 32 MiB product tensor)


@functools.lru_cache(maxsize=16)
def _diagonals(device: torch.device) -> torch.Tensor:
    """i + j for the 16 x 16 sub-limb products, row-major."""
    i = torch.arange(16, device=device)
    return (i[:, None] + i[None, :]).reshape(-1)


@functools.lru_cache(maxsize=16)
def _p16(p: int, device: torch.device) -> torch.Tensor:
    return torch.tensor(_mont16(p)[1], dtype=torch.int64, device=device)


@functools.lru_cache(maxsize=4)
def _mont16(p: int) -> Tuple[int, List[int]]:
    """-p^-1 mod 2^16 and p's 16 sub-limbs of 16 bits (`mont_mul_plain`)."""
    return ((-pow(p, -1, 1 << 16)) % (1 << 16),
            [(p >> (16 * i)) & 0xFFFF for i in range(16)])


# ---------------------------------------------------------------------------
# K1's plain versions
# ---------------------------------------------------------------------------

def _split16(a: torch.Tensor) -> torch.Tensor:
    """(8, *batch) int32 words -> (16, *batch) int64 16-bit sub-limbs."""
    u = a.to(torch.int64) & MASK32
    return torch.stack([u & 0xFFFF, u >> 16], dim=1).reshape(
        (16,) + tuple(a.shape[1:]))


def mont_mul_plain(a: torch.Tensor, b: torch.Tensor,
                   p: int = P) -> torch.Tensor:
    """a * b * 2^-256 mod p on (8, *batch) int32 words, in plain torch,
    for the odd modulus p < 2^255 (Fr by default; `field/fq.py` passes Fq).

    Takes a < 2^256 and b < p (so a*b + m*p < 2^257 p, the result before the
    conditional subtract is < 2p).  Works in base 2^16 on int64: schoolbook
    columns < 16 (2^16-1)^2 < 2^36, reduction terms and carries keep every
    column < 2^38.  The result is the unique value < p, so it equals K1's
    32-bit CIOS bit for bit (and K3's Fq products for p = q)."""
    n0_16 = _mont16(p)[0]
    a, b = torch.broadcast_tensors(a, b)
    A, B = _split16(a), _split16(b)
    batch = tuple(A.shape[1:])
    # schoolbook: the 16 x 16 sub-limb products summed on anti-diagonals,
    # all at once for a small batch (256 int64 words an element), else row
    # by row
    cols = torch.zeros((32,) + batch, dtype=torch.int64, device=a.device)
    if math.prod(batch) <= _ONE_SHOT_SCHOOLBOOK:
        cols.index_add_(0, _diagonals(a.device),
                        (A[:, None] * B[None]).reshape((256,) + batch))
    else:
        for i in range(16):
            cols[i:i + 16] += A[i] * B
    p16 = _p16(p, a.device).reshape((16,) + (1,) * len(batch))
    for i in range(16):
        m = (cols[i] * n0_16) & 0xFFFF
        cols[i:i + 16] += m * p16
        cols[i + 1] += cols[i] >> 16
    # the value is sum cols[16 + i] 2^(16 i) < 2p < 2^255 with every column
    # >= 0: as 32-bit words (< 2^55), two carry-save passes leave carries
    # of 0 or 1 (the top word's carry is 0), then one ripple
    hi = cols[16:]
    w = hi[0::2] + (hi[1::2] << 16)
    for _ in range(2):
        w = (w & MASK32) + torch.cat([torch.zeros_like(w[:1]),
                                      (w >> 32)[:-1]])
    return _pack_limbs(_sub_p_select(_carry(w), p))


def add_plain(a: torch.Tensor, b: torch.Tensor, p: int = P) -> torch.Tensor:
    """(a + b) mod p: limbwise int64 sums, carries, one conditional
    subtract."""
    a, b = torch.broadcast_tensors(a, b)
    return _pack_limbs(_sub_p_select(_carry(u64_words(a) + u64_words(b)),
                                     p))


def sub_plain(a: torch.Tensor, b: torch.Tensor, p: int = P) -> torch.Tensor:
    """(a - b) mod p: a - b, plus p where that borrows."""
    a, b = torch.broadcast_tensors(a, b)
    d, borrow = _sub_words(u64_words(a), u64_words(b))
    pw = _p_words(a.device, p).reshape((N_LIMBS,) + (1,) * (a.dim() - 1))
    # a < b: d = a - b + 2^256, and d + p drops the 2^256
    return _pack_limbs(_carry(d + pw * borrow[None]))


def bind_plain(lo: torch.Tensor, hi: torch.Tensor,
               r: torch.Tensor) -> torch.Tensor:
    """lo + r (hi - lo) mod p (r Montgomery limbs that broadcast)."""
    return add_plain(lo, mont_mul_plain(sub_plain(hi, lo), r))


def evals_plain(lo: torch.Tensor, hi: torch.Tensor,
                degree: int) -> torch.Tensor:
    """The values lo + X (hi - lo) at X = 0, 2, 3, .., degree, stacked on
    axis 1: (8, degree, *batch), by repeated addition of the slope."""
    outs = [lo]
    if degree >= 2:
        m = sub_plain(hi, lo)
        cur = add_plain(hi, m)             # X = 2
        outs.append(cur)
        for _ in range(3, degree + 1):
            cur = add_plain(cur, m)
            outs.append(cur)
    return torch.stack(outs, dim=1)


def reduce_plain(cols: torch.Tensor,
                 scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact int64 limb sums S = sum_i cols[i] 2^(32 i) (each plane a sum of
    < 2^31 words) -> S mod p in Montgomery form, times `scale` if given.

    S = lo + h * 2^256 with lo < 2^256 and h < 2^32; since every summand is
    Montgomery-form, S mod p = mont_mul(lo, R) + mont_mul(h, R^2)
    (mont_mul by the Montgomery 1 reduces any lo < 2^256 below p)."""
    out = torch.empty_like(cols)
    c = torch.zeros_like(cols[0])
    for i in range(N_LIMBS):
        v = cols[i] + c
        out[i] = v & MASK32
        c = v >> 32
    h = torch.zeros_like(out)
    h[0] = c
    nd = cols.dim() - 1
    # the Montgomery forms of 1 and of R mod p are R and R^2 mod p
    lo = mont_mul_plain(_pack_limbs(out), _scalar(1, cols.device, nd))
    hi = mont_mul_plain(_pack_limbs(h), _scalar(R_MOD_P, cols.device, nd))
    res = add_plain(lo, hi)
    return res if scale is None else mont_mul_plain(res, scale)


# ---------------------------------------------------------------------------
# build and bind
# ---------------------------------------------------------------------------

_PKG_DIR = os.path.join(os.path.dirname(__file__), "..")
_CSRC = os.path.join(_PKG_DIR, "csrc")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_HEADERS = [os.path.join(_CSRC, h) for h in ("fr.cuh", "fq.cuh")]
# kernel -> (source, shared library, {C function: (restype, argtypes)})
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_KERNELS = {
    "K1": ("mont_mul.cu", "libjolt_mont_mul.so", {
        "jolt_k1_launch_size": (ctypes.c_int, []),
        "jolt_k1_force_columns": (None, [ctypes.c_int]),
        "jolt_k1": (ctypes.c_int, [_P, _P])}),
    "K2": ("product_round.cu", "libjolt_product_round.so", {
        "jolt_product_round_blocks": (ctypes.c_int, [ctypes.c_int, _I64]),
        "jolt_product_round": (ctypes.c_int, [ctypes.c_int] * 2
                               + [_I64] + [_P] * 11)}),
    "K3": ("g1.cu", "libjolt_g1.so", {
        "jolt_k3_launch_size": (ctypes.c_int, []),
        "jolt_k3_bucket_sizes": (ctypes.c_int, []),
        "jolt_k3": (ctypes.c_int, [_P, _P]),
        "jolt_k3_bucket_sum": (ctypes.c_int, [_P, ctypes.c_int, _P]),
        "jolt_k3_bucket_reduce": (ctypes.c_int, [_P, _P])}),
    "K4": ("transcript.cu", "libjolt_transcript.so", {
        "jolt_k4_launch_size": (ctypes.c_int, []),
        "jolt_k4": (ctypes.c_int, [_P, _P])}),
}
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's kernels cannot be "
                           "built")
    return path


def _paths(name: str) -> Tuple[str, str]:
    src, so, _ = _KERNELS[name]
    return os.path.join(_CSRC, src), os.path.join(_BUILD_DIR, so)


def build(names=tuple(_KERNELS)) -> Dict[str, str]:
    """Compile the named kernels for sm_90a into ``_build/``, one nvcc per
    source, all running at once; returns each kernel's ptxas report
    (registers, spills).  Raises if any nvcc fails."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        src, so = _paths(name)
        tmp = f"{so}.{os.getpid()}.tmp"
        procs[name] = (tmp, so, subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
             "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    reports, failed = {}, []
    for name, (tmp, so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{err}")
            continue
        os.replace(tmp, so)
        _libs.pop(name, None)
        reports[name] = err
    if failed:
        raise RuntimeError("nvcc failed to build " + "\n".join(failed))
    return reports


def _load(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is not None:
        return lib
    src, so = _paths(name)
    newest = max(os.path.getmtime(p) for p in [src] + _HEADERS)
    if not os.path.exists(so) or os.path.getmtime(so) < newest:
        build((name,))
    lib = ctypes.CDLL(so)
    for fn, (restype, argtypes) in _KERNELS[name][2].items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    if name == "K1" and lib.jolt_k1_launch_size() != ctypes.sizeof(_Launch):
        raise RuntimeError("K1: the launch record's layout differs between "
                           "csrc/mont_mul.cu and kernels.py")
    if name == "K4" and lib.jolt_k4_launch_size() != ctypes.sizeof(
            RoundTail):
        raise RuntimeError("K4: the launch record's layout differs between "
                           "csrc/transcript.cu and kernels.py")
    _libs[name] = lib
    return lib


# ---------------------------------------------------------------------------
# the cycle mesh: one rule for DTensor operands (`parallel/mesh.py`)
# ---------------------------------------------------------------------------

def is_dtensor(x) -> bool:
    """Whether x is a DTensor.  Until `torch.distributed.tensor` is
    imported (a cycle mesh imports it) there is none, so the one-device
    path never pays for that import (~1.3 s)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def _placed(x, mesh):
    """A tensor operand as a DTensor on `mesh` with no `Partial` left: a
    plain tensor is `Replicate` (every rank holds it whole), a `Partial`
    one (exact int64 limb-plane sums over a sharded axis) is all-reduced."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not isinstance(x, DTensor):
        return DTensor.from_local(x, mesh, [Replicate()], run_check=False)
    if any(isinstance(p, Partial) for p in x.placements):
        return x.redistribute(mesh, [Replicate()])
    return x


def _gathered(x):
    """A DTensor whole on this rank, as a plain tensor (`full_tensor`, its
    all-gather waited for)."""
    x = x.full_tensor()
    return x.wait() if hasattr(x, "wait") else x


def pair_halves(a, axis: int = -1, low: bool = False):
    """The two tensors a sumcheck pass pairs up along `axis`: the halves
    (a[:h], a[h:]) of a HighToLow pass, or with `low` the interleaved
    (a[0::2], a[1::2]) of a LowToHigh one; a bind or the evals of them
    take them as they are.

    Under a cycle mesh the pairs keep the cycle shard.  Interleaved pairs
    of a tensor `Shard`-ed in blocks of even length lie on their rank,
    which slices its own block; HighToLow pairs (i, i + h) lie on two
    ranks, so the tensor is gathered (one all-gather, where GSPMD inserts
    a collective too) and each rank keeps its own block of both halves.
    A `Replicate` tensor whose `axis` is the last keeps its blocks the
    same way, with no collective (`maybe_shard`'s rule).  Where h is not a
    multiple of D, or is 1, the halves are whole on every rank
    (`Replicate`)."""
    axis %= a.dim()

    def halves(x):
        if low:
            pre = (slice(None),) * axis
            return x[pre + (slice(0, None, 2),)], x[pre + (slice(1, None, 2),)]
        h = x.shape[axis] // 2
        return x.narrow(axis, 0, h), x.narrow(axis, h, h)
    if not is_dtensor(a):
        return halves(a)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh, p = a.device_mesh, a.placements[0]
    sharded = isinstance(p, Shard) and p.dim == axis
    if not sharded and not (isinstance(p, Replicate) and axis == a.dim() - 1):
        return halves(a)          # `axis` is not split: DTensor's own slices
    D, d = mesh.size(), mesh.get_local_rank()
    h = a.shape[axis] // 2

    def placed(parts, pl):
        return tuple(DTensor.from_local(x, mesh, [pl], run_check=False)
                     for x in parts)
    if h % D or h == 1:
        return placed(halves(_gathered(a) if sharded else a.to_local()),
                      Replicate())
    b = h // D
    if low:                       # the rank's block of a holds its pairs
        local = a.to_local() if sharded else a.to_local().narrow(
            axis, 2 * b * d, 2 * b)
        return placed(halves(local), Shard(axis))
    whole = _gathered(a) if sharded else a.to_local()
    return placed((whole.narrow(axis, b * d, b),
                   whole.narrow(axis, h + b * d, b)), Shard(axis))


def _shard_axis(xs, shape, D: int) -> Optional[int]:
    """The batch axis, counted from the right, that an elementwise form
    keeps sharded: the `Shard` axis of the largest operand whose axis is
    not broadcast in the output and splits evenly (the other operands
    move, and they are the smaller); None when there is none."""
    from torch.distributed.tensor import Shard
    for x in sorted(xs, key=lambda x: -x.numel()):
        p = x.placements[0]
        if isinstance(p, Shard) and p.dim > 0:
            k = p.dim - x.dim()
            if -k < len(shape) and x.shape[k] == shape[k] \
                    and shape[k] % D == 0:
                return k
    return None


def _on_mesh(kind: str):
    """One rule for DTensor operands, on every wrapper (K1's forms, K2):

      * kind "local" (K1's forms, elementwise over the broadcast batch):
        every rank runs the wrapper on its own shard and the output takes
        the operands' placement.  The shard axis is `_shard_axis`'s; an
        operand sharded elsewhere is redistributed to it, one broadcast
        along it stays `Replicate`;
      * kind "pairs" (K2, a HighToLow round of (8, T) factors, whose
        pairs (i, i + T/2) lie on two ranks of a block-sharded axis):
        each rank runs the wrapper on its own pairs, its blocks of the
        factors' halves (`pair_halves`: one all-gather a factor) side by
        side, so the bound factors stay `Shard`-ed; its message, the sum
        over its pairs, is one term of a sum over ranks, added exactly as
        int64 limb planes (`Partial`, all-reduced by K1's reduce form).
        "bind_message" pairs the bound factors anew, so on more than one
        rank it is a "bind" and a "message" (`_pairs`).

    `Partial` operands are all-reduced first and plain tensors count as
    `Replicate` (`_placed`).  The wrapper then runs on the local tensors
    and its outputs are wrapped back, as `local_map` does (written out
    here for K2's nested arguments and outputs), so the kernel on the card
    and the plain version on the CPU see the same shards.  Without a
    DTensor operand it is the wrapper itself."""
    def wrap(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            # the main path's launches take plain tensors: one cheap look
            # at the arguments (and K2's tuple of factors) before any work
            mod = sys.modules.get("torch.distributed.tensor")
            if mod is None or not any(
                    isinstance(x, mod.DTensor) or isinstance(x, tuple)
                    and any(isinstance(y, mod.DTensor) for y in x)
                    for x in (*args, *kwargs.values())):
                return fn(*args, **kwargs)
            DTensor, Replicate, Shard = mod.DTensor, mod.Replicate, mod.Shard
            flat, spec = pytree.tree_flatten((args, kwargs))
            mesh = next(x for x in flat if isinstance(x, DTensor)).device_mesh
            flat = [_placed(x, mesh) if isinstance(x, torch.Tensor) else x
                    for x in flat]
            if kind == "pairs":
                a, k = pytree.tree_unflatten(flat, spec)
                return _pairs(fn, mesh, *a, **k)
            tensors = [x for x in flat if isinstance(x, DTensor)]
            rep = (Replicate(),)
            axis = None
            if kind == "local":
                shape = torch.broadcast_shapes(*(x.shape for x in tensors))
                axis = _shard_axis(tensors, shape, mesh.size())
            local = []
            for x in flat:
                if isinstance(x, DTensor):
                    want = rep if axis is None or x.dim() < -axis \
                        or x.shape[axis] == 1 else (Shard(x.dim() + axis),)
                    x = x.redistribute(mesh, want).to_local()
                    if hasattr(x, "wait"):     # an async collective's result
                        x = x.wait()
                local.append(x)
            a, k = pytree.tree_unflatten(local, spec)
            out = fn(*a, **k)

            def place(t):
                pl = rep if axis is None else (Shard(t.dim() + axis),)
                return DTensor.from_local(t, mesh, pl, run_check=False)
            return pytree.tree_map_only(torch.Tensor, place, out)
        return wrapper
    return wrap


def _pairs(fn, mesh, polys, r=None, order: str = "message_bind"):
    """K2's rule on a mesh (`_on_mesh`, kind "pairs"): `polys` are
    DTensors, r an int or a `Replicate` one."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    r = r.to_local() if isinstance(r, DTensor) else r

    def placed(t, pl):
        return None if t is None else DTensor.from_local(
            t, mesh, [pl], run_check=False)
    if mesh.size() == 1:                    # one rank holds every pair
        msg, bound = fn(tuple(_gathered(p) for p in polys), r, order)
        return placed(msg, Replicate()), None if bound is None else tuple(
            placed(b, Shard(b.dim() - 1) if b.shape[-1] > 1 else Replicate())
            for b in bound)
    if order == "bind_message":
        _, bound = product_round(polys, r, "bind")
        return product_round(bound, None, "message")[0], bound
    halves = [pair_halves(p) for p in polys]
    if not isinstance(halves[0][0].placements[0], Shard):   # T/2 % D
        msg, bound = fn(tuple(_gathered(p) for p in polys), r, order)
        return placed(msg, Replicate()), None if bound is None else tuple(
            placed(b, Replicate()) for b in bound)
    msg, bound = fn(tuple(torch.cat((lo.to_local(), hi.to_local()), -1)
                          for lo, hi in halves), r, order)
    if msg is not None:
        msg = reduce(placed(u64_words(msg), Partial()))
    return msg, None if bound is None else tuple(
        placed(b, Shard(b.dim() - 1)) for b in bound)


def _no_dtensor(form: str, *xs) -> None:
    """A launch takes plain tensors: a DTensor here bypassed `_on_mesh`."""
    if any(is_dtensor(x) for x in xs):
        raise TypeError(f"{form}: a DTensor reached the kernel launch "
                        "(DTensors go through the wrappers' mesh rule)")


# ---------------------------------------------------------------------------
# K1: the elementwise Fr kernel
# ---------------------------------------------------------------------------

# K1's forms, in the order of `Op` in csrc/mont_mul.cu
FORMS = ("mul", "add", "sub", "bind", "evals", "reduce")
_OP = {form: i for i, form in enumerate(FORMS)}
# operand kinds, `Kind` in csrc/mont_mul.cu
_NONE, _SCALAR, _ROW, _VEC, _STRIDED = range(5)
_LIMIT = 1 << 31            # K1's offsets are 32-bit

# None, or a list to which every K1 launch appends (form, key) (`_key`)
record: Optional[list] = None


def force_k1_columns(v: int) -> None:
    """Make every later K1 launch take `v` columns a thread (1 or 2; the
    reduce form always takes 1), or with 0 let each launch's size choose, as
    on the main path: for timing the choice against the other."""
    if v not in (0, 1, 2):
        raise ValueError(f"force_k1_columns: {v} (want 0, 1 or 2)")
    _load("K1").jolt_k1_force_columns(v)


class _Operand(ctypes.Structure):
    _fields_ = [("p", ctypes.c_uint64), ("kind", ctypes.c_int32),
                ("sl", ctypes.c_uint32), ("s0", ctypes.c_uint32),
                ("s1", ctypes.c_uint32), ("w", ctypes.c_uint32 * N_LIMBS)]


class _Launch(ctypes.Structure):
    _fields_ = [("op", ctypes.c_int32), ("deg", ctypes.c_int32),
                ("n0", ctypes.c_uint32), ("n1", ctypes.c_uint32),
                ("out", ctypes.c_uint64), ("a", _Operand), ("b", _Operand),
                ("c", _Operand)]


def _device(form: str, *xs) -> torch.device:
    """The one device of the tensor operands (an int operand has none)."""
    devs = {x.device for x in xs if isinstance(x, torch.Tensor)}
    if len(devs) != 1 or next(iter(devs)).type not in ("cpu", "cuda"):
        raise ValueError(f"{form}: operands on {sorted(map(str, devs))}")
    return devs.pop()


def _check(form: str, *xs, dtype=torch.int32) -> None:
    for x in xs:
        if not isinstance(x, torch.Tensor):
            continue
        if x.dtype != dtype:
            raise TypeError(f"{form}: dtype {x.dtype} (want {dtype})")
        if x.dim() < 1 or x.shape[0] != N_LIMBS:
            raise ValueError(f"{form}: shape {tuple(x.shape)} (want the "
                             f"{N_LIMBS} limbs first)")


def _plain_operand(x, device, nbatch: int):
    """An operand for a plain version: an int becomes its limbs."""
    return x if isinstance(x, torch.Tensor) else _scalar(int(x), device,
                                                         nbatch)


def _key(x):
    """An operand's part of a launch record: its shape, or "int"."""
    return tuple(x.shape) if isinstance(x, torch.Tensor) else "int"


def _views(xs, shape, n0: int, n1: int):
    """Each tensor operand as (view (8, n0, n1), sl, s0, s1) -- a copy where
    its broadcast view cannot collapse -- then rows merged into one when
    every operand's rows follow on from its columns.  Ints and None stay.
    Returns (operands, n0, n1)."""
    ops = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            v = x.expand(shape).reshape(N_LIMBS, n0, n1)
            ops.append((v, *v.stride()))
        else:
            ops.append(x)
    if n0 > 1 and n1 > 1 and any(o[2] != n1 * o[3] for o in ops
                                 if isinstance(o, tuple)):
        return ops, n0, n1
    # one row: the columns' stride, or the rows' where there is one column
    return [(o[0], o[1], 0, o[3] if n1 > 1 else o[2])
            if isinstance(o, tuple) else o for o in ops], 1, n0 * n1


def _fill(slot: _Operand, o, n0: int, n1: int) -> None:
    """Describe one operand to the kernel (`Kind`)."""
    if o is None:
        slot.kind = _NONE
        return
    if not isinstance(o, tuple):
        slot.kind = _SCALAR
        slot.w = _mont_words(int(o))
        return
    v, sl, s0, s1 = o
    if sl * (N_LIMBS - 1) + s0 * (n0 - 1) + s1 * (n1 - 1) >= _LIMIT:
        raise ValueError(f"K1: operand {tuple(v.shape)} strides "
                         f"{v.stride()} span 2^31 elements")
    p = v.data_ptr()
    slot.p, slot.sl, slot.s0, slot.s1 = p, sl, s0, s1
    if s1 == 0:
        slot.kind = _ROW
    elif s1 == 1 and p % 8 == 0 and sl % 2 == 0 and s0 % 2 == 0:
        slot.kind = _VEC
    else:
        slot.kind = _STRIDED


def _describe(form: str, out: torch.Tensor, n0: int, n1: int, a, b=None,
              c=None, deg: int = 0) -> _Launch:
    """K1's launch record for `form` over (n0, n1) into `out` (`Launch` in
    csrc/mont_mul.cu)."""
    if N_LIMBS * max(deg, 1) * n0 * n1 >= _LIMIT:
        raise ValueError(f"{form}: output {tuple(out.shape)} spans 2^31 "
                         "elements")
    L = _Launch()
    L.op, L.deg, L.n0, L.n1, L.out = _OP[form], deg, n0, n1, out.data_ptr()
    _fill(L.a, a, n0, n1)
    _fill(L.b, b, n0, n1)
    _fill(L.c, c, n0, n1)
    return L


def _go(form: str, out: torch.Tensor, L: _Launch) -> None:
    """Launch K1 on out's card's current stream and count it."""
    _no_dtensor(form, out)
    lib = _load("K1")
    dev = out.device
    with torch.cuda.device(dev):          # launch on the operands' card
        rc = lib.jolt_k1(ctypes.byref(L),
                         torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{form}: K1 launch failed, CUDA error {rc}")
    _K1[form].launches += 1


def _grid(batch) -> Tuple[int, int]:
    """A batch shape as (rows, columns): the last axis is the columns."""
    return (math.prod(batch[:-1]), batch[-1]) if batch else (1, 1)


def _k1(form: str, xs, shape, out_shape, key, deg: int = 0) -> torch.Tensor:
    """K1's `form` on the operands xs = (a, b, c) (tensors, ints or None)
    over the batch of their broadcast shape `shape`, into a new tensor of
    `out_shape`; `key` is the launch's record (`record`)."""
    _no_dtensor(form, *xs)
    dev = next(x.device for x in xs if isinstance(x, torch.Tensor))
    out = torch.empty(out_shape, dtype=_I32, device=dev)
    n0, n1 = _grid(tuple(shape[1:]))
    if n0 * n1:
        ops, n0, n1 = _views(xs, shape, n0, n1)
        _go(form, out, _describe(form, out, n0, n1, *ops, deg=deg))
        if record is not None:
            record.append((form, key))
    return out


def _layout(lo: torch.Tensor, hi: torch.Tensor) -> str:
    """How lo and hi lie in memory, for the launch record: the "high" and
    "low" halves of one tensor (HighToLow and LowToHigh pairs), or
    "split"."""
    gap = hi.data_ptr() - lo.data_ptr()
    return ("low" if gap == 4 and lo.stride(-1) == 2 else "high"
            if gap == 4 * lo.shape[-1] else "split")


def _binary(form: str, plain, a, b) -> torch.Tensor:
    dev = _device(form, a, b)
    _check(form, a, b)
    if dev.type == "cpu":
        nb = max(x.dim() for x in (a, b) if isinstance(x, torch.Tensor)) - 1
        return plain(_plain_operand(a, dev, nb), _plain_operand(b, dev, nb))
    shape = torch.broadcast_shapes(*(x.shape for x in (a, b)
                                     if isinstance(x, torch.Tensor)))
    return _k1(form, (a, b, None), shape, shape, (_key(a), _key(b)))


@_on_mesh("local")
def mont_mul(a, b) -> torch.Tensor:
    """Elementwise Montgomery product a * b * 2^-256 mod p of (8, *batch)
    int32 limb tensors that broadcast together (a < 2^256, b < p), or of a
    tensor and an int (a canonical field element, by value); returns a new
    contiguous (8, *batch) tensor.

    CPU tensors take `mont_mul_plain`.  CUDA tensors launch K1's "mul" form
    on their card's current stream: broadcast operands (a per-row weight, a
    device scalar) are read in place with stride 0; an operand whose
    broadcast view cannot collapse to (rows, columns) is copied first."""
    return _binary("mul", mont_mul_plain, a, b)


@_on_mesh("local")
def add(a, b) -> torch.Tensor:
    """(a + b) mod p: K1's "add" form on the card, `add_plain` on the CPU
    (operands as `mont_mul`'s)."""
    return _binary("add", add_plain, a, b)


@_on_mesh("local")
def sub(a, b) -> torch.Tensor:
    """(a - b) mod p: K1's "sub" form on the card, `sub_plain` on the CPU
    (operands as `mont_mul`'s)."""
    return _binary("sub", sub_plain, a, b)


@_on_mesh("local")
def bind(lo: torch.Tensor, hi: torch.Tensor, r) -> torch.Tensor:
    """lo + r (hi - lo) mod p for lo, hi (8, *batch) and the challenge r (a
    canonical int, by value, or one element of Montgomery limbs): K1's
    "bind" form on the card, `bind_plain` on the CPU.  lo and hi may be
    views of one tensor P: its halves (P[..., :h], P[..., h:], a HighToLow
    bind) or its even and odd columns (P[..., 0::2], P[..., 1::2], a
    LowToHigh bind, read with stride 2)."""
    dev = _device("bind", lo, hi, r)
    _check("bind", lo, hi, r)
    if isinstance(r, torch.Tensor):
        if r.numel() != N_LIMBS:
            raise ValueError(f"bind: r of shape {tuple(r.shape)} (want one "
                             "element)")
        r = r.reshape((N_LIMBS,) + (1,) * (lo.dim() - 1))
    if dev.type == "cpu":
        return bind_plain(lo, hi, _plain_operand(r, dev, lo.dim() - 1))
    shape = torch.broadcast_shapes(lo.shape, hi.shape)
    return _k1("bind", (lo, hi, r), shape, shape,
               (_key(lo), _layout(lo, hi), _key(r)))


@_on_mesh("local")
def evals(lo: torch.Tensor, hi: torch.Tensor, degree: int) -> torch.Tensor:
    """The pairs' values lo + X (hi - lo) at X = 0, 2, 3, .., degree as
    (8, degree, *batch): K1's "evals" form on the card, `evals_plain` on
    the CPU."""
    dev = _device("evals", lo, hi)
    _check("evals", lo, hi)
    if degree < 1:
        raise ValueError(f"evals: degree {degree}")
    if dev.type == "cpu":
        return evals_plain(lo, hi, degree)
    shape = torch.broadcast_shapes(lo.shape, hi.shape)
    return _k1("evals", (lo, hi, None), shape,
               (N_LIMBS, degree) + tuple(shape[1:]),
               (_key(lo), degree, _layout(lo, hi)), deg=degree)


@_on_mesh("local")
def reduce(cols: torch.Tensor, scale=None) -> torch.Tensor:
    """Exact int64 limb-plane sums (8, *batch) -> their value mod p in
    Montgomery form (`reduce_plain`), times `scale` if given (an int, by
    value, or Montgomery limbs that broadcast over the batch): K1's
    "reduce" form on the card, `reduce_plain` on the CPU."""
    dev = _device("reduce", cols, scale)
    _check("reduce", cols, dtype=torch.int64)
    _check("reduce", scale)
    if dev.type == "cpu":
        return reduce_plain(cols, None if scale is None else _plain_operand(
            scale, dev, cols.dim() - 1))
    return _k1("reduce", (cols, None, scale), cols.shape, cols.shape,
               (_key(cols), None if scale is None else _key(scale)))


_K1 = {"mul": mont_mul, "add": add, "sub": sub, "bind": bind,
       "evals": evals, "reduce": reduce}
for _fn in _K1.values():
    _fn.launches = 0


def k1_launches() -> Dict[str, int]:
    """K1's launch counts, per form."""
    return {form: fn.launches for form, fn in _K1.items()}


# K3's forms (`Form` in csrc/g1.cu) and their launch counts, which the
# wrappers in `curve/g1.py` keep
K3_FORMS = ("add", "double", "scalar_mul", "normalize", "bucket_sum",
            "bucket_reduce")
k3_counts: Dict[str, int] = dict.fromkeys(K3_FORMS, 0)


def k3_launches() -> Dict[str, int]:
    """K3's launch counts, per form."""
    return dict(k3_counts)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for fn in (*_K1.values(), product_round, launch_round_tail):
        fn.launches = 0
    for form in K3_FORMS:
        k3_counts[form] = 0


# ---------------------------------------------------------------------------
# K2: one HighToLow round of a product sumcheck of 2 or 3 factors
# ---------------------------------------------------------------------------

# K2's pass orders (`Order` in csrc/product_round.cu)
ORDERS = ("message_bind", "message", "bind_message", "bind")


def _r_tensor(r, device) -> torch.Tensor:
    """The challenge as (8, 1) Montgomery limbs on `device`: r is a canonical
    int or already such a tensor."""
    if isinstance(r, torch.Tensor):
        return r.to(device)
    return _scalar(int(r), device, 1)


def _tensors(polys, r):
    """The factors, and r if it is a tensor."""
    return polys + ((r,) if isinstance(r, torch.Tensor) else ())


def _check_round(polys, order) -> None:
    if order not in ORDERS:
        raise ValueError(f"product_round: order {order!r} (want one of "
                         f"{ORDERS})")
    if len(polys) not in (2, 3):
        raise ValueError(f"product_round: {len(polys)} factors (K2 takes 2 "
                         "or 3)")
    T = polys[0].shape[-1]
    least = 4 if order == "bind_message" else 2
    if (any(p.dim() != 2 or p.shape != (N_LIMBS, T) for p in polys)
            or T % least or T < least):
        raise ValueError("product_round: shapes "
                         f"{[tuple(p.shape) for p in polys]} (want factors "
                         f"(8, T) with T a multiple of {least})")


def product_round_plain(polys, r, order: str):
    """K2's function in plain torch: one HighToLow round of the product
    sumcheck of `polys` (2 or 3 factors, each (8, T)) at degree NF =
    len(polys), in pass order `order` (`ORDERS`):

      * "message_bind": the message over the pairs (i, i + T/2), and each
        factor bound at r (the JAX package's `product_round_deg3` at NF = 3);
      * "message": the message alone;
      * "bind_message": each factor bound at r, then the message of the
        bound factors (a live round: bind at r_j, message round j + 1);
      * "bind": the bind alone.

    Returns (msg, bound): msg the evals at X = 0, 2, .., NF as (8, NF, 1)
    Montgomery limbs (None for "bind"), bound the NF factors (8, T/2)
    (None for "message").  r is a canonical int or (8, 1) Montgomery limbs
    (unused by "message").  It is composed of K1's plain versions; the
    message's mod-p finish is `reduce_plain`, which the kernel's finish
    equals bit for bit."""
    polys = tuple(polys)
    _check_round(polys, order)
    half = polys[0].shape[-1] // 2

    def message(ps):
        acc = None
        for p in ps:
            h = p.shape[-1] // 2
            e = evals_plain(p[:, :h], p[:, h:], len(ps))
            acc = e if acc is None else mont_mul_plain(acc, e)
        return reduce_plain(u64_words(acc).sum(dim=-1, keepdim=True))

    msg = bound = None
    if order in ("message_bind", "message"):
        msg = message(polys)
    if order != "message":
        r_t = _r_tensor(r, polys[0].device)
        bound = tuple(bind_plain(p[:, :half], p[:, half:], r_t)
                      for p in polys)
    if order == "bind_message":
        msg = message(bound)
    return msg, bound


@_on_mesh("pairs")
def product_round(polys, r=None, order: str = "message_bind"):
    """One HighToLow round of the product sumcheck of 2 or 3 factors: see
    `product_round_plain` for the orders and the result (msg, bound).

    CPU tensors take `product_round_plain`.  CUDA tensors launch K2
    (`launch_product_round`): the pass kernel and, for a message, the
    finish kernel that sums its blocks and reduces mod p on the card -- at
    most two launches and no torch op on the limbs."""
    polys = tuple(polys)
    if all(t.device.type == "cpu" for t in _tensors(polys, r)):
        return product_round_plain(polys, r, order)
    return launch_product_round(polys, r, order)



def product_round_deg3(p0: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                       r: torch.Tensor):
    """One HighToLow round of the product sumcheck of p0 p1 p2 (each (8, T),
    T even) at the challenge r (8, 1): returns (msg, b0, b1, b2) with msg the
    (8, 3, 1) Montgomery evals at X = 0, 2, 3 and b0..b2 the bound factors
    (8, T/2) -- the JAX kernel followed by its `reduce_lazy_cols`.  K2's
    "message_bind" order (`product_round`)."""
    msg, bound = product_round((p0, p1, p2), r, "message_bind")
    return (msg, *bound)


def launch_product_round(polys, r, order: str, finish: bool = True):
    """Launch K2 on the factors' card's current stream; returns (msg,
    bound) as `product_round` does.  A tensor r (one element of Montgomery
    limbs on the factors' card) is passed by pointer and read by the
    kernel; an int r by value.  With finish=False the finish kernel is
    not launched and msg is the pass kernel's block sums instead: (8 NF,
    blocks) int64, column k * 8 + l the exact sum of limb l at the k-th eval
    point (for timing the pass alone).  Counts one launch on
    `product_round.launches`."""
    polys = tuple(polys)
    _no_dtensor("product_round", *_tensors(polys, r))
    _check_round(polys, order)
    dev = polys[0].device
    if dev.type != "cuda" or any(t.device != dev
                                 for t in _tensors(polys, r)):
        raise ValueError("product_round: operands on "
                         f"{[str(t.device) for t in _tensors(polys, r)]}")
    if any(p.dtype != torch.int32 for p in polys):
        raise TypeError("product_round: dtypes "
                        f"{[p.dtype for p in polys]} (want int32)")
    T = polys[0].shape[-1]
    if T // 2 >= 1 << 31:
        raise ValueError(f"product_round: {T // 2} pairs exceed 2^31")
    nf = len(polys)
    code = ORDERS.index(order)
    polys = tuple(p.contiguous() for p in polys)
    ptrs = [p.data_ptr() for p in polys] + [None] * (3 - nf)
    # the challenge: a device scalar is read by the kernel where it lies (no
    # copy back, no wait for the card), an int reaches it by value
    words = r_dev = None
    if order != "message" and isinstance(r, torch.Tensor):
        if r.dtype != torch.int32 or r.numel() != N_LIMBS:
            raise ValueError(f"product_round: r {tuple(r.shape)} {r.dtype} "
                             "(want one element of int32 limbs)")
        r = r.contiguous()
        r_dev = r.data_ptr()
    elif order != "message":
        words = _mont_words(int(r))
    lib = _load("K2")
    msg = partial = bound = None
    with torch.cuda.device(dev):          # launch on the operands' card
        blocks = lib.jolt_product_round_blocks(code, T)
        if blocks < 0:
            raise RuntimeError(f"product_round: CUDA error {-blocks}")
        if order != "bind":
            partial = torch.empty((N_LIMBS * nf, blocks), dtype=torch.int64,
                                  device=dev)
            if finish:
                msg = torch.empty((N_LIMBS, nf, 1), dtype=torch.int32,
                                  device=dev)
        outs = [None] * 3
        if order != "message":
            b = torch.empty((nf, N_LIMBS, T // 2), dtype=torch.int32,
                            device=dev)
            bound = tuple(b.unbind(0))
            outs[:nf] = [x.data_ptr() for x in bound]
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.jolt_product_round(
            nf, code, T, *ptrs, *outs, words, r_dev,
            None if partial is None else partial.data_ptr(),
            None if msg is None else msg.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"product_round: K2 launch failed, CUDA error {rc}")
    product_round.launches += 1
    if order != "bind" and not finish:
        msg = partial
    return msg, bound


product_round.launches = 0


# ---------------------------------------------------------------------------
# K4: one batched sumcheck round's tail (`transcript/device.py:round_tail`)
# ---------------------------------------------------------------------------

K4_MAX_INSTANCES = 64
K4_WEIGHTS = 3              # K4's forms of a batching coefficient (`weights`)


class RoundTail(ctypes.Structure):
    """K4's launch record (`Tail` in csrc/transcript.cu)."""
    _fields_ = [("evals", ctypes.c_uint64 * K4_MAX_INSTANCES),
                ("degree", ctypes.c_int32 * K4_MAX_INSTANCES),
                ("n_inst", ctypes.c_int32), ("n_c", ctypes.c_int32),
                ("width", ctypes.c_int32), ("round", ctypes.c_int32),
                ("state", ctypes.c_uint64), ("claims", ctypes.c_uint64),
                ("weights", ctypes.c_uint64), ("comp", ctypes.c_uint64),
                ("r", ctypes.c_uint64),
                ("label", (ctypes.c_uint32 * N_LIMBS) * 3),
                ("inv2", ctypes.c_uint32 * N_LIMBS),
                ("inv6", ctypes.c_uint32 * N_LIMBS)]


def launch_round_tail(tail: RoundTail, device: torch.device) -> None:
    """Launch K4 with the record `tail` on `device`'s current stream (the
    caller, `transcript.device.round_tail`, fills and checks the record);
    raises if the launch fails; counts one launch."""
    lib = _load("K4")
    # the raw stream handle and no device switch when the card is current:
    # a `torch.cuda.Stream` object and the guard cost ~10 us a launch on
    # the H100's host, more than the kernel
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    with (contextlib.nullcontext() if torch.cuda.current_device() == index
          else torch.cuda.device(index)):
        rc = lib.jolt_k4(ctypes.byref(tail),
                         torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"round_tail: K4 launch failed, CUDA error {rc}")
    launch_round_tail.launches += 1


launch_round_tail.launches = 0


def k4_launches() -> int:
    """K4's launch count."""
    return launch_round_tail.launches
