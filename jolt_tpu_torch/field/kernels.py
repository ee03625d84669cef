"""The port's hand-written Hopper kernels for Fr, and their plain versions.

  * K1 `mont_mul` (``csrc/mont_mul.cu``) replaces the JAX package's Pallas
    kernel ``field/pallas_ops.py:mont_mul``: the elementwise Montgomery
    product.
  * K2 `product_round_deg3` (``csrc/product_round.cu``) replaces
    ``field/pallas_ops.py:product_round_deg3``: one HighToLow round of a
    degree-3, three-factor product sumcheck (message evals + the bound
    factors in one pass).

On CPU tensors each wrapper calls its plain version (`mont_mul_plain`,
`product_round_deg3_plain`); on CUDA tensors it launches its kernel or
raises.  `<wrapper>.launches` counts the launches.

The kernels build at first use from the sources in this package, one
``nvcc -gencode arch=compute_90a,code=sm_90a`` per source, all started
together, into ``_build/`` (listed in ``.gitignore``), and bind through
ctypes, so nothing is compiled when this module is imported.
"""

from __future__ import annotations

import ctypes
import math
import os
import shutil
import subprocess
from typing import Dict, Tuple

import torch

from .params import FR_MODULUS

N_LIMBS = 8
MASK32 = (1 << 32) - 1
P = FR_MODULUS
R = 1 << 256
R_MOD_P = R % P
R2_MOD_P = R * R % P

P_LIMBS = [(P >> (32 * i)) & MASK32 for i in range(N_LIMBS)]


def _pack_limbs(w: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int32 bit patterns."""
    return (w - ((w >> 31) << 32)).to(torch.int32)


def _sub_p_select(w: torch.Tensor) -> torch.Tensor:
    """w (int64 words, value < 2p) -> w - p if w >= p else w."""
    d = torch.empty_like(w)
    borrow = torch.zeros_like(w[0])
    for i in range(N_LIMBS):
        v = w[i] - P_LIMBS[i] - borrow
        d[i] = v & MASK32
        borrow = (v >> 63) & 1
    return torch.where(borrow.bool()[None], w, d)


_N0_16 = (-pow(P, -1, 1 << 16)) % (1 << 16)
_P16 = [(P >> (16 * i)) & 0xFFFF for i in range(16)]


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _split16(a: torch.Tensor) -> torch.Tensor:
    """(8, *batch) int32 words -> (16, *batch) int64 16-bit sub-limbs."""
    u = a.to(torch.int64) & MASK32
    return torch.stack([u & 0xFFFF, u >> 16], dim=1).reshape(
        (16,) + tuple(a.shape[1:]))


def mont_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * 2^-256 mod p on (8, *batch) int32 words, in plain torch.

    Takes a < 2^256 and b < p (so a*b + m*p < 2^257 p, the result before the
    conditional subtract is < 2p).  Works in base 2^16 on int64: schoolbook
    columns < 16 (2^16-1)^2 < 2^36, reduction terms and carries keep every
    column < 2^38.  The result is the unique value < p, so it equals K1's
    32-bit CIOS bit for bit."""
    a, b = torch.broadcast_tensors(a, b)
    A, B = _split16(a), _split16(b)
    batch = tuple(A.shape[1:])
    cols = torch.zeros((32,) + batch, dtype=torch.int64, device=a.device)
    for i in range(16):
        cols[i:i + 16] += A[i] * B
    p16 = torch.tensor(_P16, dtype=torch.int64, device=a.device).reshape(
        (16,) + (1,) * len(batch))
    for i in range(16):
        m = (cols[i] * _N0_16) & 0xFFFF
        cols[i:i + 16] += m * p16
        cols[i + 1] += cols[i] >> 16
    r16 = torch.empty((16,) + batch, dtype=torch.int64, device=a.device)
    c = torch.zeros(batch, dtype=torch.int64, device=a.device)
    for i in range(16):
        v = cols[16 + i] + c
        r16[i] = v & 0xFFFF
        c = v >> 16
    w = r16[0::2] | (r16[1::2] << 16)
    return _pack_limbs(_sub_p_select(w))


# ---------------------------------------------------------------------------
# build and bind
# ---------------------------------------------------------------------------

_PKG_DIR = os.path.join(os.path.dirname(__file__), "..")
_CSRC = os.path.join(_PKG_DIR, "csrc")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_HEADERS = [os.path.join(_CSRC, "fr.cuh")]
# kernel -> (source, shared library, {C function: (restype, argtypes)})
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_KERNELS = {
    "K1": ("mont_mul.cu", "libjolt_mont_mul.so", {
        "jolt_mont_mul": (ctypes.c_int, [_P] * 3 + [_I64] * 8 + [_P])}),
    "K2": ("product_round.cu", "libjolt_product_round.so", {
        "jolt_product_round_blocks": (ctypes.c_int, [_I64]),
        "jolt_product_round_deg3": (ctypes.c_int,
                                    [_P] * 8 + [_I64, _P])}),
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
    _libs[name] = lib
    return lib


# ---------------------------------------------------------------------------
# K1: the Montgomery product
# ---------------------------------------------------------------------------

def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise Montgomery product of (8, *batch) int32 limb tensors that
    broadcast together; returns a new contiguous (8, *batch) tensor.

    CPU tensors take `mont_mul_plain`.  CUDA tensors launch K1 on their
    card's current stream: the batch collapses to (n0, n1) and each operand is
    passed with its (limb, row, column) strides, so broadcast operands
    (a scalar challenge, a per-row weight) are read in place with stride 0.
    An operand whose broadcast view cannot be collapsed is copied first."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mont_mul_plain(a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"mont_mul: operands on {a.device} and {b.device}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"mont_mul: dtypes {a.dtype}, {b.dtype} (want int32)")
    if a.shape[0] != N_LIMBS or b.shape[0] != N_LIMBS:
        raise ValueError(f"mont_mul: limb axis {a.shape[0]}, {b.shape[0]}")
    shape = torch.broadcast_shapes(a.shape, b.shape)
    batch = shape[1:]
    n1 = batch[-1] if batch else 1
    n0 = math.prod(batch[:-1]) if len(batch) > 1 else 1
    out = torch.empty((N_LIMBS, n0, n1), dtype=torch.int32, device=a.device)
    if n0 * n1 == 0:
        return out.reshape(shape)
    if n0 * n1 >= 1 << 31:
        raise ValueError(f"mont_mul: batch of {n0 * n1} exceeds 2^31")
    av = a.expand(shape).reshape(N_LIMBS, n0, n1)
    bv = b.expand(shape).reshape(N_LIMBS, n0, n1)
    lib = _load("K1")
    with torch.cuda.device(a.device):      # launch on the operands' card
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.jolt_mont_mul(out.data_ptr(), av.data_ptr(), bv.data_ptr(),
                               n0, n1, *av.stride(), *bv.stride(), stream)
    if rc != 0:
        raise RuntimeError(f"mont_mul: K1 launch failed, CUDA error {rc}")
    mont_mul.launches += 1
    return out.reshape(shape)


mont_mul.launches = 0


# ---------------------------------------------------------------------------
# K2: one fused round of a degree-3, three-factor product sumcheck
# ---------------------------------------------------------------------------

def product_round_deg3_plain(p0: torch.Tensor, p1: torch.Tensor,
                             p2: torch.Tensor, r: torch.Tensor):
    """K2's function in plain torch: the message evals at X = 0, 2, 3 of
    sum_i p0(X) p1(X) p2(X) over the pairs (i, i + T/2), as (8, 3, 1)
    Montgomery limbs, and each factor bound HighToLow at r, (8, T/2).

    Products and binds use `mont_mul_plain`; the sums are `ops.sum_mod`,
    whose mod-p finish of the (8, 3) column sums is the same
    `ops.reduce_cols` the kernel's wrapper uses."""
    from ..poly import dense
    from . import ops
    acc = None
    for p in (p0, p1, p2):
        e = dense.sumcheck_eval_points_high(p, 3)
        acc = e if acc is None else mont_mul_plain(acc, e)
    half = p0.shape[-1] // 2
    bound = [ops.add(p[:, :half], mont_mul_plain(
        ops.sub(p[:, half:], p[:, :half]), r)) for p in (p0, p1, p2)]
    return (ops.sum_mod(acc), *bound)


def product_round_deg3(p0: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                       r: torch.Tensor):
    """One HighToLow round of the product sumcheck of p0 p1 p2 (each (8, T),
    T even) at the challenge r (8, 1): returns (msg, b0, b1, b2) with msg the
    (8, 3, 1) Montgomery evals at X = 0, 2, 3 and b0..b2 the bound factors
    (8, T/2) -- the JAX kernel followed by its `reduce_lazy_cols`.

    CPU tensors take `product_round_deg3_plain`.  CUDA tensors launch K2
    (`launch_product_round`); its per-block exact uint64 limb-plane sums add
    up in int64 here and `ops.reduce_cols` reduces them mod p."""
    if all(t.device.type == "cpu" for t in (p0, p1, p2, r)):
        return product_round_deg3_plain(p0, p1, p2, r)
    from . import ops
    partial, *bound = launch_product_round(p0, p1, p2, r)
    # each block sum < 2^40: int64 holds the uint64 and their total exactly
    msg = ops.reduce_cols(partial.sum(dim=0)[:, :, None])
    return (msg, *bound)


def launch_product_round(p0: torch.Tensor, p1: torch.Tensor,
                         p2: torch.Tensor, r: torch.Tensor):
    """Launch K2 on the operands' card's current stream; returns
    (partial, b0, b1, b2): partial (blocks, 8, 3) int64 holds each thread
    block's exact uint64 sums of the 32-bit limb planes of its products,
    b0..b2 the bound factors (8, T/2).  Counts one launch on
    `product_round_deg3.launches`."""
    args = (p0, p1, p2, r)
    dev = p0.device
    if dev.type != "cuda" or any(t.device != dev for t in args):
        raise ValueError("product_round_deg3: operands on "
                         f"{[str(t.device) for t in args]}")
    if any(t.dtype != torch.int32 for t in args):
        raise TypeError("product_round_deg3: dtypes "
                        f"{[t.dtype for t in args]} (want int32)")
    T = p0.shape[-1]
    if (any(t.shape != (N_LIMBS, T) for t in args[:3]) or T % 2 or T < 2
            or tuple(r.shape) != (N_LIMBS, 1)):
        raise ValueError("product_round_deg3: shapes "
                         f"{[tuple(t.shape) for t in args]} (want three "
                         "(8, T), T even, and r (8, 1))")
    half = T // 2
    if half >= 1 << 31:
        raise ValueError(f"product_round_deg3: {half} pairs exceed 2^31")
    p0, p1, p2, r = (t.contiguous() for t in args)
    lib = _load("K2")
    blocks = lib.jolt_product_round_blocks(half)
    bound = [torch.empty((N_LIMBS, half), dtype=torch.int32, device=dev)
             for _ in range(3)]
    partial = torch.empty((blocks, N_LIMBS, 3), dtype=torch.int64,
                          device=dev)
    with torch.cuda.device(dev):          # launch on the operands' card
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.jolt_product_round_deg3(
            p0.data_ptr(), p1.data_ptr(), p2.data_ptr(), r.data_ptr(),
            *(b.data_ptr() for b in bound), partial.data_ptr(), half, stream)
    if rc != 0:
        raise RuntimeError(f"product_round_deg3: K2 launch failed, CUDA "
                           f"error {rc}")
    product_round_deg3.launches += 1
    return (partial, *bound)


product_round_deg3.launches = 0
