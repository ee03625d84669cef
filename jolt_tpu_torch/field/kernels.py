"""The Fr Montgomery product in the port's layout: kernel K1 and its plain
version.

`mont_mul` is the wrapper of K1 (``csrc/mont_mul.cu``), the hand-written
Hopper kernel that replaces the JAX package's Pallas kernel
(``field/pallas_ops.py:mont_mul``).  On CPU tensors it calls `mont_mul_plain`;
on CUDA tensors it launches K1 or raises.  `mont_mul.launches` counts the
launches.

The kernel builds at first use from the source in this package with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into ``_build/`` (listed in
``.gitignore``) and binds through ctypes, so nothing is compiled when this
module is imported.
"""

from __future__ import annotations

import ctypes
import math
import os
import shutil
import subprocess
from typing import Optional

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
# K1: build, bind, launch
# ---------------------------------------------------------------------------

_PKG_DIR = os.path.join(os.path.dirname(__file__), "..")
_SRC = os.path.join(_PKG_DIR, "csrc", "mont_mul.cu")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_SO = os.path.join(_BUILD_DIR, "libjolt_mont_mul.so")
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: K1 cannot be built")
    return path


def build() -> str:
    """Compile K1 for sm_90a into ``_build/``; returns ptxas' report
    (registers, spills).  Raises if nvcc fails."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    res = subprocess.run(
        [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
         "-o", tmp, _SRC], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed to build K1:\n{res.stderr}")
    os.replace(tmp, _SO)
    return res.stderr


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    if (not os.path.exists(_SO)
            or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
        build()
    lib = ctypes.CDLL(_SO)
    lib.jolt_mont_mul.restype = ctypes.c_int
    lib.jolt_mont_mul.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2
        + [ctypes.c_int64] * 6 + [ctypes.c_void_p])
    _lib = lib
    return lib


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
    lib = _load()
    with torch.cuda.device(a.device):      # launch on the operands' card
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.jolt_mont_mul(out.data_ptr(), av.data_ptr(), bv.data_ptr(),
                               n0, n1, *av.stride(), *bv.stride(), stream)
    if rc != 0:
        raise RuntimeError(f"mont_mul: K1 launch failed, CUDA error {rc}")
    mont_mul.launches += 1
    return out.reshape(shape)


mont_mul.launches = 0
