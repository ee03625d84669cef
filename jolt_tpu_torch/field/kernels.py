"""The port's hand-written Hopper kernels for Fr, and their plain versions.

  * K1 `mont_mul` (``csrc/mont_mul.cu``) replaces the JAX package's Pallas
    kernel ``field/pallas_ops.py:mont_mul``: the elementwise Montgomery
    product.
  * K2 `product_round` (``csrc/product_round.cu``) replaces
    ``field/pallas_ops.py:product_round_deg3``: one HighToLow round of a
    product sumcheck of 2 or 3 factors (message evals and the bound factors
    in one pass, in one of four orders, the message finished mod p on the
    card); `product_round_deg3` is its "message_bind" order at 3 factors.

On CPU tensors each wrapper calls its plain version (`mont_mul_plain`,
`product_round_plain`); on CUDA tensors it launches its kernel or raises.
`mont_mul.launches` and `product_round.launches` count the launches.

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
        "jolt_product_round_blocks": (ctypes.c_int, [ctypes.c_int, _I64]),
        "jolt_product_round": (ctypes.c_int, [ctypes.c_int] * 2
                               + [_I64] + [_P] * 10)}),
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
# K2: one HighToLow round of a product sumcheck of 2 or 3 factors
# ---------------------------------------------------------------------------

# K2's pass orders (`Order` in csrc/product_round.cu)
ORDERS = ("message_bind", "message", "bind_message", "bind")


def _r_tensor(r, device) -> torch.Tensor:
    """The challenge as (8, 1) Montgomery limbs on `device`: r is a canonical
    int or already such a tensor."""
    if isinstance(r, torch.Tensor):
        return r.to(device)
    from . import ops
    return ops.pack_ints([r], device)


def _r_words(r) -> "ctypes.Array":
    """The challenge's 8 Montgomery words for the launch, on the host: a
    canonical int converts there, a device tensor is copied back (32 bytes,
    which waits for the card)."""
    if isinstance(r, torch.Tensor):
        words = [int(w) & MASK32 for w in r.reshape(N_LIMBS).tolist()]
    else:
        mont = int(r) % P * R % P
        words = [(mont >> (32 * i)) & MASK32 for i in range(N_LIMBS)]
    return (ctypes.c_uint32 * N_LIMBS)(*words)


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
    (unused by "message").  Products and binds use `mont_mul_plain`; the
    sums are `ops.sum_mod`, whose mod-p finish (`ops.reduce_cols`) the
    kernel's finish equals bit for bit."""
    from ..poly import dense
    from . import ops
    polys = tuple(polys)
    _check_round(polys, order)

    def message(ps):
        acc = None
        for p in ps:
            e = dense.sumcheck_eval_points_high(p, len(ps))
            acc = e if acc is None else mont_mul_plain(acc, e)
        return ops.sum_mod(acc)

    msg = bound = None
    if order in ("message_bind", "message"):
        msg = message(polys)
    if order != "message":
        r_t = _r_tensor(r, polys[0].device)
        half = polys[0].shape[-1] // 2
        bound = tuple(ops.add(p[:, :half], mont_mul_plain(
            ops.sub(p[:, half:], p[:, :half]), r_t)) for p in polys)
    if order == "bind_message":
        msg = message(bound)
    return msg, bound


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
    bound) as `product_round` does.  With finish=False the finish kernel is
    not launched and msg is the pass kernel's block sums instead: (8 NF,
    blocks) int64, column k * 8 + l the exact sum of limb l at the k-th eval
    point (for timing the pass alone).  Counts one launch on
    `product_round.launches`."""
    polys = tuple(polys)
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
    words = None if order == "message" else _r_words(r)
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
            nf, code, T, *ptrs, *outs, words,
            None if partial is None else partial.data_ptr(),
            None if msg is None else msg.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"product_round: K2 launch failed, CUDA error {rc}")
    product_round.launches += 1
    if order != "bind" and not finish:
        msg = partial
    return msg, bound


product_round.launches = 0
