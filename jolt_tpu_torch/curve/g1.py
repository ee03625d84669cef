"""Batched BN254 G1 arithmetic on the card (Jacobian coordinates over Fq).

The port's counterpart of the JAX package's `curve/g1.py`, with its names.
A batch of N points is three Fq limb tensors (X, Y, Z), each (8, N) int32
in the port's layout (`field/fq.py`: 8 x 32-bit limbs, Montgomery
R = 2^256); Z == 0 encodes infinity.

  * `jacobian_add`, `jacobian_double`, `batch_scalar_mul` are K3's
    wrappers (``csrc/g1.cu``): on CUDA tensors each launches K3's form
    ("add", "double", "scalar_mul") once or raises; on CPU tensors each
    runs its plain version (`*_plain`, the same formulas on `field/fq.py`'s
    plain Fq).  The card's limbs equal the plain versions' bit for bit.
  * Around them, as in the JAX package: `tree_sum` (halvings, each one K3
    launch over the two halves of one tensor), `mask_points`,
    `segmented_scan_points` (a log-step inclusive scan), `msm_binary`,
    `msm_u8`, `msm` (the JAX package's dispatch) and `msm_pippenger`.
  * `pack_points` / `unpack_points`: affine host points <-> a batch.

Formulas (a = 0 curve): dbl-2009-l and add-2007-bl; an add at infinity
returns the other operand, an add of equal points doubles, an add of
opposite points gives (0, 0, 0) -- the JAX package's select order.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..field import fq, kernels
from ..field.kernels import N_LIMBS
from . import bn254_host as host

Point3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]   # (X, Y, Z)
_I32 = torch.int32


# ---------------------------------------------------------------------------
# plain versions (the tests' and chip_smoke's reference; CPU tensors)
# ---------------------------------------------------------------------------

def _muls(*pairs):
    """Independent Fq products in one plain call, stacked on a new batch
    axis (the plain version's cost is its count of torch ops)."""
    a = torch.stack(torch.broadcast_tensors(*(x for x, _ in pairs)), 1)
    b = torch.stack(torch.broadcast_tensors(*(y for _, y in pairs)), 1)
    return fq.mont_mul_plain(a, b).unbind(1)


def _add(a, b):
    return fq.add_plain(a, b)


def _sub(a, b):
    return fq.sub_plain(a, b)


def _dbl(a):
    return fq.add_plain(a, a)


def jacobian_double_plain(P: Point3) -> Point3:
    """dbl-2009-l: A = X^2, B = Y^2, C = B^2, D = 2((X + B)^2 - A - C),
    E = 3A, F = E^2, X3 = F - 2D, Y3 = E (D - X3) - 8C, Z3 = 2 Y Z.
    Infinity (Z = 0) gives Z3 = 0."""
    X, Y, Z = P
    A, B, YZ = _muls((X, X), (Y, Y), (Y, Z))
    XB = _add(X, B)
    E = _add(_dbl(A), A)
    C, XB2, F = _muls((B, B), (XB, XB), (E, E))
    D = _dbl(_sub(_sub(XB2, A), C))
    X3 = _sub(F, _dbl(D))
    (ED,) = _muls((E, _sub(D, X3)))
    Y3 = _sub(ED, _dbl(_dbl(_dbl(C))))
    return (X3, Y3, _dbl(YZ))


def jacobian_add_plain(P: Point3, Q: Point3) -> Point3:
    """add-2007-bl with the JAX package's edge handling: P at infinity ->
    Q, Q at infinity -> P, same x and same y -> double(P), same x and
    opposite y -> (0, 0, 0).  The doubling runs only when a lane needs
    it."""
    both = torch.broadcast_tensors(*P, *Q)
    P, Q = tuple(both[:3]), tuple(both[3:])
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    Z12 = _add(Z1, Z2)
    Z1Z1, Z2Z2, Y1Z2, Y2Z1, Z12sq = _muls((Z1, Z1), (Z2, Z2), (Y1, Z2),
                                         (Y2, Z1), (Z12, Z12))
    U1, U2, S1, S2 = _muls((X1, Z2Z2), (X2, Z1Z1), (Y1Z2, Z2Z2),
                           (Y2Z1, Z1Z1))
    H = _sub(U2, U1)
    rr = _dbl(_sub(S2, S1))
    H2 = _dbl(H)
    I, rr2, Z3 = _muls((H2, H2), (rr, rr),
                       (_sub(_sub(Z12sq, Z1Z1), Z2Z2), H))
    J, V = _muls((H, I), (U1, I))
    X3 = _sub(_sub(rr2, J), _dbl(V))
    Y3a, S1J = _muls((rr, _sub(V, X3)), (S1, J))
    Y3 = _sub(Y3a, _dbl(S1J))

    p_inf, q_inf = fq.is_zero(Z1), fq.is_zero(Z2)
    same_x, same_y = fq.is_zero(H), fq.is_zero(rr)
    out = [X3, Y3, Z3]
    if bool(same_x.any()):
        D3 = (jacobian_double_plain(P) if bool((same_x & same_y).any())
              else (torch.zeros_like(X3),) * 3)
        # same x: double if same y, else (0, 0, 0)
        out = [fq.select(same_x, fq.select(same_y, d, torch.zeros_like(d)),
                         o) for o, d in zip(out, D3)]
    # then the infinities
    return tuple(fq.select(p_inf, q, fq.select(q_inf, p, o))
                 for o, p, q in zip(out, P, Q))


def mask_points(P: Point3, mask: torch.Tensor) -> Point3:
    """Zero out (-> infinity) the points where mask is False."""
    X, Y, Z = P
    return (X, Y, fq.select(mask, Z, torch.zeros_like(Z)))


def batch_scalar_mul_plain(P: Point3, scalar_words: torch.Tensor,
                           bits: int) -> Point3:
    """out[n] = k_n P[n]: `bits` steps of MSB-first double-and-add over the
    (W, N) little-endian u32 words, acc = double(acc) + (bit ? P : P with
    Z = 0), from acc = (0, 0, 0)."""
    zero = torch.zeros_like(P[0])
    acc = (zero, zero, zero)
    words = scalar_words.to(torch.int64) & 0xFFFFFFFF
    for i in range(bits):
        k = bits - 1 - i
        bit = ((words[k // 32] >> (k % 32)) & 1).bool()
        acc = jacobian_add_plain(jacobian_double_plain(acc),
                                 mask_points(P, bit))
    return acc


# ---------------------------------------------------------------------------
# K3: the G1 kernel (csrc/g1.cu)
# ---------------------------------------------------------------------------

_FORM = {"add": 0, "double": 1, "scalar_mul": 2}


class _Pt(ctypes.Structure):
    _fields_ = [("x", ctypes.c_uint64), ("y", ctypes.c_uint64),
                ("z", ctypes.c_uint64), ("sl", ctypes.c_int64),
                ("s1", ctypes.c_int64)]


class _G1Launch(ctypes.Structure):
    _fields_ = [("form", ctypes.c_int32), ("bits", ctypes.c_int32),
                ("n", ctypes.c_uint64), ("a", _Pt), ("b", _Pt),
                ("words", ctypes.c_uint64), ("ws", ctypes.c_int64),
                ("ox", ctypes.c_uint64), ("oy", ctypes.c_uint64),
                ("oz", ctypes.c_uint64)]


def _lib() -> ctypes.CDLL:
    lib = kernels._load("K3")
    if lib.jolt_k3_launch_size() != ctypes.sizeof(_G1Launch):
        raise RuntimeError("K3: the launch record's layout differs between "
                           "csrc/g1.cu and curve/g1.py")
    return lib


def _check(form: str, *pts) -> torch.device:
    """The one device of the points' coordinates; checks type and limbs."""
    devs = set()
    for P in pts:
        if len(P) != 3:
            raise ValueError(f"{form}: a point is (X, Y, Z), got {len(P)}")
        for c in P:
            if c.dtype != _I32:
                raise TypeError(f"{form}: dtype {c.dtype} (want int32)")
            if c.dim() < 1 or c.shape[0] != N_LIMBS:
                raise ValueError(f"{form}: shape {tuple(c.shape)} (want the "
                                 f"{N_LIMBS} limbs first)")
            devs.add(c.device)
    if len(devs) != 1 or next(iter(devs)).type not in ("cpu", "cuda"):
        raise ValueError(f"{form}: operands on {sorted(map(str, devs))}")
    return devs.pop()


def _operand(P: Point3, batch) -> Tuple[Point3, _Pt]:
    """A point broadcast over `batch` as (8, n) views with one limb and one
    lane stride shared by X, Y and Z (a copy where a view cannot be), and
    its description for the kernel."""
    views = tuple(c.expand((N_LIMBS,) + tuple(batch)).reshape(N_LIMBS, -1)
                  for c in P)
    if len({v.stride() for v in views}) != 1 or views[0].stride()[0] < 0 \
            or views[0].stride()[1] < 0:
        views = tuple(v.contiguous() for v in views)
    pt = _Pt()
    pt.x, pt.y, pt.z = (v.data_ptr() for v in views)
    pt.sl, pt.s1 = views[0].stride()
    return views, pt


def _launch(form: str, batch, a: Point3, b: Optional[Point3] = None,
            words: Optional[torch.Tensor] = None, bits: int = 0) -> Point3:
    """K3's `form` over the lanes of `batch` into three new (8, *batch)
    tensors, on the operands' card's current stream; counts the launch."""
    dev = a[0].device
    n = int(np.prod(batch)) if len(batch) else 1
    outs = tuple(torch.empty((N_LIMBS,) + tuple(batch), dtype=_I32,
                             device=dev) for _ in range(3))
    if n == 0:
        return outs
    if N_LIMBS * n >= 1 << 40:
        raise ValueError(f"{form}: {n} lanes")
    L = _G1Launch()
    L.form, L.bits, L.n = _FORM[form], bits, n
    keep = []
    views, L.a = _operand(a, batch)
    keep.append(views)
    if b is not None:
        views, L.b = _operand(b, batch)
        keep.append(views)
    if words is not None:
        L.words, L.ws = words.data_ptr(), words.stride(0)
    L.ox, L.oy, L.oz = (o.data_ptr() for o in outs)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.jolt_k3(ctypes.byref(L),
                         torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{form}: K3 launch failed, CUDA error {rc}")
    kernels.k3_counts[form] += 1
    return outs


def jacobian_double(P: Point3) -> Point3:
    """2P per lane (dbl-2009-l): K3's "double" form on CUDA tensors,
    `jacobian_double_plain` on CPU tensors."""
    dev = _check("double", P)
    if dev.type == "cpu":
        return jacobian_double_plain(P)
    batch = torch.broadcast_shapes(*(c.shape for c in P))[1:]
    return _launch("double", batch, P)


def jacobian_add(P: Point3, Q: Point3) -> Point3:
    """P + Q per lane (add-2007-bl and the JAX package's edge cases): K3's
    "add" form on CUDA tensors, `jacobian_add_plain` on CPU tensors.  The
    coordinates may be strided views (the two halves of one tensor) and
    broadcast against each other."""
    dev = _check("add", P, Q)
    if dev.type == "cpu":
        return jacobian_add_plain(P, Q)
    batch = torch.broadcast_shapes(*(c.shape for c in (*P, *Q)))[1:]
    return _launch("add", batch, P, Q)


def batch_scalar_mul(P: Point3, scalar_words: torch.Tensor,
                     bits: int) -> Point3:
    """out[n] = scalars[n] * P[n] for (W, N) little-endian u32 scalar words
    (int32 bit patterns) and `bits` <= 32 W: K3's "scalar_mul" form (one
    launch, the accumulator in registers) on CUDA tensors,
    `batch_scalar_mul_plain` on CPU tensors."""
    dev = _check("scalar_mul", P)
    if scalar_words.dim() != 2 or scalar_words.device != dev:
        raise ValueError("scalar_mul: words of shape "
                         f"{tuple(scalar_words.shape)} on "
                         f"{scalar_words.device} (want (W, N) on {dev})")
    if not 0 <= bits <= 32 * scalar_words.shape[0]:
        raise ValueError(f"scalar_mul: {bits} bits from "
                         f"{scalar_words.shape[0]} words")
    if dev.type == "cpu":
        return batch_scalar_mul_plain(P, scalar_words, bits)
    batch = torch.broadcast_shapes(*(c.shape for c in P))[1:]
    if len(batch) != 1 or scalar_words.shape[1] != batch[0]:
        raise ValueError(f"scalar_mul: points {tuple(batch)} and words "
                         f"{tuple(scalar_words.shape)}")
    words = scalar_words.to(_I32).contiguous()
    return _launch("scalar_mul", batch, P, words=words, bits=bits)


# ---------------------------------------------------------------------------
# reductions and MSMs
# ---------------------------------------------------------------------------

def _infinity(batch, device) -> Point3:
    z = torch.zeros((N_LIMBS,) + tuple(batch), dtype=_I32, device=device)
    return (z, z, z)


def _halve(P: Point3) -> Point3:
    """Lanes [:h] + lanes [h:] of an (8, 2h) batch: one add over the two
    halves of each tensor."""
    h = P[0].shape[-1] // 2
    return jacobian_add(tuple(c[..., :h] for c in P),
                        tuple(c[..., h:] for c in P))


def tree_sum(P: Point3) -> Point3:
    """Sum all points over the last axis -> batch 1 (a binary tree of
    halvings; padded with infinity to a power of two)."""
    n = P[0].shape[-1]
    m = 1
    while m < n:
        m *= 2
    if m != n:
        P = tuple(torch.nn.functional.pad(c, (0, m - n)) for c in P)
    while P[0].shape[-1] > 1:
        P = _halve(P)
    return P


def segmented_scan_points(P: Point3, heads: torch.Tensor) -> Point3:
    """Segmented inclusive prefix sum of points over the last axis.

    `heads` (shape (1, N) or (N,)) marks the first lane of each segment;
    lanes accumulate left to right within a segment and reset at heads, so
    each segment's TOTAL sits at its last lane.  A log-step (Hillis-Steele)
    scan with the JAX package's combine, (a, fa) . (b, fb) =
    (fb ? b : a + b, fa | fb): step d adds lane i - d into lane i, one K3
    launch a step over the lanes' two overlapping views.  Its tree differs
    from `jax.lax.associative_scan`'s, so the partial sums are the same
    group elements in other Jacobian coordinates."""
    X, Y, Z = P
    n = X.shape[-1]
    flag = heads.reshape(-1).to(X.device).bool()
    d = 1
    while d < n:
        s = jacobian_add((X[:, :-d], Y[:, :-d], Z[:, :-d]),
                         (X[:, d:], Y[:, d:], Z[:, d:]))
        keep = flag[d:]
        X, Y, Z = (torch.cat([c[:, :d], fq.select(keep, c[:, d:], t)], 1)
                   for c, t in zip((X, Y, Z), s))
        flag = torch.cat([flag[:d], flag[d:] | flag[:-d]])
        d *= 2
    return X, Y, Z


def msm_binary(P: Point3, bits: torch.Tensor) -> Point3:
    """Subset sum: the sum of the points where bits[n] == 1."""
    return tree_sum(mask_points(P, bits.bool()))


def msm_u8(P: Point3, scalars: torch.Tensor) -> Point3:
    """MSM with u8 scalars."""
    return msm(P, scalars.to(_I32), 8)


def msm(P: Point3, scalars, bits: int) -> Point3:
    """MSM with `bits`-bit scalars: (N,) or (W, N) little-endian u32 words
    (a tensor on the points' device, or a numpy array for Pippenger's host
    digits).  The JAX package's dispatch: binary scalars take the subset
    sum, full-width ones from 512 lanes Pippenger, the rest per-lane
    double-and-add and one tree sum."""
    if scalars.ndim == 1:
        scalars = scalars[None, :]
    if bits == 1:
        return msm_binary(P, _on(scalars[0], P) & 1)
    if bits > 32 and scalars.shape[-1] >= 512:
        return msm_pippenger(P, scalars, bits)
    return tree_sum(batch_scalar_mul(P, _on(scalars, P).to(_I32), bits))


def _on(words, P: Point3) -> torch.Tensor:
    """Scalar words as a tensor on the points' device."""
    if isinstance(words, np.ndarray):
        words = torch.from_numpy(np.array(words, dtype=np.uint32)
                                 .view(np.int32))
    return words.to(P[0].device)


# ---------------------------------------------------------------------------
# Pippenger (windowed bucket) MSM
#
# The host computes each window's digits and bucket layout (numpy); the
# card gathers the window's points into a (stride, buckets) grid and
# tree-reduces the stride axis (each halving one K3 add over the grid's two
# halves); bucket reconstruction (running suffix sums) runs vectorized
# over the windows, then the window combine.  Windows are reduced one
# after the other, each with its own power-of-two stride over only its
# non-empty buckets: the JAX package's one grid at a common stride would
# hold 32 x 256 x 32,768 points (24 GiB) at 2^20 uniform scalars, since
# the top window's 49 digits hold ~21,400 points each.
# ---------------------------------------------------------------------------

def _digits(words: np.ndarray, bits: int, c: int) -> List[np.ndarray]:
    """Each c-bit window's digits of the (W, N) little-endian u32 words."""
    digs = []
    for w in range((bits + c - 1) // c):
        lo_bit = w * c
        word_i, off = lo_bit // 32, lo_bit % 32
        dig = words[word_i].astype(np.uint64) >> np.uint64(off)
        if off + c > 32 and word_i + 1 < words.shape[0]:
            dig |= words[word_i + 1].astype(np.uint64) << np.uint64(32 - off)
        digs.append((dig & np.uint64((1 << c) - 1)).astype(np.int64))
    return digs


def _window_layout(dig: np.ndarray, c: int):
    """One window's grid: (slot_map (S, B), buckets (B,)) -- the B
    non-empty nonzero buckets, each a column of S = a power of two >= its
    largest count, slot (s, j) the lane of bucket j's s-th point, or N (the
    appended infinity lane).  None when every digit is 0."""
    n = dig.shape[0]
    # a stable sort of 8-bit keys is numpy's radix sort
    order = np.argsort(dig.astype(np.uint8) if c <= 8 else dig,
                       kind="stable")
    full = np.bincount(dig, minlength=1 << c)
    starts = np.concatenate([[0], np.cumsum(full)])
    counts = full.copy()
    counts[0] = 0
    buckets = np.nonzero(counts)[0]
    if len(buckets) == 0:
        return None
    S = 1
    while S < counts.max():
        S *= 2
    col = np.zeros(1 << c, dtype=np.int64)
    col[buckets] = np.arange(len(buckets))
    sorted_d = dig[order]
    live = sorted_d != 0
    lanes, d = order[live], sorted_d[live]
    slot = np.arange(n)[live] - starts[d]
    slot_map = np.full((S, len(buckets)), n, dtype=np.int64)
    slot_map[slot, col[d]] = lanes
    return slot_map, buckets


def _gather_grid(P: Point3, slot_map: np.ndarray) -> Point3:
    """The points at `slot_map`'s lanes as (8, S, B); lane N is infinity."""
    idx = torch.from_numpy(slot_map.reshape(-1)).to(P[0].device)
    return tuple(torch.nn.functional.pad(c, (0, 1)).index_select(1, idx)
                 .reshape((N_LIMBS,) + slot_map.shape) for c in P)


def _reduce_stride(G: Point3) -> Point3:
    """Tree-reduce the stride axis of an (8, S, B) grid -> (8, B): each
    halving adds rows [:h] to rows [h:] in one launch."""
    while G[0].shape[1] > 1:
        h = G[0].shape[1] // 2
        G = jacobian_add(tuple(c[:, :h] for c in G),
                         tuple(c[:, h:] for c in G))
    return tuple(c[:, 0] for c in G)


def _bucket_reconstruct(B: Point3, c: int) -> Point3:
    """sum_k k B_k over buckets 1..2^c-1 by running suffix sums,
    vectorized over the windows: B is (8, n_win, 2^c) -> (8, n_win)."""
    n_win = B[0].shape[1]
    run = tot = _infinity((n_win,), B[0].device)
    for i in range((1 << c) - 1):
        k = (1 << c) - 1 - i
        run = jacobian_add(run, tuple(a[:, :, k] for a in B))
        tot = jacobian_add(tot, run)
    return tot


def _window_combine(W: Point3, c: int) -> Point3:
    """sum_w 2^(c w) W_w, the top window first: acc = 2^c acc + W_w."""
    n_win = W[0].shape[1]
    acc = _infinity((1,), W[0].device)
    for i in range(n_win):
        w = n_win - 1 - i
        for _ in range(c):
            acc = jacobian_double(acc)
        acc = jacobian_add(acc, tuple(a[:, w:w + 1] for a in W))
    return acc


def msm_pippenger(P: Point3, scalar_words, bits: int,
                  c: int = 8) -> Point3:
    """Full-width MSM by windowed buckets -> a batch of one point.
    `scalar_words` is (W, N) little-endian u32 words (numpy, or a tensor
    that is copied to the host for the digits)."""
    if isinstance(scalar_words, torch.Tensor):
        scalar_words = scalar_words.cpu().numpy()
    words = np.asarray(scalar_words)
    words = words.view(np.uint32) if words.dtype == np.int32 else \
        words.astype(np.uint32)
    dev = P[0].device
    n_win = (bits + c - 1) // c
    buckets = tuple(torch.zeros((N_LIMBS, n_win, 1 << c), dtype=_I32,
                                device=dev) for _ in range(3))
    for w, dig in enumerate(_digits(words, bits, c)):
        layout = _window_layout(dig, c)
        if layout is None:
            continue
        slot_map, cols = layout
        sums = _reduce_stride(_gather_grid(P, slot_map))
        idx = torch.from_numpy(cols).to(dev)
        for dst, src in zip(buckets, sums):
            dst[:, w].index_copy_(1, idx, src)
    return _window_combine(_bucket_reconstruct(buckets, c), c)


# ---------------------------------------------------------------------------
# host <-> device
# ---------------------------------------------------------------------------

def pack_points(points: Sequence[host.Point], device="cuda") -> Point3:
    """Affine host points -> a Jacobian batch on `device` (Z = 1,
    infinity (0, 0, 0))."""
    xs = [0 if p is None else p[0] for p in points]
    ys = [0 if p is None else p[1] for p in points]
    zs = [0 if p is None else 1 for p in points]
    return tuple(fq.pack_ints(v, device) for v in (xs, ys, zs))


def unpack_points(P: Point3) -> List[host.Point]:
    """A Jacobian batch (8, N) -> affine host points (None = infinity)."""
    X, Y, Z = (fq.unpack_ints(c.reshape(N_LIMBS, -1)) for c in P)
    out: List[host.Point] = []
    q = fq.Q
    for x, y, z in zip(X, Y, Z):
        if z == 0:
            out.append(None)
            continue
        zinv = pow(z, -1, q)
        z2 = zinv * zinv % q
        out.append((x * z2 % q, y * z2 * zinv % q))
    return out
