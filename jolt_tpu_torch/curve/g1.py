"""Batched BN254 G1 arithmetic on the card (Jacobian coordinates over Fq).

The port's counterpart of the JAX package's `curve/g1.py`, with its names.
A batch of N points is three Fq limb tensors (X, Y, Z), each (8, N) int32
in the port's layout (`field/fq.py`: 8 x 32-bit limbs, Montgomery
R = 2^256); Z == 0 encodes infinity.  An affine batch has Z = R mod q
(Montgomery one) or Z = 0, and X = Y = 0 at infinity.

  * K3's wrappers (``csrc/g1.cu``), one a form: `jacobian_add`,
    `jacobian_double`, `batch_scalar_mul` (the JAX package's names),
    `normalize` (Jacobian -> affine), `bucket_sum` (segment sums of affine
    bases: mixed adds, then the partials' adds, level by level) and
    `bucket_reduce` (Pippenger's sum_w 2^(c w) sum_k k B_{w,k} in one
    launch).  On CUDA tensors each launches K3 or raises; on CPU tensors
    each runs its plain version (`*_plain`: the same formulas on
    `field/fq.py`'s plain Fq, the same additions in the same order).  The
    card's limbs equal the plain versions' bit for bit.
  * Around them, as in the JAX package: `tree_sum` (halvings, each one K3
    launch over the two halves of one tensor), `mask_points`,
    `segmented_scan_points` (a log-step inclusive scan), `msm_binary`,
    `msm_u8`, `msm` (the JAX package's dispatch), `msm_rows` (many MSMs
    of one length, as Dory's row commits and folded halves take them) and
    `msm_pippenger` (digits, a stable sort and the bucket offsets by torch
    on the points' device, then `bucket_sum` and `bucket_reduce`).
  * `pack_points` / `unpack_points`: affine host points <-> a batch.

Formulas (a = 0 curve): dbl-2009-l, add-2007-bl and madd-2007-bl; an add
at infinity returns the other operand, an add of equal points doubles, an
add of opposite points gives (0, 0, 0) -- the JAX package's select order.
"""

from __future__ import annotations

import ctypes
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..field import fq, kernels, ops
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
    return _edges(P, Q, (X3, Y3, Z3), H, rr)


def _edges(P: Point3, Q: Point3, out: Point3, H, rr) -> Point3:
    """The add's edge cases over its generic result `out`: same x (H = 0)
    -> double(P) if same y (rr = 0), else (0, 0, 0); then P at infinity ->
    Q, Q at infinity -> P."""
    p_inf, q_inf = fq.is_zero(P[2]), fq.is_zero(Q[2])
    same_x, same_y = fq.is_zero(H), fq.is_zero(rr)
    out = list(out)
    if bool(same_x.any()):
        # the doubling runs only when a finite lane needs it (a lane at
        # infinity takes the other operand below)
        dbl = same_x & same_y & ~p_inf & ~q_inf
        D3 = (jacobian_double_plain(P) if bool(dbl.any())
              else (torch.zeros_like(out[0]),) * 3)
        # same x: double if same y, else (0, 0, 0)
        out = [fq.select(same_x, fq.select(same_y, d, torch.zeros_like(d)),
                         o) for o, d in zip(out, D3)]
    # then the infinities
    return tuple(fq.select(p_inf, q, fq.select(q_inf, p, o))
                 for o, p, q in zip(out, P, Q))


def _one_like(a: torch.Tensor) -> torch.Tensor:
    """Montgomery one (R mod q) as (8, 1) limbs on `a`'s device."""
    return fq.pack_ints([1], a.device)


def affine_bases(P: Point3) -> Point3:
    """An affine batch as `bucket_sum` reads it: (X, Y, R) where Z != 0,
    (0, 0, 0) where Z = 0 (its X and Y dropped)."""
    inf = fq.is_zero(P[2])
    zero = torch.zeros_like(P[0])
    one = _one_like(P[0]).expand_as(P[0])
    return (fq.select(inf, zero, P[0]), fq.select(inf, zero, P[1]),
            fq.select(inf, zero, one))


def jacobian_madd_plain(P: Point3, Q: Point3) -> Point3:
    """P + Q for an affine Q (`affine_bases`: Z2 = R, or (0, 0, 0) at
    infinity): madd-2007-bl, Z1Z1 = Z1^2, U2 = X2 Z1Z1, S2 = Y2 Z1 Z1Z1,
    H = U2 - X1, rr = 2 (S2 - Y1), HH = H^2, I = 4 HH, J = H I, V = X1 I,
    X3 = rr^2 - J - 2V, Y3 = rr (V - X3) - 2 Y1 J,
    Z3 = (Z1 + H)^2 - Z1Z1 - HH (7M + 4S), with `jacobian_add_plain`'s
    edge handling.  Each coordinate equals `jacobian_add_plain(P, Q)`'s."""
    both = torch.broadcast_tensors(*P, *Q)
    P, Q = tuple(both[:3]), tuple(both[3:])
    X1, Y1, Z1 = P
    X2, Y2, _ = Q
    Z1Z1, Y2Z1 = _muls((Z1, Z1), (Y2, Z1))
    U2, S2 = _muls((X2, Z1Z1), (Y2Z1, Z1Z1))
    H = _sub(U2, X1)
    rr = _dbl(_sub(S2, Y1))
    ZH = _add(Z1, H)
    HH, rr2, ZH2 = _muls((H, H), (rr, rr), (ZH, ZH))
    I = _dbl(_dbl(HH))
    J, V = _muls((H, I), (X1, I))
    X3 = _sub(_sub(_sub(rr2, J), V), V)
    Y3a, Y1J = _muls((rr, _sub(V, X3)), (Y1, J))
    Y3 = _sub(Y3a, _dbl(Y1J))
    Z3 = _sub(_sub(ZH2, Z1Z1), HH)
    return _edges(P, Q, (X3, Y3, Z3), H, rr)


_Q_MINUS_2 = fq.Q - 2


def normalize_plain(P: Point3) -> Point3:
    """Jacobian -> affine per lane: (X Z^-2, Y Z^-3, R), infinity ->
    (0, 0, 0); Z^-1 = Z^(q-2), square-and-multiply from the exponent's
    top bit down (K3's chain)."""
    X, Y, Z = torch.broadcast_tensors(*P)
    inv = Z
    for k in range(_Q_MINUS_2.bit_length() - 2, -1, -1):
        inv = fq.mont_mul_plain(inv, inv)
        if (_Q_MINUS_2 >> k) & 1:
            inv = fq.mont_mul_plain(inv, Z)
    (t,) = _muls((inv, inv))
    x, t3 = _muls((X, t), (t, inv))
    (y,) = _muls((Y, t3))
    return affine_bases((x, y, Z))


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

_FORM = {"add": 0, "double": 1, "scalar_mul": 2, "normalize": 3}


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


class _BucketLaunch(ctypes.Structure):
    _fields_ = [("bases", ctypes.c_uint64), ("lanes", ctypes.c_uint64),
                ("px", ctypes.c_uint64), ("py", ctypes.c_uint64),
                ("pz", ctypes.c_uint64), ("m", ctypes.c_int64),
                ("beg", ctypes.c_uint64), ("end", ctypes.c_uint64),
                ("n", ctypes.c_int64), ("ox", ctypes.c_uint64),
                ("oy", ctypes.c_uint64), ("oz", ctypes.c_uint64)]


class _ReduceLaunch(ctypes.Structure):
    _fields_ = [(f, ctypes.c_uint64) for f in
                ("bx", "by", "bz", "wx", "wy", "wz", "ox", "oy", "oz",
                 "counter")] + [(f, ctypes.c_int32) for f in
                                ("n_win", "c", "m", "log_s")]


def _lib() -> ctypes.CDLL:
    lib = kernels._load("K3")
    if lib.jolt_k3_launch_size() != ctypes.sizeof(_G1Launch) or \
            lib.jolt_k3_bucket_sizes() != 1000 * ctypes.sizeof(
                _BucketLaunch) + ctypes.sizeof(_ReduceLaunch):
        raise RuntimeError("K3: a launch record's layout differs between "
                           "csrc/g1.cu and curve/g1.py")
    return lib


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _stamp() -> int:
    """A launch's enqueue instant, read only while launches are recorded
    (`kernels.record`)."""
    return time.perf_counter_ns() if kernels.record is not None else 0


def _done(form: str, rc: int, key=None, t_ns: int = 0) -> None:
    """Raise on a failed launch; count a good one, and record it as
    "k3_<form>" with `key` (`kernels.note`): (lanes,) for "add", "double"
    and "normalize", (lanes, bits, words) for "scalar_mul", (bases,
    entries, non-empty segments, segments) for a bucket sum's first level
    and None for its later ones, (windows, c) for "bucket_reduce"."""
    if rc != 0:
        raise RuntimeError(f"{form}: K3 launch failed, CUDA error {rc}")
    kernels.k3_counts[form] += 1
    if kernels.record is not None:
        kernels.note(f"k3_{form}", key, t_ns)


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
    key = (n, bits, words.shape[0]) if form == "scalar_mul" else (n,)
    with torch.cuda.device(dev):
        t = _stamp()
        _done(form, lib.jolt_k3(ctypes.byref(L), _stream(dev)), key, t)
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


def normalize(P: Point3) -> Point3:
    """Jacobian -> affine per lane, (X Z^-2, Y Z^-3, R), infinity ->
    (0, 0, 0): K3's "normalize" form on CUDA tensors, `normalize_plain` on
    CPU tensors."""
    dev = _check("normalize", P)
    if dev.type == "cpu":
        return normalize_plain(P)
    batch = torch.broadcast_shapes(*(c.shape for c in P))[1:]
    return _launch("normalize", batch, P)


# ---------------------------------------------------------------------------
# bucket sums: segments of affine bases, one level of chunks at a time
#
# Segment s is the bases at lanes[starts[s]:ends[s]].  Level 0 cuts each
# segment into chunks of at most _CHUNK0 entries and sums each chunk from
# infinity, left to right, with mixed adds; each later level cuts each
# segment's partials (contiguous, in segment order) into chunks of at most
# _CHUNK and sums those with generic adds, until every segment has one.  A
# thread's work is one chunk, whatever the segments' lengths: a segment
# holding every lane (equal scalars, a hot Dory row) is as fast as many
# short ones.  The chunk tables are torch plumbing on the lanes' device;
# the plain version and K3 sum the same chunks.
# ---------------------------------------------------------------------------

_CHUNK0 = 32
_CHUNK = 8


def _chunk_table(starts: torch.Tensor, counts: torch.Tensor, size: int,
                 tally: Optional[list] = None):
    """Each segment's [start, start + count) cut into chunks of `size`:
    (beg, end) int64 per chunk in segment order, the chunks a segment, and
    the most any segment has (one sync).  With `tally` a list, the same
    sync also reads the entries and the non-empty segments into it."""
    dev = starts.device
    nch = (counts + size - 1) // size
    sums = [nch.sum(), nch.max()]
    if tally is not None:
        sums += [counts.sum(), (counts > 0).sum()]
    total, longest, *more = (int(v) for v in ops.host(torch.stack(sums)))
    if tally is not None:
        tally.extend(more)
    seg = torch.repeat_interleave(torch.arange(nch.numel(), device=dev), nch,
                                  output_size=total)
    first = torch.cumsum(nch, 0) - nch
    beg = starts[seg] + (torch.arange(total, device=dev) - first[seg]) * size
    end = torch.minimum(beg + size, (starts + counts)[seg])
    return beg, end, nch, longest


def bucket_levels(starts: torch.Tensor, counts: torch.Tensor,
                  tally: Optional[list] = None):
    """The chunk tables of every level of a bucket sum over segments
    [start, start + count): level 0's chunks of <= _CHUNK0 lanes, then
    levels of <= _CHUNK partials until one partial is left a segment, as
    (beg, end) pairs (one host sync a level; [] when every segment is
    empty).  All of them are made before the first launch, so the levels'
    launches follow each other with no sync between.  `tally` as
    `_chunk_table`'s, in level 0's sync."""
    beg, end, nch, longest = _chunk_table(starts, counts, _CHUNK0, tally)
    if beg.numel() == 0:
        return []
    levels = [(beg, end)]
    while longest > 1:
        beg, end, nch, longest = _chunk_table(torch.cumsum(nch, 0) - nch,
                                              nch, _CHUNK)
        levels.append((beg, end))
    return levels


def _base_rows(P: Point3) -> torch.Tensor:
    """An affine batch point-major, as K3's level 0 gathers it: (N, 16)
    int32, X's then Y's 8 words a row, (0, 0) at infinity (64 bytes a
    lane and no other buffer of N points)."""
    X, Y, Z = P
    rows = torch.empty((X.shape[-1], 2 * N_LIMBS), dtype=_I32,
                       device=X.device)
    rows[:, :N_LIMBS] = X.t()
    rows[:, N_LIMBS:] = Y.t()
    rows.masked_fill_(fq.is_zero(Z)[:, None], 0)
    return rows


def _bucket_source(P: Point3, plain: bool):
    """The bases as a level-0 sum reads them: `affine_bases` for the
    plain version, `_base_rows` for K3."""
    return affine_bases(P) if plain else _base_rows(P)


def _sum_level_k3(src, affine: bool, lanes, beg, end, key=None) -> Point3:
    """One level on K3 (one launch): `src` the base rows (level 0) or the
    level before's partials; `key` its launch record's."""
    dev = beg.device
    n = beg.numel()
    outs = tuple(torch.empty((N_LIMBS, n), dtype=_I32, device=dev)
                 for _ in range(3))
    L = _BucketLaunch()
    if affine:
        L.bases, L.lanes = src.data_ptr(), lanes.data_ptr()
    else:
        src = tuple(c.contiguous() for c in src)
        L.px, L.py, L.pz = (c.data_ptr() for c in src)
        L.m = src[0].shape[1]
    L.beg, L.end, L.n = beg.data_ptr(), end.data_ptr(), n
    L.ox, L.oy, L.oz = (o.data_ptr() for o in outs)
    with torch.cuda.device(dev):
        t = _stamp()
        _done("bucket_sum", _lib().jolt_k3_bucket_sum(
            ctypes.byref(L), int(affine), _stream(dev)), key, t)
    return outs


def _sum_level_plain(src, affine: bool, lanes, beg, end,
                     key=None) -> Point3:
    """One level in plain Fq: step i adds each chunk's i-th entry where
    the chunk has one (mixed adds of `affine_bases` at level 0)."""
    acc = tuple(torch.zeros((N_LIMBS, beg.numel()), dtype=_I32,
                            device=beg.device) for _ in range(3))
    for i in range(int((end - beg).max())):
        pos = beg + i
        live = pos < end
        idx = torch.where(live, pos, torch.zeros_like(pos))
        if affine:
            take = lanes.index_select(0, idx).long()
            new = jacobian_madd_plain(acc, tuple(c.index_select(1, take)
                                                 for c in src))
        else:
            new = jacobian_add_plain(acc, tuple(c.index_select(1, idx)
                                                for c in src))
        acc = tuple(fq.select(live, a, b) for a, b in zip(new, acc))
    return acc


def _bucket_sum(src, lanes, starts, ends, plain: bool) -> Point3:
    """`bucket_sum` over the bases as `_bucket_source` gave them."""
    dev = lanes.device
    starts = ops.upload(starts, dev, torch.int64).reshape(-1)
    if ends is None:
        starts, ends = starts[:-1], starts[1:]
    counts = (ops.upload(ends, dev, torch.int64).reshape(-1)
              - starts).clamp_min(0)
    out = tuple(torch.zeros((N_LIMBS, starts.numel()), dtype=_I32,
                            device=dev) for _ in range(3))
    if starts.numel() == 0:
        return out
    lanes = ops.upload(lanes, dev, _I32).contiguous()
    tally = [] if kernels.record is not None and not plain else None
    levels = bucket_levels(starts, counts, tally)
    if not levels:
        return out
    level = _sum_level_plain if plain else _sum_level_k3
    key = None if tally is None else (src.shape[0], *tally, starts.numel())
    parts = level(src, True, lanes, *levels[0], key)
    for beg, end in levels[1:]:
        parts = level(parts, False, None, beg, end)
    live = torch.nonzero(counts > 0).squeeze(1)
    for o, p in zip(out, parts):
        o.index_copy_(1, live, p)
    return out


def bucket_sum_plain(P: Point3, lanes: torch.Tensor, starts: torch.Tensor,
                     ends: Optional[torch.Tensor] = None) -> Point3:
    """`bucket_sum` in plain Fq on any device: the same chunks, the same
    additions in the same order."""
    return _bucket_sum(affine_bases(P), ops.upload(lanes, P[0].device),
                       starts, ends, plain=True)


def bucket_sum(P: Point3, lanes: torch.Tensor, starts: torch.Tensor,
               ends: Optional[torch.Tensor] = None) -> Point3:
    """Segment sums of the affine bases P (`affine_bases`: Z = R, or Z = 0
    for infinity): segment s is the bases at lanes[starts[s]:ends[s]] (with
    `ends` None, `starts` holds CSR offsets, n_seg + 1 of them) -> (8,
    n_seg) Jacobian points, (0, 0, 0) for an empty segment.  K3's
    "bucket_sum" form (one launch a level) on CUDA tensors, the plain
    version on CPU tensors."""
    dev = _check("bucket_sum", P)
    if P[0].dim() != 2:
        raise ValueError(f"bucket_sum: bases {tuple(P[0].shape)} (want "
                         "(8, N))")
    plain = dev.type == "cpu"
    return _bucket_sum(_bucket_source(P, plain), ops.upload(lanes, dev),
                       starts, ends, plain)


# the most bucket-reduce threads a window (`kReduceThreads`, csrc/g1.cu)
_REDUCE_THREADS = 256


def _reduce_shape(c: int) -> Tuple[int, int]:
    """Threads a window m and log2 of the buckets a thread s."""
    m = min(1 << c, _REDUCE_THREADS)
    return m, c - (m.bit_length() - 1)


def bucket_reduce_plain(B: Point3, c: int) -> Point3:
    """sum_w 2^(c w) sum_k k B_{w,k} over (8, n_win 2^c) bucket sums ->
    (8, 1), K3's steps (csrc/g1.cu `k3_bucket_reduce`) vectorized over
    the windows' threads: each thread's running sums over its s buckets
    from the top down (S_i, T_i), the suffix scan G_i, the tree sums U of
    G_1.. and V of T, W_w = V + s U, then Horner over the windows."""
    n_win = B[0].shape[-1] >> c
    m, log_s = _reduce_shape(c)
    s = 1 << log_s
    Bv = tuple(x.reshape(N_LIMBS, n_win, m, s) for x in B)
    run = tot = _infinity((n_win, m), B[0].device)
    for k in range(s - 1, 0, -1):
        run = jacobian_add_plain(run, tuple(x[..., k] for x in Bv))
        tot = jacobian_add_plain(tot, run)
    G = jacobian_add_plain(run, tuple(x[..., 0] for x in Bv))
    d = 1
    while d < m:
        head = jacobian_add_plain(tuple(g[..., :m - d] for g in G),
                                  tuple(g[..., d:] for g in G))
        G = tuple(torch.cat([a, g[..., m - d:]], -1)
                  for a, g in zip(head, G))
        d *= 2
    G = tuple(torch.cat([torch.zeros_like(g[..., :1]), g[..., 1:]], -1)
              for g in G)
    h = m // 2
    while h >= 1:
        G = jacobian_add_plain(tuple(g[..., :h] for g in G),
                               tuple(g[..., h:2 * h] for g in G))
        tot = jacobian_add_plain(tuple(t[..., :h] for t in tot),
                                 tuple(t[..., h:2 * h] for t in tot))
        h //= 2
    U = tuple(g[..., 0] for g in G)
    for _ in range(log_s):
        U = jacobian_double_plain(U)
    W = jacobian_add_plain(tuple(t[..., 0] for t in tot), U)
    acc = tuple(x[:, n_win - 1:] for x in W)
    for w in range(n_win - 2, -1, -1):
        for _ in range(c):
            acc = jacobian_double_plain(acc)
        acc = jacobian_add_plain(acc, tuple(x[:, w:w + 1] for x in W))
    return acc


def bucket_reduce(B: Point3, c: int) -> Point3:
    """sum_w 2^(c w) sum_k k B_{w,k} from Pippenger's bucket sums B,
    (8, n_win 2^c) Jacobian (window-major) -> (8, 1): K3's
    "bucket_reduce" form (one launch: a block a window, the last block
    combines) on CUDA tensors, `bucket_reduce_plain` on CPU tensors."""
    dev = _check("bucket_reduce", B)
    nb = B[0].shape[-1]
    n_win = nb >> c
    if B[0].dim() != 2 or n_win < 1 or n_win << c != nb or not 1 <= c <= 24:
        raise ValueError(f"bucket_reduce: buckets {tuple(B[0].shape)} at "
                         f"c = {c}")
    if dev.type == "cpu":
        return bucket_reduce_plain(B, c)
    B = tuple(x.contiguous() for x in B)
    work = reduce_buffers(n_win, dev)
    _reduce_k3(B, c, *work)
    return work[1]


def reduce_buffers(n_win: int, dev) -> Tuple[Point3, Point3, torch.Tensor]:
    """K3 bucket_reduce's buffers: the windows' sums W (8, n_win), the
    result (8, 1) and the last block's ticket counter (zeroed)."""
    W = tuple(torch.empty((N_LIMBS, n_win), dtype=_I32, device=dev)
              for _ in range(3))
    out = tuple(torch.empty((N_LIMBS, 1), dtype=_I32, device=dev)
                for _ in range(3))
    return W, out, torch.zeros(1, dtype=_I32, device=dev)


def _reduce_k3(B: Point3, c: int, W: Point3, out: Point3,
               counter: torch.Tensor) -> None:
    """The bucket_reduce launch alone, over contiguous buckets B and the
    buffers of `reduce_buffers` (its counter zeroed)."""
    dev = B[0].device
    m, log_s = _reduce_shape(c)
    L = _ReduceLaunch()
    L.bx, L.by, L.bz = (x.data_ptr() for x in B)
    L.wx, L.wy, L.wz = (x.data_ptr() for x in W)
    L.ox, L.oy, L.oz = (x.data_ptr() for x in out)
    L.counter = counter.data_ptr()
    L.n_win, L.c, L.m, L.log_s = W[0].shape[1], c, m, log_s
    with torch.cuda.device(dev):
        t = _stamp()
        _done("bucket_reduce", _lib().jolt_k3_bucket_reduce(
            ctypes.byref(L), _stream(dev)), (L.n_win, c), t)


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
    flag = ops.upload(heads.reshape(-1), X.device).bool()
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
    (a tensor, or a numpy array, uploaded once to the points' device).
    The JAX package's dispatch: binary scalars take the subset
    sum, full-width ones from 512 lanes Pippenger (whose bases must be
    affine), the rest per-lane double-and-add and one tree sum."""
    if scalars.ndim == 1:
        scalars = scalars[None, :]
    if bits == 1:
        return msm_binary(P, _on(scalars[0], P) & 1)
    if bits > 32 and scalars.shape[-1] >= 512:
        return msm_pippenger(P, scalars, bits)
    return tree_sum(batch_scalar_mul(P, _on(scalars, P).to(_I32), bits))


def msm_rows(P: Point3, scalar_words: torch.Tensor, bits: int) -> Point3:
    """B MSMs of N lanes at once: bases P that broadcast to (8, B, N) and
    (W, B, N) scalar words -> the B sums, (8, B).  Each row as `msm` sums
    it at bits > 1: from 512 lanes at full width Pippenger (one call a
    row, whose bases must be affine), else one `batch_scalar_mul` over
    every row's lanes and one tree sum of all rows together."""
    words = _on(scalar_words, P)
    n_rows, n = words.shape[1:]
    P = tuple(c.expand(N_LIMBS, n_rows, n) for c in P)
    if bits > 32 and n >= 512:
        sums = [msm_pippenger(tuple(c[:, i] for c in P), words[:, i], bits)
                for i in range(n_rows)]
        return tuple(torch.cat([s[k] for s in sums], 1) for k in range(3))
    prods = batch_scalar_mul(tuple(c.reshape(N_LIMBS, -1) for c in P),
                             words.reshape(words.shape[0], -1).to(_I32),
                             bits)
    return tuple(c[..., 0] for c in tree_sum(
        tuple(c.reshape(N_LIMBS, n_rows, n) for c in prods)))


def _on(words, P: Point3) -> torch.Tensor:
    """Scalar words as a tensor on the points' device."""
    if isinstance(words, np.ndarray):
        words = np.array(words, dtype=np.uint32).view(np.int32)
    return ops.upload(words, P[0].device)


# ---------------------------------------------------------------------------
# Pippenger (windowed bucket) MSM, on the points' device from the scalar
# words to the final point: each window's c-bit digits by shifts and masks,
# a stable sort of (window, digit) keys and the buckets' offsets (torch
# plumbing), the buckets by `bucket_sum` (segments = (window, digit), digit
# 0 left empty), then `bucket_reduce`.  Windows are sorted together as far
# as _MSM_ENTRIES (lane, window) entries go, so the memory beyond the bases
# is O(N): the bases' point-major copy (64 bytes a lane) and ~30 bytes an
# entry of a window batch (digits, keys, the sort's values and
# permutation, the lane list).
# ---------------------------------------------------------------------------

_MSM_ENTRIES = 1 << 25


# (ceil log2 N from which, c): the fastest window width of the whole MSM
# from device words at 2^9 .. 2^22 lanes and c = 4 .. 16, timed by CUDA
# events on an H100 (`chip_smoke.py` phase 8b's sweep, PERF.md section 6);
# below 2^9 lanes as at 2^9, above 2^22 as at 2^22 (not measured there)
_WINDOW_BITS = ((22, 15), (21, 13), (20, 12), (17, 10), (0, 8))


def window_bits(n: int) -> int:
    """Pippenger's window width for n lanes (`_WINDOW_BITS`)."""
    log_n = max(n - 1, 1).bit_length()
    return next(c for lo, c in _WINDOW_BITS if log_n >= lo)


def check_affine(P: Point3, what: str) -> None:
    """Raise unless every lane's Z is R mod q or 0, the layout that
    `bucket_sum` and `msm_pippenger` take their bases in (one sync)."""
    one = _one_like(P[2])
    z = P[2].reshape(N_LIMBS, -1)
    if not bool(((z == one).all(0) | (z == 0).all(0)).all()):
        raise ValueError(f"{what}: the points are not affine (Z must be "
                         "R mod q, or 0 at infinity)")


def window_segments(words: torch.Tensor, w0: int, nb: int, c: int,
                    bits: int):
    """Windows w0 .. w0 + nb - 1's buckets as `bucket_sum` segments of the
    (W, N) int32 scalar words: the lanes sorted by (window, digit) with a
    stable sort, and each bucket's (start, end), digit 0's left empty."""
    dev = words.device
    n_words, n = words.shape
    win = torch.arange(w0, w0 + nb, device=dev)
    lo = win * c
    off = (lo % 32)[:, None]
    width = torch.clamp(bits - lo, max=c)[:, None]
    w_lo = lo // 32
    hi_ok = (w_lo + 1 < n_words)[:, None]
    low = words.index_select(0, w_lo).to(torch.int64) & 0xFFFFFFFF
    high = words.index_select(0, torch.clamp(w_lo + 1, max=n_words - 1)) \
        .to(torch.int64) & 0xFFFFFFFF
    dig = ((low >> off) | torch.where(hi_ok, high << (32 - off), 0)) \
        & (torch.bitwise_left_shift(torch.ones_like(width), width) - 1)
    del low, high
    key = (dig + ((win - w0) << c)[:, None]).reshape(-1).to(_I32)
    del dig
    perm = torch.sort(key, stable=True)[1]
    lanes = (perm % n).to(_I32)
    del perm
    counts = torch.bincount(key, minlength=nb << c)
    starts = torch.cumsum(counts, 0) - counts
    counts.view(nb, 1 << c)[:, 0] = 0           # digit 0 adds nothing
    return lanes, starts, starts + counts


def msm_pippenger(P: Point3, scalar_words, bits: int,
                  c: Optional[int] = None) -> Point3:
    """Full-width MSM by windowed buckets -> a batch of one point.
    `scalar_words` is (W, N) little-endian u32 words (a tensor, or numpy,
    uploaded once); c defaults to `window_bits(N)`.  The bases are affine
    (`check_affine`), as a KZG setup's powers and Dory's Gamma1 are."""
    words = _on(scalar_words, P)
    if words.dim() == 1:
        words = words[None]
    n = words.shape[1]
    if not 0 < bits <= 32 * words.shape[0]:
        raise ValueError(f"msm: {bits} bits from {words.shape[0]} words")
    c = window_bits(n) if c is None else c
    n_win = (bits + c - 1) // c
    P = tuple(x.expand(N_LIMBS, n) for x in P)
    _check("bucket_sum", P)
    plain = P[0].device.type == "cpu"
    src = _bucket_source(P, plain)             # once for every window
    per = max(1, min(n_win, _MSM_ENTRIES // max(n, 1)))
    parts = [_bucket_sum(src, *window_segments(words, w0,
                                               min(per, n_win - w0), c,
                                               bits), plain)
             for w0 in range(0, n_win, per)]
    B = tuple(torch.cat([p[i] for p in parts], 1) for i in range(3))
    return bucket_reduce(B, c)


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
        if z == 1:                      # affine (`normalize`'s lanes)
            out.append((x, y))
            continue
        zinv = pow(z, -1, q)
        z2 = zinv * zinv % q
        out.append((x * z2 % q, y * z2 * zinv % q))
    return out
