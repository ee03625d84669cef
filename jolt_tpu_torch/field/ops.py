"""BN254 Fr arithmetic on torch tensors of 32-bit limbs.

The port's own field tier (the JAX package keeps 20 x 13-bit limbs because
the TPU has no widening multiply; Hopper has 32x32->64 integer multiplies):

  * 8 limbs x 32 bits, little-endian, stored as ``torch.int32`` holding the
    uint32 bit pattern, limbs-first ``(8, *batch)`` so every limb plane is
    contiguous and neighbouring CUDA threads load neighbouring words;
  * Montgomery form with R = 2^256: a field element x is stored as
    x * R mod p, normalized (< p);
  * ops broadcast over the batch dims, so a scalar is shape ``(8, 1)``.

Compare with the JAX package only as canonical ints (`unpack_ints`,
`interop.from_jax_limbs`): the two Montgomery forms differ (R = 2^260 there).

Every op on the limbs is one of K1's wrappers (`kernels`), exported here
as the field ops: on a CUDA tensor that is the hand-written kernel
(``csrc/mont_mul.cu``) in one of its forms, one launch and no torch op on
the limbs; on a CPU tensor its plain version.  An int operand (a challenge, a
constant) is a canonical field element passed to the kernel by value.  No
lane threshold: the reference's 2048-lane / 128-lane rule sizes Pallas
blocks on the TPU, while one launch of K1 costs less on the card than the
~10-150 tensor ops of a plain version at any size.

Overflow bounds of the plain path (int64 working words):
  * add / sub / neg: limbwise sums of two 32-bit limbs plus a carry (< 2^33)
    or differences with a borrow (> -2^33);
  * `mont_mul_plain` (kernels.py): 16-bit sub-limbs, schoolbook columns
    < 16 * (2^16-1)^2 < 2^36, plus reduction terms and carries < 2^38;
  * `sum_mod` / `reduce_cols`: each 32-bit limb plane sums exactly in int64
    for up to 2^31 terms (< 2^63); the carry-out h above 2^256 is < 2^32
    and folds back as h * 2^256 mod p.  Sums are exact mod p and
    order-free, so no lazy chunking like the reference's 2^18-term bound
    (which exists only because of 13-bit limbs) is needed.

Under a cycle mesh (`parallel/mesh.py`) field tensors are DTensors:
`from_words` places them, K1's wrappers take them by their rule
(`kernels._on_mesh`), limb-plane sums over a sharded axis are `Partial`
and `reduce_cols` all-reduces them exactly before mod p (`sum_mod`,
`index_add_planes`, `scatter_add_planes`), a pass's pairs keep the shard
(`pair_halves`), and `unsharded`, `whole`, `index_copy` and `host` are the
explicit gathers where DTensor cannot place an op (`maybe_shard` gives a
gathered table its blocks back).
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import numpy as np
import torch

from ..parallel.mesh import active_mesh, maybe_shard
from ..utils import profiling
from . import kernels
from .kernels import (MASK32, N_LIMBS, P, R, R_MOD_P, is_dtensor,
                      pair_halves, u64_words)

R_INV = pow(R, -1, P)
_I32 = torch.int32


# ---------------------------------------------------------------------------
# K1's forms: add / sub / neg / mont_mul / bind / evals / reduce_cols
# ---------------------------------------------------------------------------

# K1's wrappers are the field ops (the kernel on a CUDA tensor, the plain
# version on a CPU tensor); callers outside `field` take them from here.
add = kernels.add
sub = kernels.sub
mont_mul = kernels.mont_mul
bind = kernels.bind
evals = kernels.evals
reduce_cols = kernels.reduce


def neg(a: torch.Tensor) -> torch.Tensor:
    return sub(0, a)


def mont_sqr(a: torch.Tensor) -> torch.Tensor:
    return mont_mul(a, a)


@functools.lru_cache(maxsize=1024)
def _replicated(x: int, device: torch.device, nbatch: int, mesh):
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(kernels._scalar(x, device, nbatch), mesh,
                              [Replicate()], run_check=False)


def _scalar(x: int, device, nbatch: int) -> torch.Tensor:
    """A canonical int as Montgomery limbs (8, 1, .., 1), uploaded once per
    (value, device) and, under a cycle mesh, once per mesh as a
    `Replicate` DTensor (the JAX package keys its scalar cache on the
    mesh too)."""
    mesh = active_mesh()
    if mesh is None:
        return kernels._scalar(x, device, nbatch)
    return _replicated(int(x), torch.device(device), nbatch, mesh)


def const_mont(c: int, batch_shape=(), device="cuda") -> torch.Tensor:
    """Constant c in Montgomery form, broadcastable over `batch_shape`,
    uploaded once per (value, device)."""
    return _scalar(c, device, max(len(batch_shape), 1))


def zeros(batch_shape, device="cuda") -> torch.Tensor:
    """The field zero over `batch_shape`: (8, *batch_shape)."""
    return torch.zeros((N_LIMBS,) + tuple(batch_shape), dtype=_I32,
                       device=device)


def ones(batch_shape, device="cuda") -> torch.Tensor:
    """The field one (Montgomery form) broadcast over `batch_shape`, a
    read-only expanded view: (8, *batch_shape)."""
    one = _scalar(1, device, len(batch_shape))
    return one.expand((N_LIMBS,) + tuple(batch_shape))


def resolve_device(device) -> torch.device:
    """The device a caller asked for; a CUDA device must exist (no silent
    fall-back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available (pass device='cpu' to run on the CPU)")
    return device


# ---------------------------------------------------------------------------
# conversions
# ---------------------------------------------------------------------------

def from_words(words: torch.Tensor) -> torch.Tensor:
    """Plain little-endian 32-bit words (k <= 8, *batch) of a value < p ->
    Montgomery form: one mont_mul by R^2 (the Montgomery words of the
    canonical scalar R mod p).  Under a cycle mesh this is where field
    tensors are placed (`maybe_shard`): the words are split first, so each
    rank converts only its own block."""
    k = words.shape[0]
    plain = torch.zeros((N_LIMBS,) + tuple(words.shape[1:]), dtype=_I32,
                        device=words.device)
    plain[:k] = words.to(_I32)
    return mont_mul(maybe_shard(plain), R_MOD_P)


def from_u64(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Unsigned 64-bit values given as two 32-bit words -> Montgomery form."""
    return from_words(torch.stack([lo.to(_I32), hi.to(_I32)]))


def from_u32(x: torch.Tensor) -> torch.Tensor:
    return from_words(x.to(_I32)[None])


def from_i64(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Signed 64-bit values (two's complement, as two 32-bit words) ->
    Montgomery form: the magnitude's `from_u64`, negated where the sign bit
    is set."""
    lo64, hi64 = u64_words(lo), u64_words(hi)
    pos = from_u64(lo64, hi64)
    sign = (hi64 >> 31).bool()
    nlo = (~lo64 + 1) & MASK32
    nhi = (~hi64 + (nlo == 0).to(torch.int64)) & MASK32
    return select(sign, neg(from_u64(nlo, nhi)), pos)


def to_canonical(a: torch.Tensor) -> torch.Tensor:
    """Montgomery -> canonical limbs (x mod p): mont_mul by plain 1 (the
    Montgomery words of the canonical scalar R^-1)."""
    return mont_mul(a, R_INV)


# ---------------------------------------------------------------------------
# equality / selection
# ---------------------------------------------------------------------------

def eq_mask(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Boolean mask over the batch dims: a == b (both normalized)."""
    return torch.all(a == b, dim=0)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return torch.all(a == 0, dim=0)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """Elementwise field select: mask ? a : b (mask has the batch shape)."""
    return torch.where(mask[None], a, b)


# ---------------------------------------------------------------------------
# pow / inverse (every product one K1 launch on the card)
# ---------------------------------------------------------------------------

def pow_const(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a host-known exponent e >= 0: square-and-multiply from the
    low bit, the multiply only at the exponent's set bits."""
    acc = ones(a.shape[1:], a.device).contiguous()
    base = a
    for i in range(max(e.bit_length(), 1)):
        if (e >> i) & 1:
            acc = mont_mul(acc, base)
        if i + 1 < e.bit_length():
            base = mont_mul(base, base)
    return acc


def inv(a: torch.Tensor) -> torch.Tensor:
    """Inverse per element by Fermat, a^(p-2); inv(0) = 0."""
    return pow_const(a, P - 2)


def _scan_mul(a: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products over the last axis: a log-step scan, one
    product a step over the lanes' two overlapping views."""
    n = a.shape[-1]
    d = 1
    while d < n:
        a = torch.cat([a[..., :d], mont_mul(a[..., :-d], a[..., d:])], -1)
        d *= 2
    return a


def batch_inverse(a: torch.Tensor) -> torch.Tensor:
    """Inverse of every element over the last axis by prefix products:
    log-step scans forward and backward and one Fermat inverse of the
    total; zeros map to zero."""
    zmask = is_zero(a)
    a_safe = select(zmask, ones(a.shape[1:], a.device), a)
    prefix = _scan_mul(a_safe)
    total_inv = inv(prefix[..., -1:])
    suffix = _scan_mul(a_safe.flip(-1)).flip(-1)
    one = ones(a.shape[1:-1] + (1,), a.device)
    after = torch.cat([suffix[..., 1:], one], -1)     # prod of a[j], j > i
    before = torch.cat([one, prefix[..., :-1]], -1)   # prod of a[j], j < i
    out = mont_mul(mont_mul(after, total_inv), before)
    return select(zmask, torch.zeros_like(out), out)


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def sum_mod(a: torch.Tensor, scale=None) -> torch.Tensor:
    """Sum field elements over the LAST axis -> shape (..., 1), times
    `scale` if given."""
    if a.shape[-1] >= 1 << 31:
        raise ValueError("sum_mod: more than 2^31 terms overflow int64 limbs")
    return reduce_cols(u64_words(a).sum(dim=-1, keepdim=True), scale)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inner product over the last axis: sum_i a_i * b_i -> (..., 1)."""
    return sum_mod(mont_mul(a, b))


def segment_sum_mod(a: torch.Tensor, ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Segment sum over the LAST axis: out[..., s] = sum_{i: ids[i]=s}
    a[..., i] -> (..., num_segments), exact mod p and order-free.

    Each 32-bit limb plane sums exactly in int64 by `index_add_` (integer
    atomics on the card: deterministic), then one `reduce_cols` (K1's
    reduce form on the card) finishes mod p; its contract bounds a segment
    at 2^31 terms, which the whole axis stays under."""
    if a.shape[-1] >= 1 << 31:
        raise ValueError("segment_sum_mod: more than 2^31 terms overflow "
                         "int64 limbs")
    return reduce_cols(index_add_planes(u64_words(a), a.dim() - 1, ids,
                                        num_segments))


def index_add_planes(src: torch.Tensor, dim: int, ids: torch.Tensor,
                     n: int, into=None) -> torch.Tensor:
    """Exact int64 limb planes: zeros of src's shape with `n` along `dim`
    (or `into`, planes an earlier call returned, added to in place),
    `index_add_`-ed by src at the 1-D `ids` along `dim`."""
    return _planes(src, dim, ids, n, scatter=False, into=into)


def scatter_add_planes(src: torch.Tensor, dim: int, index: torch.Tensor,
                       n: int) -> torch.Tensor:
    """Exact int64 limb planes: zeros of src's shape with `n` along `dim`,
    `scatter_add_`-ed by src at `index` (src's shape) along `dim`."""
    return _planes(src, dim, index, n, scatter=True)


def _planes(src, dim: int, ids, n: int, scatter: bool, into=None):
    """`index_add_` and `scatter_add_` have no DTensor rule, so for a
    DTensor src each rank adds its own shard, with its slice of the
    indices.  Sharded on `dim`, the planes are then `Partial`, and
    `reduce_cols` all-reduces them exactly (each plane a sum of < 2^31
    words of 32 bits, < 2^63 over all ranks); sharded elsewhere they keep
    src's shard."""
    dim %= src.dim()
    if not is_dtensor(src):
        cols = into if into is not None else torch.zeros(
            src.shape[:dim] + (n,) + src.shape[dim + 1:], dtype=torch.int64,
            device=src.device)
        add = cols.scatter_add_ if scatter else cols.index_add_
        return add(dim, upload(ids, src.device), src)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh, p = src.device_mesh, src.placements[0]
    if isinstance(p, Partial):
        src, p = src.redistribute(mesh, [Replicate()]), Replicate()
    on_dim = isinstance(p, Shard) and p.dim == dim
    ids_pl = p if scatter else Shard(0) if on_dim else Replicate()
    ids = ids.full_tensor() if isinstance(ids, DTensor) else ids
    ids = DTensor.from_local(ids, mesh, [Replicate()], run_check=False
                             ).redistribute(mesh, [ids_pl]).to_local()
    out_pl = Partial() if on_dim else p
    if into is not None and tuple(into.placements) != (out_pl,):
        raise ValueError(f"index_add_planes: into is {into.placements}, "
                         f"the planes {out_pl}")
    return DTensor.from_local(
        _planes(src.to_local(), dim, ids, n, scatter,
                None if into is None else into.to_local()), mesh,
        [out_pl], run_check=False)


# ---------------------------------------------------------------------------
# host <-> device conversion of Python ints
# ---------------------------------------------------------------------------

def words_of_ints(vals) -> np.ndarray:
    """Canonical ints -> (8, n) uint32 words (host)."""
    n = len(vals)
    buf = b"".join((int(v) % P).to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u4").reshape(n, N_LIMBS).T


def pack_ints(vals: Sequence[int], device="cuda") -> torch.Tensor:
    """Python ints -> Montgomery limbs (8, len(vals)).  A single scalar
    converts on the host; a list ships canonical words and multiplies by
    R^2 on the device."""
    if len(vals) == 1:
        return _scalar(int(vals[0]), device, 1)
    return from_words(upload(words_of_ints(vals).astype(np.int32), device))


def pack_ints_host(vals: Sequence[int], device="cuda") -> torch.Tensor:
    """Python ints -> Montgomery limbs (8, len(vals)), converted on the
    host: one upload and no launch, for the few constants of a round."""
    words = words_of_ints([int(v) % P * R % P for v in vals])
    return upload(words.astype(np.int32), device)


def np_unpack_ints(arr: np.ndarray) -> List[int]:
    """(8, ...) int32/uint32 Montgomery words (host) -> canonical ints."""
    flat = np.ascontiguousarray(
        arr.reshape(N_LIMBS, -1).astype(np.uint32).T)
    raw = flat.astype("<u4").tobytes()
    return [int.from_bytes(raw[32 * i:32 * i + 32], "little") * R_INV % P
            for i in range(flat.shape[0])]


def unsharded(a: torch.Tensor) -> torch.Tensor:
    """`a` with its last axis whole on every rank: a DTensor sharded on it
    is redistributed to `Replicate` (one all-gather), anything else is
    returned as it is.  Called before a gather by a schedule's indices,
    which reach across the ranks' blocks (`maybe_shard` gives the
    gathered lanes their blocks back); a pass's pairs take
    `pair_halves`."""
    if is_dtensor(a):
        from torch.distributed.tensor import Replicate, Shard
        p = a.placements[0]
        if isinstance(p, Shard) and p.dim == a.dim() - 1:
            return a.redistribute(a.device_mesh, [Replicate()])
    return a


def index_copy(base: torch.Tensor, dim: int, index: torch.Tensor,
               vals: torch.Tensor) -> torch.Tensor:
    """`base.index_copy(dim, index, vals)`.  `index_copy` has no DTensor
    rule in every torch release, so on a mesh both tables are gathered
    (`Replicate`) and every rank writes the whole result."""
    mesh = next((x.device_mesh for x in (base, vals) if is_dtensor(x)),
                None)
    if mesh is None:
        return base.index_copy(dim, index, vals)
    from torch.distributed.tensor import DTensor, Replicate
    base, vals = (x.redistribute(mesh, [Replicate()]).to_local()
                  if isinstance(x, DTensor) else x for x in (base, vals))
    return DTensor.from_local(base.index_copy(dim, index, vals), mesh,
                              [Replicate()], run_check=False)


def whole(a: torch.Tensor) -> torch.Tensor:
    """A field tensor as a plain tensor holding all of it (a DTensor is
    all-gathered; a plain tensor is returned as it is): for writes into a
    plain buffer, which DTensor cannot place."""
    return a.full_tensor() if is_dtensor(a) else a


def host(a: torch.Tensor) -> np.ndarray:
    """A tensor's values on the host: a DTensor is gathered whole first
    (`full_tensor`, the same on every rank).  One of the two places the
    prove path copies between host and card (`upload` the other): counts
    `d2h` and `d2h_bytes` on the active profiler (`utils/profiling.py`),
    as the copy the card would make (on the CPU too)."""
    if is_dtensor(a) and a.dtype == _I32 and any(
            p.is_partial() for p in a.placements):
        raise TypeError("host: a Partial field tensor (limb sums are int64 "
                        "planes, reduced by reduce_cols)")
    out = whole(a).cpu().numpy()
    prof = profiling.active()
    prof.count("d2h")
    prof.count("d2h_bytes", out.nbytes)
    return out


def upload(x, device, dtype=None) -> torch.Tensor:
    """`x` on `device`, of `dtype` when given: host data (a numpy array, a
    list of ints, default int64, or a CPU tensor) is cast on the host and
    copied; a tensor already on a card is only moved or cast.  The other
    place the prove path copies between host and card (`host`): host data
    counts `h2d` and `h2d_bytes` on the active profiler, as the copy the
    card would make (on the CPU too)."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    elif not isinstance(x, torch.Tensor):
        x = torch.tensor(x, dtype=dtype or torch.int64)
    elif x.device.type != "cpu":
        return x.to(device=device, dtype=dtype)
    if dtype is not None and x.dtype != dtype:
        x = x.to(dtype)
    prof = profiling.active()
    prof.count("h2d")
    prof.count("h2d_bytes", x.numel() * x.element_size())
    return x.to(device)


def unpack_ints(a: torch.Tensor) -> List[int]:
    """Montgomery limbs (8, N) -> list of canonical Python ints."""
    return np_unpack_ints(host(a))
