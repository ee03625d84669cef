"""The Fiat-Shamir transcript on the device: one sumcheck round's tail.

Torch counterpart of the JAX package's `transcript/device.py` and of the
round tail of its scan tier (`sumcheck/scan.py`, the body after the
instances' messages).  Every absorb and squeeze of the host transcript
(`transcript/blake2b.py`) is ONE Blake2b-256 compression of

    state (32 B) || 28 zero bytes || n_rounds (big-endian u32) || payload

(96 bytes with a 32-byte payload, 64 for a squeeze: one final block), so a
round of a batched sumcheck -- absorb `label_with_len("sumcheck_poly", n)`,
absorb n coefficients as 32 big-endian canonical bytes each, squeeze the
challenge -- is 2 + n compressions.

`round_tail` is that round's tail, from the instances' message evals to the
next challenge, on a stage's device buffers (`StageBuffers`):

  1. each active instance's coefficients from its evals at X in {0, 2, ..,
     d} and its claim s(0) + s(1) (degree 1-3); an inactive instance sends
     the constant claim/2;
  2. their random linear combination with the batching coefficients,
     compressed (the linear coefficient dropped);
  3. the transcript: the label, each compressed coefficient, the squeeze,
     and `challenge_scalar_optimized` (the low 125 bits of the squeeze's
     first 16 bytes read little-endian) in Montgomery form;
  4. each instance's claim at the challenge (Horner);
  5. the compressed coefficients and the challenge appended to the stage's
     buffers, the state and n_rounds updated in place.

On a CUDA buffer it is one launch of K4 (`csrc/transcript.cu`); on a CPU
buffer its plain version, `round_tail_plain`, which is torch code over K1's
plain versions (`field/kernels.py`) and `compress`, and which also runs on
CUDA tensors (as `chip_smoke.py` holds K4 against it).

Layouts.  A stage's transcript state is 9 int32 words: the 32-byte state
read as little-endian 32-bit words, then n_rounds.  In the plain version a
Blake2b 64-bit word is a pair (lo, hi) of int64 values in [0, 2^32), the
JAX package's (lo, hi) uint32 pairs: sums carry from lo into hi by hand and
every shift stays below 2^63, so no signed overflow and no arithmetic
right shift of a negative value can occur.  Field elements are the port's
Montgomery limbs (8 x 32 bits, R = 2^256).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..field import kernels
from ..field.kernels import (MASK32, N_LIMBS, P, R, R_MOD_P, _pack_limbs,
                             _scalar, add_plain, mont_mul_plain, reduce_plain,
                             sub_plain, u64_words)
from ..field.ops import upload, words_of_ints

INV2 = pow(2, -1, P)
INV6 = pow(6, -1, P)

# Blake2b's IV, and the chaining value of Blake2b-256 (digest length 32,
# no key, fanout 1, depth 1: parameter word 0x01010020)
IV = (0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B,
      0xA54FF53A5F1D36F1, 0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
      0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179)
H_INIT = (IV[0] ^ 0x01010020,) + IV[1:]
_SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
)
SIGMA = _SIGMA + _SIGMA[:2]                     # 12 rounds
# the G function's (a, b, c, d) over the columns, then the diagonals
_COLS = ((0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15))
_DIAG = ((0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14))
SUMCHECK_POLY = b"sumcheck_poly"


# ---------------------------------------------------------------------------
# host helpers
# ---------------------------------------------------------------------------

def state_to_words(state32: bytes) -> np.ndarray:
    """A 32-byte transcript state -> (4, 2) uint32: its u64 little-endian
    words as (lo, hi)."""
    return np.frombuffer(state32, dtype="<u4").reshape(4, 2).astype(
        np.uint32)


def words_to_state(words) -> bytes:
    """(n, 2) (lo, hi) words, or 2n little-endian 32-bit words -> bytes."""
    return np.asarray(words).reshape(-1).astype("<u4").tobytes()


def label_payload_words(label: bytes, length: int) -> np.ndarray:
    """The absorb payload of `raw_append_label_with_len(label, length)`
    (label right-padded to 24 bytes, then the length as a big-endian u64)
    as (4, 2) (lo, hi) uint32 words."""
    if len(label) > 24:
        raise ValueError(f"label {label!r} longer than 24 bytes")
    packed = label + b"\x00" * (24 - len(label)) + length.to_bytes(8, "big")
    return np.frombuffer(packed, dtype="<u4").reshape(4, 2).astype(
        np.uint32)


# ---------------------------------------------------------------------------
# plain version: one Blake2b-256 compression on (lo, hi) int64 halves
# ---------------------------------------------------------------------------

def _words64(values, device) -> torch.Tensor:
    """Python u64 ints -> (n, 2) int64 (lo, hi)."""
    return torch.tensor([[v & MASK32, v >> 32] for v in values],
                        dtype=torch.int64, device=device)


@functools.lru_cache(maxsize=8)
def _consts(device: torch.device):
    """The IV, H_INIT, the G lanes (a, b, c, d of the columns, then of the
    diagonals) and each round's message schedule on `device`, made once."""
    def idx(v):
        return torch.tensor(v, dtype=torch.int64, device=device)
    lanes = [idx(q) for q in zip(*_COLS)] + [idx(q) for q in zip(*_DIAG)]
    sched = [(idx(s[0:8:2]), idx(s[1:8:2]), idx(s[8:16:2]), idx(s[9:16:2]))
             for s in SIGMA]
    return _words64(IV, device), _words64(H_INIT, device), lanes, sched


def _add(alo, ahi, blo, bhi):
    lo = alo + blo
    return lo & MASK32, (ahi + bhi + (lo >> 32)) & MASK32


def _rotr(lo, hi, n: int):
    """Rotate right by n (0 < n < 64, n != 32 handled as a swap)."""
    if n == 32:
        return hi, lo
    if n > 32:
        lo, hi, n = hi, lo, n - 32
    return (((lo >> n) | (hi << (32 - n))) & MASK32,
            ((hi >> n) | (lo << (32 - n))) & MASK32)


def compress(h: torch.Tensor, m: torch.Tensor, t: int) -> torch.Tensor:
    """One Blake2b compression of the final block: chaining value h (8, 2)
    and message block m (16, 2), both (lo, hi) int64 words, t the message's
    byte length (< 2^32).  Returns the new chaining value (8, 2).  The G
    function runs on the four columns, then the four diagonals, at once."""
    iv, _, lanes, sched = _consts(h.device)
    lo = torch.cat([h[:, 0], iv[:, 0]])
    hi = torch.cat([h[:, 1], iv[:, 1]])
    lo[12] ^= t
    lo[14] ^= MASK32
    hi[14] ^= MASK32
    mlo, mhi = m[:, 0], m[:, 1]
    for s in sched:
        for half in (0, 1):
            ia, ib, ic, id_ = lanes[4 * half:4 * half + 4]
            xs, ys = s[2 * half], s[2 * half + 1]
            al, ah, bl, bh = lo[ia], hi[ia], lo[ib], hi[ib]
            cl, ch, dl, dh = lo[ic], hi[ic], lo[id_], hi[id_]
            al, ah = _add(*_add(al, ah, bl, bh), mlo[xs], mhi[xs])
            dl, dh = _rotr(dl ^ al, dh ^ ah, 32)
            cl, ch = _add(cl, ch, dl, dh)
            bl, bh = _rotr(bl ^ cl, bh ^ ch, 24)
            al, ah = _add(*_add(al, ah, bl, bh), mlo[ys], mhi[ys])
            dl, dh = _rotr(dl ^ al, dh ^ ah, 16)
            cl, ch = _add(cl, ch, dl, dh)
            bl, bh = _rotr(bl ^ cl, bh ^ ch, 63)
            lo[ia], hi[ia], lo[ib], hi[ib] = al, ah, bl, bh
            lo[ic], hi[ic], lo[id_], hi[id_] = cl, ch, dl, dh
    out_lo = h[:, 0] ^ lo[:8] ^ lo[8:]
    out_hi = h[:, 1] ^ hi[:8] ^ hi[8:]
    return torch.stack([out_lo, out_hi], dim=1)


def _bswap32(x: torch.Tensor) -> torch.Tensor:
    return (((x & 0xFF) << 24) | ((x & 0xFF00) << 8) | ((x >> 8) & 0xFF00)
            | (x >> 24))


def prefix_block(state: torch.Tensor, n_rounds: torch.Tensor) -> torch.Tensor:
    """The block state || 28 zero bytes || n_rounds (big-endian u32), the
    payload words 8..11 left zero: (16, 2) int64."""
    blk = torch.zeros((16, 2), dtype=torch.int64, device=state.device)
    blk[:4] = state
    blk[7, 1] = _bswap32(n_rounds & MASK32)
    return blk


def absorb32(state: torch.Tensor, n_rounds: torch.Tensor,
             payload: torch.Tensor):
    """Absorb a 32-byte payload ((4, 2) words): (new state (4, 2),
    n_rounds + 1)."""
    blk = prefix_block(state, n_rounds)
    blk[8:12] = payload
    return compress(_consts(state.device)[1], blk, 96)[:4], n_rounds + 1


def squeeze(state: torch.Tensor, n_rounds: torch.Tensor):
    """A challenge squeeze (no payload, 64 bytes): (new state, n_rounds +
    1); the new state is the squeeze's 32 bytes."""
    return (compress(_consts(state.device)[1], prefix_block(state, n_rounds),
                     64)[:4], n_rounds + 1)


def canonical_words_be(x_mont: torch.Tensor) -> torch.Tensor:
    """A Montgomery scalar (8, 1) -> the absorb payload of
    `raw_append_scalar`: its canonical value's 32 big-endian bytes as (4, 2)
    (lo, hi) int64 words."""
    one = torch.zeros((N_LIMBS, 1), dtype=torch.int32, device=x_mont.device)
    one[0] = 1                                  # the plain 1: x R^-1 = x
    canon = u64_words(mont_mul_plain(x_mont.reshape(N_LIMBS, 1), one))
    return _bswap32(canon.reshape(N_LIMBS).flip(0)).reshape(4, 2)


def challenge125_to_mont(digest: torch.Tensor) -> torch.Tensor:
    """A squeeze's state (4, 2) -> `challenge_scalar_optimized` (the first
    16 bytes read little-endian, the top 3 bits of the 128 cleared) in
    Montgomery form, (8, 1) int32."""
    raw = torch.zeros(N_LIMBS, dtype=torch.int64, device=digest.device)
    raw[:4] = digest[:2].reshape(4)
    raw[3] &= 0x1FFFFFFF
    # raw * (R^2 mod p) * R^-1 = raw R: `_scalar(R mod p)` is R^2 mod p
    return mont_mul_plain(_pack_limbs(raw).reshape(N_LIMBS, 1),
                          _scalar(R_MOD_P, digest.device, 1))


def coeffs_from_evals(evals: torch.Tensor, claim: torch.Tensor,
                      degree: int) -> List[torch.Tensor]:
    """A round polynomial's coefficients (degree + 1 Montgomery scalars (8,
    1)) from its evals (8, degree, 1) at X in {0, 2, .., degree} and the
    claim s(0) + s(1) (8, 1): `UniPoly.from_evals_and_hint` on K1's plain
    versions (the JAX package's `sumcheck/fused.py:_coeffs_from_evals`).
    For n polynomials at once: evals (8, degree, n), claims (8, n), and
    coefficients (8, n)."""
    e0 = evals[:, 0]
    e1 = sub_plain(claim, e0)
    if degree == 1:
        return [e0, sub_plain(e1, e0)]
    inv2 = _scalar(INV2, claim.device, 1)
    s = sub_plain(add_plain(e0, evals[:, 1]), add_plain(e1, e1))
    if degree == 2:
        c2 = mont_mul_plain(s, inv2)
        return [e0, sub_plain(sub_plain(e1, e0), c2), c2]
    if degree == 3:
        d12 = sub_plain(e1, evals[:, 1])
        t = add_plain(sub_plain(evals[:, 2], e0),
                      add_plain(d12, add_plain(d12, d12)))
        c3 = mont_mul_plain(t, _scalar(INV6, claim.device, 1))
        c2 = sub_plain(mont_mul_plain(s, inv2),
                       add_plain(c3, add_plain(c3, c3)))
        c1 = sub_plain(sub_plain(sub_plain(e1, e0), c2), c3)
        return [e0, c1, c2, c3]
    raise ValueError(f"round tail: degree {degree} (want 1, 2 or 3)")


def horner(coeffs: Sequence[torch.Tensor], r: torch.Tensor) -> torch.Tensor:
    """sum_k coeffs[k] r^k (Montgomery scalars)."""
    acc = coeffs[-1]
    for c in reversed(coeffs[:-1]):
        acc = add_plain(mont_mul_plain(acc, r), c)
    return acc


# ---------------------------------------------------------------------------
# a stage's device buffers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StageBuffers:
    """One stage's round-tail state on its device, views of one int32
    tensor `all` (uploaded once before the first round, fetched once after
    the last): `state` (9,) the transcript state and n_rounds; `claims`
    (instances, 8) and `coeffs` (instances, 8) each instance's claim and
    batching coefficient; `comp` (rounds, width, 8) each round's compressed
    coefficients; `r` (rounds, 8) each round's challenge.  All Montgomery
    limbs but the state.

    On a CUDA device also K4's part of the stage (up to K4's 64
    instances): `weights` (instances, 3, 8), each batching coefficient w,
    w/2 and w/6 as plain values (uploaded with `all`, outside it); `tail`,
    K4's launch record with everything that holds for the stage filled
    in; `degrees`, the instances' degrees that `tail` holds (set at the
    first round)."""

    all: torch.Tensor
    state: torch.Tensor
    claims: torch.Tensor
    coeffs: torch.Tensor
    comp: torch.Tensor
    r: torch.Tensor
    weights: Optional[torch.Tensor] = None
    tail: Optional[kernels.RoundTail] = None
    degrees: Optional[List[int]] = None

    @property
    def device(self) -> torch.device:
        return self.all.device

    def challenge(self, rnd: int) -> torch.Tensor:
        """Round `rnd`'s challenge as a device scalar (8, 1)."""
        return self.r[rnd].view(N_LIMBS, 1)


def k4_weights(coeffs: Sequence[int]) -> List[int]:
    """K4's forms of each batching coefficient w (canonical ints), three an
    instance: w, w/2 and w/6 as plain values.  A Montgomery product of x R
    by a plain value k is x k, canonical: so K4 gets each term of the
    batched polynomial as the canonical value the transcript absorbs, in
    one product."""
    out = []
    for w in coeffs:
        out += [w % P, w * INV2 % P, w * INV6 % P]
    return out


def _stage_record(bufs: StageBuffers) -> kernels.RoundTail:
    """K4's launch record for `bufs`, every field that holds for the stage
    filled in (the per-round fields -- evals, n_c, round -- and the
    degrees are left to `round_tail`)."""
    tail = kernels.RoundTail()
    tail.n_inst, tail.width = bufs.claims.shape[0], bufs.comp.shape[1]
    tail.state, tail.claims, tail.weights, tail.comp, tail.r = (
        t.data_ptr() for t in (bufs.state, bufs.claims, bufs.weights,
                               bufs.comp, bufs.r))
    for n_c in (1, 2, 3):
        tail.label[n_c - 1] = (ctypes.c_uint32 * N_LIMBS)(
            *label_payload_words(SUMCHECK_POLY, n_c).reshape(8).tolist())
    tail.inv2 = kernels._mont_words(INV2)
    tail.inv6 = kernels._mont_words(INV6)
    return tail


def stage_buffers(device, state32: bytes, n_rounds: int,
                  claims: Sequence[int], coeffs: Sequence[int], rounds: int,
                  width: int) -> StageBuffers:
    """A stage's buffers on `device`, from the host transcript's state and
    n_rounds, the instances' scaled input claims and batching coefficients
    (canonical ints), for `rounds` rounds of at most `width` compressed
    coefficients: one upload (on a CUDA device with K4's weights, and
    K4's record filled once for the stage)."""
    n = len(claims)
    k4 = torch.device(device).type == "cuda" and n <= kernels.K4_MAX_INSTANCES
    sizes = [9, 8 * n, 8 * n, 8 * rounds * width, 8 * rounds]
    total = sum(sizes)
    host = np.zeros(total + (8 * kernels.K4_WEIGHTS * n if k4 else 0),
                    dtype=np.uint32)
    host[:8] = state_to_words(state32).reshape(8)
    host[8] = n_rounds
    mont = [c % P * R % P for c in list(claims) + list(coeffs)]
    host[9:9 + 16 * n] = words_of_ints(mont).T.reshape(-1)
    if k4:
        host[total:] = words_of_ints(k4_weights(coeffs)).T.reshape(-1)
    flat = upload(host.view(np.int32), device)
    parts = torch.split(flat[:total], sizes)
    bufs = StageBuffers(flat[:total], parts[0], parts[1].view(n, 8),
                        parts[2].view(n, 8),
                        parts[3].view(rounds, width, 8),
                        parts[4].view(rounds, 8))
    if k4:
        bufs.weights = flat[total:].view(n, kernels.K4_WEIGHTS, 8)
        bufs.tail = _stage_record(bufs)
    return bufs


# ---------------------------------------------------------------------------
# the round tail: K4, or its plain version
# ---------------------------------------------------------------------------

def compressed_len(active: Sequence[bool], degrees: Sequence[int]) -> int:
    """The length of a round's compressed polynomial, as the host engine's
    `UniPoly.compress` gives it: the batched polynomial has as many
    coefficients as the longest instance polynomial of the round (d + 1 for
    an active instance, 1 for an inactive one), less the linear one."""
    n_coeff = max(d + 1 if a else 1 for a, d in zip(active, degrees))
    return max(1, n_coeff - 1)


def _check_round(evals, degrees, bufs: StageBuffers, rnd: int,
                 n_c: int) -> None:
    n = bufs.claims.shape[0]
    if len(evals) != n or len(degrees) != n:
        raise ValueError(f"round tail: {len(evals)} evals, {len(degrees)} "
                         f"degrees for {n} instances")
    if not 0 <= rnd < bufs.r.shape[0]:
        raise ValueError(f"round tail: round {rnd} of {bufs.r.shape[0]}")
    if not 1 <= n_c <= bufs.comp.shape[1]:
        raise ValueError(f"round tail: {n_c} compressed coefficients "
                         f"(buffer width {bufs.comp.shape[1]})")
    for e, d in zip(evals, degrees):
        if d not in (1, 2, 3):
            raise ValueError(f"round tail: degree {d} (want 1, 2 or 3)")
        if e is None:
            continue
        if e.dtype != torch.int32 or e.numel() != N_LIMBS * d \
                or e.shape[:2] != (N_LIMBS, d):
            raise ValueError(f"round tail: evals {tuple(e.shape)} "
                             f"{e.dtype} at degree {d} (want (8, {d}, 1) "
                             "int32)")
        if e.device != bufs.device:
            raise ValueError(f"round tail: evals on {e.device}, buffers on "
                             f"{bufs.device}")


def round_tail_plain(evals: Sequence[Optional[torch.Tensor]],
                     degrees: Sequence[int], bufs: StageBuffers, rnd: int,
                     n_c: int) -> None:
    """K4's function in plain torch, in place on `bufs` (see the module
    docstring): `evals[i]` is instance i's (8, d_i, 1) message evals, or
    None when it is inactive this round; `n_c` is the round's compressed
    length (`compressed_len`).  The instances' coefficients are worked
    together, those of one degree as one batch, into an (8, n, 4) table
    zero above each instance's degree: the batched sum and each claim's
    Horner step then run over the whole table (a zero leading coefficient
    leaves both unchanged)."""
    _check_round(evals, degrees, bufs, rnd, n_c)
    dev = bufs.device
    n = len(evals)
    claims = bufs.claims.T                                    # (8, n)
    table = torch.zeros((N_LIMBS, n, 4), dtype=torch.int32, device=dev)
    idle = [i for i, e in enumerate(evals) if e is None]
    if idle:
        table[:, idle, 0] = mont_mul_plain(claims[:, idle],
                                           _scalar(INV2, dev, 1))
    for d in sorted(set(degrees)):
        idx = [i for i, e in enumerate(evals) if e is not None
               and degrees[i] == d]
        if idx:
            ev = torch.cat([evals[i].reshape(N_LIMBS, d, 1) for i in idx],
                           dim=2)
            for k, c in enumerate(coeffs_from_evals(ev, claims[:, idx], d)):
                table[:, idx, k] = c
    terms = mont_mul_plain(table, bufs.coeffs.T[:, :, None])
    batched = reduce_plain(u64_words(terms).sum(dim=1))       # (8, 4)
    compressed = [batched[:, k:k + 1] for k in [0] + list(range(2, n_c + 1))]
    state = u64_words(bufs.state[:8]).view(4, 2)
    n_r = u64_words(bufs.state[8])
    state, n_r = absorb32(state, n_r, torch.from_numpy(label_payload_words(
        SUMCHECK_POLY, n_c).astype(np.int64)).to(dev))
    for c in compressed:
        state, n_r = absorb32(state, n_r, canonical_words_be(c))
    state, n_r = squeeze(state, n_r)
    r = challenge125_to_mont(state)
    for k, c in enumerate(compressed):
        bufs.comp[rnd, k] = c.view(N_LIMBS)
    bufs.r[rnd] = r.view(N_LIMBS)
    bufs.state[:8] = _pack_limbs(state.reshape(8))
    bufs.state[8] = _pack_limbs(n_r)
    bufs.claims[:] = horner(list(table.unbind(2)), r).T


def tail_record(evals: Sequence[Optional[torch.Tensor]],
                degrees: Sequence[int], bufs: StageBuffers, rnd: int,
                n_c: int) -> kernels.RoundTail:
    """K4's launch record for this round: the stage's record (`bufs.tail`)
    with this round's evals pointers (0 for an inactive instance), n_c and
    round written in, and the degrees at the stage's first round.  The
    caller has checked the round (`_check_round`); the evals must stay
    alive until the launch is enqueued."""
    tail = bufs.tail
    if tail is None:
        raise ValueError(f"round tail: {bufs.claims.shape[0]} instances on "
                         f"{bufs.device} (K4 takes at most "
                         f"{kernels.K4_MAX_INSTANCES}, on a CUDA device)")
    if bufs.degrees != degrees:
        bufs.degrees = list(degrees)
        for i, d in enumerate(degrees):
            tail.degree[i] = d
    ptrs = tail.evals
    for i, e in enumerate(evals):
        ptrs[i] = 0 if e is None else e.data_ptr()
    tail.n_c, tail.round = n_c, rnd
    return tail


def round_tail(evals: Sequence[Optional[torch.Tensor]],
               degrees: Sequence[int], bufs: StageBuffers, rnd: int,
               n_c: int) -> None:
    """One round's tail on `bufs` (`round_tail_plain` for its arguments):
    on CPU buffers the plain version; on CUDA buffers one launch of K4 on
    the card's current stream, which reads each instance's evals where they
    lie, never waits for the card, and raises if the launch fails."""
    if bufs.device.type == "cpu":
        round_tail_plain(evals, degrees, bufs, rnd, n_c)
        return
    _check_round(evals, degrees, bufs, rnd, n_c)
    evals = [e if e is None or e.is_contiguous() else e.contiguous()
             for e in evals]
    kernels.launch_round_tail(tail_record(evals, degrees, bufs, rnd, n_c),
                              bufs.device)
