"""Spartan outer sumcheck over the uniform RV64 R1CS, with univariate skip.

Torch counterpart of the JAX package's `relations/spartan_outer.py`.
Proves

    0 = sum_{k,j} weight(k) * eq(tau, j) * (Az(k,j)*Bz(k,j) - Cz(k,j))

over the constraint axis (k in [22]) and cycle axis (j in [T]), following
the reference's stage-1 shape (`zkvm/spartan/outer.rs`,
`subprotocols/univariate_skip.rs:29-131`): the 22 rows split into 2 groups
of 11, the slot-in-group index maps to the window {-5..5}, and the first
round sends ONE univariate

    s1(Y) = L(tau_high, Y) * t1(Y),        deg(s1) <= 30 (31 coeffs)

evaluated only at the 10 extrapolated targets (t1 vanishes on the window).
After the skip challenge r0 the remaining sumcheck runs 1 + log T rounds
(group bit, then cycle bits) over tensors of length 2T.

Device work: the 38 input columns lift to Montgomery form, and Az/Bz/Cz
row combos are sparse linear combinations of them, summed exactly in int64
limb planes (`ops.reduce_cols`).  Host work: transcript, Lagrange algebra,
verifier algebra.

Two tiers hold the columns, as in the JAX package, with the same bytes:
below `STREAM_THRESHOLD` cycles the whole Montgomery stack (8, 38, T)
lives on the device (32 B a value); from it on, the streaming tier keeps
only the witness words (4, 38, T) and the sign mask (38, T) there (17 B a
value, `StreamedColumns`) and lifts one `STREAM_CHUNK` of cycles at a time
for each of its three consumers: the uni-skip extended sums, the matrices
bound at Y=r0 and the 38 input openings.  `prove` / `prove_uniskip` force
a tier with the private `_stream_stage1`.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..field import FR, ops
from ..parallel.mesh import maybe_shard
from ..poly import dense, eq
from ..poly import lagrange as lag
from ..r1cs import constraints as C
from ..sumcheck.engine import OpeningAccumulator, SumcheckInstance
from ..sumcheck.fused import FusedInstance
from ..witness.r1cs_inputs import (NUM_VARS, SIGNED_COLS, R1CSCycleInputs,
                                   VAR_NAMES)

P = FR.modulus

# constraint-axis geometry: 22 rows = 2 groups x 11 slots
UNISKIP_DOMAIN = 11
UNISKIP_DEGREE = 10                      # extended targets outside the window
UNISKIP_NUM_COEFFS = 3 * UNISKIP_DEGREE + 1   # deg(L * t1) <= 30
NUM_GROUPS = 2
assert C.NUM_CONSTRAINTS == NUM_GROUPS * UNISKIP_DOMAIN

# elements of one batched combo product (terms x cycles): bounds the
# gathered-column and product scratch to 2^24 elements (~0.5 GB at 8 limbs)
_COMBO_CHUNK = 1 << 24

# the streaming tier: cycles lifted at a time (a power of two), and the
# trace length from which `prove` streams (the JAX package's `>=`)
STREAM_CHUNK = 1 << 16
STREAM_THRESHOLD = 1 << 19


def num_stage1_rounds(log_T: int) -> int:
    """Remaining-sumcheck rounds after the uni-skip first round."""
    return 1 + log_T


# ---------------------------------------------------------------------------
# device evaluation of sparse row combos
# ---------------------------------------------------------------------------

def _input_words(inputs: R1CSCycleInputs):
    """The 38 columns' u64 (lo, hi) witness words as (4, 38, T) int32 (lo's
    low and high word, then hi's) and the (38, T) mask of signed columns
    whose value is negative (the top bit of hi set)."""
    lo, hi = inputs.lo, inputs.hi
    signed_rows = np.zeros(NUM_VARS, bool)
    for v in SIGNED_COLS:
        signed_rows[v] = True
    sign_mask = signed_rows[:, None] & ((hi >> np.uint64(63)) == 1)
    words = np.stack([lo, hi]).view(np.uint32)              # (2, 38, 2T)
    words = words.reshape(2, NUM_VARS, -1, 2).transpose(0, 3, 1, 2)
    words = np.ascontiguousarray(words).reshape(4, NUM_VARS, -1)
    return words.view(np.int32), sign_mask


def _lift(words: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Witness words (4, 38, n) and sign mask (38, n) -> Montgomery limbs
    (8, 38, n).  The words are the low 128 bits of the plain value
    hi*2^64 + lo; one mont_mul by R^2 lifts them, and signed columns with
    the top bit of hi set subtract 2^128 (exact signed semantics, as the
    reference's `_lift_body`)."""
    val = ops.from_words(words)
    return ops.select(mask, ops.sub(val, 1 << 128), val)


def pack_input_columns(inputs: R1CSCycleInputs, device) -> torch.Tensor:
    """All 38 columns as one Montgomery limb tensor (8, 38, T): the
    materialized tier."""
    words, sign_mask = _input_words(inputs)
    return _lift(torch.from_numpy(words).to(device),
                 torch.from_numpy(sign_mask).to(device))


class StreamedColumns:
    """The streaming tier's handle on the 38 columns: the witness words
    (4, 38, T) int32 and the sign mask (38, T), uploaded once and kept on
    `device`; `chunks()` lifts `chunk` cycles at a time."""

    def __init__(self, inputs: R1CSCycleInputs, device, chunk: int):
        words, sign_mask = _input_words(inputs)
        self.words = torch.from_numpy(words).to(device)
        self.sign_mask = torch.from_numpy(sign_mask).to(device)
        self.device = self.words.device
        self.T = self.words.shape[-1]
        self.chunk = chunk

    def chunks(self):
        """(start, Montgomery limbs (8, 38, chunk)) for each chunk."""
        for s in range(0, self.T, self.chunk):
            e = s + self.chunk
            yield s, _lift(self.words[:, :, s:e], self.sign_mask[:, s:e])


def _chunks(cols):
    """(start, Montgomery limbs (8, 38, n)) over the columns: the
    materialized stack as one chunk, or a `StreamedColumns`' chunks."""
    return cols.chunks() if isinstance(cols, StreamedColumns) else [(0, cols)]


def stream_chunk(T: int, stream=None) -> int:
    """The streaming tier's chunk length for a trace of T cycles, or 0 for
    the materialized tier.  `stream` is `prove`'s `_stream_stage1`: None
    streams from `STREAM_THRESHOLD` cycles on, False never, True always at
    `STREAM_CHUNK`, and a power of two always at that chunk length (the
    tests' way to get several chunks from a small trace; the bytes do not
    depend on it)."""
    if stream is None:
        stream = T >= STREAM_THRESHOLD
    if stream is False:
        return 0
    chunk = STREAM_CHUNK if stream is True else int(stream)
    if chunk < 1 or chunk & (chunk - 1):
        raise ValueError(f"stream chunk {chunk} is not a power of two")
    return min(chunk, T)


def _combo_terms(w_rows: Sequence[Tuple[int, Dict[int, int]]], device):
    """Flatten [(out_idx, {var: coeff})] into device term tensors:
    (Montgomery weights (8, n_terms), var index, out index)."""
    Wv, vi, oi = [], [], []
    for out_idx, lc in w_rows:
        for v, coeff in sorted(lc.items()):
            if coeff % P == 0:
                continue
            Wv.append(coeff % P)
            vi.append(v)
            oi.append(out_idx)
    if not Wv:
        Wv, vi, oi = [0], [0], [0]
    return (ops.pack_ints(Wv, device),
            torch.tensor(vi, dtype=torch.int64, device=device),
            torch.tensor(oi, dtype=torch.int64, device=device))


def _combo(cols: torch.Tensor, terms, n_out: int) -> torch.Tensor:
    """out[:, o, :] = sum_{t: out_idx[t]=o} W[t] * cols[:, v_idx[t], :]

    Terms go in chunks: gather their columns, one mont_mul against the
    per-term weights (read in place with a zero cycle stride), and an exact
    int64 index_add into the output's limb planes; one reduction at the
    end (<= a few hundred terms per output, far below the 2^31 bound)."""
    W, v_idx, out_idx = terms
    T = cols.shape[-1]
    step = max(1, _COMBO_CHUNK // T)
    acc = None
    for s in range(0, W.shape[1], step):
        e = s + step
        prod = ops.mont_mul(W[:, s:e, None], cols[:, v_idx[s:e], :])
        acc = ops.index_add_planes(ops.u64_words(prod), 1, out_idx[s:e],
                                   n_out, acc)
    return ops.reduce_cols(acc)


def _combo_streamed(cols: StreamedColumns, terms_list, n_out: int):
    """`_combo` of each term set over the streamed columns, written chunk
    by chunk into preallocated (8, n_out, T) outputs; each chunk's columns
    are lifted once for every term set."""
    outs = [torch.empty((ops.N_LIMBS, n_out, cols.T), dtype=torch.int32,
                        device=cols.device) for _ in terms_list]
    for s, chunk in cols.chunks():
        for out, terms in zip(outs, terms_list):
            # under a cycle mesh the chunk's combos are gathered into the
            # plain outputs, of which each rank then keeps its block
            out[:, :, s:s + chunk.shape[-1]] = ops.whole(
                _combo(chunk, terms, n_out))
    return [maybe_shard(out) for out in outs]


def _group_w_rows(y_basis: Sequence[int]):
    """For Lagrange weights [l_i(y)] over the 11-slot window, build the
    per-(group, matrix) combined LCs  W[g][m] : var -> sum_i l_i * coeff."""
    rows = C.all_rows()
    W: List[List[Dict[int, int]]] = [[{}, {}, {}] for _ in range(NUM_GROUPS)]
    for k, (a, b, c) in enumerate(rows):
        g, slot = divmod(k, UNISKIP_DOMAIN)
        w = y_basis[slot]
        for m, lc in ((0, a), (1, b), (2, c)):
            d = W[g][m]
            for v, coeff in lc:
                d[v] = (d.get(v, 0) + w * coeff) % P
    return W


# ---------------------------------------------------------------------------
# uni-skip first round (prover)
# ---------------------------------------------------------------------------

def prove_uniskip(inputs: R1CSCycleInputs, tau: Sequence[int], transcript,
                  device="cuda", _stream_stage1=None):
    """Compute + absorb the uni-skip first-round polynomial; returns
    (cols_dev, s1_coeffs, r0, claim1, l_scale).

    tau = [tau_high, tau_g, *tau_cyc]  (1 + 1 + log_T challenges).
    `cols_dev` is the Montgomery stack (8, 38, T) on the materialized tier
    and a `StreamedColumns` on the streaming tier (`stream_chunk` reads
    `_stream_stage1`), where the extended sums accumulate chunk by chunk
    in int64 limb planes."""
    tau_high, tau_g, tau_cyc = tau[0], tau[1], list(tau[2:])
    E_cyc = eq.evals(tau_cyc, device)                    # (L, T)

    base = lag.symmetric_domain(UNISKIP_DOMAIN)
    targets = lag.uniskip_targets(UNISKIP_DOMAIN, UNISKIP_DEGREE)
    ext_tab = lag.extension_table(base, targets)         # [z][slot]

    # one flat term list over out = (z, g) for each matrix
    w_rows = {0: [], 1: [], 2: []}
    for zi in range(UNISKIP_DEGREE):
        Wz = _group_w_rows(ext_tab[zi])
        for g in range(NUM_GROUPS):
            for m in range(3):
                w_rows[m].append((zi * NUM_GROUPS + g, Wz[g][m]))
    n_out = UNISKIP_DEGREE * NUM_GROUPS
    terms = [_combo_terms(w_rows[m], device) for m in range(3)]
    chunk = stream_chunk(inputs.T, _stream_stage1)
    cols_dev = (StreamedColumns(inputs, device, chunk) if chunk
                else pack_input_columns(inputs, device))
    # sum_j E(j) (Az Bz - Cz)(out, j) as exact int64 limb planes: each
    # term's 32-bit limbs summed over at most 2^31 cycles stay below 2^63
    acc = None
    for s, cols in _chunks(cols_dev):
        AZ, BZ, CZ = (_combo(cols, t, n_out) for t in terms)
        inner = ops.sub(ops.mont_mul(AZ, BZ), CZ)        # (L, n_out, C)
        del AZ, BZ, CZ
        E = E_cyc[:, None, s:s + inner.shape[-1]]
        part = ops.u64_words(ops.mont_mul(inner, E)).sum(dim=-1)
        acc = part if acc is None else acc.add_(part)
        del inner
    zg = ops.unpack_ints(ops.reduce_cols(acc))

    eq_g = [(1 - tau_g) % P, tau_g % P]
    t1_ext = [(eq_g[0] * zg[zi * NUM_GROUPS] +
               eq_g[1] * zg[zi * NUM_GROUPS + 1]) % P
              for zi in range(UNISKIP_DEGREE)]

    # t1 through 11 base zeros + 10 extended values; s1 = L(tau_high,.)*t1
    xs = [z % P for z in base + targets]
    ys = [0] * UNISKIP_DOMAIN + t1_ext
    t1_coeffs = lag.interpolate_coeffs(xs, ys)
    s1_coeffs = lag.poly_mul(
        lag.lagrange_kernel_coeffs(tau_high, UNISKIP_DOMAIN), t1_coeffs)
    assert len(s1_coeffs) == UNISKIP_NUM_COEFFS

    transcript.append_scalars(b"uniskip_poly", s1_coeffs)
    r0 = transcript.challenge_scalar_optimized()
    claim1 = lag.eval_poly(s1_coeffs, r0)
    l_scale = lag.eval_poly(
        lag.lagrange_kernel_coeffs(tau_high, UNISKIP_DOMAIN), r0)
    return cols_dev, s1_coeffs, r0, claim1, l_scale


def verify_uniskip(coeffs: Sequence[int], transcript):
    """Verifier half of the skip round: degree bound, base-window sum = 0
    (`UniSkipFirstRoundProof::verify`), challenge + next claim."""
    from ..sumcheck.engine import SumcheckError
    if not 0 < len(coeffs) <= UNISKIP_NUM_COEFFS:
        raise SumcheckError(
            f"uniskip poly has {len(coeffs)} coeffs (max {UNISKIP_NUM_COEFFS})")
    transcript.append_scalars(b"uniskip_poly", coeffs)
    r0 = transcript.challenge_scalar_optimized()
    if lag.domain_sum(coeffs, UNISKIP_DOMAIN) != 0:
        raise SumcheckError("uniskip base-window sum is nonzero")
    return r0, lag.eval_poly(coeffs, r0)


# ---------------------------------------------------------------------------
# remaining sumcheck: 1 group round + log T cycle rounds over 2T tensors
# ---------------------------------------------------------------------------

def _outer_message(E, AZ, BZ, CZ) -> torch.Tensor:
    """Round evals at X in {0,2,3} of sum eq*(Az*Bz - Cz).  (L, 3, 1)."""
    e = dense.sumcheck_eval_points_high(E, 3)
    a = dense.sumcheck_eval_points_high(AZ, 3)
    b = dense.sumcheck_eval_points_high(BZ, 3)
    c = dense.sumcheck_eval_points_high(CZ, 3)
    inner = ops.sub(ops.mont_mul(a, b), c)
    return ops.sum_mod(ops.mont_mul(e, inner))


def _bind4(E, AZ, BZ, CZ, r):
    return (dense.bind_high(E, r), dense.bind_high(AZ, r),
            dense.bind_high(BZ, r), dense.bind_high(CZ, r))


class SpartanOuterProver(FusedInstance):
    """The post-skip sumcheck: index = g*T + j (group bit is the MSB,
    bound first, HighToLow).  E carries eq(tau_g,g)*eq(tau_cyc,j) scaled
    by L(tau_high, r0), so the input claim is exactly s1(r0).  A
    `FusedInstance`: on the device tier each round binds the four tables
    at the device challenge (K1's bind reads it where it lies)."""

    degree = 3

    def __init__(self, inputs: R1CSCycleInputs, tau: Sequence[int],
                 r0: int, claim: int, l_scale: int, cols_dev):
        T = inputs.T
        self.log_T = T.bit_length() - 1
        self._num_rounds = 1 + self.log_T
        assert len(tau) == self._num_rounds
        tau_g, tau_cyc = tau[0], list(tau[1:])
        self.cols_dev = cols_dev
        self.device = cols_dev.device
        self._claim = claim % P

        # Az/Bz/Cz bound to Y=r0: (L, 2, T) -> (L, 2T)
        y_basis = lag.lagrange_basis_at(
            lag.symmetric_domain(UNISKIP_DOMAIN), r0)
        Wr = _group_w_rows(y_basis)
        terms = [_combo_terms([(g, Wr[g][m]) for g in range(NUM_GROUPS)],
                              self.device) for m in range(3)]
        if isinstance(cols_dev, StreamedColumns):
            mats = _combo_streamed(cols_dev, terms, NUM_GROUPS)
        else:
            mats = [_combo(cols_dev, t, NUM_GROUPS) for t in terms]
        self.AZ, self.BZ, self.CZ = (
            out.reshape(out.shape[0], NUM_GROUPS * T) for out in mats)

        E_cyc = eq.evals(tau_cyc, self.device)
        e0 = ops.mont_mul(E_cyc, (1 - tau_g) % P * l_scale % P)
        e1 = ops.mont_mul(E_cyc, tau_g * l_scale % P)
        self.E = torch.cat([e0, e1], dim=-1)
        self._r: list = []          # the challenges bound so far
        self.input_openings: List[int] = None

    @property
    def num_rounds(self) -> int:
        return self._num_rounds

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        return self._claim

    def message_evals_dev(self, round: int):
        return _outer_message(self.E, self.AZ, self.BZ, self.CZ)

    def ingest_challenge(self, r, round: int) -> None:
        self._r.append(r)
        self.E, self.AZ, self.BZ, self.CZ = _bind4(
            self.E, self.AZ, self.BZ, self.CZ, r)

    def fused_finals(self) -> List[torch.Tensor]:
        """All 38 R1CS input MLEs at r_cycle (the cycle rounds' challenges,
        ints or device scalars): one eq table and one dot, (L, 38).  The
        dot's int64 limb planes accumulate chunk by chunk on the device
        (exact, as the uni-skip sums) and reduce once: no value leaves the
        card, on either tier."""
        Ecyc = eq.evals(self._r[1:], self.device)
        acc = None
        for s, cols in _chunks(self.cols_dev):
            E = Ecyc[:, None, s:s + cols.shape[-1]]
            part = ops.u64_words(ops.mont_mul(cols, E)).sum(dim=-1)
            acc = part if acc is None else acc.add_(part)
        return [ops.reduce_cols(acc)]

    def fused_store(self, values: List[int]) -> None:
        self.input_openings = list(values)

    def cache_openings(self, accumulator: OpeningAccumulator,
                       r_slice: Sequence[int]) -> None:
        """Cache the 38 input openings at r_cycle (they feed later stages
        and the PCS opening)."""
        r_cycle = list(r_slice[1:])
        for name, val in zip(VAR_NAMES, self.input_openings):
            accumulator.insert(("r1cs_input", name), r_cycle, val)

    def expected_output_claim(self, accumulator, r):  # prover-side unused
        raise NotImplementedError


class SpartanOuterVerifier(SumcheckInstance):
    """Verifier half: recomputes Az/Bz/Cz(r0, r_g, r_cycle) from the 38
    input openings via chi_k = l_{slot_k}(r0) * eq(r_g, g_k)."""

    def __init__(self, num_rounds: int, tau: Sequence[int], r0: int,
                 input_openings: Sequence[int], claim: int):
        self._num_rounds = num_rounds
        self.tau = list(tau)           # [tau_high, tau_g, *tau_cyc]
        self.r0 = r0 % P
        self.z = list(input_openings)
        self._claim = claim % P
        assert len(self.z) == NUM_VARS

    @property
    def num_rounds(self) -> int:
        return self._num_rounds

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        return self._claim

    def message_evals_dev(self, round):  # pragma: no cover
        raise NotImplementedError("verifier instance")

    def ingest_challenge(self, r, round):  # pragma: no cover
        raise NotImplementedError("verifier instance")

    def expected_output_claim(self, accumulator: OpeningAccumulator,
                              r: Sequence[int]) -> int:
        r = list(r)
        r_g = r[0]
        y_basis = lag.lagrange_basis_at(
            lag.symmetric_domain(UNISKIP_DOMAIN), self.r0)
        rows = C.all_rows()
        az = bz = cz = 0
        for k, (a, b, c) in enumerate(rows):
            g, slot = divmod(k, UNISKIP_DOMAIN)
            chi = y_basis[slot] * (r_g if g else (1 - r_g)) % P
            az = (az + chi * self._eval_lc(a)) % P
            bz = (bz + chi * self._eval_lc(b)) % P
            cz = (cz + chi * self._eval_lc(c)) % P
        # eq over (tau_g, tau_cyc) vs r, times the Lagrange kernel factor
        l_scale = lag.eval_poly(
            lag.lagrange_kernel_coeffs(self.tau[0], UNISKIP_DOMAIN), self.r0)
        eq_tau_r = eq.eq_int(self.tau[1:], r)
        return l_scale * eq_tau_r % P * ((az * bz - cz) % P) % P

    def _eval_lc(self, lc) -> int:
        return sum(coeff * self.z[v] for v, coeff in lc) % P
