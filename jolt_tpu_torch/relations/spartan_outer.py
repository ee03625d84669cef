"""Spartan outer sumcheck over the uniform RV64 R1CS, with univariate skip.

Torch counterpart of the JAX package's `relations/spartan_outer.py`, the
materialized tier (the bench's 2^18 trace stays below its streaming
threshold of 2^19 cycles).  Proves

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
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..field import FR, ops
from ..poly import dense, eq
from ..poly import lagrange as lag
from ..r1cs import constraints as C
from ..sumcheck.engine import OpeningAccumulator, SumcheckInstance
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


def num_stage1_rounds(log_T: int) -> int:
    """Remaining-sumcheck rounds after the uni-skip first round."""
    return 1 + log_T


# ---------------------------------------------------------------------------
# device evaluation of sparse row combos
# ---------------------------------------------------------------------------

def pack_input_columns(inputs: R1CSCycleInputs, device) -> torch.Tensor:
    """All 38 columns as one Montgomery limb tensor (8, 38, T).

    The (lo, hi) u64 witness words are the low 128 bits of the plain value
    hi*2^64 + lo; one mont_mul by R^2 lifts them, and signed columns with
    the top bit of hi set subtract 2^128 (exact signed semantics, as the
    reference's `_lift_body`)."""
    lo, hi = inputs.lo, inputs.hi
    signed_rows = np.zeros(NUM_VARS, bool)
    for v in SIGNED_COLS:
        signed_rows[v] = True
    sign_mask = signed_rows[:, None] & ((hi >> np.uint64(63)) == 1)
    words = np.stack([lo, hi]).view(np.uint32)              # (2, 38, 2T)
    words = words.reshape(2, NUM_VARS, -1, 2).transpose(0, 3, 1, 2)
    words = np.ascontiguousarray(words).reshape(4, NUM_VARS, -1)
    val = ops.from_words(
        torch.from_numpy(words.view(np.int32)).to(device))
    corr = ops.const_mont(1 << 128, (1, 1), device)
    mask = torch.from_numpy(sign_mask).to(device)
    return ops.select(mask, ops.sub(val, corr), val)


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
    acc = torch.zeros((ops.N_LIMBS, n_out, T), dtype=torch.int64,
                      device=cols.device)
    step = max(1, _COMBO_CHUNK // T)
    for s in range(0, W.shape[1], step):
        e = s + step
        prod = ops.mont_mul(W[:, s:e, None], cols[:, v_idx[s:e], :])
        acc.index_add_(1, out_idx[s:e], ops.u64_words(prod))
    return ops.reduce_cols(acc)


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
                  device="cuda"):
    """Compute + absorb the uni-skip first-round polynomial; returns
    (cols_dev, s1_coeffs, r0, claim1, l_scale).

    tau = [tau_high, tau_g, *tau_cyc]  (1 + 1 + log_T challenges)."""
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
    cols_dev = pack_input_columns(inputs, device)
    AZ = _combo(cols_dev, _combo_terms(w_rows[0], device), n_out)
    BZ = _combo(cols_dev, _combo_terms(w_rows[1], device), n_out)
    CZ = _combo(cols_dev, _combo_terms(w_rows[2], device), n_out)
    inner = ops.sub(ops.mont_mul(AZ, BZ), CZ)            # (L, n_out, T)
    del AZ, BZ, CZ
    sums = ops.dot(inner, E_cyc[:, None, :])             # (L, n_out, 1)
    zg = ops.unpack_ints(sums.reshape(sums.shape[0], n_out))

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


class SpartanOuterProver(SumcheckInstance):
    """The post-skip sumcheck: index = g*T + j (group bit is the MSB,
    bound first, HighToLow).  E carries eq(tau_g,g)*eq(tau_cyc,j) scaled
    by L(tau_high, r0), so the input claim is exactly s1(r0)."""

    degree = 3

    def __init__(self, inputs: R1CSCycleInputs, tau: Sequence[int],
                 r0: int, claim: int, l_scale: int,
                 cols_dev: torch.Tensor):
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
        mats = []
        for m in range(3):
            rows = [(g, Wr[g][m]) for g in range(NUM_GROUPS)]
            out = _combo(cols_dev, _combo_terms(rows, self.device),
                         NUM_GROUPS)
            mats.append(out.reshape(out.shape[0], NUM_GROUPS * T))
        self.AZ, self.BZ, self.CZ = mats

        E_cyc = eq.evals(tau_cyc, self.device)
        e0 = ops.mont_mul(E_cyc, ops.pack_ints(
            [(1 - tau_g) % P * l_scale % P], self.device))
        e1 = ops.mont_mul(E_cyc, ops.pack_ints(
            [tau_g * l_scale % P], self.device))
        self.E = torch.cat([e0, e1], dim=-1)
        self.input_openings: List[int] = None

    @property
    def num_rounds(self) -> int:
        return self._num_rounds

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        return self._claim

    def message_evals_dev(self, round: int):
        return _outer_message(self.E, self.AZ, self.BZ, self.CZ)

    def ingest_challenge(self, r: int, round: int) -> None:
        r_dev = ops.pack_ints([r], self.device)
        self.E, self.AZ, self.BZ, self.CZ = _bind4(
            self.E, self.AZ, self.BZ, self.CZ, r_dev)

    def cache_openings(self, accumulator: OpeningAccumulator,
                       r_slice: Sequence[int]) -> None:
        """Evaluate all 38 R1CS input MLEs at r_cycle and cache the claims
        (these feed later stages / the PCS opening)."""
        r_cycle = list(r_slice[1:])
        Ecyc = eq.evals(r_cycle, self.device)
        sums = ops.dot(self.cols_dev, Ecyc[:, None, :])   # (L, 38, 1)
        vals = ops.unpack_ints(sums.reshape(sums.shape[0], NUM_VARS))
        openings = []
        for v in range(NUM_VARS):
            val = vals[v]
            openings.append(val)
            accumulator.insert(("r1cs_input", VAR_NAMES[v]), r_cycle, val)
        self.input_openings = openings

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
