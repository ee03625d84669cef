"""Dory polynomial commitment scheme: transparent setup, two-tier GT
commitments, additive homomorphism, pay-per-bit tier-1 MSMs.

Structure mirrors the reference (`crates/jolt-dory`, `book/src/how/dory.md`):

  * URS: hash-to-curve G1/G2 generator vectors (NO trusted setup; unknown
    discrete logs), sizes O(sqrt N): Gamma1 (2^sigma, tier-1 row key) and
    Gamma2 (2^nu, tier-2 AFGHO key), plus independent per-level reduce keys.
  * Commit: coefficients as a 2^nu x 2^sigma matrix (row-major, row index =
    the FIRST nu point variables); tier 1: row commitments C1_i =
    <M_i, Gamma1> in G1 (small-scalar/pay-per-bit MSMs); tier 2: C =
    sum_i e(C1_i, Gamma2_i) in GT (one shared final exponentiation).
  * Open at r = (r_row, r_col), claim y = L^T M R with L = eq(r_row),
    R = eq(r_col):
      - phase A: the REAL Dory-reduce (Lee21 `eprint 2020/1274` section 4:
        beta-masking with per-level chi/Delta precomputations, O(log)
        rounds, O(1) verifier work per round) proves the prover-supplied
        E1 equals sum_i L_i C1_i for the v1 bound to C -- i.e. E1 commits
        the combined row s = L^T M under Gamma1.
      - phase B: a generator-folding inner-product argument (pairing-free)
        proves <s, R> = y against E1 = <s, Gamma1>.
    Verifier: O(log) pairings/GT work in phase A; phase B does O(sigma)
    field work in the round loop (closed-form folded eq tensor) plus ONE
    tensor-weight Pippenger MSM over Gamma1 at the end -- see
    `Dory.verify` (the reference is O(log N) group ops everywhere;
    `book/src/how/dory.md:58-64`).
  * Homomorphism: commitments are GT elements; RLCs of commitments match
    RLCs of polynomials (used by the stage-8 joint batched opening).

Citations: `crates/jolt-dory/src/scheme.rs`, `poly/commitment/dory/
dory_globals.rs` (matrix layout), `book/src/how/dory.md:37-80`.

Copied from the JAX package's `pcs/dory.py`, host code on Python ints
and the native library (`curve/native_pairing.py`), with both tiers of
`open` and `verify` and their logic unchanged.  What differs:

  * `DorySetup.generate` caches under the port's own gitignored
    `_build/srs/` (or `cache_dir`), in files named apart from the JAX
    package's, written atomically, and loads only the port's own classes
    (a pickle names its classes by module path: the two packages never
    share a cache).  The values are the JAX package's.
  * `Dory(setup, device="cuda")` takes its device from the caller, never
    from whether a card is present, and the device picks the route of
    Dory's G1 work.  On a CUDA device it runs on the port's device G1
    (`curve/g1.py`, K3): tier 1 of the one-hot commits (one `bucket_sum`
    over every matrix's rows), the dense commits (`g1.msm_rows` over
    Gamma1, Pippenger at 2^16 columns) and the opening's phase B (its
    MSMs, and the Gamma1 folds as scalar_mul, add and normalize).  A
    failed build or launch raises; nothing falls back.  On the CPU the
    same work runs on the native library, as in the JAX package.  Tier
    2, phase A, the opening's Fr folds and `verify` stay native on both.
    `DorySetup.gamma1_on` keeps Gamma1's device copy with the setup, one
    per device, out of the cached pickle.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
import tempfile
from typing import List, Optional, Sequence, Tuple

import torch

from ..curve import bn254_host as host
from ..curve.fq_tower import Fq2, Fq12
from ..curve.pairing import (G2Point, g2_add, g2_in_subgroup, g2_mul,
                             g2_mul_unreduced, pairing_product, tate_pairing)
from ..field import ops
from ..field.kernels import N_LIMBS
from ..field.params import FQ_MODULUS as Q
from ..field.params import FR_MODULUS as P
from ..transcript import Blake2bTranscript
from ..utils.profiling import active as _prof_active

# the bits of an Fr scalar (the K3 route's MSMs and folds)
FR_BITS = 254

# BN254 G2 cofactor (checked at setup: clearing lands in the r-torsion)
_G2_COFACTOR = 21888242871839275222246405745257275088844257914179612981679871602714643921549


# ---------------------------------------------------------------------------
# hash-to-curve (try-and-increment; generators with unknown dlog)
# ---------------------------------------------------------------------------

def _hash_fq(tag: bytes, ctr: int) -> int:
    return int.from_bytes(
        hashlib.blake2b(tag + ctr.to_bytes(8, "little"), digest_size=48)
        .digest(), "big") % Q


def _sqrt_fq(a: int) -> Optional[int]:
    if a == 0:
        return 0
    x = pow(a, (Q + 1) // 4, Q)  # q = 3 mod 4
    return x if x * x % Q == a % Q else None


def hash_to_g1(tag: bytes) -> host.Point:
    ctr = 0
    while True:
        x = _hash_fq(tag + b"/g1", ctr)
        y = _sqrt_fq((x * x % Q * x + 3) % Q)
        if y is not None:
            return (x, min(y, Q - y))  # normalized sign
        ctr += 1


def _fq2_sqrt(a: Fq2) -> Optional[Fq2]:
    """Square root in Fq2 = Fq[u]/(u^2+1), q = 3 mod 4."""
    if a == Fq2.ZERO:
        return Fq2.ZERO
    a1 = a.pow((Q - 3) // 4)
    x0 = a1 * a
    alpha = a1 * x0
    if alpha == Fq2(Q - 1):
        x = Fq2(0, 1) * x0
    else:
        b = (Fq2(1) + alpha).pow((Q - 1) // 2)
        x = b * x0
    return x if x * x == a else None


_TWIST_B = (Fq2(3) * Fq2(9, 1).inv())


def hash_to_g2(tag: bytes) -> G2Point:
    ctr = 0
    while True:
        x = Fq2(_hash_fq(tag + b"/g2x", ctr), _hash_fq(tag + b"/g2y", ctr))
        y = _fq2_sqrt(x * x * x + _TWIST_B)
        if y is not None:
            # UNREDUCED cofactor clearing: the raw hash point has order
            # dividing r*c2; [c2] P lands in the r-torsion (the ate
            # pairing's eigenspace).  g2_mul would reduce c2 mod r.
            p = g2_mul_unreduced((x, y), _G2_COFACTOR)
            if p is not None:
                return p
        ctr += 1


# ---------------------------------------------------------------------------
# GT serialization (transcript + proof wire format)
# ---------------------------------------------------------------------------

def gt_to_bytes(f: Fq12) -> bytes:
    out = b""
    for fq6 in (f.c0, f.c1):
        for fq2 in (fq6.c0, fq6.c1, fq6.c2):
            out += fq2.a.to_bytes(32, "big") + fq2.b.to_bytes(32, "big")
    return out


def _g2_bytes(p: G2Point) -> bytes:
    if p is None:
        return b"\x00" * 128
    return (p[0].a.to_bytes(32, "big") + p[0].b.to_bytes(32, "big")
            + p[1].a.to_bytes(32, "big") + p[1].b.to_bytes(32, "big"))


def _g1_bytes(p: host.Point) -> bytes:
    if p is None:
        return b"\x00" * 64
    return p[0].to_bytes(32, "big") + p[1].to_bytes(32, "big")


def gt_exp(f: Fq12, e: int) -> Fq12:
    e %= P
    from ..curve import native_pairing as _np
    fast = _np.fq12_pow(f, e)
    if fast is not None:
        return fast
    return f.pow(e)


def gt_mul(a: Fq12, b: Fq12) -> Fq12:
    return a * b


# ---------------------------------------------------------------------------
# setup
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DoryLevel:
    """Per-level precomputation for the Dory-reduce (Lee21 fig. 2)."""
    g1: List[host.Point]   # Gamma1A^(j), length m
    g2: List[G2Point]      # Gamma2A^(j), length m
    chi: Fq12              # <Gamma1A, Gamma2A>
    d1l: Fq12              # <Gamma1A_L, Gamma2A^(j-1)>
    d1r: Fq12
    d2l: Fq12              # <Gamma1A^(j-1), Gamma2A_L>
    d2r: Fq12


@dataclasses.dataclass
class DorySetup:
    nu: int                      # log2 rows
    sigma: int                   # log2 cols
    gamma1: List[host.Point]     # tier-1 row key (2^sigma)
    levels: List[DoryLevel]      # reduce levels nu..0 (levels[j] has m=2^(nu-j))
    g2star: G2Point

    @property
    def num_vars(self) -> int:
        return self.nu + self.sigma

    def gamma1_on(self, device):
        """Gamma1 as an affine batch on `device` (`curve/g1.py`: Z = R mod
        q, the layout that `bucket_sum` and Pippenger take), packed at the
        first call for that device and kept with the setup."""
        key = str(torch.device(device))
        packed = self.__dict__.setdefault("_gamma1_dev", {})
        if key not in packed:
            from ..curve import g1 as g1dev
            with _prof_active().span("encode.setup"):
                packed[key] = g1dev.pack_points(self.gamma1, device)
        return packed[key]

    def __getstate__(self):
        """The fields alone: the device copies of `gamma1_on` stay out of
        the pickle (the cache loads only the package's own classes)."""
        state = dict(self.__dict__)
        state.pop("_gamma1_dev", None)
        return state

    # Default aspect ratio: rows are capped at 2^10.  Tier-2 commits and
    # the reduce's pairing products scale with ROWS (the host pairing
    # tier), while tier-1 MSMs and the phase-B folds scale with COLS
    # (device MSMs / native G1 batches -- much cheaper per element), so a
    # wide rectangle beats the square for wall time; the verifier's
    # phase-B O(cols) fold is the counter-pressure that caps sigma.
    MAX_NU = 10

    @classmethod
    def default_nu(cls, num_vars: int) -> int:
        return min(num_vars // 2, cls.MAX_NU)

    @classmethod
    def generate(cls, num_vars: int, cache_dir: Optional[str] = None,
                 nu: Optional[int] = None) -> "DorySetup":
        nu = cls.default_nu(num_vars) if nu is None else nu
        sigma = num_vars - nu
        # cache v2 ("ate"): the GT precomputations (chi, d1l, ...) are
        # pairing-tier-dependent; the optimal-ate switch invalidated the
        # original Tate-era caches
        cache_dir = SRS_CACHE_DIR if cache_dir is None else cache_dir
        cache = os.path.join(cache_dir, f"dory_torch_ate_{nu}_{sigma}.pkl")
        if os.path.exists(cache):
            with open(cache, "rb") as f:
                return _SetupUnpickler(f).load()

        assert host.g1_mul(hash_to_g1(b"check"), 1) is not None
        gamma1 = [hash_to_g1(b"dory/t1/%d" % j) for j in range(1 << sigma)]
        g2star = hash_to_g2(b"dory/g2star")

        # reduce keys: independent fresh generator vectors per level
        lv_g1 = [[hash_to_g1(b"dory/red/%d/g1/%d" % (j, i))
                  for i in range(1 << (nu - j))] for j in range(nu + 1)]
        lv_g2 = [[hash_to_g2(b"dory/red/%d/g2/%d" % (j, i))
                  for i in range(1 << (nu - j))] for j in range(nu + 1)]
        levels = []
        for j in range(nu + 1):
            g1v, g2v = lv_g1[j], lv_g2[j]
            m = len(g1v)
            chi = pairing_product(list(zip(g1v, g2v)))
            if j < nu:
                n1, n2 = lv_g1[j + 1], lv_g2[j + 1]
                h = m // 2
                d1l = pairing_product(list(zip(g1v[:h], n2)))
                d1r = pairing_product(list(zip(g1v[h:], n2)))
                d2l = pairing_product(list(zip(n1, g2v[:h])))
                d2r = pairing_product(list(zip(n1, g2v[h:])))
            else:
                d1l = d1r = d2l = d2r = Fq12.one()
            levels.append(DoryLevel(g1v, g2v, chi, d1l, d1r, d2l, d2r))

        setup = cls(nu=nu, sigma=sigma, gamma1=gamma1, levels=levels,
                    g2star=g2star)
        os.makedirs(cache_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".pkl", dir=cache_dir)
        try:
            with os.fdopen(fd, "wb") as f:
                pickle.dump(setup, f)
            os.replace(tmp, cache)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return setup


SRS_CACHE_DIR = os.path.join(os.path.dirname(__file__), "..", "_build", "srs")


class _SetupUnpickler(pickle.Unpickler):
    """Loads a cached setup, refusing any class outside this package (a
    JAX package file would import JAX; a setup's pickle names no other)."""

    def find_class(self, module, name):
        if module.split(".")[0] == "jolt_tpu_torch":
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"a Dory setup cache of the port names {module}.{name}")


# ---------------------------------------------------------------------------
# commitment
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DoryCommitment:
    c: Fq12                       # tier-2 AFGHO commitment (GT)


@dataclasses.dataclass
class DoryHint:
    rows: List[host.Point]        # tier-1 row commitments (prover-retained)


@dataclasses.dataclass
class DoryProof:
    e1: host.Point                       # sum_i L_i C1_i (G1)
    # phase A (Dory-reduce), per round:
    a_d1l: List[Fq12]
    a_d1r: List[Fq12]
    a_d2l: List[Fq12]
    a_d2r: List[Fq12]
    a_cplus: List[Fq12]
    a_cminus: List[Fq12]
    a_final_v1: host.Point
    a_final_v2: G2Point
    # phase B (generator-folding IPA), per round:
    b_xl: List[host.Point]
    b_xr: List[host.Point]
    b_yl: List[int]
    b_yr: List[int]
    b_final_s: int


def _eq_tensor(point: Sequence[int]) -> List[int]:
    tab = [1]
    for r in point:
        r %= P
        tab = [w * v % P for w in tab for v in ((1 - r) % P, r)]
    return tab


class Dory:
    def __init__(self, setup: DorySetup, device="cuda", _k3=None):
        """`device` picks the route of the G1 work: K3 on a CUDA device,
        the native library on the CPU (the module's docstring).  `_k3`
        (True or False) forces one route whatever the device; it is only
        for the checks that hold one route against the other (the tests
        and `chip_smoke.py`).  On CPU tensors K3's wrappers run their
        plain versions."""
        self.setup = setup
        self.device = torch.device(device)
        self.k3 = self.device.type == "cuda" if _k3 is None else bool(_k3)

    # ---- commit --------------------------------------------------------

    def commit_rows(self, coeffs: Sequence[int]) -> DoryHint:
        """Tier 1: the row MSMs (all-zero trailing rows are skipped).  The
        K3 route packs the coefficients into words once and runs every
        row's MSM on the device (`g1.msm_rows`); the native route uses the
        process-cached pre-encoded generator buffer, so dense commits pay
        scalar encoding only (zero coefficients are skipped)."""
        from ..curve import native_pairing as npair
        s = self.setup
        cols = 1 << s.sigma
        n_rows = min(1 << s.nu, (len(coeffs) + cols - 1) // cols)
        rows: List[Optional[host.Point]] = [None] * (1 << s.nu)
        with _prof_active().span("commit.tier1"):
            if self.k3:
                rows[:n_rows] = self._rows_k3(coeffs, n_rows)
                return DoryHint(rows=rows)
            buf = self._gamma1_buf()
            for i in range(n_rows):
                row = coeffs[i * cols:(i + 1) * cols]
                if buf is not None:
                    got = npair.g1_msm_enc(buf, row)
                    if got is not None:
                        rows[i] = got[0]
                        continue
                rows[i] = host.g1_msm_pippenger(s.gamma1[:len(row)], row)
        return DoryHint(rows=rows)

    def _rows_k3(self, coeffs: Sequence[int], n_rows: int
                 ) -> List[Optional[host.Point]]:
        """The first `n_rows` row commitments on K3: the coefficients as
        canonical words (a short tail row padded with zeros), one MSM a
        row over Gamma1 at 254 bits, as affine host points (None for
        infinity)."""
        import numpy as np

        from ..curve import g1 as g1dev
        from ..field.ops import words_of_ints
        if n_rows == 0:
            return []
        cols = 1 << self.setup.sigma
        words = np.zeros((N_LIMBS, n_rows * cols), np.uint32)
        words[:, :len(coeffs)] = words_of_ints(coeffs)
        w = ops.upload(words.view(np.int32), self.device)
        gam = self.setup.gamma1_on(self.device)
        sums = g1dev.msm_rows(tuple(c[:, None] for c in gam),
                              w.reshape(N_LIMBS, n_rows, cols), FR_BITS)
        return g1dev.unpack_points(sums)

    def commit(self, coeffs: Sequence[int]) -> Tuple[DoryCommitment, DoryHint]:
        s = self.setup
        assert len(coeffs) <= 1 << s.num_vars
        # NO zero-padding to 2^num_vars: commit_rows handles a short tail
        # row, and trailing all-zero rows commit to infinity implicitly
        # (padding made every dense commit scan ~2^10 empty rows)
        hint = self.commit_rows(coeffs)
        return self._tier2(hint), hint

    def _tier2(self, hint: DoryHint) -> DoryCommitment:
        # Routed through the buffer-level pairing tier (cached encoded
        # gamma2).  _tier2_gt lives at the END of this file so the line
        # numbers of the traced commit path below stay unchanged
        with _prof_active().span("commit.tier2"):
            return DoryCommitment(c=_tier2_gt(self, hint.rows))

    def _gamma1_buf(self):
        """Gamma1's native encoding (the native route), made once a Dory
        instance; None on the Python pairing tier."""
        from ..curve import native_pairing as npair
        if getattr(self, "_g1_buf", None) is None and npair.available():
            with _prof_active().span("encode.setup"):
                self._g1_buf = npair.g1_enc_bases(self.setup.gamma1)
        return getattr(self, "_g1_buf", None)

    def commit_onehot_many(self, positions_list):
        """Batched `commit_onehot`: per-matrix row sums (sum of column
        generators per hit row) then one tier-2 multi-pairing per matrix.
        Tier 1 is `onehot_rows`."""
        hints = [DoryHint(rows=rows)
                 for rows in self.onehot_rows(positions_list)]
        return [(self._tier2(hint), hint) for hint in hints]

    def onehot_rows(self, positions_list) -> List[List[Optional[host.Point]]]:
        """Tier 1 of `commit_onehot_many`: each matrix's row commitments
        (the sum of the column generators of each hit row), for every
        matrix at once.  The K3 route takes one device `bucket_sum` over
        the rows (`_segment_totals`); the native route the native segment
        sums (csrc/pairing.cpp jolt_g1_segment_sums -- threaded Jacobian
        mixed-add chains), or on the Python pairing tier the device sums
        on this Dory's device, as the JAX package does."""
        s = self.setup
        with _prof_active().span("commit.tier1"):
            col_all, seg_off, metas = self.onehot_segments(positions_list)
            base_buf = None if self.k3 else self._gamma1_buf()
            if base_buf is not None:
                from ..curve import native_pairing as npair
                pts = npair.g1_segment_sums(base_buf, col_all, seg_off)
            else:
                pts = self._segment_totals(col_all, seg_off)
        out = []
        pos = 0
        for rows_hit, n_hit in metas:
            rows: List[Optional[host.Point]] = [None] * (1 << s.nu)
            for r, pt in zip(rows_hit.tolist(), pts[pos:pos + n_hit]):
                rows[r] = pt
            pos += n_hit
            out.append(rows)
        return out

    def onehot_segments(self, positions_list):
        """Tier 1's segments over every matrix at once: the column of each
        position, grouped by (matrix, row) (uint32), the segments' offsets
        (uint64, one more than the segments) and, per matrix, its hit rows
        and their count."""
        import numpy as np

        s = self.setup
        cols = 1 << s.sigma
        metas = []
        c_parts, head_parts = [], []
        for positions in positions_list:
            positions = np.asarray(positions, np.int64)
            row_idx = positions >> s.sigma
            # rows < 2^nu: a stable sort of 16-bit keys (numpy's radix
            # sort) gives the int64 sort's order
            keys = row_idx.astype(np.uint16) if s.nu <= 16 else row_idx
            order = np.argsort(keys, kind="stable")
            r_sorted = row_idx[order]
            c_parts.append((positions & (cols - 1))[order])
            n = len(positions)
            heads = np.ones(n, np.uint32)
            heads[1:] = (r_sorted[1:] != r_sorted[:-1]).astype(np.uint32)
            head_parts.append(heads)
            lasts = np.nonzero(np.concatenate([heads[1:], [1]]))[0]
            metas.append((r_sorted[lasts], len(lasts)))

        col_all = np.concatenate(c_parts).astype(np.uint32)
        heads_all = np.concatenate(head_parts)
        seg_off = np.concatenate([np.nonzero(heads_all)[0],
                                  [len(col_all)]]).astype(np.uint64)
        return col_all, seg_off, metas

    def _segment_totals(self, cols, seg_off) -> List[host.Point]:
        """The device sums: one `g1.bucket_sum` of the generators at `cols`
        (K3 on the card), segment i = cols[seg_off[i]:seg_off[i + 1]],
        normalized on the device (`g1.normalize`), as affine host
        points."""
        import numpy as np

        from ..curve import g1 as g1dev
        sums = g1dev.bucket_sum(
            self.setup.gamma1_on(self.device),
            ops.upload(cols.astype(np.int32), self.device),
            ops.upload(seg_off.astype(np.int64), self.device))
        return g1dev.unpack_points(g1dev.normalize(sums))

    def commit_onehot(self, positions) -> Tuple[DoryCommitment, DoryHint]:
        """Commit a sparse 0/1 vector given its nonzero POSITIONS (numpy
        int64, in [0, 2^num_vars)) -- O(T) mixed adds for tier 1 (no
        dense K*T vector is ever built), then the usual tier-2
        multi-pairing over nonzero rows.

        The one-hot fast path of the reference
        (`poly/one_hot_polynomial.rs:119`): each row commitment is a plain
        sum of column generators."""
        hint = DoryHint(rows=self.onehot_rows([positions])[0])
        return self._tier2(hint), hint

    # ---- open ----------------------------------------------------------

    def open(self, coeffs, hint: DoryHint,
             point: Sequence[int], value: int,
             transcript: Blake2bTranscript) -> DoryProof:
        """coeffs: dense int list, a sparse (positions int64 array,
        values list) pair, or a LIST of weighted sparse parts
        [(positions, weight, values|None)] (the stage-8 RLC) -- only the
        combined-row build touches coefficients, so sparse inputs make
        the opening O(nnz), never O(2^num_vars)."""
        s = self.setup
        n = s.num_vars
        prof = _prof_active()
        parts = coeffs if isinstance(coeffs, list) and coeffs \
            and isinstance(coeffs[0], tuple) and len(coeffs[0]) == 3 \
            else None
        sparse = isinstance(coeffs, tuple)
        if not sparse and parts is None:
            coeffs = list(coeffs) + [0] * ((1 << n) - len(coeffs))
        r_row, r_col = point[:s.nu], point[s.nu:]
        L = _eq_tensor(r_row)
        R = _eq_tensor(r_col)
        cols = 1 << s.sigma

        # ---- phase A: Dory-reduce on (v1 = rows, v2 = L (.) g2star) ----
        # Native tier keeps v1/v2 as raw encoded buffers BETWEEN rounds:
        # the per-round Python point encode/decode measured more expensive
        # than the native ladders themselves at 2^10+ lanes.  Both tiers
        # emit identical transcript bytes (the kernels mirror the Python
        # oracle value-for-value; tests/test_torch_dory.py).
        from ..curve import native_pairing as _np
        a_d1l, a_d1r, a_d2l, a_d2r = [], [], [], []
        a_cp, a_cm = [], []
        if _np.available():
            v1b, v1i = _np._g1_enc_many(hint.rows)
            with prof.span("open.e1"):
                e1 = _np.g1_msm_buf(v1b, v1i, L)[0]
            transcript.append_bytes(b"dory_e1", _g1_bytes(e1))
            with prof.span("open.A.v2init"):
                g2sb, g2si = _np.g2_enc_many([s.g2star])
                v2b, v2i = _np.g2_mul_buf(g2sb * len(L), g2si * len(L), L)
            lev_enc = self.__dict__.setdefault("_lev_enc", {})

            def enc_level(idx):
                if idx not in lev_enc:
                    lev = s.levels[idx]
                    with prof.span("encode.setup"):
                        lev_enc[idx] = (_np._g1_enc_many(lev.g1),
                                        _np.g2_enc_many(lev.g2))
                return lev_enc[idx]

            for j in range(s.nu):
                m = len(v1i)
                h = m // 2
                (n1b, n1i), (n2b, n2i) = enc_level(j + 1)
                with prof.span("open.A.pair"):
                    d1l = _np.pairing_product_buf(
                        v1b[:64 * h], v1i[:h], n2b, n2i, h)
                    d1r = _np.pairing_product_buf(
                        v1b[64 * h:], v1i[h:], n2b, n2i, h)
                    d2l = _np.pairing_product_buf(
                        n1b, n1i, v2b[:128 * h], v2i[:h], h)
                    d2r = _np.pairing_product_buf(
                        n1b, n1i, v2b[128 * h:], v2i[h:], h)
                for x in (d1l, d1r, d2l, d2r):
                    transcript.append_bytes(b"dory_d", gt_to_bytes(x))
                a_d1l.append(d1l)
                a_d1r.append(d1r)
                a_d2l.append(d2l)
                a_d2r.append(d2r)
                beta = transcript.challenge_scalar()
                binv = pow(beta, -1, P)
                (l1b, l1i), (l2b, l2i) = enc_level(j)
                with prof.span("open.A.g1fold"):
                    v1b, v1i = _np.g1_fold_buf(v1b, v1i, l1b, l1i, m, beta)
                with prof.span("open.A.g2fold"):
                    v2b, v2i = _np.g2_fold_buf(v2b, v2i, l2b, l2i, m, binv)
                with prof.span("open.A.pair"):
                    cplus = _np.pairing_product_buf(
                        v1b[:64 * h], v1i[:h], v2b[128 * h:], v2i[h:], h)
                    cminus = _np.pairing_product_buf(
                        v1b[64 * h:], v1i[h:], v2b[:128 * h], v2i[:h], h)
                transcript.append_bytes(b"dory_c", gt_to_bytes(cplus))
                transcript.append_bytes(b"dory_c", gt_to_bytes(cminus))
                a_cp.append(cplus)
                a_cm.append(cminus)
                alpha = transcript.challenge_scalar()
                ainv = pow(alpha, -1, P)
                with prof.span("open.A.g1fold"):
                    v1b, v1i = _np.g1_fold_buf(v1b[64 * h:], v1i[h:],
                                               v1b[:64 * h], v1i[:h],
                                               h, alpha)
                with prof.span("open.A.g2fold"):
                    v2b, v2i = _np.g2_fold_buf(v2b[128 * h:], v2i[h:],
                                               v2b[:128 * h], v2i[:h],
                                               h, ainv)
            fin_v1 = _np._g1_dec(v1b, v1i[0])
            fin_v2 = _np._g2_dec(v2b, v2i[0])
        else:
            with prof.span("open.e1"):
                e1 = host.g1_msm_pippenger(hint.rows, L)
            transcript.append_bytes(b"dory_e1", _g1_bytes(e1))
            v1 = list(hint.rows)
            with prof.span("open.A.v2init"):
                v2 = [g2_mul(s.g2star, li) for li in L]
            for j in range(s.nu):
                lev, nxt = s.levels[j], s.levels[j + 1]
                m = len(v1)
                h = m // 2
                with prof.span("open.A.pair"):
                    d1l = pairing_product(list(zip(v1[:h], nxt.g2)))
                    d1r = pairing_product(list(zip(v1[h:], nxt.g2)))
                    d2l = pairing_product(list(zip(nxt.g1, v2[:h])))
                    d2r = pairing_product(list(zip(nxt.g1, v2[h:])))
                for x in (d1l, d1r, d2l, d2r):
                    transcript.append_bytes(b"dory_d", gt_to_bytes(x))
                a_d1l.append(d1l)
                a_d1r.append(d1r)
                a_d2l.append(d2l)
                a_d2r.append(d2r)
                beta = transcript.challenge_scalar()
                binv = pow(beta, -1, P)
                with prof.span("open.A.g1fold"):
                    v1 = [host.g1_add(v, host.g1_mul(g, beta))
                          for v, g in zip(v1, lev.g1)]
                with prof.span("open.A.g2fold"):
                    v2 = [g2_add(v, g2_mul(g, binv))
                          for v, g in zip(v2, lev.g2)]
                with prof.span("open.A.pair"):
                    cplus = pairing_product(list(zip(v1[:h], v2[h:])))
                    cminus = pairing_product(list(zip(v1[h:], v2[:h])))
                transcript.append_bytes(b"dory_c", gt_to_bytes(cplus))
                transcript.append_bytes(b"dory_c", gt_to_bytes(cminus))
                a_cp.append(cplus)
                a_cm.append(cminus)
                alpha = transcript.challenge_scalar()
                ainv = pow(alpha, -1, P)
                with prof.span("open.A.g1fold"):
                    v1 = [host.g1_add(host.g1_mul(a, alpha), b)
                          for a, b in zip(v1[:h], v1[h:])]
                with prof.span("open.A.g2fold"):
                    v2 = [g2_add(g2_mul(a, ainv), b)
                          for a, b in zip(v2[:h], v2[h:])]
            fin_v1 = v1[0]
            fin_v2 = v2[0]
        transcript.append_bytes(b"dory_fin", _g1_bytes(fin_v1))
        transcript.append_bytes(b"dory_fin", _g2_bytes(fin_v2))

        # ---- phase B: fold s against (Gamma1, R) -----------------------
        # combined row s = L^T M: native mod-r kernels carry the per-entry
        # accumulation and the per-round vector folds / inner products;
        # sv / Rv / gam likewise stay as raw canonical buffers between
        # rounds on the native tier (sv doubles as the MSM scalar buffer).
        def _sv_python():
            sv = [0] * cols
            if parts is not None:
                for positions, w, values in parts:
                    for i, pos in enumerate(positions.tolist()):
                        c = w if values is None else w * values[i] % P
                        if c:
                            li = L[pos >> s.sigma]
                            if li:
                                jj = pos & (cols - 1)
                                sv[jj] = (sv[jj] + li * c) % P
            elif sparse:
                positions, values = coeffs
                for pos, c in zip(positions.tolist(), values):
                    if c:
                        li = L[pos >> s.sigma]
                        if li:
                            jj = pos & (cols - 1)
                            sv[jj] = (sv[jj] + li * c) % P
            else:
                for i, li in enumerate(L):
                    if li:
                        base = i * cols
                        for jj in range(cols):
                            c = coeffs[base + jj]
                            if c:
                                sv[jj] = (sv[jj] + li * c) % P
            return sv

        # On the K3 route Gamma1 and its folds stay on the device: each
        # round's MSMs read sv's canonical lanes as words, and only xl and
        # xr come back to the host, for the transcript
        b_xl, b_xr, b_yl, b_yr = [], [], [], []
        if self.k3:
            gamd = s.gamma1_on(self.device)
        if _np.available():
            with prof.span("open.B.row"):
                if parts is not None:
                    svb = _np.fr_combined_row_buf(parts, L, cols, s.sigma)
                else:
                    svb = _np.fr_enc(_sv_python())
            if not self.k3:
                gamb = self._gamma1_buf()
                gami = b"\x00" * cols
            Rb = _np.fr_enc(R)
            nsv = cols
            while nsv > 1:
                h = nsv // 2
                with prof.span("open.B.msm"):
                    if self.k3:
                        xl, xr = _b_msms_k3(gamd, svb, h)
                    else:
                        xl = _np.g1_msm_buf(gamb[64 * h:], gami[h:],
                                            svb[:32 * h])[0]
                        xr = _np.g1_msm_buf(gamb[:64 * h], gami[:h],
                                            svb[32 * h:])[0]
                yl = _np.fr_dot_buf(svb[:32 * h], Rb[32 * h:], h)
                yr = _np.fr_dot_buf(svb[32 * h:], Rb[:32 * h], h)
                transcript.append_bytes(b"dory_b", _g1_bytes(xl))
                transcript.append_bytes(b"dory_b", _g1_bytes(xr))
                transcript.append_scalar(b"dory_b", yl)
                transcript.append_scalar(b"dory_b", yr)
                b_xl.append(xl)
                b_xr.append(xr)
                b_yl.append(yl)
                b_yr.append(yr)
                alpha = transcript.challenge_scalar()
                ainv = pow(alpha, -1, P)
                svb = _np.fr_fold_buf(svb[:32 * h], svb[32 * h:], alpha, h)
                with prof.span("open.B.g1fold"):
                    if self.k3:
                        gamd = _b_fold_k3(gamd, h, ainv)
                    else:
                        gamb, gami = _np.g1_fold_buf(
                            gamb[64 * h:], gami[h:], gamb[:64 * h],
                            gami[:h], h, ainv)
                Rb = _np.fr_fold_buf(Rb[:32 * h], Rb[32 * h:], ainv, h)
                nsv = h
            b_final_s = int.from_bytes(svb[:32], "little")
        else:
            with prof.span("open.B.row"):
                sv = _sv_python()
            gam = None if self.k3 else list(s.gamma1)
            Rv = list(R)
            while len(sv) > 1:
                h = len(sv) // 2
                with prof.span("open.B.msm"):
                    if self.k3:
                        xl, xr = _b_msms_k3(gamd, _np.fr_enc(sv), h)
                    else:
                        xl = host.g1_msm_pippenger(gam[h:], sv[:h])
                        xr = host.g1_msm_pippenger(gam[:h], sv[h:])
                yl = sum(a * b for a, b in zip(sv[:h], Rv[h:])) % P
                yr = sum(a * b for a, b in zip(sv[h:], Rv[:h])) % P
                transcript.append_bytes(b"dory_b", _g1_bytes(xl))
                transcript.append_bytes(b"dory_b", _g1_bytes(xr))
                transcript.append_scalar(b"dory_b", yl)
                transcript.append_scalar(b"dory_b", yr)
                b_xl.append(xl)
                b_xr.append(xr)
                b_yl.append(yl)
                b_yr.append(yr)
                alpha = transcript.challenge_scalar()
                ainv = pow(alpha, -1, P)
                sv = [(alpha * a + b) % P for a, b in zip(sv[:h], sv[h:])]
                with prof.span("open.B.g1fold"):
                    if self.k3:
                        gamd = _b_fold_k3(gamd, h, ainv)
                    else:
                        gam = [host.g1_add(host.g1_mul(a, ainv), b)
                               for a, b in zip(gam[:h], gam[h:])]
                Rv = [(ainv * a + b) % P for a, b in zip(Rv[:h], Rv[h:])]
            b_final_s = sv[0]
        transcript.append_scalar(b"dory_bs", b_final_s)

        return DoryProof(e1=e1, a_d1l=a_d1l, a_d1r=a_d1r, a_d2l=a_d2l,
                         a_d2r=a_d2r, a_cplus=a_cp, a_cminus=a_cm,
                         a_final_v1=fin_v1, a_final_v2=fin_v2,
                         b_xl=b_xl, b_xr=b_xr, b_yl=b_yl, b_yr=b_yr,
                         b_final_s=b_final_s)

    # ---- verify --------------------------------------------------------

    def verify(self, commitment: DoryCommitment, point: Sequence[int],
               value: int, proof: DoryProof,
               transcript: Blake2bTranscript) -> bool:
        s = self.setup
        if len(proof.a_d1l) != s.nu or len(proof.b_xl) != s.sigma:
            return False
        if proof.e1 is not None and not host.g1_is_on_curve(proof.e1):
            return False
        r_row, r_col = point[:s.nu], point[s.nu:]
        L = _eq_tensor(r_row)
        transcript.append_bytes(b"dory_e1", _g1_bytes(proof.e1))

        # ---- phase A verifier ------------------------------------------
        lev0 = s.levels[0]
        # D2 = <Gamma1A, L (.) g2star> = e(sum L_i Gamma1A_i, g2star)
        acc = host.g1_msm_pippenger(lev0.g1, L)
        d1 = commitment.c
        d2 = tate_pairing(acc, s.g2star)
        c_ip = tate_pairing(proof.e1, s.g2star)
        for j in range(s.nu):
            lev = s.levels[j]
            d1l, d1r = proof.a_d1l[j], proof.a_d1r[j]
            d2l, d2r = proof.a_d2l[j], proof.a_d2r[j]
            for x in (d1l, d1r, d2l, d2r):
                transcript.append_bytes(b"dory_d", gt_to_bytes(x))
            beta = transcript.challenge_scalar()
            binv = pow(beta, -1, P)
            cplus, cminus = proof.a_cplus[j], proof.a_cminus[j]
            transcript.append_bytes(b"dory_c", gt_to_bytes(cplus))
            transcript.append_bytes(b"dory_c", gt_to_bytes(cminus))
            alpha = transcript.challenge_scalar()
            ainv = pow(alpha, -1, P)
            c_ip = (c_ip * gt_exp(d2, beta) * gt_exp(d1, binv) * lev.chi
                    * gt_exp(cplus, alpha) * gt_exp(cminus, ainv))
            d1 = (gt_exp(d1l, alpha) * d1r
                  * gt_exp(lev.d1l, alpha * beta % P)
                  * gt_exp(lev.d1r, beta))
            d2 = (gt_exp(d2l, ainv) * d2r
                  * gt_exp(lev.d2l, ainv * binv % P)
                  * gt_exp(lev.d2r, binv))
        u1, u2 = proof.a_final_v1, proof.a_final_v2
        if u1 is not None and not host.g1_is_on_curve(u1):
            return False
        if u2 is not None and not g2_in_subgroup(u2):
            # full subgroup check: the ate pairing is only defined on the
            # r-torsion eigenspace; an adversarial off-subgroup u2 must
            # be rejected, not fed to the Miller loop
            return False
        transcript.append_bytes(b"dory_fin", _g1_bytes(u1))
        transcript.append_bytes(b"dory_fin", _g2_bytes(u2))
        fin = s.levels[s.nu]
        if not tate_pairing(u1, fin.g2[0]) == d1:
            return False
        if not tate_pairing(fin.g1[0], u2) == d2:
            return False
        if not tate_pairing(u1, u2) == c_ip:
            return False

        # ---- phase B verifier ------------------------------------------
        # Succinct form: the per-round generator/tensor folds are never
        # materialized.  The folded eq tensor has the closed form
        # prod_j (ainv_j*(1-r_j) + r_j) (eq tensors stay scaled tensors
        # under the fold), and the folded generator vector is ONE Pippenger
        # MSM over Gamma1 with tensor weights w_m = prod_{i: bit_i(m)=0}
        # ainv_i -- O(sigma) field work in the loop, a single O(2^sigma /
        # log) MSM at the end (vs sigma full-length G1 fold passes).
        E = proof.e1
        y = value % P
        alphas, ainvs = [], []
        for j in range(s.sigma):
            xl, xr = proof.b_xl[j], proof.b_xr[j]
            if xl is not None and not host.g1_is_on_curve(xl):
                return False
            if xr is not None and not host.g1_is_on_curve(xr):
                return False
            yl, yr = proof.b_yl[j] % P, proof.b_yr[j] % P
            transcript.append_bytes(b"dory_b", _g1_bytes(xl))
            transcript.append_bytes(b"dory_b", _g1_bytes(xr))
            transcript.append_scalar(b"dory_b", yl)
            transcript.append_scalar(b"dory_b", yr)
            alpha = transcript.challenge_scalar()
            ainv = pow(alpha, -1, P)
            alphas.append(alpha)
            ainvs.append(ainv)
            E = host.g1_add(E, host.g1_add(host.g1_mul(xl, alpha),
                                           host.g1_mul(xr, ainv)))
            y = (y + alpha * yl + ainv * yr) % P
        transcript.append_scalar(b"dory_bs", proof.b_final_s)
        sf = proof.b_final_s % P
        # folded eq tensor: closed form over the column variables
        r_eq = 1
        for ainv, rj in zip(ainvs, r_col):
            r_eq = r_eq * ((ainv * ((1 - rj) % P) + rj) % P) % P
        if sf * r_eq % P != y:
            return False
        # folded generators: tensor-weight MSM, w_m = prod over the bits
        # of m (MSB-first) of ainv_i when bit_i(m) = 0 (round i halves on
        # the then-top bit, so round 0's challenge rides the MSB)
        w = [1]
        for ainv in reversed(ainvs):
            w = [x * ainv % P for x in w] + w
        if host.g1_msm_pippenger(s.gamma1, [sf * x % P for x in w]) != E:
            return False
        return True


def _words_on(buf: bytes, device) -> torch.Tensor:
    """Canonical 32-byte little-endian lanes -> (8, n) int32 words on
    `device` (no Python ints)."""
    import numpy as np
    lanes = np.frombuffer(buf, "<u4").view(np.int32).reshape(-1, N_LIMBS)
    return ops.upload(lanes.copy(), device).t()


def _b_msms_k3(gam, svb: bytes, h: int):
    """Phase B's xl = <gam[h:], sv[:h]> and xr = <gam[:h], sv[h:]> on K3
    (one `g1.msm_rows` over the swapped halves of the affine batch gam,
    sv's 2h canonical lanes `svb` as words), as affine host points."""
    from ..curve import g1 as g1dev
    words = _words_on(svb, gam[0].device).reshape(N_LIMBS, 2, h)
    swapped = tuple(c.reshape(N_LIMBS, 2, h).flip(1) for c in gam)
    xl, xr = g1dev.unpack_points(g1dev.msm_rows(swapped, words, FR_BITS))
    return xl, xr


def _b_fold_k3(gam, h: int, ainv: int):
    """Phase B's Gamma1 fold gam' = ainv gam[:h] + gam[h:] on K3: one
    scalar_mul with the scalar broadcast, one add, and a normalize (the
    next round's MSMs take affine bases)."""
    from ..curve import g1 as g1dev
    words = _words_on(ainv.to_bytes(32, "little"),
                      gam[0].device).expand(N_LIMBS, h)
    prod = g1dev.batch_scalar_mul(tuple(c[:, :h] for c in gam), words,
                                  FR_BITS)
    return g1dev.normalize(g1dev.jacobian_add(
        prod, tuple(c[:, h:] for c in gam)))


def _tier2_gt(dory: "Dory", rows) -> Fq12:
    """Tier-2 AFGHO commitment GT element: prod e(rows_i, gamma2_i).

    Buffer-level native tier with the encoded gamma2 cached on the Dory
    instance (one G2 encode per setup instead of per commit); the
    point-list tier remains the no-native fallback and computes the
    identical GT element (reference: jolt-dory routines.rs tier-2)."""
    from ..curve import native_pairing as _np
    gamma2 = dory.setup.levels[0].g2
    if not _np.available():
        return pairing_product([(r, g) for r, g in zip(rows, gamma2)
                                if r is not None])
    enc = dory.__dict__.get("_g2l0_enc")
    if enc is None:
        with _prof_active().span("encode.setup"):
            enc = dory.__dict__["_g2l0_enc"] = _np.g2_enc_many(gamma2)
    g2b, g2i = enc
    rb, ri = _np._g1_enc_many(rows)
    return _np.pairing_product_buf(rb, ri, g2b, g2i, len(ri))
