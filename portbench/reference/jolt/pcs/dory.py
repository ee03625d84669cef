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

import contextlib
import dataclasses
import hashlib
import multiprocessing
import os
import pickle
import tempfile
from typing import List, Optional, Sequence


from ..curve import bn254_host as host
from ..curve.fq_tower import Fq2, Fq12
from ..curve.pairing import (g2_in_subgroup, g2_mul_unreduced, pairing_product,
                             tate_pairing)
from ..field.params import FQ_MODULUS as Q
from ..field.params import FR_MODULUS as P


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
    return f.pow(e % P)


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
        if module.startswith(__name__.rsplit(".", 2)[0] + "."):
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
    """The Dory verifier (the copy keeps no prover); `device` is taken
    for the scheme seam's signature and unused: the verifier's work is
    host work on Python ints."""

    def __init__(self, setup: DorySetup, device="cpu"):
        self.setup = setup
        self.device = device

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

        # ---- phase A's transcript: every round's challenges -------------
        # (the group work below reads them; none of it feeds the
        # transcript, so it runs afterwards, in parallel where a pool is
        # set: see `parallel`)
        rounds = []                       # (beta, binv, alpha, ainv)
        for j in range(s.nu):
            for x in (proof.a_d1l[j], proof.a_d1r[j], proof.a_d2l[j],
                      proof.a_d2r[j]):
                transcript.append_bytes(b"dory_d", gt_to_bytes(x))
            beta = transcript.challenge_scalar()
            transcript.append_bytes(b"dory_c", gt_to_bytes(proof.a_cplus[j]))
            transcript.append_bytes(b"dory_c",
                                    gt_to_bytes(proof.a_cminus[j]))
            alpha = transcript.challenge_scalar()
            rounds.append((beta, pow(beta, -1, P), alpha, pow(alpha, -1, P)))
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

        # ---- phase B's transcript ---------------------------------------
        E = proof.e1
        y = value % P
        ainvs = []
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

        # ---- phase A's group work ---------------------------------------
        # round j: c_ip *= d2^beta d1^binv chi cplus^alpha cminus^ainv with
        # the previous round's d1, d2 (at j = 0: the commitment and
        # e(<Gamma1A, L>, g2star)), then d1 = d1l^alpha d1r D1L^(alpha
        # beta) D1R^beta and d2 = d2l^ainv d2r D2L^(ainv binv) D2R^binv
        fin = s.levels[s.nu]
        lev0 = s.levels[0]
        exps = []
        for j, (beta, binv, alpha, ainv) in enumerate(rounds):
            lev = s.levels[j]
            exps += [(proof.a_d1l[j], alpha), (lev.d1l, alpha * beta),
                     (lev.d1r, beta), (proof.a_d2l[j], ainv),
                     (lev.d2l, ainv * binv), (lev.d2r, binv),
                     (proof.a_cplus[j], alpha), (proof.a_cminus[j], ainv)]
        pairs = [(proof.e1, s.g2star), (u1, fin.g2[0]), (fin.g1[0], u2),
                 (u1, u2)]
        # phase B: the folded generators, a tensor-weight MSM over Gamma1,
        # w_m = prod over the bits of m (MSB-first) of ainv_i when
        # bit_i(m) = 0 (round i halves on the then-top bit, so round 0's
        # challenge rides the MSB)
        w = [1]
        for ainv in reversed(ainvs):
            w = [x * ainv % P for x in w] + w
        msm_a = _msm_tasks(lev0.g1, L)
        msm_b = _msm_tasks(s.gamma1, [sf * x % P for x in w])
        # the longest tasks first, so the workers finish together
        out = _run([(host.g1_msm_pippenger, a) for a in msm_b + msm_a]
                   + [(tate_pairing, a) for a in pairs]
                   + [(gt_exp, a) for a in exps])
        n_b, n_ab = len(msm_b), len(msm_b) + len(msm_a)
        if _g1_sum(out[:n_b]) != E:
            return False
        acc = _g1_sum(out[n_b:n_ab])
        c_ip, e_u1, e_u2, e_uu = out[n_ab:n_ab + 4]
        powed = out[n_ab + 4:]
        d1s, d2s = [commitment.c], []
        for j in range(s.nu):
            p = powed[8 * j:8 * j + 8]
            d1s.append(p[0] * proof.a_d1r[j] * p[1] * p[2])
            d2s.append(p[3] * proof.a_d2r[j] * p[4] * p[5])
        d2s.insert(0, tate_pairing(acc, s.g2star))
        prev = _run([(gt_exp, (d2s[j], rounds[j][0])) for j in range(s.nu)]
                    + [(gt_exp, (d1s[j], rounds[j][1]))
                       for j in range(s.nu)])
        for j in range(s.nu):
            p = powed[8 * j:8 * j + 8]
            c_ip = (c_ip * prev[j] * prev[s.nu + j] * s.levels[j].chi
                    * p[6] * p[7])
        return (e_u1 == d1s[s.nu] and e_u2 == d2s[s.nu]
                and e_uu == c_ip)


# The verifier's group work (GT powers, pairings, MSM chunks) runs in this
# pool of worker processes while `parallel` holds it open, else here.
_POOL, _WORKERS = None, 1
POOL_TIMEOUT_S = 300


@contextlib.contextmanager
def parallel(workers: int):
    """Runs `Dory.verify`'s group work in `workers` forked processes
    (Python ints only, so a fork of a process with a card is safe), and
    stops and joins them on exit."""
    global _POOL, _WORKERS
    if workers <= 1:
        yield
        return
    pool = multiprocessing.get_context("fork").Pool(workers)
    _POOL, _WORKERS = pool, workers
    try:
        yield
    finally:
        _POOL, _WORKERS = None, 1
        pool.close()
        pool.join()         # returns at once where `_run` stopped it


def _run(tasks):
    """[fn(*args) for fn, args in tasks], in the pool where one is set.  A
    pool that gives no answer within POOL_TIMEOUT_S is stopped and the
    work is done here: a slower check, never a hung one."""
    global _POOL, _WORKERS
    if _POOL is not None:
        try:
            return _POOL.starmap_async(_call, tasks, chunksize=1).get(
                POOL_TIMEOUT_S)
        except multiprocessing.TimeoutError:
            _POOL.terminate()
            _POOL.join()
            _POOL, _WORKERS = None, 1
    return [fn(*args) for fn, args in tasks]


def _call(fn, args):
    return fn(*args)


def _msm_tasks(points, scalars):
    """An MSM's arguments, split into one contiguous chunk a worker."""
    step = -(-len(points) // _WORKERS)
    return [(points[i:i + step], scalars[i:i + step])
            for i in range(0, len(points), step)]


def _g1_sum(points):
    acc = None
    for q in points:
        acc = host.g1_add(acc, q)
    return acc
