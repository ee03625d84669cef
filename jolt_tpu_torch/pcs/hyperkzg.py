"""HyperKZG multilinear PCS (Gemini fold over univariate KZG).

Reference: `crates/jolt-hyperkzg/src/lib.rs:10-21` -- "commit = MSM vs SRS;
open = l-1 folds + batch KZG at {r, -r, r^2}".

Scheme:
  * commit(P): treat the 2^l MLE evaluations as univariate coefficients;
    C = sum_i P[i] * tau^i * G1  (device MSM).
  * open(P, point, v): fold the coefficient vector binding the LSB variable
    to u_i = point[l-1-i] each step: f_{i+1} = (1-u_i)*even(f_i) +
    u_i*odd(f_i); commit each intermediate fold; draw r; send evals of every
    f_i at {r, -r, r^2}; batch all (poly, point, eval) KZG openings with
    challenge powers into 3 quotient witnesses; verify with 2 pairings.

The trusted setup here generates the SRS from an in-process tau --
STRUCTURALLY complete but NOT a secure ceremony; the production path is
Dory (transparent), which replaces this scheme without touching callers.

Copied from the JAX package's `pcs/hyperkzg.py`; `open`'s and `verify`'s
host algebra (Python ints) is unchanged.  What differs:

  * `KZGSetup` keeps its powers as an affine batch of the port's G1
    (`curve/g1.py`, 8 x 32-bit Fq limbs, Z = R mod q) on a device.
    `generate(max_len, tau, device)` builds them on the card with one K3
    scalar-mul launch and one K3 normalize launch; on the CPU from the
    host's scalar multiplications (the native library, else `bn254_host`),
    since the plain G1 takes seconds a step there.  Both cache under the
    port's gitignored ``_build/srs/`` in the port's own layout, tagged
    "affine" in the file name (never the JAX package's ``.srs_cache``:
    20 x 13-bit limbs, R = 2^260).  `to(device)` gives the same setup on
    another device.
  * `commit_ints` runs the device MSM (`g1.msm`: Pippenger on the card
    from the scalar words to the point) when the powers live on the card,
    and `bn254_host.g1_msm_pippenger` when they live on the CPU (the JAX
    package's CPU-backend tier); it commits the coefficients as given,
    where the JAX package zero-pads them to the SRS length to share one
    compiled shape (zero coefficients add nothing).  `commit_positions`
    commits a 0/1 vector by its ones: on the card one `g1.bucket_sum` of
    one segment.
  * the scalars' words come from `field.ops.words_of_ints`, one join of
    the little-endian bytes (a Python loop over 2^20 scalars took seconds
    a commit).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..curve import bn254_host as host
from ..curve import g1 as g1dev
from ..curve.pairing import G2_GEN, G2Point, g2_mul, pairing_product_is_one
from ..field import ops
from ..field.ops import words_of_ints
from ..field.params import FR_MODULUS as P
from ..transcript import Blake2bTranscript
from ..utils.profiling import active as _prof_active

SRS_CACHE_DIR = os.path.join(os.path.dirname(__file__), "..", "_build", "srs")
DEFAULT_TAU = 0x1234567890ABCDEF1122334455667788


@dataclasses.dataclass
class KZGSetup:
    g1_powers: Optional[List[host.Point]]  # host affine (lazy)
    g1_powers_dev: tuple               # (X, Y, Z) affine batch on a device
    tau_g2: G2Point                    # [tau] G2

    @property
    def size(self) -> int:
        return self.g1_powers_dev[0].shape[-1]

    @property
    def device(self) -> torch.device:
        return self.g1_powers_dev[0].device

    def host_powers(self) -> List[host.Point]:
        if self.g1_powers is None:
            self.g1_powers = g1dev.unpack_points(self.g1_powers_dev)
        return self.g1_powers

    def to(self, device) -> "KZGSetup":
        """This setup with its powers on `device` (itself when they are
        there already)."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if self.device == device:
            return self
        return KZGSetup(g1_powers=self.g1_powers,
                        g1_powers_dev=tuple(ops.upload(c, device)
                                            for c in self.g1_powers_dev),
                        tau_g2=self.tau_g2)

    @classmethod
    def generate(cls, max_len: int, tau: int = None, device="cuda",
                 cache_dir: Optional[str] = None) -> "KZGSetup":
        """Toy ceremony: derives tau in-process (INSECURE; test/dev tier).

        [tau^i] G1 for i < max_len, affine: on the card one K3 scalar-mul
        launch over max_len lanes and one normalize launch; on the CPU the
        host's scalar multiplications.  Cached per (size, tau) under
        ``_build/srs/`` (or `cache_dir`), written atomically; the file
        name says the layout, so a cache of Jacobian powers is never read
        as affine."""
        tau = tau if tau is not None else DEFAULT_TAU
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not "
                               "available")
        cache_dir = SRS_CACHE_DIR if cache_dir is None else cache_dir
        cache = os.path.join(cache_dir,
                             f"kzg_torch_affine_{max_len}_"
                             f"{tau % 997_651}.npz")
        tau_g2 = g2_mul(G2_GEN, tau)
        if os.path.exists(cache):
            with np.load(cache) as data:
                powers = tuple(ops.upload(data[k], device)
                               for k in ("x", "y", "z"))
            g1dev.check_affine(powers, cache)
            return cls(g1_powers=None, g1_powers_dev=powers, tau_g2=tau_g2)
        scalars = []
        acc = 1
        for _ in range(max_len):
            scalars.append(acc)
            acc = acc * tau % P
        g1_powers = None
        if device.type == "cuda":
            base = tuple(c.expand(-1, max_len) for c in
                         g1dev.pack_points([host.G1_GEN], device))
            words = ops.upload(np.array(
                words_of_ints(scalars)).view(np.int32), device)
            powers = g1dev.normalize(g1dev.batch_scalar_mul(base, words,
                                                            254))
        else:
            g1_powers = _host_mul(host.G1_GEN, scalars)
            powers = g1dev.pack_points(g1_powers, device)
        os.makedirs(cache_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".npz", dir=cache_dir)
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **{k: ops.host(c)
                               for k, c in zip(("x", "y", "z"), powers)})
            os.replace(tmp, cache)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return cls(g1_powers=g1_powers, g1_powers_dev=powers, tau_g2=tau_g2)


def _host_mul(p: host.Point, scalars: Sequence[int]) -> List[host.Point]:
    """[k] p for each k on the host: the native library's MSM of one point
    where it loads, else `bn254_host.g1_mul`."""
    from ..curve import native_pairing as npair
    if npair.available():
        return [npair.g1_msm([p], [k])[0] for k in scalars]
    return [host.g1_mul(p, k) for k in scalars]


@dataclasses.dataclass
class HyperKZGProof:
    fold_commitments: List[host.Point]          # commitments to f_1..f_{l-1}
    evals: List[List[int]]                      # per f_i: [f_i(r), f_i(-r), f_i(r^2)]
    witnesses: List[host.Point]                 # KZG quotients for {r, -r, r^2}


def _uni_eval(coeffs: Sequence[int], z: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * z + c) % P
    return acc


def _kzg_quotient(coeffs: Sequence[int], z: int) -> List[int]:
    """w(X) = (f(X) - f(z)) / (X - z) by synthetic division:
    w_{n-2} = f_{n-1};  w_{i-1} = f_i + z*w_i."""
    n = len(coeffs)
    if n <= 1:
        return [0]
    w = [0] * (n - 1)
    w[n - 2] = coeffs[n - 1] % P
    for i in range(n - 2, 0, -1):
        w[i - 1] = (coeffs[i] + z * w[i]) % P
    return w


def _absorb_point(transcript: Blake2bTranscript, label: bytes,
                  p: host.Point) -> None:
    """Absorb full affine coordinates (Fq values; 64 bytes, BE)."""
    if p is None:
        transcript.append_bytes(label, b"\x00" * 64)
    else:
        transcript.append_bytes(
            label, p[0].to_bytes(32, "big") + p[1].to_bytes(32, "big"))


class HyperKZG:
    def __init__(self, setup: KZGSetup, device=None):
        """`device`: where the MSMs run (the setup's powers are moved there
        at the first commit); None keeps the setup's own device."""
        self.setup = setup
        self.device = None if device is None else torch.device(device)
        self._moved: Optional[KZGSetup] = None

    def _powers_setup(self) -> KZGSetup:
        """The setup with its powers on this scheme's device."""
        if self.device is None:
            return self.setup
        if self._moved is None:
            self._moved = self.setup.to(self.device)
        return self._moved

    # ---- commit --------------------------------------------------------

    def commit_ints(self, coeffs: Sequence[int], bits: int = 254) -> host.Point:
        """MSM of the coefficient vector against the SRS: the device MSM
        (`g1.msm`: Pippenger at full width, the subset sum at bits = 1)
        on the card, `bn254_host.g1_msm_pippenger` on the CPU."""
        s = self._powers_setup()
        n = s.size
        assert len(coeffs) <= n, "poly larger than SRS"
        with _prof_active().span("kzg.commit"):
            if s.device.type == "cpu":
                return host.g1_msm_pippenger(
                    s.host_powers()[:len(coeffs)], coeffs)
            m = len(coeffs)
            if m == 0:
                return None
            pts = tuple(c[:, :m] for c in s.g1_powers_dev)
            acc = g1dev.msm(pts, words_of_ints(coeffs), bits)
            return g1dev.unpack_points(acc)[0]

    def commit_positions(self, positions) -> host.Point:
        """The commitment to the 0/1 vector with ones at `positions`: the
        sum of the SRS powers there (on the card one `g1.bucket_sum` of
        one segment over the powers, on the CPU the host's sum)."""
        s = self._powers_setup()
        pos = np.unique(np.asarray(positions, np.int64))
        assert len(pos) == 0 or pos[-1] < s.size, "poly larger than SRS"
        with _prof_active().span("kzg.commit"):
            if s.device.type == "cpu":
                hp = s.host_powers()
                return host.g1_msm_pippenger([hp[i] for i in pos.tolist()],
                                             [1] * len(pos))
            if len(pos) == 0:
                return None
            lanes = ops.upload(pos.astype(np.int32), s.device)
            total = g1dev.bucket_sum(s.g1_powers_dev, lanes,
                                     ops.upload([0, len(pos)], s.device))
            return g1dev.unpack_points(total)[0]

    # ---- open ----------------------------------------------------------

    def open(self, coeffs: Sequence[int], point: Sequence[int], value: int,
             transcript: Blake2bTranscript) -> HyperKZGProof:
        prof = _prof_active()
        ell = len(point)
        assert len(coeffs) == 1 << ell
        us = [point[ell - 1 - i] for i in range(ell)]  # LSB-first binding

        with prof.span("kzg.open.folds"):
            polys = [list(coeffs)]
            for u in us[:-1]:
                f = polys[-1]
                nxt = [((1 - u) * f[2 * j] + u * f[2 * j + 1]) % P
                       for j in range(len(f) // 2)]
                polys.append(nxt)
            # final fold sanity: one more bind yields the claimed value
            f = polys[-1]
            u = us[-1]
            assert ((1 - u) * f[0] + u * f[1]) % P == value % P, \
                "bad opening value"

        fold_commitments = [self.commit_ints(fp) for fp in polys[1:]]
        for cpt in fold_commitments:
            _absorb_point(transcript, b"hkzg_fold", cpt)
        r = transcript.challenge_scalar()

        with prof.span("kzg.open.evals"):
            points3 = [r, (-r) % P, r * r % P]
            evals = [[_uni_eval(fp, z) for z in points3] for fp in polys]
        for ev in evals:
            transcript.append_scalars(b"hkzg_evals", ev)

        # batch the per-point openings: B = sum_i q^i f_i opened at each z
        q = transcript.challenge_scalar()
        with prof.span("kzg.open.quotients"):
            batched = [0] * len(coeffs)
            qp = 1
            for fp in polys:
                for j, c in enumerate(fp):
                    batched[j] = (batched[j] + qp * c) % P
                qp = qp * q % P
            quotients = [_kzg_quotient(batched, z) for z in points3]
        witnesses = [self.commit_ints(w) for w in quotients]
        for w in witnesses:
            _absorb_point(transcript, b"hkzg_witness", w)
        return HyperKZGProof(fold_commitments, evals, witnesses)

    # ---- verify --------------------------------------------------------

    def verify(self, commitment: host.Point, point: Sequence[int], value: int,
               proof: HyperKZGProof, transcript: Blake2bTranscript) -> bool:
        ell = len(point)
        us = [point[ell - 1 - i] for i in range(ell)]
        # shape checks: a proof missing witnesses/evals would silently skip
        # pairing terms and leave the -r / r^2 evals commitment-unbound
        if len(proof.fold_commitments) != ell - 1 or len(proof.evals) != ell:
            return False
        if len(proof.witnesses) != 3 or any(len(ev) != 3 for ev in proof.evals):
            return False
        # prover-supplied group elements must be on-curve (None = identity)
        for pt in ([commitment] + list(proof.fold_commitments)
                   + list(proof.witnesses)):
            if pt is not None and not host.g1_is_on_curve(pt):
                return False

        for cpt in proof.fold_commitments:
            _absorb_point(transcript, b"hkzg_fold", cpt)
        r = transcript.challenge_scalar()
        points3 = [r, (-r) % P, r * r % P]

        two_inv = pow(2, -1, P)
        rinv2 = pow(2 * r, -1, P)
        # fold-consistency: f_{i+1}(r^2) = (1-u)(f_i(r)+f_i(-r))/2
        #                                + u (f_i(r)-f_i(-r))/(2r)
        for i in range(ell):
            fr, fmr, fr2 = proof.evals[i]
            nxt = ((1 - us[i]) * (fr + fmr) % P * two_inv
                   + us[i] * (fr - fmr) % P * rinv2) % P
            if i + 1 < ell:
                if nxt != proof.evals[i + 1][2]:
                    return False
            else:
                if nxt != value % P:
                    return False
        for ev in proof.evals:
            transcript.append_scalars(b"hkzg_evals", ev)

        q = transcript.challenge_scalar()
        for w in proof.witnesses:
            _absorb_point(transcript, b"hkzg_witness", w)

        # batched commitment B = sum q^i C_i and batched evals at each z
        commitments = [commitment] + list(proof.fold_commitments)
        B: host.Point = None
        qp = 1
        b_evals = [0, 0, 0]
        for C, ev in zip(commitments, proof.evals):
            B = host.g1_add(B, host.g1_mul(C, qp))
            for t in range(3):
                b_evals[t] = (b_evals[t] + qp * ev[t]) % P
            qp = qp * q % P

        # combined KZG check with challenge d (2 pairings):
        # e( sum d^j (B - y_j G + z_j W_j), G2 ) * e( -sum d^j W_j, tau G2 ) = 1
        d = transcript.challenge_scalar()
        left: host.Point = None
        wsum: host.Point = None
        dp = 1
        for (z, y, W) in zip(points3, b_evals, proof.witnesses):
            term = host.g1_add(B, host.g1_neg(host.g1_mul(host.G1_GEN, y)))
            term = host.g1_add(term, host.g1_mul(W, z))
            left = host.g1_add(left, host.g1_mul(term, dp))
            wsum = host.g1_add(wsum, host.g1_mul(W, dp))
            dp = dp * d % P
        return pairing_product_is_one([
            (left, G2_GEN),
            (host.g1_neg(wsum), self.setup.tau_g2),
        ])
