"""Scheme-agnostic PCS seam for the prover/verifier.

The reference routes every commitment through the `CommitmentScheme` /
`AdditivelyHomomorphic` trait tree (`crates/jolt-openings/src/lib.rs:20-37`)
so Dory (production, transparent setup) and HyperKZG (trusted setup) are
interchangeable behind the stage-0 commit and stage-8 joint opening.  This
module is that seam for the TPU stack:

  * `commit(name, coeffs, bits)`   -> wire commitment (absorbable object)
  * `absorb(transcript, comm)`        transcript framing per scheme
  * `open_rlc(weights, rlc, point, value, transcript)` -> opening proof for
       the mu-RLC of the named committed polynomials at one point
       (prover side; may use per-name prover hints retained from commit)
  * `combine(commitments, weights)`-> homomorphically combined commitment
  * `verify_rlc(joint, point, value, proof, transcript)` -> bool

Point convention (both schemes): point[0] binds the MOST significant index
bit (big-endian variables), matching the stage-8 reduction's r*.

`make_scheme` keeps call sites simple: a raw `KZGSetup`/`DorySetup` is
wrapped in the matching scheme; a scheme instance passes through; None
means sumcheck-only mode (no commitment layer).

Copied from the JAX package's `pcs/scheme.py`.  What differs: every
scheme takes the `device` its device work runs on (`make_scheme(setup,
device="cuda")`; `prove` passes its own), never chosen by whether a card
is present: HyperKZG's MSMs run there, and Dory's G1 work (one-hot tier
1, the dense commits, the opening's phase B) takes K3 on a CUDA device
and the native library on the CPU (`pcs/dory.py`).
`HyperKZGScheme.commit_sparse` commits the 0/1 vector by its ones
(`HyperKZG.commit_positions`, the same commitment as the JAX package's
dense 1-bit commit).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from ..curve import bn254_host as host
from ..field.params import FR_MODULUS as P
from ..transcript import Blake2bTranscript
from .dory import (Dory, DoryCommitment, DoryHint, DorySetup, gt_exp, gt_mul,
                   gt_to_bytes)
from .hyperkzg import HyperKZG, KZGSetup, _absorb_point


class HyperKZGScheme:
    """HyperKZG behind the seam (alternative scheme; trusted setup)."""

    name = "hyperkzg"

    def __init__(self, setup: KZGSetup, device="cuda"):
        self.pcs = HyperKZG(setup, device)
        self.setup = setup

    def setup_digest(self) -> bytes:
        """Stable identity of this setup's parameters (cache keying --
        distinct setups MUST produce distinct digests)."""
        import hashlib as _hl
        h = _hl.blake2b(b"hyperkzg", digest_size=16)
        h.update(self.setup.size.to_bytes(8, "big"))
        tg = self.setup.tau_g2
        for c in (tg[0].a, tg[0].b, tg[1].a, tg[1].b):
            h.update(int(c).to_bytes(32, "big"))
        return h.digest()

    def commit(self, name: str, coeffs: Sequence[int], bits: int = 254):
        return self.pcs.commit_ints(coeffs, bits=bits)

    def commit_sparse(self, name: str, positions, length: int):
        """0/1 vector by nonzero positions: the sum of the SRS powers at
        them (the secondary scheme has no tier structure)."""
        assert len(positions) == 0 or int(max(positions)) < length
        return self.pcs.commit_positions(positions)

    def absorb(self, transcript: Blake2bTranscript, comm) -> None:
        _absorb_point(transcript, b"commitment", comm)

    def open_rlc(self, weights: Dict[str, int], rlc,
                 point: Sequence[int], value: int,
                 transcript: Blake2bTranscript):
        if isinstance(rlc, tuple):   # sparse (positions, values)
            positions, values = rlc
            dense = [0] * (1 << len(point))
            for pos, v in zip(positions.tolist(), values):
                dense[pos] = (dense[pos] + v) % P
            rlc = dense
        elif isinstance(rlc, list) and rlc and isinstance(rlc[0], tuple) \
                and len(rlc[0]) == 3:   # weighted parts (stage-8 RLC)
            dense = [0] * (1 << len(point))
            for positions, w, values in rlc:
                for i, pos in enumerate(positions.tolist()):
                    v = w if values is None else w * values[i] % P
                    dense[pos] = (dense[pos] + v) % P
            rlc = dense
        return self.pcs.open(rlc, point, value, transcript)

    def combine(self, commitments: Dict[str, object],
                weights: Dict[str, int]):
        joint = None
        for name, w in weights.items():
            c = commitments[name]
            if c is not None and not host.g1_is_on_curve(c):
                return None  # poisoned joint -> verify_rlc rejects
            joint = host.g1_add(joint, host.g1_mul(c, w))
        return joint

    def verify_rlc(self, joint, point: Sequence[int], value: int, proof,
                   transcript: Blake2bTranscript) -> bool:
        return self.pcs.verify(joint, point, value, proof, transcript)


class DoryScheme:
    """Dory behind the seam (production scheme; transparent setup).

    Prover hints (tier-1 row commitments) are retained per polynomial name
    so the stage-8 RLC opening combines G1 rows homomorphically instead of
    re-running tier-1 MSMs over the dense RLC vector
    (`poly/rlc_polynomial.rs:29-78` streams the same way).
    """

    name = "dory"

    def __init__(self, setup: DorySetup, device="cuda", _k3=None):
        """`device` picks the route of Dory's G1 work (`Dory`); `_k3`
        forces one route, only for the checks that hold one route against
        the other (the tests and `chip_smoke.py`)."""
        self.dory = Dory(setup, device, _k3)
        self.setup = setup
        self._hints: Dict[str, DoryHint] = {}

    def setup_digest(self) -> bytes:
        """Stable identity of this setup's parameters (cache keying).
        (nu, sigma) + the first tier-1 generator pins the generator set:
        a custom/foreign setup with different generators digests apart."""
        import hashlib as _hl
        h = _hl.blake2b(b"dory", digest_size=16)
        h.update(self.setup.nu.to_bytes(4, "big"))
        h.update(self.setup.sigma.to_bytes(4, "big"))
        g = self.setup.gamma1[0]
        h.update(int(g[0]).to_bytes(32, "big"))
        h.update(int(g[1]).to_bytes(32, "big"))
        g2 = self.setup.g2star
        for c in (g2[0].a, g2[0].b):
            h.update(int(c).to_bytes(32, "big"))
        return h.digest()

    def commit(self, name: str, coeffs: Sequence[int],
               bits: int = 254) -> DoryCommitment:
        com, hint = self.dory.commit(coeffs)
        self._hints[name] = hint
        return com

    def commit_sparse(self, name: str, positions,
                      length: int) -> DoryCommitment:
        """One-hot fast path: tier-1 segment sums over the nonzero
        positions (`Dory.onehot_rows`: K3 on a CUDA device, native on the
        CPU), O(T) -- no dense K*T vector exists anywhere."""
        com, hint = self.dory.commit_onehot(positions)
        self._hints[name] = hint
        return com

    def commit_sparse_many(self, named_positions):
        """Batched one-hot commits: one tier-1 dispatch for every matrix
        (see Dory.onehot_rows)."""
        names = [n for n, _ in named_positions]
        results = self.dory.commit_onehot_many([p for _, p in named_positions])
        out = {}
        for name, (com, hint) in zip(names, results):
            self._hints[name] = hint
            out[name] = com
        return out

    def absorb(self, transcript: Blake2bTranscript,
               comm: DoryCommitment) -> None:
        transcript.append_bytes(b"commitment", gt_to_bytes(comm.c))

    def open_rlc(self, weights: Dict[str, int], rlc,
                 point: Sequence[int], value: int,
                 transcript: Blake2bTranscript):
        assert len(point) == self.setup.num_vars, "setup sized for wrong N"
        from ..curve import native_pairing as _np
        from ..utils.profiling import active as _prof_active
        nrows = 1 << self.setup.nu
        rows: List[Optional[host.Point]] = [None] * nrows
        with _prof_active().span("open.rlc_rows"):
            if _np.available():
                # buffer-level ladder: the folded accumulator stays raw
                # between per-polynomial GLV folds (decode once at end)
                rb, ri = b"\x00" * (64 * nrows), b"\x01" * nrows
                for name, w in weights.items():
                    hb, hi = _np._g1_enc_many(self._hints[name].rows)
                    rb, ri = _np.g1_fold_buf(rb, ri, hb, hi, nrows, w)
                rows = _np.g1_dec_many(rb, ri)
            else:
                for name, w in weights.items():
                    hrows = self._hints[name].rows
                    for i, rc in enumerate(hrows):
                        if rc is not None:
                            rows[i] = host.g1_add(rows[i],
                                                  host.g1_mul(rc, w))
        return self.dory.open(rlc, DoryHint(rows=rows), point, value,
                              transcript)

    def combine(self, commitments: Dict[str, object],
                weights: Dict[str, int]):
        joint = None
        for name, w in weights.items():
            c = commitments[name]
            if not isinstance(c, DoryCommitment):
                return None
            # GT-membership (c^r == 1, the order-r subgroup of Fq12*):
            # rejects adversarial wire elements outside the pairing target
            # group.  NB gt_exp reduces exponents mod r, so use raw pow.
            if not c.c.pow(P).is_one():
                return None
            term = gt_exp(c.c, w)
            joint = term if joint is None else gt_mul(joint, term)
        return joint

    def verify_rlc(self, joint, point: Sequence[int], value: int, proof,
                   transcript: Blake2bTranscript) -> bool:
        if joint is None:
            return False
        return self.dory.verify(DoryCommitment(c=joint), point, value, proof,
                                transcript)


def make_scheme(setup, device="cuda"):
    """None | KZGSetup | DorySetup | scheme instance -> scheme | None; a
    new scheme runs its device work on `device`."""
    if setup is None:
        return None
    if isinstance(setup, (HyperKZGScheme, DoryScheme)):
        return setup
    if isinstance(setup, KZGSetup):
        return HyperKZGScheme(setup, device)
    if isinstance(setup, DorySetup):
        return DoryScheme(setup, device)
    raise TypeError(f"unknown PCS setup type {type(setup)!r}")
