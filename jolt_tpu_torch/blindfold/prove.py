"""BlindFold phases 2-6: R1CS build, Nova fold, Spartan, Hyrax openings.

Copied from the JAX package's `blindfold/prove.py`, logic unchanged
(every MSM is `pedersen.msm`, on the native library).  `proof_io.py`
decodes `BlindFoldProof` from here.

Entry: blindfold_prove(stages, basis, transcript, rng) after every ZK
sumcheck stage recorded its ZkStageData (zk_sumcheck.py).  The returned
BlindFoldProof + the phase-1 round commitments convince a verifier that
every committed round was consistent, without revealing a coefficient.
Reference flow: `crates/jolt-blindfold/src/prove.rs`,
`book/src/how/blindfold.md` phases 2-6.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

from ..field.params import FR
from ..transcript import Blake2bTranscript
from .fold import commit_grid, cross_term, error_of, fold_vectors
from .hyrax import eq_evals_host, hyrax_open, sumcheck_prove_host
from .pedersen import PedersenBasis, point_bytes
from .r1cs import VerifierR1CS, assign_witness, build_verifier_r1cs, matvec
from .zk_sumcheck import ZkStageData

P = FR.modulus


@dataclass
class BlindFoldProof:
    value_comms: List[object]          # real-instance non-coefficient rows
    u2: int
    z2_comms: List[object]
    t_comms: List[object]
    e2_comms: List[object]
    outer_polys: List[List[int]]
    az_r: int
    bz_r: int
    cz_r: int
    inner_polys: List[List[int]]
    w_comb: List[int]
    w_rho: int
    e_comb: List[int]
    e_rho: int
    e_rows: int = 0
    e_cols: int = 0


def _log2(n: int) -> int:
    return n.bit_length() - 1


def blindfold_prove(stages: Sequence[ZkStageData], basis: PedersenBasis,
                    transcript: Blake2bTranscript, rng) -> BlindFoldProof:
    r1cs = build_verifier_r1cs(stages)
    Cg, Rg = r1cs.grid_cols, r1cs.grid_rows
    W1 = assign_witness(r1cs, stages)
    Z1 = [1] + W1
    assert _satisfies(r1cs, Z1), "blindfold: real witness unsatisfying"

    # ---- commit the real instance's value rows --------------------------
    preset = {}
    row = 0
    for s in stages:
        for j in range(s.max_rounds):
            preset[row] = (s.blinds[j], s.commitments[j])
            row += 1
    grid1 = commit_grid(basis, W1, Rg, Cg, rng, preset=preset)
    for i in range(r1cs.n_coeff_rows, Rg):
        transcript.append_bytes(b"bf_value_comm",
                                point_bytes(grid1.comms[i]))

    # ---- random relaxed instance + cross term ---------------------------
    u2 = rng.randrange(P)
    W2 = [rng.randrange(P) for _ in range(Rg * Cg)]
    Z2 = [u2] + W2
    E2 = error_of(r1cs, Z2, u2)
    T = cross_term(r1cs, Z1, 1, Z2, u2)
    # error grid covers the m constraints EXACTLY (m and Cg powers of two)
    eC = min(Cg, r1cs.m)
    eR = r1cs.m // eC
    grid2 = commit_grid(basis, W2, Rg, Cg, rng)
    gridE2 = commit_grid(basis, E2, eR, eC, rng)
    gridT = commit_grid(basis, T, eR, eC, rng)

    transcript.append_scalar(b"bf_u2", u2)
    for g in (grid2, gridT, gridE2):
        for c in g.comms:
            transcript.append_bytes(b"bf_comm", point_bytes(c))
    r = transcript.challenge_scalar_optimized()

    # ---- fold ------------------------------------------------------------
    Wf = fold_vectors(W1, W2, r)
    rho_w = [(a + r * b) % P for a, b in zip(grid1.blinds, grid2.blinds)]
    uf = (1 + r * u2) % P
    r2 = r * r % P
    Ef = [(r * t + r2 * e) % P for t, e in zip(T, E2)]
    rho_e = [(r * a + r2 * b) % P
             for a, b in zip(gridT.blinds, gridE2.blinds)]
    Zf = [uf] + Wf

    # ---- Spartan outer over the folded relaxed instance ------------------
    logm = _log2(r1cs.m)
    tau = transcript.challenge_vector(logm)
    eq_t = eq_evals_host(tau)
    az = matvec(r1cs.A, r1cs.m, Zf)
    bz = matvec(r1cs.B, r1cs.m, Zf)
    cz = matvec(r1cs.C, r1cs.m, Zf)

    def outer_combine(v):
        e, a, b, c, err = v
        return e * ((a * b - uf * c - err) % P)

    outer_polys, r_x, fin = sumcheck_prove_host(
        [eq_t, az, bz, cz, Ef[:r1cs.m]], outer_combine, 3, 0, transcript)
    _, az_r, bz_r, cz_r, _ = fin
    transcript.append_scalar(b"bf_az", az_r)
    transcript.append_scalar(b"bf_bz", bz_r)
    transcript.append_scalar(b"bf_cz", cz_r)

    # ---- Spartan inner: reduce Az/Bz/Cz witness parts to W(r_y) ----------
    ra = transcript.challenge_scalar_optimized()
    rb = transcript.challenge_scalar_optimized()
    rc = transcript.challenge_scalar_optimized()
    eq_x = eq_evals_host(r_x)
    Lw = [0] * (Rg * Cg)
    pub = 0
    for coo, w in ((r1cs.A, ra), (r1cs.B, rb), (r1cs.C, rc)):
        for i, v, coeff in coo:
            t = w * eq_x[i] % P * coeff % P
            if v == 0:
                pub = (pub + t * uf) % P
            else:
                Lw[v - 1] = (Lw[v - 1] + t) % P
    inner_claim = (ra * az_r + rb * bz_r + rc * cz_r - pub) % P
    inner_polys, r_y, _ = sumcheck_prove_host(
        [Lw, Wf], lambda v: v[0] * v[1], 2, inner_claim, transcript)

    # ---- Hyrax openings ---------------------------------------------------
    w_comb, w_rho = hyrax_open(Wf, rho_w, Rg, Cg, r_y)
    e_comb, e_rho = hyrax_open(Ef, rho_e, eR, eC, r_x)
    for v in w_comb:
        transcript.append_scalar(b"bf_open", v)
    for v in e_comb:
        transcript.append_scalar(b"bf_open", v)

    return BlindFoldProof(
        value_comms=grid1.comms[r1cs.n_coeff_rows:], u2=u2,
        z2_comms=grid2.comms, t_comms=gridT.comms, e2_comms=gridE2.comms,
        outer_polys=outer_polys, az_r=az_r, bz_r=bz_r, cz_r=cz_r,
        inner_polys=inner_polys, w_comb=w_comb, w_rho=w_rho,
        e_comb=e_comb, e_rho=e_rho, e_rows=eR, e_cols=eC)


def _satisfies(r1cs: VerifierR1CS, z: Sequence[int]) -> bool:
    az = matvec(r1cs.A, r1cs.m, z)
    bz = matvec(r1cs.B, r1cs.m, z)
    cz = matvec(r1cs.C, r1cs.m, z)
    return all((a * b - c) % P == 0 for a, b, c in zip(az, bz, cz))
