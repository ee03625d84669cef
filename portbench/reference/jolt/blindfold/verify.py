"""BlindFold verifier (phases 2-6 mirror of prove.py).

Copied from the JAX package's `blindfold/verify.py`, logic unchanged;
the folds of the commitments are `pedersen.msm` (the native library).

Input: the stages' PUBLIC ZkStageData (commitments + challenges replayed
from the main transcript; round_coeffs/blinds/claims absent) and the
BlindFoldProof.  The verifier rebuilds the same R1CS, folds the committed
instances homomorphically, replays both Spartan sumchecks, and accepts
only if the Hyrax openings tie every final claim back to the folded
commitments.  Reference: `crates/jolt-blindfold/src/verify.rs`.
"""

from __future__ import annotations

from typing import List, Sequence


from ..curve import bn254_host as host
from ..field.params import FR
from .hyrax import (eq_evals_host, hyrax_verify, sumcheck_verify_host)
from .pedersen import msm, point_bytes
from .r1cs import build_verifier_r1cs

P = FR.modulus


class BlindFoldError(Exception):
    pass


def blindfold_verify(stages: Sequence[ZkStageData],
                     proof: BlindFoldProof, basis: PedersenBasis,
                     transcript: Blake2bTranscript) -> bool:
    r1cs = build_verifier_r1cs(stages)
    Cg, Rg = r1cs.grid_cols, r1cs.grid_rows
    basis.extend(Cg)

    # real-instance row commitments: phase-1 round comms + value rows
    real_comms: List[object] = []
    for s in stages:
        real_comms.extend(s.commitments)
    if len(proof.value_comms) != Rg - r1cs.n_coeff_rows:
        raise BlindFoldError("wrong number of value-row commitments")
    real_comms.extend(proof.value_comms)
    for c in proof.value_comms:
        transcript.append_bytes(b"bf_value_comm", point_bytes(c))

    eC = min(Cg, r1cs.m)
    eR = r1cs.m // eC
    if (proof.e_rows, proof.e_cols) != (eR, eC):
        raise BlindFoldError("error-grid shape mismatch")
    if len(proof.z2_comms) != Rg or len(proof.t_comms) != eR \
            or len(proof.e2_comms) != eR:
        raise BlindFoldError("commitment count mismatch")
    for p in (proof.z2_comms + proof.t_comms + proof.e2_comms):
        if p is not None and not host.g1_is_on_curve(p):
            raise BlindFoldError("off-curve commitment")

    transcript.append_scalar(b"bf_u2", proof.u2)
    for g in (proof.z2_comms, proof.t_comms, proof.e2_comms):
        for c in g:
            transcript.append_bytes(b"bf_comm", point_bytes(c))
    r = transcript.challenge_scalar_optimized()

    # folded commitments (homomorphic)
    uf = (1 + r * proof.u2) % P
    r2 = r * r % P
    w_comms = [msm([a, b], [1, r])
               for a, b in zip(real_comms, proof.z2_comms)]
    e_comms = [msm([t, e], [r, r2])
               for t, e in zip(proof.t_comms, proof.e2_comms)]

    # ---- Spartan outer ----------------------------------------------------
    logm = (r1cs.m).bit_length() - 1
    tau = transcript.challenge_vector(logm)
    if len(proof.outer_polys) != logm:
        raise BlindFoldError("outer sumcheck round count")
    out_claim, r_x = sumcheck_verify_host(proof.outer_polys, 0, 3,
                                          transcript)
    transcript.append_scalar(b"bf_az", proof.az_r)
    transcript.append_scalar(b"bf_bz", proof.bz_r)
    transcript.append_scalar(b"bf_cz", proof.cz_r)

    ra = transcript.challenge_scalar_optimized()
    rb = transcript.challenge_scalar_optimized()
    rc = transcript.challenge_scalar_optimized()

    # ---- Spartan inner ------------------------------------------------------
    eq_x = eq_evals_host(r_x)
    pub = 0
    for coo, w in ((r1cs.A, ra), (r1cs.B, rb), (r1cs.C, rc)):
        for i, v, coeff in coo:
            if v == 0:
                pub = (pub + w * eq_x[i] % P * coeff % P * uf) % P
    inner_claim = (ra * proof.az_r + rb * proof.bz_r
                   + rc * proof.cz_r - pub) % P
    log_w = (Rg * Cg).bit_length() - 1
    if len(proof.inner_polys) != log_w:
        raise BlindFoldError("inner sumcheck round count")
    in_claim, r_y = sumcheck_verify_host(proof.inner_polys, inner_claim,
                                         2, transcript)

    # ---- Hyrax openings -----------------------------------------------------
    for v in proof.w_comb:
        transcript.append_scalar(b"bf_open", v)
    for v in proof.e_comb:
        transcript.append_scalar(b"bf_open", v)
    try:
        w_eval = hyrax_verify(w_comms, basis, r_y, proof.w_comb,
                              proof.w_rho)
        e_eval = hyrax_verify(e_comms, basis, r_x, proof.e_comb,
                              proof.e_rho)
    except ValueError as e:
        raise BlindFoldError(str(e)) from e

    # Lw~(r_y) from the sparse matrices (no materialization)
    eq_y = eq_evals_host(r_y)
    lw_eval = 0
    for coo, w in ((r1cs.A, ra), (r1cs.B, rb), (r1cs.C, rc)):
        for i, v, coeff in coo:
            if v != 0:
                lw_eval = (lw_eval
                           + w * eq_x[i] % P * coeff % P
                           * eq_y[v - 1]) % P

    # final checks
    if in_claim != lw_eval * w_eval % P:
        raise BlindFoldError("inner sumcheck final claim mismatch")
    eq_tx = 1
    for t, x in zip(tau, r_x):
        eq_tx = eq_tx * ((t * x + (1 - t) * (1 - x)) % P) % P
    expect = eq_tx * ((proof.az_r * proof.bz_r
                       - uf * proof.cz_r - e_eval) % P) % P
    if out_claim != expect:
        raise BlindFoldError("outer sumcheck final claim mismatch")
    return True
