"""The control: a proof whose field elements were computed at half the
configuration's precision.

The prover has no floating point: every number in a proof is an exact
element of BN254's 254-bit scalar field Fr.  The nearest lower precision a
faster prover would be tempted by is a 128-bit one (four 32-bit limbs in
place of eight).  `lower_precision` decodes a proof with the reference's
copy of the codec, keeps the low 128 bits of every Fr scalar the proof
carries in the clear (the uni-skip polynomial, every round polynomial's
coefficients, every opening claim and reduced claim), and encodes it
again.  Commitments, the Dory opening proof and BlindFold's proof keep
their bytes.  The check has to find every such proof wrong.
"""

from __future__ import annotations

from .jolt.proof_io import deserialize_proof, serialize_proof

HALF = (1 << 128) - 1
# the JoltProof fields that hold Fr scalars (ints, lists, lists of lists
# and dicts of them)
SCALAR_FIELDS = (
    "stage1_uniskip", "stage1_polys", "r1cs_input_openings", "shift_polys",
    "shift_opening", "stage2_polys", "stage2_openings", "stage3_polys",
    "stage3_openings", "stage4_polys", "stage4_openings", "stage5_polys",
    "stage5_openings", "stage5i_polys", "stage5i_openings", "stage6_polys",
    "stage6_openings", "stage6_claims", "stage6v_polys", "stage6v_openings",
    "stage7_polys", "stage7_openings", "stage8_polys", "stage8_openings",
    "advice_openings", "program_image_claim")


def _half(v):
    if v is None:
        return None
    if isinstance(v, int):
        return v & HALF
    if isinstance(v, list):
        return [_half(x) for x in v]
    if isinstance(v, dict):
        return {k: _half(x) for k, x in v.items()}
    raise TypeError(f"not a scalar field: {type(v).__name__}")


def lower_precision(proof_bytes: bytes) -> bytes:
    proof, statement = deserialize_proof(proof_bytes)
    for name in SCALAR_FIELDS:
        setattr(proof, name, _half(getattr(proof, name)))
    return serialize_proof(proof, statement)
