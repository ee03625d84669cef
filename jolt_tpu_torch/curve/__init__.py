"""Host BN254 curve code copied from the JAX package (`bn254_host`,
`fq_tower`, `pairing`, `ate`): the proof codec's G1/G2/GT encodings and,
with Dory (ROADMAP A11), the commitment scheme's host arithmetic."""
