from .prover import Stage1Proof, fiat_shamir_preamble, prove_stage1
