from .prover import PrefixProof, fiat_shamir_preamble, prove_prefix
