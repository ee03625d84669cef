from .prover import (JoltProof, PrefixProof, fiat_shamir_preamble, prove,
                     prove_prefix)
