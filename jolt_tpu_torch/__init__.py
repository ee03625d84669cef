"""jolt_tpu_torch: the Jolt zkVM prover on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package `jolt_tpu`, module for module, held against it
byte for byte.  It imports torch and numpy only.  Entry points run on the
card (`device="cuda"`) unless the caller asks for the CPU.
"""

from .prover import JoltProof, PrefixProof, prove, prove_prefix
from .verifier import PublicIO, VerificationError, verify, verify_prefix
