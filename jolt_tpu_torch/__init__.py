"""jolt_tpu_torch: the Jolt zkVM prover on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package `jolt_tpu`, module for module, held against it
byte for byte.  It imports torch and numpy only.  Entry points run on the
card (`device="cuda"`) unless the caller asks for the CPU.  The zk mode's
BlindFold layer is exported as the JAX package's `blindfold` exports it.
"""

from .blindfold import (PedersenBasis, ZkStageData, blindfold_prove,
                        blindfold_verify, pedersen_commit, zk_prove_stage,
                        zk_replay_challenges)
from .prover import JoltProof, PrefixProof, prove, prove_prefix
from .verifier import PublicIO, VerificationError, verify, verify_prefix
