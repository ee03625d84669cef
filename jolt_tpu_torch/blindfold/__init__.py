"""BlindFold: the zk mode's committed sumcheck rounds and the folded proof
of their checks (`prove(zk=True)`), as the JAX package's `blindfold/`."""

from .pedersen import PedersenBasis, pedersen_commit
from .zk_sumcheck import ZkStageData, zk_prove_stage, zk_replay_challenges
from .prove import blindfold_prove
from .verify import blindfold_verify

__all__ = ["PedersenBasis", "pedersen_commit", "ZkStageData",
           "zk_prove_stage", "zk_replay_challenges", "blindfold_prove",
           "blindfold_verify"]
