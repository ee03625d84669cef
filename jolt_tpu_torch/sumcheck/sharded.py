"""One product-sumcheck round on MLEs sharded over the cycle mesh.

Torch counterpart of the JAX package's `sumcheck/sharded.py`: the round
message of a product of MLEs and the HighToLow bind of each, on the
low-bit layout of `parallel/mesh.py:shard_mle`, (8, *batch, M, D) with the
last axis sharded (global index g = i*D + d).  The bind splits the M axis,
which every rank holds whole, so it stays on the rank; the message's pair
sums are exact int64 limb planes, `Partial` over the ranks, and one
all-reduce of them (`reduce_cols`) is the round's only collective.

On plain tensors (no mesh) it is the same round at D = 1.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..field import ops


def sharded_round_step(polys: Sequence[torch.Tensor], r, degree: int
                       ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """One round on MLEs (8, *batch, M, D): returns (message evals at X =
    0, 2, .., degree as (8, degree, *batch, 1), the bound MLEs (8, *batch,
    M/2, D)), the JAX function's (msg, bound).  `r` is the previous round's
    challenge (a canonical int, or (8, 1, ..) Montgomery limbs); the
    caller draws the challenges between steps.  Each rank runs K1's evals,
    mont_mul and bind forms on its own shard."""
    half = polys[0].shape[-2] // 2
    acc = None
    for Pk in polys:
        e = ops.evals(Pk[..., :half, :], Pk[..., half:, :], degree)
        acc = e if acc is None else ops.mont_mul(acc, e)
    # (8, degree, *batch, M/2, D) -> exact limb planes (8, degree, *batch, 1)
    planes = ops.u64_words(acc).sum(dim=(-2, -1))[..., None]
    msg = ops.reduce_cols(planes)
    bound = tuple(ops.bind(Pk[..., :half, :], Pk[..., half:, :], r)
                  for Pk in polys)
    return msg, bound
