"""The cycle mesh: the prover's field tensors sharded over ranks.

Torch counterpart of the JAX package's `parallel/mesh.py`.  JAX drives
every device from one process and GSPMD inserts the collectives; here each
rank is a process of `torch.distributed` and the sharded tensors are
DTensors (`torch.distributed.tensor`) on a 1-D `DeviceMesh` named
("cycle",).  The caller starts the ranks and initializes the default
process group (`torchrun`, or `spawn.run_ranks`): NCCL for one card a
rank, gloo on the CPU and for ranks that share one card.

Under `use_mesh(mesh)`:

  * `maybe_shard` places each new field tensor: its last axis (the cycle
    or entry axis; the port's tensors are limbs-first, (8, *batch)) is
    `Shard`-ed in blocks over the mesh when it is at least D long and a
    multiple of D, else the tensor is `Replicate`-d.  `ops.from_words`,
    behind `from_u64`, `from_u32` and the list `pack_ints`, calls it, as
    the JAX package's creation points do, and so do the relations where a
    table was gathered whole (a schedule's gathers, a plain buffer);
  * a bind keeps the shard: a pass's pairs (`kernels.pair_halves`) are
    each rank's blocks of the two halves, gathered once where a HighToLow
    pair crosses ranks, and K2 runs on each rank's own pairs;
  * plain tensors (indices, schedules, uploaded words) stay plain and mix
    with DTensors as `Replicate` (`implicit_replication`);
  * K1's and K2's wrappers take DTensors through one rule
    (`field/kernels.py:_on_mesh`): elementwise forms run on each rank's
    local shard, K2 on each rank's pairs; int64 limb-plane sums over
    a sharded axis are `Partial` and are all-reduced exactly before the
    mod-p reduction;
  * every batched stage takes the host engine (`sumcheck/fused.py:
    device_tier`), and host fetches gather (`ops.host`).

Field ops are exact mod p, so the proof's bytes do not depend on the mesh
(tests/test_torch_mesh.py).

`shard_mle` / `unshard_mle` are the low-bit layout of `sumcheck/
sharded.py`: an MLE (8, *batch, T) as (8, *batch, T//D, D), the last axis
sharded,
global index g = i*D + d, so rank d owns the entries whose low bits are
d and a HighToLow bind (g with g + T/2) stays on its rank.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

# `torch.distributed.tensor` (~1.3 s to import) is imported where a mesh
# is used, so the one-device path never loads it (`kernels.is_dtensor`)


def cycle_mesh(n_devices: Optional[int] = None,
               device="cuda") -> DeviceMesh:
    """A 1-D mesh named ("cycle",) over the first `n_devices` ranks of the
    default process group (all of them by default), on `device`'s type.
    Raises when no process group is initialized or it has fewer ranks:
    never a silent single-device mesh."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("cycle_mesh: no process group is initialized "
                           "(start the ranks with torchrun or "
                           "parallel.spawn.run_ranks)")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"cycle_mesh: {n} ranks asked, the process group "
                         f"has {world}")
    return DeviceMesh(torch.device(device).type, list(range(n)),
                      mesh_dim_names=("cycle",))


_ACTIVE: List[DeviceMesh] = []


def active_mesh() -> Optional[DeviceMesh]:
    return _ACTIVE[-1] if _ACTIVE else None


class use_mesh:
    """Context manager: shard field-tensor creation over `mesh`, and let
    plain tensors mix with DTensors as `Replicate`."""

    def __init__(self, mesh: DeviceMesh):
        self.mesh = mesh
        self._stack = contextlib.ExitStack()

    def __enter__(self) -> DeviceMesh:
        from torch.distributed.tensor.experimental import \
            implicit_replication
        self._stack.enter_context(implicit_replication())
        _ACTIVE.append(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        _ACTIVE.pop()
        self._stack.close()
        return False


def maybe_shard(t: torch.Tensor) -> torch.Tensor:
    """Place a field tensor (8, *batch) that every rank holds whole (a
    plain tensor, or a `Replicate` DTensor) on the active mesh, as the JAX
    package's rule does: `Shard` its last axis when there is a batch axis
    and the last is at least D long and a multiple of D, else `Replicate`;
    a no-op without a mesh and on a DTensor placed otherwise.  Each rank
    keeps its own block: no collective."""
    mesh = active_mesh()
    if mesh is None:
        return t
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    if isinstance(t, DTensor) and (t.device_mesh != mesh
                                   or t.placements != (Replicate(),)):
        return t
    D, n = mesh.size(), t.shape[-1]
    # a last axis of length 1 (whole on its one rank at D = 1) stays
    # `Replicate`: DTensor cannot reshape away a sharded axis
    if not (t.dim() >= 2 and n >= max(D, 2) and n % D == 0):
        return t if isinstance(t, DTensor) else distribute_tensor(
            t, mesh, [Replicate()], src_data_rank=None)
    if isinstance(t, DTensor):
        return t.redistribute(mesh, [Shard(t.dim() - 1)])
    return distribute_tensor(t, mesh, [Shard(t.dim() - 1)],
                             src_data_rank=None)


def shard_mle(mle: torch.Tensor, mesh: DeviceMesh):
    """(8, *batch, T) -> (8, *batch, T//D, D), the last axis sharded over
    "cycle": entry [..., i, d] = mle[..., i*D + d] (the low index bits)."""
    from torch.distributed.tensor import Shard, distribute_tensor
    D = mesh.size()
    T = mle.shape[-1]
    if T % D:
        raise ValueError(f"shard_mle: T={T} not divisible by D={D}")
    resh = mle.reshape(mle.shape[:-1] + (T // D, D))
    return distribute_tensor(resh, mesh, [Shard(resh.dim() - 1)],
                             src_data_rank=None)


def unshard_mle(sharded) -> torch.Tensor:
    """`shard_mle`'s inverse: the whole (8, *batch, T) on every rank."""
    return sharded.full_tensor().flatten(-2)
