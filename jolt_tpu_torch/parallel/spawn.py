"""Start D ranks of the cycle mesh as processes, for the tests and
`chip_smoke.py` (`torchrun --nproc-per-node D` starts them from a shell).

`run_ranks(fn, D, *args)` spawns D processes (`start_ranks` without
waiting); each initializes the default process group over a `FileStore`
(no port to pick, so concurrent runs never collide), runs `fn(rank, D,
*args)` and hands back its result.  The backend
is gloo by default: on the CPU, and for ranks that share one card; pass
"nccl" for one card a rank.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import shutil
import tempfile
import time
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank: int, fn: Callable, world: int, args: tuple, backend: str,
           workdir: str, threads: Optional[int]) -> None:
    if threads is not None:
        torch.set_num_threads(threads)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    store = dist.FileStore(os.path.join(workdir, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world)
    try:
        out = fn(rank, world, *args)
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


class Ranks:
    """Ranks started by `start_ranks`; `join()` waits for them and returns
    their results in rank order, or raises if any rank failed."""

    def __init__(self, ctx, workdir: str, world: int, own: bool):
        self.ctx, self.workdir, self.world, self.own = ctx, workdir, world, own

    def join(self) -> List[object]:
        try:
            while not self.ctx.join():
                pass
            out = []
            for rank in range(self.world):
                with open(os.path.join(self.workdir, f"rank{rank}.pkl"),
                          "rb") as f:
                    out.append(pickle.load(f))
            return out
        finally:
            if self.own:
                shutil.rmtree(self.workdir, ignore_errors=True)


def start_ranks(fn: Callable, world: int, *args, backend: str = "gloo",
                workdir: Optional[str] = None,
                threads: Optional[int] = 1) -> Ranks:
    """Start `fn(rank, world, *args)` on `world` spawned ranks and return
    at once.  `fn` must be importable by the children (a module-level
    function); `workdir` (a new temporary directory by default, removed
    after) holds the store and the results; `threads` is each rank's torch
    thread count."""
    own = workdir is None
    workdir = tempfile.mkdtemp(prefix="jolt_ranks_") if own else workdir
    os.makedirs(workdir, exist_ok=True)
    ctx = mp.start_processes(_entry, args=(fn, world, args, backend, workdir,
                                           threads),
                             nprocs=world, join=False, start_method="spawn")
    return Ranks(ctx, workdir, world, own)


def run_ranks(fn: Callable, world: int, *args, **kwargs) -> List[object]:
    """`start_ranks(...).join()`: the ranks' results in rank order."""
    return start_ranks(fn, world, *args, **kwargs).join()


# the collectives a `prove` under a mesh issues (DTensor's all-gathers of
# a sharded axis, and the exact all-reduce of `Partial` limb planes)
REQUIRED = ("all_gather_into_tensor", "all_reduce")
COLLECTIVES = REQUIRED + ("all_to_all_single",)


def probe_collectives(mesh, names=COLLECTIVES, path: str = "funcol"
                      ) -> Dict[str, str]:
    """Whether the mesh's backend carries each of DTensor's collectives
    (`names`) on tensors of the mesh's device type: {name: "ok" or the
    error}, each result checked against its value.  `path` "funcol" calls
    them as DTensor issues them (`torch.distributed.
    _functional_collectives`), "c10d" through `torch.distributed`."""
    import torch.distributed._functional_collectives as funcol
    gather = getattr(funcol, "all_gather_single", None) \
        or funcol.all_gather_tensor
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device("cpu"))
    D, rank = mesh.size(), mesh.get_local_rank()
    t = torch.arange(2 * D, dtype=torch.int64, device=dev) + 100 * rank
    base = torch.arange(2 * D, dtype=torch.int64)
    want = {
        "all_gather_into_tensor": torch.cat([base + 100 * d
                                             for d in range(D)]),
        "all_reduce": base * D + 100 * sum(range(D)),
        "all_to_all_single": torch.cat([base[2 * rank:2 * rank + 2]
                                        + 100 * d for d in range(D)])}
    group = mesh.get_group()

    def c10d(name):
        out = torch.empty(want[name].shape, dtype=torch.int64, device=dev)
        if name == "all_gather_into_tensor":
            dist.all_gather_into_tensor(out, t, group=group)
        elif name == "all_reduce":
            out.copy_(t)
            dist.all_reduce(out, group=group)
        else:
            dist.all_to_all_single(out, t, group=group)
        return out
    calls = {
        "all_gather_into_tensor": lambda: gather(t, 0, (mesh, 0)),
        "all_reduce": lambda: funcol.all_reduce(t, "sum", (mesh, 0)),
        "all_to_all_single": lambda: funcol.all_to_all_single(
            t, None, None, (mesh, 0))}
    if path not in ("funcol", "c10d"):
        raise ValueError(f"probe_collectives: path {path!r}")
    out = {}
    for name in names:
        try:
            got = (calls[name]() if path == "funcol" else c10d(name))
            got = got.clone().cpu()           # clone waits for the result
            out[name] = "ok" if torch.equal(got, want[name]) else \
                f"wrong result {got.tolist()}"
        except Exception as e:  # noqa: BLE001 -- the finding is the error
            out[name] = f"{type(e).__name__}: {e}"[:300]
    return out


def _probe_rank(rank: int, world: int, name: str, device, path: str
                ) -> str:
    from .mesh import cycle_mesh
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    return probe_collectives(cycle_mesh(world, device=device), (name,),
                             path)[name]


def probe_ranks(world: int, backend: str, device, path: str = "funcol"
                ) -> Dict[str, str]:
    """`probe_collectives` of each collective on `world` fresh ranks of
    its own, so that a backend which kills its process (a segfault)
    still names the collective: {name: "ok", or what went wrong on the
    first rank that reported it}."""
    out = {}
    for name in COLLECTIVES:
        try:
            got = run_ranks(_probe_rank, world, name, device, path,
                            backend=backend, threads=None)
            out[name] = next((g for g in got if g != "ok"), "ok")
        except Exception as e:  # noqa: BLE001 -- a rank died: the finding
            lines = [x for x in str(e).splitlines() if x.strip()]
            out[name] = f"a rank died: {' | '.join(lines[-2:])}"[:300]
    return out


def prove_rank(rank: int, world: int, trace, setup=None, device="cuda",
               every_slot: Optional[str] = None, count_comm: bool = False,
               **prove_kwargs) -> dict:
    """One rank's `prove` of `trace` under `use_mesh(cycle_mesh(world))`:
    its `serialize_proof` bytes, FS tape, seconds, the device tier's
    fetches (0 under a mesh) and the K1 / K2 / K4 launches.  `every_slot`
    forces every slot's tier through the backend seam ("device" or
    "host"); `count_comm` counts the collectives by kind and stage
    (`CommDebugMode`, through `prover.stage_hooks`); `prove_kwargs` go to
    `prove`.  `device` is "cuda" unless the caller asks for the CPU (it
    raises with no card, as `prove` does)."""
    from torch.distributed.tensor.debug import CommDebugMode

    from ..field import kernels
    from ..kernels.registry import JoltBackend, set_backend
    from ..proof_io import serialize_proof
    from ..prover import prover
    from ..sumcheck import fused
    from .mesh import cycle_mesh, use_mesh
    device = prover.resolve_device(device)
    if every_slot is not None:
        set_backend(JoltBackend.default().with_every_slot(every_slot))
    mesh = cycle_mesh(world, device=device)
    comm = CommDebugMode() if count_comm else contextlib.nullcontext()
    stages = comm_by_stage(comm) if count_comm else {}
    kernels.reset_launches()
    fetches = fused.fetches
    t0 = time.perf_counter()
    try:
        with comm, use_mesh(mesh):
            proof = prover.prove(trace, setup=setup, device=device,
                                 **prove_kwargs)
    finally:
        if count_comm:
            prover.stage_hooks.pop()
    return dict(seconds=time.perf_counter() - t0,
                bytes=serialize_proof(proof), fs_tape=proof.fs_tape,
                fetches=fused.fetches - fetches, k1=kernels.k1_launches(),
                k2=kernels.product_round.launches, k4=kernels.k4_launches(),
                comm=stages)


def comm_by_stage(comm) -> Dict[str, Dict[str, int]]:
    """Register a stage hook on `prover.stage_hooks` that files the
    collectives `comm` (a `CommDebugMode`) counted during each stage of
    `prove` under the stage's label; returns the dict it fills
    ({label: {collective: n}}).  The caller pops the hook."""
    from ..prover import prover
    stages: Dict[str, Dict[str, int]] = {}
    seen: Dict[str, int] = {}

    def hook(label: str) -> None:
        now = {str(k).split(".")[-2] if str(k).endswith(".default")
               else str(k).split(".")[-1]: v
               for k, v in comm.get_comm_counts().items()}
        stages[label] = {k: v - seen.get(k, 0) for k, v in now.items()
                         if v != seen.get(k, 0)}
        seen.clear()
        seen.update(now)
    prover.stage_hooks.append(hook)
    return stages
